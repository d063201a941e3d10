"""Training checkpoints: atomic ``.npz`` writes, resume, keep-last-k."""
from repro_torch.checkpoint import checkpoint  # noqa: F401
