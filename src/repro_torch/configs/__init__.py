"""Model configurations of the port."""
from repro_torch.configs import encoders  # noqa: F401
