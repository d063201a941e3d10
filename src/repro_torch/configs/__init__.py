"""Model configurations of the port."""
from repro_torch.configs import encoders, two_tower_retrieval  # noqa: F401
