"""Model configurations of the port."""
from repro_torch.configs import (common, encoders,  # noqa: F401
                                 two_tower_retrieval, yi_9b)
