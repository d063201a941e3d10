"""Model configurations of the port."""
from repro_torch.configs import (common, deepseek_v2_lite_16b,  # noqa: F401
                                 encoders, grok_1_314b, qwen3_14b, qwen15_4b,
                                 two_tower_retrieval, yi_9b)
