"""Model configurations of the port."""
from repro_torch.configs import (autoint, bst, common,  # noqa: F401
                                 dcn_v2, deepseek_v2_lite_16b, encoders,
                                 gin_tu, grok_1_314b, qwen3_14b, qwen15_4b,
                                 two_tower_retrieval, yi_9b)
