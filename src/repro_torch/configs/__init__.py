"""Model configurations of the port.

Importing this package populates the architecture registry
(``configs.common``): the ten arch ids of the reference, each with its
train and serve bundles.  ``encoders`` holds the paper's own encoder configs.
"""
from repro_torch.configs import (autoint, bst, common,  # noqa: F401
                                 dcn_v2, deepseek_v2_lite_16b, encoders,
                                 gin_tu, grok_1_314b, qwen3_14b, qwen15_4b,
                                 two_tower_retrieval, yi_9b)

get = common.get
list_archs = common.list_archs
