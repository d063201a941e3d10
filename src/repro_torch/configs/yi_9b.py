"""yi-9b [arXiv:2403.04652; hf] (a copy of ``repro/configs/yi_9b.py``).

48L d_model=4096 32H (GQA kv=4) d_head=128 d_ff=11008 vocab=64000,
llama-style GQA + SwiGLU; bfloat16 weights and activations at full
width, its published dtype; ``remat`` and ``loss_chunk`` as the
reference's.  Registered for training as ``yi-9b`` (AdamW).
"""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="yi-9b", n_layers=48, d_model=4096, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
        remat=True, loss_chunk=512,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        remat=False, loss_chunk=16,
    )


ARCH = common.lm_archdef(
    "yi-9b", full_config, smoke_config, notes="dense llama-arch GQA kv=4")
