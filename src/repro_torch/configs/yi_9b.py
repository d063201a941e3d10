"""yi-9b [arXiv:2403.04652; hf] (a copy of ``repro/configs/yi_9b.py``).

48L d_model=4096 32H (GQA kv=4) d_head=128 d_ff=11008 vocab=64000,
llama-style GQA + SwiGLU; bfloat16 weights and activations at full
width, its published dtype.  The training knobs of the reference's
config (``remat``, ``loss_chunk``) have no counterpart in the port.
"""
import torch

from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="yi-9b", n_layers=48, d_model=4096, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
    )
