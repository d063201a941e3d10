"""grok-1-314b [hf:xai-org/grok-1] (a copy of
``repro/configs/grok_1_314b.py``).

64L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=32768 vocab=131072,
MoE 8 experts top-2, the logit soft cap 30.0; bfloat16 at full width.
316.5 B parameters do not fit one card: the port runs this config at
its smoke size.  The reference's optimizer choice (Adafactor) and
training knobs have no counterpart in the port.
"""
import torch

from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=32768, vocab=131072,
        n_experts=8, top_k=2, moe_d_ff=32768,
        logit_soft_cap=30.0,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        n_experts=4, top_k=2, moe_d_ff=128, logit_soft_cap=30.0,
    )
