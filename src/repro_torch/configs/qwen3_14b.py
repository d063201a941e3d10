"""qwen3-14b [hf:Qwen/Qwen3-*] (a copy of ``repro/configs/qwen3_14b.py``).

40L d_model=5120 40H (GQA kv=8) d_head=128 d_ff=17408 vocab=151936,
qk-norm (per-head RMSNorm on q and k, the qwen3 signature), SwiGLU;
bfloat16 at full width.
"""
import torch

from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=8, d_head=128, d_ff=17408, vocab=151936,
        qk_norm=True,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=512, qk_norm=True,
    )
