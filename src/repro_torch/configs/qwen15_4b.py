"""qwen1.5-4b [hf:Qwen/Qwen1.5-*] (a copy of
``repro/configs/qwen15_4b.py``).

40L d_model=2560 20H (kv=20, full MHA) d_head=128 d_ff=6912
vocab=151936, QKV bias (the qwen1.5 signature), SwiGLU; bfloat16 at full
width.
"""
import torch

from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20,
        n_kv_heads=20, d_head=128, d_ff=6912, vocab=151936,
        qkv_bias=True,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, qkv_bias=True,
    )
