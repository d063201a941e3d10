"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] (a copy of
``repro/configs/deepseek_v2_lite_16b.py``).

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MLA kv_lora=512
(+64 decoupled rope dims), MoE 2 shared + 64 routed top-6; bfloat16
weights and activations at full width.  The reference's deviations from
the HF checkpoint hold here too: 64 routed experts, and the first dense
layer simplified to MoE everywhere.  Decode runs the absorbed-latent MLA
form over a cache of 512 + 64 dims a token.  16.21 B parameters (32.4 GB
in bf16) fit one 80 GB card; its training state (AdamW's float32
moments) does not.  Registered for training as ``deepseek-v2-lite-16b``
(AdamW, 4 microbatches; 1 at the smoke size).
"""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import LMConfig


def full_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=1408, vocab=102400,
        attn_kind="mla", kv_lora_rank=512, d_rope=64,
        n_experts=64, top_k=6, n_shared=2, moe_d_ff=1408,
        param_dtype=torch.bfloat16, dtype=torch.bfloat16,
        remat=True, loss_chunk=512,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=48, vocab=512,
        attn_kind="mla", kv_lora_rank=32, d_rope=8,
        n_experts=8, top_k=2, n_shared=1, moe_d_ff=48,
        remat=False, loss_chunk=16,
    )


ARCH = common.lm_archdef(
    "deepseek-v2-lite-16b", full_config, smoke_config, optimizer="adamw",
    microbatches=4,
    notes="MLA latent cache; absorbed decode; MoE shared+routed")
