"""Models of the port: the bi-encoder (Dragon / Snowflake) that embeds
documents and queries for the index.

  layers   — RMSNorm, RoPE, GQA attention (through the flash attention
             kernel), SwiGLU
  encoder  — ``EncoderConfig``, ``Tower``, ``DualEncoder``, ``init_params``
"""
from repro_torch.models import encoder, layers  # noqa: F401
