"""Models of the port: the bi-encoder (Dragon / Snowflake) that embeds
documents and queries for the index, and two-tower retrieval, whose
user tower makes the query of a TopLoc session over the item corpus.

  layers   — RMSNorm, RoPE, GQA attention (through the flash attention
             kernel), SwiGLU, the MLP tower
  encoder  — ``EncoderConfig``, ``Tower``, ``DualEncoder``, ``init_params``
  recsys   — the sparse embedding substrate (``embed_bag`` through the
             EmbeddingBag kernel), ``TwoTowerConfig``, ``TwoTower``,
             ``two_tower_init``, ``retrieval_topk``
"""
from repro_torch.models import encoder, layers, recsys  # noqa: F401
