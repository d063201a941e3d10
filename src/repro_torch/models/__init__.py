"""Models of the port: the bi-encoder (Dragon / Snowflake) that embeds
documents and queries for the index, two-tower retrieval, whose user
tower makes the query of a TopLoc session over the item corpus, and the
dense decoder LM that answers from retrieved documents.

  layers       — RMSNorm, RoPE, GQA attention (through the flash
                 attention kernel, and its decode through the flash
                 decode kernel), SwiGLU, the MLP tower
  encoder      — ``EncoderConfig``, ``Tower``, ``DualEncoder``,
                 ``init_params``
  recsys       — the sparse embedding substrate (``embed_bag`` through the
                 EmbeddingBag kernel), ``TwoTowerConfig``, ``TwoTower``,
                 ``two_tower_init``, ``retrieval_topk``
  transformer  — ``LMConfig``, ``LM`` (``forward``, ``init_cache``,
                 ``prefill``, ``decode_step``), ``init_params``
"""
from repro_torch.models import (encoder, layers, recsys,  # noqa: F401
                                transformer)
