"""Models of the port: the bi-encoder (Dragon / Snowflake) that embeds
documents and queries for the index, two-tower retrieval, whose user
tower makes the query of a TopLoc session over the item corpus, the
ranking models (DCN-v2, BST, AutoInt), GIN, and the decoder LMs that
answer from retrieved documents.

  layers       — RMSNorm, LayerNorm, RoPE, GQA attention (through the
                 flash attention kernel, and its decode through the flash
                 decode kernel), SwiGLU, the MLP tower, MoE, MLA
  encoder      — ``EncoderConfig``, ``Tower``, ``DualEncoder``,
                 ``init_params``, ``contrastive_loss``
  recsys       — the sparse embedding substrate (``embed_bag`` through the
                 EmbeddingBag kernel), ``TwoTowerConfig``, ``TwoTower``,
                 ``two_tower_init``, ``retrieval_topk``; ``DCNv2``,
                 ``BST`` (its block's attention through the flash
                 attention kernel), ``AutoInt``; ``two_tower_loss``,
                 ``bce_loss``
  gnn          — ``GINConfig``, ``GIN`` (``forward_node``,
                 ``forward_graph``, ``forward_trees``), ``init_params``,
                 ``node_loss``, ``graph_loss``, ``tree_loss``
  transformer  — ``LMConfig``, ``LM`` (``forward``, ``loss_fn``,
                 ``init_cache``, ``prefill``, ``decode_step``),
                 ``init_params``
"""
from repro_torch.models import (encoder, gnn, layers,  # noqa: F401
                                recsys, transformer)
