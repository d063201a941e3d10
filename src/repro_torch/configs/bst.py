"""bst, the Behaviour Sequence Transformer [arXiv:1905.06874]: the
configuration and its shapes (copies of ``repro/configs/bst.py``: the
same fields, values and shapes).

embed_dim 32, behaviour sequence of 20 plus the target item, 1
transformer block of 8 heads (d_head 4, through the flash attention
kernel on the card), MLP 1024-512-256; item vocabulary 5 M and 8 profile
features x 100 k.  A ranking model: TopLoc does not apply.  The serve
step is ``models.recsys.BST`` itself (no ``build_bundle``).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import recsys as R

SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1_000_000),
}

SMOKE_SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=4096),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=8192),
    "retrieval_cand": dict(kind="serve", batch=65536),
}


def full_config() -> R.BSTConfig:
    return R.BSTConfig(item_vocab=5_000_000, other_vocab=100_000)


def smoke_config() -> R.BSTConfig:
    return R.BSTConfig(item_vocab=512, other_vocab=64, n_other=3,
                       mlp=(32, 16), seq_len=6)
