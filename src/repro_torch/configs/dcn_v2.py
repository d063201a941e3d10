"""dcn-v2 [arXiv:2008.13535]: the configuration and its shapes (copies of
``repro/configs/dcn_v2.py``: the same fields, values and shapes).

13 dense + 26 sparse features (embed 16), 3 full-rank cross layers, deep
MLP 1024-1024-512; a Criteo-like skewed vocabulary (2 x 16.7 M + 2 x 2 M
+ 2 x 262 k + 20 x 65 k = 39.6 M rows, a 2.53 GB float32 table).  A
ranking model: it scores given candidate rows, TopLoc does not apply.
``retrieval_cand`` is the offline scoring of 10^6 candidate rows.  The
reference's ``build_bundle`` (TPU lowering and sharding specs) has no
counterpart here: the serve step is ``models.recsys.DCNv2`` itself.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import recsys as R

VOCABS = (2 ** 24, 2 ** 24, 2 ** 21, 2 ** 21, 2 ** 18, 2 ** 18
          ) + (2 ** 16,) * 20

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


def full_config() -> R.DCNv2Config:
    return R.DCNv2Config(vocab_sizes=VOCABS)


def smoke_config() -> R.DCNv2Config:
    return R.DCNv2Config(vocab_sizes=(64,) * 26, mlp=(64, 32),
                         embed_dim=8)
