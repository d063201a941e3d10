"""autoint [arXiv:1810.11921]: the configuration and its shapes (copies
of ``repro/configs/autoint.py``: the same fields, values and shapes).

39 sparse fields (embed 16), 3 self-attention layers (2 heads, d_attn
32) with residual projections.  A ranking model: TopLoc does not apply.
The serve step is ``models.recsys.AutoInt`` itself (no
``build_bundle``).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import recsys as R

VOCABS = (2 ** 22,) * 2 + (2 ** 18,) * 5 + (2 ** 14,) * 32

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


def full_config() -> R.AutoIntConfig:
    return R.AutoIntConfig(vocab_sizes=VOCABS)


def smoke_config() -> R.AutoIntConfig:
    return R.AutoIntConfig(n_sparse=8, vocab_sizes=(64,) * 8,
                           embed_dim=8, d_attn=8)
