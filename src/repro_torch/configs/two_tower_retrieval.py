"""two-tower-retrieval [RecSys'19 (YouTube)]: the configuration and its
serve steps (copies of ``repro/configs/two_tower_retrieval.py``: the same
fields, values and shapes).

embed_dim 256, tower MLP 1024-512-256, dot interaction.  The
``retrieval_cand`` shape (1 user against 10⁶ candidates) is the serving
problem TopLoc accelerates: ``TOPLOC_IVF`` holds the reference's
``toploc_ivf`` variant's defaults, and the port serves it through
``serving.engine.ConversationalSearchEngine`` over an IVF of the item
corpus, one user session per conversation.  The serve steps of the
reference's ``build_bundle`` (``:187-300``) are plain functions on
tensors here; its ``ArchDef`` / ``StepBundle`` / ``PartitionSpec``
machinery is JAX sharding and is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import recsys as R

SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_000,
                           k=100),
}

SMOKE_SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=4096),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=8192),
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=65536,
                           k=100),
}

# retrieval_cand through TopLoc_IVF (the reference's "toploc_ivf" variant):
# IVF partitions, cached centroids h, probed lists
TOPLOC_IVF: Dict[str, int] = dict(partitions=1024, h=128, nprobe=32)


def toploc_lmax(n_candidates: int, partitions: int) -> int:
    """The variant's posting-list width: 1.25 x the mean list."""
    return (n_candidates // partitions) * 5 // 4


def full_config() -> R.TwoTowerConfig:
    return R.TwoTowerConfig(user_vocab=1_048_576, item_vocab=2_097_152,
                            history_len=50)


def smoke_config() -> R.TwoTowerConfig:
    return R.TwoTowerConfig(embed_dim=16, tower_mlp=(32, 16),
                            user_vocab=512, item_vocab=1024,
                            history_len=5)


def pairwise_step(model: R.TwoTower, user_id, history, item_id
                  ) -> torch.Tensor:
    """serve_p99 / serve_bulk: the (B,) user-item dot products."""
    u = model.user_tower(user_id, history)
    i = model.item_tower(item_id)
    return (u * i).sum(-1)


def retrieval_step(model: R.TwoTower, user_id, history,
                   corpus: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand, brute force: the user tower, then the top k of
    its scores against every candidate (values, int32 ids)."""
    return R.retrieval_topk(model.user_tower(user_id, history), corpus, k)
