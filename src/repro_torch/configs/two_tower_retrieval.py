"""two-tower-retrieval [RecSys'19 (YouTube)]: the configuration and its
serve steps (copies of ``repro/configs/two_tower_retrieval.py``: the same
fields, values and shapes).

embed_dim 256, tower MLP 1024-512-256, dot interaction.  The
``retrieval_cand`` shape (1 user against 10⁶ candidates) is the serving
problem TopLoc accelerates: ``TOPLOC_IVF`` holds the reference's
``toploc_ivf`` variant's defaults, and the port serves it through
``serving.engine.ConversationalSearchEngine`` over an IVF of the item
corpus, one user session per conversation.  The serve steps of the
reference's ``build_bundle`` (``:114-300``) are plain functions on
tensors here, the sharded ones (``toploc_ivf_dist``, ``dist_topk``)
over the shards of a ``distributed.retrieval.RetrievalMesh`` in one
process, as the port's sharded retrieval runs.  ``build_bundle`` is the
train branch (``:56-95``): ``train_batch`` of ``user_id``, ``item_id``
and ``history``, ``models.recsys.two_tower_loss``, AdamW at a constant
1e-3; registered as ``two-tower-retrieval``.  The reference's
``PartitionSpec`` machinery is JAX sharding and is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import common
from repro_torch.core.topk import distributed_topk, topk
from repro_torch.distributed.collectives import (on_device,
                                                 sharded_corpus_topk)
from repro_torch.distributed.sharding import Shards, split_rows
from repro_torch.kernels import ref as _kref
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


def build_bundle(cfg: R.TwoTowerConfig, shape: str, *, smoke: bool = False,
                 shape_overrides=None, **kw) -> common.StepBundle:
    """The train bundle of ``train_batch`` (serve shapes are refused)."""
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    common.train_only("two-tower-retrieval", shape, sp["kind"])
    b = sp["batch"]
    i32 = torch.int32
    return common.StepBundle(
        arch="two-tower-retrieval", shape=shape, kind="train",
        step_fn=common.simple_train_step(
            lambda model, batch: R.two_tower_loss(model, batch)),
        init_model=lambda seed, device=None: R.two_tower_init(
            cfg, seed, device).requires_grad_(True),
        make_optimizer=common.adamw_constant(1e-3),
        batch_structs={"user_id": common.struct((b,), i32),
                       "item_id": common.struct((b,), i32),
                       "history": common.struct((b, cfg.history_len), i32)},
        meta=dict(params=cfg.param_count(), tokens=b))


ARCH = common.register(common.ArchDef(
    arch_id="two-tower-retrieval", family="recsys",
    shapes=tuple(SHAPE_PARAMS), make_config=full_config,
    make_smoke_config=smoke_config, build_bundle=build_bundle,
    notes="the paper-representative arch: retrieval_cand is TopLoc's "
          "problem"))


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


def dist_topk_step(model: R.TwoTower, user_id, history, corpus, k: int,
                   mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand, variant ``dist_topk`` (``:236-256``): the corpus
    split by rows over the mesh's shards (``corpus`` a ``Shards``, or a
    tensor split here), each shard's own top k of the user's scores,
    then one k-wide merge (``core.topk.distributed_topk``, ties
    shard-major, which is the brute step's lower id).  (values, int32
    global ids) on the user's device."""
    return sharded_corpus_topk(mesh, corpus, model.user_tower(user_id,
                                                              history), k)


def shard_cap(nprobe: int, shards: int) -> int:
    """``toploc_ivf_dist``'s slot cap a shard: 2 λ + 2 for the λ =
    nprobe / shards selected lists a shard owns on average (``:138``)."""
    return max(2 * nprobe // shards + 2, 2)


def toploc_ivf_dist_step(model: R.TwoTower, user_id, history, list_vecs,
                         list_ids, cache_vecs: torch.Tensor,
                         cache_ids: torch.Tensor, *, k: int, nprobe: int,
                         mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand, variant ``toploc_ivf_dist`` (``:114-186``): the
    session's cached centroids scored, their top ``nprobe`` selected;
    the posting lists split by partition over the mesh's shards
    (``Shards``, or tensors split here); each shard scans at most
    ``shard_cap`` of the selected lists, the ones it
    owns first in selection order (a stable sort), the rest masked with
    id -1, so a shard that owns more than ``cap`` drops the overflow as
    the reference does; its top k, then one k-wide merge.  The scan is
    plain torch, as the reference's is XLA.  (values (1, k), int32 ids
    (1, k)) on the user's device."""
    u = model.user_tower(user_id, history)                       # (1, e)
    _, sel_local = topk(u @ cache_vecs.T, nprobe)
    sel = cache_ids[sel_local]                                   # (1, np)
    devs = mesh.shard_devices
    cap = shard_cap(nprobe, len(devs))
    if not isinstance(list_vecs, Shards):
        list_vecs = split_rows(list_vecs, devs)
    if not isinstance(list_ids, Shards):
        list_ids = split_rows(list_ids, devs)
    vs, ids = [], []
    for s, (lv, li) in enumerate(zip(list_vecs.parts, list_ids.parts)):
        if not lv.shape[0]:
            continue
        lo, hi = list_vecs.bounds(s)
        s_loc = on_device(sel[0], lv.device).long() - lo
        own = (s_loc >= 0) & (s_loc < hi - lo)
        order = torch.sort((~own).to(torch.uint8), stable=True
                           ).indices[:cap]
        s_cap = s_loc[order].clamp(0, hi - lo - 1)
        lis = torch.where(own[order][:, None], li[s_cap], -1).reshape(1, -1)
        q = on_device(u, lv.device)
        sc = torch.where(lis >= 0, _kref.list_scores(q, lv, s_cap[None]),
                         float("-inf"))
        v, pos = topk(sc, k)
        vs.append(on_device(v, u.device))
        ids.append(on_device(lis.gather(-1, pos), u.device))
    return distributed_topk(vs, ids, k)
