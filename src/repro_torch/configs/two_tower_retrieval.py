"""two-tower-retrieval [RecSys'19 (YouTube)]: the configuration, its
bundles and its serve steps (a port of
``repro/configs/two_tower_retrieval.py``: the same fields, values and
shapes).

embed_dim 256, tower MLP 1024-512-256, dot interaction.  The
``retrieval_cand`` shape (1 user against 10⁶ candidates) is the serving
problem TopLoc accelerates: ``TOPLOC_IVF`` holds the reference's
``toploc_ivf`` variant's defaults, and the port serves it through
``serving.engine.ConversationalSearchEngine`` over an IVF of the item
corpus, one user session per conversation.

``build_bundle`` is the reference's (``:56-300``): ``train_batch`` of
``user_id``, ``item_id`` and ``history``, ``models.recsys.two_tower_loss``,
AdamW at a constant 1e-3; ``serve_p99`` / ``serve_bulk`` the pairwise
dot products (``pairwise_step``); ``retrieval_cand`` by the
``variant`` of ``shape_overrides``: ``brute`` (default,
``retrieval_step``), ``toploc_ivf`` (``toploc_ivf_step``: the session's
cached centroids, then a plain scan of the selected lists), and the
sharded ``dist_topk`` / ``toploc_ivf_dist`` over the ``shards`` (default
16) of a ``distributed.retrieval.RetrievalMesh`` in one process, as the
port's sharded retrieval runs (the corpus device repeated, unless the
step is given a ``mesh=``).  Serving replicates every parameter.
Registered as ``two-tower-retrieval``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import common
from repro_torch.core.topk import distributed_topk, topk
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import (on_device,
                                                 sharded_corpus_topk)
from repro_torch.distributed.retrieval import retrieval_mesh
from repro_torch.distributed.sharding import P, Shards, split_rows
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


def _dense_flops(cfg: R.TwoTowerConfig) -> float:
    return 2.0 * sum(
        a * bb for a, bb in zip((2 * cfg.embed_dim,) + cfg.tower_mlp[:-1],
                                cfg.tower_mlp)) + 2.0 * sum(
        a * bb for a, bb in zip((cfg.embed_dim,) + cfg.tower_mlp[:-1],
                                cfg.tower_mlp))


def _unit(shape, gen, device) -> torch.Tensor:
    x = common.normal(shape, gen, device)
    return x if x.device.type == "meta" else \
        x / x.norm(dim=-1, keepdim=True)


def build_bundle(cfg: R.TwoTowerConfig, shape: str, axes: SH.Axes = None,
                 *, n_dp: int = 1, smoke: bool = False, shape_overrides=None,
                 **kw) -> common.StepBundle:
    """The bundle of any of the four shapes (see the module docstring)."""
    axes = axes or SH.Axes()
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    b = sp["batch"]
    i32 = torch.int32
    pspecs = SH.two_tower_param_specs(cfg, axes)
    dp = axes.dp
    dense_flops = _dense_flops(cfg)

    def init(seed, device=None):
        return R.two_tower_init(cfg, seed, device)

    if sp["kind"] == "train":
        structs = {"user_id": common.struct((b,), i32),
                   "item_id": common.struct((b,), i32),
                   "history": common.struct((b, cfg.history_len), i32)}
        ospecs = SH.lm_opt_specs("adamw", pspecs)
        return common.StepBundle(
            arch="two-tower-retrieval", shape=shape, kind="train",
            step_fn=common.simple_train_step(
                lambda model, batch: R.two_tower_loss(model, batch)),
            init_model=lambda seed, device=None: init(
                seed, device).requires_grad_(True),
            make_optimizer=common.adamw_constant(1e-3),
            batch_structs=structs,
            in_specs=(pspecs, ospecs,
                      {k: P(dp) if len(v.shape) == 1 else P(dp, None)
                       for k, v in structs.items()}),
            out_specs=(pspecs, ospecs, None), donate_argnums=(0, 1),
            make_args=lambda seed, device=None: common.synth_args(
                structs, {"user_id": cfg.user_vocab,
                          "item_id": cfg.item_vocab,
                          "history": cfg.item_vocab}, seed, device),
            meta=dict(model_flops=3.0 * b * dense_flops
                      + 2.0 * b * b * cfg.tower_mlp[-1],
                      scan_trip_count=1, params=cfg.param_count(),
                      tokens=b))

    # serving replicates every parameter: pure data-parallel inference,
    # no collective a request
    if sp.get("replicate_params", True):
        pspecs = common.replicate_specs(pspecs)
    user = (common.struct((b,), i32),
            common.struct((b, cfg.history_len), i32))

    def users(gen, device):
        return (common.field_ids((b,), cfg.user_vocab, gen, device),
                common.field_ids((b, cfg.history_len), cfg.item_vocab, gen,
                                 device))

    if shape != "retrieval_cand":
        flat = axes.data + (axes.model,)

        def make_args(seed, device=None):
            gen = common.seeded(device, seed)
            return users(gen, device) + (
                common.field_ids((b,), cfg.item_vocab, gen, device),)

        return common.StepBundle(
            arch="two-tower-retrieval", shape=shape, kind="serve",
            step_fn=common.serve(pairwise_step), init_model=init,
            arg_structs=user + (common.struct((b,), i32),),
            in_specs=(pspecs, P(flat), P(flat, None), P(flat)),
            out_specs=None, make_args=make_args,
            meta=dict(model_flops=b * dense_flops, scan_trip_count=1,
                      params=cfg.param_count(), tokens=b))

    n_cand, k = sp["n_candidates"], sp["k"]
    e = cfg.tower_mlp[-1]
    variant = sp.get("variant", "brute")
    shards = sp.get("shards", 16)

    def mesh_for(t):
        return retrieval_mesh(shards, devices=[t.device] * shards)

    if variant in ("toploc_ivf", "toploc_ivf_dist"):
        p_parts = sp.get("partitions", 1024)
        lmax = sp.get("lmax", toploc_lmax(n_cand, p_parts))
        h = sp.get("h", 128)
        nprobe = sp.get("nprobe", 32)
        if variant == "toploc_ivf":
            def step(model, user_id, history, list_vecs, list_ids,
                     cache_vecs, cache_ids):
                return toploc_ivf_step(model, user_id, history, list_vecs,
                                       list_ids, cache_vecs, cache_ids,
                                       k=k, nprobe=nprobe)
            note = ("TopLoc_IVF-pruned candidate scan (hillclimb cell #3, "
                    "paper technique)")
        else:
            def step(model, user_id, history, list_vecs, list_ids,
                     cache_vecs, cache_ids):
                return toploc_ivf_dist_step(
                    model, user_id, history, list_vecs, list_ids,
                    cache_vecs, cache_ids, k=k, nprobe=nprobe,
                    mesh=mesh_for(cache_vecs))
            note = "TopLoc + shard-local scan + k-merge"

        def make_args(seed, device=None):
            gen = common.seeded(device, seed)
            ids = common.field_ids((p_parts, lmax), n_cand, gen, device)
            if ids.device.type != "meta":
                pad = torch.rand((p_parts, lmax), generator=gen,
                                 device=ids.device) < 0.2
                ids = torch.where(pad, -1, ids)
            return users(gen, device) + (
                _unit((p_parts, lmax, e), gen, device), ids,
                _unit((h, e), gen, device),
                common.field_ids((h,), p_parts, gen, device))

        work = h * e + nprobe * lmax * e
        return common.StepBundle(
            arch="two-tower-retrieval", shape=shape, kind="serve",
            step_fn=common.serve(step), init_model=init,
            arg_structs=user + (common.struct((p_parts, lmax, e),
                                              torch.float32),
                                common.struct((p_parts, lmax), i32),
                                common.struct((h, e), torch.float32),
                                common.struct((h,), i32)),
            in_specs=(pspecs, P(), P(), P(axes.model, None, None),
                      P(axes.model, None), P(), P()),
            out_specs=None, make_args=make_args,
            meta=dict(model_flops=dense_flops + 2.0 * work,
                      scan_trip_count=1, params=cfg.param_count(),
                      tokens=nprobe * lmax, note=note))

    if variant == "dist_topk":
        def step(model, user_id, history, corpus):
            return dist_topk_step(model, user_id, history, corpus, k,
                                  mesh_for(corpus))
    else:
        def step(model, user_id, history, corpus):
            return retrieval_step(model, user_id, history, corpus, k)

    def make_args(seed, device=None):
        gen = common.seeded(device, seed)
        return users(gen, device) + (_unit((n_cand, e), gen, device),)

    return common.StepBundle(
        arch="two-tower-retrieval", shape=shape, kind="serve",
        step_fn=common.serve(step), init_model=init,
        arg_structs=user + (common.struct((n_cand, e), torch.float32),),
        in_specs=(pspecs, P(), P(), P(axes.model, None)), out_specs=None,
        make_args=make_args,
        meta=dict(model_flops=dense_flops + 2.0 * n_cand * e,
                  scan_trip_count=1, params=cfg.param_count(),
                  tokens=n_cand,
                  note=f"variant={variant}; TopLoc_IVF variant via "
                       "shape_overrides (hillclimb cell #3)"))


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


def toploc_ivf_step(model: R.TwoTower, user_id, history, list_vecs,
                    list_ids, cache_vecs: torch.Tensor,
                    cache_ids: torch.Tensor, *, k: int, nprobe: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand, variant ``toploc_ivf`` (``:188-234``): the
    session's cached centroids scored, their top ``nprobe`` selected,
    the selected lists' rows scored (ids < 0 masked to -inf) and the top
    k taken over them flat, in ``lax.top_k`` order.  (values (1, k),
    int32 ids (1, k)); plain torch, as the reference's is XLA."""
    u = model.user_tower(user_id, history)                       # (1, e)
    _, sel_local = topk(u @ cache_vecs.T, nprobe)
    sel = cache_ids[sel_local].long()                            # (1, np)
    lv, li = list_vecs[sel[0]], list_ids[sel[0]]                 # (np, L, e)
    scores = torch.einsum("nld,bd->bnl", lv, u)
    scores = torch.where(li[None] >= 0, scores, float("-inf"))
    v, pos = topk(scores.reshape(1, -1), k)
    return v, li.reshape(1, -1).gather(-1, pos.long())


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
