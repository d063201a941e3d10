"""Collectives over the shards of a retrieval mesh, and two building
blocks of sharded retrieval.

Port of ``repro/distributed/collectives.py``.  The reference's
collectives run inside ``shard_map``; the port is one process, so a
collective is a function over the shards' tensors: ``all_gather``
copies each to the leader and concatenates them in shard order,
``psum`` sums them in shard order there.  What moves is what the
reference's collectives move: k entries a shard for a top-k merge, one
row of scores for a sum.

``sharded_corpus_topk`` / ``sharded_ivf_probe`` are the reference's
building blocks: a corpus split by rows, or posting lists split by
partition, each shard reduced to its own top-k and one k-wide merge
(``core.topk.distributed_topk``, ties shard-major).  The served path's
scans, which keep single-device ties, are in ``retrieval``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.topk import distributed_topk, topk
from repro_torch.distributed.sharding import Shards, split_rows
from repro_torch.kernels import ref as _kref


def on_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there already (no copy)."""
    return t if t.device == torch.device(device) else t.to(device)


def all_gather(tensors: Sequence[torch.Tensor], device, dim: int = -1
               ) -> torch.Tensor:
    """The shards' tensors on ``device``, concatenated in shard order."""
    return torch.cat([on_device(t, device) for t in tensors], dim)


def psum(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' tensors summed in shard order on ``device``.  One
    tensor is returned as it is (the sum over one device)."""
    total = None
    for t in tensors:
        t = on_device(t, device)
        total = t if total is None else total + t
    return total


def sharded_corpus_topk(mesh, corpus, queries: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries @ corpus.T`` with the corpus split by
    rows over the mesh's shards (``corpus`` a ``Shards``, or a tensor
    split here).  Returns (scores (B, k), int32 global ids (B, k)) on
    the queries' device."""
    if not isinstance(corpus, Shards):
        corpus = split_rows(corpus, mesh.shard_devices)
    leader = queries.device
    vs, ids = [], []
    for s, part in enumerate(corpus.parts):
        if not part.shape[0]:
            continue
        q = on_device(queries, part.device)
        v, i = topk(q @ part.T, min(k, part.shape[0]))
        vs.append(v)
        ids.append((i + corpus.bounds(s)[0]).to(torch.int32))
    v, i = distributed_topk([on_device(v, leader) for v in vs],
                            [on_device(i, leader) for i in ids], k)
    return v, i


def sharded_ivf_probe(mesh, list_vecs, list_ids, queries: torch.Tensor,
                      sel: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed IVF list scan: posting lists split by partition over
    the mesh's shards (``Shards``, or tensors split here); each shard
    scans the selected lists it owns (the others masked), then a k-wide
    merge.  ``sel`` (B, nprobe) holds global partition ids."""
    devs = mesh.shard_devices
    if not isinstance(list_vecs, Shards):
        list_vecs = split_rows(list_vecs, devs)
    if not isinstance(list_ids, Shards):
        list_ids = split_rows(list_ids, devs)
    leader = queries.device
    b = queries.shape[0]
    vs, ids = [], []
    for s, (lv, li) in enumerate(zip(list_vecs.parts, list_ids.parts)):
        if not lv.shape[0]:
            continue
        lo, hi = list_vecs.bounds(s)
        q = on_device(queries, lv.device)
        sl = on_device(sel, lv.device).long() - lo
        own = (sl >= 0) & (sl < hi - lo)
        ss = sl.clamp(0, hi - lo - 1)
        flat_i = torch.where(own[..., None], li[ss], -1).reshape(b, -1)
        flat_v = torch.where(flat_i >= 0, _kref.list_scores(q, lv, ss),
                             float("-inf"))
        v, pos = topk(flat_v, k)
        vs.append(on_device(v, leader))
        ids.append(on_device(flat_i.gather(-1, pos), leader))
    return distributed_topk(vs, ids, k)
