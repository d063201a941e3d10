"""Index placement specs over a retrieval mesh.

Port of ``repro/distributed/sharding.py:30-60`` and ``:295-341``: the
axis binding ``Axes`` / ``from_mesh`` and the specs of the three
retrieval indexes.  A spec is a ``P`` per field, one entry per
dimension: the mesh axis that dimension is split over, or None.  A
field whose spec names no axis lies whole on the replica's leader
device (the reference replicates it over the mesh); the port runs the
session math and the merges there, so one copy is all it reads.

The model parameter specs of the reference (``:62-293``: LM, GIN,
recsys, optimizer) come with multi-process training (ROADMAP Queue 1,
item 7, part 3); one-card training needs none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


class P(tuple):
    """A partition spec: per dimension, the mesh axis it is split over
    (None: not split), the counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical → mesh axis binding.

    ``replica`` names the serving tier's replica axis of a 2-D
    ``(replica, shard)`` retrieval mesh (None on 1-D meshes).  The index
    specs never name it: every replica group holds a whole sharded
    corpus.
    """
    data: Tuple[str, ...] = ("data",)
    model: str = "model"
    replica: Optional[str] = None


def from_mesh(mesh) -> Axes:
    names = mesh.axis_names
    data = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else names[-1]
    return Axes(data=data, model=model,
                replica="replica" if "replica" in names else None)


def ivf_index_specs(ax: Axes) -> Any:
    """Centroids on the leader; posting lists split by partition over
    the model axis (each shard scans its own lists; the merge is one
    gather of k entries a shard, ``core.topk.distributed_topk_ordered``)."""
    from repro_torch.core.ivf import IVFIndex
    tp = ax.model
    return IVFIndex(
        centroids=P(None, None),
        list_vecs=P(tp, None, None),
        list_ids=P(tp, None),
        list_sizes=P(tp),
    )


def ivf_pq_index_specs(ax: Axes) -> Any:
    """IVF-PQ: coarse centroids and codebooks on the leader (small, read
    every turn); code lists split by partition like the float lists;
    the exact re-rank corpus split by document row, so each device
    holds 1/S of the floats (the owner computes the re-rank dot, the
    sum over shards merges)."""
    from repro_torch.core.pq import IVFPQIndex
    tp = ax.model
    return IVFPQIndex(
        centroids=P(None, None),
        codewords=P(None, None, None),
        list_codes=P(tp, None, None),
        list_ids=P(tp, None),
        list_sizes=P(tp),
        doc_vecs=P(tp, None),
    )


def hnsw_index_specs(ax: Axes) -> Any:
    """HNSW: the vectors (4·d bytes a node) split by node row over the
    model axis; the adjacency, the entry point, the levels and the
    tombstones on the leader, where the traversal runs: only the
    scoring of candidates is distributed."""
    from repro_torch.core.hnsw import HNSWIndex
    tp = ax.model
    return HNSWIndex(
        vectors=P(tp, None),
        adj0=P(None, None),
        upper_adj=P(None, None, None),
        entry_point=P(),
        node_level=P(None),
        deleted=P(None),
    )


# ---------------------------------------------------------------------------
# a field split by rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shards:
    """A tensor split by rows over a mesh axis: shard s holds rows
    [s·per, min((s+1)·per, n)) (the last shard may be shorter, or empty)
    in ``parts[s]``, on shard s's device.

    ``whole`` is the unsharded tensor when every part is a view of it
    (shards that share its device: nothing was copied), else None;
    ``added`` counts the bytes the placement allocated (every part,
    where the parts are not views).  ``shape``,
    ``dtype`` and ``device`` (the leader's, shard 0's) read like a
    tensor's, so the backends' shape logic runs unchanged; indexing by
    a tensor of global ids gathers those rows onto the leader.
    """
    parts: Tuple[torch.Tensor, ...]
    per: int
    whole: Optional[torch.Tensor] = None
    added: int = 0

    @property
    def n(self) -> int:
        return sum(p.shape[0] for p in self.parts)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n,) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def bounds(self, s: int) -> Tuple[int, int]:
        """Global rows [lo, hi) of shard s."""
        lo = min(s * self.per, self.n)
        return lo, lo + self.parts[s].shape[0]

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (any shape, each in [0, n)) on the leader, each
        copied from its owner."""
        if self.whole is not None:
            return self.whole[ids]
        out = None
        for s, part in enumerate(self.parts):
            if not part.shape[0]:
                continue
            lo, hi = self.bounds(s)
            loc = ids.to(part.device).long() - lo
            own = (loc >= 0) & (loc < hi - lo)
            rows = part[loc.clamp(0, hi - lo - 1)].to(self.device)
            own = own.to(self.device).reshape(
                own.shape + (1,) * (rows.dim() - own.dim()))
            out = rows if out is None else torch.where(own, rows, out)
        return out


def split_rows(x: torch.Tensor, devices) -> Shards:
    """``x`` split by rows over ``devices`` (one shard each), in blocks
    of ⌈n/S⌉ rows, the last shorter.  Where every shard lies on ``x``'s
    device each is a view of it (no copy).  Otherwise every shard is a
    tensor of its own: the ones elsewhere copied there, the ones on
    ``x``'s device cloned, so that no shard keeps the whole of ``x``
    alive and a device holds only its shards once ``x`` is dropped."""
    s = len(devices)
    n = x.shape[0]
    per = max(1, -(-n // s))
    views = [x[min(j * per, n):min((j + 1) * per, n)] for j in range(s)]
    if all(torch.device(dev) == x.device for dev in devices):
        return Shards(tuple(views), per, x, 0)
    parts = tuple(v.to(dev, copy=True) for v, dev in zip(views, devices))
    return Shards(parts, per, None,
                  sum(p.numel() * p.element_size() for p in parts))
