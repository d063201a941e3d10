"""Corpus-sharded TopLoc retrieval over a grid of devices.

Port of ``repro/distributed/retrieval.py``.  The corpus is split over
the ``model`` axis of a ``RetrievalMesh`` (a grid of ``torch.device``s
in one process, as the reference's mesh is a grid of the devices of one
controller):

  * **IVF / IVF-PQ** — posting lists (float vectors or PQ codes) split
    by partition (``sharding.ivf_index_specs`` / ``ivf_pq_index_specs``);
    centroids and codebooks stay on the leader, shard 0.  Each shard
    scans the selection with only its own lists unmasked, reduces to a
    local top-k, and one k-wide gather + ordered merge gives the global
    result.
  * **HNSW** — the vectors split by node row (``hnsw_index_specs``); the
    adjacency stays on the leader, where the beam traversal runs, and a
    candidate's score is its owner's dot summed with the other shards'
    exact zeros.
  * The IVF-PQ re-rank corpus is split by row the same way.

The session state (centroid cache, Eq. 1 drift proxy, refresh gate,
entry point) lives on the leader; only the corpus-sized scans run per
shard.  Shard s owns the block [s·⌈p/S⌉, (s+1)·⌈p/S⌉) of lists (of rows
for the re-rank corpus and the HNSW vectors); the last block may be
shorter.  Where every shard lies on the device of the tensor it is cut
from, each is a view of it (nothing copied); otherwise each is a tensor
of its own (``sharding.split_rows``, ``placed_bytes``), so the leader
keeps only its share.

A shard scans every probe of the selection with foreign probes clipped
to one of its own lists and masked (the reference's dense formulation);
the fused kernels (rows 6 and 7) skip a masked list, so their work per
shard is what it owns.

Bit-identity contract (the reference's, ``retrieval.py:40-55``): for
all three backends, sharded results — scores, ids, every ``TurnStats``
counter — equal the single-device path bit for bit at any shard count:

  1. a candidate is scored by the same arithmetic as on one device
     (same gather, same product shapes);
  2. cross-shard float merges move selected candidates, or sum one
     non-zero with exact zeros (``collectives.psum``: -0.0 becomes
     +0.0, nothing else changes);
  3. top-k merges use ``core.topk.distributed_topk_ordered``, which
     breaks ties by the candidate's flat position in the single-device
     scan, ``probe·lmax + offset`` over the whole selection.

The fused f32 scan keeps that numbering, so sharded fused turns equal
the unsharded fused ones; the quantised IVF scan's position is the
candidate's rank (``kernels/ops.py`` ``fused_scan``), so there the
merge breaks ties as the reference's does, by rank.  The sharded IVF-PQ
re-rank is the single-device multiply-reduce of the unfused path, so a
sharded fused IVF-PQ turn equals the unsharded *unfused* one bit for bit
and the unsharded fused one in ids and counters.

The scan plugins are frozen dataclasses that plug into the backends'
``scan`` / ``search`` fields (``shard_backend``); the serving engines
call it for ``ServingConfig.shards`` / ``mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hnsw as _hnsw
from repro_torch.core import ivf as _ivf
from repro_torch.core import pq as _pq
from repro_torch.core import toploc as _tl
from repro_torch.core.topk import distributed_topk_ordered, topk
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import all_gather, on_device, psum
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref

# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def canonical_device(device) -> torch.device:
    """A device with its index (``cuda`` → ``cuda:<current>``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class RetrievalMesh:
    """A grid of devices: ``grid[r][s]`` is shard s of replica group r.

    A device may appear more than once: the counterpart of the
    reference's forced host devices, which is how a single card (or the
    CPU) runs several shards.
    """
    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """``("model",)`` for one replica group (a 1-D mesh), else
        ``("replica", "model")``, the reference's names."""
        return ("model",) if len(self.grid) == 1 else ("replica", "model")

    @property
    def devices(self) -> np.ndarray:
        """The devices as an array of the mesh's shape."""
        arr = np.empty((len(self.grid), len(self.grid[0])), dtype=object)
        for r, row in enumerate(self.grid):
            for s, dev in enumerate(row):
                arr[r, s] = dev
        return arr if len(self.axis_names) == 2 else arr[0]

    @property
    def shape(self) -> Dict[str, int]:
        sizes = (len(self.grid), len(self.grid[0]))
        return dict(zip(self.axis_names, sizes[-len(self.axis_names):]))

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the shards of a single replica group."""
        if len(self.grid) != 1:
            raise ValueError(f"a mesh of {len(self.grid)} replica groups: "
                             f"split it with replica_submeshes")
        return self.grid[0]

    @property
    def leader(self) -> torch.device:
        """Shard 0 of the first replica group: where the session state,
        the centroid scoring and the merges run."""
        return self.grid[0][0]


def retrieval_mesh(shards: int, *, replicas: int = 1,
                   devices: Optional[Sequence] = None) -> RetrievalMesh:
    """A corpus mesh over the first ``replicas * shards`` devices of
    ``devices`` (default: the visible CUDA cards).  ``replicas == 1``
    gives the 1-D ``("model",)`` mesh; more, the 2-D ``("replica",
    "model")`` mesh of the serving tier, every replica group a whole
    sharded corpus (``replica_submeshes`` splits it).  ``devices`` may
    repeat a device."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devs = [canonical_device(d) for d in devices]
    if shards < 1 or replicas < 1 or replicas * shards > len(devs):
        raise ValueError(
            f"replicas={replicas} x shards={shards} needs "
            f"{max(replicas, 1) * max(shards, 1)} device(s) but "
            f"{len(devs)} available (pass devices=[...], which may repeat "
            "a device, for more shards than cards)")
    return RetrievalMesh(tuple(tuple(devs[r * shards:(r + 1) * shards])
                               for r in range(replicas)))


def engine_mesh(shards: int, device, *, replicas: int = 1
                ) -> RetrievalMesh:
    """The mesh of ``ServingConfig.shards`` for an engine on ``device``:
    the first visible cards on CUDA, ``device`` repeated elsewhere."""
    devices = (None if torch.device(device).type == "cuda"
               else [device] * (replicas * shards))
    return retrieval_mesh(shards, replicas=replicas, devices=devices)


def replica_submeshes(mesh: RetrievalMesh) -> List[RetrievalMesh]:
    """Split a 2-D ``(replica, model)`` mesh into per-replica 1-D corpus
    meshes.  A 1-D mesh is one replica group: ``[mesh]``."""
    if len(mesh.grid) == 1:
        return [mesh]
    return [RetrievalMesh((row,)) for row in mesh.grid]


def check_mesh(mesh, device) -> RetrievalMesh:
    """``mesh`` as an engine on ``device`` takes it: a one-replica
    ``RetrievalMesh`` led by ``device``."""
    if not isinstance(mesh, RetrievalMesh):
        raise TypeError(f"mesh must be a RetrievalMesh (retrieval_mesh), "
                        f"got {type(mesh).__name__}")
    if len(mesh.grid) != 1:
        raise ValueError(f"an engine serves one replica group, the mesh "
                         f"has {len(mesh.grid)} (replica_submeshes)")
    if mesh.leader != canonical_device(device):
        raise ValueError(f"the mesh is led by {mesh.leader}, the engine "
                         f"runs on {canonical_device(device)}")
    return mesh


# ---------------------------------------------------------------------------
# index placement
# ---------------------------------------------------------------------------


def _place(mesh: RetrievalMesh, index, specs):
    """Each field of ``index`` by its spec: split by rows over the shard
    devices where the spec splits its first dimension, else on the
    leader."""
    devs = mesh.shard_devices
    out = {}
    for name, x in index._asdict().items():
        spec = getattr(specs, name)
        if x is None:
            out[name] = None
        elif spec and spec[0] is not None:
            out[name] = SH.split_rows(x, devs)
        else:
            out[name] = on_device(x, mesh.leader)
    return type(index)(**out)


def placed_bytes(index) -> int:
    """Bytes a placement allocated for its shards (0 where every shard
    is a view of the unsharded tensor)."""
    return sum(x.added for x in index if isinstance(x, SH.Shards))


def shard_ivf_index(mesh: RetrievalMesh, index: _ivf.IVFIndex
                    ) -> _ivf.IVFIndex:
    """An ``IVFIndex`` placed per ``sharding.ivf_index_specs``: the
    posting lists as ``Shards`` (a short last block where S does not
    divide p; centroids whole, so no list past p is ever selected)."""
    return _place(mesh, index, SH.ivf_index_specs(SH.Axes()))


def shard_ivf_pq_index(mesh: RetrievalMesh, index: _pq.IVFPQIndex
                       ) -> _pq.IVFPQIndex:
    """An ``IVFPQIndex`` placed per ``ivf_pq_index_specs``: code lists
    split like the float lists, the re-rank corpus by row."""
    return _place(mesh, index, SH.ivf_pq_index_specs(SH.Axes()))


def shard_hnsw_index(mesh: RetrievalMesh, index: _hnsw.HNSWIndex
                     ) -> _hnsw.HNSWIndex:
    """An ``HNSWIndex`` placed per ``hnsw_index_specs``: the vectors
    split by row, the graph (and tombstones) on the leader."""
    return _place(mesh, index, SH.hnsw_index_specs(SH.Axes()))


def place_segmented(mesh: RetrievalMesh, seg):
    """A ``core.segment.SegmentedIndex``'s delta rows and tombstones on
    the leader, where the delta scan and the merge run (the reference
    replicates them: the delta is ``cap`` rows, scanned whole against a
    top-k the leader already holds).  The base is placed separately
    (``shard_backend``)."""
    return seg._replace(delta_vecs=on_device(seg.delta_vecs, mesh.leader),
                        delta_ids=on_device(seg.delta_ids, mesh.leader),
                        tombstone=on_device(seg.tombstone, mesh.leader))


# ---------------------------------------------------------------------------
# sharded scans (plugins of the backends' scan / search fields)
# ---------------------------------------------------------------------------


def local_selection(sel: torch.Tensor, lo: int, hi: int, dev):
    """A shard's view of a global selection: ``own`` (B, nprobe) bool,
    and the probes clipped into its lists [0, hi - lo)."""
    s_local = on_device(sel, dev).long() - lo
    own = (s_local >= 0) & (s_local < hi - lo)
    return own, s_local.clamp(0, hi - lo - 1)


def _owned_sizes(sizes: torch.Tensor, own: torch.Tensor,
                 ss: torch.Tensor) -> torch.Tensor:
    """(B,) the real entries of the lists a shard owns in the selection."""
    return torch.where(own, sizes[ss], 0).sum(-1)


@dataclasses.dataclass(frozen=True)
class ShardedIVFScan:
    """Drop-in for ``ivf._scan_lists`` over partition-split lists.

    Each shard scans the selection with its foreign probes clipped to a
    local list and masked (ids -1), with the single-device scan's
    arithmetic and flat positions, reduces to a local top-k, and the
    ordered k-wide merge gives the global top-k; ``real`` sums the
    owned list sizes (int, exact in any order).  ``fused`` (a
    ``toploc.FusedTurn``) scans each shard with ``ops.fused_scan(...,
    own=own)`` (row 6).  The shards' devices are those of the placed
    index's parts.
    """
    fused: Optional[object] = None

    def __call__(self, index: _ivf.IVFIndex, queries: torch.Tensor,
                 sel: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        lv, li, ls = index.list_vecs, index.list_ids, index.list_sizes
        leader, fused = queries.device, self.fused
        vs, ps, ids, reals = [], [], [], []
        for s in range(len(lv.parts)):
            lo, hi = lv.bounds(s)
            if hi == lo:
                continue
            dev = lv.parts[s].device
            own, ss = local_selection(sel, lo, hi, dev)
            q = on_device(queries, dev)
            if fused is not None:
                v, i, pos = _kops.fused_scan(
                    q, lv.parts[s], li.parts[s], ss.to(torch.int32), k,
                    own=own, over=fused.over, precision=fused.precision,
                    device=dev)
            else:
                v, i, pos = _kref.fused_scan_ivf(q, lv.parts[s], li.parts[s],
                                                 ss, own, k=k)
            vs.append(v)
            ps.append(pos)
            ids.append(i)
            reals.append(_owned_sizes(ls.parts[s], own, ss))
        top_v, top_i = distributed_topk_ordered(
            [all_gather(vs, leader)], [all_gather(ps, leader)],
            [all_gather(ids, leader)], k)
        return top_v, top_i, psum(reals, leader).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ShardedPQScan:
    """Drop-in for ``toploc._scan_lists_pq`` over a split PQ corpus.

    The ADC tables are built once on the leader (``toploc._adc_tables``);
    each shard ADC-scans its own code lists (the plain
    ``ref.fused_scan_pq`` without re-rank, or ``ops.fused_scan_pq(...,
    own=own, fuse_rerank=False)``, row 7) to depth r with flat
    positions, and the ordered merge keeps the global top r.  The exact
    re-rank is owner-computes: each shard scores the candidate rows it
    owns with the single-device multiply-reduce (``ref.gemv_rows``, a
    matrix–vector product a query) and gives exact zeros elsewhere; the
    leader sums them in shard order, takes the top k and counts
    ``code_d`` / ``rerank_d``.
    """
    fused: Optional[object] = None

    def __call__(self, index: _pq.IVFPQIndex, queries: torch.Tensor,
                 sel: torch.Tensor, k: int, rerank: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        lc, li, ls = index.list_codes, index.list_ids, index.list_sizes
        dv = index.doc_vecs
        leader, fused = queries.device, self.fused
        r = _kops._fused_depth(k, sel.shape[1] * index.lmax, rerank)
        tables = _tl._adc_tables(index, queries)
        vs, ps, ids, codes = [], [], [], []
        for s in range(len(lc.parts)):
            lo, hi = lc.bounds(s)
            if hi == lo:
                continue
            dev = lc.parts[s].device
            own, ss = local_selection(sel, lo, hi, dev)
            tab, q = on_device(tables, dev), on_device(queries, dev)
            if fused is not None:
                # the corpus is not read without the fused re-rank
                cv, ci, cp = _kops.fused_scan_pq(
                    tab, q, lc.parts[s], li.parts[s], ss.to(torch.int32),
                    dv.parts[s], k, rerank=rerank, own=own,
                    precision=fused.precision, fuse_rerank=False,
                    device=dev)
            else:
                cv, ci, cp = _kref.fused_scan_pq(
                    tab, q, lc.parts[s], li.parts[s], ss, own, None, k=k,
                    r=r, rerank=False)
            vs.append(cv)
            ps.append(cp)
            ids.append(ci)
            codes.append(_owned_sizes(ls.parts[s], own, ss))
        _, cand = distributed_topk_ordered(
            [all_gather(vs, leader)], [all_gather(ps, leader)],
            [all_gather(ids, leader)], r)
        # exact re-rank: the owner's multiply-reduce, exact zeros elsewhere
        exact = []
        for s, part in enumerate(dv.parts):
            lo, hi = dv.bounds(s)
            c = on_device(cand, part.device).long() - lo
            own_doc = (c >= 0) & (c < hi - lo)
            if hi == lo:
                exact.append(torch.zeros(cand.shape, dtype=torch.float32,
                                         device=part.device))
                continue
            rows = part[c.clamp(0, hi - lo - 1)]             # (B, r, d)
            ex = _kref.gemv_rows(rows, on_device(queries, part.device))
            exact.append(torch.where(own_doc, ex, 0.0))
        ex = psum(exact, leader)
        ex = torch.where(cand >= 0, ex, float("-inf"))
        top_v, pos = topk(ex, k)
        top_i = cand.gather(-1, pos)
        rerank_d = (cand >= 0).sum(-1).to(torch.int32)
        return (top_v, top_i, psum(codes, leader).to(torch.int32),
                rerank_d)


@dataclasses.dataclass(frozen=True)
class ShardedHNSWSearch:
    """Drop-in for ``hnsw.search`` over row-split vectors.

    The traversal runs once, on the leader, and every score it branches
    on is the owner's dot summed with the other shards' exact zeros
    (``ops.hnsw_search_sharded``: the kernel's sharded instance on CUDA
    tensors, ``ref.hnsw_search`` with ``ref.hnsw_sharded_dots`` on CPU
    tensors; one shard is the unsharded search).
    """

    def __call__(self, index: _hnsw.HNSWIndex, queries: torch.Tensor, *,
                 ef: int, k: int,
                 entry_override: Optional[torch.Tensor] = None,
                 use_entry_override: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        vec = index.vectors
        return _kops.hnsw_search_sharded(
            vec.parts, vec.per, index.adj0, index.upper_adj,
            index.entry_point, queries,
            entry_override if use_entry_override else None, ef=ef, k=k,
            deleted=index.deleted, device=queries.device)


# ---------------------------------------------------------------------------
# backend registry wiring
#
# A table maps each registered ``core.backend`` name to (index placement,
# scan plugin class, the backend field the plugin plugs into);
# ``shard_backend`` is the one call the serving engines make.
# ---------------------------------------------------------------------------

_SHARDING_REGISTRY: dict = {}


def register_sharding(name: str, shard_index, plugin_cls,
                      field: str = "scan") -> None:
    """Teach ``shard_backend`` how to place backend ``name`` on a mesh."""
    _SHARDING_REGISTRY[name] = (shard_index, plugin_cls, field)


register_sharding("ivf", shard_ivf_index, ShardedIVFScan, "scan")
register_sharding("ivf_pq", shard_ivf_pq_index, ShardedPQScan, "scan")
register_sharding("hnsw", shard_hnsw_index, ShardedHNSWSearch, "search")


def shard_index(mesh: RetrievalMesh, backend, index):
    """``index`` placed on ``mesh`` as backend ``backend`` shards it
    (unchanged for a backend with no registered sharding)."""
    entry = _SHARDING_REGISTRY.get(backend.name)
    return index if entry is None else entry[0](mesh, index)


def shard_backend(mesh: RetrievalMesh, backend, index):
    """Place ``index`` on ``mesh`` and plug the matching sharded scan
    into ``backend`` (``fused`` copied into the plugin).  Backends with
    no registered sharding (Exact) pass through unchanged.  Returns
    (backend', index')."""
    entry = _SHARDING_REGISTRY.get(backend.name)
    if entry is None:
        return backend, index
    place, plugin_cls, field = entry
    plugin = (plugin_cls(fused=getattr(backend, "fused", None))
              if any(f.name == "fused" for f in dataclasses.fields(plugin_cls))
              else plugin_cls())
    return (dataclasses.replace(backend, **{field: plugin}),
            place(mesh, index))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def per_shard_list_work(list_sizes: np.ndarray, sel: np.ndarray,
                        n_shards: int) -> np.ndarray:
    """Posting-list scan work each shard does for a probe selection.

    ``list_sizes`` (p,) real list sizes; ``sel`` any shape of selected
    partition ids; shard s owns the partition block
    ``[s·⌈p/S⌉, (s+1)·⌈p/S⌉)``, as the sharded scans do.  Returns (S,)
    int64: real float / code distances each shard computes.
    """
    sizes = np.asarray(list_sizes)
    sel = np.asarray(sel).reshape(-1)
    p_local = -(-len(sizes) // n_shards)
    owner = sel // p_local
    work = np.zeros(n_shards, np.int64)
    for s in range(n_shards):
        work[s] = sizes[sel[owner == s]].sum()
    return work
