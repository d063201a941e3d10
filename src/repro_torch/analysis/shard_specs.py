"""Pass ``shard`` — where a sharded index's leaves and operands live.

Port of ``repro/analysis/shard_specs.py``.  The reference patches
``shard_map`` and compares its ``in_specs`` with the leaves' placements.
The port has no ``shard_map``: a sharded index is placed by
``distributed.retrieval.shard_index`` (a ``sharding.Shards`` split by
rows over the shard devices, or a whole tensor on the leader) and its
scan plugin loops over the shards itself.  So this pass checks where
every leaf and operand actually lives.  For each entry of
``retrieval._SHARDING_REGISTRY`` it builds a tiny index on the CPU,
places it on a 2-shard CPU ``RetrievalMesh`` as ``shard_backend`` does,
drives the plugin once with every per-shard scan it calls recorded
(``SHARD_CALLS``), and builds a ``SessionStore(mesh=)``:

  SS501  an index leaf with no placement: not a whole tensor on the
         leader, nor ``Shards`` on the mesh's shard devices (every turn
         would copy it, or fail).
  SS502  replicated state partitioned (or vice versa): a
         ``SHARDED_FIELDS`` leaf (posting lists, code lists, doc rows)
         not split by rows over the mesh; a ``REPLICATED_FIELDS`` leaf
         (centroids, codebooks, adjacency, entry metadata) not whole on
         the leader, where the session math of every shard runs; a
         query, selection or table that a per-shard scan sees only part
         of the batch of; an output not whole on the leader; a
         ``SessionStore(mesh=)`` slab leaf not whole on the leader.
  SS503  plugin not a frozen dataclass (the backends holding it are),
         a backend with the plugin plugged in that is unhashable, or a
         plugin registered against a field the backend lacks.
  SS500  the probe failed, or the plugin reached no per-shard scan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import Finding

PASS_ID = "shard-specs"

# index fields that must stay replicated / must shard (dim 0)
REPLICATED_FIELDS = {"centroids", "codewords", "adj0", "upper_adj",
                     "entry_point", "node_level", "deleted",
                     "delta_vecs", "delta_ids", "tombstone"}
SHARDED_FIELDS = {"list_vecs", "list_ids", "list_sizes", "list_codes",
                  "doc_vecs", "vectors"}

#: the per-shard scans the plugins call, as (module, attribute): the
#: port's counterpart of the reference's recorded ``shard_map``
SHARD_CALLS = (("repro_torch.kernels.ref", "fused_scan_ivf"),
               ("repro_torch.kernels.ops", "fused_scan"),
               ("repro_torch.kernels.ref", "fused_scan_pq"),
               ("repro_torch.kernels.ops", "fused_scan_pq"),
               ("repro_torch.kernels.ops", "hnsw_search_sharded"))

_B, _K, _SHARDS = 4, 4, 2
_KNOBS = {"ivf": dict(h=4, nprobe=3), "ivf_pq": dict(h=4, nprobe=3,
                                                     rerank=8),
          "hnsw": dict(ef=8)}


@dataclasses.dataclass
class ShardCall:
    name: str
    args: Tuple
    kwargs: Dict[str, Any]


@contextlib.contextmanager
def record_shard_calls(records: List[ShardCall]):
    """Wrap each ``SHARD_CALLS`` function to capture its operands."""
    saved = []
    for modname, attr in SHARD_CALLS:
        mod = importlib.import_module(modname)
        real = getattr(mod, attr)

        def fake(*args, _real=real, _name=f"{modname}.{attr}", **kwargs):
            records.append(ShardCall(_name, args, kwargs))
            return _real(*args, **kwargs)

        saved.append((mod, attr, real))
        setattr(mod, attr, fake)
    try:
        yield
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


@functools.lru_cache(maxsize=1)
def _tiny_indexes() -> Dict[str, Any]:
    """IVF (p = 6), IVF-PQ (m = 2) and HNSW indexes over 96 docs, d = 8,
    on the CPU."""
    from repro_torch.core import hnsw, ivf, pq
    x = np.random.default_rng(0).normal(size=(96, 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    ivf_index = ivf.build(xt, 6, iters=3, seed=0, device="cpu")
    book = pq.train(xt, 2, iters=3, n_codes=8,
                    generator=torch.Generator().manual_seed(0))
    return {"ivf_index": ivf_index,
            "ivf_pq_index": pq.build_ivf_pq(ivf_index, xt, book,
                                            device="cpu"),
            "hnsw_index": hnsw.build(x, m=4, ef_construction=16,
                                     device="cpu")}


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _index_ids(index) -> set:
    """ids of every tensor of a placed index (``Shards`` parts too)."""
    from repro_torch.distributed.sharding import Shards
    out = set()
    for leaf in index:
        if isinstance(leaf, Shards):
            out.update(id(p) for p in leaf.parts)
            if leaf.whole is not None:
                out.add(id(leaf.whole))
        elif isinstance(leaf, torch.Tensor):
            out.add(id(leaf))
    return out


def _check_leaves(where: str, index, placed, mesh,
                  findings: List[Finding]) -> None:
    from repro_torch.distributed.retrieval import canonical_device
    from repro_torch.distributed.sharding import Shards
    devs = [canonical_device(d) for d in mesh.shard_devices]
    leader = mesh.leader
    for fname in type(placed)._fields:
        leaf, orig = getattr(placed, fname), getattr(index, fname)
        if leaf is None:
            continue
        if isinstance(leaf, Shards):
            on_mesh = (len(leaf.parts) == len(devs) and all(
                canonical_device(p.device) == d
                for p, d in zip(leaf.parts, devs)))
        else:
            on_mesh = (isinstance(leaf, torch.Tensor)
                       and canonical_device(leaf.device) == leader)
        if not on_mesh:
            findings.append(Finding(
                PASS_ID, "SS501", "", 0,
                f"{where}: index leaf `{fname}` has no placement on the "
                f"mesh ({type(leaf).__name__} on "
                f"{getattr(leaf, 'device', None)}) — every turn would "
                f"copy it"))
            continue
        if fname in REPLICATED_FIELDS and (
                isinstance(leaf, Shards) or leaf.shape != orig.shape
                or not torch.equal(leaf, orig)):
            findings.append(Finding(
                PASS_ID, "SS502", "", 0,
                f"{where}: `{fname}` is replicated TopLoc state but is "
                f"not whole on the leader ({type(leaf).__name__}) — "
                f"partitioning it breaks the session math every shard "
                f"shares"))
        if fname in SHARDED_FIELDS and not (
                isinstance(leaf, Shards)
                and leaf.per == -(-orig.shape[0] // len(devs))
                and torch.equal(torch.cat([p.cpu() for p in leaf.parts]),
                                orig.cpu())):
            findings.append(Finding(
                PASS_ID, "SS502", "", 0,
                f"{where}: corpus-sized `{fname}` is not split by rows "
                f"over the mesh's {len(devs)} shards — the placement buys "
                f"no memory scaling"))


def _call_plugin(name: str, field: str, backend, index, d: int):
    """Drive the plugged-in scan / search once with concrete operands."""
    q = torch.from_numpy(np.random.default_rng(1).normal(
        size=(_B, d)).astype(np.float32))
    if field == "search":
        return q, backend.search(index, q, ef=8, k=_K)
    sel = torch.tensor([[0, 3, 5], [5, 1, 2], [4, 3, 0], [2, 5, 1]],
                       dtype=torch.int32)
    if name == "ivf_pq":
        return q, backend.scan(index, q, sel, _K, backend.rerank)
    return q, backend.scan(index, q, sel, _K)


def _check_entry(name: str, entry, mesh, findings: List[Finding]) -> None:
    from repro_torch.core import backend as _backend
    from repro_torch.distributed.retrieval import canonical_device
    from repro_torch.distributed.sharding import Shards
    from repro_torch.serving.sessions import store_for_backend

    shard_index, plugin_cls, field = entry
    where = f"sharding[{name!r}]"

    # ---- SS503: the plugin is a frozen plug for a real field ---------
    is_dc = dataclasses.is_dataclass(plugin_cls)
    if not (is_dc and plugin_cls.__dataclass_params__.frozen):
        findings.append(Finding(
            PASS_ID, "SS503", "", 0,
            f"{where}: plugin {plugin_cls.__name__} is not a frozen "
            f"dataclass — the frozen backend holding it could change "
            f"under a turn"))
    cls = _backend.get(name)
    if field not in {f.name for f in dataclasses.fields(cls)}:
        findings.append(Finding(
            PASS_ID, "SS503", "", 0,
            f"{where}: registered field {field!r} does not exist on "
            f"backend class {cls.__name__} — shard_backend would raise "
            f"at replace()"))
        return

    be = _backend.make(name, **_KNOBS.get(name, {}))
    index = _tiny_indexes()[cls.index_kwarg]
    # wire the *entry under check* (mirrors shard_backend, but honours an
    # injected registry: the fixture tests pass seeded-bad entries)
    placed = shard_index(mesh, index)
    fused = (is_dc and any(f.name == "fused"
                           for f in dataclasses.fields(plugin_cls)))
    plugin = plugin_cls(fused=None) if fused else plugin_cls()
    be2 = dataclasses.replace(be, **{field: plugin})
    try:
        hash(be2)
    except TypeError as e:
        findings.append(Finding(
            PASS_ID, "SS503", "", 0,
            f"{where}: backend with plugged {plugin_cls.__name__} is "
            f"unhashable ({e})"))
        return

    _check_leaves(where, index, placed, mesh, findings)

    # ---- drive the plugin, capture the per-shard scans it calls ------
    records: List[ShardCall] = []
    try:
        with record_shard_calls(records):
            q, outs = _call_plugin(name, field, be2, placed,
                                   be.query_dim(index))
    except Exception as e:  # noqa: BLE001 - surface, don't abort
        findings.append(Finding(
            PASS_ID, "SS500", "", 0,
            f"{where}: plugin probe failed: {type(e).__name__}: {e}"))
        return
    if not records:
        findings.append(Finding(
            PASS_ID, "SS500", "", 0,
            f"{where}: plugin reached no per-shard scan of SHARD_CALLS — "
            f"the sharded path is unchecked"))
        return
    index_ids = _index_ids(placed)
    for rec in records:
        operands = list(rec.args) + list(rec.kwargs.values())
        for pos, t in enumerate(_tensors(operands)):
            if id(t) in index_ids or t.dim() == 0:
                continue
            if t.shape[0] != q.shape[0]:
                findings.append(Finding(
                    PASS_ID, "SS502", "", 0,
                    f"{where}: non-index operand #{pos} of {rec.name} "
                    f"(queries / selection / tables) holds {t.shape[0]} "
                    f"of the batch's {q.shape[0]} rows — per-turn TopLoc "
                    f"inputs must reach every shard whole"))
    for pos, t in enumerate(_tensors(outs)):
        if (canonical_device(t.device) != mesh.leader
                or t.shape[0] != q.shape[0]):
            findings.append(Finding(
                PASS_ID, "SS502", "", 0,
                f"{where}: output #{pos} ({tuple(t.shape)} on {t.device}) "
                f"is not whole on the leader — merged top-k results must "
                f"come back replicated"))

    # ---- session slab replication ------------------------------------
    store = store_for_backend(be2, placed, n_slots=2, mesh=mesh)
    if store is not None:
        for fname, leaf in zip(type(store.slab)._fields, store.slab):
            if (isinstance(leaf, Shards)
                    or canonical_device(leaf.device) != mesh.leader
                    or leaf.shape[0] != store.n_slots + 1):
                findings.append(Finding(
                    PASS_ID, "SS502", "", 0,
                    f"{where}: SessionStore slab leaf `{fname}` is not "
                    f"whole on the mesh's leader — sessions are "
                    f"replicated TopLoc state"))


def run(project=None, registry: Optional[Dict] = None) -> List[Finding]:
    from repro_torch.distributed import retrieval as _ret

    reg = registry if registry is not None else _ret._SHARDING_REGISTRY
    mesh = _ret.retrieval_mesh(_SHARDS, devices=["cpu"] * _SHARDS)
    findings: List[Finding] = []
    for name in sorted(reg):
        try:
            _check_entry(name, reg[name], mesh, findings)
        except Exception as e:  # noqa: BLE001 - surface, don't abort
            findings.append(Finding(
                PASS_ID, "SS500", "", 0,
                f"sharding[{name!r}]: probe failed: "
                f"{type(e).__name__}: {e}"))
    return findings
