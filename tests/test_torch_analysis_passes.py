"""The port's analysis passes besides ``kernels``: contract, shard,
deprecated, lock-order and guarded-fields.

* ``lock-order`` and ``guarded-fields`` on the reference's own fixtures
  (``tests/analysis_fixtures/bad_locking.py``, ``bad_guards.py``: read,
  not copied) give the reference's passes' ``(code, line)`` sets;
* fixtures written here to ``tmp_path`` fire exactly their marked
  diagnostic: DA601 (import and attribute call), SC201–SC205, SS501–
  SS503, and LK703 on ``synchronize``, the port's ``block_until_ready``;
* ``live_alias_names()`` is the reference's 18 names;
* ``--select bogus`` exits 2 and names every pass;
* the port's tree is clean on all six passes.
"""
import importlib.util
import textwrap
from pathlib import Path

import pytest

from repro.analysis import deprecation as rdeprecation
from repro.analysis import guarded_fields as rguarded
from repro.analysis import lock_order as rlock
from repro.analysis.project import modules_from_paths as rmodules
from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import (deprecation, guarded_fields, lock_order,
                                  shard_specs, static_contract)
from repro_torch.analysis.project import Project, modules_from_paths

FIXTURES = Path(__file__).parent / "analysis_fixtures"


def _marked_line(path: Path, marker: str) -> int:
    hits = [i + 1 for i, ln in enumerate(path.read_text().splitlines())
            if marker in ln]
    assert len(hits) == 1, (marker, hits)
    return hits[0]


def _write(tmp_path, name, src) -> Path:
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(src))
    return path


def _import(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"torch_fixture_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- locking


@pytest.mark.parametrize("fixture,port,ref", [
    ("bad_locking", lock_order, rlock),
    ("bad_guards", guarded_fields, rguarded)])
def test_concurrency_passes_equal_the_references_on_its_fixtures(
        fixture, port, ref):
    path = (FIXTURES / f"{fixture}.py").resolve()
    got = {(f.code, f.line) for f in port.run(
        modules=modules_from_paths([path]))}
    want = {(f.code, f.line) for f in ref.run(modules=rmodules([path]))}
    assert got == want and got


SYNC_SRC = '''\
    import threading

    import torch


    class SyncUnderLock:
        def __init__(self):
            self._lock = threading.Lock()
            self._event = torch.cuda.Event()
            self._stream = torch.cuda.Stream()

        def device(self):
            with self._lock:
                torch.cuda.synchronize()  # MARK:LK703a

        def event(self):
            with self._lock:
                self._event.synchronize()  # MARK:LK703b

        def stream(self):
            with self._lock:
                self._stream.synchronize()  # MARK:LK703c

        def outside(self):
            self._event.synchronize()
            with self._lock:
                return 1
'''


def test_synchronize_under_a_lock_is_lk703(tmp_path):
    path = _write(tmp_path, "sync_locked", SYNC_SRC)
    findings = lock_order.run(modules=modules_from_paths([path]))
    assert {(f.code, f.line) for f in findings} == {
        ("LK703", _marked_line(path, f"MARK:LK703{x}")) for x in "abc"}


# ------------------------------------------------------------ deprecation

DEP_SRC = '''\
    from repro_torch.core import toploc
    from repro_torch.core.toploc import ivf_start  # MARK:DA601-import


    def run_legacy(ivf_index, q0):
        v, i, sess, stats = toploc.hnsw_step(ivf_index, q0, k=8)  # MARK:DA601-call
        return ivf_start, v, i, sess, stats


    def fine(ivf_index, q0):
        from repro_torch.core import backend
        be = backend.make("ivf", h=8, nprobe=4)
        return toploc.start(be, ivf_index, q0, k=8)
'''


def test_deprecation_fixture_flags_alias_uses(tmp_path):
    path = _write(tmp_path, "dep_legacy", DEP_SRC)
    findings = deprecation.run(modules=modules_from_paths([path]))
    assert {(f.code, f.line) for f in findings} == {
        ("DA601", _marked_line(path, "MARK:DA601-import")),
        ("DA601", _marked_line(path, "MARK:DA601-call"))}


def test_live_aliases_are_the_references():
    names = deprecation.live_alias_names()
    assert names == rdeprecation.live_alias_names() and len(names) == 18


# --------------------------------------------------------------- contract

SC_SRC = '''\
    import dataclasses
    from typing import Any, ClassVar

    import torch

    from repro_torch.core.backend import RetrievalBackend


    @dataclasses.dataclass  # not frozen -> SC201
    class UnfrozenBackend(RetrievalBackend):
        name: ClassVar[str] = "fx_unfrozen"
        index_kwarg: ClassVar[str] = "ivf_index"
        h: int = 4


    class _StubPlainBatch:
        def plain_batch(self, index, q, *, k):
            raise NotImplementedError


    @dataclasses.dataclass(frozen=True, eq=False)  # identity hash -> SC202
    class IdentityHashBackend(_StubPlainBatch, RetrievalBackend):
        name: ClassVar[str] = "fx_identity"
        index_kwarg: ClassVar[str] = "ivf_index"
        stateful: ClassVar[bool] = False


    @dataclasses.dataclass(frozen=True)  # tensor-valued field -> SC203
    class TensorFieldBackend(_StubPlainBatch, RetrievalBackend):
        name: ClassVar[str] = "fx_tensor"
        index_kwarg: ClassVar[str] = "ivf_index"
        stateful: ClassVar[bool] = False
        boost: Any = dataclasses.field(default_factory=lambda: torch.ones(3),
                                       hash=False, compare=False)


    @dataclasses.dataclass(frozen=True)  # tensor annotation -> SC203
    class TensorAnnotatedBackend(_StubPlainBatch, RetrievalBackend):
        name: ClassVar[str] = "fx_annotated"
        index_kwarg: ClassVar[str] = "ivf_index"
        stateful: ClassVar[bool] = False
        boost: "torch.Tensor" = None


    @dataclasses.dataclass(frozen=True)  # no stateful surface -> SC204
    class MissingSurfaceBackend(RetrievalBackend):
        name: ClassVar[str] = "fx_missing"
        index_kwarg: ClassVar[str] = "ivf_index"


    @dataclasses.dataclass(frozen=True)  # required knob -> SC205
    class NoDefaultBackend(RetrievalBackend):
        name: ClassVar[str] = "fx_nodefault"
        index_kwarg: ClassVar[str] = "ivf_index"
        stateful: ClassVar[bool] = False
        h: int
'''


def test_static_contract_fixture_registry(tmp_path):
    bb = _import(_write(tmp_path, "bad_backends", SC_SRC))
    classes = (bb.UnfrozenBackend, bb.IdentityHashBackend,
               bb.TensorFieldBackend, bb.TensorAnnotatedBackend,
               bb.MissingSurfaceBackend, bb.NoDefaultBackend)
    reg = {cls.name: cls for cls in classes}
    codes = {}
    for f in static_contract.run(registry=reg):
        for name in reg:
            if f"backend {name!r}" in f.message:
                codes.setdefault(name, set()).add(f.code)
    assert codes == {"fx_unfrozen": {"SC201"}, "fx_identity": {"SC202"},
                     "fx_tensor": {"SC203"}, "fx_annotated": {"SC203"},
                     "fx_missing": {"SC204"}, "fx_nodefault": {"SC205"}}


def test_static_contract_real_registry_is_clean():
    assert static_contract.run() == []


# ------------------------------------------------------------------ shard

SS_SRC = '''\
    import dataclasses

    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.retrieval import (
        ShardedHNSWSearch, ShardedIVFScan, shard_hnsw_index,
        shard_ivf_index)


    def node_level_off_mesh(mesh, index):
        """A replicated leaf left on no device of the mesh -> SS501."""
        idx = shard_hnsw_index(mesh, index)
        return idx._replace(node_level=idx.node_level.to("meta"))


    def centroids_split(mesh, index):
        """Replicated TopLoc state split over the shards -> SS502."""
        idx = shard_ivf_index(mesh, index)
        return idx._replace(centroids=SH.split_rows(index.centroids,
                                                    mesh.shard_devices))


    @dataclasses.dataclass(frozen=True)
    class SplitBatchIVFScan:
        """Each half of the batch scanned on its own: a per-shard scan
        sees part of the queries -> SS502."""
        fused: object = None

        def __call__(self, index, queries, sel, k):
            h = queries.shape[0] // 2
            a = ShardedIVFScan()(index, queries[:h], sel[:h], k)
            b = ShardedIVFScan()(index, queries[h:], sel[h:], k)
            return tuple(torch.cat(x) for x in zip(a, b))


    class MutableIVFScan:
        """A plain mutable class, not a frozen dataclass -> SS503."""

        def __init__(self, fused=None):
            self.fused = fused

        def __call__(self, index, queries, sel, k):
            return ShardedIVFScan()(index, queries, sel, k)
'''


@pytest.mark.parametrize("case,code", [
    ("off_mesh", "SS501"), ("replicated_split", "SS502"),
    ("query_split", "SS502"), ("mutable_plugin", "SS503"),
    ("missing_field", "SS503")])
def test_shard_fixture_entries(tmp_path, case, code):
    from repro_torch.distributed.retrieval import (
        ShardedHNSWSearch, ShardedIVFScan, shard_hnsw_index,
        shard_ivf_index)
    bs = _import(_write(tmp_path, "bad_sharding", SS_SRC))
    reg = {
        "off_mesh": {"hnsw": (bs.node_level_off_mesh, ShardedHNSWSearch,
                              "search")},
        "replicated_split": {"ivf": (bs.centroids_split, ShardedIVFScan,
                                     "scan")},
        "query_split": {"ivf": (shard_ivf_index, bs.SplitBatchIVFScan,
                                "scan")},
        "mutable_plugin": {"ivf": (shard_ivf_index, bs.MutableIVFScan,
                                   "scan")},
        "missing_field": {"hnsw": (shard_hnsw_index, ShardedHNSWSearch,
                                   "missing_field")},
    }[case]
    findings = shard_specs.run(registry=reg)
    assert {f.code for f in findings} == {code}, [f.render()
                                                  for f in findings]


# -------------------------------------------------------------------- CLI


def test_select_unknown_pass_exits_2_with_valid_names(capsys):
    rc = cli.main(["--select", "bogus", "--select", "lock-order"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "unknown pass(es): bogus" in err
    names = analysis.all_passes()
    assert sorted(names) == ["contract", "deprecated", "guarded-fields",
                             "kernels", "lock-order", "shard"]
    assert all(name in err for name in names)


def test_tree_is_clean_on_all_six_passes():
    findings = analysis.run_all(Project())
    assert findings == [], [f.render() for f in findings]


def test_project_scans_the_port_only():
    mods = Project().modules
    assert mods and all(m.rel.startswith("src/repro_torch/") for m in mods)
    assert "repro_torch.core.toploc" in Project().by_modname()
