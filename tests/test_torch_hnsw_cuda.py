"""The HNSW search kernel (``csrc/hnsw_search.cu``) on the card.

This file imports no JAX, so its ``cuda_only`` tests run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_hnsw_cuda.py``; the
repository's conftest imports JAX).  On graphs the port builds:

* on integer vectors every dot is exact in any order, so the kernel
  equals its plain version (``kernels/ref.py`` ``hnsw_search``) bit for
  bit, ids, scores and ndist, exact ties included, with and without an
  entry override and with tombstones, at ef 1 to 256; on a chain graph
  both stop at the step cap 4 ef + 16;
* each instance of the visited set (``tiling.HNSW_VISITED``: a bitmap or
  a hash in shared memory, a bitmap in global scratch), forced on the
  same inputs, gives the same bits as the others and as the plain
  version; on a comb graph every step of a search finds deg fresh ids
  until the step cap, so a search visits 1 + (4 ef + 16) deg ids, the
  hash's highest load; the step cap holds at every instance;
* on float vectors the scores agree within 1e-5 where the traversals
  agree, and at most 1 % of the queries take another path (a near tie
  resolved by the other summation order);
* a query alone equals it in a batch of 32, bit for bit;
* each cap raises ``ValueError`` naming ROADMAP Queue 3, item 4, and so
  does a deprecated ``toploc.hnsw_*`` alias past it (no fallback);
* a zero-query pad row neither faults nor makes a NaN;
* a call plans and launches one kernel and, past its first, syncs
  nothing with the host (its plan is held to the profiler in
  ``tests/test_torch_kernels.py``);
* the batched engine equals the sequential engine bit for bit for
  TopLoc_HNSW and plain HNSW at max_batch 1, 8 and 32, and Exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hnsw
from repro_torch.kernels import hnsw_search as hs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tiling

TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph(kind, n, d, m, seed, dev):
    """A graph built by the port over integer vectors (values -3..3,
    exact dots and many exact ties) or unit-norm floats."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return hnsw.build(x, m=m, ef_construction=32, seed=seed, device=dev), x


@pytest.fixture(scope="module")
def int_graph(dev):
    return _graph("int", 2000, 64, 8, 1, dev)


@pytest.fixture(scope="module")
def float_graph(dev):
    return _graph("float", 3000, 64, 8, 2, dev)


def _queries(x, b, seed, dev, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-3, 4, size=(b, x.shape[1])).astype(np.float32)
    else:
        q = rng.normal(size=(b, x.shape[1])).astype(np.float32)
    return torch.from_numpy(q).to(dev)


def _both(index, q, **kw):
    args = (index.vectors, index.adj0, index.upper_adj, index.entry_point,
            q, kw.pop("entry_override", None))
    got = ops.hnsw_search(*args, deleted=index.deleted, **kw)
    want = kref.hnsw_search(*args, deleted=index.deleted, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", ["descent", "override", "tombstones"])
@pytest.mark.parametrize("ef,k", [(1, 1), (8, 8), (16, 10), (64, 10),
                                  (128, 10), (256, 256)])
def test_cuda_kernel_equals_plain_version_on_integers(dev, int_graph, case,
                                                      ef, k):
    index, x = int_graph
    q = _queries(x, 40, ef, dev)
    kw = dict(ef=ef, k=k)
    if case == "override":
        kw["entry_override"] = torch.randint(
            0, index.n, (40,), generator=torch.Generator().manual_seed(ef),
            dtype=torch.int32).to(dev)
    elif case == "tombstones":
        dead = torch.zeros(index.n, dtype=torch.bool)
        dead[torch.randperm(index.n, generator=torch.Generator()
                            .manual_seed(ef))[:600]] = True
        index = index._replace(deleted=dead.to(dev))
    got, want = _both(index, q, **kw)
    for g, w, name in zip(got, want, ("scores", "ids", "ndist")):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _forced(index, q, visited, entry_override=None, **kw):
    """The kernel with the visited set's instance ``visited`` forced."""
    got = hs.hnsw_search(index.vectors, index.adj0, index.upper_adj,
                         index.entry_point, q, entry_override,
                         index.deleted, visited=visited, **kw)
    torch.cuda.synchronize()
    return got


def _same(got, want):
    for g, w, name in zip(got, want, ("scores", "ids", "ndist")):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", ["descent", "override", "tombstones"])
@pytest.mark.parametrize("ef,k", [(8, 8), (64, 10), (256, 256)])
def test_cuda_each_visited_set_gives_the_same_bits(dev, int_graph, case,
                                                   ef, k):
    index, x = int_graph
    q = _queries(x, 40, ef + 1, dev)
    kw = dict(ef=ef, k=k)
    if case == "override":
        kw["entry_override"] = torch.randint(
            0, index.n, (40,), generator=torch.Generator().manual_seed(ef),
            dtype=torch.int32).to(dev)
    elif case == "tombstones":
        dead = torch.zeros(index.n, dtype=torch.bool)
        dead[torch.randperm(index.n, generator=torch.Generator()
                            .manual_seed(ef))[:600]] = True
        index = index._replace(deleted=dead.to(dev))
    _, want = _both(index, q, **dict(kw))
    for visited in tiling.HNSW_VISITED:
        _same(_forced(index, q, visited, **dict(kw)), want)


def _comb(ef, deg, dev):
    """A spine s_0 -> s_1 -> ... whose node t has dot t + 1 with the
    query (1, 0, 0, 0), each spine node linked to the next and to deg - 1
    leaves of its own (dot 0): from s_0 every step expands the newest
    spine node and finds deg fresh ids, to the step cap 4 ef + 16."""
    steps = tiling.hnsw_max_steps(ef)
    spine = steps + 2
    n = spine * deg
    x = np.zeros((n, 4), np.float32)
    x[:spine, 0] = np.arange(1, spine + 1)
    x[spine:, 1] = 1.0
    adj0 = np.full((n, deg), -1, np.int32)
    adj0[:spine - 1, 0] = np.arange(1, spine)
    adj0[:spine, 1:] = spine + np.arange(spine * (deg - 1)).reshape(
        spine, deg - 1)
    index = hnsw.HNSWIndex(
        torch.from_numpy(x).to(dev), torch.from_numpy(adj0).to(dev),
        torch.zeros((0, n, 1), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev))
    return index, 1 + steps * deg


@pytest.mark.cuda_only
@pytest.mark.parametrize("ef", [1, 16, 64, 128])
def test_cuda_visited_sets_at_the_most_ids_a_search_visits(dev, ef):
    """The comb graph at deg 32: a search visits 1 + (4 ef + 16) 32 ids,
    the number the hash is sized for (load 11/20); every instance gives
    the plain version's bits."""
    index, visits = _comb(ef, 32, dev)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    entry = torch.zeros(1, dtype=torch.int32, device=dev)
    kind, slots = tiling.hnsw_visited(index.n, 4, ef, 32, "hash")
    assert visits * 20 <= slots * 11 < visits * 20 + 11
    (v, i, nd), want = _both(index, q, ef=ef, k=ef, entry_override=entry)
    assert int(nd[0]) == visits
    _same((v, i, nd), want)
    for visited in tiling.HNSW_VISITED:
        _same(_forced(index, q, visited, ef=ef, k=ef, entry_override=entry),
              want)


@pytest.mark.cuda_only
@pytest.mark.parametrize("visited", tiling.HNSW_VISITED)
@pytest.mark.parametrize("ef", [1, 2, 4])
def test_cuda_kernel_stops_at_the_step_cap(dev, ef, visited):
    """A chain of 200 nodes on an arc, each linked to its two
    neighbours, queries at the far end: every step finds a better node,
    so the beam stops at 4 ef + 16 steps, as the plain version does, at
    every instance of the visited set."""
    n = 200
    theta = np.linspace(0.0, np.pi / 2, n)
    x = np.zeros((n, 4), np.float32)
    x[:, 0], x[:, 1] = np.cos(theta), np.sin(theta)
    adj0 = np.stack([np.arange(n) - 1, np.arange(n) + 1], 1).astype(np.int32)
    adj0[adj0 >= n] = -1
    index = hnsw.HNSWIndex(
        torch.from_numpy(x).to(dev), torch.from_numpy(adj0).to(dev),
        torch.zeros((0, n, 1), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev))
    q = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.3, 0.9, 0.0, 0.0]],
                     device=dev)
    _, (pv, pi, pnd) = _both(index, q, ef=ef, k=ef)
    v, i, nd = _forced(index, q, visited, ef=ef, k=ef)
    assert torch.equal(i, pi) and torch.equal(nd, pnd)
    assert float((v - pv).abs().max()) <= TOL
    assert 0 < int(i[0, 0]) < 4 * ef + 16 + 2 < n - 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("override", [False, True])
def test_cuda_kernel_against_plain_version_on_floats(dev, float_graph,
                                                     override):
    index, x = float_graph
    b = 200
    q = _queries(x, b, 7, dev, integer=False)
    kw = dict(ef=64, k=10)
    if override:
        kw["entry_override"] = torch.arange(b, dtype=torch.int32,
                                            device=dev) * 13
    (v, i, nd), (pv, pi, pnd) = _both(index, q, **kw)
    same = (i == pi).all(-1) & (nd == pnd)
    assert int((~same).sum()) <= b // 100, int((~same).sum())
    assert float((v - pv).abs()[same].max()) <= TOL
    assert bool(torch.isfinite(v).all())


@pytest.mark.cuda_only
@pytest.mark.parametrize("override", [False, True])
def test_cuda_one_query_equals_it_in_a_batch_of_32(dev, float_graph,
                                                   override):
    index, x = float_graph
    q = _queries(x, 32, 11, dev, integer=False)
    entry = (torch.arange(32, dtype=torch.int32, device=dev) * 31
             if override else None)
    v, i, nd = hnsw.search(index, q, ef=64, k=10, entry_override=entry,
                           use_entry_override=override)
    for b in range(32):
        v1, i1, nd1 = hnsw.search(
            index, q[b:b + 1], ef=64, k=10,
            entry_override=None if entry is None else entry[b:b + 1],
            use_entry_override=override)
        assert torch.equal(v1[0], v[b]) and torch.equal(i1[0], i[b])
        assert torch.equal(nd1[0], nd[b])


@pytest.mark.cuda_only
@pytest.mark.parametrize("what", ["ef", "ef 0", "k", "degree", "width",
                                  "d not a multiple of 4"])
def test_cuda_caps_raise(dev, int_graph, what):
    index, x = int_graph
    q = _queries(x, 2, 0, dev)
    vec, adj0, ef, k = index.vectors, index.adj0, 64, 10
    if what == "ef":
        ef = 257
    elif what == "ef 0":
        ef, k = 0, 0
    elif what == "k":
        k = 65
    elif what == "degree":
        adj0 = torch.full((index.n, 258), -1, dtype=torch.int32, device=dev)
    elif what == "width":
        vec = torch.zeros((index.n, 12_292), device=dev)
        q = torch.zeros((2, 12_292), device=dev)
    else:
        vec = torch.zeros((index.n, 66), device=dev)
        q = torch.zeros((2, 66), device=dev)
    match = "beam" if what in ("k", "ef 0") else "Queue 3, item 4"
    with pytest.raises(ValueError, match=match):
        ops.hnsw_search(vec, adj0, index.upper_adj, index.entry_point, q,
                        ef=ef, k=k)


@pytest.mark.cuda_only
@pytest.mark.parametrize("alias", ["hnsw_start", "hnsw_start_batch",
                                   "hnsw_plain_batch"])
def test_cuda_hnsw_alias_past_the_cap_raises(dev, float_graph, alias):
    """The first turn's beam is up·ef = 2 x 200, past the kernel's 256;
    the plain turn's is ef = 257."""
    import warnings
    from repro_torch.core import toploc
    index, x = float_graph
    q = _queries(x, 2, 3, dev, integer=False)
    ef = 257 if alias == "hnsw_plain_batch" else 200
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="Queue 3, item 4"):
            getattr(toploc, alias)(index, q[0] if alias == "hnsw_start"
                                   else q, ef=ef, k=10)


@pytest.mark.cuda_only
def test_cuda_zero_query_pad_rows(dev, float_graph):
    """A wave's pad rows are zero queries: every dot ties at +-0.  They
    run like any row (as the plain version does) and make no NaN."""
    index, x = float_graph
    q = _queries(x, 4, 5, dev, integer=False)
    q[1:3] = 0.0
    for entry in (None, torch.zeros(4, dtype=torch.int32, device=dev)):
        (v, i, nd), (pv, pi, pnd) = _both(index, q, ef=64, k=10,
                                          entry_override=entry)
        assert not bool(torch.isnan(v).any())
        assert torch.equal(v[1:3], pv[1:3]) and torch.equal(i[1:3], pi[1:3])
        assert torch.equal(nd[1:3], pnd[1:3])
        assert bool((i >= 0).all())


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, 32])
def test_cuda_one_launch_a_call_and_no_host_sync(dev, b):
    """The analysis pass's HNSW probes on CUDA tensors: a call plans one
    ``hnsw_search_kernel`` (the plan is held to the profiler with the
    other probes, ``tests/test_torch_kernels.py``
    ``test_cuda_launch_plans_match_the_profiler``), launches once and,
    past its first call, does not synchronise the host."""
    import warnings
    from repro_torch.analysis import kernel_budget
    probe = next(p for p in kernel_budget.port_probes()
                 if p.label == f"ops.hnsw_search[B={b}]")
    gen = torch.Generator(device=dev).manual_seed(3)
    tensors = probe.tensors(dev, gen)
    want = kernel_budget.planned(probe, tensors, dev)
    assert [w[0] for w in want] == ["hnsw_search_kernel"]
    torch.cuda.synchronize()
    syncs = []
    for _ in range(2):      # the second call: nothing first-time about it
        before = ops.hnsw_search.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                probe.call(*tensors, device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append([str(w.message) for w in caught
                      if "synchroniz" in str(w.message)])
        assert ops.hnsw_search.launches == before + 1
    assert not syncs[1], syncs


@pytest.mark.cuda_only
@pytest.mark.parametrize("max_batch", [1, 8, 32])
@pytest.mark.parametrize("strategy", ["toploc", "plain"])
def test_cuda_batched_engine_equals_sequential(dev, float_graph, strategy,
                                               max_batch):
    from repro_torch.serving import (BatchedConversationalSearchEngine,
                                     ConversationalSearchEngine,
                                     ServingConfig)
    index, x = float_graph
    rng = np.random.default_rng(4)
    convs = rng.normal(size=(32, 3, x.shape[1])).astype(np.float32)
    cfg = ServingConfig(backend="hnsw", strategy=strategy, k=10,
                        ef_search=32, up=2)
    seq = ConversationalSearchEngine(cfg, hnsw_index=index)
    bat = BatchedConversationalSearchEngine(cfg, hnsw_index=index,
                                            n_slots=32, max_batch=max_batch,
                                            max_wait_s=0.0)
    for t in range(3):
        futs = [bat.submit(f"c{c}", convs[c, t]) for c in range(32)]
        bat.drain()
        for c, fut in enumerate(futs):
            bv, bi = fut.result()
            sv, si = seq.query(f"c{c}", convs[c, t])
            assert np.array_equal(bv, sv) and np.array_equal(bi, si), (c, t)
    key = sorted((r.conv_id, r.turn, r.graph_dists, r.refreshed)
                 for r in bat.records)
    assert key == sorted((r.conv_id, r.turn, r.graph_dists, r.refreshed)
                         for r in seq.records)


@pytest.mark.cuda_only
def test_cuda_exact_batched_engine_equals_sequential(dev, float_graph):
    from repro_torch.serving import (BatchedConversationalSearchEngine,
                                     ConversationalSearchEngine,
                                     ServingConfig)
    _, x = float_graph
    docs = torch.from_numpy(x).to(dev)
    q = np.random.default_rng(9).normal(size=(8, x.shape[1])).astype(
        np.float32)
    cfg = ServingConfig(backend="exact", k=10)
    seq = ConversationalSearchEngine(cfg, doc_vecs=docs)
    bat = BatchedConversationalSearchEngine(cfg, doc_vecs=docs, max_batch=8,
                                            max_wait_s=0.0)
    futs = [bat.submit(f"c{c}", q[c]) for c in range(8)]
    bat.drain()
    for c, fut in enumerate(futs):
        bv, bi = fut.result()
        sv, si = seq.query(f"c{c}", q[c])
        assert np.array_equal(bv, sv) and np.array_equal(bi, si)
