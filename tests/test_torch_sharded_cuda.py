"""Corpus sharding on the card: the per-shard kernel calls, the sharded
``hnsw_search`` instance and the sharded engines.

This file imports no JAX, so its ``cuda_only`` tests run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_sharded_cuda.py``;
the repository's conftest imports JAX).

* Rows 6 and 7 as each shard calls them: a shard's lists (views of the
  unsharded tensors), the selection clipped into them and masked by
  ``own``; on integer inputs (every dot and ADC sum exact) bit-equal to
  their plain versions at f32 / bf16 / int8, row 7 with and without its
  re-rank.
* ``hnsw_search``'s sharded instance at S = 2, 4 and 8 (uneven blocks
  included), with descent, entry overrides and tombstones: bit-equal to
  its plain sharded version (``ref.hnsw_sharded_dots``) on integer
  vectors, and to the unsharded kernel on integer and float vectors.
* The sharded engines at S = 2 and 4 on one card: at f32 ids, scores
  and counters ``torch.equal`` to the unsharded engines (the fused
  IVF-PQ turn to the unsharded unfused one: its re-rank is the
  single-device multiply-reduce), sequential and batched.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hnsw, ivf, pq
from repro_torch.distributed import retrieval as R
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig)

PRECISIONS = ("f32", "bf16", "int8")
K = 4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# rows 6 and 7 per shard
# ---------------------------------------------------------------------------


def _lists(dev, p=12, lmax=200, d=16, b=4, nprobe=6, seed=3):
    rng = np.random.default_rng(seed)
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    li = np.arange(p * lmax).reshape(p, lmax).astype(np.int32)
    li[rng.random((p, lmax)) < 0.2] = -1
    q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    sel = np.stack([rng.permutation(p)[:nprobe] for _ in range(b)]
                   ).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (q, lv, li, sel)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("s", (2, 3, 4))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_row6_per_shard_equals_plain_version(dev, precision, s):
    q, lv, li, sel = _lists(dev)
    mesh = R.retrieval_mesh(s, devices=[dev] * s)
    shv, shi = SH.split_rows(lv, mesh.shard_devices), \
        SH.split_rows(li, mesh.shard_devices)
    r = None if precision == "f32" else \
        ops._fused_depth(K, sel.shape[1] * lv.shape[1], 2 * K)
    for j in range(s):
        lo, hi = shv.bounds(j)
        own, ss = R.local_selection(sel, lo, hi, dev)
        assert 0 < int(own.sum()) < own.numel()
        got = ops.fused_scan(q, shv.parts[j], shi.parts[j],
                             ss.to(torch.int32), K, own=own,
                             precision=precision)
        want = ref.fused_scan_ivf(q, shv.parts[j], shi.parts[j], ss, own,
                                  k=K, precision=precision, r=r)
        _equal(got, want)


@pytest.mark.cuda_only
@pytest.mark.parametrize("s", (2, 3, 4))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_row7_per_shard_equals_plain_version(dev, precision, s):
    q, lv, li, sel = _lists(dev)
    p, lmax, d = lv.shape
    rng = np.random.default_rng(9)
    m, n_codes, rerank = 8, 16, 24
    tables = torch.from_numpy(rng.integers(-4, 5, size=(q.shape[0], m,
                                                        n_codes))
                              .astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, n_codes, size=(p, lmax, m))
                             .astype(np.uint8)).to(dev)
    corpus = lv.reshape(p * lmax, d).contiguous()
    devs = [dev] * s
    shc, shi = SH.split_rows(codes, devs), SH.split_rows(li, devs)
    r = ops._fused_depth(K, sel.shape[1] * lmax, rerank)
    for j in range(s):
        lo, hi = shc.bounds(j)
        own, ss = R.local_selection(sel, lo, hi, dev)
        for fuse in (False, True):
            got = ops.fused_scan_pq(tables, q, shc.parts[j], shi.parts[j],
                                    ss.to(torch.int32), corpus, K,
                                    rerank=rerank, own=own,
                                    fuse_rerank=fuse, precision=precision)
            want = ref.fused_scan_pq(tables, q, shc.parts[j], shi.parts[j],
                                     ss, own, corpus, k=K, r=r,
                                     rerank=fuse, precision=precision)
            _equal(got, want)


# ---------------------------------------------------------------------------
# the sharded hnsw_search instance
# ---------------------------------------------------------------------------


def _graph(kind, n, d, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return hnsw.build(x, m=8, ef_construction=32, seed=seed, device=dev), x


@pytest.fixture(scope="module")
def int_graph(dev):
    return _graph("int", 2000, 64, 1, dev)


@pytest.fixture(scope="module")
def float_graph(dev):
    return _graph("float", 3000, 64, 2, dev)


def _case(index, x, case, b, seed, dev, integer=True):
    rng = np.random.default_rng(seed)
    q = (rng.integers(-3, 4, size=(b, x.shape[1])) if integer
         else rng.normal(size=(b, x.shape[1]))).astype(np.float32)
    q = torch.from_numpy(q).to(dev)
    entry, deleted = None, index.deleted
    if case == "override":
        entry = torch.from_numpy(rng.integers(0, index.n, b)
                                 .astype(np.int32)).to(dev)
    elif case == "tombstones":
        dead = rng.random(index.n) < 0.3
        deleted = torch.from_numpy(dead).to(dev)
    return q, entry, deleted


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", ["descent", "override", "tombstones"])
@pytest.mark.parametrize("ef,k", [(8, 8), (16, 10), (64, 10), (256, 10)])
@pytest.mark.parametrize("s", (2, 3, 4, 8))
def test_cuda_sharded_hnsw_equals_plain_and_unsharded(dev, int_graph, s, ef,
                                                      k, case):
    index, x = int_graph
    q, entry, deleted = _case(index, x, case, 33, ef + s, dev)
    sh = SH.split_rows(index.vectors, [dev] * s)
    args = (index.adj0, index.upper_adj, index.entry_point, q, entry)
    before = ops.hnsw_search_sharded.launches
    got = ops.hnsw_search_sharded(sh.parts, sh.per, *args, ef=ef, k=k,
                                  deleted=deleted)
    assert ops.hnsw_search_sharded.launches == before + 1
    want = ref.hnsw_search(None, *args, ef=ef, k=k, deleted=deleted,
                           dots_factory=ref.hnsw_sharded_dots(sh.parts,
                                                              sh.per))
    _equal(got, want)
    one = ops.hnsw_search(index.vectors, *args, ef=ef, k=k, deleted=deleted)
    _equal(got, one)


@pytest.mark.cuda_only
@pytest.mark.parametrize("s", (2, 4, 8))
@pytest.mark.parametrize("b", (1, 32))
def test_cuda_sharded_hnsw_on_floats_equals_unsharded(dev, float_graph, s,
                                                      b):
    index, x = float_graph
    for case in ("descent", "override"):
        q, entry, _ = _case(index, x, case, b, s, dev, integer=False)
        sh = SH.split_rows(index.vectors, [dev] * s)
        args = (index.adj0, index.upper_adj, index.entry_point, q, entry)
        got = ops.hnsw_search_sharded(sh.parts, sh.per, *args, ef=64, k=10)
        _equal(got, ops.hnsw_search(index.vectors, *args, ef=64, k=10))


@pytest.mark.cuda_only
def test_cuda_sharded_hnsw_one_shard_is_the_unsharded_kernel(dev,
                                                             float_graph):
    index, x = float_graph
    q, _, _ = _case(index, x, "descent", 4, 0, dev, integer=False)
    b0, s0 = ops.hnsw_search.launches, ops.hnsw_search_sharded.launches
    got = ops.hnsw_search_sharded((index.vectors,), index.n, index.adj0,
                                  index.upper_adj, index.entry_point, q,
                                  ef=32, k=10)
    assert (ops.hnsw_search.launches, ops.hnsw_search_sharded.launches) == \
        (b0 + 1, s0)
    _equal(got, ops.hnsw_search(index.vectors, index.adj0, index.upper_adj,
                                index.entry_point, q, ef=32, k=10))


@pytest.mark.cuda_only
def test_cuda_sharded_hnsw_refuses_bad_shards(dev, float_graph):
    index, x = float_graph
    q, _, _ = _case(index, x, "descent", 2, 0, dev, integer=False)
    sh = SH.split_rows(index.vectors, [dev] * 3)
    args = (index.adj0, index.upper_adj, index.entry_point, q)
    with pytest.raises(ValueError, match="blocks"):
        ops.hnsw_search_sharded(sh.parts, sh.per + 1, *args, ef=16, k=4)
    nine = SH.split_rows(index.vectors, [dev] * 9)
    with pytest.raises(ValueError, match="shards"):
        ops.hnsw_search_sharded(nine.parts, nine.per, *args, ef=16, k=4)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

N_CONV, D, TURNS = 6, 32, 5
BASE = dict(nprobe=8, h=32, alpha=0.3, k=10, rerank=48, ef_search=32, up=2)


@pytest.fixture(scope="module")
def corpus(dev):
    rng = np.random.default_rng(5)
    docs = rng.normal(size=(6000, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    convs = docs[rng.integers(0, 6000, size=(N_CONV, TURNS))] + \
        0.1 * rng.normal(size=(N_CONV, TURNS, D)).astype(np.float32)
    t = torch.from_numpy(docs).to(dev)
    index = ivf.build(t, 64, iters=4, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pqi = pq.build_ivf_pq(index, t, pq.train(t, 8, iters=4, generator=gen),
                          device=dev)
    g = hnsw.build(docs[:3000], m=8, ef_construction=32, seed=0, device=dev)
    return dict(ivf_index=index, ivf_pq_index=pqi, hnsw_index=g), \
        convs.astype(np.float32)


def _serve(eng, convs):
    out = []
    for t in range(TURNS):
        if isinstance(eng, BatchedConversationalSearchEngine):
            futs = [eng.submit(f"c{c}", convs[c, t]) for c in range(N_CONV)]
            eng.drain()
            out += [f.result() for f in futs]
        else:
            out += [eng.query(f"c{c}", convs[c, t]) for c in range(N_CONV)]
    recs = sorted((r.conv_id, r.turn, r.centroid_dists, r.list_dists,
                   r.graph_dists, r.code_dists, r.refreshed, r.i0)
                  for r in eng.records)
    return out, recs


@pytest.mark.cuda_only
@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("s", (2, 4))
@pytest.mark.parametrize("backend,knobs,against", [
    ("ivf", dict(strategy="toploc+", fused=True), None),
    ("ivf", dict(strategy="toploc+"), None),
    ("ivf", dict(strategy="plain", fused=True), dict(fused=False)),
    ("ivf_pq", dict(strategy="toploc+"), None),
    ("ivf_pq", dict(strategy="toploc+", fused=True), dict(fused=False)),
    ("hnsw", dict(strategy="toploc"), None)],
    ids=["ivf-fused", "ivf", "ivf-plain-fused", "pq", "pq-fused", "hnsw"])
def test_cuda_sharded_engine_equals_unsharded(dev, corpus, backend, knobs,
                                              against, s, engine):
    """f32: scores, ids and counters equal.  A sharded fused plain turn
    scans with row 6 (``scan`` wins over the fused whole turn), whose
    bits are the unfused scan's only on ties-free ids: it is held to the
    unsharded unfused engine's ids and counters and the fused scan's
    scores; the sharded fused IVF-PQ turn re-ranks as the unfused one
    does, and equals it."""
    indexes, convs = corpus
    mesh = R.retrieval_mesh(s, devices=[dev] * s)
    make = (ConversationalSearchEngine if engine == "sequential" else
            lambda c, **kw: BatchedConversationalSearchEngine(
                c, n_slots=16, max_batch=8, max_wait_s=1e-4, **kw))
    cfg = dict(BASE, backend=backend, **knobs)
    got, got_rec = _serve(make(ServingConfig(**cfg, mesh=mesh), **indexes,
                               device=dev), convs)
    want, want_rec = _serve(make(ServingConfig(**dict(cfg, **(against or
                                                               {}))),
                                 **indexes, device=dev), convs)
    assert got_rec == want_rec
    for (gv, gi), (wv, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        if backend == "ivf" and against:
            np.testing.assert_allclose(gv, wv, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(gv, wv)
