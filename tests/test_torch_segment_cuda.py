"""The mutable corpus on the card: kernels on edited indexes, and the
int8 scale cache across mutations (ROADMAP Queue 3, item 3).

This file imports no JAX, so its ``cuda_only`` tests run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_segment_cuda.py``;
the repository's conftest imports JAX).

* A delete punches ``-1`` holes into the middle of a posting list.  On
  integer inputs (every dot and ADC sum exact, bf16 rounding nothing),
  rows 3–7 at f32 / bf16 / int8 equal their plain versions bit for bit
  on lists with holes mid-list, a 128-row slice all dead followed by a
  live one, a probed list all dead, and a query whose probed lists hold
  fewer than k live rows; ``hnsw_search`` does on a graph whose
  tombstones take the entry point and most nodes.
* int8 fused turns served across add → delete → compact equal, turn for
  turn, an engine built on a copy of that index (new tensors: its int8
  scales computed anew, ``ops.group_scales``) and the plain version on
  the CPU, ids and scores bit for bit; added rows widen a list group's
  amax, so a stale scale would show.
* The batched engine equals the sequential engine bit for bit through a
  mutation script, for ivf and ivf_pq (f32, int8) and hnsw.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hnsw, ivf, pq
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


def _holed(p, lmax, d, seed):
    """Integer lists with the holes a delete leaves: list 0 every third
    row dead, list 1 its first 128-row slice dead and the next live,
    lists 2 and 6 all dead, list 3 two live rows mid-list, list 4 a live
    prefix and tail pads, the rest random holes.  Dead rows keep their
    vectors (as after a delete); pads are zero.  Returns (lv, li) numpy,
    ids unique (c * lmax + j)."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    ids = np.arange(p * lmax).reshape(p, lmax).astype(np.int32)
    live = rng.random((p, lmax)) > 0.3
    live[0] = np.arange(lmax) % 3 != 1
    live[1] = np.arange(lmax) >= 128
    live[2] = live[6] = False
    live[3] = False
    live[3, [150, 151]] = True
    pads = np.zeros((p, lmax), bool)
    pads[4, 40:] = True
    live[4] = ~pads[4]
    lv[pads] = 0
    return lv, np.where(live, ids, -1).astype(np.int32)


def _ivf_holed(dev, p=8, lmax=300, d=16, b=3, nprobe=3):
    """Queries, centroids steering the turns onto the holed lists, and
    ``sel`` forcing them: query 1 probes lists 2, 3, 6 (two live rows,
    fewer than k)."""
    lv, li = _holed(p, lmax, d, 11)
    rng = np.random.default_rng(12)
    q = rng.integers(0, 3, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 1, size=(p, d)).astype(np.float32)
    cents[[2, 6]] = 4                     # all-dead lists win stage 1
    cents[3] = 3
    sel = np.array([[0, 1, 2], [2, 3, 6], [4, 5, 1]], np.int32)[:b]
    own = np.ones((b, nprobe), np.int32)
    return [torch.from_numpy(x).to(dev) for x in (q, cents, lv, li, sel,
                                                   own)]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_ivf_kernels_on_holed_lists(dev, precision):
    """Rows 4 and 6 on holed lists: bit-equal to the plain versions."""
    q, cents, lv, li, sel, own = _ivf_holed(dev)
    nprobe = sel.shape[1]
    r = None if precision == "f32" else \
        ops._fused_depth(K, nprobe * lv.shape[1], 2 * K)
    got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=K,
                         precision=precision)
    want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=K,
                              precision=precision, r=r)
    _equal(got, want)
    assert set(want[2][0].tolist()) >= {2, 6}        # dead lists probed
    got = ops.fused_scan(q, lv, li, sel, K, own=own, precision=precision)
    want = ref.fused_scan_ivf(q, lv, li, sel, own, k=K, precision=precision,
                              r=r)
    _equal(got, want)
    # query 1's probed lists hold two live rows: the rest are pads
    assert (want[1][1] >= 0).sum() == 2


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_pq_kernels_on_holed_lists(dev, precision):
    """Rows 3, 5 and 7 on holed code lists: bit-equal to the plain
    versions (row 3 has no quantised form: it runs at f32 only)."""
    q, cents, lv, li, sel, own = _ivf_holed(dev)
    p, lmax, d = lv.shape
    m, n_codes, rerank = 8, 16, 6
    rng = np.random.default_rng(13)
    b = q.shape[0]
    tables = torch.from_numpy(rng.integers(-4, 5, size=(b, m, n_codes))
                              .astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, n_codes, size=(p, lmax, m))
                             .astype(np.uint8)).to(dev)
    corpus = lv.reshape(p * lmax, d).contiguous()
    nprobe = sel.shape[1]
    r = ops._fused_depth(K, nprobe * lmax, rerank)
    got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=K, rerank=rerank,
                            precision=precision)
    _equal(got, ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                  nprobe=nprobe, k=K, r=r,
                                  precision=precision))
    for fuse in (True, False):
        got = ops.fused_scan_pq(tables, q, codes, li, sel, corpus, K,
                                rerank=rerank, own=own, fuse_rerank=fuse,
                                precision=precision)
        _equal(got, ref.fused_scan_pq(tables, q, codes, li, sel, own,
                                      corpus, k=K, r=r, rerank=fuse,
                                      precision=precision))
    if precision == "f32":
        for bulk in (True, False):
            _equal(ops.pq_adc_scan(tables, codes, li, sel, r,
                                   adc_bulk=bulk),
                   ref.pq_adc_scan_batch(tables, codes, li, sel, r))


@pytest.mark.cuda_only
@pytest.mark.parametrize("ef", [16, 64])
@pytest.mark.parametrize("dead_share", [0.3, 0.995])
def test_cuda_hnsw_search_on_tombstoned_graph(dev, ef, dead_share):
    """``hnsw_search`` with tombstones that take the entry point and
    ``dead_share`` of the nodes (at 0.995 fewer live nodes than k reach
    many beams): bit-equal to the plain version, descent and entry
    overrides."""
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, size=(1500, 32)).astype(np.float32)
    index = hnsw.build(x, m=8, ef_construction=32, seed=0, device=dev)
    dead = rng.random(1500) < dead_share
    dead[int(index.entry_point)] = True
    deleted = torch.from_numpy(dead).to(dev)
    q = torch.from_numpy(rng.integers(-3, 4, size=(32, 32))
                         .astype(np.float32)).to(dev)
    entry = torch.from_numpy(rng.integers(0, 1500, 32).astype(np.int32)
                             ).to(dev)
    for e in (None, entry):
        got = ops.hnsw_search(index.vectors, index.adj0, index.upper_adj,
                              index.entry_point, q, e, ef=ef, k=K,
                              deleted=deleted)
        want = ref.hnsw_search(index.vectors, index.adj0, index.upper_adj,
                               index.entry_point, q, e, ef=ef, k=K,
                               deleted=deleted)
        _equal(got, want)
        # a tombstone scores -inf (the reference keeps its id, so a beam
        # with fewer than k live nodes returns it at -inf): no finite
        # score names a dead node
        ids, finite = got[1].cpu().numpy(), np.isfinite(got[0].cpu().numpy())
        assert not dead[ids[finite]].any()


# ---------------------------------------------------------------------------
# engines on a mutable corpus
# ---------------------------------------------------------------------------

N_CONV, D = 8, 32


@pytest.fixture(scope="module")
def int_corpus(dev):
    """Integer docs and turns (exact dots at every precision), an IVF of
    64 lists and an IVF-PQ over it, built by the port on the card."""
    rng = np.random.default_rng(21)
    docs = rng.integers(-2, 3, size=(4096, D)).astype(np.float32)
    convs = rng.integers(-2, 3, size=(N_CONV, 8, D)).astype(np.float32)
    t = torch.from_numpy(docs).to(dev)
    index = ivf.build(t, 64, iters=4, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pqi = pq.build_ivf_pq(index, t, pq.train(t, 8, iters=4, generator=gen),
                          device=dev)
    # added docs: larger entries than any base doc, so they widen their
    # lists' int8 group amax after a compaction
    adds = rng.integers(-6, 7, size=(96, D)).astype(np.float32)
    return {"ivf": index, "ivf_pq": pqi}, docs, convs, adds


def _copy(tree, device):
    """``tree`` with every tensor copied to ``device`` (new tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, tuple):
        return type(tree)(*(_copy(x, device) for x in tree))
    return tree


def _twin(eng, cfg, backend, device):
    """An engine on a copy of ``eng``'s index and sessions on
    ``device``: its int8 scales are computed anew."""
    index = _copy(eng.index, device)
    twin = ConversationalSearchEngine(
        cfg, **{f"{backend}_index": index.base}, device=device)
    twin.index = index
    twin.sessions = {c: _copy(s, device) for c, s in eng.sessions.items()}
    twin.turn_count = dict(eng.turn_count)
    return twin


@pytest.mark.cuda_only
@pytest.mark.parametrize("strategy", ["toploc+", "plain"])
def test_cuda_int8_scales_stay_right_across_mutations(dev, int_corpus,
                                                      strategy):
    """ROADMAP Queue 3, item 3: int8 fused ivf turns (rows 6 and 4)
    across add → delete → compact: every turn equals a twin engine on a
    copy of the index (scales computed anew) on the card and on the CPU
    (the plain version), ids and scores bit for bit."""
    indexes, _, convs, adds = int_corpus
    cfg = ServingConfig(backend="ivf", strategy=strategy, fused=True,
                        precision="int8", nprobe=8, h=32, k=10,
                        segment_cap=128)
    eng = ConversationalSearchEngine(cfg, ivf_index=indexes["ivf"])
    before = ops.fused_scan.launches + ops.fused_turn.launches
    served = []
    mutations = [lambda: eng.add_documents(adds[:64]),
                 lambda: eng.delete_documents([int(served[-1][0]), 5, 4097]),
                 eng.compact,
                 lambda: eng.add_documents(adds[64:]),
                 eng.compact]
    for t in range(6):
        if t:
            mutations[t - 1]()
        for c in range(N_CONV):
            twins = [_twin(eng, cfg, "ivf", d) for d in (dev, "cpu")]
            v, i = eng.query(f"c{c}", convs[c, t])
            served.append(i)
            for twin in twins:
                tv, ti = twin.query(f"c{c}", convs[c, t])
                assert np.array_equal(v, tv) and np.array_equal(i, ti), \
                    (t, c, twin.device)
    assert ops.fused_scan.launches + ops.fused_turn.launches > before
    # the compacted lists really changed their int8 group amax
    groups = indexes["ivf"].list_vecs.abs().amax((1, 2))
    assert (eng.index.base.list_vecs.abs().amax((1, 2)) > groups).any()


def _leaves(tree):
    out = []
    for x in tree:
        out += _leaves(x) if isinstance(x, tuple) else [x]
    return out


def _script(eng, convs, adds, build_kw):
    out = []

    def serve(t):
        if isinstance(eng, BatchedConversationalSearchEngine):
            futs = [eng.submit(f"c{c}", convs[c, t]) for c in range(N_CONV)]
            eng.drain()
            out.append([f.result(timeout=60) for f in futs])
        else:
            out.append([eng.query(f"c{c}", convs[c, t])
                        for c in range(N_CONV)])

    serve(0)
    eng.add_documents(adds[:48])
    serve(1)
    eng.delete_documents([int(out[-1][0][1][0]), 3])
    serve(2)
    eng.compact(**build_kw)
    serve(3)
    eng.add_documents(adds[48:])
    serve(4)
    eng.compact(**build_kw)
    serve(5)
    return out


@pytest.mark.cuda_only
@pytest.mark.parametrize("backend,precision", [
    ("ivf", "f32"), ("ivf", "int8"), ("ivf_pq", "f32"), ("ivf_pq", "int8"),
    ("hnsw", None)])
def test_cuda_batched_equals_sequential_through_mutations(
        dev, int_corpus, backend, precision):
    indexes, docs, convs, adds = int_corpus
    build_kw = {}
    if backend == "hnsw":
        build_kw = dict(ef_construction=32, seed=0)
        index = hnsw.build(docs[:1500], m=8, device=dev, **build_kw)
        cfg = ServingConfig(backend="hnsw", strategy="toploc", k=10,
                            ef_search=32, segment_cap=64)
    else:
        index = indexes[backend]
        cfg = ServingConfig(backend=backend, strategy="toploc+", fused=True,
                            precision=precision, nprobe=8, h=32, k=10,
                            rerank=32, segment_cap=64)
    kw = {f"{backend}_index": index}
    seq = ConversationalSearchEngine(cfg, **kw)
    bat = BatchedConversationalSearchEngine(cfg, n_slots=N_CONV,
                                            max_batch=N_CONV, max_wait_s=0.0,
                                            **kw)
    a = _script(seq, convs, adds, build_kw)
    b = _script(bat, convs, adds, build_kw)
    for ra, rb in zip(a, b):
        for (sv, si), (bv, bi) in zip(ra, rb):
            assert np.array_equal(sv, bv) and np.array_equal(si, bi)
    key = sorted((r.conv_id, r.turn, r.centroid_dists, r.list_dists,
                  r.graph_dists, r.code_dists, r.i0, r.refreshed)
                 for r in seq.records)
    assert key == sorted((r.conv_id, r.turn, r.centroid_dists, r.list_dists,
                          r.graph_dists, r.code_dists, r.i0, r.refreshed)
                         for r in bat.records)
    for x, y in zip(_leaves(seq.index), _leaves(bat.index)):
        assert (x is None and y is None) or torch.equal(x, y)
    bat.close()
