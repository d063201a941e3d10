"""The result cache of repro_torch == the reference's.

On the shared ``small_corpus`` workload (indexes built by ``repro`` and
converted), both packages' engines serve the same request streams with
the session-level historical-embedding cache (Frieder et al.) on:

* the port's sequential and batched engines equal the reference's —
  ids, every ``TurnStats`` counter and ``cache_hit`` exactly, scores
  within 1e-5 — for ivf and ivf_pq, the cache depth at k and over-
  fetched, and equal each other bit for bit;
* the non-HNSW, non-segment cases of ``tests/test_result_cache.py``:
  off == absent, hits skip the backend, misses below the threshold,
  re-scoring under the new query, the depth clamp, invalidation on
  ``end_conversation`` and slot eviction, the static replay mode, and
  ``probe``'s unit cases;
* ``probe`` gives each row the same bits at any batch size;
* a fused configuration whose fetch depth needs a top-k past the CUDA
  kernels' 2,048 is refused at construction (ROADMAP Queue 3, item 1).

A hit is decided by ``rsqrt`` and ``>= threshold``, which the two
packages may round an ulp apart: every cosine these tests compare lies
at least ``MARGIN`` from its threshold, and ``_assert_margin`` checks
so over every pair of turns of a conversation (a superset of the
anchors the cache keeps).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.serving import (BatchedConversationalSearchEngine as RBatched,
                           ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro.serving import result_cache as RRC
from repro_torch import convert
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ResultCache,
                                 ServingConfig)
from repro_torch.serving import result_cache as RC

K, H, NPROBE, ALPHA, RERANK = 10, 16, 4, 0.3, 32
THRESH = 0.6          # hits real turns on the small_corpus workload
MARGIN = 1e-5
TOL = 1e-5
CPU = "cpu"
FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
          "refreshed", "i0", "cache_hit")


@pytest.fixture(scope="module")
def tidx(ivf_index, ivf_pq_index):
    return {"ivf": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in ivf_index), device=CPU),
            "ivf_pq": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in ivf_pq_index), device=CPU)}


@pytest.fixture(scope="module")
def docs(small_corpus):
    return torch.from_numpy(small_corpus.doc_vecs)


def _kw(**kw):
    base = dict(backend="ivf", strategy="toploc+", nprobe=NPROBE, h=H,
                alpha=ALPHA, k=K, rerank=RERANK)
    base.update(kw)
    return base


def _seq(tidx, docs=None, **kw):
    cfg = ServingConfig(**_kw(**kw))
    return ConversationalSearchEngine(
        cfg, **{f"{cfg.backend}_index": tidx[cfg.backend]}, doc_vecs=docs,
        device=CPU)


def _bat(tidx, docs=None, n_slots=256, max_batch=4, **kw):
    cfg = ServingConfig(**_kw(**kw))
    return BatchedConversationalSearchEngine(
        cfg, **{f"{cfg.backend}_index": tidx[cfg.backend]}, doc_vecs=docs,
        n_slots=n_slots, max_batch=max_batch, max_wait_s=1e-4, device=CPU)


def _run(eng, convs, n_conv=4, n_turns=4):
    return [eng.query(f"c{c}", convs[c, t]) for c in range(n_conv)
            for t in range(n_turns)]


def _key(recs):
    return sorted((r.conv_id, r.turn) + tuple(getattr(r, f) for f in FIELDS)
                  for r in recs)


def _assert_margin(convs, threshold, n_conv=4, n_turns=4):
    """Every cosine between two turns of one conversation lies at least
    MARGIN from ``threshold`` (float64)."""
    c = np.asarray(convs, np.float64)[:n_conv, :n_turns]
    unit = c / np.linalg.norm(c, axis=-1, keepdims=True)
    cos = np.einsum("btd,bsd->bts", unit, unit)
    pairs = cos[:, np.tril_indices(n_turns, -1)[0],
                np.tril_indices(n_turns, -1)[1]]
    assert np.abs(pairs - threshold).min() >= MARGIN


# ------------------------------------------------- port == reference

@pytest.mark.parametrize("depth", [0, 32])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_cache_matches_reference_and_sequential_equals_batched(
        small_corpus, ivf_index, ivf_pq_index, tidx, docs, backend, depth):
    """Both engines of both packages, the cache hitting real turns:
    port == reference (ids, counters, hits exact; scores within TOL),
    the port's batched engine == its sequential engine bit for bit, and
    the hit counters agree."""
    convs = small_corpus.conversations
    _assert_margin(convs, THRESH)
    kw = _kw(backend=backend, cache_threshold=THRESH, cache_depth=depth)
    rdocs = jnp.asarray(small_corpus.doc_vecs)
    rindex = {"ivf_index": ivf_index} if backend == "ivf" else \
        {"ivf_pq_index": ivf_pq_index}
    rseq = RSeq(RConfig(**kw), **rindex, doc_vecs=rdocs)
    rbat = RBatched(RConfig(**kw), **rindex, doc_vecs=rdocs, max_batch=4,
                    max_wait_s=1e-4)
    seq = _seq(tidx, docs, **kw)
    bat = _bat(tidx, docs, **kw)
    for t in range(4):
        rfuts, futs = [], []
        for c in range(4):
            rv, ri = rseq.query(f"c{c}", jnp.asarray(convs[c, t]))
            sv, si = seq.query(f"c{c}", convs[c, t])
            np.testing.assert_array_equal(si, np.asarray(ri))
            np.testing.assert_allclose(sv, np.asarray(rv), atol=TOL, rtol=0)
            rfuts.append(rbat.submit(f"c{c}", jnp.asarray(convs[c, t])))
            futs.append((sv, si, bat.submit(f"c{c}", convs[c, t])))
        rbat.drain()
        bat.drain()
        for (sv, si, fut), rfut in zip(futs, rfuts):
            bv, bi = fut.result(timeout=5)
            rv, ri = rfut.result(timeout=5)
            assert np.array_equal(sv, bv) and np.array_equal(si, bi)
            np.testing.assert_array_equal(bi, np.asarray(ri))
            np.testing.assert_allclose(bv, np.asarray(rv), atol=TOL, rtol=0)
    assert _key(seq.records) == _key(rseq.records) == _key(bat.records) \
        == _key(rbat.records)
    assert seq.cache_stats() == bat.cache_stats() == rseq.cache_stats()
    assert seq.cache_stats()["hits"] > 0
    assert bat._cache.depth == rbat._cache.depth


@pytest.mark.parametrize("rows", [1, 2, 8, 32, 33])
def test_probe_matches_reference_and_is_batch_size_stable(rows):
    """Random entries (some invalid, some with empty slots) probed at B =
    rows and row by row: the port's rows are bit-identical at every
    batch size, and match the reference's probe (hits exact with the
    cosines MARGIN from the threshold, ids exact, scores within TOL)."""
    d, depth, out_k = 32, 16, 10
    rng = np.random.default_rng(rows)
    qv = rng.standard_normal((rows, d)).astype(np.float32)
    q = (qv + 0.8 * rng.standard_normal((rows, d))).astype(np.float32)
    ids = rng.integers(0, 500, (rows, depth)).astype(np.int32)
    ids[:, -3:] = -1
    scores = -np.sort(-rng.standard_normal((rows, depth)), axis=1
                      ).astype(np.float32)
    vecs = rng.standard_normal((rows, depth, d)).astype(np.float32)
    valid = rng.random(rows) > 0.2
    cos = (q * qv).sum(-1) / np.sqrt((q * q).sum(-1) * (qv * qv).sum(-1))
    thr = 0.5
    assert np.abs(cos.astype(np.float64) - thr).min() >= MARGIN
    entries = convert.cache_entries_from_numpy(qv, ids, scores, vecs, valid,
                                               device=CPU)
    tq = torch.from_numpy(q)
    for rescore in (True, False):
        hit, v, i = RC.probe(entries, tq, out_k=out_k, threshold=thr,
                             rescore=rescore)
        for b in range(rows):
            one = RC.probe(RC.CacheEntry(*(a[b:b + 1] for a in entries)),
                           tq[b:b + 1], out_k=out_k, threshold=thr,
                           rescore=rescore)
            for whole, alone in zip((hit, v, i), one):
                assert torch.equal(whole[b], alone[0]), (b, rescore)
        rentries = RRC.CacheEntry(*(jnp.asarray(x) for x in
                                    (qv, ids, scores, vecs, valid)))
        rhit, rv, ri = RRC.probe(rentries, jnp.asarray(q), out_k=out_k,
                                 threshold=thr, rescore=rescore)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(rhit))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=TOL,
                                   rtol=0)


# --------------------------------------------- disabled == absent

@pytest.mark.parametrize("threshold", [0.0, -1.0])
def test_cache_off_equals_cache_absent(small_corpus, tidx, docs, threshold):
    convs = small_corpus.conversations
    ref = _run(_seq(tidx, docs), convs)
    eng = _seq(tidx, docs, cache_threshold=threshold, cache_depth=32)
    got = _run(eng, convs)
    for (rv, ri), (gv, gi) in zip(ref, got):
        assert np.array_equal(rv, gv) and np.array_equal(ri, gi)
    assert eng._cache is None and eng.cache_stats() == {}
    assert not any(r.cache_hit for r in eng.records)
    bref = _run(_bat(tidx), convs)
    bgot = _run(_bat(tidx, cache_threshold=threshold), convs)
    for (rv, ri), (gv, gi) in zip(bref, bgot):
        assert np.array_equal(rv, gv) and np.array_equal(ri, gi)


# ---------------------------------------------------- hit behaviour

@pytest.mark.parametrize("batched", [False, True])
def test_cache_hits_skip_backend_and_report(small_corpus, tidx, docs,
                                            batched):
    """A repeated query is a sure hit: same docs back, zero backend work,
    the counters advance, the session does not step."""
    eng = (_bat(tidx, docs, cache_threshold=0.99) if batched
           else _seq(tidx, docs, cache_threshold=0.99))
    q = small_corpus.conversations[0, 0]
    v0, i0 = eng.query("c", q)
    v1, i1 = eng.query("c", q)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(v0, v1, rtol=1e-6)
    assert [r.cache_hit for r in eng.records] == [False, True]
    assert eng.records[1].centroid_dists == 0
    assert eng.records[1].list_dists == 0
    assert eng.records[1].i0 == -1 and not eng.records[1].refreshed
    assert eng.cache_stats() == {"hits": 1, "misses": 1, "hit_rate": 0.5}
    assert eng.summary()["cache_hit_rate"] == 0.5
    turn = (eng.store.gather([eng.store.lookup("c")]).turn[0] if batched
            else eng.sessions["c"].turn)
    assert int(turn) == 1


def test_cache_miss_below_threshold(small_corpus, tidx, docs):
    eng = _seq(tidx, docs, cache_threshold=0.9)
    q0 = small_corpus.conversations[0, 0]
    eng.query("c", q0)
    eng.query("c", -q0)                       # cosine -1
    assert eng.cache_stats()["hits"] == 0
    assert not eng.records[1].cache_hit
    assert eng.records[1].centroid_dists > 0


def test_hit_rescoring_orders_by_new_query(small_corpus, tidx, docs):
    """On a hit with a corpus, the cached docs are re-scored under the
    new query: scores are the returned docs' exact dots, descending."""
    convs = small_corpus.conversations
    unit = convs / np.linalg.norm(convs, axis=-1, keepdims=True)
    cos = (unit[:, 1:] * unit[:, :-1]).sum(-1)
    c, t = np.argwhere(cos >= 0.5 + MARGIN)[0]   # a follow-up that hits
    eng = _seq(tidx, docs, cache_threshold=0.5, cache_depth=32)
    eng.query("c", convs[c, t])
    v, i = eng.query("c", convs[c, t + 1])
    assert eng.records[1].cache_hit
    exact = small_corpus.doc_vecs[i] @ convs[c, t + 1]
    np.testing.assert_allclose(v, exact, rtol=1e-5, atol=1e-6)
    assert np.all(np.diff(v) <= 0)


def test_cache_depth_over_fetches_and_serves_topk(small_corpus, tidx, docs):
    eng = _seq(tidx, docs, cache_threshold=0.99, cache_depth=32)
    v, i = eng.query("c", small_corpus.conversations[0, 0])
    assert v.shape == (K,) and i.shape == (K,)
    entry = eng._cache._entries["c"]
    assert entry.doc_ids.shape == (32,)
    assert entry.doc_vecs.shape == (32, small_corpus.doc_vecs.shape[1])


def test_cache_depth_clamped_to_pq_rerank(small_corpus, tidx):
    """cache_depth beyond the IVF-PQ re-rank depth clamps to it, so miss
    turns serve exactly the uncached top-k with the same counters."""
    convs = small_corpus.conversations
    ref = _seq(tidx, backend="ivf_pq")
    cached = _seq(tidx, backend="ivf_pq", cache_threshold=0.5,
                  cache_depth=128)
    assert cached._cache.depth == RERANK
    assert cached._cache.rescore           # IVF-PQ keeps its corpus
    for t in range(4):
        rv, ri = ref.query("c", convs[0, t])
        cv, ci = cached.query("c", convs[0, t])
        if cached.records[-1].cache_hit:
            break                           # sessions legitimately fork
        assert np.array_equal(rv, cv) and np.array_equal(ri, ci)
        assert cached.records[-1].list_dists == ref.records[-1].list_dists


# ------------------------------------------- isolation / lifetime

@pytest.mark.parametrize("batched", [False, True])
def test_end_conversation_invalidates_entry(small_corpus, tidx, docs,
                                            batched):
    eng = (_bat(tidx, docs, cache_threshold=0.99) if batched
           else _seq(tidx, docs, cache_threshold=0.99))
    q = small_corpus.conversations[0, 0]
    eng.query("c", q)
    eng.end_conversation("c")
    eng.query("c", q)                         # same query, fresh session
    assert eng.cache_stats()["hits"] == 0
    assert not eng.records[-1].cache_hit


def test_slot_eviction_wipes_cache_row(small_corpus, tidx, docs):
    convs = small_corpus.conversations
    bat = _bat(tidx, docs, n_slots=1, max_batch=1, cache_threshold=0.99)
    bat.query("a", convs[0, 0])
    slot = bat.store.lookup("a")
    assert bool(bat._cache.gather([slot]).valid[0])
    bat.query("b", convs[1, 0])               # evicts 'a'
    bat.query("a", convs[0, 0])
    assert bat.cache_stats()["hits"] == 0
    assert not any(r.cache_hit for r in bat.records)


def test_cache_disabled_for_plain(tidx, docs):
    """The cache is session-level state: the plain strategy runs
    uncached even with a threshold set (the stateless Exact backend:
    ``tests/test_torch_hnsw_serving.py``)."""
    assert _seq(tidx, docs, strategy="plain", cache_threshold=0.9
                )._cache is None
    assert _bat(tidx, docs, strategy="plain", cache_threshold=0.9
                )._cache is None


@pytest.mark.parametrize("batched", [False, True])
def test_static_mode_without_corpus_replays_ranking(small_corpus, tidx,
                                                    batched):
    """IVF keeps no flat corpus and none was passed: hits replay the
    cached ranking."""
    eng = (_bat(tidx, cache_threshold=0.99) if batched
           else _seq(tidx, cache_threshold=0.99))
    assert eng._cache is not None and not eng._cache.rescore
    q = small_corpus.conversations[0, 0]
    v0, i0 = eng.query("c", q)
    v1, i1 = eng.query("c", q)
    assert np.array_equal(i0, i1) and np.array_equal(v0, v1)
    assert eng.records[1].cache_hit


def test_invalidate_docs_sweeps_both_modes(small_corpus, tidx, docs):
    """The tombstone sweep drops every entry (dict mode) and every slab
    row (slab mode) holding a dead id, and no other."""
    convs = small_corpus.conversations
    seq = _seq(tidx, docs, cache_threshold=0.99)
    bat = _bat(tidx, docs, cache_threshold=0.99)
    for eng in (seq, bat):
        for c in range(3):
            eng.query(f"c{c}", convs[c, 0])
    victim = int(seq.query("c0", convs[0, 0])[1][0])
    assert seq._cache.invalidate_docs([victim]) >= 1
    assert "c0" not in seq._cache._entries
    assert bat._cache.invalidate_docs([victim]) >= 1
    assert not bool(bat._cache.gather([bat.store.lookup("c0")]).valid[0])
    assert seq._cache.invalidate_docs([]) == 0


# ------------------------------------------------------- unit level

def test_probe_requires_valid_entry():
    d, k = 8, 4
    entries = RC.CacheEntry(*(a[None] for a in RC.entry_template(d, k)))
    hit, v, ids = RC.probe(entries, torch.ones((1, d)), out_k=k,
                           threshold=0.0, rescore=True)
    assert not bool(hit[0]) and ids.shape == (1, k)


def test_probe_threshold_boundary():
    d, k = 4, 2
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    entry = RC.CacheEntry(
        q_vec=q0, doc_ids=torch.tensor([3, 7], dtype=torch.int32),
        doc_scores=torch.tensor([2.0, 1.0]), doc_vecs=torch.zeros((k, d)),
        valid=torch.tensor(True))
    entries = RC.CacheEntry(*(a[None] for a in entry))
    hit, _, ids = RC.probe(entries, q0[None], out_k=k, threshold=1.0,
                           rescore=False)
    assert bool(hit[0]) and ids[0].tolist() == [3, 7]
    hit, _, _ = RC.probe(entries, torch.tensor([[0.0, 1.0, 0.0, 0.0]]),
                         out_k=k, threshold=0.5, rescore=False)
    assert not bool(hit[0])


def test_result_cache_depth_floor():
    assert ResultCache(d=8, k=10, threshold=0.5, depth=4).depth == 10


# ------------------------------- the kernels' width, at construction

@pytest.mark.parametrize("case", [
    dict(precision="bf16", cache_depth=1025, refused=True),
    dict(precision="int8", cache_depth=1024, refused=False),
    dict(precision="f32", cache_depth=2049, refused=True),
    dict(precision="f32", cache_depth=2048, refused=False),
    dict(precision="f32", fused=False, cache_depth=2600, refused=False),
    dict(precision="f32", strategy="plain", k=2049, refused=True),
    dict(backend="ivf_pq", precision="f32", rerank=2100, refused=True),
])
def test_fused_depth_past_the_kernels_is_refused_at_construction(tidx,
                                                                 case):
    """nprobe 32 of the 32 lists give a candidate pool past 2,048: a
    fused engine whose fetch depth needs a wider top-k (r = depth·over
    at bf16 / int8, the re-rank pool for IVF-PQ) is refused when it is
    built, by both engines; the unfused IVF engine serves any depth."""
    case = dict(case)
    refused = case.pop("refused")
    kw = dict(nprobe=32, cache_threshold=0.5, fused=True)
    kw.update(case)
    assert kw["nprobe"] * tidx["ivf"].lmax > 2600
    for make in (_seq, _bat):
        if refused:
            with pytest.raises(ValueError, match="Queue 3, item 1"):
                make(tidx, **kw)
        else:
            eng = make(tidx, **kw)
            assert eng._k_fetch == case.get("cache_depth", K)
