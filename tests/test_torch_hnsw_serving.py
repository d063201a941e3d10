"""Both engines of repro_torch serve HNSW and Exact as the reference's do.

On the conftest ``small_corpus`` / ``hnsw_index`` (the reference's
graph, converted), the same request streams go into both packages'
engines:

* ``ConversationalSearchEngine`` and ``BatchedConversationalSearchEngine``
  for hnsw (plain, toploc, and the adaptive backend) and exact: ids,
  sessions, every ``TurnStats`` counter and ``cache_hit`` exact, scores
  within 1e-5; the port's batched engine equals its sequential engine
  bit for bit;
* the HNSW cases of ``tests/test_result_cache.py``: the cache hitting
  on HNSW (its corpus resolved from the index), the depth clamped to ef,
  the cache off for the stateless Exact backend;
* a reference HNSW slab, taken mid-conversation, carried into the
  port's batched engine (``convert.hnsw_session_from_numpy``,
  ``SessionStore.restore``) serves the remaining turns as the
  reference does;
* an HNSW configuration past the kernel's caps is refused at
  construction (ROADMAP Queue 3, item 4).

Everything runs on CPU tensors (the kernels' plain versions).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.serving import (BatchedConversationalSearchEngine as RBatched,
                           ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro_torch import convert
from repro_torch.core import toploc
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig)

K, EF, UP = 10, 16, 2
T = 4
TOL = 1e-5
CPU = "cpu"
THRESH = 0.6
MARGIN = 1e-5
FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
          "refreshed", "i0", "cache_hit")


@pytest.fixture(scope="module")
def tindex(hnsw_index):
    return convert.hnsw_index_from_numpy(
        *(np.asarray(f) for f in hnsw_index[:5]), device=CPU)


def _kw(**kw):
    base = dict(backend="hnsw", strategy="toploc", ef_search=EF, up=UP, k=K)
    base.update(kw)
    return base


def _indexes(backend, rindex, tindex, docs):
    if backend == "exact":
        return dict(doc_vecs=jnp.asarray(docs)), dict(
            doc_vecs=torch.from_numpy(docs))
    return dict(hnsw_index=rindex), dict(hnsw_index=tindex)


def _adaptive(eng):
    """The engine with its HNSW backend re-anchoring every turn (the
    backend's knob; ServingConfig has none)."""
    eng.backend = dataclasses.replace(eng.backend, adaptive=True)
    return eng


def _key(recs):
    return sorted((r.conv_id, r.turn) + tuple(getattr(r, f) for f in FIELDS)
                  for r in recs)


def _serve_rounds(eng, convs, turns, n_conv=4, wrap=np.asarray):
    out = {}
    for t in turns:
        futs = [(c, eng.submit(f"c{c}", wrap(convs[c, t])))
                for c in range(n_conv)]
        eng.drain()
        for c, fut in futs:
            v, i = fut.result(timeout=5)
            out[(c, t)] = (np.asarray(v), np.asarray(i))
    return out


def _serve_seq(eng, convs, turns, n_conv=4, wrap=np.asarray):
    return {(c, t): tuple(np.asarray(x) for x in eng.query(
        f"c{c}", wrap(convs[c, t]))) for t in turns for c in range(n_conv)}


def _slab_rows(store, n_conv=4):
    out = {}
    for c in range(n_conv):
        slot = store.lookup(f"c{c}")
        if slot is not None:
            out[c] = [np.asarray(getattr(store.slab, f)[slot])
                      for f in toploc.HNSWSession._fields]
    return out


def _assert_margin(convs, threshold, n_conv=4, n_turns=T):
    c = np.asarray(convs, np.float64)[:n_conv, :n_turns]
    unit = c / np.linalg.norm(c, axis=-1, keepdims=True)
    cos = np.einsum("btd,bsd->bts", unit, unit)
    lo = np.tril_indices(n_turns, -1)
    assert np.abs(cos[:, lo[0], lo[1]] - threshold).min() >= MARGIN


@pytest.mark.parametrize("case", ["hnsw plain", "hnsw toploc",
                                  "hnsw adaptive", "hnsw toploc cache",
                                  "exact"])
def test_engines_match_reference_and_each_other(small_corpus, hnsw_index,
                                                tindex, case):
    """4 conversations x 4 turns through the four engines: port ==
    reference (ids, counters, hits, sessions exact; scores within TOL),
    the port's batched engine == its sequential engine bit for bit."""
    convs, docs = small_corpus.conversations, small_corpus.doc_vecs
    backend = case.split()[0]
    kw = _kw(backend=backend,
             strategy="plain" if "plain" in case else "toploc")
    if "cache" in case:
        _assert_margin(convs, THRESH)
        kw.update(cache_threshold=THRESH, cache_depth=EF)
    rkw, tkw = _indexes(backend, hnsw_index, tindex, docs)
    rseq = RSeq(RConfig(**kw), **rkw)
    rbat = RBatched(RConfig(**kw), **rkw, max_batch=4, max_wait_s=1e-4)
    seq = ConversationalSearchEngine(ServingConfig(**kw), **tkw, device=CPU)
    bat = BatchedConversationalSearchEngine(ServingConfig(**kw), **tkw,
                                            max_batch=4, max_wait_s=1e-4,
                                            device=CPU)
    if "adaptive" in case:
        for eng in (rseq, rbat, seq, bat):
            _adaptive(eng)
    ref = _serve_seq(rseq, convs, range(T), wrap=jnp.asarray)
    rref = _serve_rounds(rbat, convs, range(T), wrap=jnp.asarray)
    want = _serve_seq(seq, convs, range(T))
    got = _serve_rounds(bat, convs, range(T))
    for key, (gv, gi) in got.items():
        for rv, ri in (ref[key], rref[key]):
            np.testing.assert_array_equal(gi, ri, err_msg=str(key))
            np.testing.assert_allclose(gv, rv, atol=TOL, rtol=0)
        sv, si = want[key]
        assert np.array_equal(gv, sv) and np.array_equal(gi, si), key
    assert _key(bat.records) == _key(rbat.records) == _key(seq.records) \
        == _key(rseq.records)
    if backend == "exact" or "plain" in case:
        assert bat.store is None or not _slab_rows(bat.store)
        return
    rrows, trows = _slab_rows(rbat.store), _slab_rows(bat.store)
    assert rrows.keys() == trows.keys() == set(range(4))
    for c in range(4):
        for r, t, s in zip(rrows[c], trows[c], seq.sessions[f"c{c}"]):
            assert np.array_equal(r, t) and np.array_equal(t, s.numpy()), c
        assert tuple(int(x) for x in rseq.sessions[f"c{c}"]) == \
            tuple(int(x) for x in seq.sessions[f"c{c}"])
    if "cache" in case:
        assert seq.cache_stats() == bat.cache_stats() == rseq.cache_stats()
        assert seq.cache_stats()["hits"] > 0
        assert bat._cache.rescore and bat._cache.depth == rbat._cache.depth


def test_cache_depth_clamped_to_hnsw_beam(small_corpus, tindex):
    """cache_depth beyond ef clamps to the beam width (a top-k over an
    ef-wide pool could not be served); miss and hit turns both serve k."""
    cfg = ServingConfig(**_kw(k=5, cache_threshold=0.5, cache_depth=64))
    for eng in (ConversationalSearchEngine(cfg, hnsw_index=tindex,
                                           device=CPU),
                BatchedConversationalSearchEngine(cfg, hnsw_index=tindex,
                                                  max_batch=2, device=CPU)):
        assert eng._cache.depth == EF and eng._cache.rescore
        for t in range(3):
            v, i = eng.query("c", small_corpus.conversations[0, t])
            assert v.shape == (5,) and i.shape == (5,)


def test_cache_off_for_the_stateless_exact_backend(small_corpus):
    docs = torch.from_numpy(small_corpus.doc_vecs)
    cfg = ServingConfig(backend="exact", k=K, cache_threshold=0.9)
    assert ConversationalSearchEngine(cfg, doc_vecs=docs,
                                      device=CPU)._cache is None
    bat = BatchedConversationalSearchEngine(cfg, doc_vecs=docs, device=CPU)
    assert bat._cache is None and bat.store is None
    with pytest.raises(ValueError, match="needs doc_vecs"):
        ConversationalSearchEngine(cfg, device=CPU)


def test_reference_hnsw_slab_carried_across_mid_conversation(
        small_corpus, hnsw_index, tindex):
    """The reference batched engine serves two rounds; its HNSW slab,
    slot map, free list and turn counts go to a fresh port engine, and
    both serve the last two rounds alike."""
    convs = small_corpus.conversations
    kw = _kw()
    rbat = RBatched(RConfig(**kw), hnsw_index=hnsw_index, n_slots=6,
                    max_batch=4, max_wait_s=1e-4)
    _serve_rounds(rbat, convs, range(2), wrap=jnp.asarray)
    bat = BatchedConversationalSearchEngine(
        ServingConfig(**kw), hnsw_index=tindex, n_slots=6, max_batch=4,
        max_wait_s=1e-4, device=CPU)
    rs = rbat.store
    bat.store.restore(convert.hnsw_session_from_numpy(
        *(np.asarray(f) for f in rs.slab), device=CPU),
        list(rs._slot_of.items()), list(rs._free))
    bat.turn_count.update(rbat.turn_count)
    ref = _serve_rounds(rbat, convs, range(2, 4), wrap=jnp.asarray)
    got = _serve_rounds(bat, convs, range(2, 4))
    for key, (gv, gi) in got.items():
        np.testing.assert_array_equal(gi, ref[key][1], err_msg=str(key))
        np.testing.assert_allclose(gv, ref[key][0], atol=TOL, rtol=0)
    assert _key(bat.records) == _key(rbat.records[-8:])
    assert all(not r.refreshed for r in bat.records)   # no first turns


@pytest.mark.parametrize("knobs", [dict(ef_search=200),      # up·ef 400
                                   dict(ef_search=8, k=9),
                                   dict(ef_search=300, up=1)])
def test_hnsw_past_the_kernel_caps_is_refused_at_construction(tindex,
                                                              knobs):
    cfg = ServingConfig(**_kw(**knobs))
    for cls in (ConversationalSearchEngine,
                BatchedConversationalSearchEngine):
        with pytest.raises(ValueError, match="Queue 3, item 4"):
            cls(cfg, hnsw_index=tindex, device=CPU)
