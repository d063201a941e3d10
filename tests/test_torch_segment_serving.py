"""Both engines of repro_torch serve a mutable corpus as the reference's do.

On the conftest ``small_corpus`` workload (the reference's ivf, ivf_pq
and hnsw indexes, converted), each package's
``ConversationalSearchEngine`` and ``BatchedConversationalSearchEngine``
run with ``ServingConfig(segment_cap=CAP)`` through the same script of
turns and mutations: serve, add, serve, delete (a doc just served and a
base doc), serve, compact, serve, add, delete an added doc, serve,
compact.  For ivf and ivf_pq (toploc+ fused and unfused, plain fused,
toploc+ fused at int8) and hnsw (toploc, plain):

* the port's sequential engine equals the reference's — ids, every
  ``TurnStats`` counter, the assigned doc ids exactly, scores within
  1e-5 — and so does its batched engine the reference's batched one;
* the port's batched engine equals its sequential engine bit for bit;
* both compacted indexes equal the reference's, tensor for tensor;
* no turn serves a doc deleted before it was submitted.

Plus the corpus-mutation cases of ``tests/test_result_cache.py``: a
delete flushes the cache entries holding the victim (sequential and
batched), an add keeps them, and the corpus epoch counts mutations; and
the engine-level refusals (a frozen engine, ``exact``).

Everything runs on CPU tensors (the kernels' plain versions).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.serving import (BatchedConversationalSearchEngine as RBatched,
                           ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro_torch import convert
from repro_torch.core import segment as S
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig)

K, H, NPROBE, ALPHA, RERANK = 10, 16, 4, 0.3, 32
EF, UP = 16, 2
HKW = dict(ef_construction=32, seed=0)     # the conftest hnsw build
CAP = 12
N_CONV, TURNS = 4, 6
TOL = 1e-5
CPU = "cpu"
FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
          "refreshed", "i0", "cache_hit")

PATHS = [("ivf", dict(strategy="toploc+", fused=True)),
         ("ivf", dict(strategy="toploc+", fused=False)),
         ("ivf", dict(strategy="plain", fused=True)),
         ("ivf", dict(strategy="toploc+", fused=True, precision="int8")),
         ("ivf_pq", dict(strategy="toploc+", fused=True)),
         ("ivf_pq", dict(strategy="toploc+", fused=False)),
         ("ivf_pq", dict(strategy="plain", fused=True)),
         ("hnsw", dict(strategy="toploc")),
         ("hnsw", dict(strategy="plain"))]


@pytest.fixture(scope="module")
def tidx(ivf_index, ivf_pq_index, hnsw_index):
    return {"ivf": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in ivf_index), device=CPU),
            "ivf_pq": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in ivf_pq_index), device=CPU),
            "hnsw": convert.hnsw_index_from_numpy(
                *(np.asarray(f) for f in hnsw_index[:5]), device=CPU)}


@pytest.fixture(scope="module")
def ridx(ivf_index, ivf_pq_index, hnsw_index):
    return {"ivf": ivf_index, "ivf_pq": ivf_pq_index, "hnsw": hnsw_index}


@pytest.fixture(scope="module")
def pool(small_corpus):
    """Docs to ingest: the conversations' turns, nudged and re-normed,
    so added docs reach the served top-k."""
    rng = np.random.default_rng(5)
    x = small_corpus.conversations[:N_CONV].reshape(
        -1, small_corpus.doc_vecs.shape[1])
    x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _kw(backend, **kw):
    return dict(dict(backend=backend, nprobe=NPROBE, h=H, alpha=ALPHA, k=K,
                     rerank=RERANK, ef_search=EF, up=UP, segment_cap=CAP),
                **kw)


def _engines(backend, path, tidx, ridx, **kw):
    """(port sequential, port batched, reference sequential, reference
    batched)."""
    cfg = _kw(backend, **path)
    ti = {f"{backend}_index": tidx[backend]}
    ri = {f"{backend}_index": ridx[backend]}
    bkw = dict(n_slots=8, max_batch=4, max_wait_s=1e-4)
    return (ConversationalSearchEngine(ServingConfig(**cfg), **ti,
                                       device=CPU, **kw),
            BatchedConversationalSearchEngine(ServingConfig(**cfg), **ti,
                                              device=CPU, **bkw, **kw),
            RSeq(RConfig(**cfg), **ri),
            RBatched(RConfig(**cfg), **ri, **bkw))


def _serve(eng, convs, t, wrap):
    """Turn t of every conversation; [(v, i)] in conversation order."""
    if isinstance(eng, (BatchedConversationalSearchEngine, RBatched)):
        futs = [eng.submit(f"c{c}", wrap(convs[c, t]))
                for c in range(N_CONV)]
        eng.drain()
        out = [f.result() for f in futs]
    else:
        out = [eng.query(f"c{c}", wrap(convs[c, t])) for c in range(N_CONV)]
    return [(np.asarray(v), np.asarray(i)) for v, i in out]


def _script(eng, convs, pool, build_kw, wrap):
    """The mutation script; returns (served rows by turn, assigned ids).
    Checks that no turn served a doc deleted before it and that added
    docs were served."""
    served, added, dead, dead_before = [], [], [], []

    def serve(t):
        dead_before.append(list(dead))
        served.append(_serve(eng, convs, t, wrap))

    serve(0)
    added.append(eng.add_documents(pool[:8]))
    serve(1)
    victims = [int(served[-1][0][1][0]), 7]     # a doc just served, a base doc
    eng.delete_documents(victims)
    dead += victims
    serve(2)
    eng.compact(**build_kw)
    serve(3)
    added.append(eng.add_documents(pool[8:12]))
    victim = int(added[-1][1])
    eng.delete_documents([victim])
    dead.append(victim)
    serve(4)
    eng.compact(**build_kw)
    serve(5)
    for rows, gone in zip(served, dead_before):
        for _, ids in rows:
            assert not set(ids.tolist()) & set(gone)
    assert eng.corpus_epoch == 6
    assert any(int(i.max()) >= int(added[0][0])        # the delta is served
               for rows in served[1:3] for _, i in rows)
    return served, np.concatenate(added)


def _keyed(eng):
    return sorted((r.conv_id, r.turn) + tuple(getattr(r, f) for f in FIELDS)
                  for r in eng.records)


def _same(port, ref, exact):
    for rows_p, rows_r in zip(port, ref):
        for (pv, pi), (rv, ri) in zip(rows_p, rows_r):
            np.testing.assert_array_equal(pi, ri)
            if exact:
                np.testing.assert_array_equal(pv, rv)
            else:
                np.testing.assert_allclose(pv, rv, atol=TOL, rtol=0)


def _leaves(tree):
    out = []
    for x in tree:
        out += _leaves(x) if isinstance(x, tuple) else [x]
    return out


def _index_equal(ref_seg, port_seg):
    la = jax.tree.leaves(ref_seg, is_leaf=lambda x: x is None)
    lb = _leaves(port_seg)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert np.array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("backend,path", PATHS,
                         ids=[f"{b}-{'-'.join(map(str, p.values()))}"
                              for b, p in PATHS])
def test_engines_serve_the_mutation_script_as_the_reference(
        backend, path, tidx, ridx, small_corpus, pool):
    convs = small_corpus.conversations
    build_kw = HKW if backend == "hnsw" else {}
    seq, bat, rseq, rbat = _engines(backend, path, tidx, ridx)
    assert isinstance(seq.backend, S.SegmentedBackend)
    got, ids = _script(seq, convs, pool, build_kw, np.asarray)
    got_b, ids_b = _script(bat, convs, pool, build_kw, np.asarray)
    want, rids = _script(rseq, convs, pool, build_kw, jnp.asarray)
    want_b, rids_b = _script(rbat, convs, pool, build_kw, jnp.asarray)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(ids_b, rids_b)
    _same(got, want, exact=False)
    _same(got_b, want_b, exact=False)
    _same(got_b, got, exact=True)                # batched == sequential
    assert _keyed(seq) == _keyed(rseq)
    assert _keyed(bat) == _keyed(rbat) == _keyed(seq)
    _index_equal(rseq._seg_host, seq.index)
    _index_equal(rbat._seg_host, bat.index)
    bat.close()
    rbat.close()


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_cache_hit_never_serves_deleted_doc(engine, tidx, ivf_index,
                                            small_corpus):
    """``delete_documents`` drops every cache entry holding the dead id:
    the repeat that would hit re-runs the backend (tombstone-masked);
    the reference does the same."""
    wl = small_corpus
    docs = torch.from_numpy(wl.doc_vecs)
    cfg = _kw("ivf", strategy="toploc+", cache_threshold=0.95,
              segment_cap=4)
    if engine == "sequential":
        eng = ConversationalSearchEngine(ServingConfig(**cfg),
                                         ivf_index=tidx["ivf"],
                                         doc_vecs=docs, device=CPU)
        ref = RSeq(RConfig(**cfg), ivf_index=ivf_index,
                   doc_vecs=jnp.asarray(wl.doc_vecs))
    else:
        kw = dict(max_batch=4, max_wait_s=1e-4)
        eng = BatchedConversationalSearchEngine(
            ServingConfig(**cfg), ivf_index=tidx["ivf"], doc_vecs=docs,
            device=CPU, **kw)
        ref = RBatched(RConfig(**cfg), ivf_index=ivf_index,
                       doc_vecs=jnp.asarray(wl.doc_vecs), **kw)
    q = wl.conversations[0, 0]
    for e, wrap in ((eng, np.asarray), (ref, jnp.asarray)):
        e.query("c", wrap(q))
        _, i_hit = e.query("c", wrap(q))          # verbatim repeat: a hit
        assert e.records[-1].cache_hit
        victim = int(np.asarray(i_hit)[0])
        e.delete_documents([victim])
        assert e.corpus_epoch == 1
        _, i2 = e.query("c", wrap(q))
        assert not e.records[-1].cache_hit        # the entry was dropped
        assert victim not in np.asarray(i2)
        _, i3 = e.query("c", wrap(q))             # repopulated without it
        assert e.records[-1].cache_hit
        assert victim not in np.asarray(i3)
    assert _keyed(eng) == _keyed(ref)
    if engine == "batched":
        eng.close()
        ref.close()


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_adds_leave_cache_entries_valid(engine, tidx, ivf_index,
                                        small_corpus):
    """Ingest never invalidates: the existing entry's docs are all live,
    so the next near-duplicate turn still hits, as in the reference; the
    cache's corpus grows by the delta rows."""
    wl = small_corpus
    docs = torch.from_numpy(wl.doc_vecs)
    cfg = ServingConfig(**_kw("ivf", strategy="toploc+",
                              cache_threshold=0.95, segment_cap=4))
    eng = (ConversationalSearchEngine(cfg, ivf_index=tidx["ivf"],
                                      doc_vecs=docs, device=CPU)
           if engine == "sequential" else
           BatchedConversationalSearchEngine(cfg, ivf_index=tidx["ivf"],
                                             doc_vecs=docs, device=CPU,
                                             max_batch=4, max_wait_s=1e-4))
    q = wl.conversations[0, 0]
    eng.query("c", q)
    n0 = eng._cache.corpus.shape[0]
    eng.add_documents(wl.doc_vecs[:2] * 0.7)
    eng.query("c", q)
    assert eng.records[-1].cache_hit
    assert eng.corpus_epoch == 1 and eng._cache.corpus.shape[0] == n0
    assert torch.equal(eng._cache.corpus[len(wl.doc_vecs):][:2],
                       docs[:2] * 0.7)
    ref = RSeq(RConfig(**_kw("ivf", strategy="toploc+",
                             cache_threshold=0.95, segment_cap=4)),
               ivf_index=ivf_index, doc_vecs=jnp.asarray(wl.doc_vecs))
    ref.query("c", jnp.asarray(q))
    ref.add_documents(wl.doc_vecs[:2] * 0.7)
    ref.query("c", jnp.asarray(q))
    assert _keyed(eng) == _keyed(ref)


def test_compaction_grows_the_flat_corpus(tidx, small_corpus):
    """With ``doc_vecs`` given, a compaction appends the delta rows to
    the engine's flat corpus, so cache re-scoring covers the folded ids."""
    wl = small_corpus
    docs = torch.from_numpy(wl.doc_vecs)
    eng = ConversationalSearchEngine(
        ServingConfig(**_kw("ivf", strategy="toploc+",
                            cache_threshold=0.95, segment_cap=4)),
        ivf_index=tidx["ivf"], doc_vecs=docs, device=CPU)
    eng.add_documents(wl.doc_vecs[:3])
    eng.compact()
    assert torch.equal(eng.doc_vecs, torch.cat([docs, docs[:3]]))
    assert eng._cache.corpus.shape[0] == len(wl.doc_vecs) + 3 + 4


def test_frozen_engine_refuses_mutation(tidx):
    eng = ConversationalSearchEngine(ServingConfig(**_kw(
        "ivf", segment_cap=0)), ivf_index=tidx["ivf"], device=CPU)
    for call in (lambda: eng.add_documents(np.zeros((1, 32), np.float32)),
                 lambda: eng.delete_documents([0]), eng.compact):
        with pytest.raises(RuntimeError, match="segment_cap"):
            call()


def test_exact_refuses_a_segment_as_the_reference(small_corpus):
    docs = small_corpus.doc_vecs
    with pytest.raises(NotImplementedError, match="exact"):
        ConversationalSearchEngine(ServingConfig(backend="exact",
                                                 segment_cap=4),
                                   doc_vecs=torch.from_numpy(docs),
                                   device=CPU)
    with pytest.raises(NotImplementedError, match="exact"):
        RSeq(RConfig(backend="exact", segment_cap=4),
             doc_vecs=jnp.asarray(docs))


def test_compaction_past_the_kernel_caps_keeps_the_index(tidx, small_corpus,
                                                         monkeypatch):
    """A compaction whose new Lmax would take a fused fetch past the
    kernels' top-k cap is refused before the index is swapped: the
    engine keeps serving the index it had, and its epoch stands."""
    from repro_torch.kernels import tiling
    eng = ConversationalSearchEngine(
        ServingConfig(**_kw("ivf", strategy="toploc+", fused=True,
                            precision="int8", segment_cap=64)),
        ivf_index=tidx["ivf"], device=CPU)
    lmax = tidx["ivf"].lmax
    # every added doc on one list: that list outgrows the others
    cent = tidx["ivf"].centroids[0].numpy()
    eng.add_documents(np.repeat(cent[None], 64, 0))
    before, epoch = eng.index, eng.corpus_epoch
    r = 2 * K                                    # k·over at int8
    monkeypatch.setattr(tiling, "MAX_PAD", tiling.next_pow2(r) // 2)
    with pytest.raises(ValueError, match="Queue 3, item 1"):
        eng.compact()
    assert eng.index is before and eng.corpus_epoch == epoch
    monkeypatch.undo()
    eng.compact()
    assert eng.index.base.lmax > lmax and eng.corpus_epoch == epoch + 1
