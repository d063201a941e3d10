"""The batched engine and the session store of repro_torch == the reference.

On the shared ``small_corpus`` workload (2,000 docs, d = 32, IVF p = 32,
PQ m = 8; indexes built by ``repro`` and converted), the same request
streams go into both packages' engines:

* the port's ``BatchedConversationalSearchEngine`` equals the
  reference's batched engine — ids, every ``TurnStats`` counter and the
  session slab exactly, scores within 1e-5 — for ivf and ivf_pq,
  toploc / toploc+ / plain, fused and not;
* it equals the port's sequential engine bit for bit;
* the IVF / IVF-PQ cases of ``tests/test_serving_batched.py``: the
  ``SessionStore`` slot model (reuse, LRU eviction, the trash slot,
  release and eviction zeroing the row, listeners, ``clear`` in one
  scatter), padding, waves of one conversation, eviction mid-
  conversation, the accounting, two waves in flight and
  ``end_conversation`` during a wave;
* a reference engine's slab, taken mid-conversation, carried into the
  port's engine (``convert``, ``SessionStore.restore``) serves the
  remaining turns as the reference does.

Everything runs on CPU tensors (the kernels' plain versions).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.serving import (BatchedConversationalSearchEngine as RBatched,
                           ServingConfig as RConfig)
from repro_torch import convert
from repro_torch.core import toploc
from repro_torch.core.backend import IVFBackend, IVFPQBackend
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig,
                                 ivf_pq_session_store,
                                 ivf_session_store)
from repro_torch.serving import sessions as SS

K, H, NPROBE, RERANK = 10, 16, 4, 32
T = 4
TOL = 1e-5
CPU = "cpu"
STAT_FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
               "refreshed", "i0", "cache_hit")


@pytest.fixture(scope="module")
def tidx(ivf_index, ivf_pq_index):
    """The reference's indexes as the port's, on the CPU."""
    return {"ivf": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in ivf_index), device=CPU),
            "ivf_pq": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in ivf_pq_index), device=CPU)}


@pytest.fixture(scope="module")
def ridx(ivf_index, ivf_pq_index):
    return {"ivf": ivf_index, "ivf_pq": ivf_pq_index}


def _cfg(**kw):
    base = dict(backend="ivf", strategy="toploc+", nprobe=NPROBE, h=H,
                alpha=0.3, k=K, rerank=RERANK)
    base.update(kw)
    return ServingConfig(**base)


def _engine(cls, cfg, tidx, **kw):
    return cls(cfg, **{f"{cfg.backend}_index": tidx[cfg.backend]},
               device=CPU, **kw)


def _key(recs):
    return sorted((r.conv_id, r.turn) + tuple(getattr(r, f)
                                              for f in STAT_FIELDS)
                  for r in recs)


def _serve_rounds(eng, convs, turns, n_conv=4):
    """Each round every conversation submits one request, then the
    engine drains; returns {(conv, turn): (scores, ids)}."""
    out = {}
    for t in turns:
        futs = [(c, eng.submit(f"c{c}", convs[c, t])) for c in range(n_conv)]
        eng.drain()
        for c, fut in futs:
            v, i = fut.result(timeout=5)
            out[(c, t)] = (np.asarray(v), np.asarray(i))
    return out


def _serve_seq(eng, convs, turns, n_conv=4):
    return {(c, t): eng.query(f"c{c}", convs[c, t])
            for t in turns for c in range(n_conv)}


def _slab_rows(store, n_conv=4):
    """{conv: session row as numpy fields} from a store of either
    package."""
    out = {}
    for c in range(n_conv):
        slot = store.lookup(f"c{c}")
        if slot is None:
            continue
        out[c] = [np.asarray(getattr(store.slab, f)[slot])
                  if not isinstance(store.slab[0], torch.Tensor)
                  else getattr(store.slab, f)[slot].numpy()
                  for f in toploc.IVFSession._fields]
    return out


# ----------------------------------------------- port == reference engine

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("strategy", ["toploc", "toploc+", "plain"])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_batched_engine_matches_reference_and_sequential(
        small_corpus, ridx, tidx, backend, strategy, fused):
    """4 conversations x 4 turns at max_batch 4: the port's batched
    engine == the reference's (ids, counters, slab exactly; scores
    within TOL) and == the port's sequential engine bit for bit."""
    convs = small_corpus.conversations
    cfg = _cfg(backend=backend, strategy=strategy, fused=fused)
    rbat = RBatched(RConfig(**cfg.__dict__),
                    **{f"{backend}_index": ridx[backend]}, max_batch=4,
                    max_wait_s=1e-4)
    bat = _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=4,
                  max_wait_s=1e-4)
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    rconvs = jnp.asarray(convs)
    ref = _serve_rounds(rbat, rconvs, range(T))
    got = _serve_rounds(bat, convs, range(T))
    want = _serve_seq(seq, convs, range(T))
    for key, (gv, gi) in got.items():
        rv, ri = ref[key]
        np.testing.assert_array_equal(gi, ri, err_msg=str(key))
        np.testing.assert_allclose(gv, rv, atol=TOL, rtol=0)
        sv, si = want[key]
        assert np.array_equal(gv, sv) and np.array_equal(gi, si), key
    assert _key(bat.records) == _key(rbat.records) == _key(seq.records)
    if strategy != "plain":
        rrows, trows = _slab_rows(rbat.store), _slab_rows(bat.store)
        assert rrows.keys() == trows.keys() == set(range(4))
        for c in range(4):
            for f, r, t in zip(toploc.IVFSession._fields, rrows[c],
                               trows[c]):
                if f == "cache_vecs":
                    np.testing.assert_array_equal(r, t)
                else:
                    assert np.array_equal(r, t), (c, f)
            for f, s in zip(toploc.IVFSession._fields,
                            seq.sessions[f"c{c}"]):
                assert np.array_equal(trows[c][toploc.IVFSession._fields
                                               .index(f)], s.numpy())


def test_reference_slab_carried_across_mid_conversation(small_corpus, ridx,
                                                        tidx):
    """The reference batched engine serves two rounds (toploc+, the
    result cache on); its session slab and cache slab, slot map, free
    list and turn counts go to a fresh port engine, and both serve the
    last two rounds alike: ids, counters, hits, scores within TOL."""
    convs = small_corpus.conversations
    docs = small_corpus.doc_vecs
    kw = dict(backend="ivf", strategy="toploc+", nprobe=NPROBE, h=H,
              alpha=0.3, k=K, cache_threshold=0.6, cache_depth=16)
    rbat = RBatched(RConfig(**kw), ivf_index=ridx["ivf"],
                    doc_vecs=jnp.asarray(docs), n_slots=6, max_batch=4,
                    max_wait_s=1e-4)
    _serve_rounds(rbat, jnp.asarray(convs), range(2))
    bat = BatchedConversationalSearchEngine(
        ServingConfig(**kw), ivf_index=tidx["ivf"],
        doc_vecs=torch.from_numpy(docs), n_slots=6, max_batch=4,
        max_wait_s=1e-4, device=CPU)
    rs, rc = rbat.store, rbat._cache._slab
    slot_of, free = list(rs._slot_of.items()), list(rs._free)
    bat.store.restore(convert.ivf_session_from_numpy(
        *(np.asarray(f) for f in rs.slab), device=CPU), slot_of, free)
    bat._cache._slab.restore(convert.cache_entries_from_numpy(
        *(np.asarray(f) for f in rc.slab), device=CPU), slot_of, free)
    bat.turn_count.update(rbat.turn_count)
    ref = _serve_rounds(rbat, jnp.asarray(convs), range(2, 4))
    got = _serve_rounds(bat, convs, range(2, 4))
    for key, (gv, gi) in got.items():
        np.testing.assert_array_equal(gi, ref[key][1], err_msg=str(key))
        np.testing.assert_allclose(gv, ref[key][0], atol=TOL, rtol=0)
    assert _key(bat.records) == _key(rbat.records[-8:])
    assert any(r.cache_hit for r in bat.records)


# ------------------------------------------------------------ SessionStore

def test_session_store_slot_reuse_and_eviction(tidx):
    store = ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=2)
    s0, new0 = store.acquire("a")
    s1, new1 = store.acquire("b")
    assert new0 and new1 and s0 != s1
    assert store.acquire("a") == (s0, False)
    s2, new2 = store.acquire("c")              # 'b' is LRU → evicted
    assert new2 and s2 == s1
    assert store.evictions == 1
    assert store.lookup("b") is None
    s3, new3 = store.acquire("b")
    assert new3
    freed = store.release("c")
    s4, new4 = store.acquire("d")
    assert new4 and s4 == freed
    assert store.occupancy == 2
    assert store.stats() == {"n_slots": 2, "occupancy": 2, "allocs": 5,
                             "evictions": 2, "hits": 1}


def test_session_store_gather_scatter_roundtrip(tidx):
    store = ivf_pq_session_store(tidx["ivf_pq"], h=H, nprobe=NPROBE,
                                 n_slots=4)
    slots = [store.acquire(f"c{j}")[0] for j in range(3)]
    sess = store.gather(slots)
    assert sess.cache_vecs.shape == (3, H, tidx["ivf"].d)
    bumped = sess._replace(turn=sess.turn + torch.arange(3,
                                                         dtype=torch.int32))
    store.scatter(slots, bumped)
    assert store.gather(slots).turn.tolist() == [0, 1, 2]
    # the trash slot absorbs padded rows (twice in one scatter) without
    # touching live sessions
    pad = store.gather([slots[0], store.trash_slot])
    store.scatter([store.trash_slot, store.trash_slot],
                  SS.tree_map(lambda a: a + 1, pad))
    assert store.gather(slots).turn.tolist() == [0, 1, 2]
    assert store.trash_slot == 4


def _dirty(store, slot):
    store.scatter([slot], SS.tree_map(lambda a: a + 1,
                                      store.gather([slot])))


def _zero(store, slot):
    return all(bool((f == 0).all()) for f in store.gather([slot]))


def test_release_zeroes_slab_row_and_is_idempotent(tidx):
    store = ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=2)
    slot, _ = store.acquire("a")
    _dirty(store, slot)
    assert int(store.gather([slot]).turn[0]) == 1
    assert store.release("a") == slot and _zero(store, slot)
    n_free = len(store._free)
    assert store.release("a") is None
    assert len(store._free) == n_free
    s1, _ = store.acquire("x")
    s2, _ = store.acquire("y")
    assert s1 != s2


def test_eviction_zeroes_slab_row_before_slot_reuse(tidx):
    store = ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=1)
    slot, _ = store.acquire("old")
    _dirty(store, slot)
    new_slot, is_new = store.acquire("new")
    assert new_slot == slot and is_new and store.evictions == 1
    assert _zero(store, new_slot)


def test_slot_freed_listeners_fire_on_release_and_eviction(tidx):
    store = ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=1)
    freed = []
    store.add_slot_freed_listener(freed.append)
    slot, _ = store.acquire("a")
    store.release("a")
    assert freed == [slot]
    slot2, _ = store.acquire("b")
    store.acquire("c")                        # evicts "b"
    assert freed == [slot, slot2]
    store.release("nope")
    assert freed == [slot, slot2]


def test_clear_zeroes_many_slots_in_one_scatter(tidx, monkeypatch):
    store = ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=8)
    slots = []
    for cid in "abcd":
        s, _ = store.acquire(cid)
        _dirty(store, s)
        slots.append(s)
    calls = []
    real = SS._scatter_slab

    def counting(slab, idx, updates):
        calls.append(int(idx.shape[0]))
        return real(slab, idx, updates)

    monkeypatch.setattr(SS, "_scatter_slab", counting)
    store.clear(slots)
    assert calls == [len(slots)]
    assert all(_zero(store, s) for s in slots)
    store.clear([])
    assert calls == [len(slots)]
    freed = []
    store.add_slot_freed_listener(freed.append)
    store.clear([slots[1]])
    assert freed == []                        # clear() is not a hand-over
    store.release("a")
    assert freed == [slots[0]]


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_stores_raise(tidx, what):
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        ivf_session_store(tidx["ivf"], h=H, nprobe=NPROBE, n_slots=2,
                          mesh=object())


def test_session_template_matches_the_reference(ivf_index, tidx):
    """The slab layout: ``session_template`` has the reference's shapes
    and dtypes, on the index's device."""
    from repro.core.backend import IVFBackend as RBackend
    ref = RBackend(h=H, nprobe=NPROBE).session_template(ivf_index)
    got = IVFBackend(h=H, nprobe=NPROBE).session_template(tidx["ivf"])
    for r, g in zip(ref, got):
        assert tuple(r.shape) == tuple(g.shape)
        assert np.asarray(r).dtype == g.numpy().dtype
        assert g.device.type == "cpu" and not bool(g.any())
    bk = IVFPQBackend(h=H, nprobe=NPROBE, rerank=RERANK)
    assert bk.fetch_limit(tidx["ivf_pq"]) == min(
        RERANK, NPROBE * tidx["ivf_pq"].lmax)
    assert bk.corpus_vectors(tidx["ivf_pq"]) is tidx["ivf_pq"].doc_vecs
    assert IVFBackend(nprobe=NPROBE).fetch_limit(tidx["ivf"]) == \
        NPROBE * tidx["ivf"].lmax
    assert IVFBackend().corpus_vectors(tidx["ivf"]) is None
    assert IVFBackend().query_dim(tidx["ivf"]) == tidx["ivf"].d


# ------------------------------------------- engine behaviour (port only)

def test_batched_engine_rejects_undersized_store(tidx):
    with pytest.raises(ValueError, match="n_slots"):
        _engine(BatchedConversationalSearchEngine, _cfg(strategy="toploc"),
                tidx, n_slots=4, max_batch=32)


def test_batched_engine_max_batch_beyond_buckets(small_corpus, tidx):
    """max_batch above the largest default bucket gets its own bucket:
    one 40-row wave pads to 64."""
    convs = small_corpus.conversations
    cfg = _cfg(strategy="toploc")
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    bat = _engine(BatchedConversationalSearchEngine, cfg, tidx, n_slots=64,
                  max_batch=64, max_wait_s=1e-4)
    assert bat.batcher.bucket(64) == 64
    futs = [bat.submit(f"c{c}", convs[c % 4, 0]) for c in range(40)]
    bat.drain()
    assert bat.batcher.padded_sizes == [64]
    for c, fut in enumerate(futs):
        sv, si = seq.query(f"s{c}", convs[c % 4, 0])
        bv, bi = fut.result(timeout=5)
        assert np.array_equal(sv, bv) and np.array_equal(si, bi)


@pytest.mark.parametrize("inflight", [False, True])
def test_batched_engine_waves_same_conversation(small_corpus, tidx,
                                                inflight):
    """Three turns of one conversation, in one flush (consecutive waves)
    or in three un-synced flushes (two in flight): turn t+1 sees turn
    t's scattered session."""
    convs = small_corpus.conversations
    cfg = _cfg(strategy="toploc")
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    with _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=8,
                 max_wait_s=1e-4, max_inflight=2) as bat:
        futs = []
        for t in range(3):
            futs.append(bat.submit("c0", convs[0, t]))
            if inflight:
                bat.flush()
        bat.drain()
        for t, fut in enumerate(futs):
            sv, si = seq.query("c0", convs[0, t])
            bv, bi = fut.result(timeout=5)
            assert np.array_equal(sv, bv) and np.array_equal(si, bi), t
        assert [r.turn for r in bat.records] == [0, 1, 2]


@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_evicted_live_conversation_resumes_as_first_turn(small_corpus, tidx,
                                                         backend):
    convs = small_corpus.conversations
    cfg = _cfg(backend=backend)
    bat = _engine(BatchedConversationalSearchEngine, cfg, tidx, n_slots=2,
                  max_batch=2, max_wait_s=1e-4)
    bk = (IVFBackend(h=H, nprobe=NPROBE) if backend == "ivf" else
          IVFPQBackend(h=H, nprobe=NPROBE, rerank=RERANK))
    idx = tidx[backend]
    bat.query("a", convs[0, 0])
    bat.query("b", convs[1, 0])
    bat.query("c", convs[2, 0])                # evicts LRU 'a'
    assert bat.store.evictions == 1 and bat.store.lookup("a") is None
    v, i = bat.query("a", convs[0, 1])
    rv, ri, _, _ = toploc.start(bk, idx, torch.from_numpy(convs[0, 1]), k=K,
                                device=CPU)
    assert np.array_equal(v, rv.numpy()) and np.array_equal(i, ri.numpy())
    rec = bat.records[-1]
    assert rec.conv_id == "a" and rec.turn == 1
    assert rec.centroid_dists == idx.p and rec.refreshed and rec.i0 == -1
    bat.query("a", convs[0, 2])
    assert bat.records[-1].centroid_dists in (H, H + idx.p)


def test_trash_slot_and_padding_never_leak(small_corpus, tidx):
    """Flushes of 3 pad to bucket 4: no record for the pad row, results
    bit-identical to sequential, live slab rows == the sequential
    sessions, the trash slot mapped to no conversation."""
    convs = small_corpus.conversations
    cfg = _cfg()
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    bat = _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=4,
                  max_wait_s=1e-4)
    got = _serve_rounds(bat, convs, range(3), n_conv=3)
    want = _serve_seq(seq, convs, range(3), n_conv=3)
    for key in want:
        assert all(np.array_equal(a, b) for a, b in zip(got[key],
                                                        want[key])), key
    assert bat.batcher.padded_sizes == [4, 4, 4]
    assert len(bat.records) == 9
    assert sorted((r.conv_id, r.turn) for r in bat.records) == \
        [(f"c{c}", t) for c in range(3) for t in range(3)]
    for c in range(3):
        row = bat.store.gather([bat.store.lookup(f"c{c}")])
        for f, s in zip(toploc.IVFSession._fields, seq.sessions[f"c{c}"]):
            assert torch.equal(getattr(row, f)[0], s), (c, f)
    assert bat.store.trash_slot not in [bat.store.lookup(f"c{c}")
                                        for c in range(3)]


def test_latency_accounting_splits_queue_wait_from_service(small_corpus,
                                                           tidx):
    convs = small_corpus.conversations
    cfg = _cfg()
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    bat = _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=4,
                  max_wait_s=1e-4)
    _serve_seq(seq, convs, range(T), n_conv=3)
    _serve_rounds(bat, convs, range(T), n_conv=3)
    assert all(r.queue_wait_s == 0.0 for r in seq.records)
    assert all(r.queue_wait_s >= 0.0 and r.latency_s >= 0.0
               for r in bat.records)
    for s in (seq.summary(), bat.summary()):
        assert {"mean_queue_wait_ms", "p95_request_ms",
                "p95_latency_ms"} <= s.keys()
        assert s["p95_request_ms"] >= s["p95_latency_ms"]
    assert seq.summary()["refresh_rate"] == bat.summary()["refresh_rate"]


def test_refresh_rate_counts_followup_turns_only(small_corpus, tidx):
    """refresh_rate is the share of FOLLOW-UP turns that refreshed: with
    interleaved conversations the first turns (refreshed by convention)
    are not records[0] alone, so the summary filters on turn > 0."""
    convs = small_corpus.conversations
    eng = _engine(ConversationalSearchEngine, _cfg(alpha=-1.0), tidx)
    for t in range(2):
        for c in range(2):
            eng.query(f"c{c}", convs[c, t])
    assert [r.turn for r in eng.records] == [0, 0, 1, 1]
    assert [r.refreshed for r in eng.records] == [True, True, False, False]
    assert eng.summary()["refresh_rate"] == 0.0


def test_two_in_flight_waves_preserve_order_and_identity(small_corpus,
                                                         tidx):
    convs = small_corpus.conversations
    cfg = _cfg()
    seq = _engine(ConversationalSearchEngine, cfg, tidx)
    with _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=4,
                 max_wait_s=1e-4, max_inflight=2) as bat:
        futs = []
        for t in range(T):
            for c in range(4):
                futs.append((seq.query(f"c{c}", convs[c, t]),
                             bat.submit(f"c{c}", convs[c, t])))
            assert bat.flush() == 4
            assert bat.batcher.inflight <= 2
        assert futs[0][1].done() and futs[7][1].done()
        assert not futs[-1][1].done()
        bat.sync()
        assert bat.batcher.inflight == 0
        for (sv, si), fut in futs:
            bv, bi = fut.result(timeout=5)
            assert np.array_equal(sv, bv) and np.array_equal(si, bi)
        for c in range(4):
            turns = [r.turn for r in bat.records if r.conv_id == f"c{c}"]
            assert turns == sorted(turns)


def test_end_conversation_during_a_wave(small_corpus, tidx):
    """A release while the conversation's wave is in flight waits for
    the wave (paused batcher); the slot comes back zeroed, and its next
    occupant is served as a clean first turn."""
    convs = small_corpus.conversations
    cfg = _cfg()
    bk = IVFBackend(h=H, nprobe=NPROBE, alpha=0.3)
    with _engine(BatchedConversationalSearchEngine, cfg, tidx, max_batch=2,
                 max_wait_s=1e-4, max_inflight=2) as bat:
        fut = bat.submit("c0", convs[0, 0])
        bat.flush()                                # launched, not retired
        slot = bat.store.lookup("c0")
        bat.end_conversation("c0")
        v, i = fut.result(timeout=5)
        rv, ri, _, _ = toploc.start(bk, tidx["ivf"],
                                    torch.from_numpy(convs[0, 0]), k=K,
                                    device=CPU)
        assert np.array_equal(v, rv.numpy()) and np.array_equal(i, ri.numpy())
        assert bat.store.lookup("c0") is None and "c0" not in bat.turn_count
        assert _zero(bat.store, slot)
        v, i = bat.query("b", convs[1, 0])
        assert bat.store.lookup("b") == slot
        rv, ri, _, _ = toploc.start(bk, tidx["ivf"],
                                    torch.from_numpy(convs[1, 0]), k=K,
                                    device=CPU)
        assert np.array_equal(v, rv.numpy()) and np.array_equal(i, ri.numpy())


def test_engines_default_to_cuda(tidx, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (BatchedConversationalSearchEngine,
                ConversationalSearchEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(_cfg(), ivf_index=tidx["ivf"])
