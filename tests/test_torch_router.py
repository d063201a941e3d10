"""The port's replica router: affinity, load balance, hedging, identity.

Counterparts of the 18 tests of ``tests/test_serving_replicated.py`` on
``repro_torch.serving.ReplicatedSearchEngine``: routing conversations
over R replica engines — each with its own session slab, result cache
and (optionally) corpus submesh — equals a single sequential engine
serving that conversation, per session, bit for bit; stateless traffic
is hedged and identical whichever replica wins.  The reference skips
its 2-D mesh cases below 4 devices; here the meshes repeat the CPU
device, so every case runs.  The first routed run is also held to the
reference's sequential engine (ids exact, scores within 1e-5).

Plus the sanitizer's scenario C (``tests/test_concurrency.py``): add /
delete / compact broadcast over a 2-replica router while pinned clients
query, under seeded schedules: no violation, k results a turn, one
corpus epoch across replicas.

Runs on CPU tensors; no thread is left running.
"""
import threading
import time

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import concurrency as rconc
from repro.serving import (ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro.serving import router as rrouter
from repro_torch import convert
from repro_torch.analysis import schedules
from repro_torch.concurrency import guard_map
from repro_torch.distributed import retrieval as R
from repro_torch.serving import (ConversationalSearchEngine,
                                 ReplicatedSearchEngine, ServingConfig,
                                 SessionStore)
from repro_torch.serving.result_cache import ResultCache
from repro_torch.serving.scheduler import HedgedExecutor, MicroBatcher

K, H, NPROBE = 10, 16, 4
T = 4
CPU = "cpu"
WATCH = (MicroBatcher, SessionStore, ResultCache, HedgedExecutor,
         ReplicatedSearchEngine)


def _cfg(strategy="toploc+", **kw):
    return ServingConfig(backend="ivf", strategy=strategy, nprobe=NPROBE,
                         h=H, alpha=0.3, k=K, **kw)


@pytest.fixture(scope="module")
def tindex(ivf_index):
    return convert.ivf_index_from_numpy(*(np.asarray(f) for f in ivf_index),
                                        device=CPU)


def _router(tindex, *, replicas=2, strategy="toploc+", n_slots=8, **kw):
    cfg_kw = {k: kw.pop(k) for k in ("shards", "mesh", "segment_cap",
                                     "cache_threshold", "cache_depth")
              if k in kw}
    return ReplicatedSearchEngine(
        _cfg(strategy=strategy, **cfg_kw), replicas=replicas,
        ivf_index=tindex, n_slots=n_slots, max_batch=4, max_wait_s=1e-4,
        device=CPU, **kw)


def _mesh(shards, replicas=1):
    return R.retrieval_mesh(shards, replicas=replicas,
                            devices=[CPU] * (shards * replicas))


# ------------------------------------------------------------------ mesh

def test_retrieval_mesh_replicas_1_stays_1d():
    mesh = _mesh(1)
    assert mesh.devices.ndim == 1 and mesh.axis_names == ("model",)


def test_retrieval_mesh_2d_shape_and_axis_names():
    mesh = _mesh(2, replicas=2)
    assert mesh.devices.shape == (2, 2)
    assert mesh.axis_names == ("replica", "model")


def test_retrieval_mesh_too_few_devices_raises():
    with pytest.raises(ValueError, match="device"):
        R.retrieval_mesh(2, replicas=2, devices=[CPU] * 3)


def test_replica_submeshes_1d_passthrough():
    mesh = _mesh(1)
    assert R.replica_submeshes(mesh) == [mesh]


def test_replica_submeshes_split_is_disjoint_and_covering():
    """The grid's rows, in order: 4 slots of one repeated device."""
    mesh = _mesh(2, replicas=2)
    subs = R.replica_submeshes(mesh)
    assert len(subs) == 2
    slots = []
    for r, sm in enumerate(subs):
        assert sm.axis_names == ("model",) and sm.devices.shape == (2,)
        slots += [(r, s) for s in range(len(sm.devices))]
        assert tuple(sm.devices) == mesh.grid[r]
    assert slots == [(r, s) for r in range(2) for s in range(2)]


# -------------------------------------------------------------- routing

def test_session_affinity_sticky_across_turns(small_corpus, tindex):
    wl = small_corpus
    with _router(tindex) as eng:
        for t in range(T):
            eng.query("c0", wl.conversations[0, t])
        eng.drain()
        r = eng.replica_of("c0")
        assert r is not None
        assert [rec.conv_id for rec in eng.engines[r].records].count("c0") \
            == T
        assert all(rec.conv_id != "c0"
                   for rec in eng.engines[1 - r].records)


def test_affinity_survives_slab_eviction(small_corpus, tindex):
    """An LRU eviction inside a replica's slab does not unpin: the
    conversation rebuilds on the same replica."""
    wl = small_corpus
    with _router(tindex, n_slots=4) as eng:
        eng.query("a", wl.conversations[0, 0])
        r = eng.replica_of("a")
        with eng._route_lock:
            for j in range(4):
                eng._replica_of[f"f{j}"] = r
                eng._load[r] += 1
        for j in range(4):
            eng.query(f"f{j}", wl.conversations[1, 0])
        assert eng.engines[r].store.evictions >= 1
        assert eng.engines[r].store.lookup("a") is None
        assert eng.replica_of("a") == r
        eng.query("a", wl.conversations[0, 1])
        assert eng.replica_of("a") == r
        assert eng.engines[r].store.lookup("a") is not None


def test_least_loaded_pinning_spreads_sessions(small_corpus, tindex):
    wl = small_corpus
    with _router(tindex) as eng:
        for c in range(4):
            eng.query(f"c{c}", wl.conversations[c % 3, 0])
        ls = eng.load_stats()
        assert ls["per_replica_sessions"] == [2, 2]
        assert ls["per_replica_turns"] == [2, 2]
        assert ls["imbalance"] == 1.0
        eng.end_conversation("c0")
        assert eng.replica_of("c0") is None
        assert sum(eng.load_stats()["per_replica_sessions"]) == 3


def test_replicas_must_match_prebuilt_mesh(tindex):
    with pytest.raises(ValueError, match="replica"):
        _router(tindex, replicas=2, mesh=_mesh(1))


# ------------------------------------------------------------- identity

def _routed(eng, seq, wl, shards_note=""):
    futs = {}
    for t in range(T):
        for c in range(3):
            qv = wl.conversations[c, t]
            futs[(c, t)] = (seq.query(f"c{c}", qv), eng.submit(f"c{c}", qv))
        eng.drain()
    for (c, t), ((sv, si), fut) in futs.items():
        bv, bi = fut.result(timeout=30)
        np.testing.assert_array_equal(si, bi, err_msg=f"c{c} t{t}")
        np.testing.assert_array_equal(sv, bv, err_msg=f"c{c} t{t}")
    return futs


@pytest.mark.parametrize("cache", [False, True])
def test_routed_matches_sequential_per_session(small_corpus, tindex,
                                               ivf_index, cache):
    """R = 2 routed serving equals the sequential engine for every
    (conversation, turn), cache off and on; the sequential engine
    equals the reference's."""
    wl = small_corpus
    kw = dict(cache_threshold=0.95, cache_depth=8) if cache else {}
    seq = ConversationalSearchEngine(_cfg(**kw), ivf_index=tindex,
                                     device=CPU)
    rseq = RSeq(RConfig(backend="ivf", strategy="toploc+", nprobe=NPROBE,
                        h=H, alpha=0.3, k=K, **kw), ivf_index=ivf_index)
    with _router(tindex, **kw) as eng:
        futs = _routed(eng, seq, wl)
        assert seq.summary()["refresh_rate"] == \
            eng.summary()["refresh_rate"]
        if cache:
            assert eng.cache_stats()["hits"] >= 0
    for t in range(T):
        for c in range(3):
            rv, ri = rseq.query(f"c{c}", jnp.asarray(wl.conversations[c, t]))
            (sv, si), _ = futs[(c, t)]
            np.testing.assert_array_equal(si, np.asarray(ri))
            np.testing.assert_allclose(sv, np.asarray(rv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("how", ["shards", "mesh"])
def test_routed_sharded_2d_matches_sequential(small_corpus, tindex, how):
    """2 replicas x 2 corpus shards (from ``shards=2`` or a prebuilt 2-D
    mesh), bit-identical to the unsharded sequential engine."""
    wl = small_corpus
    seq = ConversationalSearchEngine(_cfg(), ivf_index=tindex, device=CPU)
    kw = dict(shards=2) if how == "shards" else dict(mesh=_mesh(2, 2))
    with _router(tindex, **kw) as eng:
        assert all(e.mesh is not None and len(e.mesh.shard_devices) == 2
                   for e in eng.engines)
        _routed(eng, seq, wl)


# -------------------------------------------------------------- hedging

def test_stateless_plain_traffic_is_hedged_and_identical(small_corpus,
                                                         tindex):
    wl = small_corpus
    seq = ConversationalSearchEngine(_cfg(strategy="plain"),
                                     ivf_index=tindex, device=CPU)
    with _router(tindex, strategy="plain", hedge_floor_s=0.0) as eng:
        assert not eng.stateful
        real_flush = eng.engines[0].flush

        def slow_flush():
            time.sleep(0.01)
            return real_flush()
        eng.engines[0].flush = slow_flush
        futs = [(seq.query(f"p{j}", wl.conversations[j % 3, 0]),
                 eng.submit(f"p{j}", wl.conversations[j % 3, 0]))
                for j in range(8)]
        for (sv, si), fut in futs:
            bv, bi = fut.result(timeout=30)
            np.testing.assert_array_equal(si, bi)
            np.testing.assert_array_equal(sv, bv)
        assert eng.hedge_stats()["calls"] == 8


def test_hedge_stats_exposed_only_for_stateless(tindex):
    with _router(tindex) as eng:
        assert eng.stateful and eng.hedge_stats() == {}
    with _router(tindex, strategy="plain") as eng2:
        assert not eng2.stateful and "calls" in eng2.hedge_stats()


# ------------------------------------------------------------ lifecycle

def test_router_close_is_idempotent_and_stops_pumps(small_corpus, tindex):
    wl = small_corpus
    eng = _router(tindex)
    eng.start()
    assert [t.is_alive() for t in eng._pumps] == [True, True]
    eng.submit("c0", wl.conversations[0, 0]).result(timeout=30)
    pumps = list(eng._pumps)
    eng.close()
    eng.close()
    assert not eng._pumps
    assert all(not t.is_alive() for t in pumps)
    assert threading.active_count() < 50


def test_router_use_after_close_raises(small_corpus, tindex):
    wl = small_corpus
    eng = ReplicatedSearchEngine(
        _cfg(segment_cap=8), replicas=2, ivf_index=tindex,
        doc_vecs=torch.from_numpy(wl.doc_vecs), n_slots=8, max_batch=4,
        max_wait_s=1e-4, device=CPU)
    q = wl.conversations[0, 0]
    eng.query("c0", q)
    eng.close()
    for call in (lambda: eng.submit("c0", q), lambda: eng.query("c0", q),
                 lambda: eng.add_documents(wl.doc_vecs[:2]),
                 lambda: eng.delete_documents([0]), eng.compact):
        with pytest.raises(RuntimeError, match="closed"):
            call()


def test_router_replicas_must_be_positive(tindex):
    with pytest.raises(ValueError, match="replicas"):
        ReplicatedSearchEngine(_cfg(), replicas=0, ivf_index=tindex,
                               device=CPU)


def test_query_survives_racing_end_conversation(small_corpus, tindex):
    wl = small_corpus
    with _router(tindex) as eng:
        eng.query("c0", wl.conversations[0, 0])
        assert eng.replica_of("c0") is not None
        orig_submit = eng.submit

        def racing_submit(conv_id, qvec):
            fut = orig_submit(conv_id, qvec)
            eng.end_conversation(conv_id)
            return fut

        eng.submit = racing_submit
        v, i = eng.query("c0", wl.conversations[0, 1])
        assert v.shape == (K,) and i.shape == (K,)
        assert eng.replica_of("c0") is None


def test_router_broadcast_mutations_keep_replicas_identical(small_corpus,
                                                            tindex):
    wl = small_corpus
    n0 = wl.doc_vecs.shape[0]
    with _router(tindex, segment_cap=8) as eng:
        ids = eng.add_documents(wl.doc_vecs[:3] * 0.5)
        assert ids.tolist() == [n0, n0 + 1, n0 + 2]
        assert eng.corpus_epoch == 1
        eng.delete_documents([int(ids[1])])
        assert eng.corpus_epoch == 2
        for c in ("a", "b", "c"):
            _, i = eng.query(c, wl.doc_vecs[ids[1] - n0] * 0.5)
            assert int(ids[1]) not in np.asarray(i)
        eng.compact()
        assert eng.corpus_epoch == 3
        for c in ("a", "b"):
            _, i = eng.query(c, wl.conversations[1, 1])
            assert i.shape == (K,)


def test_router_guards_match_the_reference():
    assert guard_map(ReplicatedSearchEngine) == \
        rconc.guard_map(rrouter.ReplicatedSearchEngine) != {}


# ---------------------------------------------------------------------------
# scenario C — router mutation (add / delete / compact) racing queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", schedules.SEEDS[:4])
def test_router_mutation_racing_queries_is_clean(seed, tindex,
                                                 small_corpus):
    doc_vecs = torch.from_numpy(small_corpus.doc_vecs)
    d = doc_vecs.shape[1]
    rng = np.random.default_rng(seed)
    new_rows = rng.standard_normal((3, d)).astype(np.float32)
    new_rows /= np.linalg.norm(new_rows, axis=1, keepdims=True)

    def scenario(rt):
        router = ReplicatedSearchEngine(
            _cfg(segment_cap=64), replicas=2, ivf_index=tindex,
            doc_vecs=doc_vecs, n_slots=8, max_batch=4, max_wait_s=1e-4,
            device=CPU)

        def client(b):
            for t in range(T):
                _, ids = router.query(f"c{b}",
                                      small_corpus.conversations[b, t])
                assert np.asarray(ids).shape == (K,)

        def mutator():
            ids = router.add_documents(new_rows)
            router.delete_documents([int(ids[0])])
            router.compact()

        schedules.run_threads(
            [lambda b=b: client(b) for b in range(3)] + [mutator],
            names=[f"client-{b}" for b in range(3)] + ["mutator"])
        epochs = [e.corpus_epoch for e in router.engines]
        router.close()
        return epochs

    epochs, _, rt = schedules.replay(seed, scenario, watch_classes=WATCH)
    assert not rt.reports
    assert len(set(epochs)) == 1 and epochs[0] == 3
