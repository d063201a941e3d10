"""The port's concurrency sanitizer, and the batched engine under it.

Two layers under test, as in ``tests/test_concurrency.py``:

1. The sanitizer itself (``repro_torch.analysis.tsan`` + ``schedules``,
   the port's copies): a seeded data race / lockset break / lock-order
   inversion is detected, a clean program produces zero reports, and the
   same seed replays the same interleaving.
2. Scenario A: every seed of ``schedules.SEEDS`` replays B client
   threads driving the port's overlapped-wave batched engine (the result
   cache on) with per-session **bit-identity** to the port's sequential
   engine and **zero** concurrency violations.  The sequential oracle
   itself matches the reference's sequential engine (ids and hits
   exactly, scores within 1e-5).
3. Scenario B: every seed replays a ``delete_documents`` racing the
   in-flight waves of two clients (a mutable corpus, the cache on): no
   turn submitted after the delete returned serves the deleted doc,
   from the backend or from a stale cache entry, and the schedule
   exposes no violation.  Scenario C (a router mutation racing
   queries) is in ``tests/test_torch_router.py``.

Runs on CPU tensors; no thread is left running.
"""
import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import concurrency as rconc
from repro.serving import (ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro.serving import result_cache as rrc
from repro.serving import scheduler as rsched
from repro.serving import sessions as rsess
from repro_torch import convert
from repro_torch.analysis import schedules, tsan
from repro_torch.concurrency import guard_map, guarded_by
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig,
                                 SessionStore)
from repro_torch.serving.result_cache import ResultCache
from repro_torch.serving.scheduler import HedgedExecutor, MicroBatcher

K, H, NPROBE = 10, 16, 4
B, T = 4, 3                   # conversations x turns per scenario
THRESH = 0.7
CPU = "cpu"

#: serving-layer classes under guarded-field interception
WATCH = (MicroBatcher, SessionStore, ResultCache, HedgedExecutor)


def _kw():
    return dict(backend="ivf", strategy="toploc+", nprobe=NPROBE, h=H,
                alpha=0.3, k=K, cache_threshold=THRESH)


# ---------------------------------------------------------------------------
# the sanitizer itself
# ---------------------------------------------------------------------------


@guarded_by("_lock", "n")
class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump_unlocked(self):
        self.n += 1

    def bump_locked(self):
        with self._lock:
            self.n += 1


def test_tsan_detects_seeded_race_and_lockset_break():
    rt = tsan.Runtime(schedule=schedules.ScheduleExplorer(3))
    with tsan.instrument(rt):
        c = _Counter()
        with tsan.watch(rt, _Counter):
            schedules.run_threads([c.bump_unlocked, c.bump_unlocked])
    kinds = {r.kind for r in rt.reports}
    assert "race" in kinds and "lockset" in kinds, rt.reports


def test_tsan_clean_program_produces_no_reports():
    rt = tsan.Runtime(schedule=schedules.ScheduleExplorer(3))
    with tsan.instrument(rt):
        c = _Counter()
        with tsan.watch(rt, _Counter):
            schedules.run_threads([c.bump_locked, c.bump_locked])
    tsan.assert_clean(rt)
    with c._lock:
        assert c.n == 2


def test_tsan_reports_lock_order_inversion():
    class AB:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def ab(self):
            with self.a:
                with self.b:
                    pass

        def ba(self):
            with self.b:
                with self.a:
                    pass

    rt = tsan.Runtime()
    with tsan.instrument(rt):
        x = AB()
        x.ab()
        x.ba()
    assert any(r.kind == "lock-order" for r in rt.reports), rt.reports


def test_tsan_assert_clean_raises_listing_reports():
    rt = tsan.Runtime(schedule=schedules.ScheduleExplorer(0))
    with tsan.instrument(rt):
        c = _Counter()
        with tsan.watch(rt, _Counter):
            schedules.run_threads([c.bump_unlocked, c.bump_unlocked])
    with pytest.raises(AssertionError, match="concurrency violation"):
        tsan.assert_clean(rt)


def test_seed_matrix_has_at_least_20_distinct_schedules():
    assert len(set(schedules.SEEDS)) >= 20


def test_schedule_decision_is_pure_and_seed_sensitive():
    e1 = schedules.ScheduleExplorer(7)
    e2 = schedules.ScheduleExplorer(7)
    e3 = schedules.ScheduleExplorer(8)
    probes = [("client-0", n, "lock-acquire") for n in range(64)]
    d1 = [e1.decision(*p) for p in probes]
    assert d1 == [e2.decision(*p) for p in probes]
    assert d1 != [e3.decision(*p) for p in probes]


def test_schedule_replay_same_seed_same_interleaving():
    def scen(rt):
        c = _Counter()
        schedules.run_threads([c.bump_locked] * 3,
                              names=["t-0", "t-1", "t-2"])
        with c._lock:
            return c.n

    r1, e1, _ = schedules.replay(7, scen, watch_classes=[_Counter])
    r2, e2, _ = schedules.replay(7, scen, watch_classes=[_Counter])
    named1 = {k: v for k, v in e1.traces.items() if k.startswith("t-")}
    named2 = {k: v for k, v in e2.traces.items() if k.startswith("t-")}
    assert r1 == r2 == 3
    # same seed -> bit-identical per-thread decision traces
    assert named1 == named2 and len(named1) == 3
    # a different seed steers a different interleaving
    _, e3, _ = schedules.replay(8, scen, watch_classes=[_Counter])
    named3 = {k: v for k, v in e3.traces.items() if k.startswith("t-")}
    assert named1 != named3


@pytest.mark.parametrize("cls,ref", [
    (SessionStore, rsess.SessionStore), (ResultCache, rrc.ResultCache),
    (MicroBatcher, rsched.MicroBatcher),
    (HedgedExecutor, rsched.HedgedExecutor)])
def test_guard_maps_match_the_reference(cls, ref):
    """The port's serving classes declare the reference's guards."""
    assert guard_map(cls) == rconc.guard_map(ref) != {}


# ---------------------------------------------------------------------------
# scenario A — overlapped-wave engine vs sequential oracle, all seeds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tindex(ivf_index):
    return convert.ivf_index_from_numpy(*(np.asarray(f) for f in ivf_index),
                                        device=CPU)


@pytest.fixture(scope="module")
def convs(small_corpus):
    c = small_corpus.conversations[:B, :T]
    # every cosine between two turns of a conversation lies 1e-5 or
    # more from the threshold, so both packages decide the same hits
    unit = c / np.linalg.norm(c, axis=-1, keepdims=True)
    cos = np.einsum("btd,bsd->bts", unit, unit)[
        :, *np.tril_indices(T, -1)]
    assert np.abs(cos - THRESH).min() >= 1e-5
    return c


@pytest.fixture(scope="module")
def oracle(tindex, convs):
    """Per-conversation (scores, ids, hit) rows from the port's
    sequential engine."""
    eng = ConversationalSearchEngine(ServingConfig(**_kw()),
                                     ivf_index=tindex, device=CPU)
    out = {}
    for b in range(B):
        rows = []
        for t in range(T):
            v, i = eng.query(f"c{b}", convs[b, t])
            rows.append((v, i, eng.records[-1].cache_hit))
        out[f"c{b}"] = rows
    return out


def test_oracle_matches_the_reference(ivf_index, convs, oracle):
    ref = RSeq(RConfig(**_kw()), ivf_index=ivf_index)
    hits = 0
    for b in range(B):
        for t in range(T):
            rv, ri = ref.query(f"c{b}", jnp.asarray(convs[b, t]))
            v, i, hit = oracle[f"c{b}"][t]
            np.testing.assert_array_equal(i, np.asarray(ri))
            np.testing.assert_allclose(v, np.asarray(rv), atol=1e-5, rtol=0)
            assert hit == ref.records[-1].cache_hit
            hits += hit
    assert hits > 0                       # the scenario exercises hits


@pytest.mark.parametrize("seed", schedules.SEEDS)
def test_batched_engine_bit_identical_under_every_schedule(
        seed, tindex, convs, oracle):
    """B client threads drive B conversations through the overlapped
    continuous-batching engine under one seeded schedule; every turn is
    bit-identical to the sequential oracle and the schedule exposes no
    data race / lockset break / lock-order inversion."""

    def scenario(rt):
        eng = BatchedConversationalSearchEngine(
            ServingConfig(**_kw()), ivf_index=tindex, n_slots=8,
            max_batch=B, max_wait_s=1e-4, device=CPU)
        results = {f"c{b}": [] for b in range(B)}

        def client(b):
            cid = f"c{b}"
            for t in range(T):
                results[cid].append(eng.query(cid, convs[b, t]))

        schedules.run_threads(
            [lambda b=b: client(b) for b in range(B)],
            names=[f"client-{b}" for b in range(B)])
        eng.close()
        return results

    results, _, rt = schedules.replay(seed, scenario, watch_classes=WATCH)
    assert not rt.reports
    for cid, want in oracle.items():
        got = results[cid]
        assert len(got) == len(want)
        for t, ((wv, wi, _), (gv, gi)) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(wi, gi, err_msg=f"{cid} turn {t}")
            np.testing.assert_array_equal(wv, gv, err_msg=f"{cid} turn {t}")


# ---------------------------------------------------------------------------
# scenario B — delete racing an in-flight wave, all seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", schedules.SEEDS)
def test_delete_never_serves_tombstone_under_any_schedule(
        seed, tindex, small_corpus):
    """A ``delete_documents`` racing in-flight waves never serves the
    tombstoned doc afterwards, from the backend or from a stale
    result-cache entry.  Turns whose submit started after the delete
    returned assert the doc is gone; earlier turns may still see it
    (they raced the delete)."""
    doc_vecs = torch.from_numpy(small_corpus.doc_vecs)

    def scenario(rt):
        eng = BatchedConversationalSearchEngine(
            ServingConfig(**_kw(), segment_cap=64), ivf_index=tindex,
            doc_vecs=doc_vecs, n_slots=8, max_batch=4, max_wait_s=1e-4,
            device=CPU)
        # aim every query at one known-retrievable doc
        _, i = eng.query("probe", small_corpus.conversations[0, 0])
        target = int(i[0])
        q = small_corpus.doc_vecs[target]
        deleted = threading.Event()

        def client(name):
            for _ in range(4):
                pre = deleted.is_set()
                _, ids = eng.query(name, q)
                if pre:
                    assert target not in ids.tolist(), \
                        f"{name} served tombstoned doc {target}"

        def mutator():
            eng.delete_documents([target])
            deleted.set()

        schedules.run_threads(
            [lambda: client("cA"), lambda: client("cB"), mutator],
            names=["client-A", "client-B", "mutator"])
        eng.close()
        assert eng.corpus_epoch == 1
        return target

    _, _, rt = schedules.replay(seed, scenario, watch_classes=WATCH)
    assert not rt.reports
