"""The batched engine and the result cache on the card.

This file imports no JAX, so its ``cuda_only`` tests run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_serving_cuda.py``;
the repository's conftest imports JAX).  On a synthetic corpus built by
the port on the card (20,000 docs, d = 64, IVF p = 256, PQ m = 16):

* the batched engine equals the sequential engine bit for bit — ids,
  scores, every ``TurnStats`` counter and ``cache_hit`` — for ivf and
  ivf_pq, toploc+ fused at f32, bf16 and int8, at ``max_batch`` 1, 2, 8
  and 32 (the ADC scan's two instances, stage 1 folded and merged: the
  kernel instances differ between B = 1 and B >= 2), and with the result
  cache on;
* the cache probe gives each row the same bits at B = 1 as at B = 2, 8
  and 32;
* a slot released from another thread while a wave is in flight, and
  ``end_conversation`` from another thread, leave the wave's results and
  the other sessions intact;
* zero-query pad rows at int8 make no NaN and touch only the trash slot.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import ivf, pq
from repro_torch.data import synthetic as SY
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig)
from repro_torch.serving import result_cache as RC

N_CONV, TURNS = 32, 3
FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
          "refreshed", "i0", "cache_hit")


@pytest.fixture(scope="module")
def served():
    """(indexes by backend, corpus, conversations) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=20_000, d=64, n_topics=64, n_conversations=N_CONV,
        turns_per_conversation=TURNS, seed=3))
    docs = torch.from_numpy(wl.doc_vecs).to(dev)
    index = ivf.build(docs, 256, iters=4, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pqi = pq.build_ivf_pq(index, docs, pq.train(docs, 16, iters=4,
                                                generator=gen), device=dev)
    return {"ivf": index, "ivf_pq": pqi}, docs, wl.conversations


def _cfg(backend, precision="f32", **kw):
    return ServingConfig(**{**dict(backend=backend, strategy="toploc+",
                                   fused=True, precision=precision,
                                   nprobe=16, h=128, k=10, rerank=64),
                            **kw})


def _key(recs):
    return sorted((r.conv_id, r.turn) + tuple(getattr(r, f) for f in FIELDS)
                  for r in recs)


def _serve_both(served, cfg, max_batch, convs=None, **kw):
    """The conversations round by round through both engines; asserts
    the batched results bit-identical to the sequential ones."""
    indexes, docs, served_convs = served
    convs = served_convs if convs is None else convs
    index = {f"{cfg.backend}_index": indexes[cfg.backend]}
    seq = ConversationalSearchEngine(cfg, **index, **kw)
    bat = BatchedConversationalSearchEngine(
        cfg, **index, n_slots=N_CONV, max_batch=max_batch, max_wait_s=0.0,
        **kw)
    for t in range(TURNS):
        futs = [bat.submit(f"c{c}", convs[c, t]) for c in range(N_CONV)]
        bat.drain()
        for c, fut in enumerate(futs):
            sv, si = seq.query(f"c{c}", convs[c, t])
            bv, bi = fut.result(timeout=60)
            assert np.array_equal(sv, bv) and np.array_equal(si, bi), (c, t)
    assert _key(bat.records) == _key(seq.records)
    return seq, bat


@pytest.mark.cuda_only
@pytest.mark.parametrize("max_batch", [1, 2, 8, 32])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_cuda_batched_engine_equals_sequential(served, backend, precision,
                                               max_batch):
    _, bat = _serve_both(served, _cfg(backend, precision), max_batch)
    assert max(bat.batcher.padded_sizes) == max_batch


@pytest.mark.cuda_only
@pytest.mark.parametrize("max_batch", [1, 8, 32])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_cuda_batched_cache_equals_sequential(served, backend, max_batch):
    """The result cache on (threshold 0.95, depth 64, the corpus as
    ``doc_vecs``), every other conversation repeating a turn (a sure
    hit; the others' turns drift too far to hit): the same answers,
    counters and hits."""
    _, docs, convs = served
    convs = convs.copy()
    convs[::2, 1] = convs[::2, 0]
    seq, bat = _serve_both(served, _cfg(backend, cache_threshold=0.95,
                                        cache_depth=64), max_batch,
                           convs=convs, doc_vecs=docs)
    assert seq.cache_stats() == bat.cache_stats()
    assert seq.cache_stats()["hits"] >= N_CONV // 2


@pytest.mark.cuda_only
@pytest.mark.parametrize("rows", [2, 8, 32])
def test_cuda_probe_bits_are_batch_size_stable(served, rows):
    """Cache entries probed at B = rows, and each row alone (B = 1): the
    same hit, scores and ids, bit for bit, with and without re-scoring."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(rows)
    d, depth = 768, 64
    qv = torch.randn((rows, d), generator=g, device=dev)
    q = qv + 0.5 * torch.randn((rows, d), generator=g, device=dev)
    entries = RC.CacheEntry(
        qv, torch.randint(-1, 10_000, (rows, depth), generator=g,
                          device=dev, dtype=torch.int32),
        torch.sort(torch.randn((rows, depth), generator=g, device=dev),
                   descending=True).values,
        torch.randn((rows, depth, d), generator=g, device=dev),
        torch.ones((rows,), dtype=torch.bool, device=dev))
    for rescore in (True, False):
        whole = RC.probe(entries, q, out_k=10, threshold=0.85,
                         rescore=rescore)
        for b in range(rows):
            alone = RC.probe(RC.CacheEntry(*(a[b:b + 1] for a in entries)),
                             q[b:b + 1], out_k=10, threshold=0.85,
                             rescore=rescore)
            for w, a in zip(whole, alone):
                assert torch.equal(w[b], a[0]), (b, rescore)


@pytest.mark.cuda_only
def test_cuda_release_from_another_thread_during_a_wave(served):
    """A wave of 8 conversations in flight (launched, not retired); from
    another thread, a slot outside the wave is released through the
    store and a conversation of the wave is ended.  The wave's answers
    equal the sequential engine's, the released slot reads zero, and the
    other sessions continue as the sequential engine's do."""
    indexes, _, convs = served
    cfg = _cfg("ivf")
    seq = ConversationalSearchEngine(cfg, ivf_index=indexes["ivf"])
    bat = BatchedConversationalSearchEngine(
        cfg, ivf_index=indexes["ivf"], n_slots=16, max_batch=8,
        max_wait_s=0.0, max_inflight=2)
    bat.query("other", convs[9, 0])
    want = [seq.query(f"c{c}", convs[c, 0]) for c in range(8)]
    futs = [bat.submit(f"c{c}", convs[c, 0]) for c in range(8)]
    assert bat.flush() == 8 and bat.batcher.inflight == 1
    slot = bat.store.lookup("other")
    worker = threading.Thread(target=lambda: (bat.store.release("other"),
                                              bat.end_conversation("c7")))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    for (sv, si), fut in zip(want, futs):
        bv, bi = fut.result(timeout=60)
        assert np.array_equal(sv, bv) and np.array_equal(si, bi)
    row = bat.store.gather([slot])
    assert all(not bool(f.any()) for f in row)
    assert bat.store.lookup("c7") is None
    for c in range(7):
        sv, si = seq.query(f"c{c}", convs[c, 1])
        bv, bi = bat.query(f"c{c}", convs[c, 1])
        assert np.array_equal(sv, bv) and np.array_equal(si, bi)


@pytest.mark.cuda_only
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_cuda_int8_zero_pad_rows(served, backend):
    """Waves of 3 padded to 4 with zero queries at int8 (every entry of
    a pad row ties; its scale comes from a zero row): the real rows
    equal the sequential engine's, the trash row holds no NaN, and no
    conversation maps to it."""
    indexes, _, convs = served
    cfg = _cfg(backend, "int8")
    index = {f"{backend}_index": indexes[backend]}
    seq = ConversationalSearchEngine(cfg, **index)
    bat = BatchedConversationalSearchEngine(cfg, **index, n_slots=8,
                                            max_batch=4, max_wait_s=0.0)
    for t in range(TURNS):
        futs = [bat.submit(f"c{c}", convs[c, t]) for c in range(3)]
        bat.drain()
        for c, fut in enumerate(futs):
            sv, si = seq.query(f"c{c}", convs[c, t])
            bv, bi = fut.result(timeout=60)
            assert np.array_equal(sv, bv) and np.array_equal(si, bi)
            assert np.isfinite(bv).all()
    assert bat.batcher.padded_sizes == [4] * TURNS
    trash = bat.store.gather([bat.store.trash_slot])
    assert not bool(torch.isnan(trash.cache_vecs).any())
    assert int(trash.turn[0]) == TURNS        # the pad row stepped
    assert bat.store.trash_slot not in [bat.store.lookup(f"c{c}")
                                        for c in range(3)]
