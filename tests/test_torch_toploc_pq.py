"""The slice whole: TopLoc_IVFPQ in repro_torch == the reference.

On the golden-setup workload (``tests/test_golden_cost.py``'s fixture:
1,500 docs, d=32, p=32, m=8, an 8-turn conversation with topic shifts),
with the IVF-PQ index built by ``repro`` and converted:

* ``toploc.conversation`` through ``IVFPQBackend`` — static cache and
  Eq. 1 refresh, unfused (ADC scan + exact re-rank) and through
  ``FusedTurn("f32")`` (the fused ops' plain versions on CPU), sessioned
  and plain — gives the reference's ids, every ``TurnStats`` field and
  the final session, scores within 1e-5;
* sequential and batched drivers (mixed ``is_first``) are bit-identical
  inside the port, fused and unfused;
* ``ConversationalSearchEngine(backend="ivf_pq")`` records the reference
  engine's counters and returns its ids.

Compared with live ``repro`` output, never with the pinned goldens.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ivf as rivf
from repro.core import pq as rpq
from repro.core import toploc as rtl
from repro.core.backend import IVFPQBackend as RBackend
from repro.serving import engine as reng
from repro_torch import convert
from repro_torch.core import toploc as ttl
from repro_torch.core.backend import IVFPQBackend as TBackend
from repro_torch.serving import engine as teng

H, NPROBE, K, RERANK = 16, 4, 10, 32
TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def golden():
    from repro.data import synthetic as SY
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=1500, d=32, n_topics=12, n_conversations=2,
        turns_per_conversation=8, query_drift=0.15, walk_step=0.05,
        shift_prob=0.15, seed=7))
    docs = jnp.asarray(wl.doc_vecs)
    fidx = rivf.build(docs, p=32, iters=5, key=jax.random.PRNGKey(0))
    pqi = rpq.build_ivf_pq(fidx, docs, m=8, iters=6,
                           key=jax.random.PRNGKey(0))
    tidx = convert.ivf_pq_index_from_numpy(*(np.asarray(f) for f in pqi),
                                           device=CPU)
    return wl.conversations, pqi, tidx


def _backends(alpha, fused):
    rb = RBackend(h=H, nprobe=NPROBE, alpha=alpha, rerank=RERANK,
                  fused=rtl.FusedTurn() if fused else None)
    tb = TBackend(h=H, nprobe=NPROBE, alpha=alpha, rerank=RERANK,
                  fused=ttl.FusedTurn() if fused else None)
    return rb, tb


def _same(ref, port, what):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy(),
                                  err_msg=what)


def _same_fields(ref, port, what):
    for f in ref._fields:
        _same(getattr(ref, f), getattr(port, f), f"{what}.{f}")


@pytest.mark.parametrize("alpha", [-1.0, 0.5])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["toploc", "plain"])
def test_conversation_matches_reference(golden, alpha, fused, mode):
    convs, pqi, tidx = golden
    rb, tb = _backends(alpha, fused)
    for conv in convs:
        rv, ri, rst = rtl.conversation(rb, pqi, jnp.asarray(conv), k=K,
                                       mode=mode)
        tv, ti, tst = ttl.conversation(tb, tidx, torch.from_numpy(conv),
                                       k=K, mode=mode, device=CPU)
        np.testing.assert_allclose(np.asarray(rv), tv.numpy(), rtol=0,
                                   atol=TOL)
        _same(ri, ti, "ids")
        _same_fields(rst, tst, "stats")
        assert int(tst.code_dists.min()) > 0 and \
            int(tst.list_dists.max()) <= RERANK
        if mode == "plain":
            continue
        _, _, rs, _ = rtl.start(rb, pqi, jnp.asarray(conv[0]), k=K)
        _, _, ts, _ = ttl.start(tb, tidx, torch.from_numpy(conv[0]), k=K,
                                device=CPU)
        for q in conv[1:]:
            _, _, rs, _ = rtl.step(rb, pqi, rs, jnp.asarray(q), k=K)
            _, _, ts, _ = ttl.step(tb, tidx, ts, torch.from_numpy(q), k=K,
                                   device=CPU)
        _same_fields(rs, ts, "session")


# rows restart their conversation (is_first) at these steps
RESTARTS = [(0,), (0, 3), (0, 5, 6)]


@pytest.mark.parametrize("alpha", [-1.0, 0.5])
@pytest.mark.parametrize("fused", [False, True])
def test_sequential_equals_batched(golden, alpha, fused):
    convs, _, tidx = golden
    _, tb = _backends(alpha, fused)
    steps = convs.shape[1]
    b = len(RESTARTS)

    def query(row, t):
        start = max(s for s in RESTARTS[row] if s <= t)
        return torch.from_numpy(convs[row % 2, t - start])

    seq = []
    for row in range(b):
        out, sess = [], None
        for t in range(steps):
            if t in RESTARTS[row]:
                v, i, sess, st = ttl.start(tb, tidx, query(row, t), k=K,
                                           device=CPU)
            else:
                v, i, sess, st = ttl.step(tb, tidx, sess, query(row, t),
                                          k=K, device=CPU)
            out.append((v, i, st))
        seq.append((out, sess))

    q0 = torch.stack([query(r, 0) for r in range(b)])
    v, i, sess, st = ttl.start_batch(tb, tidx, q0, k=K, device=CPU)
    for t in range(steps):
        if t > 0:
            q = torch.stack([query(r, t) for r in range(b)])
            first = torch.tensor([t in RESTARTS[r] for r in range(b)])
            v, i, sess, st = ttl.step_batch(tb, tidx, sess, q, k=K,
                                            is_first=first, device=CPU)
        for row in range(b):
            sv, si, sst = seq[row][0][t]
            assert torch.equal(v[row], sv) and torch.equal(i[row], si)
            for f in ttl.TurnStats._fields:
                assert torch.equal(getattr(st, f)[row], getattr(sst, f)), f
    for row in range(b):
        for f in ttl.IVFSession._fields:
            assert torch.equal(getattr(sess, f)[row],
                               getattr(seq[row][1], f)), f


@pytest.mark.parametrize("strategy", ["toploc", "toploc+", "plain"])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_matches_reference_engine(golden, strategy, fused):
    convs, pqi, tidx = golden
    kw = dict(backend="ivf_pq", strategy=strategy, k=K, nprobe=NPROBE, h=H,
              alpha=0.3, rerank=RERANK, fused=fused)
    ref = reng.ConversationalSearchEngine(reng.ServingConfig(**kw),
                                          ivf_pq_index=pqi)
    port = teng.ConversationalSearchEngine(teng.ServingConfig(**kw),
                                           ivf_pq_index=tidx, device=CPU)
    assert port.backend.rerank == RERANK
    for t in range(convs.shape[1]):
        for c in range(convs.shape[0]):
            rv, ri = ref.query(f"c{c}", jnp.asarray(convs[c, t]))
            tv, ti = port.query(f"c{c}", convs[c, t])
            np.testing.assert_array_equal(ri, ti)
            np.testing.assert_allclose(rv, tv, rtol=0, atol=TOL)
    fields = ("conv_id", "turn", "centroid_dists", "list_dists",
              "graph_dists", "refreshed", "i0", "code_dists", "cache_hit")
    for r, p in zip(ref.records, port.records, strict=True):
        assert [getattr(r, f) for f in fields] == \
            [getattr(p, f) for f in fields]
    rs, ps = ref.summary(), port.summary()
    for key in ("turns", "mean_centroid_dists", "mean_list_dists",
                "mean_code_dists", "refresh_rate"):
        assert rs[key] == ps[key], key


def test_engine_needs_the_pq_index(golden):
    _, _, tidx = golden
    with pytest.raises(ValueError, match="ivf_pq_index"):
        teng.ConversationalSearchEngine(teng.ServingConfig(backend="ivf_pq"),
                                        device=CPU)
