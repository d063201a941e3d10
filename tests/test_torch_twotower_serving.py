"""The slice whole: two-tower retrieval served with TopLoc, in repro_torch
and in repro.

``examples/recsys_retrieval.py`` at the smoke configuration, on the CPU:
``repro`` initialises the two-tower model (converted for the port), its
item tower encodes every item into the retrieval corpus, and ``repro``
clusters the corpus into an IVF index (converted as the other parity
tests do).  User sessions follow the example: each request rolls the
user's history by one and replaces one item; the user tower turns
(user id, history) into the query of a TopLoc turn at k = 100, one
session per user.

* The reference's user vectors, converted: the port's ``toploc.start /
  step`` (unfused and through ``FusedTurn``, the fused ops' plain
  versions on CPU) and its ``ConversationalSearchEngine`` return the
  reference's ids, ``sel`` (the session's ``anchor_sel``) and every
  ``TurnStats`` counter exactly; scores within 1e-5.
* The port's own user vectors (within 1e-5 of the reference's): ids may
  differ only at a near tie, the rule of ``test_torch_pipeline.py``;
  counters and sessions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as RC
from repro.core import ivf as rivf
from repro.core import toploc as rtl
from repro.core.backend import IVFBackend as RBackend
from repro.models import recsys as RR
from repro.serving import engine as reng
from repro_torch import convert
from repro_torch.configs import two_tower_retrieval as TC
from repro_torch.core import toploc as ttl
from repro_torch.core.backend import IVFBackend as TBackend
from repro_torch.models import recsys as TR
from repro_torch.serving import engine as teng

TOL = 1e-5
K, H, NPROBE, P = 100, 8, 6, 16
USERS, REQS = 3, 5
CPU = "cpu"


@pytest.fixture(scope="module")
def served():
    rcfg, tcfg = RC.smoke_config(), TC.smoke_config()
    params = RR.two_tower_init(rcfg, jax.random.PRNGKey(0))
    port = convert.two_tower_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device=CPU)
    corpus = np.array(RR.item_tower(params, rcfg,
                                    jnp.arange(rcfg.item_vocab)))
    fidx = rivf.build(jnp.asarray(corpus), p=P, iters=5,
                      key=jax.random.PRNGKey(1))
    tidx = convert.ivf_index_from_numpy(*(np.asarray(f) for f in fidx),
                                        device=CPU)
    # sessions after examples/recsys_retrieval.py
    rng = np.random.default_rng(0)
    r_q, t_q = [], []
    for _ in range(USERS):
        uid = np.asarray([rng.integers(rcfg.user_vocab)], np.int32)
        base = rng.integers(0, rcfg.item_vocab, rcfg.history_len)
        hists = []
        for r in range(REQS):
            hist = np.roll(base, r)
            hist[0] = rng.integers(0, rcfg.item_vocab)
            hists.append(hist.astype(np.int32))
        hists = np.stack(hists)
        uids = np.repeat(uid, REQS)
        r_q.append(np.asarray(RR.user_tower(params, rcfg, jnp.asarray(uids),
                                            jnp.asarray(hists))))
        t_q.append(port.user_tower(uids, hists))
    return corpus, fidx, tidx, r_q, t_q


def _backends(alpha, fused):
    return (RBackend(h=H, nprobe=NPROBE, alpha=alpha,
                     fused=rtl.FusedTurn() if fused else None),
            TBackend(h=H, nprobe=NPROBE, alpha=alpha,
                     fused=ttl.FusedTurn() if fused else None))


def _same_fields(ref, port, what):
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what}.{f}")


def _near_tie_swaps(rv, ri, ti, tq, corpus):
    """Each id the port returns scores, against the port's own user
    vector, within TOL of the reference's score at that slot."""
    ti = ti.numpy()
    true = np.einsum("kd,d->k", corpus[ti].astype(np.float64),
                     tq.numpy().astype(np.float64))
    assert np.abs(true - np.asarray(rv)).max() <= TOL
    assert len(set(ti.tolist())) == len(ti)
    return int((np.asarray(ri) != ti).sum())


def test_user_vectors_match_reference(served):
    *_, r_q, t_q = served
    for rq, tq in zip(r_q, t_q):
        np.testing.assert_allclose(tq.numpy(), rq, rtol=0, atol=TOL)


def test_enough_candidates_for_k(served):
    _, _, tidx, *_ = served
    assert int(tidx.list_sizes.sort().values[:NPROBE].sum()) >= K


@pytest.mark.parametrize("own_vectors", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("alpha", [-1.0, 0.1])
def test_user_sessions_match_reference(served, alpha, fused, own_vectors):
    corpus, fidx, tidx, r_q, t_q = served
    rb, tb = _backends(alpha, fused)
    swaps = 0
    for rq, tq in zip(r_q, t_q):
        if not own_vectors:
            tq = torch.from_numpy(rq.copy())
        rv, ri, rs, rst = rtl.start(rb, fidx, jnp.asarray(rq[0]), k=K)
        tv, ti, ts, tst = ttl.start(tb, tidx, tq[0], k=K, device=CPU)
        for r in range(REQS):
            if r:
                rv, ri, rs, rst = rtl.step(rb, fidx, rs, jnp.asarray(rq[r]),
                                           k=K)
                tv, ti, ts, tst = ttl.step(tb, tidx, ts, tq[r], k=K,
                                           device=CPU)
            np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=0,
                                       atol=TOL)
            if own_vectors:
                swaps += _near_tie_swaps(rv, ri, ti, tq[r], corpus)
            else:
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
            _same_fields(rst, tst, f"request {r} stats")
            _same_fields(rs, ts, f"request {r} session")
    assert swaps <= 2


@pytest.mark.parametrize("strategy", ["toploc", "toploc+", "plain"])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_serves_user_sessions_as_the_reference_engine(
        served, strategy, fused):
    """One conversation per user, requests interleaved across users."""
    _, fidx, tidx, r_q, _ = served
    kw = dict(backend="ivf", strategy=strategy, k=K, nprobe=NPROBE, h=H,
              alpha=0.1, fused=fused)
    ref = reng.ConversationalSearchEngine(reng.ServingConfig(**kw),
                                          ivf_index=fidx)
    port = teng.ConversationalSearchEngine(teng.ServingConfig(**kw),
                                           ivf_index=tidx, device=CPU)
    for r in range(REQS):
        for u in range(USERS):
            rv, ri = ref.query(f"u{u}", jnp.asarray(r_q[u][r]))
            tv, ti = port.query(f"u{u}", r_q[u][r].copy())
            np.testing.assert_array_equal(ti, ri)
            np.testing.assert_allclose(tv, rv, rtol=0, atol=TOL)
    fields = ("conv_id", "turn", "centroid_dists", "list_dists",
              "graph_dists", "refreshed", "i0", "code_dists", "cache_hit")
    for r, p in zip(ref.records, port.records, strict=True):
        assert [getattr(r, f) for f in fields] == \
            [getattr(p, f) for f in fields]
    if strategy != "plain":
        for u in range(USERS):
            _same_fields(ref.sessions[f"u{u}"], port.sessions[f"u{u}"],
                         f"user {u} session")


def test_brute_force_step_is_the_recall_reference(served):
    """What the smoke measures recall against: the port's brute-force
    ``retrieval_topk`` over the corpus gives the reference's top-k for
    the same user vectors."""
    corpus, _, _, r_q, _ = served
    for rq in r_q:
        tv, ti = TR.retrieval_topk(torch.from_numpy(rq.copy()),
                                   torch.from_numpy(corpus), K)
        rv, ri = RR.retrieval_topk(jnp.asarray(rq), jnp.asarray(corpus), K)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=0,
                                   atol=TOL)
