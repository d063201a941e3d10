"""The slice whole: encode → index → serve, in repro_torch and in repro.

The paper's pipeline (``examples/train_encoder.py``) on the CPU: the tiny
bi-encoder, initialised by ``repro`` and converted, encodes a small text
corpus from ``make_text_corpus``; ``repro`` builds the IVF index from
its own doc embeddings, converted for the port as the other parity
tests do; each package encodes the conversations' queries (8 tokens
padded to ``max_len``) with its query tower and drives them through
``toploc.conversation``, toploc+ and plain.

* Own embeddings: the two packages' query embeddings differ by up to
  1e-5, so ids may differ only at a near tie: every id the port returns
  must score, against the port's query, within 1e-5 of the reference's
  score at that slot (``chip_smoke.py``'s ``compare`` rule).  Scores
  agree within 1e-5; ``TurnStats`` counters and the final session
  (``anchor_sel`` and the cached centroids) are equal.
* The reference's query embeddings, converted: ids, ``TurnStats`` and
  sessions exactly equal; scores within 1e-5 (XLA and PyTorch sum the
  dot products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import encoders as RC
from repro.core import ivf as rivf
from repro.core import toploc as rtl
from repro.core.backend import IVFBackend as RBackend
from repro.models import encoder as RE
from repro_torch import convert
from repro_torch.configs import encoders as TC
from repro_torch.core import toploc as ttl
from repro_torch.core.backend import IVFBackend as TBackend
from repro_torch.data import synthetic as TSY

TOL = 1e-5
H, NPROBE, K = 8, 4, 10
CPU = "cpu"


@pytest.fixture(scope="module")
def pipeline():
    rc, tc = RC.tiny_encoder_config(), TC.tiny_encoder_config()
    wl = TSY.make_workload(TSY.WorkloadConfig(
        n_docs=600, d=16, n_topics=8, n_conversations=3,
        turns_per_conversation=6, shift_prob=0.2, seed=11))
    docs, queries = TSY.make_text_corpus(wl, vocab=tc.vocab,
                                         doc_len=tc.max_len, query_len=8)
    params = RE.init_params(rc, jax.random.PRNGKey(2))
    port = convert.encoder_params_from_numpy(
        jax.tree.map(np.asarray, params), tc, device=CPU)
    doc_embs = np.asarray(RE.encode_docs(params, rc, docs, docs > 0))
    np.testing.assert_allclose(port.encode_docs(docs, docs > 0).numpy(),
                               doc_embs, rtol=0, atol=TOL)
    fidx = rivf.build(jnp.asarray(doc_embs), p=16, iters=5,
                      key=jax.random.PRNGKey(1))
    tidx = convert.ivf_index_from_numpy(*(np.asarray(f) for f in fidx),
                                        device=CPU)
    q = np.pad(queries, ((0, 0), (0, 0), (0, tc.max_len - 8)))
    r_q = [np.asarray(RE.encode_queries(params, rc, c, c > 0)) for c in q]
    t_q = [port.encode_queries(c, c > 0) for c in q]
    return wl, doc_embs, fidx, tidx, r_q, t_q


def _backends(alpha):
    return (RBackend(h=H, nprobe=NPROBE, alpha=alpha),
            TBackend(h=H, nprobe=NPROBE, alpha=alpha))


def _session(backend, index, qs, start, step, wrap):
    _, _, sess, _ = start(backend, index, wrap(qs[0]))
    for q in qs[1:]:
        _, _, sess, _ = step(backend, index, sess, wrap(q))
    return sess


def _check_ids(rv, ri, ti, t_q, doc_embs):
    """The near-tie rule: each id the port returns scores, against the
    port's own query, within TOL of the reference's score there."""
    ti = ti.numpy()
    true = np.einsum("tkd,td->tk", doc_embs[ti].astype(np.float64),
                     t_q.numpy().astype(np.float64))
    assert np.abs(true - np.asarray(rv)).max() <= TOL
    for row in ti:
        assert len(set(row.tolist())) == len(row)
    return int((np.asarray(ri) != ti).sum())


@pytest.mark.parametrize("own_queries", [True, False])
@pytest.mark.parametrize("mode,alpha", [("toploc", 0.1), ("plain", -1.0)])
def test_encoded_conversations_match_reference(pipeline, own_queries, mode,
                                               alpha):
    wl, doc_embs, fidx, tidx, r_q, t_q = pipeline
    rb, tb = _backends(alpha)
    swaps = 0
    for c, (rq, tq) in enumerate(zip(r_q, t_q)):
        if not own_queries:
            tq = torch.from_numpy(rq.copy())
        rv, ri, rst = rtl.conversation(rb, fidx, jnp.asarray(rq), k=K,
                                       mode=mode)
        tv, ti, tst = ttl.conversation(tb, tidx, tq, k=K, mode=mode,
                                       device=CPU)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=0,
                                   atol=TOL)
        if own_queries:
            swaps += _check_ids(rv, ri, ti, tq, doc_embs)
        else:
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        for f in rst._fields:
            np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                          np.asarray(getattr(rst, f)),
                                          err_msg=f)
        if mode == "plain":
            continue
        rs = _session(rb, fidx, rq,
                      lambda b, i, q: rtl.start(b, i, q, k=K),
                      lambda b, i, s, q: rtl.step(b, i, s, q, k=K),
                      jnp.asarray)
        ts = _session(tb, tidx, tq,
                      lambda b, i, q: ttl.start(b, i, q, k=K, device=CPU),
                      lambda b, i, s, q: ttl.step(b, i, s, q, k=K,
                                                  device=CPU),
                      lambda q: q)
        for f in rs._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(rs, f)),
                                          err_msg=f"session {f}")
    assert swaps <= 2


def test_topic_precision_is_computed_as_the_reference_pipeline_does(
        pipeline):
    """topic-precision@1 (``examples/train_encoder.py:112-117``): the
    share of turns whose top doc is of the turn's topic; reported, not
    gated.  Both packages' runs give the same number."""
    wl, _, fidx, tidx, r_q, t_q = pipeline
    rb, tb = _backends(0.1)
    hits = []
    for run in ("ref", "port"):
        n = 0
        for c in range(len(r_q)):
            if run == "ref":
                _, ids, _ = rtl.conversation(rb, fidx, jnp.asarray(r_q[c]),
                                             k=K)
            else:
                _, ids, _ = ttl.conversation(tb, tidx, t_q[c], k=K,
                                             device=CPU)
            top = np.asarray(ids)[:, 0]
            n += int((wl.doc_topic[top] == wl.conv_topics[c]).sum())
        hits.append(n)
    assert hits[0] == hits[1]
    assert 0 <= hits[0] <= wl.conv_topics.size
