"""Retrieval-augmented answers, in repro and in repro_torch, on the CPU.

The loop of ``examples/rag_serving.py`` at its own sizes (5,000 docs of
d = 32, an IVF of p = 256 built by the reference, toploc+ with nprobe 8,
h 32, alpha 0.25, k 3; a 2-layer LM, ``MAX_LEN`` 96, ``GEN`` 8; 2
conversations x 4 turns): each turn retrieves with the conversation's
TopLoc session, builds the prompt from the retrieved docs' tokens and
the query's, prefills, then decodes greedily.  The reference's index and
LM parameters are converted for the port (``convert``), and both
packages run the loop on the same workload.

Retrieved ids and every ``TurnStats`` counter are equal.  Both decode
loops are fed the reference's greedy tokens; the port's own argmax must
pick the same token at every step, except where the reference's top two
logits lie within the logit tolerance (1e-4), where a summation order
may flip the pick: such near ties are counted, not asserted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as rivf
from repro.data import synthetic as RSY
from repro.models import transformer as RT
from repro.serving import engine as reng
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as teng

N_DOCS, D, MAX_LEN, GEN = 5000, 32, 96, 8
LOGIT_TOL = 1e-4
KNOBS = dict(backend="ivf", strategy="toploc+", nprobe=8, h=32, alpha=0.25,
             k=3)
STATS = ("centroid_dists", "list_dists", "graph_dists", "code_dists", "i0",
         "refreshed")


@pytest.fixture(scope="module")
def setup():
    wl = RSY.make_workload(RSY.WorkloadConfig(
        n_docs=N_DOCS, d=D, n_topics=32, n_conversations=2,
        turns_per_conversation=4, seed=17))
    docs_txt, conv_txt = RSY.make_text_corpus(wl, vocab=512, doc_len=24,
                                              query_len=8)
    index = rivf.build(jnp.asarray(wl.doc_vecs), p=256, iters=6,
                       key=jax.random.PRNGKey(0))
    rcfg = RT.LMConfig(name="rag-lm", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
                       remat=False, loss_chunk=8)
    params = RT.init_params(rcfg, jax.random.PRNGKey(1))
    tcfg = TT.LMConfig(name="rag-lm", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_head=16, d_ff=128, vocab=512)
    lm = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                      tcfg, device="cpu")
    tindex = convert.ivf_index_from_numpy(*(np.asarray(f) for f in index),
                                          device="cpu")
    return wl, docs_txt, conv_txt, (index, rcfg, params), (tindex, lm)


def _prompt(docs_txt, conv_txt, c, t, doc_ids):
    ctx = np.concatenate([docs_txt[d][:16] for d in doc_ids[:3]])
    return np.concatenate([ctx, conv_txt[c, t]])[: MAX_LEN - GEN]


def test_rag_loop_matches_reference(setup):
    wl, docs_txt, conv_txt, (index, rcfg, params), (tindex, lm) = setup
    r_eng = reng.ConversationalSearchEngine(reng.ServingConfig(**KNOBS),
                                            ivf_index=index)
    t_eng = teng.ConversationalSearchEngine(teng.ServingConfig(**KNOBS),
                                            ivf_index=tindex, device="cpu")
    prefill = jax.jit(lambda p, t: RT.prefill(p, rcfg, t, MAX_LEN))
    decode = jax.jit(lambda p, c, t, l: RT.decode_step(p, rcfg, c, t, l))
    near_ties = tokens = 0
    for c in range(conv_txt.shape[0]):
        for t in range(conv_txt.shape[1]):
            q = wl.conversations[c, t]
            _, r_ids = r_eng.query(f"conv{c}", jnp.asarray(q))
            _, t_ids = t_eng.query(f"conv{c}", q)
            np.testing.assert_array_equal(np.asarray(t_ids),
                                          np.asarray(r_ids))
            prompt = _prompt(docs_txt, conv_txt, c, t, np.asarray(r_ids))
            r_logits, r_cache, r_len = prefill(
                params, jnp.asarray(prompt[None].astype(np.int32)))
            t_logits, t_cache, t_len = lm.prefill(prompt[None], MAX_LEN)
            for step in range(GEN + 1):
                want = np.asarray(r_logits)[0]
                np.testing.assert_allclose(t_logits[0].numpy(), want,
                                           rtol=0, atol=LOGIT_TOL)
                top2 = np.sort(want)[-2:]
                tok = int(np.argmax(want))
                tokens += 1
                if int(t_logits[0].argmax()) != tok:
                    assert top2[1] - top2[0] < LOGIT_TOL, "token differs"
                    near_ties += 1
                if step == GEN:
                    break
                nxt = np.asarray([tok], np.int32)
                r_logits, r_cache = decode(params, r_cache, jnp.asarray(nxt),
                                           r_len)
                t_logits, t_cache = lm.decode_step(
                    t_cache, torch.from_numpy(nxt), t_len)
                r_len, t_len = r_len + 1, t_len + 1
    assert tokens == 8 * (GEN + 1)
    assert near_ties <= 2, near_ties
    assert [[getattr(r, f) for f in STATS] for r in t_eng.records] == \
        [[getattr(r, f) for f in STATS] for r in r_eng.records]
    assert t_eng.summary()["refresh_rate"] == r_eng.summary()["refresh_rate"]


def test_rag_prompt_shape_and_cache(setup):
    """A turn's prompt is 3 docs x 16 tokens + 8 query tokens; the cache
    holds MAX_LEN positions of which the prompt fills the first 56."""
    wl, docs_txt, conv_txt, _, (tindex, lm) = setup
    eng = teng.ConversationalSearchEngine(teng.ServingConfig(**KNOBS),
                                          ivf_index=tindex, device="cpu")
    _, ids = eng.query("c", wl.conversations[0, 0])
    prompt = _prompt(docs_txt, conv_txt, 0, 0, np.asarray(ids))
    assert prompt.shape == (56,)
    logits, cache, clen = lm.prefill(prompt[None], MAX_LEN)
    assert cache["k"].shape == (2, 1, 2, MAX_LEN, 16)
    assert int(clen[0]) == 56 and bool(torch.isfinite(logits).all())
    assert bool((cache["k"][:, :, :, 56:] == 0).all())
