"""repro_torch's copy of the synthetic workload == the reference's.

``make_workload`` is a numpy copy (same recipe, same random stream), so
every array and every qrel must be equal, and the IR metrics must give
the same numbers.  ``make_device_corpus`` follows the recipe with a
``torch.Generator`` on the device and is held to its properties.  The
token view (``topic_text`` / ``make_text_corpus``) and the hash
tokenizer are copies too, so their arrays must be equal.
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as RSY
from repro.data import tokenizer as RTK
from repro_torch.data import synthetic as TSY
from repro_torch.data import tokenizer as TTK

CFG = dict(n_docs=700, d=24, n_topics=9, n_conversations=3,
           turns_per_conversation=4, shift_prob=0.3, seed=5)


@pytest.fixture(scope="module")
def both():
    return (RSY.make_workload(RSY.WorkloadConfig(**CFG)),
            TSY.make_workload(TSY.WorkloadConfig(**CFG)))


def test_make_workload_matches_reference(both):
    ref, port = both
    for f in ("doc_vecs", "doc_topic", "topic_centers", "conversations",
              "conv_topics"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))
    assert ref.qrels == port.qrels


def test_ir_metrics_match_reference(both):
    ref, _ = both
    rng = np.random.default_rng(1)
    run = np.stack([[rng.permutation(CFG["n_docs"])[:10]
                     for _ in range(CFG["turns_per_conversation"])]
                    for _ in range(CFG["n_conversations"])])
    # the first turn of each conversation hits its qrels in part
    run[:, 0, :5] = [list(ref.qrels[(c, 0)])[:5]
                     for c in range(CFG["n_conversations"])]
    assert RSY.evaluate_run(run, ref) == TSY.evaluate_run(run, ref)
    g = ref.qrels[(0, 0)]
    assert RSY.mrr_at_k(run[0, 0], g) == TSY.mrr_at_k(run[0, 0], g)
    assert RSY.ndcg_at_k(run[0, 0], g, 3) == TSY.ndcg_at_k(run[0, 0], g, 3)


def test_device_corpus_follows_the_recipe():
    cfg = TSY.WorkloadConfig(**CFG)
    a = TSY.make_device_corpus(cfg, "cpu", chunk=256)
    b = TSY.make_device_corpus(cfg, "cpu", chunk=256)
    assert a.doc_vecs.shape == (CFG["n_docs"], CFG["d"])
    assert a.doc_vecs.device.type == "cpu"
    torch.testing.assert_close(a.doc_vecs.norm(dim=-1),
                               torch.ones(CFG["n_docs"]))
    assert int(a.doc_topic.min()) >= 0
    assert int(a.doc_topic.max()) < CFG["n_topics"]
    # seeded: the same config gives the same corpus
    assert torch.equal(a.doc_vecs, b.doc_vecs)
    np.testing.assert_array_equal(a.conversations, b.conversations)
    assert a.conversations.shape == (CFG["n_conversations"],
                                     CFG["turns_per_conversation"],
                                     CFG["d"])
    np.testing.assert_allclose(np.linalg.norm(a.conversations, axis=-1), 1,
                               rtol=1e-5)
    # docs sit nearer their own topic centre than the mean of the others
    c = torch.from_numpy(a.topic_centers)
    sims = a.doc_vecs @ c.T
    own = sims.gather(1, a.doc_topic[:, None])[:, 0]
    assert float(own.mean()) > float(sims.mean())


# ---------------------------------------------------------------------------
# the token view and the tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,doc_len,query_len", [(1024, 32, 8),
                                                     (32768, 256, 16)])
def test_text_corpus_matches_reference(both, vocab, doc_len, query_len):
    ref, port = both
    rd, rq = RSY.make_text_corpus(ref, vocab=vocab, doc_len=doc_len,
                                  query_len=query_len, seed=4)
    td, tq = TSY.make_text_corpus(port, vocab=vocab, doc_len=doc_len,
                                  query_len=query_len, seed=4)
    assert td.dtype == rd.dtype == np.int32
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_array_equal(tq, rq)
    assert tq.shape == (CFG["n_conversations"],
                        CFG["turns_per_conversation"], query_len)


def test_topic_text_matches_reference():
    for seed in range(3):
        a = RSY.topic_text(np.random.default_rng(seed), 5, 9, 4096, 40)
        b = TSY.topic_text(np.random.default_rng(seed), 5, 9, 4096, 40)
        np.testing.assert_array_equal(a, b)
        assert b[0] == 1


TEXTS = ["what is topical locality", "Dense Retrieval with IVF indexes",
         "", "a " * 40, "naïve café résumé"]


@pytest.mark.parametrize("max_len", [4, 16, 64])
def test_tokenizer_matches_reference(max_len):
    ids, mask = TTK.encode_batch(TEXTS, 32768, max_len)
    rids, rmask = RTK.encode_batch(TEXTS, 32768, max_len)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
    assert ids.dtype == np.int32 and mask.dtype == bool
    assert (ids[:, 0] == TTK.CLS).all()
