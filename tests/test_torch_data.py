"""repro_torch's copy of the synthetic workload == the reference's.

``make_workload`` is a numpy copy (same recipe, same random stream), so
every array and every qrel must be equal, and the IR metrics must give
the same numbers.  ``make_device_corpus`` follows the recipe with a
``torch.Generator`` on the device and is held to its properties.
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as RSY
from repro_torch.data import synthetic as TSY

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
