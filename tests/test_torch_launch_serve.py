"""The port's serve launcher prints the reference's lines.

``repro.launch.serve.main()`` (argv patched, stdout captured) and the
port's ``main([..., "--device", "cpu"])`` run the same flags for five
(backend, strategy) cases: (ivf, toploc+), (ivf, toploc), (ivf, plain),
(hnsw, toploc+) and (exact, plain).  The reference's IVF index (built
once, as its launcher builds it) is converted and passed to the port's
launcher; the port builds its own HNSW graph, which is the reference's.
Every printed line is equal character for character, with only the
build and wall times masked.  ``run`` is also held to a replay through
the deprecated aliases on its own index, and ``main`` with no
``--device`` raises without CUDA.
"""
import re
import sys
import types
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ivf as rivf
from repro.launch import serve as rserve
from repro_torch import convert
from repro_torch.core import ivf as tivf
from repro_torch.core import toploc as ttl
from repro_torch.launch import serve as tserve

FLAGS = ["--n-docs", "2000", "--d", "32", "--n-topics", "16",
         "--partitions", "32", "--nprobe", "4", "--h", "16", "--ef", "16",
         "--conversations", "4", "--turns", "4"]
CASES = [("ivf", "toploc+"), ("ivf", "toploc"), ("ivf", "plain"),
         ("hnsw", "toploc+"), ("exact", "plain")]
MASKS = [(re.compile(r"built in [0-9.]+s"), "built in <t>s"),
         (re.compile(r"wall [0-9.]+s \([0-9.]+ ms/turn\)"),
          "wall <t>s (<t> ms/turn)")]


def _args(backend, strategy, device="cpu"):
    return tserve.parser().parse_args(
        FLAGS + ["--backend", backend, "--strategy", strategy,
                 "--device", device])


@pytest.fixture(scope="module")
def ref_ivf():
    """The reference launcher's IVF index for FLAGS, built as it does."""
    from repro.data import synthetic as SY
    a = _args("ivf", "toploc+")
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=a.n_docs, d=a.d, n_topics=a.n_topics,
        n_conversations=a.conversations, turns_per_conversation=a.turns,
        shift_prob=a.shift_prob))
    return rivf.build(jnp.asarray(wl.doc_vecs), p=a.partitions, iters=8,
                      key=jax.random.PRNGKey(0))


def _masked(text):
    for pat, rep in MASKS:
        text = pat.sub(rep, text)
    return text.splitlines()


@pytest.mark.parametrize("backend,strategy", CASES)
def test_main_prints_the_references_lines(ref_ivf, monkeypatch, capsys,
                                          backend, strategy):
    argv = FLAGS + ["--backend", backend, "--strategy", strategy]
    # the reference's build of this very index, made once for the module
    monkeypatch.setattr(rserve, "IV", types.SimpleNamespace(
        build=lambda *a, **k: ref_ivf))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert rserve.main() == 0
    ref = _masked(capsys.readouterr().out)
    index = (convert.ivf_index_from_numpy(
        *(np.asarray(f) for f in ref_ivf), device="cpu")
        if backend == "ivf" else None)
    assert tserve.main(argv + ["--device", "cpu"], index=index) == 0
    port = _masked(capsys.readouterr().out)
    assert len(port) == 3 + (backend != "exact")
    assert port == ref


def _records(res, c):
    t = len(res.records) // res.run.shape[0]
    return res.records[c * t:(c + 1) * t]


STATS = ("centroid_dists", "list_dists", "graph_dists", "code_dists", "i0",
         "refreshed")


@pytest.mark.parametrize("backend,strategy", CASES)
def test_run_equals_an_alias_replay(backend, strategy):
    """What the launcher serves, turn by turn, equals the deprecated
    aliases (or ``ivf.exact_search``) replayed on its own index."""
    a = _args(backend, strategy)
    res = tserve.run(a, out=lambda line: None)
    idx, convs = res.index, torch.from_numpy(res.workload.conversations)
    assert res.run.shape == (a.conversations, a.turns, a.k)
    assert res.metrics == tserve.SY.evaluate_run(res.run, res.workload,
                                                 k=a.k)
    alpha = a.alpha if strategy == "toploc+" else -1.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for c in range(a.conversations):
            q = convs[c]
            if backend == "exact":
                _, ids = tivf.exact_search(idx, q, a.k)
                np.testing.assert_array_equal(res.run[c], ids.numpy())
                continue
            got = []
            for t in range(a.turns):
                if strategy == "plain":
                    _, i, st = ttl.ivf_plain_batch(
                        idx, q[t:t + 1], nprobe=a.nprobe, k=a.k,
                        device="cpu")
                    i, st = i[0], ttl.TurnStats(*(x[0] for x in st))
                elif backend == "hnsw":
                    if t == 0:
                        _, i, sess, st = ttl.hnsw_start(
                            idx, q[0], ef=a.ef, k=a.k, up=a.up,
                            device="cpu")
                    else:
                        _, i, sess, st = ttl.hnsw_step(
                            idx, sess, q[t], ef=a.ef, k=a.k, device="cpu")
                elif t == 0:
                    _, i, sess, st = ttl.ivf_start(
                        idx, q[0], h=a.h, nprobe=a.nprobe, k=a.k,
                        device="cpu")
                else:
                    _, i, sess, st = ttl.ivf_step(
                        idx, sess, q[t], nprobe=a.nprobe, k=a.k, alpha=alpha,
                        device="cpu")
                np.testing.assert_array_equal(res.run[c, t], i.numpy())
                got.append(tuple(int(getattr(st, f)) for f in STATS))
            want = [tuple(int(getattr(r, f)) for f in STATS)
                    for r in _records(res, c)]
            assert got == want


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(FLAGS)
