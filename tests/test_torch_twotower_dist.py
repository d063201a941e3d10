"""The two-tower sharded serve steps == the reference's, on the CPU.

``repro/configs/two_tower_retrieval.py`` serves ``retrieval_cand`` in
two sharded variants (``build_bundle``): ``dist_topk`` (the candidate
corpus split by rows, a top-k a shard, one k-wide merge) and
``toploc_ivf_dist`` (the session's cached centroids pick ``nprobe``
posting lists, split by partition; each shard scans at most ``cap`` of
them, the ones it owns first, and a shard that owns more drops the
overflow).  The reference's steps need one JAX device a shard, so
``ref_steps`` runs them once in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` at S = 1, 2 and
4 (its own timeout, ``REF_TIMEOUT`` s) on the same numpy inputs and the
same parameters (``two_tower_init`` of one key), and the port runs
``dist_topk_step`` / ``toploc_ivf_dist_step`` over a ``RetrievalMesh``
of the CPU repeated S times: ids exact, scores within 1e-5.  One
``toploc_ivf_dist`` case puts every cached centroid in the first
quarter of the partitions, so at S = 4 shard 0 owns more selected lists
than its cap.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as RC
from repro.models import recsys as RR
from repro_torch import convert
from repro_torch.configs import two_tower_retrieval as TC
from repro_torch.distributed import retrieval as tretrieval
from repro_torch.distributed.sharding import split_rows

SHARDS = (1, 2, 4)
REF_TIMEOUT = 120
TOL = 1e-5
CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
KEY = 3
N_CAND, K = 4096, 10                 # dist_topk
P, LMAX, H, NPROBE = 32, 12, 16, 8   # toploc_ivf_dist
#: the toploc_ivf_dist cases: cached centroids spread over the
#: partitions, or all in the first P / 4 (shard 0's at S = 4: overflow)
CASES = ("spread", "overflow")

REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import two_tower_retrieval as TT
from repro.distributed import retrieval as R, sharding as SH
from repro.models import recsys as RR

z = dict(np.load(sys.argv[1]))
cfg = TT.smoke_config()
params = RR.two_tower_init(cfg, jax.random.PRNGKey(int(z["key"])))
k, nprobe = int(z["k"]), int(z["nprobe"])
p, lmax, h = z["list_ids"].shape + (z["cache_vecs/spread"].shape[0],)
uid, hist = jnp.asarray(z["uid"]), jnp.asarray(z["hist"])
out = {}
for s in [int(x) for x in z["shards"]]:
    mesh = R.retrieval_mesh(s)
    axes = SH.Axes(data=("data",), model="model")
    with compat.set_mesh(mesh):
        b = TT.build_bundle(cfg, "retrieval_cand", axes, smoke=True,
                            shape_overrides=dict(
                                variant="dist_topk", k=k,
                                n_candidates=z["corpus"].shape[0]))
        v, i = jax.jit(b.step_fn)(params, uid, hist,
                                  jnp.asarray(z["corpus"]))
        out[f"dist_topk/S{s}/v"], out[f"dist_topk/S{s}/i"] = v, i
        b = TT.build_bundle(cfg, "retrieval_cand", axes, smoke=True,
                            shape_overrides=dict(
                                variant="toploc_ivf_dist", k=k,
                                partitions=p, lmax=lmax, h=h, nprobe=nprobe,
                                shards=s))
        step = jax.jit(b.step_fn)
        for case in ("spread", "overflow"):
            v, i = step(params, uid, hist, jnp.asarray(z["list_vecs"]),
                        jnp.asarray(z["list_ids"]),
                        jnp.asarray(z[f"cache_vecs/{case}"]),
                        jnp.asarray(z[f"cache_ids/{case}"]))
            out[f"{case}/S{s}/v"], out[f"{case}/S{s}/i"] = v, i
np.savez(sys.argv[2], **{n: np.asarray(a) for n, a in out.items()})
"""


def _inputs():
    cfg = TC.smoke_config()
    rng = np.random.default_rng(11)
    e = cfg.tower_mlp[-1]
    z = dict(key=KEY, k=K, nprobe=NPROBE, shards=np.asarray(SHARDS),
             uid=rng.integers(0, cfg.user_vocab, 1).astype(np.int32),
             hist=rng.integers(-1, cfg.item_vocab,
                               (1, cfg.history_len)).astype(np.int32),
             corpus=rng.normal(size=(N_CAND, e)).astype(np.float32),
             list_vecs=rng.normal(size=(P, LMAX, e)).astype(np.float32))
    ids = rng.permutation(P * LMAX).astype(np.int32).reshape(P, LMAX)
    ids[:, LMAX - 3:] = -1                     # ragged lists: pad slots
    ids[5] = -1                                # an empty list
    z["list_ids"] = ids
    for case, hi in (("spread", P), ("overflow", P // 4)):
        z[f"cache_vecs/{case}"] = rng.normal(size=(H, e)).astype(np.float32)
        z[f"cache_ids/{case}"] = rng.choice(hi, H, replace=hi < H
                                            ).astype(np.int32)
    return z


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory, data):
    d = tmp_path_factory.mktemp("ref_twotower_dist")
    inp, out = d / "in.npz", d / "out.npz"
    np.savez(inp, **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, "-c", REF_SCRIPT, str(inp), str(out)],
                   env=env, check=True, timeout=REF_TIMEOUT,
                   capture_output=True)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def model():
    params = RR.two_tower_init(RC.smoke_config(), jax.random.PRNGKey(KEY))
    return convert.two_tower_params_from_numpy(
        jax.tree.map(np.asarray, params), TC.smoke_config(), device=CPU)


def _mesh(s):
    return tretrieval.retrieval_mesh(s, devices=[CPU] * s)


def _user(data):
    return torch.from_numpy(data["uid"]), torch.from_numpy(data["hist"])


def _same(got, ref_steps, key):
    v, i = got
    np.testing.assert_array_equal(i.numpy(), ref_steps[key + "/i"])
    assert i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), ref_steps[key + "/v"], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("s", SHARDS)
def test_dist_topk_step_matches_the_reference(model, data, ref_steps, s):
    got = TC.dist_topk_step(model, *_user(data),
                            torch.from_numpy(data["corpus"]), K, _mesh(s))
    _same(got, ref_steps, f"dist_topk/S{s}")


@pytest.mark.parametrize("s", SHARDS)
def test_dist_topk_step_equals_the_brute_step(model, data, s):
    """Ties go shard-major, which is the lower id: the brute step's."""
    corpus = torch.from_numpy(data["corpus"])
    want = TC.retrieval_step(model, *_user(data), corpus, K)
    got = TC.dist_topk_step(model, *_user(data),
                            split_rows(corpus, [CPU] * s), K, _mesh(s))
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("s", SHARDS)
def test_toploc_ivf_dist_step_matches_the_reference(model, data, ref_steps,
                                                    case, s):
    got = TC.toploc_ivf_dist_step(
        model, *_user(data), torch.from_numpy(data["list_vecs"]),
        torch.from_numpy(data["list_ids"]),
        torch.from_numpy(data[f"cache_vecs/{case}"]),
        torch.from_numpy(data[f"cache_ids/{case}"]), k=K, nprobe=NPROBE,
        mesh=_mesh(s))
    _same(got, ref_steps, f"{case}/S{s}")


def test_the_overflow_case_overflows_a_shard(model, data):
    """At S = 4 the overflow case's shard 0 owns more selected lists than
    its cap (2·8 // 4 + 2 = 6), and dropping them changes the result
    against S = 1, whose cap (2·8 + 2 = 18) drops nothing."""
    uid, hist = _user(data)
    u = model.user_tower(uid, hist)
    cv = torch.from_numpy(data["cache_vecs/overflow"])
    ci = torch.from_numpy(data["cache_ids/overflow"])
    sel = ci[torch.sort(u @ cv.T, descending=True, stable=True
                        ).indices[0, :NPROBE]]
    cap = TC.shard_cap(NPROBE, 4)
    assert cap == 6 and int((sel < P // 4).sum()) > cap
    assert TC.shard_cap(NPROBE, 1) >= NPROBE
    args = (model, uid, hist, torch.from_numpy(data["list_vecs"]),
            torch.from_numpy(data["list_ids"]), cv, ci)
    capped = TC.toploc_ivf_dist_step(*args, k=K, nprobe=NPROBE,
                                     mesh=_mesh(4))
    whole = TC.toploc_ivf_dist_step(*args, k=K, nprobe=NPROBE,
                                    mesh=_mesh(1))
    assert not torch.equal(capped[1], whole[1])
