"""The port's serve bundles against the reference's, on the CPU.

Every serve shape of the registry is bundled (``configs.common.
lm_bundle`` and the recsys configs' ``build_bundle``), and each bundle's
step equals the reference bundle's step on the same parameters
(``convert.*_params_from_numpy`` of the reference's ``*_init`` tree) and
the same inputs, at smoke size with ``shape_overrides`` to a small batch
and sequence:

* the LMs' ``prefill_32k`` / ``decode_32k`` / ``long_500k``: logits
  within 1e-4 x max(1, |logit|), the cache within 1e-4, the greedy
  tokens equal (each decode row's cache filled with random entries up to
  a ragged ``cache_len``);
* the ranking models' ``serve_p99`` / ``serve_bulk`` /
  ``retrieval_cand``: the logits within 1e-5 x max(1, |logit|);
* two-tower's pairwise scores within 1e-5, and ``retrieval_cand``'s
  ``brute``, ``toploc_ivf`` and, on a one-device mesh, ``dist_topk`` /
  ``toploc_ivf_dist``: scores within 1e-5, ids equal but where two
  scores lie within 1e-5 of each other.

The bundles' ``meta`` dicts (``model_flops``, ``params``,
``active_params``, ``tokens``, ``scan_trip_count``) equal the
reference's for every (arch, shape), smoke and full, and so do the
archs' ``skip_shapes`` and their reasons.  A serve shape is a
``kind="serve"`` bundle with no optimizer, and ``make_args`` draws
arguments of its ``arg_structs``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get as rget
from repro.configs import list_archs as rlist
from repro.distributed import sharding as RSH
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import common as TC

CPU = "cpu"
AXES = RSH.Axes(data=("data",), model="model")
LMS = ["yi-9b", "qwen1.5-4b", "qwen3-14b", "grok-1-314b",
       "deepseek-v2-lite-16b"]
META_KEYS = ("model_flops", "params", "active_params", "tokens",
             "scan_trip_count")


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > tol * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3g}")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("arch_id", sorted(rlist()))
def test_bundle_meta_equals_the_reference(arch_id):
    t, r = TC.get(arch_id), rget(arch_id)
    assert t.skip_shapes == r.skip_shapes
    for smoke in (True, False):
        cfg = t.make_smoke_config() if smoke else t.make_config()
        rcfg = r.make_smoke_config() if smoke else r.make_config()
        for shape in t.shapes:
            tb = t.build_bundle(cfg, shape, n_dp=16, smoke=smoke)
            rb = r.build_bundle(rcfg, shape, AXES, n_dp=16, smoke=smoke)
            assert {k: tb.meta.get(k) for k in META_KEYS} == \
                {k: rb.meta.get(k) for k in META_KEYS}, (shape, smoke)


@pytest.mark.parametrize("arch_id", sorted(rlist()))
def test_serve_shapes_are_bundled(arch_id):
    """Each serve shape's bundle: kind "serve", no optimizer, and
    ``make_args`` (CPU and meta) of its ``arg_structs``' shapes."""
    t = TC.get(arch_id)
    cfg = t.make_smoke_config()
    serve = [s for s in t.shapes if t.build_bundle(
        cfg, s, smoke=True).kind == "serve"]
    assert bool(serve) == (t.family != "gnn")
    for shape in serve:
        b = t.build_bundle(cfg, shape, smoke=True,
                           shape_overrides=dict(global_batch=2, batch=8,
                                                seq_len=16,
                                                n_candidates=256))
        assert b.make_optimizer is None
        for dev in ("meta", CPU):
            args = b.make_args(0, dev)
            got = jax.tree.map(lambda a: tuple(a.shape), args,
                               is_leaf=lambda a: isinstance(a,
                                                            torch.Tensor))
            want = jax.tree.map(lambda s: tuple(s.shape),
                                b.arg_structs,
                                is_leaf=lambda s: isinstance(s, TC.Struct))
            assert got == want, (shape, dev)


def _lm_inputs(cfg, shape, rng):
    if shape.startswith("prefill"):
        return (rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),)
    b, s = 2, 32
    cache = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax.eval_shape(lambda: RT.init_cache(cfg, b, s)))
    return (cache, rng.integers(0, cfg.vocab, (b,)).astype(np.int32),
            np.array([3, 30], np.int32))


@pytest.mark.parametrize("arch_id", LMS)
def test_lm_serve_bundles_equal_the_reference(arch_id):
    t, r = TC.get(arch_id), rget(arch_id)
    cfg, rcfg = t.make_smoke_config(), r.make_smoke_config()
    params = jax.tree.map(np.asarray,
                          RT.init_params(rcfg, jax.random.PRNGKey(3)))
    model = convert.lm_params_from_numpy(params, cfg, CPU)
    rng = np.random.default_rng(4)
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        ov = dict(global_batch=2,
                  seq_len=16 if shape.startswith("prefill") else 32)
        tb = t.build_bundle(cfg, shape, smoke=True, shape_overrides=ov)
        rb = r.build_bundle(rcfg, shape, AXES, smoke=True,
                            shape_overrides=ov)
        assert tb.kind == rb.kind == "serve"
        inputs = _lm_inputs(rcfg, shape, rng)
        want = jax.jit(rb.step_fn)(params, *jax.tree.map(jnp.asarray,
                                                          inputs))
        targs = jax.tree.map(_t, inputs)
        got = tb.step_fn(model, *targs)
        _close(got[0], want[0], 1e-4, f"{shape} logits")
        assert torch.equal(got[0].argmax(-1),
                           torch.from_numpy(np.asarray(want[0]).argmax(-1)))
        for name in want[1]:
            _close(got[1][name], want[1][name], 1e-4, f"{shape} {name}")
        if shape.startswith("prefill"):
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(want[2]))


def _ranking_inputs(arch_id, cfg, b, rng):
    if arch_id == "dcn-v2":
        return (rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                         1).astype(np.int32))
    if arch_id == "bst":
        return (rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)
                             ).astype(np.int32),
                rng.integers(0, cfg.item_vocab, (b,)).astype(np.int32),
                rng.integers(0, cfg.other_vocab, (b, cfg.n_other)
                             ).astype(np.int32))
    return (np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                     1).astype(np.int32),)


_RANK = {"dcn-v2": (RR.dcnv2_init, convert.dcnv2_params_from_numpy),
         "bst": (RR.bst_init, convert.bst_params_from_numpy),
         "autoint": (RR.autoint_init, convert.autoint_params_from_numpy)}


@pytest.mark.parametrize("arch_id", sorted(_RANK))
def test_ranking_serve_bundles_equal_the_reference(arch_id):
    t, r = TC.get(arch_id), rget(arch_id)
    cfg, rcfg = t.make_smoke_config(), r.make_smoke_config()
    init, conv = _RANK[arch_id]
    params = jax.tree.map(np.asarray, init(rcfg, jax.random.PRNGKey(5)))
    model = conv(params, cfg, CPU)
    rng = np.random.default_rng(6)
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        ov = dict(batch={"serve_p99": 64, "serve_bulk": 256,
                         "retrieval_cand": 100}[shape])
        tb = t.build_bundle(cfg, shape, smoke=True, shape_overrides=ov)
        rb = r.build_bundle(rcfg, shape, AXES, smoke=True,
                            shape_overrides=ov)
        inputs = _ranking_inputs(arch_id, rcfg, ov["batch"], rng)
        want = jax.jit(rb.step_fn)(params, *map(jnp.asarray, inputs))
        got = tb.step_fn(model, *map(_t, inputs))
        _close(got, want, 1e-5, f"{arch_id} {shape}")


def _ids_equal(got_v, got_i, want_v, want_i, what):
    """Ids equal, but where the reference's neighbouring scores tie within
    1e-5 (then the id sets of the tied run agree)."""
    gv, gi = got_v.numpy(), got_i.numpy()
    wv, wi = np.asarray(want_v), np.asarray(want_i)
    _close(got_v, wv, 1e-5, f"{what} scores")
    for row in range(wi.shape[0]):
        for j in range(wi.shape[1]):
            if gi[row, j] == wi[row, j]:
                continue
            near = np.abs(wv[row] - wv[row, j]) <= 1e-5
            assert gi[row, j] in set(wi[row][near]), (what, row, j)


def test_two_tower_serve_bundles_equal_the_reference():
    t, r = TC.get("two-tower-retrieval"), rget("two-tower-retrieval")
    cfg, rcfg = t.make_smoke_config(), r.make_smoke_config()
    params = jax.tree.map(np.asarray,
                          RR.two_tower_init(rcfg, jax.random.PRNGKey(7)))
    model = convert.two_tower_params_from_numpy(params, cfg, CPU)
    rng = np.random.default_rng(8)
    b = 64
    users = (rng.integers(0, cfg.user_vocab, (b,)).astype(np.int32),
             rng.integers(-1, cfg.item_vocab, (b, cfg.history_len)
                          ).astype(np.int32))
    items = rng.integers(0, cfg.item_vocab, (b,)).astype(np.int32)
    for shape in ("serve_p99", "serve_bulk"):
        tb = t.build_bundle(cfg, shape, smoke=True,
                            shape_overrides=dict(batch=b))
        rb = r.build_bundle(rcfg, shape, AXES, smoke=True,
                            shape_overrides=dict(batch=b))
        want = jax.jit(rb.step_fn)(params, *map(jnp.asarray,
                                                users + (items,)))
        got = tb.step_fn(model, *map(_t, users + (items,)))
        _close(got, want, 1e-5, shape)

    e, n, k = cfg.tower_mlp[-1], 512, 10
    user = tuple(u[:1] for u in users)
    corpus = rng.normal(size=(n, e)).astype(np.float32)
    p, lmax, h, nprobe = 16, 40, 8, 4
    lv = rng.normal(size=(p, lmax, e)).astype(np.float32)
    li = rng.integers(0, n, (p, lmax)).astype(np.int32)
    li[rng.random((p, lmax)) < 0.2] = -1
    cv = rng.normal(size=(h, e)).astype(np.float32)
    ci = rng.permutation(p)[:h].astype(np.int32)
    ivf = (lv, li, cv, ci)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))
    for variant, extra in (("brute", (corpus,)), ("dist_topk", (corpus,)),
                           ("toploc_ivf", ivf), ("toploc_ivf_dist", ivf)):
        ov = dict(variant=variant, n_candidates=n, k=k, partitions=p,
                  lmax=lmax, h=h, nprobe=nprobe, shards=1)
        tb = t.build_bundle(cfg, "retrieval_cand", smoke=True,
                            shape_overrides=ov)
        with compat.set_mesh(jmesh):
            rb = r.build_bundle(rcfg, "retrieval_cand", AXES, smoke=True,
                                shape_overrides=ov)
            want = jax.jit(rb.step_fn)(params, *map(jnp.asarray,
                                                    user + extra))
        got = tb.step_fn(model, *map(_t, user + extra))
        _ids_equal(got[0], got[1], want[0], want[1], variant)
