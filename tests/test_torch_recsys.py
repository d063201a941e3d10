"""The port's two-tower model == the reference's, on the CPU.

``repro``'s ``two_tower_init(smoke_config())`` gives the parameters; the
port takes them as numpy arrays (``convert.two_tower_params_from_numpy``)
and both packages run the same numpy ids through ``user_tower`` (the
history bag through ``embedding_bag``, mean) and ``item_tower``: unit
vectors within 1e-5 (XLA and PyTorch sum the MLP products in other
orders).  Brute-force ``retrieval_topk`` over the item corpus returns
the same ids as ``lax.top_k`` when both packages score the same user
vectors.  The configuration module copies the reference's fields,
values and shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as RC
from repro.models import layers as RL
from repro.models import recsys as RR
from repro_torch import convert
from repro_torch.configs import two_tower_retrieval as TC
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR

TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def towers():
    rcfg, tcfg = RC.smoke_config(), TC.smoke_config()
    params = RR.two_tower_init(rcfg, jax.random.PRNGKey(3))
    port = convert.two_tower_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device=CPU)
    return rcfg, tcfg, params, port


def _requests(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    uid = rng.integers(0, cfg.user_vocab, b).astype(np.int32)
    hist = rng.integers(-1, cfg.item_vocab, (b, cfg.history_len))
    hist[0] = -1                                   # a user with no history
    hist[1, -1] = cfg.item_vocab - 1               # the table's last row
    return uid, hist.astype(np.int32)


def test_configs_copy_the_reference():
    for name in ("full_config", "smoke_config"):
        r, t = getattr(RC, name)(), getattr(TC, name)()
        rf = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert rf.keys() == tf.keys()
        assert {k: v for k, v in rf.items() if k != "dtype"} == \
            {k: v for k, v in tf.items() if k != "dtype"}
        assert t.dtype == torch.float32 and r.dtype == jnp.float32
    assert TC.SHAPE_PARAMS == RC.SHAPE_PARAMS
    assert TC.SMOKE_SHAPE_PARAMS == RC.SMOKE_SHAPE_PARAMS
    # the reference's toploc_ivf variant defaults (build_bundle)
    assert TC.TOPLOC_IVF == dict(partitions=1024, h=128, nprobe=32)
    assert TC.toploc_lmax(1_000_000, 1024) == 1220


@pytest.mark.parametrize("name", ["full_config", "smoke_config"])
def test_param_count_matches_the_reference(name):
    assert getattr(TC, name)().param_count() == \
        getattr(RC, name)().param_count()


def test_port_init_has_the_reference_tree_and_scales():
    cfg = TC.smoke_config()
    gen = torch.Generator().manual_seed(0)
    p = TR.two_tower_params(cfg, gen)
    ref = RR.two_tower_init(RC.smoke_config(), jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    assert abs(float(p["emb"]["table"].std()) - cfg.embed_dim ** -0.5) < 0.02
    assert not p["user_mlp"]["layers"][0]["b"].any()
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == cfg.param_count()
    model = TR.two_tower_init(cfg, seed=0, device=CPU)
    assert not any(q.requires_grad for q in model.parameters())


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_layer_matches_reference(final_act):
    rng = np.random.default_rng(5)
    dims = (12, 8, 4)
    params = RL.mlp_init(jax.random.PRNGKey(1), dims)
    x = rng.normal(size=(6, 12)).astype(np.float32)
    want = np.asarray(RL.mlp_apply(params, jnp.asarray(x),
                                   final_act=final_act))
    port = TL.MLP(jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                               params), final_act=final_act)
    got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if final_act:
        assert (got >= 0).all()
    nobias = TL.MLP(TL.mlp_init(torch.Generator().manual_seed(0), dims,
                                bias=False))
    assert len(nobias.biases) == 0 and nobias(torch.zeros(2, 12)).shape == \
        (2, 4)


def test_user_and_item_towers_match_reference(towers):
    rcfg, tcfg, params, port = towers
    uid, hist = _requests(tcfg, 7)
    want = np.asarray(RR.user_tower(params, rcfg, jnp.asarray(uid),
                                    jnp.asarray(hist)))
    got = port.user_tower(uid, hist).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-6)
    items = np.arange(tcfg.item_vocab, dtype=np.int32)
    want = np.asarray(RR.item_tower(params, rcfg, jnp.asarray(items)))
    got = port.item_tower(items).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # tensors on the device take the same path, unchecked
    np.testing.assert_array_equal(
        port.item_tower(torch.from_numpy(items)).numpy(), got)


def test_sparse_substrate_matches_reference(towers):
    rcfg, tcfg, params, port = towers
    offs = TR.field_offsets((tcfg.user_vocab, tcfg.item_vocab))
    assert offs == RR.field_offsets((rcfg.user_vocab, rcfg.item_vocab))
    uid, hist = _requests(tcfg, 5, seed=1)
    ids = np.stack([uid, hist[:, 0].clip(0)], -1)
    want = np.asarray(RR.embed_fields(params["emb"], offs, jnp.asarray(ids)))
    got = TR.embed_fields(port.table, offs, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(RR.embed_bag(params["emb"], offs[1], jnp.asarray(hist),
                                   agg="mean"))
    got = TR.embed_bag(port.table, offs[1], torch.from_numpy(hist)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_retrieval_topk_ids_match_lax_top_k(towers):
    rcfg, tcfg, params, port = towers
    uid, hist = _requests(tcfg, 4, seed=2)
    u = np.array(RR.user_tower(params, rcfg, jnp.asarray(uid),
                               jnp.asarray(hist)))
    corpus = np.array(RR.item_tower(params, rcfg,
                                    jnp.arange(tcfg.item_vocab)))
    rv, ri = RR.retrieval_topk(jnp.asarray(u), jnp.asarray(corpus), 100)
    tv, ti = TR.retrieval_topk(torch.from_numpy(u), torch.from_numpy(corpus),
                               100)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=0, atol=TOL)
    # the serve step: the port's own user tower, then brute force
    sv, si = TC.retrieval_step(port, uid, hist, torch.from_numpy(corpus),
                               100)
    np.testing.assert_allclose(sv.numpy(), np.asarray(rv), rtol=0, atol=TOL)


def test_pairwise_step_matches_reference(towers):
    rcfg, tcfg, params, port = towers
    uid, hist = _requests(tcfg, 6, seed=3)
    items = np.random.default_rng(4).integers(
        0, tcfg.item_vocab, 6).astype(np.int32)
    u = RR.user_tower(params, rcfg, jnp.asarray(uid), jnp.asarray(hist))
    i = RR.item_tower(params, rcfg, jnp.asarray(items))
    want = np.asarray(jnp.sum(u * i, -1))
    got = TC.pairwise_step(port, uid, hist, items).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("bad", [
    dict(user_id=np.array([512])), dict(user_id=np.array([-1])),
    dict(history=np.full((1, 5), 1024)), dict(history=np.zeros((1, 5)))])
def test_host_ids_outside_the_vocabulary_are_refused(towers, bad):
    """Numpy ids are checked where they come in; on the card the kernel
    and the gather read unchecked."""
    port = towers[3]
    args = dict(user_id=np.array([0]), history=np.zeros((1, 5), np.int64))
    args.update(bad)
    with pytest.raises(ValueError, match="ids"):
        port.user_tower(args["user_id"], args["history"])
