"""The port's ranking models (DCN-v2, BST, AutoInt) == the reference's, on
the CPU.

``repro``'s ``*_init(smoke_config())`` gives the parameters; the port
takes them as numpy arrays (``convert.dcnv2_`` / ``bst_`` /
``autoint_params_from_numpy``) and both packages score the same numpy
ids and dense features: logits within 1e-5 (XLA and PyTorch sum the
products in other orders), with ids at each field's first and last row.
BST's attention runs the port's plain version here (``ops.flash_attention``
on CPU tensors) and the reference's plain math (S = 7 is not a multiple
of 128).  ``LayerNorm`` and ``MLP`` with each activation the models pass
it (ReLU, gelu's tanh form, leaky ReLU 0.01) within 1e-6.  The
configuration modules copy the reference's fields, values and shapes;
the port's init draws the reference's tree at its scales; host ids
outside a vocabulary are refused before they reach the device.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as RA
from repro.configs import bst as RB
from repro.configs import dcn_v2 as RD
from repro.models import layers as RL
from repro.models import recsys as RR
from repro_torch import convert
from repro_torch.configs import autoint as TA
from repro_torch.configs import bst as TB
from repro_torch.configs import dcn_v2 as TD
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR

TOL = 1e-5          # logits: summation order across the two libraries
LAYER_TOL = 1e-6    # one LayerNorm / MLP
CPU = "cpu"
B = 9

# (reference config module, port config module, reference init, port
# init, port converter)
MODELS = {
    "dcn_v2": (RD, TD, RR.dcnv2_init, TR.dcnv2_init,
               convert.dcnv2_params_from_numpy),
    "bst": (RB, TB, RR.bst_init, TR.bst_init,
            convert.bst_params_from_numpy),
    "autoint": (RA, TA, RR.autoint_init, TR.autoint_init,
                convert.autoint_params_from_numpy),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_configs_copy_the_reference(model):
    rmod, tmod = MODELS[model][:2]
    for name in ("full_config", "smoke_config"):
        r, t = _fields(getattr(rmod, name)()), _fields(getattr(tmod, name)())
        assert r.keys() == t.keys()
        assert r.pop("dtype") == jnp.float32
        assert t.pop("dtype") == torch.float32
        assert r == t
    assert tmod.SHAPE_PARAMS == rmod.SHAPE_PARAMS
    assert tmod.SMOKE_SHAPE_PARAMS == rmod.SMOKE_SHAPE_PARAMS
    assert getattr(tmod, "VOCABS", None) == getattr(rmod, "VOCABS", None)


@pytest.mark.parametrize("name", ["full_config", "smoke_config"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_count_matches_the_reference(model, name):
    rmod, tmod = MODELS[model][:2]
    assert getattr(tmod, name)().param_count() == \
        getattr(rmod, name)().param_count()
    if model == "dcn_v2":
        assert getattr(tmod, name)().d_input == getattr(rmod, name)().d_input


@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_init_has_the_reference_tree_and_scales(model):
    rmod, tmod, rinit, tinit, _ = MODELS[model]
    cfg = tmod.smoke_config()
    p = tinit(cfg, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: rinit(rmod.smoke_config(),
                                       jax.random.PRNGKey(0)))
    want = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == want
    # param_count is the reference's formula (test above), which counts a
    # head bias the trees do not hold and not BST's positions: the trees'
    # sizes are held to each other instead
    assert sum(t.numel() for t in jax.tree.leaves(p)) == \
        sum(a.size for a in jax.tree.leaves(ref))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(p))
    table = p["emb"]["table"]
    assert abs(float(table.std()) - cfg.embed_dim ** -0.5) < 0.02
    if model == "dcn_v2":
        assert not any(c["b"].any() for c in p["cross"])
        w = p["cross"][0]["w"]
        assert abs(float(w.std()) - cfg.d_input ** -0.5) < 0.01
    if model == "bst":
        assert abs(float(p["pos"].std()) - 0.02) < 0.005
        norm = p["blocks"][0]["norm1"]
        assert bool((norm["scale"] == 1).all()) and not norm["bias"].any()
    if model == "autoint":
        w = p["attn"][1]["wq"]
        assert abs(float(w.std()) - w.shape[0] ** -0.5) < 0.02


def _ids(rng, vocabs, b=B):
    """(b, F) ids: row 0 every field's first row, row 1 its last, the
    rest uniform."""
    vocabs = np.asarray(vocabs)
    ids = (rng.random((b, vocabs.size)) * vocabs).astype(np.int32)
    ids[0], ids[1] = 0, vocabs - 1
    return ids


def _inputs(model, cfg, seed=0):
    rng = np.random.default_rng(seed)
    if model == "dcn_v2":
        dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
        return dense, _ids(rng, cfg.vocab_sizes)
    if model == "bst":
        seq = _ids(rng, (cfg.item_vocab,) * (cfg.seq_len + 1))
        return (seq[:, :-1], np.ascontiguousarray(seq[:, -1]),
                _ids(rng, (cfg.other_vocab,) * cfg.n_other))
    return (_ids(rng, cfg.vocab_sizes),)


REF_FORWARD = {"dcn_v2": RR.dcnv2_forward, "bst": RR.bst_forward,
               "autoint": RR.autoint_forward}


@functools.lru_cache(maxsize=None)
def _ported(model):
    """(name, reference cfg, port cfg, reference params, port model)."""
    rmod, tmod, rinit, _, conv = MODELS[model]
    rcfg, tcfg = rmod.smoke_config(), tmod.smoke_config()
    params = rinit(rcfg, jax.random.PRNGKey(7))
    port = conv(jax.tree.map(np.asarray, params), tcfg, device=CPU)
    return model, rcfg, tcfg, params, port


@pytest.fixture(params=sorted(MODELS))
def ported(request):
    return _ported(request.param)


def test_logits_match_the_reference(ported):
    model, rcfg, tcfg, params, port = ported
    inputs = _inputs(model, tcfg)
    want = np.asarray(REF_FORWARD[model](params, rcfg,
                                         *map(jnp.asarray, inputs)))
    got = port(*inputs)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # tensors take the same path, unchecked
    again = port(*(torch.from_numpy(x) for x in inputs))
    assert torch.equal(again, got)
    assert not any(p.requires_grad for p in port.parameters())


def test_chunked_scoring_matches_one_call(ported):
    model, _, tcfg, _, port = ported
    inputs = [torch.from_numpy(x) for x in _inputs(model, tcfg, seed=1)]
    whole = port(*inputs)
    got = TR.score_in_chunks(port, B, 4, *inputs)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=LAYER_TOL)
    assert TR.score_in_chunks(port, B, B, *inputs).shape == (B,)


def test_host_ids_outside_a_vocabulary_are_refused(ported):
    model, _, tcfg, _, port = ported
    inputs = list(_inputs(model, tcfg))
    first = 1 if model == "dcn_v2" else 0
    for i in range(first, len(inputs)):
        for bad in (-1, None):
            x = [a.copy() for a in inputs]
            flat = x[i].reshape(-1)
            if bad is None:
                col = flat.size - 1 if x[i].ndim == 1 else x[i].shape[1] - 1
                vocab = (tcfg.item_vocab if model == "bst" and i < 2 else
                         tcfg.other_vocab if model == "bst" else
                         tcfg.vocab_sizes[col])
                flat[col] = vocab
            else:
                flat[0] = bad
            with pytest.raises(ValueError, match="must lie in"):
                port(*x)
    with pytest.raises(ValueError, match="integer ids"):
        port(*inputs[:first], inputs[first].astype(np.float32),
             *inputs[first + 1:])


def test_bst_attention_runs_the_plain_version_on_the_cpu():
    """BST's block goes through ``ops.flash_attention`` (the plain version
    on CPU tensors); the plain attention set on the module gives the
    same bits, and the heads are embed_dim / n_heads wide."""
    model, _, tcfg, _, port = _ported("bst")
    attn = port.blocks[0].attn
    assert attn.cfg == TL.AttnConfig(tcfg.embed_dim, tcfg.n_heads,
                                     tcfg.n_heads,
                                     tcfg.embed_dim // tcfg.n_heads,
                                     causal=False)
    inputs = _inputs(model, tcfg, seed=2)
    want = port(*inputs)
    attn.attention = tref.mha_attention
    try:
        assert torch.equal(port(*inputs), want)
    finally:
        del attn.attention


def test_layernorm_matches_the_reference():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, 7, 32)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.normal(size=32).astype(np.float32),
              "bias": rng.normal(size=32).astype(np.float32)}
    want = np.asarray(RL.layernorm(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x)))
    norm = TL.LayerNorm({k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(norm(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=LAYER_TOL)
    assert norm(torch.from_numpy(x).to(torch.bfloat16)).dtype == \
        torch.bfloat16
    init = TL.layernorm_init(32, CPU)
    assert bool((init["scale"] == 1).all()) and not init["bias"].any()


ACTS = {"relu": jax.nn.relu, "gelu": jax.nn.gelu,
        "leaky_relu": jax.nn.leaky_relu}


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_mlp_activations_match_the_reference(act, final_act):
    rng = np.random.default_rng(5)
    dims = (12, 8, 4)
    params = RL.mlp_init(jax.random.PRNGKey(1), dims)
    x = (rng.normal(size=(6, 12)) * 2).astype(np.float32)
    want = np.asarray(RL.mlp_apply(params, jnp.asarray(x), act=ACTS[act],
                                   final_act=final_act))
    port = TL.MLP(jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                               params), final_act=final_act, act=act)
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=LAYER_TOL)


def test_mlp_refuses_an_unknown_activation():
    params = TL.mlp_init(torch.Generator().manual_seed(0), (4, 2))
    with pytest.raises(ValueError, match="activation"):
        TL.MLP(params, act="swish")


def test_field_vocab_check_names_the_field():
    with pytest.raises(ValueError, match="field 2's ids"):
        TR.check_ids("ids", np.array([[0, 1, 5]]), (4, 4, 4))
    with pytest.raises(ValueError, match=r"\(B, 3\) ids"):
        TR.check_ids("ids", np.array([0, 1, 2]), (4, 4, 4))
    TR.check_ids("ids", np.zeros((0, 3), np.int32), (4, 4, 4))
