"""The port's bi-encoder == the reference's, on the CPU.

``repro.models.encoder.init_params`` draws a parameter tree from a JAX
key; ``convert.encoder_params_from_numpy`` carries it across as numpy
(unstacking the layers), and both packages encode the same token
batches from ``make_text_corpus``: docs at the full length, queries of
16 tokens padded to it as the reference's pipeline pads them.  Query and
doc embeddings agree within 1e-5 (float32 throughout; XLA and PyTorch
sum the products in other orders).  The lengths are S = 32 and 64 (not
multiples of 128: the reference runs its plain attention on any device)
and S = 128 (where the reference's TPU path takes its kernel), on the
tiny and small configs and a shared-towers (Snowflake-style) variant.
The layers are held one at a time too: attention with GQA / MQA, qkv
bias and qk-norm, causal or not; RoPE, RMSNorm and SwiGLU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import encoders as RC
from repro.data import synthetic as RSY
from repro.models import encoder as RE
from repro.models import layers as RL
from repro_torch import convert
from repro_torch.configs import encoders as TC
from repro_torch.models import encoder as TE
from repro_torch.models import layers as TL

TOL = 1e-5
CONFIGS = {"tiny": "tiny_encoder_config", "small": "small_encoder_config",
           "tiny_shared": "tiny_encoder_config"}


def _configs(name, max_len=None):
    rc, tc = (getattr(m, CONFIGS[name])() for m in (RC, TC))
    kw = {}
    if name.endswith("shared"):
        kw["shared_towers"] = True
    if max_len:
        kw["max_len"] = max_len
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def _tokens(cfg, s, n=6, seed=3):
    """Docs of ``s`` tokens (two with a padded tail) and queries of 16
    tokens padded to ``s``, as (tokens, mask) pairs."""
    wl = RSY.make_workload(RSY.WorkloadConfig(
        n_docs=n, d=8, n_topics=3, n_conversations=1,
        turns_per_conversation=n, seed=seed))
    docs, queries = RSY.make_text_corpus(wl, vocab=cfg.vocab, doc_len=s,
                                         query_len=16)
    docs[:2, s // 2:] = 0
    q = np.pad(queries[0], ((0, 0), (0, s - 16)))
    return (docs, docs > 0), (q, q > 0)


def _both(name, s, seed=0):
    rc, tc = _configs(name, max_len=max(s, RC.tiny_encoder_config().max_len))
    params = RE.init_params(rc, jax.random.PRNGKey(seed))
    port = convert.encoder_params_from_numpy(
        jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, port


@pytest.mark.parametrize("name,s", [("tiny", 32), ("tiny", 128),
                                    ("small", 64), ("small", 128),
                                    ("tiny_shared", 32),
                                    ("tiny_shared", 128)])
def test_encode_matches_reference(name, s):
    rc, params, port = _both(name, s)
    docs, queries = _tokens(rc, s)
    for side, (tok, mask) in (("docs", docs), ("queries", queries)):
        want = getattr(RE, f"encode_{side}")(params, rc, tok, mask)
        got = getattr(port, f"encode_{side}")(tok, mask)
        assert got.shape == (tok.shape[0], rc.d_out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=side)


def test_shared_towers_are_one_module():
    _, _, port = _both("tiny_shared", 32)
    assert port.query is port.doc
    _, _, two = _both("tiny", 32)
    assert two.query is not two.doc
    # parameters() counts a shared module once: half the two towers'
    assert 2 * sum(p.numel() for p in port.parameters()) == \
        sum(p.numel() for p in two.parameters())


def test_attention_attribute_runs_every_layer_through_its_function():
    """Setting ``Attention.attention`` on a layer's instance routes that
    layer's attention through the given function (how the chip smoke
    holds the kernel to the plain version inside the towers); None is
    ``ops.flash_attention`` again."""
    from repro_torch.kernels import ref
    rc, _, port = _both("tiny", 32)
    (tok, mask), _ = _tokens(rc, 32)
    want = port.encode_docs(tok, mask)
    calls = []

    def plain(q, k, v, *, causal):
        calls.append(q.shape)
        return ref.mha_attention(q, k, v, causal=causal)

    attns = [m for m in port.doc.modules() if isinstance(m, TL.Attention)]
    assert len(attns) == rc.n_layers
    for m in attns:
        m.attention = plain
    got = port.encode_docs(tok, mask)
    assert len(calls) == rc.n_layers
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for m in attns:
        m.attention = None
    port.encode_docs(tok, mask)
    assert len(calls) == rc.n_layers


def test_padding_changes_the_function_as_in_the_reference():
    """Padding keys are not masked: the same 16 query tokens padded to
    32 or to 64 give other embeddings, in both packages alike."""
    rc, params, port = _both("small", 64)
    _, (q, mask) = _tokens(rc, 64)
    short = (q[:, :32], mask[:, :32])
    for tok, m in ((q, mask), short):
        np.testing.assert_allclose(
            port.encode_queries(tok, m).numpy(),
            np.asarray(RE.encode_queries(params, rc, tok, m)), rtol=0,
            atol=TOL)
    a = port.encode_queries(q, mask)
    b = port.encode_queries(*short)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("fn", ["dragon_config", "snowflake_config",
                                "small_encoder_config",
                                "tiny_encoder_config"])
def test_configs_match_reference(fn):
    ref = dataclasses.asdict(getattr(RC, fn)())
    port = dataclasses.asdict(getattr(TC, fn)())
    assert ref.pop("dtype") == jax.numpy.float32
    assert port.pop("dtype") == torch.float32
    assert port == ref
    assert getattr(TC, fn)().param_count() == getattr(RC, fn)().param_count()


def test_port_init_follows_the_reference_scales():
    """``init_params`` draws from a seeded ``torch.Generator``: the
    reference's tree shapes, dense normal x (1/d_in)^.5, embedding x 1,
    positions x 0.02, norms ones, and the same seed gives the same
    encoder."""
    rc, tc = _configs("small")
    ref = jax.tree.map(np.asarray, RE.init_params(rc, jax.random.PRNGKey(0)))
    port = TE.init_params(tc, seed=5, device="cpu")
    again = TE.init_params(tc, seed=5, device="cpu")
    for (n, a), (_, b) in zip(port.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    assert not any(p.requires_grad for p in port.parameters())
    t, r = port.doc, ref["doc"]
    assert t.embed.shape == r["embed"].shape
    assert t.pos.shape == r["pos"].shape
    assert t.proj.shape == r["proj"].shape
    layer = t.layers[1]
    for name in ("wq", "wk", "wv", "wo"):
        assert getattr(layer.attn, name).shape == \
            r["layers"]["attn"][name].shape[1:]
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(layer.mlp, name)
        assert w.shape == r["layers"]["mlp"][name].shape[1:]
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05
    assert abs(float(t.embed.std()) - 1) < 0.05
    assert abs(float(t.pos.std()) - 0.02) < 0.002
    assert torch.equal(layer.norm1.scale, torch.ones(tc.d_model))
    tok, mask = _tokens(rc, 64)[1]
    out = port.encode_queries(tok, mask)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(len(tok)))


def test_sequences_past_max_len_are_refused():
    rc, _, port = _both("tiny", 32)
    tok = np.ones((1, 33), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        port.encode_docs(tok, tok > 0)


# ---------------------------------------------------------------------------
# the layers the encoder is built from, one at a time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv,qkv_bias,qk_norm,causal", [
    (4, False, False, False),       # the encoder's MHA
    (2, True, False, True),         # GQA with qkv bias (qwen1.5-style)
    (1, False, True, False),        # MQA with qk-norm (qwen3-style)
    (2, True, True, True)])
def test_attention_layer_matches_reference(hkv, qkv_bias, qk_norm, causal):
    rcfg = RL.AttnConfig(32, 4, hkv, 8, qkv_bias=qkv_bias, qk_norm=qk_norm,
                         causal=causal)
    tcfg = TL.AttnConfig(32, 4, hkv, 8, qkv_bias=qkv_bias, qk_norm=qk_norm,
                         causal=causal)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    params = RL.attn_init(jax.random.PRNGKey(hkv), rcfg)
    rng = np.random.default_rng(hkv)
    if qkv_bias:                    # non-zero biases, so they count
        params = dict(params, **{n: rng.normal(size=params[n].shape).astype(
            np.float32) for n in ("bq", "bk", "bv")})
    tparams = convert._tree(lambda a: torch.tensor(np.asarray(a)),
                            jax.tree.map(np.asarray, params))
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    want = RL.attn_apply(params, rcfg, x)
    got = TL.Attention(tcfg, tparams)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_norm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 1, 10)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(RL.apply_rope(x, pos)), rtol=0, atol=TOL)
    scale = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        TL.RMSNorm({"scale": torch.from_numpy(scale)})(
            torch.from_numpy(x)).numpy(),
        np.asarray(RL.rmsnorm({"scale": scale}, x)), rtol=0, atol=TOL)
    mlp = jax.tree.map(np.asarray,
                       RL.swiglu_init(jax.random.PRNGKey(3), 16, 40))
    np.testing.assert_allclose(
        TL.SwiGLU({k: torch.tensor(v) for k, v in mlp.items()})(
            torch.from_numpy(x)).numpy(),
        np.asarray(RL.swiglu(mlp, x)), rtol=0, atol=TOL)
