"""The port's decoder LM == the reference's, on the CPU.

``repro.models.transformer.init_params`` draws a parameter tree from a
JAX key; ``convert.lm_params_from_numpy`` carries it across as numpy
(unstacking the layers), and both packages run the same token batches
through ``forward``, ``prefill`` and ``decode_step`` (the reference in
its "ref" mode on the CPU: plain attention and decode attention).  The
configs are the smoke sizes of the five LM archs, each the port's own
(``repro_torch.configs``) and equal to the reference's: yi-9b (GQA),
qwen1.5-4b (MHA, QKV bias), qwen3-14b (GQA, qk-norm), grok-1 (GQA, MoE
top-2 of 4, the logit soft cap) and deepseek-v2-lite (MLA with its
latent cache, MoE top-2 of 8 with a shared expert); biases and norm
scales are perturbed from their zero / one init so that those paths
carry weight.  float32: logits within 1e-4, caches within 1e-5
(summation order), the greedy tokens equal.  Also: a full cache (the
reference drops the write), ragged ``cache_len``, prompts that are not a
multiple of 128, prefill + decode == ``forward`` over the whole
sequence, bfloat16 runs within 5e-2 of the largest logit, and the
bfloat16 conversion bit for bit (the MoE banks and the float32 router
included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite_16b as RDS
from repro.configs import grok_1_314b as RGK
from repro.configs import qwen3_14b as RQ3
from repro.configs import qwen15_4b as RQ15
from repro.configs import yi_9b as RYI
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import deepseek_v2_lite_16b as TDS
from repro_torch.configs import grok_1_314b as TGK
from repro_torch.configs import qwen3_14b as TQ3
from repro_torch.configs import qwen15_4b as TQ15
from repro_torch.configs import yi_9b as TYI
from repro_torch.models import transformer as TT

LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
REF_CONFIGS = {"yi-9b": RYI, "qwen1.5-4b": RQ15, "qwen3-14b": RQ3,
               "grok-1": RGK, "deepseek-v2-lite": RDS}
PORT_CONFIGS = {"yi-9b": TYI, "qwen1.5-4b": TQ15, "qwen3-14b": TQ3,
                "grok-1": TGK, "deepseek-v2-lite": TDS}
JNP_TO_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(rcfg) -> TT.LMConfig:
    """The port's LMConfig with the reference config's values."""
    names = {f.name for f in dataclasses.fields(TT.LMConfig)}
    kw = {f.name: getattr(rcfg, f.name)
          for f in dataclasses.fields(rcfg) if f.name in names}
    kw["param_dtype"] = JNP_TO_TORCH[rcfg.param_dtype]
    kw["dtype"] = JNP_TO_TORCH[rcfg.dtype]
    return TT.LMConfig(**kw)


def _perturb(params, seed):
    """Biases and norm scales away from their zero / one init."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("'bq'", "'bk'", "'bv'", "'scale'")):
            return (a + rng.normal(scale=0.1, size=a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _both(arch, seed=0, **overrides):
    """The reference's smoke config of ``arch`` and the port's own, both
    with ``overrides``; reference parameters, perturbed, converted."""
    rcfg = dataclasses.replace(REF_CONFIGS[arch].smoke_config(), **overrides)
    params = jax.tree.map(np.asarray,
                          RT.init_params(rcfg, jax.random.PRNGKey(seed)))
    params = _perturb(params, seed)
    tcfg = dataclasses.replace(
        PORT_CONFIGS[arch].smoke_config(),
        **{k: JNP_TO_TORCH.get(v, v) for k, v in overrides.items()})
    assert tcfg == port_config(rcfg)
    port = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    return rcfg, jax.tree.map(jnp.asarray, params), port


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)
                                                ).astype(np.int32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


ARCHS = sorted(REF_CONFIGS)


def test_port_smoke_config_is_the_reference_one():
    assert TYI.smoke_config() == port_config(RYI.smoke_config())
    full = TYI.full_config()
    assert full == port_config(RYI.full_config())
    assert full.param_count() == RYI.full_config().param_count() \
        == 8_829_407_232
    assert full.kv_bytes_per_token() == 48 * 2 * 4 * 128 * 2


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-14b", "grok-1",
                                  "deepseek-v2-lite"])
def test_port_configs_are_the_reference_ones(arch):
    """The port's own config modules: every field the port keeps equal to
    the reference's, at full and smoke size, and the parameter counts."""
    for name in ("full_config", "smoke_config"):
        rcfg = getattr(REF_CONFIGS[arch], name)()
        tcfg = getattr(PORT_CONFIGS[arch], name)()
        assert tcfg == port_config(rcfg)
        assert tcfg.param_count() == rcfg.param_count()
        assert tcfg.active_param_count() == rcfg.active_param_count()


def test_deepseek_full_config_fits_one_card():
    """16.21 B parameters (32.4 GB in bf16), 2.66 B active a token; the
    latent cache 576 values a layer a token."""
    cfg = TDS.full_config()
    assert cfg.param_count() == 16_210_311_168
    assert cfg.active_param_count() == 2_663_233_536
    assert cfg.kv_bytes_per_token() == 27 * (512 + 64) * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rcfg, rp, port = _both(arch)
    tok = _tokens(rcfg.vocab, 2, 40)
    want = RT.forward(rp, rcfg, jnp.asarray(tok))
    got = port(tok)
    assert got.shape == (2, 40, rcfg.vocab)
    _close(got, want, LOGIT_TOL, "logits")


def _decode_both(rcfg, rp, port, tok, max_len, steps, lens=None):
    """Prefill both, then ``steps`` decode steps fed the reference's
    greedy tokens; every logit and cache held within tolerance."""
    rl, rc, rlen = RT.prefill(rp, rcfg, jnp.asarray(tok), max_len)
    tl, tc, tlen = port.prefill(tok, max_len)
    _close(tl, rl, LOGIT_TOL, "prefill logits")
    assert sorted(tc) == sorted(rc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape
        _close(tc[name], rc[name], CACHE_TOL, f"prefill cache {name}")
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(rlen))
    if lens is not None:
        rlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(steps):
        nxt = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        rl, rc = RT.decode_step(rp, rcfg, rc, jnp.asarray(nxt), rlen)
        tl, tc = port.decode_step(tc, torch.from_numpy(nxt), tlen)
        _close(tl, rl, LOGIT_TOL, f"step {step} logits")
        for name in rc:
            _close(tc[name], rc[name], CACHE_TOL, f"step {step} cache {name}")
        rlen, tlen = rlen + 1, tlen + 1
    return tl


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, rp, port = _both(arch, seed=1)
    _decode_both(rcfg, rp, port, _tokens(rcfg.vocab, 2, 40, seed=1),
                 max_len=64, steps=8)


def test_ragged_cache_len_matches_reference():
    """Rows at different fills: row 1 decodes as if its prompt were 5
    tokens shorter (its later slots are overwritten)."""
    rcfg, rp, port = _both("yi-9b", seed=2)
    _decode_both(rcfg, rp, port, _tokens(rcfg.vocab, 2, 37, seed=2),
                 max_len=48, steps=8, lens=np.asarray([37, 32], np.int32))


def test_full_cache_drops_the_write_like_the_reference():
    """A prompt that fills the cache: every step's write is dropped and
    the step attends to the max_len cached positions."""
    _full_cache("qwen3-14b")


def test_full_mla_cache_drops_the_write_like_the_reference():
    """The same for MLA's latent cache (ckv, krope)."""
    _full_cache("deepseek-v2-lite")


def _full_cache(arch):
    rcfg, rp, port = _both(arch, seed=3)
    tok = _tokens(rcfg.vocab, 2, 24, seed=3)
    _decode_both(rcfg, rp, port, tok, max_len=24, steps=3)
    _, cache, _ = port.prefill(tok, 24)
    before = {n: c.clone() for n, c in cache.items()}
    port.decode_step(cache, torch.zeros(2, dtype=torch.int64),
                     torch.full((2,), 24, dtype=torch.int32))
    for n in cache:
        assert torch.equal(cache[n], before[n])


@pytest.mark.parametrize("arch", ["yi-9b", "qwen1.5-4b"])
def test_prefill_then_decode_equals_forward(arch):
    """Prefill S = 29 tokens, decode the next 6: each step's logits are
    the full forward's at that position, within 1e-4."""
    rcfg, _, port = _both(arch, seed=4)
    tok = _tokens(rcfg.vocab, 2, 35, seed=4)
    full = port(tok).float()
    logits, cache, clen = port.prefill(tok[:, :29], 64)
    _close(logits, full[:, 28].numpy(), LOGIT_TOL, "prefill")
    for j in range(29, 35):
        logits, cache = port.decode_step(cache, torch.from_numpy(tok[:, j]),
                                         clen)
        clen = clen + 1
        _close(logits, full[:, j].numpy(), LOGIT_TOL, f"position {j}")


def test_bf16_matches_reference_within_its_rounding():
    """bfloat16 weights and activations: the two frameworks round at
    other places, so logits agree within 5e-2 of the largest."""
    _bf16("yi-9b")


def test_bf16_mla_moe_matches_reference_within_its_rounding():
    """The same for deepseek-v2-lite: MLA, the MoE's banks in bf16, its
    router in float32."""
    _bf16("deepseek-v2-lite")


def _bf16(arch):
    rcfg, rp, port = _both(arch, seed=5, param_dtype=jnp.bfloat16,
                           dtype=jnp.bfloat16)
    assert port.cfg.dtype == torch.bfloat16
    tok = _tokens(rcfg.vocab, 2, 40, seed=5)
    rl, rc, rlen = RT.prefill(rp, rcfg, jnp.asarray(tok), 48)
    tl, tc, tlen = port.prefill(tok, 48)
    assert tl.dtype == torch.float32
    assert all(c.dtype == torch.bfloat16 for c in tc.values())
    for step in range(3):
        want = np.asarray(rl)
        tol = 5e-2 * float(np.abs(want).max())
        _close(tl, want, tol, f"bf16 step {step}")
        nxt = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rl, rc = RT.decode_step(rp, rcfg, rc, jnp.asarray(nxt), rlen)
        tl, tc = port.decode_step(tc, torch.from_numpy(nxt), tlen)
        rlen, tlen = rlen + 1, tlen + 1


def test_lm_params_from_numpy_is_bit_exact_in_bf16():
    rcfg = dataclasses.replace(RYI.smoke_config(), param_dtype=jnp.bfloat16,
                               dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray,
                          RT.init_params(rcfg, jax.random.PRNGKey(6)))
    port = convert.lm_params_from_numpy(params, port_config(rcfg),
                                        device="cpu")

    def bits(t):
        return t.detach().view(torch.int16).numpy()
    assert params["embed"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(bits(port.embed),
                                  params["embed"].view(np.int16))
    np.testing.assert_array_equal(bits(port.lm_head),
                                  params["lm_head"].view(np.int16))
    for i, layer in enumerate(port.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                bits(getattr(layer.attn, name)),
                params["layers"]["attn"][name][i].view(np.int16))
        np.testing.assert_array_equal(
            bits(layer.mlp.w_down),
            params["layers"]["mlp"]["w_down"][i].view(np.int16))
    assert port.embed.dtype == torch.bfloat16


def test_moe_and_mla_trees_convert_bit_exact_in_bf16():
    """deepseek's MLA weights, the (E, d, f) expert banks and the shared
    experts bit for bit in bf16; the router stays float32."""
    rcfg = dataclasses.replace(RDS.smoke_config(), param_dtype=jnp.bfloat16,
                               dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray,
                          RT.init_params(rcfg, jax.random.PRNGKey(7)))
    port = convert.lm_params_from_numpy(params, port_config(rcfg),
                                        device="cpu")
    lp = params["layers"]
    for i, layer in enumerate(port.layers):
        for name in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"):
            got = getattr(layer.attn, name).detach()
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          lp["attn"][name][i].view(np.int16))
        for name in ("w_gate", "w_up", "w_down"):
            got = getattr(layer.moe, name).detach()
            assert got.shape == lp["moe"][name][i].shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          lp["moe"][name][i].view(np.int16))
        np.testing.assert_array_equal(
            layer.moe.shared.w_down.detach().view(torch.int16).numpy(),
            lp["moe"]["shared"]["w_down"][i].view(np.int16))
        assert layer.moe.router.dtype == torch.float32
        np.testing.assert_array_equal(layer.moe.router.detach().numpy(),
                                      lp["moe"]["router"][i])


def test_host_token_ids_are_checked_where_they_come_in():
    rcfg, _, port = _both("yi-9b")
    with pytest.raises(ValueError, match="ids must lie"):
        port(np.full((1, 4), rcfg.vocab, np.int32))
    with pytest.raises(ValueError, match="max_len"):
        port.prefill(_tokens(rcfg.vocab, 1, 10), 8)
    _, cache, _ = port.prefill(_tokens(rcfg.vocab, 1, 4), 8)
    with pytest.raises(ValueError, match="cache_len"):
        port.decode_step(cache, np.zeros(1, np.int32),
                         np.full(1, -1, np.int32))


def test_init_params_at_the_reference_scales():
    _init_params("yi-9b")


@pytest.mark.parametrize("arch", ["grok-1", "deepseek-v2-lite"])
def test_init_params_of_moe_and_mla_at_the_reference_scales(arch):
    _init_params(arch)


def _init_params(arch):
    cfg = PORT_CONFIGS[arch].smoke_config()
    lm = TT.init_params(cfg, seed=0, device="cpu")
    assert len(lm.layers) == cfg.n_layers
    n = sum(p.numel() for p in lm.parameters())
    # the reference's analytic count leaves out MLA's latent norm scale
    assert n == cfg.param_count() + (cfg.n_layers * cfg.kv_lora_rank
                                     if cfg.attn_kind == "mla" else 0)
    assert abs(float(lm.embed.std()) - 1.0) < 0.05
    wq = lm.layers[0].attn.wq
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
    assert not any(p.requires_grad for p in lm.parameters())
