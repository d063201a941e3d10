"""The port's MoE and MLA layers == the reference's, on the CPU.

``repro.models.layers`` draws the parameters (``moe_init`` /
``mla_init`` from a JAX key, norm scales perturbed from one); the port
takes the same arrays (``torch.from_numpy``) and both run the same numpy
inputs.  MoE: ``moe_apply`` outputs within 1e-5 and the aux loss within
1e-6, at one and two routing groups, with shared experts and without;
the dispatch itself (``_dispatch_group``) exact: the dispatched rows,
the token in every expert slot, so the set of dropped (token, expert)
choices, under a small ``capacity_factor`` that drops some and on tied
router logits (ties to the smaller expert, as ``lax.top_k``).  MLA:
``mla_apply`` (the reference's attention in "ref" mode on the CPU, the
port's plain version) and the absorbed ``mla_decode`` within 1e-5,
caches within 1e-5, a full cache's write dropped.  The attention at
MLA's widths: the port's plain ``flash_attention`` at (D, Dv) = (192,
128) and (256, 256) against the reference's Pallas kernel in interpret
mode (S, Skv multiples of 128), and above the reference's 2048² switch
against its ``chunked_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as rfa
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import layers as RL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

OUT_TOL, AUX_TOL, TOL = 1e-5, 1e-6, 1e-5


def _np_tree(params, seed=0):
    """The reference's parameters as numpy, norm scales perturbed."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a)
        if "scale" in jax.tree_util.keystr(path):
            a = (a + rng.normal(scale=0.1, size=a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

# (E, top_k, d, f, n_shared, capacity_factor, groups, B, S, tied)
MOE_CASES = [(8, 2, 16, 24, 1, 1.25, 1, 2, 8, False),
             (8, 3, 16, 16, 0, 0.4, 2, 2, 12, False),    # drops, 2 groups
             (4, 2, 16, 32, 0, 0.5, 1, 1, 16, True),     # tied, drops
             (6, 1, 8, 16, 2, 0.1, 1, 1, 32, True)]      # tied, top-1


def _moe(case, seed=0):
    e, k, d, f, sh, cf, g, b, s, tied = case
    rcfg = RL.MoEConfig(n_experts=e, top_k=k, d_model=d, d_ff=f,
                        n_shared=sh, capacity_factor=cf, n_groups=g)
    params = jax.tree.map(np.array,
                          RL.moe_init(jax.random.PRNGKey(seed), rcfg))
    if tied:
        # experts 0-1 and 2-3 see equal logits: ties to the smaller
        params["router"][:, 1] = params["router"][:, 0]
        params["router"][:, 3] = params["router"][:, 2]
    x = np.random.default_rng(seed + 1).normal(size=(b, s, d)
                                               ).astype(np.float32)
    tcfg = TL.MoEConfig(e, k, d, f, sh, cf, g)
    return rcfg, params, x, tcfg


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_matches_the_reference(case):
    rcfg, params, x, tcfg = _moe(case)
    want, want_aux = jax.jit(RL.moe_apply, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), rcfg, jnp.asarray(x))
    got, aux = TL.MoE(tcfg, _torch_tree(params))(torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, want, OUT_TOL, "moe out")
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_dispatch_drops_exactly_what_the_reference_drops(case):
    """Per routing group: the dispatched (E, C, d) rows equal, and the
    token in every expert slot (the pad token T where none) equal, so
    the same (token, expert) choices dropped; weights within 1e-6."""
    rcfg, params, x, tcfg = _moe(case)
    e, k, d = rcfg.n_experts, rcfg.top_k, rcfg.d_model
    tokens = x.reshape(rcfg.n_groups, -1, d)
    t = tokens.shape[1]
    cap = tcfg.capacity(t)
    assert cap == max(k, int(rcfg.capacity_factor * t * k / e + 0.9999))
    dropped = 0
    for xl in tokens:
        logits = xl @ params["router"]
        rd, rtok, rw, raux = jax.jit(RL._dispatch_group,
                                     static_argnums=(2, 3))(
            jnp.asarray(xl), jnp.asarray(logits), k, cap)
        td, slot, tw, taux = TL._dispatch_group(
            torch.from_numpy(xl), torch.from_numpy(logits), k, cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
        tok = torch.full((e * cap + 1,), t, dtype=torch.long)
        tok[slot.reshape(-1)] = torch.arange(t).repeat_interleave(k)
        np.testing.assert_array_equal(tok[:-1].numpy(), np.asarray(rtok))
        np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=0,
                                   atol=AUX_TOL)
        assert abs(float(taux) - float(raux)) <= AUX_TOL
        dropped += int((slot == e * cap).sum())
    if rcfg.capacity_factor < 1:
        assert dropped > 0


def test_tied_router_logits_route_to_the_smaller_expert():
    """Top-1 over logits where experts 1 and 3 tie 0 and 2: no token is
    ever routed to 1 or 3."""
    rcfg, params, x, tcfg = _moe(MOE_CASES[3])
    xl = x.reshape(-1, rcfg.d_model)
    logits = torch.from_numpy(xl @ params["router"])
    assert torch.equal(logits[:, 1], logits[:, 0])
    cap = tcfg.capacity(xl.shape[0])
    # a capacity past every token: nothing drops, every choice is seen
    _, slot, _, _ = TL._dispatch_group(torch.from_numpy(xl), logits, 1,
                                       xl.shape[0])
    experts = set((slot // xl.shape[0]).reshape(-1).tolist())
    assert experts & {0, 2} and not experts & {1, 3}
    assert cap < xl.shape[0]


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_CFG = dict(d_model=32, n_heads=4, kv_lora_rank=16, d_head=8, d_rope=4)


def _mla(seed=0):
    rcfg = RL.MLAConfig(**MLA_CFG)
    params = _np_tree(RL.mla_init(jax.random.PRNGKey(seed), rcfg), seed)
    return rcfg, params, TL.MLA(TL.MLAConfig(**MLA_CFG),
                                _torch_tree(params))


def test_mla_apply_matches_the_reference():
    rcfg, params, port = _mla()
    x = np.random.default_rng(1).normal(size=(2, 20, 32)).astype(np.float32)
    want = jax.jit(RL.mla_apply, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), rcfg, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), want, TOL)


@pytest.mark.parametrize("lens,s_max", [((5, 9), 16), ((15, 16), 16)])
def test_mla_decode_matches_the_reference(lens, s_max):
    """Ragged fills; a row at S_max (the second case) drops its write and
    attends to all S_max cached positions."""
    rcfg, params, port = _mla(1)
    rng = np.random.default_rng(2)
    b, r, dr = 2, MLA_CFG["kv_lora_rank"], MLA_CFG["d_rope"]
    x = rng.normal(size=(b, 1, 32)).astype(np.float32)
    ckv = rng.normal(size=(b, s_max, r)).astype(np.float32)
    krope = rng.normal(size=(b, s_max, dr)).astype(np.float32)
    clen = np.asarray(lens, np.int32)
    want = jax.jit(RL.mla_decode, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), rcfg, jnp.asarray(x),
        jnp.asarray(ckv), jnp.asarray(krope), jnp.asarray(clen))
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    got = port.decode(torch.from_numpy(x), tc, tk, torch.from_numpy(clen))
    _close(got[0], want[0], TOL, "out")
    _close(tc, want[1], TOL, "ckv")
    _close(tk, want[2], TOL, "krope")
    full = clen >= s_max
    np.testing.assert_array_equal(tc.numpy()[full], ckv[full])


# ---------------------------------------------------------------------------
# attention at MLA's widths, and the chunked plain version
# ---------------------------------------------------------------------------

# B, H, Hkv, S, Skv, D, Dv, causal
WIDE = [(1, 2, 2, 128, 128, 192, 128, True),
        (1, 2, 1, 128, 256, 192, 128, True),
        (1, 2, 2, 128, 128, 256, 256, False)]


def _attn_inputs(shape, seed=0):
    b, h, hkv, s, skv, d, dv, _ = shape
    rng = np.random.default_rng(seed + s + skv + d)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


@pytest.mark.parametrize("shape", WIDE)
def test_plain_attention_at_wide_heads_matches_pallas_interpret(shape):
    q, k, v = _attn_inputs(shape)
    want = rfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                               causal=shape[-1], blk_q=64, blk_kv=64,
                               interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=shape[-1], device="cpu")
    _close(got, want, TOL)


# past 2048² scores: causal S < Skv, ragged Skv (a part tile), GQA
CHUNKED = [(1, 2, 1, 64, 70_000, 16, 8, True),
           (1, 2, 2, 2100, 2100, 8, 8, False)]


@pytest.mark.parametrize("shape", CHUNKED)
def test_plain_attention_streams_above_the_references_switch(shape):
    """Above 2048² scores the port's plain version is ``chunked_attention``
    and matches the reference's plain path (its ``chunked_attention``)."""
    q, k, v = _attn_inputs(shape)
    assert q.shape[2] * k.shape[2] > ref.CHUNK_THRESHOLD ** 2
    want = rops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                causal=shape[-1], mode="ref")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=shape[-1], device="cpu")
    _close(got, want, TOL)
    assert torch.equal(got, ref.chunked_attention(tq, tk, tv,
                                                  causal=shape[-1]))
    _close(ref.mha_attention(tq, tk, tv, causal=shape[-1]),
           rref.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=shape[-1]), TOL)
