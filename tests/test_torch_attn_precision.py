"""The tensor-core attention kernels' arithmetic, emulated in plain torch,
against the reference's Pallas kernels (interpret mode), on the CPU.

``csrc/flash_decode.cu`` (bf16 cache) and ``csrc/flash_attention.cu``
take their products on the tensor cores with narrow operands, which
carry float32 values as sums of terms (``csrc/attn_mma.cuh``):

* a bf16 query is one term, a float32 query three bf16 terms (hi + mid
  + lo, each rounded to nearest even); the cache is bf16 already;
* the softmax weights P are two bf16 terms (hi + lo);
* float32 attention takes every product in 3xTF32: x = hi + lo, hi
  rounded to nearest at tf32's 10 mantissa bits, lo = x - hi truncated
  to tf32 by the tensor core, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi;
* the scale 1 / sqrt(D) multiplies the f32 scores after the dot (the
  reference scales q first); the bf16 attention takes its softmax in
  base 2 (scores times log2(e)).

The emulations below repeat that arithmetic (products of the terms
summed in float32, the online softmax over the kernels' tiles and
splits) and are held to the reference's ``flash_decode`` and
``flash_attention`` in Pallas interpret mode on the same numpy inputs:
float32 results within 1e-5, bf16 outputs within one bf16 ulp of the
row's largest |out|, the gates the CUDA kernels meet on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).  The narrower
schemes (one bf16 term for P, one tf32 pass) are shown to miss the
float32 gate, so the test tells the schemes apart.  This runs before any
chip time: it shows the precision scheme fits the gates.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as rfa
from repro_torch.kernels.tiling import decode_split

TOL = 1e-5
LOG2E = 1.4426950408889634


def bf16_terms(x: torch.Tensor, n: int):
    """x as n bf16 terms, each the nearest-even bf16 of what is left."""
    out = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def tf32_split(x: torch.Tensor):
    """(hi, lo) of the 3xTF32 product: hi rounded to nearest (ties away)
    at 10 mantissa bits, lo = x - hi as the tensor core reads it
    (truncated to tf32)."""
    hi = ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def mm_terms(a_terms, b_terms):
    """sum over the given (a, b) term pairs of a @ b, in float32."""
    return sum(a @ b for a, b in zip(a_terms, b_terms))


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return mm_terms([al, ah, ah], [bh, bl, bh])


def bf16_ulp_of_row(x: np.ndarray) -> np.ndarray:
    top = np.maximum(np.abs(x).max(-1, keepdims=True),
                     np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(top)) - 7)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_emulated(q, k, v, lens, q_terms, p_terms=2):
    """decode_mma_kernel's arithmetic: per split of ``decode_split(S)``
    rows, per 16-row sub-tile of a warp (warp w takes sub-tiles w, w+4,
    ...), an online softmax whose P goes to the P V product as
    ``p_terms`` bf16 terms; the four warps folded in order, then the
    splits in order.  q (B, H, D) float32 carrying its ``q_terms`` bf16
    terms; k, v (B, Hkv, S, D) bf16 values in float32."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    chunk, nsplit = decode_split(s)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(b, h, d)
    for row in range(b):
        n_len = min(int(lens[row]), s)
        for kvh in range(hkv):
            qt = bf16_terms(q[row, kvh * group:(kvh + 1) * group], q_terms)
            parts = []
            for sp in range(-(-n_len // chunk)):
                start = sp * chunk
                n = min(chunk, n_len - start)
                warps = []
                for w in range(4):
                    m = torch.full((group, 1), -math.inf)
                    l = torch.zeros(group, 1)
                    acc = torch.zeros(group, d)
                    for r0 in range(16 * w, n, 64):
                        kk = k[row, kvh, start + r0:start + min(r0 + 16, n)]
                        vv = v[row, kvh, start + r0:start + min(r0 + 16, n)]
                        sc = mm_terms(qt, [kk.T] * len(qt)) * scale
                        m_new = torch.maximum(m, sc.max(-1, keepdim=True)[0])
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new)
                        l = l * alpha + p.sum(-1, keepdim=True)
                        acc = acc * alpha + mm_terms(
                            bf16_terms(p, p_terms), [vv] * p_terms)
                        m = m_new
                    warps.append((m, l, acc))
                mm = torch.stack([x[0] for x in warps]).max(0)[0]
                e = [torch.exp(x[0] - mm) for x in warps]
                parts.append((mm, sum(x[1] * ei for x, ei in zip(warps, e)),
                              sum(x[2] * ei for x, ei in zip(warps, e))))
            mm = torch.stack([x[0] for x in parts]).max(0)[0]
            e = [torch.exp(x[0] - mm) for x in parts]
            l = sum(x[1] * ei for x, ei in zip(parts, e))
            acc = sum(x[2] * ei for x, ei in zip(parts, e))
            out[row, kvh * group:(kvh + 1) * group] = acc / l
    return out


# B, H, Hkv, S, D: groups 8 (Yi-9B's), 1 and 5, S a multiple of 128 (the
# Pallas kernel's padding contract), several splits and sub-tiles
DECODE_SHAPES = [(3, 16, 2, 384, 64), (2, 4, 4, 256, 32),
                 (3, 10, 2, 1024, 16)]


def _decode_inputs(shape, seed):
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(seed + s + h)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in (k, v))
    lens = np.asarray([1, s, s + 1, s // 3 + 7][:b], np.int32)
    return q, k, v, lens


def _decode_reference(q, k, v, lens, dtype):
    out = rfa.flash_decode(jnp.asarray(q, dtype),
                           *(jnp.asarray(x, jnp.bfloat16) for x in (k, v)),
                           jnp.asarray(lens), blk_kv=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_f32_query_three_terms_holds_the_f32_gate(shape):
    """A float32 q on a bf16 cache: q as three bf16 terms, P as two,
    within 1e-5 of the Pallas kernel; P as one bf16 term is not."""
    q, k, v, lens = _decode_inputs(shape, 0)
    want = _decode_reference(q, k, v, lens, jnp.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = decode_emulated(*t, lens, q_terms=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    coarse = decode_emulated(*t, lens, q_terms=3, p_terms=1)
    assert float(np.abs(coarse.numpy() - want).max()) > TOL


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_bf16_query_holds_one_bf16_ulp(shape):
    """A bf16 q (one term) and bf16 output: within one bf16 ulp of the
    row's largest |out| of the Pallas kernel's bf16 output."""
    q, k, v, lens = _decode_inputs(shape, 1)
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    want = _decode_reference(q, k, v, lens, jnp.bfloat16)
    got = decode_emulated(*(torch.from_numpy(x) for x in (q, k, v)), lens,
                          q_terms=1).to(torch.bfloat16).float().numpy()
    assert (np.abs(got - want) <= bf16_ulp_of_row(want)).all()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def attention_emulated(q, k, v, causal, scheme):
    """flash_attention's arithmetic over 64-key tiles (online softmax per
    query row): ``scheme`` "bf16" (Q K^T of bf16 values, softmax in base
    2, P as two bf16 terms), "3xtf32" (every product in 3xTF32) or
    "tf32" (one tf32 pass, the scheme ruled out).  q (B, H, S, D), k, v
    (B, Hkv, Skv, D / Dv) float32."""
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(group, 1)
    vv = v.repeat_interleave(group, 1)
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, dv)
    qpos = torch.arange(s)[:, None] + skv - s
    for kv0 in range(0, skv, 64):
        kt, vt = kk[:, :, kv0:kv0 + 64], vv[:, :, kv0:kv0 + 64]
        if scheme == "bf16":
            sc = (q @ kt.transpose(-1, -2)) * (scale * LOG2E)
        elif scheme == "3xtf32":
            sc = mm_3xtf32(q, kt.transpose(-1, -2)) * scale
        else:
            sc = tf32_split(q)[0] @ tf32_split(kt.transpose(-1, -2))[0] \
                * scale
        if causal:
            kpos = torch.arange(kv0, kv0 + kt.shape[2])[None]
            sc = sc.masked_fill(qpos < kpos, -1e30)
        exp = torch.exp2 if scheme == "bf16" else torch.exp
        m_new = torch.maximum(m, sc.max(-1, keepdim=True)[0])
        alpha, p = exp(m - m_new), exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if scheme == "bf16":
            pv = mm_terms(bf16_terms(p, 2), [vt] * 2)
        elif scheme == "3xtf32":
            pv = mm_3xtf32(p, vt)
        else:
            pv = tf32_split(p)[0] @ tf32_split(vt)[0]
        acc = acc * alpha + pv
        m = m_new
    return acc / l.clamp_min(1e-30)


# B, H, Hkv, S, Skv, D, Dv, causal (tiles of 64: the Pallas padding
# contract); Dragon's head width, GQA, S < Skv, Dv != D
ATTN_SHAPES = [(1, 4, 4, 128, 128, 64, 64, False),
               (2, 8, 2, 128, 128, 64, 64, True),
               (1, 4, 2, 64, 192, 32, 32, True),
               (1, 4, 4, 128, 128, 48, 32, True),
               (1, 2, 1, 128, 128, 128, 128, True)]


def _attn_inputs(shape, seed):
    b, h, hkv, s, skv, d, dv, _ = shape
    rng = np.random.default_rng(seed + s + skv + d)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


def _attn_reference(q, k, v, causal, dtype):
    out = rfa.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                              causal=causal, blk_q=64, blk_kv=64,
                              interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_3xtf32_holds_the_f32_gate(shape):
    """float32 inputs in 3xTF32: within 1e-5 of the Pallas kernel; one
    tf32 pass is not."""
    q, k, v = _attn_inputs(shape, 0)
    want = _attn_reference(q, k, v, shape[-1], jnp.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = attention_emulated(*t, shape[-1], "3xtf32")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    coarse = attention_emulated(*t, shape[-1], "tf32")
    assert float(np.abs(coarse.numpy() - want).max()) > TOL


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_bf16_holds_one_bf16_ulp(shape):
    """bf16 inputs, P as two bf16 terms, softmax in base 2: the bf16
    output within one bf16 ulp of the row's largest |out| of the Pallas
    kernel's bf16 output."""
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in _attn_inputs(shape, 1))
    want = _attn_reference(q, k, v, shape[-1], jnp.bfloat16)
    got = attention_emulated(*(torch.from_numpy(x) for x in (q, k, v)),
                             shape[-1], "bf16")
    got = got.to(torch.bfloat16).float().numpy()
    assert (np.abs(got - want) <= bf16_ulp_of_row(want)).all()


def test_tf32_split_rounds_to_nearest_and_truncates_the_rest():
    """hi keeps 10 mantissa bits rounded to nearest (ties away), lo is
    the rest truncated to tf32: |x - hi - lo| <= 2^-21 |x|."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=10_000)
                          * np.exp2(rng.integers(-30, 30, 10_000))
                          ).astype(np.float32))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert bool(((t.view(torch.int32) & 8191) == 0).all())
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= x.abs().double() * 2.0 ** -21).all())
    assert torch.equal(sum(bf16_terms(x, 3)), x)
