"""The port's decode attention == the reference's, on the CPU.

``repro_torch.kernels.ref.decode_attention`` (the plain version of the
``flash_decode`` CUDA kernel, which ``ops.flash_decode`` runs on CPU
tensors) against the reference's ``repro.kernels.ref.decode_attention``
and against its Pallas ``flash_decode`` in interpret mode (where S is a
multiple of 128, its padding contract).  The same numpy inputs go to
both: GQA groups 1, 2, 5 and 8, ragged ``cache_len`` per row (1, S and
values between), ``cache_len > S`` (the reference's dropped write on a
full cache), and S not a multiple of 128 (the port takes any S).
float32 within 1e-5 (summation order); bfloat16 caches and queries
within one bfloat16 ulp of the output (the two round one float32 result
each).  The CUDA kernel is held to the same plain version on the card
(``tests/test_torch_kernels.py``, ``cuda_only``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as rfa
from repro.kernels import ref as rref
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-5
# B, H, Hkv, S, D
SHAPES = [(3, 4, 4, 256, 16),      # group 1 (MHA)
          (2, 4, 2, 128, 16),      # group 2
          (4, 10, 2, 256, 32),     # group 5 (qwen3-14b's)
          (4, 16, 2, 384, 64),     # group 8 (yi-9b's)
          (2, 8, 1, 100, 16)]      # S not a multiple of 128


def _inputs(shape, seed=0):
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(seed + s + h)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    lens = np.asarray([1, s + 1, s // 3 + 7, s][:b], np.int32)
    return q, k, v, lens


def _ulp_bf16(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_matches_reference_f32(shape):
    q, k, v, lens = _inputs(shape)
    want = np.asarray(rref.decode_attention(*map(jnp.asarray, (q, k, v)),
                                            jnp.asarray(lens)))
    got = tref.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the op on CPU tensors is the plain version
    op = tops.flash_decode(*map(torch.from_numpy, (q, k, v, lens)),
                           device="cpu")
    assert torch.equal(op, got)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] % 128 == 0])
def test_plain_decode_matches_pallas_interpret(shape):
    q, k, v, lens = _inputs(shape, seed=1)
    want = np.asarray(rfa.flash_decode(*map(jnp.asarray, (q, k, v)),
                                       jnp.asarray(lens), blk_kv=128,
                                       interpret=True))
    got = tref.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_matches_reference_bf16(shape):
    """bf16 query and cache (both packages round the same float32 inputs
    to the same bits): outputs in bf16 within one bf16 ulp."""
    q, k, v, lens = _inputs(shape, seed=2)
    want = rref.decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(lens))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = tref.decode_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _ulp_bf16(want)).all(), float(diff.max())


def test_cache_len_past_s_counts_as_s():
    q, k, v, _ = _inputs(SHAPES[3])
    s = k.shape[2]
    t = [torch.from_numpy(x) for x in (q, k, v)]
    full = tref.decode_attention(*t, torch.full((4,), s, dtype=torch.int32))
    past = tref.decode_attention(*t, torch.full((4,), s + 5,
                                                dtype=torch.int32))
    assert torch.equal(full, past)
    assert torch.equal(full, tref.decode_attention(*t))


def test_masked_positions_are_never_seen():
    """Whatever finite values lie past cache_len do not change the
    result (the plain version multiplies them by 0; the kernel never
    reads them)."""
    q, k, v, lens = _inputs(SHAPES[2])
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    k2, v2 = t[1].clone(), t[2].clone()
    for row, n in enumerate(lens):
        k2[row, :, n:] = 1e4
        v2[row, :, n:] = -1e4
    assert torch.equal(tref.decode_attention(*t),
                       tref.decode_attention(t[0], k2, v2, t[3]))


def test_kernel_mode_on_cpu_tensors_raises():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(SHAPES[0]))
    with pytest.raises(ValueError, match="kernel"):
        tops.flash_decode(q, k, v, lens, mode="kernel", device="cpu")


@pytest.mark.parametrize("bad", ["heads", "dims", "len", "empty_row"])
def test_shapes_the_kernel_cannot_take_are_refused(bad):
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(SHAPES[1]))
    if bad == "heads":
        q = q[:, :3]
    elif bad == "dims":
        q = q[..., :8]
    elif bad == "len":
        lens = lens[:1]
    else:
        lens = lens.clone()
        lens[1] = 0
    with pytest.raises(ValueError):
        tops.flash_decode(q, k, v, lens, device="cpu")


@pytest.mark.parametrize("s,split", [(1, (64, 1)), (100, (64, 2)),
                                     (1000, (64, 16)), (1024, (64, 16)),
                                     (8192, (128, 64)),
                                     (32_768, (512, 64)),
                                     (100_000, (512, 196))])
def test_decode_split_depends_on_s_alone(s, split):
    chunk, n = tfd.decode_split(s)
    assert (chunk, n) == split
    assert chunk * n >= s > chunk * (n - 1)
