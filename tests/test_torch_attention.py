"""The port's attention == the reference's, on the CPU.

The same numpy inputs go to the port's plain ``mha_attention`` (what
``ops.flash_attention`` runs on CPU tensors) and to the reference's
Pallas ``flash_attention`` kernel in interpret mode (64 x 64 tiles) and
its plain ``mha_attention``.  Tolerance 1e-5 against both: scores and
softmax sums are float32 in every version, and only their summation
order differs (the interpret kernel's online softmax rescales per kv
tile, the plain versions normalise once).  The sweep is
``tests/test_kernels.py``'s (MHA, GQA, causal, non-causal, Dv != D)
plus causal with S < Skv (queries are the last S positions).  The
kernel itself is held to the plain version on the card
(``test_torch_kernels.py``, ``cuda_only``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as rfa
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

TOL = 1e-5
# B, H, Hkv, S, Skv, D, Dv, causal
SWEEP = [(1, 4, 4, 128, 128, 32, 32, True), (2, 8, 2, 256, 256, 64, 64, True),
         (1, 4, 1, 128, 128, 64, 64, False),
         (1, 4, 4, 128, 128, 32, 32, False),
         (1, 4, 4, 128, 128, 48, 32, True),   # MLA: Dv != D
         (2, 8, 2, 128, 256, 64, 64, True),   # S < Skv
         (1, 4, 2, 64, 192, 32, 32, False)]


def _inputs(shape):
    b, h, hkv, s, skv, d, dv, _ = shape
    rng = np.random.default_rng(s + skv + d + h)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


def _port(q, k, v, causal):
    return ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, device="cpu").numpy()


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_attention_matches_pallas_interpret(shape):
    q, k, v = _inputs(shape)
    want = rfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                               causal=shape[-1], blk_q=64, blk_kv=64,
                               interpret=True)
    np.testing.assert_allclose(_port(q, k, v, shape[-1]), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", SWEEP + [
    (1, 4, 2, 100, 200, 16, 16, True),       # ragged: ref math in repro
    (2, 3, 3, 33, 33, 8, 8, False)])
def test_plain_attention_matches_reference_ref(shape):
    q, k, v = _inputs(shape)
    want = rref.mha_attention(*map(jnp.asarray, (q, k, v)), causal=shape[-1])
    np.testing.assert_allclose(_port(q, k, v, shape[-1]), np.asarray(want),
                               rtol=0, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _inputs(SWEEP[1]))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, device="cpu")
    assert torch.equal(got, ref.mha_attention(q, k, v, causal=True))
    assert ops.flash_attention.launches == before


def test_kernel_mode_on_cpu_tensors_raises():
    q, k, v = map(torch.from_numpy, _inputs(SWEEP[0]))
    with pytest.raises(ValueError, match="kernel"):
        ops.flash_attention(q, k, v, mode="kernel", device="cpu")


@pytest.mark.parametrize("bad", ["heads", "causal_s_gt_skv", "dims"])
def test_shapes_the_kernel_cannot_take_are_refused(bad):
    q, k, v = map(torch.from_numpy, _inputs(SWEEP[0]))
    if bad == "heads":
        k, v = k[:, :3], v[:, :3]             # 3 kv heads for 4 heads
    elif bad == "causal_s_gt_skv":
        k, v = k[:, :, :64], v[:, :, :64]
    else:
        k = k[..., :16]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=True, device="cpu")
