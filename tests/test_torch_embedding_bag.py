"""The port's EmbeddingBag == the reference's, on the CPU.

The same numpy inputs go to the port's plain ``embedding_bag`` (what
``ops.embedding_bag`` runs on CPU tensors) and to the reference's plain
version (``repro.kernels.ref.embedding_bag``, an einsum) and its Pallas
kernel in interpret mode (``repro.kernels.ops.embedding_bag(...,
mode="interpret")``, which sums in bag order as the port does).  Bags
hold pads (-1), an all-pad bag and the last row V - 1; sum and mean,
weighted and unweighted.  Tolerance 1e-6: every version sums in float32
and only the einsum's order differs, on values of the two-tower table's
scale (normal x d^-1/2).  The CUDA kernel is held to the plain version
on the card (``test_torch_kernels.py``, ``cuda_only``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops, ref

TOL = 1e-6
# V, d, B, L (small B x L: the interpret kernel steps one row at a time)
SWEEP = [(100, 16, 4, 6), (500, 32, 3, 10), (64, 8, 5, 3)]


def _inputs(shape):
    v, d, b, bag = shape
    rng = np.random.default_rng(v + d + b + bag)
    table = (rng.normal(size=(v, d)) * d ** -0.5).astype(np.float32)
    ids = rng.integers(-1, v, size=(b, bag)).astype(np.int32)
    ids[:, -1] = v - 1
    ids[0] = -1
    w = rng.uniform(0.5, 2.0, size=(b, bag)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_embedding_bag_matches_reference(shape, weighted, agg):
    table, ids, w = _inputs(shape)
    w = w if weighted else None
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            None if w is None else torch.from_numpy(w),
                            agg=agg, device="cpu").numpy()
    want_ref = np.asarray(rref.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), mode=agg))
    want_kernel = np.asarray(rops.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), agg=agg, mode="interpret"))
    assert got.shape == want_ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=TOL)
    assert not got[0].any()                       # the all-pad bag
    # the plain version the op dispatched to, called directly
    np.testing.assert_array_equal(
        got, ref.embedding_bag(torch.from_numpy(table),
                               torch.from_numpy(ids),
                               None if w is None else torch.from_numpy(w),
                               mode=agg).numpy())


def test_mean_divides_by_the_weight_sum_floored_at_one():
    """``mean`` is sum / max(Σ mask·w, 1): an all-pad bag stays 0 and a
    bag of weight 0.5 is not scaled up."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[-1, -1], [1, -1], [2, 3]], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.0], [0.5, 1.0], [1.0, 3.0]])
    out = ops.embedding_bag(table, ids, w, agg="mean", device="cpu")
    torch.testing.assert_close(out[0], torch.zeros(3))
    torch.testing.assert_close(out[1], table[1] * 0.5)
    torch.testing.assert_close(out[2], (table[2] + 3 * table[3]) / 4)


def test_kernel_mode_on_cpu_tensors_raises():
    table, ids, _ = (torch.from_numpy(x) for x in _inputs(SWEEP[0]))
    with pytest.raises(ValueError, match="kernel"):
        ops.embedding_bag(table, ids, mode="kernel", device="cpu")
    with pytest.raises(ValueError, match="agg"):
        ops.embedding_bag(table, ids, agg="max", device="cpu")


def test_kernel_path_refuses_grad_before_any_launch(monkeypatch):
    """The CUDA kernel has no backward: on the kernel path, inputs that
    require grad are refused before the launcher is reached; without
    grad the launcher is reached (and, given CPU tensors, refuses
    them)."""
    monkeypatch.setattr(ops, "_mode", lambda mode, dev: "kernel")
    table, ids, w = (torch.from_numpy(x) for x in _inputs(SWEEP[0]))
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table.requires_grad_(), ids, device="cpu")
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table.detach(), ids, w.requires_grad_(),
                          device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        ops.embedding_bag(table.detach(), ids, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        ops.embedding_bag(table, ids, device="cpu")


def test_launcher_refuses_what_the_kernel_does_not_take():
    table, ids, w = (torch.from_numpy(x) for x in _inputs(SWEEP[0]))
    with pytest.raises(ValueError, match="CUDA tensor required"):
        teb.embedding_bag(table, ids, w)


def test_plain_version_keeps_the_table_dtype():
    table, ids, w = (torch.from_numpy(x) for x in _inputs(SWEEP[0]))
    out = ops.embedding_bag(table.double(), ids, w, device="cpu")
    assert out.dtype == torch.float64
