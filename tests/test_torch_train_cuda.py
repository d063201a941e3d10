"""The kernels' autograd Functions on the card at the shapes training
gives them (``chip_smoke.py`` ``[train]``).

This file imports no JAX, so its ``cuda_only`` tests can run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_train_cuda.py``).
Each case runs the kernel path (``kernels.ops``: the CUDA forward, the
plain version's VJP backward) and the plain path (autograd through
``kernels.ref`` on the same CUDA tensors) and holds the outputs and every
gradient to each other within the forward's tolerance, a backward called
twice to the same bits, and the launch count to one a forward:

* row 8 at Dragon's training shape, (64, 12, 256, 64) float32,
  non-causal, and at BST's, (65,536, 8, 21, 4) float32 (the binding
  pads D to 4 floats' 16 bytes; the gradients keep D = 4);
* row 10 at the two-tower's, a (3,145,728, 256) float32 table (3.22 GB)
  and (32,768, 50) history bags with pads, mean aggregation: a dense
  table gradient, within 1e-5 x its largest |value| of autograd's
  through the plain bag (the sums run in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

ATTN_TOL = 1e-5
BAG_TOL = 1e-6      # the forward's, as in tests/test_torch_kernels.py
GRAD_TOL = 1e-5     # a gradient leaf, against its largest |value|


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _grads(fn, inputs, g):
    xs = [t.detach().clone().requires_grad_(t.is_floating_point())
          for t in inputs]
    out = fn(*xs)
    out.backward(g)
    return out.detach(), [x.grad for x in xs if x.requires_grad]


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", [(64, 12, 256, 64), (65_536, 8, 21, 4)],
                         ids=["dragon", "bst"])
def test_cuda_attention_function_at_the_train_shapes(cuda_device, shape):
    gen = torch.Generator(cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(shape, device=cuda_device, generator=gen)
                  for _ in range(4))
    before = ops.flash_attention.launches
    out, grads = _grads(lambda a, b, c: ops.flash_attention(
        a, b, c, causal=False), (q, k, v), g)
    assert ops.flash_attention.launches == before + 1
    p_out, p_grads = _grads(lambda a, b, c: ref.plain_attention(
        a, b, c, causal=False), (q, k, v), g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), [out] + grads,
                          [p_out] + p_grads):
        assert a.shape == b.shape == shape, name
        err = (a - b).abs().max().item()
        assert err <= ATTN_TOL * max(1.0, b.abs().max().item()), (name, err)
    again = _grads(lambda a, b, c: ops.flash_attention(
        a, b, c, causal=False), (q, k, v), g)[1]
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda_only
def test_cuda_bag_function_at_the_two_tower_shape(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(1)
    rows, d, b, l = 3_145_728, 256, 32_768, 50
    table = torch.randn(rows, d, device=cuda_device, generator=gen) * d ** -0.5
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, rows, (b, l)).astype(np.int32)
    ids[:, :3] = rng.integers(0, 64, (b, 3))     # hot rows many bags share
    ids = torch.from_numpy(ids).to(cuda_device)
    g = torch.randn(b, d, device=cuda_device, generator=gen)
    before = ops.embedding_bag.launches
    out, (d_table,) = _grads(lambda t, i: ops.embedding_bag(
        t, i, agg="mean"), (table, ids), g)
    assert ops.embedding_bag.launches == before + 1
    assert d_table.shape == table.shape
    again = _grads(lambda t, i: ops.embedding_bag(t, i, agg="mean"),
                   (table, ids), g)[1][0]
    assert torch.equal(d_table, again)
    p_out, (p_table,) = _grads(lambda t, i: ref.embedding_bag(
        t, i, mode="mean"), (table, ids), g)
    assert (out - p_out).abs().max().item() <= BAG_TOL
    assert (d_table - p_table).abs().max().item() <= GRAD_TOL * max(
        1.0, p_table.abs().max().item())
