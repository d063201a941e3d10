"""The fused kernels' plain versions and wrappers, and the CUDA kernels.

This file imports no JAX, so its ``cuda_only`` tests can run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_kernels.py``; the
repository's conftest imports JAX).  On integer-valued inputs every dot
product is exact, so a numpy brute force ordered by (value desc,
position asc) pins the plain versions, and the CUDA kernels must equal
the plain versions bit for bit: values, ids, ``sel`` and positions,
pads ``(-inf, -1, PAD_POS)`` included.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kmeans
from repro_torch.core.topk import topk
from repro_torch.kernels import ops, ref, tiling
from repro_torch.kernels.sorting import PAD_POS

SHAPES = [(6, 10, 16, 3, 3, 4),        # p, lmax, d, B, nprobe, k
          (5, 7, 8, 1, 5, 8),          # k > candidates available
          (9, 16, 32, 4, 2, 4),
          (300, 200, 32, 9, 64, 10),   # p, lmax not multiples of 128
          (1000, 130, 8, 25, 64, 10)]  # dense ties; B not a multiple of 8


def _inputs(shape, dev="cpu"):
    """Integer-valued ragged posting lists (list 0 empty, zero pads) and
    a partial ``own`` mask."""
    p, lmax, d, b, nprobe, _ = shape
    rng = np.random.default_rng(p * 100 + lmax)
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 5, size=(p, d)).astype(np.float32)
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    real = np.arange(lmax)[None] < sizes[:, None]
    li = np.where(real, np.arange(p * lmax).reshape(p, lmax) % 200, -1)
    lv[~real] = 0
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    own[0, 0] = 0
    return [torch.from_numpy(x).to(dev) for x in
            (q, cents, lv, li.astype(np.int32), own)]


def _brute_sel(q, cents, nprobe):
    s = q.double().numpy() @ cents.double().numpy().T
    return np.stack([np.lexsort((np.arange(len(r)), -r))[:nprobe]
                     for r in s]).astype(np.int32)


def _brute_scan(q, lv, li, sel, own, k):
    qn, lvn, lin = q.double().numpy(), lv.double().numpy(), li.numpy()
    out = []
    for b in range(qn.shape[0]):
        cand = []
        for j, lst in enumerate(sel[b]):
            if own is not None and own[b, j] == 0:
                continue
            for off in range(lvn.shape[1]):
                if lin[lst, off] >= 0:
                    cand.append((-(lvn[lst, off] @ qn[b]),
                                 j * lvn.shape[1] + off, lin[lst, off]))
        cand.sort()
        cand = cand[:k] + [(np.inf, PAD_POS, -1)] * (k - len(cand[:k]))
        out.append(cand)
    a = np.asarray(out, dtype=object)
    return (-a[..., 0].astype(np.float32), a[..., 2].astype(np.int32),
            a[..., 1].astype(np.int64).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_brute_force(shape):
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, own = _inputs(shape)
    v, i, sel = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k)
    want_sel = _brute_sel(q, cents, nprobe)
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    for got, want in zip((v, i), _brute_scan(q, lv, li, want_sel, None, k)):
        np.testing.assert_array_equal(got.numpy(), want)
    got = ref.fused_scan_ivf(q, lv, li, sel, own, k=k)
    for g, w in zip(got, _brute_scan(q, lv, li, want_sel, own.numpy(), k)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_wrapper_limits():
    """What the kernels do not take is refused before any launch."""
    assert tiling.check_pad("k", 10) == 16
    with pytest.raises(ValueError, match="at most 64"):
        tiling.check_pad("nprobe", 65)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.check_merge(64 * 200, 16)
    with pytest.raises(ValueError, match="float4"):
        tiling.check_width(6)
    tiling.check_merge(64 * tiling.scan_split(702), 16)   # the smoke's merge
    tiling.check_merge(tiling.centroid_chunks(16_384), 64)
    tiling.check_width(768)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_equal_plain_versions(cuda_device, shape):
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, own = _inputs(shape, cuda_device)
    before = (ops.fused_turn.launches, ops.fused_scan.launches)
    got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k)
    want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = ops.fused_scan(q, lv, li, want[2], k, own=own)
    for g, w in zip(got, ref.fused_scan_ivf(q, lv, li, want[2], own, k=k)):
        assert torch.equal(g, w)
    assert (ops.fused_turn.launches, ops.fused_scan.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda_only
def test_cuda_empty_batch_launches_nothing(cuda_device):
    q, cents, lv, li, _ = _inputs(SHAPES[0], cuda_device)
    before = ops.fused_scan.launches
    v, i, pos = ops.fused_scan(q[:0], lv, li,
                               torch.zeros((0, 2), dtype=torch.int32,
                                           device=cuda_device), 4)
    assert v.shape == (0, 4) and ops.fused_scan.launches == before


@pytest.mark.cuda_only
@pytest.mark.parametrize("k", [4, 64, 1024])
def test_cuda_topk_keeps_tie_order_at_build_chunk(cuda_device, k):
    """``core.topk`` on the card, at the index build's chunk shape
    (``kmeans.CHUNK`` points x 16,384 centroids, integer scores so ties
    are dense), keeps ``lax.top_k``'s order: sampled rows equal the CPU
    result."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    s = torch.randint(-3, 4, (kmeans.CHUNK, 16_384), generator=g,
                      device=cuda_device).float()
    v, i = topk(s, k)
    rows = torch.cat([torch.arange(128), torch.arange(kmeans.CHUNK - 128,
                                                      kmeans.CHUNK)])
    cv, ci = topk(s[rows.to(cuda_device)].cpu(), k)
    assert torch.equal(v[rows.to(cuda_device)].cpu(), cv)
    assert torch.equal(i[rows.to(cuda_device)].cpu(), ci)
