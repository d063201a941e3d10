"""The kernels' plain versions and wrappers, and the CUDA kernels.

This file imports no JAX, so its ``cuda_only`` tests can run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_kernels.py``; the
repository's conftest imports JAX).  On integer-valued inputs every dot
product and ADC sum is exact, so a numpy brute force ordered by (value
desc, position asc) pins the plain versions, and the CUDA kernels must
equal the plain versions bit for bit: values, ids, ``sel`` and
positions, pads ``(-inf, -1, PAD_POS)`` included.  The IVF-PQ shapes
add code rows of 16-byte loads (m = 48) and of byte loads (m = 8, 4),
lists longer than one ADC block (Lmax > 512), fewer slots than k, and a
re-rank depth below its power-of-two padding.
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


# p, lmax, d, B, nprobe, k, m, n_codes, rerank
PQ_SHAPES = [(6, 10, 16, 3, 3, 4, 4, 16, 6),       # r 6 below r_pad 8
             (4, 3, 8, 2, 2, 8, 8, 256, 8),        # 6 slots for k = 8
             (9, 600, 32, 4, 2, 4, 48, 256, 64),   # two ADC blocks a list
             (300, 200, 32, 9, 64, 10, 48, 256, 64),
             (1000, 130, 8, 25, 64, 10, 8, 256, 20)]  # dense ties, m = 8
N_CORPUS = 200


def _pq_inputs(shape, dev="cpu"):
    """Integer LUTs, codes, queries, centroids and corpus rows over the
    ragged lists of ``_inputs`` (ids repeat: slot % 200), a partial
    ``own``."""
    p, lmax, d, b, nprobe, k, m, c, _ = shape
    q, cents, _, li, own = _inputs((p, lmax, d, b, nprobe, k))
    rng = np.random.default_rng(p * 10 + m)
    tables = rng.integers(-4, 5, size=(b, m, c)).astype(np.float32)
    codes = rng.integers(0, c, size=(p, lmax, m)).astype(np.uint8)
    corpus = rng.integers(-4, 5, size=(N_CORPUS, d)).astype(np.float32)
    return [x.to(dev) for x in (q, cents, torch.from_numpy(tables),
                                torch.from_numpy(codes), li,
                                torch.from_numpy(corpus), own)]


def _depth(shape):
    p, lmax, d, b, nprobe, k, m, c, rerank = shape
    return max(k, min(rerank, nprobe * lmax))


def _brute_pq(q, tables, codes, li, sel, own, corpus, k, r):
    """ADC top r (values, ids, flat positions) and the exact top k of
    those r (values, ids, ADC ranks), in int64, by sorting."""
    t, c = tables.numpy().astype(np.int64), codes.numpy().astype(np.int64)
    lin, b = li.numpy(), q.shape[0]
    lmax, m = c.shape[1], c.shape[2]
    adc = []
    for row in range(b):
        cc = c[sel[row]].reshape(-1, m)
        ids = lin[sel[row]].reshape(-1).copy()
        if own is not None:
            ids.reshape(-1, lmax)[own[row] == 0] = -1
        v = t[row, np.arange(m)[None], cc].sum(-1)
        pos = np.arange(len(ids))
        keep = ids >= 0
        o = np.lexsort((pos[keep], -v[keep]))[:r]
        n = len(o)
        adc.append((np.r_[v[keep][o], [0] * (r - n)].astype(np.float32),
                    np.r_[ids[keep][o], [-1] * (r - n)].astype(np.int32),
                    np.r_[pos[keep][o], [PAD_POS] * (r - n)].astype(np.int32),
                    n))
    av = np.stack([a[0] for a in adc])
    for row, a in enumerate(adc):
        av[row, a[3]:] = -np.inf
    ai = np.stack([a[1] for a in adc])
    ap = np.stack([a[2] for a in adc])
    qn, cn = q.numpy().astype(np.int64), corpus.numpy().astype(np.int64)
    ex = np.where(ai >= 0, np.einsum("brd,bd->br", cn[np.maximum(ai, 0)], qn),
                  0).astype(np.float64)
    ex[ai < 0] = -np.inf
    rank = np.stack([np.lexsort((np.arange(r), -e))[:k] for e in ex])
    return ((av, ai, ap), (np.take_along_axis(ex, rank, 1).astype(np.float32),
                           np.take_along_axis(ai, rank, 1),
                           rank.astype(np.int32)))


@pytest.mark.parametrize("shape", PQ_SHAPES)
def test_pq_plain_versions_match_brute_force(shape):
    nprobe, k = shape[4], shape[5]
    r = _depth(shape)
    q, cents, tables, codes, li, corpus, own = _pq_inputs(shape)
    sel = _brute_sel(q, cents, nprobe)
    (av, ai, ap), exact = _brute_pq(q, tables, codes, li, sel, None, corpus,
                                    k, r)
    v, i = ref.pq_adc_scan_batch(tables, codes, li, torch.from_numpy(sel), r)
    np.testing.assert_array_equal(v.numpy(), av)
    np.testing.assert_array_equal(i.numpy(), ai)
    v, i, s = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                nprobe=nprobe, k=k, r=r)
    np.testing.assert_array_equal(s.numpy(), sel)
    for g, w in zip((v, i), exact):
        np.testing.assert_array_equal(g.numpy(), w)
    (av, ai, ap), exact = _brute_pq(q, tables, codes, li, sel, own.numpy(),
                                    corpus, k, r)
    for rerank, want in ((False, (av, ai, ap)), (True, exact)):
        got = ref.fused_scan_pq(tables, q, codes, li, torch.from_numpy(sel),
                                own, corpus, k=k, r=r, rerank=rerank)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


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


def test_pq_wrapper_limits():
    """The ADC block's LUT and the PQ merge at the smoke's shapes fit;
    wider ones are refused before any launch."""
    assert tiling.pq_split(702) == 2 and tiling.pq_split(512) == 1
    tiling.check_merge(64 * tiling.pq_split(702), 64)   # the smoke's merge
    tiling.check_lut(48, 256)
    assert tiling.lut_bytes(48, 256) == 49_152
    with pytest.raises(ValueError, match="uint8"):
        tiling.check_lut(8, 512)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.check_lut(256, 256)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.check_merge(64 * tiling.pq_split(4096), 64)
    with pytest.raises(ValueError, match="at most 64"):
        tiling.check_pad("rerank depth", 100)


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


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", PQ_SHAPES)
def test_cuda_pq_kernels_equal_plain_versions(cuda_device, shape):
    nprobe, k, rerank = shape[4], shape[5], shape[8]
    r = _depth(shape)
    q, cents, tables, codes, li, corpus, own = _pq_inputs(shape, cuda_device)
    before = (ops.pq_adc_scan.launches, ops.fused_scan_pq.launches,
              ops.fused_turn_pq.launches)
    got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=k, rerank=rerank)
    want = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                             nprobe=nprobe, k=k, r=r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sel = want[2]
    got = ops.pq_adc_scan(tables, codes, li, sel, r)
    for g, w in zip(got, ref.pq_adc_scan_batch(tables, codes, li, sel, r)):
        assert torch.equal(g, w)
    for fuse in (True, False):
        got = ops.fused_scan_pq(tables, q, codes, li, sel, corpus, k,
                                rerank=rerank, own=own, fuse_rerank=fuse)
        want = ref.fused_scan_pq(tables, q, codes, li, sel, own, corpus,
                                 k=k, r=r, rerank=fuse)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (ops.pq_adc_scan.launches, ops.fused_scan_pq.launches,
            ops.fused_turn_pq.launches) == \
        (before[0] + 1, before[1] + 2, before[2] + 1)


@pytest.mark.cuda_only
def test_cuda_pq_empty_batch_launches_nothing(cuda_device):
    q, cents, tables, codes, li, corpus, _ = _pq_inputs(PQ_SHAPES[0],
                                                        cuda_device)
    before = (ops.pq_adc_scan.launches, ops.fused_scan_pq.launches,
              ops.fused_turn_pq.launches)
    sel = torch.zeros((0, 2), dtype=torch.int32, device=cuda_device)
    v, _ = ops.pq_adc_scan(tables[:0], codes, li, sel, 4)
    assert v.shape == (0, 4)
    v, _, _ = ops.fused_scan_pq(tables[:0], q[:0], codes, li, sel, corpus,
                                4, rerank=8)
    assert v.shape == (0, 4)
    v, _, s = ops.fused_turn_pq(q[:0], cents, tables[:0], codes, li, corpus,
                                nprobe=2, k=4, rerank=8)
    assert v.shape == (0, 4) and s.shape == (0, 2)
    assert (ops.pq_adc_scan.launches, ops.fused_scan_pq.launches,
            ops.fused_turn_pq.launches) == before
