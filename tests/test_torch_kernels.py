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
re-rank depth below its power-of-two padding.  The bf16 and int8
precisions of the fused ops are held the same way: on these inputs bf16
rounds nothing and the int8 dots are exact, so kernel and plain version
agree bit for bit, at several int8 scale groups per list and per
centroid table, a candidate depth of 2,000 (r_pad 2,048) and a row
alone or in a batch.  Flash attention runs on
float inputs: its plain version is pinned to a float64 numpy softmax
and the kernel to the plain version, both within 1e-5 (summation
order), over MHA/GQA, causal with S == Skv and S < Skv, Dv != D, ragged
S and Skv, and the encoders' shapes.
"""
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import kmeans
from repro_torch.core.topk import topk
from repro_torch.kernels import _build, ops, ref, tiling
from repro_torch.kernels.flash_decode import flash_decode as \
    flash_decode_launch
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


# top-k past one merge block: the two-tower retrieval_cand shape (k 100,
# nprobe 32, Lmax 1220: two merge passes), 128-wide probes and top-k
# (nine groups), and a three-pass merge (22,912-row lists)
WIDE_SHAPES = [(64, 1220, 8, 2, 32, 100),
               (300, 1220, 8, 3, 128, 128),
               (128, 22_912, 4, 1, 128, 128)]
WIDE_PQ_SHAPES = [(64, 1220, 16, 2, 32, 100, 16, 256, 128),
                  (300, 1220, 16, 2, 128, 100, 16, 256, 128)]


def test_plain_versions_match_brute_force_past_one_block_merge():
    test_plain_versions_match_brute_force(WIDE_SHAPES[0])


def test_wrapper_limits():
    """What the kernels do not take is refused before any launch: top-k
    wider than 2,048 (ROADMAP Queue 3) and rows that are not float4."""
    assert tiling.check_pad("k", 10) == 16
    assert tiling.check_pad("k", 100) == 128
    assert tiling.check_pad("k", 1000) == 1024
    assert tiling.check_pad("k", 2000) == 2048
    assert tiling.check_pad("nprobe", 256) == 256
    with pytest.raises(ValueError, match="at most 2048"):
        tiling.check_pad("nprobe", 2049)
    with pytest.raises(ValueError, match="at most 2048"):
        tiling.merge_group(4096)
    assert tiling.merge_group(2048) == 9
    with pytest.raises(ValueError, match="float4"):
        tiling.check_width(6)
    # the smoke's merges take one pass
    assert tiling.merge_plan(64 * tiling.scan_split(702), 16) == [(384, 1)]
    assert len(tiling.merge_plan(tiling.centroid_chunks(16_384), 64)) == 1
    tiling.check_width(768)


def test_pq_wrapper_limits():
    """The ADC block's LUT and the PQ merge at the smoke's shapes fit;
    wider LUTs are refused before any launch, wider merges take groups."""
    assert tiling.pq_split(702) == 2 and tiling.pq_split(512) == 1
    assert tiling.merge_plan(64 * tiling.pq_split(702), 64) == [(128, 1)]
    tiling.check_lut(48, 256)
    assert tiling.lut_bytes(48, 256) == 49_152
    with pytest.raises(ValueError, match="uint8"):
        tiling.check_lut(8, 512)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.check_lut(256, 256)
    assert len(tiling.merge_plan(64 * tiling.pq_split(4096), 64)) == 2
    assert tiling.check_pad("rerank depth", 100) == 128
    assert tiling.check_pad("rerank depth", 1000) == 1024
    assert tiling.check_pad("rerank depth", 2000) == 2048
    with pytest.raises(ValueError, match="at most 2048"):
        tiling.check_pad("rerank depth", 2049)


@pytest.mark.parametrize("lmax,d,r_pad,want", [
    (702, 768, 32, (1024, 1)),      # the smoke: one group a list
    (702, 768, 2048, (2048, 1)),    # r_pad wider than the byte cap
    (1500, 1024, 32, (1024, 2)),    # byte-capped: two groups a list
    (1500, 1024, 2048, (2048, 1)),
    (10, 16, 8, (16, 1)), (10, 16, 2, (16, 1)), (5000, 8, 16, (2048, 4))])
def test_int8_list_groups(lmax, d, r_pad, want):
    """The reference's list tiles (``list_tile(lmax, 4 d, kp=r_pad,
    max_tile=2048)`` under a 4 MiB tile) as int8 scale groups."""
    assert tiling.list_groups(lmax, d, r_pad) == want


def test_int8_scale_is_one_ieee_divide():
    """The plain versions' int8 scale is 127 / max(amax, 1e-30) rounded
    once, as the kernels' ``__fdiv_rn`` and the reference's jnp divide
    round it (torch's ``127.0 / t`` multiplies by a reciprocal)."""
    amax = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-3, 10.0, 4096).astype(np.float32))
    amax[0] = 0.0
    want = np.float32(127.0) / np.maximum(amax.numpy(), np.float32(1e-30))
    np.testing.assert_array_equal(ref.int8_scale(amax).numpy(), want)
    _, scale = ref.quantize_sym(amax.reshape(64, 64), (1,))
    np.testing.assert_array_equal(
        scale[:, 0].numpy(),
        np.float32(127.0) / amax.reshape(64, 64).abs().amax(1).numpy())


@pytest.mark.parametrize("p,np_pad,want", [
    (16_384, 64, (512, 32)), (6, 4, (8, 1)), (1000, 64, (512, 2)),
    (600, 1024, (1024, 1)), (300, 2048, (2048, 1))])
def test_int8_centroid_groups(p, np_pad, want):
    assert tiling.centroid_groups(p, np_pad) == want


# the two-tower retrieval_cand shape through TopLoc_IVF
# (repro/configs/two_tower_retrieval.py:31-32, :194-198): k = 100,
# nprobe = 32, p = 1,024, lmax = (10^6 // 1024) * 5 // 4
CAND_LMAX = (1_000_000 // 1024) * 5 // 4


@pytest.mark.parametrize("k", [100, 64])
def test_merge_plan_at_the_retrieval_cand_shape(k):
    """The merge of 32 probes x 10 scan slices of top-k_pad lists does
    not fit one block (491,520 B at k 100, 245,760 B at k 64): the plan
    merges groups that fit, then the groups; every block fits."""
    assert CAND_LMAX == 1220
    n_lists, w = 32 * tiling.scan_split(CAND_LMAX), tiling.next_pow2(k)
    assert n_lists * w * tiling.MERGE_ENTRY_BYTES > tiling.SMEM_BLOCK_BYTES
    plan = tiling.merge_plan(n_lists, w)
    assert plan[0][0] == n_lists and plan[-1][1] == 1 and len(plan) == 2
    group = tiling.merge_group(w)
    for n, groups in plan:
        assert groups == -(-n // group)
        assert min(n, group) * w * tiling.MERGE_ENTRY_BYTES <= \
            tiling.SMEM_BLOCK_BYTES
    # stage 1 at p = 1,024: 8 chunks of top-32, one pass
    assert tiling.merge_plan(tiling.centroid_chunks(1024), 32) == [(8, 1)]


def test_merge_plan_passes_until_one_group():
    group = tiling.merge_group(128)
    assert group == 151
    assert tiling.merge_plan(1, 128) == [(1, 1)]
    assert tiling.merge_plan(group, 128) == [(group, 1)]
    assert tiling.merge_plan(group + 1, 128) == [(group + 1, 2), (2, 1)]
    assert tiling.merge_plan(group * group + 1, 128) == \
        [(group * group + 1, group + 1), (group + 1, 2), (2, 1)]


def test_merge_plan_at_width_1024():
    """Lists of 1,024 (k = 1,000) go 18 a block: 232,448 // 12,288; the
    smoke's k = 1,000 scan (64 probes x 6 slices) takes three passes."""
    assert tiling.merge_group(1024) == 18
    assert 18 * 1024 * tiling.MERGE_ENTRY_BYTES <= tiling.SMEM_BLOCK_BYTES
    assert tiling.merge_plan(64 * tiling.scan_split(702), 1024) == \
        [(384, 22), (22, 2), (2, 1)]
    # stage 1 at p = 16,384 and nprobe 256: 128 chunks of 256, one group
    assert tiling.merge_group(256) == 75
    assert tiling.merge_plan(tiling.centroid_chunks(16_384), 256) == \
        [(128, 2), (2, 1)]


def test_merge_plan_at_width_2048():
    """Lists of 2,048 (r = k·over = 2,000 at k = 1,000) go 9 a block; the
    smoke's quantised k = 1,000 scan (64 probes x 6 slices) takes three
    passes."""
    assert tiling.merge_group(2048) == 9
    assert 9 * 2048 * tiling.MERGE_ENTRY_BYTES <= tiling.SMEM_BLOCK_BYTES
    assert tiling.merge_plan(64 * tiling.scan_split(702), 2048) == \
        [(384, 43), (43, 5), (5, 1)]


# k = 1,000 and nprobe = 256 / a re-rank depth of 1,000: each block keeps
# its best 128 (scan, stage 1) or 512 (ADC) and pads the rest of its list
THOUSAND_SHAPES = [(300, 200, 8, 2, 64, 1000),
                   (600, 40, 8, 2, 256, 1000)]
THOUSAND_PQ_SHAPES = [(600, 40, 16, 2, 256, 100, 16, 256, 1000),
                      (64, 1220, 16, 1, 8, 1000, 16, 256, 1000)]


@pytest.mark.parametrize("shape", THOUSAND_SHAPES)
def test_plain_versions_match_brute_force_at_k_1000(shape):
    test_plain_versions_match_brute_force(shape)


@pytest.mark.parametrize("shape", THOUSAND_PQ_SHAPES)
def test_pq_plain_versions_match_brute_force_at_depth_1000(shape):
    test_pq_plain_versions_match_brute_force(shape)


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
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_cuda_kernels_equal_plain_versions_past_one_block_merge(
        cuda_device, shape):
    """k up to 128 and merges that take groups (``tiling.merge_plan``):
    bit-equal to the plain versions, as a one-block merge is."""
    assert len(tiling.merge_plan(shape[4] * tiling.scan_split(shape[1]),
                                 tiling.next_pow2(shape[5]))) >= 2
    test_cuda_kernels_equal_plain_versions(cuda_device, shape)


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
@pytest.mark.parametrize("shape", WIDE_PQ_SHAPES)
def test_cuda_pq_kernels_equal_plain_versions_at_depth_128(cuda_device,
                                                           shape):
    """A re-rank depth of 128 (r_pad 128), one and three merge groups."""
    test_cuda_pq_kernels_equal_plain_versions(cuda_device, shape)


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", THOUSAND_SHAPES)
def test_cuda_kernels_equal_plain_versions_at_k_1000(cuda_device, shape):
    """k = 1,000 (r_pad 1,024, merges of 18 lists a block) and nprobe =
    256 (np_pad 256): bit-equal to the plain versions."""
    test_cuda_kernels_equal_plain_versions(cuda_device, shape)


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", THOUSAND_PQ_SHAPES)
def test_cuda_pq_kernels_equal_plain_versions_at_depth_1000(cuda_device,
                                                            shape):
    """nprobe = 256 and a re-rank depth of 1,000 (r_pad 1,024): the
    re-rank sorts 1,024 candidates in dynamic shared memory."""
    test_cuda_pq_kernels_equal_plain_versions(cuda_device, shape)


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


# ---------------------------------------------------------------------------
# bf16 / int8 fused ops: kernel == plain version on integer inputs
# ---------------------------------------------------------------------------

QUANT = ("bf16", "int8")
# several int8 groups a list (d = 1,024, Lmax > 1,024), then r = 2,000
# (r_pad 2,048) wider than the byte-capped group of 1,024 rows
GROUP_SHAPES = [(8, 1100, 1024, 2, 3, 4), (8, 1100, 1024, 2, 3, 1000)]


def _ivf_quant(q, cents, lv, li, own, nprobe, k, precision):
    """(kernel, plain) results of fused_turn and of fused_scan (own
    mask) at ``precision``."""
    r = ops._fused_depth(k, nprobe * lv.shape[1], 2 * k)
    got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k,
                         precision=precision)
    want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k,
                              precision=precision, r=r)
    sel = want[2]
    got_s = ops.fused_scan(q, lv, li, sel, k, own=own, precision=precision)
    want_s = ref.fused_scan_ivf(q, lv, li, sel, own, k=k,
                                precision=precision, r=r)
    return (got, got_s), (want, want_s)


BF16_STEP = 2.0 ** -9


def _bf16_split(tensors, seed):
    """Integer tensors (|x| <= 4) with BF16_STEP added to the magnitude
    of about half their nonzero entries: bf16 rounds each back to its
    integer and float32 keeps it, so bf16 and float32 scores order rows
    differently, while float32 sums against integer queries stay exact
    (multiples of 2^-9 below 2^15 at d <= 1,024; ADC sums of m <= 48)."""
    rng = np.random.default_rng(seed)
    return [t + t.sign() * BF16_STEP * torch.from_numpy(
        rng.integers(0, 2, size=tuple(t.shape)).astype(np.float32)).to(
            t.device) for t in tensors]


def _split_inputs(shape, dev="cpu"):
    q, cents, lv, li, own = _inputs(shape, dev)
    cents, lv = _bf16_split((cents, lv), shape[0])
    return q, cents, lv, li, own


def _split_pq_inputs(shape, dev="cpu"):
    q, cents, tables, codes, li, corpus, own = _pq_inputs(shape, dev)
    cents, tables, corpus = _bf16_split((cents, tables, corpus), shape[0])
    return q, cents, tables, codes, li, corpus, own


SPLIT_SHAPES = [SHAPES[3], SHAPES[4], THOUSAND_SHAPES[0]]
SPLIT_PQ_SHAPES = [PQ_SHAPES[2], PQ_SHAPES[3], PQ_SHAPES[4]]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_bf16_split_inputs_expose_unrounded_list_scoring(shape,
                                                         monkeypatch):
    """On ``_bf16_split`` lists the bf16 scan's candidate ranks differ
    from those of a scan that skips bf16's rounding of the rows (the
    plain version with its list scoring patched to float32), so the
    kernels' bit-equality on these inputs holds the rounding; its f32
    re-rank is exact (float64 agrees)."""
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, own = _split_inputs(shape)
    r = ops._fused_depth(k, nprobe * shape[1], 2 * k)
    sel = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k,
                             precision="bf16", r=r)[2]
    v, ids, rank = ref.fused_scan_ivf(q, lv, li, sel, own, k=k,
                                      precision="bf16", r=r)
    # the same scan with its re-rank in float64
    exact = ref.fused_scan_ivf(q.double(), lv.double(), li, sel, own, k=k,
                               precision="bf16", r=r)
    assert torch.equal(v.double(), exact[0]) and torch.equal(ids, exact[1])
    plain = ref.list_scores
    monkeypatch.setattr(ref, "list_scores", lambda q_, lv_, sel_, p_, r_:
                        plain(q_, lv_, sel_, "f32", r_))
    assert not torch.equal(rank, ref.fused_scan_ivf(
        q, lv, li, sel, own, k=k, precision="bf16", r=r)[2])


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_bf16_split_inputs_expose_unrounded_centroid_scoring(shape,
                                                             monkeypatch):
    """The same for stage 1: a centroid scoring that skips bf16's
    rounding probes other lists than the bf16 one."""
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, _ = _split_inputs(shape)
    r = ops._fused_depth(k, nprobe * shape[1], 2 * k)
    sel = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k,
                             precision="bf16", r=r)[2]
    plain = ref.centroid_scores
    monkeypatch.setattr(ref, "centroid_scores", lambda q_, c_, p_, n_:
                        plain(q_, c_, "f32", n_))
    assert not torch.equal(sel, ref.fused_turn_ivf(
        q, cents, lv, li, nprobe=nprobe, k=k, precision="bf16", r=r)[2])


@pytest.mark.parametrize("shape", SPLIT_PQ_SHAPES)
def test_bf16_split_inputs_expose_unrounded_adc(shape, monkeypatch):
    """The same for the ADC: LUTs left unrounded give another ADC top r
    (ids or flat positions) than bf16 LUTs."""
    nprobe, k, rerank = shape[4], shape[5], shape[8]
    q, cents, tables, codes, li, corpus, own = _split_pq_inputs(shape)
    sel = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=k, r=_depth(shape),
                            precision="bf16")[2]

    def adc_top_r():
        return ref.fused_scan_pq(tables, q, codes, li, sel, own, corpus,
                                 k=k, r=_depth(shape), rerank=False,
                                 precision="bf16")
    want = adc_top_r()
    plain = ref.adc_tables
    monkeypatch.setattr(ref, "adc_tables", lambda t_, p_: plain(t_, "f32"))
    got = adc_top_r()
    assert not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


QUANT_INPUTS = {"integer": (_inputs, _pq_inputs),
                "bf16_split": (_split_inputs, _split_pq_inputs)}


@pytest.mark.cuda_only
@pytest.mark.parametrize("inputs", QUANT_INPUTS)
@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("shape", SHAPES + THOUSAND_SHAPES + GROUP_SHAPES)
def test_cuda_quantised_kernels_equal_plain_versions(cuda_device, shape,
                                                     precision, inputs):
    """fused_turn and fused_scan at bf16 / int8: the quantised stage 1
    (two centroid groups at p = 1,000), the list groups' amax pass, the
    quantised top r = k·over and the float32 re-rank inside the kernel,
    bit-equal (values, ids, sel, candidate ranks), on integer inputs and
    on ``_bf16_split`` ones, where bf16 and float32 order candidates
    differently."""
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, own = QUANT_INPUTS[inputs][0](shape, cuda_device)
    before = (ops.fused_turn.launches, ops.fused_scan.launches)
    got, want = _ivf_quant(q, cents, lv, li, own, nprobe, k, precision)
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert torch.equal(g, w)
    assert (ops.fused_turn.launches, ops.fused_scan.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda_only
@pytest.mark.parametrize("inputs", QUANT_INPUTS)
@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("shape", PQ_SHAPES + THOUSAND_PQ_SHAPES)
def test_cuda_quantised_pq_kernels_equal_plain_versions(cuda_device, shape,
                                                        precision, inputs):
    """fused_turn_pq and fused_scan_pq (with and without the re-rank) at
    bf16 / int8 LUTs and a quantised stage 1, bit-equal, on integer and
    on ``_bf16_split`` inputs."""
    nprobe, k, rerank = shape[4], shape[5], shape[8]
    r = _depth(shape)
    q, cents, tables, codes, li, corpus, own = QUANT_INPUTS[inputs][1](
        shape, cuda_device)
    got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=k, rerank=rerank,
                            precision=precision)
    want = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                             nprobe=nprobe, k=k, r=r, precision=precision)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for fuse in (True, False):
        got = ops.fused_scan_pq(tables, q, codes, li, want[2], corpus, k,
                                rerank=rerank, own=own, fuse_rerank=fuse,
                                precision=precision)
        plain = ref.fused_scan_pq(tables, q, codes, li, want[2], own, corpus,
                                  k=k, r=r, rerank=fuse, precision=precision)
        for g, w in zip(got, plain):
            assert torch.equal(g, w)


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
def test_cuda_fused_rows_do_not_depend_on_the_batch(cuda_device, precision):
    """A query's results are the same bits alone (B = 1) and in a batch
    of 8, on float inputs: every group scale and every sum is fixed by
    the query and the index, not by the launch."""
    shape = (1000, 130, 32, 8, 64, 10)
    g = torch.Generator().manual_seed(8)
    q, cents, lv = (torch.randn(s, generator=g).to(cuda_device) for s in
                    ((8, 32), (1000, 32), (1000, 130, 32)))
    _, _, _, li, _ = _inputs(shape, cuda_device)
    lv = lv * (li >= 0)[..., None]
    tables = torch.randn((8, 8, 256), generator=g).to(cuda_device)
    codes = torch.randint(0, 256, (1000, 130, 8), generator=g,
                          dtype=torch.uint8).to(cuda_device)
    corpus = torch.randn((200, 32), generator=g).to(cuda_device)

    def run(rows):
        v, i, s = ops.fused_turn(q[rows], cents, lv, li, nprobe=64, k=10,
                                 precision=precision)
        out = [v, i, s, *ops.fused_scan(q[rows], lv, li, s, 10,
                                        precision=precision)]
        out += ops.fused_turn_pq(q[rows], cents, tables[rows], codes, li,
                                 corpus, nprobe=64, k=10, rerank=64,
                                 precision=precision)
        return out

    full = run(slice(0, 8))
    for row in range(8):
        for a, b in zip(run(slice(row, row + 1)), full):
            assert torch.equal(a[0], b[row])


# the order of ranks_before (csrc/topk_tie.cuh) on given values: no fused
# kernel can emit -0.0 (every sum starts at +0.0, as the reference's
# do), so a small harness sorts and merges rows of +-0 on the card
TIE_HARNESS = r"""
#include "topk_tie.cuh"
__global__ void tie_kernel(float* v, int* id, int* pos, int n, int lists) {
  __shared__ float sv[64];
  __shared__ int si[64];
  __shared__ int sp[64];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v[t]; si[t] = id[t]; sp[t] = pos[t];
  }
  if (lists == 1) {
    topk_tie::block_sort(sv, si, sp, n);
  } else {
    __syncthreads();
    topk_tie::merge_lists(sv, si, sp, lists, n / lists);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    v[t] = sv[t]; id[t] = si[t]; pos[t] = sp[t];
  }
}
extern "C" int tie_order(float* v, int* id, int* pos, int n, int lists) {
  tie_kernel<<<1, 64>>>(v, id, pos, n, lists);
  return (int)cudaDeviceSynchronize();
}
"""


def tie_harness(tmp_dir):
    """Builds the harness beside the kernels' headers; its ``tie_order``."""
    src = tmp_dir / "tie_harness.cu"
    src.write_text(TIE_HARNESS)
    so = tmp_dir / "libtie.so"
    subprocess.run([_build.nvcc(), *_build.ARCH, "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), "-o",
                    str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).tie_order
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn


SIGNED_ZEROS = [-0.0, 0.0, -0.0, 0.0, 1.0, -1.0]


@pytest.mark.cuda_only
def test_cuda_signed_zero_order(cuda_device, tmp_path):
    """+0.0 ranks above -0.0, as in lax.top_k ([-0, +0, -0, +0, 1, -1]
    -> ids [4, 1, 3, 0]): ``core.topk`` on the card, and ``ranks_before``
    in the bitonic sort and in the list merge."""
    x = torch.tensor(SIGNED_ZEROS, device=cuda_device)
    assert topk(x, 4)[1].tolist() == [4, 1, 3, 0]
    assert topk(x[None].repeat(3, 1), 6)[1][2].tolist() == [4, 1, 3, 0, 2, 5]
    fn = tie_harness(tmp_path)
    want = [4, 1, 3, 0, 2, 5]
    for lists, order in ((1, list(range(6))), (2, [4, 1, 3, 0, 2, 5])):
        # merge: two sorted lists of 32, the second holding +-0 too
        v = torch.full((64,), float("-inf"), device=cuda_device)
        pos = torch.full((64,), PAD_POS, dtype=torch.int32,
                         device=cuda_device)
        vals = torch.tensor(SIGNED_ZEROS)[order]
        if lists == 1:
            v[:6] = vals.to(cuda_device)
            pos[:6] = torch.tensor(order, dtype=torch.int32)
        else:   # list 0: ids 4, 1, 0; list 1: ids 3, 2, 5 (each sorted)
            for base, ids in ((0, [4, 1, 0]), (32, [3, 2, 5])):
                v[base:base + 3] = torch.tensor(SIGNED_ZEROS)[ids].to(
                    cuda_device)
                pos[base:base + 3] = torch.tensor(ids, dtype=torch.int32)
        ids = pos.clone()
        assert fn(v.data_ptr(), ids.data_ptr(), pos.data_ptr(), 64,
                  lists) == 0
        assert pos[:6].tolist() == want
        assert [math_sign(x) for x in v[:6].tolist()] == \
            [1, 1, 1, -1, -1, -1]


def math_sign(x):
    return -1 if str(x).startswith("-") else 1


# ---------------------------------------------------------------------------
# flash attention: float inputs, held within ATTN_TOL (summation order)
# ---------------------------------------------------------------------------

ATTN_TOL = 1e-5
# B, H, Hkv, S, Skv, D, Dv, causal
ATTN_SHAPES = [(1, 4, 4, 128, 128, 32, 32, True),
               (2, 8, 2, 256, 256, 64, 64, True),     # GQA
               (1, 4, 1, 128, 128, 64, 64, False),
               (1, 4, 4, 128, 128, 48, 32, True),     # Dv != D (MLA)
               (2, 8, 2, 64, 192, 64, 64, True),      # S < Skv, bottom-right
               (1, 4, 2, 100, 200, 64, 64, False),    # ragged S and Skv
               (1, 4, 2, 100, 200, 64, 64, True),
               (3, 2, 1, 7, 300, 16, 8, False),       # tails of both tiles
               (1, 2, 2, 16, 16, 128, 128, False),    # widest head
               (1, 12, 12, 256, 256, 64, 64, False),  # dragon, one query
               (1, 16, 16, 256, 256, 64, 64, False)]  # snowflake


def _attn_inputs(shape, dev="cpu"):
    b, h, hkv, s, skv, d, dv, _ = shape
    rng = np.random.default_rng(s * 1000 + skv + d)
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dev)
            for sh in ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


def _attn_float64(q, k, v, causal):
    """Softmax attention in float64 numpy, GQA by head // (H / Hkv),
    causal bottom-right."""
    q, k, v = (x.double().numpy() for x in (q, k, v))
    b, h, s, d = q.shape
    skv = k.shape[2]
    kk = np.repeat(k, h // k.shape[1], axis=1)
    vv = np.repeat(v, h // v.shape[1], axis=1)
    logits = np.einsum("bhsd,bhtd->bhst", q, kk) / np.sqrt(d)
    if causal:
        mask = (np.arange(s)[:, None] + skv - s) < np.arange(skv)[None]
        logits = np.where(mask, -np.inf, logits)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhst,bhtd->bhsd", p / p.sum(-1, keepdims=True), vv)


@pytest.mark.parametrize("shape", ATTN_SHAPES[:9])
def test_plain_attention_matches_float64(shape):
    q, k, v = _attn_inputs(shape)
    got = ops.flash_attention(q, k, v, causal=shape[-1], device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               _attn_float64(q, k, v, shape[-1]),
                               rtol=0, atol=ATTN_TOL)


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_cuda_flash_attention_equals_plain_version(cuda_device, shape):
    q, k, v = _attn_inputs(shape, cuda_device)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape[-1])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.mha_attention(q, k, v, causal=shape[-1])
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ATTN_TOL


@pytest.mark.cuda_only
def test_cuda_flash_attention_refuses_grad_and_empty_launches_nothing(
        cuda_device):
    q, k, v = _attn_inputs(ATTN_SHAPES[0], cuda_device)
    before = ops.flash_attention.launches
    assert ops.flash_attention(q[:0], k[:0], v[:0]).shape == (0, 4, 128, 32)
    assert ops.flash_attention.launches == before
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

# V, d, B, L: the two-tower user history (d 256, L 50) at B = 1 and 512,
# bags longer than one 32-id chunk, the smoke config's d = 16, a width
# that takes the scalar path (d = 6)
BAG_SHAPES = [(1000, 256, 1, 50), (1000, 256, 512, 50), (300, 16, 9, 70),
              (50, 6, 5, 3)]


def _bag_inputs(shape, integer, dev="cpu"):
    """Ids in [-1, V) with pads, the last row V - 1 in every bag but the
    all-pad bag 0, and weights; integer-valued table and weights, or
    floats at the two-tower table's scale (normal x d^-1/2) and normal
    weights."""
    v, d, b, bag = shape
    rng = np.random.default_rng(v + d + b + bag)
    if integer:
        table = rng.integers(-4, 5, size=(v, d)).astype(np.float32)
        w = rng.integers(-3, 4, size=(b, bag)).astype(np.float32)
    else:
        table = (rng.normal(size=(v, d)) * d ** -0.5).astype(np.float32)
        w = rng.normal(size=(b, bag)).astype(np.float32)
    ids = rng.integers(-1, v, size=(b, bag)).astype(np.int32)
    ids[:, -1] = v - 1
    ids[0] = -1
    return [torch.from_numpy(x).to(dev) for x in (table, ids, w)]


@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_embedding_bag_matches_float64(agg, weighted):
    """The plain version against a float64 numpy sum, within the error
    bound of a float32 sum in bag order (L x 2^-24 x the sum of |row x
    w| per element), and its sum bit for bit against a float32 numpy
    loop in bag order."""
    table, ids, w = _bag_inputs(BAG_SHAPES[2], integer=False)
    got = ref.embedding_bag(table, ids, w if weighted else None, mode=agg)
    tn, idn = table.numpy(), ids.numpy()
    wn = (idn >= 0) * (w.numpy() if weighted else 1.0)
    rows = tn[np.maximum(idn, 0)].astype(np.float64)
    want = np.einsum("bld,bl->bd", rows, wn)
    bound = ids.shape[1] * 2.0 ** -24 * np.einsum("bld,bl->bd",
                                                  np.abs(rows), np.abs(wn))
    if agg == "mean":
        den = np.maximum(wn.sum(-1, keepdims=True), 1)
        want, bound = want / den, bound / den + 2.0 ** -24 * np.abs(want)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert not got[0].any()                       # the all-pad bag
    if agg == "sum":
        acc = np.zeros((ids.shape[0], tn.shape[1]), np.float32)
        for col in range(ids.shape[1]):
            acc = acc + tn[np.maximum(idn[:, col], 0)] * \
                wn[:, col, None].astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), acc)


@pytest.mark.cuda_only
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", BAG_SHAPES)
def test_cuda_embedding_bag_equals_plain_version(cuda_device, shape,
                                                  integer):
    """Bit-equal on every input: both sum in bag order, one rounding
    after each product and each sum."""
    table, ids, w = _bag_inputs(shape, integer, cuda_device)
    for weights in (None, w):
        for agg in ("sum", "mean"):
            before = ops.embedding_bag.launches
            got = ops.embedding_bag(table, ids, weights, agg=agg)
            assert ops.embedding_bag.launches == before + 1
            want = ref.embedding_bag(table, ids, weights, mode=agg)
            assert torch.equal(got, want)
    assert not got[0].any()


@pytest.mark.cuda_only
def test_cuda_embedding_bag_refuses_grad_and_empty_launches_nothing(
        cuda_device):
    table, ids, w = _bag_inputs(BAG_SHAPES[0], True, cuda_device)
    before = ops.embedding_bag.launches
    assert ops.embedding_bag(table, ids[:0]).shape == (0, 256)
    assert ops.embedding_bag.launches == before
    with pytest.raises(NotImplementedError, match="backward"):
        ops.embedding_bag(table.requires_grad_(), ids)
    with torch.no_grad():
        ops.embedding_bag(table, ids)


# ---------------------------------------------------------------------------
# flash decode: one query token per row against a KV cache
# ---------------------------------------------------------------------------

# B, H, Hkv, S, D: GQA groups 1, 5 and 8; S not a multiple of 128, 1,024
# and 32,768 (decode_32k); B = 1 and 8
DECODE_SHAPES = [(1, 4, 4, 1000, 64), (8, 40, 8, 1000, 128),
                 (1, 32, 4, 1024, 128), (8, 32, 4, 1024, 128),
                 (8, 32, 4, 32_768, 128), (2, 10, 2, 300, 16)]


def _decode_inputs(shape, dtype, dev="cpu"):
    """q (B, H, D) float32, the cache in ``dtype``, and cache_len per row
    cycling through 1, S, S + 1 (a full cache's dropped write) and values
    between."""
    b, h, hkv, s, d = shape
    g = torch.Generator().manual_seed(s + h + b)
    q = torch.randn((b, h, d), generator=g)
    k, v = (torch.randn((b, hkv, s, d), generator=g).to(dtype)
            for _ in range(2))
    lens = torch.tensor([1, s, s + 1, s // 2 + 3, s - 1, 17, s // 3,
                         s - 100][:b], dtype=torch.int32)
    return [x.to(dev) for x in (q, k, v, lens.clamp_min(1))]


def _decode_float64(q, k, v, lens):
    q, k, v = (x.double().numpy() for x in (q, k, v))
    b, h, d = q.shape
    out = np.zeros_like(q)
    for row in range(b):
        n = min(int(lens[row]), k.shape[2])
        for head in range(h):
            kv = head // (h // k.shape[1])
            s = k[row, kv, :n] @ q[row, head] / np.sqrt(d)
            p = np.exp(s - s.max())
            out[row, head] = p @ v[row, kv, :n] / p.sum()
    return out


@pytest.mark.parametrize("shape", [DECODE_SHAPES[i] for i in (0, 1, 5)])
def test_plain_decode_matches_float64(shape):
    q, k, v, lens = _decode_inputs(shape, torch.float32)
    got = ref.decode_attention(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), _decode_float64(q, k, v, lens),
                               rtol=0, atol=ATTN_TOL)


def _bf16_row_ulp(x):
    """One bfloat16 ulp at the largest |x| of each (b, h) row."""
    top = x.abs().amax(-1, keepdim=True).clamp_min(
        torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_cuda_flash_decode_equals_plain_version(cuda_device, shape, dtype):
    """The kernel's float32 result within 1e-5 of the plain version's,
    on a float32 or a bfloat16 cache; with a bf16 query the op's bf16
    output within one bf16 ulp of its row's largest |out| (each side
    rounds its own f32 result; an output near 0 is a cancellation, where
    the summation order moves more bits than one ulp of it)."""
    q, k, v, lens = _decode_inputs(shape, dtype, cuda_device)
    f32 = flash_decode_launch(q, k, v, lens)
    err = float((f32 - ref.decode_attention(q, k, v, lens)).abs().max())
    assert err <= ATTN_TOL
    q = q.to(dtype)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, k, v, lens)
    want = ref.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= ATTN_TOL
    else:
        assert bool((diff <= _bf16_row_ulp(want.float())).all())


@pytest.mark.cuda_only
def test_cuda_flash_decode_ignores_the_batch_and_unread_rows(cuda_device):
    """A row's output is the same bits alone or in a batch, and whatever
    lies past its cache_len is never read (NaN there changes nothing)."""
    q, k, v, lens = _decode_inputs(DECODE_SHAPES[3], torch.bfloat16,
                                   cuda_device)
    full = ops.flash_decode(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lens.tolist()):
        k2[row, :, n:] = float("nan")
        v2[row, :, n:] = float("nan")
    assert torch.equal(ops.flash_decode(q, k2, v2, lens), full)
    for row in (0, 5):
        one = ops.flash_decode(q[row:row + 1], k[row:row + 1].contiguous(),
                               v[row:row + 1].contiguous(),
                               lens[row:row + 1])
        assert torch.equal(one[0], full[row])


@pytest.mark.cuda_only
def test_cuda_flash_decode_refuses_grad_and_empty_launches_nothing(
        cuda_device):
    q, k, v, lens = _decode_inputs(DECODE_SHAPES[0], torch.float32,
                                   cuda_device)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q[:0], k[:0], v[:0], lens[:0])
    assert out.shape == (0, 4, 64) and ops.flash_decode.launches == before
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.flash_decode(q.requires_grad_(), k, v, lens)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_decode(q.detach()[..., :60].contiguous(),
                         k[..., :60].to(torch.bfloat16).contiguous(),
                         v[..., :60].to(torch.bfloat16).contiguous(), lens)
