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
    """The ADC block's LUT and the PQ fold at the smoke's shapes fit;
    wider LUTs are refused before any launch, wider merges take groups."""
    assert tiling.pq_split(702) == 6 and tiling.pq_split(512) == 4
    # at the smoke's shape the ADC scan folds its 384 lists of 64 in its
    # launch, over the LUT's 49,152 B
    assert tiling.scan_fold(64, 702, 64)
    assert tiling.adc_smem(48, 256, 64, 702, 64) == 49_152
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


def test_group_scales_are_kept_per_tensor_version_and_group(monkeypatch):
    """``ops.group_scales`` runs the one-time scale pass once per (tensor,
    group size) and keeps the result while the tensor lives and is not
    edited in place: a second index of the same shape, a new group size,
    an in-place edit (``_version``) and an inference tensor (no version
    counter) each run it again; a freed tensor drops its entry; under
    the plan recorder nothing is kept.  The pass itself is stood in for
    by its plain version (the card runs csrc ``group_amax``)."""
    from repro_torch.kernels import launcher
    calls = []

    def plain_pass(x, blk, n_groups):
        calls.append((blk, n_groups))
        return ref.group_amax(x, blk, n_groups).view(torch.int32)

    monkeypatch.setattr(ops._ft, "group_amax", plain_pass)
    ops.drop_scales()
    lv = torch.randn(4, 10, 8)
    a = ops.group_scales(lv, 16, 1)
    assert ops.group_scales(lv, 16, 1) is a and len(calls) == 1
    assert ops.group_scales(lv, 8, 2).shape == (4, 2) and len(calls) == 2
    other = lv.clone()
    assert torch.equal(ops.group_scales(other, 16, 1), a)
    assert len(calls) == 3
    lv[0] *= 4                                       # in place
    edited = ops.group_scales(lv, 16, 1)
    assert len(calls) == 4 and not torch.equal(edited, a)
    assert torch.equal(edited, ref.group_amax(lv, 16, 1).view(torch.int32))
    cents = torch.randn(20, 8)
    assert ops.group_scales(cents, 32, 1).shape == (1, 1)
    ops.group_scales(cents, 32, 1)
    assert len(calls) == 5
    n = len(ops._scales)
    del other
    assert len(ops._scales) == n - 1
    with torch.inference_mode():
        frozen = torch.randn(2, 10, 8)
    ops.group_scales(frozen, 16, 1)
    ops.group_scales(frozen, 16, 1)
    assert len(calls) == 7
    fresh = torch.randn(2, 10, 8)
    with launcher.record_launches():
        ops.group_scales(fresh, 16, 1)
    ops.group_scales(fresh, 16, 1)
    assert len(calls) == 9
    ops.drop_scales()
    assert not ops._scales


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
# head dims past 128, the wide instances (keys 128 / 192 / 256 and values
# 128 / 256 bucketed apart): MLA's prefill (4 warps), 256 / 256 at one
# warp (f32: one stage) and at four, ragged S and Skv, and the other
# bucket pairs
ATTN_WIDE_SHAPES = [(1, 16, 16, 784, 784, 192, 128, True),   # MLA prefill
                    (1, 4, 4, 256, 256, 256, 256, True),
                    (4, 16, 8, 256, 256, 256, 256, False),
                    (1, 4, 2, 100, 200, 192, 128, True),     # ragged
                    (2, 4, 2, 100, 200, 256, 256, False),
                    (1, 4, 4, 128, 128, 136, 200, True),     # (192, 256)
                    (1, 4, 4, 128, 128, 96, 256, False),     # (128, 256)
                    (1, 4, 4, 128, 128, 256, 64, True)]      # (256, 128)


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


@pytest.mark.parametrize("shape", [ATTN_WIDE_SHAPES[i] for i in (1, 3, 5)])
def test_plain_attention_matches_float64_at_wide_heads(shape):
    q, k, v = _attn_inputs(shape)
    got = ops.flash_attention(q, k, v, causal=shape[-1], device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               _attn_float64(q, k, v, shape[-1]),
                               rtol=0, atol=ATTN_TOL)


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_WIDE_SHAPES)
def test_cuda_flash_attention_wide_heads_equal_plain_version(
        cuda_device, shape, dtype):
    """D, Dv up to 256: one launch; the f32 result within ATTN_TOL of
    the plain version, the bf16 output within one bf16 ulp of its row's
    largest |out| (each side rounds its own f32 result)."""
    q, k, v = (t.to(dtype) for t in _attn_inputs(shape, cuda_device))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape[-1])
    want = ref.mha_attention(q, k, v, causal=shape[-1])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= ATTN_TOL
    else:
        assert bool((diff <= _bf16_row_ulp(want.float())).all())


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


# The two kernels of csrc/embedding_bag.cu: bag_rows_kernel (a block a
# (bag, 32-column slice), the rows staged by cp.async) up to
# tiling.BAG_ROWS_MAX_B bags, embedding_bag_kernel (a warp a bag) past it.
# (V, d, B, L): each side of the threshold and serve_p99's 512; bags of 1,
# 31, 32, 33 and 200 ids (past one 64-row chunk); d 16, 260 (a slice of
# 4 columns past 8 whole ones) and 1,000 (32 slices, the last of 8)
BAG_THR = tiling.BAG_ROWS_MAX_B
BAG_EDGE_SHAPES = [(1000, 256, 1, 50), (1000, 256, BAG_THR, 50),
                   (1000, 256, BAG_THR + 1, 50), (1000, 256, 512, 50),
                   (500, 256, 3, 1), (500, 256, 3, 31), (500, 256, 3, 32),
                   (500, 256, 3, 33), (500, 256, 3, 200), (400, 16, 5, 50),
                   (400, 260, 5, 50), (400, 1000, 5, 50)]


def _bag_edge_inputs(shape, dev="cpu"):
    """``_bag_inputs``' float table, ids and weights, with bag 0 all
    pads only when there is another bag (a lone bag stays real)."""
    table, ids, w = _bag_inputs(shape, False, dev)
    if ids.shape[0] == 1:
        rng = np.random.default_rng(shape[0] + shape[3])
        ids = torch.from_numpy(rng.integers(-1, shape[0], size=ids.shape)
                               .astype(np.int32)).to(dev)
        ids[:, -1] = shape[0] - 1
    return table, ids, w


def test_bag_plan_picks_the_rows_kernel_up_to_the_threshold():
    """B <= BAG_ROWS_MAX_B: one block of a warp per (bag, slice of
    BAG_SLICE columns), its staged rows in static shared memory; past
    it one warp a bag; a forced kernel wins; B = 0 launches nothing."""
    for b in (1, 8, BAG_THR):
        (plan,) = tiling.plan_embedding_bag(b, 256)
        assert plan.kernel == "bag_rows_kernel"
        assert plan.grid == (b, 256 // tiling.BAG_SLICE, 1)
        assert plan.block == (tiling.WARP, 1, 1) and plan.dyn_smem_bytes == 0
        assert plan.static_smem_bytes == tiling.STATIC_SMEM[
            "bag_rows_kernel"] == tiling.BAG_ROWS_CHUNK * (
                tiling.BAG_SLICE + 2) * 4
    assert tiling.plan_embedding_bag(1, 1000)[0].grid == (1, 32, 1)
    for b in (BAG_THR + 1, 262_144):
        (plan,) = tiling.plan_embedding_bag(b, 256)
        assert plan.kernel == "embedding_bag_kernel"
        assert plan.grid == (-(-b // tiling.BAG_WARPS), 1, 1)
    assert tiling.plan_embedding_bag(1, 256, "warp")[0].kernel == \
        "embedding_bag_kernel"
    assert tiling.plan_embedding_bag(10 ** 6, 256, "rows")[0].kernel == \
        "bag_rows_kernel"
    assert tiling.plan_embedding_bag(0, 256) == []
    with pytest.raises(ValueError, match="rows"):
        tiling.plan_embedding_bag(1, 256, "block")


def _bag_rows_replay(table, ids, weights):
    """csrc bag_rows_kernel's arithmetic in numpy float32: per (bag,
    slice of BAG_SLICE columns), per chunk of BAG_ROWS_CHUNK ids, lane c
    adds row * w of column c for each real id in bag order, one rounding
    after the product and one after the sum; a pad is skipped."""
    t, idn = table.numpy(), ids.numpy()
    w = (np.ones(idn.shape, np.float32) if weights is None
         else weights.numpy())
    b, bag = idn.shape
    d = t.shape[1]
    out = np.zeros((b, d), np.float32)
    for row in range(b):
        for c0 in range(0, d, tiling.BAG_SLICE):
            cols = slice(c0, min(d, c0 + tiling.BAG_SLICE))
            acc = np.zeros(cols.stop - c0, np.float32)
            for l0 in range(0, bag, tiling.BAG_ROWS_CHUNK):
                for l in range(l0, min(bag, l0 + tiling.BAG_ROWS_CHUNK)):
                    if idn[row, l] < 0:
                        continue
                    acc = (acc + (t[idn[row, l], cols] * w[row, l]
                                  ).astype(np.float32)).astype(np.float32)
            out[row, cols] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("shape", [BAG_EDGE_SHAPES[k] for k in
                                   (0, 4, 7, 8, 10, 11)])
def test_bag_rows_kernel_order_is_the_plain_versions_bits(shape):
    """A CPU replay of the small-batch kernel's summation order (slices,
    chunks of 64 ids, pads skipped) equals ref.embedding_bag bit for
    bit, weighted and not, on float inputs."""
    table, ids, w = _bag_edge_inputs(shape)
    for weights in (None, w):
        want = ref.embedding_bag(table, ids, weights)
        got = _bag_rows_replay(table, ids, weights)
        assert torch.equal(got, want)
        assert (ids.shape[0] == 1) == bool(got[0].any())


@pytest.mark.cuda_only
@pytest.mark.parametrize("kernel", ["", "rows", "warp"])
@pytest.mark.parametrize("shape", BAG_EDGE_SHAPES)
def test_cuda_embedding_bag_kernels_equal_plain_version(cuda_device, shape,
                                                        kernel):
    """Each kernel, forced or by the plan, bit-equal to the plain version
    on float inputs, weighted and not, with an all-pad bag 0: both sum
    in bag order with one rounding a product and a sum."""
    from repro_torch.kernels import embedding_bag as eb
    table, ids, w = _bag_edge_inputs(shape, cuda_device)
    for weights in (None, w):
        got = eb.embedding_bag(table, ids, weights, kernel=kernel)
        assert torch.equal(got, ref.embedding_bag(table, ids, weights))
        assert (ids.shape[0] == 1) == bool(got[0].any())


@pytest.mark.cuda_only
@pytest.mark.parametrize("kernel", ["rows", "warp"])
def test_cuda_embedding_bag_reads_a_misaligned_table_view(cuda_device,
                                                          kernel):
    """A table view 4 bytes past a 16-byte boundary (d = 256) takes each
    kernel's 4-byte path, to the same bits."""
    from repro_torch.kernels import embedding_bag as eb
    table, ids, w = _bag_edge_inputs(BAG_EDGE_SHAPES[0], cuda_device)
    buf = torch.empty(table.numel() + 1, device=cuda_device)
    view = buf[1:].view(table.shape)
    view.copy_(table)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    for weights in (None, w):
        got = eb.embedding_bag(view, ids, weights, kernel=kernel)
        assert torch.equal(got, ref.embedding_bag(table, ids, weights))


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, BAG_THR, BAG_THR + 1])
def test_cuda_embedding_bag_launches_one_kernel_a_call(cuda_device, b):
    """One kernel a call under the profiler, the one the plan names."""
    table, ids, w = _bag_edge_inputs((1000, 256, b, 50), cuda_device)
    want = tiling.plan_embedding_bag(b, 256)[0].kernel
    before = ops.embedding_bag.launches
    names = _traced_kernels(lambda: ops.embedding_bag(table, ids, w),
                            cuda_device)
    assert len(names) == 1 and want in names[0], names
    assert ops.embedding_bag.launches > before


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


# ---------------------------------------------------------------------------
# the tensor-core attention kernels: bf16 inputs, views, launches, bits
# ---------------------------------------------------------------------------


def _traced_kernels(call, device):
    """Names of the device kernels torch.profiler sees in one ``call()``
    (after a warm-up call), as ``kernel_budget.traced`` reads them: a
    session whose trace is the call's recorded plan with kernels
    missing, while the ops wrappers' launch counts show every call
    launching, is taken again; any other trace is returned as it is,
    for the caller to compare."""
    from repro_torch.analysis import kernel_budget
    probe = kernel_budget.Probe("call", (), lambda device: call())
    want = kernel_budget.planned(probe, [], device)
    return [x[0] for x in kernel_budget.traced(probe, [], device, want)]


def _transposed(x):
    """x (B, H, S, D) as the model's projections leave it: a (B, S, H, D)
    buffer seen through transpose(1, 2)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_cuda_flash_attention_bf16_equals_plain_version(cuda_device, shape):
    """bf16 inputs read as they are: the bf16 output within one bf16 ulp
    of its row's largest |out| against the plain version on the same
    inputs (each side rounds its own f32 result)."""
    q, k, v = (t.to(torch.bfloat16)
               for t in _attn_inputs(shape, cuda_device))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape[-1])
    want = ref.mha_attention(q, k, v, causal=shape[-1])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _bf16_row_ulp(want.float())).all())


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_reads_views_and_ignores_the_batch(
        cuda_device, dtype):
    """A transposed v (the projections' layout) is read in place, with the
    bits of its contiguous copy; a row's output is the same bits alone
    or in a batch."""
    shape = (3, 8, 2, 100, 200, 64, 64, True)
    q, k, v = (t.to(dtype) for t in _attn_inputs(shape, cuda_device))
    full = ops.flash_attention(q, k, v)
    assert torch.equal(ops.flash_attention(_transposed(q), _transposed(k),
                                           _transposed(v)), full)
    for row in (0, 2):
        one = ops.flash_attention(q[row:row + 1], k[row:row + 1],
                                  v[row:row + 1])
        assert torch.equal(one[0], full[row])


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_launches_only_its_kernel(cuda_device, dtype):
    """One ops call on the prefill's layout (v transposed) is one kernel,
    the one its plan names: no casts, no layout copies."""
    shape = (1, 32, 4, 784, 784, 128, 128, True)
    q, k, v = (t.to(dtype) for t in _attn_inputs(shape, cuda_device))
    v = _transposed(v)
    plan = tiling.plan_flash_attention(1, 32, 784, 128, 128,
                                       "bf16" if dtype == torch.bfloat16
                                       else "f32")
    names = _traced_kernels(lambda: ops.flash_attention(q, k, v),
                            cuda_device)
    assert len(names) == len(plan) == 1 and plan[0].kernel in names[0]


@pytest.mark.cuda_only
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_bf16_launches_one_kernel(cuda_device, qdtype):
    """On a bf16 cache one ops call is one kernel (the splits folded in
    it, no casts), the output in q's dtype; on a float32 cache two."""
    q, k, v, lens = _decode_inputs(DECODE_SHAPES[3], torch.bfloat16,
                                   cuda_device)
    q = q.to(qdtype)
    assert ops.flash_decode(q, k, v, lens).dtype == qdtype
    names = _traced_kernels(lambda: ops.flash_decode(q, k, v, lens),
                            cuda_device)
    assert len(names) == 1 and "decode_mma_kernel" in names[0]
    plan = tiling.plan_flash_decode(8, 32, 4, 1024, 128, "bf16")
    assert [x.kernel for x in plan] == ["decode_mma_kernel"]
    q, k, v = q.float(), k.float(), v.float()
    names = _traced_kernels(lambda: ops.flash_decode(q, k, v, lens),
                            cuda_device)
    assert len(names) == 2


@pytest.mark.cuda_only
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_calls_repeat_their_bits(cuda_device, qdtype):
    """The arrival counters are reset by each call: back-to-back calls,
    and a call at another B between them, give the same bits; cache_len
    1, S and S + 1 within the gates of the plain version."""
    b, h, hkv, s, d = 3, 32, 4, 32_768, 128
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((b, h, d), generator=g, device=cuda_device).to(qdtype)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device=cuda_device
                        ).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([1, s, s + 1], dtype=torch.int32,
                        device=cuda_device)
    first = ops.flash_decode(q, k, v, lens)
    ops.flash_decode(q[:1], k[:1], v[:1], lens[:1] + s // 2)
    assert torch.equal(ops.flash_decode(q, k, v, lens), first)
    assert torch.equal(ops.flash_decode(q, k, v, lens), first)
    want = ref.decode_attention(q, k, v, lens)
    diff = (first.float() - want.float()).abs()
    if qdtype == torch.float32:
        assert float(diff.max()) <= ATTN_TOL
    else:
        assert bool((diff <= _bf16_row_ulp(want.float())).all())


@pytest.mark.cuda_only
def test_cuda_flash_decode_bf16_refuses_grad_and_empty_launches_nothing(
        cuda_device):
    q, k, v, lens = _decode_inputs(DECODE_SHAPES[0], torch.bfloat16,
                                   cuda_device)
    q = q.to(torch.bfloat16)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q[:0], k[:0], v[:0], lens[:0])
    assert out.shape == (0, 4, 64) and out.dtype == torch.bfloat16
    assert ops.flash_decode.launches == before
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.flash_decode(q.requires_grad_(), k, v, lens)


@pytest.mark.cuda_only
def test_cuda_flash_attention_bf16_refuses_grad_and_empty_launches_nothing(
        cuda_device):
    q, k, v = (t.to(torch.bfloat16)
               for t in _attn_inputs(ATTN_SHAPES[0], cuda_device))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q[:0], k[:0], v[:0])
    assert out.shape == (0, 4, 128, 32) and out.dtype == torch.bfloat16
    assert ops.flash_attention.launches == before
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


# csrc/attn_mma.cuh on the card: one warp's m16n8k16 product of a bf16 A
# (16 x 16) and B (16 x 8) whose A comes as hi + lo terms of float32
# values (the P V step), one 3xTF32 m16n8k8 product of float32 A (16 x 8)
# and B (8 x 8), and the three-term bf16 split of float32 values
MMA_HARNESS = r"""
#include "attn_mma.cuh"
using namespace attn_mma;
__global__ void mma_kernel(const float* a16, const __nv_bfloat16* b16,
                           float* c16, const float* a8, const float* b8,
                           float* c8, const float* x, float* x3) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t hi[4], lo[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + (i & 1) * 8, c = 2 * t + (i >> 1) * 8;
    split_bf16(a16[r * 16 + c], a16[r * 16 + c + 1], hi[i], lo[i]);
  }
  uint32_t b[2];
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat16 e0 = b16[(2 * t + 8 * i) * 8 + g];
    const __nv_bfloat16 e1 = b16[(2 * t + 8 * i + 1) * 8 + g];
    b[i] = (uint32_t)__bfloat16_as_ushort(e0) |
           ((uint32_t)__bfloat16_as_ushort(e1) << 16);
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(c, lo, b[0], b[1]);
  mma_bf16(c, hi, b[0], b[1]);
  for (int i = 0; i < 4; ++i) c16[(g + (i >> 1) * 8) * 8 + 2 * t + (i & 1)] = c[i];
  uint32_t ah[4], al[4];
  for (int i = 0; i < 4; ++i)
    split_tf32(a8[(g + (i & 1) * 8) * 8 + t + (i >> 1) * 4], ah[i], al[i]);
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b8[t * 8 + g], b0h, b0l);
  split_tf32(b8[(t + 4) * 8 + g], b1h, b1l);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(d, ah, al, b0h, b0l, b1h, b1l);
  for (int i = 0; i < 4; ++i) c8[(g + (i >> 1) * 8) * 8 + 2 * t + (i & 1)] = d[i];
  uint32_t terms[3];
  split3_bf16(x[2 * lane], x[2 * lane + 1], terms);
  float2 s = make_float2(0.f, 0.f);
  for (int i = 2; i >= 0; --i) {
    const float2 h = unpack_bf16(terms[i]);
    s.x += h.x;
    s.y += h.y;
  }
  x3[2 * lane] = s.x;
  x3[2 * lane + 1] = s.y;
}
extern "C" int mma_check(const float* a16, const void* b16, float* c16,
                         const float* a8, const float* b8, float* c8,
                         const float* x, float* x3) {
  mma_kernel<<<1, 32>>>(a16, (const __nv_bfloat16*)b16, c16, a8, b8, c8,
                        x, x3);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda_only
def test_cuda_attn_mma_header(cuda_device, tmp_path):
    """The fragment layouts and splits of csrc/attn_mma.cuh: a P V step
    (P as hi + lo bf16) within 2^-15 of the float64 product, a 3xTF32
    product within 2^-19 of it (relative to sum |a b|), and the
    three-term bf16 split exact."""
    src = tmp_path / "mma_harness.cu"
    src.write_text(MMA_HARNESS)
    so = tmp_path / "libmma.so"
    subprocess.run([_build.nvcc(), *_build.ARCH, "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), "-o",
                    str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).mma_check
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(11)
    a16 = torch.rand((16, 16), generator=gen)
    b16 = torch.randn((16, 8), generator=gen).to(torch.bfloat16)
    a8 = torch.randn((16, 8), generator=gen)
    b8 = torch.randn((8, 8), generator=gen)
    x = torch.randn(64, generator=gen) * torch.exp2(
        torch.randint(-20, 20, (64,), generator=gen).float())
    dev = [t.to(cuda_device) for t in (a16, b16, a8, b8, x)]
    c16, c8, x3 = (torch.zeros(n, device=cuda_device)
                   for n in ((16, 8), (16, 8), (64,)))
    assert fn(dev[0].data_ptr(), dev[1].data_ptr(), c16.data_ptr(),
              dev[2].data_ptr(), dev[3].data_ptr(), c8.data_ptr(),
              dev[4].data_ptr(), x3.data_ptr()) == 0
    for got, a, b, tol in ((c16, a16, b16.float(), 2.0 ** -15),
                           (c8, a8, b8, 2.0 ** -19)):
        want = a.double() @ b.double()
        scale = a.double().abs() @ b.double().abs()
        assert float(((got.cpu().double() - want).abs() / scale).max()) \
            <= tol
    assert torch.equal(x3.cpu(), x)


# B, H, Hkv, S, D and cache dtype: the served shapes (Yi-9B's RAG cache
# and decode_32k cut to B = 8), the smoke's [decode] shapes and the
# kernels probe
DECODE_PLANS = [((1, 32, 4, 1024, 128), "bf16", (16, 4), 104_448),
                ((8, 32, 4, 32_768, 128), "bf16", (64, 32), 104_448),
                ((8, 40, 8, 32_768, 128), "bf16", (64, 64), 104_448),
                ((1, 4, 4, 1000, 128), "bf16", (16, 4), 104_448),
                ((2, 10, 2, 300, 16), "bf16", (5, 4), 18_432),
                ((1, 32, 4, 4_000_000, 128), "bf16", (7813, 4), 250_144),
                ((4, 8, 2, 2048, 128), "f32", (32, 8), None)]


@pytest.mark.parametrize("shape,cache,grid,smem", DECODE_PLANS)
def test_flash_decode_plans(shape, cache, grid, smem):
    """The bf16 cache is one decode_mma_kernel launch (4 warps a block,
    one block per (split, row x kv head), the ring or the fold in
    dynamic shared memory within one block's cap); the float32 cache
    keeps its split and combine kernels."""
    b, h, hkv, s, d = shape
    if smem is not None and smem > tiling.SMEM_BLOCK_BYTES:
        with pytest.raises(ValueError, match="fold"):
            tiling.plan_flash_decode(b, h, hkv, s, d, cache)
        return
    plan = tiling.plan_flash_decode(b, h, hkv, s, d, cache)
    assert plan[0].grid == tuple(grid) + (1,) * (3 - len(grid))
    assert all(x.smem_bytes <= tiling.SMEM_BLOCK_BYTES for x in plan)
    if cache == "bf16":
        assert [x.kernel for x in plan] == ["decode_mma_kernel"]
        assert plan[0].block == (128, 1, 1)
        assert plan[0].dyn_smem_bytes == smem
    else:
        assert [x.kernel for x in plan] == ["decode_split_kernel",
                                            "decode_combine_kernel"]
    assert tiling.plan_flash_decode(0, h, hkv, s, d, cache) == []


# B, H, S, D, Dv, dtype -> grid, warps, dynamic shared memory: Dragon's
# query (B = 1) and doc batch (B = 64), Snowflake's query, Yi-9B's bf16
# prefill, the smoke's [attn] shapes and the kernels probe
ATTN_PLANS = [((1, 12, 256, 64, 64), "f32", (12, 16), 1, 71_680),
              ((64, 12, 256, 64, 64), "f32", (768, 4), 4, 71_680),
              ((1, 16, 256, 64, 64), "f32", (16, 16), 1, 71_680),
              ((1, 32, 784, 128, 128), "bf16", (32, 13), 4, 104_448),
              ((1, 32, 784, 128, 128), "f32", (32, 13), 4, 137_216),
              ((2, 8, 100, 64, 64), "f32", (16, 7), 1, 71_680),
              ((2, 8, 128, 48, 32), "bf16", (16, 8), 1, 55_296),
              ((1, 4, 1024, 128, 128), "f32", (4, 64), 1, 137_216)]


@pytest.mark.parametrize("shape,dtype,grid,warps,smem", ATTN_PLANS)
def test_flash_attention_plans(shape, dtype, grid, warps, smem):
    """One launch per call: 4-warp blocks (64 query rows) when they still
    cover the 132 SMs, else one-warp blocks; the stages of K and V tiles
    (bf16 three, f32 two) within one block's shared memory."""
    b, h, s, d, dv = shape
    plan = tiling.plan_flash_attention(b, h, s, d, dv, dtype)
    kernel = {"f32": "flash_tf32_kernel", "bf16": "flash_bf16_kernel"}
    assert [x.kernel for x in plan] == [kernel[dtype]]
    assert plan[0].grid == (*grid, 1)
    assert plan[0].block == (32 * warps, 1, 1)
    assert plan[0].grid[0] * plan[0].grid[1] >= min(
        tiling.SMS, b * h * -(-s // 16))
    assert plan[0].dyn_smem_bytes == smem <= tiling.SMEM_BLOCK_BYTES
    assert tiling.plan_flash_attention(0, h, s, d, dv, dtype) == []


# B, H, S, D, Dv, dtype -> grid, stages, dynamic shared memory of the wide
# instances (4 warps): MLA's prefill, then (256, 256) (f32 one stage: two
# need 268 KB), and the f32 bucket pairs on each side of DK + DV = 320
ATTN_WIDE_PLANS = [((1, 16, 784, 192, 128), "bf16", (16, 13), 2, 111_616),
                   ((1, 16, 784, 192, 128), "f32", (16, 13), 2, 221_184),
                   ((1, 4, 256, 256, 256), "bf16", (4, 4), 2, 168_960),
                   ((1, 4, 256, 256, 256), "f32", (4, 4), 1, 201_728),
                   ((1, 4, 128, 96, 256), "f32", (4, 2), 1, 136_192),
                   ((1, 4, 128, 256, 64), "f32", (4, 2), 1, 168_960)]


@pytest.mark.parametrize("shape,dtype,grid,stages,smem", ATTN_WIDE_PLANS)
def test_flash_attention_wide_plans(shape, dtype, grid, stages, smem):
    """Past 128 one 4-warp block per 64 query rows; the key and value
    buckets apart ((192, 128) keeps a 128-wide accumulator); the block's
    query rows staged after two stages of K and V, or one where two do
    not fit."""
    b, h, s, d, dv = shape
    plan = tiling.plan_flash_attention(b, h, s, d, dv, dtype)
    kernel = {"f32": "flash_tf32_kernel", "bf16": "flash_bf16_kernel"}
    assert [x.kernel for x in plan] == [kernel[dtype]]
    assert plan[0].grid == (*grid, 1) and plan[0].block == (128, 1, 1)
    assert tiling.attn_smem(*tiling.attn_bucket(d, dv), 4, dtype) == \
        (stages, smem)
    assert plan[0].dyn_smem_bytes == smem <= tiling.SMEM_BLOCK_BYTES
    assert tiling.attn_bucket(192, 128) == (192, 128)
    assert tiling.attn_bucket(128, 128) == (128, 128)
    assert tiling.attn_bucket(48, 32) == (64, 64)


# ---------------------------------------------------------------------------
# rows 1-2: centroid_topk and ivf_scan, and every entry's launch plan
# ---------------------------------------------------------------------------

# p, d, B, k: p not a multiple of 128, k = p, dense ties (d = 8), B = 64
# with a two-pass merge at k = 2,048
CK_SHAPES = [(600, 16, 3, 8), (16, 16, 2, 16), (1000, 8, 25, 64),
             (2500, 8, 64, 2048)]
# p, lmax, d, B, nprobe, k: fewer real rows than k, nprobe 256, k 2,048
IV_SHAPES = [(6, 10, 16, 3, 3, 4), (5, 7, 8, 1, 5, 8),
             (1000, 130, 8, 25, 64, 10), (600, 40, 8, 2, 256, 2048)]


def _ck_inputs(shape, dtype, dev):
    """Integer queries and centroids; the first shape's scores are all
    negative (centroids in [1, 4], queries in [-4, -1])."""
    p, d, b, _ = shape
    rng = np.random.default_rng(p + d)
    lo = 1 if d == 8 else 4
    q = rng.integers(-lo, lo + 1, size=(b, d))
    c = rng.integers(-lo, lo + 1, size=(p, d))
    if shape == CK_SHAPES[0]:
        q, c = -np.abs(q) - 1, np.abs(c) + 1
    return [torch.from_numpy(x.astype(np.float32)).to(dtype).to(dev)
            for x in (q, c)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CK_SHAPES)
def test_cuda_centroid_topk_equals_plain_version(cuda_device, shape, dtype):
    q, c = _ck_inputs(shape, dtype, cuda_device)
    before = ops.centroid_topk.launches
    got = ops.centroid_topk(q, c, shape[3])
    want = ref.centroid_topk(q, c, shape[3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.centroid_topk.launches == before + 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", IV_SHAPES)
def test_cuda_ivf_scan_equals_plain_version(cuda_device, shape, dtype):
    q, _, lv, li, _ = _inputs(shape, cuda_device)
    rng = np.random.default_rng(shape[0])
    sel = torch.from_numpy(rng.integers(0, shape[0], size=shape[3:5]).astype(
        np.int32)).to(cuda_device)
    before = ops.ivf_scan.launches
    got = ops.ivf_scan(q.to(dtype), lv.to(dtype), li, sel, shape[5])
    want = ref.ivf_scan_batch(q.to(dtype), lv.to(dtype), li, sel, shape[5])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.ivf_scan.launches == before + 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_two_stages_equal_the_fused_turn(cuda_device, shape):
    """centroid_topk -> ivf_scan gives the f32 fused turn's sel, values
    and ids bit for bit: the same device code in the same order."""
    nprobe, k = shape[4], shape[5]
    q, cents, lv, li, _ = _inputs(shape, cuda_device)
    q = q + 0.25 * torch.randn(q.shape, device=cuda_device)
    fv, fi, fs = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k)
    _, sel = ops.centroid_topk(q, cents, nprobe)
    v, i = ops.ivf_scan(q, lv, li, sel, k)
    assert torch.equal(sel, fs) and torch.equal(v, fv) and torch.equal(i, fi)


def _probes():
    """The kernels analysis pass's probes: the reference's and the
    port's own (``hnsw_search``)."""
    from repro_torch.analysis import kernel_budget
    return kernel_budget.default_probes() + kernel_budget.port_probes()


def _probe_labels():
    return [p.label for p in _probes()]


@pytest.mark.cuda_only
@pytest.mark.parametrize("label", _probe_labels())
def test_cuda_launch_plans_match_the_profiler(cuda_device, label):
    """Each probe of the kernels analysis pass, on CUDA tensors: the
    recorded launch plan equals the kernels torch.profiler traces (name,
    order, grid, block, static + dynamic shared memory)."""
    from repro_torch.analysis import kernel_budget
    probe = next(p for p in _probes() if p.label == label)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tensors = probe.tensors(cuda_device, gen)
    ops.drop_scales()       # a first call: int8 runs its scale pass
    want = kernel_budget.planned(probe, tensors, cuda_device)
    assert want and kernel_budget.traced(probe, tensors, cuda_device,
                                         before=ops.drop_scales,
                                         want=want) == want


# ---------------------------------------------------------------------------
# the redesigned stage kernels (csrc/ivf_stages.cuh): one pass over the
# centroid table for up to 32 queries, a warp-level selection a block, the
# scan's fold in its own launch
# ---------------------------------------------------------------------------


def _float_stage_inputs(p, lmax, d, b, seed, dev):
    """Float queries, centroids and ragged lists (list 0 empty)."""
    g = torch.Generator().manual_seed(seed)
    q, cents, lv = (torch.randn(s, generator=g) for s in
                    ((b, d), (p, d), (p, lmax, d)))
    sizes = torch.randint(0, lmax + 1, (p,), generator=g)
    sizes[0] = 0
    real = torch.arange(lmax)[None] < sizes[:, None]
    li = torch.where(real, torch.arange(p * lmax).view(p, lmax), -1)
    lv = lv * real[..., None]
    return [x.to(dev) for x in (q, cents, lv, li.to(torch.int32))]


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
def test_cuda_stage_rows_keep_their_bits_at_b_1_8_25(cuda_device,
                                                      precision):
    """Rows 1, 2 and 4-7 give a query the same bits alone, in a batch of
    8 (stage 1's 8-query tile) and in a batch of 25 (its 32-query tile,
    the table read once), on float inputs at d = 64."""
    p, lmax, d, nprobe, k = 700, 300, 64, 16, 10
    q, cents, lv, li = _float_stage_inputs(p, lmax, d, 25, 25, cuda_device)
    g = torch.Generator().manual_seed(5)
    tables = torch.randn((25, 8, 256), generator=g).to(cuda_device)
    codes = torch.randint(0, 256, (p, lmax, 8), generator=g,
                          dtype=torch.uint8).to(cuda_device)
    corpus = lv.view(p * lmax, d)

    def run(rows):
        out = list(ops.centroid_topk(q[rows], cents, 64))
        sel = ops.centroid_topk(q[rows], cents, nprobe)[1]
        out += ops.ivf_scan(q[rows], lv, li, sel, k)
        out += ops.fused_turn(q[rows], cents, lv, li, nprobe=nprobe, k=k,
                              precision=precision)
        out += ops.fused_scan(q[rows], lv, li, sel, k, precision=precision)
        out += ops.fused_turn_pq(q[rows], cents, tables[rows], codes, li,
                                 corpus, nprobe=nprobe, k=k, rerank=64,
                                 precision=precision)
        out += ops.fused_scan_pq(tables[rows], q[rows], codes, li, sel,
                                 corpus, k, rerank=64, precision=precision)
        return out

    full = run(slice(0, 25))
    for lo, hi in ((0, 8), (8, 16), (24, 25), (3, 4)):
        for a, b in zip(run(slice(lo, hi)), full):
            assert torch.equal(a, b[lo:hi])


# p, d, B, kp: p below one chunk, p not a multiple of 128, the top-h
# caches at kp 1,024 and 2,048, B in the 8- and the 32-query tile and
# past one 32-query tile
CK_EDGE_SHAPES = [(100, 16, 1, 64), (100, 16, 25, 64), (300, 8, 9, 128),
                  (3000, 16, 1, 1024), (3000, 16, 25, 1024),
                  (3000, 8, 2, 2048), (2500, 16, 40, 2048)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CK_EDGE_SHAPES)
def test_cuda_centroid_topk_chunk_edges(cuda_device, shape, dtype):
    p, d, b, kp = shape
    q, c = _ck_inputs((p, d, b, kp), dtype, cuda_device)
    got = ops.centroid_topk(q, c, kp)
    want = ref.centroid_topk(q, c, kp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _sized_lists(lmax, sizes, d, dev):
    """Integer lists of the given sizes (ids = flat slots, -1 pads)."""
    p = len(sizes)
    rng = np.random.default_rng(lmax + p)
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    real = np.arange(lmax)[None] < np.asarray(sizes)[:, None]
    lv[~real] = 0
    li = np.where(real, np.arange(p * lmax).reshape(p, lmax), -1)
    q = rng.integers(-4, 5, size=(3, d)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in
            (q, lv, li.astype(np.int32))]


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
@pytest.mark.parametrize("k", [10, 100, 1000])
def test_cuda_scan_of_lists_of_0_1_128_and_lmax_rows(cuda_device, k,
                                                      precision):
    """Lists holding 0, 1, 128 and Lmax rows (slices with no real row
    write nothing), probed with repeats and a foreign list: the folded
    scan (k 10, 100) and the merged one (k 1,000) equal the plain
    versions bit for bit, ivf_scan too at f32."""
    lmax = 300
    q, lv, li = _sized_lists(lmax, [0, 1, 128, lmax, 0, 129, 2], 16,
                             cuda_device)
    sel = torch.tensor([[3, 0, 1, 2, 4, 5, 6, 3], [0, 4, 0, 4, 1, 1, 0, 4],
                        [2, 2, 3, 5, 6, 1, 0, 4]], dtype=torch.int32,
                       device=cuda_device)
    own = torch.ones_like(sel)
    own[1, 2] = 0
    assert tiling.scan_fold(8, lmax, tiling.next_pow2(k)) == (k < 1000)
    r = ops._fused_depth(k, 8 * lmax, 2 * k)
    got = ops.fused_scan(q, lv, li, sel, k, own=own, precision=precision)
    want = ref.fused_scan_ivf(q, lv, li, sel, own, k=k, precision=precision,
                              r=r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if precision == "f32":
        for g, w in zip(ops.ivf_scan(q, lv, li, sel, k),
                        ref.ivf_scan_batch(q, lv, li, sel, k)):
            assert torch.equal(g, w)


@pytest.mark.cuda_only
def test_cuda_folded_scan_on_two_streams(cuda_device):
    """Two streams call the folded scan at once, each with its own
    arrival counters (launcher.arrival_counters): every call equals the
    same call made alone, and the counters are left zeroed."""
    from repro_torch.kernels import launcher
    p, lmax, d = 400, 700, 64
    q, _, lv, li = _float_stage_inputs(p, lmax, d, 16, 7, cuda_device)
    g = torch.Generator().manual_seed(9)
    sels = [torch.randint(0, p, (8, 64), generator=g, dtype=torch.int32
                          ).to(cuda_device) for _ in range(2)]
    qs = [q[:8], q[8:]]
    assert tiling.scan_fold(64, lmax, 16)
    alone = [ops.fused_scan(x, lv, li, s, 10) for x, s in zip(qs, sels)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for n, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[n].append(ops.fused_scan(qs[n], lv, li, sels[n], 10))
    torch.cuda.synchronize()
    for n in range(2):
        for got in outs[n]:
            for a, b in zip(got, alone[n]):
                assert torch.equal(a, b)
        with torch.cuda.stream(streams[n]):
            buf = launcher.arrival_counters(cuda_device, 1)
        assert int(buf.abs().sum()) == 0


STAGE_PLAN_CALLS = {
    "centroid_topk B=1": lambda t: ops.centroid_topk(t["q"][:1], t["c"], 64),
    "centroid_topk B=25": lambda t: ops.centroid_topk(t["q"], t["c"], 64),
    "centroid_topk B=25 kp=1024": lambda t: ops.centroid_topk(
        t["q"], t["c"], 1024),
    "fused_scan folded": lambda t: ops.fused_scan(t["q"], t["lv"], t["li"],
                                                  t["sel"], 10),
    "fused_scan merged": lambda t: ops.fused_scan(t["q"], t["lv"], t["li"],
                                                  t["sel"], 1000),
    "fused_scan[int8] folded": lambda t: ops.fused_scan(
        t["q"], t["lv"], t["li"], t["sel"], 10, precision="int8"),
    "ivf_scan folded": lambda t: ops.ivf_scan(t["q"], t["lv"], t["li"],
                                              t["sel"], 10),
    "fused_turn[bf16]": lambda t: ops.fused_turn(
        t["q"], t["c"], t["lv"], t["li"], nprobe=16, k=10,
        precision="bf16"),
}


@pytest.mark.cuda_only
@pytest.mark.parametrize("name", STAGE_PLAN_CALLS)
def test_cuda_stage_plans_match_the_profiler(cuda_device, name):
    """The new stage plans (the 8- and 32-query stage-1 tiles, the
    growing merge of the top-h cache, the folded scan of one kernel and
    the merged one) equal the kernels torch.profiler traces: name,
    order, grid, block, static + dynamic shared memory."""
    from repro_torch.analysis import kernel_budget
    q, c, lv, li = _float_stage_inputs(3000, 300, 64, 25, 11, cuda_device)
    g = torch.Generator().manual_seed(1)
    t = dict(q=q, c=c, lv=lv, li=li,
             sel=torch.randint(0, 3000, (25, 16), generator=g,
                               dtype=torch.int32).to(cuda_device))
    probe = kernel_budget.Probe(name, (), lambda device: STAGE_PLAN_CALLS[
        name](t))
    ops.drop_scales()       # a first call: int8 runs its scale pass
    want = kernel_budget.planned(probe, [], cuda_device)
    assert want and kernel_budget.traced(probe, [], cuda_device,
                                         before=ops.drop_scales,
                                         want=want) == want
    names = [x[0] for x in want]
    assert ("merge_kernel" in names[names.index("scan_lists_kernel"):]
            ) == ("merged" in name) if "scan" in name else True


# ---------------------------------------------------------------------------
# the folds of stage 1 and of the ADC scan, the chained turn, the scales
# kept per index (csrc/fold.cuh, ops.group_scales)
# ---------------------------------------------------------------------------


def _unfolded(monkeypatch):
    """Every launch past its fold: merge_kernel (and rerank_kernel) after
    stage 1 and after the scans."""
    monkeypatch.setattr(tiling, "FOLD_SMEM_BYTES", 0)
    monkeypatch.setattr(tiling, "SELECT_FOLD_QUERIES", 0)


def _all_folded(monkeypatch):
    """Stage 1 folds every tile (up to 32 queries a block) at kp <= 128."""
    monkeypatch.setattr(tiling, "SELECT_FOLD_QUERIES", 64)


def _rows_3_to_7(q, cents, lv, li, tables, codes, corpus, nprobe, k, rerank,
                 precision):
    out = list(ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k,
                              precision=precision))
    sel = out[2]
    out += ops.fused_scan(q, lv, li, sel, k, precision=precision)
    out += ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                             nprobe=nprobe, k=k, rerank=rerank,
                             precision=precision)
    out += ops.fused_scan_pq(tables, q, codes, li, sel, corpus, k,
                             rerank=rerank, precision=precision)
    out += ops.fused_scan_pq(tables, q, codes, li, sel, corpus, k,
                             rerank=rerank, precision=precision,
                             fuse_rerank=False)
    if precision == "f32":
        out += ops.pq_adc_scan(tables, codes, li, sel, rerank)
    return out


# B, nprobe, k, the PQ re-rank depth: the scans fold at r_pad <= 128 and
# merge past it, up to 2,048; stage 1 folds at B = 1
FOLD_EDGES = [(1, 16, 10, 64), (1, 8, 100, 128), (1, 8, 100, 256),
              (3, 16, 10, 2000), (25, 16, 64, 128), (64, 8, 10, 64),
              (2, 64, 1000, 1000)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
@pytest.mark.parametrize("edge", FOLD_EDGES)
def test_cuda_folds_equal_the_merges(cuda_device, edge, precision,
                                     monkeypatch):
    """Rows 3-7 on integer inputs on both sides of each fold limit: the
    calls as the tiling plans them (stage 1 and the scans folded where
    they fit), with every fold off (merge_kernel and rerank_kernel after
    the launches) and with stage 1 folding every tile (up to 32 queries a
    block) are bit-equal, and equal the plain versions."""
    b, nprobe, k, rerank = edge
    shape = (700, 300, 16, b, nprobe, k, 16, 256, rerank)
    q, cents, tables, codes, li, corpus, _ = _pq_inputs(shape, cuda_device)
    lv = _inputs(shape[:6], cuda_device)[2]
    args = (q, cents, lv, li, tables, codes, corpus, nprobe, k, rerank,
            precision)
    planned = _rows_3_to_7(*args)
    with monkeypatch.context() as m:
        _unfolded(m)
        merged = _rows_3_to_7(*args)
    with monkeypatch.context() as m:
        _all_folded(m)
        folded = _rows_3_to_7(*args)
    for a, b_, c in zip(planned, merged, folded):
        assert torch.equal(a, b_) and torch.equal(a, c)
    r = ops._fused_depth(k, nprobe * 300, 2 * k)
    want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k,
                              precision=precision, r=r)
    for g, w in zip(planned[:3], want):
        assert torch.equal(g, w)
    r_pq = ops._fused_depth(k, nprobe * 300, rerank)
    want = ref.fused_scan_pq(tables, q, codes, li, want[2], None, corpus,
                             k=k, r=r_pq, rerank=True, precision=precision)
    for g, w in zip(planned[9:12], want):
        assert torch.equal(g, w)


@pytest.mark.cuda_only
@pytest.mark.parametrize("p", [1000, 3000])
@pytest.mark.parametrize("kp", [16, 64, 128])
@pytest.mark.parametrize("b", [1, 8, 25, 64])
def test_cuda_stage1_fold_equals_its_merge(cuda_device, b, kp, p,
                                           monkeypatch):
    """centroid_topk with stage 1's fold in every tile (1 to 32 queries
    a block; one group of chunks, or groups of 16 then the groups) and
    with none: bit-equal, and equal to the plain version, on float
    inputs."""
    q, c = _ck_inputs((p, 16, b, kp), torch.float32, cuda_device)
    with monkeypatch.context() as m:
        _all_folded(m)
        assert tiling.select_fold(b, p, 16, kp)
        folded = ops.centroid_topk(q, c, kp)
    with monkeypatch.context() as m:
        _unfolded(m)
        merged = ops.centroid_topk(q, c, kp)
    for f, g, w in zip(folded, merged, ref.centroid_topk(q, c, kp)):
        assert torch.equal(f, g) and torch.equal(f, w)


def _int8_calls(q, cents, lv, li, tables, codes, corpus):
    sel = ops.centroid_topk(q, cents, 16)[1]
    return [lambda: ops.fused_turn(q, cents, lv, li, nprobe=16, k=10,
                                   precision="int8"),
            lambda: ops.fused_scan(q, lv, li, sel, 10, precision="int8"),
            lambda: ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                      nprobe=16, k=10, rerank=64,
                                      precision="int8")]


def _planned_kernels(call):
    from repro_torch.kernels import launcher
    with launcher.record_launches() as records:
        call()
    return [x.kernel for r in records for x in r.plan]


@pytest.mark.cuda_only
def test_cuda_cached_scales_equal_per_call_scales(cuda_device):
    """The int8 turns and scan on the scales kept per index give the bits
    of the same calls with the scales dropped before each (a pass a
    call), and a call after the first plans no scale pass."""
    q, cents, lv, li = _float_stage_inputs(700, 300, 64, 3, 13, cuda_device)
    g = torch.Generator().manual_seed(2)
    tables = torch.randn((3, 8, 256), generator=g).to(cuda_device)
    codes = torch.randint(0, 256, (700, 300, 8), generator=g,
                          dtype=torch.uint8).to(cuda_device)
    corpus = lv.view(-1, 64)
    calls = _int8_calls(q, cents, lv, li, tables, codes, corpus)
    ops.drop_scales()
    first = [call() for call in calls]
    cached = [call() for call in calls]
    for call in calls:
        assert "group_amax_kernel" not in _planned_kernels(call)
    fresh = []
    for call in calls:
        ops.drop_scales()
        assert "group_amax_kernel" in _planned_kernels(call)
        fresh.append(call())
    for a, b_, c in zip(first, cached, fresh):
        for x, y, z in zip(a, b_, c):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda_only
def test_cuda_in_place_edit_recomputes_the_scales(cuda_device):
    """An in-place edit of ``list_vecs`` (its ``_version`` moves) makes the
    next int8 call run the scale pass again: its result is the plain
    version's on the edited lists, not the old scales'; a second index of
    the same shape keeps its own scales, and a freed index drops its."""
    shape = (300, 200, 32, 2, 8, 10)
    q, cents, lv, li, _ = _inputs(shape, cuda_device)
    sel = ref.fused_turn_ivf(q, cents, lv, li, nprobe=8, k=10)[2]

    def both(lists):
        got = ops.fused_scan(q, lists, li, sel, 10, precision="int8")
        want = ref.fused_scan_ivf(q, lists, li, sel, None, k=10,
                                  precision="int8", r=20)
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)

    ops.drop_scales()
    both(lv)
    other = lv.clone()
    other[:, :, 0] *= 3
    both(other)
    lv[:, :, 1] *= 5                       # in place
    assert "group_amax_kernel" in _planned_kernels(
        lambda: ops.fused_scan(q, lv, li, sel, 10, precision="int8"))
    both(lv)
    both(other)
    n = len(ops._scales)
    del other
    assert len(ops._scales) == n - 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
def test_cuda_chained_turns_on_two_streams(cuda_device, precision):
    """The row-4 and row-5 turns (stage 1, then the scan chained behind
    it by programmatic dependent launch) called on two streams at once
    equal the same calls made in turn, and leave the counters zeroed."""
    from repro_torch.kernels import launcher
    q, cents, lv, li = _float_stage_inputs(2000, 300, 64, 2, 17, cuda_device)
    g = torch.Generator().manual_seed(4)
    tables = torch.randn((2, 8, 256), generator=g).to(cuda_device)
    codes = torch.randint(0, 256, (2000, 300, 8), generator=g,
                          dtype=torch.uint8).to(cuda_device)
    corpus = lv.view(-1, 64)

    def calls(n):
        return (list(ops.fused_turn(q[n:n + 1], cents, lv, li, nprobe=64,
                                    k=10, precision=precision))
                + list(ops.fused_turn_pq(q[n:n + 1], cents, tables[n:n + 1],
                                         codes, li, corpus, nprobe=64, k=10,
                                         rerank=64, precision=precision)))

    alone = [calls(0), calls(1)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for n, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[n].append(calls(n))
    torch.cuda.synchronize()
    for n in range(2):
        for got in outs[n]:
            for a, b_ in zip(got, alone[n]):
                assert torch.equal(a, b_)
        with torch.cuda.stream(streams[n]):
            buf = launcher.arrival_counters(cuda_device, 1)
        assert int(buf.abs().sum()) == 0


SERVED_KERNELS = {
    "pq_adc_scan": 1, "fused_scan_pq": 1, "fused_scan": 1, "fused_turn": 2,
    "fused_turn_pq": 2}


# fused_turn_pq's edges (p, lmax, d, B, nprobe, k, m, rerank): p below
# one 128-centroid chunk and not a multiple of one; d 4 and 3,632 (the
# widest check_width takes: 8 staged queries in half a block's shared
# memory); B 1, 8, 25, 32 and 33 (the query tiles' edges); re-rank depths
# 1, 63 and 64; B = 1 over 17 chunks folds stage 1 in two groups
PQ_EDGE_SHAPES = [(100, 40, 16, 1, 8, 1, 8, 1), (300, 50, 4, 8, 16, 10, 4, 63),
                  (1000, 30, 3632, 25, 8, 10, 16, 64),
                  (300, 130, 16, 32, 16, 10, 8, 64),
                  (300, 130, 16, 33, 16, 10, 8, 63),
                  (2100, 60, 32, 1, 64, 10, 16, 64)]


def _pq_edge_inputs(shape, dev):
    """Integer queries, centroids, LUTs, codes and corpus rows over
    ragged lists (list 0 empty; ids < 500 repeat)."""
    p, lmax, d, b, nprobe, k, m, _ = shape
    rng = np.random.default_rng(p + lmax + d + b)
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 5, size=(p, d)).astype(np.float32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    real = np.arange(lmax)[None] < sizes[:, None]
    li = np.where(real, np.arange(p * lmax).reshape(p, lmax) % 500, -1)
    tables = rng.integers(-4, 5, size=(b, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(p, lmax, m)).astype(np.uint8)
    corpus = rng.integers(-4, 5, size=(500, d)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in
            (q, cents, tables, codes, li.astype(np.int32), corpus)]


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
@pytest.mark.parametrize("shape", PQ_EDGE_SHAPES)
def test_cuda_fused_turn_pq_edges_equal_plain_version(cuda_device, shape,
                                                      precision):
    """Row 5 at its edges, bit-equal to the plain version (values, ids,
    sel) at every precision."""
    p, lmax, d, b, nprobe, k, m, rerank = shape
    q, cents, tables, codes, li, corpus = _pq_edge_inputs(shape,
                                                          cuda_device)
    r = max(k, min(rerank, nprobe * lmax))
    got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=k, rerank=rerank,
                            precision=precision)
    want = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                             nprobe=nprobe, k=k, r=r, precision=precision)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda_only
@pytest.mark.parametrize("precision", ("f32",) + QUANT)
def test_cuda_kernels_a_call_at_the_served_shape(cuda_device, precision):
    """Rows 3-7 at the served shape (B = 1, nprobe 64, Lmax 702, d 768,
    k 10, PQ m 48 x 256, re-rank depth 64; 1,024 lists stand for the
    index's 16,384): after an int8 call's first, rows 3, 6 and 7 run one
    kernel a call and rows 4 and 5 two, in the plans and in the
    profiler's trace."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    d, lmax, n_lists = 768, 702, 1024
    cents_l = torch.randn((n_lists, d), generator=g, device=cuda_device)
    lv = torch.randn((n_lists, lmax, d), generator=g, device=cuda_device)
    li = torch.randint(-1, 50_000, (n_lists, lmax), generator=g,
                       device=cuda_device, dtype=torch.int32)
    q = torch.randn((1, d), generator=g, device=cuda_device)
    tables = torch.randn((1, 48, 256), generator=g, device=cuda_device)
    codes = torch.randint(0, 256, (n_lists, lmax, 48), generator=g,
                          device=cuda_device, dtype=torch.uint8)
    corpus = torch.randn((50_000, d), generator=g, device=cuda_device)
    sel = ops.centroid_topk(q, cents_l, 64)[1]
    calls = {
        "fused_turn": lambda: ops.fused_turn(q, cents_l, lv, li, nprobe=64,
                                             k=10, precision=precision),
        "fused_scan": lambda: ops.fused_scan(q, lv, li, sel, 10,
                                             precision=precision),
        "fused_turn_pq": lambda: ops.fused_turn_pq(
            q, cents_l, tables, codes, li, corpus, nprobe=64, k=10,
            rerank=64, precision=precision),
        "fused_scan_pq": lambda: ops.fused_scan_pq(
            tables, q, codes, li, sel, corpus, 10, rerank=64,
            precision=precision)}
    if precision == "f32":
        calls["pq_adc_scan"] = lambda: ops.pq_adc_scan(tables, codes, li,
                                                       sel, 64)
    for name, call in calls.items():
        call()                              # the int8 scales, once
        plan = _planned_kernels(call)
        assert len(plan) == SERVED_KERNELS[name], (name, plan)
        names = _traced_kernels(call, cuda_device)
        assert len(names) == len(plan), (name, names)
        assert all(k in n for k, n in zip(plan, names)), (name, names)


# ---------------------------------------------------------------------------
# the ADC scan (csrc/pq_adc.cu): from B = 8 the LUT landed by one bulk
# copy a block, each entry converted as it is read, at B = 1 staged by
# the block's threads; held to the plain version at every depth and on
# tied lists, and the scans' in-launch fold to merge_kernel on tied lists
# ---------------------------------------------------------------------------

# Lmax -> slices a list: 1, 3, 6, 8 and 9
ADC_LMAX = [128, 300, 702, 1024, 1100]


def _adc_lists(lmax, b, nprobe, m, dev, seed, values=(-4, 5)):
    """Integer LUTs (B, m, 256) in [lo, hi) (the ADC sums are exact, and
    dense ties fall within and across slices and lists), codes and ids
    of nprobe + 2 lists of Lmax rows (list 0 all pads, list 1 shorter
    than one slice, list 2 full, the rest ragged; ids repeat), and probe
    sets that hold lists 0-2 and repeats."""
    rng = np.random.default_rng(seed)
    p = nprobe + 2
    tables = rng.integers(*values, size=(b, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(p, lmax, m)).astype(np.uint8)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[:3] = (0, min(50, lmax), lmax)
    real = np.arange(lmax)[None] < sizes[:, None]
    li = np.where(real, rng.integers(0, 10_000, size=(p, lmax)), -1)
    sel = rng.integers(0, p, size=(b, nprobe))
    sel[:, :3] = (0, 1, 2)
    return [torch.from_numpy(x).to(dev) for x in
            (tables, codes, li.astype(np.int32), sel.astype(np.int32))]


def _adc_equal(tables, codes, li, sel, r_pad):
    """The ADC scan's binding at r_pad: values, ids and flat positions
    equal the plain ADC top r_pad, pads (-inf, -1, PAD_POS) included."""
    from repro_torch.kernels import pq_adc
    got = pq_adc.pq_adc_scan(tables, codes, li, sel, r_pad=r_pad)
    want = ref.fused_scan_pq(tables, None, codes, li, sel, None, None,
                             k=r_pad, r=r_pad, rerank=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("r_pad", [16, 64, 128, 256])
@pytest.mark.parametrize("lmax", ADC_LMAX)
def test_cuda_adc_scan_depths_and_widths(cuda_device, lmax, r_pad, b):
    """Row 3 at 1, 3, 6, 8 and 9 slices a list, B = 1 and 3 (the LUT
    staged by the threads) and 8 (by bulk copies), and r_pad 16, 64, 128
    (folded in the launch) and 256 (merge_kernel after it): bit-equal to
    the plain version, on lists that are all pads, shorter than one
    slice, full and ragged."""
    nprobe = 12
    plan = tiling.plan_adc(b, nprobe, lmax, 16, 256, r_pad)
    assert (len(plan) == 1) == (r_pad <= 128)
    _adc_equal(*_adc_lists(lmax, b, nprobe, 16, cuda_device,
                           lmax + r_pad), r_pad)


def test_entries_pass_the_arguments_their_signatures_declare(monkeypatch):
    """Every ops entry hands its C entry as many arguments as
    ``_build.SIGNATURES`` declares, the stream (which ``launcher.run``
    appends) aside: the analysis pass's probes and the PQ scan, on meta
    tensors, with the ADC scan's instance by the batch and forced."""
    from repro_torch.analysis import kernel_budget as KB
    from repro_torch.kernels import launcher
    seen = {}

    def run(entry, plan, device, *args):
        seen.setdefault(entry, set()).add(len(args))

    monkeypatch.setattr(launcher, "run", run)
    meta = torch.device("meta")
    with launcher.record_launches():
        for probe in KB.default_probes():
            probe.call(*probe.tensors(meta), device=meta)
        t = torch.empty((2, 16, 256), device=meta)
        codes = torch.empty((64, 300, 16), dtype=torch.uint8, device=meta)
        li = torch.empty((64, 300), dtype=torch.int32, device=meta)
        sel = torch.empty((2, 8), dtype=torch.int32, device=meta)
        q = torch.empty((2, 64), device=meta)
        cents = torch.empty((64, 64), device=meta)
        corpus = torch.empty((1000, 64), device=meta)
        for bulk in (None, False, True):
            ops.fused_scan_pq(t, q, codes, li, sel, corpus, 10, rerank=32,
                              device=meta, adc_bulk=bulk)
            ops.pq_adc_scan(t, codes, li, sel, 10, device=meta,
                            adc_bulk=bulk)
            ops.fused_turn_pq(q, cents, t, codes, li, corpus, nprobe=8,
                              k=10, rerank=32, device=meta, adc_bulk=bulk)
    assert {"pq_adc_scan_f32", "fused_scan_pq", "fused_turn_pq",
            "fused_turn_ivf", "fused_scan_ivf"} <= set(seen)
    for entry, counts in seen.items():
        assert counts == {len(_build.SIGNATURES[entry]) - 1}, entry


@pytest.mark.parametrize("b", [1, 2, 32])
def test_adc_instance_plans_by_batch_or_forced(b):
    """The ADC scan's plan takes the bulk instance (its mbarrier's
    static bytes) from ``ADC_BULK_MIN_B`` queries, or as forced."""
    def static(bulk):
        (launch,) = tiling.plan_adc(b, 8, 300, 16, 256, 64, bulk=bulk)
        return launch.smem_bytes
    assert static(True) - static(False) == tiling.ADC_BULK_SMEM
    assert static(None) == static(b >= tiling.ADC_BULK_MIN_B)


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
def test_cuda_adc_instances_give_the_same_bits(cuda_device, b):
    """Rows 3, 7 and 5 with the ADC scan's instance forced, the LUT by a
    bulk copy or staged by the threads, at every batch the engine serves
    and every precision: the same bits as the instance the batch picks
    (which the tests above hold to the plain versions)."""
    nprobe, k, rerank = 16, 10, 64
    shape = (nprobe + 2, 702, 16, b, nprobe, k, 48, 256, rerank)
    q, cents, tables, codes, li, corpus, _ = _pq_inputs(shape, cuda_device)
    r = ops._fused_depth(k, nprobe * 702, rerank)
    sel = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                            nprobe=nprobe, k=k, r=r)[2]
    runs = {"row3": lambda bulk, prec: ops.pq_adc_scan(
                tables, codes, li, sel, rerank, adc_bulk=bulk),
            "row7": lambda bulk, prec: ops.fused_scan_pq(
                tables, q, codes, li, sel, corpus, k, rerank=rerank,
                precision=prec, adc_bulk=bulk),
            "row5": lambda bulk, prec: ops.fused_turn_pq(
                q, cents, tables, codes, li, corpus, nprobe=nprobe, k=k,
                rerank=rerank, precision=prec, adc_bulk=bulk)}
    for name, run in runs.items():
        for prec in ("f32",) + (QUANT if name != "row3" else ()):
            outs = [run(bulk, prec) for bulk in (None, False, True)]
            for o in outs[1:]:
                for g, w in zip(o, outs[0]):
                    assert torch.equal(g, w), (name, prec)


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("lmax", [702, 1100])
@pytest.mark.parametrize("values", [(1, 2), (0, 2)])
def test_cuda_adc_scan_exact_ties(cuda_device, lmax, values, b):
    """Every ADC sum equal (a LUT of ones), or few distinct sums (0 / 1
    entries): ties across the slices of one list and across the 64
    lists of a query, decided by the flat position."""
    _adc_equal(*_adc_lists(lmax, b, 64, 8, cuda_device, 5, values), 64)


@pytest.mark.cuda_only
def test_cuda_adc_scan_lists_all_pads_or_short(cuda_device):
    """A query whose probed lists are all pads gets only pads; one whose
    lists are shorter than one slice gets fewer real entries than
    r_pad."""
    tables, codes, li, sel = _adc_lists(702, 2, 8, 16, cuda_device, 3)
    sel[0] = 0              # all pads
    sel[1] = 1              # 50 rows, repeated: 400 candidates
    _adc_equal(tables, codes, li, sel, 64)
    sel[1, 1:] = 0          # one list of 50 rows: fewer than r_pad
    _adc_equal(tables, codes, li, sel, 64)
    for row in range(2):    # each alone: B = 1
        _adc_equal(tables[row:row + 1].contiguous(), codes, li,
                   sel[row:row + 1].contiguous(), 64)


@pytest.mark.cuda_only
def test_cuda_adc_scan_at_b25_served_shape(cuda_device):
    """B = 25 at the served shape's widths (nprobe 64, Lmax 702, m = 48 x
    256 codes, r_pad 64): 9,600 blocks, bit-equal."""
    _adc_equal(*_adc_lists(702, 25, 64, 48, cuda_device, 25), 64)


@pytest.mark.cuda_only
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("lmax", [702, 1100])
def test_cuda_quantised_adc_rows_as_read(cuda_device, lmax, precision, b):
    """Rows 5 and 7 at bf16 and int8 take the ADC kernel (each table
    entry rounded or quantised as it is read; int8's scale from the
    shared copy): fused_scan_pq with an ``own`` mask, with and without
    its re-rank, and fused_turn_pq, bit-equal to the plain versions, at
    B = 1 and 3 (the LUT staged by the threads) and B = 8 (by bulk
    copies), 6 and 9 slices a list."""
    nprobe, k, rerank = 16, 10, 64
    shape = (nprobe + 2, lmax, 16, b, nprobe, k, 16, 256, rerank)
    q, cents, tables, codes, li, corpus, own = _pq_inputs(shape,
                                                          cuda_device)
    r = ops._fused_depth(k, nprobe * lmax, rerank)
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
@pytest.mark.parametrize("k", [10, 64])
def test_cuda_fold_equals_the_merges_on_tied_lists(cuda_device, k,
                                                   monkeypatch):
    """Row 6's fold merges the query's 64 lists in its launch; with the
    fold off, merge_kernel merges the same lists after it.  On lists
    whose scores tie in many places (integer rows and queries in [-1,
    1]) both give the same bits, and the plain version's."""
    p, lmax, d, b, nprobe = 80, 300, 16, 4, 64
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.integers(-1, 2, size=(b, d)).astype(
        np.float32)).to(cuda_device)
    lv = torch.from_numpy(rng.integers(-1, 2, size=(p, lmax, d)).astype(
        np.float32)).to(cuda_device)
    li = torch.from_numpy((np.arange(p * lmax) % 5000).reshape(p, lmax)
                          .astype(np.int32)).to(cuda_device)
    sel = torch.from_numpy(rng.integers(0, p, size=(b, nprobe)).astype(
        np.int32)).to(cuda_device)
    assert tiling.scan_fold(nprobe, lmax, tiling.next_pow2(k))
    folded = ops.fused_scan(q, lv, li, sel, k)
    with monkeypatch.context() as m:
        _unfolded(m)
        merged = ops.fused_scan(q, lv, li, sel, k)
    want = ref.fused_scan_ivf(q, lv, li, sel, None, k=k)
    for f, g, w in zip(folded, merged, want):
        assert torch.equal(f, g) and torch.equal(f, w)
