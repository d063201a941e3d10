"""The selection and merge networks of the IVF stage kernels, emulated.

``csrc/ivf_stages.cuh`` selects each block's best candidates with
warp-level bitonic networks (``topk_tie::warp_sort`` of 128 entries, 4 a
lane, or, for a scan's best 32 or fewer, four sorts of 32 merged
pairwise by ``topk_tie::warp_merge``) and folds the blocks' lists with
``topk_tie::merge_warps`` (lists of at most 128: warps fold them in
registers, then pairwise; the scan's two-level fold, a list's slices
then a query's lists, and the merge kernel) or ``topk_tie::merge_grow``
(lists narrower than the output, in the groups and passes of
``tiling.merge_plan``).  The card is needed to run
them, so these tests replay the same compare-exchange networks step for
step in plain PyTorch, on the same lists in the kernels' grouping, and
hold the result to ``sorting.block_topk_desc_tie`` (the plain versions'
order) and to ``lax.top_k`` over the real candidates (the reference's
order): exact ties, +0.0 above -0.0, all-pad and empty slices, real rows
scoring -inf, and top-k widths of 64, 1,024 and 2,048.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core.topk import order_key
from repro_torch.kernels import sorting, tiling
from repro_torch.kernels.sorting import PAD_POS

ROWS = 128  # tiling.SCAN_ROWS == tiling.CENTROID_CHUNK == tiling.PQ_ROWS


def ranks_before(va, pa, vb, pb):
    """csrc/topk_tie.cuh ranks_before: (value desc, position asc)."""
    ka, kb = order_key(va), order_key(vb)
    return (ka > kb) | ((ka == kb) & (pa < pb))


def _swap(t, lo, hi, mask):
    a, b = t[..., lo].clone(), t[..., hi].clone()
    t[..., lo] = torch.where(mask, b, a)
    t[..., hi] = torch.where(mask, a, b)


def warp_sort(v, i, p):
    """topk_tie::warp_sort over the last axis (32 N entries, entry e in
    lane e // N): each entry takes its partner's when the network says
    so, in the kernel's order of strides."""
    n = v.shape[-1]
    e = torch.arange(n)
    k = 2
    while k <= n:
        s = k // 2
        while s:
            part = e ^ s
            ov, oi, op = v[..., part], i[..., part], p[..., part]
            keep_better = ((e & s) == 0) == ((e & k) == 0)
            take = torch.where(keep_better, ranks_before(ov, op, v, p),
                               ranks_before(v, p, ov, op))
            v, i, p = (torch.where(take, o, x) for o, x in
                       ((ov, v), (oi, i), (op, p)))
            s //= 2
        k *= 2
    return v, i, p


def half_clean(t3, n_lists, w):
    v, i, p = t3
    hw = w // 2
    dist = hw
    while dist:
        t = torch.arange(n_lists * hw)
        e = t % hw
        lo = (t // hw) * w + 2 * e - (e & (dist - 1))
        hi = lo + dist
        m = ranks_before(v[..., hi], p[..., hi], v[..., lo], p[..., lo])
        for x in (v, i, p):
            _swap(x, lo, hi, m)
        dist //= 2


def merge_lists(t3, n_lists, w):
    """topk_tie::merge_lists: fold list half + t into list t, then a
    half-cleaner, until one list is left."""
    v, i, p = t3
    m = n_lists
    while m > 1:
        half = (m + 1) // 2
        pairs = m - half
        t = torch.arange(pairs * w)
        b = (half + t // w) * w + (w - 1 - t % w)
        take = ranks_before(v[..., b], p[..., b], v[..., t], p[..., t])
        for x in (v, i, p):
            x[..., t] = torch.where(take, x[..., b], x[..., t])
        half_clean(t3, pairs, w)
        m = half


def warp_merge(a, b):
    """topk_tie::warp_merge of two sorted warp lists of W entries: entry
    e keeps the better of a[e] and b[W-1-e], then a half-cleaner."""
    (av, ai, ap), (bv, bi, bp) = a, (x.flip(-1) for x in b)
    take = ranks_before(bv, bp, av, ap)
    v, i, p = (torch.where(take, y, x) for x, y in
               ((av, bv), (ai, bi), (ap, bp)))
    n = v.shape[-1]
    e = torch.arange(n)
    s = n // 2
    while s:
        part = e ^ s
        ov, oi, op = v[..., part], i[..., part], p[..., part]
        take = torch.where((e & s) == 0, ranks_before(ov, op, v, p),
                           ranks_before(v, p, ov, op))
        v, i, p = (torch.where(take, o, x) for o, x in
                   ((ov, v), (oi, i), (op, p)))
        s //= 2
    return v, i, p


def merge_warps(t3, n_lists, w, pad_id, nwarps):
    """topk_tie::merge_warps: warp t folds lists t, t + nwarps, ... (of
    w <= 128 entries, padded to a warp's 32 N) in registers, then the
    warps' best w merge pairwise through slots of w."""
    width = 32 if w <= 32 else 64 if w <= 64 else 128

    def load(l):
        out = pads(t3[0].shape[:-1] + (width,), pad_id)
        for x, y in zip(out, t3):
            x[..., :w] = y[..., l * w:(l + 1) * w]
        return out

    regs = {}
    for warp in range(min(nwarps, n_lists)):
        regs[warp] = load(warp)
        for l in range(warp + nwarps, n_lists, nwarps):
            regs[warp] = warp_merge(regs[warp], load(l))
    m = min(nwarps, n_lists)
    while True:
        for warp in range(m):
            for x, y in zip(t3, regs[warp]):
                x[..., warp * w:(warp + 1) * w] = y[..., :w]
        if m == 1:
            return
        half = (m + 1) // 2
        for warp in range(m - half):
            regs[warp] = warp_merge(regs[warp], load(warp + half))
        m = half


def merge_grow(t3, n_lists, w_in, w, pad_id):
    """topk_tie::merge_grow: pairs merge whole into lists of twice the
    width until the width is w (an odd last list paired with pads), then
    merge_lists.  Returns the width of list 0."""
    v, i, p = t3
    n, width = n_lists, w_in
    while width < w and n > 1:
        if n & 1:
            sl = slice(n * width, (n + 1) * width)
            v[..., sl], i[..., sl], p[..., sl] = -np.inf, pad_id, PAD_POS
            n += 1
        pairs = n // 2
        t = torch.arange(pairs * width)
        base = (t // width) * 2 * width
        e = t % width
        a, b = base + e, base + 2 * width - 1 - e   # a[e] vs b[width-1-e]
        better = ranks_before(v[..., b], p[..., b], v[..., a], p[..., a])
        new = []
        for x in (v, i, p):
            xa, xb = x[..., a], x[..., b]
            new.append((torch.where(better, xb, xa),
                        torch.where(better, xa, xb)))
        for x, (lo, up) in zip((v, i, p), new):
            x[..., base + e] = lo
            x[..., base + width + e] = up
        half_clean(t3, 2 * pairs, width)
        width *= 2
        n = pairs
    if n > 1:
        merge_lists(t3, n, width)
    return width


def pads(shape, pad_id):
    return (torch.full(shape, -np.inf), torch.full(shape, pad_id,
                                                   dtype=torch.int32),
            torch.full(shape, PAD_POS, dtype=torch.int32))


def block_lists(v, i, p, w, select=False):
    """Each 128-entry block of the last axis: its best w.  ``select``
    (the scan at w <= 32): four lists of 32 warp-sorted apart and merged
    pairwise; else one warp sort of all 128."""
    lead, n = v.shape[:-1], v.shape[-1]
    blocks = [x.reshape(*lead, n // ROWS, ROWS) for x in (v, i, p)]
    if select and w <= 32:
        lists = [warp_sort(*(x[..., k * 32:(k + 1) * 32] for x in blocks))
                 for k in range(4)]
        top = warp_merge(warp_merge(lists[0], lists[1]),
                         warp_merge(lists[2], lists[3]))
        return [x[..., :w].clone() for x in top]
    return [x[..., :w].clone() for x in warp_sort(*blocks)]


def merge_topk(lists, counts, w_in, w, pad_id):
    """csrc merge_topk_f32: each query's lists of w_in (``counts`` real
    entries each, or all) merged in the groups and passes of
    ``tiling.merge_plan`` into the best w."""
    v, i, p = (x.clone() for x in lists)
    b, n = v.shape[:2]
    if counts is not None:
        real = torch.arange(w_in)[None, None] < counts[..., None]
        v = torch.where(real, v, -np.inf)
        i = torch.where(real, i, pad_id)
        p = torch.where(real, p, PAD_POS)
    plan = tiling.merge_plan(n, w, w_in)
    first, later = tiling.merge_groups(w_in, w)
    width_in, group = w_in, first
    for _, groups in plan:
        outs = []
        for g in range(groups):
            sl = slice(g * group, min(n, (g + 1) * group))
            m = sl.stop - sl.start
            t3 = pads((b, m * width_in + (w if width_in < w else 0)), pad_id)
            for x, y in zip(t3, (v, i, p)):
                x[:, :m * width_in] = y[:, sl].reshape(b, -1)
            if width_in == w <= 128:
                merge_warps(t3, m, w, pad_id, nwarps=16)
                width = w
            else:
                width = merge_grow(t3, m, width_in, w, pad_id)
            out = pads((b, w), pad_id)
            for x, y in zip(out, t3):
                x[:, :width] = y[:, :width]
            outs.append(out)
        v, i, p = (torch.stack([o[k] for o in outs], 1) for k in range(3))
        n, width_in, group = groups, w, later
    return v[:, 0], i[:, 0], p[:, 0]


def scan_emulated(scores, ids, r_pad):
    """The scan of csrc ivf_stages.cuh for scores (B, nprobe, lmax) of
    rows with ids (-1: pad): each 128-row slice's best min(r_pad, 128)
    real entries, then the two-level fold when ``tiling.scan_fold``,
    else the merge.  Returns the top r_pad (values, ids, positions)."""
    b, nprobe, lmax = scores.shape
    nsplit = tiling.scan_split(lmax)
    w = min(r_pad, ROWS)
    full = nsplit * ROWS
    pos = (torch.arange(nprobe)[:, None] * lmax
           + torch.arange(lmax)[None]).expand(b, -1, -1)
    v, i, p = pads((b, nprobe, full), -1)
    real = ids >= 0
    v[..., :lmax] = torch.where(real, scores, -np.inf)
    i[..., :lmax] = ids
    p[..., :lmax] = torch.where(real, pos, PAD_POS).int()
    slices = block_lists(v, i, p, w, select=True)  # (B, nprobe, nsplit, w)
    counts = real.reshape(b, nprobe, -1) if lmax == full else torch.cat(
        [real, torch.zeros(b, nprobe, full - lmax, dtype=torch.bool)], -1)
    counts = counts.reshape(b, nprobe, nsplit, ROWS).sum(-1).clamp(max=w)
    if not tiling.scan_fold(nprobe, lmax, r_pad):
        return merge_topk([x.reshape(b, nprobe * nsplit, w) for x in slices],
                          counts.reshape(b, -1), w, r_pad, -1)
    assert w == r_pad
    lists = []
    for j in range(nprobe):   # level 1: a list's slices
        t3 = [x[:, j].reshape(b, nsplit * w).clone() for x in slices]
        real = (torch.arange(w)[None, None] < counts[:, j, :, None]
                ).reshape(b, -1)
        t3 = [torch.where(real, x, pad) for x, pad in
              zip(t3, (-np.inf, -1, PAD_POS))]
        merge_warps(t3, nsplit, w, -1, nwarps=8)
        lists.append([x[:, :w] for x in t3])
    t3 = [torch.cat([lst[k] for lst in lists], 1) for k in range(3)]
    merge_warps(t3, nprobe, w, -1, nwarps=8)         # level 2: the lists
    return tuple(x[:, :w] for x in t3)


def stage1_emulated(scores, kp):
    """Stage 1 of csrc ivf_stages.cuh on scores (B, p): each 128-centroid
    chunk's best min(kp, 128) (centroid index as id and position), then
    merge_topk_f32 to kp."""
    b, p = scores.shape
    chunks = tiling.centroid_chunks(p)
    w1 = min(kp, ROWS)
    v, i, _ = pads((b, chunks * ROWS), PAD_POS)
    v[:, :p] = scores
    i[:, :p] = torch.arange(p, dtype=torch.int32)
    lists = block_lists(v, i, i.clone(), w1)
    if not tiling.select_fold(b, p, 768, kp):
        return merge_topk(lists, None, w1, kp, PAD_POS)
    # the fold, in the launch: each group of SELECT_GROUP chunks' lists,
    # then the groups' (one group: its chunks)
    g = tiling.SELECT_GROUP
    groups = []
    for lo in range(0, chunks, g):
        n = min(g, chunks - lo)
        t3 = [x[:, lo:lo + n].reshape(b, -1).clone() for x in lists]
        if chunks > g:
            merge_warps(t3, n, w1, PAD_POS, nwarps=8)
            n = 1
        groups.append([x[:, :n * w1] for x in t3])
    t3 = [torch.cat([grp[k] for grp in groups], 1) for k in range(3)]
    merge_warps(t3, t3[0].shape[1] // w1, w1, PAD_POS, nwarps=8)
    return tuple(x[:, :kp] for x in t3)


def rerank_emulated(exact, cand_i, r, kp):
    """fold.cuh rerank_fold: candidate t of the fold's w (t < r, id >=
    0) keeps its exact score, the rest -inf and their id, position t;
    one warp sorts them (warp_sort of 32 N, pads past w) and keeps kp."""
    b, w = cand_i.shape
    t = torch.arange(w)
    es = torch.where((t < r) & (cand_i >= 0), exact, -np.inf)
    n = 32 if w <= 32 else 64 if w <= 64 else 128
    v, i, p = pads((b, n), -1)
    v[:, :w], i[:, :w], p[:, :w] = es, cand_i, t.int().expand(b, -1)
    v, i, p = warp_sort(v, i, p)
    return v[:, :kp], i[:, :kp], p[:, :kp]


def _want(v, i, p, k):
    return sorting.block_topk_desc_tie(v, i, p, k)


def _lax_order(scores, real, k):
    """Positions of lax.top_k over each row's real entries, flat order."""
    out = []
    for row, mask in zip(scores.numpy(), real.numpy()):
        cand = np.flatnonzero(mask)
        kk = min(k, cand.size)
        if kk == 0:
            out.append([])
            continue
        _, idx = jax.lax.top_k(jax.numpy.asarray(row[cand]), kk)
        out.append(cand[np.asarray(idx)].tolist())
    return out


def _scores(kind, shape, rng):
    """``ties`` integer scores in [-2, 2]; ``zeros`` +-0.0 and +-1;
    ``neginf`` real rows at -inf among finite ones."""
    if kind == "ties":
        return rng.integers(-2, 3, size=shape).astype(np.float32)
    if kind == "zeros":
        return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                          size=shape)
    s = rng.standard_normal(shape).astype(np.float32)
    s[rng.random(shape) < 0.4] = -np.inf
    return s


def _lists(kind, b, nprobe, lmax, seed):
    """Scores (``_scores``) and ids of probed lists of ragged sizes: one
    list empty, one a single row, one full, so slices past a list's end
    are all pads."""
    rng = np.random.default_rng(seed)
    s = _scores(kind, (b, nprobe, lmax), rng)
    sizes = rng.integers(0, lmax + 1, size=(b, nprobe))
    sizes[:, 0] = 0
    sizes[:, 1] = 1
    sizes[:, -1] = lmax
    real = np.arange(lmax)[None, None] < sizes[..., None]
    ids = np.where(real, rng.integers(0, 10_000, size=s.shape), -1)
    return torch.from_numpy(s), torch.from_numpy(ids.astype(np.int32))


# (kind, B, nprobe, lmax, r_pad): folded in the launch (r_pad <= 128) or
# merged after it (r_pad 1,024 / 2,048: slices of 128, merge_grow)
SCAN_CASES = [("ties", 2, 6, 300, 16), ("zeros", 2, 5, 130, 16),
              ("neginf", 2, 4, 260, 32), ("ties", 1, 3, 128, 128),
              ("ties", 2, 9, 40, 64), ("zeros", 1, 7, 300, 1024),
              ("neginf", 1, 6, 260, 2048)]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_selection_and_fold(case):
    kind, b, nprobe, lmax, r_pad = case
    scores, ids = _lists(kind, b, nprobe, lmax, r_pad + lmax)
    real = ids >= 0
    v, i, p = scan_emulated(scores, ids, r_pad)
    pos = (torch.arange(nprobe)[:, None] * lmax
           + torch.arange(lmax)[None]).expand(b, -1, -1)
    flat = [x.reshape(b, -1) for x in (
        torch.where(real, scores, -np.inf), ids,
        torch.where(real, pos, PAD_POS).int())]
    k = min(r_pad, flat[0].shape[1])
    wv, wi, wp = _want(*flat, k)
    assert torch.equal(v[:, :k], wv) and torch.equal(i[:, :k], wi)
    assert torch.equal(p[:, :k], wp)
    assert (p[:, k:] == PAD_POS).all()
    # +0.0 above -0.0 and the bits of each value, as lax.top_k keeps them
    assert torch.equal(order_key(v[:, :k]), order_key(wv))
    for row, want in enumerate(_lax_order(flat[0], real.reshape(b, -1),
                                          r_pad)):
        assert p[row, :len(want)].tolist() == want
        assert (p[row, len(want):] == PAD_POS).all()


def test_scan_selection_of_empty_queries():
    """Every list empty or foreign: the fold leaves only pads."""
    scores = torch.zeros((2, 4, 200))
    ids = torch.full((2, 4, 200), -1, dtype=torch.int32)
    v, i, p = scan_emulated(scores, ids, 16)
    assert (v == -np.inf).all() and (i == -1).all() and (p == PAD_POS).all()


# (kind, B, p, kp): p a multiple of 128, not one, and below one chunk;
# B = 1 at kp <= 128 folds in the launch (one group, or groups of 16)
STAGE1_CASES = [("ties", 2, 1000, 64), ("zeros", 2, 600, 64),
                ("neginf", 1, 2500, 1024), ("ties", 1, 2500, 2048),
                ("ties", 3, 100, 64), ("zeros", 1, 1300, 2048),
                ("ties", 1, 1000, 64), ("zeros", 1, 4000, 128),
                ("neginf", 1, 2100, 16)]


@pytest.mark.parametrize("case", STAGE1_CASES)
def test_stage1_selection_and_merge(case):
    kind, b, p, kp = case
    scores = torch.from_numpy(_scores(kind, (b, p),
                                      np.random.default_rng(p + kp)))
    v, i, pos = stage1_emulated(scores, kp)
    idx = torch.arange(p, dtype=torch.int32).expand(b, -1)
    k = min(kp, p)
    wv, wi, _ = _want(scores, idx, idx, k)
    assert torch.equal(v[:, :k], wv) and torch.equal(i[:, :k], wi)
    assert torch.equal(order_key(v[:, :k]), order_key(wv))
    assert (i[:, k:] == PAD_POS).all() and (v[:, k:] == -np.inf).all()
    assert torch.equal(pos, i)
    for row, want in enumerate(_lax_order(scores, torch.ones_like(
            scores, dtype=torch.bool), kp)):
        assert i[row, :len(want)].tolist() == want


@pytest.mark.parametrize("w_in,w,n", [(128, 1024, 300), (64, 64, 400),
                                      (128, 2048, 17), (16, 16, 5)])
def test_merge_plan_groups_fit_one_block(w_in, w, n):
    """Every pass's block holds its group's lists (and, while the width
    grows, one list of w) in the shared memory the plan asks for."""
    smem = tiling.merge_smem(n, w, w_in)
    first, later = tiling.merge_groups(w_in, w)
    spare = w if w_in < w else 0
    assert smem <= tiling.SMEM_BLOCK_BYTES
    assert (min(n, first) * w_in + spare) * tiling.MERGE_ENTRY_BYTES <= smem
    for n_in, groups in tiling.merge_plan(n, w, w_in)[1:]:
        assert min(n_in, later) * w * tiling.MERGE_ENTRY_BYTES <= smem
    assert tiling.merge_plan(n, w) == tiling.merge_plan(n, w, w)


# (kind, B, nprobe, lmax, r_pad, m): the ADC scan folded in its launch
# and re-ranked there (r_pad <= 128), or merged after it (1,024)
ADC_CASES = [("ties", 2, 6, 300, 64, 8), ("zeros", 2, 5, 130, 16, 4),
             ("ties", 1, 9, 702, 64, 16), ("ties", 2, 3, 128, 128, 8),
             ("zeros", 1, 7, 300, 1024, 4)]


@pytest.mark.parametrize("case", ADC_CASES)
def test_adc_selection_fold_and_rerank(case):
    """The ADC scan (csrc/pq_adc.cu adc_scan_kernel) selects and folds as
    the IVF scan does, over 128-row slices: replayed on ADC sums of
    integer (or +-0) LUTs, its top r equals the plain ``pq_adc_scan``
    and ``lax.top_k``; the fold's re-rank (fold.cuh rerank_fold) of the
    first r candidates equals the plain ``fused_scan_pq``."""
    from repro_torch.kernels import ref
    kind, b, nprobe, lmax, r_pad, m = case
    assert tiling.PQ_ROWS == ROWS
    rng = np.random.default_rng(r_pad * lmax + m)
    tables = torch.from_numpy(_scores(kind, (b, m, 256), rng))
    codes = torch.from_numpy(rng.integers(0, 256, size=(nprobe, lmax, m)
                                          ).astype(np.uint8))
    _, ids = _lists("ties", 1, nprobe, lmax, r_pad + m)
    ids = ids[0]
    sel = torch.arange(nprobe, dtype=torch.int32).expand(b, -1).contiguous()
    scores = ref.adc_sum(tables, codes.reshape(1, -1, m).expand(b, -1, -1)
                         ).reshape(b, nprobe, lmax)
    v, i, p = scan_emulated(scores, ids.expand(b, -1, -1), r_pad)
    r = r_pad - r_pad // 4
    wv, wi = ref.pq_adc_scan_batch(tables, codes, ids, sel, r)
    assert torch.equal(v[:, :r], wv) and torch.equal(i[:, :r], wi)
    assert torch.equal(order_key(v[:, :r]), order_key(wv))
    real = (ids >= 0).expand(b, -1, -1).reshape(b, -1)
    for row, want in enumerate(_lax_order(scores.reshape(b, -1), real, r)):
        assert p[row, :len(want)].tolist() == want
    if not tiling.scan_fold(nprobe, lmax, r_pad):
        return
    d = 8
    corpus = torch.from_numpy(rng.integers(-3, 4, size=(10_000, d)
                                           ).astype(np.float32))
    q = torch.from_numpy(rng.integers(-3, 4, size=(b, d)).astype(np.float32))
    exact = ref.gemv_rows(corpus[i.long().clamp_min(0)], q)
    k = 8
    got = rerank_emulated(exact, i, r, k)
    want = ref.fused_scan_pq(tables, q, codes, ids, sel, None, corpus, k=k,
                             r=r, rerank=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
