"""Launches of the fused IVF turn kernels (``csrc/fused_turn.cu``).

Counterpart of ``repro/kernels/fused_turn.py`` (family ivf, f32 / bf16 /
int8): the kernels themselves are CUDA C++ for sm_90a, bound through
ctypes (``_build``).  These functions take CUDA tensors only, check what
the kernels take (device, dtype, shape, contiguity, 16-byte rows),
allocate outputs and scratch, and hand the entry, its launch plan
(``tiling.plan_*``) and its arguments to ``launcher.run``, which
launches on PyTorch's current stream without synchronising and raises
if a launch was refused (or records the plan under
``launcher.record_launches``, where meta tensors pass these checks).
Padding and the choice between kernel and plain version belong to
``ops.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import launcher
from repro_torch.kernels import tiling
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: the fused ops' precisions, in the order of their kernel codes
#: (csrc/fused_common.cuh Precision); ops.check_precision checks them
PRECISIONS = ("f32", "bf16", "int8")
PRECISION_CODE = {p: code for code, p in enumerate(PRECISIONS)}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int
           ) -> None:
    launcher.check_device(name, t)
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype in (torch.float32, torch.bfloat16) and not launcher.aligned(t):
        raise ValueError(f"{name}: rows are read 16 bytes at a time and "
                         f"must be 16-byte aligned")


def _check_lists(queries: torch.Tensor, list_vecs: torch.Tensor,
                 list_ids: torch.Tensor, nprobe: int, r_pad: int) -> None:
    _check("queries", queries, torch.float32, 2)
    _check("list_vecs", list_vecs, torch.float32, 3)
    _check("list_ids", list_ids, torch.int32, 2)
    p, lmax, d = list_vecs.shape
    if queries.shape[1] != d or tuple(list_ids.shape) != (p, lmax):
        raise ValueError(f"shapes disagree: queries {tuple(queries.shape)}, "
                         f"list_vecs {tuple(list_vecs.shape)}, list_ids "
                         f"{tuple(list_ids.shape)}")
    if queries.device != list_vecs.device or queries.device != list_ids.device:
        raise ValueError("queries and lists lie on different devices")
    tiling.check_width(d)
    if queries.shape[0] > tiling.MAX_GRID_Y:
        raise ValueError(f"batch {queries.shape[0]} > {tiling.MAX_GRID_Y}")
    if nprobe * lmax >= PAD_POS:
        raise ValueError("flat scan positions overflow int32")


def _buffers(shape, dev) -> Triple:
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def check_depth(r: int, r_pad: int, kp: int) -> None:
    """The depths of a re-rank: its top kp of the top r of r_pad."""
    if not (0 < kp <= r_pad and 0 < r <= r_pad and r_pad <= tiling.MAX_PAD):
        raise ValueError(f"need kp <= r_pad and r <= r_pad <= "
                         f"{tiling.MAX_PAD}: kp={kp}, r={r}, r_pad={r_pad}")


def fold_counters(dev, scan: int, select: int = 0):
    """(scan's, stage 1's) arrival counters, each a view of ``scan`` or
    ``select`` zeroed ints of the stream's buffer
    (``launcher.arrival_counters``), or None when 0: disjoint, so a scan
    chained behind stage 1 never shares stage 1's."""
    if scan + select == 0:
        return None, None
    buf = launcher.arrival_counters(dev, scan + select)
    return (buf[:scan] if scan else None,
            buf[scan:scan + select] if select else None)


def scan_lists(b: int, nprobe: int, lmax: int, r_pad: int, dev,
               select: int = 0):
    """The scan blocks' lists and the fold's counters: ((cand_v, cand_i,
    cand_p, cand_n, counters), s1_counters): one slot of min(r_pad, 128)
    entries and a count per (query, probe, 128-row slice; the IVF and
    ADC scans slice alike), and what the merge adds past them; the scan's
    counters when its launch folds the lists itself (``tiling.scan_fold``)
    and ``select`` counters for stage 1's fold, each else None."""
    n_lists = nprobe * tiling.scan_split(lmax)
    w = min(r_pad, tiling.SCAN_ROWS)
    cand = _buffers(b * (n_lists * w + tiling.merge_scratch(n_lists, r_pad,
                                                             w)), dev)
    counts = torch.empty(b * n_lists, dtype=torch.int32, device=dev)
    fold = b * nprobe + b if tiling.scan_fold(nprobe, lmax, r_pad) else 0
    counters, s1_counters = fold_counters(dev, fold, select)
    return (*cand, counts, counters), s1_counters


def check_scales(name: str, amax: Optional[torch.Tensor], shape,
                 precision: str) -> None:
    """int8 takes the index's cached group amax (``ops``): int32 of
    ``shape``; the other precisions none."""
    if precision != "int8":
        return
    if amax is None:
        raise ValueError(f"{name}: int8 needs the index's group amax")
    _check(name, amax, torch.int32, len(shape))
    if tuple(amax.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got "
                         f"{tuple(amax.shape)}")


def group_amax(x: torch.Tensor, blk: int, n_groups: int) -> torch.Tensor:
    """The one-time int8 scale pass: the largest |x| of every group of
    ``blk`` rows of each set of ``x`` (n_sets, set_rows, d) float32, as
    the int32 bits of a non-negative float, (n_sets, n_groups)."""
    _check("x", x, torch.float32, 3)
    n_sets, set_rows, d = x.shape
    tiling.check_width(d)
    if blk < 1 or n_groups * blk < set_rows:
        raise ValueError(f"{n_groups} groups of {blk} rows do not cover "
                         f"{set_rows} rows")
    out = torch.empty((n_sets, n_groups), dtype=torch.int32, device=x.device)
    launcher.run("group_amax", tiling.plan_group_amax(n_sets, set_rows),
                 x.device, x, n_sets, set_rows, d, blk, n_groups, out)
    return out


def _scan_scratch(b: int, nprobe: int, lmax: int, d: int, r_pad: int,
                  kp: int, precision: str, dev, select: int = 0):
    """(lists, s1_counters, mid, out, blk_l, n_groups) of a scan: the scan
    blocks' lists and counters (``scan_lists``), the quantised paths' top
    r_pad before a re-rank the launch does not fold, the output ((B,
    r_pad) for f32, (B, kp) after a re-rank) and the int8 groups."""
    lists, s1_counters = scan_lists(b, nprobe, lmax, r_pad, dev, select)
    if precision == "f32":
        return lists, s1_counters, (None, None, None), \
            _buffers((b, r_pad), dev), 1, 1
    blk_l, n_groups = tiling.list_groups(lmax, d, r_pad)
    mid = ((None, None, None) if lists[-1] is not None
           else _buffers((b, r_pad), dev))
    return (lists, s1_counters, mid, _buffers((b, kp), dev), blk_l,
            n_groups)


def fused_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
               list_ids: torch.Tensor, sel: torch.Tensor,
               own: Optional[torch.Tensor], *, r_pad: int,
               precision: str = "f32", r: int = 0, kp: int = 0,
               amax: Optional[torch.Tensor] = None) -> Triple:
    """Scan the probed lists ``sel`` (B, nprobe) int32; ``own`` (B,
    nprobe) int32 or None.  f32 returns the top ``r_pad`` (values, ids,
    flat positions probe*lmax + offset), pads ``(-inf, -1, PAD_POS)``;
    bf16 / int8 the float32 top ``kp`` of the quantised top ``r``
    (values, ids, candidate ranks); int8 reads ``amax`` (p, n_groups),
    the index's group amax (``group_amax`` over ``tiling.list_groups``).
    A B of 0 launches nothing."""
    b, nprobe = sel.shape
    p, lmax, d = list_vecs.shape
    _check_lists(queries, list_vecs, list_ids, nprobe, r_pad)
    if precision != "f32":
        check_depth(r, r_pad, kp)
    _check("sel", sel, torch.int32, 2)
    if own is not None:
        _check("own", own, torch.int32, 2)
        if own.shape != sel.shape:
            raise ValueError("own must match sel's shape")
    if queries.shape[0] != b:
        raise ValueError("queries and sel disagree on the batch")
    lists, _, mid, out, blk_l, n_groups = _scan_scratch(
        b, nprobe, lmax, d, r_pad, kp, precision, queries.device)
    check_scales("amax", amax, (p, n_groups), precision)
    launcher.run(
        "fused_scan_ivf",
        tiling.plan_fused_scan_ivf(b, nprobe, lmax, d, precision, r_pad),
        queries.device, queries, list_vecs, list_ids, p, sel, nprobe, own, b,
        nprobe, lmax, d, PRECISION_CODE[precision], blk_l, n_groups, amax, r,
        r_pad, kp, *lists, *mid, *out)
    return out


def centroid_scratch(b: int, p: int, d: int, np_pad: int, dev):
    """Stage 1's scratch: (s1_v, s1_i, sel_v, sel, counters): the chunk
    blocks' lists of min(np_pad, 128) and what their merge adds past
    them, the probe set, and the number of counters its fold takes
    (``tiling.select_counters`` when ``tiling.select_fold``, else 0)."""
    chunks = tiling.centroid_chunks(p)
    w1 = min(np_pad, tiling.CENTROID_CHUNK)
    n = b * (chunks * w1 + tiling.merge_scratch(chunks, np_pad, w1))
    tiles = (tiling.select_counters(b, p, d)
             if tiling.select_fold(b, p, d, np_pad) else 0)
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((b, np_pad), dtype=torch.float32, device=dev),
            torch.empty((b, np_pad), dtype=torch.int32, device=dev), tiles)


def fused_turn(queries: torch.Tensor, centroids: torch.Tensor,
               list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
               nprobe: int, np_pad: int, r_pad: int, precision: str = "f32",
               r: int = 0, kp: int = 0, amax: Optional[torch.Tensor] = None,
               c_amax: Optional[torch.Tensor] = None) -> Triple:
    """Whole turn: returns (values, ids, sel (B, np_pad)), values and ids
    (B, r_pad) for f32 and (B, kp) after the quantised paths' re-rank of
    their top ``r``; the first ``nprobe`` probes are scanned.  int8 reads
    the index's group amax: ``amax`` (p, n_groups) of the lists and
    ``c_amax`` (1, n_cgroups) of the centroids (``tiling.centroid_groups``).
    A B of 0 launches nothing."""
    b = queries.shape[0]
    p, lmax, d = list_vecs.shape
    _check_lists(queries, list_vecs, list_ids, nprobe, r_pad)
    if precision != "f32":
        check_depth(r, r_pad, kp)
    _check("centroids", centroids, torch.float32, 2)
    if tuple(centroids.shape) != (p, d):
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match "
                         f"{p} lists of width {d}")
    if not 0 < nprobe <= min(p, np_pad) or np_pad > tiling.MAX_PAD:
        raise ValueError(f"nprobe={nprobe}, np_pad={np_pad}, p={p}")
    dev = queries.device
    s1_v, s1_i, sel_v, sel, tiles = centroid_scratch(b, p, d, np_pad, dev)
    lists, s1_counters, mid, out, blk_l, n_groups = _scan_scratch(
        b, nprobe, lmax, d, r_pad, kp, precision, dev, tiles)
    blk_p, n_cgroups = tiling.centroid_groups(p, np_pad)
    check_scales("amax", amax, (p, n_groups), precision)
    check_scales("c_amax", c_amax, (1, n_cgroups), precision)
    launcher.run(
        "fused_turn_ivf",
        tiling.plan_fused_turn_ivf(b, p, nprobe, np_pad, lmax, d, precision,
                                   r_pad),
        dev, queries, centroids, list_vecs, list_ids, p, b, nprobe, np_pad,
        lmax, d, PRECISION_CODE[precision], blk_p, c_amax, blk_l, n_groups,
        amax, r, r_pad, kp, s1_v, s1_i, s1_counters, sel_v, sel, *lists,
        *mid, *out)
    return out[0], out[1], sel
