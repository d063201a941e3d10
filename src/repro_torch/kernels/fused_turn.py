"""Launches of the fused IVF turn kernels (``csrc/fused_turn.cu``).

Counterpart of ``repro/kernels/fused_turn.py`` (family ivf, f32 / bf16 /
int8): the kernels themselves are CUDA C++ for sm_90a, bound through
ctypes (``_build``).  These functions take CUDA tensors only, check what
the kernels take (device, dtype, shape, contiguity, 16-byte rows),
allocate outputs and scratch, launch on PyTorch's current stream without
synchronising, and raise if a launch was refused.  Padding and the choice
between kernel and plain version belong to ``ops.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import tiling
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: the fused ops' precisions, in the order of their kernel codes
#: (csrc/fused_common.cuh Precision); ops.check_precision checks them
PRECISIONS = ("f32", "bf16", "int8")
PRECISION_CODE = {p: code for code, p in enumerate(PRECISIONS)}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int
           ) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype == torch.float32 and t.data_ptr() % 16:
        raise ValueError(f"{name}: rows are read as float4 and must be "
                         f"16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


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


def _scan_scratch(b: int, nprobe: int, lmax: int, d: int, r_pad: int,
                  kp: int, precision: str, dev):
    """(cand, mid, out, amax, blk_l, n_groups) of a scan: the scan
    blocks' lists, the quantised paths' top r_pad before the re-rank,
    the output ((B, r_pad) for f32, (B, kp) after a re-rank) and the
    int8 list-group amax."""
    cand = _buffers(b * nprobe * tiling.scan_split(lmax) * r_pad, dev)
    if precision == "f32":
        return cand, (None, None, None), _buffers((b, r_pad), dev), \
            None, 1, 1
    blk_l, n_groups = tiling.list_groups(lmax, d, r_pad)
    amax = (torch.empty(b * nprobe * n_groups, dtype=torch.int32, device=dev)
            if precision == "int8" else None)
    return (cand, _buffers((b, r_pad), dev), _buffers((b, kp), dev), amax,
            blk_l, n_groups)


def fused_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
               list_ids: torch.Tensor, sel: torch.Tensor,
               own: Optional[torch.Tensor], *, r_pad: int,
               precision: str = "f32", r: int = 0, kp: int = 0) -> Triple:
    """Scan the probed lists ``sel`` (B, nprobe) int32; ``own`` (B,
    nprobe) int32 or None.  f32 returns the top ``r_pad`` (values, ids,
    flat positions probe*lmax + offset), pads ``(-inf, -1, PAD_POS)``;
    bf16 / int8 the float32 top ``kp`` of the quantised top ``r``
    (values, ids, candidate ranks).  A B of 0 launches nothing."""
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
    cand, mid, out, amax, blk_l, n_groups = _scan_scratch(
        b, nprobe, lmax, d, r_pad, kp, precision, queries.device)
    if b == 0:
        return out
    with torch.cuda.device(queries.device):
        err = _build.lib().fused_scan_ivf(
            _ptr(queries), _ptr(list_vecs), _ptr(list_ids), p, _ptr(sel),
            nprobe, _ptr(own), b, nprobe, lmax, d, PRECISION_CODE[precision],
            blk_l, n_groups, _ptr(amax), r, r_pad, kp,
            tiling.merge_group(r_pad), *map(_ptr, cand), *map(_ptr, mid),
            *map(_ptr, out), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"fused_scan_ivf ({precision})")
    return out


def centroid_scratch(b: int, p: int, np_pad: int, precision: str, dev):
    """Stage 1's scratch: (s1_v, s1_i, sel_v, sel, c_amax, blk_p,
    n_cgroups); c_amax is None unless int8."""
    n = b * tiling.centroid_chunks(p) * np_pad
    blk_p, n_cgroups = tiling.centroid_groups(p, np_pad)
    c_amax = (torch.empty(n_cgroups, dtype=torch.int32, device=dev)
              if precision == "int8" else None)
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((b, np_pad), dtype=torch.float32, device=dev),
            torch.empty((b, np_pad), dtype=torch.int32, device=dev),
            c_amax, blk_p, n_cgroups)


def fused_turn(queries: torch.Tensor, centroids: torch.Tensor,
               list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
               nprobe: int, np_pad: int, r_pad: int, precision: str = "f32",
               r: int = 0, kp: int = 0) -> Triple:
    """Whole turn: returns (values, ids, sel (B, np_pad)), values and ids
    (B, r_pad) for f32 and (B, kp) after the quantised paths' re-rank of
    their top ``r``; the first ``nprobe`` probes are scanned.  A B of 0
    launches nothing."""
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
    s1_v, s1_i, sel_v, sel, c_amax, blk_p, n_cgroups = centroid_scratch(
        b, p, np_pad, precision, dev)
    cand, mid, out, amax, blk_l, n_groups = _scan_scratch(
        b, nprobe, lmax, d, r_pad, kp, precision, dev)
    if b == 0:
        return out[0], out[1], sel
    with torch.cuda.device(dev):
        err = _build.lib().fused_turn_ivf(
            _ptr(queries), _ptr(centroids), _ptr(list_vecs), _ptr(list_ids),
            p, b, nprobe, np_pad, lmax, d, PRECISION_CODE[precision], blk_p,
            n_cgroups, _ptr(c_amax), blk_l, n_groups, _ptr(amax), r, r_pad,
            kp, tiling.merge_group(np_pad), tiling.merge_group(r_pad),
            _ptr(s1_v), _ptr(s1_i), _ptr(sel_v), _ptr(sel), *map(_ptr, cand),
            *map(_ptr, mid), *map(_ptr, out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"fused_turn_ivf ({precision})")
    return out[0], out[1], sel
