"""Launches of the fused IVF turn kernels (``csrc/fused_turn.cu``).

Counterpart of ``repro/kernels/fused_turn.py`` (family ivf, f32): the
kernels themselves are CUDA C++ for sm_90a, bound through ctypes
(``_build``).  These functions take CUDA tensors only, check what the
kernels take (device, dtype, shape, contiguity, 16-byte rows), allocate
outputs and scratch, launch on PyTorch's current stream without
synchronising, and raise if a launch was refused.  Padding and the
choice between kernel and plain version belong to ``ops.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import tiling
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
    tiling.check_merge(nprobe * tiling.scan_split(lmax), r_pad)


def _scan_buffers(b: int, nprobe: int, lmax: int, r_pad: int, dev
                  ) -> Tuple[Triple, Triple]:
    n = b * nprobe * tiling.scan_split(lmax) * r_pad
    cand = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    out = (torch.empty((b, r_pad), dtype=torch.float32, device=dev),
           torch.empty((b, r_pad), dtype=torch.int32, device=dev),
           torch.empty((b, r_pad), dtype=torch.int32, device=dev))
    return cand, out


def fused_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
               list_ids: torch.Tensor, sel: torch.Tensor,
               own: Optional[torch.Tensor], *, r_pad: int) -> Triple:
    """Scan the probed lists ``sel`` (B, nprobe) int32; ``own`` (B,
    nprobe) int32 or None.  Returns the top ``r_pad`` (values, ids,
    flat positions probe*lmax + offset), pads ``(-inf, -1, PAD_POS)``.
    A B of 0 launches nothing."""
    b, nprobe = sel.shape
    p, lmax, d = list_vecs.shape
    _check_lists(queries, list_vecs, list_ids, nprobe, r_pad)
    _check("sel", sel, torch.int32, 2)
    if own is not None:
        _check("own", own, torch.int32, 2)
        if own.shape != sel.shape:
            raise ValueError("own must match sel's shape")
    if queries.shape[0] != b:
        raise ValueError("queries and sel disagree on the batch")
    cand, out = _scan_buffers(b, nprobe, lmax, r_pad, queries.device)
    if b == 0:
        return out
    with torch.cuda.device(queries.device):
        err = _build.lib().fused_scan_ivf_f32(
            _ptr(queries), _ptr(list_vecs), _ptr(list_ids), p, _ptr(sel),
            nprobe, _ptr(own), b, nprobe, lmax, d, r_pad, *map(_ptr, cand),
            *map(_ptr, out), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_scan_ivf_f32")
    return out


def fused_turn(queries: torch.Tensor, centroids: torch.Tensor,
               list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
               nprobe: int, np_pad: int, r_pad: int) -> Triple:
    """Whole turn: returns (values (B, r_pad), ids (B, r_pad),
    sel (B, np_pad)); the first ``nprobe`` probes are scanned.  A B of
    0 launches nothing."""
    b = queries.shape[0]
    p, lmax, d = list_vecs.shape
    _check_lists(queries, list_vecs, list_ids, nprobe, r_pad)
    _check("centroids", centroids, torch.float32, 2)
    if tuple(centroids.shape) != (p, d):
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match "
                         f"{p} lists of width {d}")
    if not 0 < nprobe <= min(p, np_pad) or np_pad > tiling.CENTROID_CHUNK:
        raise ValueError(f"nprobe={nprobe}, np_pad={np_pad}, p={p}")
    nchunks = tiling.centroid_chunks(p)
    tiling.check_merge(nchunks, np_pad)
    dev = queries.device
    s1_v = torch.empty(b * nchunks * np_pad, dtype=torch.float32, device=dev)
    s1_i = torch.empty(b * nchunks * np_pad, dtype=torch.int32, device=dev)
    sel_v = torch.empty((b, np_pad), dtype=torch.float32, device=dev)
    sel = torch.empty((b, np_pad), dtype=torch.int32, device=dev)
    cand, out = _scan_buffers(b, nprobe, lmax, r_pad, dev)
    if b == 0:
        return out[0], out[1], sel
    with torch.cuda.device(dev):
        err = _build.lib().fused_turn_ivf_f32(
            _ptr(queries), _ptr(centroids), _ptr(list_vecs), _ptr(list_ids),
            p, b, nprobe, np_pad, lmax, d, r_pad, _ptr(s1_v), _ptr(s1_i),
            _ptr(sel_v), _ptr(sel), *map(_ptr, cand), *map(_ptr, out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_turn_ivf_f32")
    return out[0], out[1], sel
