"""Launches of the IVF-PQ kernels (``csrc/pq_adc.cu``).

Counterpart of ``repro/kernels/pq_adc.py`` (``pq_adc_scan``) and of the
pq family of ``repro/kernels/fused_turn.py`` (``fused_scan_pq``,
``fused_turn_pq``, f32 / bf16 / int8).  As in ``fused_turn.py``: CUDA
tensors only, every operand checked (device, dtype, shape, contiguity,
16-byte rows), outputs and scratch allocated here, and the entry with
its launch plan handed to ``launcher.run`` (one launch sequence on
PyTorch's current stream without synchronising; a refused launch
raises).  Padding and the choice between kernel and plain version belong
to ``ops.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import launcher
from repro_torch.kernels import tiling
from repro_torch.kernels.fused_turn import (PRECISION_CODE, _buffers, _check,
                                           centroid_scratch, check_depth,
                                           check_scales, scan_lists)
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_scan(tables: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, b: int, nprobe: int,
                 r_pad: int) -> None:
    _check("tables", tables, torch.float32, 3)
    _check("list_codes", list_codes, torch.uint8, 3)
    _check("list_ids", list_ids, torch.int32, 2)
    _, m, n_codes = tables.shape
    p, lmax, m_codes = list_codes.shape
    if tables.shape[0] != b or m_codes != m or \
            tuple(list_ids.shape) != (p, lmax):
        raise ValueError(f"shapes disagree: tables {tuple(tables.shape)}, "
                         f"list_codes {tuple(list_codes.shape)}, list_ids "
                         f"{tuple(list_ids.shape)}, batch {b}")
    if len({tables.device, list_codes.device, list_ids.device}) != 1:
        raise ValueError("tables and lists lie on different devices")
    tiling.check_lut(m, n_codes)
    if b > tiling.MAX_GRID_Y:
        raise ValueError(f"batch {b} > {tiling.MAX_GRID_Y}")
    if nprobe * lmax >= PAD_POS:
        raise ValueError("flat scan positions overflow int32")
    tiling.check_pad("r_pad", r_pad)


def _check_rerank(queries: torch.Tensor, corpus: torch.Tensor, b: int
                  ) -> None:
    _check("queries", queries, torch.float32, 2)
    _check("corpus", corpus, torch.float32, 2)
    if queries.shape[0] != b or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"batch {b} / corpus {tuple(corpus.shape)}")
    if queries.device != corpus.device:
        raise ValueError("queries and corpus lie on different devices")
    tiling.check_width(corpus.shape[1])


def _sel_check(sel: torch.Tensor, b: int, own: Optional[torch.Tensor]
               ) -> None:
    _check("sel", sel, torch.int32, 2)
    if sel.shape[0] != b:
        raise ValueError("tables and sel disagree on the batch")
    if own is not None:
        _check("own", own, torch.int32, 2)
        if own.shape != sel.shape:
            raise ValueError("own must match sel's shape")


def pq_adc_scan(tables: torch.Tensor, list_codes: torch.Tensor,
                list_ids: torch.Tensor, sel: torch.Tensor, *, r_pad: int
                ) -> Triple:
    """ADC-scan the probed lists ``sel`` (B, nprobe) int32.  Returns the
    ADC top ``r_pad`` (values, ids, flat positions probe*lmax + offset),
    pads ``(-inf, -1, PAD_POS)``.  A B of 0 launches nothing."""
    b, nprobe = sel.shape
    p, lmax, m = list_codes.shape
    _check_scan(tables, list_codes, list_ids, b, nprobe, r_pad)
    _sel_check(sel, b, None)
    dev = tables.device
    lists, _ = scan_lists(b, nprobe, lmax, r_pad, dev)
    out = _buffers((b, r_pad), dev)
    n_codes = tables.shape[2]
    launcher.run(
        "pq_adc_scan_f32",
        tiling.plan_adc(b, nprobe, lmax, m, n_codes, r_pad), dev, tables, m,
        n_codes, list_codes, list_ids, p, sel, b, nprobe, lmax, r_pad,
        *lists, *out)
    return out


def fused_scan_pq(tables: torch.Tensor, queries: Optional[torch.Tensor],
                  list_codes: torch.Tensor, list_ids: torch.Tensor,
                  sel: torch.Tensor, own: Optional[torch.Tensor],
                  corpus: Optional[torch.Tensor], *, r: int, r_pad: int,
                  kp: int, rerank: bool, precision: str = "f32") -> Triple:
    """ADC scan of ``sel`` (B, nprobe) with ``own`` (B, nprobe) int32 or
    None, at ``precision``.  With ``rerank``: the exact top ``kp`` of the
    ADC top ``r`` against ``corpus`` rows (values, ids, ADC ranks);
    without: the ADC top ``r_pad`` (values, ids, flat positions).  A B
    of 0 launches nothing."""
    b, nprobe = sel.shape
    p, lmax, m = list_codes.shape
    _check_scan(tables, list_codes, list_ids, b, nprobe, r_pad)
    _sel_check(sel, b, own)
    if rerank:
        _check_rerank(queries, corpus, b)
        check_depth(r, r_pad, kp)
    dev = tables.device
    lists, _ = scan_lists(b, nprobe, lmax, r_pad, dev)
    mid = (_buffers((b, r_pad), dev) if rerank and lists[-1] is None
           else (None, None, None))
    out = _buffers((b, kp if rerank else r_pad), dev)
    d = corpus.shape[1] if rerank else 0
    n_codes = tables.shape[2]
    launcher.run(
        "fused_scan_pq",
        tiling.plan_fused_scan_pq(b, nprobe, lmax, m, n_codes, d, r_pad,
                                  rerank, precision),
        dev, tables, queries if rerank else None, m, n_codes, list_codes,
        list_ids, p, sel, nprobe, own, corpus if rerank else None, b, nprobe,
        lmax, d, PRECISION_CODE[precision], r, r_pad, kp, int(rerank),
        *lists, *mid, *out)
    return out


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, np_pad: int, r: int, r_pad: int, kp: int,
                  precision: str = "f32",
                  c_amax: Optional[torch.Tensor] = None) -> Triple:
    """Whole IVF-PQ turn at ``precision``: returns (values (B, kp), ids
    (B, kp), sel (B, np_pad)); the first ``nprobe`` probes are scanned
    and the ADC top ``r`` re-ranked; int8 reads ``c_amax`` (1,
    n_cgroups), the centroids' cached group amax.  A B of 0 launches
    nothing."""
    b, d = queries.shape
    p, lmax, m = list_codes.shape
    _check_scan(tables, list_codes, list_ids, b, nprobe, r_pad)
    _check_rerank(queries, corpus, b)
    _check("centroids", centroids, torch.float32, 2)
    if tuple(centroids.shape) != (p, d):
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match "
                         f"{p} lists of width {d}")
    if not 0 < nprobe <= min(p, np_pad) or np_pad > tiling.MAX_PAD:
        raise ValueError(f"nprobe={nprobe}, np_pad={np_pad}, p={p}")
    check_depth(r, r_pad, kp)
    dev = queries.device
    s1_v, s1_i, sel_v, sel, tiles = centroid_scratch(b, p, d, np_pad, dev)
    lists, s1_counters = scan_lists(b, nprobe, lmax, r_pad, dev, tiles)
    mid = (_buffers((b, r_pad), dev) if lists[-1] is None
           else (None, None, None))
    out = _buffers((b, kp), dev)
    blk_p, n_cgroups = tiling.centroid_groups(p, np_pad)
    check_scales("c_amax", c_amax, (1, n_cgroups), precision)
    n_codes = tables.shape[2]
    launcher.run(
        "fused_turn_pq",
        tiling.plan_fused_turn_pq(b, p, nprobe, np_pad, lmax, m, n_codes, d,
                                  precision, r_pad),
        dev, queries, centroids, tables, m, n_codes, list_codes, list_ids, p,
        corpus, b, nprobe, np_pad, lmax, d, PRECISION_CODE[precision], blk_p,
        c_amax, r, r_pad, kp, s1_v, s1_i, s1_counters, sel_v, sel, *lists,
        *mid, *out)
    return out[0], out[1], sel
