"""Launches of the IVF-PQ kernels (``csrc/pq_adc.cu``).

Counterpart of ``repro/kernels/pq_adc.py`` (``pq_adc_scan``) and of the
pq family of ``repro/kernels/fused_turn.py`` (``fused_scan_pq``,
``fused_turn_pq``, f32).  As in ``fused_turn.py``: CUDA tensors only,
every operand checked (device, dtype, shape, contiguity, 16-byte rows),
outputs and scratch allocated here, one launch sequence on PyTorch's
current stream without synchronising, and a refused launch raises.
Padding and the choice between kernel and plain version belong to
``ops.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import tiling
from repro_torch.kernels.fused_turn import _check, _ptr, _raise_on
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
    if r_pad > tiling.PQ_ROWS:
        raise ValueError(f"r_pad={r_pad} > {tiling.PQ_ROWS} rows per block")
    tiling.check_merge(nprobe * tiling.pq_split(lmax), r_pad)


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


def _buffers(shape, dev) -> Triple:
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _cand(b: int, nprobe: int, lmax: int, r_pad: int, dev) -> Triple:
    return _buffers(b * nprobe * tiling.pq_split(lmax) * r_pad, dev)


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
    cand, out = _cand(b, nprobe, lmax, r_pad, dev), _buffers((b, r_pad), dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.lib().pq_adc_scan_f32(
            _ptr(tables), m, tables.shape[2], _ptr(list_codes),
            _ptr(list_ids), p, _ptr(sel), b, nprobe, lmax, r_pad,
            *map(_ptr, cand), *map(_ptr, out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "pq_adc_scan_f32")
    return out


def fused_scan_pq(tables: torch.Tensor, queries: Optional[torch.Tensor],
                  list_codes: torch.Tensor, list_ids: torch.Tensor,
                  sel: torch.Tensor, own: Optional[torch.Tensor],
                  corpus: Optional[torch.Tensor], *, r: int, r_pad: int,
                  kp: int, rerank: bool) -> Triple:
    """ADC scan of ``sel`` (B, nprobe) with ``own`` (B, nprobe) int32 or
    None.  With ``rerank``: the exact top ``kp`` of the ADC top ``r``
    against ``corpus`` rows (values, ids, ADC ranks); without: the ADC
    top ``r_pad`` (values, ids, flat positions).  A B of 0 launches
    nothing."""
    b, nprobe = sel.shape
    p, lmax, m = list_codes.shape
    _check_scan(tables, list_codes, list_ids, b, nprobe, r_pad)
    _sel_check(sel, b, own)
    if rerank:
        _check_rerank(queries, corpus, b)
        if not 0 < kp <= r_pad or not 0 < r <= r_pad:
            raise ValueError(f"need kp <= r_pad and r <= r_pad: kp={kp}, "
                             f"r={r}, r_pad={r_pad}")
    dev = tables.device
    cand = _cand(b, nprobe, lmax, r_pad, dev)
    mid = _buffers((b, r_pad), dev) if rerank else (None, None, None)
    out = _buffers((b, kp if rerank else r_pad), dev)
    if b == 0:
        return out
    d = corpus.shape[1] if rerank else 0
    with torch.cuda.device(dev):
        err = _build.lib().fused_scan_pq_f32(
            _ptr(tables), _ptr(queries if rerank else None), m,
            tables.shape[2], _ptr(list_codes), _ptr(list_ids), p, _ptr(sel),
            nprobe, _ptr(own), _ptr(corpus if rerank else None), b, nprobe,
            lmax, d, r, r_pad, kp, int(rerank), *map(_ptr, cand),
            *map(_ptr, mid), *map(_ptr, out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_scan_pq_f32")
    return out


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, np_pad: int, r: int, r_pad: int, kp: int
                  ) -> Triple:
    """Whole IVF-PQ turn: returns (values (B, kp), ids (B, kp), sel
    (B, np_pad)); the first ``nprobe`` probes are scanned and the ADC
    top ``r`` re-ranked.  A B of 0 launches nothing."""
    b, d = queries.shape
    p, lmax, m = list_codes.shape
    _check_scan(tables, list_codes, list_ids, b, nprobe, r_pad)
    _check_rerank(queries, corpus, b)
    _check("centroids", centroids, torch.float32, 2)
    if tuple(centroids.shape) != (p, d):
        raise ValueError(f"centroids {tuple(centroids.shape)} do not match "
                         f"{p} lists of width {d}")
    if not 0 < nprobe <= min(p, np_pad) or np_pad > tiling.CENTROID_CHUNK:
        raise ValueError(f"nprobe={nprobe}, np_pad={np_pad}, p={p}")
    if not 0 < kp <= r_pad or not 0 < r <= r_pad:
        raise ValueError(f"need kp <= r_pad and r <= r_pad: kp={kp}, r={r}, "
                         f"r_pad={r_pad}")
    nchunks = tiling.centroid_chunks(p)
    tiling.check_merge(nchunks, np_pad)
    dev = queries.device
    s1_v = torch.empty(b * nchunks * np_pad, dtype=torch.float32, device=dev)
    s1_i = torch.empty(b * nchunks * np_pad, dtype=torch.int32, device=dev)
    sel_v = torch.empty((b, np_pad), dtype=torch.float32, device=dev)
    sel = torch.empty((b, np_pad), dtype=torch.int32, device=dev)
    cand = _cand(b, nprobe, lmax, r_pad, dev)
    mid, out = _buffers((b, r_pad), dev), _buffers((b, kp), dev)
    if b == 0:
        return out[0], out[1], sel
    with torch.cuda.device(dev):
        err = _build.lib().fused_turn_pq_f32(
            _ptr(queries), _ptr(centroids), _ptr(tables), m, tables.shape[2],
            _ptr(list_codes), _ptr(list_ids), p, _ptr(corpus), b, nprobe,
            np_pad, lmax, d, r, r_pad, kp, _ptr(s1_v), _ptr(s1_i),
            _ptr(sel_v), _ptr(sel), *map(_ptr, cand), *map(_ptr, mid),
            *map(_ptr, out), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_turn_pq_f32")
    return out[0], out[1], sel
