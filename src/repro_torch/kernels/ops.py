"""Dispatch wrappers for the port's kernels.

Each op has two execution paths, picked by the device of its tensors:

  * ``"kernel"`` — the CUDA kernel (``fused_turn.py`` / ``pq_adc.py`` →
                   ``csrc/``), the only path for CUDA tensors;
  * ``"ref"``    — the plain PyTorch version (``ref.py``), the only path
                   for CPU tensors.

There is no fallback between them: ``mode="kernel"`` on CPU tensors and
``mode="ref"`` on CUDA tensors raise, a failed build raises, a refused
launch raises.  The wrappers keep the reference's signatures and
return shapes (``repro/kernels/ops.py:95-114``, ``:130-196`` and
``:209-290``, without the TPU tile knobs), own the power-of-two padding
of k / nprobe / the re-rank depth, and count their launches in a plain
int on the wrapper (``fused_turn.launches``), so a run can show that
its path went through the kernels.

Only ``precision="f32"`` is ported; the bf16/int8 variants (stage-3
in-kernel re-rank) are ROADMAP Queue 1, item 3.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import fused_turn as _ft
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels import ref
from repro_torch.kernels import tiling

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def default_mode(device: torch.device) -> str:
    return "kernel" if device.type == "cuda" else "ref"


def _mode(mode: Optional[str], device: torch.device) -> str:
    mode = mode or default_mode(device)
    if mode not in ("kernel", "ref"):
        raise ValueError(f"mode must be 'kernel' or 'ref', got {mode!r}")
    if mode != default_mode(device):
        raise ValueError(f"mode={mode!r} on {device.type} tensors: the "
                         f"kernel runs only on CUDA tensors and the plain "
                         f"version only on CPU tensors")
    return mode


def check_precision(precision: str) -> None:
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r}: only the float32 fused kernels are "
            f"ported; the bf16/int8 variants are ROADMAP Queue 1, item 3")


def fused_turn(queries: torch.Tensor, centroids: torch.Tensor,
               list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
               nprobe: int, k: int, over: int = 2, precision: str = "f32",
               mode: Optional[str] = None, device=None) -> Triple:
    """Whole IVF turn: centroid top-nprobe + probed-list scan.

    Returns (values (B, k), ids (B, k), sel (B, nprobe)); ids and sel
    int32.  ``over`` is the quantised candidate depth of the unported
    precisions, kept for the reference's signature.
    """
    del over
    check_precision(precision)
    dev = _device.require(device, queries, centroids, list_vecs, list_ids)
    if _mode(mode, dev) == "ref":
        return ref.fused_turn_ivf(queries, centroids, list_vecs, list_ids,
                                  nprobe=nprobe, k=k)
    np_pad = tiling.check_pad("nprobe", nprobe)
    r_pad = tiling.check_pad("k", k)
    v, i, s = _ft.fused_turn(queries.contiguous(), centroids, list_vecs,
                             list_ids, nprobe=nprobe, np_pad=np_pad,
                             r_pad=r_pad)
    fused_turn.launches += int(queries.shape[0] > 0)
    return v[:, :k], i[:, :k], s[:, :nprobe]


fused_turn.launches = 0


def fused_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
               list_ids: torch.Tensor, sel: torch.Tensor, k: int, *,
               own: Optional[torch.Tensor] = None, over: int = 2,
               precision: str = "f32", mode: Optional[str] = None,
               device=None) -> Triple:
    """IVF list scan with a caller-supplied selection ``sel`` (B, nprobe).

    Returns (values (B, k), ids (B, k), pos (B, k)): ``pos`` is the flat
    scan position ``probe·lmax + offset`` (the tie-break key of the
    reference's ``distributed_topk_ordered``), ``PAD_POS`` on -inf
    lanes.  ``own`` masks lists this shard does not own.
    """
    del over
    check_precision(precision)
    dev = _device.require(device, queries, list_vecs, list_ids, sel, own)
    if _mode(mode, dev) == "ref":
        return ref.fused_scan_ivf(queries, list_vecs, list_ids, sel, own,
                                  k=k)
    r_pad = tiling.check_pad("k", k)
    own32 = None if own is None else own.to(torch.int32).contiguous()
    v, i, pp = _ft.fused_scan(queries.contiguous(), list_vecs, list_ids,
                              sel.to(torch.int32).contiguous(), own32,
                              r_pad=r_pad)
    fused_scan.launches += int(queries.shape[0] > 0)
    return v[:, :k], i[:, :k], pp[:, :k]


fused_scan.launches = 0


# ---------------------------------------------------------------------------
# IVF-PQ: ADC scan, fused scan (+ exact re-rank), whole turn
# ---------------------------------------------------------------------------


def _fused_depth(k: int, cap: int, *, rerank: int) -> int:
    """Exact candidate depth r: the PQ re-rank depth, clamped to the
    scannable candidate count and floored at k (the reference's clamp,
    ``repro/kernels/ops.py:122-127``)."""
    return max(k, min(rerank, cap))


def pq_adc_scan(tables: torch.Tensor, list_codes: torch.Tensor,
                list_ids: torch.Tensor, sel: torch.Tensor, k: int, *,
                mode: Optional[str] = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan of the probed PQ lists ``sel`` (B, nprobe) with the
    per-query LUTs ``tables`` (B, m, n_codes): the ADC top-k (values
    (B, k), int32 ids (B, k)), to be re-ranked by the caller."""
    dev = _device.require(device, tables, list_codes, list_ids, sel)
    if _mode(mode, dev) == "ref":
        return ref.pq_adc_scan_batch(tables, list_codes, list_ids, sel, k)
    kp = tiling.check_pad("k", k)
    v, i, _ = _pq.pq_adc_scan(tables.to(torch.float32).contiguous(),
                              list_codes, list_ids,
                              sel.to(torch.int32).contiguous(), r_pad=kp)
    pq_adc_scan.launches += int(sel.shape[0] > 0)
    return v[:, :k], i[:, :k]


pq_adc_scan.launches = 0


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, k: int, rerank: int, precision: str = "f32",
                  mode: Optional[str] = None, device=None) -> Triple:
    """Whole IVF-PQ turn: centroid top-nprobe + ADC scan + exact re-rank
    of the ADC top ``r = max(k, min(rerank, nprobe·lmax))`` against
    ``corpus`` rows.  Returns (values (B, k), ids (B, k), sel (B,
    nprobe)); ids and sel int32."""
    check_precision(precision)
    dev = _device.require(device, queries, centroids, tables, list_codes,
                          list_ids, corpus)
    r = _fused_depth(k, nprobe * list_codes.shape[1], rerank=rerank)
    if _mode(mode, dev) == "ref":
        return ref.fused_turn_pq(queries, centroids, tables, list_codes,
                                 list_ids, corpus, nprobe=nprobe, k=k, r=r)
    np_pad = tiling.check_pad("nprobe", nprobe)
    r_pad = tiling.check_pad("rerank depth", r)
    v, i, s = _pq.fused_turn_pq(
        queries.contiguous(), centroids, tables.to(torch.float32).contiguous(),
        list_codes, list_ids, corpus, nprobe=nprobe, np_pad=np_pad, r=r,
        r_pad=r_pad, kp=tiling.next_pow2(k))
    fused_turn_pq.launches += int(queries.shape[0] > 0)
    return v[:, :k], i[:, :k], s[:, :nprobe]


fused_turn_pq.launches = 0


def fused_scan_pq(tables: torch.Tensor, queries: torch.Tensor,
                  list_codes: torch.Tensor, list_ids: torch.Tensor,
                  sel: torch.Tensor, corpus: torch.Tensor, k: int, *,
                  rerank: int, own: Optional[torch.Tensor] = None,
                  precision: str = "f32", fuse_rerank: bool = True,
                  mode: Optional[str] = None, device=None) -> Triple:
    """PQ ADC scan with a caller-supplied selection ``sel`` (B, nprobe).

    With ``fuse_rerank`` (single-device turns): the exact top-k of the
    ADC top r, (values (B, k), ids (B, k), ADC ranks (B, k)).  Without
    (the sharded merge): the ADC top r, (values (B, r), ids (B, r), flat
    positions ``probe·lmax + offset``, ``PAD_POS`` on -inf lanes).
    ``own`` masks lists this shard does not own.
    """
    check_precision(precision)
    dev = _device.require(device, tables, queries, list_codes, list_ids,
                          sel, corpus, own)
    r = _fused_depth(k, sel.shape[1] * list_codes.shape[1], rerank=rerank)
    if _mode(mode, dev) == "ref":
        return ref.fused_scan_pq(tables, queries, list_codes, list_ids, sel,
                                 own, corpus, k=k, r=r, rerank=fuse_rerank)
    r_pad = tiling.check_pad("rerank depth", r)
    own32 = None if own is None else own.to(torch.int32).contiguous()
    v, i, pp = _pq.fused_scan_pq(
        tables.to(torch.float32).contiguous(),
        queries.contiguous() if fuse_rerank else None, list_codes, list_ids,
        sel.to(torch.int32).contiguous(), own32,
        corpus if fuse_rerank else None, r=r, r_pad=r_pad,
        kp=tiling.next_pow2(k), rerank=fuse_rerank)
    fused_scan_pq.launches += int(sel.shape[0] > 0)
    w = k if fuse_rerank else r
    return v[:, :w], i[:, :w], pp[:, :w]


fused_scan_pq.launches = 0


def reset_launches() -> None:
    """Set every op's launch count to 0."""
    fused_turn.launches = 0
    fused_scan.launches = 0
    pq_adc_scan.launches = 0
    fused_turn_pq.launches = 0
    fused_scan_pq.launches = 0
