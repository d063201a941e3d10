"""Dispatch wrappers for the port's kernels.

Each op has two execution paths, picked by the device of its tensors:

  * ``"kernel"`` — the CUDA kernel (``fused_turn.py`` / ``pq_adc.py`` /
                   ``flash_attention.py`` / ``flash_decode.py`` /
                   ``embedding_bag.py`` → ``csrc/``), the only path for
                   CUDA tensors;
  * ``"ref"``    — the plain PyTorch version (``ref.py``), the only path
                   for CPU tensors.

There is no fallback between them: ``mode="kernel"`` on CPU tensors and
``mode="ref"`` on CUDA tensors raise, a failed build raises, a refused
launch raises.  The wrappers keep the reference's signatures and
return shapes (``repro/kernels/ops.py:95-114``, ``:130-196``,
``:209-290``, ``:331-356`` and ``:386-399``, without the TPU tile
knobs), own the
power-of-two padding of k / nprobe / the re-rank depth, and count their
launches in a plain int on the wrapper (``fused_turn.launches``), so a
run can show that its path went through the kernels.

The fused retrieval ops take the reference's ``precision``: "f32", or
"bf16" / "int8" scoring with a float32 re-rank of the top ``r``
candidates inside the kernel (``kernels/ref.py`` states the contract);
any other precision raises ``ValueError``.  ``flash_attention`` and
``embedding_bag`` port the forward: their backwards come with training
(ROADMAP Queue 1, item 7), so the kernel path refuses inputs that
require grad, as ``flash_decode`` (serving only, no backward in the
reference either) does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
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


PRECISIONS = _ft.PRECISIONS


def check_precision(precision: str) -> None:
    """The one check of a fused op's ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: the fused ops "
                         f"take one of {PRECISIONS}")


def _fused_depth(k: int, cap: int, want: int) -> int:
    """Exact candidate depth r: ``want`` (k·over for quantised IVF, the
    re-rank depth for PQ) clamped to the scannable candidate count
    ``cap`` and floored at k (``repro/kernels/ops.py:122-127``)."""
    return max(k, min(want, cap))


def fused_turn(queries: torch.Tensor, centroids: torch.Tensor,
               list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
               nprobe: int, k: int, over: int = 2, precision: str = "f32",
               mode: Optional[str] = None, device=None) -> Triple:
    """Whole IVF turn: centroid top-nprobe + probed-list scan (+ the
    float32 re-rank of the top ``k·over`` when quantised).

    Returns (values (B, k), ids (B, k), sel (B, nprobe)); ids and sel
    int32.
    """
    check_precision(precision)
    dev = _device.require(device, queries, centroids, list_vecs, list_ids)
    r = k if precision == "f32" else _fused_depth(
        k, nprobe * list_vecs.shape[1], k * over)
    if _mode(mode, dev) == "ref":
        return ref.fused_turn_ivf(queries, centroids, list_vecs, list_ids,
                                  nprobe=nprobe, k=k, precision=precision,
                                  r=r)
    np_pad = tiling.check_pad("nprobe", nprobe)
    r_pad = tiling.check_pad("k" if precision == "f32" else "k·over", r)
    v, i, s = _ft.fused_turn(queries.contiguous(), centroids, list_vecs,
                             list_ids, nprobe=nprobe, np_pad=np_pad,
                             r_pad=r_pad, precision=precision, r=r,
                             kp=tiling.next_pow2(k))
    fused_turn.launches += int(queries.shape[0] > 0)
    return v[:, :k], i[:, :k], s[:, :nprobe]


fused_turn.launches = 0


def fused_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
               list_ids: torch.Tensor, sel: torch.Tensor, k: int, *,
               own: Optional[torch.Tensor] = None, over: int = 2,
               precision: str = "f32", mode: Optional[str] = None,
               device=None) -> Triple:
    """IVF list scan with a caller-supplied selection ``sel`` (B, nprobe).

    Returns (values (B, k), ids (B, k), pos (B, k)).  f32: ``pos`` is the
    flat scan position ``probe·lmax + offset`` (the tie-break key of the
    reference's ``distributed_topk_ordered``), ``PAD_POS`` on -inf lanes.
    bf16 / int8: the float32 top-k of the quantised top ``k·over``, and
    ``pos`` the candidate rank (single-device use).  ``own`` masks lists
    this shard does not own.
    """
    check_precision(precision)
    dev = _device.require(device, queries, list_vecs, list_ids, sel, own)
    r = k if precision == "f32" else _fused_depth(
        k, sel.shape[1] * list_vecs.shape[1], k * over)
    if _mode(mode, dev) == "ref":
        return ref.fused_scan_ivf(queries, list_vecs, list_ids, sel, own,
                                  k=k, precision=precision, r=r)
    r_pad = tiling.check_pad("k" if precision == "f32" else "k·over", r)
    own32 = None if own is None else own.to(torch.int32).contiguous()
    v, i, pp = _ft.fused_scan(queries.contiguous(), list_vecs, list_ids,
                              sel.to(torch.int32).contiguous(), own32,
                              r_pad=r_pad, precision=precision, r=r,
                              kp=tiling.next_pow2(k))
    fused_scan.launches += int(queries.shape[0] > 0)
    return v[:, :k], i[:, :k], pp[:, :k]


fused_scan.launches = 0


# ---------------------------------------------------------------------------
# IVF-PQ: ADC scan, fused scan (+ exact re-rank), whole turn
# ---------------------------------------------------------------------------


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
    ``corpus`` rows, whatever the precision (bf16 / int8 score the
    centroids and the ADC quantised).  Returns (values (B, k), ids
    (B, k), sel (B, nprobe)); ids and sel int32."""
    check_precision(precision)
    dev = _device.require(device, queries, centroids, tables, list_codes,
                          list_ids, corpus)
    r = _fused_depth(k, nprobe * list_codes.shape[1], rerank)
    if _mode(mode, dev) == "ref":
        return ref.fused_turn_pq(queries, centroids, tables, list_codes,
                                 list_ids, corpus, nprobe=nprobe, k=k, r=r,
                                 precision=precision)
    np_pad = tiling.check_pad("nprobe", nprobe)
    r_pad = tiling.check_pad("rerank depth", r)
    v, i, s = _pq.fused_turn_pq(
        queries.contiguous(), centroids, tables.to(torch.float32).contiguous(),
        list_codes, list_ids, corpus, nprobe=nprobe, np_pad=np_pad, r=r,
        r_pad=r_pad, kp=tiling.next_pow2(k), precision=precision)
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
    ``own`` masks lists this shard does not own.  bf16 / int8 score the
    ADC quantised; the re-rank is float32.
    """
    check_precision(precision)
    dev = _device.require(device, tables, queries, list_codes, list_ids,
                          sel, corpus, own)
    r = _fused_depth(k, sel.shape[1] * list_codes.shape[1], rerank)
    if _mode(mode, dev) == "ref":
        return ref.fused_scan_pq(tables, queries, list_codes, list_ids, sel,
                                 own, corpus, k=k, r=r, rerank=fuse_rerank,
                                 precision=precision)
    r_pad = tiling.check_pad("rerank depth", r)
    own32 = None if own is None else own.to(torch.int32).contiguous()
    v, i, pp = _pq.fused_scan_pq(
        tables.to(torch.float32).contiguous(),
        queries.contiguous() if fuse_rerank else None, list_codes, list_ids,
        sel.to(torch.int32).contiguous(), own32,
        corpus if fuse_rerank else None, r=r, r_pad=r_pad,
        kp=tiling.next_pow2(k), rerank=fuse_rerank, precision=precision)
    fused_scan_pq.launches += int(sel.shape[0] > 0)
    w = k if fuse_rerank else r
    return v[:, :w], i[:, :w], pp[:, :w]


fused_scan_pq.launches = 0


# ---------------------------------------------------------------------------
# flash attention (forward)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, mode: Optional[str] = None,
                    device=None) -> torch.Tensor:
    """Attention forward. q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv,
    Skv, Dv); Hkv divides H; returns (B, H, S, Dv) float32.

    Causal masking is bottom-right (queries are the last S positions).
    Unlike the reference, which drops to its plain math when S or Skv is
    not a multiple of 128, every CUDA call runs the kernel: it masks
    ragged tails itself.  The kernel has no backward yet, so it refuses
    inputs that require grad.
    """
    dev = _device.require(device, q, k, v)
    _fa.check_shapes(q, k, v, causal=causal)
    if _mode(mode, dev) == "ref":
        return ref.mha_attention(q, k, v, causal=causal)
    refuse_grad("flash_attention", q, k, v)
    f32 = [t.to(torch.float32).contiguous() for t in (q, k, v)]
    out = _fa.flash_attention(*f32, causal=causal)
    flash_attention.launches += int(out.numel() > 0)
    return out.to(q.dtype)


flash_attention.launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor, *, mode: Optional[str] = None,
                 device=None) -> torch.Tensor:
    """Decode attention (serving only). q (B, H, D), k and v (B, Hkv, S,
    D), cache_len (B,) integer; returns (B, H, D) in q's dtype.

    Positions >= cache_len are masked; a cache_len past S counts as S
    (the reference passes ``cache_len + 1`` after a write it dropped on a
    full cache).  cache_len must be >= 1: a row with none attends to
    nothing, so a CPU cache_len is checked; on the card it is the
    caller's contract.  Unlike the reference,
    which drops to its plain math unless S is a multiple of 128, every
    CUDA call runs the kernel on any S, reading a float32 or bfloat16
    cache in its own dtype.
    """
    dev = _device.require(device, q, k, v, cache_len)
    _fd.check_shapes(q, k, v, cache_len)
    if _mode(mode, dev) == "ref":
        return ref.decode_attention(q, k, v, cache_len)
    refuse_grad("flash_decode", q, k, v)
    out = _fd.flash_decode(q.to(torch.float32).contiguous(), k.contiguous(),
                           v.contiguous(),
                           cache_len.to(torch.int32).contiguous())
    flash_decode.launches += int(q.shape[0] > 0)
    return out.to(q.dtype)


flash_decode.launches = 0


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """The CUDA kernels run forward only: refuse inputs that need grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward only; its backward comes "
            f"with training (ROADMAP Queue 1, item 7)")


# ---------------------------------------------------------------------------
# embedding_bag (forward)
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, agg: str = "sum",
                  *, mode: Optional[str] = None, device=None
                  ) -> torch.Tensor:
    """EmbeddingBag: table (V, d), bags ids (B, L) int (negative = pad),
    weights (B, L) or None -> (B, d) in the table's dtype.

    ``agg="mean"`` divides the bag's sum by max(Σ mask·w, 1), the
    reference's rule, on both paths.  The kernel takes float32 tables
    and refuses inputs that require grad.  On CUDA tensors, ids must be
    < V: the caller checks them on the host, where they come in
    (``models/recsys.py``).
    """
    if agg not in ("sum", "mean"):
        raise ValueError(f"agg must be 'sum' or 'mean', got {agg!r}")
    dev = _device.require(device, table, ids, weights)
    if ids.dim() != 2 or table.dim() != 2 or (
            weights is not None and weights.shape != ids.shape):
        raise ValueError(f"need table (V, d), ids (B, L) and weights like "
                         f"ids: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}")
    if _mode(mode, dev) == "ref":
        return ref.embedding_bag(table, ids, weights, mode=agg)
    refuse_grad("embedding_bag", table, weights)
    if table.dtype != torch.float32:
        raise NotImplementedError(
            f"embedding_bag: the CUDA kernel takes float32 tables, got "
            f"{table.dtype}")
    w32 = None if weights is None else weights.to(torch.float32).contiguous()
    out = _eb.embedding_bag(table.contiguous(),
                            ids.to(torch.int32).contiguous(), w32)
    embedding_bag.launches += int(ids.shape[0] > 0)
    return ref.bag_mean(out, ids, w32) if agg == "mean" else out


embedding_bag.launches = 0


def reset_launches() -> None:
    """Set every op's launch count to 0."""
    fused_turn.launches = 0
    fused_scan.launches = 0
    pq_adc_scan.launches = 0
    fused_turn_pq.launches = 0
    fused_scan_pq.launches = 0
    flash_attention.launches = 0
    flash_decode.launches = 0
    embedding_bag.launches = 0
