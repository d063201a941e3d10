"""Dispatch wrappers for the port's kernels.

Each op has two execution paths, picked by the device of its tensors:

  * ``"kernel"`` — the CUDA kernel (``fused_turn.py`` / ``pq_adc.py`` /
                   ``flash_attention.py`` / ``flash_decode.py`` /
                   ``embedding_bag.py`` / ``centroid_topk.py`` /
                   ``ivf_scan.py`` / ``hnsw_search.py`` → ``csrc/``; ``hnsw_search``
                   also over row-sharded vectors),
                   the only path for
                   CUDA tensors (and for ``meta`` tensors, which only
                   ``launcher.record_launches`` takes: it records each
                   call's launch plan and launches nothing);
  * ``"ref"``    — the plain PyTorch version (``ref.py``), the only path
                   for CPU tensors.

There is no fallback between them: ``mode="kernel"`` on CPU tensors and
``mode="ref"`` on CUDA tensors raise, a failed build raises, a refused
launch raises.  The wrappers keep the reference's signatures and
return shapes (``repro/kernels/ops.py:49-88``, ``:95-114``,
``:130-196``, ``:209-290``, ``:331-356`` and ``:386-399``, without the
TPU tile knobs), own the power-of-two padding of k / nprobe / the
re-rank depth, and count their launches in a plain int on the wrapper
(``fused_turn.launches``), so a run can show that its path went through
the kernels; a recorded call counts nothing.

The fused retrieval ops take the reference's ``precision``: "f32", or
"bf16" / "int8" scoring with a float32 re-rank of the top ``r``
candidates inside the kernel (``kernels/ref.py`` states the contract);
any other precision raises ``ValueError``.  ``flash_attention`` and
``embedding_bag`` are differentiable on both paths, as the reference's
``custom_vjp``s are (``repro/kernels/ops.py:303-329``, ``:362-384``): on
the kernel path one ``torch.autograd.Function`` each runs the CUDA
forward and, for its backward, the VJP of the plain version (plain
torch, as the reference's backward is plain XLA math); on the plain
path autograd differentiates the plain version itself.
``flash_decode`` (serving only, no backward in the reference either)
refuses inputs that require grad.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import centroid_topk as _ck
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_turn as _ft
from repro_torch.kernels import hnsw_search as _hs
from repro_torch.kernels import ivf_scan as _iv
from repro_torch.kernels import launcher
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels import ref
from repro_torch.kernels import tiling

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def default_mode(device: torch.device) -> str:
    return "kernel" if device.type in ("cuda", "meta") else "ref"


def _mode(mode: Optional[str], device: torch.device) -> str:
    mode = mode or default_mode(device)
    if mode not in ("kernel", "ref"):
        raise ValueError(f"mode must be 'kernel' or 'ref', got {mode!r}")
    if mode != default_mode(device):
        raise ValueError(f"mode={mode!r} on {device.type} tensors: the "
                         f"kernel runs only on CUDA tensors and the plain "
                         f"version only on CPU tensors")
    return mode


def _count(op, batch: int) -> None:
    """One launch of ``op``'s kernel, unless the batch was empty (nothing
    launched) or the call was recorded (``launcher.record_launches``)."""
    if batch > 0 and not launcher.recording():
        op.launches += 1


PRECISIONS = _ft.PRECISIONS


def _same_dtype(what: str, queries: torch.Tensor, rows: torch.Tensor
                ) -> None:
    """Queries and scored rows share one dtype, float32 or bfloat16."""
    if queries.dtype != rows.dtype or queries.dtype not in _ck.DTYPE_CODE:
        raise ValueError(f"{what}: queries and rows must both be float32 or "
                         f"both bfloat16, got {queries.dtype} and "
                         f"{rows.dtype}")


# ---------------------------------------------------------------------------
# centroid_topk / ivf_scan: the two stages of an IVF turn, one kernel each
# ---------------------------------------------------------------------------


def centroid_topk(queries: torch.Tensor, centroids: torch.Tensor, k: int, *,
                  mode: Optional[str] = None, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k centroids by float32 dot product for a query batch: queries
    (B, d), centroids (p, d), both float32 or both bfloat16 (widened).
    Returns (values (B, k) float32, ids (B, k) int32) in ``lax.top_k``'s
    order (score desc, index asc), the reference's "ref" mode.  Unlike its
    Pallas wrapper, which pads p with zero centroids and masks them only
    after its top-k, no padded centroid ever competes (ROADMAP,
    "Properties of the reference itself")."""
    dev = _device.require(device, queries, centroids)
    _same_dtype("centroid_topk", queries, centroids)
    if not 0 < k <= centroids.shape[0]:
        raise ValueError(f"top-{k} of {centroids.shape[0]} centroids")
    if _mode(mode, dev) == "ref":
        return ref.centroid_topk(queries, centroids, k)
    v, i = _ck.centroid_topk(queries.contiguous(), centroids,
                             kp=tiling.check_pad("k", k))
    _count(centroid_topk, queries.shape[0])
    return v[:, :k], i[:, :k]


centroid_topk.launches = 0


def ivf_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
             list_ids: torch.Tensor, sel: torch.Tensor, k: int, *,
             mode: Optional[str] = None, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan of the probed posting lists ``sel`` (B, nprobe): queries (B,
    d) and list_vecs (p, Lmax, d) both float32 or both bfloat16 (widened),
    list_ids (p, Lmax) int32 with -1 pads.  Returns (values (B, k)
    float32, doc ids (B, k) int32) in ``lax.top_k``'s order over the
    gathered lists (score desc, flat position ``probe·lmax + offset``
    asc); fewer than k real rows leave (-inf, -1)."""
    dev = _device.require(device, queries, list_vecs, list_ids, sel)
    _same_dtype("ivf_scan", queries, list_vecs)
    if not 0 < k <= sel.shape[1] * list_vecs.shape[1]:
        raise ValueError(f"top-{k} of {sel.shape[1]} lists of "
                         f"{list_vecs.shape[1]} slots")
    if _mode(mode, dev) == "ref":
        return ref.ivf_scan_batch(queries, list_vecs, list_ids, sel, k)
    v, i = _iv.ivf_scan(queries.contiguous(), list_vecs, list_ids,
                        sel.to(torch.int32).contiguous(),
                        kp=tiling.check_pad("k", k))
    _count(ivf_scan, sel.shape[0])
    return v[:, :k], i[:, :k]


ivf_scan.launches = 0


def check_precision(precision: str) -> None:
    """The one check of a fused op's ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: the fused ops "
                         f"take one of {PRECISIONS}")


# ---------------------------------------------------------------------------
# int8 group scales: one pass per index, kept per tensor
# ---------------------------------------------------------------------------

#: id(tensor) -> (weak reference, {(blk, n_groups): (_version, amax)})
_scales: Dict[int, Tuple[weakref.ref, Dict[Tuple[int, int],
                                           Tuple[int, torch.Tensor]]]] = {}


def group_scales(x: torch.Tensor, blk: int, n_groups: int) -> torch.Tensor:
    """The int8 group amax of an index tensor on the kernel path: lists
    (p, lmax, d) -> (p, n_groups), or centroids (p, d) as one set -> (1,
    n_groups), each group ``blk`` rows (``tiling.list_groups`` /
    ``centroid_groups``).  A group's amax depends on the index and the
    group size only, so one pass (``fused_turn.group_amax``) serves every
    call: the result is kept per tensor through a weak reference (a freed
    index drops it), keyed by (blk, n_groups) and the tensor's
    ``_version``, so an in-place edit recomputes it.  Inference tensors
    keep no version counter and are recomputed every call.  The port's
    own paths never write into an index tensor (``core.segment``'s
    mutations return new tensors); a write that bumps no version (through
    ``.data``, DLPack or a raw pointer) would leave a stale scale.  Under
    ``launcher.record_launches`` the pass is recorded when no valid
    result is kept, and nothing is kept."""
    entry = _scales.get(id(x))
    if entry is not None and entry[0]() is not x:
        entry = None
    version = None if x.is_inference() else x._version
    kept = entry[1].get((blk, n_groups)) if entry is not None else None
    if kept is not None and version is not None and kept[0] == version:
        return kept[1]
    out = _ft.group_amax(x if x.dim() == 3 else x.unsqueeze(0), blk,
                         n_groups)
    if launcher.recording() or version is None:
        return out
    if entry is None:
        key = id(x)
        entry = (weakref.ref(x, lambda _, key=key: _scales.pop(key, None)),
                 {})
        _scales[key] = entry
    entry[1][(blk, n_groups)] = (version, out)
    return out


def drop_scales() -> None:
    """Forget every kept int8 scale: the next int8 call on each index
    runs its scale pass again."""
    _scales.clear()


def _list_scales(list_vecs: torch.Tensor, r_pad: int, precision: str
                 ) -> Optional[torch.Tensor]:
    if precision != "int8":
        return None
    _, lmax, d = list_vecs.shape
    return group_scales(list_vecs, *tiling.list_groups(lmax, d, r_pad))


def _centroid_scales(centroids: torch.Tensor, np_pad: int, precision: str
                     ) -> Optional[torch.Tensor]:
    if precision != "int8":
        return None
    return group_scales(centroids, *tiling.centroid_groups(
        centroids.shape[0], np_pad))


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
    v, i, s = _ft.fused_turn(
        queries.contiguous(), centroids, list_vecs, list_ids, nprobe=nprobe,
        np_pad=np_pad, r_pad=r_pad, precision=precision, r=r,
        kp=tiling.next_pow2(k),
        amax=_list_scales(list_vecs, r_pad, precision),
        c_amax=_centroid_scales(centroids, np_pad, precision))
    _count(fused_turn, queries.shape[0])
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
                              kp=tiling.next_pow2(k),
                              amax=_list_scales(list_vecs, r_pad, precision))
    _count(fused_scan, queries.shape[0])
    return v[:, :k], i[:, :k], pp[:, :k]


fused_scan.launches = 0


# ---------------------------------------------------------------------------
# IVF-PQ: ADC scan, fused scan (+ exact re-rank), whole turn
# ---------------------------------------------------------------------------


def pq_adc_scan(tables: torch.Tensor, list_codes: torch.Tensor,
                list_ids: torch.Tensor, sel: torch.Tensor, k: int, *,
                mode: Optional[str] = None, device=None,
                adc_bulk: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan of the probed PQ lists ``sel`` (B, nprobe) with the
    per-query LUTs ``tables`` (B, m, n_codes): the ADC top-k (values
    (B, k), int32 ids (B, k)), to be re-ranked by the caller.
    ``adc_bulk`` forces the kernel's instance (True: the LUT by a bulk
    copy, False: staged by the threads; None: by ``tiling.ADC_BULK_MIN_B``)
    for measurement, on the kernel path; every instance gives the same
    bits, as rows 5 and 7 take it."""
    dev = _device.require(device, tables, list_codes, list_ids, sel)
    if _mode(mode, dev) == "ref":
        return ref.pq_adc_scan_batch(tables, list_codes, list_ids, sel, k)
    kp = tiling.check_pad("k", k)
    v, i, _ = _pq.pq_adc_scan(tables.to(torch.float32).contiguous(),
                              list_codes, list_ids,
                              sel.to(torch.int32).contiguous(), r_pad=kp,
                              bulk=adc_bulk)
    _count(pq_adc_scan, sel.shape[0])
    return v[:, :k], i[:, :k]


pq_adc_scan.launches = 0


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, k: int, rerank: int, precision: str = "f32",
                  mode: Optional[str] = None, device=None,
                  adc_bulk: Optional[bool] = None) -> Triple:
    """Whole IVF-PQ turn: centroid top-nprobe + ADC scan + exact re-rank
    of the ADC top ``r = max(k, min(rerank, nprobe·lmax))`` against
    ``corpus`` rows, whatever the precision (bf16 / int8 score the
    centroids and the ADC quantised).  Returns (values (B, k), ids
    (B, k), sel (B, nprobe)); ids and sel int32.  ``adc_bulk`` as
    ``pq_adc_scan``'s."""
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
        r_pad=r_pad, kp=tiling.next_pow2(k), precision=precision,
        c_amax=_centroid_scales(centroids, np_pad, precision),
        bulk=adc_bulk)
    _count(fused_turn_pq, queries.shape[0])
    return v[:, :k], i[:, :k], s[:, :nprobe]


fused_turn_pq.launches = 0


def fused_scan_pq(tables: torch.Tensor, queries: torch.Tensor,
                  list_codes: torch.Tensor, list_ids: torch.Tensor,
                  sel: torch.Tensor, corpus: torch.Tensor, k: int, *,
                  rerank: int, own: Optional[torch.Tensor] = None,
                  precision: str = "f32", fuse_rerank: bool = True,
                  mode: Optional[str] = None, device=None,
                  adc_bulk: Optional[bool] = None) -> Triple:
    """PQ ADC scan with a caller-supplied selection ``sel`` (B, nprobe).

    With ``fuse_rerank`` (single-device turns): the exact top-k of the
    ADC top r, (values (B, k), ids (B, k), ADC ranks (B, k)).  Without
    (the sharded merge): the ADC top r, (values (B, r), ids (B, r), flat
    positions ``probe·lmax + offset``, ``PAD_POS`` on -inf lanes).
    ``own`` masks lists this shard does not own.  bf16 / int8 score the
    ADC quantised; the re-rank is float32.  ``adc_bulk`` as
    ``pq_adc_scan``'s.
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
        kp=tiling.next_pow2(k), rerank=fuse_rerank, precision=precision,
        bulk=adc_bulk)
    _count(fused_scan_pq, sel.shape[0])
    w = k if fuse_rerank else r
    return v[:, :w], i[:, :w], pp[:, :w]


fused_scan_pq.launches = 0


# ---------------------------------------------------------------------------
# flash attention (the kernel forward, the plain version's VJP backward)
# ---------------------------------------------------------------------------


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, causal: bool, needs=(True,) * 3):
    """(dq, dk, dv) of ``ref.plain_attention`` at (q, k, v) against the
    output gradient g, recomputed under ``torch.enable_grad()`` in the
    inputs' own dtypes (the reference's ``_fa_bwd``: the plain math
    streams the keys above 2048² scores); None where ``needs`` is
    false."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(n) for t, n in zip((q, k, v),
                                                             needs)]
        out = ref.plain_attention(*qkv, causal=causal)
        wrt = [t for t in qkv if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
    return tuple(next(grads) if n else None for n in needs)


class Attention(torch.autograd.Function):
    """``forward`` runs ``launch(q, k, v, causal)`` (the CUDA kernel on
    the kernel path) and saves the caller's q, k and v, not the output;
    ``backward`` is ``attention_vjp``.  ``launch`` is a parameter so that
    the backward's logic can be checked on the CPU with the plain
    forward in the kernel's place."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, launch):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_vjp(q, k, v, g, ctx.causal,
                               ctx.needs_input_grad[:3]), None, None)


def _attention_kernel(q, k, v, causal: bool) -> torch.Tensor:
    """One launch of the CUDA kernel: inputs in a dtype it reads (float32
    otherwise), in a layout it takes (a contiguous copy otherwise);
    output in q's dtype."""
    dtype = q.dtype if q.dtype in _fa.ENTRIES and (
        k.dtype == v.dtype == q.dtype) else torch.float32
    qkv = [t.to(dtype) for t in (q, k, v)]
    out = _fa.flash_attention(
        *(t if _fa.takes(t) else t.contiguous() for t in qkv), causal=causal)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, mode: Optional[str] = None,
                    device=None) -> torch.Tensor:
    """Attention. q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv,
    Dv); Hkv divides H; returns (B, H, S, Dv) in q's dtype.

    Causal masking is bottom-right (queries are the last S positions).
    The plain version (CPU tensors) is ``ref.plain_attention``: above
    2048² scores it streams the keys (``ref.chunked_attention``), as the
    reference's does.  Unlike the reference, which drops to its plain
    math when S or Skv is not a multiple of 128, every CUDA call runs
    the kernel: it masks ragged tails itself.  bfloat16 and float32
    inputs are read as they are, strided views included (the layout
    copy is made only where rows are not 16-byte aligned; a head dim
    whose rows are not a multiple of 16 bytes is zero-padded by the
    binding); other dtypes go through float32.  On CUDA tensors the call
    goes through ``Attention``: inputs that require grad get the plain
    version's VJP as their backward, with the caller's unpadded q, k
    and v; the forward is the kernel whether or not they do.
    """
    dev = _device.require(device, q, k, v)
    _fa.check_shapes(q, k, v, causal=causal)
    if _mode(mode, dev) == "ref":
        return ref.plain_attention(q, k, v, causal=causal)
    out = Attention.apply(q, k, v, causal, _attention_kernel)
    _count(flash_attention, out.numel())
    return out


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
    cache in its own dtype.  A bfloat16 cache takes a bfloat16 or float32
    q as it is and writes the output in q's dtype: one launch, no casts.
    """
    dev = _device.require(device, q, k, v, cache_len)
    _fd.check_shapes(q, k, v, cache_len)
    if _mode(mode, dev) == "ref":
        return ref.decode_attention(q, k, v, cache_len)
    refuse_grad("flash_decode", q, k, v)
    qk = q if q.dtype in _fd.Q_DTYPES.get(k.dtype, ()) else q.to(
        torch.float32)
    out = _fd.flash_decode(qk.contiguous(), k.contiguous(), v.contiguous(),
                           cache_len.to(torch.int32).contiguous())
    _count(flash_decode, q.shape[0])
    return out.to(q.dtype)


flash_decode.launches = 0


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Refuse inputs that need grad where the kernel has no backward
    (``flash_decode``: serving only, as in the reference)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward only (serving; the "
            f"reference's has no backward either)")


# ---------------------------------------------------------------------------
# embedding_bag (the kernel forward, the plain sum bag's VJP backward)
# ---------------------------------------------------------------------------


def bag_vjp(table: torch.Tensor, ids: torch.Tensor,
            weights: Optional[torch.Tensor], g: torch.Tensor,
            needs=(True, True)):
    """(d table, d weights) of the plain sum bag (``ref.embedding_bag``)
    against the output gradient g (the reference's ``_eb_bwd``): a dense
    (V, d) table gradient, each row the sum of g[b] · w[b, l] over the
    (b, l) that name it (a pad names row 0 with weight 0, as the
    reference's gather does); d weights[b, l] = (g[b] · table[ids[b,
    l]]) for real ids, 0 for pads.  Accumulated in float32 (float64 for
    float64 inputs); None where ``needs`` is false or there are no
    weights.

    The table gradient is aten's embedding backward over the (b, l)
    terms (the VJP of a row gather; on the card the ids are sorted and
    each row's terms summed in a fixed order, no float atomics), so two
    calls give the same bits.  (``index_put_(accumulate=True)`` took 579 ms and a stable sort
    with ``torch.segment_reduce`` 87 ms at the two-tower's 1.6 M ids on
    the card; this 15.6 ms.)"""
    f = ref.acc_dtype(table.dtype)
    gf = g.to(f)
    rows = ids.clamp_min(0).long()
    d_table = d_w = None
    if needs[0]:
        w = ref._bag_weights(ids, weights).to(f)
        terms = (gf[:, None, :] * w[:, :, None]).reshape(-1, g.shape[-1])
        d_table = torch.ops.aten.embedding_dense_backward(
            terms, rows.reshape(-1), table.shape[0], -1, False
        ).to(table.dtype)
    if needs[1] and weights is not None:
        dots = (table[rows].to(f) * gf[:, None, :]).sum(-1)
        d_w = (dots * (ids >= 0).to(f)).to(weights.dtype)
    return d_table, d_w


class Bag(torch.autograd.Function):
    """``forward`` runs ``launch(table, ids, weights)`` (the CUDA sum bag
    on the kernel path) and saves its inputs; ``backward`` is
    ``bag_vjp`` (no gradient for the ids).  ``launch`` is a parameter for
    the CPU checks of the backward, as in ``Attention``."""

    @staticmethod
    def forward(ctx, table, ids, weights, launch):
        ctx.save_for_backward(table, ids, weights)
        return launch(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_table, d_w = bag_vjp(table, ids, weights, g, (need[0], need[2]))
        return d_table, None, d_w, None


def _bag_kernel(table, ids, weights) -> torch.Tensor:
    """One launch of the CUDA sum bag (float32 tables only)."""
    if table.dtype != torch.float32:
        raise NotImplementedError(
            f"embedding_bag: the CUDA kernel takes float32 tables, got "
            f"{table.dtype}")
    w32 = None if weights is None else weights.to(torch.float32).contiguous()
    return _eb.embedding_bag(table.contiguous(),
                             ids.to(torch.int32).contiguous(), w32)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, agg: str = "sum",
                  *, mode: Optional[str] = None, device=None
                  ) -> torch.Tensor:
    """EmbeddingBag: table (V, d), bags ids (B, L) int (negative = pad),
    weights (B, L) or None -> (B, d) in the table's dtype.

    ``agg="mean"`` divides the bag's sum by max(Σ mask·w, 1), the
    reference's rule, on both paths, outside the sum's autograd Function
    as the reference has it.  The kernel takes float32 tables; on CUDA
    tensors the sum goes through ``Bag``, whose backward is the plain
    sum bag's VJP (a dense table gradient).  On CUDA tensors, ids must
    be < V: the caller checks them on the host, where they come in
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
    out = Bag.apply(table, ids, weights, _bag_kernel)
    _count(embedding_bag, ids.shape[0])
    return ref.bag_mean(out, ids, weights) if agg == "mean" else out


embedding_bag.launches = 0


# ---------------------------------------------------------------------------
# hnsw_search: the HNSW traversal, one block per query
# ---------------------------------------------------------------------------


def hnsw_search(vectors: torch.Tensor, adj0: torch.Tensor,
                upper_adj: torch.Tensor, entry_point: torch.Tensor,
                queries: torch.Tensor,
                entry_override: Optional[torch.Tensor] = None, *, ef: int,
                k: int, deleted: Optional[torch.Tensor] = None,
                mode: Optional[str] = None, device=None) -> Triple:
    """HNSW search of B queries (the reference's ``_search_impl``, an XLA
    ``while_loop`` there): vectors (n, d) float32, adj0 (n, 2M) and
    upper_adj (L, n, M) int32 with -1 pads, entry_point () int32, queries
    (B, d) float32; ``entry_override`` (B,) starts the level-0 beam there
    and skips the descent; ``deleted`` (n,) bool masks tombstones out of
    the result.  Returns (scores (B, k) float32, ids (B, k) int32, ndist
    (B,) int32).  On CUDA tensors one ``csrc/hnsw_search.cu`` launch,
    within ``tiling.check_hnsw``'s caps (ValueError past them); on CPU
    tensors ``ref.hnsw_search``."""
    dev = _device.require(device, vectors, adj0, upper_adj, entry_point,
                          queries, entry_override, deleted)
    if queries.dim() != 2 or queries.shape[1] != vectors.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} against vectors "
                         f"{tuple(vectors.shape)}")
    if not 0 < k <= ef:
        raise ValueError(f"top-{k} of a beam of {ef}")
    if _mode(mode, dev) == "ref":
        return ref.hnsw_search(vectors, adj0, upper_adj, entry_point,
                               queries, entry_override, ef=ef, k=k,
                               deleted=deleted)
    out = _hs.hnsw_search(
        vectors, adj0, upper_adj, entry_point.to(torch.int32).contiguous(),
        queries.to(torch.float32).contiguous(),
        None if entry_override is None
        else entry_override.to(torch.int32).contiguous(), deleted, ef=ef,
        k=k)
    _count(hnsw_search, queries.shape[0])
    return out


hnsw_search.launches = 0


def hnsw_search_sharded(parts, n_local: int, adj0: torch.Tensor,
                        upper_adj: torch.Tensor, entry_point: torch.Tensor,
                        queries: torch.Tensor,
                        entry_override: Optional[torch.Tensor] = None, *,
                        ef: int, k: int,
                        deleted: Optional[torch.Tensor] = None,
                        mode: Optional[str] = None, device=None) -> Triple:
    """``hnsw_search`` over row-sharded vectors: ``parts[s]`` holds rows
    [s·n_local, s·n_local + len(parts[s])); the graph and the queries lie
    on the leader device.  Each score is the owner's dot summed in shard
    order with the other shards' exact zeros (the reference's ``psum``).
    One shard is the unsharded search (``hnsw_search``, its launch
    counted there); from two, on CUDA tensors one launch of
    ``csrc/hnsw_search.cu``'s sharded instance, on CPU tensors
    ``ref.hnsw_search`` with ``ref.hnsw_sharded_dots``."""
    if len(parts) == 1:
        return hnsw_search(parts[0], adj0, upper_adj, entry_point, queries,
                           entry_override, ef=ef, k=k, deleted=deleted,
                           mode=mode, device=device)
    dev = _device.require(device, adj0, upper_adj, entry_point, queries,
                          entry_override, deleted, *parts)
    if queries.dim() != 2 or queries.shape[1] != parts[0].shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} against shards "
                         f"of {parts[0].shape[1]} columns")
    if not 0 < k <= ef:
        raise ValueError(f"top-{k} of a beam of {ef}")
    if _mode(mode, dev) == "ref":
        return ref.hnsw_search(None, adj0, upper_adj, entry_point, queries,
                               entry_override, ef=ef, k=k, deleted=deleted,
                               dots_factory=ref.hnsw_sharded_dots(parts,
                                                                  n_local))
    out = _hs.hnsw_search_sharded(
        parts, n_local, adj0, upper_adj,
        entry_point.to(torch.int32).contiguous(),
        queries.to(torch.float32).contiguous(),
        None if entry_override is None
        else entry_override.to(torch.int32).contiguous(), deleted, ef=ef,
        k=k)
    _count(hnsw_search_sharded, queries.shape[0])
    return out


hnsw_search_sharded.launches = 0


#: the ops whose launches are counted
COUNTED = ("centroid_topk", "ivf_scan", "fused_turn", "fused_scan",
           "pq_adc_scan", "fused_turn_pq", "fused_scan_pq", "flash_attention",
           "flash_decode", "embedding_bag", "hnsw_search",
           "hnsw_search_sharded")


def reset_launches() -> None:
    """Set every op's launch count to 0."""
    for name in COUNTED:
        globals()[name].launches = 0


def launch_counts() -> Dict[str, int]:
    """Every op's launch count, by name."""
    return {name: globals()[name].launches for name in COUNTED}
