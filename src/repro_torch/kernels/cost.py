"""What each kernel must move and compute: the bytes and FLOPs of a call.

Every formula has a **data-aware** form (``*_bound``), which counts
only the work this call's data needs: the real ids of a bag, the real
rows of the probed lists, each decode row's cache up to its
``cache_len``.  The ``[times]`` rows of ``chip_smoke.py`` divide these
by the card's rates into their ``bound_ms``.

The kernels the registry's steps reach (rows 1, 2, 8, 9 and 10) also
have a **shape-only** form (``*_cost``), which reads shapes and dtypes
and nothing else: every id counts as real, every list row as filled,
every decode row's cache as full to S.  It is what a call on ``meta``
tensors can count, so the launcher's cost counter (``launcher.
count_costs``) and the dry-run (``launch.analysis``) use it on the
``meta`` device and on the card alike, and the two counts agree.  Each
``*_bound`` of these rows is its ``*_cost`` given the real row count.

A ``Cost`` is (flops, bytes, the FLOPs' rate class).  The rate classes
are the H100 SXM datasheet's: ``"f32"`` (the CUDA cores, 67 TFLOP/s:
TF32 is off in the port), ``"bf16"`` (dense tensor cores, 989 TFLOP/s)
and ``"tf32x3"`` (a float32 product in three TF32 tensor-core passes, as
the float32 attention kernels compute it: 495 / 3 TFLOP/s).  Bytes move
at the HBM3 rate, 3.35 TB/s.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
# float32 products in 3xTF32: three tf32 tensor-core passes (495 TFLOP/s
# dense) per product
TF32X3_FLOP_PER_S = 495e12 / 3
#: FLOP/s of each rate class
RATES = {"f32": F32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S,
         "tf32x3": TF32X3_FLOP_PER_S}


class Cost(NamedTuple):
    """One kernel call's work: FLOPs, bytes moved, the FLOPs' rate
    class (a key of ``RATES``)."""
    flops: int
    nbytes: int
    rate: str = "f32"


def bound_ms(nbytes, flops, flop_rate=F32_FLOP_PER_S) -> Tuple[float, str]:
    """The least time for this work: bytes over the memory rate or
    operations over the peak rate of the inputs' type, the larger; and
    which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _esize(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# row 1: centroid_topk (data-independent)
# ---------------------------------------------------------------------------


def ck_cost(c_shape, q_shape, kp, dtype) -> Cost:
    """A centroid top-k: the table and the queries read once, in
    ``dtype``, the (B, kp) values and ids written once; 2 p d a query."""
    (p, d), b = c_shape, q_shape[0]
    es = _esize(dtype)
    return Cost(2 * b * p * d, (p * d + b * d) * es + b * kp * 8, "f32")


def ck_bound(c, q, kp) -> Tuple[int, int]:
    """(bytes, flops) of a centroid top-k of float32 operands."""
    import torch
    w = ck_cost(c.shape, q.shape, kp, torch.float32)
    return w.nbytes, w.flops


# ---------------------------------------------------------------------------
# rows 2, 4, 6: scanning posting lists
# ---------------------------------------------------------------------------


def scan_cost(b, nprobe, lmax, d, out_w, dtype, out_bytes=12,
              rows=None) -> Cost:
    """A scan of the probed lists: ``rows`` rows read in ``dtype`` (by
    default every one of the lmax rows of each probed list, counted as
    real), the ids of every slot, the float32 query, the selection and
    the (B, out_w) outputs; ``out_bytes`` a result slot (value, id and
    position: 12; ``ivf_scan`` writes no position: 8)."""
    slots = b * nprobe * lmax
    rows = slots if rows is None else rows
    return Cost(2 * rows * d, rows * d * _esize(dtype) + slots * 4
                + b * d * 4 + b * nprobe * 4 + b * out_w * out_bytes, "f32")


def scan_bound(index, q, sel, r_pad) -> Tuple[int, int]:
    """(bytes, flops) fused_scan must move and do for these inputs: the
    real float32 rows of the probed lists."""
    import torch
    b, nprobe = sel.shape
    w = scan_cost(b, nprobe, index.lmax, index.d, r_pad, torch.float32,
                  rows=int(index.list_sizes[sel.long()].sum()))
    return w.nbytes, w.flops


# ---------------------------------------------------------------------------
# rows 3, 5, 7: the ADC scan
# ---------------------------------------------------------------------------


def adc_bound(pqi, q, sel, r, out_w, rerank) -> Tuple[int, int]:
    """(bytes, flops) of the ADC scan of these inputs: the code rows of
    the probed lists' real docs, their ids, the (B, m, 256) LUTs, the
    selection and the (B, out_w) outputs; ``m`` adds per real row.  With
    ``rerank``, the query and the corpus rows of each query's min(r,
    real rows) candidates, and their dot products."""
    b, nprobe = sel.shape
    real = pqi.list_sizes[sel.long()].sum(-1)
    rows = int(real.sum())
    nbytes = (rows * pqi.m + b * nprobe * pqi.lmax * 4
              + b * pqi.codewords.shape[:2].numel() * 4 + sel.numel() * 4
              + b * out_w * 12)
    flops = rows * pqi.m
    if rerank:
        cand = int(real.clamp(max=r).sum())
        nbytes += q.numel() * 4 + cand * pqi.d * 4
        flops += 2 * cand * pqi.d
    return nbytes, flops


# ---------------------------------------------------------------------------
# row 8: flash attention
# ---------------------------------------------------------------------------


def attn_cost(q_shape, k_shape, v_shape, dtype, causal=False) -> Cost:
    """q, k, v read once and the output written once, in their dtype;
    the QK^T and PV products (causal: only the unmasked part, bottom
    right: query i of S, the last of Skv, sees skv - s + i + 1 keys).
    bfloat16 runs on the tensor cores, float32 in 3xTF32."""
    b, h, s, d = (int(x) for x in q_shape)
    skv, dv = int(k_shape[2]), int(v_shape[3])
    nbytes = _esize(dtype) * (_numel(q_shape) + _numel(k_shape)
                              + _numel(v_shape) + b * h * s * dv)
    pairs = s * skv
    if causal:
        pairs = s * (skv - s) + s * (s + 1) // 2
    import torch
    return Cost(2 * b * h * pairs * (d + dv), nbytes,
                "bf16" if dtype == torch.bfloat16 else "tf32x3")


def attn_bound(q, k, v, causal=False) -> Tuple[int, int]:
    """(bytes, flops) of attention over these inputs (``attn_cost``: the
    work does not depend on the data)."""
    c = attn_cost(q.shape, k.shape, v.shape, q.dtype, causal)
    return c.nbytes, c.flops


# ---------------------------------------------------------------------------
# row 9: decode attention
# ---------------------------------------------------------------------------


def decode_cost(q_shape, k_shape, q_dtype, k_dtype, rows=None) -> Cost:
    """Decode attention: ``rows`` cache rows of K and V read once (by
    default every row's cache full to S), q and cache_len read once, the
    output written once; 4 FLOP per cache element per query head of the
    group.  A bfloat16 cache runs on the tensor cores, a float32 one in
    3xTF32."""
    import torch
    b, h, d = (int(x) for x in q_shape)
    hkv, s = int(k_shape[1]), int(k_shape[2])
    rows = b * s if rows is None else rows
    nbytes = (2 * rows * hkv * d * _esize(k_dtype)
              + 2 * b * h * d * _esize(q_dtype) + b * 4)
    return Cost(4 * rows * h * d, nbytes,
                "bf16" if k_dtype == torch.bfloat16 else "tf32x3")


def decode_bound(q, k, lens) -> Tuple[int, int]:
    """(bytes, flops) of decode attention over these inputs: each row's
    first min(cache_len, S) rows of its cache."""
    w = decode_cost(q.shape, k.shape, q.dtype, k.dtype,
                    rows=int(lens.clamp(max=k.shape[2]).sum()))
    return w.nbytes, w.flops


# ---------------------------------------------------------------------------
# row 10: embedding bag
# ---------------------------------------------------------------------------


def bag_cost(ids_shape, d, weighted=False, rows=None) -> Cost:
    """A bag sum: ``rows`` table rows read once (by default every id
    real), the ids (and the weights, where given) read once, the (B, d)
    output written once; a product and a sum per element of a row."""
    b, bag = (int(x) for x in ids_shape)
    rows = b * bag if rows is None else rows
    return Cost(2 * rows * d, rows * d * 4 + b * bag * 4 * (2 if weighted
                                                            else 1)
                + b * d * 4, "f32")


def bag_bound(ids, d) -> Tuple[int, int]:
    """(bytes, flops) of an unweighted bag sum over these ids: each real
    id's row."""
    w = bag_cost(ids.shape, d, rows=int((ids >= 0).sum()))
    return w.nbytes, w.flops


# ---------------------------------------------------------------------------
# hnsw_search
# ---------------------------------------------------------------------------


def hnsw_bound(index, nd, b, k) -> Tuple[int, int]:
    """(bytes, flops) of a search with these distance counts: each scored
    row's vector and at least its adjacency entry, the queries and the
    outputs; 2 d flops a scored row."""
    d = index.vectors.shape[1]
    n = int(nd.sum())
    return n * (d + 1) * 4 + b * d * 4 + b * (k * 8 + 4), 2 * n * d
