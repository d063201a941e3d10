"""Launch of the centroid top-k kernel (``csrc/centroid_topk.cu``).

Counterpart of ``repro/kernels/centroid_topk.py`` ``centroid_topk``.  As
in ``fused_turn.py``: CUDA tensors only, every operand checked (device,
dtype, shape, contiguity, 16-byte rows), outputs and scratch allocated
here, and the entry with its launch plan handed to ``launcher.run``.
Queries and centroids are float32 or bfloat16, one dtype for both, read
in that dtype by the kernel.  Padding and the choice between kernel and
plain version belong to ``ops.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cost, launcher, tiling
from repro_torch.kernels.fused_turn import _check, fold_counters

#: operand dtypes the kernels read, and their codes in the C entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: the kernel reads float32 or bfloat16, "
                         f"got {t.dtype}")


def centroid_topk(queries: torch.Tensor, centroids: torch.Tensor, *,
                  kp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top ``kp`` centroids by float32 dot product: (values
    (B, kp) float32, centroid indices (B, kp) int32), ordered by (score
    desc, index asc); slots past p hold (-inf, PAD_POS).  A B of 0
    launches nothing."""
    check_dtype("queries", queries)
    _check("queries", queries, queries.dtype, 2)
    _check("centroids", centroids, queries.dtype, 2)
    b, d = queries.shape
    p = centroids.shape[0]
    if centroids.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} and centroids "
                         f"{tuple(centroids.shape)} disagree on d")
    if queries.device != centroids.device:
        raise ValueError("queries and centroids lie on different devices")
    tiling.check_width(d, queries.element_size())
    qt = tiling.centroid_qtile(b, d)
    if -(-b // qt) > tiling.MAX_GRID_Y:
        raise ValueError(f"batch {b}: more than {tiling.MAX_GRID_Y} blocks "
                         f"of {qt} queries")
    if not 0 < kp <= tiling.MAX_PAD or kp & (kp - 1):
        raise ValueError(f"kp={kp}: a power of two <= {tiling.MAX_PAD}")
    dev = queries.device
    chunks = tiling.centroid_chunks(p)
    w1 = min(kp, tiling.CENTROID_CHUNK)
    n = b * (chunks * w1 + tiling.merge_scratch(chunks, kp, w1))
    s1_v = torch.empty(n, dtype=torch.float32, device=dev)
    s1_i = torch.empty(n, dtype=torch.int32, device=dev)
    out_v = torch.empty((b, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, kp), dtype=torch.int32, device=dev)
    _, counters = fold_counters(
        dev, 0, tiling.select_counters(b, p, d)
        if tiling.select_fold(b, p, d, kp) else 0)
    plan = tiling.plan_centroid_topk(b, p, d, kp)
    launcher.count("centroid_topk", plan, cost.ck_cost(
        centroids.shape, queries.shape, kp, queries.dtype))
    launcher.run("centroid_topk", plan, dev,
                 queries, centroids, DTYPE_CODE[queries.dtype], p, b, d, kp,
                 s1_v, s1_i, counters, out_v, out_i)
    return out_v, out_i
