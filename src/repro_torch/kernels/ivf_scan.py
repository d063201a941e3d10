"""Launch of the probed-list scan kernel (``csrc/ivf_scan.cu``).

Counterpart of ``repro/kernels/ivf_scan.py`` ``ivf_scan``.  As in
``fused_turn.py``: CUDA tensors only, every operand checked (device,
dtype, shape, contiguity, 16-byte rows), outputs and scratch allocated
here, and the entry with its launch plan handed to ``launcher.run``.
Queries and list rows are float32 or bfloat16, one dtype for both, read
in that dtype by the kernel.  Padding and the choice between kernel and
plain version belong to ``ops.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cost, launcher, tiling
from repro_torch.kernels.centroid_topk import DTYPE_CODE, check_dtype
from repro_torch.kernels.fused_turn import _check, scan_lists
from repro_torch.kernels.sorting import PAD_POS


def ivf_scan(queries: torch.Tensor, list_vecs: torch.Tensor,
             list_ids: torch.Tensor, sel: torch.Tensor, *, kp: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the probed lists ``sel`` (B, nprobe) int32: each query's top
    ``kp`` rows by float32 dot product, (values (B, kp) float32, doc ids
    (B, kp) int32), ordered by (score desc, flat position probe·lmax +
    offset asc); ids < 0 are pads and slots past the real rows hold
    (-inf, -1).  A B of 0 launches nothing."""
    check_dtype("queries", queries)
    _check("queries", queries, queries.dtype, 2)
    _check("list_vecs", list_vecs, queries.dtype, 3)
    _check("list_ids", list_ids, torch.int32, 2)
    _check("sel", sel, torch.int32, 2)
    p, lmax, d = list_vecs.shape
    b, nprobe = sel.shape
    if tuple(queries.shape) != (b, d) or tuple(list_ids.shape) != (p, lmax):
        raise ValueError(f"shapes disagree: queries {tuple(queries.shape)}, "
                         f"list_vecs {tuple(list_vecs.shape)}, list_ids "
                         f"{tuple(list_ids.shape)}, sel {tuple(sel.shape)}")
    if len({t.device for t in (queries, list_vecs, list_ids, sel)}) != 1:
        raise ValueError("queries, lists and sel lie on different devices")
    tiling.check_width(d, queries.element_size())
    if b > tiling.MAX_GRID_Y:
        raise ValueError(f"batch {b} > {tiling.MAX_GRID_Y}")
    if nprobe * lmax >= PAD_POS:
        raise ValueError("flat scan positions overflow int32")
    if not 0 < kp <= tiling.MAX_PAD or kp & (kp - 1):
        raise ValueError(f"kp={kp}: a power of two <= {tiling.MAX_PAD}")
    dev = queries.device
    out_v = torch.empty((b, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, kp), dtype=torch.int32, device=dev)
    lists, _ = scan_lists(b, nprobe, lmax, kp, dev)
    plan = tiling.plan_ivf_scan(b, nprobe, lmax, d, kp)
    launcher.count("ivf_scan", plan,
                   cost.scan_cost(b, nprobe, lmax, d, kp, queries.dtype, 8))
    launcher.run("ivf_scan", plan,
                 dev, queries, list_vecs, DTYPE_CODE[queries.dtype], list_ids,
                 p, sel, b, nprobe, lmax, d, kp, *lists, out_v, out_i)
    return out_v, out_i
