"""Dispatch wrappers for the port's kernels.

Each op has two execution paths, picked by the device of its tensors:

  * ``"kernel"`` — the CUDA kernel (``fused_turn.py`` → ``csrc/``), the
                   only path for CUDA tensors;
  * ``"ref"``    — the plain PyTorch version (``ref.py``), the only path
                   for CPU tensors.

There is no fallback between them: ``mode="kernel"`` on CPU tensors and
``mode="ref"`` on CUDA tensors raise, a failed build raises, a refused
launch raises.  The wrappers keep the reference's signatures and
return shapes (``repro/kernels/ops.py:130-164`` and ``:209-248``), own
the power-of-two padding of k / nprobe, and count their launches in a
plain int on the wrapper (``fused_turn.launches``), so a run can show
that its path went through the kernels.

Only ``precision="f32"`` is ported; the bf16/int8 variants (stage-3
in-kernel re-rank) are ROADMAP Queue 1, item 3.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import fused_turn as _ft
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


def reset_launches() -> None:
    """Set every op's launch count to 0."""
    fused_turn.launches = 0
    fused_scan.launches = 0
