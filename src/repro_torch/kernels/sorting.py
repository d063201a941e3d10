"""Tie-aware top-k order shared by the fused kernels and their plain versions.

The reference keeps its running top-k inside Pallas kernels with
bitonic compare-exchange networks (``repro/kernels/sorting.py``) that
order candidates by the composite key (value desc, position asc) — the
order ``lax.top_k`` gives over a flat row, ties going to the smaller
source position, and +0.0 above -0.0 (``core.topk.order_key``).  Pads
carry ``(-inf, id -1, PAD_POS)`` and so can never displace a real
candidate.

On the card that order is realised by the device functions of
``csrc/topk_tie.cuh``.  Here it is the plain PyTorch version: a stable
sort by position, then a stable descending sort by value — equal to the
bitonic networks wherever the keys are distinct (every real candidate
has its own position; pads are identical).
"""
from __future__ import annotations

from typing import Tuple

import torch

#: position sentinel for padding lanes (INT32_MAX)
PAD_POS = 2 ** 31 - 1

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def block_topk_desc_tie(vals: torch.Tensor, ids: torch.Tensor,
                        pos: torch.Tensor, k: int) -> Triple:
    """Top-k under (value desc, position asc); counterpart of
    ``repro.kernels.sorting.block_topk_desc_tie``."""
    # imported here: repro_torch.core imports this module's package
    from repro_torch.core.topk import order_key
    o1 = torch.sort(pos, dim=-1, stable=True).indices
    o2 = torch.sort(order_key(vals.gather(-1, o1)), dim=-1,
                    descending=True, stable=True).indices
    order = o1.gather(-1, o2)[..., :k]
    return vals.gather(-1, order), ids.gather(-1, order), pos.gather(-1, order)


def merge_topk_desc_tie(run_v: torch.Tensor, run_i: torch.Tensor,
                        run_p: torch.Tensor, blk_v: torch.Tensor,
                        blk_i: torch.Tensor, blk_p: torch.Tensor) -> Triple:
    """Merge two sorted tiles, keep the run's width; counterpart of
    ``repro.kernels.sorting.merge_topk_desc_tie``."""
    k = run_v.shape[-1]
    return block_topk_desc_tie(torch.cat([run_v, blk_v], -1),
                               torch.cat([run_i, blk_i], -1),
                               torch.cat([run_p, blk_p], -1), k)
