"""Gradient utilities (``repro/optim/grad.py``): the gradient of a loss,
clipping by the global norm, microbatch accumulation, and int8
error-feedback compression.

A loss function takes ``(model, batch)`` and returns ``(loss, metrics)``
(the reference's ``(params, batch)``); gradients are lists in the order
of ``trainable(model)``.  ``compressed_mean`` runs the compression's
numerics on one process; across a process group it is not ported
(ROADMAP Queue 1 item 7, part 3).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

LossFn = Callable[[nn.Module, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def trainable(model: nn.Module) -> List[nn.Parameter]:
    """The parameters a step updates, in ``model.parameters()`` order."""
    return [p for p in model.parameters() if p.requires_grad]


def value_and_grad(loss_fn: LossFn, model: nn.Module, batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]],
                              List[torch.Tensor]]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    the gradient of every trainable parameter, zeros where the loss does
    not reach it)."""
    params = trainable(model)
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²), each leaf's sum in float32."""
    return torch.sqrt(torch.stack([(g.float() ** 2).sum()
                                   for g in grads]).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Every gradient times min(1, max_norm / max(norm, 1e-9)) (in its
    own dtype), and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / norm.clamp_min(1e-9), 1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


def accumulate(loss_fn: LossFn, model: nn.Module,
               batches: Dict[str, torch.Tensor], *, has_aux: bool = True):
    """The mean gradient over the leading microbatch axis of every batch
    tensor, in float32 (each microbatch's gradient / n added to a zero
    accumulator in turn, as the reference's scan does); with ``has_aux``
    also the metrics' mean, (grads, metrics)."""
    n = next(iter(batches.values())).shape[0]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in trainable(model)]
    aux_acc: Optional[Dict[str, torch.Tensor]] = None
    for i in range(n):
        (_, aux), g = value_and_grad(loss_fn, model,
                                     {k: v[i] for k, v in batches.items()})
        acc = [a + b / n for a, b in zip(acc, g)]
        if has_aux:
            aux = {k: v / n for k, v in aux.items()}
            aux_acc = aux if aux_acc is None else {
                k: aux_acc[k] + aux[k] for k in aux_acc}
    return (acc, aux_acc) if has_aux else acc


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------


def init_error_feedback(params: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + the carried error -> (int8 codes, scale, new error): the scale
    max|g + err| / 127 (at least 1e-12 / 127), codes rounded half to
    even and clipped to ±127."""
    gf = g.float() + err
    scale = gf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_mean(grads: Sequence[torch.Tensor],
                    err_state: Sequence[torch.Tensor],
                    axis_name: Optional[str] = None
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Quantise and dequantise every gradient with error feedback: the
    single-process numerics of the reference's compressed all-reduce
    (its ``axis_name=None`` branch).  Returns (dequantised grads, new
    errors)."""
    if axis_name is not None:
        raise NotImplementedError(
            "compressed_mean over a process group is not ported (ROADMAP "
            "Queue 1 item 7, part 3: torch.distributed)")
    out, errs = [], []
    for g, e in zip(grads, err_state):
        q, scale, new_e = compress(g, e)
        out.append(decompress(q, scale))
        errs.append(new_e)
    return out, errs
