"""Optimizers: AdamW, Adafactor and SGD with momentum
(``repro/optim/optimizers.py``), as ``torch.optim.Optimizer`` subclasses.

Each ``step()`` computes the reference's update literally, every
parameter's in float32 whatever its dtype:

* AdamW: float32 moments (``moment_dtype``), bias corrections 1 − b^step,
  u = −lr · (m̂ / (√v̂ + eps) + wd · p);
* Adafactor (arXiv:1804.04235): factored row and column statistics for a
  parameter of rank ≥ 2 whose last two dims are both ≥
  ``min_dim_size_to_factor``, a full second moment otherwise, β = 1 −
  step^−decay, and the update clipped to an RMS of ``clip_threshold``;
* SGD: plain, momentum, or Nesterov.

The new weight is (p + u) computed in float32 and cast to p's dtype
(``apply_updates``), so a bfloat16 parameter is updated as the reference
updates it, not in bfloat16 as ``torch.optim.AdamW`` would.  The state is
made when the optimizer is (the reference's ``init``): zeros and a step
of 0 per parameter, so ``state_dict()["state"]`` carries the step and
every moment to a checkpoint from the start, and a restore writes into
tensors that already exist (``checkpoint.load_into``).  The learning
rate is a schedule of the step (``optim.schedules``) or a number.

``step(grads=...)`` takes the gradients as a list in parameter order (the
train steps pass clipped or accumulated ones, which may be float32 for a
bfloat16 parameter); without it each parameter's ``.grad`` is used, and
a missing one counts as zeros, as the reference's gradient of an unused
leaf is.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import torch

from repro_torch.optim import schedules

LR = Union[float, Callable[[int], torch.Tensor]]


def _to_schedule(lr: LR):
    return lr if callable(lr) else schedules.constant(lr)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """p ← (p + u) in float32, cast to p's dtype, in place."""
    for p, u in zip(params, updates):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_((p.float() + u).to(p.dtype))


class _Optimizer(torch.optim.Optimizer):
    """The step loop shared by the three: gradients in, float32 updates
    out of ``_update``, then ``apply_updates``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: LR,
                 defaults: Dict):
        self.schedule = _to_schedule(lr)
        super().__init__(params, defaults)
        for p in self.params:
            self.state[p] = dict(self._init(p),
                                 step=torch.zeros((), dtype=torch.int32))

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def step_count(self) -> int:
        """Updates applied so far (the reference's ``state["step"]``)."""
        return int(self.state[self.params[0]]["step"]) if self.params else 0

    def _init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _update(self, g, st, p, step, lr) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, *,
             grads: Optional[Sequence[Optional[torch.Tensor]]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self.params
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             f"parameters")
        step = self.step_count + 1
        lr = self.schedule(step)
        updates = []
        for p, g in zip(params, grads):
            st = self.state[p]
            g = torch.zeros_like(p) if g is None else g
            updates.append(self._update(g, st, p, step, lr))
            st["step"].fill_(step)
        apply_updates(params, updates)
        return loss


class AdamW(_Optimizer):
    """``repro/optim/optimizers.py:48`` ``adamw``: b1 0.9, b2 0.95, eps
    1e-8 and no decay by default, float32 moments."""

    def __init__(self, params, lr: LR, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.float32):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.moment_dtype = weight_decay, moment_dtype
        super().__init__(params, lr, dict(b1=b1, b2=b2, eps=eps,
                                          weight_decay=weight_decay))

    def _init(self, p):
        return {"m": torch.zeros(p.shape, dtype=self.moment_dtype,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=self.moment_dtype,
                                 device=p.device)}

    def _update(self, g, st, p, step, lr):
        b1, b2 = self.b1, self.b2
        s = torch.tensor(step, dtype=torch.float32)
        bc1, bc2 = 1 - b1 ** s, 1 - b2 ** s
        gf = g.float()
        m = st["m"].float().mul(b1).add_(gf * (1 - b1))
        v = st["v"].float().mul(b2).add_(gf * (1 - b2) * gf)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
        if self.weight_decay:
            u.add_(self.weight_decay * p.float())
        st["m"].copy_(m)
        st["v"].copy_(v)
        return u.mul_(-lr)


class Adafactor(_Optimizer):
    """``repro/optim/optimizers.py:90`` ``adafactor``: decay 0.8, eps
    1e-30, update RMS clipped at 1.0, factored from 128 x 128."""

    def __init__(self, params, lr: LR, decay: float = 0.8,
                 eps: float = 1e-30, clip_threshold: float = 1.0,
                 min_dim_size_to_factor: int = 128):
        self.decay, self.eps = decay, eps
        self.clip_threshold = clip_threshold
        self.min_dim = min_dim_size_to_factor
        super().__init__(params, lr, dict(decay=decay, eps=eps))

    def factored(self, shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= self.min_dim
                and shape[-2] >= self.min_dim)

    def _init(self, p):
        z = dict(dtype=torch.float32, device=p.device)
        if self.factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    def _update(self, g, st, p, step, lr):
        eps = self.eps
        beta = 1.0 - torch.tensor(step, dtype=torch.float32) ** (-self.decay)
        gf = g.float()
        g2 = gf * gf + eps
        if "vr" in st:
            vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
            denom = ((vr[..., None] / vr.mean(-1, keepdim=True)[..., None])
                     * vc[..., None, :])
            u = gf * torch.rsqrt(denom + eps)
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        else:
            v = beta * st["v"] + (1 - beta) * g2
            u = gf * torch.rsqrt(v + eps)
            st["v"].copy_(v)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / (rms / self.clip_threshold).clamp_min(1.0)
        return -lr * u


class SGD(_Optimizer):
    """``repro/optim/optimizers.py:148`` ``sgd``: plain, with momentum, or
    Nesterov."""

    def __init__(self, params, lr: LR, momentum: float = 0.0,
                 nesterov: bool = False):
        self.momentum, self.nesterov = momentum, nesterov
        super().__init__(params, lr, dict(momentum=momentum,
                                          nesterov=nesterov))

    def _init(self, p):
        if self.momentum == 0.0:
            return {}
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    def _update(self, g, st, p, step, lr):
        gf = g.float()
        if self.momentum == 0.0:
            return -lr * gf
        m = self.momentum * st["m"] + gf
        st["m"].copy_(m)
        if self.nesterov:
            return -lr * (self.momentum * m + gf)
        return -lr * m


REGISTRY = {"adamw": AdamW, "adafactor": Adafactor, "sgd": SGD}


def make(name: str, params, lr: LR, **kw) -> _Optimizer:
    """The optimizer ``name`` over ``params`` (the reference's ``make``
    with the parameters it will update)."""
    return REGISTRY[name](params, lr, **kw)
