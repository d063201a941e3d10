"""The architecture registry and the train-step bundles shared by every
architecture (the train half of ``repro/configs/common.py``).

Every architecture file registers an ``ArchDef``; the launcher
(``launch/train.py``) asks it for a ``StepBundle`` of a train shape: the
step function, the seeded model and its optimizer, and the shapes and
dtypes of a batch.  The reference's PartitionSpecs, donation hints and
``ShapeDtypeStruct`` stand-ins are TPU lowering and have no counterpart:
a bundle here builds real tensors on one device.  Serve shapes are not
bundled: their steps are the models' own methods (``LM.prefill`` /
``decode_step``, the recsys models' forwards, ``configs.
two_tower_retrieval``'s serve steps).

A step is ``step_fn(model, optimizer, batch) -> metrics``: the loss and
its gradients (``optim.grad.value_and_grad``), the gradients clipped to
a global norm of 1.0, one optimizer update (``simple_train_step``, and
``lm_bundle``'s microbatch accumulation).  ``LM_SHAPES``,
``LM_SHAPE_PARAMS`` and ``LM_SMOKE_SHAPE_PARAMS`` are copies of
``:91-114``, the same keys and values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import transformer as TF
from repro_torch.optim import grad as G
from repro_torch.optim import optimizers as OPT
from repro_torch.optim import schedules as SCHED


class Struct(NamedTuple):
    """The shape and dtype of one batch tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def struct(shape, dtype: torch.dtype) -> Struct:
    return Struct(tuple(int(n) for n in shape), dtype)


@dataclasses.dataclass
class StepBundle:
    """One (arch, train shape): ``step_fn(model, optimizer, batch) ->
    metrics``, ``init_model(seed, device)`` (a seeded model whose
    parameters require grad), ``make_optimizer(model)`` (the reference's
    optimizer over ``optim.grad.trainable(model)``) and the batch's
    tensors by name (``batch_structs``)."""
    arch: str
    shape: str
    kind: str                       # "train"
    step_fn: Callable[..., Dict[str, torch.Tensor]]
    init_model: Callable[[int, Any], nn.Module]
    make_optimizer: Callable[[nn.Module], torch.optim.Optimizer]
    batch_structs: Dict[str, Struct]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ArchDef:
    arch_id: str
    family: str                     # "lm" | "gnn" | "recsys"
    shapes: Tuple[str, ...]
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    build_bundle: Callable[..., StepBundle]   # (config, shape) -> bundle
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


_REGISTRY: Dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.arch_id] = arch
    return arch


def get(arch_id: str) -> ArchDef:
    import repro_torch.configs  # noqa: F401  (populate the registry)
    return _REGISTRY[arch_id]


def list_archs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def train_only(arch_id: str, shape: str, kind: str) -> None:
    """Refuse a serve shape: only train shapes are bundled."""
    if kind != "train":
        raise NotImplementedError(
            f"{arch_id} {shape}: a serve shape; its step is the model's "
            f"own forward (only train shapes are bundled)")


def seeded(device, seed: int) -> torch.Generator:
    """A generator on ``device`` (default cuda) seeded with ``seed``."""
    from repro_torch import device as _device
    return torch.Generator(device=_device.resolve(device)).manual_seed(seed)


def adamw_constant(lr: float = 1e-3) -> Callable[[nn.Module],
                                                 OPT.AdamW]:
    """The recsys and GIN optimizer: AdamW at a constant rate."""
    return lambda model: OPT.AdamW(G.trainable(model), SCHED.constant(lr))


# ---------------------------------------------------------------------------
# generic train step (non-LM models)
# ---------------------------------------------------------------------------


def simple_train_step(loss_fn: G.LossFn):
    """``loss_fn(model, batch) -> (loss, metrics)`` as a step: gradients,
    clipped to a global norm of 1.0, one optimizer update.  Returns
    {"loss", "gnorm", **metrics}."""
    def train_step(model, opt, batch):
        (loss, metrics), grads = G.value_and_grad(loss_fn, model, batch)
        grads, gnorm = G.clip_by_global_norm(grads, 1.0)
        opt.step(grads=grads)
        out = {"loss": loss, "gnorm": gnorm}
        out.update(metrics)
        return out
    return train_step


# ---------------------------------------------------------------------------
# LM bundles (shared by the five transformer archs)
# ---------------------------------------------------------------------------

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

LM_SHAPE_PARAMS = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="serve", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="serve", seq_len=524288, global_batch=1),
}

LM_SKIPS = {
    "long_500k": ("pure full-attention arch: rule-mandated skip for "
                  "seq 524288 (sub-quadratic-only shape)"),
}

# reduced shapes for harness debugging (--smoke); batch >= 32 so both
# production meshes shard the batch dim
LM_SMOKE_SHAPE_PARAMS = {
    "train_4k": dict(kind="train", seq_len=128, global_batch=64),
    "prefill_32k": dict(kind="serve", seq_len=128, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=256, global_batch=64),
    "long_500k": dict(kind="serve", seq_len=512, global_batch=32),
}


def make_lm_optimizer(name: str, params) -> OPT._Optimizer:
    """The LMs' optimizer (``:117``): warmup_cosine(3e-4, 2000, 200,000);
    Adafactor, or AdamW with weight decay 0.1."""
    lr = SCHED.warmup_cosine(3e-4, 2000, 200_000)
    if name == "adafactor":
        return OPT.Adafactor(params, lr)
    return OPT.AdamW(params, lr, weight_decay=0.1)


def lm_bundle(cfg: TF.LMConfig, arch_id: str, shape: str, *,
              optimizer: str = "adamw", smoke: bool = False,
              microbatches: int = 1,
              shape_overrides: Optional[dict] = None) -> StepBundle:
    """The LM train bundle (``:124-230``): batches of ``tokens`` and
    ``labels`` (B, S) int32, ``LM.loss_fn``; with ``microbatches`` > 1
    the batch is split along B and the gradients accumulated, each
    microbatch's gradient / mb added in the accumulator's dtype (float32
    for AdamW, the parameters' dtype for Adafactor), and the loss the
    microbatches' mean."""
    sp = dict(LM_SMOKE_SHAPE_PARAMS[shape] if smoke
              else LM_SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    seq, batch = sp["seq_len"], sp["global_batch"]
    train_only(arch_id, shape, sp["kind"])
    mb = int(sp.get("microbatches", microbatches))
    if batch % max(mb, 1):
        raise ValueError(f"batch {batch} does not split into {mb} "
                         f"microbatches")

    def lf(model, d):
        return model.loss_fn(d["tokens"], d["labels"])

    def train_step(model, opt, data):
        if mb > 1:
            acc_dt = torch.float32 if optimizer == "adamw" \
                else cfg.param_dtype
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in G.trainable(model)]
            loss = torch.zeros((), device=data["tokens"].device)
            for i in range(mb):
                d = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                     for k, v in data.items()}
                (li, _), g = G.value_and_grad(lf, model, d)
                grads = [a + (b / mb).to(a.dtype) for a, b in zip(grads, g)]
                loss = loss + li / mb
        else:
            (loss, _), grads = G.value_and_grad(lf, model, data)
        grads, gnorm = G.clip_by_global_norm(grads, 1.0)
        opt.step(grads=grads)
        return {"loss": loss, "gnorm": gnorm}

    return StepBundle(
        arch=arch_id, shape=shape, kind="train", step_fn=train_step,
        init_model=lambda seed, device=None: TF.init_params(
            cfg, seed, device).requires_grad_(True),
        make_optimizer=lambda model: make_lm_optimizer(
            optimizer, G.trainable(model)),
        batch_structs={"tokens": struct((batch, seq), torch.int32),
                       "labels": struct((batch, seq), torch.int32)},
        meta=dict(params=cfg.param_count(),
                  active_params=cfg.active_param_count(),
                  tokens=batch * seq, microbatches=mb,
                  model_flops=6.0 * cfg.active_param_count() * batch * seq))


def lm_archdef(arch_id: str, full_cfg: Callable[[], TF.LMConfig],
               smoke_cfg: Callable[[], TF.LMConfig], *,
               optimizer: str = "adamw", microbatches: int = 1,
               notes: str = "") -> ArchDef:
    def build(cfg, shape, *, smoke: bool = False,
              shape_overrides: Optional[dict] = None, **kw):
        return lm_bundle(cfg, arch_id, shape, optimizer=optimizer,
                         smoke=smoke,
                         microbatches=1 if smoke else microbatches,
                         shape_overrides=shape_overrides)

    return register(ArchDef(
        arch_id=arch_id, family="lm", shapes=LM_SHAPES,
        make_config=full_cfg, make_smoke_config=smoke_cfg,
        build_bundle=build, skip_shapes=dict(LM_SKIPS), notes=notes))
