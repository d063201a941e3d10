"""The architecture registry and the step bundles shared by every
architecture (``repro/configs/common.py``).

Every architecture file registers an ``ArchDef``; the launchers
(``launch/train.py``, ``launch/dryrun.py``) ask it for a ``StepBundle``
per (shape x mesh axes): the step function, the seeded model (and, to
train, its optimizer), the shapes and dtypes of the step's arguments,
the reference's specs for them (``in_specs`` / ``out_specs``, the
parameters' first), its donation hints and its roofline metadata
(``meta``: the analytic ``model_flops``, ``scan_trip_count``,
``params``, ``active_params``, ``tokens``).  ``init_model(seed,
device="meta")`` builds the model with no data, the counterpart of the
reference's ``ShapeDtypeStruct`` stand-ins: a 314 B parameter tree
stays abstract.

A train step is ``step_fn(model, optimizer, batch) -> metrics``: the
loss and its gradients (``optim.grad.value_and_grad``), the gradients
clipped to a global norm of 1.0, one optimizer update
(``simple_train_step``, and ``lm_bundle``'s microbatch accumulation).
A serve step is ``step_fn(model, *args)``, ``args`` as ``arg_structs``
(``make_args(seed, device)`` draws valid ones).  ``LM_SHAPES``,
``LM_SHAPE_PARAMS`` and ``LM_SMOKE_SHAPE_PARAMS`` are copies of
``:91-114``, the same keys and values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
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
    """One (arch, shape).  ``init_model(seed, device)``: a seeded model
    (on ``meta``: no data), whose parameters require grad to train.

    train: ``step_fn(model, optimizer, batch) -> metrics``,
    ``make_optimizer(model)`` (the reference's optimizer over
    ``optim.grad.trainable(model)``), the batch's tensors by name
    (``batch_structs``; ``arg_structs`` is ``(batch_structs,)``).

    serve: ``step_fn(model, *args)``, the args' structs (trees of
    ``Struct``) in ``arg_structs``, ``make_args(seed, device)`` a tuple
    of valid args (``None`` for an arg the caller supplies).

    ``in_specs`` is the reference's: the parameters' spec tree, (to
    train) the optimizer state's, then each argument's; ``out_specs``
    and ``donate_argnums`` likewise (an index counts the parameters as
    argument 0)."""
    arch: str
    shape: str
    kind: str                       # "train" | "serve"
    step_fn: Callable[..., Any]
    init_model: Callable[[int, Any], nn.Module]
    make_optimizer: Optional[Callable[[nn.Module],
                                      torch.optim.Optimizer]] = None
    batch_structs: Dict[str, Struct] = dataclasses.field(
        default_factory=dict)
    arg_structs: Tuple[Any, ...] = ()
    in_specs: Tuple[Any, ...] = ()
    out_specs: Any = None
    donate_argnums: Tuple[int, ...] = ()
    make_args: Optional[Callable[[int, Any], Tuple[Any, ...]]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind == "train" and not self.arg_structs:
            self.arg_structs = (self.batch_structs,)


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


#: P() for every leaf of a tree (``sharding.replicate_specs``)
replicate_specs = SH.replicate_specs


def lm_param_structs(model: nn.Module) -> Dict[str, Any]:
    """An LM's parameter shapes as a tree of ``Struct`` in the reference's
    layout: ``layers`` stacked, each leaf with the leading layer count
    (``sharding.lm_opt_specs`` reads Adafactor's factoring from it)."""
    out: Dict[str, Any] = {}
    n_layers = len(model.layers)
    for name, p in model.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] == "layers":
            parts, shape = ["layers"] + parts[2:], (n_layers,) + shape
        node = out
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = struct(shape, p.dtype)
    return out


def seeded(device, seed: int):
    """A generator on ``device`` (default cuda) seeded with ``seed``; on
    ``meta`` a ``models.layers.MetaGenerator``, which draws nothing."""
    from repro_torch.models import layers as L
    return L.generator(_device.resolve(device), seed)


def adamw_constant(lr: float = 1e-3) -> Callable[[nn.Module],
                                                 OPT.AdamW]:
    """The recsys and GIN optimizer: AdamW at a constant rate."""
    return lambda model: OPT.AdamW(G.trainable(model), SCHED.constant(lr))


def field_ids(shape, vocabs, gen, device) -> torch.Tensor:
    """Int32 ids of ``shape``, uniform in [0, vocabs) for one size, or
    field f's (the last dim) in [0, vocabs[f]); empty on ``meta``."""
    dev = _device.resolve(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=dev)
    if isinstance(vocabs, int):
        return torch.randint(0, vocabs, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    hi = torch.tensor(vocabs, dtype=torch.float64, device=dev)
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
    return (u * hi).long().clamp_max(hi.long() - 1).to(torch.int32)


def normal(shape, gen, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal of ``shape``; empty on ``meta``."""
    dev = _device.resolve(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def synth_args(structs: Dict[str, Struct], bounds: Dict[str, Any], seed: int,
               device=None) -> Tuple[Dict[str, torch.Tensor]]:
    """A valid train batch of ``structs`` on ``device`` (empty tensors on
    ``meta``): integers uniform below ``bounds[name]`` (one size, or one
    a field), booleans all True, floats standard normal.  ``make_args``
    of the train bundles: ``(batch,)``."""
    dev = _device.resolve(device)
    gen = seeded(dev, seed)
    out = {}
    for name, st in structs.items():
        if st.dtype == torch.bool:
            out[name] = torch.ones(st.shape, dtype=torch.bool, device=dev)
        elif st.dtype.is_floating_point:
            out[name] = normal(st.shape, gen, dev, st.dtype)
        else:
            out[name] = field_ids(st.shape, bounds[name], gen, dev).to(
                st.dtype)
    return (out,)


def serve_batch_spec(b: int, axes: SH.Axes, ndim: int) -> P:
    """A ranking model's serve batch: over every mesh axis (pure
    data-parallel inference: the idle model axis takes batch shards
    too) when b % 256 == 0, else over the data axes only (the
    reference's rule: 10^6 rows do not split 256 / 512 ways)."""
    flat = axes.data + (axes.model,)
    return P(flat if b % 256 == 0 else axes.dp, *(None,) * (ndim - 1))


def serve(fn):
    """A serve step: ``fn`` with autograd off."""
    def step(*args):
        with torch.no_grad():
            return fn(*args)
    return step


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
                  "seq 524288 (sub-quadratic-only shape); KV cache is "
                  "sequence-shardable so the cell lowers, but it is "
                  "excluded from the graded table per the brief"),
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


def lm_bundle(cfg: TF.LMConfig, arch_id: str, shape: str,
              axes: Optional[SH.Axes] = None, *, optimizer: str = "adamw",
              n_dp: int = 1, smoke: bool = False, microbatches: int = 1,
              shape_overrides: Optional[dict] = None) -> StepBundle:
    """The LM bundles (``:124-274``).

    train: batches of ``tokens`` and ``labels`` (B, S) int32,
    ``LM.loss_fn``; with ``microbatches`` > 1 the batch is split along B
    and the gradients accumulated, each microbatch's gradient / mb added
    in the accumulator's dtype (float32 for AdamW, the parameters' dtype
    for Adafactor), and the loss the microbatches' mean.

    serve: ``prefill_32k`` is ``LM.prefill`` of (B, S) tokens into a
    cache of S; ``decode_32k`` / ``long_500k`` are one ``LM.decode_step``
    over a cache of S (``make_args``: the cache zeroed, every row filled
    to S - 1, so the step attends to all S).  An MoE LM routes its train
    and prefill tokens in ``n_dp`` groups, one a data shard, and a
    decode step in one (the reference's rule).  The reference's
    ``act_spec`` / ``moe_group_axes`` / ``moe_tp_axis`` are lowering
    knobs with no counterpart."""
    axes = axes or SH.Axes()
    sp = dict(LM_SMOKE_SHAPE_PARAMS[shape] if smoke
              else LM_SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    seq, batch = sp["seq_len"], sp["global_batch"]
    kind = sp["kind"]
    is_decode = shape.startswith(("decode", "long"))
    if cfg.is_moe and not is_decode:
        cfg = dataclasses.replace(cfg, moe_groups=max(n_dp, 1))
    pspecs = SH.lm_param_specs(cfg, axes)
    n_params, n_active = cfg.param_count(), cfg.active_param_count()
    meta = dict(scan_trip_count=cfg.n_layers, params=n_params,
                active_params=n_active)

    if kind == "train":
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
                    grads = [a + (b / mb).to(a.dtype)
                             for a, b in zip(grads, g)]
                    loss = loss + li / mb
            else:
                (loss, _), grads = G.value_and_grad(lf, model, data)
            grads, gnorm = G.clip_by_global_norm(grads, 1.0)
            opt.step(grads=grads)
            return {"loss": loss, "gnorm": gnorm}

        def init_model(seed, device=None):
            return TF.init_params(cfg, seed, device).requires_grad_(True)

        opt_name = "adafactor" if optimizer == "adafactor" else "adamw"
        ospecs = SH.lm_opt_specs(
            opt_name, pspecs,
            lm_param_structs(TF.init_params(cfg, 0, "meta"))
            if opt_name == "adafactor" else None)
        return StepBundle(
            arch=arch_id, shape=shape, kind="train", step_fn=train_step,
            init_model=init_model,
            make_optimizer=lambda model: make_lm_optimizer(
                optimizer, G.trainable(model)),
            batch_structs={"tokens": struct((batch, seq), torch.int32),
                           "labels": struct((batch, seq), torch.int32)},
            in_specs=(pspecs, ospecs, SH.lm_batch_specs(axes)),
            out_specs=(pspecs, ospecs, None), donate_argnums=(0, 1),
            make_args=lambda seed, device=None: synth_args(
                {"tokens": struct((batch, seq), torch.int32),
                 "labels": struct((batch, seq), torch.int32)},
                {"tokens": cfg.vocab, "labels": cfg.vocab}, seed, device),
            meta=dict(meta, tokens=batch * seq, microbatches=mb,
                      model_flops=6.0 * n_active * batch * seq))

    def init_model(seed, device=None):
        return TF.init_params(cfg, seed, device)

    if is_decode:
        names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
        widths = ((cfg.kv_lora_rank,), (cfg.d_rope,)) \
            if cfg.attn_kind == "mla" else ((cfg.n_kv_heads, cfg.d_head),) * 2
        cache_structs = {
            n: struct((cfg.n_layers, batch) + (
                (seq,) + w if cfg.attn_kind == "mla" else (w[0], seq, w[1])),
                cfg.dtype) for n, w in zip(names, widths)}
        cspecs = SH.lm_cache_specs(cfg, axes, shard_batch=batch % n_dp == 0)

        def make_args(seed, device=None):
            dev = _device.resolve(device)
            cache = {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                     for n, s in cache_structs.items()}
            return (cache, field_ids((batch,), cfg.vocab,
                                     seeded(dev, seed), dev),
                    torch.full((batch,), seq - 1, dtype=torch.int32,
                               device=dev))

        batch_spec = P(axes.dp) if batch >= 16 else P()
        return StepBundle(
            arch=arch_id, shape=shape, kind="serve",
            step_fn=serve(lambda model, cache, tokens, cache_len:
                          model.decode_step(cache, tokens, cache_len)),
            init_model=init_model,
            arg_structs=(cache_structs, struct((batch,), torch.int32),
                         struct((batch,), torch.int32)),
            in_specs=(pspecs, cspecs, batch_spec, batch_spec),
            out_specs=(None, cspecs), donate_argnums=(1,),
            make_args=make_args,
            meta=dict(meta, model_flops=2.0 * n_active * batch,
                      tokens=batch))

    # prefill
    def make_args(seed, device=None):
        dev = _device.resolve(device)
        return (field_ids((batch, seq), cfg.vocab, seeded(dev, seed),
                          dev),)

    return StepBundle(
        arch=arch_id, shape=shape, kind="serve",
        step_fn=serve(lambda model, tokens: model.prefill(tokens, seq)),
        init_model=init_model,
        arg_structs=(struct((batch, seq), torch.int32),),
        in_specs=(pspecs, SH.lm_batch_specs(axes)["tokens"]),
        out_specs=(None, SH.lm_cache_specs(cfg, axes), None),
        make_args=make_args,
        meta=dict(meta, model_flops=2.0 * n_active * batch * seq,
                  tokens=batch * seq))


def lm_archdef(arch_id: str, full_cfg: Callable[[], TF.LMConfig],
               smoke_cfg: Callable[[], TF.LMConfig], *,
               optimizer: str = "adamw", microbatches: int = 1,
               notes: str = "") -> ArchDef:
    def build(cfg, shape, axes=None, *, n_dp: int = 1, smoke: bool = False,
              shape_overrides: Optional[dict] = None, **kw):
        return lm_bundle(cfg, arch_id, shape, axes, optimizer=optimizer,
                         n_dp=n_dp, smoke=smoke,
                         microbatches=1 if smoke else microbatches,
                         shape_overrides=shape_overrides)

    return register(ArchDef(
        arch_id=arch_id, family="lm", shapes=LM_SHAPES,
        make_config=full_cfg, make_smoke_config=smoke_cfg,
        build_bundle=build, skip_shapes=dict(LM_SKIPS), notes=notes))
