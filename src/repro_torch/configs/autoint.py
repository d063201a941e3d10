"""autoint [arXiv:1810.11921]: the configuration and its bundles (a port
of ``repro/configs/autoint.py``: the same fields, values and shapes).

39 sparse fields (embed 16), 3 self-attention layers (2 heads, d_attn
32) with residual projections.  A ranking model: TopLoc does not apply.

``build_bundle`` is the reference's (``:60-115``): ``train_batch`` of
sparse and ``labels``, ``models.recsys.bce_loss``, AdamW at a constant
1e-3; the serve shapes run ``models.recsys.AutoInt`` itself with every
parameter replicated and the batch over every mesh axis where it splits
256 ways.  Registered as ``autoint``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.models import recsys as R

VOCABS = (2 ** 22,) * 2 + (2 ** 18,) * 5 + (2 ** 14,) * 32

SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1_000_000),
}

SMOKE_SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=4096),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=8192),
    "retrieval_cand": dict(kind="serve", batch=65536),
}


def full_config() -> R.AutoIntConfig:
    return R.AutoIntConfig(vocab_sizes=VOCABS)


def smoke_config() -> R.AutoIntConfig:
    return R.AutoIntConfig(n_sparse=8, vocab_sizes=(64,) * 8,
                           embed_dim=8, d_attn=8)


def _flops_per_row(cfg: R.AutoIntConfig) -> float:
    f, d0 = cfg.n_sparse, cfg.embed_dim
    da, h = cfg.d_attn, cfg.n_heads
    flops, d_in = 0.0, d0
    for _ in range(cfg.n_attn_layers):
        d_out = da * h
        flops += 2.0 * f * d_in * d_out * 4          # q, k, v, residual
        flops += 2.0 * f * f * d_out * 2             # scores + weighted sum
        d_in = d_out
    return flops + 2.0 * f * d_in


def init_model(cfg: R.AutoIntConfig, seed: int = 0, device=None
               ) -> R.AutoInt:
    """A seeded ``AutoInt`` on ``device`` (default cuda; on ``meta``
    nothing is drawn) whose parameters require grad."""
    gen = common.seeded(device, seed)
    return R.AutoInt(cfg, R.autoint_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.AutoIntConfig, shape: str, axes: SH.Axes = None,
                 *, n_dp: int = 1, smoke: bool = False,
                 shape_overrides=None, **kw) -> common.StepBundle:
    axes = axes or SH.Axes()
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    b = sp["batch"]
    pspecs = SH.autoint_param_specs(cfg, axes)
    dp = axes.dp
    structs = {"sparse": common.struct((b, cfg.n_sparse), torch.int32),
               "labels": common.struct((b,), torch.float32)}
    meta = dict(model_flops=(3.0 if sp["kind"] == "train" else 1.0)
                * b * _flops_per_row(cfg),
                scan_trip_count=1, params=cfg.param_count(), tokens=b)
    if sp["kind"] == "train":
        ospecs = SH.lm_opt_specs("adamw", pspecs)
        return common.StepBundle(
            arch="autoint", shape=shape, kind="train",
            step_fn=common.simple_train_step(
                lambda model, batch: R.bce_loss(model(batch["sparse"]),
                                                batch["labels"])),
            init_model=lambda seed, device=None: init_model(cfg, seed,
                                                            device),
            make_optimizer=common.adamw_constant(1e-3),
            batch_structs=structs,
            in_specs=(pspecs, ospecs,
                      {"sparse": P(dp, None), "labels": P(dp)}),
            out_specs=(pspecs, ospecs, None), donate_argnums=(0, 1),
            meta=meta,
            make_args=lambda seed, device=None: common.synth_args(
                structs, {"sparse": cfg.vocab_sizes}, seed, device))

    if sp.get("replicate_params", True):
        pspecs = common.replicate_specs(pspecs)

    def make_args(seed, device=None):
        gen = common.seeded(device, seed)
        return (common.field_ids((b, cfg.n_sparse), cfg.vocab_sizes, gen,
                                 device),)

    return common.StepBundle(
        arch="autoint", shape=shape, kind="serve",
        step_fn=common.serve(lambda model, sparse: model(sparse)),
        init_model=lambda seed, device=None: init_model(
            cfg, seed, device).requires_grad_(False),
        arg_structs=(structs["sparse"],),
        in_specs=(pspecs, common.serve_batch_spec(b, axes, 2)),
        out_specs=None, make_args=make_args, meta=meta)


ARCH = common.register(common.ArchDef(
    arch_id="autoint", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
