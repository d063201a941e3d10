"""dcn-v2 [arXiv:2008.13535]: the configuration and its bundles (a port
of ``repro/configs/dcn_v2.py``: the same fields, values and shapes).

13 dense + 26 sparse features (embed 16), 3 full-rank cross layers, deep
MLP 1024-1024-512; a Criteo-like skewed vocabulary (2 x 16.7 M + 2 x 2 M
+ 2 x 262 k + 20 x 65 k = 39.6 M rows, a 2.53 GB float32 table).  A
ranking model: it scores given candidate rows, TopLoc does not apply.
``retrieval_cand`` is the offline scoring of 10^6 candidate rows.

``build_bundle`` is the reference's (``:60-123``): ``train_batch`` of
dense, sparse and ``labels``, ``models.recsys.bce_loss``, AdamW at a
constant 1e-3, the tables row-split and the MLP tensor-parallel; the
serve shapes run ``models.recsys.DCNv2`` itself with every parameter
replicated (pure data-parallel inference, no collective a request) and
the batch over every mesh axis where it splits 256 ways.  Registered as
``dcn-v2``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.models import recsys as R

VOCABS = (2 ** 24, 2 ** 24, 2 ** 21, 2 ** 21, 2 ** 18, 2 ** 18
          ) + (2 ** 16,) * 20

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


def full_config() -> R.DCNv2Config:
    return R.DCNv2Config(vocab_sizes=VOCABS)


def smoke_config() -> R.DCNv2Config:
    return R.DCNv2Config(vocab_sizes=(64,) * 26, mlp=(64, 32),
                         embed_dim=8)


def _flops_per_row(cfg: R.DCNv2Config) -> float:
    d = cfg.d_input
    cross = cfg.n_cross_layers * 2.0 * d * d
    deep, dims = 0.0, (d,) + cfg.mlp
    for a, b in zip(dims[:-1], dims[1:]):
        deep += 2.0 * a * b
    return cross + deep + 2.0 * (d + cfg.mlp[-1])


def init_model(cfg: R.DCNv2Config, seed: int = 0, device=None) -> R.DCNv2:
    """A seeded ``DCNv2`` on ``device`` (default cuda; on ``meta`` nothing
    is drawn) whose parameters require grad."""
    gen = common.seeded(device, seed)
    return R.DCNv2(cfg, R.dcnv2_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.DCNv2Config, shape: str, axes: SH.Axes = None, *,
                 n_dp: int = 1, smoke: bool = False, shape_overrides=None,
                 **kw) -> common.StepBundle:
    axes = axes or SH.Axes()
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    b, i32, f32 = sp["batch"], torch.int32, torch.float32
    pspecs = SH.dcnv2_param_specs(cfg, axes)
    dp = axes.dp
    structs = {"dense": common.struct((b, cfg.n_dense), f32),
               "sparse": common.struct((b, cfg.n_sparse), i32),
               "labels": common.struct((b,), f32)}
    meta = dict(model_flops=(3.0 if sp["kind"] == "train" else 1.0)
                * b * _flops_per_row(cfg),
                scan_trip_count=1, params=cfg.param_count(), tokens=b)
    if sp["kind"] == "train":
        return common.StepBundle(
            arch="dcn-v2", shape=shape, kind="train",
            step_fn=common.simple_train_step(
                lambda model, batch: R.bce_loss(
                    model(batch["dense"], batch["sparse"]),
                    batch["labels"])),
            init_model=lambda seed, device=None: init_model(
                cfg, seed, device),
            make_optimizer=common.adamw_constant(1e-3),
            batch_structs=structs,
            in_specs=(pspecs, SH.lm_opt_specs("adamw", pspecs),
                      {"dense": P(dp, None), "sparse": P(dp, None),
                       "labels": P(dp)}),
            out_specs=(pspecs, SH.lm_opt_specs("adamw", pspecs), None),
            donate_argnums=(0, 1), meta=meta,
            make_args=lambda seed, device=None: common.synth_args(
                structs, {"sparse": cfg.vocab_sizes}, seed, device))

    if sp.get("replicate_params", True):
        pspecs = common.replicate_specs(pspecs)

    def make_args(seed, device=None):
        gen = common.seeded(device, seed)
        return (common.normal((b, cfg.n_dense), gen, device),
                common.field_ids((b, cfg.n_sparse), cfg.vocab_sizes, gen,
                                 device))

    spec = common.serve_batch_spec(b, axes, 2)
    return common.StepBundle(
        arch="dcn-v2", shape=shape, kind="serve",
        step_fn=common.serve(lambda model, dense, sparse: model(dense,
                                                                sparse)),
        init_model=lambda seed, device=None: init_model(
            cfg, seed, device).requires_grad_(False),
        arg_structs=(structs["dense"], structs["sparse"]),
        in_specs=(pspecs, spec, spec), out_specs=None,
        make_args=make_args, meta=meta)


ARCH = common.register(common.ArchDef(
    arch_id="dcn-v2", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
