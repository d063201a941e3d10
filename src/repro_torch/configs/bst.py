"""bst, the Behaviour Sequence Transformer [arXiv:1905.06874]: the
configuration and its bundles (a port of ``repro/configs/bst.py``: the
same fields, values and shapes).

embed_dim 32, behaviour sequence of 20 plus the target item, 1
transformer block of 8 heads (d_head 4, through the flash attention
kernel on the card), MLP 1024-512-256; item vocabulary 5 M and 8 profile
features x 100 k.  A ranking model: TopLoc does not apply.

``build_bundle`` is the reference's (``:57-123``): ``train_batch`` of
history, target, other and ``labels``, ``models.recsys.bce_loss``, AdamW
at a constant 1e-3 (the block's attention forward through row 8, its
backward the plain VJP); the serve shapes run ``models.recsys.BST``
itself with every parameter replicated and the batch over every mesh
axis where it splits 256 ways.  Registered as ``bst``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.models import recsys as R

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


def full_config() -> R.BSTConfig:
    return R.BSTConfig(item_vocab=5_000_000, other_vocab=100_000)


def smoke_config() -> R.BSTConfig:
    return R.BSTConfig(item_vocab=512, other_vocab=64, n_other=3,
                       mlp=(32, 16), seq_len=6)


def _flops_per_row(cfg: R.BSTConfig) -> float:
    e, s = cfg.embed_dim, cfg.seq_len + 1
    attn = cfg.n_blocks * (8.0 * s * e * e + 4.0 * s * s * e
                           + 4.0 * s * e * 4 * e)
    d_in = s * e + cfg.n_other * e
    deep, dims = 0.0, (d_in,) + cfg.mlp
    for a, b in zip(dims[:-1], dims[1:]):
        deep += 2.0 * a * b
    return attn + deep + 2.0 * cfg.mlp[-1]


def init_model(cfg: R.BSTConfig, seed: int = 0, device=None) -> R.BST:
    """A seeded ``BST`` on ``device`` (default cuda; on ``meta`` nothing is
    drawn) whose parameters require grad."""
    gen = common.seeded(device, seed)
    return R.BST(cfg, R.bst_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.BSTConfig, shape: str, axes: SH.Axes = None, *,
                 n_dp: int = 1, smoke: bool = False, shape_overrides=None,
                 **kw) -> common.StepBundle:
    axes = axes or SH.Axes()
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    b, i32 = sp["batch"], torch.int32
    pspecs = SH.bst_param_specs(cfg, axes)
    dp = axes.dp
    structs = {"history": common.struct((b, cfg.seq_len), i32),
               "target": common.struct((b,), i32),
               "other": common.struct((b, cfg.n_other), i32),
               "labels": common.struct((b,), torch.float32)}
    meta = dict(model_flops=(3.0 if sp["kind"] == "train" else 1.0)
                * b * _flops_per_row(cfg),
                scan_trip_count=1, params=cfg.param_count(), tokens=b)
    if sp["kind"] == "train":
        ospecs = SH.lm_opt_specs("adamw", pspecs)
        return common.StepBundle(
            arch="bst", shape=shape, kind="train",
            step_fn=common.simple_train_step(
                lambda model, batch: R.bce_loss(
                    model(batch["history"], batch["target"],
                          batch["other"]), batch["labels"])),
            init_model=lambda seed, device=None: init_model(cfg, seed,
                                                            device),
            make_optimizer=common.adamw_constant(1e-3),
            batch_structs=structs,
            in_specs=(pspecs, ospecs,
                      {"history": P(dp, None), "target": P(dp),
                       "other": P(dp, None), "labels": P(dp)}),
            out_specs=(pspecs, ospecs, None), donate_argnums=(0, 1),
            meta=meta,
            make_args=lambda seed, device=None: common.synth_args(
                structs, {"history": cfg.item_vocab,
                          "target": cfg.item_vocab,
                          "other": (cfg.other_vocab,) * cfg.n_other},
                seed, device))

    if sp.get("replicate_params", True):
        pspecs = common.replicate_specs(pspecs)

    def make_args(seed, device=None):
        gen = common.seeded(device, seed)
        return (common.field_ids((b, cfg.seq_len), cfg.item_vocab, gen,
                                 device),
                common.field_ids((b,), cfg.item_vocab, gen, device),
                common.field_ids((b, cfg.n_other), cfg.other_vocab, gen,
                                 device))

    return common.StepBundle(
        arch="bst", shape=shape, kind="serve",
        step_fn=common.serve(lambda model, history, target, other: model(
            history, target, other)),
        init_model=lambda seed, device=None: init_model(
            cfg, seed, device).requires_grad_(False),
        arg_structs=(structs["history"], structs["target"], structs["other"]),
        in_specs=(pspecs, common.serve_batch_spec(b, axes, 2),
                  common.serve_batch_spec(b, axes, 1),
                  common.serve_batch_spec(b, axes, 2)),
        out_specs=None, make_args=make_args, meta=meta)


ARCH = common.register(common.ArchDef(
    arch_id="bst", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
