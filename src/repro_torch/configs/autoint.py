"""autoint [arXiv:1810.11921]: the configuration and its shapes (copies
of ``repro/configs/autoint.py``: the same fields, values and shapes).

39 sparse fields (embed 16), 3 self-attention layers (2 heads, d_attn
32) with residual projections.  A ranking model: TopLoc does not apply.
The serve step is ``models.recsys.AutoInt`` itself.
``build_bundle`` is the reference's train branch (``:60-85``):
``train_batch`` of sparse and ``labels``, ``models.recsys.bce_loss``,
AdamW at a constant 1e-3; registered as ``autoint``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
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


def init_model(cfg: R.AutoIntConfig, seed: int = 0, device=None) -> R.AutoInt:
    """A seeded ``AutoInt`` on ``device`` (default cuda) whose parameters
    require grad."""
    gen = common.seeded(device, seed)
    return R.AutoInt(cfg, R.autoint_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.AutoIntConfig, shape: str, *, smoke: bool = False,
                 shape_overrides=None, **kw) -> common.StepBundle:
    """The train bundle of ``train_batch`` (serve shapes are refused)."""
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    common.train_only("autoint", shape, sp["kind"])
    b, i32 = sp["batch"], torch.int32
    return common.StepBundle(
        arch="autoint", shape=shape, kind="train",
        step_fn=common.simple_train_step(
            lambda model, batch: R.bce_loss(model(batch["sparse"]),
                                            batch["labels"])),
        init_model=lambda seed, device=None: init_model(cfg, seed, device),
        make_optimizer=common.adamw_constant(1e-3),
        batch_structs={"sparse": common.struct((b, cfg.n_sparse), i32),
                       "labels": common.struct((b,), torch.float32)},
        meta=dict(params=cfg.param_count(), tokens=b))


ARCH = common.register(common.ArchDef(
    arch_id="autoint", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
