"""bst, the Behaviour Sequence Transformer [arXiv:1905.06874]: the
configuration and its shapes (copies of ``repro/configs/bst.py``: the
same fields, values and shapes).

embed_dim 32, behaviour sequence of 20 plus the target item, 1
transformer block of 8 heads (d_head 4, through the flash attention
kernel on the card), MLP 1024-512-256; item vocabulary 5 M and 8 profile
features x 100 k.  A ranking model: TopLoc does not apply.  The serve
step is ``models.recsys.BST`` itself.  ``build_bundle`` is the
reference's train branch (``:57-90``): ``train_batch`` of history,
target, other and ``labels``, ``models.recsys.bce_loss``, AdamW at a
constant 1e-3; registered as ``bst`` (the block's attention forward
through row 8, its backward the plain VJP).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
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


def init_model(cfg: R.BSTConfig, seed: int = 0, device=None) -> R.BST:
    """A seeded ``BST`` on ``device`` (default cuda) whose parameters
    require grad."""
    gen = common.seeded(device, seed)
    return R.BST(cfg, R.bst_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.BSTConfig, shape: str, *, smoke: bool = False,
                 shape_overrides=None, **kw) -> common.StepBundle:
    """The train bundle of ``train_batch`` (serve shapes are refused)."""
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    common.train_only("bst", shape, sp["kind"])
    b, i32 = sp["batch"], torch.int32
    return common.StepBundle(
        arch="bst", shape=shape, kind="train",
        step_fn=common.simple_train_step(
            lambda model, batch: R.bce_loss(model(batch["history"], batch["target"],
                                                  batch["other"]),
                                            batch["labels"])),
        init_model=lambda seed, device=None: init_model(cfg, seed, device),
        make_optimizer=common.adamw_constant(1e-3),
        batch_structs={"history": common.struct((b, cfg.seq_len), i32),
                       "target": common.struct((b,), i32),
                       "other": common.struct((b, cfg.n_other), i32),
                       "labels": common.struct((b,), torch.float32)},
        meta=dict(params=cfg.param_count(), tokens=b))


ARCH = common.register(common.ArchDef(
    arch_id="bst", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
