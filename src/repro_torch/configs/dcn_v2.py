"""dcn-v2 [arXiv:2008.13535]: the configuration and its shapes (copies of
``repro/configs/dcn_v2.py``: the same fields, values and shapes).

13 dense + 26 sparse features (embed 16), 3 full-rank cross layers, deep
MLP 1024-1024-512; a Criteo-like skewed vocabulary (2 x 16.7 M + 2 x 2 M
+ 2 x 262 k + 20 x 65 k = 39.6 M rows, a 2.53 GB float32 table).  A
ranking model: it scores given candidate rows, TopLoc does not apply.
``retrieval_cand`` is the offline scoring of 10^6 candidate rows.  The
serve step is ``models.recsys.DCNv2`` itself.  ``build_bundle`` is the
reference's train branch (``:60-90``): ``train_batch`` of dense, sparse
and ``labels``, ``models.recsys.bce_loss``, AdamW at a constant 1e-3;
registered as ``dcn-v2``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import common
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


def init_model(cfg: R.DCNv2Config, seed: int = 0, device=None) -> R.DCNv2:
    """A seeded ``DCNv2`` on ``device`` (default cuda) whose parameters
    require grad."""
    gen = common.seeded(device, seed)
    return R.DCNv2(cfg, R.dcnv2_init(cfg, gen)).requires_grad_(True)


def build_bundle(cfg: R.DCNv2Config, shape: str, *, smoke: bool = False,
                 shape_overrides=None, **kw) -> common.StepBundle:
    """The train bundle of ``train_batch`` (serve shapes are refused)."""
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    common.train_only("dcn-v2", shape, sp["kind"])
    b, i32 = sp["batch"], torch.int32
    return common.StepBundle(
        arch="dcn-v2", shape=shape, kind="train",
        step_fn=common.simple_train_step(
            lambda model, batch: R.bce_loss(model(batch["dense"], batch["sparse"]),
                                            batch["labels"])),
        init_model=lambda seed, device=None: init_model(cfg, seed, device),
        make_optimizer=common.adamw_constant(1e-3),
        batch_structs={"dense": common.struct((b, cfg.n_dense), torch.float32),
                       "sparse": common.struct((b, cfg.n_sparse), i32),
                       "labels": common.struct((b,), torch.float32)},
        meta=dict(params=cfg.param_count(), tokens=b))


ARCH = common.register(common.ArchDef(
    arch_id="dcn-v2", family="recsys", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="ranking model; TopLoc does not apply"))
