"""gin-tu [arXiv:1810.00826]: GIN, 5 layers, d_hidden 64, sum
aggregation, learnable eps; the configuration and its shapes (copies of
``repro/configs/gin_tu.py``: the same fields, values and shapes).

Four regimes, one per shape:
  full_graph_sm  Cora-scale full batch (2,708 nodes, 10,556 edges,
                 d 1,433)
  minibatch_lg   Reddit-scale sampled subgraphs: 1,024 per-seed trees of
                 1 + 15 + 150 nodes and 165 edges (fanout 15-10), d 602
  ogb_products   full batch, large (2,449,029 nodes, 61,859,140 edges,
                 d 100)
  molecule       128 small graphs of 30 nodes / 64 edges, d 16
Every shape is ``kind="train"``.  d_in and n_classes are set per shape
(``dataclasses.replace``).  ``build_bundle`` is the reference's
(``:79-178``): ``models.gnn.node_loss`` on the full-batch shapes,
``tree_loss`` on ``minibatch_lg``'s trees, ``graph_loss`` on
``molecule``'s graphs, AdamW at a constant 1e-3; the parameters and
the optimizer state replicated, the full-batch shapes' edges split over
every mesh axis (node states replicated), the other shapes' batches
over the data axes; registered as ``gin-tu``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.models import gnn

SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7, pad_edges_to=512),
    "minibatch_lg": dict(kind="train", batch_nodes=1024, fanouts=(15, 10),
                         d_feat=602, n_classes=41,
                         tree_nodes=166, tree_edges=165),
    "ogb_products": dict(kind="train", n_nodes=2_449_029,
                         n_edges=61_859_140, d_feat=100, n_classes=47,
                         pad_edges_to=512),
    "molecule": dict(kind="train", batch=128, n_nodes=30, n_edges=64,
                     d_feat=16, n_classes=2),
}

SMOKE_SHAPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(kind="train", n_nodes=512, n_edges=2048,
                          d_feat=32, n_classes=7, pad_edges_to=512),
    "minibatch_lg": dict(kind="train", batch_nodes=64, fanouts=(3, 2),
                         d_feat=32, n_classes=8, tree_nodes=10,
                         tree_edges=9),
    "ogb_products": dict(kind="train", n_nodes=4096, n_edges=16384,
                         d_feat=32, n_classes=16, pad_edges_to=512),
    "molecule": dict(kind="train", batch=32, n_nodes=10, n_edges=16,
                     d_feat=8, n_classes=2),
}


def full_config() -> gnn.GINConfig:
    return gnn.GINConfig(name="gin-tu", n_layers=5, d_hidden=64)


def smoke_config() -> gnn.GINConfig:
    return gnn.GINConfig(name="gin-tu-smoke", n_layers=3, d_hidden=16)


def pad_to(n: int, mult: int) -> int:
    """``n`` rounded up to a multiple of ``mult`` (the padded edge count
    of a full-batch shape, ``pad_edges_to``)."""
    return ((n + mult - 1) // mult) * mult


def shape_config(cfg: gnn.GINConfig, shape: str, smoke: bool = False,
                 shape_overrides=None) -> gnn.GINConfig:
    """``cfg`` with the shape's d_in and n_classes."""
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    return dataclasses.replace(cfg, d_in=sp["d_feat"],
                               n_classes=sp["n_classes"])


def init_model(cfg: gnn.GINConfig, seed: int = 0, device=None) -> gnn.GIN:
    """A seeded ``GIN`` on ``device`` (default cuda) whose parameters
    require grad (``cfg`` specialised by ``shape_config``)."""
    return gnn.GIN(cfg, gnn.init_params(cfg, common.seeded(device, seed))
                   ).requires_grad_(True)


def build_bundle(cfg: gnn.GINConfig, shape: str, axes: SH.Axes = None, *,
                 n_dp: int = 1, smoke: bool = False, shape_overrides=None,
                 **kw) -> common.StepBundle:
    """The train bundle of one of the four shapes."""
    axes = axes or SH.Axes()
    sp = dict(SMOKE_SHAPE_PARAMS[shape] if smoke else SHAPE_PARAMS[shape])
    sp.update(shape_overrides or {})
    cfg = shape_config(cfg, shape, smoke, shape_overrides)
    st, i32, f32, b8 = common.struct, torch.int32, torch.float32, torch.bool
    flat = axes.data + (axes.model,)
    d_h = cfg.d_hidden
    if shape in ("full_graph_sm", "ogb_products"):
        n, e = sp["n_nodes"], pad_to(sp["n_edges"], sp["pad_edges_to"])
        structs = {"x": st((n, sp["d_feat"]), f32),
                   "edge_src": st((e,), i32), "edge_dst": st((e,), i32),
                   "edge_mask": st((e,), b8), "labels": st((n,), i32),
                   "train_mask": st((n,), b8)}

        def loss_fn(model, b):
            return gnn.node_loss(model, b["x"], b["edge_src"],
                                 b["edge_dst"], b["labels"],
                                 b["train_mask"], b["edge_mask"])
        tokens = n
        bspecs = {"x": P(), "edge_src": P(flat), "edge_dst": P(flat),
                  "edge_mask": P(flat), "labels": P(), "train_mask": P()}
        # fwd ~ Σ_l 2·N·d_in·d_h + 2·N·d_h² + E·d_h; train ~ 3x fwd
        n_e = sp["n_edges"]
        fwd = (2 * n * sp["d_feat"] * d_h + 2 * n * d_h * d_h
               + (cfg.n_layers - 1) * (4 * n * d_h * d_h + n_e * d_h)
               + n_e * sp["d_feat"])
        bounds = {"edge_src": n, "edge_dst": n, "labels": cfg.n_classes}
    elif shape == "minibatch_lg":
        bsz, tn, te = sp["batch_nodes"], sp["tree_nodes"], sp["tree_edges"]
        structs = {"x": st((bsz, tn, sp["d_feat"]), f32),
                   "edge_src": st((bsz, te), i32),
                   "edge_dst": st((bsz, te), i32),
                   "edge_mask": st((bsz, te), b8),
                   "labels": st((bsz,), i32)}

        def loss_fn(model, b):
            return gnn.tree_loss(model, b["x"], b["edge_src"],
                                 b["edge_dst"], b["edge_mask"], b["labels"])
        tokens = bsz
        bspecs = {k: P(axes.dp) for k in structs}
        fwd = bsz * (2 * tn * sp["d_feat"] * d_h
                     + cfg.n_layers * (4 * tn * d_h * d_h + te * d_h))
        bounds = {"edge_src": tn, "edge_dst": tn, "labels": cfg.n_classes}
    else:  # molecule
        bsz, n, e = sp["batch"], sp["n_nodes"], sp["n_edges"]
        structs = {"x": st((bsz, n, sp["d_feat"]), f32),
                   "edge_src": st((bsz, e), i32),
                   "edge_dst": st((bsz, e), i32),
                   "node_mask": st((bsz, n), b8),
                   "edge_mask": st((bsz, e), b8),
                   "labels": st((bsz,), i32)}

        def loss_fn(model, b):
            return gnn.graph_loss(model, b["x"], b["edge_src"],
                                  b["edge_dst"], b["node_mask"],
                                  b["labels"], b["edge_mask"])
        tokens = bsz
        bspecs = {k: P(axes.dp) for k in structs}
        fwd = bsz * (2 * n * sp["d_feat"] * d_h
                     + cfg.n_layers * (4 * n * d_h * d_h + e * d_h))
        bounds = {"edge_src": n, "edge_dst": n, "labels": cfg.n_classes}
    # GIN's parameters are tiny: replicated, and so is their state
    pspecs = SH.gin_param_specs(gnn.init_params(cfg, common.seeded(
        "meta", 0)))
    ospecs = common.replicate_specs(SH.lm_opt_specs("adamw", pspecs))
    return common.StepBundle(
        arch="gin-tu", shape=shape, kind="train",
        step_fn=common.simple_train_step(loss_fn),
        init_model=lambda seed, device=None: init_model(cfg, seed, device),
        make_optimizer=common.adamw_constant(1e-3), batch_structs=structs,
        in_specs=(pspecs, ospecs, bspecs), out_specs=(pspecs, ospecs, None),
        donate_argnums=(0, 1),
        make_args=lambda seed, device=None: common.synth_args(
            structs, bounds, seed, device),
        meta=dict(model_flops=3.0 * fwd, scan_trip_count=1,
                  params=cfg.param_count(), tokens=tokens))


ARCH = common.register(common.ArchDef(
    arch_id="gin-tu", family="gnn", shapes=tuple(SHAPE_PARAMS),
    make_config=full_config, make_smoke_config=smoke_config,
    build_bundle=build_bundle,
    notes="segment-sum message passing; TopLoc does not apply"))
