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
Every shape is ``kind="train"`` in the reference; the port runs the
forward (``models.gnn.GIN``), which training will differentiate.
d_in and n_classes are set per shape (``dataclasses.replace``).  No
``build_bundle``: that is TPU lowering.
"""
from __future__ import annotations

from typing import Any, Dict

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
