"""GIN (Graph Isomorphism Network, arXiv:1810.00826): the forward.

Port of ``repro/models/gnn.py:32-120`` (inference): sum aggregation over
the incoming edges, a learnable ε per layer, a 2-layer MLP update with
LayerNorm, and a linear head per layer whose logits are summed (node
classification), or applied to each layer's sum-pooled nodes (graph
classification, the jumping-knowledge readout).  ``node_loss``,
``graph_loss`` (``:122``, ``:135``) and ``tree_loss`` (``minibatch_lg``'s,
``repro/configs/gin_tu.py:132-145``) are the training losses.

The reference aggregates with ``jax.ops.segment_sum`` (XLA, no Pallas
kernel), so the port aggregates in plain torch.  It sums without float
atomics: the edges are ordered by destination once a forward (a stable
sort, so each node's messages keep their edge order, as the reference's
serial scatter adds them on the CPU) and each node's messages are summed
by one segment reduction, so two runs give the same bits.  The messages
of a layer are gathered whole (E x d floats: 24.7 GB at ogb_products'
first layer).

``forward_graph`` runs a batch of padded graphs as one disjoint graph
(node ids offset by graph) where the reference ``vmap``s one graph at a
time; ``forward_trees`` does the same for ``minibatch_lg``'s sampled
trees and reads each tree's root.  Host (numpy) inputs are checked and
moved to the model's device; tensors are the caller's contract.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 1433
    n_classes: int = 7
    task: str = "node"            # "node" | "graph"
    eps_learnable: bool = True
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        per = 2 * self.d_hidden * self.d_hidden + 2 * self.d_hidden + 1
        first = (self.d_in * self.d_hidden + self.d_hidden * self.d_hidden
                 + 2 * self.d_hidden + 1)
        head = self.n_layers * self.d_hidden * self.n_classes
        return first + (self.n_layers - 1) * per + head


def _gin_mlp_init(gen: torch.Generator, d_in: int, d_out: int,
                  dtype) -> Params:
    dev = gen.device
    return {"w1": L.dense_init(gen, d_in, d_out, dtype),
            "b1": torch.zeros((d_out,), dtype=dtype, device=dev),
            "w2": L.dense_init(gen, d_out, d_out, dtype),
            "b2": torch.zeros((d_out,), dtype=dtype, device=dev),
            "norm": L.layernorm_init(d_out, dev, dtype)}


def init_params(cfg: GINConfig, gen: torch.Generator) -> Params:
    """The reference's ``init_params`` tree (``layers`` [{mlp, eps}],
    ``heads``) drawn from ``gen`` at its scales, on its device; every ε
    starts at 0, a float32 scalar."""
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": _gin_mlp_init(gen, d_in, cfg.d_hidden, cfg.dtype),
            "eps": torch.zeros((), dtype=torch.float32, device=gen.device),
        })
    heads = [L.dense_init(gen, cfg.d_hidden, cfg.n_classes, cfg.dtype)
             for _ in range(cfg.n_layers)]
    return {"layers": layers, "heads": heads}


class EdgeOrder(NamedTuple):
    """The edges in destination order, computed once a forward."""
    src: torch.Tensor               # (E,) int64 sources, by destination
    mask: Optional[torch.Tensor]    # (E,) bool in that order, or None
    lengths: torch.Tensor           # (N,) int64 edges into each node


def edge_order(edge_src: torch.Tensor, edge_dst: torch.Tensor,
               n_nodes: int, edge_mask: Optional[torch.Tensor] = None
               ) -> EdgeOrder:
    """Sort the edges by destination, stably (each node's edges keep
    their order); integer work only, no host sync.  On ``meta`` (the
    dry-run's trace: ``bincount`` has no meta kernel) the counts are an
    empty (N,) tensor, the shape ``bincount`` gives for ids < N."""
    dst = edge_dst.long()
    order = torch.sort(dst, stable=True).indices
    lengths = (torch.empty(n_nodes, dtype=torch.int64, device=dst.device)
               if dst.device.type == "meta"
               else torch.bincount(dst, minlength=n_nodes))
    return EdgeOrder(edge_src.long()[order],
                     None if edge_mask is None else edge_mask[order],
                     lengths)


def aggregate(h: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, n_nodes: int,
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum aggregation: out[i] = Σ_{(j→i)∈E} h[j], a masked edge's
    message times 0 (``aggregate_ordered`` over ``edge_order``)."""
    return aggregate_ordered(h, edge_order(edge_src, edge_dst, n_nodes,
                                           edge_mask))


def aggregate_ordered(h: torch.Tensor, order: EdgeOrder) -> torch.Tensor:
    """``aggregate`` over edges already in destination order: each
    node's messages summed in edge order by one segment reduction
    (``torch.segment_reduce``: a loop a segment, no atomics)."""
    msg = h[order.src]                                       # (E, d)
    if order.mask is not None:
        msg.mul_(order.mask[:, None].to(msg.dtype))
    return torch.segment_reduce(msg, "sum", lengths=order.lengths, axis=0,
                                unsafe=True)


class GINMLP(nn.Module):
    """relu(LayerNorm(relu(x w1 + b1) w2 + b2))."""

    def __init__(self, params: Params):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, L.frozen(params[name]))
        self.norm = L.LayerNorm(params["norm"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        return torch.relu(self.norm(h @ self.w2 + self.b2))


def _check_edges(name: str, e: np.ndarray, n: int) -> None:
    e = np.asarray(e)
    if not np.issubdtype(e.dtype, np.integer):
        raise ValueError(f"{name}: integer node ids required, got {e.dtype}")
    if e.size and (e.min() < 0 or e.max() >= n):
        raise ValueError(f"{name}: node ids must lie in [0, {n}), got "
                         f"[{e.min()}, {e.max()}]")


class GIN(nn.Module):
    """``forward_node`` / ``forward_graph`` of the reference over one set
    of parameters (``init_params`` or ``convert.gin_params_from_numpy``);
    ``cfg.d_in`` and ``cfg.n_classes`` are the shape's."""

    def __init__(self, cfg: GINConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.mlps = nn.ModuleList(GINMLP(lp["mlp"])
                                  for lp in params["layers"])
        self.eps = nn.ParameterList(L.frozen(lp["eps"])
                                    for lp in params["layers"])
        self.heads = nn.ParameterList(L.frozen(w) for w in params["heads"])

    @property
    def device(self) -> torch.device:
        return self.heads[0].device

    def _inputs(self, x, n: int, edges, masks):
        """x as the model's dtype and the edge arrays on its device, host
        node ids checked against ``n`` nodes."""
        dev = self.device
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
        out = []
        for name, e in edges:
            if isinstance(e, np.ndarray):
                _check_edges(name, e, n)
                e = torch.from_numpy(e.astype(np.int64)).to(dev)
            out.append(e)
        for m in masks:
            if isinstance(m, np.ndarray):
                m = torch.from_numpy(m.astype(bool)).to(dev)
            out.append(m)
        _device.require(dev, x, *out)
        return (x.to(self.cfg.dtype), *out)

    def _layers(self, h: torch.Tensor, order: EdgeOrder):
        """Each layer's node states h, in turn."""
        for mlp, eps in zip(self.mlps, self.eps):
            h = mlp((1.0 + eps) * h + aggregate_ordered(h, order))
            yield h

    def forward_node(self, x, edge_src, edge_dst, edge_mask=None
                     ) -> torch.Tensor:
        """Node classification logits (N, n_classes) float32: x (N,
        d_in), edges (E,) each, edge_mask (E,) bool or None."""
        n = x.shape[0]
        x, src, dst, *mask = self._inputs(
            x, n, (("edge_src", edge_src), ("edge_dst", edge_dst)),
            () if edge_mask is None else (edge_mask,))
        order = edge_order(src, dst, n, mask[0] if mask else None)
        logits = torch.zeros((n, self.cfg.n_classes), dtype=torch.float32,
                             device=x.device)
        for h, head in zip(self._layers(x, order), self.heads):
            logits = logits + (h @ head).float()
        return logits

    def forward_graph(self, x, edge_src, edge_dst, node_mask,
                      edge_mask=None) -> torch.Tensor:
        """Graph classification logits (G, n_classes) float32 of G padded
        graphs: x (G, N, d_in), edges (G, E) local ids, node_mask (G, N),
        edge_mask (G, E) or None; one graph (no leading G) gives
        (n_classes,).  Each layer's nodes are sum-pooled per graph under
        node_mask."""
        if x.ndim == 2:
            return self.forward_graph(
                x[None], edge_src[None], edge_dst[None], node_mask[None],
                None if edge_mask is None else edge_mask[None])[0]
        g, n = x.shape[:2]
        x, src, dst, node_mask, *mask = self._inputs(
            x, n, (("edge_src", edge_src), ("edge_dst", edge_dst)),
            (node_mask,) + (() if edge_mask is None else (edge_mask,)))
        base = (torch.arange(g, device=x.device) * n)[:, None]
        order = edge_order((src + base).reshape(-1), (dst + base).reshape(-1),
                           g * n, mask[0].reshape(-1) if mask else None)
        keep = node_mask.reshape(g * n, 1)
        logits = torch.zeros((g, self.cfg.n_classes), dtype=torch.float32,
                             device=x.device)
        for h, head in zip(self._layers(x.reshape(g * n, -1), order),
                           self.heads):
            pooled = (h * keep.to(h.dtype)).reshape(g, n, -1).sum(1)
            logits = logits + (pooled @ head).float()
        return logits

    def forward_trees(self, x, edge_src, edge_dst, edge_mask=None
                      ) -> torch.Tensor:
        """``minibatch_lg``: (B, n_classes) float32, the root's (node 0's)
        ``forward_node`` logits of each of B padded sampled trees, x (B,
        Tn, d_in), edges (B, Te) local ids (``NeighborSampler.
        sample_trees``), run as one disjoint graph."""
        b, n = x.shape[:2]
        x, src, dst, *mask = self._inputs(
            x, n, (("edge_src", edge_src), ("edge_dst", edge_dst)),
            () if edge_mask is None else (edge_mask,))
        base = (torch.arange(b, device=x.device) * n)[:, None]
        logits = self.forward_node(
            x.reshape(b * n, -1), (src + base).reshape(-1),
            (dst + base).reshape(-1), mask[0].reshape(-1) if mask else None)
        return logits.reshape(b, n, -1)[:, 0]


def _xent(logits: torch.Tensor, labels) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Per-row cross-entropy and correctness of ``labels`` (numpy or a
    tensor) against logits (R, C)."""
    if isinstance(labels, np.ndarray):
        labels = torch.from_numpy(labels.astype(np.int64))
    labels = labels.to(logits.device)
    return (L.softmax_xent(logits, labels),
            (logits.argmax(-1) == labels).float())


def node_loss(model: GIN, x, edge_src, edge_dst, labels, train_mask,
              edge_mask=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Node classification (``repro/models/gnn.py:122``): the mean
    cross-entropy and accuracy over the nodes of ``train_mask``."""
    logits = model.forward_node(x, edge_src, edge_dst, edge_mask)
    nll, hit = _xent(logits, labels)
    if isinstance(train_mask, np.ndarray):
        train_mask = torch.from_numpy(train_mask.astype(bool))
    m = train_mask.to(logits.device).float()
    cnt = m.sum().clamp_min(1.0)
    return (nll * m).sum() / cnt, {"acc": (hit * m).sum() / cnt}


def graph_loss(model: GIN, x, edge_src, edge_dst, node_mask, labels,
               edge_mask=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Graph classification of a batch of padded graphs (``:135``): the
    mean cross-entropy and accuracy of ``forward_graph``'s logits."""
    nll, hit = _xent(model.forward_graph(x, edge_src, edge_dst, node_mask,
                                         edge_mask), labels)
    return nll.mean(), {"acc": hit.mean()}


def tree_loss(model: GIN, x, edge_src, edge_dst, edge_mask, labels
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``minibatch_lg``'s loss (``repro/configs/gin_tu.py:132-145``): the
    mean cross-entropy and accuracy of each sampled tree's root logits
    (``forward_trees``)."""
    nll, hit = _xent(model.forward_trees(x, edge_src, edge_dst, edge_mask),
                     labels)
    return nll.mean(), {"acc": hit.mean()}
