"""Carry the reference's state across: numpy arrays in, port tensors out.

The JAX package and the port share their index and session layouts
field for field, so a reference-built ``IVFIndex`` / ``IVFPQIndex`` /
``HNSWIndex`` / ``IVFSession`` / ``HNSWSession`` becomes the port's by
handing each field over as a numpy array (``np.asarray(field)``);
``to_numpy`` goes the other way.  The batched engine's state converts
the same way: its session slab through ``ivf_session_from_numpy`` or
``hnsw_session_from_numpy``, its result-cache slab through
``cache_entries_from_numpy``; a mutable corpus mid-mutation through
``segmented_index_from_numpy`` around its converted base.  The
bi-encoder's parameter tree converts leaf for leaf, its stacked layers
unstacked (``encoder_params_from_numpy``); so do the two-tower model's
(``two_tower_params_from_numpy``), the ranking models' (``dcnv2_`` /
``bst_`` / ``autoint_params_from_numpy``), GIN's
(``gin_params_from_numpy``) and the LM's (``lm_params_from_numpy``,
bfloat16 carried bit for bit).
Nothing here imports the reference: the arrays are the interface.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.hnsw import HNSWIndex
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.pq import IVFPQIndex, check_index
from repro_torch.core.segment import SegmentedIndex
from repro_torch.core.toploc import HNSWSession, IVFSession, index_tensor
from repro_torch.models.encoder import DualEncoder, EncoderConfig, Tower
from repro_torch.models.gnn import GIN, GINConfig
from repro_torch.models.recsys import (BST, AutoInt, AutoIntConfig,
                                       BSTConfig, DCNv2, DCNv2Config,
                                       TwoTower, TwoTowerConfig)
from repro_torch.models.transformer import LM, LMConfig
from repro_torch.serving.result_cache import CacheEntry


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.int32), device=dev)


def ivf_index_from_numpy(centroids, list_vecs, list_ids, list_sizes,
                         device=None) -> IVFIndex:
    """An ``IVFIndex`` on ``device`` (default cuda) from its four fields."""
    dev = _device.resolve(device)
    return IVFIndex(_f32(centroids, dev), _f32(list_vecs, dev),
                    _i32(list_ids, dev), _i32(list_sizes, dev))


def ivf_pq_index_from_numpy(centroids, codewords, list_codes, list_ids,
                            list_sizes, doc_vecs, device=None) -> IVFPQIndex:
    """An ``IVFPQIndex`` on ``device`` (default cuda) from its six fields;
    ``list_codes`` stays uint8; codes and ids are checked against the
    codebook and the corpus (``pq.check_index``)."""
    dev = _device.resolve(device)
    codes = torch.tensor(np.asarray(list_codes, np.uint8), device=dev)
    return check_index(IVFPQIndex(
        _f32(centroids, dev), _f32(codewords, dev), codes,
        _i32(list_ids, dev), _i32(list_sizes, dev), _f32(doc_vecs, dev)))


def ivf_session_from_numpy(cache_ids, cache_vecs, anchor_sel, refreshes,
                           turn, device=None) -> IVFSession:
    """An ``IVFSession`` on ``device`` (default cuda); batched sessions
    (a leading batch axis on every field) convert the same way."""
    dev = _device.resolve(device)
    return IVFSession(_i32(cache_ids, dev), _f32(cache_vecs, dev),
                      _i32(anchor_sel, dev), _i32(refreshes, dev),
                      _i32(turn, dev))


def hnsw_index_from_numpy(vectors, adj0, upper_adj, entry_point, node_level,
                          deleted=None, device=None) -> HNSWIndex:
    """An ``HNSWIndex`` on ``device`` (default cuda) from its fields (the
    reference's order; ``deleted`` None or (n,) bool)."""
    dev = _device.resolve(device)
    return HNSWIndex(
        _f32(vectors, dev), _i32(adj0, dev), _i32(upper_adj, dev),
        _i32(entry_point, dev), _i32(node_level, dev),
        None if deleted is None
        else torch.tensor(np.asarray(deleted, bool), device=dev))


def hnsw_session_from_numpy(entry_point, turn, device=None) -> HNSWSession:
    """An ``HNSWSession`` on ``device`` (default cuda); a batched session
    or a session slab (a leading axis on both fields) converts the same
    way."""
    dev = _device.resolve(device)
    return HNSWSession(_i32(entry_point, dev), _i32(turn, dev))


def segmented_index_from_numpy(base, delta_vecs, delta_ids, tombstone,
                               device=None) -> SegmentedIndex:
    """A ``segment.SegmentedIndex`` on ``device`` (default cuda) around
    ``base``, a port index already converted there (``ivf_index_...``,
    ``ivf_pq_index_...`` or ``hnsw_index_from_numpy``), from the delta
    buffer, its ids and the tombstone mask: a reference segment carried
    over mid-mutation."""
    dev = _device.require(device, index_tensor(base))
    return SegmentedIndex(base, _f32(delta_vecs, dev), _i32(delta_ids, dev),
                          torch.tensor(np.asarray(tombstone, bool),
                                       device=dev))


def cache_entries_from_numpy(q_vec, doc_ids, doc_scores, doc_vecs, valid,
                             device=None) -> CacheEntry:
    """A result-cache ``CacheEntry`` on ``device`` (default cuda); the
    reference's cache slab (a leading ``n_slots + 1`` axis on every
    field) converts the same way, as its session slab does through
    ``ivf_session_from_numpy``.  ``SessionStore.restore`` takes either
    over, with the reference store's slot map and free list."""
    dev = _device.resolve(device)
    return CacheEntry(_f32(q_vec, dev), _i32(doc_ids, dev),
                      _f32(doc_scores, dev), _f32(doc_vecs, dev),
                      torch.tensor(np.asarray(valid, bool), device=dev))


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def encoder_params_from_numpy(params: Dict[str, Any], cfg: EncoderConfig,
                              device=None) -> DualEncoder:
    """A ``DualEncoder`` on ``device`` (default cuda) from the reference's
    ``init_params`` tree as numpy arrays (``{"query": tower, "doc":
    tower}``).  Each tower's ``layers`` leaves are stacked along a leading
    ``n_layers`` axis (the reference's ``vmap``/``scan`` layout) and are
    unstacked into one tree per layer.  With ``cfg.shared_towers`` the
    reference's two entries are one tower, and so is the port's: one
    ``Tower`` module serves both sides."""
    dev = _device.resolve(device)

    def tower(p):
        t = _tree(lambda a: _f32(a, dev),
                  {k: v for k, v in p.items() if k != "layers"})
        t["layers"] = [_tree(lambda a, i=i: _f32(np.asarray(a)[i], dev),
                             p["layers"]) for i in range(cfg.n_layers)]
        return Tower(cfg, t)

    query = tower(params["query"])
    doc = query if cfg.shared_towers else tower(params["doc"])
    return DualEncoder(cfg, query, doc)


def two_tower_params_from_numpy(params: Dict[str, Any], cfg: TwoTowerConfig,
                                device=None) -> TwoTower:
    """A ``TwoTower`` on ``device`` (default cuda) from the reference's
    ``two_tower_init`` tree as numpy arrays (``emb.table``, ``user_mlp``
    and ``item_mlp`` with their ``layers`` lists of ``w`` / ``b``)."""
    dev = _device.resolve(device)
    return TwoTower(cfg, _tree(lambda a: _f32(a, dev), params))


def dcnv2_params_from_numpy(params: Dict[str, Any], cfg: DCNv2Config,
                            device=None) -> DCNv2:
    """A ``DCNv2`` on ``device`` (default cuda) from the reference's
    ``dcnv2_init`` tree as numpy arrays (``emb.table``, ``cross`` [{w,
    b}], ``deep.layers``, ``head``)."""
    dev = _device.resolve(device)
    return DCNv2(cfg, _tree(lambda a: _f32(a, dev), params))


def bst_params_from_numpy(params: Dict[str, Any], cfg: BSTConfig,
                          device=None) -> BST:
    """A ``BST`` on ``device`` (default cuda) from the reference's
    ``bst_init`` tree as numpy arrays (``emb``, ``other_emb``, ``pos``,
    ``blocks`` [{attn, norm1, norm2, ff}], ``deep``, ``head``)."""
    dev = _device.resolve(device)
    return BST(cfg, _tree(lambda a: _f32(a, dev), params))


def autoint_params_from_numpy(params: Dict[str, Any], cfg: AutoIntConfig,
                              device=None) -> AutoInt:
    """An ``AutoInt`` on ``device`` (default cuda) from the reference's
    ``autoint_init`` tree as numpy arrays (``emb``, ``attn`` [{wq, wk, wv,
    wres}], ``head``)."""
    dev = _device.resolve(device)
    return AutoInt(cfg, _tree(lambda a: _f32(a, dev), params))


def gin_params_from_numpy(params: Dict[str, Any], cfg: GINConfig,
                          device=None) -> GIN:
    """A ``GIN`` on ``device`` (default cuda) from the reference's
    ``models.gnn.init_params`` tree as numpy arrays (``layers`` [{mlp:
    {w1, b1, w2, b2, norm}, eps}], ``heads``); ``cfg`` carries the
    shape's d_in and n_classes."""
    dev = _device.resolve(device)
    return GIN(cfg, _tree(lambda a: _f32(a, dev), params))


def _tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit: float32 as float32, and
    bfloat16 (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def lm_params_from_numpy(params: Dict[str, Any], cfg: LMConfig,
                         device=None) -> LM:
    """An ``LM`` on ``device`` (default cuda) from the reference's
    ``init_params`` tree as numpy arrays; the ``layers`` leaves, stacked
    along a leading ``n_layers`` axis, are unstacked into one tree per
    layer.  Every leaf keeps its dtype and bits (bfloat16 included)."""
    dev = _device.resolve(device)
    tree = _tree(lambda a: _tensor(a, dev),
                 {k: v for k, v in params.items() if k != "layers"})
    tree["layers"] = [_tree(lambda a, i=i: _tensor(np.asarray(a)[i], dev),
                            params["layers"]) for i in range(cfg.n_layers)]
    return LM(cfg, tree)


def to_numpy(x: Any) -> Any:
    """A tensor, or a NamedTuple of tensors, as numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(f) for f in x))
    raise TypeError(f"cannot convert {type(x).__name__}")
