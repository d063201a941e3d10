"""Carry the reference's state across: numpy arrays in, port tensors out.

The JAX package and the port share their index and session layouts
field for field, so a reference-built ``IVFIndex`` / ``IVFPQIndex`` /
``IVFSession`` becomes the port's by handing each field over as a numpy
array (``np.asarray(field)``); ``to_numpy`` goes the other way.  The
bi-encoder's parameter tree converts leaf for leaf, its stacked layers
unstacked (``encoder_params_from_numpy``); so do the two-tower model's
(``two_tower_params_from_numpy``) and the LM's
(``lm_params_from_numpy``, bfloat16 carried bit for bit).
Nothing here imports the reference: the arrays are the interface.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.pq import IVFPQIndex, check_index
from repro_torch.core.toploc import IVFSession
from repro_torch.models.encoder import DualEncoder, EncoderConfig, Tower
from repro_torch.models.recsys import TwoTower, TwoTowerConfig
from repro_torch.models.transformer import LM, LMConfig


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
