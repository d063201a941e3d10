"""Carry the reference's state across: numpy arrays in, port tensors out.

The JAX package and the port share their index and session layouts
field for field, so a reference-built ``IVFIndex`` / ``IVFPQIndex`` /
``IVFSession`` becomes the port's by handing each field over as a numpy
array (``np.asarray(field)``); ``to_numpy`` goes the other way.
Nothing here imports the reference: the arrays are the interface.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.pq import IVFPQIndex, check_index
from repro_torch.core.toploc import IVFSession


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


def to_numpy(x: Any) -> Any:
    """A tensor, or a NamedTuple of tensors, as numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(f) for f in x))
    raise TypeError(f"cannot convert {type(x).__name__}")
