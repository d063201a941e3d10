"""RecSys: the sparse embedding substrate and two-tower retrieval.

Port of ``repro/models/recsys.py:32-153`` (inference): one concatenated
embedding table ``(Σ vocab, dim)`` with per-field row offsets, looked up
by a plain gather for single-valent fields (``embed_fields``, the
reference runs XLA there) and by the hand-written EmbeddingBag kernel for
multi-hot bags (``embed_bag`` → ``kernels.ops.embedding_bag``), and the
two-tower model of Yi et al. (RecSys'19): the user tower concatenates
the user's embedding with the mean of its history bag, the item tower
takes the item's embedding, each runs an MLP and L2-normalises with a
1e-6 floor.  ``retrieval_topk`` is the brute-force candidate scoring
that TopLoc over an IVF of the item corpus replaces
(``serving/engine.py``).

Ids are checked once, where they come in from the host: numpy ids given
to ``TwoTower.user_tower`` / ``item_tower`` must lie in their vocabulary
(history ids may be negative: pads) before they move to the device.
Ids that are already tensors on the card are the caller's contract: the
kernel and the gather read unchecked.  Entry points run on cuda unless
given ``device="cpu"``.  DCN-v2, BST, AutoInt and the losses are not
ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core.topk import topk
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# sparse embedding substrate
# ---------------------------------------------------------------------------


def field_offsets(vocab_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Per-field row offsets into the concatenated table."""
    out, acc = [], 0
    for v in vocab_sizes:
        out.append(acc)
        acc += int(v)
    return tuple(out)


def embed_table_init(gen: torch.Generator, vocab_sizes: Sequence[int],
                     dim: int, dtype=torch.float32) -> Params:
    """The concatenated table, normal × dim^-½, on the generator's
    device."""
    total = int(sum(vocab_sizes))
    table = torch.randn((total, dim), generator=gen, device=gen.device)
    return {"table": table.mul_(dim ** -0.5).to(dtype)}


def embed_fields(table: torch.Tensor, offsets: Sequence[int],
                 ids: torch.Tensor) -> torch.Tensor:
    """Single-valent lookup: ids (B, F) per field -> (B, F, dim)."""
    offs = torch.as_tensor(offsets, dtype=torch.int64, device=ids.device)
    return table[ids.long() + offs[None, :]]


def embed_bag(table: torch.Tensor, offset: int, ids: torch.Tensor,
              agg: str = "mean") -> torch.Tensor:
    """Multi-hot bag of one field: ids (B, L) (negative = pad) -> (B,
    dim), through the EmbeddingBag kernel on the card."""
    shifted = torch.where(ids >= 0, ids + offset, -1).to(torch.int32)
    return ops.embedding_bag(table, shifted, agg=agg, device=table.device)


def check_ids(name: str, ids: np.ndarray, vocab: int, *,
              pads: bool = False) -> None:
    """Refuse host ids outside [0, vocab) (negative ids allowed as pads
    with ``pads``): on the card they would be read unchecked."""
    ids = np.asarray(ids)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"{name}: integer ids required, got {ids.dtype}")
    if ids.size and (ids.max() >= vocab or (not pads and ids.min() < 0)):
        raise ValueError(f"{name}: ids must lie in "
                         f"{'[-1' if pads else '[0'}, {vocab}), got "
                         f"[{ids.min()}, {ids.max()}]")


# ---------------------------------------------------------------------------
# two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 1_000_000
    item_vocab: int = 2_097_152
    history_len: int = 50
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        e = self.embed_dim
        emb = (self.user_vocab + self.item_vocab) * e

        def tower(d_in):
            n, dims = 0, (d_in,) + self.tower_mlp
            for a, b in zip(dims[:-1], dims[1:]):
                n += a * b + b
            return n
        return emb + tower(2 * e) + tower(e)


def two_tower_params(cfg: TwoTowerConfig, gen: torch.Generator) -> Params:
    """A parameter tree in the reference's layout (``emb``, ``user_mlp``,
    ``item_mlp``) drawn from ``gen``, on its device."""
    e = cfg.embed_dim
    return {
        "emb": embed_table_init(gen, (cfg.user_vocab, cfg.item_vocab), e,
                                cfg.dtype),
        "user_mlp": L.mlp_init(gen, (2 * e,) + cfg.tower_mlp, cfg.dtype),
        "item_mlp": L.mlp_init(gen, (e,) + cfg.tower_mlp, cfg.dtype),
    }


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-6)


class TwoTower(nn.Module):
    """The user and item towers over one embedding table."""

    def __init__(self, cfg: TwoTowerConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.table = L.frozen(params["emb"]["table"])
        self.user_mlp = L.MLP(params["user_mlp"])
        self.item_mlp = L.MLP(params["item_mlp"])
        self.offsets = field_offsets((cfg.user_vocab, cfg.item_vocab))

    @property
    def device(self) -> torch.device:
        return self.table.device

    def _ids(self, name: str, ids, vocab: int, pads: bool = False
             ) -> torch.Tensor:
        if isinstance(ids, np.ndarray):
            check_ids(name, ids, vocab, pads=pads)
            ids = torch.from_numpy(ids.astype(np.int32)).to(self.device)
        _device.require(self.device, ids)
        return ids

    def user_tower(self, user_id, history) -> torch.Tensor:
        """user_id (B,), history (B, L) item ids (negative = pad), numpy
        or tensors -> (B, out), unit rows."""
        cfg = self.cfg
        user_id = self._ids("user_id", user_id, cfg.user_vocab)
        history = self._ids("history", history, cfg.item_vocab, pads=True)
        ue = embed_fields(self.table, self.offsets[:1], user_id[:, None])
        he = embed_bag(self.table, self.offsets[1], history, agg="mean")
        return _normalize(self.user_mlp(torch.cat([ue[:, 0], he], -1)))

    def item_tower(self, item_id) -> torch.Tensor:
        """item_id (B,) -> (B, out), unit rows."""
        item_id = self._ids("item_id", item_id, self.cfg.item_vocab)
        ie = embed_fields(self.table, self.offsets[1:], item_id[:, None])
        return _normalize(self.item_mlp(ie[:, 0]))


def two_tower_init(cfg: TwoTowerConfig, seed: int = 0, device=None
                   ) -> TwoTower:
    """A randomly initialised ``TwoTower`` on ``device`` (default cuda),
    drawn from a ``torch.Generator`` seeded with ``seed`` (other numbers
    than the reference's ``jax.random`` key gives)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TwoTower(cfg, two_tower_params(cfg, gen))


def retrieval_topk(user_vec: torch.Tensor, item_corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force candidate scoring: (B, e) x (N, e) -> top-k (values,
    int32 ids) in ``lax.top_k`` order."""
    v, i = topk(user_vec @ item_corpus.T, k)
    return v, i.to(torch.int32)
