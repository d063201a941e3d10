"""RecSys: the sparse embedding substrate, two-tower retrieval and the
ranking models DCN-v2, BST and AutoInt.

Port of ``repro/models/recsys.py:32-358`` (inference): one concatenated
embedding table ``(Σ vocab, dim)`` with per-field row offsets, looked up
by a plain gather for single-valent fields (``embed_fields``, the
reference runs XLA there) and by the hand-written EmbeddingBag kernel for
multi-hot bags (``embed_bag`` → ``kernels.ops.embedding_bag``), and the
two-tower model of Yi et al. (RecSys'19): the user tower concatenates
the user's embedding with the mean of its history bag, the item tower
takes the item's embedding, each runs an MLP and L2-normalises with a
1e-6 floor.  ``retrieval_topk`` is the brute-force candidate scoring
that TopLoc over an IVF of the item corpus replaces
(``serving/engine.py``).  The ranking models score given candidate rows
(TopLoc does not apply): DCN-v2 (three full-rank cross layers beside a
deep MLP), BST (the behaviour sequence and the target item through a
transformer block whose attention is the hand-written flash attention
kernel, non-causal, heads of embed_dim / n_heads = 4) and AutoInt
(self-attention over the fields, plain einsums and a float32 softmax,
as the reference runs XLA there).

Ids are checked once, where they come in from the host: numpy ids given
to ``TwoTower.user_tower`` / ``item_tower`` must lie in their vocabulary
(history ids may be negative: pads) before they move to the device.
Ids that are already tensors on the card are the caller's contract: the
kernel and the gather read unchecked.  Entry points run on cuda unless
given ``device="cpu"``.  The training losses are the reference's:
``two_tower_loss`` (in-batch sampled softmax, ``:126``) and ``bce_loss``
(the CTR models', ``:361``).
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
    table = L.randn((total, dim), gen)
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


def check_ids(name: str, ids: np.ndarray, vocab, *,
              pads: bool = False) -> None:
    """Refuse host ids outside [0, vocab) (negative ids allowed as pads
    with ``pads``): on the card they would be read unchecked.  ``vocab``
    is one size, or one per field (the last axis) of (B, F) ids."""
    ids = np.asarray(ids)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"{name}: integer ids required, got {ids.dtype}")
    if not ids.size:
        return
    if not isinstance(vocab, (int, np.integer)):
        vocab = np.asarray(vocab, dtype=np.int64)
        if ids.ndim != 2 or ids.shape[1] != vocab.size:
            raise ValueError(f"{name}: (B, {vocab.size}) ids required, got "
                             f"{ids.shape}")
        bad = (ids >= vocab) | (ids < 0)
        if bad.any():
            f = int(np.nonzero(bad.any(0))[0][0])
            raise ValueError(f"{name}: field {f}'s ids must lie in [0, "
                             f"{vocab[f]}), got [{ids[:, f].min()}, "
                             f"{ids[:, f].max()}]")
        return
    if ids.max() >= vocab or (not pads and ids.min() < 0):
        raise ValueError(f"{name}: ids must lie in "
                         f"{'[-1' if pads else '[0'}, {vocab}), got "
                         f"[{ids.min()}, {ids.max()}]")


def device_ids(name: str, ids, vocab, device: torch.device, *,
               pads: bool = False) -> torch.Tensor:
    """Host (numpy) ids checked by ``check_ids`` and moved to ``device``
    as int32; a tensor must already lie there and is taken unchecked."""
    if isinstance(ids, np.ndarray):
        check_ids(name, ids, vocab, pads=pads)
        ids = torch.from_numpy(ids.astype(np.int32)).to(device)
    _device.require(device, ids)
    return ids


def score_in_chunks(fn, rows: int, chunk: int, *inputs) -> torch.Tensor:
    """``fn(*inputs)`` over rows [i, i + chunk) of every input at a time,
    the (rows,) results concatenated: rows are scored independently, so
    a batch whose activations would not fit is served this way."""
    if chunk >= rows:
        return fn(*inputs)
    return torch.cat([fn(*(x[i:i + chunk] for x in inputs))
                      for i in range(0, rows, chunk)])


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
        return device_ids(name, ids, vocab, self.device, pads=pads)

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
    gen = L.generator(_device.resolve(device), seed)
    return TwoTower(cfg, two_tower_params(cfg, gen))


def two_tower_loss(model: TwoTower, batch: Params
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled softmax (``repro/models/recsys.py:126``): user
    (``user_id``, ``history``) and item (``item_id``) towers, logits u iᵀ
    / temperature, row i's positive item i.  (mean loss, {"acc"})."""
    u = model.user_tower(batch["user_id"], batch["history"])
    i = model.item_tower(batch["item_id"])
    logits = (u @ i.T) / model.cfg.temperature
    labels = torch.arange(u.shape[0], device=u.device)
    loss = L.softmax_xent(logits, labels).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc}


def bce_loss(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Binary cross-entropy on click labels (``:361``), in the stable
    form max(x, 0) − x y + log1p(exp(−|x|)), in float32.  (mean loss,
    {"acc": share of (x > 0) == (y > 0.5)}).  |x| is taken as x ≥ 0 ? x
    : −x, whose gradient at 0 is 1 as ``jnp.abs``'s is (torch's is 0)."""
    lf = logits.float()
    y = labels.float()
    loss = (torch.maximum(lf, torch.zeros_like(lf)) - lf * y
            + torch.log1p(torch.exp(-torch.where(lf >= 0, lf, -lf)))
            ).mean()
    acc = ((lf > 0) == (y > 0.5)).float().mean()
    return loss, {"acc": acc}


def retrieval_topk(user_vec: torch.Tensor, item_corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force candidate scoring: (B, e) x (N, e) -> top-k (values,
    int32 ids) in ``lax.top_k`` order."""
    v, i = topk(user_vec @ item_corpus.T, k)
    return v, i.to(torch.int32)


def _dense(x, device: torch.device) -> torch.Tensor:
    """Dense features (numpy or a tensor on ``device``) as float32."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)
    _device.require(device, x)
    return x


# ---------------------------------------------------------------------------
# DCN-v2 (arXiv:2008.13535)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: Tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: Tuple[int, ...] = ()   # len == n_sparse
    dtype: torch.dtype = torch.float32

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def param_count(self) -> int:
        d = self.d_input
        emb = sum(self.vocab_sizes) * self.embed_dim
        cross = self.n_cross_layers * (d * d + d)
        deep, dims = 0, (d,) + self.mlp
        for a, b in zip(dims[:-1], dims[1:]):
            deep += a * b + b
        return emb + cross + deep + (d + self.mlp[-1]) + 1


def dcnv2_init(cfg: DCNv2Config, gen: torch.Generator) -> Params:
    """The reference's ``dcnv2_init`` tree (``emb``, ``cross`` [{w, b}],
    ``deep``, ``head``) drawn from ``gen`` at its scales, on its
    device."""
    d = cfg.d_input
    return {
        "emb": embed_table_init(gen, cfg.vocab_sizes, cfg.embed_dim,
                                cfg.dtype),
        "cross": [{"w": L.dense_init(gen, d, d, cfg.dtype),
                   "b": torch.zeros((d,), dtype=cfg.dtype,
                                    device=gen.device)}
                  for _ in range(cfg.n_cross_layers)],
        "deep": L.mlp_init(gen, (d,) + cfg.mlp, cfg.dtype),
        "head": L.dense_init(gen, d + cfg.mlp[-1], 1, cfg.dtype),
    }


class DCNv2(nn.Module):
    """``dcnv2_forward``: dense (B, n_dense) and sparse ids (B, n_sparse)
    -> logits (B,) float32.  x0 = [dense, field embeddings]; three cross
    layers x <- x0 * (x W + b) + x; the deep MLP on x0 (ReLU after every
    layer); the head on [x, deep]."""

    def __init__(self, cfg: DCNv2Config, params: Params):
        super().__init__()
        if len(cfg.vocab_sizes) != cfg.n_sparse:
            raise ValueError(f"{len(cfg.vocab_sizes)} vocab sizes for "
                             f"{cfg.n_sparse} sparse fields")
        self.cfg = cfg
        self.table = L.frozen(params["emb"]["table"])
        self.cross_w = nn.ParameterList(L.frozen(c["w"])
                                        for c in params["cross"])
        self.cross_b = nn.ParameterList(L.frozen(c["b"])
                                        for c in params["cross"])
        self.deep = L.MLP(params["deep"], final_act=True)
        self.head = L.frozen(params["head"])
        self.offsets = field_offsets(cfg.vocab_sizes)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, dense, sparse_ids) -> torch.Tensor:
        cfg = self.cfg
        dense = _dense(dense, self.device)
        ids = device_ids("sparse_ids", sparse_ids, cfg.vocab_sizes,
                         self.device)
        se = embed_fields(self.table, self.offsets, ids)      # (B, F, e)
        x0 = torch.cat([dense.to(cfg.dtype), se.reshape(se.shape[0], -1)],
                       -1)
        x = x0
        for w, b in zip(self.cross_w, self.cross_b):
            x = x0 * (x @ w + b) + x
        both = torch.cat([x, self.deep(x0)], -1)
        return (both @ self.head)[:, 0].float()


# ---------------------------------------------------------------------------
# BST: Behaviour Sequence Transformer (arXiv:1905.06874)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp: Tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 5_000_000
    n_other: int = 8                 # other categorical profile features
    other_vocab: int = 100_000
    dtype: torch.dtype = torch.float32

    @property
    def attn(self) -> L.AttnConfig:
        """The block's attention: MHA, non-causal, d_head = e / H."""
        e, h = self.embed_dim, self.n_heads
        return L.AttnConfig(e, h, h, e // h, causal=False)

    def param_count(self) -> int:
        e = self.embed_dim
        emb = self.item_vocab * e + self.n_other * self.other_vocab * e
        attn = self.n_blocks * (4 * e * e + 2 * e * 4 * e + 4 * e)
        d_in = (self.seq_len + 1) * e + self.n_other * e
        deep, dims = 0, (d_in,) + self.mlp
        for a, b in zip(dims[:-1], dims[1:]):
            deep += a * b + b
        return emb + attn + deep + self.mlp[-1] + 1


def bst_init(cfg: BSTConfig, gen: torch.Generator) -> Params:
    """The reference's ``bst_init`` tree (``emb``, ``other_emb``,
    ``pos``, ``blocks`` [{attn, norm1, norm2, ff}], ``deep``, ``head``)
    drawn from ``gen`` at its scales, on its device."""
    e, dev = cfg.embed_dim, gen.device
    blocks = [{"attn": L.attn_init(gen, cfg.attn, cfg.dtype),
               "norm1": L.layernorm_init(e, dev, cfg.dtype),
               "norm2": L.layernorm_init(e, dev, cfg.dtype),
               "ff": L.mlp_init(gen, (e, 4 * e, e), cfg.dtype)}
              for _ in range(cfg.n_blocks)]
    d_in = (cfg.seq_len + 1) * e + cfg.n_other * e
    return {
        "emb": embed_table_init(gen, (cfg.item_vocab,), e, cfg.dtype),
        "other_emb": embed_table_init(gen, (cfg.other_vocab,) * cfg.n_other,
                                      e, cfg.dtype),
        "pos": (L.randn((cfg.seq_len + 1, e), gen) * 0.02).to(cfg.dtype),
        "blocks": blocks,
        "deep": L.mlp_init(gen, (d_in,) + cfg.mlp, cfg.dtype),
        "head": L.dense_init(gen, cfg.mlp[-1], 1, cfg.dtype),
    }


class BSTBlock(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then x + FF(LN(x))
    with the tanh-form gelu.  The attention applies RoPE inside, on top
    of the model's learned positions, as the reference's ``attn_apply``."""

    def __init__(self, cfg: BSTConfig, params: Params):
        super().__init__()
        self.attn = L.Attention(cfg.attn, params["attn"])
        self.norm1 = L.LayerNorm(params["norm1"])
        self.norm2 = L.LayerNorm(params["norm2"])
        self.ff = L.MLP(params["ff"], act="gelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ff(self.norm2(x))


class BST(nn.Module):
    """``bst_forward``: history (B, seq_len) and target (B,) item ids,
    other_ids (B, n_other) profile ids -> logits (B,) float32.  The
    sequence [history, target] embedded plus ``pos`` goes through the
    blocks (attention through ``ops.flash_attention``: row 8 on the
    card), then [the flattened sequence, the profile embeddings] through
    the leaky-ReLU MLP and the head."""

    def __init__(self, cfg: BSTConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.table = L.frozen(params["emb"]["table"])
        self.other_table = L.frozen(params["other_emb"]["table"])
        self.pos = L.frozen(params["pos"])
        self.blocks = nn.ModuleList(BSTBlock(cfg, p)
                                    for p in params["blocks"])
        self.deep = L.MLP(params["deep"], act="leaky_relu")
        self.head = L.frozen(params["head"])
        self.other_offsets = field_offsets((cfg.other_vocab,) * cfg.n_other)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, history, target, other_ids) -> torch.Tensor:
        cfg, dev = self.cfg, self.device
        history = device_ids("history", history, cfg.item_vocab, dev)
        target = device_ids("target", target, cfg.item_vocab, dev)
        other = device_ids("other_ids", other_ids,
                           (cfg.other_vocab,) * cfg.n_other, dev)
        b = history.shape[0]
        seq = torch.cat([history, target[:, None].to(history.dtype)], 1)
        x = self.table[seq.long()] + self.pos[None]       # (B, S + 1, e)
        for blk in self.blocks:
            x = blk(x)
        oe = embed_fields(self.other_table, self.other_offsets, other)
        feat = torch.cat([x.reshape(b, -1), oe.reshape(b, -1)], -1)
        return (self.deep(feat) @ self.head)[:, 0].float()


# ---------------------------------------------------------------------------
# AutoInt (arXiv:1810.11921)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_sizes: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        emb = sum(self.vocab_sizes) * self.embed_dim
        d0, da, h = self.embed_dim, self.d_attn, self.n_heads
        n, d_in = 0, d0
        for _ in range(self.n_attn_layers):
            n += d_in * da * h * 3 + d_in * da * h   # qkv + residual proj
            d_in = da * h
        return emb + n + self.n_sparse * d_in + 1


def autoint_init(cfg: AutoIntConfig, gen: torch.Generator) -> Params:
    """The reference's ``autoint_init`` tree (``emb``, ``attn`` [{wq, wk,
    wv, wres}], ``head``) drawn from ``gen`` at its scales, on its
    device."""
    layers, d_in = [], cfg.embed_dim
    d_out = cfg.d_attn * cfg.n_heads
    for _ in range(cfg.n_attn_layers):
        layers.append({name: L.dense_init(gen, d_in, d_out, cfg.dtype)
                       for name in ("wq", "wk", "wv", "wres")})
        d_in = d_out
    return {
        "emb": embed_table_init(gen, cfg.vocab_sizes, cfg.embed_dim,
                                cfg.dtype),
        "attn": layers,
        "head": L.dense_init(gen, cfg.n_sparse * d_in, 1, cfg.dtype),
    }


class AutoInt(nn.Module):
    """``autoint_forward``: sparse ids (B, n_sparse) -> logits (B,)
    float32.  Per layer, multi-head self-attention over the fields (the
    scores over sqrt(d_attn), softmax in float32) plus a residual
    projection, then ReLU; the head on the flattened fields."""

    def __init__(self, cfg: AutoIntConfig, params: Params):
        super().__init__()
        if len(cfg.vocab_sizes) != cfg.n_sparse:
            raise ValueError(f"{len(cfg.vocab_sizes)} vocab sizes for "
                             f"{cfg.n_sparse} sparse fields")
        self.cfg = cfg
        self.table = L.frozen(params["emb"]["table"])
        for name in ("wq", "wk", "wv", "wres"):
            setattr(self, name, nn.ParameterList(
                L.frozen(lp[name]) for lp in params["attn"]))
        self.head = L.frozen(params["head"])
        self.offsets = field_offsets(cfg.vocab_sizes)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, sparse_ids) -> torch.Tensor:
        cfg = self.cfg
        ids = device_ids("sparse_ids", sparse_ids, cfg.vocab_sizes,
                         self.device)
        x = embed_fields(self.table, self.offsets, ids)       # (B, F, e)
        b, f, _ = x.shape
        h, da = cfg.n_heads, cfg.d_attn
        for wq, wk, wv, wres in zip(self.wq, self.wk, self.wv, self.wres):
            q, k, v = ((x @ w).reshape(b, f, h, da).transpose(1, 2)
                       for w in (wq, wk, wv))
            logits = torch.einsum("bhfd,bhgd->bhfg", q, k) / (da ** 0.5)
            probs = torch.softmax(logits.float(), -1).to(x.dtype)
            o = torch.einsum("bhfg,bhgd->bhfd", probs, v)
            x = torch.relu(o.transpose(1, 2).reshape(b, f, h * da)
                           + x @ wres)
        return (x.reshape(b, -1) @ self.head)[:, 0].float()
