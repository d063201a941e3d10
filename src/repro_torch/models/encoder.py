"""Bi-encoder dense retrieval models (the paper's Dragon / Snowflake).

Port of ``repro/models/encoder.py`` (inference): a bidirectional
transformer tower per side (Dragon: separate query and doc towers;
Snowflake: one shared tower), CLS pooling after the final RMSNorm, a
projection, and L2 normalisation with a 1e-6 floor.  The function is the
reference's exactly (``:90-117``):

* token embedding gather + learned position embedding, times the mask;
* per layer: ``x + attn(norm1(x)) · mask``, then ``x + mlp(norm2(x)) ·
  mask`` (RoPE on q and k, ``AttnConfig(causal=False)``);
* padding keys are *not* masked in attention: padding positions are
  zeroed before every block, so their q, k and v are 0 and they enter
  each softmax with score 0.  The padded length is part of the function,
  so callers pad queries to ``max_len`` as the reference's pipeline does.

The reference stacks a tower's layers along a leading ``n_layers`` axis
(``jax.vmap`` at init, ``lax.scan`` in ``encode``); the port unstacks
them into an ``nn.ModuleList`` of ``EncoderLayer``s
(``convert.encoder_params_from_numpy`` slices the stacked arrays).
Entry points (``init_params``, the converter) run on cuda unless given
``device="cpu"``.  Training (``contrastive_loss``) is not ported.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import layers as L

Params = L.Params


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    name: str = "dragon"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    vocab: int = 32768
    max_len: int = 256
    out_dim: int = 0              # 0 → d_model
    normalize: bool = True        # L2-normalise pooled embedding
    shared_towers: bool = False   # Snowflake: one tower; Dragon: two
    dtype: torch.dtype = torch.float32

    @property
    def d_out(self) -> int:
        return self.out_dim or self.d_model

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_heads,
                            self.d_model // self.n_heads, causal=False)

    def param_count(self) -> int:
        d = self.d_model
        per = 4 * d * d + 3 * d * self.d_ff + 4 * d
        emb = self.vocab * d + self.max_len * d
        towers = 1 if self.shared_towers else 2
        return towers * (emb + self.n_layers * per + d * self.d_out)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, params: Params):
        super().__init__()
        self.attn = L.Attention(cfg.attn_cfg(), params["attn"])
        self.norm1 = L.RMSNorm(params["norm1"])
        self.norm2 = L.RMSNorm(params["norm2"])
        self.mlp = L.SwiGLU(params["mlp"])

    def forward(self, x, mask, positions):
        h = self.attn(self.norm1(x), positions)
        x = x + h * mask
        return x + self.mlp(self.norm2(x)) * mask


class Tower(nn.Module):
    """One encoder tower over the reference's tower tree, with
    ``layers`` a list of per-layer trees."""

    def __init__(self, cfg: EncoderConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.embed = L.frozen(params["embed"])
        self.pos = L.frozen(params["pos"])
        self.layers = nn.ModuleList(EncoderLayer(cfg, lp)
                                    for lp in params["layers"])
        self.final_norm = L.RMSNorm(params["final_norm"])
        self.proj = L.frozen(params["proj"])

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """tokens (B, S) integer, mask (B, S) bool -> (B, d_out)."""
        b, s = tokens.shape
        m = mask[..., None].to(self.cfg.dtype)
        x = self.embed[tokens.long()].to(self.cfg.dtype) + self.pos[None, :s]
        x = x * m
        positions = torch.arange(s, device=x.device).expand(b, s)
        for layer in self.layers:
            x = layer(x, m, positions)
        out = self.final_norm(x)[:, 0] @ self.proj        # CLS
        if self.cfg.normalize:
            out = out / out.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        return out


class DualEncoder(nn.Module):
    """The query and doc towers (one shared module for Snowflake)."""

    def __init__(self, cfg: EncoderConfig, query: Tower, doc: Tower):
        super().__init__()
        if cfg.shared_towers and query is not doc:
            raise ValueError("shared_towers: pass the same Tower twice")
        self.cfg = cfg
        self.query = query
        self.doc = doc

    @property
    def device(self) -> torch.device:
        return self.query.embed.device

    def _inputs(self, tokens, mask):
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens).to(self.device)
        if isinstance(mask, np.ndarray):
            mask = torch.from_numpy(mask).to(self.device)
        _device.require(self.device, tokens, mask)
        if tokens.shape[1] > self.cfg.max_len:
            raise ValueError(f"sequence of {tokens.shape[1]} tokens > "
                             f"max_len {self.cfg.max_len}")
        return tokens, mask.bool()

    def encode_queries(self, tokens, mask) -> torch.Tensor:
        """tokens (B, S), mask (B, S) (numpy or tensors) -> (B, d_out)."""
        return self.query(*self._inputs(tokens, mask))

    def encode_docs(self, tokens, mask) -> torch.Tensor:
        return self.doc(*self._inputs(tokens, mask))


def tower_init(cfg: EncoderConfig, gen: torch.Generator) -> Params:
    """A tower tree at the reference's scales: dense normal ×
    (1/d_in)^½, embedding scale 1.0, positions × 0.02, norms ones."""
    dev = gen.device

    def one_layer():
        return {"attn": L.attn_init(gen, cfg.attn_cfg(), cfg.dtype),
                "norm1": L.rmsnorm_init(cfg.d_model, dev, cfg.dtype),
                "norm2": L.rmsnorm_init(cfg.d_model, dev, cfg.dtype),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype)}

    return {
        "embed": L.dense_init(gen, cfg.vocab, cfg.d_model, cfg.dtype,
                              scale=1.0),
        "pos": (torch.randn((cfg.max_len, cfg.d_model), generator=gen,
                            device=dev) * 0.02).to(cfg.dtype),
        "layers": [one_layer() for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dev, cfg.dtype),
        "proj": L.dense_init(gen, cfg.d_model, cfg.d_out, cfg.dtype),
    }


def init_params(cfg: EncoderConfig, seed: int = 0, device=None
                ) -> DualEncoder:
    """A randomly initialised ``DualEncoder`` on ``device`` (default
    cuda), drawn from a ``torch.Generator`` seeded with ``seed`` (other
    numbers than the reference's ``jax.random`` key gives)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    query = Tower(cfg, tower_init(cfg, gen))
    doc = query if cfg.shared_towers else Tower(cfg, tower_init(cfg, gen))
    return DualEncoder(cfg, query, doc)
