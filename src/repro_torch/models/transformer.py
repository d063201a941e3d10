"""Decoder-only LM (dense GQA), inference: logits, prefill and decode.

Port of ``repro/models/transformer.py`` for the dense llama-style archs
(yi, qwen1.5 with QKV bias, qwen3 with qk-norm): ``LMConfig`` with its
parameter counts, ``init_params`` at the reference's scales, and the
serving path of ``prefill`` (``:370-449``) and ``decode_step``
(``:288-368``, the GQA branch) over a KV cache in the reference's
layout, (L, B, Hkv, S, dh) per K and V.  Prefill attends through
``ops.flash_attention`` (causal), each decode step through
``ops.flash_decode`` (``layers.Attention.decode``).

The reference stacks the layers along a leading axis and scans over
them; the port holds one ``DecoderLayer`` per layer in an
``nn.ModuleList`` (``convert.lm_params_from_numpy`` unstacks the
reference's arrays).  Decode writes each step's keys and values into
the cache in place and returns it, as the reference returns its updated
cache.  bf16 logits are rounded to bf16 before the float32 cast, as
``(x @ lm_head.astype(dtype)).astype(f32)`` does.

Not ported (ROADMAP Queue 1, item 7): MLA attention, MoE layers, the
logit soft cap (they raise ``NotImplementedError``), the loss and
training; ``remat``, ``loss_chunk``, ``unroll`` and ``act_spec`` are
training and sharding knobs with no counterpart here.  Token ids given
and cache fills given as numpy arrays are checked on the host where
they come in; those already on the card are the caller's contract (a
greedy step's argmax is valid by construction).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import layers as L
from repro_torch.models.recsys import check_ids

Params = L.Params
Cache = Dict[str, torch.Tensor]

UNPORTED = "ROADMAP Queue 1, item 7"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # attention flavour
    attn_kind: str = "gqa"            # "gqa"; "mla" is not ported
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_soft_cap: Optional[float] = None   # not ported
    n_experts: int = 0                        # MoE: not ported
    # numerics
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.float32

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.d_head, self.qkv_bias, self.qk_norm,
                            self.rope_theta, causal=True)

    def check_ported(self) -> None:
        """Refuse what the port does not run."""
        for what, unported in (("attn_kind='mla'", self.attn_kind == "mla"),
                               ("MoE (n_experts > 0)", self.n_experts > 0),
                               ("logit_soft_cap", bool(self.logit_soft_cap))):
            if unported:
                raise NotImplementedError(
                    f"{self.name}: {what} is not ported ({UNPORTED})")
        if self.attn_kind != "gqa":
            raise ValueError(f"attn_kind={self.attn_kind!r}")

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula, dense GQA)."""
        d, dh = self.d_model, self.d_head
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Parameters a token activates: all of them in a dense model."""
        return self.param_count()

    def kv_bytes_per_token(self) -> int:
        """Bytes of K and V one cached token takes over all layers."""
        return (2 * self.n_layers * self.n_kv_heads * self.d_head
                * torch.empty((), dtype=self.dtype).element_size())


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__()
        self.norm_attn = L.RMSNorm(params["norm_attn"])
        self.attn = L.Attention(cfg.attn_cfg(), params["attn"])
        self.norm_mlp = L.RMSNorm(params["norm_mlp"])
        self.mlp = L.SwiGLU(params["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d) -> (x', k, v): the layer's output and the keys and
        values its attention saw."""
        h, k, v = self.attn.forward_kv(self.norm_attn(x), positions)
        x = x + h
        return x + self.mlp(self.norm_mlp(x)), k, v

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cache_len: torch.Tensor
               ) -> torch.Tensor:
        h, _, _ = self.attn.decode(self.norm_attn(x), k_cache, v_cache,
                                   cache_len)
        x = x + h
        return x + self.mlp(self.norm_mlp(x))


class LM(nn.Module):
    """The decoder over the reference's parameter tree, ``layers`` a list
    of per-layer trees."""

    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.embed = L.frozen(params["embed"])
        self.layers = nn.ModuleList(DecoderLayer(cfg, lp)
                                    for lp in params["layers"])
        self.final_norm = L.RMSNorm(params["final_norm"])
        self.lm_head = L.frozen(params["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, np.ndarray):
            check_ids("tokens", tokens, self.cfg.vocab)
            tokens = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        _device.require(self.device, tokens)
        return tokens.long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(self.cfg.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.lm_head.to(self.cfg.dtype)

    def trunk(self, tokens):
        """Embed, every layer, final norm: (hidden (B, S, d), [(k, v)] per
        layer, each (B, Hkv, S, dh))."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=x.device).expand(b, s)
        kvs = []
        for layer in self.layers:
            x, k, v = layer(x, positions)
            kvs.append((k, v))
        return self.final_norm(x), kvs

    def forward(self, tokens) -> torch.Tensor:
        """Full logits (B, S, V) in ``cfg.dtype``, as the reference's
        ``forward``: for small vocabularies and tests."""
        return self._logits(self.trunk(tokens)[0])

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed K and V caches, (L, B, Hkv, max_len, dh) each."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
        return {name: torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                for name in ("k", "v")}

    def prefill(self, tokens, max_len: int
                ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """Prefill from a prompt, tokens (B, S) with S <= max_len:
        (last-token logits (B, V) float32, cache sized max_len, cache_len
        (B,) int32 = S)."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens > max_len {max_len}")
        x, kvs = self.trunk(tokens)
        cache = self.init_cache(b, max_len)
        for l, (k, v) in enumerate(kvs):
            cache["k"][l, :, :, :s] = k
            cache["v"][l, :, :, :s] = v
        logits = self._logits(x[:, -1]).float()
        return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)

    def decode_step(self, cache: Cache, tokens, cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """One step: tokens (B,), cache_len (B,) the current fill.  Writes
        each row's keys and values at cache_len (none where the cache is
        full) and returns (logits (B, V) float32, the cache)."""
        tokens = self._tokens(tokens)
        if isinstance(cache_len, np.ndarray):
            if cache_len.size and cache_len.min() < 0:
                raise ValueError(f"cache_len must be >= 0, got {cache_len}")
            cache_len = torch.from_numpy(cache_len.astype(np.int32)
                                         ).to(self.device)
        x = self._embed(tokens[:, None])
        for l, layer in enumerate(self.layers):
            x = layer.decode(x, cache["k"][l], cache["v"][l], cache_len)
        return self._logits(self.final_norm(x)[:, 0]).float(), cache


def layer_init(cfg: LMConfig, gen: torch.Generator) -> Params:
    dev, dt = gen.device, cfg.param_dtype
    return {"norm_attn": L.rmsnorm_init(cfg.d_model, dev, dt),
            "norm_mlp": L.rmsnorm_init(cfg.d_model, dev, dt),
            "attn": L.attn_init(gen, cfg.attn_cfg(), dt),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)}


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> LM:
    """A randomly initialised ``LM`` on ``device`` (default cuda), drawn
    from a ``torch.Generator`` seeded with ``seed`` at the reference's
    scales: dense normal x (1/d_in)^½, the embedding at 1.0, norms ones
    (other numbers than the reference's ``jax.random`` key gives)."""
    cfg.check_ported()
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": L.dense_init(gen, cfg.vocab, cfg.d_model,
                                    cfg.param_dtype, scale=1.0),
              "layers": [layer_init(cfg, gen) for _ in range(cfg.n_layers)],
              "final_norm": L.rmsnorm_init(cfg.d_model, dev,
                                           cfg.param_dtype),
              "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab,
                                      cfg.param_dtype)}
    return LM(cfg, params)
