"""Decoder-only LM, inference: logits, prefill and decode.

Port of ``repro/models/transformer.py`` for the five LM archs: dense
SwiGLU with GQA (yi, qwen1.5 with QKV bias, qwen3 with qk-norm) and MoE
(grok-1: GQA, top-2 of 8, the logit soft cap; deepseek-v2-lite: MLA, 2
shared + top-6 of 64 routed).  ``LMConfig`` with its parameter counts,
``init_params`` at the reference's scales, and the serving path of
``prefill`` (``:370-449``) and ``decode_step`` (``:288-368``) over the
reference's caches: (L, B, Hkv, S, dh) per K and V for GQA, the latent
``ckv`` (L, B, S, r) and ``krope`` (L, B, S, dr) for MLA (``:271-285``).
Prefill attends through ``ops.flash_attention`` (causal; MLA at D =
d_head + d_rope, Dv = d_head), a GQA decode step through
``ops.flash_decode`` (``layers.Attention.decode``), an MLA step through
the absorbed einsums (``layers.MLA.decode``).  A decode step runs its
MoE layers at one routing group (``moe_groups = 1``), as the reference
does; ``forward`` and ``prefill`` at ``moe_groups``.  The logit soft cap
is applied at the reference's three serving sites: ``forward``'s logits
in ``dtype``, ``prefill``'s and ``decode_step``'s in float32.

The reference stacks the layers along a leading axis and scans over
them; the port holds one ``DecoderLayer`` per layer in an
``nn.ModuleList`` (``convert.lm_params_from_numpy`` unstacks the
reference's arrays).  Decode writes each step's cache entries in place
and returns the cache, as the reference returns its updated cache.
bf16 logits are rounded to bf16 before the float32 cast, as
``(x @ lm_head.astype(dtype)).astype(f32)`` does.

Not ported: the loss and training (ROADMAP Queue 1, item 7);
``remat``, ``loss_chunk``, ``unroll``, ``act_spec`` and the MoE's
``moe_group_axes`` / ``moe_tp_axis`` are training and sharding knobs
with no counterpart here.  Token ids given and cache fills given as
numpy arrays are checked on the host where they come in; those already
on the card are the caller's contract (a greedy step's argmax is valid
by construction).
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

ATTN_KINDS = ("gqa", "mla")


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
    attn_kind: str = "gqa"            # "gqa" | "mla"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_soft_cap: Optional[float] = None
    # MLA
    kv_lora_rank: int = 512
    d_rope: int = 64
    # MoE (n_experts 0: dense)
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (if != d_ff)
    capacity_factor: float = 1.25
    moe_groups: int = 1               # routing groups
    # numerics
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.attn_kind not in ATTN_KINDS:
            raise ValueError(f"attn_kind={self.attn_kind!r}, one of "
                             f"{ATTN_KINDS}")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.d_head, self.qkv_bias, self.qk_norm,
                            self.rope_theta, causal=True)

    def mla_cfg(self) -> L.MLAConfig:
        return L.MLAConfig(self.d_model, self.n_heads, self.kv_lora_rank,
                           self.d_head, self.d_rope, self.rope_theta)

    def moe_cfg(self) -> L.MoEConfig:
        return L.MoEConfig(self.n_experts, self.top_k, self.d_model,
                           self.expert_ff, self.n_shared,
                           self.capacity_factor, self.moe_groups)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, dh = self.d_model, self.d_head
        if self.attn_kind == "mla":
            attn = (d * self.n_heads * (dh + self.d_rope)          # wq
                    + d * self.kv_lora_rank + d * self.d_rope       # down
                    + self.kv_lora_rank * self.n_heads * dh * 2     # up k,v
                    + self.n_heads * dh * d)                        # wo
        else:
            attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            ff = 3 * d * self.expert_ff * (self.n_experts + self.n_shared)
            ff += d * self.n_experts                                # router
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: the routed top-k and the
        shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full_ff = 3 * d * self.expert_ff * (self.n_experts + self.n_shared)
        act_ff = 3 * d * self.expert_ff * (self.top_k + self.n_shared)
        return self.param_count() - self.n_layers * (full_ff - act_ff)

    def kv_bytes_per_token(self) -> int:
        """Bytes of cache one token takes over all layers: K and V, or
        MLA's latent and rope key."""
        width = (self.kv_lora_rank + self.d_rope if self.attn_kind == "mla"
                 else 2 * self.n_kv_heads * self.d_head)
        return (self.n_layers * width
                * torch.empty((), dtype=self.dtype).element_size())


class DecoderLayer(nn.Module):
    """Pre-norm attention (GQA or MLA) and MLP (SwiGLU or MoE), each
    added to the residual."""

    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.norm_attn = L.RMSNorm(params["norm_attn"])
        self.attn = (L.MLA(cfg.mla_cfg(), params["attn"])
                     if cfg.attn_kind == "mla"
                     else L.Attention(cfg.attn_cfg(), params["attn"]))
        self.norm_mlp = L.RMSNorm(params["norm_mlp"])
        if cfg.is_moe:
            self.moe = L.MoE(cfg.moe_cfg(), params["moe"])
        else:
            self.mlp = L.SwiGLU(params["mlp"])

    def _mlp(self, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
        if not self.cfg.is_moe:
            return self.mlp(x)
        # a decode step routes its tokens as one group
        return self.moe(x, groups=1 if decode else None)[0]

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d) -> (x', a, b): the layer's output and what its
        cache keeps, (k, v) each (B, Hkv, S, dh) or MLA's (c_kv (B, S,
        r), k_rope (B, S, dr))."""
        h, a, b = self.attn.forward_kv(self.norm_attn(x), positions)
        x = x + h
        return x + self._mlp(self.norm_mlp(x)), a, b

    def decode(self, x: torch.Tensor, cache_a: torch.Tensor,
               cache_b: torch.Tensor, cache_len: torch.Tensor
               ) -> torch.Tensor:
        h, _, _ = self.attn.decode(self.norm_attn(x), cache_a, cache_b,
                                   cache_len)
        x = x + h
        return x + self._mlp(self.norm_mlp(x), decode=True)


class LM(nn.Module):
    """The decoder over the reference's parameter tree, ``layers`` a list
    of per-layer trees."""

    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__()
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

    def _cap(self, logits: torch.Tensor) -> torch.Tensor:
        """The logit soft cap, cap · tanh(logits / cap), where set."""
        cap = self.cfg.logit_soft_cap
        return cap * torch.tanh(logits / cap) if cap else logits

    @property
    def cache_names(self) -> Tuple[str, str]:
        return ("ckv", "krope") if self.cfg.attn_kind == "mla" else ("k",
                                                                      "v")

    def trunk(self, tokens):
        """Embed, every layer, final norm: (hidden (B, S, d), per layer
        what its cache keeps: (k, v) each (B, Hkv, S, dh), or MLA's (c_kv
        (B, S, r), k_rope (B, S, dr)))."""
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
        """Full logits (B, S, V) in ``cfg.dtype`` (soft-capped there),
        as the reference's ``forward``: for small vocabularies and
        tests."""
        return self._cap(self._logits(self.trunk(tokens)[0]))

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed caches: K and V, (L, B, Hkv, max_len, dh) each; MLA's
        ckv (L, B, max_len, r) and krope (L, B, max_len, dr)."""
        cfg = self.cfg
        ln = cfg.n_layers
        if cfg.attn_kind == "mla":
            shapes = {"ckv": (ln, batch, max_len, cfg.kv_lora_rank),
                      "krope": (ln, batch, max_len, cfg.d_rope)}
        else:
            shapes = dict.fromkeys(("k", "v"), (ln, batch, cfg.n_kv_heads,
                                                max_len, cfg.d_head))
        return {name: torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                for name, shape in shapes.items()}

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
        na, nb = self.cache_names
        for l, (a, c) in enumerate(kvs):
            cache[na][l, ..., :s, :] = a
            cache[nb][l, ..., :s, :] = c
        logits = self._cap(self._logits(x[:, -1]).float())
        return logits, cache, torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)

    def decode_step(self, cache: Cache, tokens, cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """One step: tokens (B,), cache_len (B,) the current fill.  Writes
        each row's cache entries at cache_len (none where the cache is
        full) and returns (logits (B, V) float32, the cache)."""
        tokens = self._tokens(tokens)
        if isinstance(cache_len, np.ndarray):
            if cache_len.size and cache_len.min() < 0:
                raise ValueError(f"cache_len must be >= 0, got {cache_len}")
            cache_len = torch.from_numpy(cache_len.astype(np.int32)
                                         ).to(self.device)
        x = self._embed(tokens[:, None])
        na, nb = self.cache_names
        for l, layer in enumerate(self.layers):
            x = layer.decode(x, cache[na][l], cache[nb][l], cache_len)
        return self._cap(self._logits(self.final_norm(x)[:, 0]).float()), \
            cache


def layer_init(cfg: LMConfig, gen: torch.Generator) -> Params:
    dev, dt = gen.device, cfg.param_dtype
    p = {"norm_attn": L.rmsnorm_init(cfg.d_model, dev, dt),
         "norm_mlp": L.rmsnorm_init(cfg.d_model, dev, dt),
         "attn": (L.mla_init(gen, cfg.mla_cfg(), dt)
                  if cfg.attn_kind == "mla"
                  else L.attn_init(gen, cfg.attn_cfg(), dt))}
    if cfg.is_moe:
        p["moe"] = L.moe_init(gen, cfg.moe_cfg(), dt)
    else:
        p["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> LM:
    """A randomly initialised ``LM`` on ``device`` (default cuda), drawn
    from a ``torch.Generator`` seeded with ``seed`` at the reference's
    scales: dense normal x (1/d_in)^½, the embedding at 1.0, norms ones
    (other numbers than the reference's ``jax.random`` key gives)."""
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
