"""Building blocks of the bi-encoder, the recsys towers and the LM, as ``nn.Module``s.

Port of the parts of ``repro/models/layers.py`` the encoder, the
two-tower model and the dense LMs use: RMSNorm (float32, eps 1e-6,
``:42-46``), RoPE in the split-halves convention (``:66-79``), GQA
attention with optional qkv bias and qk-norm (``AttnConfig``,
``_project_qkv`` + ``attn_apply``, ``:86-146``) and its one-token decode
against a KV cache (``attn_decode``, ``:149-171``), the SwiGLU MLP
(``:177-186``) and the plain MLP tower (``mlp_init`` / ``mlp_apply``,
``:189-210``).  MoE and MLA are not ported (ROADMAP Queue 1, item 7).

Parameters keep the reference's layout (``x @ w`` with ``w`` of shape
(d_in, d_out)), so a reference parameter tree converts leaf for leaf.
Each module is built from a dict of tensors: ``*_init(gen, ...)`` draws
one from a ``torch.Generator`` at the reference's scales, and
``convert.encoder_params_from_numpy`` makes one from the reference's
arrays.  Parameters do not require grad: these slices serve, and the
attention and EmbeddingBag kernels have no backward yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.kernels import ops

Params = Dict[str, object]
#: an attention function (q, k, v, *, causal) -> out, or a decode attention
#: function (q, k, v, cache_len) -> out, in place of the kernel
AttentionFn = Callable[..., torch.Tensor]


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that requires no grad."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# initialisers / norms
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal times (1 / d_in)^½ unless ``scale`` is given, on the
    generator's device."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * scale).to(dtype)


def rmsnorm_init(d: int, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · scale, computed in float32."""

    def __init__(self, params: Params, eps: float = 1e-6):
        super().__init__()
        self.scale = frozen(params["scale"])
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps)
        return (out * self.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0, device=None
               ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, d_head); positions (..., S) integer (broadcastable).
    Split halves: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (covers MHA; optional qkv bias / qk-norm)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32
              ) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = gen.device
    p: Params = {"wq": dense_init(gen, d, h * dh, dtype),
                 "wk": dense_init(gen, d, hkv * dh, dtype),
                 "wv": dense_init(gen, d, hkv * dh, dtype),
                 "wo": dense_init(gen, h * dh, d, dtype)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, dev, dtype)
        p["k_norm"] = rmsnorm_init(dh, dev, dtype)
    return p


class Attention(nn.Module):
    """Full-sequence attention through ``ops.flash_attention``, or through
    ``attention`` where an instance sets it (e.g. to
    ``kernels.ref.mha_attention``, to hold the kernel to its plain
    version inside a model); one-token decode through
    ``ops.flash_decode``, or ``decode_attention`` where set (e.g. to
    ``kernels.ref.decode_attention``)."""

    attention: Optional[AttentionFn] = None
    decode_attention: Optional[AttentionFn] = None

    def __init__(self, cfg: AttnConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, frozen(params[name]))
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                setattr(self, name, frozen(params[name]))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(params["q_norm"])
            self.k_norm = RMSNorm(params["k_norm"])

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d) -> q (B, H, S, dh), k and v (B, Hkv, S, dh)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        pos = positions[:, None]
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta)
        return q, k, v.transpose(1, 2)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d)."""
        return self.forward_kv(x, positions)[0]

    def forward_kv(self, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None):
        """``forward``, also returning the keys and values it attended to:
        (out (B, S, d), k (B, Hkv, S, dh), v (B, Hkv, S, dh)), the LM's
        prefill writes them to its cache."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = self.project_qkv(x, positions)
        if self.attention is None:
            out = ops.flash_attention(q, k, v, causal=self.cfg.causal,
                                      device=q.device)
        else:
            out = self.attention(q, k, v, causal=self.cfg.causal)
        out = out.transpose(1, 2).reshape(b, s,
                                          self.cfg.n_heads * self.cfg.d_head)
        return out @ self.wo, k, v

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cache_len: torch.Tensor):
        """One-token decode: x (B, 1, d), caches (B, Hkv, S, dh), cache_len
        (B,) the current fill.  Returns (out (B, 1, d), k_cache, v_cache).

        Each row's new key and value go to position ``cache_len`` (RoPE at
        that position), in place; a row whose cache is full (cache_len >=
        S) writes nothing, as the reference's ``mode="drop"`` scatter,
        and attends to its S cached positions.  Then ``ops.flash_decode``
        over ``cache_len + 1`` positions.
        """
        cfg = self.cfg
        b = x.shape[0]
        hkv, s = k_cache.shape[1], k_cache.shape[2]
        q, k, v = self.project_qkv(x, cache_len[:, None])
        # the drop without a host sync: a full row writes back what it
        # holds at S - 1
        keep = (cache_len < s)[:, None, None]
        pos = cache_len.clamp(max=s - 1).long()[:, None]
        b_ix = torch.arange(b, device=x.device)[:, None]
        h_ix = torch.arange(hkv, device=x.device)[None, :]
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache[b_ix, h_ix, pos] = torch.where(
                keep, new[:, :, 0].to(cache.dtype), cache[b_ix, h_ix, pos])
        if self.decode_attention is None:
            out = ops.flash_decode(q[:, :, 0], k_cache, v_cache,
                                   cache_len + 1, device=x.device)
        else:
            out = self.decode_attention(q[:, :, 0], k_cache, v_cache,
                                        cache_len + 1)
        return (out.reshape(b, 1, cfg.n_heads * cfg.d_head) @ self.wo,
                k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> Params:
    return {"w_gate": dense_init(gen, d, d_ff, dtype),
            "w_up": dense_init(gen, d, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d, dtype)}


class SwiGLU(nn.Module):
    """(silu(x w_gate) · x w_up) w_down."""

    def __init__(self, params: Params):
        super().__init__()
        self.w_gate = frozen(params["w_gate"])
        self.w_up = frozen(params["w_up"])
        self.w_down = frozen(params["w_down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.nn.functional.silu(x @ self.w_gate) * (x @ self.w_up)
                ) @ self.w_down


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32,
             bias: bool = True) -> Params:
    """Plain MLP tower (recsys): dims = [in, h1, ..., out]; dense weights
    at the reference's scale, zero biases."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lp = {"w": dense_init(gen, d_in, d_out, dtype)}
        if bias:
            lp["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
        layers.append(lp)
    return {"layers": layers}


class MLP(nn.Module):
    """x @ w (+ b) per layer, ReLU between layers and, with
    ``final_act``, after the last."""

    def __init__(self, params: Params, final_act: bool = False):
        super().__init__()
        self.weights = nn.ParameterList(frozen(lp["w"])
                                        for lp in params["layers"])
        self.biases = nn.ParameterList(
            frozen(lp["b"]) for lp in params["layers"] if "b" in lp)
        if len(self.biases) not in (0, len(self.weights)):
            raise ValueError("either every layer has a bias or none has")
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.weights)
        for i, w in enumerate(self.weights):
            x = x @ w
            if len(self.biases):
                x = x + self.biases[i]
            if i < n - 1 or self.final_act:
                x = torch.relu(x)
        return x
