"""Building blocks of the bi-encoder, the recsys towers and the LM, as ``nn.Module``s.

Port of the parts of ``repro/models/layers.py`` the encoder, the
two-tower model and the dense LMs use: RMSNorm (float32, eps 1e-6,
``:42-46``), RoPE in the split-halves convention (``:66-79``), GQA
attention with optional qkv bias and qk-norm (``AttnConfig``,
``_project_qkv`` + ``attn_apply``, ``:86-146``) and its one-token decode
against a KV cache (``attn_decode``, ``:149-171``), the SwiGLU MLP
(``:177-186``) and the plain MLP tower (``mlp_init`` / ``mlp_apply``,
``:189-210``), the group-local top-k MoE with shared experts (grok-1,
deepseek-v2-lite; ``MoEConfig`` / ``moe_init`` / ``_dispatch_group`` /
``moe_apply``, ``:218-358``) and MLA, DeepSeek-V2's multi-head latent
attention (``MLAConfig`` / ``mla_init`` / ``mla_apply`` and the absorbed
``mla_decode`` over the latent cache, ``:361-462``).

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
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import topk as _topk
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


# ---------------------------------------------------------------------------
# MoE: group-local top-k routing (sort-based dispatch, static shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """``repro/models/layers.py:221-236`` without ``group_axes`` /
    ``tp_axis`` (the reference's SPMD sharding knobs)."""
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    n_groups: int = 1            # routing groups, each dispatched alone

    def capacity(self, t_local: int) -> int:
        """Slots an expert has in a group of ``t_local`` tokens."""
        return max(self.top_k, int(self.capacity_factor * t_local
                                   * self.top_k / self.n_experts + 0.9999))


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32
             ) -> Params:
    """The router (d, E) in float32, the expert banks (E, d, f) / (E, f,
    d) normal x (1/d)^½, the shared experts one SwiGLU of width f x
    n_shared."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = (1.0 / d) ** 0.5

    def bank(n, din, dout):
        return (torch.randn((n, din, dout), generator=gen, device=gen.device)
                * scale).to(dtype)

    p: Params = {"router": dense_init(gen, d, e, torch.float32),
                 "w_gate": bank(e, d, f), "w_up": bank(e, d, f),
                 "w_down": bank(e, f, d)}
    if cfg.n_shared:
        p["shared"] = swiglu_init(gen, d, f * cfg.n_shared, dtype)
    return p


def _dispatch_group(x: torch.Tensor, logits: torch.Tensor, top_k: int,
                    capacity: int):
    """Sort-based dispatch of one routing group
    (``repro/models/layers.py:256-293``): x (T, d), logits (T, E) ->
    (dispatched (E, C, d), slot (T, k) of each (token, choice) in the
    expert-major (E·C) order, E·C where it was dropped, weights (E·C,)
    float32, aux ()).

    The router's top-k is ``lax.top_k``'s (ties to the smaller expert);
    the choices are sorted stably by expert and each expert keeps its
    first C; the rest are dropped (the reference's slot E·C, which its
    scatters drop: here it is one spare slot, cut off).  Slots no token
    fills gather the zero pad row T.  No host sync.
    """
    t, d = x.shape
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), -1)
    top_w, top_e = _topk.topk(probs, top_k)                       # (T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss (Switch): E · sum(frac_tokens · frac_probs)
    me = torch.nn.functional.one_hot(top_e[:, 0], e).float().mean(0)
    aux = e * (me * probs.mean(0)).sum()
    s = t * top_k
    dev = x.device
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev))    # (E,)
    pos = torch.arange(s, device=dev) - start[se]
    slot = torch.where(pos < capacity, se * capacity + pos, e * capacity)
    stok = torch.arange(t, device=dev).repeat_interleave(top_k)[order]
    gather_tok = torch.full((e * capacity + 1,), t, device=dev,
                            dtype=torch.long).scatter_(0, slot, stok)
    weights = torch.zeros(e * capacity + 1, device=dev).scatter_(
        0, slot, top_w.reshape(-1)[order])
    x_pad = torch.cat([x, x.new_zeros((1, d))], 0)
    dispatched = x_pad[gather_tok[:-1]].reshape(e, capacity, d)
    token_slot = torch.empty_like(slot).scatter_(0, order, slot)
    return dispatched, token_slot.reshape(t, top_k), weights[:-1], aux


class MoE(nn.Module):
    """``moe_apply``: x (B, S, d) -> (out (B, S, d), aux ()).

    The tokens split into ``n_groups`` routing groups of T = B·S /
    n_groups, each dispatched alone (``_dispatch_group``) with capacity
    ``cfg.capacity``; the router in float32; each expert's SwiGLU over
    its C slots as batched products (``torch.bmm``: the reference runs
    these in XLA); each slot's output times its router weight in the
    output dtype, then each token's kept slots summed in expert order in
    that dtype, as the reference's scatter-add adds them; the shared
    experts added after the cast.  aux is the groups' mean.
    """

    def __init__(self, cfg: MoEConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, frozen(params[name]))
        self.shared = SwiGLU(params["shared"]) if cfg.n_shared else None

    def forward(self, x: torch.Tensor, groups: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (out, aux), at ``groups`` routing groups
        (default ``cfg.n_groups``)."""
        cfg = self.cfg
        b, s, d = x.shape
        tokens = x.reshape(-1, d)
        g = cfg.n_groups if groups is None else groups
        if tokens.shape[0] % g:
            raise ValueError(f"{tokens.shape[0]} tokens do not split into "
                             f"{g} routing groups")
        t = tokens.shape[0] // g
        cap = cfg.capacity(t)
        xg = tokens.reshape(g, t, d)
        logits = xg.float() @ self.router
        outs, auxs = [], []
        for xl, ll in zip(xg, logits):
            dispatched, slot, weights, aux = _dispatch_group(
                xl, ll, cfg.top_k, cap)
            h = torch.bmm(dispatched, self.w_gate)
            u = torch.bmm(dispatched, self.w_up)
            y = torch.bmm(torch.nn.functional.silu(h) * u, self.w_down)
            y = y.reshape(-1, d) * weights[:, None].to(y.dtype)
            y = torch.cat([y, y.new_zeros((1, d))], 0)   # the dropped slot
            # each token's slots in expert order: the scatter-add's order
            by_expert = slot.sort(-1).values
            out = torch.zeros((t, d), dtype=y.dtype, device=x.device)
            for j in range(cfg.top_k):
                out = out + y[by_expert[:, j]]
            outs.append(out)
            auxs.append(aux)
        out = torch.stack(outs).reshape(b, s, d).to(x.dtype)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, torch.stack(auxs).mean()


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    d_head: int = 128            # nope part of qk, and v
    d_rope: int = 64             # decoupled rope key dim (shared per head)
    rope_theta: float = 10000.0


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype=torch.float32
             ) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dh, dr = cfg.d_head, cfg.d_rope
    return {"wq": dense_init(gen, d, h * (dh + dr), dtype),
            "w_dkv": dense_init(gen, d, r, dtype),        # x -> c_kv
            "w_krope": dense_init(gen, d, dr, dtype),     # decoupled k
            "w_uk": dense_init(gen, r, h * dh, dtype),    # c_kv -> k_nope
            "w_uv": dense_init(gen, r, h * dh, dtype),    # c_kv -> v
            "kv_norm": rmsnorm_init(r, gen.device, dtype),
            "wo": dense_init(gen, h * dh, d, dtype)}


class MLA(nn.Module):
    """MLA: ``forward`` is ``mla_apply`` (materialised K and V, the
    causal attention through ``ops.flash_attention`` at D = d_head +
    d_rope, Dv = d_head, or through ``attention`` where an instance sets
    it, as ``Attention`` does); ``decode`` is ``mla_decode``, the
    absorbed form over the latent cache (plain einsums in float32, as
    the reference runs them in XLA)."""

    attention: Optional[AttentionFn] = None

    def __init__(self, cfg: MLAConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for name in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"):
            setattr(self, name, frozen(params[name]))
        self.kv_norm = RMSNorm(params["kv_norm"])

    def _queries(self, x: torch.Tensor, positions: torch.Tensor):
        """q_nope (B, S, H, dh) and the roped q_rope (B, H, S, dr)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ self.wq).reshape(b, s, cfg.n_heads, cfg.d_head + cfg.d_rope)
        q_rope = apply_rope(q[..., cfg.d_head:].transpose(1, 2),
                            positions[:, None], cfg.rope_theta)
        return q[..., :cfg.d_head], q_rope

    def latents(self, x: torch.Tensor, positions: torch.Tensor):
        """What the cache keeps of x (B, S, d): c_kv (B, S, r) and the
        roped shared key k_rope (B, S, dr)."""
        c_kv = self.kv_norm(x @ self.w_dkv)
        k_rope = apply_rope((x @ self.w_krope)[:, None], positions[:, None],
                            self.cfg.rope_theta)[:, 0]
        return c_kv, k_rope

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d)."""
        return self.forward_kv(x, positions)[0]

    def forward_kv(self, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None):
        """``forward``, also returning the latents the prefill caches:
        (out (B, S, d), c_kv (B, S, r), k_rope (B, S, dr))."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, dh, dr = cfg.n_heads, cfg.d_head, cfg.d_rope
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q_nope, q_rope = self._queries(x, positions)
        c_kv, k_rope = self.latents(x, positions)
        k_nope = (c_kv @ self.w_uk).reshape(b, s, h, dh).transpose(1, 2)
        v = (c_kv @ self.w_uv).reshape(b, s, h, dh).transpose(1, 2)
        q_full = torch.cat([q_nope.transpose(1, 2), q_rope], -1)
        k_full = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, dr)],
                           -1)
        if self.attention is None:
            out = ops.flash_attention(q_full, k_full, v, causal=True,
                                      device=x.device)
        else:
            out = self.attention(q_full, k_full, v, causal=True)
        out = out.transpose(1, 2).reshape(b, s, h * dh)
        return out @ self.wo, c_kv, k_rope

    def decode(self, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, cache_len: torch.Tensor):
        """One-token absorbed decode: x (B, 1, d), caches (B, S, r) and
        (B, S, dr), cache_len (B,) the current fill.  Returns (out (B, 1,
        d), ckv_cache, krope_cache).

        The new latent and rope key go to position ``cache_len`` in
        place; a full row (cache_len >= S) writes nothing, as the
        reference's ``mode="drop"`` scatter.  Then q·k = (q_nope
        W_uk^T)·c_kv + q_rope·k_rope in float32 (the two einsums summed
        in that order) over the positions < cache_len + 1, the float32
        softmax, out = (attn·c_kv) W_uv.
        """
        cfg = self.cfg
        b = x.shape[0]
        h, dh, dr, r = cfg.n_heads, cfg.d_head, cfg.d_rope, cfg.kv_lora_rank
        s_max = ckv_cache.shape[1]
        positions = cache_len[:, None]
        q_nope, q_rope = self._queries(x, positions)
        c_kv, k_rope = self.latents(x, positions)
        keep = (cache_len < s_max)[:, None]
        pos = cache_len.clamp(max=s_max - 1).long()
        b_ix = torch.arange(b, device=x.device)
        for cache, new in ((ckv_cache, c_kv), (krope_cache, k_rope)):
            cache[b_ix, pos] = torch.where(keep, new[:, 0].to(cache.dtype),
                                           cache[b_ix, pos])
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                             self.w_uk.reshape(r, h, dh))
        ckv = ckv_cache.float()
        logits = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
                  + torch.einsum("bhr,bsr->bhs", q_rope[:, :, 0].float(),
                                 krope_cache.float()))
        logits = logits / torch.tensor((dh + dr) ** 0.5,
                                       dtype=torch.float32)
        mask = (torch.arange(s_max, device=x.device)[None]
                < (cache_len + 1)[:, None])
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
        o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(logits, -1), ckv)
        out = torch.einsum("bhr,rhd->bhd", o_lat,
                           self.w_uv.reshape(r, h, dh).float())
        out = out.reshape(b, 1, h * dh).to(x.dtype)
        return out @ self.wo, ckv_cache, krope_cache
