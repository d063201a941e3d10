"""Launch of the flash attention forward kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention``,
the forward only).  As in ``fused_turn.py``: CUDA tensors only, every
operand checked (device, dtype, shape, contiguity), the output allocated
here, one launch on PyTorch's current stream without synchronising, and
a refused launch raises.  The choice between kernel and plain version
belongs to ``ops.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_turn import _raise_on

#: widest head dim (D and Dv) the kernel takes (csrc MAX_DIM)
MAX_DIM = 128


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"{name}: expected 4-d float32, got {t.dim()}-d "
                         f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool) -> None:
    """The shapes both versions take: q (B, H, S, D), k (B, Hkv, Skv, D),
    v (B, Hkv, Skv, Dv), Hkv dividing H, Skv >= 1, and S <= Skv when
    causal (a query row before the first key would have nothing to
    attend to: the reference's plain version gives NaN there and its
    Pallas kernel a tile-dependent mean)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d (B, heads, seq, dim)")
    b, h, s, d = q.shape
    bk, hkv, skv, dk = k.shape
    if bk != b or dk != d or tuple(v.shape[:3]) != (b, hkv, skv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"kv heads {hkv} must divide heads {h}")
    if skv < 1:
        raise ValueError("no keys")
    if causal and s > skv:
        raise ValueError(f"causal attention with S={s} > Skv={skv}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention forward: (B, H, S, Dv) float32.  A B·H·S of 0 launches
    nothing."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t)
    check_shapes(q, k, v, causal=causal)
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv}: at most {MAX_DIM}")
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _build.lib().flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            hkv, s, skv, d, dv, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_attention_f32")
    return out
