"""Launch of the flash attention forward kernels (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention``,
the forward only).  As in ``fused_turn.py``: CUDA tensors only, every
operand checked (device, dtype, shape, layout), the output allocated
here, and the entry with its launch plan handed to ``launcher.run`` (one
launch on PyTorch's current stream without synchronising; a refused
launch raises).  The inputs are read in their own dtype, bfloat16 or
float32, and the output has it.  q, k and v may be strided views (a
transposed ``v`` from the model's projections is read in place) as long
as the head dim is contiguous and every row starts on 16 bytes
(``takes``).  D and Dv go up to 256 (MLA's prefill is D = 192, Dv =
128), each in a bucket of its own (``tiling.attn_bucket``).  The choice
between kernel and plain version belongs to ``ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import launcher, tiling

#: widest head dim (D and Dv) the kernel takes (csrc MAX_DIM)
MAX_DIM = tiling.ATTN_MAX_DIM
#: input dtypes the kernels read natively, and the C entry of each
ENTRIES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
#: the dtype's name in ``tiling.plan_flash_attention``
PLAN_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def takes(t: torch.Tensor) -> bool:
    """A 4-d operand whose layout the kernel reads as it is: the last dim
    contiguous, the other strides and the data 16-byte aligned."""
    vec = 16 // t.element_size()
    return (t.dim() == 4 and t.stride(-1) == 1
            and all(s % vec == 0 for s in t.stride()[:3])
            and launcher.aligned(t))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    launcher.check_device(name, t)
    if t.dtype != dtype or t.dim() != 4:
        raise ValueError(f"{name}: expected 4-d {dtype}, got {t.dim()}-d "
                         f"{t.dtype}")
    if not takes(t):
        raise ValueError(f"{name}: the head dim must be contiguous and every "
                         f"row 16-byte aligned (strides {t.stride()})")


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
    """Attention forward: (B, H, S, Dv) in the inputs' dtype (float32 or
    bfloat16, the same for q, k and v).  A B·H·S of 0 launches
    nothing."""
    if q.dtype not in ENTRIES:
        raise ValueError(f"q: dtype {q.dtype}, the kernels take "
                         f"{sorted(map(str, ENTRIES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype)
    check_shapes(q, k, v, causal=causal)
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    vec = 16 // q.element_size()
    if d > MAX_DIM or dv > MAX_DIM or d % vec or dv % vec:
        raise ValueError(f"head dims D={d}, Dv={dv}: at most {MAX_DIM} and "
                         f"multiples of {vec} ({q.dtype} rows are read 16 "
                         f"bytes at a time)")
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    plan = tiling.plan_flash_attention(b, h, s, d, dv, PLAN_DTYPE[q.dtype])
    warps = plan[0].block[0] // tiling.WARP if plan else 1
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    launcher.run(ENTRIES[q.dtype], plan, q.device, q, k, v, out, b, h, hkv,
                 s, skv, d, dv, int(causal), 1.0 / math.sqrt(d), warps,
                 strides)
    return out
