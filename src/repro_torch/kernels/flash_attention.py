"""Launch of the flash attention forward kernels (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention``,
the forward; its backward is the plain version's VJP, ``ops.Attention``,
as the reference's is plain math).  As in ``fused_turn.py``: CUDA tensors only, every
operand checked (device, dtype, shape, layout), the output allocated
here, and the entry with its launch plan handed to ``launcher.run`` (one
launch on PyTorch's current stream without synchronising; a refused
launch raises).  The inputs are read in their own dtype, bfloat16 or
float32, and the output has it.  q, k and v may be strided views (a
transposed ``v`` from the model's projections is read in place) as long
as the head dim is contiguous and every row starts on 16 bytes
(``takes``).  D and Dv go up to 256 (MLA's prefill is D = 192, Dv =
128), each in a bucket of its own (``tiling.attn_bucket``).  A D or Dv
whose rows are not a multiple of 16 bytes (BST's D = 4 in bfloat16, f32
D = 2 or 6) is zero-padded to the next multiple (``padded_dims``): the
zeros add nothing to a dot product, the scale stays that of the true D,
and the output is sliced back to Dv.  The choice between kernel and
plain version belongs to ``ops.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import cost, launcher, tiling

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


def padded_dims(d: int, dv: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(D, Dv) as the kernel reads them: each rounded up to a multiple of
    16 bytes of ``dtype`` (rows are read 16 bytes at a time)."""
    vec = 16 // dtype.itemsize
    return -(-d // vec) * vec, -(-dv // vec) * vec


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    """t with its last dim zero-padded to ``width`` (t itself if it has
    that width)."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention forward: (B, H, S, Dv) in the inputs' dtype (float32 or
    bfloat16, the same for q, k and v).  A B·H·S of 0 launches
    nothing."""
    if q.dtype not in ENTRIES:
        raise ValueError(f"q: dtype {q.dtype}, the kernels take "
                         f"{sorted(map(str, ENTRIES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        launcher.check_device(name, t)
        if t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d {q.dtype}, got "
                             f"{t.dim()}-d {t.dtype}")
    check_shapes(q, k, v, causal=causal)
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if d > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv}: at most {MAX_DIM}")
    work = cost.attn_cost(q.shape, k.shape, v.shape, q.dtype, causal)
    dp, dvp = padded_dims(d, dv, q.dtype)
    q, k, v = _pad(q, dp), _pad(k, dp), _pad(v, dvp)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not takes(t):
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             f"every row 16-byte aligned (strides "
                             f"{t.stride()})")
    out = torch.empty((b, h, s, dvp), dtype=q.dtype, device=q.device)
    plan = tiling.plan_flash_attention(b, h, s, dp, dvp, PLAN_DTYPE[q.dtype])
    warps = plan[0].block[0] // tiling.WARP if plan else 1
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    launcher.count(ENTRIES[q.dtype], plan, work)
    launcher.run(ENTRIES[q.dtype], plan, q.device, q, k, v, out, b, h, hkv,
                 s, skv, dp, dvp, int(causal), 1.0 / math.sqrt(d), warps,
                 strides)
    return out if dvp == dv else out[..., :dv]
