"""Launch of the decode attention kernel (``csrc/flash_decode.cu``).

Counterpart of ``repro/kernels/flash_attention.py`` ``flash_decode``
(one new token per row against a KV cache masked by ``cache_len``).  As
in ``fused_turn.py``: CUDA tensors only, every operand checked (device,
dtype, shape, contiguity, 16-byte rows), outputs and scratch allocated
here, the launches on PyTorch's current stream without synchronising,
and a refused launch raises.  The cache is read in its own dtype
(float32 or bfloat16); the query and the output are float32.  The
choice between kernel and plain version belongs to ``ops.py``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_turn import _raise_on
from repro_torch.kernels.tiling import MAX_GRID_Y, next_pow2

#: widest head dim the kernel takes (csrc MAX_DIM), and the widest GQA
#: group (query heads per kv head, csrc MAX_GROUP)
MAX_DIM = 128
MAX_GROUP = 8
#: cache dtypes the kernel reads natively, and its C entry for each
ENTRIES = {torch.float32: "flash_decode_f32",
           torch.bfloat16: "flash_decode_bf16"}


def decode_split(s: int) -> Tuple[int, int]:
    """(rows per split, splits) of a cache of ``s`` rows: about 64 splits
    of a power of two between 64 and 512 rows.  A function of ``s``
    alone, so the kernel's summation order does not depend on the batch
    or on ``cache_len``."""
    chunk = min(512, max(64, next_pow2(-(-s // 64))))
    return chunk, -(-s // chunk)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor) -> None:
    """q (B, H, D), k and v (B, Hkv, S, D) alike, Hkv dividing H, S >= 1,
    cache_len (B,), each >= 1 where it is read on the host (a CPU
    tensor; on the card it is the caller's contract)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, Hkv, S, D): q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    bk, hkv, s, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"kv heads {hkv} must divide heads {h}")
    if s < 1:
        raise ValueError("empty cache")
    if tuple(cache_len.shape) != (b,):
        raise ValueError(f"cache_len {tuple(cache_len.shape)}, want ({b},)")
    if cache_len.device.type == "cpu" and b and int(cache_len.min()) < 1:
        raise ValueError(f"cache_len must be >= 1 (a row with none attends "
                         f"to nothing), got {cache_len.tolist()}")


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if name != "cache_len" and t.data_ptr() % 16:
        raise ValueError(f"{name}: rows are read 16 bytes at a time and "
                         f"must be 16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """Decode attention: (B, H, D) float32.  q float32; k and v float32
    or bfloat16; cache_len int32, rows past min(cache_len, S) unread.  A
    B of 0 launches nothing."""
    check_shapes(q, k, v, cache_len)
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        _check(name, t)
    if len({q.device, k.device, v.device, cache_len.device}) != 1:
        raise ValueError("q, k, v and cache_len lie on different devices")
    if q.dtype != torch.float32 or cache_len.dtype != torch.int32:
        raise ValueError(f"q must be float32 and cache_len int32, got "
                         f"{q.dtype}, {cache_len.dtype}")
    if k.dtype not in ENTRIES or v.dtype != k.dtype:
        raise ValueError(f"k and v must both be one of "
                         f"{sorted(map(str, ENTRIES))}, got {k.dtype}, "
                         f"{v.dtype}")
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    vec = 16 // k.element_size()
    if d > MAX_DIM or d % vec:
        raise ValueError(f"head dim {d}: at most {MAX_DIM} and a multiple "
                         f"of {vec} ({k.dtype} rows are read 16 bytes at a "
                         f"time)")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"{h // hkv} query heads per kv head: the kernel "
                         f"holds at most {MAX_GROUP}")
    if b * hkv > MAX_GRID_Y:
        raise ValueError(f"B x Hkv = {b * hkv} > {MAX_GRID_Y} (grid y)")
    chunk, nsplit = decode_split(s)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    part = b * hkv * nsplit * (h // hkv)
    part_m = torch.empty(part, dtype=torch.float32, device=q.device)
    part_l = torch.empty(part, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(part * d, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        entry = ENTRIES[k.dtype]
        err = getattr(_build.lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            b, h, hkv, s, d, chunk, nsplit, 1.0 / math.sqrt(d),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, entry)
    return out
