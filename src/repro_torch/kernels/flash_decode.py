"""Launch of the decode attention kernel (``csrc/flash_decode.cu``).

Counterpart of ``repro/kernels/flash_attention.py`` ``flash_decode``
(one new token per row against a KV cache masked by ``cache_len``).  As
in ``fused_turn.py``: CUDA tensors only, every operand checked (device,
dtype, shape, contiguity, 16-byte rows), outputs and scratch allocated
here, and the entry with its launch plan handed to ``launcher.run``
(the launches on PyTorch's current stream without synchronising; a
refused launch raises).  The cache is read in its own dtype (float32
or bfloat16).  A bfloat16 cache takes a bfloat16 query (bfloat16
output) or a float32 one (float32 output); a float32 cache takes a
float32 query.  The choice between kernel and plain version belongs
to ``ops.py``.

The bfloat16 entry folds its splits in the launch itself: the last
block of each (row, kv head) to arrive folds them, told so by an
arrival counter that it resets to 0.  The counters live in a zeroed
int32 buffer kept per device and stream (``launcher.arrival_counters``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import launcher, tiling
from repro_torch.kernels.tiling import MAX_GRID_Y, decode_split

#: widest head dim the kernel takes (csrc MAX_DIM), and the widest GQA
#: group (query heads per kv head, csrc MAX_GROUP)
MAX_DIM = 128
MAX_GROUP = 8
#: cache dtypes the kernel reads natively, and its C entry for each
ENTRIES = {torch.float32: "flash_decode_f32",
           torch.bfloat16: "flash_decode_bf16"}
#: query dtypes each cache dtype takes
Q_DTYPES = {torch.float32: (torch.float32,),
            torch.bfloat16: (torch.bfloat16, torch.float32)}

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
    launcher.check_device(name, t)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if name != "cache_len" and not launcher.aligned(t):
        raise ValueError(f"{name}: rows are read 16 bytes at a time and "
                         f"must be 16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """Decode attention: (B, H, D), bfloat16 for a bfloat16 q, else
    float32.  k and v float32 or bfloat16 (``Q_DTYPES`` names the q
    each takes); cache_len int32, rows past min(cache_len, S) unread.  A
    B of 0 launches nothing."""
    check_shapes(q, k, v, cache_len)
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        _check(name, t)
    if len({q.device, k.device, v.device, cache_len.device}) != 1:
        raise ValueError("q, k, v and cache_len lie on different devices")
    if k.dtype not in ENTRIES or v.dtype != k.dtype:
        raise ValueError(f"k and v must both be one of "
                         f"{sorted(map(str, ENTRIES))}, got {k.dtype}, "
                         f"{v.dtype}")
    if q.dtype not in Q_DTYPES[k.dtype] or cache_len.dtype != torch.int32:
        raise ValueError(f"a {k.dtype} cache takes q in "
                         f"{[str(t) for t in Q_DTYPES[k.dtype]]} and "
                         f"cache_len int32, got {q.dtype}, {cache_len.dtype}")
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
    bf16 = k.dtype == torch.bfloat16
    plan = tiling.plan_flash_decode(b, h, hkv, s, d,
                                    "bf16" if bf16 else "f32")
    out_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    out = torch.empty((b, h, d), dtype=out_dtype, device=q.device)
    part = b * hkv * nsplit * (h // hkv)
    part_m = torch.empty(part, dtype=torch.float32, device=q.device)
    part_l = torch.empty(part, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(part * d, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d)
    if not bf16:
        launcher.run(ENTRIES[k.dtype], plan, q.device, q, k, v, cache_len, b,
                     h, hkv, s, d, chunk, nsplit, scale, part_m, part_l,
                     part_acc, out)
        return out
    counter = launcher.arrival_counters(q.device, b * hkv) if b else None
    launcher.run(ENTRIES[k.dtype], plan, q.device, q,
                 int(q.dtype == torch.bfloat16), k, v, cache_len, b, h, hkv,
                 s, d, chunk, nsplit, scale, part_m, part_l, part_acc,
                 counter, out)
    return out
