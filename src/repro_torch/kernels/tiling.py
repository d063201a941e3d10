"""Padding contract, shared-memory caps, merge plan and launch plans of the
CUDA kernels.

The Pallas kernels of the reference split their streamed axes by VMEM
bytes; the Hopper kernels in ``csrc/`` instead take a fixed number of
rows per thread block and mask the ragged edge themselves, so no
operand is padded in memory.  What stays is the power-of-two contract
of the top-k networks, the ADC block's LUT budget, and the plan of the
candidate merge (``merge_plan``): a query's sorted candidate lists are
folded in groups that fit one block's shared memory, pass after pass,
until one group is left.  ``ops.py`` and the launch modules ask this
module how to split, what fits and how many lists a merge block takes.

The launch plans (``plan_*``, one per C entry of ``csrc/``) list the
kernels one call of an entry launches, each as a ``Launch`` (kernel,
grid, block, dynamic shared memory, opt-in), in launch order.  The
bindings hand an entry's plan to ``launcher.run``, which records it
under ``launcher.record_launches`` and launches the entry otherwise;
``repro_torch.analysis.kernel_budget`` checks the recorded plans
against the card's limits below, and ``chip_smoke.py`` ``[plans]``
holds them to the kernels a profiler sees on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# Shared memory one thread block may use on Hopper (sm_90): 227 KB of
# the SM's 256 KB, above 48 KB only as opt-in dynamic shared memory
# (cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...)).
SMEM_BLOCK_BYTES = 232_448
SMEM_DEFAULT_BYTES = 48 * 1024
# Threads of one block, the warp, and the grid's extents.
MAX_BLOCK_THREADS = 1024
WARP = 32
MAX_GRID_X = 2 ** 31 - 1

# Rows of one probed posting list scored by one block of the scan
# kernel, centroids and queries scored by one block of the stage-1
# kernel (must equal the constants of the same names in
# csrc/fused_turn.cu).
SCAN_ROWS = 128
CENTROID_CHUNK = 128
QTILE = 8

# Rows of one probed PQ list scored by one block of the ADC scan
# (csrc/pq_adc.cu PQ_ROWS): 512 rows are 24 KB of codes at m = 48, and
# two blocks cover a list of the smoke's Lmax 702.
PQ_ROWS = 512
# Codewords per subquantizer: codes are uint8.
MAX_CODES = 256

# Widest running top-k (r_pad), probe set (np_pad) and re-rank depth
# the kernels take (csrc/pq_adc.cu MAX_R): a scan block keeps its best
# min(r_pad, SCAN_ROWS) rows, a stage-1 block its best min(np_pad,
# CENTROID_CHUNK) centroids, and pads the rest of its list; the merge
# takes lists of this width (merge_group(2048) = 9 a block) and the
# re-rank block sorts this many candidates in dynamic shared memory
# (24 KB at 2,048, beside the query).  2,048 holds the quantised depth
# r = k x over = 2,000 at TREC CAsT's k = 1,000.
MAX_PAD = 2048

# One merge candidate in shared memory: value f32, id i32, position i32.
MERGE_ENTRY_BYTES = 12

# Largest grid y / z extent (y: the batch of the scan kernel).
MAX_GRID_Y = 65_535
MAX_GRID_Z = 65_535


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def scan_split(lmax: int) -> int:
    """Blocks per probed list: each takes ``SCAN_ROWS`` consecutive rows."""
    return max(1, -(-lmax // SCAN_ROWS))


def pq_split(lmax: int) -> int:
    """Blocks per probed PQ list: each takes ``PQ_ROWS`` consecutive rows."""
    return max(1, -(-lmax // PQ_ROWS))


def lut_bytes(m: int, n_codes: int) -> int:
    """Shared memory of one query's ADC lookup table, (m, n_codes) f32."""
    return m * n_codes * 4


def check_lut(m: int, n_codes: int) -> None:
    """The ADC block holds its query's whole LUT in shared memory beside
    the sort arrays of its ``PQ_ROWS`` scores; above 48 KB the LUT is
    opt-in dynamic shared memory (m = 48 x 256 codes is 49,152 B)."""
    if not 0 < n_codes <= MAX_CODES:
        raise ValueError(f"n_codes={n_codes}: codes are uint8, at most "
                         f"{MAX_CODES} codewords")
    need = lut_bytes(m, n_codes) + PQ_ROWS * MERGE_ENTRY_BYTES
    if m <= 0 or need > SMEM_BLOCK_BYTES:
        raise ValueError(f"an ADC block for m={m} x {n_codes} codes needs "
                         f"{need} B of shared memory; one block has "
                         f"{SMEM_BLOCK_BYTES}")


def centroid_chunks(p: int) -> int:
    return max(1, -(-p // CENTROID_CHUNK))


def merge_group(width: int) -> int:
    """Sorted lists of ``width`` candidates one merge block holds in
    shared memory (the ``group`` argument of csrc ``merge_topk_f32``)."""
    if not 0 < width <= MAX_PAD:
        raise ValueError(f"merge width {width}: the kernels keep at most "
                         f"{MAX_PAD}")
    return SMEM_BLOCK_BYTES // (width * MERGE_ENTRY_BYTES)


def merge_plan(n_lists: int, width: int) -> List[Tuple[int, int]]:
    """The passes of the candidate merge, as (lists in, groups out) per
    query: each pass merges groups of up to ``merge_group(width)``
    consecutive lists into each group's best ``width``, in place, until
    a pass has one group (its output is the query's top ``width``).
    Every pass ranks by (value desc, flat position asc), so the result
    is a one-block merge's, bit for bit."""
    if n_lists < 1:
        raise ValueError(f"n_lists={n_lists}")
    group = merge_group(width)
    passes, n = [], n_lists
    while True:
        groups = -(-n // group)
        passes.append((n, groups))
        if groups == 1:
            return passes
        n = groups


def check_width(d: int, elem_bytes: int = 4) -> None:
    """The kernels read rows 16 bytes a lane (float4, or 8 bfloat16
    values for ``elem_bytes`` 2) and stage queries as float32 in shared
    memory."""
    if (d * elem_bytes) % 16:
        raise ValueError(f"d={d}: the kernels read rows of {elem_bytes}-byte "
                         f"values 16 bytes at a time (float4, or 8 "
                         f"bfloat16)")
    if d * 4 > SMEM_DEFAULT_BYTES or QTILE * d * 4 > SMEM_BLOCK_BYTES // 2:
        raise ValueError(f"d={d} is wider than the kernels stage in "
                         f"shared memory")


def check_pad(name: str, n: int) -> int:
    """Pad a top-k width to a power of two within the kernels' cap
    (top-k past 2,048 is ROADMAP Queue 3)."""
    n_pad = next_pow2(n)
    if n_pad > MAX_PAD:
        raise ValueError(f"{name}={n} pads to {n_pad}; the CUDA kernels "
                         f"keep at most {MAX_PAD} (top-k past 2,048: "
                         f"ROADMAP Queue 3)")
    return n_pad


# ---------------------------------------------------------------------------
# int8 scale groups
#
# The int8 contract (``repro/kernels/fused_turn.py`` ``score_tile``)
# quantises a query with one scale per row and the scored operand with
# one scale per tile of the reference's Pallas grid: ``blk_p`` rows of
# the zero-padded centroids (``repro/kernels/tiling.py``
# ``centroid_tile``) and ``blk_l``-row sub-tiles of each posting list
# zero-padded to ``lpad`` (``list_tile``, byte-capped by the 4 MiB tile
# budget, never narrower than the candidate depth).  Those groups are
# part of the numbers, not of the CUDA tiling, so the port keeps the
# reference's policy and constants here; the kernels reduce each group's
# largest |x| before they score (csrc/fused_turn.cu).
# ---------------------------------------------------------------------------

#: bytes of one streamed list tile in the reference (its VMEM slice)
GROUP_TILE_BYTES = 4 * 1024 * 1024
#: most rows of a list group, and rows of a centroid group
GROUP_MAX_ROWS = 2048
CENTROID_GROUP_ROWS = 512


def _pow2_floor(n: int) -> int:
    return max(next_pow2(n + 1) // 2, 1)


def list_groups(lmax: int, d: int, r_pad: int) -> Tuple[int, int]:
    """``(blk_l, n_groups)``: rows of one int8 scale group of a posting
    list of float32 rows of width d, and groups per list (``lpad //
    blk_l`` of the reference's ``list_tile(lmax, 4 d, kp=r_pad)``)."""
    lpad = next_pow2(lmax)
    blk = min(lpad, GROUP_MAX_ROWS,
              _pow2_floor(GROUP_TILE_BYTES // max(4 * d, 1)))
    blk = max(blk, r_pad)
    return blk, -(-lpad // blk)


def centroid_groups(p: int, np_pad: int) -> Tuple[int, int]:
    """``(blk_p, n_groups)``: centroids of one int8 scale group and
    groups over the p centroids (the reference's ``centroid_tile(p,
    np_pad, blk_p=512)``)."""
    blk = max(min(CENTROID_GROUP_ROWS, next_pow2(p)), np_pad)
    return blk, -(-p // blk)


# ---------------------------------------------------------------------------
# launch plans
#
# Threads of each kernel's block and static shared memory of each kernel
# (must equal csrc/: ROW_THREADS, MERGE_THREADS, RERANK_THREADS,
# ADC_THREADS, the decode kernels' THREADS and MMA_WARPS, embedding_bag's
# WARPS and the __shared__ arrays each kernel declares; the tensor-core
# attention kernels keep everything in dynamic shared memory).
# ---------------------------------------------------------------------------

ROW_THREADS = 256
MERGE_THREADS = 512
RERANK_THREADS = 512
ADC_THREADS = 256
ATTN_BKV = 64              # keys of a flash_attention kv tile
ATTN_WARP_ROWS = 16        # query rows of one of its warps
DECODE_THREADS = 256       # the float32-cache split kernel
DECODE_MAX_GROUP = 8
DECODE_MMA_WARPS = 4       # decode_mma_kernel (bfloat16 cache)
DECODE_STAGES = 3          # its ring of 16-row K and V sub-tiles a warp
DECODE_SUB = 16
DECODE_FOLD_HEAD = 32      # floats before its fold arrays
# SMs of the H100 SXM: flash_attention takes 4-warp blocks only when that
# still gives every SM a block
SMS = 132
BAG_WARPS = 4              # bags of an embedding_bag block

STATIC_SMEM: Dict[str, int] = {
    # sv / si / sp [QTILE][CENTROID_CHUNK]
    "centroid_chunk_kernel": 3 * QTILE * CENTROID_CHUNK * 4,
    # sv / si / sp [SCAN_ROWS]
    "scan_lists_kernel": 3 * SCAN_ROWS * 4,
    # sv / si / sp [PQ_ROWS]
    "adc_scan_kernel": 3 * PQ_ROWS * 4,
    # p_s[MAX_GROUP][MAX_CHUNK], m_s and l_s [MAX_GROUP]
    "decode_split_kernel": DECODE_MAX_GROUP * 512 * 4 + 2 * DECODE_MAX_GROUP * 4,
    "decode_combine_kernel": DECODE_MAX_GROUP * 4,
    "merge_kernel": 0, "rerank_kernel": 0, "list_amax_kernel": 0,
    "centroid_amax_kernel": 0, "flash_bf16_kernel": 0,
    "flash_tf32_kernel": 0, "decode_mma_kernel": 0,
    "embedding_bag_kernel": 0,
}
# The int8 instances keep the arrays of their scale reductions (sq[QTILE],
# red[32]); the compiler drops them from the f32 and bf16 instances.
INT8_STATIC_SMEM: Dict[str, int] = {
    "centroid_chunk_kernel": QTILE * 4, "scan_lists_kernel": 32 * 4,
    "adc_scan_kernel": 32 * 4,
}

Dim3 = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a C entry: the kernel's name in ``csrc/``,
    its grid and block, the dynamic shared memory it asks for, and
    whether the entry raised the kernel's dynamic shared-memory cap
    first (``opt_in``: cudaFuncSetAttribute, else 48 KB is the cap),
    and the static shared memory of the kernel's instance."""

    kernel: str
    grid: Dim3
    block: Dim3
    dyn_smem_bytes: int
    opt_in: bool
    static_smem_bytes: int = 0

    @property
    def smem_bytes(self) -> int:
        """Static plus dynamic shared memory of one block."""
        return self.static_smem_bytes + self.dyn_smem_bytes


def _launch(kernel: str, grid, threads: int, smem: int, opt_in: bool,
            precision: str = "f32") -> Launch:
    g = tuple(grid) + (1,) * (3 - len(tuple(grid)))
    static = STATIC_SMEM[kernel] + (INT8_STATIC_SMEM.get(kernel, 0)
                                    if precision == "int8" else 0)
    return Launch(kernel, g, (threads, 1, 1), smem, opt_in, static)


def plan_merge(b: int, n_lists: int, w: int) -> List[Launch]:
    """``merge_topk_f32``: one ``merge_kernel`` per pass of
    ``merge_plan``, each asking for the shared memory of the first
    pass's groups."""
    group = merge_group(w)
    smem = min(n_lists, group) * w * MERGE_ENTRY_BYTES
    return [_launch("merge_kernel", (b, groups), MERGE_THREADS, smem, True)
            for _, groups in merge_plan(n_lists, w)]


def plan_select(b: int, p: int, d: int, np_pad: int, precision: str
                ) -> List[Launch]:
    """Stage 1 (``select_probes``): the int8 centroid amax pass, the
    chunk blocks, the merge to np_pad."""
    n = centroid_chunks(p)
    amax = ([_launch("centroid_amax_kernel", (n,), ROW_THREADS, 0, False)]
            if precision == "int8" else [])
    return amax + [_launch("centroid_chunk_kernel", (n, -(-b // QTILE)),
                           ROW_THREADS, QTILE * d * 4, True, precision)
                   ] + plan_merge(b, n, np_pad)


def plan_rerank(b: int, d: int, r_pad: int) -> List[Launch]:
    """``rerank_rows``: one block per query, the query and the r_pad
    sort entries in dynamic shared memory."""
    return [_launch("rerank_kernel", (b,), RERANK_THREADS,
                    d * 4 + r_pad * MERGE_ENTRY_BYTES, True)]


def plan_fused_scan_ivf(b: int, nprobe: int, lmax: int, d: int,
                        precision: str, r_pad: int) -> List[Launch]:
    """``fused_scan_ivf``: the int8 list amax pass, the scan blocks, the
    merge to r_pad, and the quantised paths' float32 re-rank."""
    if b == 0:
        return []
    grid = (nprobe * scan_split(lmax), b)
    amax = ([_launch("list_amax_kernel", grid, ROW_THREADS, 0, False)]
            if precision == "int8" else [])
    rerank = plan_rerank(b, d, r_pad) if precision != "f32" else []
    return (amax + [_launch("scan_lists_kernel", grid, ROW_THREADS, d * 4,
                            True, precision)]
            + plan_merge(b, grid[0], r_pad) + rerank)


def plan_fused_turn_ivf(b: int, p: int, nprobe: int, np_pad: int, lmax: int,
                        d: int, precision: str, r_pad: int) -> List[Launch]:
    if b == 0:
        return []
    return (plan_select(b, p, d, np_pad, precision)
            + plan_fused_scan_ivf(b, nprobe, lmax, d, precision, r_pad))


def plan_adc(b: int, nprobe: int, lmax: int, m: int, n_codes: int,
             r_pad: int, precision: str = "f32") -> List[Launch]:
    """``adc_scan_merge``: the ADC blocks (the LUT in dynamic shared
    memory) and the merge to r_pad."""
    if b == 0:
        return []
    grid = (nprobe * pq_split(lmax), b)
    return ([_launch("adc_scan_kernel", grid, ADC_THREADS,
                     lut_bytes(m, n_codes), True, precision)]
            + plan_merge(b, grid[0], r_pad))


def plan_fused_scan_pq(b: int, nprobe: int, lmax: int, m: int, n_codes: int,
                       d: int, r_pad: int, rerank: bool, precision: str
                       ) -> List[Launch]:
    if b == 0:
        return []
    return (plan_adc(b, nprobe, lmax, m, n_codes, r_pad, precision)
            + (plan_rerank(b, d, r_pad) if rerank else []))


def plan_fused_turn_pq(b: int, p: int, nprobe: int, np_pad: int, lmax: int,
                       m: int, n_codes: int, d: int, precision: str,
                       r_pad: int) -> List[Launch]:
    if b == 0:
        return []
    return (plan_select(b, p, d, np_pad, precision)
            + plan_fused_scan_pq(b, nprobe, lmax, m, n_codes, d, r_pad, True,
                                 precision))


def plan_centroid_topk(b: int, p: int, d: int, kp: int) -> List[Launch]:
    """``centroid_topk``: stage 1 at float32, its top kp."""
    return plan_select(b, p, d, kp, "f32") if b else []


def plan_ivf_scan(b: int, nprobe: int, lmax: int, d: int, kp: int
                  ) -> List[Launch]:
    """``ivf_scan``: the float32 scan and its merge to kp."""
    return plan_fused_scan_ivf(b, nprobe, lmax, d, "f32", kp)


def attn_bucket(d: int, dv: int) -> int:
    """The head-dim bucket a flash_attention instance is built for: the
    tiles hold 64 or 128 columns, zero-filled past D and Dv."""
    return 64 if max(d, dv) <= 64 else 128


def attn_warps(b: int, h: int, s: int) -> int:
    """Warps (16 query rows each) of a flash_attention block: 4 when
    64-row blocks still cover the SMs, else 1 (Dragon at B = 1: 192
    one-warp blocks rather than 48)."""
    rows = 4 * ATTN_WARP_ROWS
    return 4 if b * h * -(-s // rows) >= SMS else 1


def plan_flash_attention(b: int, h: int, s: int, d: int, dv: int,
                         dtype: str = "f32") -> List[Launch]:
    """``flash_attention_bf16`` / ``_f32``: one block of 1 or 4 warps
    per (row x head, 16 queries a warp); a ring of 64-key K and V tiles
    in dynamic shared memory, rows padded (bf16: three stages, D + 8
    both; f32: two stages, K D + 8, V D + 4, in the bucket's D)."""
    if b * h * s == 0:
        return []
    db = attn_bucket(d, dv)
    if dtype == "bf16":
        kernel, smem = "flash_bf16_kernel", 3 * ATTN_BKV * 2 * (db + 8) * 2
    elif dtype == "f32":
        kernel, smem = ("flash_tf32_kernel",
                         2 * ATTN_BKV * ((db + 8) + (db + 4)) * 4)
    else:
        raise ValueError(f"dtype {dtype!r}: 'f32' or 'bf16'")
    warps = attn_warps(b, h, s)
    return [_launch(kernel, (b * h, -(-s // (ATTN_WARP_ROWS * warps))),
                    warps * WARP, smem, True)]


def decode_split(s: int) -> Tuple[int, int]:
    """(rows per split, splits) of a cache of ``s`` rows: about 64 splits
    of a power of two between 64 and 512 rows.  A function of ``s``
    alone, so the decode kernel's summation order does not depend on
    the batch or on ``cache_len``."""
    chunk = min(512, max(64, next_pow2(-(-s // 64))))
    return chunk, -(-s // chunk)


def decode_mma_smem(d: int, group: int, nsplit: int) -> int:
    """Dynamic shared memory of ``decode_mma_kernel`` (csrc mma_smem):
    the warps' rings of 16-row K and V sub-tiles (head dim padded to ks
    16, rows to ks 16 + 8), or the fold arrays after them: the four
    warps' (m, l, weight, acc) or the splits' weights, the larger."""
    ks = next(k for k in (1, 2, 4, 8) if d <= 16 * k)
    ring = DECODE_STAGES * DECODE_MMA_WARPS * 2 * DECODE_SUB * (
        16 * ks + 8) * 2
    warps = (DECODE_FOLD_HEAD + 3 * DECODE_MMA_WARPS * DECODE_MAX_GROUP
             + DECODE_MMA_WARPS * DECODE_MAX_GROUP * 16 * ks)
    splits = DECODE_FOLD_HEAD + group * nsplit
    return max(ring, 4 * max(warps, splits))


def plan_flash_decode(b: int, h: int, hkv: int, s: int, d: int,
                      cache: str = "f32") -> List[Launch]:
    """``flash_decode_bf16``: ``decode_mma_kernel``, one 4-warp block per
    (split, row x kv head), the splits folded in the launch.
    ``flash_decode_f32``: the split kernel (the group's fold in dynamic
    shared memory, G = the group's power-of-two bucket) and the combine
    kernel."""
    if b == 0:
        return []
    group = h // hkv
    _, nsplit = decode_split(s)
    if cache == "bf16":
        smem = decode_mma_smem(d, group, nsplit)
        if smem > SMEM_BLOCK_BYTES:
            raise ValueError(f"S={s}: {nsplit} splits of {group} queries "
                             f"need {smem} B of shared memory to fold")
        return [_launch("decode_mma_kernel", (nsplit, b * hkv),
                        DECODE_MMA_WARPS * WARP, smem, True)]
    if cache != "f32":
        raise ValueError(f"cache {cache!r}: 'f32' or 'bf16'")
    g = next_pow2(group)
    threads = -(-max(group * d, WARP * group) // WARP) * WARP
    return [_launch("decode_split_kernel", (nsplit, b * hkv), DECODE_THREADS,
                    DECODE_THREADS // WARP * g * d * 4, True),
            _launch("decode_combine_kernel", (b * hkv,), threads,
                    group * nsplit * 4, True)]


def plan_embedding_bag(b: int) -> List[Launch]:
    """``embedding_bag_f32``: one warp a bag, no shared memory."""
    return ([_launch("embedding_bag_kernel", (-(-b // BAG_WARPS),),
                     BAG_WARPS * WARP, 0, False)] if b else [])
