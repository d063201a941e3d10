"""Padding contract, shared-memory caps and merge plan of the CUDA kernels.

The Pallas kernels of the reference split their streamed axes by VMEM
bytes; the Hopper kernels in ``csrc/`` instead take a fixed number of
rows per thread block and mask the ragged edge themselves, so no
operand is padded in memory.  What stays is the power-of-two contract
of the top-k networks, the ADC block's LUT budget, and the plan of the
candidate merge (``merge_plan``): a query's sorted candidate lists are
folded in groups that fit one block's shared memory, pass after pass,
until one group is left.  ``ops.py`` and the launch modules ask this
module how to split, what fits and how many lists a merge block takes.
"""
from __future__ import annotations

from typing import List, Tuple

# Shared memory one thread block may use on Hopper (sm_90): 227 KB of
# the SM's 256 KB, above 48 KB only as opt-in dynamic shared memory.
SMEM_BLOCK_BYTES = 232_448
SMEM_DEFAULT_BYTES = 48 * 1024

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

# Largest grid y extent (the batch of the scan kernel).
MAX_GRID_Y = 65_535


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


def check_width(d: int) -> None:
    """The kernels read rows as float4 and stage queries in shared memory."""
    if d % 4:
        raise ValueError(f"d={d}: the kernels read rows as float4")
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
