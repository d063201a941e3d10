"""Padding contract and shared-memory caps of the CUDA kernels.

The Pallas kernels of the reference split their streamed axes by VMEM
bytes; the Hopper kernels in ``csrc/`` instead take a fixed number of
rows per thread block and mask the ragged edge themselves, so no
operand is padded in memory.  What stays is the power-of-two contract
of the top-k networks and the per-block shared-memory budgets of the
merge kernel and the ADC block's LUT, which this module owns —
``ops.py`` and the launch modules ask it how to split and what fits.
"""
from __future__ import annotations

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
# two blocks cover a list of the smoke's Lmax 702, so the merge of the
# blocks' top-64 fits one block's shared memory (128 x 64 x 12 B).
PQ_ROWS = 512
# Codewords per subquantizer: codes are uint8.
MAX_CODES = 256

# Widest running top-k (r_pad) and probe set (np_pad) this slice's
# kernels take: each block keeps its top entries out of at most
# SCAN_ROWS / CENTROID_CHUNK candidates.
MAX_PAD = 64

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


def check_merge(n_lists: int, width: int) -> None:
    """Refuse a merge whose ``n_lists`` sorted lists of ``width`` entries
    would not fit one block's shared memory."""
    need = n_lists * width * MERGE_ENTRY_BYTES
    if need > SMEM_BLOCK_BYTES:
        raise ValueError(
            f"merging {n_lists} lists of {width} candidates needs {need} B "
            f"of shared memory; one block has {SMEM_BLOCK_BYTES}")


def check_width(d: int) -> None:
    """The kernels read rows as float4 and stage queries in shared memory."""
    if d % 4:
        raise ValueError(f"d={d}: the kernels read rows as float4")
    if d * 4 > SMEM_DEFAULT_BYTES or QTILE * d * 4 > SMEM_BLOCK_BYTES // 2:
        raise ValueError(f"d={d} is wider than the kernels stage in "
                         f"shared memory")


def check_pad(name: str, n: int) -> int:
    """Pad a top-k width to a power of two within the kernels' cap."""
    n_pad = next_pow2(n)
    if n_pad > MAX_PAD:
        raise ValueError(f"{name}={n} pads to {n_pad}; the CUDA kernels "
                         f"keep at most {MAX_PAD}")
    return n_pad
