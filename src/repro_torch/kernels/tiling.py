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
from typing import Dict, List, Optional, Tuple

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
# kernel, centroids scored by one block of the stage-1 kernel, and the
# stage-1 query tiles: 8 queries a block at B <= 8, else 32 (the table
# read once per call up to B = 32) while 32 staged queries fit one block
# (d <= QTILE_WIDE_MAX_D); must equal the constants of the same names in
# csrc/ivf_stages.cuh.
SCAN_ROWS = 128
CENTROID_CHUNK = 128
QTILE = 8
QTILE_WIDE = 32
QTILE_WIDE_MAX_D = 1536
# Fold the scan's lists inside its own launch (csrc scan_lists_kernel and
# adc_scan_kernel with arrival counters, csrc/fold.cuh) when the query's
# top r_pad is at most one slice wide and the fold's lists take at most
# this much shared memory a block (over the staged query or LUT);
# otherwise merge_kernel follows the scan.
FOLD_SMEM_BYTES = 64 * 1024
# Fold stage 1's chunk lists inside its launch (csrc centroid_chunk_kernel
# with arrival counters) when its query tiles hold at most this many
# queries: the tile's last block merges them one after another, where
# merge_kernel merges them on a block each.
SELECT_FOLD_QUERIES = 1
# Chunks whose lists the stage-1 fold merges first (csrc SELECT_GROUP).
SELECT_GROUP = 16

# Rows of one probed PQ list scored by one block of the ADC scan
# (csrc/pq_adc.cu ADC_ROWS, fold.cuh SLICE_ROWS): a query's 64 lists of
# the smoke's Lmax 702 are 384 blocks, and a block's 128 rows sort in one
# warp's registers as the IVF scan's do.
PQ_ROWS = 128
# The smallest batch whose ADC blocks land the LUT by one bulk copy each
# (csrc/pq_adc.cu ADC_BULK_MIN_B, the kernel instance BULK; the LUT whole
# 16-byte pieces, the tables 16-byte aligned as the allocator gives
# them): below it few tables serve all blocks, and staging them by the
# block's threads measured faster there (chip_smoke.py --adc-times, rows
# 3, 5 and 7 at every precision: the bulk copy wins every row from B =
# 8, the staging 12 of the 14 row-batches at B = 2 and 4; PERF.md
# section 6).  The bulk instance's mbarrier adds ADC_BULK_SMEM bytes of
# static shared memory (8 that the build lays out in 16).
ADC_BULK_MIN_B = 8
ADC_BULK_SMEM = 16
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
    the selection arrays of its ``PQ_ROWS`` scores; above 48 KB the LUT is
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


def centroid_qtile(b: int, d: int) -> int:
    """Queries of one stage-1 block (``csrc`` launch_chunks)."""
    return QTILE if b <= QTILE or d > QTILE_WIDE_MAX_D else QTILE_WIDE


def scan_fold(nprobe: int, lmax: int, r_pad: int) -> bool:
    """Whether a scan launch (the IVF scan, or the ADC scan: slices of the
    same ``SCAN_ROWS`` == ``PQ_ROWS`` rows) folds a query's lists itself:
    r_pad within one slice's rows, and the fold's largest merge
    (max(slices, probes) lists of r_pad) within ``FOLD_SMEM_BYTES``.
    The quantised IVF scan and the ADC scan with a re-rank then re-rank
    in the same launch."""
    return (r_pad <= SCAN_ROWS and max(scan_split(lmax), nprobe) * r_pad
            * MERGE_ENTRY_BYTES <= FOLD_SMEM_BYTES)


def select_groups(p: int) -> int:
    """Groups of ``SELECT_GROUP`` chunks the stage-1 fold merges first."""
    return -(-centroid_chunks(p) // SELECT_GROUP)


def select_fold_smem(p: int, np_pad: int) -> int:
    """Shared memory of stage 1's fold: the larger level's lists of
    np_pad, a group's chunks or the groups."""
    return max(SELECT_GROUP, select_groups(p)) * np_pad * MERGE_ENTRY_BYTES


def select_counters(b: int, p: int, d: int) -> int:
    """Arrival counters of stage 1's fold: a tile's groups, then a tile."""
    return -(-b // centroid_qtile(b, d)) * (select_groups(p) + 1)


def select_fold(b: int, p: int, d: int, np_pad: int) -> bool:
    """Whether stage 1 folds its chunk lists in its own launch (csrc
    centroid_chunk_kernel with arrival counters, two levels of
    merge_warps: groups of ``SELECT_GROUP`` chunks, then the groups):
    lists of np_pad <= 128 (a chunk's whole list; the top-h cache's
    growing merge stays merge_kernel's), tiles of at most
    ``SELECT_FOLD_QUERIES`` queries, and the fold's lists within one
    block's shared memory beside the instance's static arrays."""
    qt = centroid_qtile(b, d)
    return (np_pad <= CENTROID_CHUNK
            and min(b, qt) <= SELECT_FOLD_QUERIES
            and select_fold_smem(p, np_pad) + centroid_static(qt, "int8")
            <= SMEM_BLOCK_BYTES)


def merge_group(width: int) -> int:
    """Sorted lists of ``width`` candidates one merge block holds in
    shared memory (csrc ``merge_topk_f32``'s later passes)."""
    if not 0 < width <= MAX_PAD:
        raise ValueError(f"merge width {width}: the kernels keep at most "
                         f"{MAX_PAD}")
    return SMEM_BLOCK_BYTES // (width * MERGE_ENTRY_BYTES)


def merge_groups(w_in: int, width: int) -> Tuple[int, int]:
    """(first, later): lists one merge block takes in its first pass, of
    ``w_in`` entries toward the best ``width``, and in the later passes,
    of ``width`` (csrc fused_common merge_groups): as many as fit one
    block's shared memory, except that a first pass whose lists grow
    (``w_in < width``: csrc topk_tie merge_grow, with room for one list
    of ``width``) takes 2 width / w_in of them, so its groups spread over
    blocks and each grows into two lists of ``width``."""
    later = merge_group(width)
    if not 0 < w_in <= width:
        raise ValueError(f"merge of lists of {w_in} into {width}")
    entries = SMEM_BLOCK_BYTES // MERGE_ENTRY_BYTES
    if w_in == width:
        return entries // w_in, later
    return min((entries - width) // w_in, max(2, 2 * width // w_in)), later


def merge_plan(n_lists: int, width: int, w_in: int = 0
               ) -> List[Tuple[int, int]]:
    """The passes of the candidate merge, as (lists in, groups out) per
    query: the first pass merges groups of ``merge_groups(w_in,
    width)[0]`` consecutive lists of ``w_in`` (default ``width``)
    entries into each group's best ``width``, each later pass groups of
    ``merge_group(width)``, until a pass has one group (its output is
    the query's top ``width``).  Every pass ranks by (value desc, flat
    position asc), so the result is a one-block merge's, bit for bit."""
    if n_lists < 1:
        raise ValueError(f"n_lists={n_lists}")
    group, later = merge_groups(w_in or width, width)
    passes, n = [], n_lists
    while True:
        groups = -(-n // group)
        passes.append((n, groups))
        if groups == 1:
            return passes
        n, group = groups, later


def merge_smem(n_lists: int, width: int, w_in: int = 0) -> int:
    """Dynamic shared memory every pass of the merge asks for: the
    largest pass's (csrc merge_topk_f32)."""
    w_in = w_in or width
    first, later = merge_groups(w_in, width)
    spare = width if w_in < width else 0
    passes = merge_plan(n_lists, width, w_in)
    smem = (min(n_lists, first) * w_in + spare) * MERGE_ENTRY_BYTES
    if len(passes) > 1:
        smem = max(smem, min(passes[1][0], later) * width
                   * MERGE_ENTRY_BYTES)
    return smem


def merge_scratch(n_lists: int, width: int, w_in: int) -> int:
    """Entries a query's merge needs past its ``n_lists * w_in`` input
    entries: the first pass's groups of ``width`` when the width grows
    and one pass is not enough (else it merges in place)."""
    passes = merge_plan(n_lists, width, w_in)
    return passes[0][1] * width if w_in < width and len(passes) > 1 else 0


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


def check_hnsw(d: int, ef: int, degree: int, k: int) -> None:
    """The HNSW kernel's caps (ROADMAP Queue 3, item 4): a beam of at most
    ``HNSW_MAX_EF`` entries, at most ``HNSW_MAX_DEGREE`` neighbours a
    node, k <= ef, and a query row the retrieval kernels' width
    (``check_width``)."""
    if not 1 <= ef <= HNSW_MAX_EF:
        raise ValueError(f"ef={ef}: the HNSW kernel keeps a beam of 1 to "
                         f"{HNSW_MAX_EF} entries (ROADMAP Queue 3, item 4)")
    if degree > HNSW_MAX_DEGREE:
        raise ValueError(f"degree {degree}: the HNSW kernel expands at most "
                         f"{HNSW_MAX_DEGREE} neighbours a node (ROADMAP "
                         f"Queue 3, item 4)")
    if not 1 <= k <= ef:
        raise ValueError(f"k={k}: the HNSW kernel returns 1 to ef={ef} "
                         f"results (ROADMAP Queue 3, item 4)")
    try:
        check_width(d)
    except ValueError as e:
        raise ValueError(f"{e} (ROADMAP Queue 3, item 4)") from None


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
# reference's policy and constants here.  A group's largest |x| depends
# on the index and the group size only, not on the query: one pass over
# the whole table (csrc/fused_turn.cu group_amax, ``plan_group_amax``)
# computes every group's, and ``ops`` keeps the result per index tensor.
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
# bag_rows_kernel (csrc/embedding_bag.cu SLICE, ROWS_CHUNK): columns of
# one block's slice of a bag (a lane each), and rows it stages at once
BAG_SLICE = 32
BAG_ROWS_CHUNK = 64
# The largest B that takes bag_rows_kernel; larger batches take one warp
# a bag.  Set from chip_smoke.py --bag-times (both kernels forced on the
# two-tower table, L = 50; NVIDIA H100 80GB HBM3, 700 W; PERF.md section
# 6): 0.0199 against 0.0213 ms at B = 512, 0.0529 against 0.0505 at
# 2,048 and 0.1588 against 0.1565 at 8,192.
BAG_ROWS_MAX_B = 512
# hnsw_search_kernel (csrc/hnsw_search.cu THREADS, MAX_EF, MAX_DEGREE):
# one block a query; the beam's entries and a step's new neighbours are
# each a thread's in the merge
HNSW_THREADS = 256
HNSW_MAX_EF = 256
HNSW_MAX_DEGREE = 256
# Its visited sets (csrc/hnsw_search.cu V_*, in code order): a bitmap of
# n bits or an open-addressed hash of ids in shared memory, or a bitmap
# in global scratch; the hash is sized for a search's most ids at a load
# of at most HNSW_HASH_LOAD (11/20), so its probes stay short
HNSW_VISITED = ("bitmap", "hash", "global")
HNSW_HASH_LOAD = (11, 20)
# shards of row-sharded vectors its sharded instance reads
# (csrc/hnsw_search.cu MAX_SHARDS)
HNSW_MAX_SHARDS = 8

STATIC_SMEM: Dict[str, int] = {
    # sv [QTILE][CENTROID_CHUNK + 1] (the 8-query instance;
    # centroid_static gives the 32-query one's)
    "centroid_chunk_kernel": QTILE * (CENTROID_CHUNK + 1) * 4,
    # sv / si / sp [SCAN_ROWS]
    "scan_lists_kernel": 3 * SCAN_ROWS * 4,
    # sv / si / sp [PQ_ROWS]; ADC_BULK_SMEM more in the bulk-copy instance
    "adc_scan_kernel": 3 * PQ_ROWS * 4,
    # gmax [SCAN_ROWS]: the groups one slice touches
    "group_amax_kernel": SCAN_ROWS * 4,
    # p_s[MAX_GROUP][MAX_CHUNK], m_s and l_s [MAX_GROUP]
    "decode_split_kernel": DECODE_MAX_GROUP * 512 * 4 + 2 * DECODE_MAX_GROUP * 4,
    "decode_combine_kernel": DECODE_MAX_GROUP * 4,
    "merge_kernel": 0, "rerank_kernel": 0, "flash_bf16_kernel": 0,
    "flash_tf32_kernel": 0, "decode_mma_kernel": 0,
    "embedding_bag_kernel": 0,
    # rows [BAG_ROWS_CHUNK][BAG_SLICE], sid and sw [BAG_ROWS_CHUNK]
    "bag_rows_kernel": BAG_ROWS_CHUNK * (BAG_SLICE + 2) * 4,
    # bv / bi / be [2][HNSW_MAX_EF], nv / ni / nk [HNSW_MAX_DEGREE],
    # wv / wj / wi / wn [2][warps], ctl[4]; the query and a shared
    # visited set are dynamic (plan_hnsw_search)
    "hnsw_search_kernel": (6 * HNSW_MAX_EF + 3 * HNSW_MAX_DEGREE
                           + 8 * HNSW_THREADS // WARP + 4) * 4,
}
# The int8 instances keep the arrays of their scale reductions (red[32];
# stage 1's sq: centroid_static); the compiler drops them from the f32
# and bf16 instances.
INT8_STATIC_SMEM: Dict[str, int] = {
    "scan_lists_kernel": 32 * 4, "adc_scan_kernel": 32 * 4,
}


def centroid_static(qtile: int, precision: str) -> int:
    """Static shared memory of the stage-1 instance for ``qtile``
    queries: sv[qtile][CENTROID_CHUNK + 1], and int8's sq[qtile]."""
    return qtile * (CENTROID_CHUNK + 1) * 4 + (
        qtile * 4 if precision == "int8" else 0)

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
            precision: str = "f32", static: int = -1) -> Launch:
    g = tuple(grid) + (1,) * (3 - len(tuple(grid)))
    if static < 0:
        static = STATIC_SMEM[kernel] + (INT8_STATIC_SMEM.get(kernel, 0)
                                        if precision == "int8" else 0)
    return Launch(kernel, g, (threads, 1, 1), smem, opt_in, static)


def plan_merge(b: int, n_lists: int, w: int, w_in: int = 0
               ) -> List[Launch]:
    """``merge_topk_f32``: one ``merge_kernel`` per pass of
    ``merge_plan`` (lists of ``w_in``, default ``w``, into the best
    ``w``), each asking for the largest pass's shared memory."""
    smem = merge_smem(n_lists, w, w_in)
    return [_launch("merge_kernel", (b, groups), MERGE_THREADS, smem, True)
            for _, groups in merge_plan(n_lists, w, w_in)]


def plan_group_amax(n_sets: int, set_rows: int) -> List[Launch]:
    """``group_amax``: the one-time int8 scale pass of an index, one
    block per 128-row slice of each set (a list, or the one set of p
    centroids)."""
    if n_sets * set_rows == 0:
        return []
    return [_launch("group_amax_kernel", (n_sets * scan_split(set_rows),),
                    ROW_THREADS, 0, False)]


def plan_select(b: int, p: int, d: int, np_pad: int, precision: str
                ) -> List[Launch]:
    """Stage 1 (``select_probes``): the chunk blocks (tiles of
    ``centroid_qtile`` queries staged in dynamic shared memory), which
    fold their lists of min(np_pad, 128) into np_pad in the same launch
    when ``select_fold`` (the dynamic shared memory then holds the larger
    of the queries and the fold), else the merge after them."""
    n = centroid_chunks(p)
    qt = centroid_qtile(b, d)
    smem = min(b, qt) * d * 4
    fold = select_fold(b, p, d, np_pad)
    if fold:
        smem = max(smem, select_fold_smem(p, np_pad))
    return [_launch("centroid_chunk_kernel", (n, -(-b // qt)), ROW_THREADS,
                    smem, True, static=centroid_static(qt, precision))
            ] + ([] if fold else
                 plan_merge(b, n, np_pad, min(np_pad, CENTROID_CHUNK)))


def plan_rerank(b: int, d: int, r_pad: int) -> List[Launch]:
    """``rerank_rows``: one block per query, the query and the r_pad
    sort entries in dynamic shared memory."""
    return [_launch("rerank_kernel", (b,), RERANK_THREADS,
                    d * 4 + r_pad * MERGE_ENTRY_BYTES, True)]


def scan_smem(d: int, nprobe: int, lmax: int, r_pad: int) -> int:
    """Dynamic shared memory of the scan blocks: the staged query, or
    the fold's largest merge when the launch folds (csrc launch_scan)."""
    smem = d * 4
    if scan_fold(nprobe, lmax, r_pad):
        smem = max(smem, max(scan_split(lmax), nprobe) * r_pad
                   * MERGE_ENTRY_BYTES)
    return smem


def plan_fused_scan_ivf(b: int, nprobe: int, lmax: int, d: int,
                        precision: str, r_pad: int) -> List[Launch]:
    """``fused_scan_ivf``: the scan blocks, which fold to r_pad (and
    re-rank the quantised paths' candidates in float32) in the same
    launch when ``scan_fold``; else the merge of their lists of min(r_pad,
    128) after them, and the quantised paths' re-rank.  int8 reads the
    index's cached group scales (``plan_group_amax``, once per index)."""
    if b == 0:
        return []
    grid = (nprobe * scan_split(lmax), b)
    scan = [_launch("scan_lists_kernel", grid, ROW_THREADS,
                    scan_smem(d, nprobe, lmax, r_pad), True, precision)]
    if scan_fold(nprobe, lmax, r_pad):
        return scan
    return (scan + plan_merge(b, grid[0], r_pad, min(r_pad, SCAN_ROWS))
            + (plan_rerank(b, d, r_pad) if precision != "f32" else []))


def plan_fused_turn_ivf(b: int, p: int, nprobe: int, np_pad: int, lmax: int,
                        d: int, precision: str, r_pad: int) -> List[Launch]:
    """``fused_turn_ivf``: stage 1, then the scan chained behind it."""
    if b == 0:
        return []
    return (plan_select(b, p, d, np_pad, precision)
            + plan_fused_scan_ivf(b, nprobe, lmax, d, precision, r_pad))


def adc_smem(m: int, n_codes: int, nprobe: int, lmax: int, r_pad: int
             ) -> int:
    """Dynamic shared memory of the ADC blocks: the LUT, or the fold's
    largest merge over it when the launch folds (csrc adc_scan)."""
    smem = lut_bytes(m, n_codes)
    if scan_fold(nprobe, lmax, r_pad):
        smem = max(smem, max(pq_split(lmax), nprobe) * r_pad
                   * MERGE_ENTRY_BYTES)
    return smem


def plan_adc(b: int, nprobe: int, lmax: int, m: int, n_codes: int,
             r_pad: int, precision: str = "f32",
             bulk: Optional[bool] = None) -> List[Launch]:
    """``adc_scan``: the ADC blocks (the LUT in dynamic shared memory,
    by a bulk copy a block from ``ADC_BULK_MIN_B`` queries, or as
    ``bulk`` forces), folded to r_pad in the same launch when
    ``scan_fold``, else the merge of their lists of min(r_pad, 128) to
    r_pad after them."""
    if b == 0:
        return []
    grid = (nprobe * pq_split(lmax), b)
    want = b >= ADC_BULK_MIN_B if bulk is None else bulk
    bulk = want and (m * n_codes) % 4 == 0
    static = (STATIC_SMEM["adc_scan_kernel"]
              + (INT8_STATIC_SMEM["adc_scan_kernel"]
                 if precision == "int8" else 0)
              + (ADC_BULK_SMEM if bulk else 0))
    scan = [_launch("adc_scan_kernel", grid, ADC_THREADS,
                    adc_smem(m, n_codes, nprobe, lmax, r_pad), True,
                    precision, static)]
    if scan_fold(nprobe, lmax, r_pad):
        return scan
    return scan + plan_merge(b, grid[0], r_pad, min(r_pad, PQ_ROWS))


def plan_fused_scan_pq(b: int, nprobe: int, lmax: int, m: int, n_codes: int,
                       d: int, r_pad: int, rerank: bool, precision: str,
                       bulk: Optional[bool] = None) -> List[Launch]:
    """``fused_scan_pq``: the ADC scan, then its float32 re-rank, which
    the scan's launch runs itself when it folds."""
    if b == 0:
        return []
    return (plan_adc(b, nprobe, lmax, m, n_codes, r_pad, precision, bulk)
            + (plan_rerank(b, d, r_pad)
               if rerank and not scan_fold(nprobe, lmax, r_pad) else []))


def plan_fused_turn_pq(b: int, p: int, nprobe: int, np_pad: int, lmax: int,
                       m: int, n_codes: int, d: int, precision: str,
                       r_pad: int, bulk: Optional[bool] = None
                       ) -> List[Launch]:
    """``fused_turn_pq``: stage 1, then the ADC scan chained behind it."""
    if b == 0:
        return []
    return (plan_select(b, p, d, np_pad, precision)
            + plan_fused_scan_pq(b, nprobe, lmax, m, n_codes, d, r_pad, True,
                                 precision, bulk))


def plan_centroid_topk(b: int, p: int, d: int, kp: int) -> List[Launch]:
    """``centroid_topk``: stage 1 at float32, its top kp."""
    return plan_select(b, p, d, kp, "f32") if b else []


def plan_ivf_scan(b: int, nprobe: int, lmax: int, d: int, kp: int
                  ) -> List[Launch]:
    """``ivf_scan``: the float32 scan, folded to kp in its launch or
    merged after it."""
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


def plan_embedding_bag(b: int, d: int, kernel: str = "") -> List[Launch]:
    """``embedding_bag_f32``: up to ``BAG_ROWS_MAX_B`` bags (or ``kernel``
    "rows") one block of a warp per (bag, slice of ``BAG_SLICE``
    columns), the slice's rows staged in static shared memory by
    asynchronous copies; else (or ``kernel`` "warp") one warp a bag, no
    shared memory."""
    if kernel not in ("", "rows", "warp"):
        raise ValueError(f"embedding_bag kernel must be 'rows' or 'warp', "
                         f"got {kernel!r}")
    if not b:
        return []
    if kernel == "rows" or (not kernel and b <= BAG_ROWS_MAX_B):
        return [_launch("bag_rows_kernel", (b, -(-d // BAG_SLICE)), WARP, 0,
                        False)]
    return [_launch("embedding_bag_kernel", (-(-b // BAG_WARPS),),
                    BAG_WARPS * WARP, 0, False)]


def hnsw_max_steps(ef: int) -> int:
    """The level-0 steps a search takes at most (the reference's
    ``4 ef + 16``)."""
    return 4 * ef + 16


def hnsw_visited(n: int, d: int, ef: int, degree: int,
                 visited: str = "") -> Tuple[str, int]:
    """(instance, words) of the HNSW kernel's visited set for n nodes,
    a query of d floats, a beam of ef and ``degree`` level-0 neighbours:
    a bitmap of ceil(n / 32) words or a hash of ceil(visits / load)
    slots, visits = min(n, 1 + max_steps x degree) the most ids a
    search marks, in shared memory beside the query and the static
    arrays, the smaller of the two that fits (a bitmap on a tie);
    else a bitmap of ceil(n / 32) words a query in global scratch.
    ``visited`` names an instance to force (ValueError where it does not
    fit)."""
    if visited not in ("",) + HNSW_VISITED:
        raise ValueError(f"visited must be one of {HNSW_VISITED}, got "
                         f"{visited!r}")
    bitmap = -(-n // WARP)
    visits = min(n, 1 + hnsw_max_steps(ef) * degree)
    num, den = HNSW_HASH_LOAD
    sizes = {"bitmap": bitmap, "hash": -(-visits * den // num)}
    room = (SMEM_BLOCK_BYTES - STATIC_SMEM["hnsw_search_kernel"]
            - d * 4) // 4
    fits = [v for v in ("bitmap", "hash") if sizes[v] <= room]
    if visited == "global" or (not visited and not fits):
        return "global", bitmap
    if not visited:
        visited = min(fits, key=sizes.get)
    elif visited not in fits:
        raise ValueError(f"a {visited} of {sizes[visited]} words does not "
                         f"fit the {room} words of shared memory left "
                         f"beside a query of d={d}")
    return visited, sizes[visited]


def plan_hnsw_search(b: int, d: int, n: int, ef: int, degree: int,
                     visited: str = "") -> List[Launch]:
    """``hnsw_search``: ``hnsw_search_kernel``, one block a query; in
    dynamic shared memory the query and, for a shared instance, the
    visited set (``hnsw_visited``; the cap raised once, as every
    kernel's)."""
    kind, words = hnsw_visited(n, d, ef, degree, visited)
    smem = d * 4 + (0 if kind == "global" else words * 4)
    return [_launch("hnsw_search_kernel", (b,), HNSW_THREADS, smem,
                    True)] if b else []
