#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's serving paths through ``ConversationalSearchEngine``
at the size its users run: TopLoc_IVF (float lists, the hand-written
``fused_scan`` / ``fused_turn`` CUDA kernels) and TopLoc_IVFPQ (PQ
lists, the ``pq_adc_scan`` / ``fused_scan_pq`` / ``fused_turn_pq``
kernels), over an MS MARCO passage-scale corpus (8,841,823 docs, d =
768, the width of the dragon BERT-base dual encoder) drawn on the device
from a seed after the synthetic workload's recipe, an IVF index of
16,384 lists, PQ codes of m = 48 subquantizers x 256 codewords, and the
``ServingConfig`` defaults (k = 10, nprobe = 64, h = 1024, alpha = 0.1,
rerank = 64) over 25 conversations x 10 turns.  Then the paper's own
pipeline, text to answers: the dragon dual encoder at full width and
depth (random weights from a seed; its attention is the hand-written
``flash_attention`` kernel) encodes a 65,536-doc text corpus, the port
indexes the embeddings, and each served turn encodes its query before
``engine.query``.  Then two-tower retrieval at its full published width
(``repro/configs/two_tower_retrieval.py``: embed 256, MLP 1024-512-256,
1,048,576 users and 2,097,152 items in one 3.22 GB table, history 50;
random weights from a seed): the item tower encodes the retrieval_cand
corpus of 10^6 items, the port indexes it (p = 1,024), and user sessions
are served with TopLoc, each request's history bag through the
hand-written ``embedding_bag`` kernel.  Then retrieval-augmented answers
(``examples/rag_serving.py``): the encoder path's retriever feeds Yi-9B
at full width and depth (``repro/configs/yi_9b.py``, bf16, random
weights from a seed), which prefills the retrieved docs and the query
and decodes greedily through the hand-written ``flash_decode`` kernel;
then the same turns answered by DeepSeek-V2-Lite at full width and
depth (``repro/configs/deepseek_v2_lite_16b.py``: MLA, 64 routed experts
top-6 + 2 shared, bf16, random weights from a seed), its prefill through
``flash_attention`` at D = 192, Dv = 128; and the ``decode_32k`` serve
shape of Yi-9B, cut from B = 128 to B = 8 (at B = 128 the K/V cache
would be 412 GB).

Phases (one line each, [serve] one per path; any failure raises and
exits non-zero):
  1 card      nvidia-smi name and power limit, versions, TF32 off
  2 build     nvcc of every kernels/csrc source (seconds; registers and
              spills per kernel); HMMA (tensor-core) instructions in
              each instance of the tensor-core attention kernels, and
              the LUT's bulk copy (UBLKCP) in each bulk instance of the
              ADC scan, from cuobjdump -sass of the built library
  3 exact     integer inputs: kernels == plain versions bit for bit
              (rows 1-2, centroid_topk and ivf_scan, in float32 and
              bfloat16: p not a multiple of 128 with every score
              negative, k up to 2,048, B up to 64, nprobe up to 256,
              fewer real rows than k, dense ties; then the others:
              (retrieval top-k and re-rank depth up to 1,000, nprobe up
              to 256, merges past one block; the bf16 and int8 fused
              ops too, r = 2,000 and several int8 groups a list; +0.0
              above -0.0 in core.topk; embedding_bag at B = 1, 512,
              262,144)
    plans     every probe of the kernels analysis pass, the LM's bf16
              flash_decode and flash_attention calls and the stage
              kernels at the smoke's shapes, on CUDA tensors under
              torch.profiler: the recorded launch plan == the traced
              kernels (name, order, grid, block, shared memory): no cast
              or layout-copy kernels beside the bf16 kernels; an int8
              call after its first runs no scale pass
  4 realistic unit-norm floats at the smoke's shapes, B = 1 and 25, f32,
              bf16 and int8, and at the two-tower retrieval_cand shape
    stages    rows 1 and 3-7 split into their kernels under
              torch.profiler (device us each, L2 flushed), B = 1 and 25,
              and the one-time int8 scale passes of the index
  5 attn      flash_attention == its plain version within 1e-5, Yi-9B's
              RAG prefill shape (S = 784, D = 128, GQA 8, causal),
              DeepSeek's MLA prefill (H 16, D = 192, Dv = 128) and
              heads 256 wide on bf16 inputs too (the bf16 kernel), its
              bf16 output within one bf16 ulp
  6 decode    flash_decode == its plain version: f32 results within
              1e-5, bf16 outputs within one bf16 ulp of the row's
              largest |out|; GQA groups 1, 5, 8, S = 1,000 / 1,024 /
              32,768, B = 1 and 8, ragged cache_len with 1, S and S + 1
  7 encode    dragon encodes 65,536 text docs (snowflake one query
              batch); then [serve] encoder lines: IVF over the doc
              embeddings, each turn's query encoded at B = 1
  8 rag       Yi-9B answers 4 conversations x 4 turns: query tower at
              B = 1, fused toploc+ (k = 3) over the encoder path's IVF,
              prefill of 3 docs x 256 + 16 query tokens (first held
              to a prefill through the plain attention), 32 greedy
              tokens; encode / retrieval / prefill p50 and p95, ms a
              token, 24,576 flash_decode launches, finite logits; then
              [rag] deepseek-v2-lite: the same 16 turns (its 784-token
              prefill first held to the plain attention, routed as the
              plain run: logits, ckv, krope), the absorbed MLA decode; init s, peak memory,
              prefill p50 / p95, ms and kernels a token beside the
              decode's byte floor (every expert's bank a token)
  9 twotower  the full-width model, the item corpus, its IVF; then
              [recsys serve] (100 users x 10 requests per path, user
              tower at B = 1 then engine.query), [pairwise] (serve_p99
              and serve_bulk) and the embedding_bag [times]; [twotower
              dist]: the sharded serve steps at S = 2 and 4 of the one
              card, dist_topk (k = 100 of 10^6 items) == the brute step's
              ids, toploc_ivf_dist == its S = 1 result
 10 index     the port's ivf.build at full size + exact top-10
 11 pq        the port's build_ivf_pq at full size (m = 48, 8 iters)
 12 serve     per backend: toploc+ / toploc / plain fused, toploc+
              unfused; each backend's launch counts start at 0; then
              the quantised turn, ServingConfig(fused=True, precision=
              "bf16" / "int8") x toploc+ / toploc / plain, counts from 0
              again, recall@10 and counters against the f32 fused path
    fig8      the reference's recall gate: quantised vs f32 fused turn
              >= 0.95 at fig8's 20,000 docs, d = 64, p = 2,048
    hnsw      the port's HNSW build (host numpy) over the corpus's first
              20,000 docs (m = 16, ef_construction = 64); hnsw_search
              (one CUDA block a query) against its plain version
              (differing queries <= 1 %); the 25 x 10 turns through the
              sequential engine (plain, toploc, toploc adaptive, toploc
              with fig7's cache) at ef 32 and 64, recall@10 against
              exact search over the same docs; fig3's 32 x 10 through
              the batched engine at max_batch 1, 8, 32 == the sequential
              engine bit for bit; a device-memory round trip by a
              pointer chase; the kernel's times at B = 1 and 32 beside
              its byte bound and its chain bound (the steps of a call's
              longest search x the round trip)
    exact     serve: ExactBackend through the sequential engine over the
              whole corpus, ids == [index]'s exact top-10
    sharded   the corpus split over S = 2 and 4 shards of the one card
              (distributed.retrieval, every shard a view): per-shard
              list work and bytes placed; each shard's row 6 / 7 call
              == its plain version (f32 / bf16 / int8); the 25 x 10
              turns, ivf and ivf_pq toploc+ fused (f32, bf16, int8) and
              unfused at each S, p50 / p95 beside the unsharded engine,
              at f32 ids, scores and TurnStats == the unsharded engine's;
              hnsw_search's sharded instance == the unsharded kernel on
              every turn and its plain sharded version (tie rule), the
              HNSW toploc engine == unsharded, its times at B = 1 and 32
    router    ReplicatedSearchEngine, two replicas on the one card (and
              2 replicas x 2 shards): pinned toploc+ fused sessions and
              hedged plain fused traffic == a sequential engine
 13 batched   start_batch / step_batch == the sequential engine
    batched serve  fig3's protocol (32 conversations x 10 turns) through
              BatchedConversationalSearchEngine at max_batch 1, 8, 32,
              seven paths a backend (the result cache in one), each
              replay bit-equal to the sequential engine; turns/s beside
              the sequential engine's, request p50 / p95, launches and
              host syncs a wave
    classic   the two-stage turn, centroid_topk -> ivf_scan, over the
              full index for the 25 x 10 turns at B = 1 and 10 at B =
              25 (launches counted from 0), plus the top-h = 1,024
              cache of each first turn: bit-equal to the fused f32
              turn; the caches and the B = 25 turns within TOL of the
              plain versions; then rows 1-2's [times] at B = 1 and 25
 14 times     CUDA-event kernel times (L2 flushed) beside their bounds,
              rows 4-7 at f32, bf16 and int8; flash_attention at
              dragon's B = 1 and 64 (float32, 3xTF32 bound), Yi-9B's
              and DeepSeek's MLA bf16 prefill (B = 1, S = 784, causal)
              beside SDPA (the kernels it picked named)
    segment   the mutable corpus (core.segment), fig6's protocol: fig3's
              32 x 10 through the batched engine at max_batch 32, ingest
              off and on (each wave: add docs, delete a doc it served,
              compact when the segment would overflow); HNSW toploc on
              the [hnsw] graph (cap 256, 64 docs a wave), then IVF (p =
              4,096) and IVF-PQ over the corpus's first 2,000,000 docs
              (cap 2,048, 512 docs a wave), toploc+ fused f32 / int8,
              plain fused, toploc+ unfused; per path wave p50 / p99,
              docs/s, add p50, each compaction's ms, peak memory; gates:
              an empty delta == the wrapped backend, no deleted doc
              served, compact == segment.rebuild (torch.equal; HNSW's
              rebuild in a child process), the sequential replay == the
              batched run; the holed-index checks: rows 3-7 (f32 / bf16
              / int8) and hnsw_search bit-equal to their plain versions
              on lists with holes, dead slices and lists, and on
              tombstoned graphs
 15 decode32k once the retrieval objects are freed: Yi-9B at decode_32k
              (S = 32,768) cut from B = 128 to B = 8 (412 GB of cache
              at B = 128; 25.8 GB at B = 8), ragged cache_len; step ms
              and tokens/s against the step's bytes over 3.35 TB/s;
              then flash_decode's [times] at B = 1, S = 1,024 and B = 8,
              S = 32,768 beside its plain version and SDPA
then a JSON line of kernels, the card line, and the result line.

Run from the repository root: ``python3 chip_smoke.py``.  Size flags
(``--n-docs``, ``--lists``, ``--iters``, ``--enc-docs``, ``--tt-items``,
``--tt-users``) cut the run for a quick check.  ``--stages-only`` builds
and prints only the [stages] split; ``--dump-rows PATH`` builds and saves
rows 1-7's outputs on the seeded realistic inputs, hnsw_search's on a
seeded graph and row 8's at the [attn] shapes up to 128 wide to PATH,
so the kernels of two checkouts can be held to each other bit for bit
(``--same-dumps A B``);
``--segment-only`` builds and runs only the corpus, the [hnsw] graph
and [segment]; ``--sharded-only`` only the corpus, the IVF and IVF-PQ
indexes, the [hnsw] graph, [sharded] and [router]; ``--hnsw-only`` builds and runs only the corpus, [hnsw] and the [exact]
serve; ``--hnsw-docs`` sizes the graph; ``--hnsw-times`` builds and
prints only a device-memory round trip (a pointer chase) and
hnsw_search's times on the [hnsw] graph beside its byte and chain
bounds, the graph loaded from ``--hnsw-graph PATH`` when that file
exists, else built and saved there, so two checkouts time one graph;
``--bag-times`` builds and times only embedding_bag's kernels over a
range of batch sizes ([bag], ``phase_bag_sweep``); ``--adc-times``
builds and times only the rows that run the ADC scan, rows 3, 5 and 7
at every precision and B = 1 to 32 with each instance of the scan forced
([adc], ``phase_adc_times``), so two checkouts can be compared in one
call.  The eight may be given together.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 1e-5                     # |score| agreement across summation orders
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SCAN_SRC = "src/repro_torch/kernels/csrc/fused_turn.cu"
PQ_SRC = "src/repro_torch/kernels/csrc/pq_adc.cu"
FA_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
EB_SRC = "src/repro_torch/kernels/csrc/embedding_bag.cu"
FD_SRC = "src/repro_torch/kernels/csrc/flash_decode.cu"
CK_SRC = "src/repro_torch/kernels/csrc/centroid_topk.cu"
IV_SRC = "src/repro_torch/kernels/csrc/ivf_scan.cu"
HS_SRC = "src/repro_torch/kernels/csrc/hnsw_search.cu"
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
# float32 products in 3xTF32: three tf32 tensor-core passes (495 TFLOP/s
# dense) per product
TF32X3_FLOP_PER_S = 495e12 / 3
# the tensor-core kernels: cuobjdump -sass must show HMMA in each
MMA_KERNELS = ("flash_bf16_kernel", "flash_tf32_kernel", "decode_mma_kernel")
PQ_M, PQ_ITERS, RERANK = 48, 8, 64
IVF_KERNELS = ("fused_scan", "fused_turn")
PQ_KERNELS = ("pq_adc_scan", "fused_scan_pq", "fused_turn_pq")
# the quantised fused turn: bf16 and int8 instances of rows 4-7, named
# "op[precision]" in the kernels line
QUANT = ("bf16", "int8")
QUANT_OPS = ("fused_scan", "fused_turn", "fused_scan_pq", "fused_turn_pq")
QUANT_KERNELS = tuple(f"{op}[{prec}]" for op in QUANT_OPS for prec in QUANT)
ENC_KERNELS = ("flash_attention",)
REC_KERNELS = ("embedding_bag",)
LM_KERNELS = ("flash_decode",)
# rows 1-2: the two stages of a turn as kernels of their own
CLASSIC_KERNELS = ("centroid_topk", "ivf_scan")
HNSW_KERNELS = ("hnsw_search",)
HNSW_SHARD_KERNELS = ("hnsw_search_sharded",)   # its sharded instance
SOURCES = {**dict.fromkeys(IVF_KERNELS, SCAN_SRC),
           **dict.fromkeys(PQ_KERNELS, PQ_SRC),
           **{f"{op}[{prec}]": SCAN_SRC if op in IVF_KERNELS else PQ_SRC
              for op in QUANT_OPS for prec in QUANT},
           "flash_attention": FA_SRC, "embedding_bag": EB_SRC,
           "flash_decode": FD_SRC, "centroid_topk": CK_SRC,
           "ivf_scan": IV_SRC, "hnsw_search": HS_SRC,
           "hnsw_search_sharded": HS_SRC}
REPLACES = {"fused_scan": "src/repro/kernels/fused_turn.py:644",
            "fused_turn": "src/repro/kernels/fused_turn.py:406",
            "pq_adc_scan": "src/repro/kernels/pq_adc.py:79",
            "fused_scan_pq": "src/repro/kernels/fused_turn.py:686",
            "fused_turn_pq": "src/repro/kernels/fused_turn.py:445",
            "flash_attention": "src/repro/kernels/flash_attention.py:89",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:49",
            "flash_decode": "src/repro/kernels/flash_attention.py:180",
            "centroid_topk": "src/repro/kernels/centroid_topk.py:66",
            "ivf_scan": "src/repro/kernels/ivf_scan.py:64",
            "hnsw_search": "src/repro/core/hnsw.py:349 _search_impl (XLA "
                           "while_loop, no Pallas kernel)",
            "hnsw_search_sharded": "src/repro/distributed/retrieval.py:407 "
                                   "_search_impl under shard_map, dots "
                                   "psum-ed (XLA, no Pallas kernel)"}
REPLACES.update({f"{op}[{prec}]": REPLACES[op] for op in QUANT_OPS
                 for prec in QUANT})
BAG_TOL = 1e-6                 # embedding_bag on random floats
# the encoder path: docs of the text corpus, queries of Q_LEN tokens
# padded to max_len, DOC_BATCH docs per doc-tower call ([attn] and
# [times] hold and time the kernel at that batch too)
ENC_DOCS, DOC_BATCH, Q_LEN = 65_536, 64, 16
MSMARCO_DOCS = 8_841_823


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sass_counts(so, kernels, opcodes):
    """Per instance of each kernel named in ``kernels``, its mangled name
    and the number of SASS instructions whose opcode starts with each of
    ``opcodes``, from ``cuobjdump -sass`` of the built library: {kernel:
    [(name, {opcode: n}), ...]}."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = next((k for k in kernels if k in line), None)
            if cur:
                counts.setdefault(cur, []).append(
                    (line.split("Function :")[1].strip(),
                     dict.fromkeys(opcodes, 0)))
            continue
        m = cur and re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                              r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            for op in opcodes:
                if m.group(1).startswith(op):
                    counts[cur][-1][1][op] += 1
    return counts


def sass_checks(so):
    """The SASS the design relies on, per kernel instance: HMMA
    (tensor-core) instructions in each of the MMA_KERNELS, and the bulk
    copy of the LUT (UBLKCP) in each of adc_scan_kernel's three bulk
    instances (template argument BULK true: ``Lb1E`` in the mangled
    name) and in none of the three that stage the LUT by threads. Raises
    if an instance breaks this or a kernel is missing; returns the HMMA
    counts and, per adc_scan_kernel instance, (bulk instance, its counts
    of bulk copies and mbarrier instructions (SYNCS))."""
    hmma = sass_counts(so, MMA_KERNELS, ("HMMA",))
    adc = [("Lb1E" in name, c)
           for name, c in sass_counts(so, ("adc_scan_kernel",),
                                      ("UBLKCP", "SYNCS")
                                      ).get("adc_scan_kernel", [])]
    if set(hmma) != set(MMA_KERNELS) or not all(
            c["HMMA"] for cs in hmma.values() for _, c in cs):
        raise AssertionError(f"SASS: HMMA per instance {hmma}")
    if (sorted(bulk for bulk, _ in adc) != [False] * 3 + [True] * 3
            or not all(bool(c["UBLKCP"]) == bulk for bulk, c in adc)):
        raise AssertionError(f"SASS: bulk copy per adc_scan_kernel "
                             f"instance {adc}")
    return ({k: [c["HMMA"] for _, c in cs] for k, cs in hmma.items()}, adc)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparison under the tie rule
# ---------------------------------------------------------------------------


def compare(what, got_v, got_i, want_v, want_i, true_score, n_ids):
    """Hold a kernel's (B, k) top-k against its plain version's.

    Scores agree within TOL.  Every real id the kernel returns is valid
    (in [0, n_ids)), distinct within its row, and its own score —
    ``true_score(ids)``, a float64 dot product computed here — lies
    within TOL of the plain version's score at that slot.  So ids may
    differ only where two candidates are tied within TOL (a near tie
    resolved by another summation order).  Returns (max |dscore|,
    id mismatches)."""
    import torch
    fin = torch.isfinite(want_v)
    if not torch.equal(torch.isfinite(got_v), fin):
        raise AssertionError(f"{what}: finite lanes differ")
    diff = (got_v - want_v).abs().where(fin, torch.zeros_like(got_v))
    err = float(diff.max()) if diff.numel() else 0.0
    if err > TOL:
        raise AssertionError(f"{what}: max |dscore| {err} > {TOL}")
    mism = got_i != want_i
    if bool((mism & ~fin).any()):
        raise AssertionError(f"{what}: pad lanes differ")
    ids = got_i.long()
    if bool(((ids < 0) | (ids >= n_ids))[fin].any()):
        raise AssertionError(f"{what}: an id out of [0, {n_ids})")
    lane = torch.arange(ids.shape[-1], device=ids.device)
    srt = ids.where(fin, -1 - lane).sort(-1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{what}: an id repeats within a row")
    true = true_score(ids.clamp_min(0))
    off = (true - want_v.double()).abs().where(fin, torch.zeros_like(true))
    if bool((off > TOL).any()):
        raise AssertionError(f"{what}: a returned id scores "
                             f"{float(off.max())} from the wanted score")
    return err, int(mism.sum())


def dot_rows(rows, q):
    """``true_score`` over the rows of ``rows``: ids (B, k) -> the float64
    dot product of each id's row with its query q[b]."""
    def score(ids):
        return (rows[ids].double() * q.double()[:, None]).sum(-1)
    return score


def equal(what, got, want, names):
    import torch
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs")


# ---------------------------------------------------------------------------
# phase 3: exact integer inputs
# ---------------------------------------------------------------------------


def int_inputs(shape, dev):
    """The integer-valued posting lists of tests/test_fused.py (list 0
    empty, ragged sizes, zero pads) plus a partial ``own`` mask."""
    import torch
    p, lmax, d, b, nprobe, _ = shape
    rng = np.random.default_rng(p * 100 + lmax)
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 5, size=(p, d)).astype(np.float32)
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    real = np.arange(lmax)[None] < sizes[:, None]
    li = np.where(real, np.arange(p * lmax).reshape(p, lmax) % 200, -1)
    lv[~real] = 0
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    own[0, 0] = 0
    return [torch.from_numpy(x).to(dev) for x in
            (q, cents, lv, li.astype(np.int32), own)]


EXACT_SHAPES = [(6, 10, 16, 3, 3, 4),      # p, lmax, d, B, nprobe, k
                (5, 7, 8, 1, 5, 8),        # k > candidates available
                (9, 16, 32, 4, 2, 4),
                (300, 200, 32, 9, 64, 10),  # non-tile-multiple p, lmax
                (1000, 130, 8, 25, 64, 10),  # dense ties, B not / 8
                # r_pad 128, merges in groups (tiling.merge_plan): the
                # two-tower retrieval_cand shape (k 100, nprobe 32, Lmax
                # 1,220), then np_pad 128 (nine groups)
                (64, 1220, 8, 2, 32, 100),
                (300, 1220, 8, 3, 128, 128),
                # k = 1,000 (r_pad 1,024, 18 lists a merge block): the
                # smoke's nprobe and Lmax (three passes), then nprobe 256
                (1000, 702, 8, 2, 64, 1000),
                (600, 40, 8, 3, 256, 1000)]

# p, lmax, d, B, nprobe, k, m, n_codes, rerank
# (tests/test_torch_kernels.py PQ_SHAPES)
PQ_EXACT_SHAPES = [(6, 10, 16, 3, 3, 4, 4, 16, 6),      # r 6 < r_pad 8
                   (4, 3, 8, 2, 2, 8, 8, 256, 8),       # 6 slots, k = 8
                   (9, 600, 32, 4, 2, 4, 48, 256, 64),  # 2 ADC blocks
                   (300, 200, 32, 9, 64, 10, 48, 256, 64),
                   (1000, 130, 8, 25, 64, 10, 8, 256, 20),  # dense ties
                   # re-rank depth 128 (r_pad 128), one and three groups
                   (64, 1220, 16, 2, 32, 100, 16, 256, 128),
                   (300, 1220, 16, 2, 128, 100, 16, 256, 128),
                   # nprobe 256; a re-rank depth of 1,000 (r_pad 1,024,
                   # past the 512 rows an ADC block keeps)
                   (600, 40, 16, 2, 256, 100, 16, 256, 1000),
                   (64, 1220, 16, 1, 8, 1000, 16, 256, 1000)]


def pq_int_inputs(shape, dev):
    """Integer LUTs, codes and corpus rows (200, ids repeat) over the
    lists of ``int_inputs``."""
    import torch
    p, lmax, d, b, nprobe, k, m, c, _ = shape
    q, cents, _, li, own = int_inputs((p, lmax, d, b, nprobe, k), dev)
    rng = np.random.default_rng(p * 10 + m)
    tables = rng.integers(-4, 5, size=(b, m, c)).astype(np.float32)
    codes = rng.integers(0, c, size=(p, lmax, m)).astype(np.uint8)
    corpus = rng.integers(-4, 5, size=(200, d)).astype(np.float32)
    return [q, cents] + [torch.from_numpy(x).to(dev) for x in
                         (tables, codes)] + [
        li, torch.from_numpy(corpus).to(dev), own]


def phase_exact(dev):
    """Returns the shape counts and the most merge passes a shape took."""
    import torch
    from repro_torch.kernels import ops, ref, tiling
    for shape in EXACT_SHAPES:
        q, cents, lv, li, own = int_inputs(shape, dev)
        nprobe, k = shape[4], shape[5]
        got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k)
        want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k)
        equal(f"fused_turn {shape}", got, want, ("v", "ids", "sel"))
        got = ops.fused_scan(q, lv, li, want[2], k, own=own)
        want = ref.fused_scan_ivf(q, lv, li, want[2], own, k=k)
        equal(f"fused_scan {shape}", got, want, ("v", "ids", "pos"))
    for shape in PQ_EXACT_SHAPES:
        q, cents, tables, codes, li, corpus, own = pq_int_inputs(shape, dev)
        nprobe, k, rerank = shape[4], shape[5], shape[8]
        r = max(k, min(rerank, nprobe * shape[1]))
        got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                nprobe=nprobe, k=k, rerank=rerank)
        want = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                 nprobe=nprobe, k=k, r=r)
        equal(f"fused_turn_pq {shape}", got, want, ("v", "ids", "sel"))
        sel = want[2]
        equal(f"pq_adc_scan {shape}",
              ops.pq_adc_scan(tables, codes, li, sel, r),
              ref.pq_adc_scan_batch(tables, codes, li, sel, r),
              ("v", "ids"))
        for fuse in (True, False):
            equal(f"fused_scan_pq rerank={fuse} {shape}",
                  ops.fused_scan_pq(tables, q, codes, li, sel, corpus, k,
                                    rerank=rerank, own=own,
                                    fuse_rerank=fuse),
                  ref.fused_scan_pq(tables, q, codes, li, sel, own, corpus,
                                    k=k, r=r, rerank=fuse),
                  ("v", "ids", "pos"))
    torch.cuda.synchronize()
    passes = max(len(tiling.merge_plan(sh[4] * tiling.scan_split(sh[1]),
                                       tiling.next_pow2(sh[5])))
                 for sh in EXACT_SHAPES)
    return len(EXACT_SHAPES), len(PQ_EXACT_SHAPES), passes


# several int8 scale groups a list (d = 1,024, Lmax > 1,024), then r =
# 2,000 (r_pad 2,048) wider than that byte-capped group of 1,024 rows
GROUP_SHAPES = [(8, 1100, 1024, 2, 3, 4), (8, 1100, 1024, 2, 3, 1000)]
SIGNED_ZEROS = [-0.0, 0.0, -0.0, 0.0, 1.0, -1.0]
BF16_STEP = 2.0 ** -9


def bf16_split(tensors, seed):
    """Integer tensors (|x| <= 4) with BF16_STEP added to the magnitude
    of about half their nonzero entries: bf16 (8 significant bits)
    rounds each back to its integer and float32 keeps it, so bf16 scores
    and float32 scores order the rows differently.  Against integer
    queries every float32 sum stays exact (terms are multiples of 2^-9,
    sums below 2^15 at d <= 1,024), and so do the ADC sums of m <= 48
    such LUT entries."""
    import torch
    rng = np.random.default_rng(seed)
    return [t + t.sign() * BF16_STEP * torch.from_numpy(
        rng.integers(0, 2, size=tuple(t.shape)).astype(np.float32)).to(
            t.device) for t in tensors]


def phase_exact_quant(dev):
    """bf16 and int8 fused ops == their plain versions, bit for bit:
    values, ids, sel and candidate ranks, at the IVF and PQ shapes of
    phase_exact (k = 1,000: r = 2,000, r_pad 2,048) and GROUP_SHAPES.
    First on integer inputs (|x| <= 4: bf16 rounds nothing, int8 is
    exact), then with the centroids, lists, LUTs and corpus rows of
    ``bf16_split`` (integer queries), on which a kernel that skipped
    bf16's rounding at any stage would order candidates as float32 does.
    Then +0.0 above -0.0 in ``core.topk`` on the card (no fused kernel
    emits -0.0: every sum starts at +0.0)."""
    import torch
    from repro_torch.core.topk import topk
    for rounded in (False, True):
        exact_quant(dev, rounded)
    x = torch.tensor(SIGNED_ZEROS, device=dev)
    got = topk(x[None].repeat(4, 1), 6)[1].tolist()
    if got != [[4, 1, 3, 0, 2, 5]] * 4:
        raise AssertionError(f"core.topk on the card orders +-0 as {got}")
    torch.cuda.synchronize()
    return len(EXACT_SHAPES) + len(GROUP_SHAPES), len(PQ_EXACT_SHAPES)


def exact_quant(dev, rounded):
    """phase_exact_quant's checks on integer inputs, or on ``bf16_split``
    ones if ``rounded``."""
    from repro_torch.kernels import ops, ref
    for prec in QUANT:
        for shape in EXACT_SHAPES + GROUP_SHAPES:
            q, cents, lv, li, own = int_inputs(shape, dev)
            if rounded:
                cents, lv = bf16_split((cents, lv), shape[0])
            tag = f"[{prec}]{' bf16-split' if rounded else ''} {shape}"
            nprobe, k = shape[4], shape[5]
            r = ops._fused_depth(k, nprobe * shape[1], 2 * k)
            got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k,
                                 precision=prec)
            want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k,
                                      precision=prec, r=r)
            equal(f"fused_turn{tag}", got, want, ("v", "ids", "sel"))
            got = ops.fused_scan(q, lv, li, want[2], k, own=own,
                                 precision=prec)
            want = ref.fused_scan_ivf(q, lv, li, want[2], own, k=k,
                                      precision=prec, r=r)
            equal(f"fused_scan{tag}", got, want, ("v", "ids", "rank"))
        for shape in PQ_EXACT_SHAPES:
            q, cents, tables, codes, li, corpus, own = pq_int_inputs(shape,
                                                                     dev)
            if rounded:
                cents, tables, corpus = bf16_split((cents, tables, corpus),
                                                   shape[0])
            tag = f"[{prec}]{' bf16-split' if rounded else ''} {shape}"
            nprobe, k, rerank = shape[4], shape[5], shape[8]
            r = max(k, min(rerank, nprobe * shape[1]))
            got = ops.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                    nprobe=nprobe, k=k, rerank=rerank,
                                    precision=prec)
            want = ref.fused_turn_pq(q, cents, tables, codes, li, corpus,
                                     nprobe=nprobe, k=k, r=r, precision=prec)
            equal(f"fused_turn_pq{tag}", got, want, ("v", "ids", "sel"))
            for fuse in (True, False):
                equal(f"fused_scan_pq{tag} rerank={fuse}",
                      ops.fused_scan_pq(tables, q, codes, li, want[2],
                                        corpus, k, rerank=rerank, own=own,
                                        fuse_rerank=fuse, precision=prec),
                      ref.fused_scan_pq(tables, q, codes, li, want[2], own,
                                        corpus, k=k, r=r, rerank=fuse,
                                        precision=prec),
                      ("v", "ids", "pos"))


# embedding_bag: V rows of the two-tower width, bags of the history length
BAG_V, BAG_D, BAG_L = 100_000, 256, 50
BAG_BATCHES = (1, 512, 262_144)     # a request, serve_p99, serve_bulk


def bag_inputs(b, integer, gen, dev):
    """B bags of BAG_L ids in [-1, V), about one in ten a pad, the last
    row V - 1 in every bag, bag 0 all pads when B > 1; an integer-valued
    table and weights, or floats at the two-tower table's scale (normal
    x d^-1/2) and normal weights."""
    import torch
    ids = torch.randint(0, BAG_V, (b, BAG_L), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand((b, BAG_L), generator=gen, device=dev) < 0.1] = -1
    ids[:, -1] = BAG_V - 1
    if b > 1:
        ids[0] = -1
    if integer:
        table = torch.randint(-4, 5, (BAG_V, BAG_D), generator=gen,
                              device=dev).float()
        w = torch.randint(-3, 4, (b, BAG_L), generator=gen,
                          device=dev).float()
    else:
        table = torch.randn((BAG_V, BAG_D), generator=gen, device=dev
                            ) * BAG_D ** -0.5
        w = torch.randn((b, BAG_L), generator=gen, device=dev)
    return table, ids, w


def phase_exact_bag(dev, errs):
    """embedding_bag against its plain version, sum and mean, weighted
    and not: bit for bit on integer inputs, within BAG_TOL on floats."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(7)
    for b in BAG_BATCHES:
        for integer in (True, False):
            table, ids, w = bag_inputs(b, integer, gen, dev)
            for weights in (None, w):
                for agg in ("sum", "mean"):
                    got = ops.embedding_bag(table, ids, weights, agg=agg)
                    want = ref.embedding_bag(table, ids, weights, mode=agg)
                    what = (f"embedding_bag B={b} integer={integer} "
                            f"weighted={weights is not None} {agg}")
                    if integer:
                        equal(what, (got,), (want,), ("out",))
                        continue
                    err = float((got - want).abs().max())
                    if got.shape != want.shape or not err <= BAG_TOL:
                        raise AssertionError(f"{what}: max |d| {err}")
                    errs["embedding_bag"] = max(errs["embedding_bag"], err)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# rows 1-2: centroid_topk and ivf_scan, the two stages of a turn alone
# ---------------------------------------------------------------------------

# p, d, B, k: p not a multiple of 128 with every score negative (the
# reference's zero-padded centroids would outrank them), k = p, dense
# ties (d = 8, entries in [-1, 1]), B = 64, k up to 2,048 (a three-pass
# merge over 20 chunks), the smoke's nprobe and h over p = 16,384
CK_EXACT = [(600, 16, 3, 8), (16, 16, 2, 16), (300, 8, 9, 10),
            (1000, 8, 25, 64), (700, 32, 64, 100), (2500, 8, 64, 2048),
            (16_384, 8, 3, 64), (16_384, 8, 2, 1024)]
# p, lmax, d, B, nprobe, k (int_inputs' ragged lists: list 0 empty, ids
# repeat): fewer than k real rows, k = 100 past one merge group, nprobe
# 256 at k = 1,000 and 2,048, B = 64
IV_EXACT = [(6, 10, 16, 3, 3, 4), (5, 7, 8, 1, 5, 8), (9, 16, 32, 4, 2, 30),
            (300, 200, 32, 9, 64, 10), (1000, 130, 8, 25, 64, 10),
            (64, 1220, 8, 2, 32, 100), (600, 40, 8, 3, 256, 1000),
            (600, 40, 8, 2, 256, 2048), (300, 200, 16, 64, 16, 64)]


def ck_inputs(shape, dev):
    """Integer queries and centroids; the first shape's scores are all
    negative (centroids in [1, 4], queries in [-4, -1]); the d = 8
    shapes draw from [-1, 1], so ties are dense."""
    import torch
    p, d, b, _ = shape
    rng = np.random.default_rng(p + d + b)
    lo = 1 if d == 8 else 4
    if shape == CK_EXACT[0]:
        q = -rng.integers(1, 5, size=(b, d))
        c = rng.integers(1, 5, size=(p, d))
    else:
        q = rng.integers(-lo, lo + 1, size=(b, d))
        c = rng.integers(-lo, lo + 1, size=(p, d))
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (q, c)]


def iv_inputs(shape, dev):
    """int_inputs' lists and a selection drawn with repeats."""
    import torch
    q, _, lv, li, _ = int_inputs(shape, dev)
    p, b, nprobe = shape[0], shape[3], shape[4]
    rng = np.random.default_rng(p + nprobe)
    sel = torch.from_numpy(rng.integers(0, p, size=(b, nprobe)).astype(
        np.int32)).to(dev)
    return q, lv, li, sel


def phase_exact_classic(dev):
    """Rows 1-2 bit-equal to their plain versions on integer inputs, in
    float32 and bfloat16 (exact on these values).  Returns the most
    merge passes a shape took."""
    import torch
    from repro_torch.kernels import ops, ref, tiling
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CK_EXACT:
            q, c = (x.to(dtype) for x in ck_inputs(shape, dev))
            k = shape[3]
            got = ops.centroid_topk(q, c, k)
            want = ref.centroid_topk(q, c, k)
            equal(f"centroid_topk {shape} {dtype}", got, want, ("v", "ids"))
            if shape == CK_EXACT[0] and not bool((got[0] < 0).all()):
                raise AssertionError("centroid_topk: a padded centroid won")
        for shape in IV_EXACT:
            q, lv, li, sel = iv_inputs(shape, dev)
            q, lv = q.to(dtype), lv.to(dtype)
            k = shape[5]
            got = ops.ivf_scan(q, lv, li, sel, k)
            want = ref.ivf_scan_batch(q, lv, li, sel, k)
            equal(f"ivf_scan {shape} {dtype}", got, want, ("v", "ids"))
    torch.cuda.synchronize()
    return max([len(tiling.merge_plan(tiling.centroid_chunks(s[0]),
                                      tiling.next_pow2(s[3])))
                for s in CK_EXACT] +
               [len(tiling.merge_plan(s[4] * tiling.scan_split(s[1]),
                                      tiling.next_pow2(s[5])))
                for s in IV_EXACT])


def phase_classic(args, index, docs, convs, dev, errs):
    """The two-stage turn at full width: for the 25 conversations' turns
    at B = 1 and B = 25, ``ops.centroid_topk(q, C, nprobe)`` then
    ``ops.ivf_scan(q, lists, ids, sel, k)``, and on each first turn the
    top-h cache (a refresh turn's ``centroid_topk(q, C, h)``).  The
    launch counts start at 0 just before and are read just after.  Then
    each turn is held bit for bit to ``ops.fused_turn(..., precision=
    "f32")`` (values, ids, sel), and the B = 25 turns and the top-h
    caches to the plain versions within TOL.  Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops, ref
    k, nprobe, h = args.k, args.nprobe, 1024
    lv, li, c = index.list_vecs, index.list_ids, index.centroids
    turns = []
    for b in (1, 25):
        for t in range(convs.shape[1]):
            qs = torch.from_numpy(np.ascontiguousarray(convs[:, t])).to(dev)
            turns += [(qs[j:j + 1], t) for j in range(len(qs))] if b == 1 \
                else [(qs, t)]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    runs = []
    for q, t in turns:
        sel_v, sel = ops.centroid_topk(q, c, nprobe)
        v, i = ops.ivf_scan(q, lv, li, sel, k)
        cache = ops.centroid_topk(q, c, h) if t == 0 else None
        runs.append((q, sel_v, sel, v, i, cache))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: getattr(ops, n).launches for n in CLASSIC_KERNELS}
    if min(counts.values()) == 0:
        raise AssertionError(f"classic: a kernel was not launched: {counts}")
    ties = dict.fromkeys(("centroid_topk", "ivf_scan", "cache"), 0)
    for q, sel_v, sel, v, i, cache in runs:
        fv, fi, fs = ops.fused_turn(q, c, lv, li, nprobe=nprobe, k=k)
        equal(f"classic B={q.shape[0]} vs fused_turn", (v, i, sel),
              (fv, fi, fs), ("v", "ids", "sel"))
        if not (torch.isfinite(v).all() and v.shape == (q.shape[0], k)):
            raise AssertionError("classic: non-finite or misshapen scores")
        checks = [("cache", cache, ref.centroid_topk(q, c, h), c)
                  ] if cache is not None else []
        if q.shape[0] > 1:
            checks += [("centroid_topk", (sel_v, sel),
                        ref.centroid_topk(q, c, nprobe), c),
                       ("ivf_scan", (v, i),
                        ref.ivf_scan_batch(q, lv, li, sel, k), docs)]
        for name, got, want, rows in checks:
            err, mism = compare(f"classic {name} B={q.shape[0]}", *got,
                                *want, dot_rows(rows, q), rows.shape[0])
            key = "centroid_topk" if name == "cache" else name
            errs[key] = max(errs[key], err)
            ties[name] += mism
    n_conv, n_turn = convs.shape[:2]
    log("classic", f"p={index.p} lmax={index.lmax} d={index.d} nprobe="
        f"{nprobe} k={k} h={h}: {len(turns)} turns ({n_conv} x {n_turn} at "
        f"B = 1, {n_turn} at B = {n_conv}) of centroid_topk -> ivf_scan in "
        f"{wall:.2f}s host "
        f"clock, launches {counts}; values, ids and sel bit-equal to "
        f"fused_turn (f32); against the plain versions max_abs_err "
        f"centroid_topk={errs['centroid_topk']:.3g} ivf_scan="
        f"{errs['ivf_scan']:.3g} (tol {TOL}), near-tie id mismatches "
        f"{ties}")
    return counts


def bf16_probes():
    """The bf16 calls of the LM path, held to the profiler like the
    analysis pass's probes: a decode step's ``flash_decode`` on a bf16
    cache and a prefill's ``flash_attention`` on bf16 q, k and a v seen
    through transpose(1, 2), as the projections leave it.  Each is the
    one kernel of its plan: no casts, no layout copies."""
    import torch
    from repro_torch.analysis import kernel_budget as KB
    from repro_torch.kernels import ops
    bf16 = torch.bfloat16
    return [
        KB.Probe("ops.flash_decode[bf16]",
                 (KB.Arg((4, 32, 128), bf16), KB.Arg((4, 4, 2048, 128), bf16),
                  KB.Arg((4, 4, 2048, 128), bf16),
                  KB.Arg((4,), torch.int32, 1, 2049)),
                 lambda q, k, v, n, device: ops.flash_decode(
                     q, k, v, n, device=device)),
        KB.Probe("ops.flash_attention[bf16]",
                 (KB.Arg((1, 32, 784, 128), bf16),
                  KB.Arg((1, 4, 784, 128), bf16),
                  KB.Arg((1, 784, 4, 128), bf16)),
                 lambda q, k, v, device: ops.flash_attention(
                     q, k, v.transpose(1, 2), causal=True, device=device)),
    ]


def stage_probes():
    """The stage kernels at the smoke's shapes, held to the profiler like
    the analysis pass's probes: stage 1 in its 32-query tile (B = 25)
    and the top-h cache's growing merge (kp = 1,024), the served
    fused_scan (B = 1, nprobe 64, Lmax 702, d 768, k 10), whose lists
    fold in its one launch, the served int8 turn (stage 1 folded, the
    scan with its re-rank chained behind it, the one-time scale passes of
    its lists and centroids), and the served PQ scan and turn (m = 48 x
    256 codes, re-rank depth 64), whose ADC scans fold and re-rank in
    their launch; then rows 4-7 at f32 and B = 32, the batched engine's
    largest wave (stage 1 merged after its tile, the ADC scan's bulk
    instance); 512 lists stand for the index's 16,384."""
    import torch
    from repro_torch.analysis import kernel_budget as KB
    from repro_torch.kernels import ops
    f32 = torch.float32
    lists = (KB.Arg((512, 702, 768), f32),
             KB.Arg((512, 702), torch.int32, -1, 10_000))
    pq_lists = (KB.Arg((1, PQ_M, 256), f32),
                KB.Arg((512, 702, PQ_M), torch.uint8, 0, 256),
                KB.Arg((512, 702), torch.int32, -1, 10_000))
    return [
        KB.Probe("ops.centroid_topk[B=25]",
                 (KB.Arg((25, 768), f32), KB.Arg((16_384, 768), f32)),
                 lambda q, c, device: ops.centroid_topk(q, c, 64,
                                                        device=device)),
        KB.Probe("ops.centroid_topk[h=1024]",
                 (KB.Arg((1, 768), f32), KB.Arg((16_384, 768), f32)),
                 lambda q, c, device: ops.centroid_topk(q, c, 1024,
                                                        device=device)),
        KB.Probe("ops.fused_scan[served]",
                 (KB.Arg((1, 768), f32), *lists,
                  KB.Arg((1, 64), torch.int32, 0, 512)),
                 lambda q, lv, li, sel, device: ops.fused_scan(
                     q, lv, li, sel, 10, device=device)),
        KB.Probe("ops.fused_turn[int8 served]",
                 (KB.Arg((1, 768), f32), KB.Arg((512, 768), f32), *lists),
                 lambda q, c, lv, li, device: ops.fused_turn(
                     q, c, lv, li, nprobe=64, k=10, precision="int8",
                     device=device)),
        KB.Probe("ops.fused_scan_pq[served]",
                 (*pq_lists, KB.Arg((1, 64), torch.int32, 0, 512),
                  KB.Arg((1, 768), f32), KB.Arg((10_000, 768), f32)),
                 lambda t, cd, li, sel, q, rows, device: ops.fused_scan_pq(
                     t, q, cd, li, sel, rows, 10, rerank=RERANK,
                     device=device)),
        KB.Probe("ops.fused_turn_pq[served]",
                 (KB.Arg((1, 768), f32), KB.Arg((512, 768), f32), *pq_lists,
                  KB.Arg((10_000, 768), f32)),
                 lambda q, c, t, cd, li, rows, device: ops.fused_turn_pq(
                     q, c, t, cd, li, rows, nprobe=64, k=10, rerank=RERANK,
                     device=device)),
    ] + wave_probes(KB, ops, lists, pq_lists[1:])


def wave_probes(KB, ops, lists, pq_lists, b=32):
    """Rows 4-7 at f32 on a wave of ``b`` queries (``stage_probes``)."""
    import torch
    f32 = torch.float32
    q, cents = KB.Arg((b, 768), f32), KB.Arg((512, 768), f32)
    tables, sel = KB.Arg((b, PQ_M, 256), f32), KB.Arg((b, 64), torch.int32,
                                                       0, 512)
    rows = KB.Arg((10_000, 768), f32)
    return [
        KB.Probe(f"ops.fused_turn[B={b}]", (q, cents, *lists),
                 lambda q, c, lv, li, device: ops.fused_turn(
                     q, c, lv, li, nprobe=64, k=10, device=device)),
        KB.Probe(f"ops.fused_scan[B={b}]", (q, *lists, sel),
                 lambda q, lv, li, sel, device: ops.fused_scan(
                     q, lv, li, sel, 10, device=device)),
        KB.Probe(f"ops.fused_turn_pq[B={b}]",
                 (q, cents, tables, *pq_lists, rows),
                 lambda q, c, t, cd, li, rows, device: ops.fused_turn_pq(
                     q, c, t, cd, li, rows, nprobe=64, k=10, rerank=RERANK,
                     device=device)),
        KB.Probe(f"ops.fused_scan_pq[B={b}]",
                 (tables, *pq_lists, sel, q, rows),
                 lambda t, cd, li, sel, q, rows, device: ops.fused_scan_pq(
                     t, q, cd, li, sel, rows, 10, rerank=RERANK,
                     device=device)),
    ]


def phase_plans(dev):
    """Every probe of the ``kernels`` analysis pass, the two bf16 probes
    of the LM path (``bf16_probes``) and the stage kernels at the smoke's
    shapes (``stage_probes``), on CUDA tensors of its
    shapes, drawn from a seeded generator: the plan the recorder records
    for the call is held to the kernels torch.profiler traces (name,
    count, order, grid, block, static + dynamic shared memory), each as
    a first call on its tensors (the kept int8 scales dropped first, so
    the int8 calls run their one-time scale pass); then an int8 call
    after its first must plan no scale pass.  Returns (probes, kernels
    checked)."""
    import torch
    from repro_torch.analysis import kernel_budget as KB
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(17)
    n, bad = 0, []
    probes = (KB.default_probes() + KB.port_probes() + bf16_probes()
              + stage_probes())
    retraced = []
    for probe in probes:
        tensors = probe.tensors(dev, gen)
        ops.drop_scales()
        want = KB.planned(probe, tensors, dev)
        KB.traced.retaken = 0
        seen = KB.traced(probe, tensors, dev, want, before=ops.drop_scales)
        if KB.traced.retaken:
            retraced.append(f"{probe.label} ({KB.traced.retaken}x)")
        if seen != want or not want:
            bad.append(f"{probe.label}: the profiler saw {seen}, the plan "
                       f"says {want}")
        probe.call(*tensors, device=dev)
        again = KB.planned(probe, tensors, dev)
        if any(x[0] == "group_amax_kernel" for x in again):
            bad.append(f"{probe.label}: a second call plans the scale "
                       f"pass again: {again}")
        n += len(want)
        del tensors
        torch.cuda.empty_cache()
    if retraced:
        log("plans", f"traced again after the profiler lost kernels: "
            f"{', '.join(retraced)}")
    if bad:
        raise AssertionError("plans: " + "; ".join(bad))
    return len(probes), n


def ck_bound(c, q, kp):
    """(bytes, flops) of a centroid top-k: the table and the queries read
    once, the (B, kp) values and ids written once; 2 p d a query."""
    p, d = c.shape
    return (c.numel() * 4 + q.numel() * 4 + q.shape[0] * kp * 8,
            2 * q.shape[0] * p * d)


def phase_classic_times(args, index, convs, dev):
    """Rows 1-2 at B = 1 and 25 (the conversations' first turns), L2
    flushed: the kernel, its plain version and, for row 1, the library
    yardstick ``torch.topk(queries @ centroids.T, k)`` (two calls)."""
    import torch
    from repro_torch.kernels import ops, ref, tiling
    k, nprobe = args.k, args.nprobe
    lv, li, c = index.list_vecs, index.list_ids, index.centroids
    qs = torch.from_numpy(np.ascontiguousarray(convs[:, 0])).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {}
    for b in (1, 25):
        batches = [qs[j:j + 1] for j in range(25)] if b == 1 else [qs] * 5
        sels = [ops.centroid_topk(q, c, nprobe)[1] for q in batches]
        r_pad = tiling.next_pow2(k)
        calls = {
            "centroid_topk": (
                [lambda q=q: ops.centroid_topk(q, c, nprobe)
                 for q in batches],
                [lambda q=q: ref.centroid_topk(q, c, nprobe)
                 for q in batches],
                [ck_bound(c, q, tiling.next_pow2(nprobe)) for q in batches],
                [lambda q=q: torch.topk(q @ c.T, nprobe) for q in batches]),
            "ivf_scan": (
                [lambda q=q, s=s: ops.ivf_scan(q, lv, li, s, k)
                 for q, s in zip(batches, sels)],
                [lambda q=q, s=s: ref.ivf_scan_batch(q, lv, li, s, k)
                 for q, s in zip(batches, sels)],
                # fused_scan's bytes without the positions it writes
                [(nb - q.shape[0] * r_pad * 4, fl) for (nb, fl), q in zip(
                    [scan_bound(index, q, s, r_pad)
                     for q, s in zip(batches, sels)], batches)],
                None),
        }
        row = {}
        for name, (kern, plain, works, lib) in calls.items():
            for cs in (kern, plain, lib or []):                 # warm-up
                event_ms(cs[:2], flush, spin=True)
            row[name] = timed(kern, plain, works, flush)
            row[name]["library_ms"] = (event_ms(lib, flush, spin=True)
                                       if lib else None)
            lib_txt = (f" topk(q @ C.T)_ms={row[name]['library_ms']:.4f}"
                       if lib else "")
            log("times", f"{name} B={b}: ms={row[name]['ms']:.4f} "
                f"plain_ms={row[name]['plain_ms']:.4f}{lib_txt} "
                f"bound_ms={row[name]['bound_ms']:.4f} "
                f"({row[name]['bound_by']}) "
                f"share={row[name]['bound_ms'] / row[name]['ms']:.3f} "
                f"kernels_a_call={row[name]['kernels']}")
        out[b] = row
    return out


# ---------------------------------------------------------------------------
# phase 4: realistic floats at the smoke's shapes
# ---------------------------------------------------------------------------


def unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def realistic_lists(p, lmax, d, gen, dev):
    """Unit-norm random posting lists, ragged sizes in [lmax/2, lmax],
    list 0 empty; doc ids are flat slot numbers."""
    import torch
    lv = torch.empty((p, lmax, d), device=dev)
    for s in range(0, p, 512):
        e = min(p, s + 512)
        lv[s:e] = unit(torch.randn((e - s, lmax, d), generator=gen,
                                   device=dev))
    sizes = torch.randint(lmax // 2, lmax + 1, (p,), generator=gen,
                          device=dev)
    sizes[0] = 0
    real = torch.arange(lmax, device=dev)[None] < sizes[:, None]
    lv.masked_fill_(~real[..., None], 0.0)
    li = torch.where(real, torch.arange(p * lmax, device=dev).view(p, lmax),
                     -1).to(torch.int32)
    return lv, li


def realistic_ivf(tag, q, cents, lv, li, nprobe, k, errs, ties):
    """fused_scan and fused_turn against their plain versions on float
    lists, under the tie rule; returns the plain probe set, the centroid
    scores and the doc scorer for the PQ checks."""
    import torch
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref
    p, lmax, d = lv.shape
    rows = lv.view(p * lmax, d)
    cs = ref.gemv_rows(cents, q)
    _, sel = topk(cs, nprobe)
    sel = sel.to(torch.int32)
    docs = dot_rows(rows, q)
    # fused_scan against its plain version on the same selection
    got = ops.fused_scan(q, lv, li, sel, k)
    want = ref.fused_scan_ivf(q, lv, li, sel, None, k=k)
    err, n = compare(f"fused_scan {tag}", got[0], got[1], want[0], want[1],
                     docs, p * lmax)
    errs["fused_scan"] = max(errs["fused_scan"], err)
    ties["fused_scan"] += n
    # fused_turn: stage 1's probe set under the tie rule, stage 2
    # against the plain scan of the probe set the kernel chose
    gv, gi, gsel = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k)
    _, n = compare(f"fused_turn sel {tag}", cs.gather(1, gsel.long()),
                   gsel, cs.gather(1, sel.long()), sel, dot_rows(cents, q),
                   p)
    ties["sel"] += n
    want = ref.fused_scan_ivf(q, lv, li, gsel, None, k=k)
    err, n = compare(f"fused_turn {tag}", gv, gi, want[0], want[1], docs,
                     p * lmax)
    errs["fused_turn"] = max(errs["fused_turn"], err)
    ties["fused_turn"] += n
    return sel, cs, docs


def check_ranks(what, got, want, q, lv, li, sel, prec, r):
    """A quantised fused_scan's candidate ranks (its third output, the
    rank in the quantised order) against the plain quantised order: in
    each row the finite lanes' ranks are distinct and below r, and each
    returned id's plain quantised score lies within TOL of the plain
    version's score at the rank the kernel gave it.  So a rank may
    differ from the plain version's only where two quantised scores tie
    within TOL.  Returns the number of ranks that differ."""
    import torch
    from repro_torch.kernels import ref, tiling
    gv, gi, grank = got
    fin = torch.isfinite(gv)
    if bool(((grank < 0) | (grank >= r))[fin].any()):
        raise AssertionError(f"{what}: a candidate rank out of [0, {r})")
    lane = torch.arange(grank.shape[-1], device=grank.device)
    srt = grank.long().where(fin, -1 - lane).sort(-1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"{what}: a candidate rank repeats in a row")
    flat_i = li[sel.long()].reshape(sel.shape[0], -1)
    flat_v = torch.where(flat_i >= 0, ref.list_scores(
        q, lv, sel, prec, tiling.next_pow2(r)), float("-inf"))
    cand_v = ref._top_candidates(flat_v, flat_i, r)[0]
    # each returned id's flat position (ids are unique in these lists)
    pos = (flat_i[:, :, None] == gi[:, None, :]).int().argmax(1)
    own = flat_v.gather(1, pos)
    at = cand_v.gather(1, grank.long().clamp(0, r - 1))
    off = (own - at).abs().where(fin, torch.zeros_like(own))
    if bool((off > TOL).any()):
        raise AssertionError(f"{what}: an id sits at a candidate rank whose "
                             f"quantised score is {float(off.max())} from "
                             f"its own")
    return int(((grank != want[2]) & fin).sum())


def realistic_quant(tag, prec, q, cents, lv, li, sel, docs, tables, codes,
                    rows, nprobe, k, r, errs, ties):
    """The bf16 / int8 fused ops against their plain versions on float
    lists under the tie rule: the quantised candidates and the ADC top r
    are the plain version's (int8 exactly, bf16 up to summation order),
    the float32 re-rank within TOL; fused_scan's candidate ranks under
    the tie rule of the plain quantised scores (``check_ranks``), on the
    plain probe set and on fused_turn's, whose stage 2 is that scan
    (``csrc/fused_turn.cu`` fused_scan_ivf) and returns its bits; stage
    1's probe set under the tie rule of the plain quantised centroid
    scores."""
    import torch
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref, tiling
    p, lmax, _ = lv.shape
    r_ivf = ops._fused_depth(k, nprobe * lmax, 2 * k)
    cq = ref.centroid_scores(q, cents, prec, tiling.next_pow2(nprobe))
    _, qsel = topk(cq, nprobe)
    qsel = qsel.to(torch.int32)

    def cscore(ids):
        return cq.gather(1, ids).double()

    def check(name, got, want):
        err, n = compare(f"{name}[{prec}] {tag}", got[0], got[1], want[0],
                         want[1], docs, p * lmax)
        key = f"{name}[{prec}]"
        errs[key] = max(errs.get(key, 0.0), err)
        ties[key] += n

    got = ops.fused_scan(q, lv, li, sel, k, precision=prec)
    want = ref.fused_scan_ivf(q, lv, li, sel, None, k=k, precision=prec,
                              r=r_ivf)
    check("fused_scan", got, want)
    ties["rank"] += check_ranks(f"fused_scan[{prec}] ranks {tag}", got,
                                want, q, lv, li, sel, prec, r_ivf)
    gv, gi, gsel = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k,
                                  precision=prec)
    _, n = compare(f"fused_turn[{prec}] sel {tag}", cq.gather(1, gsel.long()),
                   gsel, cq.gather(1, qsel.long()), qsel, cscore, p)
    ties["sel"] += n
    want = ref.fused_scan_ivf(q, lv, li, gsel, None, k=k, precision=prec,
                              r=r_ivf)
    check("fused_turn", (gv, gi), want)
    # stage 2 of fused_turn is fused_scan on its probe set: the same bits,
    # and that scan's candidate ranks under the tie rule
    got = ops.fused_scan(q, lv, li, gsel, k, precision=prec)
    equal(f"fused_turn[{prec}] stage 2 {tag}", (gv, gi), got[:2],
          ("v", "ids"))
    ties["rank"] += check_ranks(f"fused_turn[{prec}] ranks {tag}", got,
                                want, q, lv, li, gsel, prec, r_ivf)
    equal(f"fused_scan_pq[{prec}] ADC top-r {tag}",
          ops.fused_scan_pq(tables, q, codes, li, sel, rows, k,
                            rerank=RERANK, fuse_rerank=False,
                            precision=prec),
          ref.fused_scan_pq(tables, q, codes, li, sel, None, rows, k=k, r=r,
                            rerank=False, precision=prec),
          ("v", "ids", "pos"))
    check("fused_scan_pq", ops.fused_scan_pq(tables, q, codes, li, sel, rows,
                                             k, rerank=RERANK,
                                             precision=prec),
          ref.fused_scan_pq(tables, q, codes, li, sel, None, rows, k=k, r=r,
                            rerank=True, precision=prec))
    gv, gi, gsel = ops.fused_turn_pq(q, cents, tables, codes, li, rows,
                                     nprobe=nprobe, k=k, rerank=RERANK,
                                     precision=prec)
    _, n = compare(f"fused_turn_pq[{prec}] sel {tag}",
                   cq.gather(1, gsel.long()), gsel, cq.gather(1, qsel.long()),
                   qsel, cscore, p)
    ties["sel_pq"] += n
    check("fused_turn_pq", (gv, gi), ref.fused_scan_pq(
        tables, q, codes, li, gsel, None, rows, k=k, r=r, rerank=True,
        precision=prec))


def phase_realistic(args, dev, errs):
    """Float IVF lists, then PQ lists over the same slots: random uint8
    codes of m = 48, random codebooks, the float rows as re-rank
    source (doc id = flat slot)."""
    import torch
    from repro_torch.core import pq, toploc
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    p, lmax, d, k = args.lists, args.lmax, args.d, args.k
    cents = unit(torch.randn((p, d), generator=gen, device=dev))
    lv, li = realistic_lists(p, lmax, d, gen, dev)
    qs = unit(torch.randn((25, d), generator=gen, device=dev))
    rows = lv.view(p * lmax, d)
    pqi = pq.IVFPQIndex(
        cents, torch.randn((PQ_M, 256, d // PQ_M), generator=gen,
                           device=dev) / math.sqrt(d // PQ_M),
        torch.randint(0, 256, (p, lmax, PQ_M), generator=gen, device=dev,
                      dtype=torch.uint8),
        li, (li >= 0).sum(1).to(torch.int32), rows)
    r = max(k, min(RERANK, args.nprobe * lmax))
    ties = dict.fromkeys(("fused_turn", "fused_scan", "sel", "fused_turn_pq",
                          "fused_scan_pq", "sel_pq", "rank") +
                         QUANT_KERNELS, 0)
    for b in (1, 25):
        q = qs[:b].contiguous()
        sel, cs, docs = realistic_ivf(f"B={b}", q, cents, lv, li,
                                      args.nprobe, k, errs, ties)
        # PQ: ADC candidates bit-equal (same sum order), exact re-rank
        # within TOL under the tie rule
        tables = toploc._adc_tables(pqi, q)
        codes = pqi.list_codes
        equal(f"pq_adc_scan B={b}", ops.pq_adc_scan(tables, codes, li, sel, r),
              ref.pq_adc_scan_batch(tables, codes, li, sel, r), ("v", "ids"))
        equal(f"fused_scan_pq ADC top-r B={b}",
              ops.fused_scan_pq(tables, q, codes, li, sel, rows, k,
                                rerank=RERANK, fuse_rerank=False),
              ref.fused_scan_pq(tables, q, codes, li, sel, None, rows, k=k,
                                r=r, rerank=False), ("v", "ids", "pos"))
        got = ops.fused_scan_pq(tables, q, codes, li, sel, rows, k,
                                rerank=RERANK)
        want = ref.fused_scan_pq(tables, q, codes, li, sel, None, rows, k=k,
                                 r=r, rerank=True)
        err, n = compare(f"fused_scan_pq B={b}", got[0], got[1], want[0],
                         want[1], docs, p * lmax)
        errs["fused_scan_pq"] = max(errs["fused_scan_pq"], err)
        ties["fused_scan_pq"] += n
        gv, gi, gsel = ops.fused_turn_pq(q, cents, tables, codes, li, rows,
                                         nprobe=args.nprobe, k=k,
                                         rerank=RERANK)
        _, n = compare(f"fused_turn_pq sel B={b}", cs.gather(1, gsel.long()),
                       gsel, cs.gather(1, sel.long()), sel,
                       dot_rows(cents, q), p)
        ties["sel_pq"] += n
        want = ref.fused_scan_pq(tables, q, codes, li, gsel, None, rows, k=k,
                                 r=r, rerank=True)
        err, n = compare(f"fused_turn_pq B={b}", gv, gi, want[0], want[1],
                         docs, p * lmax)
        errs["fused_turn_pq"] = max(errs["fused_turn_pq"], err)
        ties["fused_turn_pq"] += n
        for prec in QUANT:
            realistic_quant(f"B={b}", prec, q, cents, lv, li, sel, docs,
                            tables, codes, rows, args.nprobe, k, r, errs,
                            ties)
    torch.cuda.synchronize()
    del lv, li, rows, pqi
    torch.cuda.empty_cache()
    return ties


def phase_realistic_cand(args, dev, errs, ties):
    """fused_scan / fused_turn at the two-tower retrieval_cand shape
    through TopLoc_IVF: p = 1,024 lists of Lmax 1,220 at d = 256, k =
    100, nprobe = 32 (r_pad 128, a merge of two passes), B = 1 and 25."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    shape = TT.SHAPE_PARAMS["retrieval_cand"]
    p, nprobe = TT.TOPLOC_IVF["partitions"], TT.TOPLOC_IVF["nprobe"]
    lmax = TT.toploc_lmax(shape["n_candidates"], p)
    d, k = TT.full_config().tower_mlp[-1], shape["k"]
    cents = unit(torch.randn((p, d), generator=gen, device=dev))
    lv, li = realistic_lists(p, lmax, d, gen, dev)
    qs = unit(torch.randn((25, d), generator=gen, device=dev))
    for b in (1, 25):
        realistic_ivf(f"two-tower B={b}", qs[:b].contiguous(), cents, lv,
                      li, nprobe, k, errs, ties)
    torch.cuda.synchronize()
    return p, lmax, d, nprobe, k


# ---------------------------------------------------------------------------
# phase 5: flash attention against its plain version
# ---------------------------------------------------------------------------

# B, H, Hkv, S, Skv, D, Dv, causal
ATTN_SHAPES = [(2, 8, 8, 256, 256, 64, 64, True),      # MHA
               (2, 8, 2, 256, 256, 64, 64, True),      # GQA
               (2, 8, 2, 128, 384, 64, 64, True),      # causal S < Skv
               (2, 8, 2, 256, 256, 64, 64, False),
               (2, 8, 2, 100, 200, 64, 64, False),     # ragged S, Skv
               (2, 8, 2, 100, 200, 64, 64, True),
               (2, 8, 2, 128, 128, 48, 32, True),      # Dv != D
               (1, 12, 12, 256, 256, 64, 64, False),   # dragon query
               (DOC_BATCH, 12, 12, 256, 256, 64, 64, False),  # dragon docs
               (1, 16, 16, 256, 256, 64, 64, False),   # snowflake
               (1, 32, 4, 784, 784, 128, 128, True),   # yi-9b RAG prefill
               (1, 16, 16, 784, 784, 192, 128, True),  # deepseek MLA prefill
               (1, 8, 4, 256, 256, 256, 256, True)]    # the widest heads
# shapes whose inputs are bf16, as the LM's prefill gives them: the op
# reads them as they are (the bf16 kernel) and writes a bf16 output
ATTN_BF16 = {(1, 32, 4, 784, 784, 128, 128, True),
             (1, 16, 16, 784, 784, 192, 128, True),
             (1, 8, 4, 256, 256, 256, 256, True)}
# deepseek-v2-lite's prefill through MLA: H = Hkv = 16, D = d_head +
# d_rope = 192, Dv = d_head = 128 (a wide instance)
MLA_ATTN = (1, 16, 16, 784, 784, 192, 128, True)


def attn_inputs(shape, gen, dev):
    import torch
    b, h, hkv, s, skv, d, dv, _ = shape
    return [torch.randn(sh, generator=gen, device=dev) for sh in
            ((b, h, s, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


def phase_attn(args, dev, errs):
    """flash_attention against its plain version at every ATTN_SHAPES
    shape: the kernel's float32 result within TOL; at an ATTN_BF16 shape
    (bf16 inputs) also the op's bf16 output within one bf16 ulp of its
    row's largest |out| (each side rounds its own f32 result).  Returns
    that largest |d| in ulps."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    row_ulps = 0.0
    for shape in ATTN_SHAPES:
        causal = shape[-1]
        q, k, v = attn_inputs(shape, gen, dev)
        if shape in ATTN_BF16:
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.mha_attention(q, k, v, causal=causal)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"flash_attention {shape}: {got.shape} "
                                     f"{got.dtype}")
            _, row_ulp = bf16_ulp(want.float())
            worst = float(((got.float() - want.float()).abs()
                           / row_ulp).max())
            if not worst <= 1.0:
                raise AssertionError(f"flash_attention {shape} bf16: {worst} "
                                     f"bf16 ulps of the row's largest |out|")
            row_ulps = max(row_ulps, worst)
            q, k, v = (t.float() for t in (q, k, v))
            got = FA.flash_attention(q, k, v, causal=causal)
        else:
            got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.mha_attention(q, k, v, causal=causal)
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err <= TOL:
            raise AssertionError(f"flash_attention {shape}: max |d| {err}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    torch.cuda.synchronize()
    return row_ulps


# ---------------------------------------------------------------------------
# phase 6: flash decode against its plain version
# ---------------------------------------------------------------------------

# B, H, Hkv, S, D: GQA groups 1, 5 (qwen3-14b) and 8 (yi-9b); S = 1,000
# (not a multiple of 128), 1,024 (the RAG cache) and 32,768 (decode_32k);
# B = 1 and 8
DECODE_SHAPES = [(1, 4, 4, 1000, 128), (8, 4, 4, 1024, 128),
                 (1, 40, 8, 1024, 128), (8, 40, 8, 32_768, 128),
                 (1, 32, 4, 1000, 128), (8, 32, 4, 1024, 128),
                 (1, 32, 4, 32_768, 128), (8, 32, 4, 32_768, 128)]


def decode_lens(b, s, dev):
    """cache_len per row: at B = 8, 1, S, S + 1 (a full cache's dropped
    write) and values between; at B = 1 each of 1, S, S + 1 and S/2 in
    turn."""
    import torch
    if b == 1:
        return [torch.tensor([n], dtype=torch.int32, device=dev)
                for n in (1, s, s + 1, s // 2)]
    return [torch.tensor([1, s, s + 1, s // 2 + 3, s - 1, 17, s // 3,
                          s - 100][:b], dtype=torch.int32,
                         device=dev).clamp_min(1)]


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), and one at the
    largest |x| of each row (last axis)."""
    import torch
    tiny = torch.finfo(torch.float32).tiny
    top = x.abs().amax(-1, keepdim=True).clamp_min(tiny)
    return (torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(tiny))) - 7),
            torch.exp2(torch.floor(torch.log2(top)) - 7))


def phase_decode(args, dev, errs):
    """flash_decode against its plain version at every DECODE_SHAPES
    shape and cache_len set, on a float32 and a bfloat16 cache: the
    kernel's float32 result within TOL of the plain version's; with a
    bf16 query, the op's bf16 output within one bf16 ulp of its row's
    largest |out| (each side rounds its own f32 result).  Returns (calls,
    the largest |d| in ulps of the row's largest |out|, and in ulps of
    |out| itself)."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    calls, row_ulps, elem_ulps = 0, 0.0, 0.0
    for shape in DECODE_SHAPES:
        b, h, hkv, s, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, d), generator=gen, device=dev)
            k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            for lens in decode_lens(b, s, dev):
                what = f"flash_decode {shape} {dtype} cache_len {lens.tolist()}"
                err = float((FD.flash_decode(q, k, v, lens)
                             - ref.decode_attention(q, k, v, lens)
                             ).abs().max())
                if not err <= TOL:
                    raise AssertionError(f"{what}: f32 max |d| {err}")
                errs["flash_decode"] = max(errs["flash_decode"], err)
                qd = q.to(dtype)
                got = ops.flash_decode(qd, k, v, lens)
                want = ref.decode_attention(qd, k, v, lens)
                calls += 1
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{what}: {got.shape} {got.dtype}")
                diff = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    if not float(diff.max()) <= TOL:
                        raise AssertionError(f"{what}: {float(diff.max())}")
                    continue
                ulp, row_ulp = bf16_ulp(want.float())
                worst = float((diff / row_ulp).max())
                if not worst <= 1.0:
                    raise AssertionError(f"{what}: {worst} bf16 ulps of the "
                                         f"row's largest |out|")
                row_ulps = max(row_ulps, worst)
                elem_ulps = max(elem_ulps, float((diff / ulp).max()))
            del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return calls, row_ulps, elem_ulps


# ---------------------------------------------------------------------------
# phase 7: the bi-encoder: encode the text corpus, serve encoded queries
# ---------------------------------------------------------------------------


def pad_queries(tok, max_len):
    """Queries padded to max_len, as the reference's pipeline pads them
    (padding keys take part in attention: the length is part of the
    function)."""
    return np.pad(tok, [(0, 0)] * (tok.ndim - 1) + [(0, max_len - tok.shape[-1])])


def set_attention(model, fn, which="attention"):
    """Run every attention layer of ``model`` (GQA or MLA) through ``fn``
    (None: the kernel); ``which`` is "attention" (``flash_attention``)
    or "decode_attention" (``flash_decode``, GQA only)."""
    from repro_torch.models.layers import MLA, Attention
    for m in model.modules():
        if isinstance(m, (Attention, MLA)) and hasattr(type(m), which):
            setattr(m, which, fn)


# name fragments of cuBLAS / cuBLASLt matrix-product kernels (sm90's
# nvjet and xmma kernels, older gemm / gemv / splitK ones)
GEMM_NAMES = ("gemm", "gemv", "splitK", "nvjet", "xmma")


def profile_device(run, reps, classes):
    """Device time of ``run()`` from a torch.profiler trace of ``reps``
    runs after two warm-ups: the union of kernel intervals (busy),
    kernel time by class (the first of ``classes``, (name, substrings),
    whose substring is in the kernel's name; else "other") and kernels
    per run.  The host's own time is read without the profiler, as
    tracing slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device kernels")
    busy, end = 0.0, float("-inf")
    split = dict.fromkeys([c for c, _ in classes] + ["other"], 0.0)
    other = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        cls = next((c for c, subs in classes
                    if any(x in name for x in subs)), "other")
        split[cls] += b - a
        if cls == "other":
            other[name[:40]] = other.get(name[:40], 0.0) + b - a
    out = {"reps": reps, "busy_ms": busy / reps / 1e3,
           "kernels": len(spans) // reps}
    out.update({f"{k}_ms": v / reps / 1e3 for k, v in split.items()})
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    out["top_other"] = ", ".join(f"{n} {t / reps / 1e3:.3f}"
                                 for n, t in top)
    return out


def kernel_split(call, flush, reps=10):
    """Each kernel of one call alone: ``call()`` ``reps`` + 1 times under
    torch.profiler, the L2 flushed (``flush`` overwritten) before each;
    the flush's fill kernel splits the trace into calls, and the last
    ``reps`` are read (the trace may miss the window's first fill; a
    trace that misses calls is taken again, the host traced too, up to
    three times).
    Returns, per call, the mean device µs of each kernel (and memset) by
    name, the kernels a call and the span from the first kernel's start
    to the last one's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        flush.zero_()
        call()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    for _ in range(3):     # a session the profiler missed is taken again
        with profile(activities=acts) as prof:
            for _ in range(reps + 1):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        runs, cur = [], None
        for a, b, name in spans:
            if "FillFunctor" in name:
                cur = []
                runs.append(cur)
            elif cur is not None:
                cur.append((a, b, name))
        runs = runs[-reps:]
        if len(runs) == reps and all(runs):
            break
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        raise AssertionError(f"kernel split: {len(runs)} calls traced, "
                             f"expected {reps}")
    per = {}
    for r in runs:
        for a, b, name in r:
            short = name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0].split()[-1]
            per[short] = per.get(short, 0.0) + (b - a) / reps
    return dict(kernels=per, n=len(runs[0]),
                span=float(np.mean([r[-1][1] - r[0][0] for r in runs])))


def stage_inputs(args, dev, seed):
    """The seeded inputs of ``[stages]`` and ``--dump-rows``: p unit
    centroids, ragged unit lists of Lmax rows (``realistic_lists``), 25
    unit queries and an IVF-PQ index over the same lists with random m =
    48 x 256 codes and codewords, whose corpus rows are the list rows."""
    import torch
    from repro_torch.core import pq
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, lmax, d = args.lists, args.lmax, args.d
    cents = unit(torch.randn((p, d), generator=gen, device=dev))
    lv, li = realistic_lists(p, lmax, d, gen, dev)
    qs = unit(torch.randn((25, d), generator=gen, device=dev))
    rows = lv.view(p * lmax, d)
    pqi = pq.IVFPQIndex(
        cents, torch.randn((PQ_M, 256, d // PQ_M), generator=gen,
                           device=dev) / math.sqrt(d // PQ_M),
        torch.randint(0, 256, (p, lmax, PQ_M), generator=gen, device=dev,
                      dtype=torch.uint8),
        li, (li >= 0).sum(1).to(torch.int32), rows)
    return cents, lv, li, qs, rows, pqi


def folded(call):
    """``call()`` with stage 1 folding every query tile in its launch
    (``tiling.SELECT_FOLD_QUERIES`` raised to the widest tile)."""
    from repro_torch.kernels import tiling
    keep = tiling.SELECT_FOLD_QUERIES
    tiling.SELECT_FOLD_QUERIES = tiling.QTILE_WIDE
    try:
        return call()
    finally:
        tiling.SELECT_FOLD_QUERIES = keep


def phase_stages(args, dev):
    """Rows 1 and 3-7 split into their kernels (``kernel_split``) on
    unit-norm random lists at the smoke's shape (p = 16,384, Lmax 702,
    d = 768, ragged sizes in [Lmax / 2, Lmax]; PQ m = 48 x 256 codes):
    ``centroid_topk`` at kp = 64 (B = 1, 25) and at the top-h kp = 1,024
    (B = 1), ``fused_scan`` and ``fused_turn`` at f32 / bf16 / int8,
    ``fused_scan_pq`` at f32 / bf16 / int8 with the served re-rank depth
    64, ``fused_turn_pq`` at f32 / bf16 / int8 and ``pq_adc_scan`` (B = 1,
    25), k = 10,
    nprobe 64.  int8 calls after their warm-up read the index's cached
    scales; the one-time scale passes of the lists (35 GB) and the
    centroids are split apart at B = 1.  Also written as stages.json in
    the output directory."""
    import torch
    from repro_torch.core import toploc
    from repro_torch.kernels import ops, tiling
    k, nprobe = args.k, args.nprobe
    cents, lv, li, qs, rows, pqi = stage_inputs(args, dev, args.seed + 19)
    codes = pqi.list_codes
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {}
    for b in (1, 25):
        q = qs[:b].contiguous()
        sel = ops.centroid_topk(q, cents, nprobe)[1]
        tables = toploc._adc_tables(pqi, q)
        calls = {"centroid_topk kp=64": lambda: ops.centroid_topk(
            q, cents, nprobe)}
        if b == 1:
            calls["centroid_topk kp=1024"] = lambda: ops.centroid_topk(
                q, cents, 1024)
        for prec in ("f32",) + QUANT:
            calls[f"fused_scan[{prec}]"] = lambda prec=prec: ops.fused_scan(
                q, lv, li, sel, k, precision=prec)
        for prec in ("f32",) + QUANT:
            calls[f"fused_turn[{prec}]"] = lambda prec=prec: ops.fused_turn(
                q, cents, lv, li, nprobe=nprobe, k=k, precision=prec)
        for prec in ("f32",) + QUANT:
            calls[f"fused_scan_pq[{prec}]"] = \
                lambda prec=prec: ops.fused_scan_pq(
                    tables, q, codes, li, sel, rows, k, rerank=RERANK,
                    precision=prec)
        for prec in ("f32",) + QUANT:
            calls[f"fused_turn_pq[{prec}]"] = \
                lambda prec=prec: ops.fused_turn_pq(
                    q, cents, tables, codes, li, rows, nprobe=nprobe, k=k,
                    rerank=RERANK, precision=prec)
        calls["pq_adc_scan"] = lambda: ops.pq_adc_scan(tables, codes, li,
                                                       sel, RERANK)
        if b == 1:
            # the int8 scale pass, once per index: the lists' groups at the
            # served r_pad and the centroids' at nprobe 64
            r_q = tiling.next_pow2(2 * k)
            calls["scale pass lists"] = lambda: (
                ops.drop_scales(), ops.group_scales(
                    lv, *tiling.list_groups(args.lmax, args.d, r_q)))
            calls["scale pass centroids"] = lambda: (
                ops.drop_scales(), ops.group_scales(
                    cents, *tiling.centroid_groups(args.lists, nprobe)))
        if b == 25:
            # stage 1 folding its 32-query tile in its launch, against the
            # merge kernel the plans keep at B = 25 (tiling.select_fold)
            calls["centroid_topk kp=64 folded"] = lambda: folded(
                lambda: ops.centroid_topk(q, cents, nprobe))
            calls["fused_turn[f32] folded"] = lambda: folded(
                lambda: ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k))
        for name, call in calls.items():
            s = kernel_split(call, flush)
            out[f"{name} B={b}"] = s
            log("stages", f"{name} B={b}: {s['n']} kernels, span "
                f"{s['span']:.1f} us: " + ", ".join(
                    f"{kn} {us:.1f}" for kn, us in s["kernels"].items()))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stages.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    del lv, li, rows, pqi
    torch.cuda.empty_cache()
    return out


ADC_BATCHES = (1, 2, 4, 8, 16, 32)      # the batched engine's buckets


def phase_adc_times(args, dev):
    """The rows that run the ADC scan, by CUDA events (``event_ms``: 30
    calls, L2 flushed before each, a spin kernel queued first), on
    ``stage_inputs``'s seeded lists and PQ index at the smoke's shapes
    and 32 seeded unit queries: row 3
    ``pq_adc_scan``, row 7 ``fused_scan_pq`` with its re-rank and row 5
    ``fused_turn_pq``, at f32, bf16 and int8, at each batch the engine
    serves (``ADC_BATCHES``), with the scan's instance forced
    (``adc_bulk``: staged by the threads, or the LUT by a bulk copy),
    three times each, the two instances in turns; a line per call with
    both instances' mean times in ms, then, per call, the smallest batch
    from which the bulk instance's median is the lower (the evidence for
    ``tiling.ADC_BULK_MIN_B``).  Returns {(call, B): (staged ms, bulk
    ms)} of medians."""
    import torch
    from repro_torch.core import toploc
    from repro_torch.kernels import ops
    cents, lv, li, _, rows, pqi = stage_inputs(args, dev, args.seed + 19)
    del lv
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    qs = unit(torch.randn((max(ADC_BATCHES), args.d), generator=gen,
                          device=dev))
    codes = pqi.list_codes
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {}
    for b in ADC_BATCHES:
        q = qs[:b].contiguous()
        sel = ops.centroid_topk(q, cents, args.nprobe)[1]
        t = toploc._adc_tables(pqi, q)
        calls = {"row3 pq_adc_scan": lambda bulk: ops.pq_adc_scan(
            t, codes, li, sel, RERANK, adc_bulk=bulk)}
        for prec in ("f32",) + QUANT:
            calls[f"row7 fused_scan_pq[{prec}]"] = \
                lambda bulk, prec=prec: ops.fused_scan_pq(
                    t, q, codes, li, sel, rows, args.k, rerank=RERANK,
                    precision=prec, adc_bulk=bulk)
        for prec in ("f32",) + QUANT:
            calls[f"row5 fused_turn_pq[{prec}]"] = \
                lambda bulk, prec=prec: ops.fused_turn_pq(
                    q, cents, t, codes, li, rows, nprobe=args.nprobe,
                    k=args.k, rerank=RERANK, precision=prec, adc_bulk=bulk)
        for name, call in calls.items():
            outs = [call(bulk) for bulk in (False, True)]
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise AssertionError(f"{name} B={b}: the ADC scan's two "
                                     f"instances differ")
            torch.cuda.synchronize()
            ms = {False: [], True: []}
            for _ in range(3):
                for bulk in (False, True):
                    ms[bulk].append(event_ms([lambda: call(bulk)] * 30,
                                             flush, spin=True))
            out[(name, b)] = (float(np.median(ms[False])),
                              float(np.median(ms[True])))
            log("adc", f"{name} B={b}: staged " + " ".join(
                f"{x:.4f}" for x in ms[False]) + " | bulk " + " ".join(
                f"{x:.4f}" for x in ms[True]))
    for name in calls:
        wins = [b for b in ADC_BATCHES if out[(name, b)][1]
                < out[(name, b)][0]]
        log("adc", f"{name}: bulk faster (median) at B = "
            f"{', '.join(map(str, wins)) or 'none'}")
    return out


def phase_dump_rows(args, dev, path):
    """Rows 1-7 on the smoke's seeded realistic inputs (``stage_inputs``
    with ``phase_realistic``'s seed: p = 16,384 unit centroids, ragged
    unit lists of Lmax 702, d = 768, random m = 48 PQ codes), at B = 1,
    2, 4 and 25 (B = 2 and 4 below the ADC scan's ``ADC_BULK_MIN_B``,
    25 above it): centroid_topk (kp 64 and the top-h 1,024), ivf_scan
    (k 10), pq_adc_scan, and fused_turn / fused_scan / fused_turn_pq /
    fused_scan_pq at f32, bf16 and int8 (fused_scan also at the
    two-tower k = 100, nprobe 32), the int8 calls twice (the second on
    the scales the first left cached), every output saved to ``path``,
    so two builds of the kernels can be held to each other bit for bit
    (``torch.equal``) from two processes."""
    import torch
    from repro_torch.core import toploc
    from repro_torch.kernels import ops
    k, nprobe = args.k, args.nprobe
    cents, lv, li, qs, rows, pqi = stage_inputs(args, dev, args.seed + 1)
    codes = pqi.list_codes
    out = {}
    for b in (1, 2, 4, 25):
        q = qs[:b].contiguous()
        _, sel = ops.centroid_topk(q, cents, nprobe)
        tables = toploc._adc_tables(pqi, q)
        calls = {"centroid_topk": lambda: ops.centroid_topk(q, cents,
                                                             nprobe),
                 "centroid_topk[h]": lambda: ops.centroid_topk(q, cents,
                                                               1024),
                 "ivf_scan": lambda: ops.ivf_scan(q, lv, li, sel, k),
                 "pq_adc_scan": lambda: ops.pq_adc_scan(tables, codes, li,
                                                        sel, RERANK),
                 "fused_scan[k100]": lambda: ops.fused_scan(
                     q, lv, li, sel[:, :32].contiguous(), 100)}
        for prec in ("f32",) + QUANT:
            calls[f"fused_turn[{prec}]"] = lambda prec=prec: ops.fused_turn(
                q, cents, lv, li, nprobe=nprobe, k=k, precision=prec)
            calls[f"fused_scan[{prec}]"] = lambda prec=prec: ops.fused_scan(
                q, lv, li, sel, k, precision=prec)
            calls[f"fused_turn_pq[{prec}]"] = \
                lambda prec=prec: ops.fused_turn_pq(
                    q, cents, tables, codes, li, rows, nprobe=nprobe, k=k,
                    rerank=RERANK, precision=prec)
            calls[f"fused_scan_pq[{prec}]"] = \
                lambda prec=prec: ops.fused_scan_pq(
                    tables, q, codes, li, sel, rows, k, rerank=RERANK,
                    precision=prec)
        for name in ("fused_turn", "fused_scan", "fused_turn_pq"):
            calls[f"{name}[int8] again"] = calls[f"{name}[int8]"]
        calls["fused_scan_pq[adc]"] = lambda: ops.fused_scan_pq(
            tables, q, codes, li, sel, rows, k, rerank=RERANK,
            fuse_rerank=False)
        for name, call in calls.items():
            out[f"{name} B={b}"] = [t.cpu() for t in call()]
    torch.cuda.synchronize()
    rows_out = len(out)
    del lv, li, rows, pqi
    torch.cuda.empty_cache()
    out.update(dump_hnsw(args, dev))
    n_hnsw = len(out) - rows_out
    out.update(dump_attn(args, dev))
    torch.save(out, path)
    log("dump", f"{rows_out} outputs of rows 1-7 at B = 1, 2, 4 and 25, "
        f"{n_hnsw} of hnsw_search, {len(out) - rows_out - n_hnsw} of "
        f"flash_attention -> {path}")


def dump_attn(args, dev):
    """flash_attention (row 8) at every [attn] shape whose heads are at
    most 128 wide (the instances that predate the wide ones), on float32
    and bf16 inputs, v contiguous and as the prefill leaves it
    (transposed): {name: [out]} on the host."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    out = {}
    for shape in ATTN_SHAPES:
        if max(shape[5], shape[6]) > 128:
            continue
        causal = shape[-1]
        x = attn_inputs(shape, gen, dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in x)
            vt = v.transpose(1, 2).contiguous().transpose(1, 2)
            out[f"flash_attention {shape} {dtype}"] = [
                ops.flash_attention(q, k, v, causal=causal).cpu()]
            out[f"flash_attention {shape} {dtype} v transposed"] = [
                ops.flash_attention(q, k, vt, causal=causal).cpu()]
    return out


def dump_hnsw(args, dev, n=20_000, deg=32, levels=3):
    """hnsw_search on a seeded graph, no build needed: n unit vectors
    of d = 768, level 0 ``deg`` random neighbours a node and ``levels``
    upper levels of deg / 2 (about a tenth of each row -1 pads), a
    random entry point; 32 unit queries.  ef 32, 64 and 128 (k 10) at
    B = 1 (the first query) and 32, from the descent, from random entry
    overrides, and from the descent with a tenth of the nodes
    tombstoned: {name: [scores, ids, ndist]} on the host."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)

    def unit(rows):
        x = torch.randn((rows, args.d), generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    def links(shape):
        ids = torch.randint(0, n, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        pad = torch.rand(shape, generator=gen, device=dev) < 0.1
        return torch.where(pad, -1, ids)

    vecs, queries = unit(n), unit(32)
    adj0, upper = links((n, deg)), links((levels, n, deg // 2))
    entry = torch.randint(0, n, (), generator=gen, device=dev,
                          dtype=torch.int32)
    override = torch.randint(0, n, (32,), generator=gen, device=dev,
                             dtype=torch.int32)
    dead = torch.rand(n, generator=gen, device=dev) < 0.1
    out = {}
    for ef in (32, 64, 128):
        for b in (1, 32):
            q = queries[:b]
            for case, kw in (("descent", {}),
                             ("override", dict(entry_override=override[:b])),
                             ("tombstones", dict(deleted=dead))):
                got = ops.hnsw_search(vecs, adj0, upper, entry, q, ef=ef,
                                      k=args.k, **kw)
                out[f"hnsw_search ef={ef} {case} B={b}"] = [
                    t.cpu() for t in got]
    return out


def same_dumps(a_path, b_path):
    """``--same-dumps A B``: every output of two ``--dump-rows`` files
    ``torch.equal`` (dtype, shape and bits); returns the count compared,
    raises on the first difference."""
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        raise AssertionError(f"the dumps hold other outputs: "
                             f"{sorted(a.keys() ^ b.keys())}")
    for name in a:
        for x, y in zip(a[name], b[name], strict=True):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{name}: the two dumps differ")
    return len(a), sum(len(v) for v in a.values())


def profile_query_tower(enc, q, reps=5):
    """The query tower at B = 1: device busy time, cuBLAS GEMMs,
    ``flash_attention`` and the rest (``profile_device``)."""
    return profile_device(lambda: enc.encode_queries(q, q > 0), reps,
                          (("flash_attention", ("flash_bf16",
                                                 "flash_tf32")),
                           ("gemm", GEMM_NAMES)))


def phase_encode(args, dev, cfg, errs):
    """The doc tower over the text corpus in batches, the plain-attention
    check on the card, and one snowflake query batch."""
    import torch
    from repro_torch.configs import encoders as C
    from repro_torch.data import synthetic as SY
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encoder as E
    t0 = time.perf_counter()
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=args.enc_docs, d=args.d, n_topics=256, doc_spread=0.35,
        n_conversations=25, turns_per_conversation=10, query_drift=0.15,
        walk_step=0.05, shift_prob=0.15, seed=args.seed))
    docs_tok, conv_tok = SY.make_text_corpus(
        wl, vocab=cfg.vocab, doc_len=cfg.max_len, query_len=Q_LEN,
        seed=args.seed + 1)
    t_text = time.perf_counter() - t0
    enc = E.init_params(cfg, seed=args.seed, device=dev)
    tok = torch.from_numpy(docs_tok).to(dev)
    embs = torch.empty((args.enc_docs, cfg.d_out), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, args.enc_docs, DOC_BATCH):
        batch = tok[s:s + DOC_BATCH]
        embs[s:s + DOC_BATCH] = enc.encode_docs(batch, batch > 0)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    calls = -(-args.enc_docs // DOC_BATCH)
    launches = ops.flash_attention.launches
    if launches != cfg.n_layers * calls:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {calls} doc-tower calls")
    norms = embs.norm(dim=-1)
    if not bool(torch.isfinite(embs).all()) or \
            float((norms - 1).abs().max()) > 1e-4:
        raise AssertionError("doc embeddings not finite and unit-norm")
    # the kernel path against the same towers with the plain attention,
    # at the served shapes: four queries one at a time, one doc batch
    qs = torch.from_numpy(pad_queries(conv_tok[:4, 0], cfg.max_len)).to(dev)
    checks = {}
    for side, batches in (("queries", qs.split(1)),
                          ("docs", [tok[:DOC_BATCH]])):
        fn = getattr(enc, f"encode_{side}")
        got = [fn(t, t > 0) for t in batches]
        set_attention(enc, ref.mha_attention)
        want = [fn(t, t > 0) for t in batches]
        set_attention(enc, None)
        checks[side] = max(float((g - w).abs().max())
                           for g, w in zip(got, want))
        if not checks[side] <= TOL:
            raise AssertionError(f"{side}: kernel vs plain attention "
                                 f"{checks[side]}")
    errs["flash_attention"] = max(errs["flash_attention"], *checks.values())
    prof = profile_query_tower(enc, qs[:1])
    log("encode", f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
        f"max_len={cfg.max_len} params={cfg.param_count() / 1e6:.1f}M: "
        f"{args.enc_docs} docs of {cfg.max_len} tokens (cut: "
        f"{args.enc_docs:,} of {MSMARCO_DOCS:,} MS MARCO passages) in "
        f"batches of {DOC_BATCH}: text_s={t_text:.1f} encode_s={t_enc:.1f} "
        f"docs_per_s={args.enc_docs / t_enc:.1f} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"flash_attention_launches={launches} (= {cfg.n_layers} x {calls} "
        f"tower calls); kernel vs plain attention, same towers: "
        f"4 queries at B=1 max_abs_err={checks['queries']:.3g}, "
        f"{DOC_BATCH} docs max_abs_err={checks['docs']:.3g} (tol {TOL})")
    log("profile", f"{cfg.name} query tower, B=1, {Q_LEN} tokens padded to "
        f"{cfg.max_len} (torch.profiler, {prof.pop('reps')} encodes; device "
        f"ms per query): " + " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                                      else f"{k}={v}"
                                      for k, v in prof.items()))
    # the second config: one query batch through the shared tower
    scfg = C.snowflake_config()
    snow = E.init_params(scfg, seed=args.seed, device=dev)
    sq = torch.from_numpy(pad_queries(conv_tok[:, 0], scfg.max_len)).to(dev)
    before = ops.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = snow.encode_queries(sq, sq > 0)
    torch.cuda.synchronize()
    t_snow = time.perf_counter() - t0
    if out.shape != (sq.shape[0], scfg.d_out) or \
            not bool(torch.isfinite(out).all()) or \
            float((out.norm(dim=-1) - 1).abs().max()) > 1e-4:
        raise AssertionError("snowflake embeddings not finite and unit-norm")
    log("encode", f"{scfg.name} L={scfg.n_layers} d={scfg.d_model} "
        f"H={scfg.n_heads} shared towers={snow.query is snow.doc}: "
        f"{sq.shape[0]} queries in {t_snow * 1e3:.1f} ms, "
        f"flash_attention_launches={ops.flash_attention.launches - before}")
    del snow, out, tok
    torch.cuda.empty_cache()
    return enc, embs, wl, docs_tok, conv_tok, launches


def phase_encode_serve(args, dev, enc, embs, wl, conv_tok):
    """An IVF over the doc embeddings; each turn encodes its query at
    B = 1, as a live assistant would, then calls ``engine.query``.
    Returns the index and the launch counts summed over the paths."""
    import torch
    from repro_torch.core import ivf
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    t0 = time.perf_counter()
    index = ivf.build(embs, args.enc_lists, iters=args.iters, seed=args.seed,
                      capacity_factor=1.3)
    torch.cuda.synchronize()
    log("serve", f"encoder index: {args.enc_docs} dragon doc embeddings, "
        f"p={args.enc_lists} lmax={index.lmax} build_s="
        f"{time.perf_counter() - t0:.1f}")
    q_tok = torch.from_numpy(pad_queries(conv_tok, enc.cfg.max_len)).to(dev)
    n_conv, turns = conv_tok.shape[:2]

    def run(knobs, n_conv, turns):
        eng = ConversationalSearchEngine(
            ServingConfig(backend="ivf", precision="f32", **knobs),
            ivf_index=index)
        enc_ms, hits = [], 0
        for c in range(n_conv):
            for t in range(turns):
                tok = q_tok[c, t][None]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                qv = enc.encode_queries(tok, tok > 0)[0]
                torch.cuda.synchronize()
                enc_ms.append((time.perf_counter() - t0) * 1e3)
                _, ids = eng.query(f"c{c}", qv)
                hits += int(wl.doc_topic[ids[0]] == wl.conv_topics[c, t])
        return eng, np.asarray(enc_ms), hits

    for _, knobs in SERVE:                       # warm every path
        run(knobs, 1, 2)
    counts = {}
    for name, knobs in SERVE:
        ops.reset_launches()
        eng, enc_ms, hits = run(knobs, n_conv, turns)
        n = launch_counts()
        counts = {k: counts.get(k, 0) + n[k] for k in n}
        if n["flash_attention"] != enc.cfg.n_layers * n_conv * turns:
            raise AssertionError(f"encoder {name}: {n['flash_attention']} "
                                 f"flash_attention launches")
        ret_ms = np.asarray([r.latency_s for r in eng.records]) * 1e3
        s = eng.summary()
        log("serve", f"encoder ivf {name}: turns={s['turns']} "
            f"encode_p50_ms={np.percentile(enc_ms, 50):.3f} "
            f"encode_p95_ms={np.percentile(enc_ms, 95):.3f} "
            f"retrieval_p50_ms={np.percentile(ret_ms, 50):.3f} "
            f"retrieval_p95_ms={np.percentile(ret_ms, 95):.3f} "
            f"mean_centroid_dists={s['mean_centroid_dists']:.1f} "
            f"mean_list_dists={s['mean_list_dists']:.1f} "
            f"refresh_rate={s['refresh_rate']:.3f} "
            f"topic_p@1={hits / s['turns']:.3f} " + " ".join(
                f"{k}_launches={n[k]}" for k in ENC_KERNELS + IVF_KERNELS))
    if min(counts[k] for k in ENC_KERNELS + IVF_KERNELS) == 0:
        raise AssertionError(f"encoder path: a kernel was not launched: "
                             f"{counts}")
    del q_tok
    torch.cuda.empty_cache()
    return index, counts


# ---------------------------------------------------------------------------
# phase 8: retrieval-augmented answers: the encoder path's retriever feeds
# Yi-9B at full width and depth
# ---------------------------------------------------------------------------

RAG_CONVS, RAG_TURNS, RAG_K = 4, 4, 3     # 16 turns; 3 docs a prompt
RAG_MAX_LEN, RAG_GEN = 1024, 32           # cache positions; greedy steps
DECODE32K_B, DECODE32K_STEPS = 8, 10      # decode_32k cut from B = 128


def rag_turn(enc, eng, lm, conv, q_tok, q_host, docs_tok, times=None):
    """One turn of examples/rag_serving.py: encode the query (B = 1),
    retrieve with the conversation's session, prefill the retrieved docs'
    tokens and the query's, decode RAG_GEN greedy steps.  Returns a
    device flag: every logit finite."""
    import torch
    clock = time.perf_counter
    torch.cuda.synchronize()
    t0 = clock()
    qv = enc.encode_queries(q_tok[None], q_tok[None] > 0)[0]
    torch.cuda.synchronize()
    t1 = clock()
    _, ids = eng.query(conv, qv)
    prompt = np.concatenate([docs_tok[i] for i in ids[:RAG_K]] + [q_host])
    torch.cuda.synchronize()
    t2 = clock()
    logits, cache, clen = lm.prefill(prompt[None], RAG_MAX_LEN)
    torch.cuda.synchronize()
    t3 = clock()
    ok = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    for _ in range(RAG_GEN):
        logits, cache = lm.decode_step(cache, tok, clen)
        clen = clen + 1
        ok &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t4 = clock()
    if times is not None:
        for name, t in (("encode", t1 - t0), ("prefill", t3 - t2),
                        ("token", (t4 - t3) / RAG_GEN)):
            times[name].append(t * 1e3)
    return ok, prompt.shape[0]


def phase_rag(args, dev, enc, index, docs_tok, conv_tok):
    """Yi-9B at full width and depth (bf16, random weights from a seeded
    CUDA generator) answers RAG_CONVS conversations x RAG_TURNS turns:
    each turn's query goes through the dragon query tower at B = 1 and
    fused toploc+ over the encoder path's IVF (k = 3), the 3 docs (256
    tokens each) and the 16 query tokens are prefilled (784 tokens,
    cache max_len 1,024) and RAG_GEN tokens decoded greedily.  First,
    outside the counted run: the prefill of a 784-token prompt through
    the plain attention against flash_attention (logits and both caches
    within 5e-2 of the plain side's largest |value|), then one decode
    step through the plain decode attention against the kernel's, the
    same 48 layers.  Launch counts
    are set to 0 just before the 16 turns and read just after."""
    import torch
    from repro_torch.configs import yi_9b
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    cfg = yi_9b.full_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = TF.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    q_tok = torch.from_numpy(pad_queries(conv_tok, enc.cfg.max_len)).to(dev)
    knobs = dict(backend="ivf", strategy="toploc+", fused=True, k=RAG_K,
                 precision="f32")
    # warm-up turn, then the kernel against the plain decode attention
    warm = ConversationalSearchEngine(ServingConfig(**knobs),
                                      ivf_index=index)
    rag_turn(enc, warm, lm, "warm", q_tok[0, 0], conv_tok[0, 0], docs_tok)
    _, ids = warm.query("warm", enc.encode_queries(
        q_tok[0, 1][None], q_tok[0, 1][None] > 0)[0])
    prompt = np.concatenate([docs_tok[i] for i in ids[:RAG_K]]
                            + [conv_tok[0, 1]])
    set_attention(lm, ref.mha_attention)
    want_pre = lm.prefill(prompt[None], RAG_MAX_LEN)[:2]
    set_attention(lm, None)
    logits, cache, clen = lm.prefill(prompt[None], RAG_MAX_LEN)
    pre_err = {}
    for name, got_t, want_t in (("logits", logits, want_pre[0]),
                                ("k", cache["k"], want_pre[1]["k"]),
                                ("v", cache["v"], want_pre[1]["v"])):
        d = float((got_t.float() - want_t.float()).abs().max())
        top = float(want_t.float().abs().max())
        pre_err[name] = d / top
        if not (bool(torch.isfinite(got_t).all()) and d <= 5e-2 * top):
            raise AssertionError(f"yi-9b prefill of {prompt.shape[0]} tokens, "
                                 f"kernel vs plain attention: {name} max |d| "
                                 f"{d} of {top}")
    del want_pre
    tok = logits.argmax(-1)
    got, _ = lm.decode_step(cache, tok, clen)
    set_attention(lm, ref.decode_attention, "decode_attention")
    want, _ = lm.decode_step(cache, tok, clen)
    set_attention(lm, None, "decode_attention")
    scale = float(want.abs().max())
    step_err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and step_err <= 5e-2 * scale):
        raise AssertionError(f"yi-9b decode step, kernel vs plain decode "
                             f"attention: max |d logit| {step_err} of "
                             f"{scale}")
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    del logits, cache, got, want
    eng = ConversationalSearchEngine(ServingConfig(**knobs), ivf_index=index)
    times = {"encode": [], "prefill": [], "token": []}
    ops.reset_launches()
    ok, plen = None, 0
    for c in range(RAG_CONVS):
        for t in range(RAG_TURNS):
            flag, plen = rag_turn(enc, eng, lm, f"c{c}", q_tok[c, t],
                                  conv_tok[c, t], docs_tok, times)
            ok = flag if ok is None else ok & flag
    n = launch_counts()
    turns = RAG_CONVS * RAG_TURNS
    if not bool(ok):
        raise AssertionError("rag: a logit is not finite")
    want_fd = cfg.n_layers * RAG_GEN * turns
    if n["flash_decode"] != want_fd:
        raise AssertionError(f"rag: {n['flash_decode']} flash_decode "
                             f"launches, want {want_fd}")
    if n["flash_attention"] != (cfg.n_layers + enc.cfg.n_layers) * turns:
        raise AssertionError(f"rag: {n['flash_attention']} flash_attention "
                             f"launches")
    if n["fused_scan"] + n["fused_turn"] == 0:
        raise AssertionError("rag: retrieval launched no kernel")
    # the device's share of a decode step at B = 1 (after the counted run)
    logits, cache, clen = lm.prefill(prompt[None], RAG_MAX_LEN)
    tok = logits.argmax(-1)
    prof = profile_device(lambda: lm.decode_step(cache, tok, clen), 5,
                          (("flash_decode", ("decode_mma",
                                             "decode_split",
                                             "decode_combine")),
                           ("gemm", GEMM_NAMES)))
    del logits, cache
    ret = np.asarray([r.latency_s for r in eng.records]) * 1e3
    pct = {name: np.percentile(v, [50, 95]) for name, v in
           (("encode", times["encode"]), ("retrieval", ret),
            ("prefill", times["prefill"]), ("token", times["token"]))}
    log("rag", f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} kv={cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} params={cfg.param_count():,} bf16 "
        f"(init_s={t_init:.2f}); retriever dragon query tower B=1 + ivf "
        f"toploc+ fused p={index.p} k={RAG_K}; {RAG_CONVS} conversations x "
        f"{RAG_TURNS} turns, prompt {plen} tokens ({RAG_K} docs x "
        f"{docs_tok.shape[1]} + {Q_LEN}), max_len {RAG_MAX_LEN}, "
        f"{RAG_GEN} greedy tokens a turn: " + " ".join(
            f"{name}_p50_ms={v[0]:.3f} {name}_p95_ms={v[1]:.3f}"
            for name, v in pct.items() if name != "token") +
        f" ms_per_token_p50={pct['token'][0]:.3f} "
        f"ms_per_token_p95={pct['token'][1]:.3f} "
        f"flash_decode_launches={n['flash_decode']} (= {cfg.n_layers} x "
        f"{RAG_GEN} x {turns}) flash_attention_launches="
        f"{n['flash_attention']} (prefill {cfg.n_layers * turns} + query "
        f"tower {enc.cfg.n_layers * turns}) fused_scan_launches="
        f"{n['fused_scan']} fused_turn_launches={n['fused_turn']} "
        f"logits finite; prefill through flash_attention vs the plain "
        f"attention, all layers: max |d| / max |plain| " + " ".join(
            f"{n}={e:.4g}" for n, e in pre_err.items()) + " (tol 5e-2); "
        f"kernel vs plain decode attention, one step "
        f"through all layers: max |d logit| {step_err:.4g} of "
        f"{scale:.4g}, same top-1 {same_top} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    log("profile", f"{cfg.name} decode step, B=1, cache_len "
        f"{prompt.shape[0]} "
        f"(torch.profiler, {prof.pop('reps')} steps; device ms per step): "
        + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in prof.items())
        + f"; host-clock ms a token p50 {pct['token'][0]:.3f}, so the "
        f"card idles {1 - prof['busy_ms'] / pct['token'][0]:.3f} of it")
    del lm, q_tok
    torch.cuda.empty_cache()
    return n


def decode_floor_bytes(cfg, max_len):
    """Bytes one B = 1 decode step of an MoE / MLA LM must read: every
    weight but the embedding (one row of it), since the reference's
    dense dispatch multiplies every expert's bank, and the whole latent
    cache (its einsums run over all max_len positions, masked after)."""
    import torch
    esz = torch.empty((), dtype=cfg.dtype).element_size()
    weights = (cfg.param_count() - (cfg.vocab - 1) * cfg.d_model) * esz
    return weights + cfg.kv_bytes_per_token() * max_len


def moe_prefill_gate(lm, prompt, tol=5e-2):
    """An MLA / MoE LM's prefill of ``prompt`` through flash_attention
    against the same prefill through the plain attention, with the kernel
    run's routing taken from the plain run's (teacher-forced): a bf16
    ulp apart in one attention output can flip a token's top-k experts, a
    discontinuous change (as a near tie in any top-k is) after which the
    two runs take other paths.  So each routing call of the kernel run
    takes the plain run's top-k experts, weighted by its own router
    probabilities at them, and the logits, ckv and krope of every layer
    are held within ``tol`` of the plain side's largest |value|.  Returns
    its line, with the tokens whose own top-k differs from the plain
    run's, a layer (a diagnostic, not gated)."""
    import types
    import torch
    from repro_torch.core import topk as core_topk
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    cfg = lm.cfg
    routes, flips = [], []

    def record(probs, k):
        w, e = core_topk.topk(probs, k)
        routes.append(e)
        return w, e

    def forced(probs, k):
        e = routes[len(flips)]
        own = core_topk.topk(probs, k)[1]
        flips.append(int((own.sort(-1).values != e.sort(-1).values)
                         .any(-1).sum()))
        return probs.gather(-1, e), e

    def run(attention, route):
        set_attention(lm, attention)
        layers._topk = types.SimpleNamespace(topk=route)
        try:
            return lm.prefill(prompt[None], RAG_MAX_LEN)
        finally:
            layers._topk = core_topk
            set_attention(lm, None)

    def rel(got, want):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{cfg.name} prefill: not finite")
        d = float((got.float() - want.float()).abs().max())
        return d / float(want.float().abs().max())

    want = run(ref.mha_attention, record)
    got = run(None, forced)
    if len(flips) != len(routes) or len(routes) % cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefill: {len(routes)} routing "
                             f"calls recorded, {len(flips)} forced")
    per = len(routes) // cfg.n_layers
    flips = [sum(flips[i:i + per]) for i in range(0, len(flips), per)]
    err = {"logits": rel(got[0], want[0])}
    err.update({n: rel(got[1][n], want[1][n]) for n in ("ckv", "krope")})
    s = prompt.shape[0]
    if max(err.values()) > tol:
        raise AssertionError(
            f"{cfg.name} prefill of {s} tokens, kernel vs plain attention, "
            f"the plain run's routing: max |d| / max |plain| {err} (tol "
            f"{tol}); own routing flips a layer {flips}")
    return (f"{s} tokens, all {cfg.n_layers} layers, the kernel run "
            f"routed as the plain run: max |d| / max |plain| " + " ".join(
                f"{n}={e:.4g}" for n, e in err.items())
            + f" (tol {tol}), same top-1 "
            f"{bool((got[0].argmax(-1) == want[0].argmax(-1)).all())}; "
            f"tokens whose own top-{cfg.top_k} experts would differ, a "
            f"layer: {','.join(map(str, flips))}")


def phase_rag_deepseek(args, dev, enc, index, docs_tok, conv_tok):
    """DeepSeek-V2-Lite at full width and depth (27 layers, MLA with a
    512 + 64 latent, 64 routed experts top-6 and 2 shared, bf16, random
    weights from a seeded CUDA generator) answers the same RAG turns as
    [rag]: RAG_CONVS x RAG_TURNS, the dragon query tower at B = 1, fused
    toploc+ over the encoder path's IVF (k = 3), a 784-token prompt (its
    MLA prefill through flash_attention at D = 192, Dv = 128) and RAG_GEN
    greedy tokens (the absorbed MLA decode, einsums).  First, outside
    the counted run: the prompt's prefill through flash_attention held
    to the same prefill through the plain attention
    (``moe_prefill_gate``).  Launch
    counts are set to 0 just before the turns and read just after; a
    decode step is profiled after them (device ms, kernels a step)."""
    import torch
    from repro_torch.configs import deepseek_v2_lite_16b as DS
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    cfg = DS.full_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    lm = TF.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    q_tok = torch.from_numpy(pad_queries(conv_tok, enc.cfg.max_len)).to(dev)
    knobs = dict(backend="ivf", strategy="toploc+", fused=True, k=RAG_K,
                 precision="f32")
    warm = ConversationalSearchEngine(ServingConfig(**knobs),
                                      ivf_index=index)
    rag_turn(enc, warm, lm, "warm", q_tok[0, 0], conv_tok[0, 0], docs_tok)
    _, ids = warm.query("warm", enc.encode_queries(
        q_tok[0, 1][None], q_tok[0, 1][None] > 0)[0])
    prompt = np.concatenate([docs_tok[i] for i in ids[:RAG_K]]
                            + [conv_tok[0, 1]])
    t0 = time.perf_counter()
    gate = moe_prefill_gate(lm, prompt)
    t_gate = time.perf_counter() - t0
    eng = ConversationalSearchEngine(ServingConfig(**knobs), ivf_index=index)
    times = {"encode": [], "prefill": [], "token": []}
    ops.reset_launches()
    ok, plen = None, 0
    for c in range(RAG_CONVS):
        for t in range(RAG_TURNS):
            flag, plen = rag_turn(enc, eng, lm, f"c{c}", q_tok[c, t],
                                  conv_tok[c, t], docs_tok, times)
            ok = flag if ok is None else ok & flag
    n = launch_counts()
    turns = RAG_CONVS * RAG_TURNS
    if not bool(ok):
        raise AssertionError(f"{cfg.name}: a logit is not finite")
    if n["flash_attention"] != (cfg.n_layers + enc.cfg.n_layers) * turns:
        raise AssertionError(f"{cfg.name}: {n['flash_attention']} "
                             f"flash_attention launches")
    if n["flash_decode"] or n["fused_scan"] + n["fused_turn"] == 0:
        raise AssertionError(f"{cfg.name}: launches {n}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a decode step at B = 1, after the counted run
    logits, cache, clen = lm.prefill(prompt[None], RAG_MAX_LEN)
    tok = logits.argmax(-1)
    prof = profile_device(lambda: lm.decode_step(cache, tok, clen), 5,
                          (("gemm", GEMM_NAMES),))
    del logits, cache
    floor = decode_floor_bytes(cfg, RAG_MAX_LEN)
    active = cfg.active_param_count() * 2
    ret = np.asarray([r.latency_s for r in eng.records]) * 1e3
    pct = {name: np.percentile(v, [50, 95]) for name, v in
           (("encode", times["encode"]), ("retrieval", ret),
            ("prefill", times["prefill"]), ("token", times["token"]))}
    log("rag", f"{cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} MLA r={cfg.kv_lora_rank}+{cfg.d_rope} MoE "
        f"{cfg.n_experts} routed top-{cfg.top_k} + {cfg.n_shared} shared "
        f"ff={cfg.expert_ff} vocab={cfg.vocab} params="
        f"{cfg.param_count():,} (active {cfg.active_param_count():,}) "
        f"{str(cfg.dtype)[6:]} (init_s={t_init:.2f}); the [rag] turns: "
        f"{RAG_CONVS} x "
        f"{RAG_TURNS}, prompt {plen} tokens, max_len {RAG_MAX_LEN}, "
        f"{RAG_GEN} greedy tokens a turn: " + " ".join(
            f"{name}_p50_ms={v[0]:.3f} {name}_p95_ms={v[1]:.3f}"
            for name, v in pct.items() if name != "token") +
        f" ms_per_token_p50={pct['token'][0]:.3f} "
        f"ms_per_token_p95={pct['token'][1]:.3f} beside the decode's byte "
        f"floor {floor / 1e9:.2f} GB a token = "
        f"{floor / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s (every "
        f"expert's bank: the reference's dense dispatch; the active "
        f"{active / 1e9:.2f} GB would be "
        f"{active / HBM_BYTES_PER_S * 1e3:.3f} ms); "
        f"flash_attention_launches={n['flash_attention']} (prefill "
        f"{cfg.n_layers * turns} at D=192 Dv=128 + query tower "
        f"{enc.cfg.n_layers * turns}) fused_scan_launches="
        f"{n['fused_scan']} fused_turn_launches={n['fused_turn']} logits "
        f"finite; prefill through flash_attention vs the plain attention: "
        f"{gate} (gate_s={t_gate:.2f}); max_mem_gb={peak_gb:.2f} "
        f"phase_s={time.perf_counter() - t_phase:.2f}")
    log("profile", f"{cfg.name} decode step, B=1, cache_len "
        f"{prompt.shape[0]} (torch.profiler, {prof.pop('reps')} steps; "
        f"device ms per step): " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in prof.items())
        + f"; kernels a token {prof['kernels']}; host-clock ms a token p50 "
        f"{pct['token'][0]:.3f}, so the card idles "
        f"{1 - prof['busy_ms'] / pct['token'][0]:.3f} of it")
    del lm, q_tok
    torch.cuda.empty_cache()
    return n


# ---------------------------------------------------------------------------
# phase 9: two-tower retrieval at full width, served with TopLoc
# ---------------------------------------------------------------------------

TT_CHUNK = 65_536       # items per item-tower call while encoding the corpus
TT_REQS = 10            # requests per user session


def phase_twotower(args, dev, cfg):
    """The model from a seeded CUDA generator; embedding_bag held to its
    plain version on the full table at its last rows (byte offsets past
    2^31) and the user tower at B = 512 held to the same tower with the
    plain bag; the item tower over the retrieval_cand corpus; its IVF."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.core import ivf
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys as R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.two_tower_init(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    rows = model.table.shape[0]
    ids = torch.randint(rows - 4096, rows, (512, cfg.history_len),
                        generator=gen, device=dev, dtype=torch.int32)
    ids[:, 0] = rows - 1
    top_err = float((ops.embedding_bag(model.table, ids, agg="mean")
                     - ref.embedding_bag(model.table, ids, mode="mean")
                     ).abs().max())
    uid = torch.randint(0, cfg.user_vocab, (512,), generator=gen,
                        device=dev, dtype=torch.int32)
    hist = torch.randint(-1, cfg.item_vocab, (512, cfg.history_len),
                         generator=gen, device=dev, dtype=torch.int32)
    shifted = torch.where(hist >= 0, hist + model.offsets[1], -1)
    plain = unit(model.user_mlp(torch.cat(
        [model.table[uid.long()],
         ref.embedding_bag(model.table, shifted, mode="mean")], -1)))
    tower_err = float((model.user_tower(uid, hist) - plain).abs().max())
    if not (top_err <= BAG_TOL and tower_err <= TOL):
        raise AssertionError(f"two-tower: embedding_bag at the last rows "
                             f"{top_err}, user tower {tower_err}")
    n_items = args.tt_items
    if n_items > cfg.item_vocab:
        raise ValueError(f"{n_items} items > item_vocab {cfg.item_vocab}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = torch.empty((n_items, cfg.tower_mlp[-1]), device=dev)
    for s in range(0, n_items, TT_CHUNK):
        e = min(n_items, s + TT_CHUNK)
        corpus[s:e] = model.item_tower(
            torch.arange(s, e, device=dev, dtype=torch.int32))
    torch.cuda.synchronize()
    t_items = time.perf_counter() - t0
    if not bool(torch.isfinite(corpus).all()) or \
            float((corpus.norm(dim=-1) - 1).abs().max()) > 1e-4:
        raise AssertionError("item vectors not finite and unit-norm")
    p = TT.TOPLOC_IVF["partitions"]
    t0 = time.perf_counter()
    index = ivf.build(corpus, p, iters=args.iters, seed=args.seed,
                      capacity_factor=1.25)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if index.n_docs != n_items:
        raise AssertionError("the item index lost items")
    log("twotower", f"{cfg.name} embed={cfg.embed_dim} mlp="
        f"{'-'.join(map(str, cfg.tower_mlp))} users={cfg.user_vocab:,} "
        f"items={cfg.item_vocab:,} history={cfg.history_len} "
        f"params={cfg.param_count() / 1e6:.1f}M table_gb="
        f"{model.table.numel() * 4 / 1e9:.2f}: init_s={t_init:.2f}; "
        f"embedding_bag at rows [V-4096, V) of the table, B=512: "
        f"max_abs_err={top_err:.3g} (tol {BAG_TOL}); user tower B=512 vs "
        f"the plain bag: max_abs_err={tower_err:.3g} (tol {TOL}); "
        f"item tower over {n_items:,} items in calls of {TT_CHUNK:,}: "
        f"items_s={t_items:.2f} ({n_items / t_items:,.0f} items/s); "
        f"ivf.build p={p} capacity 1.25 iters={args.iters}: "
        f"build_s={t_build:.2f} lmax={index.lmax} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return model, corpus, index


def recsys_sessions(cfg, n_users, n_items, seed):
    """User sessions after examples/recsys_retrieval.py: each user has an
    id and a base history of cfg.history_len items; request r rolls the
    history by r and replaces its first item.  Host numpy, as requests
    arrive: [(user, user_id (1,), history (1, L))], user-major."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n_users):
        uid = np.asarray([rng.integers(cfg.user_vocab)], np.int32)
        base = rng.integers(0, n_items, cfg.history_len)
        for r in range(TT_REQS):
            hist = np.roll(base, r)
            hist[0] = rng.integers(0, n_items)
            out.append((u, uid, hist[None].astype(np.int32)))
    return out


def phase_recsys_serve(args, dev, model, corpus, index):
    """Each request: the user tower at B = 1 (one embedding_bag launch),
    then engine.query with the two-tower TopLoc_IVF knobs, one session
    per user.  Per path (after a warm-up; launch counts set to 0 just
    before, read just after): tower and retrieval p50/p95, the counters,
    recall@k against the brute-force retrieval_cand step; then fused ==
    unfused toploc+.  Returns the summed launch counts and the toploc+
    fused run's user vectors."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    k = TT.SHAPE_PARAMS["retrieval_cand"]["k"]
    knobs0 = dict(backend="ivf", k=k, nprobe=TT.TOPLOC_IVF["nprobe"],
                  h=TT.TOPLOC_IVF["h"], alpha=0.1, precision="f32")
    reqs = recsys_sessions(model.cfg, args.tt_users, corpus.shape[0],
                           args.seed)
    gold = [TT.retrieval_step(model, uid, hist, corpus, k)[1][0].cpu()
            .numpy() for _, uid, hist in reqs]

    def run(knobs, reqs):
        eng = ConversationalSearchEngine(ServingConfig(**knobs0, **knobs),
                                         ivf_index=index)
        tower_ms, vecs, vs, ids = [], [], [], []
        for u, uid, hist in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uv = model.user_tower(uid, hist)[0]
            torch.cuda.synchronize()
            tower_ms.append((time.perf_counter() - t0) * 1e3)
            v, i = eng.query(f"u{u}", uv)
            vecs.append(uv)
            vs.append(v)
            ids.append(i)
        return eng, np.asarray(tower_ms), torch.stack(vecs), np.stack(vs), \
            np.stack(ids)

    for _, knobs in SERVE:                       # warm every path
        run(knobs, reqs[:2])
    runs, counts = {}, {}
    for name, knobs in SERVE:
        ops.reset_launches()
        eng, tower_ms, vecs, vs, ids = run(knobs, reqs)
        n = launch_counts()
        counts = {kk: counts.get(kk, 0) + n[kk] for kk in n}
        if n["embedding_bag"] != len(reqs):
            raise AssertionError(f"recsys {name}: {n['embedding_bag']} "
                                 f"embedding_bag launches for {len(reqs)} "
                                 f"requests")
        recall = np.mean([len(set(i) & set(g)) / k
                          for i, g in zip(ids, gold)])
        ret_ms = np.asarray([r.latency_s for r in eng.records]) * 1e3
        s = eng.summary()
        log("recsys serve", f"ivf {name}: users={args.tt_users} "
            f"requests={s['turns']} k={k} nprobe={knobs0['nprobe']} "
            f"h={knobs0['h']} tower_p50_ms={np.percentile(tower_ms, 50):.3f} "
            f"tower_p95_ms={np.percentile(tower_ms, 95):.3f} "
            f"retrieval_p50_ms={np.percentile(ret_ms, 50):.3f} "
            f"retrieval_p95_ms={np.percentile(ret_ms, 95):.3f} "
            f"mean_centroid_dists={s['mean_centroid_dists']:.1f} "
            f"mean_list_dists={s['mean_list_dists']:.1f} "
            f"refresh_rate={s['refresh_rate']:.3f} recall@{k}={recall:.4f} "
            + " ".join(f"{kk}_launches={n[kk]}"
                       for kk in REC_KERNELS + IVF_KERNELS))
        runs[name] = (eng, vecs, vs, ids)
    if min(counts[kk] for kk in REC_KERNELS + IVF_KERNELS) == 0:
        raise AssertionError(f"recsys path: a kernel was not launched: "
                             f"{counts}")
    fused, unfused = runs["toploc+ fused"], runs["toploc+ unfused"]
    flat = [torch.from_numpy(x).to(dev) for x in
            (fused[2], fused[3], unfused[2], unfused[3])]
    err, n = compare("recsys fused vs unfused toploc+", *flat,
                     dot_rows(corpus, fused[1]), corpus.shape[0])
    if not same_records(fused[0], unfused[0]):
        raise AssertionError("recsys: fused and unfused toploc+ TurnStats "
                             "differ")
    log("recsys serve", "launches "
        f"{ {kk: counts[kk] for kk in REC_KERNELS + IVF_KERNELS} }; "
        f"fused == unfused toploc+: stats equal, max |dscore| {err:.3g}, "
        f"near-tie id mismatches {n}")
    return counts, fused[1]


def phase_pairwise(args, dev, model):
    """serve_p99 (B = 512) and serve_bulk (B = 262,144): user and item
    towers, then the (B,) dot products; ids drawn on the card (valid by
    construction).  Returns the embedding_bag launches."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.kernels import ops
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    total = 0
    for shape, reps in (("serve_p99", 20), ("serve_bulk", 3)):
        b = TT.SHAPE_PARAMS[shape]["batch"]

        def draw(hi, size):
            return torch.randint(0, hi, size, generator=gen, device=dev,
                                 dtype=torch.int32)
        uid, items = draw(cfg.user_vocab, (b,)), draw(cfg.item_vocab, (b,))
        hist = draw(cfg.item_vocab, (b, cfg.history_len))
        TT.pairwise_step(model, uid, hist, items)          # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = TT.pairwise_step(model, uid, hist, items)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = ops.embedding_bag.launches
        if n != reps or out.shape != (b,) or \
                not bool(torch.isfinite(out).all()) or \
                float(out.abs().max()) > 1 + 1e-5:
            raise AssertionError(f"{shape}: {n} launches, scores "
                                 f"{tuple(out.shape)} not finite in [-1, 1]")
        total += n
        log("pairwise", f"{shape} B={b}: {reps} steps, ms_per_step="
            f"{dt / reps * 1e3:.3f} requests_per_s={b * reps / dt:,.0f} "
            f"embedding_bag_launches={n}")
    return total


def bag_bound(ids, d):
    """(bytes, flops) of an unweighted bag sum over these ids: each real
    id's row read once, the ids read once, the (B, d) output written
    once; a product and a sum per element of a real row."""
    rows = int((ids >= 0).sum())
    return (rows * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4,
            2 * rows * d)


# the batch sizes of [bag]: a request, powers of 4 up to serve_p99's 512,
# past it, and serve_bulk
BAG_SWEEP = (1, 8, 32, 128, 512, 2048, 8192, 262_144)


def bag_table(dev, seed):
    """A table of the two-tower model's shape (user and item fields, d
    256: 3.22 GB) from a seeded CUDA generator at the model's scale
    (normal x d^-1/2), the item field's first row and size, and the
    history length."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    cfg = TT.full_config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((cfg.user_vocab + cfg.item_vocab, cfg.embed_dim),
                        generator=gen, device=dev) * cfg.embed_dim ** -0.5
    return table, cfg.user_vocab, cfg.item_vocab, cfg.history_len


def bag_kernels():
    """The embedding_bag kernels of this tree by the names its binding
    takes (``embedding_bag.KERNELS``); a tree with one kernel: (None,)."""
    from repro_torch.kernels import embedding_bag as eb
    return tuple(getattr(eb, "KERNELS", (None,)))


def bag_call(table, ids, kernel):
    """One unweighted embedding_bag sum through the binding, with
    ``kernel`` forced (None: the launch plan's choice)."""
    from repro_torch.kernels import embedding_bag as eb
    if kernel is None:
        return eb.embedding_bag(table, ids, None)
    return eb.embedding_bag(table, ids, None, kernel=kernel)


def phase_bag_sweep(args, dev):
    """Each embedding_bag kernel forced at every B of BAG_SWEEP on a
    table of the two-tower shape (``bag_table``; L = 50 ids of the item
    field, unweighted sum), L2 flushed, beside
    ``torch.nn.functional.embedding_bag`` (timed only), each output
    held to the plain version bit for bit; the kernel the launch plan
    picks at each B.  Also written as bag_sweep.json in the output
    directory: the measurement behind ``tiling.BAG_ROWS_MAX_B``."""
    import torch
    from repro_torch.kernels import ref, tiling
    table, lo, vocab, hist = bag_table(dev, args.seed + 23)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    lib_fn = torch.nn.functional.embedding_bag
    out = {}
    for b in BAG_SWEEP:
        reps = 5 if b > 8192 else 25
        idss = [torch.randint(lo, lo + vocab, (b, hist), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(reps)]
        row = {}
        for kernel in bag_kernels():
            calls = [lambda x=x: bag_call(table, x, kernel) for x in idss]
            event_ms(calls[:2], flush, spin=True)              # warm-up
            if not torch.equal(calls[0](),
                               ref.embedding_bag(table, idss[0])):
                raise AssertionError(f"embedding_bag[{kernel}] B={b}: "
                                     f"not bit-equal to its plain version")
            row[str(kernel)] = event_ms(calls, flush, spin=True)
        lib = [lambda x=x: lib_fn(x, table, mode="sum") for x in idss]
        event_ms(lib[:2], flush, spin=True)
        row["library"] = event_ms(lib, flush, spin=True)
        row["bound"] = float(np.mean([bound_ms(*bag_bound(x, table.shape[1])
                                               )[0] for x in idss]))
        plan = tiling.plan_embedding_bag
        row["plan"] = (plan(b, table.shape[1]) if "d" in inspect.signature(
            plan).parameters else plan(b))[0].kernel
        out[b] = row
        log("bag", f"B={b} L={hist} d={table.shape[1]}: " + " ".join(
            f"{k}_ms={v:.4f}" for k, v in row.items() if k not in (
                "bound", "plan")) + f" bound_ms={row['bound']:.6f} plan="
            f"{row['plan']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bag_sweep.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    del table
    torch.cuda.empty_cache()
    return out


def phase_bag_times(args, dev, model):
    """embedding_bag on the two-tower table at B = 1, 512 and 262,144
    (L = 50 history ids of the item field, unweighted sum), L2 flushed:
    the kernel, its plain version (device time: it never syncs) and,
    timed only, ``torch.nn.functional.embedding_bag`` on the same ids."""
    import torch
    from repro_torch.kernels import ops, ref
    cfg, table = model.cfg, model.table
    lo = model.offsets[1]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    lib_fn = torch.nn.functional.embedding_bag
    out = {}
    for b, reps in zip(BAG_BATCHES, (25, 25, 5)):
        idss = [torch.randint(lo, lo + cfg.item_vocab, (b, cfg.history_len),
                              generator=gen, device=dev, dtype=torch.int32)
                for _ in range(reps)]
        kern = [lambda x=x: ops.embedding_bag(table, x) for x in idss]
        plain = [lambda x=x: ref.embedding_bag(table, x) for x in idss]
        lib = [lambda x=x: lib_fn(x, table, mode="sum") for x in idss]
        for calls in (kern, plain, lib):                    # warm-up
            event_ms(calls[:2], flush, spin=True)
        row = timed(kern, plain, [bag_bound(x, table.shape[1]) for x in idss],
                    flush, plain_syncs=False)
        row["library_ms"] = event_ms(lib, flush, spin=True)
        log("times", f"embedding_bag B={b} L={cfg.history_len} "
            f"d={table.shape[1]} (table {table.shape[0]:,} rows): "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"F.embedding_bag_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
            f"share={row['bound_ms'] / row['ms']:.3f} "
            f"kernels_a_call={row['kernels']}")
        out[b] = row
    return out


def phase_cand_times(args, dev, index, vecs):
    """fused_scan and fused_turn at the two-tower TopLoc shape (k 100,
    nprobe 32, p 1,024, B = 1, the served user vectors), L2 flushed."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref, tiling
    k = TT.SHAPE_PARAMS["retrieval_cand"]["k"]
    nprobe = TT.TOPLOC_IVF["nprobe"]
    lv, li, c = index.list_vecs, index.list_ids, index.centroids
    qs = [vecs[j:j + 1].contiguous() for j in range(min(25, len(vecs)))]
    sels = [topk(ref.gemv_rows(c, q), nprobe)[1].to(torch.int32) for q in qs]
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    scan_w = [scan_bound(index, q, s, tiling.next_pow2(k))
              for q, s in zip(qs, sels)]
    calls = {
        "fused_scan": (
            [lambda q=q, s=s: ops.fused_scan(q, lv, li, s, k)
             for q, s in zip(qs, sels)],
            [lambda q=q, s=s: ref.fused_scan_ivf(q, lv, li, s, None, k=k)
             for q, s in zip(qs, sels)], scan_w),
        "fused_turn": (
            [lambda q=q: ops.fused_turn(q, c, lv, li, nprobe=nprobe, k=k)
             for q in qs],
            [lambda q=q: ref.fused_turn_ivf(q, c, lv, li, nprobe=nprobe,
                                            k=k) for q in qs],
            [(nb + index.p * index.d * 4, fl + 2 * index.p * index.d)
             for nb, fl in scan_w]),
    }
    for name, (kern, plain, works) in calls.items():
        event_ms(kern[:2], flush, spin=True)                # warm-up
        row = timed(kern, plain, works, flush)
        log("times", f"{name} two-tower B=1 k={k} nprobe={nprobe} "
            f"p={index.p} lmax={index.lmax} d={index.d}: "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"share={row['bound_ms'] / row['ms']:.3f} "
            f"kernels_a_call={row['kernels']}")


TT_DIST_REQS = 20       # requests of the sharded two-tower serve steps


def phase_twotower_dist(args, dev, model, corpus, index):
    """The two-tower sharded serve steps over S = 2 and 4 shards of the
    one card (every shard a view): ``dist_topk_step`` at
    retrieval_cand's shape (the whole item corpus, k = 100) == the brute
    ``retrieval_step`` (ids ``torch.equal``, scores within TOL) on
    TT_DIST_REQS requests; ``toploc_ivf_dist_step`` over the item IVF
    (each request's cache the top-h centroids of its user vector, nprobe
    32) at S = 1, 2, 4, its ids == S = 1's wherever no shard owned more
    than its cap.
    Host ms p50 of each (synchronised)."""
    import torch
    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.core.topk import topk
    from repro_torch.distributed import retrieval as R
    from repro_torch.kernels import ref
    k = TT.SHAPE_PARAMS["retrieval_cand"]["k"]
    h, nprobe = TT.TOPLOC_IVF["h"], TT.TOPLOC_IVF["nprobe"]
    reqs = recsys_sessions(model.cfg, TT_DIST_REQS // TT_REQS,
                           corpus.shape[0], args.seed + 9)
    clock, ms = time.perf_counter, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = clock()
        got = fn()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((clock() - t0) * 1e3)
        return got

    same, overflow, checked, worst = 0, 0, 0, 0.0
    for _, uid, hist in reqs:
        uid_t = torch.from_numpy(uid).to(dev)
        hist_t = torch.from_numpy(hist).to(dev)
        want = run("brute", lambda: TT.retrieval_step(model, uid_t, hist_t,
                                                      corpus, k))
        for s in SHARD_COUNTS:
            mesh = R.retrieval_mesh(s, devices=[dev] * s)
            got = run(f"dist S={s}", lambda: TT.dist_topk_step(
                model, uid_t, hist_t, corpus, k, mesh))
            err = float((got[0] - want[0]).abs().max())
            if not (torch.equal(got[1], want[1]) and err <= TOL):
                raise AssertionError(f"dist_topk_step at S={s} != the "
                                     f"brute retrieval_step (score max "
                                     f"|d| {err})")
            same += 1
            worst = max(worst, err)
        u = model.user_tower(uid_t, hist_t)
        cache_ids = topk(ref.gemv_rows(index.centroids, u), h)[1][0]
        cache_vecs = index.centroids[cache_ids]
        sel = cache_ids[topk(u @ cache_vecs.T, nprobe)[1][0]]
        outs = {}
        for s in (1,) + SHARD_COUNTS:
            mesh = R.retrieval_mesh(s, devices=[dev] * s)
            outs[s] = run(f"toploc_ivf_dist S={s}",
                          lambda: TT.toploc_ivf_dist_step(
                              model, uid_t, hist_t, index.list_vecs,
                              index.list_ids, cache_vecs, cache_ids, k=k,
                              nprobe=nprobe, mesh=mesh))
            per = -(-index.p // s)
            owned = torch.bincount(sel.long() // per, minlength=s)
            if s > 1 and int(owned.max()) > TT.shard_cap(nprobe, s):
                overflow += 1
            elif s > 1:
                checked += 1
                if not torch.equal(outs[s][1], outs[1][1]):
                    raise AssertionError(f"toploc_ivf_dist_step at S={s} "
                                         f"!= S=1 with no shard over cap")
    log("twotower dist", f"dist_topk_step k={k} over {corpus.shape[0]:,} "
        f"items at S = {', '.join(map(str, SHARD_COUNTS))} on one card: "
        f"{same} results' ids == the brute retrieval_step's, scores max "
        f"|d| {worst:.3g} (tol {TOL}; a shard's product is a matrix of "
        f"other width); "
        f"toploc_ivf_dist_step h={h} nprobe={nprobe} p={index.p}: {checked} "
        f"results == S=1's, {overflow} with a shard over its cap; host "
        f"ms p50: " + " ".join(f"{n.replace(' ', '_')}={np.median(v):.3f}"
                               for n, v in ms.items()))


# ---------------------------------------------------------------------------
# phases 10-13: index, PQ index, serving, sequential == batched
# ---------------------------------------------------------------------------


def smoke_corpus(args, dev):
    """The smoke's corpus on the card (``args.n_docs`` docs), its 25 x 10
    conversations, fig3's 32 x 10 ([batched serve]'s, drawn around the
    same topic centres from a seed of their own), and the exact top-k of
    every turn of the 25; plus the seconds the corpus took."""
    import torch
    from repro_torch.core import ivf
    from repro_torch.data import synthetic as SY
    cfg = SY.WorkloadConfig(n_docs=args.n_docs, d=args.d, n_topics=256,
                            doc_spread=0.35, n_conversations=25,
                            turns_per_conversation=10, query_drift=0.15,
                            walk_step=0.05, shift_prob=0.15, seed=args.seed)
    t0 = time.perf_counter()
    corpus = SY.make_device_corpus(cfg, dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    convs = corpus.conversations
    bconvs = SY._conversations(
        np.random.default_rng(args.seed + BATCH_SEED),
        dataclasses.replace(cfg, n_conversations=BATCH_CONVS,
                            turns_per_conversation=BATCH_TURNS),
        corpus.topic_centers)[0]
    flat = torch.from_numpy(convs.reshape(-1, args.d)).to(dev)
    _, exact = ivf.exact_search(corpus.doc_vecs, flat, args.k)
    exact = exact.cpu().numpy().reshape(convs.shape[0], convs.shape[1], -1)
    return corpus.doc_vecs, convs, bconvs, exact, t_gen


def phase_index(args, dev):
    import torch
    from repro_torch.core import ivf
    torch.cuda.reset_peak_memory_stats()
    docs, convs, bconvs, exact, t_gen = smoke_corpus(args, dev)
    t0 = time.perf_counter()
    index = ivf.build(docs, args.lists, iters=args.iters, seed=args.seed,
                      capacity_factor=1.3)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    # the corpus stays: it is the IVF-PQ index's re-rank source
    torch.cuda.empty_cache()
    log("index", f"n_docs={args.n_docs} d={args.d} p={args.lists} "
        f"iters={args.iters} corpus_s={t_gen:.1f} build_s={t_build:.1f} "
        f"lmax={index.lmax} n_indexed={index.n_docs} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}")
    if index.n_docs != args.n_docs:
        raise AssertionError("the index lost documents")
    return index, docs, convs, exact, bconvs


def doc_slots(index):
    """(n_docs,) int64: the flat posting-list slot holding each doc id."""
    import torch
    real = index.list_ids.view(-1) >= 0
    slot = torch.empty(index.n_docs, dtype=torch.int64,
                       device=index.list_ids.device)
    slot[index.list_ids.view(-1)[real].long()] = torch.nonzero(real)[:, 0]
    return slot


def phase_pq(args, index, docs, dev):
    """The port's build_ivf_pq at full size: train (k-means++ and 8
    Lloyd passes per subquantizer), then encode and pack."""
    import torch
    from repro_torch.core import pq
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    book = pq.train(docs, PQ_M, iters=PQ_ITERS, generator=gen)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    pqi = pq.build_ivf_pq(index, docs, book)
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    if pqi.doc_vecs.data_ptr() != docs.data_ptr():
        raise AssertionError("IVFPQIndex.doc_vecs copied the corpus")
    n_rows = int((pqi.list_ids >= 0).sum())
    if n_rows != args.n_docs or pqi.n_docs != args.n_docs:
        raise AssertionError(f"{n_rows} code rows for {args.n_docs} docs")
    # every sampled doc's code row is its own encoding
    sample = torch.randperm(args.n_docs, generator=gen, device=dev)[:8192]
    rows = pqi.list_codes.view(-1, PQ_M)[doc_slots(index)[sample]]
    if not torch.equal(rows, pq.encode(book, docs[sample])):
        raise AssertionError("a doc's code row is not its encoding")
    log("pq", f"m={PQ_M} n_codes=256 d_sub={args.d // PQ_M} "
        f"iters={PQ_ITERS} train_s={t_train:.1f} encode_s={t_encode:.1f} "
        f"code_rows={n_rows} list_codes_gb={pqi.list_codes.numel() / 1e9:.2f}"
        f" max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}")
    return pqi


SERVE = [("toploc+ fused", dict(strategy="toploc+", fused=True)),
         ("toploc fused", dict(strategy="toploc", fused=True)),
         ("plain fused", dict(strategy="plain", fused=True)),
         ("toploc+ unfused", dict(strategy="toploc+", fused=False))]
BACKENDS = (("ivf", IVF_KERNELS), ("ivf_pq", PQ_KERNELS))


def launch_counts():
    from repro_torch.kernels import ops
    names = IVF_KERNELS + PQ_KERNELS + ENC_KERNELS + REC_KERNELS + LM_KERNELS
    return {name: getattr(ops, name).launches for name in names}


def serve(backend, index, convs, exact, name, knobs, quiet=False):
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    eng = ConversationalSearchEngine(
        ServingConfig(**{"backend": backend, "precision": "f32", **knobs}),
        **{f"{backend}_index": index})
    before = launch_counts()
    n_conv, turns = convs.shape[:2]
    vs = np.zeros((n_conv, turns, eng.cfg.k), np.float32)
    ids = np.zeros((n_conv, turns, eng.cfg.k), np.int64)
    for c in range(n_conv):
        for t in range(turns):
            vs[c, t], ids[c, t] = eng.query(f"c{c}", convs[c, t])
    lat = np.asarray([r.latency_s for r in eng.records]) * 1e3
    s = eng.summary()
    recall = np.mean([len(set(ids[c, t]) & set(exact[c, t])) / eng.cfg.k
                      for c in range(n_conv) for t in range(turns)])
    after = launch_counts()
    launches = " ".join(f"{n}_launches={after[n] - before[n]}"
                        for n in dict(BACKENDS)[backend])
    if not quiet:
        p50, p95 = np.percentile(lat, [50, 95])
        log("serve", f"{backend} {name}: turns={s['turns']} "
            f"p50_ms={p50:.3f} p95_ms={p95:.3f} "
            f"mean_centroid_dists={s['mean_centroid_dists']:.1f} "
            f"mean_list_dists={s['mean_list_dists']:.1f} "
            f"mean_code_dists={s['mean_code_dists']:.1f} "
            f"refresh_rate={s['refresh_rate']:.3f} recall@10={recall:.4f} "
            f"{launches}")
    return eng, vs, ids


STAT_FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
               "i0", "refreshed")


def same_records(a, b):
    return [[getattr(r, f) for f in STAT_FIELDS] for r in a.records] == \
        [[getattr(r, f) for f in STAT_FIELDS] for r in b.records]


def phase_serve(indexes, docs, convs, exact, dev):
    """Each backend's four paths after a warm-up, its launch counts set
    to 0 just before and read just after; fused == unfused toploc+."""
    import torch
    runs, launches = {}, {}
    q = torch.from_numpy(convs.reshape(-1, convs.shape[-1])).to(dev)
    for backend, kernels in BACKENDS:
        index = indexes[backend]
        # warm every path (cuBLAS handles, allocator) outside the counted run
        for name, knobs in SERVE:
            serve(backend, index, convs[:1, :2], exact[:1, :2], name, knobs,
                  quiet=True)
        from repro_torch.kernels import ops
        ops.reset_launches()
        runs[backend] = {name: serve(backend, index, convs, exact, name,
                                     knobs) for name, knobs in SERVE}
        counts = launch_counts()
        launches.update({n: counts[n] for n in kernels})
        if min(counts[n] for n in kernels) == 0:
            raise AssertionError(f"{backend}: a kernel was not launched: "
                                 f"{counts}")
        fused, unfused = (runs[backend][n] for n in ("toploc+ fused",
                                                     "toploc+ unfused"))
        flat = [torch.from_numpy(x.reshape(-1, x.shape[-1])).to(dev)
                for x in (fused[1], fused[2], unfused[1], unfused[2])]
        err, n = compare(f"{backend} fused vs unfused toploc+", *flat,
                         dot_rows(docs, q), docs.shape[0])
        if not same_records(fused[0], unfused[0]):
            raise AssertionError(f"{backend}: fused and unfused toploc+ "
                                 f"TurnStats differ")
        log("serve", f"{backend} launches "
            f"{ {n: counts[n] for n in kernels} }; fused == unfused "
            f"toploc+: stats equal, max |dscore| {err:.3g}, near-tie id "
            f"mismatches {n}")
    return runs, launches


QSERVE = (("toploc+", "toploc+ fused"), ("toploc", "toploc fused"),
          ("plain", "plain fused"))


def phase_serve_quant(indexes, convs, exact, runs):
    """``ServingConfig(fused=True, precision=...)`` for bf16 and int8 x
    toploc+ / toploc / plain, per backend, after a warm-up, the launch
    counts set to 0 just before each precision's runs and read just
    after.  Each path against
    the f32 fused path on the same turns: recall@10, and the TurnStats
    counters, equal on the sessioned paths (their stage 1, cache and
    drift check stay f32); the plain path's quantised stage 1 may probe
    other lists.  Returns the launches per quantised kernel."""
    from repro_torch.kernels import ops
    launches = {}
    for backend, _ in BACKENDS:
        index = indexes[backend]
        for prec in QUANT:
            for strat, _ in QSERVE:
                serve(backend, index, convs[:1, :2], exact[:1, :2], "", dict(
                    strategy=strat, fused=True, precision=prec), quiet=True)
        ops_kernels = (("fused_scan", "fused_turn") if backend == "ivf"
                       else ("fused_scan_pq", "fused_turn_pq"))
        for prec in QUANT:
            ops.reset_launches()
            for strat, f32_name in QSERVE:
                eng, _, ids = serve(backend, index, convs, exact,
                                    f"{strat} fused {prec}",
                                    dict(strategy=strat, fused=True,
                                         precision=prec))
                f32_eng, _, f32_ids = runs[backend][f32_name]
                k = eng.cfg.k
                rec = np.mean([len(set(a) & set(b)) / k for a, b in zip(
                    ids.reshape(-1, k), f32_ids.reshape(-1, k))])
                same = [[getattr(r, f) for f in STAT_FIELDS] == [
                    getattr(g, f) for f in STAT_FIELDS]
                    for r, g in zip(eng.records, f32_eng.records)]
                cents = all(r.centroid_dists == g.centroid_dists for r, g in
                            zip(eng.records, f32_eng.records))
                if strat != "plain" and not all(same):
                    raise AssertionError(f"{backend} {strat} {prec}: "
                                         f"TurnStats differ from f32's")
                if not cents:
                    raise AssertionError(f"{backend} {strat} {prec}: "
                                         f"centroid_dists differ")
                log("serve", f"{backend} {strat} fused {prec} vs f32 fused: "
                    f"recall@10={rec:.4f} TurnStats equal on "
                    f"{sum(same)}/{len(same)} turns (centroid_dists on all)")
            for op in ops_kernels:
                n = getattr(ops, op).launches
                if n == 0:
                    raise AssertionError(f"{op}[{prec}] was not launched")
                launches[f"{op}[{prec}]"] = n
        log("serve", f"{backend} quantised launches " + str(
            {n: c for n, c in launches.items() if n.split("[")[0] in
             ops_kernels}))
    return launches


def phase_fig8(dev):
    """The reference's own recall gate (``benchmarks/fig8_fused.py``):
    20,000 synthetic docs at d = 64, IVF p = 2,048, nprobe 16, k 10, the
    first 32 utterances; recall@10 of the quantised fused turn against
    the f32 fused turn on the card must be >= 0.95 (fused_turn); the PQ
    turn (m = 8, rerank 64) is reported."""
    import torch
    from repro_torch.core import ivf, pq, toploc
    from repro_torch.data import synthetic as SY
    from repro_torch.kernels import ops
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=20_000, d=64, n_topics=32, n_conversations=8,
        turns_per_conversation=8, seed=8))
    docs = torch.from_numpy(wl.doc_vecs).to(dev)
    idx = ivf.build(docs, 2048, iters=4, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pqi = pq.build_ivf_pq(idx, docs, pq.train(docs, 8, iters=4,
                                              generator=gen))
    q = torch.from_numpy(wl.conversations.reshape(-1, 64)[:32]).to(dev)
    tables = toploc._adc_tables(pqi, q)

    def run(prec):
        ivf_ids = ops.fused_turn(q, idx.centroids, idx.list_vecs,
                                 idx.list_ids, nprobe=16, k=10,
                                 precision=prec)[1].cpu().numpy()
        pq_ids = ops.fused_turn_pq(q, pqi.centroids, tables, pqi.list_codes,
                                   pqi.list_ids, pqi.doc_vecs, nprobe=16,
                                   k=10, rerank=64,
                                   precision=prec)[1].cpu().numpy()
        return ivf_ids, pq_ids

    def recall(a, b):
        return float(np.mean([len(set(x) & set(y)) / 10
                              for x, y in zip(a, b)]))

    base = run("f32")
    out = {}
    for prec in QUANT:
        got = run(prec)
        out[prec] = (recall(got[0], base[0]), recall(got[1], base[1]))
        log("fig8", f"{prec}: recall@10 vs the f32 fused turn: ivf "
            f"{out[prec][0]:.3f} (floor 0.95), ivf_pq {out[prec][1]:.3f} "
            f"(reported); 20,000 docs d=64 p=2048 lmax={idx.lmax} "
            f"nprobe=16 k=10, 32 queries")
        if out[prec][0] < 0.95:
            raise AssertionError(f"fig8 {prec} recall@10 {out[prec][0]} "
                                 f"< 0.95")
    return out


def phase_batched(index, convs, run, dev):
    """start_batch / step_batch over all conversations at once must equal
    the sequential engine exactly: ids, scores, stats, final sessions."""
    import torch
    from repro_torch.core import toploc
    eng, vs, ids = run
    b, turns = convs.shape[:2]
    k = eng.cfg.k
    recs = {(r.conv_id, r.turn): r for r in eng.records}
    sess = None
    for t in range(turns):
        q = torch.from_numpy(np.ascontiguousarray(convs[:, t])).to(dev)
        if t == 0:
            v, i, sess, st = toploc.start_batch(eng.backend, index, q, k=k)
        else:
            v, i, sess, st = toploc.step_batch(eng.backend, index, sess, q,
                                               k=k)
        if not (np.array_equal(v.cpu().numpy(), vs[:, t])
                and np.array_equal(i.cpu().numpy(), ids[:, t])):
            raise AssertionError(f"batched turn {t}: results differ")
        host = {f: getattr(st, f).cpu().numpy() for f in STAT_FIELDS}
        for c in range(b):
            r = recs[(f"c{c}", t)]
            if [int(host[f][c]) for f in STAT_FIELDS] != \
                    [int(getattr(r, f)) for f in STAT_FIELDS]:
                raise AssertionError(f"batched turn {t} conv {c}: stats")
    for c in range(b):
        for f, x in zip(toploc.IVFSession._fields, eng.sessions[f"c{c}"]):
            if not torch.equal(getattr(sess, f)[c], x):
                raise AssertionError(f"batched conv {c}: session {f}")


# [batched serve]: fig3's protocol (benchmarks/fig3_batched_serving.py)
# on the collection-scale indexes: 32 concurrent conversations x 10 turns
# (their own seed), each round every conversation submits one request and
# the engine drains; max_batch 1, 8 and 32, n_slots 32, two waves in
# flight, no deadline wait
BATCH_CONVS, BATCH_TURNS, BATCH_SEED = 32, 10, 23
BATCH_SIZES = (1, 8, 32)
# timed replays per engine and max_batch: turns/s is their median, the
# mean of the two (a replay of 10 waves at B = 32 takes ~5 ms, so one
# host stall of the shared machine would set a single replay's rate;
# two, not three, to keep the whole smoke well inside its time limit)
BATCH_REPEATS = 2
BSERVE = (("toploc+ fused", dict(strategy="toploc+", fused=True)),
          ("toploc+ fused bf16", dict(strategy="toploc+", fused=True,
                                      precision="bf16")),
          ("toploc+ fused int8", dict(strategy="toploc+", fused=True,
                                      precision="int8")),
          ("toploc fused", dict(strategy="toploc", fused=True)),
          ("plain fused", dict(strategy="plain", fused=True)),
          ("toploc+ unfused", dict(strategy="toploc+", fused=False)),
          # fig7's cache settings: threshold 0.95, depth 64
          ("toploc+ fused cache", dict(strategy="toploc+", fused=True,
                                       cache_threshold=0.95,
                                       cache_depth=64)))
BATCH_ROWS = {"ivf": ("fused_turn", "fused_scan"),
              "ivf_pq": ("pq_adc_scan", "fused_turn_pq", "fused_scan_pq")}


def path_kernels(backend, cfg):
    """The kernel a wave of this path runs: the fused turn (plain) or
    scan (sessioned); unfused, IVF-PQ's ADC scan and for IVF none (its
    unfused stages are plain PyTorch, where the reference runs XLA)."""
    if not cfg.fused:
        return ("pq_adc_scan",) if backend == "ivf_pq" else ()
    op = "fused_turn" if cfg.strategy == "plain" else "fused_scan"
    return (op + ("_pq" if backend == "ivf_pq" else ""),)


def serve_rounds(eng, convs):
    """fig3's replay through a batched engine: round by round, every
    conversation submits its turn, then the engine drains.  Returns
    (scores, ids, wall seconds)."""
    n_conv, turns = convs.shape[:2]
    k = eng.cfg.k
    vs = np.zeros((n_conv, turns, k), np.float32)
    ids = np.zeros((n_conv, turns, k), np.int64)
    t0 = time.perf_counter()
    for t in range(turns):
        futs = [eng.submit(f"c{c}", convs[c, t]) for c in range(n_conv)]
        eng.drain()
        for c, fut in enumerate(futs):
            vs[c, t], ids[c, t] = fut.result()
    return vs, ids, time.perf_counter() - t0


def serve_sequential(eng, convs):
    """The same turns, in the same order, through the sequential
    engine."""
    n_conv, turns = convs.shape[:2]
    k = eng.cfg.k
    vs = np.zeros((n_conv, turns, k), np.float32)
    ids = np.zeros((n_conv, turns, k), np.int64)
    t0 = time.perf_counter()
    for t in range(turns):
        for c in range(n_conv):
            vs[c, t], ids[c, t] = eng.query(f"c{c}", convs[c, t])
    return vs, ids, time.perf_counter() - t0


def count_syncs(run):
    """Calls that synchronise the host with the card while ``run()``
    runs (torch.cuda's sync debug mode, one warning each), and run's
    result."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), out


def device_ops(warm, run):
    """(kernels, copies and fills) the card runs in ``run()``, from
    torch.profiler's device events; ``warm()`` runs first in a discarded
    warm-up step, which absorbs what a session's start can miss."""
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
    with prof:
        for call in (warm, run):
            call()
            torch.cuda.synchronize()
            prof.step()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in evs)
    return len(evs) - copies, copies


BATCH_KEYS = STAT_FIELDS + ("cache_hit",)


def phase_batched_serve(indexes, docs, convs):
    """Each backend's paths (``BSERVE``) through the sequential engine
    and through ``BatchedConversationalSearchEngine`` at max_batch 1, 8
    and 32, after a warm-up round of each, ``BATCH_REPEATS`` timed
    replays each on fresh engines: every batched replay equals the
    sequential one bit for bit (ids, scores, every TurnStats counter,
    cache_hit), else it raises.  Per engine and max_batch: the median
    turns/s (each replay's in brackets), the request p50 / p95
    (latency_s + queue_wait_s) over all replays, waves and their mean
    size, the launches per wave of the backend's rows (counts set to 0
    just before the replays, read just after), the host syncs per wave
    (one more, untimed round under the sync debug mode), the cache hit
    rate, and the sequential engine's median turns/s beside.  Returns
    (launches per kernel, results)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import (BatchedConversationalSearchEngine,
                                     ConversationalSearchEngine,
                                     ServingConfig)
    turns = convs.shape[0] * convs.shape[1]
    launches, out, by_b = {}, {}, {}
    for backend, _ in BACKENDS:
        index = {f"{backend}_index": indexes[backend]}
        rows = BATCH_ROWS[backend]
        for name, knobs in BSERVE:
            cfg = ServingConfig(backend=backend, **knobs)
            kw = dict(doc_vecs=docs) if cfg.cache_threshold > 0 else {}

            def batched(b):
                return BatchedConversationalSearchEngine(
                    cfg, **index, **kw, n_slots=BATCH_CONVS, max_batch=b,
                    max_wait_s=0.0, max_inflight=2)

            def records(eng):
                return {(r.conv_id, r.turn): [getattr(r, f) for f in
                                              BATCH_KEYS]
                        for r in eng.records}

            s_syncs, _ = count_syncs(lambda: serve_sequential(
                ConversationalSearchEngine(cfg, **index, **kw),
                convs[:, :1]))
            s_walls = []
            for _ in range(BATCH_REPEATS):
                gc.collect()        # the engines' cycles, not mid-run
                seq = ConversationalSearchEngine(cfg, **index, **kw)
                v, i, wall = serve_sequential(seq, convs)
                if not s_walls:
                    s_v, s_i, s_recs = v, i, records(seq)
                elif not (np.array_equal(v, s_v) and np.array_equal(i, s_i)
                          and records(seq) == s_recs):
                    raise AssertionError(f"{backend} {name}: sequential "
                                         f"replays differ")
                s_walls.append(wall)
            s_wall = float(np.median(s_walls))
            for b in BATCH_SIZES:
                serve_rounds(batched(b), convs[:, :1])
                engines, walls = [], []
                ops.reset_launches()
                for _ in range(BATCH_REPEATS):
                    gc.collect()
                    eng = batched(b)
                    v, i, wall = serve_rounds(eng, convs)
                    if not (np.array_equal(v, s_v) and np.array_equal(i, s_i)
                            and records(eng) == s_recs):
                        raise AssertionError(
                            f"[batched serve] {backend} {name} B={b}: "
                            f"differs from the sequential engine")
                    engines.append(eng)
                    walls.append(wall)
                counts = {n: getattr(ops, n).launches for n in rows}
                wall = float(np.median(walls))
                want = path_kernels(backend, cfg)
                if {n for n in rows if counts[n]} != set(want):
                    raise AssertionError(f"{backend} {name} B={b}: "
                                         f"launches {counts}, the path "
                                         f"runs {want}")
                for n in want:
                    key = n if cfg.precision == "f32" else \
                        f"{n}[{cfg.precision}]"
                    launches[key] = launches.get(key, 0) + counts[n]
                    by_b[f"{key} B={b}"] = by_b.get(f"{key} B={b}",
                                                    0) + counts[n]
                sizes = [n for e in engines for n in e.batcher.batch_sizes]
                waves = len(sizes)
                req = np.asarray([r.latency_s + r.queue_wait_s
                                  for e in engines for r in e.records]) * 1e3
                p50, p95 = np.percentile(req, [50, 95])
                probe = batched(b)
                syncs, _ = count_syncs(lambda: serve_rounds(probe,
                                                            convs[:, :1]))
                per_wave = syncs / len(probe.batcher.batch_sizes)
                hit = (f"{eng.cache_stats()['hit_rate']:.4f}"
                       if eng.cache_stats() else "off")
                out[(backend, name, b)] = dict(
                    turns_s=turns / wall, seq_turns_s=turns / s_wall,
                    p50_ms=p50, p95_ms=p95, waves=waves,
                    syncs_per_wave=per_wave)
                profiled = ""
                if name == "toploc+ fused":
                    e1, e2 = batched(b), batched(b)
                    n_k, n_c = device_ops(
                        lambda: serve_rounds(e1, convs[:, :1]),
                        lambda: serve_rounds(e2, convs[:, :1]))
                    w = BATCH_CONVS // b
                    profiled = (f" profiler: {n_k / w:.1f} kernels/wave, "
                                f"{n_c / w:.1f} copies+fills/wave;")
                log("batched serve", f"{backend} {name} B={b}: turns/s="
                    f"{turns / wall:.1f} (" + "/".join(
                        f"{turns / x:.1f}" for x in walls) + "; sequential "
                    f"{turns / s_wall:.1f} (" + "/".join(
                        f"{turns / x:.1f}" for x in s_walls) + "), "
                    f"{s_syncs / BATCH_CONVS:.2f} host syncs/turn) request "
                    f"p50_ms={p50:.3f} p95_ms={p95:.3f} waves={waves} "
                    f"mean_wave={np.mean(sizes):.2f} "
                    f"launches/wave " + " ".join(
                        f"{n}={counts[n] / waves:.2f}" for n in rows)
                    + f" host_syncs/wave={per_wave:.2f} cache_hit_rate="
                    f"{hit};{profiled} == sequential (ids, scores, "
                    f"TurnStats, cache_hit)")
                del eng, engines, probe
            torch.cuda.empty_cache()
    log("batched serve", f"launches by kernel and max_batch: {by_b}")
    return launches, out


# ---------------------------------------------------------------------------
# [hnsw] and the [exact] serve: the HNSW index and the Exact baseline
# ---------------------------------------------------------------------------

# the graph: benchmarks/common.py's m and ef_construction over the first
# HNSW_DOCS docs of the smoke's corpus (a view, no copy; the reference's
# BENCH_DOCS); the host build takes ~3.5 ms a node on the card's host
# (PERF.md section 4), so the collection's 8.8 M docs are out of reach
# and the graph is cut
HNSW_DOCS, HNSW_M, HNSW_EFC = 20_000, 16, 64
HNSW_EFS, HNSW_UP = (32, 64), 2         # table1's ef and fig2's largest
# the sequential paths (adaptive: the backend's knob re-anchoring every
# turn, set on the engine's backend) and the batched ones
HSERVE = (("plain", dict(strategy="plain"), False),
          ("toploc", dict(strategy="toploc"), False),
          ("toploc adaptive", dict(strategy="toploc"), True))
HBATCH = (("toploc", dict(strategy="toploc")),
          # fig7's cache settings, the depth clamped to ef
          ("toploc cache", dict(strategy="toploc", cache_threshold=0.95,
                                cache_depth=64)))
HNSW_DIFF_SHARE = 0.01        # queries the kernel may route otherwise


def hnsw_check(index, q, ef, k, entry, what):
    """The kernel against its plain version on the same queries: the
    rows whose traversal agrees (ids and ndist equal) are held by
    ``compare`` (scores within TOL, each id's float64 score within TOL);
    returns (max |dscore|, rows, rows whose ids or ndist differ)."""
    import torch
    from repro_torch.kernels import ops, ref
    args = (index.vectors, index.adj0, index.upper_adj, index.entry_point,
            q, entry)
    kv, ki, kn = ops.hnsw_search(*args, ef=ef, k=k)
    pv, pi, pn = ref.hnsw_search(*args, ef=ef, k=k)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kv).all()):
        raise AssertionError(f"{what}: a non-finite score")
    same = (ki == pi).all(-1) & (kn == pn)
    err, _ = compare(what, kv[same], ki[same], pv[same], pi[same],
                     dot_rows(index.vectors, q[same]), index.n)
    return err, q.shape[0], int((~same).sum())


def hnsw_bound(index, nd, b, k):
    """(bytes, flops) of a search with these distance counts: each scored
    row's vector and at least its adjacency entry, the queries and the
    outputs; 2 d flops a scored row."""
    d = index.vectors.shape[1]
    n = int(nd.sum())
    return n * (d + 1) * 4 + b * d * 4 + b * (k * 8 + 4), 2 * n * d


def hnsw_steps(index, q, ef, k):
    """The dependent steps of the search of one query ``q`` (1, d): the
    descent's and level 0's, counted by the plain version, whose scorer
    runs once a step and once for each entry (the global entry point's,
    the level-0 start's)."""
    from repro_torch.kernels import ref
    calls = [0]
    dots = ref.hnsw_dots(index.vectors)

    def factory(queries):
        at = dots(queries)

        def counted(ids):
            calls[0] += 1
            return at(ids)
        return counted

    ref.hnsw_search(index.vectors, index.adj0, index.upper_adj,
                    index.entry_point, q, ef=ef, k=k, dots_factory=factory)
    return calls[0] - 2


# a pointer chase: one thread, each load's address the value of the last
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase_kernel(const int* __restrict__ next, int hops,
                             int* out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  *out = i;
}
extern "C" int chase(const int* next, int hops, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, hops,
                                                                out);
  return (int)cudaGetLastError();
}
"""


def probe_lib(name, src):
    """A measurement kernel of this script (not part of the port), built
    from ``src`` with nvcc beside the port's library and loaded; the
    library is named by a hash of its source and built once."""
    import ctypes
    import hashlib
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"{name}_{tag}.so"
    if not so.exists():
        cu = _build.BUILD_DIR / f"{name}_{tag}_{os.getpid()}.cu"
        tmp = cu.with_suffix(".so")
        cu.write_text(src)
        subprocess.run([_build.nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
                        str(cu)], check=True)
        os.replace(tmp, so)
        cu.unlink()
    return ctypes.CDLL(str(so))


def round_trip_ns(dev, hops=100_000):
    """One dependent load's latency on the card, by a pointer chase
    through a random single cycle: over 256 MB after the L2 is flushed
    (a device-memory round trip: the chase touches 100,000 of its 2 M
    lines once each) and over 4 MB left in the L2 (an L2 hit).  Returns
    {"dram": ns, "l2": ns}; the chase kernel is built here from
    ``CHASE_SRC``, not part of the port."""
    import ctypes
    import torch
    lib = probe_lib("chase", CHASE_SRC)
    lib.chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    got = {}
    for name, n in (("dram", 64 << 20), ("l2", 1 << 20)):
        order = torch.randperm(n, generator=gen, device=dev)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt[order] = order.roll(-1).to(torch.int32)

        def run(h):
            err = lib.chase(nxt.data_ptr(), h, out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"chase: cudaError {err}")
        run(1000)
        ts = []
        for _ in range(3):
            if name == "dram":
                flush.zero_()
            else:
                run(n)          # the whole cycle: every line in the L2
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run(hops)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) * 1e6 / hops)
        got[name] = float(np.median(ts))
        del order, nxt
    return got


def hnsw_graph(args, dev):
    """The [hnsw] graph (the port's build over the corpus's first
    ``args.hnsw_docs`` docs) and the smoke's 250 turns as (B, d) queries:
    loaded from ``args.hnsw_graph`` (``hnsw.save``'s npz; the turns and
    the run's sizes and seed in ``PATH.turns.npz`` beside it) when that
    file exists, else built and, with a path, saved there, so two
    checkouts time one graph.  A file made for other sizes, seed or
    build settings is refused."""
    import torch
    from repro_torch.core import hnsw
    path = args.hnsw_graph
    made = dict(n_docs=args.n_docs, hnsw_docs=args.hnsw_docs, d=args.d,
                seed=args.seed, m=HNSW_M, ef_construction=HNSW_EFC)
    if path and os.path.exists(path):
        z = np.load(path + ".turns.npz")
        saved = {key: int(z[key]) for key in made}
        if saved != made:
            raise ValueError(f"{path} holds a graph made for {saved}, "
                             f"this run needs {made}")
        return hnsw.load(path, device=dev), torch.from_numpy(z["turns"]).to(dev)
    docs, convs, _, _, _ = smoke_corpus(args, dev)
    n = min(args.hnsw_docs, docs.shape[0])
    vecs = docs[:n].clone()
    del docs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = hnsw.build(vecs, m=HNSW_M, ef_construction=HNSW_EFC,
                       seed=args.seed)
    log("hnsw", f"build N={n}: {time.perf_counter() - t0:.1f}s on the host")
    turns = torch.from_numpy(convs.reshape(-1, args.d)).to(dev)
    if path:
        with open(path, "wb") as fh:
            hnsw.save(index, fh)
        np.savez(path + ".turns.npz", turns=turns.cpu().numpy(), **made)
    return index, turns


def hnsw_times(index, flat, k, rtt_ns, plain=True, ef=HNSW_EFS[-1]):
    """The kernel's CUDA-event ms at B = 1 (the first 8 turns, a call
    each) and B = 32 (4 calls), L2 flushed, beside the byte bound, the
    chain bound (the steps of a call's longest search, its blocks
    running side by side, x one dependent device-memory round trip,
    ``rtt_ns``) and, with ``plain``, the plain version's ms.  Returns
    {B: row}."""
    import torch
    from repro_torch.kernels import ops, ref
    flush = torch.empty(64 << 20, dtype=torch.float32, device=flat.device)
    args_ = (index.vectors, index.adj0, index.upper_adj, index.entry_point)
    times = {}
    for b in (1, 32):
        qs = [flat[j * b:(j + 1) * b] for j in range(8 if b == 1 else 4)]
        works = [hnsw_bound(index, ops.hnsw_search(*args_, q, ef=ef, k=k)[2],
                            q.shape[0], k) for q in qs]
        calls = [lambda q=q: ops.hnsw_search(*args_, q, ef=ef, k=k)
                 for q in qs]
        if plain:
            row = timed(calls, [lambda q=q: ref.hnsw_search(*args_, q, ef=ef,
                                                            k=k)
                                for q in qs], works, flush)
        else:
            row = dict(ms=event_ms(calls, flush, spin=True),
                       bound_ms=float(np.mean([bound_ms(*w)[0]
                                               for w in works])),
                       bound_by=bound_ms(*works[0])[1],
                       kernels=kernels_a_call(calls[0]))
        steps = [max(hnsw_steps(index, q[i:i + 1], ef, k)
                     for i in range(q.shape[0])) for q in qs]
        row["steps"] = float(np.mean(steps))
        row["chain_ms"] = row["steps"] * rtt_ns / 1e6
        times[b] = row
        log("hnsw", f"hnsw_search ef={ef} B={b} (descent + level 0, L2 "
            f"flushed): {row['ms']:.4f} ms a call"
            + (f", plain {row['plain_ms']:.3f} ms" if plain else "")
            + f", bound {row['bound_ms']:.5f} ms ({row['bound_by']}: the "
            f"scored rows, {HBM_BYTES_PER_S / 1e12:.2f} TB/s), chain bound "
            f"{row['chain_ms']:.4f} ms ({row['steps']:.1f} steps of the "
            f"longest search x {rtt_ns:.1f} ns), {row['ms'] / row['steps'] * 1e3:.3f}"
            f" µs a step, {row['kernels']} kernel a call")
    return times


def phase_hnsw_times(args, dev):
    """``--hnsw-times``: the round trip, then only the kernel's times on
    the [hnsw] graph (``hnsw_graph``), without the plain version."""
    rtt = round_trip_ns(dev)
    log("hnsw", f"pointer chase: {rtt['dram']:.1f} ns a device-memory "
        f"round trip (256 MB, L2 flushed), {rtt['l2']:.1f} ns an L2 hit "
        f"(4 MB)")
    index, flat = hnsw_graph(args, dev)
    hnsw_times(index, flat, args.k, rtt["dram"], plain=False)
    hnsw_visited_times(index, flat, args.k)


def hnsw_visited_times(index, flat, k, efs=(32, 64, 128), rounds=3):
    """The kernel's CUDA-event ms with each instance of its visited set
    that fits the graph forced (``tiling.hnsw_visited``), at ef 32, 64
    and 128, B = 1 (the first 8 turns, a call each) and B = 32 (4
    calls), L2 flushed: the instances run in turns (A B C C B A ...) and
    give the same bits, else this raises.  Prints the median of the
    rounds per instance."""
    import torch
    from repro_torch.kernels import hnsw_search as K, tiling
    flush = torch.empty(64 << 20, dtype=torch.float32, device=flat.device)
    g = (index.vectors, index.adj0, index.upper_adj, index.entry_point)
    n, d = index.vectors.shape
    deg = index.adj0.shape[1]
    for ef in efs:
        kinds = []
        for kind in tiling.HNSW_VISITED:
            try:
                kinds.append((kind, tiling.hnsw_visited(n, d, ef, deg,
                                                        kind)[1]))
            except ValueError:
                pass
        for b in (1, 32):
            qs = [flat[j * b:(j + 1) * b] for j in range(8 if b == 1 else 4)]
            calls = {kind: [lambda q=q, kind=kind: K.hnsw_search(
                *g, q, None, None, ef=ef, k=k, visited=kind) for q in qs]
                for kind, _ in kinds}
            outs = {kind: [c() for c in cs] for kind, cs in calls.items()}
            first = outs[kinds[0][0]]
            for kind, got in outs.items():
                if not all(torch.equal(x, y) for o, p in zip(got, first)
                           for x, y in zip(o, p)):
                    raise AssertionError(f"hnsw_search ef={ef} B={b}: the "
                                         f"{kind} instance's bits differ")
            ms = {kind: [] for kind, _ in kinds}
            order = [kind for kind, _ in kinds]
            for r in range(rounds * 2):
                for kind in order if r % 2 == 0 else order[::-1]:
                    ms[kind].append(event_ms(calls[kind], flush, spin=True))
            log("hnsw", f"visited set forced, ef={ef} B={b} (n={n}, deg "
                f"{deg}, L2 flushed, median of {rounds * 2} rounds in "
                "turns, bits equal): " + "; ".join(
                    f"{kind} ({words} words) {np.median(ms[kind]):.4f} ms"
                    for kind, words in kinds)
                + f"; picked: {tiling.hnsw_visited(n, d, ef, deg)[0]}")


def phase_hnsw(args, docs, convs, bconvs, dev):
    """The port's HNSW build over the first ``args.hnsw_docs`` docs, the
    kernel held to its plain version, the smoke's 25 x 10 turns through
    the sequential engine (plain, toploc, toploc adaptive, toploc with
    fig7's cache) at ef 32 and 64, fig3's 32 x 10 through the batched
    engine at max_batch 1, 8, 32 == the sequential engine bit for bit,
    and the kernel's times.  Returns (launches, max_abs_err, times {B:
    row}, the graph)."""
    import torch
    from repro_torch.core import hnsw, ivf
    from repro_torch.kernels import ops
    from repro_torch.serving import (BatchedConversationalSearchEngine,
                                     ConversationalSearchEngine,
                                     ServingConfig)
    n, k = min(args.hnsw_docs, docs.shape[0]), args.k
    vecs = docs[:n]
    t0 = time.perf_counter()
    index = hnsw.build(vecs, m=HNSW_M, ef_construction=HNSW_EFC,
                       seed=args.seed)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if index.vectors.data_ptr() != docs.data_ptr():
        raise AssertionError("the HNSW index copied the corpus")
    log("hnsw", f"build N={n} d={args.d} m={HNSW_M} "
        f"ef_construction={HNSW_EFC}: {t_build:.1f}s on the host, "
        f"{n / t_build:.0f} nodes/s, top_level={index.top_level}, "
        f"entry_point={int(index.entry_point)}, adj0 "
        f"{index.adj0.numel() * 4 / 1e6:.1f} MB, vectors "
        f"{vecs.numel() * 4 / 1e6:.1f} MB (past the 50 MB L2)")
    flat = torch.from_numpy(convs.reshape(-1, args.d)).to(dev)
    _, exact = ivf.exact_search(vecs, flat, k)
    exact = exact.cpu().numpy().reshape(convs.shape[0], convs.shape[1], -1)

    # the kernel against its plain version: descent and entry override
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    entry = torch.randint(0, n, (flat.shape[0],), generator=gen,
                          device=dev, dtype=torch.int32)
    err, rows, diff = 0.0, 0, 0
    for ef in HNSW_EFS + (HNSW_UP * HNSW_EFS[-1],):
        for e in (None, entry):
            x, r, dq = hnsw_check(index, flat, ef, k, e, f"hnsw ef={ef}")
            err, rows, diff = max(err, x), rows + r, diff + dq
    if diff > HNSW_DIFF_SHARE * rows:
        raise AssertionError(f"hnsw: {diff} of {rows} queries differ from "
                             f"the plain version")
    log("hnsw", f"kernel vs plain version, {rows} queries (the "
        f"{flat.shape[0]} turns at ef {', '.join(map(str, HNSW_EFS))} and "
        f"{HNSW_UP * HNSW_EFS[-1]}"
        f", descent and entry override): max_abs_err={err:.3g} (tol {TOL})"
        f", ids or graph_dists differ on {diff} ({diff / rows:.2%}; limit "
        f"{HNSW_DIFF_SHARE:.0%})")

    def config(ef, knobs):
        return ServingConfig(backend="hnsw", k=k, ef_search=ef, up=HNSW_UP,
                             **knobs)

    def engine(cls, ef, knobs, adaptive=False, **kw):
        eng = cls(config(ef, knobs), hnsw_index=index, **kw)
        if adaptive:
            eng.backend = dataclasses.replace(eng.backend, adaptive=True)
        return eng

    launches, graph = 0, {}
    n_conv, turns = convs.shape[:2]
    paths = [(name, knobs, a) for name, knobs, a in HSERVE] + [
        ("toploc cache", HBATCH[1][1], False)]
    for ef in HNSW_EFS:
        for name, knobs, adaptive in paths:
            serve_sequential(engine(ConversationalSearchEngine, ef, knobs,
                                    adaptive), convs[:1, :2])      # warm
            ops.reset_launches()
            eng = engine(ConversationalSearchEngine, ef, knobs, adaptive)
            _, ids, _ = serve_sequential(eng, convs)
            got = ops.hnsw_search.launches
            if got == 0:
                raise AssertionError(f"hnsw {name} ef={ef}: no kernel launch")
            launches += got
            lat = np.asarray([r.latency_s for r in eng.records]) * 1e3
            p50, p95 = np.percentile(lat, [50, 95])
            s = eng.summary()
            recall = np.mean([len(set(ids[c, t]) & set(exact[c, t])) / k
                              for c in range(n_conv) for t in range(turns)])
            graph[(name, ef)] = s["mean_graph_dists"]
            log("hnsw", f"ef={ef} {name}: turns={s['turns']} p50_ms="
                f"{p50:.3f} p95_ms={p95:.3f} mean_graph_dists="
                f"{s['mean_graph_dists']:.1f} recall@10={recall:.4f} (exact "
                f"over the {n} docs) cache_hit_rate="
                f"{s['cache_hit_rate']:.3f} hnsw_search_launches={got}")
    for ef in HNSW_EFS:
        log("hnsw", f"ef={ef}: mean graph_dists a turn, HNSW "
            f"{graph[('plain', ef)]:.1f}, TopLoc_HNSW "
            f"{graph[('toploc', ef)]:.1f} (adaptive "
            f"{graph[('toploc adaptive', ef)]:.1f}); TopLoc "
            f"{'<=' if graph[('toploc', ef)] <= graph[('plain', ef)] else '>'}"
            f" HNSW (printed, not a gate: the corpus shows little locality)")

    # the batched engine == the sequential engine, fig3's traffic
    n_turns = bconvs.shape[0] * bconvs.shape[1]
    for name, knobs in HBATCH:
        ef = HNSW_EFS[-1]
        seq = engine(ConversationalSearchEngine, ef, knobs)
        s_v, s_i, s_wall = serve_sequential(seq, bconvs)
        s_recs = {(r.conv_id, r.turn): [getattr(r, f) for f in BATCH_KEYS]
                  for r in seq.records}
        for b in BATCH_SIZES:
            def batched():
                return engine(BatchedConversationalSearchEngine, ef, knobs,
                              n_slots=BATCH_CONVS, max_batch=b,
                              max_wait_s=0.0, max_inflight=2)
            serve_rounds(batched(), bconvs[:, :1])                  # warm
            ops.reset_launches()
            eng = batched()
            v, i, wall = serve_rounds(eng, bconvs)
            got = ops.hnsw_search.launches
            recs = {(r.conv_id, r.turn): [getattr(r, f) for f in BATCH_KEYS]
                    for r in eng.records}
            if not (np.array_equal(v, s_v) and np.array_equal(i, s_i)
                    and recs == s_recs):
                raise AssertionError(f"[hnsw] {name} B={b}: the batched "
                                     f"engine differs from the sequential")
            if got == 0:
                raise AssertionError(f"hnsw batched {name} B={b}: no launch")
            launches += got
            waves = len(eng.batcher.batch_sizes)
            probe = batched()
            syncs, _ = count_syncs(lambda: serve_rounds(probe,
                                                        bconvs[:, :1]))
            req = np.asarray([r.latency_s + r.queue_wait_s
                              for r in eng.records]) * 1e3
            p50, p95 = np.percentile(req, [50, 95])
            log("hnsw", f"batched ef={ef} {name} B={b}: turns/s="
                f"{n_turns / wall:.1f} (sequential {n_turns / s_wall:.1f}) "
                f"request p50_ms={p50:.3f} p95_ms={p95:.3f} waves={waves} "
                f"launches/wave={got / waves:.2f} host_syncs/wave="
                f"{syncs / len(probe.batcher.batch_sizes):.2f} "
                f"cache_hit_rate={eng.summary()['cache_hit_rate']:.3f}; "
                f"== sequential (ids, scores, TurnStats, cache_hit)")

    # the kernel's time beside its bounds and the plain version's
    rtt = round_trip_ns(dev)
    log("hnsw", f"pointer chase: {rtt['dram']:.1f} ns a device-memory "
        f"round trip (256 MB, L2 flushed), {rtt['l2']:.1f} ns an L2 hit "
        f"(4 MB)")
    times = hnsw_times(index, flat, k, rtt["dram"])
    return launches, err, times, index


def phase_exact_serve(docs, convs, exact):
    """ExactBackend through the sequential engine over the whole corpus,
    the 25 x 10 turns at k = 10: its ids equal ``smoke_corpus``'s exact
    top-k (the same function, batch-size stable) bit for bit."""
    from repro_torch.serving import ConversationalSearchEngine, ServingConfig
    cfg = ServingConfig(backend="exact", k=exact.shape[-1])
    serve_sequential(ConversationalSearchEngine(cfg, doc_vecs=docs),
                     convs[:1, :2])                                 # warm
    eng = ConversationalSearchEngine(cfg, doc_vecs=docs)
    _, ids, _ = serve_sequential(eng, convs)
    if not np.array_equal(ids, exact):
        raise AssertionError("[exact] serve: ids differ from the exact "
                             "search of [index]")
    lat = np.asarray([r.latency_s for r in eng.records]) * 1e3
    p50, p95 = np.percentile(lat, [50, 95])
    log("exact", f"serve ExactBackend over all {docs.shape[0]} docs: turns="
        f"{len(eng.records)} p50_ms={p50:.3f} p95_ms={p95:.3f}; ids == "
        f"[index]'s exact top-{exact.shape[-1]} bit for bit")


# ---------------------------------------------------------------------------
# [sharded] / [router]: the corpus split over shards of one card, and two
# replicas behind the router
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4)
SHARD_PATHS = (("toploc+ fused", dict(strategy="toploc+", fused=True)),
               ("toploc+ fused bf16", dict(strategy="toploc+", fused=True,
                                           precision="bf16")),
               ("toploc+ fused int8", dict(strategy="toploc+", fused=True,
                                           precision="int8")),
               ("toploc+ unfused", dict(strategy="toploc+", fused=False)))
SHARD_ROW = {"ivf": "fused_scan", "ivf_pq": "fused_scan_pq"}
SHARD_QUERIES = 4             # queries of the per-shard kernel checks


def shard_mesh(s, dev):
    from repro_torch.distributed import retrieval as R
    return R.retrieval_mesh(s, devices=[dev] * s)


def shard_run(backend, index, convs, knobs, mesh=None):
    """The 25 x 10 turns through the sequential engine (the mesh's, or
    unsharded), after a warm-up on two turns, the launch counts set to 0
    between the two: (engine, scores, ids, latencies ms)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ConversationalSearchEngine, ServingConfig
    cfg = ServingConfig(**{"backend": backend, **knobs}, mesh=mesh)
    serve_sequential(ConversationalSearchEngine(
        cfg, **{f"{backend}_index": index}), convs[:1, :2])        # warm
    ops.reset_launches()
    eng = ConversationalSearchEngine(cfg, **{f"{backend}_index": index})
    vs, ids, _ = serve_sequential(eng, convs)
    return eng, vs, ids, np.asarray([r.latency_s for r in eng.records]) * 1e3


def shard_rows_check(backend, index, docs, q, sel, dev, errs):
    """Each shard's row 6 / row 7 call, as ``ShardedIVFScan`` /
    ``ShardedPQScan`` make it (the shard's lists, the selection clipped
    into them, ``own``), against its plain version on the same inputs:
    row 6 under the tie rule (``compare``), row 7's ADC top r bit for
    bit, at f32, bf16 and int8.  Returns the calls checked."""
    import torch
    from repro_torch.core import toploc
    from repro_torch.distributed import retrieval as R
    from repro_torch.kernels import ops, ref
    k, calls = 10, 0
    for s in SHARD_COUNTS:
        placed = R.shard_backend(shard_mesh(s, dev), _bk(backend),
                                 index)[1]
        lists = placed.list_vecs if backend == "ivf" else placed.list_codes
        ids = placed.list_ids
        tables = None if backend == "ivf" else toploc._adc_tables(index, q)
        for j in range(s):
            lo, hi = lists.bounds(j)
            own, ss = R.local_selection(sel, lo, hi, dev)
            ss = ss.to(torch.int32)
            for prec in ("f32",) + QUANT:
                what = f"[sharded] S={s} shard {j} {SHARD_ROW[backend]}[{prec}]"
                if backend == "ivf":
                    r = None if prec == "f32" else ops._fused_depth(
                        k, sel.shape[1] * index.lmax, 2 * k)
                    got = ops.fused_scan(q, lists.parts[j], ids.parts[j], ss,
                                         k, own=own, precision=prec)
                    want = ref.fused_scan_ivf(q, lists.parts[j],
                                              ids.parts[j], ss, own, k=k,
                                              precision=prec, r=r)
                    err, _ = compare(what, got[0], got[1], want[0], want[1],
                                     dot_rows(docs, q), docs.shape[0])
                    key = "fused_scan" if prec == "f32" else \
                        f"fused_scan[{prec}]"
                    errs[key] = max(errs.get(key, 0.0), err)
                else:
                    r = ops._fused_depth(k, sel.shape[1] * index.lmax,
                                         RERANK)
                    equal(what, ops.fused_scan_pq(
                        tables, q, lists.parts[j], ids.parts[j], ss,
                        placed.doc_vecs.parts[j], k, rerank=RERANK, own=own,
                        fuse_rerank=False, precision=prec),
                        ref.fused_scan_pq(tables, q, lists.parts[j],
                                          ids.parts[j], ss, own, None, k=k,
                                          r=r, rerank=False, precision=prec),
                        ("v", "ids", "pos"))
                calls += 1
    return calls


def _bk(backend):
    from repro_torch.core import backend as B
    return B.make(backend)


def sharded_hnsw_times(index, flat, k, rtt_ns, s, dev, steps,
                       ef=HNSW_EFS[-1]):
    """The sharded instance's CUDA-event ms at S shards of one card, B =
    1 (8 calls) and 32 (4 calls), L2 flushed, beside the unsharded
    kernel's on the same queries (in turns: unsharded, sharded,
    sharded, unsharded), the plain sharded version's, the byte bound and
    the chain bound (the same traversal as the unsharded search's: its
    longest search's steps, ``steps`` {B: mean over the calls}, counted
    once for every S).  Returns {B: row}."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops, ref
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sh = SH.split_rows(index.vectors, [dev] * s)
    g = (index.adj0, index.upper_adj, index.entry_point)
    dots = ref.hnsw_sharded_dots(sh.parts, sh.per)
    times = {}
    for b in (1, 32):
        qs = [flat[j * b:(j + 1) * b] for j in range(8 if b == 1 else 4)]
        works = [hnsw_bound(index, ops.hnsw_search(index.vectors, *g, q,
                                                   ef=ef, k=k)[2],
                            q.shape[0], k) for q in qs]
        calls = [lambda q=q: ops.hnsw_search_sharded(sh.parts, sh.per, *g,
                                                     q, ef=ef, k=k)
                 for q in qs]
        flat_calls = [lambda q=q: ops.hnsw_search(index.vectors, *g, q,
                                                  ef=ef, k=k) for q in qs]
        plain = [lambda q=q: ref.hnsw_search(None, *g, q, ef=ef, k=k,
                                             dots_factory=dots) for q in qs]
        unsharded = [event_ms(flat_calls, flush, spin=True)]
        row = timed(calls, plain, works, flush)
        row["ms"] = float(np.mean([row["ms"],
                                   event_ms(calls, flush, spin=True)]))
        unsharded.append(event_ms(flat_calls, flush, spin=True))
        row["unsharded_ms"] = float(np.mean(unsharded))
        if b not in steps:
            steps[b] = float(np.mean([max(hnsw_steps(index, q[i:i + 1], ef,
                                                     k)
                                          for i in range(q.shape[0]))
                                      for q in qs]))
        row["steps"] = steps[b]
        row["chain_ms"] = row["steps"] * rtt_ns / 1e6
        times[b] = row
        log("sharded", f"hnsw_search sharded S={s} ef={ef} B={b} (L2 "
            f"flushed): {row['ms']:.4f} ms a call, unsharded "
            f"{row['unsharded_ms']:.4f} ms (same queries, in turns), plain "
            f"sharded {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} "
            f"ms ({row['bound_by']}), chain bound {row['chain_ms']:.4f} ms "
            f"({row['steps']:.1f} steps x {rtt_ns:.1f} ns), "
            f"{row['kernels']} kernel a call")
    return times


def phase_sharded(args, indexes, docs, convs, graph, dev, errs,
                  steps=None):
    """``[sharded]``: the corpus split over S = 2 and 4 shards of one card
    (``retrieval_mesh(S, devices=[cuda:0] x S)``; each shard a view of the
    unsharded tensors).  Per backend and path, the 25 x 10 turns through
    the sequential engine at each S, the launch counts set to 0 just
    before each run and read just after, beside the unsharded engine on
    the same turns: at f32 ids, scores and every counter equal (the
    fused IVF-PQ turn to the unsharded unfused one: its re-rank is the
    single-device multiply-reduce); bf16 / int8 print their agreement.
    Each shard's row 6 / 7 call against its plain version; HNSW on the
    [hnsw] graph: the sharded engine == the unsharded one, the sharded
    ``hnsw_search`` instance == its plain sharded version (under the
    tie rule) and == the unsharded kernel on every turn, and its times
    (``steps``: the chain steps {B: steps} of ``hnsw_times`` on the same
    graph and turns, counted here when not given).  Returns (launches,
    hnsw_search_sharded max_abs_err, times)."""
    import torch
    from repro_torch.core.topk import topk
    from repro_torch.distributed import retrieval as R
    from repro_torch.kernels import ops, ref
    launches = {}
    t_phase = time.perf_counter()
    flat = torch.from_numpy(convs.reshape(-1, args.d)).to(dev)
    for backend in ("ivf", "ivf_pq"):
        index = indexes[backend]
        _, sel = topk(ref.gemv_rows(index.centroids, flat), args.nprobe)
        sizes = index.list_sizes.cpu().numpy()
        for s in SHARD_COUNTS:
            work = R.per_shard_list_work(sizes, sel.cpu().numpy(), s)
            placed = R.shard_backend(shard_mesh(s, dev), _bk(backend),
                                     index)[1]
            log("sharded", f"{backend} S={s}: shards of "
                f"{placed.list_ids.per} lists (last "
                f"{placed.list_ids.parts[-1].shape[0]}), bytes placed "
                f"{R.placed_bytes(placed)} (views of the unsharded index); "
                f"per-shard list work of the {flat.shape[0]} turns' plain "
                f"selections "
                f"(nprobe {args.nprobe}): {work.tolist()} = {int(work.sum())}"
                f", max / mean {work.max() / work.mean():.3f}")
        n = shard_rows_check(backend, index, docs, flat[:SHARD_QUERIES],
                             sel[:SHARD_QUERIES].to(torch.int32), dev, errs)
        log("sharded", f"{backend}: {n} per-shard {SHARD_ROW[backend]} calls "
            f"(S = {', '.join(map(str, SHARD_COUNTS))}, every shard, f32 / "
            f"bf16 / int8, B = {SHARD_QUERIES}, nprobe {args.nprobe}) == "
            f"their plain versions ("
            + ("under the tie rule, tol " + str(TOL) if backend == "ivf"
               else "ADC top r bit for bit") + ")")
        base = {name: shard_run(backend, index, convs, knobs)
                for name, knobs in SHARD_PATHS}
        for name, knobs in SHARD_PATHS:
            prec = knobs.get("precision", "f32")
            row = SHARD_ROW[backend] + ("" if prec == "f32" else f"[{prec}]")
            want = base[name]
            if backend == "ivf_pq" and knobs["fused"] and prec == "f32":
                want = base["toploc+ unfused"]
            for s in SHARD_COUNTS:
                eng, vs, ids, lat = shard_run(backend, index, convs, knobs,
                                              shard_mesh(s, dev))
                got = ops.fused_scan.launches + ops.fused_scan_pq.launches
                if knobs["fused"]:
                    if got != s * vs.shape[0] * vs.shape[1]:
                        raise AssertionError(f"[sharded] {backend} {name} "
                                             f"S={s}: {got} launches")
                    launches[row] = launches.get(row, 0) + got
                w_eng, w_vs, w_ids, w_lat = want
                same_ids = float(np.mean(ids == w_ids))
                if prec == "f32":
                    if not (np.array_equal(vs, w_vs)
                            and np.array_equal(ids, w_ids)
                            and same_records(eng, w_eng)):
                        raise AssertionError(
                            f"[sharded] {backend} {name} S={s}: differs from "
                            f"the unsharded engine")
                    note = "== unsharded" + (" unfused" if want is not
                                             base[name] else "") + \
                        " (ids, scores, TurnStats)"
                else:
                    rec = np.mean([len(set(a) & set(b)) / args.k for a, b in
                                   zip(ids.reshape(-1, args.k),
                                       w_ids.reshape(-1, args.k))])
                    note = (f"vs unsharded {name}: recall@10 {rec:.4f}, ids "
                            f"equal at {same_ids:.4f} of slots, TurnStats "
                            f"equal: {same_records(eng, w_eng)}")
                p50, p95 = np.percentile(lat, [50, 95])
                u50, u95 = np.percentile(w_lat if want is base[name]
                                         else base[name][3], [50, 95])
                log("sharded", f"{backend} {name} S={s}: p50_ms={p50:.3f} "
                    f"p95_ms={p95:.3f} (unsharded {u50:.3f} / {u95:.3f}) "
                    f"{row}_launches={got}; {note}")

    # HNSW on the [hnsw] graph
    k, ef = args.k, HNSW_EFS[-1]
    hflat = flat
    from repro_torch.distributed import sharding as SH
    diff = rows = 0
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    entry = torch.randint(0, graph.n, (flat.shape[0],), generator=gen,
                          device=dev, dtype=torch.int32)
    g = (graph.adj0, graph.upper_adj, graph.entry_point)
    for s in SHARD_COUNTS:
        sh = SH.split_rows(graph.vectors, [dev] * s)
        dots = ref.hnsw_sharded_dots(sh.parts, sh.per)
        for e in (None, entry):
            for ef_ in HNSW_EFS + (HNSW_UP * ef,):
                got = ops.hnsw_search_sharded(sh.parts, sh.per, *g, hflat, e,
                                              ef=ef_, k=k)
                one = ops.hnsw_search(graph.vectors, *g, hflat, e, ef=ef_,
                                      k=k)
                equal(f"[sharded] hnsw_search S={s} ef={ef_} == unsharded",
                      got, one, ("v", "ids", "ndist"))
            q, ee = hflat[:SHARD_QUERIES], None if e is None else \
                e[:SHARD_QUERIES]
            kv, ki, kn = ops.hnsw_search_sharded(sh.parts, sh.per, *g, q, ee,
                                                 ef=ef, k=k)
            pv, pi, pn = ref.hnsw_search(None, *g, q, ee, ef=ef, k=k,
                                         dots_factory=dots)
            same = (ki == pi).all(-1) & (kn == pn)
            x, _ = compare(f"[sharded] hnsw_search S={s} vs plain", kv[same],
                           ki[same], pv[same], pi[same],
                           dot_rows(graph.vectors, q[same]), graph.n)
            err, rows, diff = max(err, x), rows + q.shape[0], \
                diff + int((~same).sum())
    if diff > HNSW_DIFF_SHARE * rows + 1:
        raise AssertionError(f"[sharded] hnsw: {diff} of {rows} queries "
                             f"differ from the plain sharded version")
    log("sharded", f"hnsw_search sharded (S = "
        f"{', '.join(map(str, SHARD_COUNTS))}, the {flat.shape[0]} turns at "
        f"ef {', '.join(map(str, HNSW_EFS))}, {HNSW_UP * ef}, descent and "
        f"entry override) == the unsharded kernel bit for bit; vs its plain "
        f"sharded version ({rows} queries): max_abs_err={err:.3g} (tol "
        f"{TOL}), {diff} differ")
    knobs = dict(strategy="toploc", ef_search=ef, up=HNSW_UP)
    base = shard_run("hnsw", graph, convs, knobs)
    n_launch = 0
    for s in SHARD_COUNTS:
        mesh = shard_mesh(s, dev)
        eng, vs, ids, lat = shard_run("hnsw", graph, convs, knobs, mesh)
        got = ops.hnsw_search_sharded.launches
        if got == 0 or ops.hnsw_search.launches:
            raise AssertionError(f"[sharded] hnsw S={s}: launches {got}, "
                                 f"unsharded {ops.hnsw_search.launches}")
        n_launch += got
        if not (np.array_equal(vs, base[1]) and np.array_equal(ids, base[2])
                and same_records(eng, base[0])):
            raise AssertionError(f"[sharded] hnsw S={s}: differs from the "
                                 f"unsharded engine")
        p50, p95 = np.percentile(lat, [50, 95])
        u50, u95 = np.percentile(base[3], [50, 95])
        log("sharded", f"hnsw toploc ef={ef} S={s}: p50_ms={p50:.3f} "
            f"p95_ms={p95:.3f} (unsharded {u50:.3f} / {u95:.3f}) "
            f"hnsw_search_sharded_launches={got}; == unsharded (ids, "
            f"scores, TurnStats); bytes placed "
            f"{R.placed_bytes(R.shard_hnsw_index(mesh, graph))}")
    launches["hnsw_search_sharded"] = n_launch
    rtt = round_trip_ns(dev)
    steps = dict(steps or {})
    times = {s: sharded_hnsw_times(graph, flat, k, rtt["dram"], s, dev,
                                   steps) for s in SHARD_COUNTS}
    log("sharded", f"phase {time.perf_counter() - t_phase:.1f}s")
    return launches, err, times


def phase_router(index, convs, dev):
    """``[router]``: ``ReplicatedSearchEngine`` with two replicas on one
    card (two batched engines on cuda:0, a stream each), then two
    replicas x two shards.  Stateful toploc+ fused traffic pinned per
    session equals the sequential engine per session bit for bit;
    stateless plain fused traffic is hedged (hedge floor 0, so hedges
    fire) and equals the sequential plain engine whichever replica
    wins (the oracle: a sequential engine of one replica's config).
    Returns the launches of rows 4 and 6."""
    from repro_torch.distributed import retrieval as R
    from repro_torch.kernels import ops
    from repro_torch.serving import (ConversationalSearchEngine,
                                     ReplicatedSearchEngine, ServingConfig)
    n_conv, turns = convs.shape[:2]
    launches = {}
    t_phase = time.perf_counter()
    meshes = [("2 replicas", None),
              ("2 replicas x 2 shards",
               R.retrieval_mesh(2, replicas=2, devices=[dev] * 4))]
    for strategy in ("toploc+", "plain"):
        cfg = ServingConfig(backend="ivf", strategy=strategy, fused=True)
        for what, mesh in meshes:
            # the oracle: one sequential engine of a replica's config
            sub = None if mesh is None else R.replica_submeshes(mesh)[0]
            seq = ConversationalSearchEngine(
                dataclasses.replace(cfg, mesh=sub), ivf_index=index)
            s_v, s_i, _ = serve_sequential(seq, convs)
            ops.reset_launches()
            t0 = time.perf_counter()
            with ReplicatedSearchEngine(
                    dataclasses.replace(cfg, mesh=mesh), replicas=2,
                    ivf_index=index, n_slots=32, max_batch=8,
                    max_wait_s=0.0 if strategy != "plain" else 0.002,
                    hedge_floor_s=0.0) as eng:
                vs = np.zeros_like(s_v)
                ids = np.zeros_like(s_i)
                for t in range(turns):
                    futs = [eng.submit(f"c{c}", convs[c, t])
                            for c in range(n_conv)]
                    if eng.stateful:
                        eng.drain()
                    for c, f in enumerate(futs):
                        vs[c, t], ids[c, t] = f.result(timeout=60)
                wall = time.perf_counter() - t0
                stats = (eng.load_stats() if eng.stateful
                         else eng.hedge_stats())
            for op in ("fused_scan", "fused_turn"):
                launches[op] = launches.get(op, 0) + getattr(ops, op).launches
            if not (np.array_equal(vs, s_v) and np.array_equal(ids, s_i)):
                raise AssertionError(f"[router] {strategy} {what}: differs "
                                     f"from the sequential engine")
            log("router", f"ivf {strategy} fused, {what} on one card: "
                f"{n_conv * turns} turns in {wall:.3f}s "
                f"({n_conv * turns / wall:.1f} turns/s), launches "
                f"fused_scan={ops.fused_scan.launches} fused_turn="
                f"{ops.fused_turn.launches}; "
                + ("pinned per session, " if strategy != "plain" else
                   "hedged, ") + f"{stats}; == the sequential engine "
                f"(ids, scores)")
    log("router", f"phase {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phases 14-15: kernel times beside their bounds; the LM at decode_32k
# ---------------------------------------------------------------------------


def event_ms(calls, flush, *, spin):
    """Mean CUDA-event time of each call, with the L2 cache flushed
    (``flush`` overwritten) before each.  With ``spin`` a spin kernel
    queued first lets the host enqueue every call before the device
    starts them, so host overhead does not show as device time; calls
    that synchronise with the host themselves (the plain versions of the
    retrieval kernels) run without it and their time includes that
    overhead."""
    import torch
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in calls]
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(200_000_000)
    for c, (start, end) in zip(calls, marks):
        flush.zero_()
        start.record()
        c()
        end.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in marks]))


def scan_bound(index, q, sel, r_pad):
    """(bytes, flops) fused_scan must move and do for these inputs: the
    real rows of the probed lists, their ids, the query, the selection
    and the (B, r_pad) outputs."""
    b, nprobe = sel.shape
    rows = int(index.list_sizes[sel.long()].sum())
    nbytes = (rows * index.d * 4 + b * nprobe * index.lmax * 4
              + q.numel() * 4 + sel.numel() * 4 + b * r_pad * 12)
    return nbytes, 2 * rows * index.d


def adc_bound(pqi, q, sel, r, out_w, rerank):
    """(bytes, flops) of the ADC scan of these inputs: the code rows of
    the probed lists' real docs, their ids, the (B, m, 256) LUTs, the
    selection and the (B, out_w) outputs; ``m`` adds per real row.  With
    ``rerank``, the query and the corpus rows of each query's min(r,
    real rows) candidates, and their dot products."""
    b, nprobe = sel.shape
    real = pqi.list_sizes[sel.long()].sum(-1)
    rows = int(real.sum())
    nbytes = (rows * pqi.m + b * nprobe * pqi.lmax * 4
              + b * pqi.codewords.shape[:2].numel() * 4 + sel.numel() * 4
              + b * out_w * 12)
    flops = rows * pqi.m
    if rerank:
        cand = int(real.clamp(max=r).sum())
        nbytes += q.numel() * 4 + cand * pqi.d * 4
        flops += 2 * cand * pqi.d
    return nbytes, flops


def bound_ms(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """The least time for this work: bytes over the memory rate or
    operations over the peak rate of the inputs' type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernels_a_call(call):
    """The kernels one call launches, from the launch plan the recorder
    records for it (``tiling.plan_*``; ``[plans]`` holds the plans to
    the profiler); nothing is launched."""
    from repro_torch.kernels import launcher
    with launcher.record_launches() as records:
        call()
    return sum(len(r.plan) for r in records)


def timed(kernel_calls, plain_calls, works, flush, plain_syncs=True):
    """One kernel's row: kernel and plain-version times, mean bound, and
    the kernels the first call launches.  A plain version that never
    waits for the host (``plain_syncs`` False) is timed behind the spin
    too, so its time is the device's."""
    return dict(ms=event_ms(kernel_calls, flush, spin=True),
                plain_ms=event_ms(plain_calls, flush, spin=not plain_syncs),
                bound_ms=float(np.mean([bound_ms(*w)[0] for w in works])),
                bound_by=bound_ms(*works[0])[1],
                kernels=kernels_a_call(kernel_calls[0]))


def phase_times(args, index, pqi, convs, dev):
    import torch
    from repro_torch.core import toploc
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref, tiling
    reps = 25
    k, nprobe = args.k, args.nprobe
    r_pad = tiling.next_pow2(k)
    r = max(k, min(RERANK, nprobe * pqi.lmax))
    qs = torch.from_numpy(np.ascontiguousarray(convs[:, 0])).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    lv, li, c = index.list_vecs, index.list_ids, index.centroids
    codes, docs = pqi.list_codes, pqi.doc_vecs
    out = {}
    for b in (1, 25):
        batches = ([qs[j:j + 1] for j in range(reps)] if b == 1
                   else [qs] * 5)
        sels = [topk(ref.gemv_rows(c, q), nprobe)[1].to(torch.int32)
                for q in batches]
        tabs = [toploc._adc_tables(pqi, q) for q in batches]
        args_ = list(zip(batches, sels, tabs))
        calls = {
            "fused_scan": (
                [lambda q=q, s=s: ops.fused_scan(q, lv, li, s, k)
                 for q, s, _ in args_],
                [lambda q=q, s=s: ref.fused_scan_ivf(q, lv, li, s, None, k=k)
                 for q, s, _ in args_]),
            "fused_turn": (
                [lambda q=q: ops.fused_turn(q, c, lv, li, nprobe=nprobe, k=k)
                 for q in batches],
                [lambda q=q: ref.fused_turn_ivf(q, c, lv, li, nprobe=nprobe,
                                                k=k) for q in batches]),
            "pq_adc_scan": (
                [lambda t=t, s=s: ops.pq_adc_scan(t, codes, li, s, r)
                 for _, s, t in args_],
                [lambda t=t, s=s: ref.pq_adc_scan_batch(t, codes, li, s, r)
                 for _, s, t in args_]),
            "fused_scan_pq": (
                [lambda q=q, s=s, t=t: ops.fused_scan_pq(
                    t, q, codes, li, s, docs, k, rerank=RERANK)
                 for q, s, t in args_],
                [lambda q=q, s=s, t=t: ref.fused_scan_pq(
                    t, q, codes, li, s, None, docs, k=k, r=r, rerank=True)
                 for q, s, t in args_]),
            "fused_turn_pq": (
                [lambda q=q, t=t: ops.fused_turn_pq(
                    q, c, t, codes, li, docs, nprobe=nprobe, k=k,
                    rerank=RERANK) for q, _, t in args_],
                [lambda q=q, t=t: ref.fused_turn_pq(
                    q, c, t, codes, li, docs, nprobe=nprobe, k=k, r=r)
                 for q, _, t in args_]),
        }
        scan_w = [scan_bound(index, q, s, r_pad) for q, s, _ in args_]
        centroids = [(index.p * index.d * 4 + q.numel() * 4,
                      2 * q.shape[0] * index.p * index.d) for q in batches]
        works = {
            "fused_scan": scan_w,
            # fused_turn adds the centroid table, read once, and its products
            "fused_turn": [(nb + cb - q.numel() * 4, fl + cf) for
                           (nb, fl), (cb, cf), q in
                           zip(scan_w, centroids, batches)],
            "pq_adc_scan": [adc_bound(pqi, q, s, r, tiling.next_pow2(r),
                                      False) for q, s, _ in args_],
            "fused_scan_pq": [adc_bound(pqi, q, s, r, r_pad, True)
                              for q, s, _ in args_],
            "fused_turn_pq": [(nb + cb - q.numel() * 4, fl + cf) for
                              (nb, fl), (cb, cf), q in zip(
                                  [adc_bound(pqi, q, s, r, r_pad, True)
                                   for q, s, _ in args_],
                                  centroids, batches)],
        }
        design = {}
        r_q = ops._fused_depth(k, nprobe * index.lmax, 2 * k)
        for prec in QUANT:
            calls.update(quant_calls(prec, index, pqi, args_, batches, k,
                                     nprobe, r, r_q))
            for op in QUANT_OPS:
                # the function reads each input once whatever the
                # precision: the f32 row's bound
                works[f"{op}[{prec}]"] = works[op]
                design[f"{op}[{prec}]"] = float(np.mean([
                    bound_ms(nb + quant_extra(op, prec, index, s, q, r_q),
                             0)[0] for (nb, _), (q, s, _) in
                    zip(works[op], args_)]))
        for kern, plain in calls.values():                     # warm-up
            event_ms(kern[:2], flush, spin=True)
        row = {name: timed(kern, plain, works[name], flush)
               for name, (kern, plain) in calls.items()}
        for name, rr in row.items():
            extra = (f" design_bound_ms={design[name]:.4f} (re-rank rows)"
                     if name in design else "")
            log("times", f"{name} B={b}: ms={rr['ms']:.4f} "
                f"plain_ms={rr['plain_ms']:.4f} "
                f"bound_ms={rr['bound_ms']:.4f} ({rr['bound_by']}) "
                f"share={rr['bound_ms'] / rr['ms']:.3f}{extra} "
                f"kernels_a_call={rr['kernels']}")
        out[b] = row
    return out


def quant_calls(prec, index, pqi, args_, batches, k, nprobe, r, r_q):
    """Kernel and plain-version calls of rows 4-7 at ``prec``."""
    from repro_torch.kernels import ops, ref
    lv, li, c = index.list_vecs, index.list_ids, index.centroids
    codes, docs = pqi.list_codes, pqi.doc_vecs
    return {
        f"fused_scan[{prec}]": (
            [lambda q=q, s=s: ops.fused_scan(q, lv, li, s, k, precision=prec)
             for q, s, _ in args_],
            [lambda q=q, s=s: ref.fused_scan_ivf(q, lv, li, s, None, k=k,
                                                 precision=prec, r=r_q)
             for q, s, _ in args_]),
        f"fused_turn[{prec}]": (
            [lambda q=q: ops.fused_turn(q, c, lv, li, nprobe=nprobe, k=k,
                                        precision=prec) for q in batches],
            [lambda q=q: ref.fused_turn_ivf(q, c, lv, li, nprobe=nprobe, k=k,
                                            precision=prec, r=r_q)
             for q in batches]),
        f"fused_scan_pq[{prec}]": (
            [lambda q=q, s=s, t=t: ops.fused_scan_pq(
                t, q, codes, li, s, docs, k, rerank=RERANK, precision=prec)
             for q, s, t in args_],
            [lambda q=q, s=s, t=t: ref.fused_scan_pq(
                t, q, codes, li, s, None, docs, k=k, r=r, rerank=True,
                precision=prec) for q, s, t in args_]),
        f"fused_turn_pq[{prec}]": (
            [lambda q=q, t=t: ops.fused_turn_pq(
                q, c, t, codes, li, docs, nprobe=nprobe, k=k, rerank=RERANK,
                precision=prec) for q, _, t in args_],
            [lambda q=q, t=t: ref.fused_turn_pq(
                q, c, t, codes, li, docs, nprobe=nprobe, k=k, r=r,
                precision=prec) for q, _, t in args_]),
    }


def quant_extra(op, prec, index, sel, q, r_q):
    """Bytes the quantised kernels' design moves beyond the function's
    own: the IVF re-rank reads r candidate rows again.  The int8 group
    scales come from the index once (``ops.group_scales``), not from a
    pass a call."""
    b = sel.shape[0]
    return b * r_q * index.d * 4 if op in ("fused_scan", "fused_turn") else 0


def decode_bound(q, k, lens):
    """(bytes, flops) of decode attention over these inputs: each row's
    first min(cache_len, S) rows of K and V read once, q and cache_len
    read once, the output written once; 4 FLOP per cache element per
    query head of the group."""
    b, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rows = int(lens.clamp(max=s).sum())
    nbytes = (2 * rows * hkv * d * k.element_size() + 2 * q.numel()
              * q.element_size() + lens.numel() * 4)
    return nbytes, 4 * rows * h * d


def phase_decode_times(args, dev):
    """flash_decode at the RAG shape (B = 1, S = 1,024) and the
    decode_32k shape cut to B = 8 (S = 32,768), Yi-9B's heads (32 query,
    4 kv, D = 128), bf16, every row's cache full, L2 flushed; beside its
    plain version (device time: it never syncs) and, timed only,
    ``scaled_dot_product_attention`` on q as (B, H, 1, D) with
    ``enable_gqa`` and the cache_len mask."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, s, reps in ((1, RAG_MAX_LEN, 25), (8, 32_768, 10)):
        q = torch.randn((b, 32, 128), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((b, 4, s, 128), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        mask = (torch.arange(s, device=dev)[None] < lens[:, None]
                )[:, None, None]
        kern = [lambda: ops.flash_decode(q, k, v, lens)] * reps
        plain = [lambda: ref.decode_attention(q, k, v, lens)] * reps
        lib = [lambda: sdpa(q[:, :, None], k, v, attn_mask=mask,
                            enable_gqa=True)] * reps
        for calls in (kern, plain, lib):                    # warm-up
            event_ms(calls[:2], flush, spin=True)
        nbytes, flops = decode_bound(q, k, lens)
        row = timed(kern, plain, [(nbytes, flops, BF16_FLOP_PER_S)] * reps,
                    flush, plain_syncs=False)
        row["library_ms"] = event_ms(lib, flush, spin=True)
        log("times", f"flash_decode B={b} H=32 Hkv=4 S={s} D=128 bf16, "
            f"cache full: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB) share={row['bound_ms'] / row['ms']:.3f} "
            f"kernels_a_call={row['kernels']}")
        out[b] = row
        del q, k, v
    torch.cuda.empty_cache()
    return out


def phase_decode32k(args, dev):
    """The decode_32k serve shape (configs/common.py LM_SHAPE_PARAMS:
    seq 32,768, batch 128) cut to B = DECODE32K_B: B = 128 would need
    412 GB of cache.  Yi-9B at full width and depth, bf16, random
    weights; the (48, 8, 4, 32,768, 128) K and V caches (25.8 GB) drawn
    from the generator; cache_len per row in [16,384, 32,767].  Step ms
    against the step's bytes over 3.35 TB/s (weights + each row's K/V
    up to cache_len): arithmetic, not a measurement.  Launch counts are
    set to 0 just before the timed steps and read just after."""
    import torch
    from repro_torch.configs import common, yi_9b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TF
    cfg = yi_9b.full_config()
    shape = common.LM_SHAPE_PARAMS["decode_32k"]
    s, b_full = shape["seq_len"], shape["global_batch"]
    b = DECODE32K_B
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm = TF.init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    t0 = time.perf_counter()
    cache = lm.init_cache(b, s)
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[name][layer].normal_(generator=gen)
    lens = torch.randint(s // 2, s, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen, device=dev)
    logits, cache = lm.decode_step(cache, tok, lens)           # warm-up
    torch.cuda.synchronize()
    steps = DECODE32K_STEPS
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = lm.decode_step(cache, logits.argmax(-1), lens + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    n = launch_counts()
    if n["flash_decode"] != cfg.n_layers * steps or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode32k: {n['flash_decode']} flash_decode "
                             f"launches, logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    prof = profile_device(
        lambda: lm.decode_step(cache, tok, lens + steps), 3,
        (("flash_decode", ("decode_mma", "decode_split",
                           "decode_combine")),
         ("gemm", GEMM_NAMES)))
    # the weights a step reads: all but the embedding table, of which it
    # gathers B rows
    w_bytes = (cfg.param_count() - cfg.vocab * cfg.d_model
               + b * cfg.d_model) * 2
    # step i attends to min(cache_len + i + 1, S) positions a row
    rows = sum(int((lens + i + 1).clamp(max=s).sum()) for i in range(steps))
    kv_bytes = rows / steps * cfg.kv_bytes_per_token()
    bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    full = (w_bytes + b * s * cfg.kv_bytes_per_token()) / HBM_BYTES_PER_S * 1e3
    log("decode32k", f"{cfg.name} decode_32k seq={s} batch {b_full} cut to "
        f"B={b} (B={b_full} needs {b_full * s * cfg.kv_bytes_per_token() / 1e9:.0f} "
        f"GB of cache): cache {cache['k'].numel() * 4 / 1e9:.1f} GB bf16 "
        f"filled in {t_fill:.2f} s, cache_len in [{int(lens.min())}, "
        f"{int(lens.max())}]; {steps} steps: step_ms={step_ms:.3f} "
        f"tokens_per_s={b / step_ms * 1e3:.1f} "
        f"flash_decode_launches={n['flash_decode']}; the step's bytes "
        f"(weights {w_bytes / 1e9:.2f} GB + K/V to cache_len "
        f"{kv_bytes / 1e9:.2f} GB) / 3.35 TB/s = {bound:.3f} ms "
        f"(share {bound / step_ms:.3f}; {full:.3f} ms with every row full, "
        f"arithmetic) max_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    log("profile", f"{cfg.name} decode_32k step, B={b} (torch.profiler, "
        f"{prof.pop('reps')} steps; device ms per step): " + " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in prof.items())
        + f"; the card idles {1 - prof['busy_ms'] / step_ms:.3f} of a step")
    del lm, cache, logits
    torch.cuda.empty_cache()
    return n


def attn_bound(q, k, v, causal=False):
    """(bytes, flops) of attention over these inputs: q, k, v read once,
    the output written once, in their dtype; the QK^T and PV products
    (causal: only the unmasked half, bottom-right, that the work
    needs)."""
    b, h, s, d = q.shape
    skv, dv = k.shape[2], v.shape[3]
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + b * h * s * dv)
    pairs = s * skv
    if causal:   # query i (of S, the last of Skv) sees skv - s + i + 1 keys
        pairs = s * (skv - s) + s * (s + 1) // 2
    return nbytes, 2 * b * h * pairs * (d + dv)


def sdpa_backend(q, k, v, causal):
    """The backend scaled_dot_product_attention picks for these inputs
    (PyTorch's own dispatcher, ``torch._fused_sdp_choice``) and the
    device kernels one call runs (torch.profiler, host and device
    activity, taken again up to 3 times while it sees none; each name
    cut to 48 characters)."""
    import torch
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile
    gqa = q.shape[1] != k.shape[1]
    name = SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask=None, dropout_p=0.0, is_causal=causal,
        scale=None, enable_gqa=gqa)).name
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return (f"{name}: " + (" | ".join(dict.fromkeys(n[:48] for n in names))
                           or "no kernel traced"))


def phase_attn_times(args, dev):
    """flash_attention at dragon's query (B = 1) and doc-batch (B =
    DOC_BATCH) shapes in float32 and at Yi-9B's RAG prefill (B = 1, 32 /
    4 heads, S = 784, D = 128, causal) and DeepSeek-V2-Lite's MLA
    prefill (16 heads, D = 192, Dv = 128) in bf16, beside its plain version
    (no host sync: device time, as the kernel's) and, timed only,
    PyTorch's ``scaled_dot_product_attention`` on the same tensors.  The
    float32 bound is at the 3xTF32 rate (the f32 FMA bound beside it),
    the bf16 one at the bf16 tensor-core rate."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, shape, dtype, reps in (
            (1, (1, 12, 12, 256, 256, 64, 64, False), torch.float32, 25),
            (DOC_BATCH, (DOC_BATCH, 12, 12, 256, 256, 64, 64, False),
             torch.float32, 5),
            ("yi", (1, 32, 4, 784, 784, 128, 128, True), torch.bfloat16,
             25),
            ("mla", MLA_ATTN, torch.bfloat16, 25)):
        causal = shape[-1]
        qkv = [[t.to(dtype) for t in attn_inputs(shape, gen, dev)]
               for _ in range(reps)]
        kern = [lambda x=x: ops.flash_attention(*x, causal=causal)
                for x in qkv]
        plain = [lambda x=x: ref.mha_attention(*x, causal=causal)
                 for x in qkv]
        lib = [lambda x=x: sdpa(*x, is_causal=causal,
                                enable_gqa=shape[1] != shape[2])
               for x in qkv]
        for calls in (kern, plain, lib):                    # warm-up
            event_ms(calls[:2], flush, spin=True)
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 \
            else TF32X3_FLOP_PER_S
        works = [(*attn_bound(*x, causal=causal), rate) for x in qkv]
        row = timed(kern, plain, works, flush, plain_syncs=False)
        row["library_ms"] = event_ms(lib, flush, spin=True)
        fma = (f" (f32 FMA bound {bound_ms(*works[0][:2])[0]:.4f})"
               if dtype == torch.float32 else "")
        log("times", f"flash_attention B={shape[0]} H={shape[1]} "
            f"Hkv={shape[2]} S={shape[3]} D={shape[5]} Dv={shape[6]} "
            f"{'causal ' if causal else ''}{str(dtype)[6:]}: "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} (sdpa's backend "
            f"{sdpa_backend(*qkv[0], causal)}) "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}){fma} "
            f"share={row['bound_ms'] / row['ms']:.3f} "
            f"kernels_a_call={row['kernels']}")
        out[b] = row
        del qkv, kern, plain, lib
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# [segment]: the mutable corpus (core.segment), fig6's protocol
# ---------------------------------------------------------------------------

SEG_DOCS, SEG_LISTS = 2_000_000, 4_096   # three copies of the lists fit
SEG_CAP, SEG_ADD = 2_048, 512            # fig6's cap; two compactions
SEG_HNSW_CAP, SEG_HNSW_ADD = 256, 64
SEG_BATCH = 32
SEG_POOL_SEED = 61
SEG_PATHS = (("ivf", "toploc+ fused", dict(strategy="toploc+", fused=True)),
             ("ivf", "toploc+ fused int8", dict(strategy="toploc+",
                                                fused=True,
                                                precision="int8")),
             ("ivf", "plain fused", dict(strategy="plain", fused=True)),
             ("ivf", "toploc+ unfused", dict(strategy="toploc+",
                                             fused=False)),
             ("ivf_pq", "toploc+ fused", dict(strategy="toploc+",
                                              fused=True)),
             ("ivf_pq", "plain fused", dict(strategy="plain", fused=True)),
             ("ivf_pq", "toploc+ unfused", dict(strategy="toploc+",
                                                fused=False)))
# the HNSW oracle (hnsw.build over the [hnsw] graph's docs and the added
# ones, ~75 s of host numpy) runs in a child process beside the IVF legs
SEG_REBUILD_SRC = r"""
import sys
import time
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.core import backend, hnsw, segment
z = np.load(sys.argv[2])
t0 = time.perf_counter()
seg = segment.rebuild(backend.make("hnsw"), hnsw.load(sys.argv[3], "cpu"),
                      z["added"], z["deleted"], cap=int(z["cap"]),
                      ef_construction=int(z["efc"]), seed=int(z["seed"]))
print(time.perf_counter() - t0)
np.savez(sys.argv[4], *[t.numpy() for t in list(seg.base) + list(seg[1:])])
"""


def seg_leaves(tree):
    out = []
    for x in tree:
        out += seg_leaves(x) if isinstance(x, tuple) else [x]
    return out


def seg_equal(what, got, want):
    """Every tensor of two segmented indexes (or lists of tensors)
    torch.equal: dtype, shape and bits.  Returns how many."""
    import torch
    a, b = seg_leaves(got), seg_leaves(want)
    if len(a) != len(b) or any(
            (x is None) != (y is None) or (x is not None and (
                x.dtype != y.dtype or not torch.equal(x, y.to(x.device))))
            for x, y in zip(a, b)):
        raise AssertionError(f"[segment] {what}: the indexes differ")
    return sum(x is not None for x in a)


def seg_pool(n, d, seed, dev):
    """fig6's ingest pool: ``n`` seeded unit-norm docs on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


def seg_drive(eng, convs, pool, n_add, cap, build_kw, ingest, picks=None):
    """fig6's wave loop (``benchmarks/fig6_ingest.py`` ``drive``): each
    round every conversation submits its turn and the engine drains (a
    sequential engine answers them in order); with ``ingest`` each wave
    is followed by a ``compact()`` when the next add would overflow the
    segment, one ``add_documents`` of ``n_add`` pool docs, and one delete
    of the top doc the wave served conversation ``t % n`` (or of
    ``picks[t]``: another run's picks, replayed).  Returns the served
    scores and ids, the wave, add and compaction seconds, the added docs,
    the deleted ids, the picks, and how many served docs had been
    deleted before their turn was submitted."""
    import torch
    from repro_torch.serving import BatchedConversationalSearchEngine
    n_conv, turns = convs.shape[:2]
    vs = np.zeros((n_conv, turns, eng.cfg.k), np.float32)
    ids = np.zeros((n_conv, turns, eng.cfg.k), np.int64)
    out = dict(wave_s=[], add_s=[], compact_s=[], deleted=[], picks=[],
               stale=0)
    added, fill = [], 0
    batched = isinstance(eng, BatchedConversationalSearchEngine)
    for t in range(turns):
        gone = list(out["deleted"])
        t0 = time.perf_counter()
        if batched:
            futs = [eng.submit(f"c{c}", convs[c, t]) for c in range(n_conv)]
            eng.drain()
            rows = [f.result() for f in futs]
        else:
            rows = [eng.query(f"c{c}", convs[c, t]) for c in range(n_conv)]
        out["wave_s"].append(time.perf_counter() - t0)
        for c, (v, i) in enumerate(rows):
            vs[c, t], ids[c, t] = v, i
        out["stale"] += int(np.isin(ids[:, t], gone).sum())
        if not ingest:
            continue
        if fill + n_add > cap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.compact(**build_kw)
            torch.cuda.synchronize()
            out["compact_s"].append(time.perf_counter() - t0)
            fill = 0
        batch = pool[t * n_add:(t + 1) * n_add]
        t0 = time.perf_counter()
        eng.add_documents(batch)
        torch.cuda.synchronize()
        out["add_s"].append(time.perf_counter() - t0)
        added.append(batch)
        fill += n_add
        victim = int(ids[t % n_conv, t, 0]) if picks is None else picks[t]
        out["picks"].append(victim)
        if victim >= 0 and victim not in gone:
            eng.delete_documents([victim])
            out["deleted"].append(victim)
    out.update(v=vs, ids=ids, added=torch.cat(added) if added else None)
    return out


def seg_same(what, a, a_eng, b, b_eng):
    """Two runs served the same scores, ids and counters, bit for bit."""
    def recs(eng):
        return sorted((r.conv_id, r.turn) + tuple(getattr(r, f)
                                                   for f in BATCH_KEYS)
                      for r in eng.records)
    if not (np.array_equal(a["v"], b["v"])
            and np.array_equal(a["ids"], b["ids"])
            and recs(a_eng) == recs(b_eng)):
        raise AssertionError(f"[segment] {what}")


def seg_leg(card, backend, name, knobs, index, convs, pool, cap, n_add,
            build_kw, rebuild=True):
    """One path under fig6's protocol, the batched engine at max_batch
    32: a frozen engine and the segmented engine with ingest off (an
    empty delta reproduces the wrapped backend bit for bit), then ingest
    on with the launch counts set to 0 just before and read just after
    (each of the path's kernels launched, no deleted doc served), the
    last compaction, the compacted index == ``segment.rebuild`` over the
    pristine index and the whole history (unless ``rebuild`` is False:
    the caller holds it), and the script replayed through the sequential
    engine == the batched run and its index, bit for bit.  Returns
    (launches by kernel, the engine, the ingest run)."""
    import torch
    from repro_torch.core import segment
    from repro_torch.kernels import ops
    from repro_torch.serving import (BatchedConversationalSearchEngine,
                                     ConversationalSearchEngine,
                                     ServingConfig)
    cfg = ServingConfig(backend=backend, segment_cap=cap, **knobs)
    kw = {f"{backend}_index": index}

    def batched(c=cfg):
        return BatchedConversationalSearchEngine(
            c, n_slots=convs.shape[0], max_batch=SEG_BATCH, max_wait_s=0.0,
            max_inflight=2, **kw)

    def drive(eng, ingest, picks=None):
        return seg_drive(eng, convs, pool, n_add, cap, build_kw, ingest,
                         picks)

    # a batched engine and its batcher hold each other: free the last
    # leg's engines (and their compacted indexes) before this one's
    gc.collect()
    torch.cuda.empty_cache()
    serve_rounds(batched(), convs[:, :1])                          # warm
    frozen_eng = batched(dataclasses.replace(cfg, segment_cap=0))
    frozen = drive(frozen_eng, False)
    off_eng = batched()
    off = drive(off_eng, False)
    seg_same(f"{backend} {name}: an empty delta differs from the wrapped "
             f"backend", off, off_eng, frozen, frozen_eng)
    kernels = (HNSW_KERNELS if backend == "hnsw"
               else path_kernels(backend, cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng = batched()
    on = drive(eng, True)
    counts = {n: getattr(ops, n).launches for n in kernels}
    if 0 in counts.values():
        raise AssertionError(f"[segment] {backend} {name}: a kernel of the "
                             f"path was not launched: {counts}")
    if on["stale"] or off["stale"]:
        raise AssertionError(f"[segment] {backend} {name}: served "
                             f"{on['stale']} deleted docs")
    t0 = time.perf_counter()
    eng.compact(**build_kw)
    torch.cuda.synchronize()
    last_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_eq = 0
    if rebuild:
        n_eq = seg_equal(f"{backend} {name}: compact != rebuild", eng.index,
                         segment.rebuild(eng._seg_inner, index, on["added"],
                                         on["deleted"], cap=cap, **build_kw))
    seq = ConversationalSearchEngine(cfg, **kw)
    rep = drive(seq, True, on["picks"])
    seg_same(f"{backend} {name}: the sequential replay differs from the "
             f"batched run", rep, seq, on, eng)
    seq.compact(**build_kw)
    seg_equal(f"{backend} {name}: sequential != batched index", seq.index,
              eng.index)
    del seq, frozen_eng, off_eng
    gc.collect()
    torch.cuda.empty_cache()
    wave = {run: np.percentile(np.asarray(r["wave_s"]) * 1e3, [50, 99])
            for run, r in (("frozen", frozen), ("off", off), ("on", on))}
    n_added = on["added"].shape[0]
    log("segment", f"{backend} {name} ({card}): wave p50 / p99 ms frozen "
        f"index {wave['frozen'][0]:.3f} / {wave['frozen'][1]:.3f}, ingest "
        f"off {wave['off'][0]:.3f} / {wave['off'][1]:.3f}, on "
        f"{wave['on'][0]:.3f} / {wave['on'][1]:.3f}; ingest "
        f"{n_added / sum(on['add_s']):.1f} docs/s, add p50 "
        f"{np.percentile(np.asarray(on['add_s']) * 1e3, 50):.3f} ms ("
        f"{n_add} docs); compactions ms "
        f"{', '.join(f'{s * 1e3:.1f}' for s in on['compact_s'])}, last "
        f"{last_ms:.1f}; peak {peak:.1f} GB; {n_added} added, "
        f"{len(on['deleted'])} deleted, 0 deleted docs served; launches "
        + (" ".join(f"{n}={c}" for n, c in counts.items())
           or "none (plain PyTorch, where the reference runs XLA)")
        + (f"; compact == rebuild ({n_eq} tensors torch.equal)" if rebuild
           else "") + "; empty delta == the wrapped backend; sequential "
        "replay == batched (ids, scores, TurnStats, index)")
    return counts, eng, on


def seg_holed_lists(p, lmax, d, gen, dev):
    """Integer lists (values -4..4) with the holes a delete leaves: ~30 %
    of every list dead mid-list, list 0 every third row, list 1 its
    first 128-row slice dead and the next live, lists 2 and 192..255 all
    dead, list 191 two live rows mid-list, list 4 a live prefix and zero
    tail pads.  Dead rows keep their vectors; ids are unique."""
    import torch
    lv = torch.randint(-4, 5, (p, lmax, d), generator=gen, device=dev
                       ).float()
    ids = torch.arange(p * lmax, device=dev, dtype=torch.int32
                       ).view(p, lmax)
    live = torch.rand((p, lmax), generator=gen, device=dev) > 0.3
    r = torch.arange(lmax, device=dev)
    live[0] = r % 3 != 1
    live[1] = r >= 128
    live[2] = False
    live[192:] = False
    live[191] = (r == 150) | (r == 151)
    live[4] = r < 40
    lv[4, 40:] = 0
    return lv, torch.where(live, ids, -1)


def phase_segment_holes(args, dev, card):
    """Rows 3-7 at f32 / bf16 / int8 and hnsw_search on edited indexes,
    integer inputs (exact dots): bit-equal to their plain versions.
    256 lists of the [segment] IVF's Lmax (``seg_holed_lists``), nprobe
    64, k 10, B = 1 and 32: half the queries steered onto lists 191..255
    (stage 1 probes 191..254: two live rows, fewer than k), the rest onto
    holed lists; a ``sel`` whose first row probes lists 0..63.  HNSW: a
    seeded graph of 20,000 integer vectors (d 768, deg 32, 3 upper
    levels), the entry point and 10 % or 99.5 % of the nodes tombstoned,
    descent and entry overrides."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    p, lmax, d, nprobe, k, m, rerank = 256, 635, args.d, 64, args.k, 48, 64
    lv, li = seg_holed_lists(p, lmax, d, gen, dev)
    cents = torch.randint(-4, 1, (p, d), generator=gen, device=dev).float()
    cents[191:] = 4
    q = torch.randint(0, 3, (32, d), generator=gen, device=dev).float()
    q[16:] = -q[16:]
    sel = torch.stack([torch.randperm(p, generator=gen, device=dev)[:nprobe]
                       for _ in range(32)]).to(torch.int32)
    sel[0] = torch.arange(nprobe, device=dev, dtype=torch.int32)
    tables = torch.randint(-4, 5, (32, m, 256), generator=gen, device=dev
                           ).float()
    codes = torch.randint(0, 256, (p, lmax, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    corpus = lv.view(p * lmax, d)
    calls = 0

    def same(what, got, want):
        nonlocal calls
        calls += 1
        if any(g.dtype != w.dtype or not torch.equal(g, w)
               for g, w in zip(got, want)):
            raise AssertionError(f"[segment] holed {what}: the kernel "
                                 f"differs from its plain version")

    r_pq = ops._fused_depth(k, nprobe * lmax, rerank)
    for b in (1, 32):
        qb, sb, tb = q[:b], sel[:b], tables[:b]
        for prec in ("f32", "bf16", "int8"):
            r = None if prec == "f32" else ops._fused_depth(
                k, nprobe * lmax, 2 * k)
            want = ref.fused_turn_ivf(qb, cents, lv, li, nprobe=nprobe, k=k,
                                      precision=prec, r=r)
            same(f"fused_turn[{prec}] B={b}", ops.fused_turn(
                qb, cents, lv, li, nprobe=nprobe, k=k, precision=prec), want)
            if int((want[1][0] >= 0).sum()) != 2:
                raise AssertionError("[segment] holed: the first query does "
                                     "not see two live rows")
            same(f"fused_scan[{prec}] B={b}", ops.fused_scan(
                qb, lv, li, sb, k, precision=prec), ref.fused_scan_ivf(
                qb, lv, li, sb, None, k=k, precision=prec, r=r))
            same(f"fused_turn_pq[{prec}] B={b}", ops.fused_turn_pq(
                qb, cents, tb, codes, li, corpus, nprobe=nprobe, k=k,
                rerank=rerank, precision=prec), ref.fused_turn_pq(
                qb, cents, tb, codes, li, corpus, nprobe=nprobe, k=k,
                r=r_pq, precision=prec))
            for fuse in (True, False):
                same(f"fused_scan_pq[{prec}] rerank={fuse} B={b}",
                     ops.fused_scan_pq(tb, qb, codes, li, sb, corpus, k,
                                       rerank=rerank, fuse_rerank=fuse,
                                       precision=prec),
                     ref.fused_scan_pq(tb, qb, codes, li, sb, None, corpus,
                                       k=k, r=r_pq, rerank=fuse,
                                       precision=prec))
        same(f"pq_adc_scan B={b}", ops.pq_adc_scan(tb, codes, li, sb, r_pq),
             ref.pq_adc_scan_batch(tb, codes, li, sb, r_pq))
    del lv, li, codes, corpus

    n, deg = HNSW_DOCS, 32
    vecs = torch.randint(-3, 4, (n, d), generator=gen, device=dev).float()

    def links(shape):
        ids = torch.randint(0, n, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        return torch.where(torch.rand(shape, generator=gen, device=dev)
                           < 0.1, -1, ids)

    adj0, upper = links((n, deg)), links((3, n, deg // 2))
    entry = torch.randint(0, n, (), generator=gen, device=dev,
                          dtype=torch.int32)
    override = torch.randint(0, n, (32,), generator=gen, device=dev,
                             dtype=torch.int32)
    hq = torch.randint(-3, 4, (32, d), generator=gen, device=dev).float()
    for share in (0.1, 0.995):
        dead = torch.rand(n, generator=gen, device=dev) < share
        dead[entry.long()] = True
        for b in (1, 32):
            for e in (None, override[:b]):
                same(f"hnsw_search dead={share} B={b}", ops.hnsw_search(
                    vecs, adj0, upper, entry, hq[:b], e, ef=64, k=k,
                    deleted=dead), ref.hnsw_search(
                    vecs, adj0, upper, entry, hq[:b], e, ef=64, k=k,
                    deleted=dead))
    log("segment", f"holed indexes: {calls} calls of rows 3-7 (f32 / bf16 "
        f"/ int8) and hnsw_search bit-equal to their plain versions: p {p},"
        f" Lmax {lmax}, d {d}, nprobe {nprobe}, k {k}, B = 1 and 32; holes "
        f"mid-list, a dead 128-row slice before a live one, dead probed "
        f"lists, a query with 2 live rows among its 64 lists; HNSW {n} "
        f"nodes, the entry point and 10 % / 99.5 % tombstoned ({card})")


def phase_segment(args, docs, bconvs, graph, dev):
    """[segment]: fig6's protocol (``benchmarks/fig6_ingest.py``) on the
    port's mutable corpus, fig3's 32 x 10 (``bconvs``) through the
    batched engine at max_batch 32 (``seg_leg``).  HNSW toploc first, on
    the [hnsw] graph (``graph``), cap 256, 64 docs a wave, ef 64; its
    from-scratch rebuild then runs in a child process while IVF (p 4,096)
    and IVF-PQ (m 48) over the corpus's first ``SEG_DOCS`` docs serve
    each path of ``SEG_PATHS``: cap 2,048, 512 seeded unit-norm docs a
    wave (two compactions in 10 waves).  Then the holed-index kernel
    checks (``phase_segment_holes``), and the HNSW rebuild is held to
    the engine's index.  Returns launches by kernel name (the int8 ones
    as ``op[int8]``)."""
    import tempfile
    import torch
    from repro_torch.core import hnsw, ivf, pq, segment
    from repro_torch.kernels import _build
    card = card_line()
    launches = {}

    def count(counts, prec="f32"):
        for n, c in counts.items():
            key = n if prec == "f32" else f"{n}[{prec}]"
            launches[key] = launches.get(key, 0) + c

    n_graph = graph.n
    build_kw = dict(ef_construction=HNSW_EFC, seed=args.seed)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    child = None
    try:
        pool = seg_pool(SEG_HNSW_ADD * bconvs.shape[1], args.d,
                        args.seed + SEG_POOL_SEED + 1, dev)
        counts, eng, on = seg_leg(card, "hnsw", "toploc",
                                  dict(strategy="toploc"), graph, bconvs,
                                  pool, SEG_HNSW_CAP, SEG_HNSW_ADD,
                                  build_kw, rebuild=False)
        count(counts)
        hnsw.save(graph, os.path.join(tmp, "pristine.npz"))
        np.savez(os.path.join(tmp, "history.npz"),
                 added=on["added"].cpu().numpy(),
                 deleted=np.asarray(on["deleted"], np.int64),
                 cap=SEG_HNSW_CAP, efc=HNSW_EFC, seed=args.seed)
        child = subprocess.Popen(
            [sys.executable, "-c", SEG_REBUILD_SRC, os.path.join(ROOT, "src"),
             os.path.join(tmp, "history.npz"),
             os.path.join(tmp, "pristine.npz"),
             os.path.join(tmp, "rebuilt.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        served = [t.cpu() for t in seg_leaves(eng.index)]
        del eng, on, pool

        t0 = time.perf_counter()
        sub = docs[:SEG_DOCS]
        index = ivf.build(sub, SEG_LISTS, iters=args.iters, seed=args.seed,
                          capacity_factor=1.3)
        torch.cuda.synchronize()
        t_ivf = time.perf_counter() - t0
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        pqi = pq.build_ivf_pq(index, sub, pq.train(sub, PQ_M, iters=PQ_ITERS,
                                                   generator=gen))
        torch.cuda.synchronize()
        t_pq = time.perf_counter() - t0
        pool = seg_pool(SEG_ADD * bconvs.shape[1], args.d,
                        args.seed + SEG_POOL_SEED, dev)
        # a delta doc's list and code do not depend on the docs beside
        # it: each of 64 rows alone == in the batch
        rows = pool[:64]
        whole = (segment.nearest_centroids(index.centroids, rows),
                 segment.encode_rows(pqi.book, rows))
        for j in range(rows.shape[0]):
            alone = (segment.nearest_centroids(index.centroids,
                                               rows[j:j + 1]),
                     segment.encode_rows(pqi.book, rows[j:j + 1]))
            if not all(torch.equal(w[j:j + 1], a)
                       for w, a in zip(whole, alone)):
                raise AssertionError("[segment] a doc's list or code "
                                     "depends on the docs beside it")
        log("segment", f"prefix of {SEG_DOCS} docs: IVF p={SEG_LISTS} "
            f"build_s={t_ivf:.1f} lmax={index.lmax} list_vecs "
            f"{index.list_vecs.numel() * 4 / 1e9:.2f} GB a copy; IVF-PQ "
            f"m={PQ_M} build_s={t_pq:.1f}; 64 delta docs' lists and codes "
            f"alone == in one batch ({card})")
        for backend, name, knobs in SEG_PATHS:
            counts, _, _ = seg_leg(card, backend, name, knobs,
                                   index if backend == "ivf" else pqi,
                                   bconvs, pool, SEG_CAP, SEG_ADD, {})
            count(counts, knobs.get("precision", "f32"))
        del index, pqi, sub, pool
        gc.collect()
        torch.cuda.empty_cache()
        phase_segment_holes(args, dev, card)

        took, err = child.communicate(timeout=900)
        if child.returncode:
            raise RuntimeError(f"[segment] the hnsw rebuild failed: {err}")
        z = np.load(os.path.join(tmp, "rebuilt.npz"))
        want = [torch.from_numpy(z[f"arr_{i}"]) for i in range(len(z.files))]
        n_eq = seg_equal("hnsw toploc: compact != rebuild", served, want)
        log("segment", f"hnsw toploc: compact == rebuild ({n_eq} tensors "
            f"torch.equal; the rebuild, hnsw.build over {want[0].shape[0]} "
            f"docs ({n_graph} + the added), took {float(took):.1f}s in a "
            f"child process beside the IVF legs)")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=8_841_823)
    ap.add_argument("--lists", type=int, default=16_384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--enc-docs", type=int, default=ENC_DOCS)
    ap.add_argument("--tt-items", type=int, default=1_000_000,
                    help="two-tower retrieval_cand corpus size")
    ap.add_argument("--tt-users", type=int, default=100,
                    help="two-tower user sessions per serving path")
    ap.add_argument("--stages-only", action="store_true",
                    help="build, then only the [stages] kernel split")
    ap.add_argument("--bag-times", action="store_true",
                    help="build, then only the [bag] sweep of embedding_bag's "
                    "kernels over B (phase_bag_sweep)")
    ap.add_argument("--adc-times", action="store_true",
                    help="build, then only time the rows that run the ADC "
                    "scan (phase_adc_times)")
    ap.add_argument("--hnsw-docs", type=int, default=HNSW_DOCS,
                    help="nodes of the [hnsw] graph (a prefix of the "
                    "corpus)")
    ap.add_argument("--segment-only", action="store_true",
                    help="build, then only the corpus, the [hnsw] graph "
                    "and [segment] (phase_segment)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build, then only the corpus, the indexes, the "
                    "[hnsw] graph, [sharded] and [router]")
    ap.add_argument("--hnsw-only", action="store_true",
                    help="build, then only the corpus, [hnsw] and the "
                    "[exact] serve (no IVF index)")
    ap.add_argument("--dump-rows", metavar="PATH",
                    help="build, then only save rows 1-8's and "
                    "hnsw_search's outputs on seeded inputs to PATH "
                    "(phase_dump_rows)")
    ap.add_argument("--same-dumps", nargs=2, metavar=("A", "B"),
                    help="only hold two --dump-rows files to each other "
                    "bit for bit (same_dumps)")
    ap.add_argument("--hnsw-times", action="store_true",
                    help="build, then only the round trip and "
                    "hnsw_search's times on the [hnsw] graph "
                    "(phase_hnsw_times)")
    ap.add_argument("--hnsw-graph", metavar="PATH",
                    help="load the [hnsw] graph of --hnsw-times from PATH, "
                    "or build it and save it there (hnsw_graph)")
    args = ap.parse_args()
    args.d, args.k, args.nprobe = 768, 10, 64
    args.lmax = math.ceil(1.3 * args.n_docs / args.lists)
    # 16 sqrt(N) lists, FAISS's upper end: 4,096 at 65,536 docs
    args.enc_lists = 16 * math.isqrt(args.enc_docs)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.same_dumps:
        n_out, n_t = same_dumps(*args.same_dumps)
        log("dump", f"{n_out} outputs ({n_t} tensors) torch.equal in "
            f"{args.same_dumps[0]} and {args.same_dumps[1]}")
        return 0
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels import _build, tiling
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    card = card_line()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on")
    log("card", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | tf32 off")

    _build.lib()
    log("build", f"nvcc {_build.last_build['seconds']:.1f}s, one per source "
        f"in parallel, from {_build.CSRC.relative_to(ROOT)}")
    for src, lines in _build.last_build["ptxas"].items():
        log("build", f"{src}: " + " | ".join(lines))
    hmma, adc = sass_checks(_build.build())
    log("build", "cuobjdump -sass, HMMA instructions per instance: " + "; ".join(
        f"{name} {counts}" for name, counts in hmma.items()))
    log("build", "cuobjdump -sass, adc_scan_kernel per instance (three "
        "precisions, bulk copy or staged): bulk copies (UBLKCP), mbarrier "
        "(SYNCS): " + "; ".join(f"{'bulk' if bulk else 'staged'} {c}"
                                for bulk, c in adc))

    if (args.stages_only or args.dump_rows or args.bag_times or args.adc_times
            or args.hnsw_only or args.hnsw_times or args.segment_only
            or args.sharded_only):
        if args.sharded_only:
            from repro_torch.core import hnsw
            index, docs, convs, _, _ = phase_index(args, dev)
            pqi = phase_pq(args, index, docs, dev)
            t0 = time.perf_counter()
            graph = hnsw.build(docs[:min(args.hnsw_docs, docs.shape[0])],
                               m=HNSW_M, ef_construction=HNSW_EFC,
                               seed=args.seed)
            log("hnsw", f"build N={graph.n}: "
                f"{time.perf_counter() - t0:.1f}s on the host")
            errs = {}
            launches, err, _ = phase_sharded(
                args, {"ivf": index, "ivf_pq": pqi}, docs, convs, graph, dev,
                errs)
            launches.update(phase_router(index, convs, dev))
            log("sharded", f"launches {launches}; hnsw_search_sharded "
                f"max_abs_err={err:.3g}; per-shard max_abs_err {errs}")
            del index, pqi, docs, graph
            torch.cuda.empty_cache()
        if args.hnsw_times:
            phase_hnsw_times(args, dev)
        if args.segment_only:
            from repro_torch.core import hnsw
            docs, _, bconvs, _, _ = smoke_corpus(args, dev)
            t0 = time.perf_counter()
            graph = hnsw.build(docs[:min(args.hnsw_docs, docs.shape[0])],
                               m=HNSW_M, ef_construction=HNSW_EFC,
                               seed=args.seed)
            log("hnsw", f"build N={graph.n}: "
                f"{time.perf_counter() - t0:.1f}s on the host")
            phase_segment(args, docs, bconvs, graph, dev)
            del docs, graph
            torch.cuda.empty_cache()
        if args.hnsw_only:
            docs, convs, bconvs, exact, _ = smoke_corpus(args, dev)
            phase_hnsw(args, docs, convs, bconvs, dev)
            phase_exact_serve(docs, convs, exact)
            del docs
            torch.cuda.empty_cache()
        if args.bag_times:
            phase_bag_sweep(args, dev)
        if args.adc_times:
            phase_adc_times(args, dev)
        if args.stages_only:
            phase_stages(args, dev)
        if args.dump_rows:
            phase_dump_rows(args, dev, args.dump_rows)
        print(card)
        return 0
    passes = phase_exact_classic(dev)
    log("exact", f"centroid_topk {len(CK_EXACT)} shapes and ivf_scan "
        f"{len(IV_EXACT)} shapes, float32 and bfloat16 (v, ids): bit-equal "
        f"to their plain versions (p = 600 with every score negative, k up "
        f"to 2,048, B up to 64, nprobe up to 256, merges of up to {passes} "
        f"passes)")
    n_ivf, n_pq, passes = phase_exact(dev)
    log("exact", f"{n_ivf} shapes: fused_turn (v, ids, sel) and fused_scan "
        f"(v, ids, pos); {n_pq} PQ shapes: fused_turn_pq (v, ids, sel), "
        f"pq_adc_scan (v, ids), fused_scan_pq with and without re-rank "
        f"(v, ids, pos): bit-equal to their plain versions (k and the "
        f"re-rank depth up to 1,000, nprobe up to 256, merges of up to "
        f"{passes} passes)")
    n_ivf, n_pq = phase_exact_quant(dev)
    log("exact", f"bf16 and int8: {n_ivf} shapes fused_turn (v, ids, sel) "
        f"and fused_scan (v, ids, rank), {n_pq} PQ shapes fused_turn_pq and "
        f"fused_scan_pq with and without re-rank: bit-equal to their plain "
        f"versions (k = 1,000: r = 2,000, r_pad 2,048; two int8 groups a "
        f"list at d = 1,024, Lmax 1,100; r_pad 2,048 above the byte-capped "
        f"group), on integer inputs and on bf16-split ones; core.topk on "
        f"the card ranks +0.0 above -0.0")
    n_probes, n_plan = phase_plans(dev)
    log("plans", f"{n_probes} probes (the kernels analysis pass's, the "
        f"LM's bf16 flash_decode / flash_attention calls and the stage "
        f"kernels at the smoke's shapes) on CUDA tensors: "
        f"{n_plan} traced kernels == the recorded launch plans (name, order, "
        f"grid, block, static + dynamic shared memory); the bf16 calls run "
        f"no cast or copy kernel")
    errs = dict.fromkeys(IVF_KERNELS + PQ_KERNELS + REC_KERNELS
                         + QUANT_KERNELS + CLASSIC_KERNELS, 0.0)
    phase_exact_bag(dev, errs)
    log("exact", f"embedding_bag V={BAG_V} d={BAG_D} L={BAG_L} B="
        f"{','.join(map(str, BAG_BATCHES))}, pads, all-pad bags, ids at "
        f"V-1, sum and mean, weighted and not: bit-equal to its plain "
        f"version on integer inputs; on floats max_abs_err="
        f"{errs['embedding_bag']:.3g} (tol {BAG_TOL})")

    ties = phase_realistic(args, dev, errs)
    log("realistic", f"p={args.lists} lmax={args.lmax} d={args.d} "
        f"m={PQ_M} B=1,25: ADC candidates (pq_adc_scan, fused_scan_pq "
        f"top-r) bit-equal; max_abs_err " + " ".join(
            f"{n}={errs[n]:.3g}" for n in IVF_KERNELS + PQ_KERNELS) +
        f" (tol {TOL}); near-tie id mismatches " + " ".join(
            f"{n}={v}" for n, v in ties.items()
            if "[" not in n and n != "rank"))
    log("realistic", "bf16 / int8 at the same shapes (candidates and ADC "
        "top-r as the plain version's, fused_scan's candidate ranks and the "
        "f32 re-rank under the tie rule): max_abs_err " + " ".join(
            f"{n}={errs[n]:.3g}" for n in QUANT_KERNELS) +
        f" (tol {TOL}); near-tie id mismatches " + " ".join(
            f"{n}={ties[n]}" for n in QUANT_KERNELS) +
        f"; near-tie candidate rank mismatches {ties['rank']}")
    cand_ties = dict.fromkeys(("fused_turn", "fused_scan", "sel"), 0)
    cand_errs = dict.fromkeys(IVF_KERNELS, 0.0)
    p, lmax, d, nprobe, k = phase_realistic_cand(args, dev, cand_errs,
                                                 cand_ties)
    for n in IVF_KERNELS:
        errs[n] = max(errs[n], cand_errs[n])
    plan = tiling.merge_plan(nprobe * tiling.scan_split(lmax),
                             tiling.next_pow2(k))
    log("realistic", f"two-tower retrieval_cand shape p={p} lmax={lmax} "
        f"d={d} nprobe={nprobe} k={k} B=1,25 (merge passes, lists in and "
        f"groups out: {plan}): max_abs_err " + " ".join(
            f"{n}={e:.3g}" for n, e in cand_errs.items()) +
        f" (tol {TOL}); near-tie id mismatches " + " ".join(
            f"{n}={v}" for n, v in cand_ties.items()))
    phase_stages(args, dev)

    errs["flash_attention"] = 0.0
    attn_ulps = phase_attn(args, dev, errs)
    log("attn", f"{len(ATTN_SHAPES)} shapes (MHA, GQA, causal S == Skv and "
        f"S < Skv, non-causal, ragged S/Skv, Dv != D, dragon B = 1 and "
        f"{DOC_BATCH}, snowflake, yi-9b's RAG prefill H=32 Hkv=4 S=784 "
        f"D=128 causal bf16, deepseek's MLA prefill H=16 S=784 D=192 "
        f"Dv=128 causal bf16, heads 256 wide bf16): flash_attention "
        f"max_abs_err="
        f"{errs['flash_attention']:.3g} (tol {TOL}); bf16 outputs max |d| "
        f"{attn_ulps:.3g} bf16 ulp of the row's largest |out| (tol 1)")
    errs["flash_decode"] = 0.0
    calls, row_ulps, elem_ulps = phase_decode(args, dev, errs)
    log("decode", f"{len(DECODE_SHAPES)} shapes (GQA groups 1, 5, 8; S = "
        f"1,000, 1,024, 32,768; B = 1, 8; cache_len 1, S, S + 1 and "
        f"between), float32 and bfloat16 caches, {calls} calls: "
        f"flash_decode's f32 result max_abs_err={errs['flash_decode']:.3g} "
        f"(tol {TOL}) on both caches; bf16 outputs max |d| "
        f"{row_ulps:.3g} bf16 ulp of the row's largest |out| (tol 1), "
        f"{elem_ulps:.3g} ulp of |out| itself (not a gate: near-zero "
        f"outputs are cancellations)")

    from repro_torch.configs.encoders import dragon_config
    enc, embs, wl, docs_tok, conv_tok, enc_launches = phase_encode(
        args, dev, dragon_config(), errs)
    enc_index, enc_counts = phase_encode_serve(args, dev, enc, embs, wl,
                                               conv_tok)
    rag_counts = phase_rag(args, dev, enc, enc_index, docs_tok, conv_tok)
    ds_counts = phase_rag_deepseek(args, dev, enc, enc_index, docs_tok,
                                   conv_tok)
    enc_launches += enc_counts["flash_attention"]
    del enc, embs, enc_index
    torch.cuda.empty_cache()

    from repro_torch.configs import two_tower_retrieval as TT
    model, corpus, tindex = phase_twotower(args, dev, TT.full_config())
    rec_counts, rec_vecs = phase_recsys_serve(args, dev, model, corpus,
                                              tindex)
    rec_counts["embedding_bag"] += phase_pairwise(args, dev, model)
    bag_times = phase_bag_times(args, dev, model)
    phase_cand_times(args, dev, tindex, rec_vecs)
    phase_twotower_dist(args, dev, model, corpus, tindex)
    del model, corpus, tindex, rec_vecs
    torch.cuda.empty_cache()

    index, docs, convs, exact, bconvs = phase_index(args, dev)
    pqi = phase_pq(args, index, docs, dev)
    indexes = {"ivf": index, "ivf_pq": pqi}
    runs, launches = phase_serve(indexes, docs, convs, exact, dev)
    launches.update(phase_serve_quant(indexes, convs, exact, runs))
    phase_fig8(dev)
    hnsw_launches, errs["hnsw_search"], hnsw_times, graph = phase_hnsw(
        args, docs, convs, bconvs, dev)
    launches["hnsw_search"] = hnsw_launches
    phase_exact_serve(docs, convs, exact)
    sh_launches, errs["hnsw_search_sharded"], sh_times = phase_sharded(
        args, indexes, docs, convs, graph, dev, errs,
        {b: row["steps"] for b, row in hnsw_times.items()})
    for name, n in list(sh_launches.items()) + list(
            phase_router(index, convs, dev).items()):
        launches[name] = launches.get(name, 0) + n

    for backend, _ in BACKENDS:
        for name in ("toploc+ fused", "toploc+ unfused"):
            phase_batched(indexes[backend], convs, runs[backend][name], dev)
    log("batched", "start_batch/step_batch over 25 conversations == the "
        "sequential engine (ids, scores, TurnStats, sessions), fused and "
        "unfused toploc+, ivf and ivf_pq")
    bs_launches, _ = phase_batched_serve(indexes, docs, bconvs)
    for name, n in bs_launches.items():
        launches[name] = launches.get(name, 0) + n
    launches.update(phase_classic(args, index, docs, convs, dev, errs))
    classic_times = phase_classic_times(args, index, convs, dev)

    times = phase_times(args, index, pqi, convs, dev)
    times[1]["flash_attention"] = phase_attn_times(args, dev)[1]
    times[1]["embedding_bag"] = bag_times[1]
    times[1].update(classic_times[1])
    times[1]["hnsw_search"] = hnsw_times[1]
    times[1]["hnsw_search_sharded"] = sh_times[SHARD_COUNTS[-1]][1]
    del index, pqi, indexes, runs
    torch.cuda.empty_cache()
    for name, n in phase_segment(args, docs, bconvs, graph, dev).items():
        launches[name] = launches.get(name, 0) + n
    # the LM at decode_32k runs once the retrieval objects are freed
    del docs, graph
    torch.cuda.empty_cache()
    d32_counts = phase_decode32k(args, dev)
    times[1]["flash_decode"] = phase_decode_times(args, dev)[1]
    launches["flash_attention"] = (enc_launches + rag_counts["flash_attention"]
                                   + ds_counts["flash_attention"])
    launches["flash_decode"] = (rag_counts["flash_decode"]
                                + d32_counts["flash_decode"])
    for name in IVF_KERNELS + REC_KERNELS:
        launches[name] = launches.get(name, 0) + rec_counts[name]
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], ms=times[1][name]["ms"],
                    plain_ms=times[1][name]["plain_ms"],
                    bound_ms=times[1][name]["bound_ms"],
                    bound_by=times[1][name]["bound_by"],
                    library_ms=times[1][name].get("library_ms"),
                    **({"chain_ms": times[1][name]["chain_ms"]}
                       if "chain_ms" in times[1][name] else {}))
               for name in IVF_KERNELS + PQ_KERNELS + QUANT_KERNELS +
               ENC_KERNELS + REC_KERNELS + LM_KERNELS + CLASSIC_KERNELS
               + HNSW_KERNELS + HNSW_SHARD_KERNELS]
    log("done", f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
