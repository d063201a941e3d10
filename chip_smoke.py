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
and the ``decode_32k`` serve shape of that model, cut from B = 128 to B
= 8 (at B = 128 the K/V cache would be 412 GB).

Phases (one line each, [serve] one per path; any failure raises and
exits non-zero):
  1 card      nvidia-smi name and power limit, versions, TF32 off
  2 build     nvcc of every kernels/csrc source (seconds; registers and
              spills per kernel)
  3 exact     integer inputs: kernels == plain versions bit for bit
              (retrieval top-k and re-rank depth up to 1,000, nprobe up
              to 256, merges past one block; the bf16 and int8 fused
              ops too, r = 2,000 and several int8 groups a list; +0.0
              above -0.0 in core.topk; embedding_bag at B = 1, 512,
              262,144)
  4 realistic unit-norm floats at the smoke's shapes, B = 1 and 25, f32,
              bf16 and int8, and at the two-tower retrieval_cand shape
  5 attn      flash_attention == its plain version within 1e-5, Yi-9B's
              RAG prefill shape (S = 784, D = 128, GQA 8, causal) on
              bf16 inputs too, its bf16 output within one bf16 ulp
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
              token, 24,576 flash_decode launches, finite logits
  9 twotower  the full-width model, the item corpus, its IVF; then
              [recsys serve] (100 users x 10 requests per path, user
              tower at B = 1 then engine.query), [pairwise] (serve_p99
              and serve_bulk) and the embedding_bag [times]
 10 index     the port's ivf.build at full size + exact top-10
 11 pq        the port's build_ivf_pq at full size (m = 48, 8 iters)
 12 serve     per backend: toploc+ / toploc / plain fused, toploc+
              unfused; each backend's launch counts start at 0; then
              the quantised turn, ServingConfig(fused=True, precision=
              "bf16" / "int8") x toploc+ / toploc / plain, counts from 0
              again, recall@10 and counters against the f32 fused path
    fig8      the reference's recall gate: quantised vs f32 fused turn
              >= 0.95 at fig8's 20,000 docs, d = 64, p = 2,048
 13 batched   start_batch / step_batch == the sequential engine
 14 times     CUDA-event kernel times (L2 flushed) beside their bounds,
              rows 4-7 at f32, bf16 and int8
 15 decode32k once the retrieval objects are freed: Yi-9B at decode_32k
              (S = 32,768) cut from B = 128 to B = 8 (412 GB of cache
              at B = 128; 25.8 GB at B = 8), ragged cache_len; step ms
              and tokens/s against the step's bytes over 3.35 TB/s;
              then flash_decode's [times] at B = 1, S = 1,024 and B = 8,
              S = 32,768 beside its plain version and SDPA
then a JSON line of kernels, the card line, and the result line.

Run from the repository root: ``python3 chip_smoke.py``.  Size flags
(``--n-docs``, ``--lists``, ``--iters``, ``--enc-docs``, ``--tt-items``,
``--tt-users``) cut the run for a quick check.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
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
SOURCES = {**dict.fromkeys(IVF_KERNELS, SCAN_SRC),
           **dict.fromkeys(PQ_KERNELS, PQ_SRC),
           **{f"{op}[{prec}]": SCAN_SRC if op in IVF_KERNELS else PQ_SRC
              for op in QUANT_OPS for prec in QUANT},
           "flash_attention": FA_SRC, "embedding_bag": EB_SRC,
           "flash_decode": FD_SRC}
REPLACES = {"fused_scan": "src/repro/kernels/fused_turn.py:644",
            "fused_turn": "src/repro/kernels/fused_turn.py:406",
            "pq_adc_scan": "src/repro/kernels/pq_adc.py:79",
            "fused_scan_pq": "src/repro/kernels/fused_turn.py:686",
            "fused_turn_pq": "src/repro/kernels/fused_turn.py:445",
            "flash_attention": "src/repro/kernels/flash_attention.py:89",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:49",
            "flash_decode": "src/repro/kernels/flash_attention.py:180"}
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
               (1, 32, 4, 784, 784, 128, 128, True)]   # yi-9b RAG prefill
# shapes whose inputs are bf16, as the LM's prefill gives them: the op
# casts them to float32 for the kernel and its output back to bf16
ATTN_BF16 = {(1, 32, 4, 784, 784, 128, 128, True)}


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
    """Run every attention layer of ``model`` through ``fn`` (None: the
    kernel); ``which`` is "attention" (``flash_attention``) or
    "decode_attention" (``flash_decode``)."""
    from repro_torch.models.layers import Attention
    for m in model.modules():
        if isinstance(m, Attention):
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


def profile_query_tower(enc, q, reps=5):
    """The query tower at B = 1: device busy time, cuBLAS GEMMs,
    ``flash_attention`` and the rest (``profile_device``)."""
    return profile_device(lambda: enc.encode_queries(q, q > 0), reps,
                          (("flash_attention", ("flash_fwd",)),
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
                          (("flash_decode", ("decode_split",
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
            f"share={row['bound_ms'] / row['ms']:.3f}")
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
            f"share={row['bound_ms'] / row['ms']:.3f}")


# ---------------------------------------------------------------------------
# phases 10-13: index, PQ index, serving, sequential == batched
# ---------------------------------------------------------------------------


def phase_index(args, dev):
    import torch
    from repro_torch.core import ivf
    from repro_torch.data import synthetic as SY
    cfg = SY.WorkloadConfig(n_docs=args.n_docs, d=args.d, n_topics=256,
                            doc_spread=0.35, n_conversations=25,
                            turns_per_conversation=10, query_drift=0.15,
                            walk_step=0.05, shift_prob=0.15, seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus = SY.make_device_corpus(cfg, dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = ivf.build(corpus.doc_vecs, args.lists, iters=args.iters,
                      seed=args.seed, capacity_factor=1.3)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    convs = corpus.conversations
    flat = torch.from_numpy(convs.reshape(-1, args.d)).to(dev)
    _, exact = ivf.exact_search(corpus.doc_vecs, flat, args.k)
    exact = exact.cpu().numpy().reshape(convs.shape[0], convs.shape[1], -1)
    # the corpus stays: it is the IVF-PQ index's re-rank source
    docs = corpus.doc_vecs
    del corpus, flat
    torch.cuda.empty_cache()
    log("index", f"n_docs={args.n_docs} d={args.d} p={args.lists} "
        f"iters={args.iters} corpus_s={t_gen:.1f} build_s={t_build:.1f} "
        f"lmax={index.lmax} n_indexed={index.n_docs} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}")
    if index.n_docs != args.n_docs:
        raise AssertionError("the index lost documents")
    return index, docs, convs, exact


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


def timed(kernel_calls, plain_calls, works, flush, plain_syncs=True):
    """One kernel's row: kernel and plain-version times, mean bound.
    A plain version that never waits for the host (``plain_syncs``
    False) is timed behind the spin too, so its time is the device's."""
    return dict(ms=event_ms(kernel_calls, flush, spin=True),
                plain_ms=event_ms(plain_calls, flush, spin=not plain_syncs),
                bound_ms=float(np.mean([bound_ms(*w)[0] for w in works])),
                bound_by=bound_ms(*works[0])[1])


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
            extra = (f" design_bound_ms={design[name]:.4f} (scale pass and "
                     f"re-rank rows)" if name in design else "")
            log("times", f"{name} B={b}: ms={rr['ms']:.4f} "
                f"plain_ms={rr['plain_ms']:.4f} "
                f"bound_ms={rr['bound_ms']:.4f} ({rr['bound_by']}) "
                f"share={rr['bound_ms'] / rr['ms']:.3f}{extra}")
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
    own: int8 reads the probed lists' rows (pads too, every row below
    Lmax: they enter the group scales) a second time, and the turns the
    centroids; the IVF re-rank reads r candidate rows again."""
    b, nprobe = sel.shape
    extra = 0
    if prec == "int8":
        if op in ("fused_scan", "fused_turn"):
            extra += b * nprobe * index.lmax * index.d * 4
        if op in ("fused_turn", "fused_turn_pq"):
            extra += index.p * index.d * 4
    if op in ("fused_scan", "fused_turn"):
        extra += b * r_q * index.d * 4
    return extra


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
            f"{nbytes / 1e6:.1f} MB) share={row['bound_ms'] / row['ms']:.3f}")
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
        (("flash_decode", ("decode_split", "decode_combine")),
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


def attn_bound(q, k, v):
    """(bytes, flops) of attention over these inputs: q, k, v read once,
    the output written once; QK^T and PV products."""
    b, h, s, d = q.shape
    skv, dv = k.shape[2], v.shape[3]
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + b * h * s * dv)
    return nbytes, 2 * b * h * s * skv * (d + dv)


def phase_attn_times(args, dev):
    """flash_attention at dragon's query (B = 1) and doc-batch (B =
    DOC_BATCH) shapes, beside its plain version (no host sync: device
    time, as the kernel's) and, timed only, PyTorch's
    ``scaled_dot_product_attention`` on the same float32 tensors."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for b, reps in ((1, 25), (DOC_BATCH, 5)):
        qkv = [attn_inputs((b, 12, 12, 256, 256, 64, 64, False), gen, dev)
               for _ in range(reps)]
        kern = [lambda x=x: ops.flash_attention(*x, causal=False)
                for x in qkv]
        plain = [lambda x=x: ref.mha_attention(*x, causal=False)
                 for x in qkv]
        lib = [lambda x=x: sdpa(*x) for x in qkv]
        for calls in (kern, plain, lib):                    # warm-up
            event_ms(calls[:2], flush, spin=True)
        row = timed(kern, plain, [attn_bound(*x) for x in qkv], flush,
                    plain_syncs=False)
        row["library_ms"] = event_ms(lib, flush, spin=True)
        log("times", f"flash_attention B={b} H=12 S=256 D=64: "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"share={row['bound_ms'] / row['ms']:.3f}")
        out[b] = row
    return out


# ---------------------------------------------------------------------------


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
    args = ap.parse_args()
    args.d, args.k, args.nprobe = 768, 10, 64
    args.lmax = math.ceil(1.3 * args.n_docs / args.lists)
    # 16 sqrt(N) lists, FAISS's upper end: 4,096 at 65,536 docs
    args.enc_lists = 16 * math.isqrt(args.enc_docs)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    errs = dict.fromkeys(IVF_KERNELS + PQ_KERNELS + REC_KERNELS
                         + QUANT_KERNELS, 0.0)
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

    errs["flash_attention"] = 0.0
    attn_ulps = phase_attn(args, dev, errs)
    log("attn", f"{len(ATTN_SHAPES)} shapes (MHA, GQA, causal S == Skv and "
        f"S < Skv, non-causal, ragged S/Skv, Dv != D, dragon B = 1 and "
        f"{DOC_BATCH}, snowflake, yi-9b's RAG prefill H=32 Hkv=4 S=784 "
        f"D=128 causal bf16): flash_attention max_abs_err="
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
    del model, corpus, tindex, rec_vecs
    torch.cuda.empty_cache()

    index, docs, convs, exact = phase_index(args, dev)
    pqi = phase_pq(args, index, docs, dev)
    indexes = {"ivf": index, "ivf_pq": pqi}
    runs, launches = phase_serve(indexes, docs, convs, exact, dev)
    launches.update(phase_serve_quant(indexes, convs, exact, runs))
    phase_fig8(dev)

    for backend, _ in BACKENDS:
        for name in ("toploc+ fused", "toploc+ unfused"):
            phase_batched(indexes[backend], convs, runs[backend][name], dev)
    log("batched", "start_batch/step_batch over 25 conversations == the "
        "sequential engine (ids, scores, TurnStats, sessions), fused and "
        "unfused toploc+, ivf and ivf_pq")

    times = phase_times(args, index, pqi, convs, dev)
    times[1]["flash_attention"] = phase_attn_times(args, dev)[1]
    times[1]["embedding_bag"] = bag_times[1]
    # the LM at decode_32k runs once the retrieval objects are freed
    del index, pqi, docs, indexes, runs
    torch.cuda.empty_cache()
    d32_counts = phase_decode32k(args, dev)
    times[1]["flash_decode"] = phase_decode_times(args, dev)[1]
    launches["flash_attention"] = enc_launches + rag_counts["flash_attention"]
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
                    library_ms=times[1][name].get("library_ms"))
               for name in IVF_KERNELS + PQ_KERNELS + QUANT_KERNELS +
               ENC_KERNELS + REC_KERNELS + LM_KERNELS]
    log("done", f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
