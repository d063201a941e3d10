#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's two serving paths through
``ConversationalSearchEngine`` at the size its users run: TopLoc_IVF
(float lists, the hand-written ``fused_scan`` / ``fused_turn`` CUDA
kernels) and TopLoc_IVFPQ (PQ lists, the ``pq_adc_scan`` /
``fused_scan_pq`` / ``fused_turn_pq`` kernels), over an MS MARCO
passage-scale corpus (8,841,823 docs, d = 768, the width of the dragon
BERT-base dual encoder) drawn on the device from a seed after the
synthetic workload's recipe, an IVF index of 16,384 lists, PQ codes of
m = 48 subquantizers x 256 codewords, and the ``ServingConfig`` defaults
(k = 10, nprobe = 64, h = 1024, alpha = 0.1, rerank = 64) over 25
conversations x 10 turns.

Phases (one line each, [serve] one per path; any failure raises and
exits non-zero):
  1 card      nvidia-smi name and power limit, versions, TF32 off
  2 build     nvcc of every kernels/csrc source (seconds; registers and
              spills per kernel)
  3 exact     integer inputs: kernels == plain versions bit for bit
  4 realistic unit-norm floats at the smoke's shapes, B = 1 and 25
  5 index     the port's ivf.build at full size + exact top-10
  6 pq        the port's build_ivf_pq at full size (m = 48, 8 iters)
  7 serve     per backend: toploc+ / toploc / plain fused, toploc+
              unfused; each backend's launch counts start at 0
  8 batched   start_batch / step_batch == the sequential engine
  9 times     CUDA-event kernel times (L2 flushed) beside their bounds
then a JSON line of kernels, the card line, and the result line.

Run from the repository root: ``python3 chip_smoke.py``.  Size flags
(``--n-docs``, ``--lists``, ``--iters``) cut the run for a quick check.
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
PQ_M, PQ_ITERS, RERANK = 48, 8, 64
IVF_KERNELS = ("fused_scan", "fused_turn")
PQ_KERNELS = ("pq_adc_scan", "fused_scan_pq", "fused_turn_pq")
REPLACES = {"fused_scan": "src/repro/kernels/fused_turn.py:644",
            "fused_turn": "src/repro/kernels/fused_turn.py:406",
            "pq_adc_scan": "src/repro/kernels/pq_adc.py:79",
            "fused_scan_pq": "src/repro/kernels/fused_turn.py:686",
            "fused_turn_pq": "src/repro/kernels/fused_turn.py:445"}


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
                (1000, 130, 8, 25, 64, 10)]  # dense ties, B not / 8

# p, lmax, d, B, nprobe, k, m, n_codes, rerank
# (tests/test_torch_kernels.py PQ_SHAPES)
PQ_EXACT_SHAPES = [(6, 10, 16, 3, 3, 4, 4, 16, 6),      # r 6 < r_pad 8
                   (4, 3, 8, 2, 2, 8, 8, 256, 8),       # 6 slots, k = 8
                   (9, 600, 32, 4, 2, 4, 48, 256, 64),  # 2 ADC blocks
                   (300, 200, 32, 9, 64, 10, 48, 256, 64),
                   (1000, 130, 8, 25, 64, 10, 8, 256, 20)]  # dense ties


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
    import torch
    from repro_torch.kernels import ops, ref
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
    return len(EXACT_SHAPES), len(PQ_EXACT_SHAPES)


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


def phase_realistic(args, dev, errs):
    """Float IVF lists, then PQ lists over the same slots: random uint8
    codes of m = 48, random codebooks, the float rows as re-rank
    source (doc id = flat slot)."""
    import torch
    from repro_torch.core import pq, toploc
    from repro_torch.core.topk import topk
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
                          "fused_scan_pq", "sel_pq"), 0)
    for b in (1, 25):
        q = qs[:b].contiguous()
        cs = ref.gemv_rows(cents, q)
        _, sel = topk(cs, args.nprobe)
        sel = sel.to(torch.int32)
        docs = dot_rows(rows, q)
        # fused_scan against its plain version on the same selection
        got = ops.fused_scan(q, lv, li, sel, k)
        want = ref.fused_scan_ivf(q, lv, li, sel, None, k=k)
        err, n = compare(f"fused_scan B={b}", got[0], got[1], want[0],
                         want[1], docs, p * lmax)
        errs["fused_scan"] = max(errs["fused_scan"], err)
        ties["fused_scan"] += n
        # fused_turn: stage 1's probe set under the tie rule, stage 2
        # against the plain scan of the probe set the kernel chose
        gv, gi, gsel = ops.fused_turn(q, cents, lv, li, nprobe=args.nprobe,
                                      k=k)
        _, n = compare(f"fused_turn sel B={b}", cs.gather(1, gsel.long()),
                       gsel, cs.gather(1, sel.long()), sel,
                       dot_rows(cents, q), p)
        ties["sel"] += n
        want = ref.fused_scan_ivf(q, lv, li, gsel, None, k=k)
        err, n = compare(f"fused_turn B={b}", gv, gi, want[0], want[1],
                         docs, p * lmax)
        errs["fused_turn"] = max(errs["fused_turn"], err)
        ties["fused_turn"] += n
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
    torch.cuda.synchronize()
    del lv, li, rows, pqi
    torch.cuda.empty_cache()
    return ties


# ---------------------------------------------------------------------------
# phases 5-8: index, PQ index, serving, sequential == batched
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
    return {name: getattr(ops, name).launches
            for name in IVF_KERNELS + PQ_KERNELS}


def serve(backend, index, convs, exact, name, knobs, quiet=False):
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    eng = ConversationalSearchEngine(
        ServingConfig(backend=backend, precision="f32", **knobs),
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
# phase 9: kernel times beside their bounds
# ---------------------------------------------------------------------------


def event_ms(calls, flush, *, spin):
    """Mean CUDA-event time of each call, with the L2 cache flushed
    (``flush`` overwritten) before each.  With ``spin`` a spin kernel
    queued first lets the host enqueue every call before the device
    starts them, so host overhead does not show as device time; calls
    that synchronise with the host themselves (the plain versions) run
    without it and their time includes that overhead."""
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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed(kernel_calls, plain_calls, works, flush):
    """One kernel's row: kernel and plain-version times, mean bound."""
    return dict(ms=event_ms(kernel_calls, flush, spin=True),
                plain_ms=event_ms(plain_calls, flush, spin=False),
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
        for kern, plain in calls.values():                     # warm-up
            event_ms(kern[:2], flush, spin=True)
        row = {name: timed(kern, plain, works[name], flush)
               for name, (kern, plain) in calls.items()}
        for name, rr in row.items():
            log("times", f"{name} B={b}: ms={rr['ms']:.4f} "
                f"plain_ms={rr['plain_ms']:.4f} "
                f"bound_ms={rr['bound_ms']:.4f} ({rr['bound_by']}) "
                f"share={rr['bound_ms'] / rr['ms']:.3f}")
        out[b] = row
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=8_841_823)
    ap.add_argument("--lists", type=int, default=16_384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    args.d, args.k, args.nprobe = 768, 10, 64
    args.lmax = math.ceil(1.3 * args.n_docs / args.lists)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels import _build
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

    n_ivf, n_pq = phase_exact(dev)
    log("exact", f"{n_ivf} shapes: fused_turn (v, ids, sel) and fused_scan "
        f"(v, ids, pos); {n_pq} PQ shapes: fused_turn_pq (v, ids, sel), "
        f"pq_adc_scan (v, ids), fused_scan_pq with and without re-rank "
        f"(v, ids, pos): bit-equal to their plain versions")

    errs = dict.fromkeys(IVF_KERNELS + PQ_KERNELS, 0.0)
    ties = phase_realistic(args, dev, errs)
    log("realistic", f"p={args.lists} lmax={args.lmax} d={args.d} "
        f"m={PQ_M} B=1,25: ADC candidates (pq_adc_scan, fused_scan_pq "
        f"top-r) bit-equal; max_abs_err " + " ".join(
            f"{n}={e:.3g}" for n, e in errs.items()) + f" (tol {TOL}); "
        f"near-tie id mismatches " + " ".join(
            f"{n}={v}" for n, v in ties.items()))

    index, docs, convs, exact = phase_index(args, dev)
    pqi = phase_pq(args, index, docs, dev)
    indexes = {"ivf": index, "ivf_pq": pqi}
    runs, launches = phase_serve(indexes, docs, convs, exact, dev)

    for backend, _ in BACKENDS:
        for name in ("toploc+ fused", "toploc+ unfused"):
            phase_batched(indexes[backend], convs, runs[backend][name], dev)
    log("batched", "start_batch/step_batch over 25 conversations == the "
        "sequential engine (ids, scores, TurnStats, sessions), fused and "
        "unfused toploc+, ivf and ivf_pq")

    times = phase_times(args, index, pqi, convs, dev)
    kernels = [dict(name=name, route="cuda",
                    source=SCAN_SRC if name in IVF_KERNELS else PQ_SRC,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], ms=times[1][name]["ms"],
                    plain_ms=times[1][name]["plain_ms"],
                    bound_ms=times[1][name]["bound_ms"],
                    bound_by=times[1][name]["bound_by"], library_ms=None)
               for name in IVF_KERNELS + PQ_KERNELS]
    log("done", f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
