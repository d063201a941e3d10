#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path — TopLoc_IVF conversations served by
``ConversationalSearchEngine`` through the hand-written ``fused_scan`` /
``fused_turn`` CUDA kernels — at the size its users run: an MS MARCO
passage-scale corpus (8,841,823 docs, d = 768, the width of the dragon
BERT-base dual encoder) drawn on the device from a seed after the
synthetic workload's recipe, an IVF index of 16,384 lists, and the
``ServingConfig`` defaults (k = 10, nprobe = 64, h = 1024, alpha = 0.1)
over 25 conversations x 10 turns.

Phases (one line each; any failure raises and exits non-zero):
  1 card      nvidia-smi name and power limit, versions, TF32 off
  2 build     nvcc of kernels/csrc (seconds, registers, spills)
  3 exact     integer inputs: kernels == plain versions bit for bit
  4 realistic unit-norm floats at the smoke's shapes, B = 1 and 25
  5 index     the port's ivf.build at full size + exact top-10
  6 serve     toploc+ / toploc / plain fused, toploc+ unfused
  7 batched   start_batch / step_batch == the sequential engine
  8 times     CUDA-event kernel times (L2 flushed) beside their bounds
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


def dot_rows(rows, q, slot=None):
    """``true_score`` over the rows of ``rows``: ids (B, k) -> the float64
    dot product of each id's row (``rows[slot[id]]`` where a ``slot``
    map is given) with its query q[b]."""
    def score(ids):
        r = rows[ids if slot is None else slot[ids]]
        return (r.double() * q.double()[:, None]).sum(-1)
    return score


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


def phase_exact(dev):
    import torch
    from repro_torch.kernels import ops, ref
    for shape in EXACT_SHAPES:
        q, cents, lv, li, own = int_inputs(shape, dev)
        nprobe, k = shape[4], shape[5]
        got = ops.fused_turn(q, cents, lv, li, nprobe=nprobe, k=k)
        want = ref.fused_turn_ivf(q, cents, lv, li, nprobe=nprobe, k=k)
        for name, g, w in zip(("v", "ids", "sel"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fused_turn {shape}: {name} differs")
        got = ops.fused_scan(q, lv, li, want[2], k, own=own)
        want = ref.fused_scan_ivf(q, lv, li, want[2], own, k=k)
        for name, g, w in zip(("v", "ids", "pos"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fused_scan {shape}: {name} differs")
    torch.cuda.synchronize()
    return len(EXACT_SHAPES)


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
    import torch
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    p, lmax, d = args.lists, args.lmax, args.d
    cents = unit(torch.randn((p, d), generator=gen, device=dev))
    lv, li = realistic_lists(p, lmax, d, gen, dev)
    qs = unit(torch.randn((25, d), generator=gen, device=dev))
    ties = {"fused_turn": 0, "fused_scan": 0, "sel": 0}
    for b in (1, 25):
        q = qs[:b].contiguous()
        cs = ref.gemv_rows(cents, q)
        _, sel = topk(cs, args.nprobe)
        sel = sel.to(torch.int32)
        # fused_scan against its plain version on the same selection
        got = ops.fused_scan(q, lv, li, sel, args.k)
        want = ref.fused_scan_ivf(q, lv, li, sel, None, k=args.k)
        docs = dot_rows(lv.view(p * lmax, d), q)
        err, n = compare(f"fused_scan B={b}", got[0], got[1], want[0],
                         want[1], docs, p * lmax)
        errs["fused_scan"] = max(errs["fused_scan"], err)
        ties["fused_scan"] += n
        # fused_turn: stage 1's probe set under the tie rule, stage 2
        # against the plain scan of the probe set the kernel chose
        gv, gi, gsel = ops.fused_turn(q, cents, lv, li, nprobe=args.nprobe,
                                      k=args.k)
        _, n = compare(f"fused_turn sel B={b}", cs.gather(1, gsel.long()),
                       gsel, cs.gather(1, sel.long()), sel,
                       dot_rows(cents, q), p)
        ties["sel"] += n
        want = ref.fused_scan_ivf(q, lv, li, gsel, None, k=args.k)
        err, n = compare(f"fused_turn B={b}", gv, gi, want[0], want[1],
                         docs, p * lmax)
        errs["fused_turn"] = max(errs["fused_turn"], err)
        ties["fused_turn"] += n
    torch.cuda.synchronize()
    del lv, li
    torch.cuda.empty_cache()
    return ties


# ---------------------------------------------------------------------------
# phases 5-7: index, serving, sequential == batched
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
    del corpus, flat
    torch.cuda.empty_cache()
    log("index", f"n_docs={args.n_docs} d={args.d} p={args.lists} "
        f"iters={args.iters} corpus_s={t_gen:.1f} build_s={t_build:.1f} "
        f"lmax={index.lmax} n_indexed={index.n_docs} "
        f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}")
    if index.n_docs != args.n_docs:
        raise AssertionError("the index lost documents")
    return index, convs, exact


SERVE = [("toploc+ fused", dict(strategy="toploc+", fused=True)),
         ("toploc fused", dict(strategy="toploc", fused=True)),
         ("plain fused", dict(strategy="plain", fused=True)),
         ("toploc+ unfused", dict(strategy="toploc+", fused=False))]


def serve(index, convs, exact, name, knobs, quiet=False):
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    eng = ConversationalSearchEngine(
        ServingConfig(backend="ivf", precision="f32", **knobs),
        ivf_index=index)
    before = (ops.fused_scan.launches, ops.fused_turn.launches)
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
    launches = (ops.fused_scan.launches - before[0],
                ops.fused_turn.launches - before[1])
    if not quiet:
        p50, p95 = np.percentile(lat, [50, 95])
        log("serve", f"{name}: turns={s['turns']} p50_ms={p50:.3f} "
            f"p95_ms={p95:.3f} mean_centroid_dists={s['mean_centroid_dists']:.1f} "
            f"mean_list_dists={s['mean_list_dists']:.1f} "
            f"refresh_rate={s['refresh_rate']:.3f} recall@10={recall:.4f} "
            f"fused_scan_launches={launches[0]} "
            f"fused_turn_launches={launches[1]}")
    return eng, vs, ids


def doc_slots(index):
    """(n_docs,) int64: the flat posting-list slot holding each doc id."""
    import torch
    real = index.list_ids.view(-1) >= 0
    slot = torch.empty(index.n_docs, dtype=torch.int64,
                       device=index.list_ids.device)
    slot[index.list_ids.view(-1)[real].long()] = torch.nonzero(real)[:, 0]
    return slot


STAT_FIELDS = ("centroid_dists", "list_dists", "graph_dists", "code_dists",
               "i0", "refreshed")


def same_records(a, b):
    return [[getattr(r, f) for f in STAT_FIELDS] for r in a.records] == \
        [[getattr(r, f) for f in STAT_FIELDS] for r in b.records]


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
# phase 8: kernel times beside their bounds
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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_times(args, index, convs, dev):
    import torch
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops, ref, tiling
    reps = 25
    r_pad = tiling.next_pow2(args.k)
    qs = torch.from_numpy(np.ascontiguousarray(convs[:, 0])).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    out = {}
    for b in (1, 25):
        batches = ([qs[j:j + 1] for j in range(reps)] if b == 1
                   else [qs] * 5)
        sels = [topk(ref.gemv_rows(index.centroids, q), args.nprobe)[1]
                .to(torch.int32) for q in batches]
        lv, li, c = index.list_vecs, index.list_ids, index.centroids

        def scan_k(q, s):
            return lambda: ops.fused_scan(q, lv, li, s, args.k)

        def scan_p(q, s):
            return lambda: ref.fused_scan_ivf(q, lv, li, s, None, k=args.k)

        def turn_k(q):
            return lambda: ops.fused_turn(q, c, lv, li, nprobe=args.nprobe,
                                          k=args.k)

        def turn_p(q):
            return lambda: ref.fused_turn_ivf(q, c, lv, li,
                                              nprobe=args.nprobe, k=args.k)

        sw = [scan_bound(index, q, s, r_pad) for q, s in zip(batches, sels)]
        # fused_turn adds the centroid table, read once, and its products
        tw = [(nb + index.p * index.d * 4,
               fl + 2 * q.shape[0] * index.p * index.d)
              for (nb, fl), q in zip(sw, batches)]
        scans = [scan_k(q, s) for q, s in zip(batches, sels)]
        turns = [turn_k(q) for q in batches]
        event_ms(scans[:2] + turns[:2], flush, spin=True)     # warm-up
        row = {
            "fused_scan": dict(
                ms=event_ms(scans, flush, spin=True),
                plain_ms=event_ms([scan_p(q, s)
                                   for q, s in zip(batches, sels)],
                                  flush, spin=False),
                bound_ms=float(np.mean([bound_ms(*w)[0] for w in sw])),
                bound_by=bound_ms(*sw[0])[1]),
            "fused_turn": dict(
                ms=event_ms(turns, flush, spin=True),
                plain_ms=event_ms([turn_p(q) for q in batches], flush,
                                  spin=False),
                bound_ms=float(np.mean([bound_ms(*w)[0] for w in tw])),
                bound_by=bound_ms(*tw[0])[1]),
        }
        for name, r in row.items():
            log("times", f"{name} B={b}: ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
                f" ({r['bound_by']}) share={r['bound_ms'] / r['ms']:.3f}")
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
    from repro_torch.kernels import _build, ops
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
    ptxas = [ln.strip() for ln in str(_build.last_build["log"]).splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", f"nvcc {_build.last_build['seconds']:.1f}s from "
        f"{_build.CSRC.relative_to(ROOT)} | " + " | ".join(ptxas))

    log("exact", f"{phase_exact(dev)} shapes: fused_turn (v, ids, sel) and "
        f"fused_scan (v, ids, pos) bit-equal to their plain versions")

    errs = {"fused_scan": 0.0, "fused_turn": 0.0}
    ties = phase_realistic(args, dev, errs)
    log("realistic", f"p={args.lists} lmax={args.lmax} d={args.d} B=1,25: "
        f"max_abs_err scan={errs['fused_scan']:.3g} "
        f"turn={errs['fused_turn']:.3g} (tol {TOL}); near-tie id "
        f"mismatches scan={ties['fused_scan']} turn={ties['fused_turn']} "
        f"sel={ties['sel']}")

    index, convs, exact = phase_index(args, dev)

    # warm every path (cuBLAS handles, allocator) outside the counted run
    for name, knobs in SERVE:
        serve(index, convs[:1, :2], exact[:1, :2], name, knobs, quiet=True)
    ops.reset_launches()
    runs = {name: serve(index, convs, exact, name, knobs)
            for name, knobs in SERVE}
    launches = {"fused_scan": ops.fused_scan.launches,
                "fused_turn": ops.fused_turn.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    (_, fv, fi), (_, uv, ui) = runs["toploc+ fused"], runs["toploc+ unfused"]
    flat = [torch.from_numpy(x.reshape(-1, x.shape[-1])).to(dev)
            for x in (fv, fi, uv, ui)]
    err, n = compare("fused vs unfused toploc+", *flat,
                     dot_rows(index.list_vecs.view(-1, args.d),
                              torch.from_numpy(convs.reshape(-1, args.d))
                              .to(dev), doc_slots(index)), index.n_docs)
    if not same_records(runs["toploc+ fused"][0], runs["toploc+ unfused"][0]):
        raise AssertionError("fused and unfused toploc+ TurnStats differ")
    log("serve", f"launches {launches}; fused == unfused toploc+: stats "
        f"equal, max |dscore| {err:.3g}, near-tie id mismatches {n}")

    for name in ("toploc+ fused", "toploc+ unfused"):
        phase_batched(index, convs, runs[name], dev)
    log("batched", "start_batch/step_batch over 25 conversations == the "
        "sequential engine (ids, scores, TurnStats, sessions), fused and "
        "unfused toploc+")

    times = phase_times(args, index, convs, dev)
    replaces = {"fused_scan": "src/repro/kernels/fused_turn.py:644",
                "fused_turn": "src/repro/kernels/fused_turn.py:406"}
    kernels = [dict(name=name, route="cuda", source=SCAN_SRC,
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=errs[name], ms=times[1][name]["ms"],
                    plain_ms=times[1][name]["plain_ms"],
                    bound_ms=times[1][name]["bound_ms"],
                    bound_by=times[1][name]["bound_by"], library_ms=None)
               for name in ("fused_scan", "fused_turn")]
    log("done", f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
