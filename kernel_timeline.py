#!/usr/bin/env python3
"""In-kernel timeline of the retrieval kernels on one GPU.

Without a device profiler that sees inside a kernel, this script copies
``src/repro_torch`` into ``build/repro_torch/timeline/``, adds
``%globaltimer`` stamps at the phase boundaries of the stage kernels
(stage 1's chunk blocks and two-level fold, the IVF and ADC scan blocks,
their two-level fold and the fold's float32 re-rank, and inside each
fold level the landing of its lists and their merge; the embedding_bag
kernel), each block
appending its stamps to a device buffer, builds that copy and runs the
served B = 1 calls at the smoke's shape (``chip_smoke.stage_inputs``:
p = 16,384, Lmax 702, d = 768, PQ m = 48; k 10, nprobe 64, re-rank
depth 64; ``fused_turn_pq`` at f32, bf16 and int8; ``pq_adc_scan`` at
B = 25 too), the L2 cache flushed before each.  For the third call of each
it prints, per phase, the minimum / median / maximum time in µs from the
call's first stamp:

  CHUNK  stage-1 block: start, scores done, its lists written
  G1     stage-1 fold, a group of 16 chunks: arrived, merged
  G2     stage-1 fold, the groups: arrived, sel written
  SCAN   IVF scan block: start, wait for stage 1 over, scored, selected
  ADC    ADC scan block: start, LUT ready (landed or staged, int8's
         scale taken, the slice's ids and codes asked for), scored,
         selected
  G1 / G2 also: the lists landed in shared memory, merged, written
  L1     a probed list's fold: arrived, lists landed, merged, written
  L2     the query's fold: arrived, lists landed, merged (and the SM's
         clock64 over the merge, printed as GHz)
  RR     its float32 re-rank: rows asked of L2, rows scored
  END    the folding block done
  BAG    embedding_bag's warp-a-bag kernel, the warp of a bag: start,
         its first 32 ids landed, its first 8 rows summed, its row written
  ROWS   its small-batch kernel, a block (bag, column slice): start, the
         ids landed, the rows landed, the slice summed and written

Then ``embedding_bag`` at B = 1 on a table of the two-tower shape (d
256, the history's L = 50 ids), each of its kernels forced.  An anchor
may name alternatives, the code as it is and as it was before the
kernels' redesign, so the same script stamps both trees.

The stamps cost a few device instructions and one atomic a block; the
timeline is for where the time goes, the kernel times are ``chip_smoke.py
[times]``'s.  Run from the repository root: ``python3 kernel_timeline.py``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(ROOT, "build", "repro_torch", "timeline")
CSRC = os.path.join(COPY, "src", "repro_torch", "kernels", "csrc")

RECORDER = '''
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
static __device__ unsigned long long g_ts[16384][7];
static __device__ unsigned int g_n;
__device__ __forceinline__ void rec(unsigned long long tag,
                                    unsigned long long a,
                                    unsigned long long t1,
                                    unsigned long long t2,
                                    unsigned long long t3 = 0,
                                    unsigned long long t4 = 0,
                                    unsigned long long t5 = 0) {
  const unsigned int i = atomicAdd(&g_n, 1u);
  if (i < 16384) {
    g_ts[i][0] = tag; g_ts[i][1] = a; g_ts[i][2] = t1; g_ts[i][3] = t2;
    g_ts[i][4] = t3; g_ts[i][5] = t4; g_ts[i][6] = t5;
  }
}
'''

DUMP = '''
extern "C" int timeline_{tag}(void* dst, unsigned int* n) {{
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(dst, {ns}g_ts, sizeof({ns}g_ts));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(n, {ns}g_n, sizeof(unsigned int));
  unsigned int zero = 0;
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol({ns}g_n, &zero, sizeof(unsigned int));
  return (int)err;
}}
'''

# a stamp that waits for x to land: the store reads it
SINK = ("static __device__ volatile unsigned int tl_sink[32];\n"
        "__device__ __forceinline__ unsigned long long gtime_after(float x) "
        "{\n  tl_sink[threadIdx.x & 31] = __float_as_uint(x);\n"
        "  __syncwarp();\n  return gtime();\n}\n"
        "__device__ __forceinline__ float first_of(float4 v) { return v.x; }\n"
        "__device__ __forceinline__ float first_of(float v) { return v; }\n")

# (file, anchor, text put after the anchor)
STAMPS = [
    ("topk_tie.cuh", "namespace topk_tie {\n", RECORDER),
    ("fold.cuh", "namespace fold {\n",
     "using topk_tie::gtime;\nusing topk_tie::rec;\n"),
    ("fold.cuh", "    if (!arrive_last(counter, nsplit)) return false;\n",
     "    const unsigned long long tl_l1 = gtime();\n"),
    ("fold.cuh", "first, 1, nsplit,\n               w, -1);\n"
     "    __syncthreads();\n",
     "    const unsigned long long tl_l1b = gtime();\n"),
    ("fold.cuh", ("    topk_tie::merge_ranks(fv, fi, fp, nsplit, w);\n",
                  "    topk_tie::merge_warps(fv, fi, fp, nsplit, w, -1);\n"),
     "    const unsigned long long tl_l1c = gtime();\n"),
    ("fold.cuh", "      cand_n[first] = keep;\n",
     "      rec(3, b, tl_l1, tl_l1b, tl_l1c, gtime());\n"),
    ("fold.cuh", "  if (!arrive_last(counter, nprobe)) return false;\n",
     "  const unsigned long long tl_l2 = gtime();\n"),
    ("fold.cuh", "row, nsplit, nprobe,\n             w, -1);\n"
     "  __syncthreads();\n",
     "  const unsigned long long tl_l2b = gtime();\n"
     "  const unsigned long long tl_k2b = clock64();\n"),
    ("fold.cuh", ("  topk_tie::merge_ranks(fv, fi, fp, nprobe, w);\n",
                  "  topk_tie::merge_warps(fv, fi, fp, nprobe, w, -1);\n"),
     "  if (threadIdx.x == 0)\n"
     "    rec(4, b, tl_l2, tl_l2b, gtime(), tl_k2b, clock64());\n"),
    ("fold.cuh", "  for (int t = threadIdx.x; t < w; t += blockDim.x) "
     "es[t] = -INFINITY;\n  __syncthreads();\n",
     "  const unsigned long long tl_r1 = gtime();\n"),
    ("fold.cuh", "es[t] = sum[0];\n  }\n  __syncthreads();\n",
     "  if (threadIdx.x == 0) rec(9, b, tl_r1, gtime());\n"),
    ("pq_adc.cu", "  const int s = blockIdx.x % nsplit;\n",
     "  const unsigned long long tl_t0 = fold::gtime();\n"),
    ("pq_adc.cu", "  // also orders the LUT's stores before its reads\n",
     "  const unsigned long long tl_t1 = fold::gtime();\n"),
    ("ivf_stages.cuh", "  const int nwarps = blockDim.x >> 5;\n\n",
     "  const unsigned long long tl_t0 = fold::gtime();\n"),
    ("ivf_stages.cuh", "  fold::wait_primary();\n\n",
     "  const unsigned long long tl_t1 = fold::gtime();\n"),
    ("ivf_stages.cuh", "  fold::release_dependents();\n",
     "  const unsigned long long tl_c0 = fold::gtime();\n"),
    ("ivf_stages.cuh", "        sv[t][r] = sc[k];\n    }\n  }\n  __syncthreads();\n",
     "  const unsigned long long tl_c1 = fold::gtime();\n"),
    ("ivf_stages.cuh", "    if (!fold::arrive_last(counter, gn)) return;\n",
     "    const unsigned long long tl_g1 = fold::gtime();\n"
     "    unsigned long long tl_g1b = 0, tl_g1c = 0;\n"),
    ("ivf_stages.cuh", "gn, w1, topk_tie::PAD_POS);\n      __syncthreads();\n",
     "      if (t == 0) tl_g1b = fold::gtime();\n"),
    ("ivf_stages.cuh", ("      topk_tie::merge_ranks(fv, fi, fp, gn, w1);\n",
                        "      topk_tie::merge_warps(fv, fi, fp, gn, w1, "
                        "topk_tie::PAD_POS);\n"),
     "      if (t == 0) tl_g1c = fold::gtime();\n"),
    ("ivf_stages.cuh", "  if (!fold::arrive_last(counter, lists)) return;\n",
     "  const unsigned long long tl_g2 = fold::gtime();\n"
     "  unsigned long long tl_g2b = 0, tl_g2c = 0;\n"),
    ("ivf_stages.cuh", "lists, w1,\n                     topk_tie::PAD_POS);\n"
     "    __syncthreads();\n",
     "    if (t == 0) tl_g2b = fold::gtime();\n"),
    ("ivf_stages.cuh", ("    topk_tie::merge_ranks(fv, fi, fp, lists, w1);\n",
                        "    topk_tie::merge_warps(fv, fi, fp, lists, w1, "
                        "topk_tie::PAD_POS);\n"),
     "    if (t == 0) tl_g2c = fold::gtime();\n"),
    # embedding_bag's warp-a-bag kernel
    ("embedding_bag.cu", "namespace {\n", RECORDER + SINK),
    ("embedding_bag.cu", "  if (bag >= B) return;  // warp-uniform\n",
     "  const unsigned long long tl_b0 = gtime();\n"
     "  unsigned long long tl_b1 = 0, tl_b2 = 0;\n"),
    ("embedding_bag.cu", "? __ldg(bag_w + l0 + lane) : 1.f;\n",
     "      if (l0 == 0 && c0 == 0)\n"
     "        tl_b1 = gtime_after(__int_as_float(my_id) + my_w);\n"),
    ("embedding_bag.cu", "            acc[j] = add_scaled(acc[j], x[u][j], "
     "w[u]);\n        }\n",
     "        if (u0 == 0 && l0 == 0 && c0 == 0)\n"
     "          tl_b2 = gtime_after(first_of(acc[0]));\n"),
    # its small-batch kernel (absent before it was written: optional)
    ("embedding_bag.cu?", "  float acc = 0.f;\n",
     "  const unsigned long long tl_r0 = gtime();\n"
     "  unsigned long long tl_r1 = 0, tl_r2 = 0;\n"),
    ("embedding_bag.cu?", "      sw[k * 32 + lane] = my_w[k];\n    }\n"
     "    __syncwarp();\n",
     "    if (l0 == 0) tl_r1 = gtime();\n"),
    ("embedding_bag.cu?", "    cp_async_wait_all();\n    __syncwarp();\n",
     "    if (l0 == 0) tl_r2 = gtime();\n"),
    ("embedding_bag.cu?", "  if (lane < ncols) out[(size_t)bag * d + c0 + lane] = "
     "acc;\n",
     "  const unsigned long long tl_r3 = gtime_after(acc);\n"
     "  if (lane == 0) rec(11, bag, tl_r0, tl_r1, tl_r2, tl_r3);\n"),
]

# (file, text, text that replaces it): stamps that go before a line
REPLACE = [
    ("pq_adc.cu", "    __syncthreads();\n  }\n  fold::select_slice(",
     "    __syncthreads();\n  }\n  const unsigned long long tl_t2 = "
     "fold::gtime();\n  fold::select_slice("),
    ("pq_adc.cu", "  if (counters == nullptr) return;  // merge_topk_f32 folds "
     "the lists\n\n  int *fi, *fp;\n  if (!fold::fold_query(lut",
     "  if (threadIdx.x == 0)\n"
     "    fold::rec(1, b, tl_t0, tl_t1, tl_t2, fold::gtime());\n"
     "  if (counters == nullptr) return;  // merge_topk_f32 folds the lists\n"
     "\n  int *fi, *fp;\n  if (!fold::fold_query(lut"),
    ("pq_adc.cu", "                      out_v, out_i, out_p);\n}\n",
     "                      out_v, out_i, out_p);\n"
     "  if (threadIdx.x == 0) fold::rec(5, b, fold::gtime(), 0);\n}\n"),
    ("ivf_stages.cuh", "    __syncthreads();\n  }\n  fold::select_slice(",
     "    __syncthreads();\n  }\n  const unsigned long long tl_t2 = "
     "fold::gtime();\n  fold::select_slice("),
    ("ivf_stages.cuh", "  if (counters == nullptr) return;  // merge_topk_f32 "
     "folds the lists\n\n  int *fi, *fp;\n  float* fv",
     "  if (threadIdx.x == 0)\n"
     "    fold::rec(2, b, tl_t0, tl_t1, tl_t2, fold::gtime());\n"
     "  if (counters == nullptr) return;  // merge_topk_f32 folds the lists\n"
     "\n  int *fi, *fp;\n  float* fv"),
    ("ivf_stages.cuh", "                      sel_stride, lmax, b, out_v, "
     "out_i, out_p);\n}\n",
     "                      sel_stride, lmax, b, out_v, out_i, out_p);\n"
     "  if (threadIdx.x == 0) fold::rec(5, b, fold::gtime(), 0);\n}\n"),
    ("ivf_stages.cuh", "  if (counters == nullptr) return;  // merge_topk_f32 "
     "merges the chunks\n",
     "  if (threadIdx.x == 0) fold::rec(6, b0, tl_c0, tl_c1, fold::gtime());\n"
     "  if (counters == nullptr) return;  // merge_topk_f32 merges the "
     "chunks\n"),
    ("ivf_stages.cuh", "    lists = ngroups;\n",
     "    if (threadIdx.x == 0)\n"
     "      fold::rec(7, b0, tl_g1, tl_g1b, tl_g1c, fold::gtime());\n"
     "    lists = ngroups;\n"),
    ("ivf_stages.cuh", "  if (threadIdx.x == 0) *counter = 0;\n}\n\n"
     "// Stage 1's chunk blocks",
     "  if (threadIdx.x == 0) {\n    *counter = 0;\n"
     "    fold::rec(8, b0, tl_g2, tl_g2b, tl_g2c, fold::gtime());\n  }\n}\n\n"
     "// Stage 1's chunk blocks"),
    ("embedding_bag.cu", "      if (c < width) out[(size_t)bag * width + c] = "
     "acc[j];\n    }\n  }\n}\n",
     "      if (c < width) out[(size_t)bag * width + c] = acc[j];\n    }\n"
     "  }\n  const unsigned long long tl_b3 =\n"
     "      gtime_after(first_of(out[(size_t)bag * width]));\n"
     "  if (lane == 0) rec(10, bag, tl_b0, tl_b1, tl_b2, tl_b3);\n}\n"),
]

PHASES = {  # tag: (name, columns of the stamps)
    6: ("CHUNK", (2, 3, 4)), 7: ("G1", (2, 3, 4, 5)), 8: ("G2", (2, 3, 4, 5)),
    2: ("SCAN", (2, 3, 4, 5)), 1: ("ADC", (2, 3, 4, 5)),
    3: ("L1", (2, 3, 4, 5)), 4: ("L2", (2, 3, 4)), 9: ("RR", (2, 3)),
    5: ("END", (2,)), 10: ("BAG", (2, 3, 4, 5)),
    11: ("ROWS", (2, 3, 4, 5)),
}
# C sources that get a dump entry: (file, tag, namespace of the recorder)
DUMPS = (("fused_turn.cu", "ivf", "topk_tie::"),
         ("pq_adc.cu", "pq", "topk_tie::"),
         ("embedding_bag.cu", "bag", ""))


def instrument() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(COPY, "src"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), COPY)
    texts = {}

    def text(name):
        if name not in texts:
            with open(os.path.join(CSRC, name)) as fh:
                texts[name] = fh.read()
        return texts[name]

    for name, anchors, add in STAMPS:
        optional = name.endswith("?")
        name = name.rstrip("?")
        s = text(name)
        # an anchor, or the first present of alternatives (the code as it
        # is and as it was, so the parent of a change can be stamped too)
        found = [a for a in ((anchors,) if isinstance(anchors, str)
                             else anchors) if a in s]
        if not found:
            if optional:
                continue
            raise SystemExit(f"{name}: anchor not found: {anchors!r}")
        texts[name] = s.replace(found[0], found[0] + add, 1)
    for name, old, new in REPLACE:
        s = text(name)
        if old not in s:
            raise SystemExit(f"{name}: anchor not found: {old!r}")
        texts[name] = s.replace(old, new, 1)
    for name, s in texts.items():
        with open(os.path.join(CSRC, name), "w") as fh:
            fh.write(s)
    for name, tag, ns in DUMPS:
        with open(os.path.join(CSRC, name), "a") as fh:
            fh.write(DUMP.format(tag=tag, ns=ns))


def drive() -> None:
    """Runs inside the instrumented copy."""
    import ctypes
    import types

    import numpy as np
    import torch

    import chip_smoke as C
    from repro_torch.core import toploc
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        raise SystemExit("kernel_timeline: no CUDA device")
    lib = _build.lib()
    dev = torch.device("cuda")
    args = types.SimpleNamespace(lists=16_384, lmax=702, d=768, k=10,
                                 nprobe=64, seed=0)
    cents, lv, li, qs, rows, pqi = C.stage_inputs(args, dev, args.seed + 19)
    q = qs[:1].contiguous()
    sel = ops.centroid_topk(q, cents, 64)[1]
    tables = toploc._adc_tables(pqi, q)
    codes = pqi.list_codes
    sel25 = ops.centroid_topk(qs, cents, 64)[1]
    tables25 = toploc._adc_tables(pqi, qs)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    buf = np.zeros((16384, 7), np.uint64)
    n = ctypes.c_uint(0)

    def dump():
        out = []
        for name in ("timeline_ivf", "timeline_pq", "timeline_bag"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            if fn(buf.ctypes.data, ctypes.addressof(n)) != 0:
                raise RuntimeError(f"{name} failed")
            out.append(buf[:min(n.value, 16384)].copy())
        return np.concatenate(out)

    calls = {
        "fused_turn[f32]": lambda: ops.fused_turn(q, cents, lv, li,
                                                  nprobe=64, k=10),
        "fused_turn[bf16]": lambda: ops.fused_turn(
            q, cents, lv, li, nprobe=64, k=10, precision="bf16"),
        "fused_scan[f32]": lambda: ops.fused_scan(q, lv, li, sel, 10),
        "fused_scan_pq[f32]": lambda: ops.fused_scan_pq(
            tables, q, codes, li, sel, rows, 10, rerank=C.RERANK),
        "pq_adc_scan": lambda: ops.pq_adc_scan(tables, codes, li, sel,
                                               C.RERANK),
        "pq_adc_scan B=25": lambda: ops.pq_adc_scan(tables25, codes, li,
                                                    sel25, C.RERANK),
    }
    for prec in ("f32", "bf16", "int8"):
        calls[f"fused_turn_pq[{prec}]"] = lambda prec=prec: ops.fused_turn_pq(
            q, cents, tables, codes, li, rows, nprobe=64, k=10,
            rerank=C.RERANK, precision=prec)
    table, lo, vocab, hist = C.bag_table(dev, args.seed + 23)
    bag = torch.randint(lo, lo + vocab, (1, hist), device=dev,
                        dtype=torch.int32)
    for kernel in C.bag_kernels():
        calls[f"embedding_bag[{kernel}]"] = \
            lambda kernel=kernel: C.bag_call(table, bag, kernel)
    print(C.card_line())
    for name, call in calls.items():
        for _ in range(3):
            flush.zero_()
            dump()
            call()
            r = dump()
        t0 = min(int(x[c]) for x in r if int(x[0]) in PHASES
                 for c in PHASES[int(x[0])][1])
        label = name if "B=" in name else f"{name} B=1"
        print(f"{label}: µs from the call's first stamp, min / median / "
              f"max over the blocks of each phase")
        for tag, (label, cols) in PHASES.items():
            got = r[r[:, 0] == tag]
            if not len(got):
                continue
            parts = []
            for c in cols:
                v = np.sort(got[:, c].astype(np.int64) - t0) / 1e3
                parts.append(f"{v[0]:.1f} / {v[len(v) // 2]:.1f} / "
                             f"{v[-1]:.1f}")
            print(f"  {label:5s} x{len(got):3d}: " + "; ".join(parts))
        l2 = r[r[:, 0] == 4]
        if len(l2):  # the SM's clock over the query fold's merge
            x = l2[0].astype(np.int64)
            print(f"  SM clock over the L2 merge: "
                  f"{(x[6] - x[5]) / max(x[4] - x[3], 1):.2f} GHz")


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--drive":
        drive()
        return 0
    instrument()
    shutil.copy(os.path.abspath(__file__), COPY)
    return subprocess.call([sys.executable, os.path.join(
        COPY, os.path.basename(__file__)), "--drive"], cwd=COPY)


if __name__ == "__main__":
    sys.exit(main())
