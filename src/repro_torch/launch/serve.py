"""Serving driver: the full paper pipeline on the synthetic workload.

Port of ``repro/launch/serve.py``.  Builds the topic corpus, the IVF or
HNSW index (or Exact's corpus on the device), then serves every
conversation through the selected strategy with the sequential engine,
reporting the paper's metrics (MRR@10 / NDCG@3 / NDCG@10), wall clock
and the hardware-independent work counters, in the reference's lines.

  PYTHONPATH=src python -m repro_torch.launch.serve --backend ivf \\
      --strategy toploc+ --n-docs 20000 --nprobe 16 --h 64 [--device cpu]

It runs on cuda unless given ``--device cpu`` (and raises without CUDA,
as every entry point of the port does).  The workload is the
reference's array for array (``data.synthetic``).  The HNSW graph is
the reference's (the port's host build is); the IVF index is the
port's own k-means, drawn from a torch generator, so it differs from
the reference's unless one is passed in (``main(..., index=)`` /
``run(..., index=)``, e.g. the reference's converted by ``convert``).
``run`` also takes a ``workload`` already made for the same flags, and
returns what the printed lines (``report``) are made from, so a caller
can hold them to a replay.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import hnsw as HN
from repro_torch.core import ivf as IV
from repro_torch.data import synthetic as SY
from repro_torch.serving.engine import (ConversationalSearchEngine,
                                        ServingConfig, TurnRecord)


class ServeRun(NamedTuple):
    workload: SY.Workload
    index: Any                  # IVFIndex, HNSWIndex or Exact's (n, d) corpus
    run: np.ndarray             # (conversations, turns, k) int64 doc ids
    records: List[TurnRecord]   # the engine's, one a turn in serving order
    metrics: Dict[str, float]   # evaluate_run's MRR@10 / NDCG@3 / NDCG@10
    summary: Dict[str, float]   # the engine's summary()
    wall_s: float               # serving wall clock, every turn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--backend", default="ivf",
                    choices=["ivf", "hnsw", "exact"])
    ap.add_argument("--strategy", default="toploc+",
                    choices=["plain", "toploc", "toploc+"])
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--n-topics", type=int, default=64)
    ap.add_argument("--partitions", type=int, default=128)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--h", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--ef", type=int, default=32)
    ap.add_argument("--up", type=int, default=2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--conversations", type=int, default=10)
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--shift-prob", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    return ap


def run(args: argparse.Namespace, *, index: Any = None,
        workload: Optional[SY.Workload] = None,
        out: Callable[[str], None] = print) -> ServeRun:
    """Build (or take ``workload`` and ``index``, made for the same
    flags), serve, and print the build lines."""
    dev = _device.resolve(args.device)
    out(f"[serve] building workload: {args.n_docs} docs, "
        f"{args.conversations}x{args.turns} turns")
    wl = workload if workload is not None else SY.make_workload(
        SY.WorkloadConfig(n_docs=args.n_docs, d=args.d,
                          n_topics=args.n_topics,
                          n_conversations=args.conversations,
                          turns_per_conversation=args.turns,
                          shift_prob=args.shift_prob))

    t0 = time.time()
    if args.backend == "ivf":
        if index is None:
            index = IV.build(wl.doc_vecs, p=args.partitions, iters=8,
                             seed=0, device=dev)
        kw = {"ivf_index": index}
        out(f"[serve] IVF built in {time.time()-t0:.1f}s "
            f"(p={args.partitions}, Lmax={index.lmax})")
    elif args.backend == "hnsw":
        if index is None:
            index = HN.build(wl.doc_vecs, m=16, ef_construction=64,
                             device=dev)
        kw = {"hnsw_index": index}
        out(f"[serve] HNSW built in {time.time()-t0:.1f}s")
    else:
        if index is None:
            index = torch.from_numpy(wl.doc_vecs).to(dev)
        kw = {"doc_vecs": index}

    eng = ConversationalSearchEngine(ServingConfig(
        backend=args.backend, strategy=args.strategy, k=args.k,
        nprobe=args.nprobe, h=args.h, alpha=args.alpha,
        ef_search=args.ef, up=args.up), device=dev, **kw)

    convs = torch.from_numpy(wl.conversations).to(dev)
    ranked = np.zeros((args.conversations, args.turns, args.k), np.int64)
    t0 = time.time()
    for c in range(args.conversations):
        for t in range(args.turns):
            _, ids = eng.query(f"conv{c}", convs[c, t])
            ranked[c, t] = ids
        eng.end_conversation(f"conv{c}")
    wall = time.time() - t0
    return ServeRun(wl, index, ranked, list(eng.records),
                    SY.evaluate_run(ranked, wl, k=args.k), eng.summary(),
                    wall)


def report(args: argparse.Namespace, res: ServeRun) -> List[str]:
    """The metric and work lines ``main`` prints after serving."""
    m, s, wall = res.metrics, res.summary, res.wall_s
    return [f"[serve] {args.backend}/{args.strategy}: "
            f"MRR@10={m['mrr@10']:.3f} NDCG@3={m['ndcg@3']:.3f} "
            f"NDCG@10={m['ndcg@10']:.3f}",
            f"[serve] wall {wall:.2f}s "
            f"({1e3*wall/(args.conversations*args.turns):.2f} ms/turn); "
            f"work: centroid={s['mean_centroid_dists']:.0f} "
            f"list={s['mean_list_dists']:.0f} "
            f"graph={s['mean_graph_dists']:.0f} "
            f"refresh_rate={s['refresh_rate']:.2f}"]


def main(argv: Optional[List[str]] = None, *, index: Any = None) -> int:
    args = parser().parse_args(argv)
    for line in report(args, run(args, index=index)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
