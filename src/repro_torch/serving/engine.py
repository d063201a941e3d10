"""Conversational serving engine — TopLoc as a first-class feature.

Port of the sequential ``ConversationalSearchEngine`` of
``repro/serving/engine.py``: per-conversation TopLoc state held on the
device between turns, the retrieval backend resolved once from the
``core.backend`` registry, and work + latency accounting per turn.

``ServingConfig`` keeps every field and default of the reference.  The
knobs whose modules are not ported yet raise ``NotImplementedError``:
corpus sharding (``shards > 1``, ``mesh``), the mutable corpus
(``segment_cap > 0``) and the result cache (``cache_threshold > 0``);
the batched engine and the result cache are ROADMAP Queue 1, item 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import backend as _backend
from repro_torch.core import ivf as _ivf
from repro_torch.core import pq as _pq
from repro_torch.core import toploc


@dataclasses.dataclass
class ServingConfig:
    backend: str = "ivf"          # any core.backend registry name
    strategy: str = "toploc"      # "toploc" | "toploc+" | "plain"
    k: int = 10
    # IVF / IVF-PQ
    nprobe: int = 64
    h: int = 1024                 # cached centroids (TopLoc_IVF)
    alpha: float = 0.1            # refresh threshold (TopLoc_IVF+)
    rerank: int = 64              # exact re-rank depth (IVF-PQ)
    # fused turn (core.toploc.FusedTurn over the CUDA kernels of
    # kernels/csrc/): "f32" equals the unfused path; "bf16" / "int8"
    # score quantised and re-rank in float32 inside the kernel
    fused: bool = False
    precision: str = "f32"
    # HNSW
    ef_search: int = 64
    up: int = 2                   # first-turn ef upscaling
    # corpus sharding (not ported)
    shards: int = 0
    mesh: Any = None
    shard_axis: str = "model"
    # session-level result cache (not ported)
    cache_threshold: float = 0.0
    cache_depth: int = 0
    # mutable corpus (not ported)
    segment_cap: int = 0


@dataclasses.dataclass
class TurnRecord:
    conv_id: str
    turn: int
    latency_s: float              # service time (dispatch -> result)
    centroid_dists: int
    list_dists: int
    graph_dists: int
    refreshed: bool
    i0: int
    code_dists: int = 0
    cache_hit: bool = False
    queue_wait_s: float = 0.0


def _refuse_unported(cfg: ServingConfig) -> None:
    if (cfg.shards and cfg.shards > 1) or cfg.mesh is not None:
        raise NotImplementedError(
            "corpus sharding (shards > 1 / mesh) is not ported yet: "
            "ROADMAP Queue 1, item 6")
    if cfg.segment_cap > 0:
        raise NotImplementedError(
            "the mutable corpus (segment_cap > 0) is not ported yet: "
            "ROADMAP Queue 1, item 5")
    if cfg.cache_threshold > 0.0:
        raise NotImplementedError(
            "the result cache (cache_threshold > 0) is not ported yet: "
            "ROADMAP Queue 1, item 1")


class ConversationalSearchEngine:
    """One turn per call, sessions in a Python dict.

    The index (``ivf_index`` for ``backend="ivf"``, ``ivf_pq_index`` for
    ``"ivf_pq"``) must live on ``device`` (default cuda); queries may be
    numpy arrays or tensors and are moved there.
    """

    def __init__(self, config: ServingConfig, *,
                 ivf_index: Optional[_ivf.IVFIndex] = None,
                 ivf_pq_index: Optional[_pq.IVFPQIndex] = None,
                 device=None):
        _refuse_unported(config)
        self.cfg = config
        self.device = _device.resolve(device)
        alpha = config.alpha if config.strategy == "toploc+" else -1.0
        fused = (toploc.FusedTurn(precision=config.precision)
                 if config.fused else None)
        # the ported registry holds the IVF family only: pass its knobs
        # (ef_search / up belong to backends not yet ported); make()
        # drops rerank for "ivf", as the reference's does
        self.backend = _backend.make(config.backend, h=config.h,
                                     nprobe=config.nprobe, alpha=alpha,
                                     rerank=config.rerank, fused=fused)
        self.index = {"ivf_index": ivf_index,
                      "ivf_pq_index": ivf_pq_index
                      }.get(self.backend.index_kwarg)
        if self.index is None:
            raise ValueError(f"{config.backend} backend needs "
                             f"{self.backend.index_kwarg}")
        _device.require(self.device, self.index.centroids)
        if isinstance(self.index, _pq.IVFPQIndex):
            _pq.check_index(self.index)
        self.sessions: Dict[str, Any] = {}
        self.turn_count: Dict[str, int] = {}
        self.records: List[TurnRecord] = []

    @property
    def _sessioned(self) -> bool:
        return self.backend.stateful and self.cfg.strategy != "plain"

    def query(self, conv_id: str, qvec) -> Tuple[np.ndarray, np.ndarray]:
        """One conversational turn. qvec (d,). Returns (scores, doc_ids)."""
        t0 = time.perf_counter()
        k = self.cfg.k
        dev = self.device
        q = torch.as_tensor(qvec, dtype=torch.float32).to(dev)
        turn = self.turn_count.get(conv_id, 0)
        if not self._sessioned:
            v, i, stats = toploc.plain(self.backend, self.index, q, k=k,
                                       device=dev)
        elif turn == 0 or conv_id not in self.sessions:
            v, i, sess, stats = toploc.start(self.backend, self.index, q,
                                             k=k, device=dev)
            self.sessions[conv_id] = sess
        else:
            v, i, sess, stats = toploc.step(self.backend, self.index,
                                            self.sessions[conv_id], q, k=k,
                                            device=dev)
            self.sessions[conv_id] = sess
        # one device→host copy ends the turn (and synchronises the card)
        host = torch.stack([s.to(torch.int64) for s in stats]).cpu()
        v = v.cpu().numpy()
        i = i.cpu().numpy()
        dt = time.perf_counter() - t0
        st = dict(zip(toploc.TurnStats._fields, host.tolist()))
        self.turn_count[conv_id] = turn + 1
        self.records.append(TurnRecord(
            conv_id, turn, dt, st["centroid_dists"], st["list_dists"],
            st["graph_dists"], bool(st["refreshed"]), st["i0"],
            st["code_dists"]))
        return v, i

    def end_conversation(self, conv_id: str) -> None:
        self.sessions.pop(conv_id, None)
        self.turn_count.pop(conv_id, None)

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        lat = np.asarray([r.latency_s for r in self.records])
        wait = np.asarray([r.queue_wait_s for r in self.records])
        return {
            "turns": len(self.records),
            "mean_latency_ms": float(lat.mean() * 1e3),
            "p95_latency_ms": float(np.percentile(lat, 95) * 1e3),
            "mean_queue_wait_ms": float(wait.mean() * 1e3),
            "p95_request_ms": float(np.percentile(lat + wait, 95) * 1e3),
            "mean_centroid_dists": float(np.mean(
                [r.centroid_dists for r in self.records])),
            "mean_list_dists": float(np.mean(
                [r.list_dists for r in self.records])),
            "mean_graph_dists": float(np.mean(
                [r.graph_dists for r in self.records])),
            "mean_code_dists": float(np.mean(
                [r.code_dists for r in self.records])),
            # refresh is defined from each conversation's second turn on
            "refresh_rate": float(np.mean(
                [r.refreshed for r in self.records if r.turn > 0]
                or [0.0])),
            "cache_hit_rate": float(np.mean(
                [r.cache_hit for r in self.records])),
        }
