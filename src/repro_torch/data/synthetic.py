"""Synthetic CAsT-like conversational search workload.

``make_workload`` and the IR metrics are a numpy copy of the
reference's ``repro/data/synthetic.py`` (same recipe, same random
stream, so the same config gives the same arrays): a topic-clustered
unit-norm corpus with Zipf-skewed topic popularity, conversations that
drift around a topic with optional hard shifts, and graded qrels from
exhaustive search.

``make_device_corpus`` follows the same recipe at collection scale: the
documents are drawn on the device from a seeded ``torch.Generator``
(so they differ from the numpy stream), the topic centres and the
conversations come from numpy exactly as in ``make_workload``.  Qrels
are left to the caller, who can run an exact search on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_docs: int = 100_000
    d: int = 64
    n_topics: int = 256
    doc_spread: float = 0.35       # doc noise around topic centre
    n_conversations: int = 25
    turns_per_conversation: int = 10
    query_drift: float = 0.15      # per-turn query noise
    walk_step: float = 0.05        # slow within-topic topic walk
    shift_prob: float = 0.0        # prob. of a hard topic shift per turn
    seed: int = 0


class Workload(NamedTuple):
    doc_vecs: np.ndarray           # (n_docs, d) float32, unit norm
    doc_topic: np.ndarray          # (n_docs,) int32
    topic_centers: np.ndarray      # (n_topics, d)
    conversations: np.ndarray      # (n_conv, turns, d) float32 queries
    conv_topics: np.ndarray        # (n_conv, turns) int32
    qrels: Dict[Tuple[int, int], Dict[int, int]]  # (conv, turn) → {doc: grade}


class DeviceCorpus(NamedTuple):
    doc_vecs: torch.Tensor         # (n_docs, d) float32 on the device
    doc_topic: torch.Tensor        # (n_docs,) int64 on the device
    topic_centers: np.ndarray      # (n_topics, d) float32
    conversations: np.ndarray      # (n_conv, turns, d) float32 queries
    conv_topics: np.ndarray        # (n_conv, turns) int32


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _popularity(n_topics: int) -> np.ndarray:
    """Zipf-ish topic popularity (real collections are skewed)."""
    pop = 1.0 / np.arange(1, n_topics + 1) ** 0.7
    return pop / pop.sum()


def _conversations(rng: np.random.Generator, cfg: WorkloadConfig,
                   centers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    convs = np.zeros((cfg.n_conversations, cfg.turns_per_conversation,
                      cfg.d), np.float32)
    conv_topics = np.zeros((cfg.n_conversations,
                            cfg.turns_per_conversation), np.int32)
    for c in range(cfg.n_conversations):
        topic = int(rng.integers(cfg.n_topics))
        anchor = centers[topic].copy()
        for t in range(cfg.turns_per_conversation):
            if t > 0 and rng.uniform() < cfg.shift_prob:
                topic = int(rng.integers(cfg.n_topics))
                anchor = centers[topic].copy()
            anchor = _normalize(anchor + cfg.walk_step *
                                rng.normal(size=cfg.d)).astype(np.float32)
            q = _normalize(anchor + cfg.query_drift *
                           rng.normal(size=cfg.d)).astype(np.float32)
            convs[c, t] = q
            conv_topics[c, t] = topic
    return convs, conv_topics


def make_workload(cfg: WorkloadConfig) -> Workload:
    rng = np.random.default_rng(cfg.seed)
    centers = _normalize(rng.normal(size=(cfg.n_topics, cfg.d))
                         ).astype(np.float32)
    doc_topic = rng.choice(cfg.n_topics, size=cfg.n_docs,
                           p=_popularity(cfg.n_topics)).astype(np.int32)
    docs = _normalize(centers[doc_topic]
                      + cfg.doc_spread * rng.normal(
                          size=(cfg.n_docs, cfg.d))).astype(np.float32)
    convs, conv_topics = _conversations(rng, cfg, centers)

    # graded qrels from exhaustive search (grade bands 3 / 2 / 1)
    qrels: Dict[Tuple[int, int], Dict[int, int]] = {}
    flat_q = convs.reshape(-1, cfg.d)
    scores = flat_q @ docs.T                       # (Q, n_docs)
    top20 = np.argsort(-scores, axis=-1)[:, :20]
    for qi in range(flat_q.shape[0]):
        c, t = divmod(qi, cfg.turns_per_conversation)
        grades: Dict[int, int] = {}
        for r, doc in enumerate(top20[qi]):
            grades[int(doc)] = 3 if r < 3 else (2 if r < 10 else 1)
        qrels[(c, t)] = grades
    return Workload(docs, doc_topic, centers, convs, conv_topics, qrels)


def make_device_corpus(cfg: WorkloadConfig, device, *,
                       chunk: int = 1 << 20) -> DeviceCorpus:
    """The workload's corpus and conversations, documents drawn on
    ``device`` ``chunk`` rows at a time (no host copy of the corpus)."""
    rng = np.random.default_rng(cfg.seed)
    centers = _normalize(rng.normal(size=(cfg.n_topics, cfg.d))
                         ).astype(np.float32)
    convs, conv_topics = _conversations(rng, cfg, centers)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    pop = torch.as_tensor(_popularity(cfg.n_topics), dtype=torch.float32,
                          device=device)
    doc_topic = torch.multinomial(pop, cfg.n_docs, replacement=True,
                                  generator=gen)
    c = torch.as_tensor(centers, device=device)
    docs = torch.empty((cfg.n_docs, cfg.d), dtype=torch.float32,
                       device=device)
    for s in range(0, cfg.n_docs, chunk):
        e = min(cfg.n_docs, s + chunk)
        x = torch.randn((e - s, cfg.d), generator=gen, device=device)
        x.mul_(cfg.doc_spread).add_(c[doc_topic[s:e]])
        docs[s:e] = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    return DeviceCorpus(docs, doc_topic, centers, convs, conv_topics)


# ---------------------------------------------------------------------------
# IR metrics (MRR@k, NDCG@k — the paper's Table 1 metrics)
# ---------------------------------------------------------------------------

def mrr_at_k(ranked: np.ndarray, grades: Dict[int, int], k: int = 10,
             min_grade: int = 2) -> float:
    for r, doc in enumerate(ranked[:k]):
        if grades.get(int(doc), 0) >= min_grade:
            return 1.0 / (r + 1)
    return 0.0


def ndcg_at_k(ranked: np.ndarray, grades: Dict[int, int], k: int = 10
              ) -> float:
    dcg = sum((2 ** grades.get(int(doc), 0) - 1) / np.log2(r + 2)
              for r, doc in enumerate(ranked[:k]))
    ideal = sorted(grades.values(), reverse=True)[:k]
    idcg = sum((2 ** g - 1) / np.log2(r + 2) for r, g in enumerate(ideal))
    return float(dcg / idcg) if idcg > 0 else 0.0


def evaluate_run(run: np.ndarray, workload: Workload, k: int = 10
                 ) -> Dict[str, float]:
    """run: (n_conv, turns, ≥k) ranked doc ids → averaged metrics."""
    n_conv, turns, _ = run.shape
    mrr, n3, n10 = [], [], []
    for c in range(n_conv):
        for t in range(turns):
            g = workload.qrels[(c, t)]
            mrr.append(mrr_at_k(run[c, t], g, 10))
            n3.append(ndcg_at_k(run[c, t], g, 3))
            n10.append(ndcg_at_k(run[c, t], g, 10))
    return {"mrr@10": float(np.mean(mrr)), "ndcg@3": float(np.mean(n3)),
            "ndcg@10": float(np.mean(n10))}
