"""TopLoc — the paper's session logic, shared by the registered backends.

Port of ``repro/core/toploc.py``:

  * the session states ``IVFSession`` (IVF and IVF-PQ) and
    ``HNSWSession`` (the privileged entry point), and the ``TurnStats``
    work counters of the paper's cost model;
  * the batch-size-stable centroid scoring (``_bcast_centroid_scores``,
    ``make_cache_batch``) and ADC tables (``_adc_tables``) that keep
    sequential and batched serving bit-identical;
  * ``_scan_lists_pq``, the unfused IVF-PQ list scan (ADC scan kernel
    ``kernels.ops.pq_adc_scan`` + exact re-rank);
  * ``FusedTurn``, the plugin that routes IVF / IVF-PQ turns through the
    fused CUDA kernels (``kernels.ops.fused_turn`` / ``fused_scan`` /
    ``fused_turn_pq`` / ``fused_scan_pq``);
  * the drivers ``start / step / plain (+_batch) / conversation``.

PyTorch runs eagerly, so the drivers are plain functions (the
reference jit-compiles one program per backend); ``lax.scan`` becomes a
Python loop.  Each driver takes ``device`` (default cuda, see
``repro_torch.device``) and refuses an index or inputs that live
elsewhere (``index_tensor`` finds the index's device for every index
type: IVF, IVF-PQ, HNSW and Exact's bare corpus).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.core import ivf as _ivf
from repro_torch.core import pq as _pq
from repro_torch.core.topk import topk
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref


class IVFSession(NamedTuple):
    """Per-conversation TopLoc_IVF state (device resident)."""
    cache_ids: torch.Tensor     # (h,) int32 — global centroid ids of C0
    cache_vecs: torch.Tensor    # (h, d)     — gathered centroid vectors
    anchor_sel: torch.Tensor    # (np,) int32 — top_np(q0, C0), for Eq. 1
    refreshes: torch.Tensor     # () int32
    turn: torch.Tensor          # () int32


class HNSWSession(NamedTuple):
    """Per-conversation TopLoc_HNSW state."""
    entry_point: torch.Tensor   # () int32 — privileged entry node
    turn: torch.Tensor          # () int32


class TurnStats(NamedTuple):
    centroid_dists: torch.Tensor  # () int32
    list_dists: torch.Tensor      # () int32 — float doc distances
    graph_dists: torch.Tensor     # () int32
    code_dists: torch.Tensor      # () int32 — PQ ADC evaluations
    i0: torch.Tensor              # () int32 — |I0| (IVF+ only; -1 otherwise)
    refreshed: torch.Tensor       # () bool


def _zero_stats(device=None) -> TurnStats:
    """The counters of a turn that did no backend work (a result-cache
    hit): every count 0, ``i0`` -1, not refreshed."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return TurnStats(z, z, z, z, torch.full((), -1, dtype=torch.int32,
                                            device=device),
                     torch.zeros((), dtype=torch.bool, device=device))


def stack_stats(stats) -> TurnStats:
    """Stack a sequence of per-turn ``TurnStats`` along a new first axis."""
    return TurnStats(*(torch.stack([getattr(s, f) for s in stats])
                       for f in TurnStats._fields))


# ---------------------------------------------------------------------------
# batch-size-stable centroid scoring
#
# A (B, d) @ (d, p) matmul picks its algorithm (and so its reduction
# order) by shape, so scores would drift bitwise with batch size.  Each
# row is instead scored by the same matrix–vector product the
# sequential path runs (``kernels.ref.gemv_rows``): identical operand
# shapes at any B, hence identical bits.
# ---------------------------------------------------------------------------


def _bcast_centroid_scores(centroids: torch.Tensor, q: torch.Tensor
                           ) -> torch.Tensor:
    """(B, p) centroid scores, bit-identical per row to ``centroids @ q_b``."""
    return _kref.gemv_rows(centroids, q)


def make_cache_batch(index: _ivf.IVFIndex, q: torch.Tensor, *, h: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ``ivf.make_cache``: C0 = top_h(q, C) per row. q (B, d)."""
    _, ids = topk(_bcast_centroid_scores(index.centroids, q), h)
    ids = ids.to(torch.int32)
    return ids, index.centroids[ids]


def _adc_tables(index: _pq.IVFPQIndex, q: torch.Tensor) -> torch.Tensor:
    """Per-query ADC lookup tables, (B, m, n_codes).

    Each row is the same (m, n_codes, d_sub) x (m, d_sub, 1) batched
    product at any B (cf. ``_bcast_centroid_scores``), so a row's tables
    are bit-identical whether it is served alone or in a batch.
    """
    m, _, d_sub = index.codewords.shape
    rows = [torch.bmm(index.codewords, q[b].reshape(m, d_sub, 1))[..., 0]
            for b in range(q.shape[0])]
    if not rows:
        return q.new_empty((0,) + index.codewords.shape[:2])
    return torch.stack(rows)


def _scan_lists_pq(index: _pq.IVFPQIndex, q: torch.Tensor,
                   sel: torch.Tensor, k: int, rerank: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """ADC-scan the selected PQ lists, exact-re-rank the top R.

    q (B, d); sel (B, np).  Returns (top_v (B, k), top_i (B, k),
    code_dists (B,), rerank_dists (B,)).  The re-rank is the plain
    per-row matrix–vector product of ``kernels.ref.rerank_exact`` (the
    reference runs it in XLA), so a row's scores do not depend on B.
    """
    r = _kops._fused_depth(k, sel.shape[1] * index.lmax, rerank)
    tables = _adc_tables(index, q)
    _, cand_ids = _kops.pq_adc_scan(tables, index.list_codes,
                                    index.list_ids, sel, r, device=q.device)
    top_v, top_i, _ = _kref.rerank_exact(q, index.doc_vecs, cand_ids, k)
    code_d = index.list_sizes[sel].sum(-1).to(torch.int32)
    rerank_d = (cand_ids >= 0).sum(-1).to(torch.int32)
    return top_v, top_i, code_d, rerank_d


# ---------------------------------------------------------------------------
# fused turn plugin (kernels.fused_turn)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedTurn:
    """Routes IVF and IVF-PQ turns through the fused CUDA kernels.

    The stateless plain turn runs whole in ``ops.fused_turn`` /
    ``ops.fused_turn_pq`` (centroid top-nprobe + list scan, + exact
    re-rank for PQ); sessioned turns keep the centroid cache and the
    Eq. 1 drift check in plain PyTorch (float32 at every precision) and
    scan with ``ops.fused_scan`` / ``ops.fused_scan_pq``.
    ``precision="f32"``: ids, ``sel`` and every ``TurnStats`` counter
    equal the unfused path; scores agree within the summation-order
    tolerance.  ``"bf16"`` / ``"int8"`` score the scan (and the plain
    turn's stage 1) quantised and re-rank the top ``k·over`` IVF
    candidates (PQ: the usual ``rerank``) in float32 inside the kernel,
    so returned scores are exact dots.  The device of the tensors picks
    the path (``kernels.ops``): kernel on CUDA tensors, plain version on
    CPU tensors.
    """

    precision: str = "f32"
    over: int = 2            # quantised IVF candidate depth: r = k·over

    def __post_init__(self):
        _kops.check_precision(self.precision)

    def turn_ivf(self, index: _ivf.IVFIndex, q: torch.Tensor, *,
                 nprobe: int, k: int):
        """Whole turn: returns (v, i, sel, list_dists)."""
        v, i, sel = _kops.fused_turn(
            q, index.centroids, index.list_vecs, index.list_ids,
            nprobe=nprobe, k=k, over=self.over, precision=self.precision,
            device=q.device)
        real = index.list_sizes[sel].sum(-1).to(torch.int32)
        return v, i, sel, real

    def list_scan_ivf(self, index: _ivf.IVFIndex, q: torch.Tensor,
                      sel: torch.Tensor, k: int):
        """Drop-in for ``ivf._scan_lists``: (v, i, real_dists)."""
        v, i, _pos = _kops.fused_scan(
            q, index.list_vecs, index.list_ids, sel, k, over=self.over,
            precision=self.precision, device=q.device)
        real = index.list_sizes[sel].sum(-1).to(torch.int32)
        return v, i, real

    def turn_pq(self, index: _pq.IVFPQIndex, q: torch.Tensor, *,
                nprobe: int, k: int, rerank: int):
        """Whole PQ turn: returns (v, i, sel, code_d, rerank_d)."""
        tables = _adc_tables(index, q)
        v, i, sel = _kops.fused_turn_pq(
            q, index.centroids, tables, index.list_codes, index.list_ids,
            index.doc_vecs, nprobe=nprobe, k=k, rerank=rerank,
            precision=self.precision, device=q.device)
        code_d = index.list_sizes[sel].sum(-1).to(torch.int32)
        # every valid ADC candidate outranks the -inf pads, so the
        # re-ranked count is exactly min(r, candidates available)
        r = _kops._fused_depth(k, nprobe * index.lmax, rerank)
        return v, i, sel, code_d, code_d.clamp(max=r)

    def list_scan_pq(self, index: _pq.IVFPQIndex, q: torch.Tensor,
                     sel: torch.Tensor, k: int, rerank: int):
        """Drop-in for ``_scan_lists_pq``: (v, i, code_d, rerank_d)."""
        tables = _adc_tables(index, q)
        v, i, _rank = _kops.fused_scan_pq(
            tables, q, index.list_codes, index.list_ids, sel,
            index.doc_vecs, k, rerank=rerank, precision=self.precision,
            device=q.device)
        code_d = index.list_sizes[sel].sum(-1).to(torch.int32)
        r = _kops._fused_depth(k, sel.shape[1] * index.lmax, rerank)
        return v, i, code_d, code_d.clamp(max=r)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def index_tensor(index) -> torch.Tensor:
    """A tensor of ``index`` that lies where the whole index does: the
    centroids of an IVF / IVF-PQ index, the vectors of an HNSW index, or
    Exact's index itself, the bare (n, d) corpus."""
    if isinstance(index, torch.Tensor):
        return index
    for field in ("centroids", "vectors"):
        t = getattr(index, field, None)
        if isinstance(t, torch.Tensor):
            return t
    raise TypeError(f"not an index: {type(index).__name__}")


def _on(device, index, *tensors) -> None:
    _device.require(device, index_tensor(index), *tensors)


def start(backend, index, q0: torch.Tensor, *, k: int, device=None):
    """First utterance. q0 (d,). Returns (scores (k,), ids (k,), session,
    stats)."""
    _on(device, index, q0)
    return backend.start(index, q0, k=k)


def step(backend, index, sess, q: torch.Tensor, *, k: int, device=None):
    """Follow-up utterance. Returns (scores, ids, session, stats)."""
    _on(device, index, q)
    return backend.step(index, sess, q, k=k)


def plain(backend, index, q: torch.Tensor, *, k: int, device=None):
    """Stateless baseline turn. q (d,). Returns (scores, ids, stats)."""
    _on(device, index, q)
    return backend.plain(index, q, k=k)


def start_batch(backend, index, q0: torch.Tensor, *, k: int, device=None):
    """B first utterances at once. q0 (B, d)."""
    _on(device, index, q0)
    return backend.start_batch(index, q0, k=k)


def step_batch(backend, index, sess, q: torch.Tensor, *, k: int,
               is_first: Optional[torch.Tensor] = None, device=None):
    """Follow-ups of B concurrent conversations; session fields carry a
    leading batch dim and ``is_first`` ((B,) bool) marks rows that run
    first-turn semantics as a forced refresh."""
    _on(device, index, q)
    return backend.step_batch(index, sess, q, k=k, is_first=is_first)


def plain_batch(backend, index, q: torch.Tensor, *, k: int, device=None):
    """Batched stateless baseline turn. q (B, d)."""
    _on(device, index, q)
    return backend.plain_batch(index, q, k=k)


def conversation(backend, index, utterances: torch.Tensor, *, k: int,
                 mode: str = "toploc", device=None):
    """Run a (T, d) conversation through one strategy.

    mode 'toploc' (sessioned) or 'plain' (stateless, all turns as one
    batch — bit-identical to per-turn dispatch).  Returns (scores (T, k),
    ids (T, k), stats stacked over turns).
    """
    _on(device, index, utterances)
    if mode == "plain":
        return backend.plain_batch(index, utterances, k=k)
    if mode != "toploc":
        raise ValueError(f"mode must be 'toploc' or 'plain', got {mode!r}")
    v0, i0, sess, st0 = backend.start(index, utterances[0], k=k)
    vs, is_, sts = [v0], [i0], [st0]
    for q in utterances[1:]:
        v, i, sess, st = backend.step(index, sess, q, k=k)
        vs.append(v)
        is_.append(i)
        sts.append(st)
    return torch.stack(vs), torch.stack(is_), stack_stats(sts)
