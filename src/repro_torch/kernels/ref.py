"""Plain PyTorch versions of the port's kernels (float32).

Mirror ``repro/kernels/ref.py``: ``fused_turn_ivf`` / ``fused_scan_ivf``
(:182-263, ``precision="f32"``: centroid scores → top ``nprobe`` →
gather of the probed lists → masked scores → top-k in ``lax.top_k``
order) and the IVF-PQ oracles ``pq_adc_scan_batch`` (:92),
``fused_turn_pq`` (:213) and ``fused_scan_pq`` (:266): ADC scores of the
probed lists' uint8 codes → top ``r`` → exact re-rank of those ``r``
against the float corpus → top-k.  The CPU runs these;
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Every score is a per-row matrix–vector product (``gemv_rows``): one
query at a time, with the same operand shapes at any batch size, so a
row reduces in the same order whether it is served alone or in a batch
— the port's form of the reference's batch-size-stable broadcast
(``repro/core/toploc.py:78-95``).

An ADC score is summed over the subquantizers in order, ``acc = 0;
acc += lut[j, code_j]`` for j = 0..m-1 in float32 (``adc_sum``): the
order of the Pallas kernels (one one-hot dot per subquantizer,
``repro/kernels/pq_adc.py:59-64``) and of the CUDA kernels, so ADC
candidate sets agree bit for bit on the card.

Unlike the reference oracle, whose positions are undefined where a
value is ``-inf``, the pads here carry the kernels' convention
``(-inf, -1, PAD_POS)``, so kernel and plain version agree bit for bit
on every lane.  After an exact re-rank the position is the candidate's
ADC rank, on every lane, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.topk import topk
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gemv_rows(mat: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, n) scores, row b = ``mat @ q_b`` for a shared (n, d) ``mat``
    or ``mat[b] @ q_b`` for a per-row (B, n, d) one — one matrix–vector
    product per row, so each row's result is independent of B."""
    rows = [(mat if mat.dim() == 2 else mat[b]) @ queries[b]
            for b in range(queries.shape[0])]
    if not rows:
        n = mat.shape[-2]
        return queries.new_empty((0, n))
    return torch.stack(rows)


def list_scores(queries: torch.Tensor, list_vecs: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
    """Scores of every slot of the probed lists, (B, nprobe·lmax), flat
    position ``probe·lmax + offset``."""
    d = list_vecs.shape[-1]
    rows = [list_vecs[sel[b]].reshape(-1, d) @ queries[b]
            for b in range(queries.shape[0])]
    if not rows:
        return queries.new_empty((0, sel.shape[1] * list_vecs.shape[1]))
    return torch.stack(rows)


def fused_scan_ivf(queries: torch.Tensor, list_vecs: torch.Tensor,
                   list_ids: torch.Tensor, sel: torch.Tensor,
                   own: Optional[torch.Tensor], *, k: int) -> Triple:
    """Plain version of the fused IVF scan: (values (B, k), ids (B, k),
    flat positions (B, k)), int32 ids/positions."""
    b = queries.shape[0]
    ids = list_ids[sel]                                  # (B, np, lmax)
    if own is not None:
        ids = torch.where(own[..., None] > 0, ids, -1)
    flat_i = ids.reshape(b, -1)
    flat_v = torch.where(flat_i >= 0, list_scores(queries, list_vecs, sel),
                         float("-inf"))
    v, pos = topk(flat_v, k)
    i = flat_i.gather(-1, pos)
    pos = torch.where(torch.isneginf(v), PAD_POS, pos)
    return v, i.to(torch.int32), pos.to(torch.int32)


def fused_turn_ivf(queries: torch.Tensor, centroids: torch.Tensor,
                   list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
                   nprobe: int, k: int) -> Triple:
    """Plain version of the whole IVF turn: (values (B, k), ids (B, k),
    sel (B, nprobe)), int32 ids/sel."""
    _, sel = topk(gemv_rows(centroids, queries), nprobe)
    sel = sel.to(torch.int32)
    v, i, _ = fused_scan_ivf(queries, list_vecs, list_ids, sel, None, k=k)
    return v, i, sel


# ---------------------------------------------------------------------------
# IVF-PQ: ADC scan of uint8 codes + exact re-rank
# ---------------------------------------------------------------------------


def adc_sum(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) ADC scores: ``sum_j tables[b, j, codes[b, n, j]]`` for
    tables (B, m, n_codes) f32 and codes (B, N, m), summed over j in
    order in float32."""
    b, n, m = codes.shape
    idx = codes.long()
    acc = tables.new_zeros((b, n))
    for j in range(m):
        acc = acc + tables[:, j, :].gather(1, idx[:, :, j])
    return acc


def _probed_adc(tables: torch.Tensor, list_codes: torch.Tensor,
                list_ids: torch.Tensor, sel: torch.Tensor,
                own: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked ADC scores and ids of every slot of the probed lists,
    (B, nprobe·lmax) at flat position ``probe·lmax + offset``."""
    b = sel.shape[0]
    sel = sel.long()
    ids = list_ids[sel]                                  # (B, np, lmax)
    if own is not None:
        ids = torch.where(own[..., None] > 0, ids, -1)
    flat_i = ids.reshape(b, -1)
    codes = list_codes[sel].reshape(b, flat_i.shape[1], -1)
    flat_v = torch.where(flat_i >= 0, adc_sum(tables, codes),
                         float("-inf"))
    return flat_v, flat_i


def _top_candidates(flat_v: torch.Tensor, flat_i: torch.Tensor, r: int
                    ) -> Triple:
    """Top ``r`` (values, ids, flat positions) in ``lax.top_k`` order,
    pads ``(-inf, -1, PAD_POS)``, also where ``r`` exceeds the slots."""
    short = r - flat_v.shape[1]
    if short > 0:
        flat_v = torch.cat([flat_v, flat_v.new_full((flat_v.shape[0], short),
                                                    float("-inf"))], -1)
        flat_i = torch.cat([flat_i, flat_i.new_full((flat_i.shape[0], short),
                                                    -1)], -1)
    v, pos = topk(flat_v, r)
    i = flat_i.gather(-1, pos)
    pos = torch.where(torch.isneginf(v), PAD_POS, pos)
    return v, i.to(torch.int32), pos.to(torch.int32)


def rerank_exact(queries: torch.Tensor, corpus: torch.Tensor,
                 cand_i: torch.Tensor, k: int) -> Triple:
    """Exact top-k of the candidates ``cand_i`` (B, r) (-1 = pad), each
    row scored against the float corpus by one matrix–vector product per
    query: (values (B, k), ids (B, k), ADC ranks (B, k))."""
    rows = corpus[cand_i.long().clamp_min(0)]            # (B, r, d)
    exact = torch.where(cand_i >= 0, gemv_rows(rows, queries),
                        float("-inf"))
    v, rank = topk(exact, k)
    return v, cand_i.gather(-1, rank), rank.to(torch.int32)


def pq_adc_scan_batch(tables: torch.Tensor, list_codes: torch.Tensor,
                      list_ids: torch.Tensor, sel: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ADC scan: the ADC top-k (values (B, k),
    int32 ids (B, k)) of the probed lists ``sel`` (B, nprobe)."""
    v, i, _ = _top_candidates(*_probed_adc(tables, list_codes, list_ids,
                                           sel, None), k)
    return v, i


def fused_scan_pq(tables: torch.Tensor, queries: torch.Tensor,
                  list_codes: torch.Tensor, list_ids: torch.Tensor,
                  sel: torch.Tensor, own: Optional[torch.Tensor],
                  corpus: torch.Tensor, *, k: int, r: int, rerank: bool
                  ) -> Triple:
    """Plain version of the fused PQ scan.  With ``rerank``: the exact
    top-k of the ADC top ``r`` (values, ids, ADC ranks); without: the
    ADC top ``r`` with flat positions (``queries``/``corpus`` unused)."""
    cv, ci, cp = _top_candidates(*_probed_adc(tables, list_codes, list_ids,
                                              sel, own), r)
    if not rerank:
        return cv, ci, cp
    return rerank_exact(queries, corpus, ci, k)


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, k: int, r: int) -> Triple:
    """Plain version of the whole IVF-PQ turn: (values (B, k), ids
    (B, k), sel (B, nprobe)), int32 ids/sel."""
    _, sel = topk(gemv_rows(centroids, queries), nprobe)
    sel = sel.to(torch.int32)
    v, i, _ = fused_scan_pq(tables, queries, list_codes, list_ids, sel,
                            None, corpus, k=k, r=r, rerank=True)
    return v, i, sel
