"""Plain PyTorch versions of the port's kernels.

Mirror ``repro/kernels/ref.py``: ``fused_turn_ivf`` / ``fused_scan_ivf``
(:182-263: centroid scores → top ``nprobe`` → gather of the probed
lists → masked scores → top-k in ``lax.top_k`` order) and the IVF-PQ
oracles ``pq_adc_scan_batch`` (:92), ``fused_turn_pq`` (:213) and
``fused_scan_pq`` (:266): ADC scores of the probed lists' uint8 codes →
top ``r`` → exact re-rank of those ``r`` against the float corpus →
top-k.  The CPU runs these; ``chip_smoke.py`` holds the CUDA kernels
against them on the card.

The fused ops take the reference's ``precision`` (``score_tile`` /
``adc_score_tile``, ``repro/kernels/fused_turn.py:81-150``).  "bf16"
rounds both operands to bfloat16 (nearest even) and sums their exact
products in float32.  "int8" quantises symmetrically (``quantize_sym``:
scale = 127 / max(amax, 1e-30), round half to even, clip to ±127), the
query with one scale per row and the scored operand with one scale per
group of ``tiling.centroid_groups`` / ``tiling.list_groups`` (the
reference's tiles), the ADC table with one scale per query; the
integer dot is exact (summed here in float64) and dequantised as
``f32(acc) / (sq · st)`` (ADC: ``/ st``).  A quantised IVF scan keeps
the top ``r = k·over`` candidates by (quantised score desc, flat
position asc) and re-ranks them in float32 from the list rows
(``rerank_lists``): top k by (exact score desc, candidate rank asc),
position = candidate rank.  Quantised PQ changes only the ADC scores.

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

``centroid_topk`` and ``ivf_scan_batch`` are the plain versions of the
standalone centroid top-k and list scan (``repro/kernels/ref.py:21-65``):
float32 scores (bfloat16 operands widened) of every centroid, or of
every slot of the probed lists with -1 pads at -inf, then the top-k in
``lax.top_k`` order; a pad slot keeps its id -1.

``mha_attention`` is the plain version of the flash attention kernel
(``repro/kernels/ref.py:317-346``): the full (S, Skv) score matrix,
float32 softmax, bottom-right causal mask.

``decode_attention`` is the plain version of the flash decode kernel
(``repro/kernels/ref.py:347-365``): one query token per row against a
KV cache, positions >= ``cache_len`` masked, float32 softmax.

``hnsw_search`` is the plain version of the HNSW search kernel
(``csrc/hnsw_search.cu``), the reference's XLA traversal
``repro/core/hnsw.py`` ``_search_impl``, batched over queries; its
scorer is the ``dots_at`` seam of ``hnsw_dots``.

``embedding_bag`` is the plain version of the EmbeddingBag kernel
(``repro/kernels/ref.py:435-456``), summed in the Pallas kernel's order:
sequential over the bag, ``acc = acc + row * w`` in float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.topk import topk
from repro_torch.kernels import tiling
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


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """127 / max(amax, 1e-30), one IEEE divide (``127.0 / t`` in torch
    is ``t.reciprocal() * 127``, which rounds twice)."""
    return torch.full_like(amax, 127.0) / amax.clamp_min(1e-30)


def group_amax(x: torch.Tensor, blk: int, n_groups: int) -> torch.Tensor:
    """Plain version of the one-time int8 scale pass (csrc/fused_turn.cu
    ``group_amax``, kept per index by ``ops.group_scales``): the largest
    |x| of each group of ``blk`` rows of each set of ``x`` (n_sets,
    set_rows, d), (n_sets, n_groups) float32; rows past set_rows (the
    reference's zero padding) count as 0.  The kernel returns the same
    values as int32 bits."""
    n_sets, rows, _ = x.shape
    if blk < 1 or n_groups * blk < rows:
        raise ValueError(f"{n_groups} groups of {blk} rows do not cover "
                         f"{rows} rows")
    a = x.abs().amax(-1)
    a = torch.cat([a, a.new_zeros((n_sets, n_groups * blk - rows))], 1)
    return a.reshape(n_sets, n_groups, blk).amax(-1)


def quantize_sym(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation over ``dims``: (integer values as
    float32, scale), ``repro/kernels/fused_turn.py:81`` ``quantize_sym``."""
    scale = int8_scale(x.abs().amax(dim=dims, keepdim=True))
    return torch.round(x * scale).clamp(-127.0, 127.0), scale


def _int_dots(mat: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``gemv_rows`` of integer-valued operands, exact (float64), as
    float32: the int32 dot of the kernels, rounded once."""
    return gemv_rows(mat.double(), queries.double()).to(torch.float32)


def centroid_scores(queries: torch.Tensor, centroids: torch.Tensor,
                    precision: str, np_pad: int) -> torch.Tensor:
    """(B, p) stage-1 scores under ``precision``; int8 groups the
    centroids by ``tiling.centroid_groups(p, np_pad)``."""
    if precision == "f32":
        return gemv_rows(centroids, queries)
    if precision == "bf16":
        return gemv_rows(bf16_round(centroids), bf16_round(queries))
    p, d = centroids.shape
    blk, ng = tiling.centroid_groups(p, np_pad)
    amax = torch.stack([centroids[g * blk:(g + 1) * blk].abs().amax()
                        for g in range(ng)])
    st = int8_scale(amax).repeat_interleave(blk)[:p]
    qi, sq = quantize_sym(queries, (1,))
    ti = torch.round(centroids * st[:, None]).clamp(-127.0, 127.0)
    return _int_dots(ti, qi) / (sq * st[None])


def list_scores(queries: torch.Tensor, list_vecs: torch.Tensor,
                sel: torch.Tensor, precision: str = "f32",
                r_pad: int = 1) -> torch.Tensor:
    """Scores of every slot of the probed lists, (B, nprobe·lmax), flat
    position ``probe·lmax + offset``, under ``precision``; int8 groups
    each list's rows by ``tiling.list_groups(lmax, d, r_pad)``."""
    b, (_, lmax, d) = queries.shape[0], list_vecs.shape
    if b == 0:
        return queries.new_empty((0, sel.shape[1] * lmax))
    if precision == "int8":
        blk, ng = tiling.list_groups(lmax, d, r_pad)
        qi, sq = quantize_sym(queries, (1,))
    rows = []
    for row in range(b):
        lv = list_vecs[sel[row].long()]                   # (np, lmax, d)
        if precision == "f32":      # (bf16 lists of ivf_scan widen here)
            rows.append(lv.float().reshape(-1, d) @ queries[row])
        elif precision == "bf16":
            rows.append(bf16_round(lv).reshape(-1, d)
                        @ bf16_round(queries[row]))
        else:
            amax = torch.stack([lv[:, g * blk:(g + 1) * blk].abs()
                                .amax((1, 2)) for g in range(ng)], 1)
            st = int8_scale(amax).repeat_interleave(blk, 1)[:, :lmax]
            ti = torch.round(lv * st[..., None]).clamp(-127.0, 127.0)
            acc = _int_dots(ti.reshape(1, -1, d), qi[row:row + 1])[0]
            rows.append(acc / (sq[row] * st.reshape(-1)))
    return torch.stack(rows)


def centroid_topk(queries: torch.Tensor, centroids: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the centroid top-k: (values (B, k) float32, ids
    (B, k) int32), (score desc, index asc)."""
    v, i = topk(centroid_scores(queries.float(), centroids.float(), "f32",
                                1), k)
    return v, i.to(torch.int32)


def ivf_scan_batch(queries: torch.Tensor, list_vecs: torch.Tensor,
                   list_ids: torch.Tensor, sel: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the probed-list scan: (values (B, k) float32,
    doc ids (B, k) int32), (score desc, flat position asc)."""
    flat_i = list_ids[sel.long()].reshape(sel.shape[0], -1)
    flat_v = torch.where(flat_i >= 0,
                         list_scores(queries.float(), list_vecs, sel),
                         float("-inf"))
    v, pos = topk(flat_v, k)
    return v, flat_i.gather(-1, pos).to(torch.int32)


def fused_scan_ivf(queries: torch.Tensor, list_vecs: torch.Tensor,
                   list_ids: torch.Tensor, sel: torch.Tensor,
                   own: Optional[torch.Tensor], *, k: int,
                   precision: str = "f32", r: Optional[int] = None
                   ) -> Triple:
    """Plain version of the fused IVF scan: (values (B, k), ids (B, k),
    flat positions (B, k)), int32 ids/positions.  Quantised: the exact
    top-k of the top ``r`` candidates, positions = candidate ranks."""
    b = queries.shape[0]
    ids = list_ids[sel.long()]                           # (B, np, lmax)
    if own is not None:
        ids = torch.where(own[..., None] > 0, ids, -1)
    flat_i = ids.reshape(b, -1)
    r_pad = tiling.next_pow2(r or k)
    flat_v = torch.where(flat_i >= 0,
                         list_scores(queries, list_vecs, sel, precision,
                                     r_pad), float("-inf"))
    if precision != "f32":
        _, ci, cp = _top_candidates(flat_v, flat_i, r)
        return rerank_lists(queries, list_vecs, sel, ci, cp, k)
    v, pos = topk(flat_v, k)
    i = flat_i.gather(-1, pos)
    pos = torch.where(torch.isneginf(v), PAD_POS, pos)
    return v, i.to(torch.int32), pos.to(torch.int32)


def fused_turn_ivf(queries: torch.Tensor, centroids: torch.Tensor,
                   list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
                   nprobe: int, k: int, precision: str = "f32",
                   r: Optional[int] = None) -> Triple:
    """Plain version of the whole IVF turn: (values (B, k), ids (B, k),
    sel (B, nprobe)), int32 ids/sel."""
    _, sel = topk(centroid_scores(queries, centroids, precision,
                                  tiling.next_pow2(nprobe)), nprobe)
    sel = sel.to(torch.int32)
    v, i, _ = fused_scan_ivf(queries, list_vecs, list_ids, sel, None, k=k,
                             precision=precision, r=r)
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


def adc_tables(tables: torch.Tensor, precision: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LUTs an ADC sum reads under ``precision`` and the divisor of
    the sum: f32 as they are; bf16 rounded; int8 quantised with one
    scale per (m, n_codes) table (its integer sums are exact in f32,
    ``repro/kernels/fused_turn.py:117`` ``adc_score_tile``)."""
    one = tables.new_ones((tables.shape[0], 1))
    if precision == "f32":
        return tables, one
    if precision == "bf16":
        return bf16_round(tables), one
    ti, st = quantize_sym(tables, (1, 2))
    return ti, st.reshape(-1, 1)


def _probed_adc(tables: torch.Tensor, list_codes: torch.Tensor,
                list_ids: torch.Tensor, sel: torch.Tensor,
                own: Optional[torch.Tensor], precision: str = "f32"
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
    lut, div = adc_tables(tables, precision)
    acc = adc_sum(lut, codes)
    flat_v = torch.where(flat_i >= 0, acc if precision != "int8"
                         else acc / div, float("-inf"))
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


def _rerank_rows(queries: torch.Tensor, rows: torch.Tensor,
                 cand_i: torch.Tensor, k: int) -> Triple:
    """Exact top-k of the candidates ``cand_i`` (B, r) (-1 = pad) with
    their float rows (B, r, d), one matrix–vector product per query:
    (values (B, k), ids (B, k), candidate ranks (B, k))."""
    exact = torch.where(cand_i >= 0, gemv_rows(rows, queries),
                        float("-inf"))
    v, rank = topk(exact, k)
    return v, cand_i.gather(-1, rank), rank.to(torch.int32)


def rerank_exact(queries: torch.Tensor, corpus: torch.Tensor,
                 cand_i: torch.Tensor, k: int) -> Triple:
    """Exact top-k of the candidates ``cand_i`` (B, r) (-1 = pad), each
    row scored against the float corpus: (values (B, k), ids (B, k), ADC
    ranks (B, k))."""
    return _rerank_rows(queries, corpus[cand_i.long().clamp_min(0)],
                        cand_i, k)


def rerank_lists(queries: torch.Tensor, list_vecs: torch.Tensor,
                 sel: torch.Tensor, cand_i: torch.Tensor,
                 cand_p: torch.Tensor, k: int) -> Triple:
    """Exact top-k of IVF candidates at flat positions ``cand_p`` (B, r):
    each row read from the float lists at ``(sel[b, pos // lmax], pos %
    lmax)`` (``repro/kernels/fused_turn.py:311-316``)."""
    lmax = list_vecs.shape[1]
    pos = torch.where(cand_i >= 0, cand_p, 0).long()
    lists = sel.long().gather(1, pos // lmax)
    return _rerank_rows(queries, list_vecs[lists, pos % lmax], cand_i, k)


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
                  corpus: torch.Tensor, *, k: int, r: int, rerank: bool,
                  precision: str = "f32") -> Triple:
    """Plain version of the fused PQ scan.  With ``rerank``: the exact
    top-k of the ADC top ``r`` (values, ids, ADC ranks); without: the
    ADC top ``r`` with flat positions (``queries``/``corpus`` unused)."""
    cv, ci, cp = _top_candidates(*_probed_adc(tables, list_codes, list_ids,
                                              sel, own, precision), r)
    if not rerank:
        return cv, ci, cp
    return rerank_exact(queries, corpus, ci, k)


def fused_turn_pq(queries: torch.Tensor, centroids: torch.Tensor,
                  tables: torch.Tensor, list_codes: torch.Tensor,
                  list_ids: torch.Tensor, corpus: torch.Tensor, *,
                  nprobe: int, k: int, r: int, precision: str = "f32"
                  ) -> Triple:
    """Plain version of the whole IVF-PQ turn: (values (B, k), ids
    (B, k), sel (B, nprobe)), int32 ids/sel."""
    _, sel = topk(centroid_scores(queries, centroids, precision,
                                  tiling.next_pow2(nprobe)), nprobe)
    sel = sel.to(torch.int32)
    v, i, _ = fused_scan_pq(tables, queries, list_codes, list_ids, sel,
                            None, corpus, k=k, r=r, rerank=True,
                            precision=precision)
    return v, i, sel


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a plain version accumulates in: float32 for float32,
    bfloat16 and float16 inputs (the reference's), float64 for float64
    ones (the gradient checks' finite differences need it)."""
    return torch.promote_types(dtype, torch.float32)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Plain attention. q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv,
    Skv, Dv); Hkv divides H; returns (B, H, S, Dv) in q's dtype.

    ``repro/kernels/ref.py:317-346``: the softmax accumulates in float32
    whatever the input dtype (float64 inputs in float64, ``acc_dtype``),
    and causal masking is bottom-right (the queries are the last S
    positions of the Skv timeline).
    """
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    acc = acc_dtype(q.dtype)
    qg = q.to(acc).reshape(b, hkv, h // hkv, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg, k.to(acc)) / math.sqrt(d)
    if causal:
        qpos = torch.arange(s, device=q.device) + (skv - s)
        kpos = torch.arange(skv, device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.to(acc))
    return out.reshape(b, h, s, dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain single-token decode attention.  q (B, H, D), k (B, Hkv, S,
    D), v (B, Hkv, S, Dv); Hkv divides H; ``cache_len`` (B,) masks
    positions >= cache_len.  Returns (B, H, Dv) in q's dtype.

    ``repro/kernels/ref.py:347-365``: float32 einsums over the cache in
    its own dtype cast up, masked logits -inf, float32 softmax.
    """
    b, h, d = q.shape
    hkv, s, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg, k.float()) / math.sqrt(d)
    if cache_len is not None:
        mask = torch.arange(s, device=q.device)[None] < cache_len[:, None]
        logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", probs, v.float())
    return out.reshape(b, h, dv).to(q.dtype)


#: above CHUNK_THRESHOLD² scores the plain attention streams the keys
#: (``repro/kernels/ops.py:297-314`` ``_CHUNK_THRESHOLD``)
CHUNK_THRESHOLD = 2048


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, blk_kv: int = 1024
                      ) -> torch.Tensor:
    """``mha_attention`` over tiles of ``blk_kv`` keys with an online
    softmax, never holding the (S, Skv) score matrix
    (``repro/kernels/ref.py:368``): the queries scaled by 1 / sqrt(D)
    before the dot, keys padded to whole tiles and masked, a row with
    nothing to attend to yet carried as m = -inf, output acc / max(l,
    1e-30), everything in float32 (float64 for float64 inputs)."""
    b, h, s, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // hkv
    nblk = -(-skv // blk_kv)
    pad = nblk * blk_kv - skv
    fdt = acc_dtype(q.dtype)
    kf = torch.nn.functional.pad(k.to(fdt), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(fdt), (0, 0, 0, pad))
    qg = q.to(fdt).reshape(b, hkv, group, s, d) * (1.0 / d ** 0.5)
    qpos = torch.arange(s, device=q.device) + (skv - s)
    m = torch.full((b, hkv, group, s), float("-inf"), dtype=fdt,
                   device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=fdt, device=q.device)
    acc = torch.zeros((b, hkv, group, s, dv), dtype=fdt, device=q.device)
    for j in range(nblk):
        kj = kf[:, :, j * blk_kv:(j + 1) * blk_kv]
        vj = vf[:, :, j * blk_kv:(j + 1) * blk_kv]
        sco = torch.einsum("bhgsd,bhtd->bhgst", qg, kj)
        kpos = j * blk_kv + torch.arange(blk_kv, device=q.device)
        valid = (kpos < skv)[None, :]
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        sco = sco.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, sco.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sco - m_safe[..., None]).masked_fill(~valid, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhtd->bhgsd", p,
                                                     vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s, dv).to(q.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """The plain version of ``flash_attention`` (``repro/kernels/ops.py``
    ``_ref_attention``): ``chunked_attention`` above CHUNK_THRESHOLD²
    scores, else ``mha_attention``."""
    if q.shape[2] * k.shape[2] > CHUNK_THRESHOLD ** 2:
        return chunked_attention(q, k, v, causal=causal)
    return mha_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over fixed-width bags: table (V, d), ids (B, L) int
    (negative = pad), weights (B, L) or None; returns (B, d) in the
    table's dtype.  mode "sum" or "mean" (``bag_mean``).

    The sum runs in float32 (float64 for a float64 table) and in bag
    order, one product and one sum per step (``embedding_bag.py:28-42``'s
    ``acc + row * valid``), so it rounds as the Pallas and CUDA kernels
    do.  A pad adds ``row * 0``
    (±0), which leaves the sum as it is: the kernel skips it.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    f = acc_dtype(table.dtype)
    w = _bag_weights(ids, weights).to(f)
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=f,
                      device=table.device)
    for l in range(ids.shape[1]):
        rows = table[ids[:, l].clamp_min(0).long()].to(f)
        acc = acc + rows * w[:, l, None]
    if mode == "mean":
        acc = bag_mean(acc, ids, weights)
    return acc.to(table.dtype)


def _bag_weights(ids: torch.Tensor, weights: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if weights is None:
        return (ids >= 0).to(torch.float32)
    f = acc_dtype(weights.dtype)
    return (ids >= 0).to(f) * weights.to(f)


def bag_mean(total: torch.Tensor, ids: torch.Tensor,
             weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's mean rule (``repro/kernels/ops.py:392-398``): a
    bag's float32 sum over max(Σ mask·w, 1)."""
    return total / _bag_weights(ids, weights).sum(-1, keepdim=True
                                                   ).clamp_min(1.0)


def hnsw_dots(vectors: torch.Tensor):
    """The default ``dots_at`` factory of ``hnsw_search`` (the
    reference's ``_gather_dots``): ``factory(queries (B, d))`` returns
    ``dots_at(ids (B, m)) -> (B, m)``, each id's row gathered and scored
    against its row's query by an explicit multiply and a sum over d.
    The sum reduces each (row, id) alone, in an order set by d only, so
    a query's scores do not depend on B.  The sharded scorer
    (``hnsw_sharded_dots``) plugs in here and reuses the traversal."""
    def factory(queries: torch.Tensor):
        def dots_at(ids: torch.Tensor) -> torch.Tensor:
            return (vectors[ids.long()] * queries[:, None, :]).sum(-1)
        return dots_at
    return factory


def hnsw_sharded_dots(parts, n_local: int):
    """A ``dots_at`` factory over row-sharded vectors (shard s holds rows
    [s·n_local, s·n_local + len(parts[s]))): each shard scores the ids it
    owns with ``hnsw_dots``' multiply and sum and gives exact zeros
    elsewhere, and the scores are summed in shard order on the queries'
    device — the reference's owner-computes ``psum``
    (``repro/distributed/retrieval.py:372-427``), which turns -0.0 into
    +0.0 and changes nothing else.  The plain version of the kernel's
    sharded instance."""
    def factory(queries: torch.Tensor):
        qs = [queries.to(p.device) for p in parts]

        def dots_at(ids: torch.Tensor) -> torch.Tensor:
            total = None
            for s, (part, q) in enumerate(zip(parts, qs)):
                loc = ids.to(part.device).long() - s * n_local
                own = (loc >= 0) & (loc < part.shape[0])
                if part.shape[0]:
                    rows = part[loc.clamp(0, part.shape[0] - 1)]
                    dot = (rows * q[:, None, :]).sum(-1)
                else:
                    dot = q.new_zeros(ids.shape)
                dot = torch.where(own, dot, 0.0).to(queries.device)
                total = dot if total is None else total + dot
            return total
        return dots_at
    return factory


def hnsw_search(vectors: torch.Tensor, adj0: torch.Tensor,
                upper_adj: torch.Tensor, entry_point: torch.Tensor,
                queries: torch.Tensor,
                entry_override: Optional[torch.Tensor] = None, *, ef: int,
                k: int, deleted: Optional[torch.Tensor] = None,
                dots_factory=None) -> Triple:
    """Plain version of the HNSW search kernel: the reference's
    ``_search_impl`` (``repro/core/hnsw.py:349-388``) for B queries at
    once, its ``vmap`` + ``while_loop`` a batch with a per-row "still
    going" mask (one host sync a step for the loop's test).

    Without ``entry_override`` (B,) the greedy descent runs from
    ``entry_point`` through the upper levels (argmax over a node's
    neighbours, ties to the first, moving only on a strictly larger
    score); then the level-0 beam of ``ef`` entries starts there: each
    step expands the best unexpanded entry (``argmax``, ties to the
    first), scores the neighbours that are real and not yet visited,
    marks them, and keeps the best ``ef`` of [beam; new] by
    ``core.topk.topk`` (``lax.top_k``'s order), the expanded flags riding
    along, until the reference's stop test or ``4 ef + 16`` steps.
    ``deleted`` ids score -inf at the end.  Returns (scores (B, k), ids
    (B, k) int32, ndist (B,) int32)."""
    b, dev = queries.shape[0], queries.device
    n = adj0.shape[0]
    ninf = float("-inf")
    dots_at = (dots_factory or hnsw_dots(vectors))(queries)
    rows = torch.arange(b, device=dev)
    ndist = torch.zeros(b, dtype=torch.int32, device=dev)
    if entry_override is None:
        cur = entry_point.to(torch.int64).expand(b).clone()
        cur_s = dots_at(cur[:, None])[:, 0]
        ndist += 1
        for lvl in range(upper_adj.shape[0] - 1, -1, -1):
            going = torch.ones(b, dtype=torch.bool, device=dev)
            while bool(going.any()):
                nbrs = upper_adj[lvl][cur].long()             # (B, M)
                valid = nbrs >= 0
                s = torch.where(valid, dots_at(nbrs.clamp_min(0)), ninf)
                j = s.argmax(-1, keepdim=True)
                sj = s.gather(1, j)[:, 0]
                better = going & (sj > cur_s)
                ndist += torch.where(going, valid.sum(-1), 0).to(torch.int32)
                cur = torch.where(better, nbrs.gather(1, j)[:, 0], cur)
                cur_s = torch.where(better, sj, cur_s)
                going = better
        start = cur
    else:
        start = entry_override.to(torch.int64)

    # level 0: a fixed-width beam of ef entries
    max_steps = 4 * ef + 16
    cand_v = torch.full((b, ef), ninf, dtype=torch.float32, device=dev)
    cand_v[:, 0] = dots_at(start[:, None])[:, 0]
    cand_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    cand_i[:, 0] = start.to(torch.int32)
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited[rows, start] = True
    ndist += 1
    step = torch.zeros(b, dtype=torch.int32, device=dev)
    lanes = torch.arange(ef, device=dev)
    while True:
        real = cand_i >= 0
        unexp = ~expanded & real
        best_unexp = torch.where(unexp, cand_v, ninf).amax(-1)
        worst = torch.where(real, cand_v, float("inf")).amin(-1)
        full = real.sum(-1) >= ef
        go = unexp.any(-1) & ~(full & (best_unexp < worst)) & (
            step < max_steps)
        if not bool(go.any()):
            break
        pick = torch.where(unexp, cand_v, ninf).argmax(-1, keepdim=True)
        node = cand_i.gather(1, pick)[:, 0].long().clamp_min(0)
        expanded = expanded | (go[:, None] & (lanes == pick))
        nbrs = adj0[node]                                  # (B, 2M)
        idx = nbrs.long().clamp_min(0)
        ok = (nbrs >= 0) & ~visited.gather(1, idx) & go[:, None]
        s = torch.where(ok, dots_at(idx), ninf)
        ndist += ok.sum(-1).to(torch.int32)
        visited[rows[:, None].expand_as(idx)[ok], idx[ok]] = True
        all_v = torch.cat([cand_v, s], 1)
        all_i = torch.cat([cand_i, torch.where(ok, nbrs, -1)], 1)
        all_e = torch.cat([expanded, torch.zeros_like(ok)], 1)
        top_v, pos = topk(all_v, ef)
        g = go[:, None]
        cand_v = torch.where(g, top_v, cand_v)
        cand_i = torch.where(g, all_i.gather(1, pos), cand_i)
        expanded = torch.where(g, all_e.gather(1, pos), expanded)
        step += go.to(torch.int32)
    if deleted is not None:
        dead = deleted[cand_i.long().clamp_min(0)] & (cand_i >= 0)
        cand_v = torch.where(dead, ninf, cand_v)
    top_v, pos = topk(cand_v, k)
    return top_v, cand_i.gather(1, pos), ndist
