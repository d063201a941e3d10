"""Product quantisation of IVF posting lists (TopLoc_IVFPQ).

Port of ``repro/core/pq.py``.  Each vector is split into ``m``
subspaces of ``d_sub = d / m`` dims, each encoded as one byte: the index
of its nearest of 256 codewords.  A list scan then costs ``m`` lookups
into the query's ``(m, 256)`` ADC table per document instead of a d-dim
dot product, and the top ``R`` ADC candidates are re-ranked exactly
against the float corpus (``IVFPQIndex.doc_vecs``).

The reference's semantics are kept as they are: codebooks are
dot-product Lloyd iterations with k-means++ seeding (``train``), and
encoding is the L2 argmin written as ``c_sq - 2·dots``, first index on
ties (``encode``).  Unlike the reference, ``encode`` is chunked over
points: the reference forms ``(n, m, 256)`` dots, 435 GB at 8.8M × 48.
ADC sums run over the subquantizers in order (``kernels.ref.adc_sum``),
the order of the kernels.

``torch.Generator`` replaces ``jax.random``, so the port's codebooks are
held to the reference by properties; on the reference's codebooks every
other function here is held to it exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import kmeans as _kmeans
from repro_torch.core.topk import topk
from repro_torch.kernels import ref as _ref

#: points per Lloyd chunk of the codebook training (chunk × 256 scores)
TRAIN_CHUNK = 1 << 20
#: points per encode chunk (chunk × m × 256 f32 distances in flight)
ENCODE_CHUNK = 1 << 14


class PQCodebook(NamedTuple):
    codewords: torch.Tensor     # (m, n_codes, d_sub) float32
    m: int = 0                  # static copy of the subspace count

    @property
    def d(self) -> int:
        return self.codewords.shape[0] * self.codewords.shape[2]


def train(vectors: torch.Tensor, m: int, *, iters: int = 8,
          generator: torch.Generator, n_codes: int = 256) -> PQCodebook:
    """Per-subspace k-means codebooks (k-means++ seeding, dot-product
    Lloyd). vectors (n, d), d % m == 0."""
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"d={d} is not a multiple of m={m}")
    d_sub = d // m
    books = []
    for j in range(m):
        sub = vectors[:, j * d_sub:(j + 1) * d_sub].contiguous()
        c, _ = _kmeans.kmeans_fit(sub, n_codes, iters=iters,
                                  generator=generator,
                                  chunk=TRAIN_CHUNK, init="++")
        books.append(c)
    return PQCodebook(torch.stack(books), m)


def encode(book: PQCodebook, vectors: torch.Tensor, *,
           chunk: int = ENCODE_CHUNK) -> torch.Tensor:
    """→ codes (n, m) uint8: nearest codeword per subspace (L2)."""
    n, d = vectors.shape
    m, n_codes, d_sub = book.codewords.shape
    # ||x - c||² = ||x||² - 2<x,c> + ||c||²; argmin over codewords
    c_sq = (book.codewords ** 2).sum(-1)                    # (m, n_codes)
    out = torch.empty((n, m), dtype=torch.uint8, device=vectors.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        subs = vectors[s:e].reshape(e - s, m, d_sub)
        dots = torch.einsum("nmd,mkd->nmk", subs, book.codewords)
        out[s:e] = torch.argmin(c_sq[None] - 2 * dots, dim=-1).to(
            torch.uint8)
    return out


def decode(book: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct (n, d) from (n, m) codes."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)
    return book.codewords[sub[None], codes.long()].reshape(n, -1)


def adc_table(book: PQCodebook, query: torch.Tensor) -> torch.Tensor:
    """Query (d,) → (m, n_codes) inner-product lookup table."""
    m, n_codes, d_sub = book.codewords.shape
    return torch.bmm(book.codewords, query.reshape(m, d_sub, 1))[..., 0]


def adc_scores(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC: approximate <q, x> for encoded docs. codes (n, m) → (n,)."""
    return _ref.adc_sum(table[None], codes[None])[0]


# ---------------------------------------------------------------------------
# IVF-PQ index: IVF geometry + PQ-compressed posting lists
# ---------------------------------------------------------------------------


class IVFPQIndex(NamedTuple):
    """IVF index whose posting lists hold PQ codes instead of floats.

    The bucketed-padded layout of ``ivf.IVFIndex`` with ``m`` uint8 codes
    per list entry; ``doc_vecs`` is the uncompressed collection, the
    source of the exact re-rank of each query's top-R ADC candidates.
    Every field lives on one device.
    """
    centroids: torch.Tensor     # (p, d) float32 — IVF coarse quantiser
    codewords: torch.Tensor     # (m, n_codes, d_sub) — PQ codebooks
    list_codes: torch.Tensor    # (p, Lmax, m) uint8 — PQ-encoded lists
    list_ids: torch.Tensor      # (p, Lmax) int32 — doc ids, -1 = pad
    list_sizes: torch.Tensor    # (p,) int32 — real sizes
    doc_vecs: torch.Tensor      # (n, d) float32 — re-rank source

    @property
    def p(self) -> int:
        return self.centroids.shape[0]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]

    @property
    def m(self) -> int:
        return self.codewords.shape[0]

    @property
    def lmax(self) -> int:
        return self.list_ids.shape[1]

    @property
    def n_docs(self) -> int:
        return int(self.list_sizes.sum())

    @property
    def book(self) -> PQCodebook:
        return PQCodebook(self.codewords, self.codewords.shape[0])

    @property
    def bytes_per_doc(self) -> int:
        """Posting-list payload per document (codes only)."""
        return self.codewords.shape[0]


def build_ivf_pq(index, vectors, book: PQCodebook,
                 device=None) -> IVFPQIndex:
    """PQ-compress the posting lists of a built ``ivf.IVFIndex`` with a
    codebook ``book`` trained before (``train``).

    Encodes every doc and gathers the codes into the index's bucketed
    layout (pad rows hold code 0, masked by ``list_ids == -1``).
    ``centroids``, ``list_ids`` and ``list_sizes`` are the float index's
    own tensors, and ``doc_vecs`` is ``vectors`` itself when that is a
    float32 tensor on ``device`` (default cuda): nothing is copied.  A
    numpy ``vectors`` is copied there.
    """
    dev = _device.resolve(device)
    if isinstance(vectors, np.ndarray):
        vectors = torch.from_numpy(vectors).to(dev)
    _device.require(dev, vectors, index.centroids, book.codewords)
    vectors = vectors.to(torch.float32)
    codes = encode(book, vectors)                           # (n, m) uint8
    real = index.list_ids >= 0
    list_codes = codes[index.list_ids.long().clamp_min(0)]
    list_codes.masked_fill_(~real[..., None], 0)
    return IVFPQIndex(index.centroids, book.codewords, list_codes,
                      index.list_ids, index.list_sizes.to(torch.int32),
                      vectors)


def check_index(index: IVFPQIndex) -> IVFPQIndex:
    """Raise unless every list entry names a codeword of each
    subquantizer and a row of ``doc_vecs``.

    The kernels read the ADC table at each code, and the re-rank reads
    ``doc_vecs`` at each id, without a bound check, so an index that comes
    in from outside (``convert``, a hand-built one) is checked once here,
    never per turn.  uint8 codes always fit 256 codewords.
    """
    n_codes = index.codewords.shape[1]
    if (n_codes < 256 and index.list_codes.numel()
            and int(index.list_codes.max()) >= n_codes):
        raise ValueError(f"list_codes holds a code >= n_codes = {n_codes}")
    if (index.list_ids.numel()
            and int(index.list_ids.max()) >= index.doc_vecs.shape[0]):
        raise ValueError(f"list_ids holds an id >= the "
                         f"{index.doc_vecs.shape[0]} rows of doc_vecs")
    return index


def adc_scores_masked(tables: torch.Tensor, codes: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """ADC scores of pre-gathered candidate blocks, batched and masked.

    tables (B, m, n_codes) f32; codes (B, N, m); ids (B, N) int32 (-1 =
    pad/foreign → -inf).  Returns (B, N) f32, each candidate summed as
    the list scan sums it.
    """
    return torch.where(ids >= 0, _ref.adc_sum(tables, codes), float("-inf"))


def adc_search_lists(book: PQCodebook, query: torch.Tensor,
                     list_codes: torch.Tensor, list_ids: torch.Tensor,
                     sel: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TopLoc+PQ composed: the ADC top-k (values, doc ids) of the
    selected PQ-encoded posting lists. query (d,); sel (np,)."""
    table = adc_table(book, query)                          # (m, n_codes)
    sel = sel.long()
    codes = list_codes[sel]                                 # (np, L, m)
    ids = list_ids[sel].reshape(-1)
    scores = adc_scores_masked(table[None],
                               codes.reshape(1, -1, codes.shape[-1]),
                               ids[None])[0]
    v, pos = topk(scores, k)
    return v, ids[pos]
