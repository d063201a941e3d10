"""repro_torch IVF index: build, balanced assignment and search paths.

* ``balance_assignment`` is chunked over points in the port (it never
  holds an ``(n, p)`` matrix); on the same points and centroids it must
  give the reference's assignment and sizes exactly, spill and straggler
  fallback included.  Integer-valued inputs keep every similarity exact.
* ``build`` draws its k-means from a ``torch.Generator`` (not the
  reference's bits), so it is held to the layout's properties.
* The search paths run on a ``repro``-built index (the conftest corpus)
  converted to the port: ids / ``sel`` / counters exact, scores within
  1e-5 (XLA-CPU and PyTorch sum in different orders).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ivf as rivf
from repro.core import kmeans as rkm
from repro_torch import convert
from repro_torch.core import ivf as tivf
from repro_torch.core import kmeans as tkm

TOL = 1e-5


@pytest.mark.parametrize("n,p,capacity,chunk", [
    (400, 12, 40, 64),     # capacity slack, spills to later ranks
    (400, 12, 30, 1000),   # 360 slots for 400 points: stragglers
    (257, 5, 52, 100),     # few clusters, heavy similarity ties
])
def test_balance_assignment_matches_reference(n, p, capacity, chunk):
    rng = np.random.default_rng(n + p)
    pts = rng.integers(-3, 4, size=(n, 8)).astype(np.float32)
    cents = rng.integers(-3, 4, size=(p, 8)).astype(np.float32)
    ra, rs = rkm.balance_assignment(jnp.asarray(pts), jnp.asarray(cents),
                                    p, capacity)
    ta, ts = tkm.balance_assignment(torch.from_numpy(pts),
                                    torch.from_numpy(cents), p, capacity,
                                    chunk=chunk)
    np.testing.assert_array_equal(np.asarray(ra), ta.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())


def test_build_layout_properties(small_corpus):
    docs = small_corpus.doc_vecs
    n = docs.shape[0]
    p, cf = 32, 1.3
    idx = tivf.build(docs, p, iters=4, seed=1, capacity_factor=cf,
                     device="cpu", chunk=300)
    capacity = max(1, int(cf * n / p + 0.9999))
    li = idx.list_ids.numpy()
    lv = idx.list_vecs.numpy()
    sizes = idx.list_sizes.numpy()
    real = li >= 0
    assert idx.centroids.shape == (p, docs.shape[1])
    assert idx.lmax == sizes.max() <= capacity
    np.testing.assert_array_equal(real.sum(1), sizes)
    # every doc exactly once, list rows == doc rows, pads 0 / -1
    np.testing.assert_array_equal(np.sort(li[real]), np.arange(n))
    np.testing.assert_array_equal(lv[real], docs[li[real]])
    assert not lv[~real].any()
    # the real slots come first and keep ascending doc ids
    for row, s in zip(li, sizes):
        assert (row[s:] == -1).all() and (np.diff(row[:s]) > 0).all()


@pytest.fixture(scope="module")
def converted(ivf_index):
    return convert.ivf_index_from_numpy(
        *(np.asarray(f) for f in ivf_index), device="cpu")


@pytest.fixture(scope="module")
def queries(small_corpus):
    return small_corpus.conversations.reshape(-1, small_corpus.doc_vecs
                                              .shape[1])[:9]


def _close(ref, port):
    np.testing.assert_allclose(np.asarray(ref), port.numpy(), rtol=0,
                               atol=TOL)


def _same(ref, port):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


def test_search_and_scan_lists_match_reference(ivf_index, converted,
                                               queries):
    rv, ri, rst = rivf.search(ivf_index, jnp.asarray(queries), nprobe=5,
                              k=10)
    tv, ti, tst = tivf.search(converted, torch.from_numpy(queries),
                              nprobe=5, k=10)
    _close(rv, tv)
    _same(ri, ti)
    for f in rst._fields:
        _same(getattr(rst, f), getattr(tst, f))
    _, sel = jax.lax.top_k(jnp.asarray(queries) @ ivf_index.centroids.T, 3)
    r = rivf._scan_lists(ivf_index, jnp.asarray(queries), sel, 7)
    t = tivf._scan_lists(converted, torch.from_numpy(queries),
                         torch.tensor(np.asarray(sel)), 7)
    _close(r[0], t[0])
    _same(r[1], t[1])
    _same(r[2], t[2])


def test_make_cache_and_search_cached_match_reference(ivf_index, converted,
                                                      queries):
    rids, rvecs = rivf.make_cache(ivf_index, jnp.asarray(queries[0]), h=12)
    tids, tvecs = tivf.make_cache(converted, torch.from_numpy(queries[0]),
                                  h=12)
    _same(rids, tids)
    _same(rvecs, tvecs)
    r = rivf.search_cached(ivf_index, rids, rvecs, jnp.asarray(queries),
                           nprobe=4, k=10)
    t = tivf.search_cached(converted, tids, tvecs,
                           torch.from_numpy(queries), nprobe=4, k=10)
    _close(r[0], t[0])
    _same(r[1], t[1])
    _same(r[2], t[2])
    for f in r[3]._fields:
        _same(getattr(r[3], f), getattr(t[3], f))


@pytest.mark.parametrize("chunk", [1 << 20, 300])
def test_exact_search_matches_reference(small_corpus, queries, chunk):
    docs = small_corpus.doc_vecs
    rv, ri = rivf.exact_search(jnp.asarray(docs), jnp.asarray(queries), 10)
    tv, ti = tivf.exact_search(torch.from_numpy(docs),
                               torch.from_numpy(queries), 10, chunk=chunk)
    _close(rv, tv)
    _same(ri, ti)
