"""repro_torch product quantisation == the reference's (``core/pq.py``).

* On the reference's codebooks, converted: ``encode``, ``decode``,
  ``adc_table``, ``adc_scores``, ``adc_scores_masked``,
  ``adc_search_lists`` and ``build_ivf_pq``'s ``list_codes`` equal the
  reference — exactly on integer inputs (every dot and sum is exact); on
  the golden workload's floats exactly except near ties, which are
  counted and checked to be ties (the two codewords' distances within
  1e-5), and scores within 1e-5 (XLA-CPU and PyTorch sum in other
  orders).
* The port's own ``train`` (k-means++ seeding, dot-product Lloyd, from a
  ``torch.Generator``) gives other bits than ``jax.random``, so it is
  held by properties: distinct codewords, and a reconstruction MSE on
  the golden workload within ``MSE_FACTOR`` of the reference's.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ivf as rivf
from repro.core import pq as rpq
from repro_torch import convert
from repro_torch.core import kmeans as tkm
from repro_torch.core import pq as tpq

TOL = 1e-5
# the port's codebooks may reconstruct at most this much worse than the
# reference's: both are 6 Lloyd iterations from k-means++ seeds, and
# different seeds move a local optimum by a few per cent
MSE_FACTOR = 1.10
CPU = "cpu"


@pytest.fixture(scope="module")
def golden():
    from repro.data import synthetic as SY
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=1500, d=32, n_topics=12, n_conversations=2,
        turns_per_conversation=8, query_drift=0.15, walk_step=0.05,
        shift_prob=0.15, seed=7))
    docs = jnp.asarray(wl.doc_vecs)
    fidx = rivf.build(docs, p=32, iters=5, key=jax.random.PRNGKey(0))
    book = rpq.train(docs, m=8, iters=6, key=jax.random.PRNGKey(0))
    tbook = tpq.PQCodebook(torch.from_numpy(np.array(book.codewords)), 8)
    return wl, fidx, book, tbook


def _int_book(rng, m, n_codes, d_sub):
    return rng.integers(-3, 4, size=(m, n_codes, d_sub)).astype(np.float32)


@pytest.mark.parametrize("m,n_codes,d_sub,n", [(4, 16, 2, 300),
                                               (8, 256, 4, 500),
                                               (2, 8, 8, 64)])
def test_functions_match_reference_on_integer_inputs(m, n_codes, d_sub, n):
    rng = np.random.default_rng(m * 1000 + n_codes)
    cw = _int_book(rng, m, n_codes, d_sub)
    x = rng.integers(-3, 4, size=(n, m * d_sub)).astype(np.float32)
    q = rng.integers(-3, 4, size=(m * d_sub,)).astype(np.float32)
    rbook = rpq.PQCodebook(jnp.asarray(cw), m)
    tbook = tpq.PQCodebook(torch.from_numpy(cw), m)
    rcodes = np.asarray(rpq.encode(rbook, jnp.asarray(x)))
    tcodes = tpq.encode(tbook, torch.from_numpy(x), chunk=37)
    assert tcodes.dtype == torch.uint8
    np.testing.assert_array_equal(rcodes, tcodes.numpy())   # ties: first
    np.testing.assert_array_equal(np.asarray(rpq.decode(rbook, rcodes)),
                                  tpq.decode(tbook, tcodes).numpy())
    rtab = np.asarray(rpq.adc_table(rbook, jnp.asarray(q)))
    ttab = tpq.adc_table(tbook, torch.from_numpy(q))
    np.testing.assert_array_equal(rtab, ttab.numpy())
    np.testing.assert_array_equal(
        np.asarray(rpq.adc_scores(jnp.asarray(rtab), rcodes)),
        tpq.adc_scores(ttab, tcodes).numpy())


def test_masked_and_list_search_match_reference():
    rng = np.random.default_rng(3)
    m, n_codes, d_sub, p, lmax = 4, 16, 2, 6, 9
    cw = _int_book(rng, m, n_codes, d_sub)
    q = rng.integers(-3, 4, size=(m * d_sub,)).astype(np.float32)
    codes = rng.integers(0, n_codes, size=(p, lmax, m)).astype(np.uint8)
    ids = np.arange(p * lmax, dtype=np.int32).reshape(p, lmax)
    ids[:, 7:] = -1
    ids[2] = -1
    sel = np.array([4, 2, 0, 5], np.int32)
    rbook = rpq.PQCodebook(jnp.asarray(cw), m)
    tbook = tpq.PQCodebook(torch.from_numpy(cw), m)
    rv, ri = rpq.adc_search_lists(rbook, jnp.asarray(q), jnp.asarray(codes),
                                  jnp.asarray(ids), jnp.asarray(sel), 12)
    tv, ti = tpq.adc_search_lists(tbook, torch.from_numpy(q),
                                  torch.from_numpy(codes),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(sel), 12)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    tables = rng.integers(-4, 5, size=(3, m, n_codes)).astype(np.float32)
    blk = rng.integers(0, n_codes, size=(3, 11, m)).astype(np.int32)
    bid = np.where(rng.random((3, 11)) > 0.3, 1, -1).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(rpq.adc_scores_masked(jnp.asarray(tables),
                                         jnp.asarray(blk),
                                         jnp.asarray(bid))),
        tpq.adc_scores_masked(*(torch.from_numpy(a) for a in
                                (tables, blk, bid))).numpy())


def _near_tie_mismatches(book, x, rcodes, tcodes):
    """Subspace codes that differ, each checked to be a near tie: the
    two codewords' L2 distances agree within TOL.  Returns the count."""
    cw = np.asarray(book.codewords, np.float64)
    m, _, d_sub = cw.shape
    rows, subs = np.nonzero(rcodes != tcodes)
    for r, j in zip(rows, subs):
        xs = x[r, j * d_sub:(j + 1) * d_sub].astype(np.float64)
        dr = np.sum((xs - cw[j, rcodes[r, j]]) ** 2)
        dt = np.sum((xs - cw[j, tcodes[r, j]]) ** 2)
        assert abs(dr - dt) < TOL, (r, j, dr, dt)
    return len(rows)


def test_reference_codebook_on_golden_workload(golden):
    """Floats: encode equal but for near ties, tables and scores within
    TOL; decode is a gather, exact."""
    wl, _, book, tbook = golden
    x = wl.doc_vecs
    rcodes = np.array(rpq.encode(book, jnp.asarray(x)))
    tcodes = tpq.encode(tbook, torch.from_numpy(x)).numpy()
    assert _near_tie_mismatches(book, x, rcodes, tcodes) <= 2
    np.testing.assert_array_equal(np.asarray(rpq.decode(book, rcodes)),
                                  tpq.decode(tbook,
                                             torch.from_numpy(rcodes)).numpy())
    for q in wl.conversations[:, 0]:
        rtab = np.array(rpq.adc_table(book, jnp.asarray(q)))
        ttab = tpq.adc_table(tbook, torch.from_numpy(q))
        np.testing.assert_allclose(rtab, ttab.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            np.asarray(rpq.adc_scores(jnp.asarray(rtab), rcodes)),
            tpq.adc_scores(torch.from_numpy(rtab),
                           torch.from_numpy(rcodes)).numpy(),
            rtol=0, atol=TOL)


def test_build_ivf_pq_list_codes_match_reference(golden):
    wl, fidx, book, tbook = golden
    # the fixture's codebook: the same training call
    rpqi = rpq.build_ivf_pq(fidx, jnp.asarray(wl.doc_vecs), m=8, iters=6,
                            key=jax.random.PRNGKey(0))
    tidx = convert.ivf_index_from_numpy(*(np.asarray(f) for f in fidx),
                                        device=CPU)
    docs = torch.from_numpy(wl.doc_vecs)
    tpqi = tpq.build_ivf_pq(tidx, docs, tbook, device=CPU)
    # the float index's tensors and the corpus are shared, not copied
    assert tpqi.centroids is tidx.centroids
    assert tpqi.list_ids is tidx.list_ids
    assert tpqi.doc_vecs.data_ptr() == docs.data_ptr()
    np.testing.assert_array_equal(np.asarray(rpqi.codewords),
                                  tpqi.codewords.numpy())
    rcodes, tcodes = np.asarray(rpqi.list_codes), tpqi.list_codes.numpy()
    assert tcodes.dtype == np.uint8 and tcodes.shape == rcodes.shape
    real = np.asarray(fidx.list_ids) >= 0
    assert not tcodes[~real].any()
    ids = np.asarray(fidx.list_ids)[real]
    assert _near_tie_mismatches(book, wl.doc_vecs[ids], rcodes[real],
                                tcodes[real]) <= 2
    # the converted reference index carries over field for field
    conv = convert.ivf_pq_index_from_numpy(*(np.asarray(f) for f in rpqi),
                                           device=CPU)
    assert conv.list_codes.dtype == torch.uint8
    for f in rpqi._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rpqi, f)),
                                      getattr(conv, f).numpy(), err_msg=f)
    assert conv.m == 8 and conv.lmax == rpqi.lmax and \
        conv.n_docs == rpqi.n_docs == len(wl.doc_vecs)


def _mse(codewords, x, codes):
    recon = tpq.decode(tpq.PQCodebook(codewords, codewords.shape[0]),
                       torch.as_tensor(np.array(codes)))
    return float(((recon - torch.from_numpy(x)) ** 2).sum(-1).mean())


def _distinct(codewords):
    return min(len(np.unique(np.asarray(c), axis=0)) for c in codewords)


def test_port_train_properties(golden):
    """Distinct ++ seeds; after Lloyd, as many distinct codewords as the
    reference keeps, and reconstruction within MSE_FACTOR of the
    reference's codebooks on the same corpus.  (Dot-product Lloyd
    respawns empty clusters from random points, which can collide: the
    reference keeps 237 to 248 of 256 distinct here.)"""
    wl, _, book, tbook = golden
    x = wl.doc_vecs
    seeds = tpq.train(torch.from_numpy(x), 8, iters=0,
                      generator=torch.Generator().manual_seed(0))
    assert _distinct(seeds.codewords) == 256
    gen = torch.Generator().manual_seed(0)
    own = tpq.train(torch.from_numpy(x), 8, iters=6, generator=gen)
    assert own.codewords.shape == (8, 256, 4) and own.m == 8
    assert _distinct(own.codewords) >= _distinct(book.codewords) - 8
    own_mse = _mse(own.codewords, x, tpq.encode(own, torch.from_numpy(x)))
    ref_mse = _mse(tbook.codewords, x,
                   rpq.encode(book, jnp.asarray(x)))
    assert own_mse <= MSE_FACTOR * ref_mse, (own_mse, ref_mse)


def test_plusplus_seeding_properties():
    """Seeds are rows of the points; with as many distinct points as
    seeds every point is drawn once (a drawn point's distance is 0);
    identical points fall back to uniform draws."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    seeds = tkm._plusplus_init(pts, 40, torch.Generator().manual_seed(1))
    order = torch.cdist(seeds, pts).argmin(-1)
    assert torch.equal(seeds, pts[order])
    assert torch.equal(order.sort().values, torch.arange(40))
    same = torch.ones((10, 3))
    seeds = tkm._plusplus_init(same, 4, torch.Generator().manual_seed(1))
    assert torch.equal(seeds, torch.ones((4, 3)))
    with pytest.raises(ValueError, match="init"):
        tkm.kmeans_fit(pts, 4, generator=torch.Generator(), init="kmeans")


@pytest.mark.parametrize("bad", ["code", "id"])
@pytest.mark.parametrize("via", ["convert", "engine"])
def test_out_of_range_index_entries_are_refused(via, bad):
    """The kernels read the ADC table at each code and ``doc_vecs`` at
    each id unchecked, so a code past the codebook or an id past the
    corpus is refused once, where an index comes in: by ``convert`` and
    by the engine (a hand-built ``IVFPQIndex``)."""
    from repro_torch.serving import engine as teng
    rng = np.random.default_rng(3)
    p, lmax, m, n_codes, d = 3, 4, 2, 4, 8
    codes = rng.integers(0, n_codes, size=(p, lmax, m)).astype(np.uint8)
    ids = np.arange(p * lmax).reshape(p, lmax)

    def make():
        fields = (rng.normal(size=(p, d)),
                  rng.normal(size=(m, n_codes, d // m)), codes, ids,
                  np.full(p, lmax), rng.normal(size=(p * lmax, d)))
        if via == "convert":
            return convert.ivf_pq_index_from_numpy(*fields, device=CPU)
        idx = tpq.IVFPQIndex(*(torch.from_numpy(np.asarray(f, t)) for f, t
                               in zip(fields, (np.float32, np.float32,
                                               np.uint8, np.int32, np.int32,
                                               np.float32))))
        return teng.ConversationalSearchEngine(
            teng.ServingConfig(backend="ivf_pq"), ivf_pq_index=idx,
            device=CPU)

    codes[1, 2, 1] = n_codes - 1
    make()
    if bad == "code":
        codes[1, 2, 1] = n_codes
    else:
        ids[1, 2] = p * lmax
    with pytest.raises(ValueError, match="n_codes" if bad == "code"
                       else "doc_vecs"):
        make()
