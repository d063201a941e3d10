"""repro_torch's bf16 / int8 fused turn == the reference's.

The port's ``ops.fused_turn`` / ``fused_scan`` / ``fused_turn_pq`` /
``fused_scan_pq`` at ``precision="bf16"`` and ``"int8"`` run their plain
PyTorch versions on CPU tensors; the reference's run its jnp oracles
(``mode="ref"``) and, at its own tiny shapes, its Pallas kernels in
interpret mode.  The same numpy inputs go to both.  int8 dots are exact
and the dequantisation is one IEEE product and one divide, so ids,
``sel`` and candidate ranks are equal and values within 1e-5 (the
float32 re-rank sums in another order); bf16 is held to the tolerance
the reference holds its own two modes to (``tests/test_fused.py``):
values within 1e-5 (relative, and absolute for float scores near 0), ids
equal on the integer-valued inputs, where bf16 rounds nothing.  Shapes
cover several int8 scale groups of centroids (p > 512) and of a list (d
= 1,024, Lmax > 1,024), a candidate depth wider than the byte-capped
group (r_pad 2,048 > 1,024), k = 1,000 (r = 2,000), k above the real
candidates and all probed lists empty.  Then the engine:
``ServingConfig(fused=True, precision=...)`` for ivf and ivf_pq under
all three strategies against the reference's engine, and the reference's
recall floor against the float32 fused path.  Last, the order of signed
zeros, held against ``lax.top_k``.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ivf as rivf
from repro.core import pq as rpq
from repro.kernels import ops as rops
from repro.serving import engine as reng
from repro_torch import convert
from repro_torch.core import toploc as ttl
from repro_torch.core.backend import IVFBackend, IVFPQBackend
from repro_torch.core.topk import masked_topk, topk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sorting
from repro_torch.kernels.sorting import PAD_POS
from repro_torch.serving import engine as teng

CPU = "cpu"
QUANT = ("bf16", "int8")
TOL = 1e-5


def _lists(rng, p, lmax, d, n_docs, draw):
    """Ragged posting lists (list 0 empty, zero pads), rows drawn by
    ``draw``."""
    lv = draw((p, lmax, d))
    li = np.full((p, lmax), -1, np.int32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    nid = 0
    for pi in range(p):
        li[pi, :sizes[pi]] = (nid + np.arange(sizes[pi])) % n_docs
        nid += sizes[pi]
        lv[pi, sizes[pi]:] = 0
    return lv, li


def _draw(rng, floats):
    if floats:
        return lambda sh: rng.normal(size=sh).astype(np.float32)
    return lambda sh: rng.integers(-4, 5, size=sh).astype(np.float32)


def _ivf_inputs(p, lmax, d, b, nprobe, floats=False):
    rng = np.random.default_rng(p * 100 + lmax)
    draw = _draw(rng, floats)
    q, cents = draw((b, d)), draw((p, d))
    lv, li = _lists(rng, p, lmax, d, 200, draw)
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    own[0, 0] = 0
    return q, cents, lv, li, own


def _hold(ref, port, exact_ids, what):
    """Values within TOL, relative (the reference's own bf16 rule) and
    absolute (float inputs: scores near 0 summed in another order); ids,
    sel and positions equal where ``exact_ids``."""
    np.testing.assert_allclose(np.asarray(ref[0]), port[0].numpy(),
                               rtol=TOL, atol=TOL, err_msg=what)
    if exact_ids:
        for name, r, t in zip(("ids", "sel/pos"), ref[1:], port[1:]):
            np.testing.assert_array_equal(np.asarray(r), t.numpy(),
                                          err_msg=f"{what} {name}")


# p, lmax, d, b, nprobe, k
TINY = [(6, 10, 16, 3, 3, 4),        # non-tile-multiple
        (5, 7, 8, 1, 5, 8),          # k > real candidates
        (9, 16, 32, 4, 2, 4)]
WIDE = [(600, 40, 16, 2, 8, 10),     # two centroid groups (blk_p 512)
        (12, 1100, 1024, 2, 3, 4),   # two groups a list (blk_l 1,024)
        (12, 1100, 1024, 1, 3, 1000),  # r_pad 2,048 > the byte cap
        (300, 40, 8, 2, 64, 1000)]   # k = 1,000: r = 2,000


def _ivf_case(shape, precision, mode, floats=False):
    p, lmax, d, b, nprobe, k = shape
    q, cents, lv, li, own = _ivf_inputs(p, lmax, d, b, nprobe, floats)
    exact = precision == "int8" or not floats
    ref = rops.fused_turn(*map(jnp.asarray, (q, cents, lv, li)),
                          nprobe=nprobe, k=k, precision=precision, mode=mode)
    port = tops.fused_turn(*map(torch.from_numpy, (q, cents, lv, li)),
                           nprobe=nprobe, k=k, precision=precision,
                           device=CPU)
    _hold(ref, port, exact, f"fused_turn {shape}")
    sel = np.array(ref[2])
    ref = rops.fused_scan(*map(jnp.asarray, (q, lv, li, sel)), k,
                          own=jnp.asarray(own), precision=precision,
                          mode=mode)
    port = tops.fused_scan(*map(torch.from_numpy, (q, lv, li, sel)), k,
                           own=torch.from_numpy(own), precision=precision,
                           device=CPU)
    _hold(ref, port, exact, f"fused_scan {shape}")
    return port


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("shape", TINY)
def test_quantised_ivf_ops_match_reference(shape, mode, precision):
    _ivf_case(shape, precision, mode)


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("shape", WIDE)
def test_quantised_ivf_ops_match_reference_at_wide_shapes(shape, precision):
    """The reference's oracle (its interpret mode is too slow here)."""
    _, _, pos = _ivf_case(shape, precision, "ref")
    assert int(pos.max()) < 2 * shape[5]        # candidate ranks < r


def test_int8_groups_match_the_interpret_kernel_at_two_groups_a_list():
    """The Pallas kernel itself quantises each 1,024-row tile of a list
    of 1,100 rows (d = 1,024) with its own scale."""
    _ivf_case((4, 1100, 1024, 1, 2, 4), "int8", "interpret")


# p, lmax, d, r_pad: one group a list, several (d = 1,024, Lmax > 1,024),
# a group wider than the byte cap (r_pad 2,048), groups past the rows
GROUP_AMAX_SHAPES = [(5, 10, 16, 8), (3, 1100, 1024, 32),
                     (3, 1100, 1024, 2048), (4, 520, 8192, 16)]


@pytest.mark.parametrize("shape", GROUP_AMAX_SHAPES)
def test_group_amax_is_the_per_call_groups(shape):
    """The scales the kernels take from the index once (``ref.group_amax``,
    the plain version of csrc ``group_amax``) are those of every per-call
    group: ``ref.list_scores`` / ``centroid_scores``'s groups in the port,
    and the reference's int8 tiles (``repro.kernels.fused_turn``
    ``quantize_sym`` over the zero-padded lists' ``blk_l``-row tiles and
    the centroids' ``blk_p``-row tiles): the same amax, so the same scale
    bits."""
    from repro.kernels import fused_turn as rft
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import tiling
    p, lmax, d, r_pad = shape
    rng = np.random.default_rng(p * lmax + d)
    lv = (rng.standard_normal((p, lmax, d)) * rng.uniform(
        0.1, 4.0, size=(p, lmax, 1))).astype(np.float32)
    blk, ng = tiling.list_groups(lmax, d, r_pad)
    got = tref.group_amax(torch.from_numpy(lv), blk, ng)
    lpad = ng * blk
    pad = np.zeros((p, lpad, d), np.float32)
    pad[:, :lmax] = lv
    tiles = pad.reshape(p, ng, blk, d)
    for pi in range(p):
        for g in range(ng):
            want = np.abs(tiles[pi, g]).max()
            assert got[pi, g].item() == want
            _, scale = rft.quantize_sym(jnp.asarray(tiles[pi, g]), (0, 1))
            assert tref.int8_scale(got[pi, g]).item() == \
                np.asarray(scale).item()
    cents = rng.standard_normal((1300, 16)).astype(np.float32)
    blk_p, ncg = tiling.centroid_groups(1300, 64)
    got_c = tref.group_amax(torch.from_numpy(cents)[None], blk_p, ncg)[0]
    cpad = np.zeros((ncg * blk_p, 16), np.float32)
    cpad[:1300] = cents
    for g in range(ncg):
        _, scale = rft.quantize_sym(jnp.asarray(cpad[g * blk_p:(g + 1)
                                                     * blk_p]), (0, 1))
        assert tref.int8_scale(got_c[g]).item() == np.asarray(scale).item()
    # the port's per-call groups, as ref.list_scores / centroid_scores
    # stack them
    lt = torch.from_numpy(lv)
    per_call = torch.stack([lt[:, g * blk:(g + 1) * blk].abs().amax((1, 2))
                            if g * blk < lmax else torch.zeros(p)
                            for g in range(ng)], 1)
    assert torch.equal(got, per_call)
    ct = torch.from_numpy(cents)
    assert torch.equal(got_c, torch.stack(
        [ct[g * blk_p:(g + 1) * blk_p].abs().amax() for g in range(ncg)]))


@pytest.mark.parametrize("precision", QUANT)
def test_quantised_ivf_ops_on_float_inputs(precision):
    """Normal floats: int8 still exact (ids, sel, ranks); bf16 values."""
    _ivf_case((600, 40, 16, 3, 8, 10), precision, "ref", floats=True)


@pytest.mark.parametrize("precision", QUANT)
def test_quantised_all_probed_lists_empty(precision):
    """Every probed list empty -> ids -1, scores -inf, ranks in order."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    cents = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    lv = torch.zeros((4, 6, 8))
    li = torch.full((4, 6), -1, dtype=torch.int32)
    v, i, sel = tops.fused_turn(q, cents, lv, li, nprobe=2, k=4,
                                precision=precision, device=CPU)
    assert bool((i == -1).all()) and bool(torch.isneginf(v).all())
    v, i, pos = tops.fused_scan(q, lv, li, sel, 4, precision=precision,
                                device=CPU)
    assert bool((i == -1).all()) and pos.tolist() == [[0, 1, 2, 3]] * 2
    rv, ri, rs = rops.fused_turn(*(jnp.asarray(x.numpy()) for x in
                                   (q, cents, lv, li)), nprobe=2, k=4,
                                 precision=precision, mode="ref")
    np.testing.assert_array_equal(np.asarray(rs), sel.numpy())


def _pq_inputs(p, lmax, d, b, nprobe, m, c, floats):
    rng = np.random.default_rng(p * 10 + m)
    draw = _draw(rng, floats)
    q, cents, tables = draw((b, d)), draw((p, d)), draw((b, m, c))
    codes = rng.integers(0, c, size=(p, lmax, m)).astype(np.uint8)
    _, li = _lists(rng, p, lmax, 1, 64, draw)
    corpus = draw((64, d))
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    return q, cents, tables, codes, li, corpus, own


# p, lmax, d, b, nprobe, k, m, n_codes
PQ_TINY = [(6, 10, 16, 3, 3, 4, 4, 16), (5, 8, 8, 2, 4, 8, 2, 8)]
PQ_WIDE = [(600, 40, 16, 2, 8, 10, 8, 256),
           (300, 40, 16, 1, 64, 1000, 8, 256)]   # depth 2,000


def _pq_case(shape, precision, mode, floats, rerank=None):
    p, lmax, d, b, nprobe, k, m, c = shape
    rerank = rerank or 2 * k
    q, cents, tables, codes, li, corpus, own = _pq_inputs(
        p, lmax, d, b, nprobe, m, c, floats)
    exact = precision == "int8" or not floats
    ref = rops.fused_turn_pq(*map(jnp.asarray, (q, cents, tables, codes, li,
                                                corpus)),
                             nprobe=nprobe, k=k, rerank=rerank,
                             precision=precision, mode=mode)
    port = tops.fused_turn_pq(*map(torch.from_numpy, (q, cents, tables, codes,
                                                      li, corpus)),
                              nprobe=nprobe, k=k, rerank=rerank,
                              precision=precision, device=CPU)
    _hold(ref, port, exact, f"fused_turn_pq {shape}")
    sel = np.array(ref[2])
    for fuse in (True, False):
        ref = rops.fused_scan_pq(*map(jnp.asarray, (tables, q, codes, li,
                                                    sel, corpus)), k,
                                 rerank=rerank, own=jnp.asarray(own),
                                 precision=precision, fuse_rerank=fuse,
                                 mode=mode)
        port = tops.fused_scan_pq(*map(torch.from_numpy, (tables, q, codes,
                                                          li, sel, corpus)),
                                  k, rerank=rerank,
                                  own=torch.from_numpy(own),
                                  precision=precision, fuse_rerank=fuse,
                                  device=CPU)
        fin = np.isfinite(np.asarray(ref[0]))
        # the oracle leaves positions undefined on -inf lanes
        ref = (ref[0], ref[1], np.asarray(ref[2])[fin])
        port = (port[0], port[1], port[2][torch.from_numpy(fin)])
        _hold(ref, port, exact,
              f"fused_scan_pq rerank={fuse} {shape}")


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("shape", PQ_TINY)
def test_quantised_pq_ops_match_reference(shape, mode, floats, precision):
    _pq_case(shape, precision, mode, floats)


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("shape", PQ_WIDE)
def test_quantised_pq_ops_match_reference_at_wide_shapes(shape, precision):
    _pq_case(shape, precision, "ref", floats=True)


# ---------------------------------------------------------------------------
# engine level: ServingConfig(fused=True, precision=...) vs the reference
# ---------------------------------------------------------------------------

K, NPROBE, H = 10, 4, 16


@pytest.fixture(scope="module")
def served():
    """The reference fused tests' fixture (``tests/test_fused.py``):
    1,200 docs at d = 32, p = 24, PQ m = 8; both packages' indexes."""
    from repro.data import synthetic as SY
    wl = SY.make_workload(SY.WorkloadConfig(
        n_docs=1200, d=32, n_topics=12, n_conversations=3,
        turns_per_conversation=5, seed=3))
    idx = rivf.build(jnp.asarray(wl.doc_vecs), p=24, iters=4,
                     key=jax.random.PRNGKey(0))
    pqi = rpq.build_ivf_pq(idx, jnp.asarray(wl.doc_vecs), m=8, iters=4,
                           key=jax.random.PRNGKey(0))
    tidx = convert.ivf_index_from_numpy(*(np.asarray(f) for f in idx),
                                        device=CPU)
    tpq = convert.ivf_pq_index_from_numpy(*(np.asarray(f) for f in pqi),
                                          device=CPU)
    return wl.conversations, {"ivf": (idx, tidx), "ivf_pq": (pqi, tpq)}


RECORD_FIELDS = ("conv_id", "turn", "centroid_dists", "list_dists",
                 "graph_dists", "refreshed", "i0", "code_dists")


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("strategy", ["toploc+", "toploc", "plain"])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_engine_matches_reference_engine(served, backend, strategy,
                                         precision):
    convs, indexes = served
    ridx, tidx = indexes[backend]
    kw = dict(backend=backend, strategy=strategy, k=K, nprobe=NPROBE, h=H,
              alpha=0.3, rerank=32, fused=True, precision=precision)
    key = f"{backend}_index"
    ref = reng.ConversationalSearchEngine(reng.ServingConfig(**kw),
                                          **{key: ridx})
    port = teng.ConversationalSearchEngine(teng.ServingConfig(**kw),
                                           **{key: tidx}, device=CPU)
    for t in range(convs.shape[1]):
        for c in range(convs.shape[0]):
            rv, ri = ref.query(f"c{c}", jnp.asarray(convs[c, t]))
            tv, ti = port.query(f"c{c}", convs[c, t])
            np.testing.assert_allclose(rv, tv, rtol=TOL, atol=TOL)
            if precision == "int8":
                np.testing.assert_array_equal(ri, ti)
    for r, p in zip(ref.records, port.records, strict=True):
        assert [getattr(r, f) for f in RECORD_FIELDS] == \
            [getattr(p, f) for f in RECORD_FIELDS]


@pytest.mark.parametrize("strategy", ["toploc+", "plain"])
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_engine_matches_reference_engine_at_k_1000(served, backend,
                                                   strategy):
    """int8 at TREC CAsT's k = 1,000 over every list (nprobe 24): the
    re-ranked depth is all 1,560 slots (r_pad 2,048) for both families;
    every counter equal, scores within 1e-5, and ids equal but where two
    docs' exact scores tie within 1e-5 (the float32 re-rank sums in
    another order than XLA's, and 1,000 float scores hold such ties)."""
    convs, indexes = served
    docs = np.asarray(indexes["ivf_pq"][0].doc_vecs, np.float64)
    ridx, tidx = indexes[backend]
    kw = dict(backend=backend, strategy=strategy, k=1000, nprobe=24, h=24,
              alpha=0.3, rerank=2000, fused=True, precision="int8")
    key = f"{backend}_index"
    assert 24 * tidx.lmax >= 1025
    ref = reng.ConversationalSearchEngine(reng.ServingConfig(**kw),
                                          **{key: ridx})
    port = teng.ConversationalSearchEngine(teng.ServingConfig(**kw),
                                           **{key: tidx}, device=CPU)
    for t in range(3):
        for c in range(2):
            rv, ri = ref.query(f"c{c}", jnp.asarray(convs[c, t]))
            tv, ti = port.query(f"c{c}", convs[c, t])
            np.testing.assert_allclose(rv, tv, rtol=TOL, atol=TOL)
            q = convs[c, t].astype(np.float64)
            swap = ri != ti
            assert swap.sum() <= 4
            np.testing.assert_allclose(docs[ri[swap]] @ q, docs[ti[swap]] @ q,
                                       rtol=0, atol=TOL)
            assert set(ri) == set(ti)
    for r, p in zip(ref.records, port.records, strict=True):
        assert [getattr(r, f) for f in RECORD_FIELDS] == \
            [getattr(p, f) for f in RECORD_FIELDS]


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("backend", ["ivf", "ivf_pq"])
def test_quantised_recall_against_the_f32_fused_path(served, backend,
                                                     precision):
    """The reference's floor (``tests/test_fused.py:194-206``): recall@10
    of the quantised plain turn against the float32 fused one >= 0.9."""
    convs, indexes = served
    index = indexes[backend][1]
    base = (IVFBackend(h=H, nprobe=NPROBE) if backend == "ivf"
            else IVFPQBackend(h=H, nprobe=NPROBE, rerank=32))
    q = torch.from_numpy(convs.reshape(-1, convs.shape[-1])[:7])
    f32 = dataclasses.replace(base, fused=ttl.FusedTurn())
    quant = dataclasses.replace(base, fused=ttl.FusedTurn(precision=precision))
    _, ri, rst = f32.plain_batch(index, q, k=K)
    _, gi, gst = quant.plain_batch(index, q, k=K)
    rec = np.mean([len(set(ri[r].tolist()) & set(gi[r].tolist())) / K
                   for r in range(ri.shape[0])])
    assert rec >= 0.9, (backend, precision, rec)
    assert torch.equal(rst.centroid_dists, gst.centroid_dists)


# ---------------------------------------------------------------------------
# signed zeros: lax.top_k ranks +0.0 above -0.0
# ---------------------------------------------------------------------------

SIGNED_ZEROS = [-0.0, 0.0, -0.0, 0.0, 1.0, -1.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_topk_orders_signed_zeros_as_lax(dtype):
    x = np.array(SIGNED_ZEROS, np.float32)
    rows = np.stack([x, -x, x[::-1].copy()])
    for k in (4, 6):
        rv, ri = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = topk(torch.from_numpy(rows).to(dtype), k)
        np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
        np.testing.assert_array_equal(np.signbit(np.asarray(rv)),
                                      torch.signbit(tv.float()).numpy())
    assert topk(torch.tensor(SIGNED_ZEROS), 4)[1].tolist() == [4, 1, 3, 0]


def test_masked_topk_orders_signed_zeros_as_lax():
    """Masked lanes go to -inf after every ±0."""
    x = np.array(SIGNED_ZEROS * 2, np.float32)
    mask = np.arange(12) % 3 != 1
    rv, ri = jax.lax.top_k(jnp.where(mask, x, -jnp.inf), 8)
    tv, ti = masked_topk(torch.from_numpy(x), torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())


def test_tie_networks_order_signed_zeros_as_lax():
    """The plain tie networks (``kernels/sorting.py``) order by (value
    desc, position asc) with +0.0 above -0.0: ``lax.top_k`` over the
    flat row, which the reference's Pallas networks (they tie ±0) do
    not give."""
    x = np.array(SIGNED_ZEROS, np.float32)
    pos = np.arange(6, dtype=np.int32)
    _, want = jax.lax.top_k(jnp.asarray(x), 6)
    v, i, p = sorting.block_topk_desc_tie(
        torch.from_numpy(x), torch.from_numpy(pos + 100),
        torch.from_numpy(pos), 6)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want) + 100)
    pad = torch.tensor([float("-inf")] * 2)
    run = sorting.block_topk_desc_tie(torch.from_numpy(x[:3]),
                                      torch.tensor([0, 1, 2]),
                                      torch.tensor([0, 1, 2]), 3)
    blk = sorting.block_topk_desc_tie(torch.from_numpy(x[3:]),
                                      torch.tensor([3, 4, 5]),
                                      torch.tensor([3, 4, 5]), 3)
    v, i, p = sorting.merge_topk_desc_tie(
        torch.cat([run[0], pad]), torch.cat([run[1], torch.tensor([-1] * 2)]),
        torch.cat([run[2], torch.tensor([PAD_POS] * 2)]), *blk)
    np.testing.assert_array_equal(p[:5].numpy(), np.asarray(want)[:5])
