"""repro_torch IVF-PQ ops == the reference's, op level, float32.

The port's ``ops.pq_adc_scan`` / ``fused_scan_pq`` / ``fused_turn_pq``
on CPU tensors run their plain PyTorch versions; the reference's run
their Pallas kernels in interpret mode and their jnp oracles ("ref").
Inputs are integer LUTs, codes, queries and corpus rows at
``tests/test_fused.py``'s PQ shapes (non-tile-multiple nlist / Lmax,
ragged lists, list 0 empty, doc ids repeating across lists), so every
ADC sum and re-rank dot is exact whatever the order, and values, ids,
``sel`` and positions must be equal, bit for bit.

A property of the reference, not of the port: the standalone Pallas
``pq_adc_scan`` (``repro/kernels/pq_adc.py:67-68``) folds its running
top-k with the non-tie-aware merge network, so on exactly tied ADC
scores its order is not ``lax.top_k``'s.  The port keeps ``lax.top_k``'s
order everywhere, so ``pq_adc_scan`` is held to "ref" on tied inputs and
to "interpret" on tie-free inputs (every code row distinct, LUT entries
that encode the row as a base-n_codes number).  The fused kernels merge
tie-aware and are held to both modes on tied inputs.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sorting import PAD_POS

# p, lmax, d, b, nprobe, k, m, n_codes
SHAPES = [(6, 10, 16, 3, 3, 4, 4, 16),
          (5, 8, 8, 2, 4, 8, 2, 8)]
N_DOCS = 64


def _lists(rng, p, lmax):
    """Ragged ids, list 0 empty, doc ids repeating across lists."""
    li = np.full((p, lmax), -1, np.int32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    nid = 0
    for pi in range(p):
        for off in range(sizes[pi]):
            li[pi, off] = nid % N_DOCS
            nid += 1
    return li


def _inputs(shape, *, tie_free=False):
    p, lmax, d, b, nprobe, k, m, c = shape
    rng = np.random.default_rng(p * 10 + m)
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 5, size=(p, d)).astype(np.float32)
    li = _lists(rng, p, lmax)
    if tie_free:
        # every code row distinct; lut[j, x] = x * c^j makes a row's ADC
        # score its base-c number, so no two real rows tie
        rows = rng.permutation(c ** m)[:p * lmax]
        codes = np.stack([(rows // c ** j) % c for j in range(m)], -1)
        codes = codes.reshape(p, lmax, m).astype(np.uint8)
        lut = (np.arange(c)[None] * (c ** np.arange(m))[:, None]).astype(
            np.float32)
        tables = np.broadcast_to(lut, (b, m, c)).copy()
    else:
        codes = rng.integers(0, c, size=(p, lmax, m)).astype(np.uint8)
        tables = rng.integers(-4, 5, size=(b, m, c)).astype(np.float32)
    corpus = rng.integers(-4, 5, size=(N_DOCS, d)).astype(np.float32)
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    own[0, 0] = 0
    return q, cents, tables, codes, li, corpus, own


def _sel(q, cents, nprobe):
    _, _, sel = rops.fused_turn(jnp.asarray(q), jnp.asarray(cents),
                                jnp.zeros((cents.shape[0], 1, q.shape[1])),
                                jnp.full((cents.shape[0], 1), -1,
                                         jnp.int32),
                                nprobe=nprobe, k=1, mode="ref")
    return np.array(sel)


def _eq(ref, port, what):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy(),
                                  err_msg=what)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,tie_free", [("ref", False), ("ref", True),
                                           ("interpret", True)])
def test_pq_adc_scan_matches_reference(shape, mode, tie_free):
    p, lmax, d, b, nprobe, k, m, c = shape
    q, cents, tables, codes, li, _, _ = _inputs(shape, tie_free=tie_free)
    sel = _sel(q, cents, nprobe)
    for depth in (k, 2 * k):
        rv, ri = rops.pq_adc_scan(jnp.asarray(tables), jnp.asarray(codes),
                                  jnp.asarray(li), jnp.asarray(sel), depth,
                                  mode=mode)
        tv, ti = tops.pq_adc_scan(*_t(tables, codes, li, sel), depth,
                                  device="cpu")
        _eq(rv, tv, "values")
        _eq(ri, ti, "ids")
        assert ti.dtype == torch.int32


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("fuse_rerank", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_scan_pq_matches_reference(shape, mode, fuse_rerank, masked):
    p, lmax, d, b, nprobe, k, m, c = shape
    q, cents, tables, codes, li, corpus, own = _inputs(shape)
    sel = _sel(q, cents, nprobe)
    r_own = jnp.asarray(own) if masked else None
    t_own = torch.from_numpy(own) if masked else None
    # rerank 2k: r a power of two; k + 2: r below its padding r_pad
    for rerank in (2 * k, k + 2):
        rv, ri, rp = rops.fused_scan_pq(
            jnp.asarray(tables), jnp.asarray(q), jnp.asarray(codes),
            jnp.asarray(li), jnp.asarray(sel), jnp.asarray(corpus), k,
            rerank=rerank, own=r_own, fuse_rerank=fuse_rerank, mode=mode)
        tv, ti, tp = tops.fused_scan_pq(
            *_t(tables, q, codes, li, sel, corpus), k, rerank=rerank,
            own=t_own, fuse_rerank=fuse_rerank, device="cpu")
        assert tv.shape[1] == (k if fuse_rerank else
                               max(k, min(rerank, nprobe * lmax)))
        _eq(rv, tv, "values")
        _eq(ri, ti, "ids")
        fin = np.isfinite(np.asarray(rv))
        if fuse_rerank or mode == "interpret":
            _eq(rp, tp, "pos")       # ADC ranks / PAD_POS on every lane
        else:
            # the oracle leaves flat positions undefined on -inf lanes
            _eq(np.asarray(rp)[fin], tp[torch.from_numpy(fin)], "pos")
            assert bool((tp[~torch.from_numpy(fin)] == PAD_POS).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["interpret", "ref"])
def test_fused_turn_pq_matches_reference(shape, mode):
    p, lmax, d, b, nprobe, k, m, c = shape
    q, cents, tables, codes, li, corpus, _ = _inputs(shape)
    for rerank in (2 * k, k + 2):
        rv, ri, rs = rops.fused_turn_pq(
            jnp.asarray(q), jnp.asarray(cents), jnp.asarray(tables),
            jnp.asarray(codes), jnp.asarray(li), jnp.asarray(corpus),
            nprobe=nprobe, k=k, rerank=rerank, mode=mode)
        tv, ti, ts = tops.fused_turn_pq(
            *_t(q, cents, tables, codes, li, corpus), nprobe=nprobe, k=k,
            rerank=rerank, device="cpu")
        _eq(rv, tv, "values")
        _eq(ri, ti, "ids")
        _eq(rs, ts, "sel")
        assert ti.dtype == ts.dtype == torch.int32
