"""Rows 1-2 of the kernel table: ``ops.centroid_topk`` and ``ops.ivf_scan``.

The same numpy inputs, made from a seed, go through ``repro.kernels.ops``
(its "ref" oracle and, where the Pallas kernel's tie order cannot show,
its "interpret" mode) and through the port's ops on CPU tensors, whose
plain versions run here; the CUDA kernels are held to those plain
versions on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``
``[exact]``).  Ids exact; values within TOL x max(1, |value|): float32
summation order, whose error grows with the score (the reference's
sweeps score unnormalised normal vectors, |score| up to ~40).

The port follows "ref" (``lax.top_k`` over the exact scores) where the
Pallas kernels differ from it: on exact ties (both fold with the plain,
not tie-aware, bitonic networks, ``ivf_scan`` keyed by doc id), and for
``centroid_topk`` when every real score is negative, where the zero
centroids that the reference's wrapper pads p with outrank them before
it masks ids >= p.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops, ref

TOL = 1e-5
RNG_SEED = 1234


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _check(got, want, tol=TOL):
    gv, gi = got
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi.numpy(), wi)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv.numpy()), fin)
    err = np.abs(gv.numpy()[fin] - wv[fin])
    assert (err <= tol * np.maximum(1.0, np.abs(wv[fin]))).all(), err.max()


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


# ---------------------------------------------------------- centroid_topk

# the reference's sweep (tests/test_kernels.py test_centroid_topk_sweep)
CK_SWEEP = [(1, 32, 256, 8), (8, 64, 512, 16), (4, 128, 1024, 32),
            (3, 48, 1000, 10)]


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("b,d,p,k", CK_SWEEP)
def test_centroid_topk_sweep(b, d, p, k, mode):
    rng = np.random.default_rng(RNG_SEED + p)
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(p, d)).astype(np.float32)
    want = rops.centroid_topk(jnp.asarray(q), jnp.asarray(c), k, mode=mode)
    _check(ops.centroid_topk(_t(q), _t(c), k, device="cpu"), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centroid_topk_dtypes(dtype):
    """bf16 operands are widened to float32 (the Pallas kernel's
    ``.astype(jnp.float32)``); no f32 copy is asked of the caller."""
    rng = np.random.default_rng(RNG_SEED)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    c = rng.normal(size=(256, 64)).astype(np.float32)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = rops.centroid_topk(_jax(q, jt), _jax(c, jt), 8, mode="ref")
    got = ops.centroid_topk(_t(q).to(tt), _t(c).to(tt), 8, device="cpu")
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _check(got, want)


def test_centroid_topk_all_negative_scores_ignore_padding():
    """p = 600 (not a tile multiple), every score negative: the port and
    "ref" return the eight real centroids; the reference's "interpret"
    path returns its zero pads (ids >= p, masked to -inf) instead."""
    rng = np.random.default_rng(RNG_SEED)
    c = (np.abs(rng.normal(size=(600, 16))) + 0.5).astype(np.float32)
    q = -np.ones((2, 16), np.float32)
    want = rops.centroid_topk(jnp.asarray(q), jnp.asarray(c), 8, mode="ref")
    got = ops.centroid_topk(_t(q), _t(c), 8, device="cpu")
    _check(got, want)
    assert bool((got[0] < 0).all()) and int(got[1].max()) < 600
    iv, ii = rops.centroid_topk(jnp.asarray(q), jnp.asarray(c), 8,
                                mode="interpret")
    assert np.isneginf(np.asarray(iv)).all() and (np.asarray(ii) >= 600).all()


@pytest.mark.parametrize("k", [1, 7, 64, 300])
def test_centroid_topk_exact_ties_follow_lax_top_k(k):
    """Integer scores tie densely: ids in lax.top_k's order (score desc,
    index asc), at k up to past one 128-centroid chunk."""
    rng = np.random.default_rng(RNG_SEED + k)
    q = rng.integers(-1, 2, size=(5, 8)).astype(np.float32)
    c = rng.integers(-1, 2, size=(700, 8)).astype(np.float32)
    want = rops.centroid_topk(jnp.asarray(q), jnp.asarray(c), k, mode="ref")
    _check(ops.centroid_topk(_t(q), _t(c), k, device="cpu"), want)


def test_centroid_topk_refuses_what_neither_path_takes():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="top-9 of 8"):
        ops.centroid_topk(q, torch.zeros((8, 8)), 9, device="cpu")
    with pytest.raises(ValueError, match="both"):
        ops.centroid_topk(q, torch.zeros((8, 8), dtype=torch.bfloat16), 2,
                          device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        ops.centroid_topk(q, torch.zeros((8, 8)), 2, mode="kernel",
                          device="cpu")


# --------------------------------------------------------------- ivf_scan

# the reference's sweep (tests/test_kernels.py test_ivf_scan_sweep)
IV_SWEEP = [(2, 32, 32, 64, 4, 8), (4, 64, 64, 128, 8, 16),
            (1, 32, 16, 100, 4, 10)]


def _lists(b, d, p, lmax, npb, seed, integer=False, pad=0.25):
    rng = np.random.default_rng(seed)
    if integer:
        lv = rng.integers(-2, 3, size=(p, lmax, d)).astype(np.float32)
        q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
        li = rng.integers(0, 50, (p, lmax)).astype(np.int32)
    else:
        lv = rng.normal(size=(p, lmax, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
        li = rng.integers(0, 100000, (p, lmax)).astype(np.int32)
    mask = rng.uniform(size=(p, lmax)) < pad
    li[mask] = -1
    lv[mask] = 0
    sel = np.stack([rng.permutation(p)[:npb] for _ in range(b)]).astype(
        np.int32)
    return q, lv, li, sel


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("b,d,p,lmax,npb,k", IV_SWEEP)
def test_ivf_scan_sweep(b, d, p, lmax, npb, k, mode):
    q, lv, li, sel = _lists(b, d, p, lmax, npb, RNG_SEED + p)
    want = rops.ivf_scan(*map(jnp.asarray, (q, lv, li, sel)), k, mode=mode)
    _check(ops.ivf_scan(*map(_t, (q, lv, li, sel)), k, device="cpu"), want)


@pytest.mark.parametrize("b,d,p,lmax,npb,k", IV_SWEEP)
def test_ivf_scan_bfloat16(b, d, p, lmax, npb, k):
    q, lv, li, sel = _lists(b, d, p, lmax, npb, RNG_SEED + d)
    want = rops.ivf_scan(_jax(q, jnp.bfloat16), _jax(lv, jnp.bfloat16),
                         jnp.asarray(li), jnp.asarray(sel), k, mode="ref")
    got = ops.ivf_scan(_t(q).bfloat16(), _t(lv).bfloat16(), _t(li), _t(sel),
                       k, device="cpu")
    _check(got, want)


@pytest.mark.parametrize("k", [5, 40, 128])
def test_ivf_scan_exact_ties_follow_flat_position(k):
    """Integer rows and repeated doc ids: ties go to the smaller flat
    position probe*lmax + offset (lax.top_k over the gathered lists),
    not to the doc id the Pallas kernel keys its networks by."""
    q, lv, li, sel = _lists(3, 8, 20, 30, 6, RNG_SEED + k, integer=True)
    want = rops.ivf_scan(*map(jnp.asarray, (q, lv, li, sel)), k, mode="ref")
    _check(ops.ivf_scan(*map(_t, (q, lv, li, sel)), k, device="cpu"), want)


def test_ivf_scan_fewer_real_rows_than_k_pad_with_minus_one():
    """Three probed lists of 10 slots, most of them pads: the slots past
    the real rows come back as (-inf, -1), as in "ref"."""
    q, lv, li, sel = _lists(2, 16, 8, 10, 3, RNG_SEED, pad=0.8)
    real = (li[sel] >= 0).reshape(2, -1).sum(-1)
    k = 20
    assert (real < k).all()
    want = rops.ivf_scan(*map(jnp.asarray, (q, lv, li, sel)), k, mode="ref")
    got = ops.ivf_scan(*map(_t, (q, lv, li, sel)), k, device="cpu")
    _check(got, want)
    for row, n in enumerate(real):
        assert bool(torch.isneginf(got[0][row, n:]).all())
        assert bool((got[1][row, n:] == -1).all())


def test_ivf_scan_refuses_what_neither_path_takes():
    q, lv, li, sel = map(_t, _lists(2, 8, 4, 3, 2, RNG_SEED))
    with pytest.raises(ValueError, match="top-7 of 2 lists"):
        ops.ivf_scan(q, lv, li, sel, 7, device="cpu")
    with pytest.raises(ValueError, match="both"):
        ops.ivf_scan(q.bfloat16(), lv, li, sel, 2, device="cpu")


# ------------------------------------------------ the two-stage turn

@pytest.mark.parametrize("b,nprobe,k", [(1, 4, 10), (5, 16, 10),
                                        (3, 64, 100)])
def test_two_stages_equal_the_fused_turn(b, nprobe, k):
    """centroid_topk -> ivf_scan is the f32 fused turn (the reference's
    "The f32 path is bit-identical to centroid_topk -> ivf_scan"): the
    port's plain versions agree bit for bit, and with the reference's
    "ref" two-stage turn on ids."""
    p, lmax, d = 200, 40, 32
    q, lv, li, _ = _lists(b, d, p, lmax, 1, RNG_SEED + b)
    c = np.random.default_rng(b).normal(size=(p, d)).astype(np.float32)
    tq, tc, tlv, tli = map(_t, (q, c, lv, li))
    _, sel = ops.centroid_topk(tq, tc, nprobe, device="cpu")
    v, i = ops.ivf_scan(tq, tlv, tli, sel, k, device="cpu")
    fv, fi, fs = ops.fused_turn(tq, tc, tlv, tli, nprobe=nprobe, k=k,
                                device="cpu")
    assert torch.equal(sel, fs) and torch.equal(v, fv) and torch.equal(i, fi)
    _, rsel = rops.centroid_topk(jnp.asarray(q), jnp.asarray(c), nprobe,
                                 mode="ref")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(rsel))
    _check((v, i), rops.ivf_scan(jnp.asarray(q), jnp.asarray(lv),
                                 jnp.asarray(li), rsel, k, mode="ref"))


def test_plain_versions_count_no_launches():
    q, lv, li, sel = map(_t, _lists(2, 8, 4, 3, 2, RNG_SEED))
    before = (ops.centroid_topk.launches, ops.ivf_scan.launches)
    ops.centroid_topk(q, lv[0], 2, device="cpu")
    ops.ivf_scan(q, lv, li, sel, 2, device="cpu")
    assert (ops.centroid_topk.launches, ops.ivf_scan.launches) == before
    assert ref.centroid_topk(q, lv[0], 2)[1].dtype == torch.int32
