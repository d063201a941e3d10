"""repro_torch fused ops == the reference's, op level, float32.

The port's ``ops.fused_turn`` / ``ops.fused_scan`` on CPU tensors run
their plain PyTorch versions; the reference's run its Pallas kernels in
interpret mode and its jnp oracles.  Inputs are the integer-valued
posting lists of ``tests/test_fused.py`` (sums of small integers are
exact in f32, whatever the summation order), so values, ids, ``sel``
and flat positions must be equal, bit for bit, at the shapes that file
uses: non-tile-multiple nlist / Lmax, k above the candidates available,
an empty list, and here also a partial ``own`` mask.

The CUDA kernels themselves are held to the same plain versions in
``tests/test_torch_kernels.py`` (no JAX import, so it runs on a card).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sorting import PAD_POS

SHAPES = [(6, 10, 16, 3, 3, 4),     # p, lmax, d, b, nprobe, k
          (5, 7, 8, 1, 5, 8),       # k > real candidates
          (9, 16, 32, 4, 2, 4)]


def _mk_lists(rng, p, lmax, d, n_docs):
    """Ragged integer-valued posting lists; list 0 is always empty."""
    lv = rng.integers(-4, 5, size=(p, lmax, d)).astype(np.float32)
    li = np.full((p, lmax), -1, np.int32)
    sizes = rng.integers(0, lmax + 1, size=p)
    sizes[0] = 0
    nid = 0
    for pi in range(p):
        for l in range(sizes[pi]):
            li[pi, l] = nid % n_docs
            nid += 1
        lv[pi, sizes[pi]:] = 0
    return lv, li


def _inputs(p, lmax, d, b, nprobe):
    rng = np.random.default_rng(p * 100 + lmax)
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    cents = rng.integers(-4, 5, size=(p, d)).astype(np.float32)
    lv, li = _mk_lists(rng, p, lmax, d, n_docs=200)
    own = (rng.random((b, nprobe)) > 0.35).astype(np.int32)
    own[0, 0] = 0
    return q, cents, lv, li, own


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _eq(ref, port, what):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy(),
                                  err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["interpret", "ref"])
def test_fused_turn_matches_reference(shape, mode):
    p, lmax, d, b, nprobe, k = shape
    q, cents, lv, li, _ = _inputs(p, lmax, d, b, nprobe)
    rv, ri, rs = rops.fused_turn(jnp.asarray(q), jnp.asarray(cents),
                                 jnp.asarray(lv), jnp.asarray(li),
                                 nprobe=nprobe, k=k, mode=mode)
    tv, ti, ts = tops.fused_turn(*_t(q, cents, lv, li), nprobe=nprobe, k=k,
                                 device="cpu")
    _eq(rv, tv, "values")
    _eq(ri, ti, "ids")
    _eq(rs, ts, "sel")
    assert ti.dtype == ts.dtype == torch.int32


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_scan_matches_reference(shape, mode, masked):
    p, lmax, d, b, nprobe, k = shape
    q, cents, lv, li, own = _inputs(p, lmax, d, b, nprobe)
    _, _, sel = rops.fused_turn(jnp.asarray(q), jnp.asarray(cents),
                                jnp.asarray(lv), jnp.asarray(li),
                                nprobe=nprobe, k=k, mode="ref")
    sel = np.array(sel)
    r_own = jnp.asarray(own) if masked else None
    t_own = torch.from_numpy(own) if masked else None
    rv, ri, rp = rops.fused_scan(jnp.asarray(q), jnp.asarray(lv),
                                 jnp.asarray(li), jnp.asarray(sel), k,
                                 own=r_own, mode=mode)
    tv, ti, tp = tops.fused_scan(*_t(q, lv, li, sel), k, own=t_own,
                                 device="cpu")
    _eq(rv, tv, "values")
    _eq(ri, ti, "ids")
    # the oracle leaves positions undefined on -inf lanes; the kernels
    # (interpret and CUDA) and the port's plain version write PAD_POS
    fin = np.isfinite(np.asarray(rv))
    _eq(np.asarray(rp)[fin], tp[torch.from_numpy(fin)], "pos")
    assert bool((tp[~torch.from_numpy(fin)] == PAD_POS).all())
    if mode == "interpret":
        _eq(rp, tp, "pos incl. pads")


def test_fused_turn_all_probed_lists_empty():
    """Every probed list empty -> all ids -1, scores -inf, pads PAD_POS."""
    rng = np.random.default_rng(0)
    p, lmax, d, b = 4, 6, 8, 2
    q = rng.normal(size=(b, d)).astype(np.float32)
    cents = rng.normal(size=(p, d)).astype(np.float32)
    lv = np.zeros((p, lmax, d), np.float32)
    li = np.full((p, lmax), -1, np.int32)
    v, i, sel = tops.fused_turn(*_t(q, cents, lv, li), nprobe=2, k=4,
                                device="cpu")
    assert bool((i == -1).all()) and bool(torch.isneginf(v).all())
    _, _, pos = tops.fused_scan(*_t(q, lv, li), sel, 4, device="cpu")
    assert bool((pos == PAD_POS).all())


# k = 1,000 (the depth TREC CAsT runs are scored at) with nprobe 64 and
# 256: the reference's jnp oracle (its Pallas kernels, in interpret mode,
# are too slow at this width on the CPU)
THOUSAND = [(300, 40, 8, 2, 64, 1000), (600, 20, 8, 1, 256, 1000)]


@pytest.mark.parametrize("shape", THOUSAND)
def test_fused_turn_and_scan_match_reference_at_k_1000(shape):
    p, lmax, d, b, nprobe, k = shape
    q, cents, lv, li, own = _inputs(p, lmax, d, b, nprobe)
    rv, ri, rs = rops.fused_turn(jnp.asarray(q), jnp.asarray(cents),
                                 jnp.asarray(lv), jnp.asarray(li),
                                 nprobe=nprobe, k=k, mode="ref")
    tv, ti, ts = tops.fused_turn(*_t(q, cents, lv, li), nprobe=nprobe, k=k,
                                 device="cpu")
    _eq(rv, tv, "values")
    _eq(ri, ti, "ids")
    _eq(rs, ts, "sel")
    rv, ri, _ = rops.fused_scan(jnp.asarray(q), jnp.asarray(lv),
                                jnp.asarray(li), jnp.asarray(np.array(rs)),
                                k, own=jnp.asarray(own), mode="ref")
    tv, ti, _ = tops.fused_scan(*_t(q, lv, li), ts, k,
                                own=torch.from_numpy(own), device="cpu")
    _eq(rv, tv, "scan values")
    _eq(ri, ti, "scan ids")
