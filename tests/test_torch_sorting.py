"""repro_torch top-k order == the reference's, on integer inputs with ties.

The port keeps one order everywhere: (value desc, position asc), the
order of ``lax.top_k`` and of the reference's tie-aware bitonic
networks.  Integer-valued inputs make every comparison exact, and heavy
ties plus ``(-inf, -1, PAD_POS)`` pads exercise the tie rule.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import topk as rtopk
from repro.kernels import sorting as rsort
from repro_torch.core import topk as ttopk
from repro_torch.kernels import sorting as tsort


def _tiles(seed, rows, n, n_pad):
    """Integer values in [-3, 3] at distinct positions, the last n_pad
    lanes of each row padding (-inf, -1, PAD_POS), rows shuffled."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, size=(rows, n)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(rows, n)).astype(np.int32)
    pos = np.stack([rng.permutation(4 * n)[:n] for _ in range(rows)]
                   ).astype(np.int32)
    v[:, n - n_pad:] = -np.inf
    ids[:, n - n_pad:] = -1
    pos[:, n - n_pad:] = tsort.PAD_POS
    perm = np.stack([rng.permutation(n) for _ in range(rows)])
    take = lambda a: np.take_along_axis(a, perm, 1)  # noqa: E731
    return take(v), take(ids), take(pos)


def _eq(ref, port):
    for r, t in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())


@pytest.mark.parametrize("n,n_pad,k", [(16, 0, 4), (16, 5, 8), (32, 12, 32),
                                       (64, 60, 16), (8, 8, 2)])
def test_block_topk_desc_tie_matches_reference(n, n_pad, k):
    v, i, p = _tiles(n + n_pad + k, 6, n, n_pad)
    ref = rsort.block_topk_desc_tie(jnp.asarray(v), jnp.asarray(i),
                                    jnp.asarray(p), k)
    port = tsort.block_topk_desc_tie(torch.from_numpy(v),
                                     torch.from_numpy(i),
                                     torch.from_numpy(p), k)
    _eq(ref, port)


@pytest.mark.parametrize("k,pads", [(4, (0, 0)), (8, (3, 6)), (16, (16, 2))])
def test_merge_topk_desc_tie_matches_reference(k, pads):
    sa = _tiles(k + pads[0], 5, 2 * k, pads[0])
    sb = _tiles(k + pads[1] + 1, 5, 2 * k, pads[1])
    # every real candidate has its own position, across both tiles too
    sb[2][sb[2] != tsort.PAD_POS] += 8 * k
    # two sorted k-tiles, as the kernels hold them
    a = rsort.block_topk_desc_tie(*map(jnp.asarray, sa), k)
    b = rsort.block_topk_desc_tie(*map(jnp.asarray, sb), k)
    ref = rsort.merge_topk_desc_tie(*a, *b)
    ta = [torch.tensor(np.asarray(x)) for x in a]
    tb = [torch.tensor(np.asarray(x)) for x in b]
    _eq(ref, tsort.merge_topk_desc_tie(*ta, *tb))


@pytest.mark.parametrize("n,k,lo,hi", [(50, 7, -2, 3), (33, 33, 0, 2),
                                       (40, 1, -1, 1), (64, 20, -5, 6)])
def test_topk_breaks_ties_like_lax_top_k(n, k, lo, hi):
    rng = np.random.default_rng(n + k)
    s = rng.integers(lo, hi, size=(9, n)).astype(np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = ttopk.topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())


def test_masked_topk_and_intersect_count_match_reference():
    rng = np.random.default_rng(3)
    s = rng.integers(-2, 3, size=(5, 30)).astype(np.float32)
    m = rng.random((5, 30)) > 0.6
    rv, ri = rtopk.masked_topk(jnp.asarray(s), jnp.asarray(m), 12)
    tv, ti = ttopk.masked_topk(torch.from_numpy(s), torch.from_numpy(m), 12)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    a = rng.permutation(40)[:10].astype(np.int32)
    b = rng.permutation(40)[:10].astype(np.int32)
    a[3] = b[5] = -1
    want = int(rtopk.intersect_count(jnp.asarray(a), jnp.asarray(b)))
    assert int(ttopk.intersect_count(torch.from_numpy(a),
                                     torch.from_numpy(b))) == want
