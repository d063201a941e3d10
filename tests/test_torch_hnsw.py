"""The HNSW index and the HNSW / Exact backends of repro_torch == the
reference's.

On the conftest ``small_corpus`` / ``hnsw_index`` shapes (1,200 x 32,
m = 8, ef_construction = 32) the same numpy inputs go to ``repro`` (its
own jit path on the CPU) and to the port (plain versions on CPU
tensors):

* build: the port's graph (``adj0``, ``upper_adj``, ``entry_point``,
  ``node_level``) equals the reference's exactly, for two seeds and for
  a corpus with duplicated rows (exact ties); ``insert`` continues a
  build exactly; an npz saved by either package loads in the other;
* search: ids and ndist exact, scores within 1e-5, at ef 8, 16 and 64,
  with and without an entry override, with tombstones, on the
  duplicated corpus, and on a chain graph whose queries hit the step cap
  ``4 ef + 16``; a query searched alone equals it searched in a batch
  of 32, bit for bit;
* the five cases of ``tests/test_core_hnsw.py``, on the port;
* ``HNSWBackend`` start / step / plain and their batch forms, adaptive
  on and off, the mixed first / follow-up batch, ``ExactBackend``, the
  session store's layout and ``make``'s knobs.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import backend as rbackend
from repro.core import hnsw as rhnsw
from repro.core import toploc as rtl
from repro_torch import convert
from repro_torch.core import backend as tbackend
from repro_torch.core import hnsw as thnsw
from repro_torch.core import ivf as tivf
from repro_torch.core import toploc as ttl
from repro_torch.kernels import ops as tops
from repro_torch.serving import hnsw_session_store

CPU = "cpu"
TOL = 1e-5
K, EF, UP = 10, 16, 2
FIELDS = ("adj0", "upper_adj", "entry_point", "node_level")


def _port(index):
    """A reference index as the port's, on the CPU."""
    return convert.hnsw_index_from_numpy(
        *(np.asarray(f) for f in index[:5]),
        deleted=None if index.deleted is None else np.asarray(index.deleted),
        device=CPU)


@pytest.fixture(scope="module")
def tindex(hnsw_index):
    return _port(hnsw_index)


@pytest.fixture(scope="module")
def queries(small_corpus):
    """32 queries: the 24 conversation turns and 8 documents."""
    return np.concatenate([small_corpus.conversations.reshape(-1, 32),
                           small_corpus.doc_vecs[1500:1508]])


def _same_graph(r, t):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(r, f)),
                              getattr(t, f).numpy()), f


def _dup_corpus(small_corpus):
    """600 rows, 200 of them duplicates of earlier rows (exact ties)."""
    x = small_corpus.doc_vecs
    return np.concatenate([x[:300], x[100:200], x[300:500], x[:100]])


# ------------------------------------------------------------------ build

@pytest.mark.parametrize("case", ["seed0", "seed1", "duplicated"])
def test_build_equals_reference(small_corpus, hnsw_index, case):
    if case == "seed0":
        ref = hnsw_index
        x = small_corpus.doc_vecs[:1200]
    elif case == "seed1":
        x = small_corpus.doc_vecs[:1200]
        ref = rhnsw.build(x, m=8, ef_construction=32, seed=1)
    else:
        x = _dup_corpus(small_corpus)
        ref = rhnsw.build(x, m=8, ef_construction=32, seed=0)
    got = thnsw.build(x, m=8, ef_construction=32, seed=int(case == "seed1"),
                      device=CPU)
    _same_graph(ref, got)
    assert got.vectors.dtype == torch.float32 and got.deleted is None
    assert got.n == ref.n and got.top_level == ref.top_level


def test_insert_continues_a_build_exactly(small_corpus, hnsw_index):
    x = small_corpus.doc_vecs[:1200]
    part = thnsw.build(x[:700], m=8, ef_construction=32, seed=0,
                       device=CPU)
    whole = thnsw.insert(part, x[700:], ef_construction=32, seed=0)
    _same_graph(hnsw_index, whole)
    assert np.array_equal(whole.vectors.numpy(), x)
    with pytest.raises(ValueError, match="level stream mismatch"):
        thnsw.insert(part, x[700:], ef_construction=32, seed=5)


def test_npz_loads_in_both_packages(tmp_path, hnsw_index, tindex):
    rpath, tpath = str(tmp_path / "r.npz"), str(tmp_path / "t.npz")
    rhnsw.save(hnsw_index, rpath)
    thnsw.save(tindex, tpath)
    a, b = thnsw.load(rpath, device=CPU), rhnsw.load(tpath)
    _same_graph(hnsw_index, a)
    _same_graph(b, tindex)
    assert np.array_equal(a.vectors.numpy(), np.asarray(hnsw_index.vectors))
    assert sorted(np.load(tpath).files) == sorted(np.load(rpath).files)


# ----------------------------------------------------------------- search

def _search_both(rindex, tindex, q, **kw):
    rv, ri, rn = rhnsw.search(rindex, jnp.asarray(q), **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    tv, ti, tn = thnsw.search(tindex, torch.from_numpy(q), **{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=TOL, rtol=0)
    assert ti.dtype == tn.dtype == torch.int32
    return tv, ti, tn


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("ef", [8, 16, 64])
def test_search_matches_reference(hnsw_index, tindex, queries, ef,
                                  override):
    kw = dict(ef=ef, k=min(ef, K))
    if override:
        entry = np.random.default_rng(ef).integers(
            0, hnsw_index.n, size=queries.shape[0]).astype(np.int32)
        kw.update(entry_override=entry, use_entry_override=True)
    _search_both(hnsw_index, tindex, queries, **kw)


def test_search_with_tombstones_matches_reference(hnsw_index, queries):
    """Tombstoned nodes keep routing the beam and leave the result: k =
    ef, so tombstoned ids come back at -inf after the live ones."""
    dead = np.zeros(hnsw_index.n, bool)
    dead[np.random.default_rng(3).choice(hnsw_index.n, 400, replace=False)] \
        = True
    rindex = hnsw_index._replace(deleted=jnp.asarray(dead))
    tv, ti, _ = _search_both(rindex, _port(rindex), queries, ef=EF, k=EF)
    assert bool(torch.isinf(tv).any())
    live = tv > float("-inf")
    assert not dead[ti.numpy()[live.numpy()]].any()


def test_search_on_duplicated_rows_matches_reference(small_corpus, queries):
    """Duplicated rows tie exactly: the descent's first maximum, the
    pick's first unexpanded entry and the merge's lax.top_k order decide
    the path."""
    x = _dup_corpus(small_corpus)
    ref = rhnsw.build(x, m=8, ef_construction=32, seed=0)
    dup_q = np.concatenate([queries[:16], x[[0, 100, 300, 400, 500, 550]]])
    _search_both(ref, _port(ref), dup_q, ef=EF, k=K)


def test_search_hits_the_step_cap_like_the_reference():
    """A chain of 200 nodes on an arc, each linked to its two
    neighbours, the query at the far end: at ef = 2 every step finds a
    better node, so the beam stops at 4 ef + 16 = 24 steps, far from the
    best node."""
    n, ef = 200, 2
    theta = np.linspace(0.0, np.pi / 2, n)
    x = np.zeros((n, 4), np.float32)
    x[:, 0], x[:, 1] = np.cos(theta), np.sin(theta)
    adj0 = np.stack([np.arange(n) - 1, np.arange(n) + 1], 1).astype(np.int32)
    adj0[adj0 >= n] = -1
    fields = (x, adj0, np.zeros((0, n, 1), np.int32), np.int32(0),
              np.zeros(n, np.int32))
    rindex = rhnsw.HNSWIndex(*(jnp.asarray(f) for f in fields))
    tindex = convert.hnsw_index_from_numpy(*fields, device=CPU)
    q = np.asarray([[0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]], np.float32)
    _, ti, tn = _search_both(rindex, tindex, q, ef=ef, k=ef)
    assert 0 < int(ti[0, 0]) < 4 * ef + 16 + 2 < n - 1     # the cap stopped
    assert int(ti[1, 0]) == 0


def test_one_query_alone_equals_it_in_a_batch(tindex, queries):
    """Bit for bit, with and without an entry override."""
    q = torch.from_numpy(queries)
    entry = torch.arange(q.shape[0], dtype=torch.int32) * 7
    for kw in (dict(), dict(entry_override=entry, use_entry_override=True)):
        v, i, nd = thnsw.search(tindex, q, ef=EF, k=K, **kw)
        for b in (0, 5, 31):
            one = {key: (val[b:b + 1] if key == "entry_override" else val)
                   for key, val in kw.items()}
            v1, i1, nd1 = thnsw.search(tindex, q[b:b + 1], ef=EF, k=K, **one)
            assert torch.equal(v1[0], v[b]) and torch.equal(i1[0], i[b])
            assert int(nd1[0]) == int(nd[b])


def test_plain_scorer_does_not_depend_on_the_batch(tindex, queries):
    """The ``dots_at`` seam: a row's scores at B = 1 and 32 are equal."""
    from repro_torch.kernels import ref as kref
    q = torch.from_numpy(queries)
    ids = torch.randint(0, tindex.n, (32, 16), generator=torch.Generator()
                        .manual_seed(0))
    full = kref.hnsw_dots(tindex.vectors)(q)(ids)
    for b in range(32):
        assert torch.equal(kref.hnsw_dots(tindex.vectors)(q[b:b + 1])(
            ids[b:b + 1])[0], full[b])


def test_search_refuses_k_past_ef(tindex, queries):
    with pytest.raises(ValueError, match="beam"):
        tops.hnsw_search(tindex.vectors, tindex.adj0, tindex.upper_adj,
                         tindex.entry_point, torch.from_numpy(queries),
                         ef=8, k=9, device=CPU)


# -------------------------------------- the five cases of test_core_hnsw

def test_graph_structure(tindex):
    adj = tindex.adj0.numpy()
    n = tindex.n
    assert adj.shape[0] == n
    real = adj[adj >= 0]
    assert real.size > 0 and real.max() < n
    rows = np.arange(n)[:, None].repeat(adj.shape[1], 1)
    assert not np.any((adj == rows) & (adj >= 0))


def test_high_ef_high_recall(tindex, small_corpus):
    docs = torch.from_numpy(small_corpus.doc_vecs[:tindex.n])
    q = torch.from_numpy(small_corpus.conversations.reshape(-1, 32)[:12])
    _, ei = tivf.exact_search(docs, q, 10)
    _, i, nd = thnsw.search(tindex, q, ef=64, k=10)
    rec = np.mean([len(set(i[b].tolist()) & set(ei[b].tolist())) / 10
                   for b in range(q.shape[0])])
    assert rec >= 0.9, rec
    assert bool((nd < tindex.n).all())


def test_recall_grows_with_ef(tindex, small_corpus):
    docs = torch.from_numpy(small_corpus.doc_vecs[:tindex.n])
    q = torch.from_numpy(small_corpus.conversations.reshape(-1, 32)[:8])
    _, ei = tivf.exact_search(docs, q, 10)
    recalls, works = [], []
    for ef in (4, 16, 64):
        k = min(ef, 10)
        _, i, nd = thnsw.search(tindex, q, ef=ef, k=k)
        recalls.append(np.mean([
            len(set(i[b].tolist()) & set(ei[b, :k].tolist())) / k
            for b in range(q.shape[0])]))
        works.append(float(nd.double().mean()))
    assert recalls[-1] >= recalls[0]
    assert works[0] < works[-1]


def test_entry_override_skips_descent(tindex, small_corpus):
    q = torch.from_numpy(small_corpus.conversations[1, :1])
    _, i_full, nd_full = thnsw.search(tindex, q, ef=16, k=5)
    _, i_ov, nd_ov = thnsw.search(tindex, q, ef=16, k=5,
                                  entry_override=i_full[:, 0],
                                  use_entry_override=True)
    assert int(nd_ov[0]) < int(nd_full[0])
    assert int(i_ov[0, 0]) == int(i_full[0, 0])


def test_save_load_roundtrip(tmp_path, tindex, small_corpus):
    p = str(tmp_path / "hnsw.npz")
    thnsw.save(tindex, p)
    back = thnsw.load(p, device=CPU)
    q = torch.from_numpy(small_corpus.conversations[0, :2])
    _, i1, _ = thnsw.search(tindex, q, ef=16, k=5)
    _, i2, _ = thnsw.search(back, q, ef=16, k=5)
    assert torch.equal(i1, i2)


# --------------------------------------------------------------- backends

def _both_equal(ref, got, ctx):
    """Scores within TOL, everything else exactly, field by field."""
    rl, gl = jax.tree.leaves(ref), [x for x in _leaves(got)]
    assert len(rl) == len(gl), ctx
    for j, (r, g) in enumerate(zip(rl, gl)):
        r, g = np.asarray(r), g.numpy()
        if j == 0:
            np.testing.assert_allclose(g, r, atol=TOL, rtol=0,
                                       err_msg=str(ctx))
        else:
            assert r.shape == g.shape and np.array_equal(r, g), (ctx, j)


def _leaves(tree):
    for x in tree:
        if isinstance(x, torch.Tensor):
            yield x
        else:
            yield from _leaves(x)


@pytest.mark.parametrize("adaptive", [False, True])
def test_hnsw_backend_matches_reference(hnsw_index, tindex, small_corpus,
                                        adaptive):
    """start / step / plain one query at a time, then start_batch /
    step_batch / plain_batch over 4 conversations: scores within TOL,
    ids, sessions and TurnStats exact."""
    convs = small_corpus.conversations
    rb = rbackend.HNSWBackend(ef=EF, up=UP, adaptive=adaptive)
    tb = tbackend.HNSWBackend(ef=EF, up=UP, adaptive=adaptive)
    rs = ts = None
    for t in range(3):
        rq, tq = jnp.asarray(convs[0, t]), torch.from_numpy(convs[0, t])
        if t == 0:
            r = rtl.start(rb, hnsw_index, rq, k=K)
            g = ttl.start(tb, tindex, tq, k=K, device=CPU)
        else:
            r = rtl.step(rb, hnsw_index, rs, rq, k=K)
            g = ttl.step(tb, tindex, ts, tq, k=K, device=CPU)
        _both_equal(r, g, ("seq", t))
        rs, ts = r[2], g[2]
    _both_equal(rtl.plain(rb, hnsw_index, jnp.asarray(convs[1, 0]), k=K),
                ttl.plain(tb, tindex, torch.from_numpy(convs[1, 0]), k=K,
                          device=CPU), "plain")
    r = rtl.start_batch(rb, hnsw_index, jnp.asarray(convs[:, 0]), k=K)
    g = ttl.start_batch(tb, tindex, torch.from_numpy(convs[:, 0]), k=K,
                        device=CPU)
    _both_equal(r, g, "start_batch")
    rs, ts = r[2], g[2]
    for t in (1, 2):
        r = rtl.step_batch(rb, hnsw_index, rs, jnp.asarray(convs[:, t]), k=K)
        g = ttl.step_batch(tb, tindex, ts, torch.from_numpy(convs[:, t]),
                           k=K, device=CPU)
        _both_equal(r, g, ("step_batch", t))
        rs, ts = r[2], g[2]
    _both_equal(rtl.plain_batch(rb, hnsw_index, jnp.asarray(convs[:, 3]),
                                k=K),
                ttl.plain_batch(tb, tindex, torch.from_numpy(convs[:, 3]),
                                k=K, device=CPU), "plain_batch")


def test_hnsw_mixed_first_and_followup_batch(hnsw_index, tindex,
                                             small_corpus):
    """``test_serving_batched.py``'s mixed wave on the port, and against
    the reference's ``step_batch`` with the same ``is_first``."""
    convs = small_corpus.conversations
    tb = tbackend.HNSWBackend(ef=EF, up=UP)
    rb = rbackend.HNSWBackend(ef=EF, up=UP)
    q0 = torch.from_numpy(convs[:, 0])
    _, _, sess0, _ = ttl.start_batch(tb, tindex, q0, k=K, device=CPU)
    first = torch.tensor([False, True, False, True])
    qmix = torch.where(first[:, None], q0, torch.from_numpy(convs[:, 1]))
    got = ttl.step_batch(tb, tindex, sess0, qmix, k=K, is_first=first,
                         device=CPU)
    mv, mi, msess, mst = got
    for b in range(4):
        if bool(first[b]):
            rv, ri, rs, rst = ttl.start(tb, tindex, q0[b], k=K, device=CPU)
        else:
            sb = ttl.HNSWSession(*(f[b] for f in sess0))
            rv, ri, rs, rst = ttl.step(tb, tindex, sb, qmix[b], k=K,
                                       device=CPU)
        assert torch.equal(mv[b], rv) and torch.equal(mi[b], ri), b
        assert int(mst.graph_dists[b]) == int(rst.graph_dists)
        assert bool(mst.refreshed[b]) == bool(rst.refreshed)
        assert int(msess.entry_point[b]) == int(rs.entry_point)
        assert int(msess.turn[b]) == int(rs.turn)
    _, _, rsess0, _ = rtl.start_batch(rb, hnsw_index, jnp.asarray(convs[:, 0]),
                                      k=K)
    ref = rtl.step_batch(rb, hnsw_index, rsess0, jnp.asarray(qmix.numpy()),
                         k=K, is_first=jnp.asarray(first.numpy()))
    _both_equal(ref, got, "mixed")


def test_hnsw_session_store_layout(tindex, hnsw_index):
    store = hnsw_session_store(tindex, n_slots=3)
    row = store.gather([0])
    assert row.entry_point.shape == (1,) and row.turn.shape == (1,)
    assert row.entry_point.dtype == torch.int32 and store.trash_slot == 3
    ref = rbackend.HNSWBackend().session_template(hnsw_index)
    got = tbackend.HNSWBackend().session_template(tindex)
    for r, g in zip(ref, got):
        assert tuple(r.shape) == tuple(g.shape)
        assert np.asarray(r).dtype == g.numpy().dtype
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        hnsw_session_store(tindex, n_slots=2, mesh=object())


def test_exact_backend_matches_reference(small_corpus):
    docs = small_corpus.doc_vecs
    q = small_corpus.conversations[:, 0]
    rb, tb = rbackend.ExactBackend(), tbackend.ExactBackend()
    r = rtl.plain_batch(rb, jnp.asarray(docs), jnp.asarray(q), k=K)
    g = ttl.plain_batch(tb, torch.from_numpy(docs), torch.from_numpy(q),
                        k=K, device=CPU)
    _both_equal(r, g, "exact")
    v, i, st = ttl.plain(tb, torch.from_numpy(docs), torch.from_numpy(q[2]),
                         k=K, device=CPU)
    assert torch.equal(v, g[0][2]) and torch.equal(i, g[1][2])
    assert int(st.i0) == -1 and not bool(st.refreshed)
    assert not tb.stateful and tb.session_template(docs) is None
    d = torch.from_numpy(docs)
    assert tb.corpus_vectors(d) is d and tb.fetch_limit(d) == d.shape[0]
    assert tb.query_dim(d) == 32


def test_make_hnsw_and_exact_like_the_reference(tindex):
    hk = tbackend.make("hnsw", ef=EF, up=UP, h=64, nprobe=3)
    assert hk == tbackend.HNSWBackend(ef=EF, up=UP)
    with pytest.raises(TypeError, match="efSearch"):
        tbackend.make("hnsw", efSearch=EF)
    with pytest.raises(TypeError, match="strict"):
        tbackend.make("hnsw", ef=EF, h=4, strict=True)
    assert tbackend.make("exact", ef=EF, h=4) == tbackend.ExactBackend()
    for name in ("hnsw", "exact"):
        ref, port = rbackend.make(name), tbackend.make(name)
        rf = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
        pf = {f.name: getattr(port, f.name)
              for f in dataclasses.fields(port)}
        assert rf == pf
        assert (type(port).name, type(port).index_kwarg,
                type(port).stateful) == (type(ref).name,
                                         type(ref).index_kwarg,
                                         type(ref).stateful)
    assert hk.fetch_limit(tindex) == EF and hk.query_dim(tindex) == 32
    assert hk.corpus_vectors(tindex) is tindex.vectors
