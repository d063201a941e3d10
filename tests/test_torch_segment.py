"""The port's mutable corpus (``repro_torch.core.segment``) against the
reference's (``repro.core.segment``).

Every case of ``tests/test_segment.py`` runs on the port, on the
reference's indexes converted (``repro_torch.convert``), and its
results are held to the reference's live output: ids, sessions and
every ``TurnStats`` counter exactly, scores within 1e-5.  The
compaction contract holds inside the port bit for bit — ``compact`` ==
``rebuild`` tensor for tensor, for ivf, ivf_pq and hnsw — and the port's
compacted indexes equal the reference's (ids, sizes, codes, vectors,
``doc_vecs``; HNSW adjacency, levels, entry point).  Beyond the
reference's cases: the merge's ±0 and cross-segment ties against the
reference's ``_merge_ordered``, a reference segment carried over
mid-mutation (``convert.segmented_index_from_numpy``), the frozen
quantisers' assignments and codes against the reference's per-doc ones,
and no mutation writing into a tensor of the index it was given
(``_version`` unchanged: the int8 scale cache, ``kernels.ops
.group_scales``, relies on it).

Everything runs on CPU tensors (the kernels' plain versions).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import backend as RB
from repro.core import hnsw as RH
from repro.core import ivf as RI
from repro.core import pq as RP
from repro.core import segment as RS
from repro.core import toploc as RT
from repro_torch import convert
from repro_torch.core import backend as B
from repro_torch.core import hnsw as H
from repro_torch.core import segment as S
from repro_torch.core import toploc

K = 5
D = 16
N = 240
CAP = 16
TOL = 1e-5
CPU = "cpu"
HKW = dict(ef_construction=32, seed=0)     # hnsw build/compact params
KNOBS = dict(h=8, nprobe=4, alpha=0.5)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    docs = rng.standard_normal((N + 24, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    return docs[:N], docs[N:]              # (base docs, add pool)


@pytest.fixture(scope="module")
def ref_indexes(corpus):
    ivf = RI.build(jnp.asarray(corpus[0]), 16, iters=4,
                   key=jax.random.PRNGKey(0))
    return {"ivf": ivf,
            "ivf_pq": RP.build_ivf_pq(ivf, jnp.asarray(corpus[0]), 8),
            "hnsw": RH.build(corpus[0], m=8, **HKW)}


@pytest.fixture(scope="module")
def indexes(ref_indexes):
    r = ref_indexes
    return {"ivf": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in r["ivf"]), device=CPU),
            "ivf_pq": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in r["ivf_pq"]), device=CPU),
            "hnsw": convert.hnsw_index_from_numpy(
                *(np.asarray(f) for f in r["hnsw"][:5]), device=CPU)}


def _make(which):
    """(reference inner backend, port inner backend, build kwargs)."""
    if which == "hnsw":
        return RB.make("hnsw", ef=16, up=2), B.make("hnsw", ef=16, up=2), HKW
    extra = dict(rerank=16) if which == "ivf_pq" else {}
    return (RB.make(which, **KNOBS, **extra), B.make(which, **KNOBS, **extra),
            {})


def _leaves(tree):
    out = []
    for x in tree:
        if isinstance(x, tuple):
            out += _leaves(x)
        else:
            out.append(x)
    return out


def _port_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and torch.equal(x, y)


def _ref_equal(ref, port):
    """A reference pytree equals the port's, array for array."""
    la = jax.tree.leaves(ref, is_leaf=lambda x: x is None)
    lb = _leaves(port)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert np.array_equal(np.asarray(x), y.numpy())


def _conversation(backend, index, queries, k=K):
    """A short conversation through the port's drivers: (v, i, stats)."""
    queries = torch.from_numpy(np.asarray(queries))
    out_v, out_i, out_s = [], [], []
    v, i, sess, st = toploc.start(backend, index, queries[0], k=k,
                                  device=CPU)
    out_v.append(v), out_i.append(i), out_s.append(st)
    for q in queries[1:]:
        v, i, sess, st = toploc.step(backend, index, sess, q, k=k,
                                     device=CPU)
        out_v.append(v), out_i.append(i), out_s.append(st)
    return (torch.stack(out_v).numpy(), torch.stack(out_i).numpy(),
            [[int(x) for x in s] for s in out_s])


def _ref_conversation(backend, index, queries, k=K):
    out_v, out_i, out_s = [], [], []
    v, i, sess, st = RT.start(backend, index, jnp.asarray(queries[0]), k=k)
    out_v.append(v), out_i.append(i), out_s.append(st)
    for q in queries[1:]:
        v, i, sess, st = RT.step(backend, index, sess, jnp.asarray(q), k=k)
        out_v.append(v), out_i.append(i), out_s.append(st)
    return (np.stack([np.asarray(x) for x in out_v]),
            np.stack([np.asarray(x) for x in out_i]),
            [[int(np.asarray(x)) for x in s] for s in out_s])


def _same_as_ref(port, ref):
    (v, i, s), (rv, ri, rs) = port, ref
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(v, rv, atol=TOL, rtol=0)
    assert s == rs


def _both(which, ref_indexes, indexes, cap=CAP):
    rinner, tinner, kw = _make(which)
    return (rinner, RS.make_segmented(rinner, ref_indexes[which], cap=cap),
            tinner, S.make_segmented(tinner, indexes[which], cap=cap), kw)


# ----------------------------------------------------- empty delta

@pytest.mark.parametrize("which", ["ivf", "ivf_pq", "hnsw"])
def test_empty_delta_reproduces_inner_bitwise(which, corpus, ref_indexes,
                                              indexes):
    """A cap-row delta at fill 0 changes no bit of scores, ids or
    TurnStats relative to the unwrapped backend; both equal the
    reference's wrapped conversation."""
    rinner, rseg, inner, seg, _ = _both(which, ref_indexes, indexes)
    wrap = S.SegmentedBackend(inner=inner)
    qs = corpus[0][3:6]
    v1, i1, s1 = _conversation(inner, indexes[which], qs)
    v2, i2, s2 = _conversation(wrap, seg, qs)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    assert s1 == s2
    _same_as_ref((v2, i2, s2), _ref_conversation(
        RS.SegmentedBackend(inner=rinner), rseg, qs))


# ------------------------------------------- compaction bit-identity

@pytest.mark.parametrize("which", ["ivf", "ivf_pq", "hnsw"])
def test_compact_bit_identical_to_rebuild(which, corpus, ref_indexes,
                                          indexes):
    """compact() == rebuild() tensor for tensor and at the query level
    after adds + deletes; both equal the reference's compacted index,
    and the served turns equal the reference's."""
    rinner, rseg, inner, seg, kw = _both(which, ref_indexes, indexes)
    base_docs, pool = corpus
    seg, ids = S.add_documents(seg, pool[:6])
    rseg, _ = RS.add_documents(rseg, pool[:6])
    assert list(ids) == list(range(N, N + 6))
    dead = [3, N + 1]                         # one base doc, one delta doc
    seg = S.delete_documents(inner, seg, dead)
    rseg = RS.delete_documents(rinner, rseg, dead)

    compacted = S.compact(inner, seg, **kw)
    rebuilt = S.rebuild(inner, indexes[which], pool[:6], dead, cap=CAP, **kw)
    _port_equal(compacted, rebuilt)
    rcompacted = RS.compact(rinner, rseg, **kw)
    _ref_equal(rcompacted, compacted)

    wrap = S.SegmentedBackend(inner=inner)
    qs = np.concatenate([pool[:2], base_docs[9:10]])
    got = _conversation(wrap, compacted, qs)
    again = _conversation(wrap, rebuilt, qs)
    np.testing.assert_array_equal(got[0], again[0])
    np.testing.assert_array_equal(got[1], again[1])
    assert got[2] == again[2]
    assert 3 not in got[1] and N + 1 not in got[1]
    _same_as_ref(got, _ref_conversation(RS.SegmentedBackend(inner=rinner),
                                        rcompacted, qs))


@pytest.mark.parametrize("which", ["ivf", "ivf_pq", "hnsw"])
def test_multi_cycle_compaction_equals_one_rebuild(which, corpus,
                                                   ref_indexes, indexes):
    """Two add / delete / compact cycles fold to exactly the state one
    rebuild derives from the whole history, in the port as in the
    reference, and the two packages' final indexes are equal."""
    rinner, rseg, inner, seg, kw = _both(which, ref_indexes, indexes)
    _, pool = corpus
    for mod, s, inn in ((S, seg, inner), (RS, rseg, rinner)):
        s, _ = mod.add_documents(s, pool[:5])
        s = mod.delete_documents(inn, s, [N + 2, 11])
        s = mod.compact(inn, s, **kw)
        s, ids2 = mod.add_documents(s, pool[5:9])
        assert list(ids2) == list(range(N + 5, N + 9))   # monotone
        s = mod.delete_documents(inn, s, [N + 7, 4])
        if mod is S:
            seg = mod.compact(inn, s, **kw)
        else:
            rseg = mod.compact(inn, s, **kw)
    rebuilt = S.rebuild(inner, indexes[which], pool[:9],
                        [N + 2, 11, N + 7, 4], cap=CAP, **kw)
    _port_equal(seg, rebuilt)
    _ref_equal(rseg, seg)


def test_compact_without_mutations_is_identity(indexes):
    inner = B.make("ivf", **KNOBS)
    seg = S.make_segmented(inner, indexes["ivf"], cap=CAP)
    _port_equal(S.compact(inner, seg), seg)


# ----------------------------------------------- delta determinism

def test_merge_deterministic_at_any_fill_level(corpus, indexes):
    """The same live delta docs give the same merged ranking bit for bit
    at any segment capacity, and repeated queries are reproducible."""
    inner = B.make("ivf", **KNOBS)
    wrap = S.SegmentedBackend(inner=inner)
    _, pool = corpus
    q = torch.from_numpy(pool[:2])
    outs = []
    for cap in (8, 16):
        seg = S.make_segmented(inner, indexes["ivf"], cap=cap)
        seg, _ = S.add_documents(seg, pool[:3])
        outs.append(wrap.plain_batch(seg, q, k=K))
    (v1, i1, s1), (v2, i2, s2) = outs
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    _port_equal(s1, s2)
    v3, i3, _ = wrap.plain_batch(seg, q, k=K)
    assert torch.equal(v2, v3) and torch.equal(i2, i3)


def test_merge_ties_break_by_append_order(corpus, indexes):
    """Two identical delta rows score identically; the merge ranks the
    earlier append (smaller id) first."""
    inner = B.make("ivf", **KNOBS)
    wrap = S.SegmentedBackend(inner=inner)
    _, pool = corpus
    seg = S.make_segmented(inner, indexes["ivf"], cap=CAP)
    seg, _ = S.add_documents(seg, pool[:1])
    seg, _ = S.add_documents(seg, pool[:1])          # exact duplicate
    _, i, _ = wrap.plain_batch(seg, torch.from_numpy(pool[:1]), k=K)
    assert i[0, :2].tolist() == [N, N + 1]


@pytest.mark.parametrize("case", range(4))
def test_merge_signed_zeros_and_ties_as_lax_sort(case):
    """The merge is ``lax.sort`` on (-score, position), which ranks +0.0
    and -0.0 as equal: exact ties of either sign across base and delta
    break by position (base first, then delta row), not by
    ``core.topk``'s bit order.  Held to the reference's
    ``_merge_ordered`` on the same inputs."""
    rng = np.random.default_rng(case)
    b, k, kk = 3, 6, 5
    vals = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -np.inf], np.float32)
    base_v = -np.sort(-rng.choice(vals, (b, k)), axis=1).astype(np.float32)
    base_i = rng.integers(0, 100, (b, k)).astype(np.int32)
    delta_v = rng.choice(vals, (b, kk)).astype(np.float32)
    delta_rows = np.stack([rng.permutation(kk) for _ in range(b)]
                          ).astype(np.int32)
    delta_i = (1000 + delta_rows).astype(np.int32)
    rv, ri = RS._merge_ordered(*(jnp.asarray(x) for x in (
        base_v, base_i, delta_v, delta_rows, delta_i)), k)
    tv, ti = S._merge_ordered(*(torch.from_numpy(x) for x in (
        base_v, base_i, delta_v, delta_rows.astype(np.int64), delta_i)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    # the signs of the zeros too
    assert np.array_equal(np.signbit(tv.numpy()), np.signbit(np.asarray(rv)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_merge_signed_zero_ranks_by_position():
    """The case of the reference check: scores [0, -0, 0, -0] at
    positions [3, 2, 1, 0] come out in position order."""
    v = torch.tensor([[0.0, -0.0]])
    d = torch.tensor([[0.0, -0.0]])
    mv, mi = S._merge_ordered(v, torch.tensor([[7, 8]], dtype=torch.int32),
                              d, torch.tensor([[1, 0]]),
                              torch.tensor([[11, 10]], dtype=torch.int32), 2)
    assert mi.tolist() == [[7, 8]]
    mv, mi = S._merge_ordered(v[:, :1], torch.tensor([[7]],
                                                     dtype=torch.int32),
                              d, torch.tensor([[1, 0]]),
                              torch.tensor([[11, 10]], dtype=torch.int32), 3)
    assert mi.tolist() == [[7, 10, 11]]


# ------------------------------------------------------- tombstones

def test_delete_masks_base_and_delta_immediately(corpus, indexes):
    inner = B.make("ivf", **KNOBS)
    wrap = S.SegmentedBackend(inner=inner)
    base_docs, pool = corpus
    seg = S.make_segmented(inner, indexes["ivf"], cap=CAP)
    seg, _ = S.add_documents(seg, pool[:2])
    qb, qd = torch.from_numpy(base_docs[17:18]), torch.from_numpy(pool[:1])
    _, i_b, _ = wrap.plain_batch(seg, qb, k=K)
    _, i_d, _ = wrap.plain_batch(seg, qd, k=K)
    assert 17 in i_b.tolist()[0] and N in i_d.tolist()[0]
    seg = S.delete_documents(inner, seg, [17, N])
    _, i_b, st = wrap.plain_batch(seg, qb, k=K)
    _, i_d, _ = wrap.plain_batch(seg, qd, k=K)
    assert 17 not in i_b.tolist()[0] and N not in i_d.tolist()[0]
    # list_sizes recomputed: the counters read it
    assert int(seg.base.list_sizes.sum()) == N - 1


def test_delete_is_idempotent_and_validated(indexes):
    inner = B.make("ivf", **KNOBS)
    seg = S.make_segmented(inner, indexes["ivf"], cap=CAP)
    seg = S.delete_documents(inner, seg, [5])
    seg2 = S.delete_documents(inner, seg, [5])
    _port_equal(seg, seg2)
    with pytest.raises(ValueError, match="unassigned"):
        S.delete_documents(inner, seg, [N])          # delta row not filled
    with pytest.raises(ValueError, match="unassigned"):
        S.delete_documents(inner, seg, [-1])


def test_hnsw_deleted_nodes_still_route_the_beam(corpus, indexes):
    """A deleted node leaves the result top-k but keeps routing; the
    graph is untouched, only the mask differs."""
    inner = B.make("hnsw", ef=16, up=2)
    base = indexes["hnsw"]
    seg = S.make_segmented(inner, base, cap=CAP)
    seg = S.delete_documents(inner, seg, [int(base.entry_point)])
    assert seg.base.deleted is not None
    for f in ("vectors", "adj0", "upper_adj", "entry_point", "node_level"):
        assert torch.equal(getattr(seg.base, f), getattr(base, f))
    wrap = S.SegmentedBackend(inner=inner)
    _, i, _ = wrap.plain_batch(seg, torch.from_numpy(corpus[0][:2]), k=K)
    assert int(base.entry_point) not in i.tolist()[0] + i.tolist()[1]


# --------------------------------------------------- hnsw insertion

def test_hnsw_insert_equals_build(corpus, ref_indexes):
    docs = corpus[0]
    partial = H.build(docs[:200], m=8, device=CPU, **HKW)
    grown = H.insert(partial, docs[200:], **HKW)
    full = H.build(docs, m=8, device=CPU, **HKW)
    _port_equal(grown, full)
    _ref_equal(ref_indexes["hnsw"], full)


def test_hnsw_insert_rejects_mismatched_stream(corpus):
    docs = corpus[0]
    partial = H.build(docs[:200], m=8, ef_construction=32, seed=0,
                      device=CPU)
    with pytest.raises(ValueError, match="level stream"):
        H.insert(partial, docs[200:], ef_construction=32, seed=1)


# ------------------------------------------------------- guard rails

def test_add_overflow_and_cap_validation(indexes, corpus):
    inner = B.make("ivf", **KNOBS)
    with pytest.raises(ValueError, match="cap"):
        S.make_segmented(inner, indexes["ivf"], cap=0)
    seg = S.make_segmented(inner, indexes["ivf"], cap=2)
    seg, _ = S.add_documents(seg, corpus[1][:2])
    with pytest.raises(ValueError, match="overflow"):
        S.add_documents(seg, corpus[1][2:3])


def test_exact_backend_unsupported(corpus):
    with pytest.raises(NotImplementedError, match="exact"):
        S.make_segmented(B.make("exact"), torch.from_numpy(corpus[0]),
                         cap=4)


def test_build_kwargs_only_apply_to_hnsw(indexes):
    inner = B.make("ivf", **KNOBS)
    seg = S.make_segmented(inner, indexes["ivf"], cap=CAP)
    with pytest.raises(TypeError, match="only apply to hnsw"):
        S.compact(inner, seg, ef_construction=32)


def test_segmented_registered_and_hashable():
    assert "segmented" in B.names()
    inner = B.make("ivf", **KNOBS)
    a = B.make("segmented", inner=inner)
    b = B.make("segmented", inner=B.make("ivf", **KNOBS))
    assert a == b and hash(a) == hash(b)
    assert a.stateful is True
    assert not B.make("segmented", inner=B.make("exact")).stateful
    assert (type(a).name, a.index_kwarg) == ("segmented", "segmented_index")
    assert B.names() == RB.names()


# ------------------------------------------- beyond the reference's

@pytest.mark.parametrize("which", ["ivf", "ivf_pq", "hnsw"])
def test_reference_segment_carried_over_mid_mutation(which, corpus,
                                                     ref_indexes, indexes):
    """A reference segment after adds and deletes, converted with
    ``convert.segmented_index_from_numpy``, serves the reference's turns
    and compacts to the reference's index."""
    rinner, rseg, inner, _, kw = _both(which, ref_indexes, indexes)
    _, pool = corpus
    rseg, _ = RS.add_documents(rseg, pool[:7])
    rseg = RS.delete_documents(rinner, rseg, [2, N + 3])
    rb = rseg.base
    if which == "hnsw":
        base = convert.hnsw_index_from_numpy(
            *(np.asarray(f) for f in rb[:5]), deleted=np.asarray(rb.deleted),
            device=CPU)
    elif which == "ivf":
        base = convert.ivf_index_from_numpy(*(np.asarray(f) for f in rb),
                                            device=CPU)
    else:
        base = convert.ivf_pq_index_from_numpy(
            *(np.asarray(f) for f in rb), device=CPU)
    seg = convert.segmented_index_from_numpy(
        base, *(np.asarray(f) for f in rseg[1:]), device=CPU)
    _ref_equal(rseg, seg)
    qs = np.concatenate([pool[1:3], pool[5:6]])
    _same_as_ref(_conversation(S.SegmentedBackend(inner=inner), seg, qs),
                 _ref_conversation(RS.SegmentedBackend(inner=rinner), rseg,
                                   qs))
    _ref_equal(RS.compact(rinner, rseg, **kw), S.compact(inner, seg, **kw))


def test_frozen_quantisers_match_the_reference_per_doc(corpus, ref_indexes,
                                                       indexes):
    """A delta doc's list (the first maximum of ``centroids @ v``) and
    PQ code equal the reference's per-doc ``_nearest_centroid`` /
    ``_encode_one`` on every doc of the test corpus, and do not depend
    on the docs beside it."""
    docs = np.concatenate(corpus)
    cents = np.asarray(ref_indexes["ivf"].centroids)
    want = [RS._nearest_centroid(cents, v) for v in docs]
    tdocs = torch.from_numpy(docs)
    got = S.nearest_centroids(indexes["ivf"].centroids, tdocs)
    assert got.tolist() == want
    assert torch.equal(S.nearest_centroids(indexes["ivf"].centroids,
                                           tdocs[5:9]), got[5:9])
    book = indexes["ivf_pq"].book
    rbook = RP.PQCodebook(ref_indexes["ivf_pq"].codewords,
                          ref_indexes["ivf_pq"].codewords.shape[0])
    codes = S.encode_rows(book, tdocs)
    want = np.stack([RS._encode_one(rbook, v) for v in docs])
    np.testing.assert_array_equal(codes.numpy(), want)
    assert torch.equal(S.encode_rows(book, tdocs[3:4]), codes[3:4])


@pytest.mark.parametrize("which", ["ivf", "ivf_pq", "hnsw"])
def test_mutations_never_write_into_the_index(which, corpus, indexes):
    """add / delete / compact / rebuild return new tensors: every tensor
    of the index they were given keeps its contents and its
    ``_version`` (the int8 scale cache keys on it)."""
    _, inner, kw = _make(which)
    _, pool = corpus
    seg = S.make_segmented(inner, indexes[which], cap=CAP)
    history = [seg]
    seg, _ = S.add_documents(seg, pool[:4])
    history.append(seg)
    seg = S.delete_documents(inner, seg, [1, N + 2])
    history.append(seg)
    seg, _ = S.add_documents(seg, pool[4:6])
    history.append(seg)
    seen = [[(t, t._version, t.clone()) for t in _leaves(s)
             if t is not None] for s in history]
    seg = S.compact(inner, seg, **kw)
    seg = S.delete_documents(inner, seg, [N + 4])
    S.add_documents(seg, pool[6:7])
    S.rebuild(inner, indexes[which], pool[:6], [1, N + 2], cap=CAP, **kw)
    for leaves in seen:
        for t, version, copy in leaves:
            assert t._version == version and torch.equal(t, copy)
