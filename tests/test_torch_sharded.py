"""Corpus sharding in repro_torch: the merges, the mesh, the placement,
and sharded conversations bit for bit equal to unsharded ones.

The contract (``repro_torch/distributed/retrieval.py``, the reference's
``retrieval.py:40-55``): splitting the corpus over a mesh — IVF posting
lists, PQ code lists and the re-rank corpus, the HNSW vectors — changes
where distances are computed and nothing else.  On the workload of
``tests/test_sharded_retrieval.py`` (1,500 docs, d 32, p 32, PQ m 8,
HNSW m 8 / ef_construction 32), 8-turn conversations at S = 1, 2, 3, 4
and 8 shards of the CPU device:

* f32 (unfused and fused) and the fused IVF-PQ turns at every
  precision: scores, ids, every ``TurnStats`` counter and the sessions
  ``torch.equal`` to the port's unsharded run, sequential and batched;
  and ids, ``sel`` (the sessions' anchors and caches), counters exact,
  scores within 1e-5 against the reference's live unsharded run;
* the quantised fused IVF scan breaks the merge's ties by candidate
  rank, as the reference does: held to the reference's sharded run.

The reference's sharded path needs several JAX devices; the tier-1 run
has one.  ``ref_sharded`` runs it once, in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, at S = 2 and 4
(its own timeout: ``REF_TIMEOUT`` s), and writes what it got to an npz:
the conversations of every path and the reference's merges on tied and
±0 inputs.  Nothing of the reference is changed for it.

Everything of the port runs on CPU tensors (the kernels' plain
versions).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import hnsw as rhnsw
from repro.core import ivf as rivf
from repro.core import pq as rpq
from repro.core import toploc as rtl
from repro.core import topk as rtopk
from repro.core.backend import (HNSWBackend as RHNSW, IVFBackend as RIVF,
                                IVFPQBackend as RPQ)
from repro.data import synthetic as SY
from repro.distributed import retrieval as rret
from repro_torch import convert
from repro_torch.core import toploc as ttl
from repro_torch.core import topk as ttopk
from repro_torch.core.backend import HNSWBackend, IVFBackend, IVFPQBackend
from repro_torch.distributed import collectives as C
from repro_torch.distributed import retrieval as R
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sorting import PAD_POS

T = 8
K, H, NPROBE, EF, UP, RR, ALPHA = 10, 16, 4, 16, 2, 32, 0.3
SHARDS = (1, 2, 3, 4, 8)
REF_SHARDS = (2, 4)
REF_TIMEOUT = 120
TOL = 1e-5
CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

#: (name, backend, conversation, fused precision or None)
PATHS = [("ivf", "ivf", 0, None), ("ivf-f32", "ivf", 0, "f32"),
         ("ivf-bf16", "ivf", 0, "bf16"), ("ivf-int8", "ivf", 0, "int8"),
         ("pq", "ivf_pq", 1, None), ("pq-f32", "ivf_pq", 1, "f32"),
         ("pq-bf16", "ivf_pq", 1, "bf16"), ("pq-int8", "ivf_pq", 1, "int8"),
         ("hnsw", "hnsw", 2, None)]
PATH = {p[0]: p for p in PATHS}
#: paths whose sharded turns equal the unsharded ones at any S (the
#: quantised IVF scan merges by rank)
EQUAL = [p[0] for p in PATHS if p[0] not in ("ivf-bf16", "ivf-int8")]


def _mesh(s):
    return R.retrieval_mesh(s, devices=[CPU] * s)


# ---------------------------------------------------------------------------
# workload and indexes (the reference's, converted)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wl8():
    return SY.make_workload(SY.WorkloadConfig(
        n_docs=1500, d=32, n_topics=16, n_conversations=4,
        turns_per_conversation=T, seed=7))


@pytest.fixture(scope="module")
def ridx(wl8):
    idx = rivf.build(jnp.asarray(wl8.doc_vecs), p=32, iters=4,
                     key=jax.random.PRNGKey(0))
    pqi = rpq.build_ivf_pq(idx, jnp.asarray(wl8.doc_vecs), m=8, iters=4,
                           key=jax.random.PRNGKey(0))
    g = rhnsw.build(wl8.doc_vecs, m=8, ef_construction=32, seed=0)
    return {"ivf": idx, "ivf_pq": pqi, "hnsw": g}


@pytest.fixture(scope="module")
def tidx(ridx):
    return {"ivf": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in ridx["ivf"]), device=CPU),
            "ivf_pq": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in ridx["ivf_pq"]), device=CPU),
            "hnsw": convert.hnsw_index_from_numpy(
                *(np.asarray(f) for f in ridx["hnsw"][:5]), device=CPU)}


def _backend(pkg, name):
    _, backend, _, prec = PATH[name]
    if backend == "hnsw":
        return (HNSWBackend if pkg == "t" else RHNSW)(ef=EF, up=UP)
    fused = None
    if prec is not None:
        fused = (ttl.FusedTurn(precision=prec) if pkg == "t"
                 else rtl.FusedTurn(precision=prec, mode="ref"))
    kw = dict(h=H, nprobe=NPROBE, alpha=ALPHA, fused=fused)
    if backend == "ivf_pq":
        return (IVFPQBackend if pkg == "t" else RPQ)(rerank=RR, **kw)
    return (IVFBackend if pkg == "t" else RIVF)(**kw)


def _sess_fields(sess):
    """The session fields that carry the selection: the IVF family's
    centroid cache and anchor, HNSW's entry point."""
    names = ("cache_ids", "anchor_sel") if hasattr(sess, "anchor_sel") \
        else ("entry_point",)
    return tuple(np.asarray(getattr(sess, n)) for n in names)


def _conversation(drive, bk, index, utts):
    """An 8-turn conversation: [(v, i, stats (6,), session fields)]."""
    v, i, s, st = drive.start(bk, index, utts[0], k=K)
    out = [(v, i, st, s)]
    for t in range(1, T):
        v, i, s, st = drive.step(bk, index, s, utts[t], k=K)
        out.append((v, i, st, s))
    return out


class _PortDrive:
    @staticmethod
    def start(bk, index, q, *, k):
        return ttl.start(bk, index, q, k=k, device=CPU)

    @staticmethod
    def step(bk, index, s, q, *, k):
        return ttl.step(bk, index, s, q, k=k, device=CPU)


def _port_conv(bk, index, utts):
    return _conversation(_PortDrive, bk, index,
                         torch.from_numpy(np.ascontiguousarray(utts)))


def _port_batched(bk, index, utts):
    """The conversations of ``utts`` (B, T, d) as B-row batches: turn 0
    through ``start_batch``, then ``step_batch`` with every row's
    session (row 1 enters late: a first turn at t = 1)."""
    q = torch.from_numpy(np.ascontiguousarray(utts))
    b = q.shape[0]
    rows = [[] for _ in range(b)]
    v, i, sess, st = ttl.start_batch(bk, index, q[:, 0], k=K, device=CPU)
    for r in range(b):
        rows[r].append((v[r], i[r], ttl.TurnStats(*(x[r] for x in st))))
    for t in range(1, T):
        first = torch.zeros(b, dtype=torch.bool)
        if t == 1:
            first[1] = True
        qt = torch.where(first[:, None], q[:, 0], q[:, t])
        v, i, sess, st = ttl.step_batch(bk, index, sess, qt, k=K,
                                        is_first=first, device=CPU)
        for r in range(b):
            rows[r].append((v[r], i[r],
                            ttl.TurnStats(*(x[r] for x in st))))
    return rows


def _equal(a, b, what):
    for t, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x[0], y[0]), (what, t, "scores")
        assert torch.equal(x[1].to(torch.int32), y[1].to(torch.int32)), \
            (what, t, "ids")
        for f, p, q in zip(ttl.TurnStats._fields, x[2], y[2]):
            assert torch.equal(p, q), (what, t, f)
        if len(x) > 3:
            for p, q in zip(_sess_fields(x[3]), _sess_fields(y[3])):
                np.testing.assert_array_equal(p, q, err_msg=f"{what} {t}")


def _against_reference(port, ref, what):
    """ids, sel (the session fields) and counters exact, scores 1e-5."""
    for t, (x, y) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(x[1].numpy(), np.asarray(y[1]),
                                      err_msg=f"{what} t{t} ids")
        np.testing.assert_allclose(x[0].numpy(), np.asarray(y[0]),
                                   rtol=0, atol=TOL,
                                   err_msg=f"{what} t{t} scores")
        np.testing.assert_array_equal(
            np.stack([np.asarray(s).astype(np.int64) for s in x[2]]),
            np.stack([np.asarray(s).astype(np.int64) for s in y[2]]),
            err_msg=f"{what} t{t} counters")
        for p, q in zip(_sess_fields(x[3]), y[3]):
            np.testing.assert_array_equal(p, q, err_msg=f"{what} t{t} sel")


@pytest.fixture(scope="module")
def unsharded(tidx, wl8):
    """The port's unsharded conversation of every path."""
    out = {}
    for name, backend, c, _ in PATHS:
        out[name] = _port_conv(_backend("t", name), tidx[backend],
                               wl8.conversations[c])
    return out


@pytest.fixture(scope="module")
def reference(ridx, wl8):
    """The reference's live unsharded conversation of every f32 path,
    as numpy: [(v, i, stats, session fields)]."""
    out = {}
    for name, backend, c, prec in PATHS:
        if prec in ("bf16", "int8"):
            continue
        conv = _conversation(rtl, _backend("r", name), ridx[backend],
                             jnp.asarray(wl8.conversations[c]))
        out[name] = [(np.asarray(v), np.asarray(i),
                      tuple(np.asarray(s) for s in st), _sess_fields(s_))
                     for v, i, st, s_ in conv]
    return out


# ---------------------------------------------------------------------------
# the reference's sharded path, in a child process with 8 host devices
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import hnsw, ivf, pq, toploc, topk
from repro.core.backend import HNSWBackend, IVFBackend, IVFPQBackend
from repro.distributed import retrieval as R

z = dict(np.load(sys.argv[1]))
K, H, NPROBE, EF, UP, RR, ALPHA, T = (int(z["K"]), int(z["H"]),
    int(z["NPROBE"]), int(z["EF"]), int(z["UP"]), int(z["RR"]),
    float(z["ALPHA"]), int(z["T"]))
idx = {"ivf": ivf.IVFIndex(*(jnp.asarray(z[f"ivf{j}"]) for j in range(4))),
       "ivf_pq": pq.IVFPQIndex(*(jnp.asarray(z[f"pq{j}"]) for j in range(6))),
       "hnsw": hnsw.HNSWIndex(*(jnp.asarray(z[f"hnsw{j}"]) for j in range(5)))}
out = {}
for s in [int(x) for x in z["shards"]]:
    mesh = R.retrieval_mesh(s)
    for name in [str(x) for x in z["paths"]]:
        backend, c, prec = str(z[f"{name}/backend"]), int(z[f"{name}/conv"]), \
            str(z[f"{name}/prec"])
        fused = None if prec == "none" else toploc.FusedTurn(
            precision=prec, mode="ref")
        if backend == "hnsw":
            bk = HNSWBackend(ef=EF, up=UP)
        elif backend == "ivf":
            bk = IVFBackend(h=H, nprobe=NPROBE, alpha=ALPHA, fused=fused)
        else:
            bk = IVFPQBackend(h=H, nprobe=NPROBE, alpha=ALPHA, rerank=RR,
                              fused=fused)
        sbk, sidx = R.shard_backend(mesh, bk, idx[backend])
        utts = jnp.asarray(z["convs"][c])
        vs, is_, sts, sel = [], [], [], []
        v, i, ss, st = toploc.start(sbk, sidx, utts[0], k=K)
        for t in range(T):
            if t:
                v, i, ss, st = toploc.step(sbk, sidx, ss, utts[t], k=K)
            vs.append(np.asarray(v)); is_.append(np.asarray(i))
            sts.append(np.stack([np.asarray(x).astype(np.int64) for x in st]))
            sel.append(np.concatenate(
                [np.asarray(ss.cache_ids).ravel(), np.asarray(ss.anchor_sel).ravel()]
                if backend != "hnsw" else [np.asarray(ss.entry_point).ravel()]))
        key = f"{name}/S{s}"
        out[key + "/v"], out[key + "/i"] = np.stack(vs), np.stack(is_)
        out[key + "/stats"], out[key + "/sel"] = np.stack(sts), np.stack(sel)
    # the merges, on each input set of the parent's
    for j in range(int(z["n_merge"])):
        v, p, i = (jnp.asarray(z[f"merge{j}/{f}/S{s}"]) for f in "vpi")
        kk = int(z[f"merge{j}/k"])
        spec = P(None, "model")
        f_ord = compat.shard_map(
            lambda v, p, i: topk.distributed_topk_ordered(v, p, i, kk, "model"),
            mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=(P(None, None), P(None, None)), check_vma=False)
        f_un = compat.shard_map(
            lambda v, i: topk.distributed_topk(v, i, kk, "model"),
            mesh=mesh, in_specs=(spec, spec),
            out_specs=(P(None, None), P(None, None)), check_vma=False)
        for tag, (a, b) in (("ordered", f_ord(v, p, i)), ("plain", f_un(v, i))):
            out[f"merge{j}/{tag}/S{s}/v"] = np.asarray(a)
            out[f"merge{j}/{tag}/S{s}/i"] = np.asarray(b)
np.savez(sys.argv[2], **out)
"""


def _merge_inputs():
    """Per-shard top lists with ties across shards (integer scores) and
    with +0.0 / -0.0 (and pads): [(k, {S: (v, p, i) (B, S·w)})]."""
    rng = np.random.default_rng(3)
    cases = []
    for kind in ("ties", "signed_zeros"):
        k, w, b = 6, 5, 3
        per = {}
        for s in REF_SHARDS:
            vs, ps, is_ = [], [], []
            for sh in range(s):
                if kind == "ties":
                    v = rng.integers(-2, 3, size=(b, w)).astype(np.float32)
                else:
                    v = rng.choice(np.asarray([0.0, -0.0, 1.0, -1.0],
                                              np.float32), size=(b, w))
                    v[:, -1] = -np.inf                      # a pad lane
                p = rng.permutation(1000)[:b * w].reshape(b, w) \
                    .astype(np.int32)
                # each shard's list sorted as its local top-k: (score desc
                # in lax.top_k's order, position asc)
                key = [sorted(range(w), key=lambda j: (
                    -float(v[r, j]), int(np.signbit(v[r, j])),
                    int(p[r, j]))) for r in range(b)]
                key = np.asarray(key)
                v, p = np.take_along_axis(v, key, 1), \
                    np.take_along_axis(p, key, 1)
                p = np.where(np.isneginf(v), PAD_POS, p).astype(np.int32)
                i = (p + 10 * sh).astype(np.int32)
                vs.append(v), ps.append(p), is_.append(i)
            per[s] = tuple(np.concatenate(x, 1) for x in (vs, ps, is_))
        cases.append((k, per))
    return cases


MERGES = _merge_inputs()


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory, ridx, wl8):
    """The reference's sharded conversations at S = 2 and 4 and its
    merges, from a child process with 8 forced host devices."""
    d = tmp_path_factory.mktemp("ref_sharded")
    inp, out = d / "in.npz", d / "out.npz"
    z = dict(K=K, H=H, NPROBE=NPROBE, EF=EF, UP=UP, RR=RR, ALPHA=ALPHA, T=T,
             shards=np.asarray(REF_SHARDS), convs=wl8.conversations,
             paths=np.asarray([p[0] for p in PATHS]),
             n_merge=len(MERGES))
    for j, f in enumerate(ridx["ivf"]):
        z[f"ivf{j}"] = np.asarray(f)
    for j, f in enumerate(ridx["ivf_pq"]):
        z[f"pq{j}"] = np.asarray(f)
    for j, f in enumerate(ridx["hnsw"][:5]):
        z[f"hnsw{j}"] = np.asarray(f)
    for name, backend, c, prec in PATHS:
        z[f"{name}/backend"], z[f"{name}/conv"] = backend, c
        z[f"{name}/prec"] = prec or "none"
    for j, (k, per) in enumerate(MERGES):
        z[f"merge{j}/k"] = k
        for s, (v, p, i) in per.items():
            z[f"merge{j}/v/S{s}"], z[f"merge{j}/p/S{s}"] = v, p
            z[f"merge{j}/i/S{s}"] = i
    np.savez(inp, **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, "-c", REF_SCRIPT, str(inp), str(out)],
                   env=env, check=True, timeout=REF_TIMEOUT,
                   capture_output=True)
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def test_merge_topk_matches_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(5):
        va = rng.integers(-3, 4, size=(4, 7)).astype(np.float32)
        vb = rng.integers(-3, 4, size=(4, 5)).astype(np.float32)
        va[0, :2] = [0.0, -0.0]
        vb[0, :2] = [-0.0, 0.0]
        ia = np.arange(28, dtype=np.int32).reshape(4, 7)
        ib = 100 + np.arange(20, dtype=np.int32).reshape(4, 5)
        rv, ri = rtopk.merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)),
                                  6)
        tv, ti = ttopk.merge_topk(*(torch.from_numpy(x)
                                    for x in (va, ia, vb, ib)), 6)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(np.signbit(tv.numpy()),
                                      np.signbit(np.asarray(rv)))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


def _split(x, s):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, s, axis=1)]


@pytest.mark.parametrize("case", range(len(MERGES)))
@pytest.mark.parametrize("s", REF_SHARDS)
def test_distributed_topk_matches_the_reference(ref_sharded, case, s):
    """The shard-major merge: the reference's all_gather + lax.top_k,
    ties (±0 included) as the reference resolves them."""
    k, per = MERGES[case]
    v, _, i = per[s]
    tv, ti = ttopk.distributed_topk(_split(v, s), _split(i, s), k)
    np.testing.assert_array_equal(tv.numpy(),
                                  ref_sharded[f"merge{case}/plain/S{s}/v"])
    np.testing.assert_array_equal(ti.numpy(),
                                  ref_sharded[f"merge{case}/plain/S{s}/i"])


@pytest.mark.parametrize("s", REF_SHARDS)
def test_distributed_topk_ordered_matches_the_reference_on_ties(ref_sharded,
                                                                s):
    """Equal scores across shards go to the lower flat position, as in
    the reference's ``lax.sort`` on (-score, position)."""
    k, per = MERGES[0]
    v, p, i = per[s]
    tv, ti = ttopk.distributed_topk_ordered(_split(v, s), _split(p, s),
                                            _split(i, s), k)
    np.testing.assert_array_equal(tv.numpy(),
                                  ref_sharded[f"merge0/ordered/S{s}/v"])
    np.testing.assert_array_equal(ti.numpy(),
                                  ref_sharded[f"merge0/ordered/S{s}/i"])


@pytest.mark.parametrize("s", REF_SHARDS)
def test_distributed_topk_ordered_ranks_signed_zeros_as_lax_top_k(
        ref_sharded, s):
    """On ±0 ties the merge keeps the single-device ``lax.top_k`` order
    it must reproduce: +0.0 above -0.0, then the lower position, the
    pads (-inf, ``PAD_POS``) last.  The reference's ``lax.sort`` ranks
    ±0 equal and follows the position alone; the two agree on every
    value's magnitude."""
    k, per = MERGES[1]
    v, p, i = per[s]
    tv, ti = ttopk.distributed_topk_ordered(_split(v, s), _split(p, s),
                                            _split(i, s), k)
    flat = np.asarray(jax.lax.top_k(jnp.asarray(v), k)[0])
    np.testing.assert_array_equal(tv.numpy(), flat)
    np.testing.assert_array_equal(np.signbit(tv.numpy()), np.signbit(flat))
    for r in range(v.shape[0]):
        order = sorted(range(v.shape[1]), key=lambda j: (
            -float(v[r, j]), int(np.signbit(v[r, j])), int(p[r, j])))
        np.testing.assert_array_equal(ti[r].numpy(), i[r, order[:k]])
    np.testing.assert_array_equal(
        np.abs(tv.numpy()), np.abs(ref_sharded[f"merge1/ordered/S{s}/v"]))


@pytest.mark.parametrize("s", SHARDS)
def test_distributed_topk_ordered_breaks_ties_by_position(s):
    """Every shard offers the same score; shard 0's best has a high
    position, so the tie goes to shard 1's (the reference's test)."""
    v = [torch.tensor([[1.0, 0.5]]) for _ in range(s)]
    p = [torch.tensor([[2 * j, 2 * j + 1]], dtype=torch.int32)
         for j in range(s)]
    p[0][0, 0] = 100
    i = [torch.tensor([[10 + 2 * j, 11 + 2 * j]], dtype=torch.int32)
         for j in range(s)]
    out_v, out_i = ttopk.distributed_topk_ordered(v, p, i, 2)
    if s > 1:
        assert out_v.tolist() == [[1.0, 1.0]] and int(out_i[0, 0]) == 12
    else:
        assert out_v.tolist() == [[1.0, 0.5]] and int(out_i[0, 0]) == 10


def test_collectives_gather_and_sum_in_shard_order():
    a, b = torch.tensor([[1.0, -0.0]]), torch.tensor([[0.0, 0.0]])
    assert torch.equal(C.all_gather([a, b], CPU), torch.cat([a, b], -1))
    total = C.psum([a, b], CPU)
    assert torch.equal(total, a) and not bool(torch.signbit(total[0, 1]))
    assert C.psum([a], CPU) is a and bool(torch.signbit(a[0, 1]))


@pytest.mark.parametrize("s", (1, 2, 4))
def test_collective_building_blocks_match_the_reference(ridx, wl8, tidx, s):
    """``sharded_corpus_topk`` / ``sharded_ivf_probe`` against the
    reference's on a one-device mesh (its S = 1) and the unsharded
    answer: the sets agree at every S."""
    mesh = _mesh(s)
    q = wl8.conversations[:3, 0]
    tq = torch.from_numpy(np.ascontiguousarray(q))
    rmesh = rret.retrieval_mesh(1)
    docs = tidx["ivf_pq"].doc_vecs
    from repro.distributed import collectives as rcoll
    rv, ri = rcoll.sharded_corpus_topk(rmesh, jnp.asarray(wl8.doc_vecs),
                                       jnp.asarray(q), K)
    tv, ti = C.sharded_corpus_topk(mesh, docs, tq, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=TOL, rtol=0)
    idx = tidx["ivf"]
    _, sel = ttopk.topk(tq @ idx.centroids.T, NPROBE)
    rv, ri = rcoll.sharded_ivf_probe(
        rmesh, ridx["ivf"].list_vecs, ridx["ivf"].list_ids, jnp.asarray(q),
        jnp.asarray(sel.numpy()), K)
    tv, ti = C.sharded_ivf_probe(mesh, idx.list_vecs, idx.list_ids, tq,
                                 sel, K)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1),
                                  np.sort(np.asarray(ri), 1))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_retrieval_mesh_validates_device_count():
    with pytest.raises(ValueError, match="device"):
        R.retrieval_mesh(3, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="shards"):
        R.retrieval_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device"):
        R.retrieval_mesh(2, replicas=2, devices=[CPU] * 3)


def test_retrieval_mesh_shapes_and_submeshes():
    one = R.retrieval_mesh(1, devices=[CPU])
    assert one.devices.ndim == 1 and one.axis_names == ("model",)
    assert R.replica_submeshes(one) == [one]
    mesh = R.retrieval_mesh(2, replicas=3, devices=[CPU] * 6)
    assert mesh.devices.shape == (3, 2)
    assert mesh.axis_names == ("replica", "model")
    assert mesh.shape == {"replica": 3, "model": 2}
    subs = R.replica_submeshes(mesh)
    assert len(subs) == 3
    for sm in subs:
        assert sm.axis_names == ("model",) and sm.devices.shape == (2,)
        assert sm.leader == torch.device(CPU)
    with pytest.raises(ValueError, match="replica"):
        mesh.shard_devices
    with pytest.raises(ValueError, match="replica"):
        R.check_mesh(mesh, CPU)
    with pytest.raises(TypeError, match="RetrievalMesh"):
        R.check_mesh(object(), CPU)


def test_sharding_specs_name_the_model_axis():
    ax = SH.from_mesh(_mesh(2))
    assert ax.model == "model" and ax.replica is None
    specs = SH.ivf_pq_index_specs(ax)
    assert specs.list_codes == SH.P("model", None, None)
    assert specs.doc_vecs == SH.P("model", None)
    assert specs.codewords[0] is None
    assert SH.hnsw_index_specs(ax).adj0 == SH.P(None, None)
    assert SH.from_mesh(R.retrieval_mesh(1, replicas=2, devices=[CPU] * 2)
                        ).replica == "replica"


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", (3, 7))
def test_short_last_shard_is_inert(tidx, wl8, s):
    """p = 32 lists over 3 (11, 11, 10) or 7 shards (5 x 5, 2), and
    1,500 HNSW rows: views of the unsharded tensors (no byte copied), a
    foreign probe clipped inside the shard's real lists, results equal
    to the unsharded scan."""
    mesh = _mesh(s)
    idx = tidx["ivf"]
    sidx = R.shard_ivf_index(mesh, idx)
    assert sidx.centroids is idx.centroids and R.placed_bytes(sidx) == 0
    per = -(-idx.p // s)
    assert [p.shape[0] for p in sidx.list_vecs.parts] == \
        [min(per, idx.p - j * per) for j in range(s)]
    for j, part in enumerate(sidx.list_vecs.parts):
        assert part.data_ptr() == idx.list_vecs[j * per].data_ptr()
    q = torch.from_numpy(np.ascontiguousarray(wl8.conversations[:3, 0]))
    _, sel = ttopk.topk(q @ idx.centroids.T, 12)
    sel = sel.to(torch.int32)
    from repro_torch.core import ivf as tivf
    want = tivf._scan_lists(idx, q, sel, K)
    got = R.ShardedIVFScan()(sidx, q, sel, K)
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))
    pqi = R.shard_ivf_pq_index(mesh, tidx["ivf_pq"])
    assert R.placed_bytes(pqi) == 0
    assert pqi.doc_vecs.shape == tidx["ivf_pq"].doc_vecs.shape
    rows = torch.tensor([[0, 1499, 700]])
    assert torch.equal(pqi.doc_vecs[rows], tidx["ivf_pq"].doc_vecs[rows])
    g = R.shard_hnsw_index(mesh, tidx["hnsw"])
    assert g.vectors.n == 1500 and g.adj0 is tidx["hnsw"].adj0


def test_shards_gather_rows_from_their_owners():
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    x[4, 1] = -0.0
    sh = SH.split_rows(x, [CPU] * 4)
    assert [p.shape[0] for p in sh.parts] == [3, 3, 3, 1]
    ids = torch.tensor([[9, 0, 4], [3, 3, 8]])
    copy = SH.Shards(sh.parts, sh.per)               # no whole: owners
    for s in (sh, copy):
        got = s[ids]
        assert torch.equal(got, x[ids])
    assert bool(torch.signbit(copy[torch.tensor([4])][0, 1]))


def test_split_over_two_devices_leaves_the_leader_its_share(tidx):
    """Shards on a device other than the tensor's: the leader's part is
    a tensor of its own, 1/S of the storage, and nothing pins the
    unsharded tensor; ``placed_bytes`` counts every part it allocated.
    ``meta`` stands in for a second card."""
    mesh = R.RetrievalMesh(((torch.device(CPU), torch.device("meta")),))
    x = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    sh = SH.split_rows(x, mesh.shard_devices)
    assert sh.whole is None and sh.added == x.numel() * 4
    lead = sh.parts[0]
    assert lead.untyped_storage().nbytes() == x.numel() * 4 // 2
    assert torch.equal(lead, x[:5]) and sh.parts[1].device.type == "meta"
    idx = tidx["ivf"]
    sidx = R.shard_ivf_index(mesh, idx)
    lv = idx.list_vecs
    assert sidx.list_vecs.parts[0].untyped_storage().nbytes() == \
        lv.numel() * lv.element_size() // 2
    assert R.placed_bytes(sidx) == sum(
        t.numel() * t.element_size()
        for t in (idx.list_vecs, idx.list_ids, idx.list_sizes))
    assert sidx.centroids is idx.centroids


def test_frozen_sharded_engine_drops_the_unsharded_index(tidx):
    """A frozen engine over a mesh keeps only the placed index: once the
    caller drops the unsharded one, its posting lists are freed."""
    import gc
    import weakref
    from repro_torch.serving.engine import (ConversationalSearchEngine,
                                            ServingConfig)
    idx = tidx["ivf"]
    own = type(idx)(*(t.clone() for t in idx))
    gone = weakref.ref(own.list_vecs)
    mesh = R.RetrievalMesh(((torch.device(CPU), torch.device("meta")),))
    eng = ConversationalSearchEngine(ServingConfig(backend="ivf", mesh=mesh),
                                     ivf_index=own, device=CPU)
    del own
    gc.collect()
    assert gone() is None
    assert eng.index.list_vecs.whole is None


def test_per_shard_list_work_partitions_total(tidx, wl8):
    """Per-shard work sums to the single-device total, shrinks with the
    shard count and equals the reference's helper."""
    sizes = tidx["ivf"].list_sizes.numpy()
    q = torch.from_numpy(wl8.conversations[0, 0])
    _, sel = ttopk.topk(tidx["ivf"].centroids @ q, 16)
    sel = sel.numpy()
    total = sizes[sel].sum()
    for s in SHARDS:
        work = R.per_shard_list_work(sizes, sel, s)
        assert work.shape == (s,) and work.sum() == total
        np.testing.assert_array_equal(
            work, rret.per_shard_list_work(sizes, sel, s))
    assert R.per_shard_list_work(sizes, sel, 8).max() < total


def test_shard_backend_plugs_the_scan_and_keeps_fused(tidx):
    mesh = _mesh(2)
    fused = ttl.FusedTurn(precision="bf16")
    bk, idx = R.shard_backend(mesh, IVFBackend(fused=fused), tidx["ivf"])
    assert isinstance(bk.scan, R.ShardedIVFScan) and bk.scan.fused is fused
    assert bk.fused is fused
    bk, _ = R.shard_backend(mesh, HNSWBackend(), tidx["hnsw"])
    assert isinstance(bk.search, R.ShardedHNSWSearch)
    from repro_torch.core.backend import ExactBackend
    ex = ExactBackend()
    assert R.shard_backend(mesh, ex, tidx["ivf_pq"].doc_vecs) == \
        (ex, tidx["ivf_pq"].doc_vecs)


# ---------------------------------------------------------------------------
# conversations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", [p[0] for p in PATHS])
def test_sharded_conversation_bit_identical(tidx, wl8, unsharded, reference,
                                            name, s):
    """Sequential 8-turn conversations: sharded == unsharded bit for bit
    (sessions included) where the contract holds (f32, and every
    fused IVF-PQ precision), and the reference's unsharded run within
    its tolerances at f32."""
    _, backend, c, prec = PATH[name]
    sbk, sidx = R.shard_backend(_mesh(s), _backend("t", name), tidx[backend])
    got = _port_conv(sbk, sidx, wl8.conversations[c])
    if name in EQUAL or s == 1:
        _equal(got, unsharded[name], (name, s))
    if name in reference:
        _against_reference(got, reference[name], (name, s))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", [p[0] for p in PATHS])
def test_sharded_batched_turns_bit_identical(tidx, wl8, name, s):
    """Batched turns (a late first turn mixed in): sharded == unsharded
    bit for bit, and each row == the sharded sequential conversation."""
    _, backend, c, _ = PATH[name]
    bk = _backend("t", name)
    utts = wl8.conversations[:3]
    sbk, sidx = R.shard_backend(_mesh(s), bk, tidx[backend])
    got = _port_batched(sbk, sidx, utts)
    if name in EQUAL or s == 1:
        want = _port_batched(bk, tidx[backend], utts)
        for r in range(3):
            _equal(got[r], want[r], (name, s, r))
    seq = _port_conv(sbk, sidx, utts[0])
    _equal(got[0], [x[:3] for x in seq], (name, s, "seq"))


@pytest.mark.parametrize("s", REF_SHARDS)
@pytest.mark.parametrize("name", [p[0] for p in PATHS])
def test_sharded_conversation_matches_the_reference_sharded(
        ref_sharded, tidx, wl8, name, s):
    """Against the reference's own sharded run (child process): ids,
    sel and counters exact, scores within 1e-5, at every precision —
    the quantised IVF merge's rank ties included."""
    _, backend, c, _ = PATH[name]
    sbk, sidx = R.shard_backend(_mesh(s), _backend("t", name), tidx[backend])
    got = _port_conv(sbk, sidx, wl8.conversations[c])
    key = f"{name}/S{s}"
    np.testing.assert_array_equal(np.stack([x[1].numpy() for x in got]),
                                  ref_sharded[key + "/i"])
    np.testing.assert_allclose(np.stack([x[0].numpy() for x in got]),
                               ref_sharded[key + "/v"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(
        np.stack([np.stack([np.asarray(a).astype(np.int64) for a in x[2]])
                  for x in got]), ref_sharded[key + "/stats"])
    np.testing.assert_array_equal(
        np.stack([np.concatenate([f.ravel() for f in _sess_fields(x[3])])
                  for x in got]), ref_sharded[key + "/sel"])


@pytest.mark.parametrize("s", (2, 3, 8))
def test_sharded_hnsw_dots_equal_the_unsharded_ones(tidx, wl8, s):
    """The sharded scorer (the owner's dot summed with exact zeros in
    shard order) gives the unsharded dots, a zero row included."""
    vec = tidx["hnsw"].vectors.clone()
    vec[5] = 0.0
    q = torch.from_numpy(np.ascontiguousarray(wl8.conversations[:2, 0]))
    sh = SH.split_rows(vec, [CPU] * s)
    ids = torch.tensor([[5, 0, 1499, 600], [1, 2, 3, 1498]])
    assert torch.equal(tref.hnsw_sharded_dots(sh.parts, sh.per)(q)(ids),
                       tref.hnsw_dots(vec)(q)(ids))
