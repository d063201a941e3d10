"""Both engines serve a sharded corpus as the reference's do.

On the conftest ``small_corpus`` workload (the reference's ivf, ivf_pq
and hnsw indexes, converted), the port's ``ConversationalSearchEngine``
and ``BatchedConversationalSearchEngine`` run at ``ServingConfig(shards
= 2 or 4)`` and with a prebuilt 3-shard ``RetrievalMesh`` of the CPU
device, for ivf / ivf_pq (toploc+ fused and unfused, plain fused) and
hnsw (toploc, plain); exact passes through unsharded.  Against:

* the port's unsharded sequential engine: scores, ids and every
  ``TurnRecord`` counter bit for bit;
* the reference's sequential engine, unsharded, and its batched engine
  over a prebuilt one-device mesh (the reference's sharded path at
  S = 1; the tier-1 run has one JAX device): ids and counters exact,
  scores within 1e-5.

Plus a mutable corpus under a mesh: add → serve → delete → serve →
compact → serve, sharded == unsharded bit for bit, the compacted base
equal to the unsharded engine's, no deleted doc served; and the engine's
mesh refusals.  Everything runs on CPU tensors.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.distributed import retrieval as rret
from repro.serving import (BatchedConversationalSearchEngine as RBatched,
                           ConversationalSearchEngine as RSeq,
                           ServingConfig as RConfig)
from repro_torch import convert
from repro_torch.core import segment as S
from repro_torch.distributed import retrieval as R
from repro_torch.serving import (BatchedConversationalSearchEngine,
                                 ConversationalSearchEngine, ServingConfig,
                                 SessionStore)

K, H, NPROBE, ALPHA, RERANK, EF, UP = 10, 16, 4, 0.3, 32, 16, 2
N_CONV, TURNS = 3, 5
TOL = 1e-5
CPU = "cpu"
FIELDS = ("conv_id", "turn", "centroid_dists", "list_dists", "graph_dists",
          "code_dists", "refreshed", "i0", "cache_hit")

PATHS = [("ivf", dict(strategy="toploc+")),
         ("ivf", dict(strategy="toploc+", fused=True)),
         ("ivf", dict(strategy="plain", fused=True)),
         ("ivf_pq", dict(strategy="toploc+", fused=True)),
         ("ivf_pq", dict(strategy="toploc+")),
         ("hnsw", dict(strategy="toploc")),
         ("hnsw", dict(strategy="plain")),
         ("exact", dict(strategy="plain"))]
IDS = [f"{b}-{'-'.join(f'{k}={v}' for k, v in p.items())}" for b, p in PATHS]


@pytest.fixture(scope="module")
def tidx(ivf_index, ivf_pq_index, hnsw_index, small_corpus):
    return {"ivf_index": convert.ivf_index_from_numpy(
                *(np.asarray(f) for f in ivf_index), device=CPU),
            "ivf_pq_index": convert.ivf_pq_index_from_numpy(
                *(np.asarray(f) for f in ivf_pq_index), device=CPU),
            "hnsw_index": convert.hnsw_index_from_numpy(
                *(np.asarray(f) for f in hnsw_index[:5]), device=CPU),
            "doc_vecs": torch.from_numpy(small_corpus.doc_vecs)}


@pytest.fixture(scope="module")
def ridx(ivf_index, ivf_pq_index, hnsw_index, small_corpus):
    return {"ivf_index": ivf_index, "ivf_pq_index": ivf_pq_index,
            "hnsw_index": hnsw_index,
            "doc_vecs": jnp.asarray(small_corpus.doc_vecs)}


def _cfg(backend, **kw):
    return dict(dict(backend=backend, nprobe=NPROBE, h=H, alpha=ALPHA, k=K,
                     rerank=RERANK, ef_search=EF, up=UP), **kw)


def _serve(eng, convs, turns=range(TURNS), prefix="c"):
    """Every conversation's turns, turn-major: {(c, t): (v, i)}."""
    out = {}
    for t in turns:
        if isinstance(eng, (BatchedConversationalSearchEngine, RBatched)):
            futs = {c: eng.submit(f"{prefix}{c}", convs[c, t])
                    for c in range(N_CONV)}
            eng.drain()
            got = {c: f.result() for c, f in futs.items()}
        else:
            got = {c: eng.query(f"{prefix}{c}", convs[c, t])
                   for c in range(N_CONV)}
        for c, (v, i) in got.items():
            out[(c, t)] = (np.asarray(v), np.asarray(i))
    return out


def _records(eng):
    return sorted(tuple(getattr(r, f) for f in FIELDS) for r in eng.records)


def _same(a, b, what):
    for key in a:
        np.testing.assert_array_equal(a[key][0], b[key][0], err_msg=what)
        np.testing.assert_array_equal(a[key][1], b[key][1], err_msg=what)


def _close(port, ref, what):
    for key in port:
        np.testing.assert_array_equal(port[key][1], ref[key][1],
                                      err_msg=f"{what} {key}")
        np.testing.assert_allclose(port[key][0], ref[key][0], atol=TOL,
                                   rtol=0, err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def baselines(tidx, ridx, small_corpus):
    """Per path: the port's unsharded sequential run and the reference's
    (sequential unsharded, batched over a one-device mesh)."""
    convs = small_corpus.conversations
    out = {}
    for (backend, path), name in zip(PATHS, IDS):
        port = ConversationalSearchEngine(
            ServingConfig(**_cfg(backend, **path)), **tidx, device=CPU)
        rseq = RSeq(RConfig(**_cfg(backend, **path)), **ridx)
        rbat = RBatched(RConfig(**_cfg(backend, **path),
                                mesh=rret.retrieval_mesh(1)), **ridx,
                        n_slots=8, max_batch=4, max_wait_s=1e-4)
        jconvs = jnp.asarray(convs)
        out[name] = (_serve(port, convs), _records(port),
                     _serve(rseq, jconvs), _records(rseq),
                     _serve(rbat, jconvs), _records(rbat))
        rbat.close()
    return out


SHARDINGS = [dict(shards=2), dict(shards=4), "mesh3"]


def _sharding(kind):
    if kind == "mesh3":
        return dict(mesh=R.retrieval_mesh(3, devices=[CPU] * 3))
    return kind


@pytest.mark.parametrize("kind", SHARDINGS,
                         ids=["shards2", "shards4", "mesh3"])
@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("path", range(len(PATHS)), ids=IDS)
def test_sharded_engine_matches_unsharded_and_the_reference(
        tidx, small_corpus, baselines, path, engine, kind):
    backend, knobs = PATHS[path]
    cfg = ServingConfig(**_cfg(backend, **knobs), **_sharding(kind))
    if engine == "sequential":
        eng = ConversationalSearchEngine(cfg, **tidx, device=CPU)
    else:
        eng = BatchedConversationalSearchEngine(
            cfg, **tidx, n_slots=8, max_batch=4, max_wait_s=1e-4,
            device=CPU)
    assert eng.mesh is not None
    if backend != "exact":
        assert type(eng.index).__name__ != "Tensor"
    got = _serve(eng, small_corpus.conversations)
    port, port_rec, rseq, rseq_rec, rbat, rbat_rec = baselines[IDS[path]]
    _same(got, port, IDS[path])
    assert _records(eng) == port_rec
    _close(got, rseq, "reference sequential")
    _close(got, rbat, "reference batched, one-device mesh")
    assert _records(eng) == rseq_rec == rbat_rec


CAP = 12


@pytest.fixture(scope="module")
def pool(small_corpus):
    rng = np.random.default_rng(5)
    x = small_corpus.conversations[:N_CONV, :2].reshape(
        -1, small_corpus.doc_vecs.shape[1])
    x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mutate(eng, convs, pool, build_kw):
    """serve, add, serve, delete (a doc just served and an added one),
    serve, compact, serve: the served answers and the deleted ids."""
    out = {}
    out.update(_serve(eng, convs, [0]))
    ids = eng.add_documents(pool)
    out.update(_serve(eng, convs, [1]))
    victim = int(out[(0, 1)][1][0])
    dead = [victim, int(ids[1])]
    eng.delete_documents(dead)
    out.update(_serve(eng, convs, [2]))
    eng.compact(**build_kw)
    out.update(_serve(eng, convs, [3]))
    return out, dead


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("backend,knobs", [
    ("ivf", dict(strategy="toploc+", fused=True)),
    ("ivf_pq", dict(strategy="toploc+")),
    ("hnsw", dict(strategy="toploc"))], ids=["ivf", "ivf_pq", "hnsw"])
def test_segmented_corpus_under_a_mesh(tidx, ridx, small_corpus, pool,
                                       backend, knobs, engine):
    build_kw = dict(ef_construction=32, seed=0) if backend == "hnsw" else {}
    convs = small_corpus.conversations
    cfg = _cfg(backend, segment_cap=CAP, **knobs)
    make = (ConversationalSearchEngine if engine == "sequential" else
            lambda c, **kw: BatchedConversationalSearchEngine(
                c, n_slots=8, max_batch=4, max_wait_s=1e-4, **kw))
    plain = make(ServingConfig(**cfg), **tidx, device=CPU)
    shard = make(ServingConfig(**cfg, shards=3), **tidx, device=CPU)
    want, dead = _mutate(plain, convs, pool, build_kw)
    got, dead2 = _mutate(shard, convs, pool, build_kw)
    assert dead == dead2
    _same(got, want, backend)
    assert _records(shard) == _records(plain)
    for (c, t), (_, i) in got.items():
        if t >= 2:
            assert not set(dead) & set(i.tolist()), (c, t)
    # the served base is the unsharded engine's, placed on the mesh
    base = shard.index.base
    placed = R.shard_index(shard.mesh, shard._seg_inner, plain.index.base)
    for a, b in zip(base, placed):
        if hasattr(a, "parts"):
            for x, y in zip(a.parts, b.parts):
                assert torch.equal(x, y)
        elif a is not None:
            assert torch.equal(a, b)
    assert shard.corpus_epoch == 3
    ref = RSeq(RConfig(**cfg), **ridx)
    rgot, rdead = _mutate(ref, jnp.asarray(convs), jnp.asarray(pool),
                          build_kw)
    assert rdead == dead
    _close(got, rgot, "reference")


def test_engine_mesh_refusals(tidx):
    ivf = dict(ivf_index=tidx["ivf_index"])
    with pytest.raises(TypeError, match="RetrievalMesh"):
        ConversationalSearchEngine(ServingConfig(mesh=object()), **ivf,
                                   device=CPU)
    two = R.retrieval_mesh(1, replicas=2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="replica"):
        ConversationalSearchEngine(ServingConfig(mesh=two), **ivf,
                                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            R.retrieval_mesh(2)


def test_session_store_lives_on_the_mesh_leader(tidx):
    from repro_torch.serving.sessions import (hnsw_session_store,
                                              ivf_session_store)
    mesh = R.retrieval_mesh(4, devices=[CPU] * 4)
    store = ivf_session_store(tidx["ivf_index"], h=H, nprobe=NPROBE,
                              n_slots=2, mesh=mesh)
    assert isinstance(store, SessionStore) and store.device == mesh.leader
    placed = R.shard_hnsw_index(mesh, tidx["hnsw_index"])
    assert hnsw_session_store(placed, n_slots=2, mesh=mesh).device == \
        torch.device(CPU)
    meta = R.RetrievalMesh(((torch.device("meta"),),))
    with pytest.raises(ValueError, match="leader"):
        ivf_session_store(tidx["ivf_index"], h=H, nprobe=NPROBE, n_slots=2,
                          mesh=meta)
    assert S.SegmentedBackend.name == "segmented"
