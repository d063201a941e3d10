"""The port's ground rules, checked on the CPU.

* ``repro_torch`` imports neither JAX nor the reference package.
* Entry points default to cuda and raise without it; they never drift
  to the CPU behind the caller's back.
* ``mode="kernel"`` on CPU tensors raises (the kernel has no CPU mode);
  unknown precisions raise ``ValueError``, unported LM features
  ``NotImplementedError``;
  unported backends raise the reference's unknown-backend error.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import backend as rbackend
from repro.serving import engine as reng
from repro_torch import convert
from repro_torch.configs import encoders as tconfigs
from repro_torch.configs import two_tower_retrieval as ttt
from repro_torch.core import backend as tbackend
from repro_torch.core import ivf as tivf
from repro_torch.core import pq as tpq
from repro_torch.core import segment as tsegment
from repro_torch.core import toploc as ttl
from repro_torch.configs import common as tcommon
from repro_torch.data import pipeline as tpipeline
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import fault as tfault
from repro_torch.distributed import retrieval as tretrieval
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.kernels import ops as tops
from repro_torch.models import encoder as tenc
from repro_torch.configs import yi_9b as tyi
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng
from repro_torch.serving import router as trouter

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.device, "
        "repro_torch.core, repro_torch.kernels, repro_torch.kernels.ops, "
        "repro_torch.kernels.fused_turn, repro_torch.kernels._build, "
        "repro_torch.kernels.pq_adc, repro_torch.core.pq, "
        "repro_torch.serving, repro_torch.data.synthetic, "
        "repro_torch.kernels.flash_attention, repro_torch.models, "
        "repro_torch.models.layers, repro_torch.models.encoder, "
        "repro_torch.configs.encoders, repro_torch.data.tokenizer, "
        "repro_torch.kernels.embedding_bag, repro_torch.models.recsys, "
        "repro_torch.configs.two_tower_retrieval, "
        "repro_torch.kernels.flash_decode, repro_torch.models.transformer, "
        "repro_torch.configs.yi_9b, repro_torch.configs.common, "
        "repro_torch.kernels.launcher, repro_torch.kernels.centroid_topk, "
        "repro_torch.kernels.ivf_scan, repro_torch.analysis, "
        "repro_torch.analysis.kernel_budget, "
        "repro_torch.analysis.__main__, repro_torch.distributed, "
        "repro_torch.distributed.sharding, "
        "repro_torch.distributed.collectives, "
        "repro_torch.distributed.retrieval, "
        "repro_torch.serving.router, repro_torch.models.gnn, "
        "repro_torch.data.graph, repro_torch.configs.dcn_v2, "
        "repro_torch.configs.bst, repro_torch.configs.autoint, "
        "repro_torch.configs.gin_tu, repro_torch.optim, "
        "repro_torch.optim.schedules, repro_torch.optim.optimizers, "
        "repro_torch.optim.grad, repro_torch.checkpoint, "
        "repro_torch.checkpoint.checkpoint, repro_torch.distributed.fault, "
        "repro_torch.launch, repro_torch.launch.train, "
        "repro_torch.launch.serve, repro_torch.analysis.project, "
        "repro_torch.analysis.deprecation, "
        "repro_torch.analysis.static_contract, "
        "repro_torch.analysis.lock_order, "
        "repro_torch.analysis.guarded_fields, "
        "repro_torch.analysis.shard_specs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == ""


def test_no_source_of_the_port_or_the_smoke_imports_jax_or_repro():
    """Every import statement, function-local ones too, of
    ``src/repro_torch`` and ``chip_smoke.py``."""
    import ast
    import glob
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    files = glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(root, "chip_smoke.py")]
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 40 and bad == []


def test_tf32_is_off():
    assert repro_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    p, lmax, d = 4, 5, 8
    idx = convert.ivf_index_from_numpy(
        rng.normal(size=(p, d)), rng.normal(size=(p, lmax, d)),
        np.arange(p * lmax).reshape(p, lmax), np.full(p, lmax),
        device="cpu")
    return idx, torch.from_numpy(rng.normal(size=(2, d)).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_pq(tiny):
    """An IVF-PQ index over ``tiny``'s lists (m = 2, 4 codewords) and its
    queries' ADC tables."""
    idx, q = tiny
    rng = np.random.default_rng(1)
    p, lmax, d = idx.list_vecs.shape
    pqi = convert.ivf_pq_index_from_numpy(
        idx.centroids, rng.normal(size=(2, 4, d // 2)),
        rng.integers(0, 4, size=(p, lmax, 2)), idx.list_ids,
        idx.list_sizes, rng.normal(size=(p * lmax, d)), device="cpu")
    return pqi, q, torch.from_numpy(rng.normal(size=(2, 2, 4)).astype(
        np.float32))


SEL = torch.zeros((2, 1), dtype=torch.int32)

ENTRY_POINTS = {
    "ivf.build": lambda idx, q: tivf.build(
        np.zeros((8, 4), np.float32), 2),
    "pq.build_ivf_pq": lambda idx, q: tpq.build_ivf_pq(
        idx, np.zeros((20, 8), np.float32),
        tpq.train(torch.zeros((20, 8)), 2, n_codes=4,
                  generator=torch.Generator().manual_seed(0))),
    "convert": lambda idx, q: convert.ivf_index_from_numpy(*idx),
    "convert.ivf_pq": lambda idx, q: convert.ivf_pq_index_from_numpy(
        idx.centroids, np.zeros((2, 4, 4)), np.zeros((4, 5, 2)),
        idx.list_ids, idx.list_sizes, np.zeros((20, 8))),
    "toploc.start": lambda idx, q: ttl.start(
        tbackend.IVFBackend(h=2, nprobe=1), idx, q[0], k=2),
    "toploc.plain_batch": lambda idx, q: ttl.plain_batch(
        tbackend.IVFBackend(nprobe=1), idx, q, k=2),
    "toploc.ivf_start": lambda idx, q: ttl.ivf_start(
        idx, q[0], h=2, nprobe=1, k=2),
    "toploc.ivf_pq_plain_batch": lambda idx, q: ttl.ivf_pq_plain_batch(
        idx, q, nprobe=1, k=2),
    "ops.fused_turn": lambda idx, q: tops.fused_turn(
        q, idx.centroids, idx.list_vecs, idx.list_ids, nprobe=1, k=2),
    "ops.fused_scan": lambda idx, q: tops.fused_scan(
        q, idx.list_vecs, idx.list_ids,
        torch.zeros((2, 1), dtype=torch.int32), 2),
    "ops.pq_adc_scan": lambda idx, q: tops.pq_adc_scan(
        torch.zeros((2, 2, 4)), torch.zeros((4, 5, 2), dtype=torch.uint8),
        idx.list_ids, SEL, 2),
    "ops.fused_scan_pq": lambda idx, q: tops.fused_scan_pq(
        torch.zeros((2, 2, 4)), q, torch.zeros((4, 5, 2), dtype=torch.uint8),
        idx.list_ids, SEL, torch.zeros((20, 8)), 2, rerank=4),
    "ops.fused_turn_pq": lambda idx, q: tops.fused_turn_pq(
        q, idx.centroids, torch.zeros((2, 2, 4)),
        torch.zeros((4, 5, 2), dtype=torch.uint8), idx.list_ids,
        torch.zeros((20, 8)), nprobe=1, k=2, rerank=4),
    "ops.flash_attention": lambda idx, q: tops.flash_attention(
        torch.zeros((1, 2, 4, 8)), torch.zeros((1, 1, 4, 8)),
        torch.zeros((1, 1, 4, 8))),
    "encoder.init_params": lambda idx, q: tenc.init_params(
        tconfigs.tiny_encoder_config()),
    "convert.encoder": lambda idx, q: convert.encoder_params_from_numpy(
        {}, tconfigs.tiny_encoder_config()),
    "ops.embedding_bag": lambda idx, q: tops.embedding_bag(
        torch.zeros((4, 8)), torch.zeros((2, 3), dtype=torch.int32)),
    "recsys.two_tower_init": lambda idx, q: trec.two_tower_init(
        ttt.smoke_config()),
    "convert.two_tower": lambda idx, q: convert.two_tower_params_from_numpy(
        {}, ttt.smoke_config()),
    "ops.flash_decode": lambda idx, q: tops.flash_decode(
        torch.zeros((1, 2, 8)), torch.zeros((1, 1, 4, 8)),
        torch.zeros((1, 1, 4, 8)), torch.ones(1, dtype=torch.int32)),
    "transformer.init_params": lambda idx, q: ttf.init_params(
        tyi.smoke_config()),
    "convert.lm": lambda idx, q: convert.lm_params_from_numpy(
        {}, tyi.smoke_config()),
    "engine": lambda idx, q: teng.ConversationalSearchEngine(
        teng.ServingConfig(), ivf_index=idx),
    "engine.ivf_pq": lambda idx, q: teng.ConversationalSearchEngine(
        teng.ServingConfig(backend="ivf_pq"), ivf_pq_index=idx),
    "engine.shards": lambda idx, q: teng.BatchedConversationalSearchEngine(
        teng.ServingConfig(shards=2), ivf_index=idx),
    "router": lambda idx, q: trouter.ReplicatedSearchEngine(
        teng.ServingConfig(), replicas=2, ivf_index=idx),
    "train.run": lambda idx, q: ttrain.run(
        "dcn-v2", steps=1, smoke=True, ckpt_dir=None, ckpt_every=1,
        resume=False, injector=tfault.FailureInjector([])),
    "train.main": lambda idx, q: ttrain.main(["--arch", "dcn-v2",
                                              "--smoke", "--steps", "1"]),
    "serve.main": lambda idx, q: tserve.main(["--n-docs", "100"]),
    "serve.run": lambda idx, q: tserve.run(
        tserve.parser().parse_args(["--backend", "exact"])),
    "train.synth_batch": lambda idx, q: ttrain.synth_batch(
        {"x": tcommon.struct((2,), torch.int32)},
        np.random.default_rng(0), 4),
    "bundle.init_model": lambda idx, q: tcommon.get("gin-tu").build_bundle(
        tcommon.get("gin-tu").make_smoke_config(), "molecule",
        smoke=True).init_model(0),
    "bundle.make_args": lambda idx, q: tcommon.get("bst").build_bundle(
        tcommon.get("bst").make_smoke_config(), "serve_p99",
        smoke=True).make_args(0),
    "mesh.make_debug_mesh": lambda idx, q: tmesh.make_debug_mesh(),
    "elastic.make_elastic_mesh": lambda idx, q: telastic.make_elastic_mesh(),
    "pipeline.shard_batch": lambda idx, q: tpipeline.shard_batch(
        {"x": np.zeros(2)}, None),
}


def test_retrieval_mesh_defaults_to_the_cards(no_cuda):
    """With no ``devices`` a mesh takes the visible CUDA cards: none
    here, so it raises rather than fall back to the CPU."""
    with pytest.raises(ValueError, match="0 available"):
        tretrieval.retrieval_mesh(1)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(no_cuda, tiny, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](*tiny)


@pytest.mark.parametrize("op", ["fused_turn", "fused_scan"])
def test_kernel_mode_on_cpu_tensors_raises(tiny, op):
    idx, q = tiny
    with pytest.raises(ValueError, match="kernel"):
        if op == "fused_turn":
            tops.fused_turn(q, idx.centroids, idx.list_vecs, idx.list_ids,
                            nprobe=1, k=2, mode="kernel", device="cpu")
        else:
            tops.fused_scan(q, idx.list_vecs, idx.list_ids,
                            torch.zeros((2, 1), dtype=torch.int32), 2,
                            mode="kernel", device="cpu")


PQ_OPS = {
    "pq_adc_scan": lambda pqi, q, t, **kw: tops.pq_adc_scan(
        t, pqi.list_codes, pqi.list_ids, SEL, 2, **kw),
    "fused_scan_pq": lambda pqi, q, t, **kw: tops.fused_scan_pq(
        t, q, pqi.list_codes, pqi.list_ids, SEL, pqi.doc_vecs, 2, rerank=4,
        **kw),
    "fused_turn_pq": lambda pqi, q, t, **kw: tops.fused_turn_pq(
        q, pqi.centroids, t, pqi.list_codes, pqi.list_ids, pqi.doc_vecs,
        nprobe=1, k=2, rerank=4, **kw),
}


@pytest.mark.parametrize("op", sorted(PQ_OPS))
def test_pq_kernel_mode_on_cpu_tensors_raises(tiny_pq, op):
    PQ_OPS[op](*tiny_pq, device="cpu")           # the plain version runs
    with pytest.raises(ValueError, match="kernel"):
        PQ_OPS[op](*tiny_pq, mode="kernel", device="cpu")


def test_cpu_tensors_with_cuda_entry_point_are_refused(tiny):
    idx, q = tiny
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA to ask for it explicitly")
    with pytest.raises(ValueError, match="move the inputs"):
        ttl.plain_batch(tbackend.IVFBackend(nprobe=1), idx, q, k=2,
                        device="cuda")


@pytest.mark.parametrize("precision", ["fp8", "f16"])
def test_unknown_precisions_raise(tiny, tiny_pq, precision):
    """bf16 and int8 are ported; any other precision raises ValueError
    at every fused op, at ``FusedTurn`` and at the engine, as the
    reference's ``score_tile`` does."""
    idx, q = tiny
    with pytest.raises(ValueError, match="unknown precision"):
        tops.fused_turn(q, idx.centroids, idx.list_vecs, idx.list_ids,
                        nprobe=1, k=2, precision=precision, device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        tops.fused_scan(q, idx.list_vecs, idx.list_ids, SEL, 2,
                        precision=precision, device="cpu")
    for op in ("fused_scan_pq", "fused_turn_pq"):
        with pytest.raises(ValueError, match="unknown precision"):
            PQ_OPS[op](*tiny_pq, precision=precision, device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        ttl.FusedTurn(precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):
        teng.ConversationalSearchEngine(
            teng.ServingConfig(fused=True, precision=precision),
            ivf_index=idx, device="cpu")


@pytest.mark.parametrize("knob", [dict(shards=2), dict(mesh=object())])
def test_unported_serving_knobs_raise(tiny, knob):
    """Corpus sharding is ported: ``shards=2`` serves over two shards of
    the CPU device; a mesh that is not a ``RetrievalMesh`` raises."""
    if "mesh" in knob:
        with pytest.raises(TypeError, match="RetrievalMesh"):
            teng.ConversationalSearchEngine(teng.ServingConfig(**knob),
                                            ivf_index=tiny[0], device="cpu")
        return
    eng = teng.ConversationalSearchEngine(
        teng.ServingConfig(nprobe=1, h=2, **knob), ivf_index=tiny[0],
        device="cpu")
    assert len(eng.mesh.shard_devices) == 2
    assert isinstance(eng.backend.scan, tretrieval.ShardedIVFScan)


@pytest.mark.parametrize("engine", ["ConversationalSearchEngine",
                                    "BatchedConversationalSearchEngine"])
def test_segment_cap_builds_a_segmented_backend(tiny, engine):
    """``segment_cap > 0`` (the mutable corpus, ported) wraps the
    backend in a ``SegmentedBackend`` over an empty delta of that many
    rows, in both engines, as the reference's ``_setup`` does."""
    eng = getattr(teng, engine)(teng.ServingConfig(segment_cap=8),
                                ivf_index=tiny[0], device="cpu")
    assert isinstance(eng.backend, tsegment.SegmentedBackend)
    assert isinstance(eng.backend.inner, tbackend.IVFBackend)
    assert eng.index.base is tiny[0]
    assert tsegment.delta_cap(eng.index) == 8
    assert tsegment.delta_fill(eng.index) == 0 and eng.corpus_epoch == 0


def test_serving_config_keeps_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(reng.ServingConfig)}
    port = {f.name: f.default
            for f in dataclasses.fields(teng.ServingConfig)}
    assert port == ref


def test_make_checks_knobs_like_the_reference():
    assert tbackend.make("ivf", nprobe=3).nprobe == 3
    with pytest.raises(TypeError, match="typo"):
        tbackend.make("ivf", nprob=3)
    with pytest.raises(TypeError, match="strict"):
        tbackend.make("ivf", strict=True, rerank=3)
    # lenient make drops the PQ knob for the float backend
    assert not hasattr(tbackend.make("ivf", rerank=3), "rerank")
    assert tbackend.make("ivf_pq", rerank=3).rerank == 3
    assert tbackend.names() == ("exact", "hnsw", "ivf", "ivf_pq",
                                "segmented") == rbackend.names()


def test_make_ivf_pq_defaults_match_the_reference():
    """``make("ivf_pq")`` gives the reference's knobs and defaults, the
    sharded-scan hook ``scan`` included."""
    ref, port = rbackend.make("ivf_pq"), tbackend.make("ivf_pq")
    rf = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    pf = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    assert list(rf) == list(pf) and "scan" in pf
    assert pf == {n: rf[n] for n in pf}
    assert (type(port).name, type(port).index_kwarg) == \
        ("ivf_pq", "ivf_pq_index")
    assert isinstance(port, tbackend.IVFBackend)


@pytest.mark.parametrize("feature", [dict(attn_kind="mla"),
                                     dict(n_experts=8, top_k=2),
                                     dict(logit_soft_cap=30.0)])
def test_moe_mla_and_soft_cap_configs_count_like_the_reference(feature):
    """MLA, MoE and the logit soft cap are ported (ROADMAP Queue 1, item
    7): a config with each builds an LM, and its parameter counts are
    the reference's."""
    from repro.configs import yi_9b as ryi
    from repro.models import transformer as rtf
    cfg = dataclasses.replace(tyi.smoke_config(), **feature)
    rcfg = dataclasses.replace(ryi.smoke_config(), **feature)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    lm = ttf.init_params(cfg, device="cpu")
    assert lm(np.zeros((1, 3), np.int32)).shape == (1, 3, cfg.vocab)
