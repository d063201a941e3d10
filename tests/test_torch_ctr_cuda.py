"""The ranking models and GIN on the card.

This file imports no JAX, so its ``cuda_only`` tests run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_ctr_cuda.py``; the
repository's conftest imports JAX).  At the configurations' smoke sizes,
weights drawn once on the CPU and copied to the card:

* DCN-v2, BST and AutoInt score 512 rows on the card within 1e-5 of the
  same model on the CPU (ids at each field's first and last row);
* BST's block runs the flash attention kernel (one launch a block) and
  its logits are within 1e-5 of the same model with the plain attention
  (``Attention.attention = ref.mha_attention``) on the card;
* GIN's node, graph and tree forwards on the card are within 1e-5 of
  the CPU's, and two forwards give the same bits (the aggregation has no
  float atomics).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import autoint as TA
from repro_torch.configs import bst as TB
from repro_torch.configs import dcn_v2 as TD
from repro_torch.configs import gin_tu as TG
from repro_torch.data import graph as G
from repro_torch.kernels import ops, ref
from repro_torch.models import gnn as N
from repro_torch.models import recsys as R

TOL = 1e-5
B = 512

MODELS = {"dcn_v2": (TD, R.dcnv2_init, R.DCNv2),
          "bst": (TB, R.bst_init, R.BST),
          "autoint": (TA, R.autoint_init, R.AutoInt)}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _to(params, dev):
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params.to(dev)


def _pair(name, dev):
    """(cfg, CPU model, card model) from one draw of the weights."""
    mod, init, cls = MODELS[name]
    cfg = mod.smoke_config()
    params = init(cfg, torch.Generator().manual_seed(11))
    return cfg, cls(cfg, params), cls(cfg, _to(params, dev))


def _ids(rng, vocabs, b=B):
    vocabs = np.asarray(vocabs)
    ids = (rng.random((b, vocabs.size)) * vocabs).astype(np.int32)
    ids[0], ids[1] = 0, vocabs - 1
    return ids


def _inputs(name, cfg, seed=0):
    rng = np.random.default_rng(seed)
    if name == "dcn_v2":
        return (rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                _ids(rng, cfg.vocab_sizes))
    if name == "bst":
        seq = _ids(rng, (cfg.item_vocab,) * (cfg.seq_len + 1))
        return (seq[:, :-1].copy(), seq[:, -1].copy(),
                _ids(rng, (cfg.other_vocab,) * cfg.n_other))
    return (_ids(rng, cfg.vocab_sizes),)


@pytest.mark.cuda_only
@pytest.mark.parametrize("name", sorted(MODELS))
def test_cuda_ranking_models_equal_the_cpu(cuda_device, name):
    cfg, cpu, card = _pair(name, cuda_device)
    inputs = _inputs(name, cfg)
    ops.reset_launches()
    got = card(*inputs)
    torch.cuda.synchronize()
    want = cpu(*inputs)
    assert got.device.type == "cuda" and got.shape == (B,)
    err = (got.cpu() - want).abs()
    if float(err.max()) > TOL:        # say whether the card or the CPU moved
        again = card(*inputs).cpu()
        raise AssertionError(
            f"card vs CPU max |d| {float(err.max())} at rows "
            f"{err.topk(5).indices.tolist()}; a second card run "
            f"{'equal' if torch.equal(again, got.cpu()) else 'differs'} "
            f"(vs CPU {float((again - want).abs().max())}), a second CPU "
            f"run {'equal' if torch.equal(cpu(*inputs), want) else 'differs'}"
            f"; stream {torch.cuda.current_stream()}, tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}")
    assert ops.flash_attention.launches == (cfg.n_blocks if name == "bst"
                                            else 0)


@pytest.mark.cuda_only
def test_cuda_bst_kernel_equals_its_plain_attention(cuda_device):
    cfg, _, card = _pair("bst", cuda_device)
    inputs = _inputs("bst", cfg, seed=1)
    kernel = card(*inputs)
    for blk in card.blocks:
        blk.attn.attention = ref.mha_attention
    before = ops.flash_attention.launches
    plain = card(*inputs)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before
    assert float((kernel - plain).abs().max()) <= TOL


def _gin(shape, dev):
    sp = TG.SMOKE_SHAPE_PARAMS[shape]
    cfg = dataclasses.replace(TG.smoke_config(), d_in=sp["d_feat"],
                              n_classes=sp["n_classes"])
    params = N.init_params(cfg, torch.Generator().manual_seed(12))
    for i, lp in enumerate(params["layers"]):
        lp["eps"] = torch.tensor(0.1 * (i + 1))
    return sp, N.GIN(cfg, params), N.GIN(cfg, _to(params, dev))


@pytest.mark.cuda_only
def test_cuda_gin_forwards_equal_the_cpu_and_repeat_bit_for_bit(
        cuda_device):
    sp, cpu, card = _gin("ogb_products", cuda_device)
    src, dst, x, _ = G.sbm_graph(sp["n_nodes"], sp["n_edges"],
                                 sp["n_classes"], d_feat=sp["d_feat"], seed=2)
    mask = np.arange(src.size) % 7 != 0
    got = card.forward_node(x, src, dst, mask)
    again = card.forward_node(x, src, dst, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got.cpu() - cpu.forward_node(x, src, dst, mask)
                  ).abs().max()) <= TOL

    sp, cpu, card = _gin("molecule", cuda_device)
    mol = G.molecule_batch(sp["batch"], sp["n_nodes"], sp["n_edges"],
                           sp["d_feat"], sp["n_classes"], seed=3)[:5]
    got = card.forward_graph(*mol)
    assert torch.equal(got, card.forward_graph(*mol))
    assert float((got.cpu() - cpu.forward_graph(*mol)).abs().max()) <= TOL

    sp, cpu, card = _gin("minibatch_lg", cuda_device)
    src, dst, feats, labels = G.sbm_graph(2000, 20000, sp["n_classes"],
                                          d_feat=sp["d_feat"], seed=4)
    sampler = G.NeighborSampler(G.edges_to_csr(src, dst, 2000), feats,
                                labels, fanouts=sp["fanouts"], seed=5)
    t = sampler.sample_trees(np.arange(sp["batch_nodes"]))
    args = (t["x"], t["edge_src"], t["edge_dst"], t["edge_mask"])
    got = card.forward_trees(*args)
    assert torch.equal(got, card.forward_trees(*args))
    assert float((got.cpu() - cpu.forward_trees(*args)).abs().max()) <= TOL
