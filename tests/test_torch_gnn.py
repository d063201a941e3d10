"""The port's GIN forward and graph substrate == the reference's, on the
CPU.

``repro.models.gnn.init_params`` gives the parameters; the port takes them
as numpy arrays (``convert.gin_params_from_numpy``) and both packages run
the same graphs from the port's and the reference's ``data/graph.py``
(which give equal arrays for the same seeds) at ``smoke_config()`` sizes:

* ``aggregate`` (a segment sum in edge order) within 1e-6;
* ``forward_node`` on a full-batch graph with and without an edge mask,
  the port's batched ``forward_graph`` (one disjoint graph) against the
  reference's ``vmap`` over padded molecules, and ``forward_trees``
  against the reference's ``vmap`` of ``forward_node`` over sampled
  trees, each within ``LOGIT_TOL`` = 1e-5 (logits summed over the
  layers: each layer's head adds an error of its own to the sum);
* the configuration module copies the reference's fields and shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as RC
from repro.data import graph as RG
from repro.models import gnn as RN
from repro_torch import convert
from repro_torch.configs import gin_tu as TC
from repro_torch.data import graph as TG
from repro_torch.models import gnn as TN

AGG_TOL = 1e-6      # one segment sum of unit-scale features
# logits are the sum of the n_layers (3 at smoke size) heads' outputs,
# each after a LayerNorm that the two libraries round apart (measured
# ~1e-6 at smoke size): 1e-5, as the CTR models' logits
LOGIT_TOL = 1e-5
CPU = "cpu"
SP = TC.SMOKE_SHAPE_PARAMS


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_configs_copy_the_reference():
    for name in ("full_config", "smoke_config"):
        r, t = _fields(getattr(RC, name)()), _fields(getattr(TC, name)())
        assert r.keys() == t.keys()
        assert r.pop("dtype") == jnp.float32
        assert t.pop("dtype") == torch.float32
        assert r == t
    assert TC.SHAPE_PARAMS == RC.SHAPE_PARAMS
    assert TC.SMOKE_SHAPE_PARAMS == RC.SMOKE_SHAPE_PARAMS
    assert TC.pad_to(10556, 512) == RC._pad_to(10556, 512) == 10752


@pytest.mark.parametrize("shape", sorted(TC.SHAPE_PARAMS))
@pytest.mark.parametrize("name", ["full_config", "smoke_config"])
def test_param_count_matches_the_reference(name, shape):
    sp = TC.SHAPE_PARAMS[shape]
    kw = dict(d_in=sp["d_feat"], n_classes=sp["n_classes"])
    t = dataclasses.replace(getattr(TC, name)(), **kw)
    r = dataclasses.replace(getattr(RC, name)(), **kw)
    assert t.param_count() == r.param_count()


def _cfgs(shape):
    sp = SP[shape]
    kw = dict(d_in=sp["d_feat"], n_classes=sp["n_classes"])
    return (dataclasses.replace(RC.smoke_config(), **kw),
            dataclasses.replace(TC.smoke_config(), **kw))


def test_port_init_has_the_reference_tree_and_scales():
    rcfg, tcfg = _cfgs("full_graph_sm")
    p = TN.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: RN.init_params(rcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: t.dtype, p) == \
        jax.tree.map(lambda a: torch.float32, ref)
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == sum(a.size for a in jax.tree.leaves(ref))
    mlp0 = p["layers"][0]["mlp"]
    assert abs(float(mlp0["w1"].std()) - tcfg.d_in ** -0.5) < 0.01
    assert not mlp0["b1"].any() and not mlp0["norm"]["bias"].any()
    assert all(float(lp["eps"]) == 0.0 for lp in p["layers"])
    model = TN.GIN(tcfg, p)
    assert not any(q.requires_grad for q in model.parameters())


def _model(rcfg, tcfg, seed=4):
    params = RN.init_params(rcfg, jax.random.PRNGKey(seed))
    # a learnt ε other than 0, so (1 + ε) h is held too
    params["layers"] = [dict(lp, eps=jnp.float32(0.1 * (i + 1)))
                        for i, lp in enumerate(params["layers"])]
    return params, convert.gin_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device=CPU)


@pytest.fixture(scope="module")
def full_graph():
    """The smoke full_graph_sm graph (the port's sbm_graph), its edges
    padded to ``pad_edges_to`` with masked (0 -> 0) edges, and both
    packages' models."""
    sp = SP["full_graph_sm"]
    n = sp["n_nodes"]
    src, dst, x, _ = TG.sbm_graph(n, sp["n_edges"] - 100, sp["n_classes"],
                                  d_feat=sp["d_feat"], seed=3)
    e_pad = TC.pad_to(src.size, sp["pad_edges_to"])
    pad = e_pad - src.size
    es = np.concatenate([src, np.zeros(pad, np.int32)])
    ed = np.concatenate([dst, np.zeros(pad, np.int32)])
    em = np.arange(e_pad) < src.size
    rcfg, tcfg = _cfgs("full_graph_sm")
    params, port = _model(rcfg, tcfg)
    return x, es, ed, em, rcfg, params, port


def test_aggregate_matches_the_reference(full_graph):
    x, es, ed, em, *_ = full_graph
    n = x.shape[0]
    for mask in (None, em):
        want = np.asarray(RN.aggregate(
            jnp.asarray(x), jnp.asarray(es), jnp.asarray(ed), n,
            None if mask is None else jnp.asarray(mask)))
        got = TN.aggregate(torch.from_numpy(x), torch.from_numpy(es),
                           torch.from_numpy(ed), n,
                           None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AGG_TOL)
    # an isolated node sums nothing; a masked edge adds nothing
    lonely = TN.aggregate(torch.ones(3, 2), torch.tensor([0, 1]),
                          torch.tensor([1, 1]), 3, torch.tensor([True, False]))
    assert lonely.tolist() == [[0, 0], [1, 1], [0, 0]]


@pytest.mark.parametrize("masked", [False, True])
def test_forward_node_matches_the_reference(full_graph, masked):
    x, es, ed, em, rcfg, params, port = full_graph
    mask = em if masked else None
    want = np.asarray(RN.forward_node(
        params, rcfg, jnp.asarray(x), jnp.asarray(es), jnp.asarray(ed),
        None if mask is None else jnp.asarray(mask)))
    got = port.forward_node(x, es, ed, mask)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    again = port.forward_node(*(torch.from_numpy(a) for a in (x, es, ed)),
                              None if mask is None else torch.from_numpy(mask))
    assert torch.equal(again, got)


def test_forward_graph_batched_matches_the_reference_vmap():
    sp = SP["molecule"]
    xs, src, dst, node_mask, edge_mask, _ = TG.molecule_batch(
        sp["batch"], sp["n_nodes"], sp["n_edges"], sp["d_feat"],
        sp["n_classes"], seed=5)
    node_mask[::3, -2:] = False              # padded graphs
    edge_mask[::2, -3:] = False
    rcfg, tcfg = _cfgs("molecule")
    params, port = _model(rcfg, tcfg)
    want = np.asarray(jax.vmap(
        lambda x, es, ed, nm, em: RN.forward_graph(params, rcfg, x, es, ed,
                                                   nm, em))(
        *map(jnp.asarray, (xs, src, dst, node_mask, edge_mask))))
    got = port.forward_graph(xs, src, dst, node_mask, edge_mask)
    assert got.shape == (sp["batch"], sp["n_classes"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    one = port.forward_graph(xs[4], src[4], dst[4], node_mask[4])
    ref_one = np.asarray(RN.forward_graph(
        params, rcfg, *map(jnp.asarray, (xs[4], src[4], dst[4],
                                         node_mask[4]))))
    assert one.shape == (sp["n_classes"],)
    np.testing.assert_allclose(one.numpy(), ref_one, rtol=0, atol=LOGIT_TOL)


def test_forward_trees_match_the_reference_vmap():
    sp = SP["minibatch_lg"]
    src, dst, feats, labels = TG.sbm_graph(600, 3000, sp["n_classes"],
                                           d_feat=sp["d_feat"], seed=6)
    g = TG.edges_to_csr(src, dst, 600)
    sampler = TG.NeighborSampler(g, feats, labels, fanouts=sp["fanouts"],
                                 seed=7)
    seeds = np.arange(0, 600, 600 // sp["batch_nodes"])[:sp["batch_nodes"]]
    t = sampler.sample_trees(seeds)
    assert t["x"].shape[1:] == (sp["tree_nodes"], sp["d_feat"])
    assert t["edge_src"].shape[1] == sp["tree_edges"]
    rcfg, tcfg = _cfgs("minibatch_lg")
    params, port = _model(rcfg, tcfg)
    want = np.asarray(jax.vmap(
        lambda x, es, ed, em: RN.forward_node(params, rcfg, x, es, ed,
                                              em)[0])(
        *map(jnp.asarray, (t["x"], t["edge_src"], t["edge_dst"],
                           t["edge_mask"]))))
    got = port.forward_trees(t["x"], t["edge_src"], t["edge_dst"],
                             t["edge_mask"])
    assert got.shape == (sp["batch_nodes"], sp["n_classes"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def test_host_node_ids_outside_the_graph_are_refused(full_graph):
    x, es, ed, em, _, _, port = full_graph
    for bad in (-1, x.shape[0]):
        e = es.copy()
        e[5] = bad
        with pytest.raises(ValueError, match="must lie in"):
            port.forward_node(x, e, ed)
        with pytest.raises(ValueError, match="must lie in"):
            port.forward_node(x, es, e)
    with pytest.raises(ValueError, match="integer node ids"):
        port.forward_node(x, es.astype(np.float32), ed)


def _same(a, b):
    """Equal arrays (or tuples / dicts of them), dtype included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_data_equals_the_reference(seed):
    _same(TG.sbm_graph(300, 1200, 5, d_feat=8, seed=seed),
          RG.sbm_graph(300, 1200, 5, d_feat=8, seed=seed))
    _same(TG.molecule_batch(6, 10, 16, 4, 3, seed=seed),
          RG.molecule_batch(6, 10, 16, 4, 3, seed=seed))
    src, dst, feats, labels = RG.sbm_graph(300, 1200, 5, d_feat=8,
                                           seed=seed)
    rg, tg = RG.edges_to_csr(src, dst, 300), TG.edges_to_csr(src, dst, 300)
    _same(tuple(tg), tuple(rg))
    seeds = np.arange(seed, 300, 37).astype(np.int32)
    rs = RG.NeighborSampler(rg, feats, labels, fanouts=(4, 3), seed=seed)
    ts = TG.NeighborSampler(tg, feats, labels, fanouts=(4, 3), seed=seed)
    assert ts.max_nodes(8) == rs.max_nodes(8)
    assert ts.max_edges(8) == rs.max_edges(8)
    _same(tuple(ts.sample(seeds)), tuple(rs.sample(seeds)))
    _same(ts.sample_trees(seeds), rs.sample_trees(seeds))
    _same(tuple(ts.sample(seeds[:3])), tuple(rs.sample(seeds[:3])))
