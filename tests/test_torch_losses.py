"""The port's training losses and their gradients == the reference's, on
the CPU; and the backward logic of the kernels' autograd Functions.

Each loss runs on the same numpy inputs and reference-drawn parameters
(``convert.*_params_from_numpy``) in both packages: the reference under
``jax.value_and_grad`` (its kernels in "ref" mode, their ``custom_vjp``
backwards the plain math), the port under ``optim.grad.value_and_grad``
(the plain versions on CPU tensors).  The reference's gradient tree is
carried across by the same converter, so every leaf is compared with
the port parameter of the same name.  Tolerances: loss, metrics and
every gradient within 1e-5·max(1, |·|) for the encoder, the recsys
models and GIN (the five LMs' are in ``test_torch_lm_loss.py``).

``ops.Attention`` and ``ops.Bag`` are checked with the plain forward in
the kernel's place: ``torch.autograd.gradcheck`` in float64, their
backwards against the reference's ``_fa_bwd`` / ``_eb_bwd`` (``jax.vjp``
of its plain math) in float32, and the attention's backward above 2048²
scores, where it streams the keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as RA
from repro.configs import bst as RB
from repro.configs import dcn_v2 as RD
from repro.configs import encoders as REC
from repro.configs import two_tower_retrieval as RTT
from repro.kernels import ops as RK
from repro.models import encoder as RE
from repro.models import gnn as RN
from repro.models import recsys as RR
from repro.configs import gin_tu as RGIN
from repro_torch import convert
from repro_torch.configs import autoint as TA
from repro_torch.configs import bst as TB
from repro_torch.configs import dcn_v2 as TD
from repro_torch.configs import encoders as TEC
from repro_torch.configs import gin_tu as TGIN
from repro_torch.configs import two_tower_retrieval as TTT
from repro_torch.kernels import ops, ref
from repro_torch.models import encoder as TE
from repro_torch.models import gnn as TN
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.optim import grad as TG

CPU = "cpu"
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_vg(fn, params, *args):
    """The reference's ``jax.value_and_grad(fn, has_aux=True)`` at
    (params, *args), jitted (op-by-op dispatch is slow on the CPU)."""
    return jax.jit(jax.value_and_grad(fn, has_aux=True))(params, *args)


def _close(got, want, tol, what):
    """Every element within tol·max(1, |want|) (NaN where want is)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert (np.isnan(got) == np.isnan(want)).all(), what
    bad = np.abs(got - want) > tol * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3g}")


def check(model, port_loss, batch, rgrads, rloss, rmetrics, to_module, tol):
    """The port's (loss, metrics, grads) against the reference's: the
    reference's gradient tree converted by ``to_module`` and compared by
    parameter name."""
    model.requires_grad_(True)
    (loss, metrics), grads = TG.value_and_grad(port_loss, model, batch)
    _close(loss, rloss, tol, "loss")
    for k, v in rmetrics.items():
        _close(metrics[k], v, tol, k)
    want = dict(to_module(_np(rgrads)).named_parameters())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        _close(g, want[name], tol, name)


# ---------------------------------------------------------------------------
# the encoder's InfoNCE
# ---------------------------------------------------------------------------


def test_contrastive_loss_and_grads_match_the_reference():
    rcfg, tcfg = REC.tiny_encoder_config(), TEC.tiny_encoder_config()
    params = RE.init_params(rcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    b, s = 6, rcfg.max_len
    q = rng.integers(1, rcfg.vocab, (b, s)).astype(np.int32)
    q[:, 12:] = 0                                  # 12-token queries
    d = rng.integers(1, rcfg.vocab, (b, s)).astype(np.int32)
    d[:3, 20:] = 0
    batch = {"q_tokens": q, "q_mask": q > 0, "d_tokens": d, "d_mask": d > 0}
    (rloss, rm), rgrads = _ref_vg(
        lambda p, b: RE.contrastive_loss(p, rcfg, b), params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.encoder_params_from_numpy(_np(params), tcfg, device=CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    check(model, TE.contrastive_loss, tb, rgrads, rloss, rm,
          lambda g: convert.encoder_params_from_numpy(g, tcfg, device=CPU),
          TOL)


# ---------------------------------------------------------------------------
# recsys: the two-tower in-batch softmax and the CTR models' BCE
# ---------------------------------------------------------------------------


def test_two_tower_loss_and_grads_match_the_reference():
    rcfg, tcfg = RTT.smoke_config(), TTT.smoke_config()
    params = RR.two_tower_init(rcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    b = 24
    hist = rng.integers(-1, rcfg.item_vocab, (b, rcfg.history_len))
    hist[0] = -1
    batch = {"user_id": rng.integers(0, rcfg.user_vocab, b),
             "item_id": rng.integers(0, rcfg.item_vocab, b),
             "history": hist}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    (rloss, rm), rgrads = _ref_vg(
        lambda p, b: RR.two_tower_loss(p, rcfg, b), params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.two_tower_params_from_numpy(_np(params), tcfg,
                                                device=CPU)
    check(model, TR.two_tower_loss,
          {k: torch.from_numpy(v) for k, v in batch.items()}, rgrads, rloss,
          rm, lambda g: convert.two_tower_params_from_numpy(g, tcfg,
                                                            device=CPU), TOL)


def _ctr_batch(name, cfg, b, rng):
    if name == "dcn_v2":
        return {"dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                "sparse": np.stack([rng.integers(0, v, b)
                                    for v in cfg.vocab_sizes], 1)}
    if name == "bst":
        return {"history": rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)),
                "target": rng.integers(0, cfg.item_vocab, b),
                "other": rng.integers(0, cfg.other_vocab, (b, cfg.n_other))}
    return {"sparse": np.stack([rng.integers(0, v, b)
                                for v in cfg.vocab_sizes], 1)}


CTR = {
    "dcn_v2": (RD, TD, RR.dcnv2_init, RR.dcnv2_forward,
               convert.dcnv2_params_from_numpy, ("dense", "sparse")),
    "bst": (RB, TB, RR.bst_init, RR.bst_forward,
            convert.bst_params_from_numpy, ("history", "target", "other")),
    "autoint": (RA, TA, RR.autoint_init, RR.autoint_forward,
                convert.autoint_params_from_numpy, ("sparse",)),
}


@pytest.mark.parametrize("name", sorted(CTR))
def test_bce_loss_and_grads_match_the_reference(name):
    rmod, tmod, init, fwd, conv, keys = CTR[name]
    rcfg, tcfg = rmod.smoke_config(), tmod.smoke_config()
    params = init(rcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(2)
    b = 32
    batch = {k: (v.astype(np.int32) if v.dtype.kind == "i" else v)
             for k, v in _ctr_batch(name, rcfg, b, rng).items()}
    labels = (rng.random(b) < 0.3).astype(np.float32)

    def rloss_fn(p):
        logits = fwd(p, rcfg, *(jnp.asarray(batch[k]) for k in keys))
        return RR.bce_loss(logits, jnp.asarray(labels))

    (rloss, rm), rgrads = _ref_vg(rloss_fn, params)
    model = conv(_np(params), tcfg, device=CPU)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["labels"] = torch.from_numpy(labels)
    check(model, lambda m, bt: TR.bce_loss(m(*(bt[k] for k in keys)),
                                           bt["labels"]),
          tb, rgrads, rloss, rm, lambda g: conv(g, tcfg, device=CPU), TOL)


def test_bce_loss_matches_the_reference_at_extreme_logits():
    x = np.array([-80.0, -3.0, 0.0, 0.0, 2.5, 90.0], np.float32)
    y = np.array([0.0, 1.0, 1.0, 0.0, 0.0, 1.0], np.float32)
    (rl, rm), rg = jax.value_and_grad(
        lambda a: RR.bce_loss(a, jnp.asarray(y)), has_aux=True)(
            jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    tl, tm = TR.bce_loss(t, torch.from_numpy(y))
    tl.backward()
    _close(tl, rl, TOL, "loss")
    _close(tm["acc"], rm["acc"], TOL, "acc")
    _close(t.grad, rg, TOL, "grad")


# ---------------------------------------------------------------------------
# GIN: node, graph and tree losses
# ---------------------------------------------------------------------------


def _gin(shape, seed=4):
    sp = RGIN.SMOKE_SHAPE_PARAMS[shape]
    kw = dict(d_in=sp["d_feat"], n_classes=sp["n_classes"])
    rcfg = dataclasses.replace(RGIN.smoke_config(), **kw)
    tcfg = dataclasses.replace(TGIN.smoke_config(), **kw)
    params = RN.init_params(rcfg, jax.random.PRNGKey(seed))
    params["layers"] = [dict(lp, eps=jnp.float32(0.1 * (i + 1)))
                        for i, lp in enumerate(params["layers"])]
    conv = lambda g: convert.gin_params_from_numpy(g, tcfg, device=CPU)
    return rcfg, params, conv(_np(params)), conv


def _min_relu_input(model, x, es, ed, em) -> float:
    """The smallest |input| of any ReLU of the port's forward_node: a
    ReLU input within rounding of 0 may fall on either side of the kink
    in the two packages, and its gradient then differs by a whole term;
    the node test's graph keeps every ReLU input clear of it."""
    with torch.no_grad():
        order = TN.edge_order(torch.from_numpy(es), torch.from_numpy(ed),
                              x.shape[0], torch.from_numpy(em))
        h, low = torch.from_numpy(x), float("inf")
        for mlp, eps in zip(model.mlps, model.eps):
            pre = ((1.0 + eps) * h + TN.aggregate_ordered(h, order)
                   ) @ mlp.w1 + mlp.b1
            post = mlp.norm(torch.relu(pre) @ mlp.w2 + mlp.b2)
            low = min(low, pre.abs().min().item(), post.abs().min().item())
            h = torch.relu(post)
    return low


def test_node_loss_and_grads_match_the_reference():
    rcfg, params, model, conv = _gin("full_graph_sm")
    rng = np.random.default_rng(13)
    n, e = 64, 300
    x = rng.normal(size=(n, rcfg.d_in)).astype(np.float32)
    es, ed = (rng.integers(0, n, e).astype(np.int32) for _ in range(2))
    em = rng.random(e) < 0.9
    labels = rng.integers(0, rcfg.n_classes, n).astype(np.int32)
    tm = rng.random(n) < 0.5
    assert _min_relu_input(model, x, es, ed, em) > 1e-5
    (rloss, rm), rgrads = _ref_vg(
        lambda p, *a: RN.node_loss(p, rcfg, *a), params,
        *map(jnp.asarray, (x, es, ed, labels, tm, em)))
    check(model, lambda m, b: TN.node_loss(m, *b), (x, es, ed, labels, tm,
                                                    em),
          rgrads, rloss, rm, conv, TOL)


def test_graph_loss_and_grads_match_the_reference():
    rcfg, params, model, conv = _gin("molecule")
    rng = np.random.default_rng(4)
    g, n, e = 8, 10, 16
    x = rng.normal(size=(g, n, rcfg.d_in)).astype(np.float32)
    es, ed = (rng.integers(0, n, (g, e)).astype(np.int32) for _ in range(2))
    nm, em = rng.random((g, n)) < 0.8, rng.random((g, e)) < 0.9
    labels = rng.integers(0, rcfg.n_classes, g).astype(np.int32)
    (rloss, rm), rgrads = _ref_vg(
        lambda p, *a: RN.graph_loss(p, rcfg, *a), params,
        *map(jnp.asarray, (x, es, ed, nm, labels, em)))
    check(model, lambda m, b: TN.graph_loss(m, *b),
          (x, es, ed, nm, labels, em), rgrads, rloss, rm, conv, TOL)


def test_tree_loss_and_grads_match_the_reference_config():
    """``minibatch_lg``'s loss as ``repro/configs/gin_tu.py:132-145``
    computes it (each tree's root through ``forward_node``, vmapped)."""
    rcfg, params, model, conv = _gin("minibatch_lg")
    rng = np.random.default_rng(5)
    bsz, tn, te = 6, 10, 9
    x = rng.normal(size=(bsz, tn, rcfg.d_in)).astype(np.float32)
    es, ed = (rng.integers(0, tn, (bsz, te)).astype(np.int32)
              for _ in range(2))
    em = rng.random((bsz, te)) < 0.9
    labels = rng.integers(0, rcfg.n_classes, bsz).astype(np.int32)

    def rloss_fn(p):
        logits = jax.vmap(lambda a, b, c, d: RN.forward_node(
            p, rcfg, a, b, c, d)[0])(*(jnp.asarray(t) for t in (x, es, ed,
                                                                em)))
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                                   -1)[..., 0]
        acc = jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(labels))
        return jnp.mean(logz - gold), {"acc": acc}

    (rloss, rm), rgrads = _ref_vg(rloss_fn, params)
    check(model, lambda m, b: TN.tree_loss(m, *b), (x, es, ed, em, labels),
          rgrads, rloss, rm, conv, TOL)


def test_take_label_follows_take_along_axis():
    """A negative label counts from the end and one past the classes
    gives NaN (JAX's fill mode), as the reference's cross-entropies see
    them; no gradient reaches a NaN row."""
    logits = np.arange(12, dtype=np.float32).reshape(4, 3) / 7
    labels = np.array([0, -1, 3, 2], np.int32)
    want = jnp.take_along_axis(jnp.asarray(logits),
                               jnp.asarray(labels)[:, None], -1)[:, 0]
    t = torch.from_numpy(logits).requires_grad_()
    got = TL.take_label(t, torch.from_numpy(labels))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    torch.nan_to_num(got).sum().backward()
    assert not t.grad[2].any() and t.grad[1, 2] == 1.0


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, the plain forward in the kernel's place
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, causal):
    return ref.plain_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [1, 2])
def test_attention_function_backward_gradcheck(causal, hkv):
    g = torch.Generator().manual_seed(hkv)
    q = torch.randn(2, 2, 3, 4, generator=g, dtype=torch.float64)
    k = torch.randn(2, hkv, 5, 4, generator=g, dtype=torch.float64)
    v = torch.randn(2, hkv, 5, 3, generator=g, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.Attention.apply(a, b, c, causal,
                                            _plain_attention),
        (q.requires_grad_(), k.requires_grad_(), v.requires_grad_()))


def test_attention_function_backward_takes_views_and_some_inputs():
    """A strided (transposed) v, and gradients for q only."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 4, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 2, 4, 4, generator=g, dtype=torch.float64)
    vt = torch.randn(1, 2, 4, 4, generator=g, dtype=torch.float64)
    v = vt.transpose(2, 3)
    assert not v.is_contiguous()
    assert torch.autograd.gradcheck(
        lambda a: ops.Attention.apply(a, k, v, False, _plain_attention),
        (q.requires_grad_(),))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_matches_the_reference_fa_bwd(causal):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 9, 5)).astype(np.float32)
    gout = rng.normal(size=(2, 4, 6, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: RK.flash_attention(
        a, b, c, causal=causal, mode="ref"), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(gout))
    got = ops.attention_vjp(*map(torch.from_numpy, (q, k, v, gout)), causal)
    for name, a, b in zip("qkv", got, want):
        _close(a, b, TOL, f"d{name}")


def test_attention_backward_streams_the_keys_above_the_threshold():
    """Above 2048² scores the VJP recomputes ``chunked_attention``, as
    the reference's does; its gradients equal the full attention's."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 1, 2100, 8, generator=g)
    k = torch.randn(1, 1, 2100, 8, generator=g)
    v = torch.randn(1, 1, 2100, 4, generator=g)
    gout = torch.randn(1, 1, 2100, 4, generator=g)
    got = ops.attention_vjp(q, k, v, gout, True)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha_attention(*qkv, causal=True), qkv,
                               gout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _bag_inputs(dtype):
    g = torch.Generator().manual_seed(3)
    table = torch.randn(7, 3, generator=g, dtype=dtype)
    ids = torch.tensor([[0, 2, -1, 2], [6, -1, -1, -1], [-1, -1, -1, -1],
                        [1, 1, 1, 5]], dtype=torch.int32)
    w = torch.randn(4, 4, generator=g, dtype=dtype)
    return table, ids, w


def _plain_bag(table, ids, w):
    return ref.embedding_bag(table, ids, w)


def test_bag_function_backward_gradcheck():
    table, ids, w = _bag_inputs(torch.float64)
    assert torch.autograd.gradcheck(
        lambda t, ww: ops.Bag.apply(t, ids, ww, _plain_bag),
        (table.requires_grad_(), w.requires_grad_()))
    assert torch.autograd.gradcheck(
        lambda t: ops.Bag.apply(t, ids, None, _plain_bag),
        (table.detach().requires_grad_(),))


@pytest.mark.parametrize("weighted", [False, True])
def test_bag_backward_matches_the_reference_eb_bwd(weighted):
    table, ids, w = _bag_inputs(torch.float32)
    w = w if weighted else None
    gout = torch.randn(4, 3, generator=torch.Generator().manual_seed(4))
    args = [jnp.asarray(table.numpy())] + (
        [jnp.asarray(w.numpy())] if weighted else [])
    _, vjp = jax.vjp(lambda t, *ww: RK.embedding_bag(
        t, jnp.asarray(ids.numpy()), ww[0] if ww else None, mode="ref"),
        *args)
    want = vjp(jnp.asarray(gout.numpy()))
    d_table, d_w = ops.bag_vjp(table, ids, w, gout)
    _close(d_table, want[0], TOL, "d table")
    if weighted:
        _close(d_w, want[1], TOL, "d weights")
    else:
        assert d_w is None
    again = ops.bag_vjp(table, ids, w, gout)[0]
    assert torch.equal(d_table, again)
