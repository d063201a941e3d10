"""The port's train steps == the reference's, on the CPU, over three
steps from the same parameters and batches.

``configs.common.simple_train_step`` (the recsys and GIN bundles: the
loss's gradients, clipped to a global norm of 1.0, one AdamW update) and
the LM bundle (``lm_bundle`` with two microbatches: yi-9b's AdamW with a
float32 accumulator, grok-1's Adafactor with one in the parameters'
dtype) run in both packages: the reference's ``build_bundle(...).step_fn``
on its ``opt.init`` state, the port's ``build_bundle(...).step_fn`` on
the same parameters converted (``convert.*_params_from_numpy``) and its
``make_optimizer``.  Every step's loss and gradient norm, and after
three steps every optimizer moment, agree within tol·max(1, |·|), tol
1e-5 (recsys, GIN) and 1e-4 (the LMs at smoke size).  The parameters
agree within the same bound plus 1 % of the most AdamW can move a weight
in three steps (3 · lr): Adam divides each gradient by its own RMS, so
on a gradient at rounding level (an element whose terms cancel) the two
packages' last-bit differences become a visible fraction of lr.  The batches are the launcher's
(``synth_batch``, the same draws in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import common as RC
from repro.configs import dcn_v2 as RD
from repro.configs import gin_tu as RGIN
from repro.configs import grok_1_314b as RGK
from repro.configs import two_tower_retrieval as RTT
from repro.configs import yi_9b as RYI
from repro.distributed import sharding as RSH
from repro.launch import train as RLT
from repro.models import gnn as RN
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import common as TC
from repro_torch.launch import train as TLT
from repro_torch.optim import grad as TG

CPU = "cpu"
AXES = RSH.Axes(data=("data",), model="model")
STEPS = 3


def _close(got, want, tol, what, scale=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = np.maximum(1.0, np.abs(want)) if scale is None else scale
    bad = np.abs(got - want) > tol * scale
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3g}")


def _run_both(rbundle, tbundle, params, to_module, vocab_hi, tol):
    """Three steps of both bundles; returns (port model, optimizer,
    reference params, reference optimizer state)."""
    rstep = jax.jit(rbundle.step_fn)
    ropt = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        rbundle.arg_structs[1])
    rp = params
    model = to_module(jax.tree.map(np.asarray, params)).requires_grad_(True)
    opt = tbundle.make_optimizer(model)
    for s in range(STEPS):
        rb = RLT.synth_batch(rbundle.arg_structs[2],
                             np.random.default_rng(1000 + s), vocab_hi)
        tb = TLT.synth_batch(tbundle.batch_structs,
                             np.random.default_rng(1000 + s), vocab_hi, CPU)
        for k in rb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]))
        rp, ropt, rm = rstep(rp, ropt, rb)
        tm = tbundle.step_fn(model, opt, tb)
        for k in ("loss", "gnorm"):
            _close(tm[k], rm[k], tol, f"step {s + 1} {k}")
    return model, opt, rp, ropt


def _check_params(model, rp, to_module, tol, lr=0.0):
    want = dict(to_module(jax.tree.map(np.asarray, rp)).named_parameters())
    for name, p in model.named_parameters():
        w = np.asarray(want[name].detach(), np.float32)
        _close(p, w, tol, name, scale=np.maximum(1.0, np.abs(w))
               + 0.01 * STEPS * lr / tol)


def _check_moments(model, opt, rstate, to_module, tol, keys):
    """Each optimizer state leaf against the reference's, converted by
    the parameters' converter (its tree mirrors the parameters')."""
    names = [n for n, _ in model.named_parameters()]
    for key, sub in keys:
        want = dict(to_module(jax.tree.map(
            np.asarray, sub(rstate))).named_parameters())
        for name, p in zip(names, opt.params):
            _close(opt.state[p][key], want[name], tol, f"{name} {key}")
    assert opt.step_count == int(rstate["step"]) == STEPS


ADAM_KEYS = (("m", lambda st: st["m"]), ("v", lambda st: st["v"]))


def test_two_tower_step_matches_the_reference():
    rcfg = RTT.smoke_config()
    tcfg = TC.get("two-tower-retrieval").make_smoke_config()
    over = dict(batch=64)
    rb = RTT.build_bundle(rcfg, "train_batch", AXES, smoke=True,
                          shape_overrides=over)
    tb = TC.get("two-tower-retrieval").build_bundle(
        tcfg, "train_batch", smoke=True, shape_overrides=over)
    conv = lambda t: convert.two_tower_params_from_numpy(t, tcfg, device=CPU)
    params = RR.two_tower_init(rcfg, jax.random.PRNGKey(1))
    model, opt, rp, rst = _run_both(rb, tb, params, conv, 32, 1e-5)
    _check_params(model, rp, conv, 1e-5, lr=1e-3)
    _check_moments(model, opt, rst, conv, 1e-5, ADAM_KEYS)


def test_dcn_v2_step_matches_the_reference():
    rcfg = RD.smoke_config()
    tcfg = TC.get("dcn-v2").make_smoke_config()
    over = dict(batch=64)
    rb = RD.build_bundle(rcfg, "train_batch", AXES, smoke=True,
                         shape_overrides=over)
    tb = TC.get("dcn-v2").build_bundle(tcfg, "train_batch", smoke=True,
                                       shape_overrides=over)
    conv = lambda t: convert.dcnv2_params_from_numpy(t, tcfg, device=CPU)
    params = RR.dcnv2_init(rcfg, jax.random.PRNGKey(2))
    model, opt, rp, rst = _run_both(rb, tb, params, conv, 32, 1e-5)
    _check_params(model, rp, conv, 1e-5, lr=1e-3)
    _check_moments(model, opt, rst, conv, 1e-5, ADAM_KEYS)


@pytest.mark.parametrize("shape", ["molecule", "minibatch_lg",
                                   "full_graph_sm"])
def test_gin_step_matches_the_reference(shape):
    """The three GIN losses; ids drawn below 2 so that every edge and
    label is in range at the smoke sizes."""
    arch = TC.get("gin-tu")
    over = dict(n_nodes=64, n_edges=256) if shape == "full_graph_sm" else {}
    rb = RGIN.build_bundle(RGIN.smoke_config(), shape, AXES, smoke=True,
                           shape_overrides=over)
    tb = arch.build_bundle(arch.make_smoke_config(), shape, smoke=True,
                           shape_overrides=over)
    sp = dict(RGIN.SMOKE_SHAPE_PARAMS[shape], **over)
    rcfg = dataclasses.replace(RGIN.smoke_config(), d_in=sp["d_feat"],
                               n_classes=sp["n_classes"])
    tcfg = dataclasses.replace(arch.make_smoke_config(), d_in=sp["d_feat"],
                               n_classes=sp["n_classes"])
    conv = lambda t: convert.gin_params_from_numpy(t, tcfg, device=CPU)
    params = RN.init_params(rcfg, jax.random.PRNGKey(3))
    model, opt, rp, rst = _run_both(rb, tb, params, conv, 2, 1e-5)
    _check_params(model, rp, conv, 1e-5, lr=1e-3)
    _check_moments(model, opt, rst, conv, 1e-5, ADAM_KEYS)


LM_OVER = dict(seq_len=32, global_batch=4)


@pytest.mark.parametrize("arch", ["yi-9b", "grok-1-314b"])
def test_lm_bundle_with_microbatches_matches_the_reference(arch):
    """Two microbatches: yi-9b accumulates in float32 for AdamW, grok-1
    in the parameters' dtype for Adafactor."""
    rmod = {"yi-9b": RYI, "grok-1-314b": RGK}[arch]
    opt_name = "adamw" if arch == "yi-9b" else "adafactor"
    rcfg = rmod.smoke_config()
    tarch = TC.get(arch)
    tcfg = tarch.make_smoke_config()
    rb = RC.lm_bundle(rcfg, arch, "train_4k", AXES, optimizer=opt_name,
                      smoke=True, microbatches=2, shape_overrides=LM_OVER)
    tb = TC.lm_bundle(tcfg, arch, "train_4k", optimizer=opt_name,
                      smoke=True, microbatches=2, shape_overrides=LM_OVER)
    assert tb.meta["microbatches"] == 2
    conv = lambda t: convert.lm_params_from_numpy(t, tcfg, device=CPU)
    params = RT.init_params(rcfg, jax.random.PRNGKey(4))
    model, opt, rp, rst = _run_both(rb, tb, params, conv, rcfg.vocab, 1e-4)
    _check_params(model, rp, conv, 1e-4)
    if opt_name == "adamw":
        _check_moments(model, opt, rst, conv, 1e-4, ADAM_KEYS)
        return
    # Adafactor: the reference's state mirrors the parameter tree with a
    # {"v"} or {"vr", "vc"} dict a leaf
    names = [n for n, _ in model.named_parameters()]
    for key in ("v", "vr", "vc"):
        sub = jax.tree.map(
            lambda d: d[key] if key in d else jnp.zeros_like(
                d["v"] if "v" in d else d["vr"])[..., :0], rst["v"],
            is_leaf=lambda d: isinstance(d, dict) and ("v" in d or "vr" in d))
        want = dict(conv(jax.tree.map(np.asarray, sub)).named_parameters())
        for name, p in zip(names, opt.params):
            if key in opt.state[p]:
                _close(opt.state[p][key], want[name], 1e-4, f"{name} {key}")
            else:
                assert want[name].numel() == 0
    assert opt.step_count == STEPS == int(rst["step"])


def test_simple_train_step_returns_the_metrics():
    model = TC.get("dcn-v2")
    cfg = model.make_smoke_config()
    b = model.build_bundle(cfg, "train_batch", smoke=True,
                           shape_overrides=dict(batch=8))
    m = b.init_model(0, CPU)
    assert all(p.requires_grad for p in m.parameters())
    opt = b.make_optimizer(m)
    out = b.step_fn(m, opt, TLT.synth_batch(b.batch_structs,
                                            np.random.default_rng(0), 32,
                                            CPU))
    assert sorted(out) == ["acc", "gnorm", "loss"]
    assert opt.step_count == 1 and len(opt.params) == len(TG.trainable(m))


def test_serve_shapes_are_not_bundled():
    """A serve shape is not bundled as a train step: its bundle is kind
    "serve", with no optimizer and no batch of labels (its steps are
    held to the reference's in ``tests/test_torch_serve_bundles.py``)."""
    for arch_id, shape in (("yi-9b", "decode_32k"), ("bst", "serve_p99")):
        arch = TC.get(arch_id)
        b = arch.build_bundle(arch.make_smoke_config(), shape, smoke=True)
        assert b.kind == "serve"
        assert b.make_optimizer is None and b.batch_structs == {}
