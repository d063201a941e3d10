"""The port's optimizers, schedules and gradient utilities == the
reference's, on the CPU.

The same numpy parameters and gradients go through
``repro.optim.optimizers`` (``init`` / ``update`` / ``apply_updates``)
and through ``repro_torch.optim.optimizers`` (``step(grads=...)``): after
three updates the parameters and every moment agree within 1e-6, for
AdamW (with and without decay, and on bfloat16 leaves with float32
moments), Adafactor (factored and not; its state shapes equal) and SGD
(plain, momentum, Nesterov).  The schedules agree within 1e-7 over their
whole range.  ``clip_by_global_norm`` and ``global_norm`` agree,
``accumulate`` equals the full batch's gradient, and the int8 codes of
``compress`` are equal exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import grad as RG
from repro.optim import optimizers as RO
from repro.optim import schedules as RS
from repro_torch.optim import grad as TG
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS

TOL = 1e-6
# leaves: a factored matrix (both dims >= 128), a stack of them, a matrix
# too narrow to factor, a vector and a scalar
SHAPES = {"w": (130, 128), "stack": (2, 128, 136), "narrow": (256, 64),
          "b": (7,), "s": ()}


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.normal(size=s) * scale, np.float32)
            for k, s in SHAPES.items()}


SCHEDS = {
    "warmup_cosine": (lambda m: m.warmup_cosine(3e-4, 20, 200), 260),
    "warmup_cosine_floor": (lambda m: m.warmup_cosine(1e-3, 0, 50,
                                                      floor=1e-5), 60),
    "inverse_sqrt": (lambda m: m.inverse_sqrt(1e-3, 16), 100),
    "constant": (lambda m: m.constant(1e-3), 5),
}


@pytest.mark.parametrize("name", sorted(SCHEDS))
def test_schedules_match_the_reference(name):
    make, n = SCHEDS[name]
    r, t = make(RS), make(TS)
    steps = np.arange(n)
    want = np.asarray(jax.vmap(r)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(t(int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert t(3).dtype == torch.float32


OPTS = {
    "adamw": (dict(), "adamw"),
    "adamw_decay": (dict(weight_decay=0.1, b2=0.99), "adamw"),
    "adamw_bf16": (dict(weight_decay=0.1), "adamw"),
    "adafactor": (dict(), "adafactor"),
    "adafactor_small_factor": (dict(min_dim_size_to_factor=4,
                                    clip_threshold=0.5), "adafactor"),
    "sgd": (dict(), "sgd"),
    "sgd_momentum": (dict(momentum=0.9), "sgd"),
    "sgd_nesterov": (dict(momentum=0.9, nesterov=True), "sgd"),
}


def _leaves(tree):
    return [tree[k] for k in SHAPES]


@pytest.mark.parametrize("variant", sorted(OPTS))
def test_optimizers_match_the_reference_after_three_updates(variant):
    kw, name = OPTS[variant]
    bf16 = variant.endswith("bf16")
    lr = RS.warmup_cosine(1e-2, 2, 10)
    params = _np_tree(0)
    if bf16:
        params = {k: v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
    grads = [_np_tree(1 + i, scale=0.1 * (i + 1)) for i in range(3)]

    ropt = RO.make(name, lr, **kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = ropt.init(rp)
    for g in grads:
        gj = {k: jnp.asarray(v).astype(rp[k].dtype) for k, v in g.items()}
        upd, rstate = ropt.update(gj, rstate, rp)
        rp = RO.apply_updates(rp, upd)

    dt = torch.bfloat16 if bf16 else torch.float32
    tp = [torch.nn.Parameter(torch.from_numpy(
        np.asarray(v, np.float32)).to(dt)) for v in _leaves(params)]
    topt = TO.make(name, tp, TS.warmup_cosine(1e-2, 2, 10), **kw)
    for g in grads:
        topt.step(grads=[torch.from_numpy(v).to(dt) for v in _leaves(g)])
    assert topt.step_count == 3 == int(rstate["step"])

    for k, got in zip(SHAPES, tp):
        want = rp[k]
        assert got.dtype == dt
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=TOL * max(1.0, np.abs(
                                       want).max()), err_msg=k)
    for i, k in enumerate(SHAPES):
        st = topt.state[tp[i]]
        if name == "adamw":
            ref_st = {"m": rstate["m"][k], "v": rstate["v"][k]}
        elif name == "adafactor":
            ref_st = rstate["v"][k]
        else:
            ref_st = {"m": rstate["m"][k]} if "m" in rstate else {}
        assert sorted(ref_st) == sorted(set(st) - {"step"})
        for sk, want in ref_st.items():
            want = np.asarray(want)
            assert st[sk].shape == want.shape and st[sk].dtype == \
                torch.float32
            np.testing.assert_allclose(
                st[sk].numpy(), want, rtol=0,
                atol=TOL * max(1.0, np.abs(want).max()), err_msg=f"{k} {sk}")


def test_adafactor_factors_exactly_where_the_reference_does():
    opt = TO.Adafactor([torch.nn.Parameter(torch.zeros(s))
                        for s in SHAPES.values()], 1e-3)
    ref = RO.adafactor(1e-3).init({k: jnp.zeros(s)
                                   for k, s in SHAPES.items()})["v"]
    for p, k in zip(opt.params, SHAPES):
        got = {n: tuple(t.shape) for n, t in opt.state[p].items()
               if n != "step"}
        assert got == {n: tuple(np.shape(v)) for n, v in ref[k].items()}


def test_optimizer_without_grads_uses_zeros_and_dot_grad():
    p = torch.nn.Parameter(torch.ones(3))
    a = TO.SGD([p], 0.5)
    p.grad = torch.full((3,), 2.0)
    a.step()
    assert torch.equal(p.detach(), torch.zeros(3))
    q = torch.nn.Parameter(torch.ones(3))
    b = TO.SGD([q], 0.5)
    b.step()                       # no .grad: a zero gradient
    assert torch.equal(q.detach(), torch.ones(3)) and b.step_count == 1
    with pytest.raises(ValueError, match="gradients"):
        b.step(grads=[])


def test_apply_updates_adds_in_float32_and_casts():
    p = torch.tensor([1.0, 256.0], dtype=torch.bfloat16)
    u = torch.tensor([1e-3, 0.75])
    TO.apply_updates([p], [u])
    want = RO.apply_updates({"p": jnp.asarray([1.0, 256.0], jnp.bfloat16)},
                            {"p": jnp.asarray([1e-3, 0.75])})["p"]
    assert torch.equal(p.float(), torch.from_numpy(
        np.asarray(want, np.float32)))


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _np_tree(5)
    want, wnorm = RG.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = TG.clip_by_global_norm(
        [torch.from_numpy(v) for v in _leaves(g)], max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    np.testing.assert_allclose(float(TG.global_norm(got)), float(
        RG.global_norm(want)), rtol=1e-6)
    for k, t in zip(SHAPES, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=TOL)


class _Lin(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))


def _lin_loss(model, batch):
    err = batch["x"] @ model.w - batch["y"]
    return (err * err).mean(), {"err": err.abs().mean()}


def _rlin_loss(params, batch):
    err = batch["x"] @ params["w"] - batch["y"]
    return jnp.mean(err * err), {"err": jnp.mean(jnp.abs(err))}


def test_accumulate_is_the_full_batch_gradient_and_the_reference():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)     # 4 microbatches
    y = rng.normal(size=(4, 5, 3)).astype(np.float32)
    model = _Lin(w)
    grads, aux = TG.accumulate(_lin_loss, model, {"x": torch.from_numpy(x),
                                                  "y": torch.from_numpy(y)})
    (_, _), full = TG.value_and_grad(_lin_loss, model, {
        "x": torch.from_numpy(x.reshape(20, 6)),
        "y": torch.from_numpy(y.reshape(20, 3))})
    np.testing.assert_allclose(grads[0].numpy(), full[0].numpy(), rtol=0,
                               atol=1e-6)
    rgrads, raux = RG.accumulate(_rlin_loss, {"w": jnp.asarray(w)},
                                 {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(rgrads["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux["err"]), float(raux["err"]),
                               rtol=1e-6)
    assert grads[0].dtype == torch.float32
    assert TG.accumulate(_lin_loss, model, {"x": torch.from_numpy(x),
                                            "y": torch.from_numpy(y)},
                         has_aux=False)[0].shape == (6, 3)


def test_value_and_grad_gives_zeros_for_an_unused_parameter():
    model = _Lin(np.ones((2, 2), np.float32))
    model.unused = torch.nn.Parameter(torch.ones(4))
    (loss, _), grads = TG.value_and_grad(
        _lin_loss, model, {"x": torch.ones(1, 2), "y": torch.zeros(1, 2)})
    assert float(loss) == 4.0 and torch.equal(grads[1], torch.zeros(4))
    assert len(grads) == len(TG.trainable(model)) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_equal_the_reference_exactly(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(33, 17)) * 10 ** rng.uniform(-3, 2)).astype(
        np.float32)
    err = (rng.normal(size=g.shape) * 1e-2).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]    # halves: both round to even
    rq, rs, re = RG.compress(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = TG.compress(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_allclose(te.numpy(), np.asarray(re), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(TG.decompress(tq, ts).numpy(),
                                  np.asarray(RG.decompress(rq, rs)))


def test_compressed_mean_matches_the_reference_over_steps():
    g = _np_tree(9)
    rerr = RG.init_error_feedback({k: jnp.asarray(v) for k, v in g.items()})
    terr = TG.init_error_feedback([torch.from_numpy(v) for v in _leaves(g)])
    for step in range(3):
        gs = _np_tree(10 + step)
        rdeq, rerr = RG.compressed_mean({k: jnp.asarray(v)
                                         for k, v in gs.items()}, rerr)
        tdeq, terr = TG.compressed_mean([torch.from_numpy(v)
                                         for v in _leaves(gs)], terr)
        for k, t in zip(SHAPES, tdeq):
            np.testing.assert_allclose(t.numpy(), np.asarray(rdeq[k]),
                                       rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 7, part 3"):
        TG.compressed_mean(tdeq, terr, axis_name="data")
