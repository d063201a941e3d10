"""The port's LM loss (``LM.loss_fn``: the chunked next-token
cross-entropy plus the MoE aux loss) and its gradients == the
reference's ``loss_fn``, on the CPU, for the five LM archs at their
smoke sizes: loss, ce, aux and every gradient within 1e-4·max(1, |·|)
(the tolerance the LMs' logits have: MoE dispatch and the soft cap
included), with per-layer recompute (``remat``) on and off, and labels
< 0 masked.  The comparison helpers are ``test_torch_losses.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite_16b as RDS
from repro.configs import grok_1_314b as RGK
from repro.configs import qwen3_14b as RQ3
from repro.configs import qwen15_4b as RQ15
from repro.configs import yi_9b as RYI
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import deepseek_v2_lite_16b as TDS
from repro_torch.configs import grok_1_314b as TGK
from repro_torch.configs import qwen3_14b as TQ3
from repro_torch.configs import qwen15_4b as TQ15
from repro_torch.configs import yi_9b as TYI
from repro_torch.optim import grad as TG

CPU = "cpu"
LM_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_vg(fn, params, *args):
    return jax.jit(jax.value_and_grad(fn, has_aux=True))(params, *args)


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > tol * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, max "
                           f"{np.abs(got - want).max():.3g}")


def check(model, port_loss, batch, rgrads, rloss, rmetrics, to_module, tol):
    """(loss, metrics, every gradient by parameter name) against the
    reference's, its gradient tree converted by ``to_module``."""
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

LMS = {"yi-9b": (RYI, TYI), "qwen1.5-4b": (RQ15, TQ15),
       "qwen3-14b": (RQ3, TQ3), "grok-1": (RGK, TGK),
       "deepseek-v2-lite": (RDS, TDS)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", sorted(LMS))
def test_lm_loss_and_grads_match_the_reference(arch, remat):
    rmod, tmod = LMS[arch]
    rcfg = dataclasses.replace(rmod.smoke_config(), remat=remat)
    tcfg = dataclasses.replace(tmod.smoke_config(), remat=remat)
    params = RT.init_params(rcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(6)
    b, s = 2, 48
    tokens = rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1                                  # masked targets
    (rloss, rm), rgrads = _ref_vg(
        lambda p, t, lb: RT.loss_fn(p, rcfg, t, lb), params,
        jnp.asarray(tokens), jnp.asarray(labels))
    model = convert.lm_params_from_numpy(_np(params), tcfg, device=CPU)
    assert (float(rm["aux"]) > 0) == tcfg.is_moe
    check(model, lambda m, bt: m.loss_fn(*bt),
          (torch.from_numpy(tokens), torch.from_numpy(labels)), rgrads,
          rloss, rm, lambda g: convert.lm_params_from_numpy(g, tcfg,
                                                            device=CPU),
          LM_TOL)


def test_lm_loss_refuses_a_ragged_chunk():
    cfg = dataclasses.replace(TYI.smoke_config(), loss_chunk=16)
    model = convert.lm_params_from_numpy(
        _np(RT.init_params(RYI.smoke_config(), jax.random.PRNGKey(0))), cfg,
        device=CPU)
    tok = np.zeros((1, 24), np.int32)
    with pytest.raises(ValueError, match="loss chunk"):
        model.loss_fn(tok, tok)


