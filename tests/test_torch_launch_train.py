"""The port's training launcher (``launch/train.py``) and registry, on
the CPU.

* The registry holds the reference's ten arch ids, and every train
  bundle's batch has the reference's shapes and dtypes (smoke and full
  configs, every train shape).
* ``synth_batch`` draws the reference's batches value for value, for
  every arch.
* ``run`` reproduces ``tests/test_train_loop.py``'s three scenarios on
  ``device="cpu"`` (qwen3-14b with checkpoints, yi-9b killed at step 2
  and restarted, dcn-v2 without checkpoints), and a run killed and
  restarted ends with every parameter, moment and step equal to an
  uninterrupted run's (the last checkpoints compared array for array).
* ``main`` trains from the command line with ``--device cpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as RCOMMON
from repro.distributed import sharding as RSH
from repro.launch import train as RLT
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import common as TC
from repro_torch.distributed import fault
from repro_torch.launch import train as TLT

AXES = RSH.Axes(data=("data",), model="model")
ARCHS = sorted(RCOMMON.list_archs())
JNP = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32):
       torch.float32, jnp.dtype(jnp.bool_): torch.bool}


def test_registry_holds_the_reference_arch_ids():
    assert TC.list_archs() == ARCHS
    for a in ARCHS:
        r, t = RCOMMON.get(a), TC.get(a)
        assert (t.family, t.shapes) == (r.family, r.shapes)


def _train_shapes(arch_id):
    r = RCOMMON.get(arch_id)
    if r.family == "lm":
        return ["train_4k"]
    return [s for s in r.shapes if s == "train_batch" or r.family == "gnn"]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_batch_structs_equal_the_reference(arch_id, smoke):
    r, t = RCOMMON.get(arch_id), TC.get(arch_id)
    rcfg = r.make_smoke_config() if smoke else r.make_config()
    tcfg = t.make_smoke_config() if smoke else t.make_config()
    for shape in _train_shapes(arch_id):
        if r.family == "lm" and not smoke:
            # the full LM bundle evaluates its parameter shapes; compare
            # the batch without building one
            from repro.configs.common import LM_SHAPE_PARAMS as SP
            want = {k: ((SP[shape]["global_batch"], SP[shape]["seq_len"]),
                        torch.int32) for k in ("tokens", "labels")}
        else:
            rb = r.build_bundle(rcfg, shape, AXES, n_dp=1, smoke=smoke)
            assert rb.kind == "train"
            want = {k: (tuple(s.shape), JNP[jnp.dtype(s.dtype)])
                    for k, s in rb.arg_structs[2].items()}
        tb = t.build_bundle(tcfg, shape, smoke=smoke)
        assert tb.kind == "train" and tb.arch == arch_id
        assert {k: (s.shape, s.dtype) for k, s in tb.batch_structs.items()
                } == want, (arch_id, shape)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_synth_batch_equals_the_reference(arch_id):
    r, t = RCOMMON.get(arch_id), TC.get(arch_id)
    shape = _train_shapes(arch_id)[0]
    over = dict(seq_len=16, global_batch=4) if r.family == "lm" else {}
    rb = r.build_bundle(r.make_smoke_config(), shape, AXES, n_dp=1,
                        smoke=True, shape_overrides=over)
    tb = t.build_bundle(t.make_smoke_config(), shape, smoke=True,
                        shape_overrides=over)
    vocab_hi = r.make_smoke_config().vocab if r.family == "lm" else 32
    for step in (0, 7):
        want = RLT.synth_batch(rb.arg_structs[2],
                               np.random.default_rng(1000 + step), vocab_hi)
        got = TLT.synth_batch(tb.batch_structs,
                              np.random.default_rng(1000 + step), vocab_hi,
                              "cpu")
        assert list(got) == list(tb.batch_structs)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == tb.batch_structs[k].dtype
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_smoke_train_loop_lm(tmp_path):
    """3 steps of a tiny LM train with checkpointing."""
    steps = TLT.run("qwen3-14b", steps=3, smoke=True,
                    ckpt_dir=str(tmp_path), ckpt_every=2, resume=False,
                    injector=fault.FailureInjector([]),
                    shape_overrides=dict(seq_len=32, global_batch=2),
                    device="cpu")
    assert steps == 3
    assert C.list_steps(str(tmp_path)) == [2, 3]


def _final(ckpt_dir):
    with np.load(f"{ckpt_dir}/ckpt_{C.latest_step(ckpt_dir):010d}.npz") as z:
        return {k: z[k] for k in z.files}


def test_train_loop_restart_resumes_bit_for_bit(tmp_path):
    """yi-9b killed at step 2 and restarted from its checkpoints ends
    with every parameter, moment and step equal to an uninterrupted
    run's."""
    inj = fault.FailureInjector([2])
    resumed = []

    def attempt(resume, d, injector):
        resumed.append(resume)
        return TLT.run("yi-9b", steps=4, smoke=True, ckpt_dir=d,
                       ckpt_every=1, resume=resume, injector=injector,
                       shape_overrides=dict(seq_len=32, global_batch=2),
                       device="cpu")

    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    assert fault.run_with_restarts(lambda r: attempt(r, d1, inj)) == 4
    assert resumed == [False, True]
    assert C.latest_step(d1) == 4
    attempt(False, d2, fault.FailureInjector([]))
    a, b = _final(d1), _final(d2)
    assert sorted(a) == sorted(b) and any(k.startswith("opt//") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_smoke_train_loop_recsys():
    losses = []
    steps = TLT.run("dcn-v2", steps=3, smoke=True, ckpt_dir=None,
                    ckpt_every=10, resume=False,
                    injector=fault.FailureInjector([]),
                    shape_overrides=dict(batch=16), device="cpu",
                    on_step=lambda s, m: losses.append(float(m["loss"])))
    assert steps == 3 and len(losses) == 3
    assert all(np.isfinite(losses))


def test_main_trains_on_the_cpu(tmp_path, capsys):
    assert TLT.main(["--arch", "autoint", "--smoke", "--steps", "2",
                     "--batch", "8", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path), "--ckpt-every", "1", "--fail-at",
                     "1"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "done at step 2" in out
    assert C.list_steps(str(tmp_path)) == [1, 2]


def test_the_seed_sets_the_parameters():
    arch = TC.get("bst")
    b = arch.build_bundle(arch.make_smoke_config(), "train_batch",
                          smoke=True)
    m0, m0b, m1 = (b.init_model(s, "cpu") for s in (0, 0, 1))
    p0, p0b, p1 = (list(m.parameters()) for m in (m0, m0b, m1))
    assert all(torch.equal(x, y) for x, y in zip(p0, p0b))
    assert not all(torch.equal(x, y) for x, y in zip(p0, p1))
