"""The port's checkpoints and restart supervisor, on the CPU.

``checkpoint.save`` publishes atomically (a crash mid-write leaves the
previous latest checkpoint the latest, and no ``.tmp`` is ever listed),
names files as the reference does (``ckpt_%010d.npz``, so the
reference's ``list_steps`` reads a port directory), keeps the last k,
refuses a missing leaf (``KeyError``) and a shape mismatch
(``ValueError``), carries bfloat16 bit for bit, and writes in the
background with errors raised at ``wait``.  A training loop killed at
chosen steps and restarted from its checkpoints ends ``torch.equal`` to
an uninterrupted one (the reference's ``test_restart_bitexact``), and
the supervisor gives up after ``max_restarts``.
"""
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as RC
from repro_torch.checkpoint import checkpoint as C
from repro_torch.distributed import fault
from repro_torch.optim import optimizers as O


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "h": torch.randn(5, generator=g).to(torch.bfloat16)},
            "opt": {0: {"m": torch.randn(4, 3, generator=g),
                        "step": torch.tensor(7, dtype=torch.int32)}}}


def test_save_restore_round_trip_in_place(tmp_path):
    a, b = _tree(0), _tree(1)
    path = C.save(str(tmp_path), 12, a)
    assert os.path.basename(path) == "ckpt_0000000012.npz"
    with np.load(path) as z:
        assert sorted(z.files) == ["opt//0//m", "opt//0//step",
                                   "params//h", "params//w"]
    C.load_into(b, C.restore(str(tmp_path), 12, b))
    for key in ("w", "h"):
        assert b["params"][key].dtype == a["params"][key].dtype
        assert torch.equal(b["params"][key], a["params"][key])
    assert torch.equal(b["opt"][0]["m"], a["opt"][0]["m"])
    assert int(b["opt"][0]["step"]) == 7


def test_names_and_steps_are_the_reference_ones(tmp_path):
    for s in (3, 10, 1):
        C.save(str(tmp_path), s, _tree(s))
    assert C.list_steps(str(tmp_path)) == RC.list_steps(str(tmp_path)) \
        == [1, 3, 10]
    assert C.latest_step(str(tmp_path)) == RC.latest_step(str(tmp_path))
    assert C.latest_step(str(tmp_path / "none")) is None


def test_missing_leaf_and_shape_mismatch_are_refused(tmp_path):
    C.save(str(tmp_path), 1, _tree())
    extra = _tree()
    extra["params"]["new"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params//new"):
        C.restore(str(tmp_path), 1, extra)
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore(str(tmp_path), 1, wrong)


def test_a_crash_mid_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    C.save(str(tmp_path), 1, _tree(1))

    def crash(*a, **k):
        raise OSError("disk lost")

    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError):
        C.save(str(tmp_path), 2, _tree(2))
    monkeypatch.undo()
    assert C.list_steps(str(tmp_path)) == [1]
    assert any(n.endswith(".tmp.npz") for n in os.listdir(tmp_path))
    back = _tree(5)
    C.load_into(back, C.restore(str(tmp_path), 1, back))
    assert torch.equal(back["params"]["w"], _tree(1)["params"]["w"])


def test_keep_last_k(tmp_path):
    for s in range(1, 6):
        C.save(str(tmp_path), s, _tree(s))
    C.keep_last_k(str(tmp_path), 2)
    assert C.list_steps(str(tmp_path)) == [4, 5]
    C.keep_last_k(str(tmp_path), 0)
    assert C.list_steps(str(tmp_path)) == [4, 5]


def test_async_checkpointer_copies_on_save(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree(0)
    want = t["params"]["w"].clone()
    for s in (1, 2, 3):
        ck.save(s, t)
        t["params"]["w"].add_(1.0)      # after save: not in that step
    ck.wait()
    assert C.list_steps(str(tmp_path)) == [2, 3]
    back = _tree(9)
    C.load_into(back, C.restore(str(tmp_path), 3, back))
    assert torch.equal(back["params"]["w"], want + 2.0)


def test_async_error_surfaces_at_wait(tmp_path, monkeypatch):
    ck = C.AsyncCheckpointer(str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("write failed")

    monkeypatch.setattr(C, "_write", boom)
    ck.save(1, _tree())
    with pytest.raises(RuntimeError, match="write failed"):
        ck.wait()
    ck.wait()


def _train(ckpt_dir, n_steps, resume, fail, every=2):
    """The reference's fault-tolerance loop: AdamW on ||x w||², a
    checkpoint every ``every`` steps, resume from the latest."""
    w = torch.nn.Parameter(torch.ones(8, 8))
    opt = O.AdamW([w], 1e-2)
    state = {"params": {"w": w.data}, "opt": opt.state_dict()["state"]}
    start = 0
    if resume:
        latest = C.latest_step(ckpt_dir)
        if latest is not None:
            C.load_into(state, C.restore(ckpt_dir, latest, state))
            start = latest
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8)
                                                         ).astype(np.float32))
    for s in range(start, n_steps):
        fail.check(s)
        loss = ((x @ w) ** 2).sum()
        (g,) = torch.autograd.grad(loss, [w])
        opt.step(grads=[g])
        if (s + 1) % every == 0 or s + 1 == n_steps:
            C.save(ckpt_dir, s + 1, state)
    return w.detach(), opt.state[w]


def test_restart_bitexact(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    w_ref, st_ref = _train(d1, 10, False, fault.FailureInjector([]))
    inj = fault.FailureInjector([3, 7])
    w_rec, st_rec = fault.run_with_restarts(
        lambda resume: _train(d2, 10, resume, inj))
    assert torch.equal(w_ref, w_rec)
    for k in ("m", "v", "step"):
        assert torch.equal(st_ref[k], st_rec[k])


def test_supervisor_gives_up_after_max_restarts():
    calls = []

    def always(resume):
        calls.append(resume)
        raise fault.SimulatedFailure("down")

    with pytest.raises(fault.SimulatedFailure):
        fault.run_with_restarts(always, max_restarts=3)
    assert calls == [False, True, True, True]
    inj = fault.FailureInjector([2, 2, 5])
    inj.check(1)
    with pytest.raises(fault.SimulatedFailure, match="step 2"):
        inj.check(2)
    inj.check(2)                        # each trigger fires once
    with pytest.raises(RuntimeError):
        fault.run_with_restarts(lambda r: (_ for _ in ()).throw(
            RuntimeError("a real crash is not restarted")))
