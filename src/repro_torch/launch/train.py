"""Training driver (``repro/launch/train.py``): any registered arch,
smoke or full config, on one device, with the fault-tolerance loop wired
in (auto-resume, async checkpoints, failure injection for drills).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 50 --ckpt-dir /tmp/ck --resume auto [--device cpu]
  ... --fail-at 20 --fail-at 35   (injected crashes; the supervisor
                                   restarts from the last checkpoint)

It runs on cuda unless given ``--device cpu`` (and raises without CUDA,
as every entry point of the port does).  The batches are the
reference's draw for draw (``synth_batch``: ``np.random.default_rng(1000
+ step)``, the same order and bounds), so the port trains on the
reference's data.  The parameters are the port's own: each family's
``*_init`` on a ``torch.Generator`` seeded with ``--seed`` (the
reference seeds its non-LM parameters by ``hash(str(shape))``, which
Python salts per process, so no run can match it).  A resumed run
continues bit for bit: the checkpoint holds every parameter, moment and
step, and step s's batch depends only on s.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import common
from repro_torch.distributed import fault


def synth_batch(structs: Dict[str, common.Struct], rng: np.random.Generator,
                vocab_hi: int, device=None) -> Dict[str, torch.Tensor]:
    """A batch of ``structs``, drawn as the reference's ``synth_batch``
    draws it: the names in sorted order (``jax.tree.map``'s), integers
    uniform in [0, vocab_hi) as int32, booleans all True (no draw),
    floats standard normal in float32, then cast to the struct's
    dtype."""
    dev = _device.resolve(device)
    out = {}
    for name in sorted(structs):
        s = structs[name]
        if s.dtype == torch.bool:
            t = torch.ones(s.shape, dtype=torch.bool)
        elif not s.dtype.is_floating_point:
            t = torch.from_numpy(rng.integers(0, vocab_hi, s.shape).astype(
                np.int32)).to(s.dtype)
        else:
            t = torch.from_numpy(rng.normal(size=s.shape).astype(
                np.float32)).to(s.dtype)
        out[name] = t.to(dev)
    return {name: out[name] for name in structs}


def train_state(model: torch.nn.Module, opt: torch.optim.Optimizer):
    """The checkpointed tree: every parameter, every moment and step."""
    return {"params": model.state_dict(), "opt": opt.state_dict()["state"]}


def run(arch_id: str, *, steps: int, smoke: bool, ckpt_dir: Optional[str],
        ckpt_every: int, resume: bool, injector: fault.FailureInjector,
        shape: str = "train_4k", shape_overrides: Optional[dict] = None,
        device=None, seed: int = 0,
        on_step: Optional[Callable[[int, Dict], None]] = None) -> int:
    """Train ``arch_id`` to ``steps``; returns ``steps``.  ``shape`` falls
    back to the arch's first shape where it has no such one (the non-LM
    archs).  With ``resume`` and a checkpoint in ``ckpt_dir`` the run
    continues from the latest one.  ``on_step(step, metrics)`` is called
    after each step."""
    dev = _device.resolve(device)
    arch = common.get(arch_id)
    cfg = arch.make_smoke_config() if smoke else arch.make_config()
    train_shape = shape if shape in arch.shapes else arch.shapes[0]
    bundle = arch.build_bundle(cfg, train_shape, smoke=smoke,
                               shape_overrides=shape_overrides or {})
    model = bundle.init_model(seed, dev)
    opt = bundle.make_optimizer(model)
    vocab_hi = cfg.vocab if arch.family == "lm" else 32
    state = train_state(model, opt)

    start = 0
    ckpt = CKPT.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if resume and ckpt_dir:
        latest = CKPT.latest_step(ckpt_dir)
        if latest is not None:
            CKPT.load_into(state, CKPT.restore(ckpt_dir, latest, state))
            start = latest
            print(f"[train] resumed from step {latest}")

    t0 = time.time()
    try:
        for s in range(start, steps):
            injector.check(s)
            batch = synth_batch(bundle.batch_structs,
                                np.random.default_rng(1000 + s), vocab_hi,
                                dev)
            metrics = bundle.step_fn(model, opt, batch)
            if on_step is not None:
                on_step(s + 1, metrics)
            if (s + 1) % max(1, steps // 10) == 0 or s + 1 == steps:
                print(f"[train] step {s + 1:5d} loss "
                      f"{float(metrics['loss']):.4f} "
                      f"({(time.time() - t0) / (s - start + 1):.2f}s/step)")
            if ckpt and ((s + 1) % ckpt_every == 0 or s + 1 == steps):
                ckpt.save(s + 1, state)
    finally:
        # a write in flight lands before the run returns or fails, so a
        # restart sees every checkpoint this run made
        if ckpt:
            ckpt.wait()
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto")
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters' torch.Generator")
    args = ap.parse_args(argv)

    overrides = {}
    if args.seq_len:
        overrides["seq_len"] = args.seq_len
    if args.batch:
        overrides["global_batch"] = args.batch
        overrides["batch"] = args.batch
    _device.resolve(args.device)
    injector = fault.FailureInjector(args.fail_at)

    def attempt(resume: bool) -> int:
        return run(args.arch, steps=args.steps, smoke=args.smoke,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   resume=resume and args.resume == "auto",
                   injector=injector, shape_overrides=overrides,
                   device=args.device, seed=args.seed)

    final = fault.run_with_restarts(attempt)
    print(f"[train] done at step {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
