#!/usr/bin/env python3
"""What aten ops allocate inside themselves on one GPU, against the
dry-run's rule for it.

``launch.analysis``'s counter sees every storage an op returns, but not
what the op allocates and frees before it returns (a copy, a sort's
buffers, a reduction's staging buffer).  Those count toward the card's
``max_memory_allocated``, so the counter adds them, op by op, by the
rules of ``analysis._workspace``.  This script runs one step of every
registry bundle at its smoke size on the card under a subclass of the
counter that resets the allocator's peak before each aten op and reads
it after.  What an op held inside itself is the peak over the op less
the larger of the bytes allocated before and after it.  It prints, per
op, the calls that held 64 KiB or more and the largest of them with its
inputs, and each call where the rule counts less than the op held
(``UNDER``).  It exits 1 if there is such a call, or without a card.

Usage: PYTHONPATH=src python3 op_workspaces.py
"""
import collections
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("op_workspaces: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get, list_archs
    from repro_torch.launch import analysis, dryrun

    dev = torch.device("cuda")
    # cuBLAS's workspaces come with a handle's first products, forward
    # and backward: make them here, outside every op that is read
    for dt in (torch.float32, torch.bfloat16):
        w = torch.ones((2, 64, 64), dtype=dt, device=dev, requires_grad=True)
        (torch.bmm(w, w).sum() + (w[0] @ w[1]).sum()
         + torch.nn.functional.linear(w[0], w[1], w[0, 0]).sum()
         ).backward()
    del w
    torch.cuda.synchronize()

    held = collections.defaultdict(list)    # op -> (bytes, rule, cell, inputs)

    class Probe(analysis.Counter):
        cell = ""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            inner = (torch.cuda.max_memory_allocated()
                     - max(before, torch.cuda.memory_allocated()))
            if inner >= 64 * 1024:
                name = func._overloadpacket.__name__
                ins = analysis.tensor_leaves((args, kwargs))
                rule = analysis._workspace(name, ins,
                                           analysis.tensor_leaves(out))
                held[name].append((inner, rule, Probe.cell, str(func), [
                    (tuple(t.shape), str(t.dtype)[6:]) for t in ins]))
            return out

    analysis.Counter = Probe
    for a in list_archs():
        arch = get(a)
        for shape in arch.shapes:
            Probe.cell = f"{a} {shape}"
            bundle = arch.build_bundle(arch.make_smoke_config(), shape,
                                       smoke=True)
            dryrun.trace(bundle, device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    under = 0
    for name, calls in sorted(held.items(), key=lambda kv: -max(kv[1])[0]):
        top = max(calls)
        print(f"{name}: {len(calls)} calls held 64 KiB or more, the most "
              f"{top[0]} B (rule {top[1]} B) in {top[2]}, {top[3]} of "
              f"{top[4]}")
        for c in calls:
            if c[1] < c[0]:
                under += 1
                print(f"  UNDER {c[0]} B held, rule {c[1]} B: {c[2]}, "
                      f"{c[3]} of {c[4]}")
    print(f"op_workspaces: {sum(map(len, held.values()))} calls held 64 KiB"
          f" or more, {under} above the rule")
    return 1 if under else 0


if __name__ == "__main__":
    raise SystemExit(main())
