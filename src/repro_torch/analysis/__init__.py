"""repro_torch.analysis — the port's invariant checks.

One pass so far (``python -m repro_torch.analysis``), the counterpart of
the reference's ``kernels`` pass (``repro/analysis/kernel_budget.py``):

  ==============  =====================================================
  kernels         recorded launch plans of every ``kernels.ops`` entry
                  on the reference's probe shapes: shared memory per
                  block, threads per block, grid extents      (PK4xx)
  ==============  =====================================================

The reference's seven other passes (trace-safety, contract, retrace,
shard, deprecated, lock-order, guarded-fields) come with the modules
they check (ROADMAP Queue 1, item 8).  Findings are suppressed only by
``analysis-baseline.txt``, which stays empty.

The dynamic half of the reference's concurrency sanitizer is here:
``tsan`` (an instrumented ``threading`` shim: lock-order graph,
vector-clock races, the ``@guarded_by`` locksets) and ``schedules``
(seeded deterministic preemptions, ``replay``), run over the batched
serving engine by ``tests/test_torch_concurrency.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.analysis.findings import (  # noqa: F401
    Finding, apply_baseline, load_baseline)


def all_passes() -> Dict[str, Callable]:
    """pass name -> ``run() -> List[Finding]`` (import-lazy)."""
    from repro_torch.analysis import kernel_budget
    return {"kernels": kernel_budget.run}


def run_all(select: Optional[List[str]] = None) -> List[Finding]:
    """Run the selected (default: all) passes."""
    passes = all_passes()
    if select:
        unknown = set(select) - set(passes)
        if unknown:
            raise ValueError(f"unknown pass(es) {sorted(unknown)}; "
                             f"available: {sorted(passes)}")
        passes = {k: v for k, v in passes.items() if k in select}
    findings: List[Finding] = []
    for fn in passes.values():
        findings.extend(fn())
    return findings
