"""repro_torch.analysis — the port's invariant checks.

Six passes over the tree (``python -m repro_torch.analysis``), each the
counterpart of a pass of the reference's ``repro.analysis``:

  ==============  =====================================================
  contract        live registry: backends frozen, hashed by value,
                  array-free, with the full driver surface  (SC2xx)
  kernels         recorded launch plans of every ``kernels.ops`` entry
                  on the reference's probe shapes: shared memory per
                  block, threads per block, grid extents      (PK4xx)
  shard           live: a tiny index placed on a 2-shard CPU mesh,
                  each leaf and per-shard operand where it must lie,
                  replicated TopLoc state never partitioned   (SS5xx)
  deprecated      AST: internal use of legacy toploc.* aliases (DA6xx)
  lock-order      AST over serving/ + distributed/: lock-graph cycles,
                  bare acquire(), blocking under a lock       (LK7xx)
  guarded-fields  AST: ``@guarded_by`` declarations vs actual lock
                  domination; undeclared shared mutables      (GF8xx)
  ==============  =====================================================

The reference's two other passes, ``trace-safety`` (TS1xx) and
``retrace`` (RT3xx), check ``jit`` boundaries, which the port has none
of; their counterpart (host syncs and ``.item()`` in a turn) is still to
be designed (ROADMAP Queue 1, item 8).  Findings are suppressed only by
``analysis-baseline.txt``, which stays empty.

The dynamic half of the concurrency checks is here too: ``tsan`` (an
instrumented ``threading`` shim: lock-order graph, vector-clock races,
the ``@guarded_by`` locksets) and ``schedules`` (seeded deterministic
preemptions, ``replay``), run over the batched serving engine by
``tests/test_torch_concurrency.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.analysis.findings import (  # noqa: F401
    Finding, apply_baseline, load_baseline)
from repro_torch.analysis.project import Project  # noqa: F401


def all_passes() -> Dict[str, Callable]:
    """pass name -> ``run(project) -> List[Finding]`` (import-lazy)."""
    from repro_torch.analysis import (deprecation, guarded_fields,
                                      kernel_budget, lock_order,
                                      shard_specs, static_contract)
    return {
        "contract": static_contract.run,
        "kernels": lambda project=None: kernel_budget.run(),
        "shard": shard_specs.run,
        "deprecated": deprecation.run,
        "lock-order": lock_order.run,
        "guarded-fields": guarded_fields.run,
    }


def run_all(project: Optional[Project] = None,
            select: Optional[List[str]] = None) -> List[Finding]:
    """Run the selected (default: all) passes over the tree."""
    passes = all_passes()
    if select:
        unknown = set(select) - set(passes)
        if unknown:
            raise ValueError(f"unknown pass(es) {sorted(unknown)}; "
                             f"available: {sorted(passes)}")
        passes = {k: v for k, v in passes.items() if k in select}
    proj = project if project is not None else Project()
    findings: List[Finding] = []
    for fn in passes.values():
        findings.extend(fn(proj))
    return findings
