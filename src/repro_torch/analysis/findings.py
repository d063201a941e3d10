"""Finding / baseline plumbing shared by the port's analysis passes.

The port's own copy of ``repro/analysis/findings.py`` (the port imports
nothing of ``repro``).  A *finding* is one diagnostic, ``path:line: CODE
message``.  The baseline file (``analysis-baseline.txt`` at the repo
root, shared with the reference's passes) holds ``fnmatch`` patterns,
one per line, matched against that rendered form; a finding matching
any pattern is *suppressed* (reported separately, never fatal).  The
tree's contract is that the baseline stays empty: a finding is repaired
where it arises.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic emitted by an analysis pass."""

    pass_id: str      # e.g. "kernel-budget"
    code: str         # e.g. "PK401"
    path: str         # repo-relative posix path ("" for live checks)
    line: int         # 1-based; 0 when no source location applies
    message: str

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<live>"
        return f"{loc}: {self.code} {self.message}"


def load_baseline(path: str) -> List[str]:
    """Suppression patterns from ``path`` (missing file: none)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except FileNotFoundError:
        return []
    return [s for s in (raw.strip() for raw in lines)
            if s and not s.startswith("#")]


def apply_baseline(
    findings: Sequence[Finding], patterns: Sequence[str],
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (active, suppressed); also return the
    baseline patterns that matched nothing (stale entries)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    used = set()
    for f in findings:
        rendered = f.render()
        hit = next((pat for pat in patterns
                    if fnmatch.fnmatch(rendered, pat)
                    or fnmatch.fnmatch(rendered, f"*{pat}*")), None)
        if hit is None:
            active.append(f)
        else:
            used.add(hit)
            suppressed.append(f)
    stale = [p for p in patterns if p not in used]
    return active, suppressed, stale
