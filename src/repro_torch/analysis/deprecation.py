"""Pass ``deprecated`` — use of the deprecated ``toploc.*`` aliases.

Port of ``repro/analysis/deprecation.py``.  The 18 legacy prefixed
entry points of ``repro_torch.core.toploc`` (``ivf_start``,
``ivf_pq_step_batch``, ``hnsw_conversation``, …) survive for downstream
callers, but the port's own code (``src/repro_torch``) must be on the
``core.backend`` registry API.  The alias set is collected live: every
wrapper carries the ``__deprecated_alias__`` marker that
``toploc._deprecated_alias`` sets, so a newly deprecated entry point is
covered with no edit here.

  DA601  internal call or import of a deprecated ``toploc.*`` alias
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Module, Project, _attr_chain

PASS_ID = "deprecated-alias"

_TOPLOC_MODULE = "repro_torch.core.toploc"


def live_alias_names() -> Set[str]:
    """Names of every ``toploc`` function marked deprecated."""
    from repro_torch.core import toploc
    return {n for n in dir(toploc)
            if getattr(getattr(toploc, n), "__deprecated_alias__", False)}


def _check_module(mod: Module, aliases: Set[str],
                  findings: List[Finding]) -> None:
    if mod.modname == _TOPLOC_MODULE:
        return  # the aliases' own definitions
    # local names bound to the toploc module (import aliases)
    toploc_names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _TOPLOC_MODULE:
                    toploc_names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module == _TOPLOC_MODULE:
                for a in node.names:
                    if a.name in aliases:
                        findings.append(Finding(
                            PASS_ID, "DA601", mod.rel, node.lineno,
                            f"imports deprecated alias "
                            f"`toploc.{a.name}` — internal code must "
                            f"use the core.backend registry drivers"))
            elif node.module in ("repro_torch.core", "repro_torch"):
                for a in node.names:
                    if a.name == "toploc":
                        toploc_names.add(a.asname or a.name)
    if not toploc_names:
        return
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if (chain and len(chain) == 2 and chain[0] in toploc_names
                    and chain[1] in aliases):
                findings.append(Finding(
                    PASS_ID, "DA601", mod.rel, node.lineno,
                    f"uses deprecated alias `toploc.{chain[1]}` — "
                    f"internal code must use the core.backend registry "
                    f"drivers"))


def run(project: Optional[Project] = None,
        modules: Optional[Sequence[Module]] = None,
        aliases: Optional[Set[str]] = None) -> List[Finding]:
    mods = list(modules) if modules is not None else (
        project or Project()).modules
    names = aliases if aliases is not None else live_alias_names()
    findings: List[Finding] = []
    for mod in mods:
        _check_module(mod, names, findings)
    findings.sort(key=lambda f: (f.path, f.line))
    return findings
