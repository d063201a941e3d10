"""Source discovery and the parsed-module model of the AST passes.

Port of ``repro/analysis/project.py``.  The scanned tree is
``src/repro_torch``: the code that must honour the registry and locking
contracts.  ``tests/``, ``chip_smoke.py`` and ``kernel_timeline.py`` are
out of scope (they call legacy names and poke internals on purpose), as
are the seeded-violation fixtures the tests parse.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

SCAN_DIRS = ("src/repro_torch",)


def repo_root() -> Path:
    """The checkout holding this package (…/src/repro_torch/analysis)."""
    return Path(__file__).resolve().parents[3]


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for chains not rooted at a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: Path            # absolute
    rel: str              # repo-relative posix path
    modname: str          # dotted module name ("repro_torch.core.ivf", …)
    tree: ast.Module

    @classmethod
    def parse(cls, path: Path, root: Path) -> Optional["Module"]:
        try:
            src = path.read_text(encoding="utf-8")
            tree = ast.parse(src, filename=str(path))
        except (OSError, SyntaxError):
            return None
        rel = path.relative_to(root).as_posix()
        return cls(path=path, rel=rel, modname=_modname(rel), tree=tree)


def _modname(rel: str) -> str:
    """Dotted import name for a repo-relative path (best effort)."""
    parts = rel[:-3].split("/") if rel.endswith(".py") else rel.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class Project:
    """The set of modules an AST pass runs over."""

    def __init__(self, root: Optional[Path] = None,
                 scan_dirs: Sequence[str] = SCAN_DIRS):
        self.root = Path(root) if root is not None else repo_root()
        self.scan_dirs = tuple(scan_dirs)
        self._modules: Optional[List[Module]] = None

    @property
    def modules(self) -> List[Module]:
        if self._modules is None:
            self._modules = self._discover()
        return self._modules

    def by_modname(self) -> Dict[str, Module]:
        return {m.modname: m for m in self.modules}

    def _discover(self) -> List[Module]:
        out: List[Module] = []
        for d in self.scan_dirs:
            base = self.root / d
            if not base.exists():
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(n for n in dirnames
                                     if n != "__pycache__")
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    mod = Module.parse(Path(dirpath) / fn, self.root)
                    if mod is not None:
                        out.append(mod)
        return out


def modules_from_paths(paths: Sequence[Path],
                       root: Optional[Path] = None) -> List[Module]:
    """Parse an explicit file list (the fixture tests' entry)."""
    r = Path(root) if root is not None else repo_root()
    out = []
    for p in paths:
        p = Path(p).resolve()
        rel_root = r if p.is_relative_to(r) else p.parent
        mod = Module.parse(p, rel_root)
        if mod is not None:
            out.append(mod)
    return out
