"""Pass ``guarded-fields`` — declared lock→field guard lint (AST, GF8xx).

Port of ``repro/analysis/guarded_fields.py``.  Classes that take part
in the serving layer's threading declare their locking convention with
``repro_torch.concurrency.guarded_by``, read here by name from the AST
(``_guard_decl``)::

    @guarded_by("_lock", "_queue", "batch_sizes")
    class MicroBatcher: ...

This pass checks the declaration against every method body:

  GF801  a read or write of a guarded field not dominated by the owning
         lock — neither inside a ``with self.<lock>:`` block (lock
         aliases resolve: a ``Condition(self._lock)`` counts as
         ``_lock``) nor in a method declared ``@holds("<lock>")``.
  GF802  a field mutated from ≥ 2 distinct methods with *no* declared
         guard — the tell-tale shape of an undeclared shared mutable.
         Fields initialised to a ``threading`` primitive (Event, Lock,
         …) are exempt (they synchronise themselves), as is
         ``__init__`` (objects under construction are single-owner).
         Mutator *method calls* (``self.x.append(…)``) count only for
         fields initialised to a plain container — a call like
         ``self._slab.clear(rows)`` on a constructed component object
         delegates to that object's API, which owns its own
         synchronisation (direct assignments always count).

Only annotated classes are checked — the pass is opt-in per class, so
single-threaded code pays nothing.  In the port those are
``serving/result_cache.py`` ``ResultCache``, ``serving/router.py``
``ReplicatedSearchEngine``, ``serving/scheduler.py`` ``MicroBatcher``
and ``HedgedExecutor``, and ``serving/sessions.py`` ``SessionStore``.
The dynamic checker (``repro_torch.analysis.tsan``) enforces the same declarations at runtime via
``__guarded_fields__``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lock_order import _ClassLocks, _holds_locks
from repro_torch.analysis.project import Module, Project, _attr_chain

PASS_ID = "guarded-fields"

_THREADING_CTORS = {"Event", "Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore", "Barrier"}

#: method calls that mutate their receiver in place
_MUTATOR_CALLS = {"append", "appendleft", "pop", "popleft", "add",
                  "remove", "clear", "update", "extend", "insert",
                  "setdefault", "discard", "move_to_end"}

#: constructors whose instances are plain (unsynchronised) containers
_CONTAINER_CTORS = {"list", "dict", "set", "frozenset", "deque",
                    "OrderedDict", "defaultdict", "Counter"}


def _guard_decl(cnode: ast.ClassDef) -> Dict[str, str]:
    """field → owning lock attr from the ``@guarded_by`` decorators."""
    decl: Dict[str, str] = {}
    for dec in cnode.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        chain = _attr_chain(dec.func) or []
        if not (chain and chain[-1] == "guarded_by"):
            continue
        consts = [a.value for a in dec.args
                  if isinstance(a, ast.Constant)
                  and isinstance(a.value, str)]
        if len(consts) >= 2:
            lock, fields = consts[0], consts[1:]
            for f in fields:
                decl[f] = lock
    return decl


class _GuardScan(ast.NodeVisitor):
    """GF801 over one method body, tracking the held-lock set."""

    def __init__(self, mod: Module, cls: str, fn: ast.AST,
                 decl: Dict[str, str], locks: Dict[str, str],
                 findings: List[Finding]):
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.decl = decl
        self.locks = locks      # lock attr -> canonical (alias-resolved)
        self.findings = findings
        self.held: List[str] = [self.locks.get(h, h)
                                for h in _holds_locks(fn)]

    def run(self) -> None:
        for stmt in self.fn.body:
            self.visit(stmt)

    def visit_With(self, node: ast.With) -> None:
        entered = 0
        for item in node.items:
            chain = _attr_chain(item.context_expr)
            if chain and len(chain) == 2 and chain[0] == "self" \
                    and chain[1] in self.locks:
                self.held.append(self.locks[chain[1]])
                entered += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(entered):
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            lock = self.decl.get(node.attr)
            if lock is not None and \
                    self.locks.get(lock, lock) not in self.held:
                kind = ("write" if isinstance(node.ctx,
                                              (ast.Store, ast.Del))
                        else "read")
                self.findings.append(Finding(
                    pass_id=PASS_ID, code="GF801", path=self.mod.rel,
                    line=node.lineno,
                    message=(f"in `{self.cls}.{self.fn.name}`: {kind} "
                             f"of `self.{node.attr}` (guarded by "
                             f"`{lock}`) outside `with self.{lock}:`")))
        self.generic_visit(node)


def _mutated_fields(fn: ast.AST,
                    call_exempt: Set[str] = frozenset()) -> Dict[str, int]:
    """self-attribute → first mutation line, for one method body.

    ``call_exempt``: attributes whose mutator-call mutations are
    ignored (constructed component objects with their own API)."""
    out: Dict[str, int] = {}

    def note(attr: str, line: int) -> None:
        out.setdefault(attr, line)

    def self_attr(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node,
                                                        ast.AugAssign)
                       else node.targets)
            for tgt in targets:
                for t in ast.walk(tgt):
                    attr = self_attr(t)
                    if attr is not None and not isinstance(
                            getattr(t, "ctx", None), ast.Load):
                        note(attr, t.lineno)
                    # self.x[i] = … mutates self.x
                    if isinstance(t, ast.Subscript):
                        attr = self_attr(t.value)
                        if attr is not None:
                            note(attr, t.lineno)
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain and len(chain) == 3 and chain[0] == "self" \
                    and chain[2] in _MUTATOR_CALLS \
                    and chain[1] not in call_exempt:
                note(chain[1], node.lineno)
    return out


def _call_exempt_attrs(cnode: ast.ClassDef) -> Set[str]:
    """Attributes initialised from a non-container constructor call —
    mutator calls on them delegate to that object's own API."""
    out: Set[str] = set()
    for node in ast.walk(cnode):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            ctor = _attr_chain(node.value.func) or []
            if not ctor or ctor[-1] in _CONTAINER_CTORS:
                continue
            for tgt in node.targets:
                chain = _attr_chain(tgt)
                if chain and len(chain) == 2 and chain[0] == "self":
                    out.add(chain[1])
    return out


def _threading_attrs(cnode: ast.ClassDef) -> Set[str]:
    """self-attributes initialised to a ``threading`` primitive."""
    out: Set[str] = set()
    for node in ast.walk(cnode):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            ctor = _attr_chain(node.value.func) or []
            if ctor and ctor[-1] in _THREADING_CTORS:
                for tgt in node.targets:
                    chain = _attr_chain(tgt)
                    if chain and len(chain) == 2 and chain[0] == "self":
                        out.add(chain[1])
    return out


def _scan_class(mod: Module, cnode: ast.ClassDef,
                findings: List[Finding]) -> None:
    decl = _guard_decl(cnode)
    if not decl:
        return
    locks = _ClassLocks(cnode).locks
    sync_attrs = _threading_attrs(cnode)
    call_exempt = _call_exempt_attrs(cnode)
    mutations: Dict[str, List[Tuple[str, int]]] = {}
    for node in cnode.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "__init__":
            continue
        _GuardScan(mod, cnode.name, node, decl, locks, findings).run()
        for attr, line in _mutated_fields(node, call_exempt).items():
            if attr in decl or attr in locks or attr in sync_attrs:
                continue
            mutations.setdefault(attr, []).append((node.name, line))
    for attr, sites in sorted(mutations.items()):
        methods = sorted({m for m, _ in sites})
        if len(methods) < 2:
            continue
        line = min(ln for _, ln in sites)
        findings.append(Finding(
            pass_id=PASS_ID, code="GF802", path=mod.rel, line=line,
            message=(f"in `{cnode.name}`: `self.{attr}` mutated from "
                     f"{len(methods)} methods ({', '.join(methods)}) "
                     f"with no declared guard — add it to a "
                     f"`@guarded_by(…)` or document why it is "
                     f"single-threaded")))


def run(project: Optional[Project] = None,
        modules: Optional[Sequence[Module]] = None) -> List[Finding]:
    """Run the pass over every annotated class in scope."""
    mods = list(modules) if modules is not None else (
        project or Project()).modules
    findings: List[Finding] = []
    for mod in mods:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                _scan_class(mod, node, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
