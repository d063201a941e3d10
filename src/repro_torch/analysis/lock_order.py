"""Pass ``lock-order`` — lock-order / lock-discipline lint (AST, LK7xx).

Port of ``repro/analysis/lock_order.py``.  The serving layer is
multi-threaded (client submitters, the flusher, replica pump threads,
hedge pools); this pass checks the three lock-discipline invariants
that keep it deadlock-free, over ``serving/`` + ``distributed/``:

  LK701  lock-acquisition cycle: the per-class lock graph (edge L→K
         when K is acquired while L is held, including one level of
         ``self.<method>()`` calls) contains a cycle — two threads
         taking the locks in opposite orders deadlock.  Reentrant
         self-edges on ``RLock`` locks are exempt (that is what RLock
         is for).
  LK702  a ``threading`` primitive acquired outside a ``with`` block or
         ``try``/``finally`` — any exception between ``acquire()`` and
         ``release()`` leaks the lock and wedges every later acquirer.
  LK703  a blocking call (``Future.result``, ``synchronize``,
         ``Thread.join``, queue ``get``, pool ``shutdown``,
         ``time.sleep``, bare ``wait``) made while holding a lock —
         the classic lost-wakeup/convoy shape: whatever must run to
         unblock the call may itself need the held lock.
         ``cv.wait()`` *on the condition variable currently held by the
         enclosing ``with``* is exempt (that is the condvar protocol —
         wait releases the lock while sleeping).

``synchronize`` (``torch.cuda.synchronize``, ``Event.synchronize``,
``Stream.synchronize``) is the port's counterpart of the reference's
``block_until_ready``.  Host reads of a tensor (``.item()``,
``.tolist()``, ``.cpu()``, ``bool(t)``) are not counted: they wait for
the device, never for another thread, and the one the tree makes under
a lock (``ResultCache.invalidate_docs`` reading each sequential entry's
ids) is the reference's own ``np.asarray`` there.  A wait one call
deeper than ``self.<method>()`` is not seen, in either package: the
batcher retires a wave under ``_drain_lock`` through the wave's
``complete`` callback, which waits on the wave's event.

Lock discovery is per class: ``self.X = threading.Lock()/RLock()``
declares lock attribute ``X``; ``self.Y = threading.Condition(self.X)``
makes ``Y`` an *alias* of ``X`` (entering the condition acquires the
underlying lock); ``self.Q = queue.Queue()`` marks ``Q`` so ``Q.get()``
counts as blocking.  ``@holds("_lock")`` (``repro_torch.concurrency``)
seeds the held-set of a method whose caller holds the lock by contract.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.project import Module, Project, _attr_chain

PASS_ID = "lock-order"

#: repo-relative prefixes scanned when running over the whole project
SCOPE_PREFIXES = ("src/repro_torch/serving/", "src/repro_torch/distributed/")

_LOCK_CTORS = {"Lock", "RLock"}
_COND_CTORS = {"Condition"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}

#: attribute calls that block the calling thread
_BLOCKING_ATTRS = {"result", "synchronize", "shutdown"}


def _with_lock_attr(item: ast.withitem,
                    locks: Dict[str, str]) -> Optional[str]:
    """Canonical lock attr for ``with self.X:`` (None if not a lock)."""
    chain = _attr_chain(item.context_expr)
    if chain and len(chain) == 2 and chain[0] == "self":
        return locks.get(chain[1])
    return None


class _ClassLocks:
    """Lock/queue attribute discovery for one class body."""

    def __init__(self, cnode: ast.ClassDef):
        self.cnode = cnode
        self.locks: Dict[str, str] = {}    # attr -> canonical lock attr
        self.rlocks: Set[str] = set()      # canonical attrs that are RLock
        self.queues: Set[str] = set()
        for node in ast.walk(cnode):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                self._assign(node)

    def _assign(self, node: ast.Assign) -> None:
        ctor = _attr_chain(node.value.func)
        if not ctor:
            return
        name = ctor[-1]
        for tgt in node.targets:
            chain = _attr_chain(tgt)
            if not (chain and len(chain) == 2 and chain[0] == "self"):
                continue
            attr = chain[1]
            if name in _LOCK_CTORS:
                self.locks[attr] = attr
                if name == "RLock":
                    self.rlocks.add(attr)
            elif name in _COND_CTORS:
                # Condition(self.X) aliases the underlying lock; a bare
                # Condition() owns a private lock — canonical = itself
                args = node.value.args
                inner = _attr_chain(args[0]) if args else None
                if inner and len(inner) == 2 and inner[0] == "self":
                    self.locks[attr] = inner[1]
                else:
                    self.locks[attr] = attr
            elif name in _QUEUE_CTORS:
                self.queues.add(attr)


class _MethodScan(ast.NodeVisitor):
    """One method body: collect lock edges + LK702/LK703 findings."""

    def __init__(self, mod: Module, cls: str, fn: ast.AST,
                 info: _ClassLocks, held0: Sequence[str],
                 findings: List[Finding]):
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.info = info
        self.findings = findings
        # stack of (canonical lock, with-object attr) currently held
        self.held: List[Tuple[str, str]] = [(h, h) for h in held0]
        # lock edges observed: (outer, inner, line)
        self.edges: List[Tuple[str, str, int]] = []
        # (canonical lock, line) of self-method calls made while held
        self.calls_held: List[Tuple[str, str, int]] = []

    def run(self) -> None:
        for stmt in self.fn.body:
            self.visit(stmt)

    def _emit(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            pass_id=PASS_ID, code=code, path=self.mod.rel,
            line=getattr(node, "lineno", 0),
            message=f"in `{self.cls}.{self.fn.name}`: {msg}"))

    # -- with / acquire tracking --------------------------------------

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            lock = _with_lock_attr(item, self.info.locks)
            if lock is None:
                continue
            chain = _attr_chain(item.context_expr)
            for outer, _ in self.held:
                if outer == lock and lock in self.info.rlocks:
                    continue          # reentrant RLock self-acquire
                self.edges.append((outer, lock, item.context_expr.lineno))
            self.held.append((lock, chain[1]))
            entered.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self.held.pop()

    def _is_release_in_finally(self, acq: ast.Call) -> bool:
        """``acquire()`` at statement position: accepted iff some
        enclosing/adjacent ``try`` has the matching ``release()`` in its
        ``finally``."""
        chain = _attr_chain(acq.func)
        target = ".".join(chain[:-1])
        for t in ast.walk(self.fn):
            if not (isinstance(t, ast.Try) and t.finalbody):
                continue
            for stmt in ast.walk(ast.Module(body=t.finalbody,
                                            type_ignores=[])):
                if isinstance(stmt, ast.Call):
                    c = _attr_chain(stmt.func)
                    if c and c[-1] == "release" \
                            and ".".join(c[:-1]) == target:
                        return True
        return False

    # -- call classification ------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain:
            attr = chain[-1]
            root = ".".join(chain[:-1])
            is_self_lock = (len(chain) == 3 and chain[0] == "self"
                            and chain[1] in self.info.locks)
            if attr == "acquire" and is_self_lock:
                if not self._is_release_in_finally(node):
                    self._emit(
                        "LK702", node,
                        f"`{root}.acquire()` outside `with`/"
                        f"try-finally — an exception before release() "
                        f"leaks the lock; use `with {root}:`")
            elif self.held:
                self._check_blocking(node, chain, attr, root)
            # one-level interprocedural edge propagation
            if (len(chain) == 2 and chain[0] == "self" and self.held):
                for outer, _ in self.held:
                    self.calls_held.append(
                        (outer, chain[1], node.lineno))
        elif isinstance(node.func, ast.Name) and self.held:
            if node.func.id in ("wait", "sleep"):
                self._emit(
                    "LK703", node,
                    f"blocking `{node.func.id}(…)` while holding "
                    f"`{self._held_str()}`")
        self.generic_visit(node)

    def _held_str(self) -> str:
        return ", ".join(sorted({h for h, _ in self.held}))

    def _check_blocking(self, node: ast.Call, chain: List[str],
                        attr: str, root: str) -> None:
        blocking = False
        if attr in _BLOCKING_ATTRS:
            blocking = True
        elif attr == "sleep" and chain[0] == "time":
            blocking = True
        elif attr == "wait":
            # cv.wait() on the condvar the enclosing `with` holds is
            # the condvar protocol (wait releases the lock) — exempt
            obj = chain[1] if len(chain) == 3 and chain[0] == "self" \
                else None
            if obj is None or all(held_obj != obj
                                  for _, held_obj in self.held):
                blocking = True
        elif attr == "join":
            # `.join()` with no args / a timeout kw / one numeric arg is
            # a thread join, not str.join
            if (not node.args and not node.keywords) or any(
                    kw.arg == "timeout" for kw in node.keywords) or (
                    len(node.args) == 1
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, (int, float))):
                blocking = True
        elif attr == "get":
            # queue waits only — a `.get` on a declared queue attribute
            blocking = (len(chain) == 3 and chain[0] == "self"
                        and chain[1] in self.info.queues)
        if blocking:
            self._emit(
                "LK703", node,
                f"blocking `{'.'.join(chain)}(…)` while holding "
                f"`{self._held_str()}` — whatever unblocks it may "
                f"need that lock")


def _holds_locks(fn: ast.AST) -> List[str]:
    """Lock names from ``@holds("…")`` decorators."""
    out: List[str] = []
    for dec in getattr(fn, "decorator_list", []):
        if not isinstance(dec, ast.Call):
            continue
        chain = _attr_chain(dec.func) or []
        if chain and chain[-1] == "holds":
            out.extend(a.value for a in dec.args
                       if isinstance(a, ast.Constant)
                       and isinstance(a.value, str))
    return out


def _find_cycles(edges: Dict[Tuple[str, str], int]
                 ) -> List[Tuple[str, str, int]]:
    """Edges participating in a cycle of the lock graph."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    def reaches(src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(graph.get(n, ()))
        return False

    bad = []
    for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
        if a == b or reaches(b, a):
            bad.append((a, b, line))
    return bad


def _scan_class(mod: Module, cnode: ast.ClassDef,
                findings: List[Finding]) -> None:
    info = _ClassLocks(cnode)
    if not info.locks:
        return
    # method -> (edges, calls-while-held); acquired-set per method for
    # the one-level fixpoint
    acquires: Dict[str, Set[Tuple[str, int]]] = {}
    edges: Dict[Tuple[str, str], int] = {}
    calls_held: List[Tuple[str, str, int]] = []
    for node in cnode.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scan = _MethodScan(mod, cnode.name, node, info,
                           _holds_locks(node), findings)
        scan.run()
        for a, b, line in scan.edges:
            edges.setdefault((a, b), line)
        calls_held.extend(scan.calls_held)
        # every lock this method acquires itself (all with-entries,
        # including depth-0 ones that produce no edge)
        acquires[node.name] = set()
        for n2 in ast.walk(node):
            if isinstance(n2, ast.With):
                for item in n2.items:
                    lk = _with_lock_attr(item, info.locks)
                    if lk is not None:
                        acquires[node.name].add(
                            (lk, item.context_expr.lineno))
    # one-level interprocedural: method called while holding L acquires K
    for outer, callee, line in calls_held:
        for lk, _ in acquires.get(callee, ()):
            if outer == lk and lk in info.rlocks:
                continue
            edges.setdefault((outer, lk), line)
    for a, b, line in _find_cycles(edges):
        findings.append(Finding(
            pass_id=PASS_ID, code="LK701", path=mod.rel, line=line,
            message=(f"in `{cnode.name}`: lock acquisition edge "
                     f"`{a}` → `{b}` closes a cycle in the lock-order "
                     f"graph (deadlock under opposing schedules)")))


def run(project: Optional[Project] = None,
        modules: Optional[Sequence[Module]] = None) -> List[Finding]:
    """Run the pass (project scope: serving/ + distributed/)."""
    if modules is not None:
        mods = list(modules)
    else:
        mods = [m for m in (project or Project()).modules
                if m.rel.startswith(SCOPE_PREFIXES)]
    findings: List[Finding] = []
    for mod in mods:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                _scan_class(mod, node, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
