"""Rule ``lock-discipline``: thread-target writes happen under a lock.

Counterpart of ``tpu_radix_join/analysis/rules_locks.py`` (with its
``lock-order`` rule) over the port's thread classes.  Daemon threads
share state with the main thread — the hang watchdog, the
MetricsSampler, the AsyncCheckpointWriter, the grid prefetcher
(``ops/chunked._Prefetcher``), the command line's lease beat
(``main._LeaseBeat``), the fleet supervisor's worker readers, and the
lease heartbeat (which rides the sampler's tick via
``LeaseBoard.sampler_extra``).  Threads whose target is not a method of
the class that starts them (the ``/statusz`` server's ``serve_forever``,
the host stream's fill closure, the command line's stdin readers) share
state through queues and events, which the rule does not model.  Their informal rule has been "writes
from the thread side hold the instance lock"; this rule makes it
checkable:

  * a **thread-target method** is any method a class passes to
    ``threading.Thread(target=self.<m>)``, plus the closure of
    ``self.<m>()`` calls reachable from it inside the same class, plus
    the :data:`EXTRA_THREAD_METHODS` entries (methods that run on
    *another* class's thread — the lease heartbeat runs on the
    metrics-sampler tick);
  * inside that closure, every ``self.<attr> = ...`` (plain, augmented,
    annotated, or tuple-unpacked) must sit lexically inside a ``with``
    whose context expression names a lock (``lock``/``cond``/``mutex``
    in its spelling — ``with self._lock:``, ``with self._cond:``), or
    carry ``# lint: unguarded-ok(<reason>)``.

The rule is deliberately lexical: it cannot prove a caller holds the
lock for you (use an RLock and re-enter, the metrics.py idiom), and it
does not chase writes through container mutation — rebinding instance
attributes is the race the repo's threads actually share state through.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tpu_radix_join_torch.analysis.core import (Finding, Repo, dotted_name,
                                          is_self_attr, rule)

#: (class, method) pairs that execute on another class's thread: the
#: lease heartbeat is invoked from the MetricsSampler daemon tick (via
#: LeaseBoard.sampler_extra) *and* from the main thread's join loop
EXTRA_THREAD_METHODS = {("LeaseBoard", "heartbeat")}

LOCK_HINTS = ("lock", "cond", "mutex")


def _is_thread_ctor(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    return name is not None and name.split(".")[-1] == "Thread"


def _thread_targets(cls: ast.ClassDef) -> Set[str]:
    """Method names the class hands to threading.Thread(target=...)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _is_thread_ctor(node):
            for kw in node.keywords:
                if kw.arg == "target":
                    attr = is_self_attr(kw.value)
                    if attr is not None:
                        out.add(attr)
    return out


def _closure(cls: ast.ClassDef, roots: Set[str]) -> Set[str]:
    """Transitive closure of self.<m>() calls from the root methods."""
    methods: Dict[str, ast.FunctionDef] = {
        n.name: n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: Set[str] = set()
    frontier = [m for m in roots if m in methods]
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        for node in ast.walk(methods[m]):
            if isinstance(node, ast.Call):
                callee = is_self_attr(node.func)
                if callee in methods and callee not in seen:
                    frontier.append(callee)
    return seen


def _locked_with(node: ast.With) -> bool:
    for item in node.items:
        spelled = ast.unparse(item.context_expr).lower()
        if any(h in spelled for h in LOCK_HINTS):
            return True
    return False


class _WriteScan(ast.NodeVisitor):
    """Collect self-attribute writes not lexically under a lock With."""

    def __init__(self):
        self.depth = 0
        self.writes: List[tuple] = []        # (line, attr)

    def visit_With(self, node: ast.With):
        locked = _locked_with(node)
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    def _check_target(self, tgt: ast.AST, line: int):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._check_target(e, line)
            return
        attr = is_self_attr(tgt)
        if attr is not None and self.depth == 0:
            self.writes.append((line, attr))

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            self._check_target(tgt, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check_target(node.target, node.lineno)
        self.generic_visit(node)


@rule("lock-discipline",
      "attribute writes in background-thread methods must hold a lock "
      "or carry # lint: unguarded-ok(reason)",
      token="unguarded")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for src in repo.files:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            roots = _thread_targets(cls)
            roots |= {m for c, m in EXTRA_THREAD_METHODS if c == cls.name}
            if not roots:
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            for mname in sorted(_closure(cls, roots)):
                scan = _WriteScan()
                scan.visit(methods[mname])
                for line, attr in scan.writes:
                    out.append(Finding(
                        rule="lock-discipline", path=src.rel, line=line,
                        key=f"{cls.name}.{mname}:self.{attr}",
                        message=(f"self.{attr} written in thread-target "
                                 f"method {cls.name}.{mname} without a "
                                 f"held lock — guard it (with "
                                 f"self._lock:) or annotate "
                                 f"unguarded-ok with why it is safe")))
    return out


# ===================================================== rule ``lock-order``
# lock-discipline proves each shared write holds *a* lock; lock-order
# proves the locks themselves cannot deadlock.  The known instance locks
# (MetricsSampler, LeaseBoard, AsyncCheckpointWriter, AdmissionQueue,
# CircuitBreaker — every class a daemon thread or the service path
# shares) form a graph whose edges are "acquired while holding": a
# nested ``with`` inside a lock region, a same-class method call whose
# closure acquires, or a call on a known-class instance attribute
# (``self._board = LeaseBoard(...)`` binds the attribute's class, so
# ``self._board.heartbeat()`` under ``self._lock`` contributes the
# heartbeat's acquisitions).  Any cycle in that graph is a deadlock two
# threads can realize by interleaving — the rule fails on the cycle, not
# on the eventual hang.

#: the instance-lock owners the order graph tracks (plus any class the
#: repo nests acquisitions in — edges are collected everywhere; these
#: names only resolve cross-class calls through instance attributes)
KNOWN_LOCK_CLASSES = ("MetricsSampler", "LeaseBoard",
                      "AsyncCheckpointWriter", "AdmissionQueue",
                      "CircuitBreaker")


def _lock_node(cls_name: str, expr: ast.AST) -> Optional[str]:
    """Canonical graph node for a ``with`` context expression that
    spells a lock, or None.  ``self._lock`` in class C -> ``C._lock``;
    other spellings keep their dotted text (same text == same lock)."""
    spelled = ast.unparse(expr)
    if not any(h in spelled.lower() for h in LOCK_HINTS):
        return None
    attr = is_self_attr(expr)
    if attr is not None:
        return f"{cls_name}.{attr}"
    return spelled


def _class_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _known_attr_types(cls: ast.ClassDef) -> Dict[str, str]:
    """self.<attr> = KnownClass(...) bindings anywhere in the class."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            ctor = dotted_name(node.value.func)
            if ctor is None:
                continue
            ctor = ctor.split(".")[-1]
            if ctor not in KNOWN_LOCK_CLASSES:
                continue
            for tgt in node.targets:
                attr = is_self_attr(tgt)
                if attr is not None:
                    out[attr] = ctor
    return out


def _acquires(cls_name: str, methods: Dict[str, ast.FunctionDef],
              mname: str, _seen: Optional[Set[str]] = None) -> Set[str]:
    """Locks a method's same-class closure acquires (transitive)."""
    seen = _seen if _seen is not None else set()
    if mname in seen or mname not in methods:
        return set()
    seen.add(mname)
    locks: Set[str] = set()
    for node in ast.walk(methods[mname]):
        if isinstance(node, ast.With):
            for item in node.items:
                ln = _lock_node(cls_name, item.context_expr)
                if ln is not None:
                    locks.add(ln)
        elif isinstance(node, ast.Call):
            callee = is_self_attr(node.func)
            if callee is not None:
                locks |= _acquires(cls_name, methods, callee, seen)
    return locks


class _EdgeScan(ast.NodeVisitor):
    """Collect (held_lock, acquired_lock, line) edges in one method."""

    def __init__(self, cls_name: str, methods: Dict[str, ast.FunctionDef],
                 attr_types: Dict[str, str],
                 foreign: Dict[str, Dict[str, Set[str]]]):
        self.cls = cls_name
        self.methods = methods
        self.attr_types = attr_types
        self.foreign = foreign        # class -> method -> acquired locks
        self.held: List[str] = []
        self.edges: List[Tuple[str, str, int]] = []

    def _add(self, dst: str, line: int):
        for src in self.held:
            if src != dst:
                self.edges.append((src, dst, line))

    def visit_With(self, node: ast.With):
        acquired = []
        for item in node.items:
            ln = _lock_node(self.cls, item.context_expr)
            if ln is not None:
                self._add(ln, node.lineno)
                acquired.append(ln)
        self.held.extend(acquired)
        self.generic_visit(node)
        del self.held[len(self.held) - len(acquired):len(self.held)]

    def visit_Call(self, node: ast.Call):
        if self.held:
            callee = is_self_attr(node.func)
            if callee is not None:
                # same-class call: its closure's acquisitions nest here
                for dst in _acquires(self.cls, self.methods, callee):
                    self._add(dst, node.lineno)
            elif (isinstance(node.func, ast.Attribute)
                  and isinstance(node.func.value, ast.Attribute)):
                # self.<attr>.<m>() on a known-class instance
                owner = is_self_attr(node.func.value)
                kcls = self.attr_types.get(owner) if owner else None
                if kcls is not None:
                    for dst in self.foreign.get(kcls, {}).get(
                            node.func.attr, set()):
                        self._add(dst, node.lineno)
        self.generic_visit(node)


@rule("lock-order",
      "the acquired-while-holding graph over the known instance locks "
      "must be acyclic (no deadlock order)",
      token="lockorder")
def check_order(repo: Repo) -> List[Finding]:
    # pass 1: per-known-class method acquisition sets (for cross-class
    # call resolution) + per-class attr -> known-class bindings
    foreign: Dict[str, Dict[str, Set[str]]] = {}
    classes: List[Tuple] = []        # (src, cls, methods, attr_types)
    for src in repo.files:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = _class_methods(cls)
            classes.append((src, cls, methods, _known_attr_types(cls)))
            if cls.name in KNOWN_LOCK_CLASSES:
                foreign[cls.name] = {
                    m: _acquires(cls.name, methods, m) for m in methods}
    # pass 2: the edge list
    edges: List[Tuple[str, str, str, int]] = []    # (src, dst, path, line)
    for src, cls, methods, attr_types in classes:
        for m in methods.values():
            scan = _EdgeScan(cls.name, methods, attr_types, foreign)
            scan.visit(m)
            edges.extend((a, b, src.rel, line) for a, b, line in scan.edges)
    # cycle detection (iterative DFS, three-color)
    adj: Dict[str, List[Tuple[str, str, int]]] = {}
    for a, b, path, line in edges:
        adj.setdefault(a, []).append((b, path, line))
    out: List[Finding] = []
    seen_cycles: Set[str] = set()
    color: Dict[str, int] = {}
    for start in sorted(adj):
        if color.get(start):
            continue
        stack: List[Tuple[str, int]] = [(start, 0)]
        path_nodes: List[str] = []
        while stack:
            node, i = stack.pop()
            if i == 0:
                color[node] = 1
                path_nodes.append(node)
            nexts = adj.get(node, [])
            if i < len(nexts):
                stack.append((node, i + 1))
                dst, fpath, fline = nexts[i]
                if color.get(dst) == 1:
                    cyc = path_nodes[path_nodes.index(dst):] + [dst]
                    canon = "->".join(_canonical_rotation(cyc[:-1]))
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(Finding(
                            rule="lock-order", path=fpath, line=fline,
                            key=f"cycle:{canon}",
                            message=(f"lock-order cycle "
                                     f"{' -> '.join(cyc)}: two threads "
                                     f"interleaving these acquisitions "
                                     f"deadlock — acquire in one global "
                                     f"order or drop the outer lock "
                                     f"before the nested acquire")))
                elif not color.get(dst):
                    stack.append((dst, 0))
            else:
                color[node] = 2
                path_nodes.pop()
    return out


def _canonical_rotation(cycle: List[str]) -> List[str]:
    """Rotation starting at the lexicographically smallest node, so the
    same cycle found from different entry points dedups/baselines to
    one key."""
    if not cycle:
        return cycle
    i = cycle.index(min(cycle))
    return cycle[i:] + cycle[:i]
