"""Whole-package static concurrency analysis (rules VC001–VC005) over
the port (port of ``veles_tpu/analysis/concurrency.py``; pure AST, the
rules unchanged).

The platform is a deeply threaded system — ManagedThreads dispatch
loops in both batchers, the router/fleet tier, the coordinator/relay
farm, the scheduler's parked waiters, async checkpointing, the kernel
builds — and the dominant defect class is thread races. This pass
proves two global properties over the package the way the VL lint
proves capture hygiene: **lock-order acyclicity** (no potential ABBA
deadlock anywhere, interprocedurally) and **guarded-state discipline**
(annotated shared state is only touched under its lock / on its owning
thread).

Rules:

=======  ============================================================
VC001    potential deadlock: a cycle in the global lock-acquisition-
         order graph (built from ``with self._lock:`` nesting,
         following same-package calls made while a lock is held).
         Reentrant same-lock acquisition (RLock/Condition) is legal;
         a plain ``threading.Lock`` re-acquired under itself is
         reported (guaranteed self-deadlock).
VC002    guarded-field violation: an attribute annotated
         ``# guarded-by: _lock`` accessed without the lock held
         (lexically, via a ``# holds: _lock``-marked helper, or in a
         constructor) — or a ``# holds:``-marked helper called from a
         context that does not hold the lock.
VC003    thread-ownership violation: an attribute annotated
         ``# owned-by: <role>`` accessed from a method not marked
         ``# runs-on: <role>`` (the batchers' "all slot state owned
         by the dispatch thread" invariant, machine-checked).
VC004    blocking call while holding a lock: ``time.sleep``,
         ``queue.get``, thread/process ``join``, ``subprocess``,
         synchronous HTTP, socket I/O (one shared table with VL004 —
         see ``analysis/lint.py``), interprocedurally through
         same-package calls.
VC005    ``Condition.wait()`` outside a ``while`` re-check loop — a
         woken waiter must re-test its predicate (spurious wakeups,
         stolen wakeups).
=======  ============================================================

Annotation syntax (trailing comments, machine-checked):

- ``self._pending = deque()  # guarded-by: _cond`` — every access of
  ``self._pending`` in this class must hold ``self._cond``.
- ``self._by_slot = {}  # owned-by: dispatch`` — every access must be
  in a method marked ``# runs-on: dispatch`` (constructors exempt).
- ``def _close_batch(self):  # holds: _cond`` — declares "callers
  hold the lock"; the method body counts as under the lock, and every
  same-package call site of the method is checked to actually hold it.
- ``def _dispatch_loop(self):  # runs-on: dispatch`` — this method
  (and its nested functions) executes on the named thread role.

Suppression: inline ``# noqa: VC002`` exactly like the VL rules.

Analysis bounds (deliberate): call resolution follows ``self.m()``,
``self.attr.m()`` / chains where the attribute's class is inferable
(constructor assignment or parameter annotation), local variables
assigned from package-class constructors, and same-module functions —
to a fixed depth. Unresolvable calls are not followed (the analysis
under-approximates the call graph, so VC001/VC004 report no false
edges from guessing). The runtime companion
(:mod:`veles_tpu_torch.analysis.lockcheck`) closes the gap from the other
side: it records the REAL acquisition-order edges of every tier-1 run
and asserts the same acyclicity at teardown.

CLI (baseline mechanics identical to the VL lint's)::

    python -m veles_tpu_torch.analysis.concurrency                # gate
    python -m veles_tpu_torch.analysis.concurrency --no-baseline  # strict
    python -m veles_tpu_torch.analysis.concurrency --update-baseline
    python -m veles_tpu_torch.analysis.concurrency file.py ...    # strict
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from veles_tpu_torch.analysis.lint import (BLOCKING_CALL_DOTTED,
                                           BLOCKING_RECEIVER_ATTRS,
                                           BLOCKING_SOCKET_ATTRS,
                                           Finding, _NOQA_RE, _dotted,
                                           baselines_dir,
                                           iter_package_files,
                                           repo_root)

RULES: Dict[str, str] = {
    "VC001": "potential deadlock: lock-acquisition-order cycle",
    "VC002": "guarded field accessed without its declared lock",
    "VC003": "thread-owned field accessed off its owning thread",
    "VC004": "blocking call while holding a lock",
    "VC005": "Condition.wait outside a predicate re-check loop",
}

_GUARDED_RE = re.compile(r"#.*?guarded-by:\s*(?P<lock>[A-Za-z_]\w*)")
_OWNED_RE = re.compile(r"#.*?owned-by:\s*(?P<role>[\w-]+)")
_HOLDS_RE = re.compile(r"#.*?\bholds:\s*(?P<locks>[A-Za-z_]\w*"
                       r"(?:\s*,\s*[A-Za-z_]\w*)*)")
_RUNS_ON_RE = re.compile(r"#.*?runs-on:\s*(?P<role>[\w-]+)")

#: interprocedural closure depth bound (call chains longer than this
#: are not followed; deep enough for every real chain in the package)
MAX_DEPTH = 8

#: constructor-ish methods whose lock-free initialization of guarded /
#: owned state is legal (no other thread can see the object yet;
#: init_unpickled runs on restore before any service thread spawns)
_CTOR_METHODS = {"__init__", "init_unpickled"}

_LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
}


class LockNode:
    """One lock in the global order graph: ``Class.attr`` (instance or
    class attribute) or ``module.NAME`` (module-level lock)."""

    __slots__ = ("name", "kind", "path", "line")

    def __init__(self, name: str, kind: str, path: str,
                 line: int) -> None:
        self.name = name      # graph identity, e.g. "MicroBatcher._cond"
        self.kind = kind      # lock | rlock | condition
        self.path = path
        self.line = line

    @property
    def reentrant(self) -> bool:
        return self.kind in ("rlock", "condition")

    def __repr__(self) -> str:
        return "<LockNode %s (%s)>" % (self.name, self.kind)


class _Method:
    """One analyzed function/method and its concurrency summary."""

    __slots__ = ("cls", "name", "node", "path", "holds", "runs_on",
                 "acquires", "calls", "accesses", "blocking", "waits")

    def __init__(self, cls: Optional["_Class"], name: str,
                 node: ast.AST, path: str) -> None:
        self.cls = cls
        self.name = name
        self.node = node
        self.path = path
        self.holds: Set[str] = set()       # lock attr names (declared)
        self.runs_on: Optional[str] = None
        #: [(held lock names tuple, acquired LockNode, line)]
        self.acquires: List[Tuple[Tuple[str, ...], LockNode, int]] = []
        #: [(held lock names tuple, call ast.Call, line,
        #:   receiver _Class candidates resolved at scan time)]
        self.calls: List[Tuple[Tuple[str, ...], ast.Call, int,
                               Tuple[Any, ...]]] = []
        #: [(held lock names tuple, attr name, ast node)] self-accesses
        self.accesses: List[Tuple[Tuple[str, ...], str, ast.AST]] = []
        #: [(held lock names tuple, description, line)] direct blockers
        self.blocking: List[Tuple[Tuple[str, ...], str, int]] = []
        #: [(attr name, in_while_loop, line)] condition waits
        self.waits: List[Tuple[str, bool, int]] = []

    @property
    def qualname(self) -> str:
        return "%s.%s" % (self.cls.name, self.name) if self.cls \
            else self.name


class _Class:
    """Per-class concurrency facts."""

    def __init__(self, name: str, module: str, path: str) -> None:
        self.name = name
        self.module = module
        self.path = path
        self.bases: List[str] = []
        self.methods: Dict[str, _Method] = {}
        #: lock attr -> LockNode (instance and class-level locks)
        self.locks: Dict[str, LockNode] = {}
        #: guarded attr -> (guard lock attr, annotation line)
        self.guarded: Dict[str, Tuple[str, int]] = {}
        #: owned attr -> (role, annotation line)
        self.owned: Dict[str, Tuple[str, int]] = {}
        #: attr -> set of inferred class names
        self.attr_types: Dict[str, Set[str]] = {}
        #: condition attr -> the lock attr it wraps
        #: (``self._cond = threading.Condition(self._lock)``)
        self.cond_alias: Dict[str, str] = {}


class _PackageIndex:
    """Everything the checks need, package-wide."""

    def __init__(self) -> None:
        #: (module, class name) -> _Class
        self.classes: Dict[Tuple[str, str], _Class] = {}
        #: bare class name -> [_Class] (for cross-module resolution)
        self.by_name: Dict[str, List[_Class]] = {}
        #: (module, function name) -> _Method for module-level defs
        self.functions: Dict[Tuple[str, str], _Method] = {}
        #: module-level lock name -> LockNode
        self.module_locks: Dict[Tuple[str, str], LockNode] = {}
        self.sources: Dict[str, List[str]] = {}

    def resolve_class(self, name: str,
                      module: Optional[str] = None) -> List[_Class]:
        """Same module first, else unique package-wide, else all
        candidates (the caller treats multiple as a union)."""
        if module is not None:
            own = self.classes.get((module, name))
            if own is not None:
                return [own]
        return self.by_name.get(name, [])

    def lookup_method(self, cls: _Class, name: str,
                      _seen: Optional[Set[int]] = None
                      ) -> Optional[_Method]:
        """MRO-ish lookup: own methods, then base classes (DFS)."""
        if _seen is None:
            _seen = set()
        if id(cls) in _seen:
            return None
        _seen.add(id(cls))
        if name in cls.methods:
            return cls.methods[name]
        for base in cls.bases:
            for base_cls in self.resolve_class(base, cls.module):
                found = self.lookup_method(base_cls, name, _seen)
                if found is not None:
                    return found
        return None

    def lookup_lock(self, cls: _Class, attr: str,
                    _seen: Optional[Set[int]] = None
                    ) -> Optional[LockNode]:
        if _seen is None:
            _seen = set()
        if id(cls) in _seen:
            return None
        _seen.add(id(cls))
        if attr in cls.locks:
            return cls.locks[attr]
        for base in cls.bases:
            for base_cls in self.resolve_class(base, cls.module):
                found = self.lookup_lock(base_cls, attr, _seen)
                if found is not None:
                    return found
        return None

    def lookup_attr_types(self, cls: _Class, attr: str) -> Set[str]:
        out: Set[str] = set()
        stack, seen = [cls], set()
        while stack:
            cur = stack.pop()
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            out |= cur.attr_types.get(attr, set())
            for base in cur.bases:
                stack.extend(self.resolve_class(base, cur.module))
        return out


def _module_name(path: str) -> str:
    """Module identity for the cross-reference keys: the normalized
    path sans extension. Basenames would collide (three server.py,
    two client.py, sixteen __init__.py in this package), and a
    collision would let call/lock resolution bind across unrelated
    files — false edges, or a masked real one. Every consumer derives
    the id from the same path string, so path-keyed is consistent."""
    root, _ = os.path.splitext(os.path.normpath(path))
    return root.replace(os.sep, "/")


def _ann_class_names(node: Optional[ast.AST]) -> Set[str]:
    """Class names inside an annotation: ``Scheduler``,
    ``Optional["Scheduler"]``, ``"queue.Queue"`` ..."""
    out: Set[str] = set()
    if node is None:
        return out
    for child in ast.walk(node):
        if isinstance(child, ast.Name):
            out.add(child.id)
        elif isinstance(child, ast.Constant) and \
                isinstance(child.value, str):
            # string annotation: take the last dotted component
            text = child.value.strip().strip("'\"")
            match = re.match(r"^(?:Optional\[)?([\w.]+)\]?$", text)
            if match:
                out.add(match.group(1).rpartition(".")[2])
    out.discard("Optional")
    out.discard("None")
    return out


def _call_class_names(value: ast.AST) -> Set[str]:
    """Every ``ClassName(...)`` constructor call inside ``value`` —
    covers ``X() if cond else Y()`` and ``a or X()`` shapes."""
    out: Set[str] = set()
    for child in ast.walk(value):
        if isinstance(child, ast.Call):
            name = _dotted(child.func)
            if name and name[:1].isupper():
                out.add(name.rpartition(".")[2])
    return out


# ---------------------------------------------------------------------------
# pass 1: collect classes, locks, annotations, attribute types
# ---------------------------------------------------------------------------

class _Collector(ast.NodeVisitor):
    def __init__(self, index: _PackageIndex, path: str,
                 source: str) -> None:
        self.index = index
        self.path = path
        self.module = _module_name(path)
        self.lines = source.splitlines()
        index.sources[path] = self.lines

    def _line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def _lock_kind(self, value: ast.AST) -> Optional[Tuple[str, ast.AST]]:
        if not isinstance(value, ast.Call):
            return None
        name = _dotted(value.func)
        if name is None:
            return None
        for factory, kind in _LOCK_FACTORIES.items():
            if name == factory or name == factory.rpartition(".")[2]:
                return kind, value
        return None

    def run(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._collect_module_lock(node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                method = _Method(None, node.name, node, self.path)
                self._def_markers(method, node)
                self.index.functions[(self.module, node.name)] = method

    def _collect_module_lock(self, node) -> None:
        if node.value is None:
            return
        kind = self._lock_kind(node.value)
        if kind is None:
            return
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for target in targets:
            if isinstance(target, ast.Name):
                lock = LockNode("%s.%s" % (self.module, target.id),
                                kind[0], self.path, node.lineno)
                self.index.module_locks[(self.module, target.id)] = lock

    @staticmethod
    def _record_cond_alias(cls: "_Class", kind, names) -> None:
        """``self._cond = threading.Condition(self._lock)``: the
        condition acquires THE wrapped lock, so holding ``_cond``
        satisfies a ``# guarded-by: _lock`` guard."""
        _kind_name, call = kind
        if _kind_name != "condition" or not call.args:
            return
        arg = call.args[0]
        if isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and \
                arg.value.id == "self":
            for name in names:
                cls.cond_alias[name] = arg.attr

    def _def_markers(self, method: _Method, node) -> None:
        line = self._line(node.lineno)
        holds = _HOLDS_RE.search(line)
        if holds:
            method.holds = {name.strip() for name in
                            holds.group("locks").split(",")}
        runs = _RUNS_ON_RE.search(line)
        if runs:
            method.runs_on = runs.group("role")

    def _collect_class(self, node: ast.ClassDef) -> None:
        cls = _Class(node.name, self.module, self.path)
        for base in node.bases:
            name = _dotted(base)
            if name:
                cls.bases.append(name.rpartition(".")[2])
        key = (self.module, node.name)
        self.index.classes[key] = cls
        self.index.by_name.setdefault(node.name, []).append(cls)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                method = _Method(cls, item.name, item, self.path)
                self._def_markers(method, item)
                cls.methods[item.name] = method
                self._collect_method_attrs(cls, item)
            elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                # class-level lock (shared across instances); the
                # AnnAssign shape (`_lock: threading.Lock = ...`)
                # counts exactly like a bare assignment
                if isinstance(item, ast.Assign):
                    value = item.value
                    names = [t.id for t in item.targets
                             if isinstance(t, ast.Name)]
                else:
                    value = item.value
                    names = [item.target.id] if isinstance(
                        item.target, ast.Name) else []
                kind = self._lock_kind(value) \
                    if value is not None else None
                if kind is not None:
                    for name in names:
                        cls.locks[name] = LockNode(
                            "%s.%s" % (cls.name, name),
                            kind[0], self.path, item.lineno)
                    self._record_cond_alias(cls, kind, names)
                self._annotations(cls, item, names)

    def _collect_method_attrs(self, cls: _Class, fn) -> None:
        """Scan ONE method for ``self.X = ...`` facts: lock creation,
        guarded-by/owned-by annotations, attribute type inference."""
        param_types: Dict[str, Set[str]] = {}
        args = fn.args
        for arg in (list(args.posonlyargs) + list(args.args) +
                    list(args.kwonlyargs)):
            names = _ann_class_names(arg.annotation)
            if names:
                param_types[arg.arg] = names
        for stmt in ast.walk(fn):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and \
                    stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            attr_names = [
                t.attr for t in targets
                if isinstance(t, ast.Attribute) and
                isinstance(t.value, ast.Name) and t.value.id == "self"]
            if not attr_names:
                continue
            kind = self._lock_kind(value)
            if kind is not None:
                for attr in attr_names:
                    cls.locks[attr] = LockNode(
                        "%s.%s" % (cls.name, attr), kind[0],
                        self.path, stmt.lineno)
                self._record_cond_alias(cls, kind, attr_names)
            # attribute types: constructor calls, annotated params,
            # string annotations on AnnAssign
            types = _call_class_names(value)
            if isinstance(value, ast.Name) and value.id in param_types:
                types |= param_types[value.id]
            if isinstance(stmt, ast.AnnAssign):
                types |= _ann_class_names(stmt.annotation)
            # `metrics if metrics is not None else ServeMetrics()`:
            # the param branch contributes its annotation too
            for child in ast.walk(value):
                if isinstance(child, ast.Name) and \
                        child.id in param_types:
                    types |= param_types[child.id]
            if types:
                for attr in attr_names:
                    cls.attr_types.setdefault(attr, set()).update(types)
            self._annotations(cls, stmt, attr_names)

    def _annotations(self, cls: _Class, stmt: ast.AST,
                     attr_names: List[str]) -> None:
        end = getattr(stmt, "end_lineno", stmt.lineno)
        for lineno in range(stmt.lineno, end + 1):
            text = self._line(lineno)
            guarded = _GUARDED_RE.search(text)
            if guarded:
                for attr in attr_names:
                    cls.guarded[attr] = (guarded.group("lock"),
                                         stmt.lineno)
            owned = _OWNED_RE.search(text)
            if owned:
                for attr in attr_names:
                    cls.owned[attr] = (owned.group("role"),
                                       stmt.lineno)


# ---------------------------------------------------------------------------
# pass 2: per-method scan with a lexical held-lock stack
# ---------------------------------------------------------------------------

class _MethodScanner:
    """Walks one function body tracking which discovered locks are
    lexically held, recording acquisitions, calls, self-attribute
    accesses, blocking calls and condition waits."""

    def __init__(self, index: _PackageIndex, method: _Method) -> None:
        self.index = index
        self.method = method
        self.cls = method.cls
        self.module = _module_name(method.path)

    def scan(self) -> None:
        fn = self.method.node
        base_held: Tuple[str, ...] = tuple(sorted(self.method.holds))
        local_types: Dict[str, Set[str]] = {}
        args = fn.args
        for arg in (list(args.posonlyargs) + list(args.args) +
                    list(args.kwonlyargs)):
            names = _ann_class_names(arg.annotation)
            if names:
                local_types[arg.arg] = names
        for stmt in fn.body:
            self._walk(stmt, base_held, in_while=False,
                       local_types=local_types)

    # -- lock resolution ---------------------------------------------------
    def _with_item_lock(self, expr: ast.AST) -> Optional[
            Tuple[str, LockNode]]:
        """``(attr-or-name, LockNode)`` for a with-item that acquires a
        discovered lock; None otherwise."""
        # getattr(self, "_units_lock_", ...) -> self._units_lock_
        if isinstance(expr, ast.Call) and \
                _dotted(expr.func) == "getattr" and \
                len(expr.args) >= 2 and \
                isinstance(expr.args[0], ast.Name) and \
                expr.args[0].id == "self" and \
                isinstance(expr.args[1], ast.Constant) and \
                isinstance(expr.args[1].value, str):
            attr = expr.args[1].value
            if self.cls is not None:
                node = self.index.lookup_lock(self.cls, attr)
                if node is not None:
                    return attr, node
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if base == "self" and self.cls is not None:
                node = self.index.lookup_lock(self.cls, attr)
                if node is not None:
                    return attr, node
            else:  # ClassName._lock (class-level lock)
                for cand in self.index.resolve_class(base, self.module):
                    node = self.index.lookup_lock(cand, attr)
                    if node is not None:
                        return attr, node
        if isinstance(expr, ast.Name):
            lock = self.index.module_locks.get((self.module, expr.id))
            if lock is not None:
                return expr.id, lock
        return None

    # -- receiver typing ---------------------------------------------------
    def _receiver_classes(self, expr: ast.AST,
                          local_types: Dict[str, Set[str]]
                          ) -> List[_Class]:
        """Candidate classes for a call receiver expression."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls is not None:
                return [self.cls]
            names = local_types.get(expr.id, set())
            out: List[_Class] = []
            for name in names:
                out.extend(self.index.resolve_class(name, self.module))
            return out
        if isinstance(expr, ast.Attribute):
            bases = self._receiver_classes(expr.value, local_types)
            out = []
            for base in bases:
                for name in self.index.lookup_attr_types(base,
                                                         expr.attr):
                    out.extend(self.index.resolve_class(name,
                                                        base.module))
            return out
        return []

    # -- blocking-call classification --------------------------------------
    def _blocking_reason(self, call: ast.Call) -> Optional[str]:
        name = _dotted(call.func)
        if name is not None and name in BLOCKING_CALL_DOTTED:
            return "%s()" % name
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            receiver = _dotted(call.func.value)
            if attr in BLOCKING_SOCKET_ATTRS and receiver is not None:
                return ".%s() (socket/stream I/O)" % attr
            needles = BLOCKING_RECEIVER_ATTRS.get(attr)
            if needles and receiver is not None:
                low = receiver.lower()
                if any(n in low for n in needles):
                    return "%s.%s()" % (receiver, attr)
        return None

    # -- the walk ----------------------------------------------------------
    def _walk(self, node: ast.AST, held: Tuple[str, ...],
              in_while: bool,
              local_types: Optional[Dict[str, Set[str]]] = None
              ) -> None:
        if local_types is None:
            local_types = {}
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                resolved = self._with_item_lock(item.context_expr)
                # the context expression itself evaluates under the
                # locks held so far
                self._walk_expr(item.context_expr, held, local_types,
                                in_while)
                if resolved is not None:
                    attr, lock = resolved
                    self.method.acquires.append(
                        (new_held, lock, item.context_expr.lineno))
                    if attr not in new_held:
                        new_held = new_held + (attr,)
            for stmt in node.body:
                self._walk(stmt, new_held, in_while, local_types)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, possibly on another thread — its
            # body holds NO locks lexically (conservative), but it
            # inherits the enclosing runs-on role for VC003 and its
            # accesses/calls are still recorded
            for stmt in node.body:
                self._walk(stmt, (), in_while=False,
                           local_types=dict(local_types))
            return
        if isinstance(node, ast.Lambda):
            self._walk_expr(node.body, (), local_types)
            return
        if isinstance(node, ast.While):
            # the test re-evaluates every iteration: it IS the
            # re-check loop for a wait written as the loop condition
            self._walk_expr(node.test, held, local_types, True)
            for stmt in node.body:
                self._walk(stmt, held, True, local_types)
            for stmt in node.orelse:
                self._walk(stmt, held, in_while, local_types)
            return
        if isinstance(node, ast.For):
            self._walk_expr(node.iter, held, local_types, in_while)
            self._walk_expr(node.target, held, local_types, in_while)
            for stmt in node.body + node.orelse:
                self._walk(stmt, held, in_while, local_types)
            return
        if isinstance(node, ast.Assign):
            self._walk_expr(node.value, held, local_types, in_while)
            # local type inference: v = ClassName(...) / v = self.attr
            names = _call_class_names(node.value)
            if isinstance(node.value, ast.Attribute) and \
                    isinstance(node.value.value, ast.Name) and \
                    node.value.value.id == "self" and \
                    self.cls is not None:
                names |= self.index.lookup_attr_types(
                    self.cls, node.value.attr)
            for target in node.targets:
                self._walk_expr(target, held, local_types, in_while)
                if isinstance(target, ast.Name) and names:
                    local_types.setdefault(target.id,
                                           set()).update(names)
            return
        # generic statements: visit child statements with the same
        # held set, expressions through _walk_expr
        for field in ast.iter_child_nodes(node):
            if isinstance(field, ast.stmt):
                self._walk(field, held, in_while, local_types)
            elif isinstance(field, ast.expr):
                self._walk_expr(field, held, local_types, in_while)
            elif isinstance(field, (ast.excepthandler,)):
                for stmt in field.body:
                    self._walk(stmt, held, in_while, local_types)
            elif isinstance(field, ast.withitem):
                self._walk_expr(field.context_expr, held, local_types,
                                in_while)
            elif isinstance(field, ast.keyword):
                self._walk_expr(field.value, held, local_types,
                                in_while)

    def _walk_expr(self, node: ast.AST, held: Tuple[str, ...],
                   local_types: Dict[str, Set[str]],
                   in_while: bool = False) -> None:
        if node is None:
            return
        stack = [node]
        while stack:
            child = stack.pop()
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue  # a def in expr position cannot occur
            if isinstance(child, ast.Lambda):
                # deferred body: runs LATER, possibly off-thread — it
                # must not inherit the caller's held-lock set (same
                # rule as nested defs in _walk) nor its loop context;
                # a plain `ast.walk` here would descend with the
                # locks still "held", hiding VC002 violations and
                # inventing VC004 ones
                self._walk_expr(child.body, (), local_types)
                continue
            stack.extend(ast.iter_child_nodes(child))
            if isinstance(child, ast.Call):
                recv: Tuple[Any, ...] = ()
                if isinstance(child.func, ast.Attribute):
                    recv = tuple(self._receiver_classes(
                        child.func.value, local_types))
                self.method.calls.append(
                    (held, child, child.lineno, recv))
                reason = self._blocking_reason(child)
                if reason is not None:
                    self.method.blocking.append(
                        (held, reason, child.lineno))
                self._maybe_condition_wait(child, in_while)
            elif isinstance(child, ast.Attribute) and \
                    isinstance(child.value, ast.Name) and \
                    child.value.id == "self":
                self.method.accesses.append((held, child.attr, child))

    def _maybe_condition_wait(self, call: ast.Call,
                              in_while: bool) -> None:
        """``in_while`` is the statement-walk's loop context, threaded
        down so the re-check-loop classification needs no ancestor
        rescan."""
        func = call.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in ("wait",):
            return
        if not (isinstance(func.value, ast.Attribute) and
                isinstance(func.value.value, ast.Name) and
                func.value.value.id == "self" and self.cls is not None):
            return
        attr = func.value.attr
        lock = self.index.lookup_lock(self.cls, attr)
        if lock is None or lock.kind != "condition":
            return
        self.method.waits.append((attr, in_while, call.lineno))


# ---------------------------------------------------------------------------
# pass 3: interprocedural closures + the checks
# ---------------------------------------------------------------------------

class _Analyzer:
    def __init__(self, index: _PackageIndex) -> None:
        self.index = index
        self.findings: List[Finding] = []
        #: (a.name, b.name) -> (path, line, via-description)
        self.edges: Dict[Tuple[str, str],
                         Tuple[str, int, str]] = {}
        self.nodes: Dict[str, LockNode] = {}
        self._acq_memo: Dict[int, Dict[str, Tuple[str, int, str]]] = {}
        self._blk_memo: Dict[int, List[Tuple[str, int, str]]] = {}
        self._in_progress: Set[int] = set()

    # -- call resolution ---------------------------------------------------
    def _resolve_call(self, method: _Method, call: ast.Call,
                      recv: Tuple[Any, ...]) -> List[_Method]:
        func = call.func
        module = _module_name(method.path)
        out: List[_Method] = []
        if isinstance(func, ast.Name):
            # same-module function or ClassName(...) constructor
            fn = self.index.functions.get((module, func.id))
            if fn is not None:
                out.append(fn)
            for cls in self.index.resolve_class(func.id, module):
                ctor = self.index.lookup_method(cls, "__init__")
                if ctor is not None:
                    out.append(ctor)
            return out
        if not isinstance(func, ast.Attribute):
            return out
        name = func.attr
        # receiver classes were resolved at scan time (with local
        # variable/parameter types in scope)
        for cls in recv:
            found = self.index.lookup_method(cls, name)
            if found is not None:
                out.append(found)
        return out

    # -- closures ----------------------------------------------------------
    # Memoization subtlety: a summary computed under a depth cutoff or
    # a recursion cut is TRUNCATED — caching it would bake the
    # truncation in and make later full-budget queries silently miss
    # acquisitions/blockers (traversal-order-dependent false
    # negatives). Only complete summaries are memoized; truncated ones
    # are recomputed (bounded by MAX_DEPTH, so still cheap).

    def may_acquire(self, method: _Method, depth: int = 0
                    ) -> Dict[str, Tuple[str, int, str]]:
        """lock node name -> (path, line, via) for every lock this
        method (transitively) may acquire."""
        return self._may_acquire(method, depth)[0]

    def _may_acquire(self, method: _Method, depth: int
                     ) -> Tuple[Dict[str, Tuple[str, int, str]], bool]:
        key = id(method)
        cached = self._acq_memo.get(key)
        if cached is not None:
            return cached, True
        if key in self._in_progress or depth > MAX_DEPTH:
            return {}, False
        self._in_progress.add(key)
        complete = True
        out: Dict[str, Tuple[str, int, str]] = {}
        for _held, lock, line in method.acquires:
            out.setdefault(lock.name,
                           (method.path, line, method.qualname))
        for _held, call, line, recv in method.calls:
            for callee in self._resolve_call(method, call, recv):
                sub, sub_complete = self._may_acquire(callee,
                                                      depth + 1)
                complete = complete and sub_complete
                for lock_name, (path, cline, via) in sub.items():
                    out.setdefault(
                        lock_name,
                        (method.path, line,
                         "%s -> %s" % (method.qualname, via)))
        self._in_progress.discard(key)
        if complete:
            self._acq_memo[key] = out
        return out, complete

    def may_block(self, method: _Method, depth: int = 0
                  ) -> List[Tuple[str, int, str]]:
        """[(reason, line-of-entry, via)] for blocking calls this
        method (transitively) may make."""
        return self._may_block(method, depth)[0]

    def _may_block(self, method: _Method, depth: int
                   ) -> Tuple[List[Tuple[str, int, str]], bool]:
        key = id(method)
        cached = self._blk_memo.get(key)
        if cached is not None:
            return cached, True
        if key in self._in_progress or depth > MAX_DEPTH:
            return [], False
        self._in_progress.add(key)
        complete = True
        out: List[Tuple[str, int, str]] = []
        for _held, reason, line in method.blocking:
            out.append((reason, line, method.qualname))
        for _held, call, line, recv in method.calls:
            for callee in self._resolve_call(method, call, recv):
                sub, sub_complete = self._may_block(callee, depth + 1)
                complete = complete and sub_complete
                for reason, _cline, via in sub:
                    out.append((reason, line,
                                "%s -> %s" % (method.qualname, via)))
        self._in_progress.discard(key)
        if complete:
            self._blk_memo[key] = out
        return out, complete

    # -- held-name -> LockNode resolution ----------------------------------
    def _held_nodes(self, method: _Method,
                    held: Tuple[str, ...]) -> List[LockNode]:
        out = []
        module = _module_name(method.path)
        for attr in held:
            node = None
            if method.cls is not None:
                node = self.index.lookup_lock(method.cls, attr)
            if node is None:
                node = self.index.module_locks.get((module, attr))
            if node is not None:
                out.append(node)
        return out

    # -- graph building ----------------------------------------------------
    def build_graph(self) -> None:
        for method in self._all_methods():
            for held, lock, line in method.acquires:
                self.nodes.setdefault(lock.name, lock)
                for held_node in self._held_nodes(method, held):
                    self.nodes.setdefault(held_node.name, held_node)
                    self._add_edge(held_node, lock, method.path, line,
                                   method.qualname)
            for held, call, line, recv in method.calls:
                if not held:
                    continue
                held_nodes = self._held_nodes(method, held)
                if not held_nodes:
                    continue
                for callee in self._resolve_call(method, call, recv):
                    acquired = self.may_acquire(callee)
                    for lock_name, (_p, _l, via) in acquired.items():
                        lock = self._node_for(lock_name, callee)
                        if lock is None:
                            continue
                        self.nodes.setdefault(lock.name, lock)
                        for held_node in held_nodes:
                            self.nodes.setdefault(held_node.name,
                                                  held_node)
                            self._add_edge(
                                held_node, lock, method.path, line,
                                "%s -> %s" % (method.qualname, via))

    def _node_for(self, lock_name: str,
                  hint: _Method) -> Optional[LockNode]:
        node = self.nodes.get(lock_name)
        if node is not None:
            return node
        cls_name, _, attr = lock_name.rpartition(".")
        for cls_list in (self.index.resolve_class(cls_name),):
            for cls in cls_list:
                found = cls.locks.get(attr)
                if found is not None:
                    return found
        for (module, name), lock in self.index.module_locks.items():
            if lock.name == lock_name:
                return lock
        return None

    def _add_edge(self, a: LockNode, b: LockNode, path: str,
                  line: int, via: str) -> None:
        if a.name == b.name:
            if a.reentrant:
                return  # legal reentrance
            self.findings.append(Finding(
                "VC001", path, line, 0,
                "non-reentrant lock %s re-acquired while already "
                "held (via %s): guaranteed self-deadlock — use an "
                "RLock or restructure" % (a.name, via)))
            return
        self.edges.setdefault((a.name, b.name), (path, line, via))

    # -- VC001: SCC cycles -------------------------------------------------
    def check_deadlocks(self) -> None:
        graph: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        for scc in _tarjan(graph):
            if len(scc) < 2:
                continue
            cycle = _reconstruct_cycle(graph, scc)
            steps = []
            first = None
            for a, b in zip(cycle, cycle[1:]):
                path, line, via = self.edges[(a, b)]
                if first is None:
                    first = (path, line)
                steps.append("%s -> %s at %s:%d (via %s)"
                             % (a, b, os.path.basename(path), line,
                                via))
            self.findings.append(Finding(
                "VC001", first[0], first[1], 0,
                "potential deadlock: lock-order cycle %s; %s"
                % (" -> ".join(cycle), "; ".join(steps))))

    # -- VC002 / VC003 ------------------------------------------------------
    def check_guarded_state(self) -> None:
        for cls in self._all_classes():
            if not cls.guarded and not cls.owned:
                continue
            for method in cls.methods.values():
                self._check_method_guards(cls, method)
            self._check_holds_discipline(cls)

    def _guard_satisfied(self, cls: _Class, method: _Method,
                         held: Tuple[str, ...], guard: str) -> bool:
        if guard in held or guard in method.holds:
            return True
        # a condition constructed over the guard counts: holding
        # `self._cond` IS holding the `self._lock` it wraps
        for attr in list(held) + sorted(method.holds):
            cur = cls
            seen: Set[int] = set()
            stack = [cur]
            while stack:
                candidate = stack.pop()
                if id(candidate) in seen:
                    continue
                seen.add(id(candidate))
                if candidate.cond_alias.get(attr) == guard:
                    return True
                for base in candidate.bases:
                    stack.extend(self.index.resolve_class(
                        base, candidate.module))
        return False

    def _check_method_guards(self, cls: _Class,
                             method: _Method) -> None:
        ctor = method.name in _CTOR_METHODS
        for held, attr, node in method.accesses:
            if attr in cls.guarded and not ctor:
                guard, _ = cls.guarded[attr]
                if not self._guard_satisfied(cls, method, held, guard):
                    self.findings.append(Finding(
                        "VC002", method.path, node.lineno,
                        node.col_offset,
                        "field %s.%s is `# guarded-by: %s` but "
                        "%s accesses it without the lock (wrap in "
                        "`with self.%s:` or mark the method "
                        "`# holds: %s`)" % (cls.name, attr, guard,
                                            method.qualname, guard,
                                            guard)))
            if attr in cls.owned and not ctor:
                role, _ = cls.owned[attr]
                if method.runs_on != role:
                    self.findings.append(Finding(
                        "VC003", method.path, node.lineno,
                        node.col_offset,
                        "field %s.%s is `# owned-by: %s` but %s is "
                        "not marked `# runs-on: %s` — off-thread "
                        "access to thread-owned state" %
                        (cls.name, attr, role, method.qualname, role)))

    def _check_holds_discipline(self, cls: _Class) -> None:
        """Every call site of a ``# holds: L``-marked method must
        actually hold L."""
        holds_methods = {name: m for name, m in cls.methods.items()
                         if m.holds}
        if not holds_methods:
            return
        for method in cls.methods.values():
            for held, call, line, _recv in method.calls:
                func = call.func
                if not (isinstance(func, ast.Attribute) and
                        isinstance(func.value, ast.Name) and
                        func.value.id == "self"):
                    continue
                callee = holds_methods.get(func.attr)
                if callee is None or \
                        method.name in _CTOR_METHODS:
                    continue
                for guard in sorted(callee.holds):
                    if not self._guard_satisfied(cls, method, held,
                                                 guard):
                        self.findings.append(Finding(
                            "VC002", method.path, line, 0,
                            "%s declares `# holds: %s` but %s calls "
                            "it without the lock held" %
                            (callee.qualname, guard,
                             method.qualname)))

    # -- VC004 ---------------------------------------------------------------
    def check_blocking_under_lock(self) -> None:
        for method in self._all_methods():
            for held, reason, line in method.blocking:
                held_nodes = self._held_nodes(method, held)
                if held_nodes:
                    self.findings.append(Finding(
                        "VC004", method.path, line, 0,
                        "blocking call %s while holding %s in %s — "
                        "one slow peer/sleep stalls every thread "
                        "contending on the lock; move the blocking "
                        "work outside the critical section" %
                        (reason,
                         ", ".join(n.name for n in held_nodes),
                         method.qualname)))
            for held, call, line, recv in method.calls:
                if not held:
                    continue
                held_nodes = self._held_nodes(method, held)
                if not held_nodes:
                    continue
                for callee in self._resolve_call(method, call, recv):
                    for reason, _l, via in self.may_block(callee):
                        self.findings.append(Finding(
                            "VC004", method.path, line, 0,
                            "call chain %s blocks (%s) while %s "
                            "holds %s" %
                            (via, reason, method.qualname,
                             ", ".join(n.name
                                       for n in held_nodes))))

    # -- VC005 ---------------------------------------------------------------
    def check_condition_waits(self) -> None:
        for method in self._all_methods():
            for attr, in_while, line in method.waits:
                if not in_while:
                    self.findings.append(Finding(
                        "VC005", method.path, line, 0,
                        "%s.wait() in %s is not inside a `while` "
                        "predicate re-check loop — spurious/stolen "
                        "wakeups make a bare wait() return with the "
                        "predicate still false" %
                        (attr, method.qualname)))

    # -- iteration helpers --------------------------------------------------
    def _all_classes(self) -> Iterable[_Class]:
        return self.index.classes.values()

    def _all_methods(self) -> Iterable[_Method]:
        for cls in self.index.classes.values():
            for method in cls.methods.values():
                yield method
        for method in self.index.functions.values():
            yield method


def _tarjan(graph: Dict[str, List[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (no recursion limit surprises)."""
    index_counter = [0]
    stack: List[str] = []
    lowlink: Dict[str, int] = {}
    index: Dict[str, int] = {}
    on_stack: Set[str] = set()
    sccs: List[List[str]] = []

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(graph.get(root, ())))]
        index[root] = lowlink[root] = index_counter[0]
        index_counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index:
                    index[succ] = lowlink[succ] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(graph.get(succ, ()))))
                    advanced = True
                    break
                elif succ in on_stack:
                    lowlink[node] = min(lowlink[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                sccs.append(scc)
    return sccs


def _reconstruct_cycle(graph: Dict[str, List[str]],
                       scc: List[str]) -> List[str]:
    """A concrete shortest cycle through ``scc[0]`` for the witness
    path (BFS back to the start; an SCC guarantees one exists)."""
    members = set(scc)
    start = scc[0]
    parents: Dict[str, str] = {}
    frontier = [start]
    while frontier:
        nxt = []
        for node in frontier:
            for succ in graph.get(node, ()):
                if succ not in members:
                    continue
                if succ == start:
                    path = [start]
                    cur = node
                    while cur != start:
                        path.append(cur)
                        cur = parents[cur]
                    path.append(start)
                    path.reverse()
                    return path
                if succ not in parents:
                    parents[succ] = node
                    nxt.append(succ)
        frontier = nxt
    return [start, start]  # unreachable for a true SCC


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def build_index(paths: Iterable[Tuple[str, str]]) -> _PackageIndex:
    """Index ``(path, source)`` pairs: pass 1 + pass 2."""
    index = _PackageIndex()
    trees = []
    for path, source in paths:
        tree = ast.parse(source, filename=path)
        _Collector(index, path, source).run(tree)
        trees.append((path, tree))
    for cls in list(index.classes.values()):
        for method in cls.methods.values():
            _MethodScanner(index, method).scan()
    for method in index.functions.values():
        _MethodScanner(index, method).scan()
    return index


def _apply_noqa(index: _PackageIndex,
                findings: List[Finding]) -> List[Finding]:
    kept = []
    for finding in findings:
        lines = index.sources.get(finding.path, [])
        suppressed = False
        for lineno in range(finding.line, finding.end_line + 1):
            if 1 <= lineno <= len(lines):
                match = _NOQA_RE.search(lines[lineno - 1])
                if match is None:
                    continue
                codes = match.group("codes")
                if not codes or finding.rule in {
                        c.strip().upper() for c in codes.split(",")}:
                    suppressed = True
                    break
        if not suppressed:
            kept.append(finding)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def analyze_sources(sources: List[Tuple[str, str]]) -> List[Finding]:
    """Analyze ``(path, source)`` pairs as one closed package."""
    index = build_index(sources)
    analyzer = _Analyzer(index)
    analyzer.build_graph()
    analyzer.check_deadlocks()
    analyzer.check_guarded_state()
    analyzer.check_blocking_under_lock()
    analyzer.check_condition_waits()
    # dedupe (interprocedural checks can hit one line several ways)
    seen: Set[Tuple[str, str, int, str]] = set()
    unique = []
    for finding in analyzer.findings:
        key = (finding.rule, finding.path, finding.line,
               finding.message)
        if key not in seen:
            seen.add(key)
            unique.append(finding)
    return _apply_noqa(index, unique)


def analyze_source(source: str,
                   path: str = "<string>") -> List[Finding]:
    """Analyze one source string (tests/fixtures)."""
    return analyze_sources([(path, source)])


def analyze_package(package_dir: Optional[str] = None
                    ) -> List[Finding]:
    """Analyze the whole veles_tpu_torch package."""
    sources = []
    findings: List[Finding] = []
    for path in iter_package_files(package_dir):
        try:
            with open(path, "r", encoding="utf-8") as fin:
                sources.append((path, fin.read()))
        except OSError as e:  # pragma: no cover - racing FS
            findings.append(Finding("VC000", path, 1, 0,
                                    "unreadable: %s" % e))
    try:
        findings.extend(analyze_sources(sources))
    except SyntaxError as e:
        findings.append(Finding(
            "VC000", e.filename or "<unknown>", e.lineno or 1, 0,
            "syntax error: %s" % e.msg))
    return findings


# ---------------------------------------------------------------------------
# CLI — the same baseline mechanics as the VL lint
# ---------------------------------------------------------------------------

def _default_baseline_path() -> str:
    return os.path.join(baselines_dir(), "concurrency_baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from veles_tpu_torch.analysis.baseline import gate_counts
    from veles_tpu_torch.analysis.lint import count_by_file_rule

    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis.concurrency",
        description="veles_tpu_torch concurrency analysis "
                    "(VC001-VC005)")
    parser.add_argument("files", nargs="*",
                        help="explicit files analyzed as one unit "
                             "(default: whole package, baseline gate)")
    parser.add_argument("--baseline", default=_default_baseline_path())
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    args = parser.parse_args(argv)

    if args.files:
        sources = []
        for path in args.files:
            with open(path, "r", encoding="utf-8") as fin:
                sources.append((path, fin.read()))
        findings = analyze_sources(sources)
        for finding in findings:
            print(finding)
        print("veles_concurrency: %d finding(s) in %d file(s)"
              % (len(findings), len(args.files)))
        return 1 if findings else 0

    findings = analyze_package()
    for finding in findings:
        print(finding)
    counts = count_by_file_rule(findings, relative_to=repo_root())
    return gate_counts("veles_concurrency", counts, args.baseline,
                       no_baseline=args.no_baseline,
                       update=args.update_baseline)


if __name__ == "__main__":
    raise SystemExit(main())
