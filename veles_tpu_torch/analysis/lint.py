"""AST lint for capture and concurrency hygiene over the port's package
(port of ``veles_tpu/analysis/lint.py``).

The hot paths (the captured decode rounds, the trainers' captured
steps, the engines' bucket forwards) die by a thousand cuts no
general-purpose linter knows about: a ``.item()`` inside a captured
step raises during the capture on the card (or, eagerly, syncs the host
every step), a ``StepGraph`` built in a loop body captures forever, a
fire-and-forget daemon thread leaks past ``Workflow`` teardown, a
socket send under a lock turns one slow peer into a global stall. Each
has a named rule here; the whole package lints clean on an empty
baseline (``python -m veles_tpu_torch.analysis``), so a new violation
fails the gate the moment it is written.

Rules:

=======  ============================================================
VL001    host synchronization inside a capture root (``.item()``,
         ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/
         ``int()``/``bool()`` of a tensor, ``torch.cuda.synchronize``):
         on the card it raises during the capture, or bakes one value
         into every replay
VL002    a capture made inside a loop body (``StepGraph(...)``,
         ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``): a
         fresh graph and memory pool per iteration
VL003    raw ``threading.Thread(daemon=True)`` outside the
         ManagedThreads discipline (veles_tpu_torch.thread_pool)
VL004    blocking socket send/recv/accept while holding a lock
VL005    bare ``except: pass`` — swallows every error including
         KeyboardInterrupt/SystemExit
VL006    deadline arithmetic on ``time.time()`` — wall-clock jumps
         (NTP step, DST, suspend/resume) corrupt timeouts computed
         from it; ``time.monotonic()`` is the clock for deadlines.
         Flags ``time.time()`` used as an operand of ``+``/``-`` or
         of a comparison; pure timestamping (assignments, log/dict
         fields) is fine
VL007    ad-hoc latency accounting: a ``time.monotonic()`` /
         ``time.perf_counter()`` subtraction inlined straight into a
         call argument outside ``veles_tpu_torch/obs/``. Every
         duration the platform reports flows through the one
         instrumented door, ``veles_tpu_torch.obs.trace.elapsed_s(t0)``
         (or a span), so the tracing plane sees what the metrics plane
         sees; files under ``veles_tpu_torch/obs/`` are exempt (they
         ARE the door)
=======  ============================================================

A **capture root** is a callable passed to ``StepGraph(...)`` (a
lambda, a name, or ``self.method``), or a ``def`` carrying a
``# veles-lint: capture-context`` marker; every function it reaches
through same-package calls (``self.m()`` in its class, same-module
functions, ``from veles_tpu_torch... import f``) runs under the capture
too, to a bounded depth (:func:`capture_surface`). :mod:`jitcheck` and
:mod:`memplan` check the same surface.

Suppression: an inline ``# noqa: VL003`` on the flagged line (bare
``# noqa`` suppresses every rule).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "VL001": "host synchronization inside a capture root",
    "VL002": "a CUDA graph capture made inside a loop body",
    "VL003": "raw threading.Thread(daemon=True) outside ManagedThreads",
    "VL004": "blocking socket send/recv while holding a lock",
    "VL005": "bare `except: pass` swallows every error",
    "VL006": "deadline arithmetic on time.time() instead of "
             "time.monotonic()",
    "VL007": "ad-hoc monotonic latency accounting outside "
             "veles_tpu_torch/obs/ (use obs.trace.elapsed_s or a span)",
}

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z]+\d+"
                      r"(?:\s*,\s*[A-Z]+\d+)*))?", re.IGNORECASE)
_CAPTURE_MARKER_RE = re.compile(r"#\s*veles-lint:\s*capture-context")

#: the package whose files are one closed unit of analysis
PACKAGE = "veles_tpu_torch"

#: interprocedural closure depth bound (the VC/VJ passes' bound too)
MAX_DEPTH = 8

# ---------------------------------------------------------------------------
# THE blocking-call table — one place to extend, no drift.
#
# VL004 (here) uses the socket attrs against "lockish"-named context
# managers; the concurrency pass's VC004
# (veles_tpu_torch/analysis/concurrency.py) uses all three tables
# against every DISCOVERED lock, interprocedurally. Extend these
# constants and both rules pick the change up.
# ---------------------------------------------------------------------------

#: attribute calls that block on a socket peer (``x.sendall(...)``)
BLOCKING_SOCKET_ATTRS = frozenset({
    "send", "sendall", "sendto", "sendmsg", "recv", "recv_into",
    "recvfrom", "accept", "connect"})

#: dotted calls that block unconditionally: sleeps, subprocess
#: round-trips, synchronous HTTP, TCP dials
BLOCKING_CALL_DOTTED = frozenset({
    "time.sleep",
    "socket.create_connection",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.put",
    "requests.request",
})

#: attribute calls that block when the receiver looks like the kind of
#: object the needle names: ``{attr: (receiver-name substrings)}`` —
#: ``q.get()`` / ``jobs_queue.get()`` is a blocking queue pop, while
#: ``doc.get()`` is a dict read; ``worker_thread.join()`` blocks,
#: ``",".join()`` does not
BLOCKING_RECEIVER_ATTRS = {
    "get": ("queue", "_q", "jobs", "requests", "tickets", "chunks",
            "tokens"),
    "join": ("thread", "proc", "worker", "child"),
    "wait": ("proc", "process", "child", "popen"),
}

#: tensor methods that copy a device value to the host (VL001)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: dotted calls that wait for the device (VL001)
_SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
#: tensor methods whose result is a tensor (a reduction): ``float()``
#: of one is a host sync
TENSOR_REDUCTIONS = frozenset({
    "sum", "any", "all", "mean", "min", "max", "prod", "norm", "amax",
    "amin", "argmax", "argmin", "count_nonzero", "std", "var",
    "logsumexp"})
#: tensor methods that read host metadata (no sync)
_HOST_META = frozenset({
    "numel", "dim", "size", "stride", "element_size", "nelement",
    "data_ptr", "get_device", "is_contiguous", "storage_offset"})
#: ``torch.*`` calls that return host values
_TORCH_HOST = ("torch.finfo", "torch.iinfo", "torch.is_tensor",
               "torch.is_floating_point", "torch.get_default_dtype",
               "torch.cuda.", "torch.distributed.", "torch.backends.",
               "torch.device", "torch.Size", "torch.dtype",
               "torch.is_grad_enabled", "torch.is_inference_mode_enabled")
#: single names that are modules, not tensors
NONTENSOR_RECEIVERS = frozenset({
    "np", "numpy", "onp", "math", "statistics", "operator", "random",
    "itertools", "functools", "builtins", "os", "sys", "torch", "F",
    "collections", "time", "json"})

#: the capture constructors (VL002) by dotted-name suffix
_CAPTURE_CTORS = ("StepGraph", "torch.cuda.CUDAGraph", "CUDAGraph",
                  "torch.cuda.graph")


class Finding:
    """One lint hit: ``rule``, ``path``, ``line``, ``col``,
    ``message``. ``end_line`` spans multi-line statements so an
    inline ``# noqa`` on any physical line of the flagged construct
    suppresses it."""

    __slots__ = ("rule", "path", "line", "col", "message", "end_line")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str, end_line: Optional[int] = None) -> None:
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.end_line = end_line if end_line is not None else line

    def __str__(self) -> str:
        return "%s:%d:%d: %s %s" % (self.path, self.line, self.col + 1,
                                    self.rule, self.message)

    def __repr__(self) -> str:
        return "<Finding %s %s:%d>" % (self.rule, self.path, self.line)


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for the Attribute chain, 'f' for a Name."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else "%s.%s" % (base, node.attr)
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == "self":
        return node.attr
    return None


def is_capture_ctor(func: ast.AST) -> bool:
    """``StepGraph`` / ``torch.cuda.CUDAGraph`` / ``torch.cuda.graph``."""
    name = _dotted(func)
    return name is not None and (
        name in _CAPTURE_CTORS or name.endswith(".StepGraph"))


def is_step_graph(func: ast.AST) -> bool:
    name = _dotted(func)
    return name is not None and (name == "StepGraph" or
                                 name.endswith(".StepGraph"))


def _captured_arg(call: ast.Call) -> Optional[ast.AST]:
    """The callable a ``StepGraph(...)`` call captures."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


def _walk_stop_at_functions(node: ast.AST) -> Iterable[ast.AST]:
    """Yield descendants of ``node`` without descending into nested
    function/lambda bodies (their execution context differs)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
            stack.extend(ast.iter_child_nodes(child))


# ---------------------------------------------------------------------------
# the capture surface: roots and their same-package call closure
# ---------------------------------------------------------------------------

class Function:
    """One function, method or captured lambda: its AST, owning class
    (or None) and module."""

    __slots__ = ("name", "cls", "module", "path", "node", "def_line")

    def __init__(self, name: str, cls: Optional[str], module: str,
                 path: str, node: ast.AST, def_line: str) -> None:
        self.name = name
        self.cls = cls
        self.module = module
        self.path = path
        self.node = node
        self.def_line = def_line

    @property
    def qualname(self) -> str:
        return "%s.%s" % (self.cls, self.name) if self.cls \
            else self.name


class Module:
    """Per-module index: functions, methods, package imports, the
    capture roots it declares and which methods rebind which ``self``
    attributes."""

    def __init__(self, module: str, path: str, source: str) -> None:
        self.module = module
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.functions: Dict[str, Function] = {}
        self.methods: Dict[Tuple[str, str], Function] = {}
        #: local name -> (source module, source name)
        self.imports: Dict[str, Tuple[str, str]] = {}
        #: per class: attr -> names of the methods that ASSIGN it
        self.class_assigns: Dict[str, Dict[str, Set[str]]] = {}
        #: functions (lambdas included) captured directly
        self.roots: List[Function] = []
        self._index()

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith(PACKAGE):
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        node.module, alias.name)
        class_stack: List[str] = []
        owner: Dict[ast.AST, Function] = {}

        def visit(node, enclosing: Optional[Function]) -> None:
            if isinstance(node, ast.ClassDef):
                self.class_assigns.setdefault(node.name, {})
                class_stack.append(node.name)
                for child in node.body:
                    visit(child, None)
                class_stack.pop()
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and enclosing is None:
                cls = class_stack[-1] if class_stack else None
                fn = Function(node.name, cls, self.module, self.path,
                              node, self.line(node.lineno))
                if cls is None:
                    self.functions[fn.name] = fn
                else:
                    self.methods[(cls, fn.name)] = fn
                    assigns = self.class_assigns[cls]
                    for sub in ast.walk(node):
                        targets: List[ast.AST] = []
                        if isinstance(sub, ast.Assign):
                            targets = sub.targets
                        elif isinstance(sub, (ast.AugAssign,
                                              ast.AnnAssign)):
                            targets = [sub.target]
                        for tgt in targets:
                            for part in ast.walk(tgt):
                                attr = _self_attr(part)
                                if attr is not None and \
                                        isinstance(part.ctx, ast.Store):
                                    assigns.setdefault(
                                        attr, set()).add(node.name)
                if _CAPTURE_MARKER_RE.search(fn.def_line):
                    self.roots.append(fn)
                owner[node] = fn
                for child in node.body:
                    visit(child, fn)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, enclosing)

        visit(self.tree, None)
        # roots by call form: StepGraph(lambda ...), StepGraph(self.m),
        # StepGraph(f), in methods, functions and module-level code
        for (cls, _), fn in list(self.methods.items()):
            self._scan_captures([fn.node], cls, fn.def_line)
        for fn in list(self.functions.values()):
            self._scan_captures([fn.node], None, fn.def_line)
        self._scan_captures(
            [n for n in self.tree.body if not isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))],
            None, "")

    def _scan_captures(self, scopes: List[ast.AST], cls: Optional[str],
                       def_line: str) -> None:
        for node in (n for scope in scopes for n in ast.walk(scope)):
            if not (isinstance(node, ast.Call) and
                    is_step_graph(node.func)):
                continue
            arg = _captured_arg(node)
            if arg is None:
                continue
            if isinstance(arg, ast.Lambda):
                self.roots.append(Function(
                    "<lambda@%d>" % arg.lineno, cls, self.module,
                    self.path, arg, def_line))
                continue
            attr = _self_attr(arg)
            if attr is not None and cls is not None and \
                    (cls, attr) in self.methods:
                self.roots.append(self.methods[(cls, attr)])
            elif isinstance(arg, ast.Name) and \
                    arg.id in self.functions:
                self.roots.append(self.functions[arg.id])


def module_name_for(path: str) -> str:
    """Dotted module name from a file path (the part from the last
    ``veles_tpu_torch`` component on)."""
    parts = os.path.normpath(path).split(os.sep)
    if PACKAGE in parts:
        idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
        parts = parts[idx:]
    name = "/".join(parts)
    if name.endswith(".py"):
        name = name[:-3]
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


class PackageIndex:
    """Every module of one closed unit, with call resolution."""

    def __init__(self, modules: Sequence[Module]) -> None:
        self.modules = {m.module: m for m in modules}
        self.by_path = {m.path: m for m in modules}

    @classmethod
    def from_sources(cls, sources: Sequence[Tuple[str, str]]
                     ) -> "PackageIndex":
        return cls([Module(module_name_for(path), path, source)
                    for path, source in sources])

    def resolve_call(self, mod: Module, caller: Function,
                     call: ast.Call) -> Optional[Function]:
        """The package function a call lands in, or None (builtin,
        external or unresolvable: the analysis under-approximates)."""
        func = call.func
        attr = _self_attr(func)
        if attr is not None and caller.cls is not None:
            return mod.methods.get((caller.cls, attr))
        if isinstance(func, ast.Name):
            name = func.id
            if name in mod.functions:
                return mod.functions[name]
            target = mod.imports.get(name)
            if target is not None:
                src = self.modules.get(target[0])
                if src is not None:
                    return src.functions.get(target[1])
        return None

    def capture_surface(self) -> Dict[Function, Module]:
        """Every function that runs under a capture: the roots plus
        their bounded same-package call closure. Nested defs count
        through their parent (``ast.walk`` covers them)."""
        surface: Dict[Function, Module] = {}
        frontier: List[Tuple[Function, Module, int]] = []
        for mod in self.modules.values():
            for fn in mod.roots:
                if fn not in surface:
                    surface[fn] = mod
                    frontier.append((fn, mod, 0))
        while frontier:
            fn, mod, depth = frontier.pop()
            if depth >= MAX_DEPTH:
                continue
            for call in ast.walk(fn.node):
                if not isinstance(call, ast.Call):
                    continue
                callee = self.resolve_call(mod, fn, call)
                if callee is not None and callee not in surface:
                    callee_mod = self.modules[callee.module]
                    surface[callee] = callee_mod
                    frontier.append((callee, callee_mod, depth + 1))
        return surface


def capture_surface(sources: Sequence[Tuple[str, str]]
                    ) -> Dict[Function, Module]:
    """The capture surface of ``(path, source)`` pairs."""
    return PackageIndex.from_sources(sources).capture_surface()


def tensor_names(fn_node: ast.AST) -> Set[str]:
    """Local names bound to tensor-ish values in a function (a forward
    pass over its assignments; parameters stay unknown)."""
    names: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and \
                is_tensor_expr(node.value, names):
            for target in node.targets:
                for part in ast.walk(target):
                    if isinstance(part, ast.Name):
                        names.add(part.id)
    return names


def is_tensor_expr(expr: ast.AST, names: Set[str]) -> bool:
    """Does ``expr`` evaluate to a tensor? A ``torch.*`` call (not one
    that returns host values), a tensor reduction method, arithmetic,
    indexing or comparison of one (not an identity test, ``is``), or a
    name bound to one. Shape, dtype and size reads are host
    metadata."""
    if isinstance(expr, ast.Call):
        func = expr.func
        if isinstance(func, ast.Attribute):
            if func.attr in _HOST_META:
                return False
            if func.attr in TENSOR_REDUCTIONS:
                base = _dotted(func.value)
                if base is None:
                    return True
                if "." not in base:
                    return base not in NONTENSOR_RECEIVERS
                return is_tensor_expr(func.value, names)
        name = _dotted(func)
        if name is not None and name.startswith("torch.") and \
                not name.startswith(_TORCH_HOST):
            return True
        if isinstance(func, ast.Attribute) and \
                not isinstance(func.value, ast.Name):
            return is_tensor_expr(func.value, names)
        return False
    if isinstance(expr, ast.Attribute):
        return expr.attr not in ("shape", "ndim", "dtype", "device",
                                 "is_cuda", "requires_grad") and \
            isinstance(expr.value, ast.Call) and \
            is_tensor_expr(expr.value, names)
    if isinstance(expr, ast.BinOp):
        return is_tensor_expr(expr.left, names) or \
            is_tensor_expr(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return is_tensor_expr(expr.operand, names)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False        # an identity test reads no tensor
        return is_tensor_expr(expr.left, names) or any(
            is_tensor_expr(c, names) for c in expr.comparators)
    if isinstance(expr, ast.BoolOp):
        return any(is_tensor_expr(v, names) for v in expr.values)
    if isinstance(expr, ast.Subscript):
        return is_tensor_expr(expr.value, names)
    if isinstance(expr, ast.Name):
        return expr.id in names
    return False


def apply_noqa(lines_of, findings: List[Finding]) -> List[Finding]:
    """Drop findings an inline ``# noqa`` (or ``# noqa: CODE``) on any
    of their lines suppresses; ``lines_of(path)`` gives a file's lines."""
    kept = []
    for finding in findings:
        lines = lines_of(finding.path)
        suppressed = False
        for lineno in range(finding.line, finding.end_line + 1):
            if not 1 <= lineno <= len(lines):
                continue
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
    return kept


def _flag_into(findings: List[Finding], rule: str, path: str,
               node: ast.AST, message: str) -> None:
    line = getattr(node, "lineno", 1)
    findings.append(Finding(rule, path, line,
                            getattr(node, "col_offset", 0), message,
                            end_line=getattr(node, "end_lineno", line)))


def check_host_syncs(fn: Function, findings: List[Finding]) -> None:
    """VL001 over one function of the capture surface."""
    names = tensor_names(fn.node)
    body = fn.node.body if isinstance(fn.node.body, list) \
        else [fn.node.body]
    for stmt in body:
        for child in ast.walk(stmt):
            if not isinstance(child, ast.Call):
                continue
            func = child.func
            name = _dotted(func)
            if isinstance(func, ast.Attribute) and \
                    func.attr in _SYNC_METHODS and not child.args:
                base = _dotted(func.value)
                if base is not None and "." not in base and \
                        base in NONTENSOR_RECEIVERS:
                    continue
                _flag_into(findings, "VL001", fn.path, child,
                           ".%s() copies a device value to the host "
                           "inside capture root %s: it raises during "
                           "the capture on the card" % (func.attr,
                                                        fn.qualname))
            elif name in _SYNC_CALLS:
                _flag_into(findings, "VL001", fn.path, child,
                           "%s() inside capture root %s waits for the "
                           "device (illegal while capturing)"
                           % (name, fn.qualname))
            elif isinstance(func, ast.Name) and \
                    func.id in ("float", "int", "bool") and \
                    len(child.args) == 1 and not child.keywords and \
                    is_tensor_expr(child.args[0], names):
                _flag_into(findings, "VL001", fn.path, child,
                           "%s() of a tensor inside capture root %s "
                           "syncs the host: a replay keeps the value "
                           "of the capture (keep it a tensor)"
                           % (func.id, fn.qualname))


class _Linter(ast.NodeVisitor):
    """One file's VL002-VL007 scan (VL001 needs the package)."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.tree = ast.parse(source, filename=path)
        # the obs package IS the sanctioned latency door (VL007):
        # exempt exactly veles_tpu_torch/obs/ — an adjacent path-
        # component pair, NOT any directory named "obs" anywhere
        parts = os.path.normpath(path).split(os.sep)
        self._obs_exempt = any(
            parts[i:i + 2] == [PACKAGE, "obs"]
            for i in range(len(parts) - 1))

    # -- plumbing ----------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        _flag_into(self.findings, rule, self.path, node, message)

    # -- VL002 --------------------------------------------------------------
    def _check_capture_in_loop(self, loop: ast.AST) -> None:
        for child in _walk_stop_at_functions(loop):
            if isinstance(child, ast.Call) and \
                    is_capture_ctor(child.func):
                self._flag("VL002", child,
                           "%s(...) inside a loop body: each iteration "
                           "captures a fresh graph into its own memory "
                           "pool — capture once, replay in the loop"
                           % _dotted(child.func))

    # -- VL003 --------------------------------------------------------------
    def _check_thread(self, call: ast.Call) -> None:
        name = _dotted(call.func)
        if name not in ("threading.Thread", "Thread"):
            return
        for kw in call.keywords:
            if kw.arg == "daemon" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value is True:
                self._flag(
                    "VL003", call,
                    "raw threading.Thread(daemon=True): daemon "
                    "threads leak past Workflow teardown invisibly — "
                    "register on a veles_tpu_torch.thread_pool."
                    "ManagedThreads and join in stop()")
                return

    # -- VL004 --------------------------------------------------------------
    @staticmethod
    def _is_lockish(expr: ast.AST) -> bool:
        name = _dotted(expr)
        if name is None and isinstance(expr, ast.Call):
            name = _dotted(expr.func)
        return name is not None and "lock" in name.lower()

    def _check_lock_io(self, node: ast.With) -> None:
        if not any(self._is_lockish(item.context_expr)
                   for item in node.items):
            return
        for stmt in node.body:
            for child in _walk_stop_at_functions(stmt):
                if isinstance(child, ast.Call) and \
                        isinstance(child.func, ast.Attribute) and \
                        child.func.attr in BLOCKING_SOCKET_ATTRS:
                    self._flag(
                        "VL004", child,
                        "blocking socket .%s() while holding a lock: "
                        "one stalled peer blocks every other thread "
                        "contending on it — do the I/O outside the "
                        "critical section" % child.func.attr)

    # -- VL005 --------------------------------------------------------------
    def _check_bare_except(self, node: ast.Try) -> None:
        for handler in node.handlers:
            if handler.type is None and \
                    all(isinstance(s, ast.Pass) for s in handler.body):
                self._flag(
                    "VL005", handler,
                    "bare `except: pass` swallows every error "
                    "including SystemExit/KeyboardInterrupt — catch a "
                    "concrete exception type")

    # -- VL006 --------------------------------------------------------------
    @staticmethod
    def _is_wallclock_call(node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            _dotted(node.func) == "time.time"

    def _check_wallclock_deadline(self, node: ast.AST) -> None:
        """``time.time()`` as a DIRECT operand of arithmetic or a
        comparison is deadline/duration math on the wall clock;
        timestamping (plain assignment, a dict/log field) stays
        legal."""
        if isinstance(node, ast.BinOp):
            operands = (node.left, node.right)
            if not isinstance(node.op, (ast.Add, ast.Sub)):
                return
        elif isinstance(node, ast.Compare):
            operands = (node.left, *node.comparators)
        else:
            return
        for operand in operands:
            if self._is_wallclock_call(operand):
                self._flag(
                    "VL006", operand,
                    "deadline arithmetic on time.time(): a wall-"
                    "clock jump (NTP step, suspend) corrupts the "
                    "timeout — use time.monotonic()")

    # -- VL007 --------------------------------------------------------------
    @staticmethod
    def _is_monotonic_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = _dotted(node.func)
        return name is not None and (
            name in ("time.monotonic", "time.perf_counter") or
            name.endswith((".monotonic", ".perf_counter")))

    def _check_inline_latency(self, call: ast.Call) -> None:
        """A ``monotonic()/perf_counter()`` subtraction inlined
        straight into a call argument is ad-hoc latency accounting.
        Only the ``now - past`` shape is flagged — ``deadline -
        monotonic()`` (remaining time) and hoisted assignments stay
        legal."""
        if self._obs_exempt:
            return
        operands = list(call.args) + [kw.value for kw in call.keywords]
        for arg in operands:
            if isinstance(arg, ast.BinOp) and \
                    isinstance(arg.op, ast.Sub) and \
                    self._is_monotonic_call(arg.left):
                self._flag(
                    "VL007", arg,
                    "monotonic-clock subtraction inlined into a call "
                    "argument: latency accounting belongs to "
                    "veles_tpu_torch.obs (trace.elapsed_s(t0) or a "
                    "span), so the tracing plane sees what the "
                    "metrics plane sees")

    # -- driver --------------------------------------------------------------
    def run(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.For, ast.While)):
                self._check_capture_in_loop(node)
            elif isinstance(node, ast.Call):
                self._check_thread(node)
                self._check_inline_latency(node)
            elif isinstance(node, ast.With):
                self._check_lock_io(node)
            elif isinstance(node, ast.Try):
                self._check_bare_except(node)
            elif isinstance(node, (ast.BinOp, ast.Compare)):
                self._check_wallclock_deadline(node)
        return self.findings


def lint_sources(sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Lint ``(path, source)`` pairs as one closed unit: VL002-VL007 per
    file, VL001 over their capture surface."""
    findings: List[Finding] = []
    for path, source in sources:
        findings.extend(_Linter(path, source).run())
    index = PackageIndex.from_sources(sources)
    for fn in index.capture_surface():
        check_host_syncs(fn, findings)
    seen: Set[Tuple[str, str, int, int]] = set()
    unique = []
    for finding in findings:
        key = (finding.rule, finding.path, finding.line, finding.col)
        if key not in seen:
            seen.add(key)
            unique.append(finding)
    lines = {path: source.splitlines() for path, source in sources}
    kept = apply_noqa(lambda p: lines.get(p, []), unique)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; returns unsuppressed findings."""
    return lint_sources([(path, source)])


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fin:
        return lint_source(fin.read(), path)


def iter_package_files(package_dir: Optional[str] = None):
    """Every .py file of the veles_tpu_torch package (skips
    __pycache__)."""
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d != "__pycache__" and
                       not d.endswith(".egg-info")]
        for filename in sorted(filenames):
            if filename.endswith(".py"):
                yield os.path.join(dirpath, filename)


def read_package(package_dir: Optional[str] = None,
                 code: str = "VL000"
                 ) -> Tuple[List[Tuple[str, str]], List[Finding]]:
    """``(path, source)`` of every package file, and a finding per file
    that would not read or parse."""
    sources: List[Tuple[str, str]] = []
    findings: List[Finding] = []
    for path in iter_package_files(package_dir):
        try:
            with open(path, "r", encoding="utf-8") as fin:
                source = fin.read()
            ast.parse(source, filename=path)
        except (OSError, SyntaxError) as exc:
            findings.append(Finding(
                code, path, getattr(exc, "lineno", None) or 1, 0,
                "unreadable: %s" % exc))
            continue
        sources.append((path, source))
    return sources, findings


def lint_package(package_dir: Optional[str] = None) -> List[Finding]:
    """Lint the whole package; paths in findings are absolute."""
    sources, findings = read_package(package_dir, "VL000")
    return findings + lint_sources(sources)


def count_by_file_rule(findings: Sequence[Finding],
                       relative_to: Optional[str] = None
                       ) -> Dict[Tuple[str, str], int]:
    """{(relpath, rule): count} — the baseline comparison unit (line
    numbers drift too much to key a baseline on)."""
    counts: Dict[Tuple[str, str], int] = {}
    for finding in findings:
        path = finding.path
        if relative_to:
            try:
                path = os.path.relpath(path, relative_to)
            except ValueError:
                pass
        key = (path.replace(os.sep, "/"), finding.rule)
        counts[key] = counts.get(key, 0) + 1
    return counts


def repo_root() -> str:
    """The checkout holding the package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def baselines_dir() -> str:
    """Where the port's gate baselines live."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baselines")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from veles_tpu_torch.analysis.baseline import gate_counts
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis.lint",
        description="veles_tpu_torch lint (VL001-VL007)")
    parser.add_argument("files", nargs="*",
                        help="explicit files linted as one unit "
                             "(strict: any finding fails)")
    parser.add_argument("--baseline", default=os.path.join(
        baselines_dir(), "lint_baseline.json"))
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    args = parser.parse_args(argv)
    if args.files:
        sources = []
        for path in args.files:
            with open(path, "r", encoding="utf-8") as fin:
                sources.append((path, fin.read()))
        findings = lint_sources(sources)
        for finding in findings:
            print(finding)
        print("veles_lint: %d finding(s) in %d file(s)"
              % (len(findings), len(args.files)))
        return 1 if findings else 0
    findings = lint_package()
    for finding in findings:
        print(finding)
    return gate_counts("veles_lint",
                       count_by_file_rule(findings,
                                          relative_to=repo_root()),
                       args.baseline, no_baseline=args.no_baseline,
                       update=args.update_baseline)


if __name__ == "__main__":
    raise SystemExit(main())
