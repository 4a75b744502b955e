"""Device-memory plan: live-range accounting + residency rules (port of
``veles_tpu/analysis/memplan.py``, which plans HBM over jaxprs; this one
plans ``torch.cuda`` memory over aten dispatch graphs).

Paged oversubscription, sharded serving and per-replica weight budgets
are all plays on device *bytes*, yet the locks (VC), the capture
contracts (VJ) and the graph shape (golden graphs) never measure bytes:
a change that doubles a decode round's peak passes every CPU test and
only surfaces as an out-of-memory on the card. This pass measures
bytes, two ways.

**Dynamic half — the golden-footprint gate.** Every steady-state
computation the AOT plane enumerates (``veles_tpu_torch.aot.registry``)
runs once on the CPU at its canonical config, the kernels' plain
versions standing in, under a :class:`MemTrace` (a
``TorchDispatchMode``), and its ops are linear-scanned with
free-at-last-use live-range accounting:

- the computation starts with its RESIDENT set live: every tensor its
  owner holds (the engine's or trainer's params, weights, caches and
  state, found by walking the callable's object), plus any older
  tensor it reads;
- an op whose schema returns a fresh tensor allocates it (its
  storage's bytes); views and in-place ops allocate nothing. An
  in-place write into a resident tensor is the port's counterpart of
  ``donate_argnums`` (the state is updated where it lives), counted as
  ``donated_mb``;
- a fresh buffer frees after its last use, unless it outlives the call
  (an output, or state the call stored): those join the resident set;
- each kernel's workspace that its plain version does not allocate
  (``ops.flash_attention.kernel_workspace``: K4/K5's split partials,
  K2/K3's ``di``) is added at the op where the wrapper ran, declared
  beside the wrapper (``ops.launches.note_workspace``).

The result — ``{peak_mb, resident_mb, donated_mb, peak_src,
top_buffers}`` per computation — is committed to
``analysis/baselines/memplan_baseline.json``, one set a torch release.
Peak rising more than :data:`PEAK_TOLERANCE` fails the gate naming the
computation and the buffers that grew, and so does a declared donation
(``Computation.donation``) that the site does not update in place;
``--update-baseline`` REQUIRES ``--reason``. ``VELES_MEMPLAN_DRIFT=grow``
seeds a 16 MiB co-resident ballast into the first registry entry so a
subprocess test proves the gate trips.

:func:`plan_round` plans a live engine's own decode round at its
geometry without touching device memory: the engine's tensors are
shadowed by ``meta`` tensors of the same shapes, strides and storage
sharing, and the round runs on them (``PagedGenerativeEngine.
plan_footprint``). Known approximations (deliberate): frees happen at
last use, not at the last Python reference (eager PyTorch frees later,
a captured graph's pool reuses as planned); the caching allocator's
rounding and fragmentation are not modelled; a captured round replays
out of its graph's private pool, so on the card its "measured" figure
is the resident set plus the pool, across the capture.

**Static half — the VM residency rules** (AST over the package,
baseline-gated through ``analysis/baseline.py`` like VL/VC/VJ):

=======  ============================================================
VM001    a state update that REBINDS ``self.X`` to a tensor computed
         from ``self.X`` outside the constructor: the old tensor stays
         referenced until the assignment completes (two copies at
         peak), and a captured graph keeps reading the old address —
         update it in place (``copy_``, ``add_``)
VM002    a large (>= 1 MiB, statically sized) tensor created inside a
         capture root: each bucket's graph pool holds its own copy
VM003    ``.cpu()``/``.numpy()``/``.tolist()`` of a dispatch result
         inside a per-step loop (a sync an iteration), or a pulled
         host value uploaded again (a device->host->device round
         trip); the single pull at a dispatch's tail is fine
VM004    a device allocation (``torch.zeros``/``torch.tensor``/
         ``torch.as_tensor`` ... on a device) inside a loop that
         dispatches, or ``torch.as_tensor(self.X, device=...)``
         re-uploading persistent host state on every dispatch
=======  ============================================================

A dispatch is a graph replay (``.replay(...)``) or an engine's device
call (``self._dev(...)``, ``self._device_*``, ``self._run_round``), made
from host code (outside the capture surface, whose own calls are the
graph). Suppress one finding with ``# noqa: VM004``.

CLI::

    python -m veles_tpu_torch.analysis.memplan             # both gates
    python -m veles_tpu_torch.analysis.memplan FILE...     # static, strict
    python -m veles_tpu_torch.analysis.memplan --update-baseline \\
        --reason "why the footprints changed"
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, \
    Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from veles_tpu_torch.analysis.jaxpr_audit import (DispatchTrace,
                                                  load_baseline,
                                                  save_golden,
                                                  torch_release)
from veles_tpu_torch.analysis.lint import (Finding, Function, Module,
                                           PackageIndex, _dotted,
                                           _flag_into, _self_attr,
                                           apply_noqa, baselines_dir,
                                           count_by_file_rule,
                                           is_tensor_expr, read_package,
                                           repo_root, tensor_names)

RULES: Dict[str, str] = {
    "VM001": "state update rebinds a tensor it should update in place",
    "VM002": "large tensor created inside a capture root (one copy per "
             "graph pool)",
    "VM003": "device->host pull in a steady-state dispatch path",
    "VM004": "device allocation inside a per-step dispatch loop / "
             "persistent state re-uploaded per dispatch",
}

MIB = 1024 * 1024

#: VM002 floor
LARGE_CONST_BYTES = MIB

#: the golden-footprint gate's peak growth allowance
PEAK_TOLERANCE = 0.05

_CTOR_METHODS = {"__init__", "init_unpickled", "__post_init__"}

#: statically resolvable dtype sizes (itemsize by final attr name)
_DTYPE_BYTES = {
    "float64": 8, "double": 8, "int64": 8, "long": 8, "complex128": 16,
    "complex64": 8, "float32": 4, "float": 4, "int32": 4, "int": 4,
    "uint32": 4, "float16": 2, "half": 2, "bfloat16": 2, "int16": 2,
    "uint16": 2, "int8": 1, "uint8": 1, "bool": 1,
}

#: torch constructors that allocate on a device (VM002/VM004)
_TORCH_CTORS = frozenset({
    "zeros", "ones", "full", "empty", "arange", "eye", "rand", "randn",
    "randint", "tensor", "as_tensor", "zeros_like", "ones_like",
    "full_like", "empty_like"})
#: host -> device uploads (VM003/VM004)
_UPLOADS = frozenset({"tensor", "as_tensor", "from_numpy"})
#: tensor methods that pull to the host (VM003)
_PULLS = frozenset({"cpu", "numpy", "tolist", "item"})


# ===========================================================================
# static half: the VM rules
# ===========================================================================

def _fold_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = _fold_int(node.left), _fold_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.LShift):
            return left << right
        if isinstance(node.op, ast.Pow):
            return left ** right
    return None


def _static_elems(args: Sequence[ast.AST]) -> Optional[int]:
    """Element count of a literal shape: ``(a, b)`` / ``[a, b]`` or the
    ints themselves (``torch.zeros(a, b)``)."""
    if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
        args = args[0].elts
    n = 1
    for arg in args:
        dim = _fold_int(arg)
        if dim is None:
            return None
        n *= dim
    return n if args else None


def _static_alloc_bytes(call: ast.Call) -> Optional[int]:
    """Bytes of a ``torch.zeros/ones/empty/full/rand*`` call with a
    literal shape (default dtype f32), else None."""
    name = _dotted(call.func) or ""
    base, _, attr = name.rpartition(".")
    if base != "torch" or attr not in ("zeros", "ones", "empty", "full",
                                       "rand", "randn"):
        return None
    args = call.args[:1] if attr == "full" else call.args
    elems = _static_elems(args)
    if elems is None:
        return None
    item = 4
    for kw in call.keywords:
        if kw.arg == "dtype":
            leaf = (_dotted(kw.value) or "").rpartition(".")[2]
            item = _DTYPE_BYTES.get(leaf, 4)
    return elems * item


def _has_device(call: ast.Call) -> bool:
    return any(kw.arg == "device" for kw in call.keywords)


def _torch_attr(call: ast.Call) -> Optional[str]:
    name = _dotted(call.func) or ""
    base, _, attr = name.rpartition(".")
    return attr if base == "torch" else None


class _MemLinter:
    """The VM001-VM004 scan over one module of an indexed package."""

    def __init__(self, index: PackageIndex, mod: Module,
                 surface: Dict[Function, Module]) -> None:
        self.index = index
        self.mod = mod
        self.surface = surface
        self.findings: List[Finding] = []

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        _flag_into(self.findings, rule, self.mod.path, node, message)

    def _functions(self) -> List[Function]:
        return list(self.mod.functions.values()) + \
            list(self.mod.methods.values())

    def _is_dispatch(self, fn: Function, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "replay":
            return True
        attr = _self_attr(func)
        return attr is not None and (attr == "_dev" or attr.startswith(
            ("_device_", "_run_")))

    # -- VM001 -------------------------------------------------------------
    def _check_rebind(self) -> None:
        for (cls, name), fn in self.mod.methods.items():
            if name in _CTOR_METHODS:
                continue
            names = tensor_names(fn.node)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                written = {_self_attr(t) for t in node.targets} - {None}
                if not written:
                    continue
                read = {_self_attr(n) for n in ast.walk(node.value)
                        if isinstance(n, ast.Attribute) and
                        isinstance(n.ctx, ast.Load)} - {None}
                rebound = sorted(written & read)
                if not rebound:
                    continue
                value = node.value
                dispatch = isinstance(value, ast.Call) and \
                    self._is_dispatch(fn, value)
                if not (dispatch or is_tensor_expr(value, names)):
                    continue
                self._flag("VM001", node,
                           "self.%s is rebound to a tensor computed from "
                           "itself in %s.%s: the old tensor stays live "
                           "until the assignment completes and a "
                           "captured graph keeps its address — update it "
                           "in place (copy_/add_)"
                           % ("/self.".join(rebound), cls, name))

    # -- VM002 -------------------------------------------------------------
    def _check_large_in_capture(self) -> None:
        for fn in self._functions():
            if fn not in self.surface:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                nbytes = _static_alloc_bytes(node)
                if nbytes is not None and nbytes >= LARGE_CONST_BYTES:
                    self._flag("VM002", node,
                               "%.1f MiB tensor created inside capture "
                               "root %s: every graph capturing it keeps "
                               "its own copy in its pool — allocate it "
                               "once outside and pass it in"
                               % (nbytes / MIB, fn.qualname))

    # -- VM003 / VM004 -----------------------------------------------------
    def _check_dispatch_paths(self) -> None:
        for fn in self._functions():
            if fn in self.surface:
                # a captured body: its calls are the graph, replayed as
                # one launch, not host-side dispatches
                continue
            dispatches = [n for n in ast.walk(fn.node)
                          if isinstance(n, ast.Call) and
                          self._is_dispatch(fn, n)]
            if not dispatches:
                continue
            dispatch_ids = set(map(id, dispatches))
            device_names: Set[str] = set()
            host_names: Set[str] = set()
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Assign) and
                        isinstance(node.value, ast.Call)):
                    continue
                targets: Set[str] = set()
                for target in node.targets:
                    targets |= {n.id for n in ast.walk(target)
                                if isinstance(n, ast.Name)}
                if id(node.value) in dispatch_ids:
                    device_names |= targets
                elif self._pulls_device(node.value, device_names):
                    host_names |= targets
            loops = [n for n in ast.walk(fn.node)
                     if isinstance(n, (ast.For, ast.While))]
            for loop in loops:
                loop_nodes = list(ast.walk(loop))
                if not any(id(n) in dispatch_ids for n in loop_nodes):
                    continue
                for node in loop_nodes:
                    if not isinstance(node, ast.Call) or \
                            id(node) in dispatch_ids:
                        continue
                    if self._pulls_device(node, device_names):
                        self._flag("VM003", node,
                                   "device->host pull of a dispatch "
                                   "result inside the per-step loop of "
                                   "%s — a sync per iteration; pull once "
                                   "after the loop" % fn.qualname)
                    elif _torch_attr(node) in _TORCH_CTORS and \
                            _has_device(node):
                        self._flag("VM004", node,
                                   "device allocation inside the per-"
                                   "step dispatch loop of %s — hoist it "
                                   "(or keep the buffer resident across "
                                   "steps)" % fn.qualname)
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                upload = _torch_attr(node) in _UPLOADS
                arg = node.args[0]
                if upload and isinstance(arg, ast.Name) and \
                        arg.id in host_names:
                    self._flag("VM003", node,
                               "%r was pulled to the host from a dispatch "
                               "result in %s and is uploaded again — keep "
                               "it on the device end to end"
                               % (arg.id, fn.qualname))
                elif upload and _has_device(node) and \
                        _self_attr(arg) is not None:
                    self._flag("VM004", node,
                               "persistent state self.%s re-uploaded on "
                               "every dispatch of %s — keep a device "
                               "mirror and rewrite it in place where the "
                               "host copy changes"
                               % (_self_attr(arg), fn.qualname))

    @staticmethod
    def _pulls_device(call: ast.Call, device_names: Set[str]) -> bool:
        func = call.func
        if not (isinstance(func, ast.Attribute) and func.attr in _PULLS):
            return False
        return any(isinstance(n, ast.Name) and n.id in device_names
                   for n in ast.walk(func.value))

    def run(self) -> List[Finding]:
        self._check_rebind()
        self._check_large_in_capture()
        self._check_dispatch_paths()
        return self.findings


def check_sources(sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """VM-rule scan of ``(path, source)`` pairs as one closed unit."""
    index = PackageIndex.from_sources(sources)
    surface = index.capture_surface()
    findings: List[Finding] = []
    for mod in index.modules.values():
        findings.extend(_MemLinter(index, mod, surface).run())

    def lines_of(path: str) -> List[str]:
        mod = index.by_path.get(path)
        return mod.lines if mod is not None else []

    kept = apply_noqa(lines_of, findings)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def check_source(source: str, path: str = "<string>") -> List[Finding]:
    """VM-rule scan of one source string (unsuppressed findings)."""
    return check_sources([(path, source)])


def check_package(package_dir: Optional[str] = None) -> List[Finding]:
    """VM-rule scan of the whole package; paths are absolute."""
    sources, findings = read_package(package_dir, "VM000")
    return findings + check_sources(sources)


# ===========================================================================
# dynamic half: live ranges over dispatched ops
# ===========================================================================

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


def _fmt(t: torch.Tensor) -> Tuple[str, str]:
    shape = "x".join(str(int(d)) for d in t.shape) or "scalar"
    return shape, str(t.dtype).replace("torch.", "")


def held_tensors(roots: Dict[str, Any], max_depth: int = 6
                 ) -> Dict[int, Tuple[str, torch.Tensor]]:
    """Every tensor reachable from ``roots`` (name -> object) through
    dicts, lists, tuples, the ``__dict__`` of the port's own objects,
    bound methods and closures: storage key -> (path label,
    one tensor on it). Parameters' ``.grad`` count too."""
    out: Dict[int, Tuple[str, torch.Tensor]] = {}
    seen: Set[int] = set()

    def visit(obj: Any, label: str, depth: int) -> None:
        if depth > max_depth or obj is None or id(obj) in seen:
            return
        if isinstance(obj, torch.Tensor):
            seen.add(id(obj))
            out.setdefault(_storage_key(obj), (label, obj))
            if obj.grad is not None:
                visit(obj.grad, label + ".grad", depth + 1)
            return
        if isinstance(obj, (str, bytes, int, float, bool, type,
                            types.ModuleType)):
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            for key, value in list(obj.items()):
                visit(value, "%s.%s" % (label, key) if label else str(key),
                      depth + 1)
        elif isinstance(obj, (list, tuple)):
            for i, value in enumerate(obj):
                visit(value, "%s.%d" % (label, i) if label else str(i),
                      depth + 1)
        elif isinstance(obj, types.MethodType):
            visit(obj.__self__, label, depth)
        elif isinstance(obj, types.FunctionType):
            for name, cell in zip(obj.__code__.co_freevars,
                                  obj.__closure__ or ()):
                try:
                    value = cell.cell_contents
                except ValueError:
                    continue
                visit(value, "%s.%s" % (label, name) if label else name,
                      depth + 1)
        elif type(obj).__module__.startswith("veles_tpu_torch") and \
                hasattr(obj, "__dict__"):
            for key, value in list(vars(obj).items()):
                visit(value, "%s.%s" % (label, key) if label else key,
                      depth + 1)

    for name, obj in roots.items():
        visit(obj, name, 0)
    return out


class MemTrace(DispatchTrace):
    """A :class:`DispatchTrace` that also records, per op, the buffers
    it allocates, reads and writes in place, and the kernel workspace
    the wrappers declare (``ops.launches.note_workspace``)."""

    def __init__(self, resident: Dict[int, Tuple[str, torch.Tensor]]
                 ) -> None:
        super().__init__()
        #: buffer id -> [nbytes, label, shape, dtype]
        self.buffers: List[List[Any]] = []
        #: storage key -> buffer id (fresh buffers remap a reused key)
        self.by_key: Dict[int, int] = {}
        self.pre: Set[int] = set()
        self.alloc_at: Dict[int, int] = {}
        self.last_use: Dict[int, int] = {}
        self.written: Set[int] = set()
        self.refs: Dict[int, StorageWeakRef] = {}
        #: op index -> the kernel workspace declared there
        self.workspace: Dict[int, int] = {}
        for key, (label, t) in resident.items():
            self._pre_buffer(key, label, t)

    def _pre_buffer(self, key: int, label: str, t: torch.Tensor) -> int:
        b = len(self.buffers)
        shape, dtype = _fmt(t)
        self.buffers.append([_storage_bytes(t), label, shape, dtype])
        self.by_key[key] = b
        self.pre.add(b)
        return b

    def _buffer(self, t: torch.Tensor) -> int:
        key = _storage_key(t)
        b = self.by_key.get(key)
        if b is None:
            b = self._pre_buffer(key, "input", t)
        return b

    def note_workspace(self, name: str, nbytes: int) -> None:
        i = len(self.ops)
        self.workspace[i] = self.workspace.get(i, 0) + nbytes

    def on_op(self, func, args, kwargs, inputs, out, outputs) -> None:
        i = len(self.ops) - 1
        for t in inputs:
            self.last_use[self._buffer(t)] = i
        schema = func._schema
        for arg in schema.arguments:
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            value = kwargs.get(arg.name) if arg.name in kwargs else None
            if value is None:
                pos = [a.name for a in schema.arguments].index(arg.name)
                value = args[pos] if pos < len(args) else None
            for t in ([value] if isinstance(value, torch.Tensor)
                      else [x for x in (value or ())
                            if isinstance(x, torch.Tensor)]
                      if isinstance(value, (list, tuple)) else []):
                self.written.add(self._buffer(t))
        # an op can only alias its inputs: an output on a storage none
        # of them holds is a fresh allocation (``to``/``reshape``/
        # ``contiguous`` return one or the other whatever the schema
        # says)
        input_keys = {_storage_key(x) for x in inputs}
        for t in outputs:
            key = _storage_key(t)
            if key in input_keys:
                self.last_use[self.by_key[key]] = i
                continue
            b = len(self.buffers)
            shape, dtype = _fmt(t)
            self.buffers.append([_storage_bytes(t), "op[%d]:%s"
                                 % (i, self.ops[-1]), shape, dtype])
            self.by_key[key] = b
            self.alloc_at[b] = i
            self.last_use[b] = i
            self.refs[b] = StorageWeakRef(t.untyped_storage())

    def footprint(self) -> Dict[str, Any]:
        """The plan, after the traced call returned."""
        survivors = {b for b, ref in self.refs.items() if not ref.expired()}
        frees: Dict[int, List[int]] = {}
        for b, at in self.alloc_at.items():
            if b in survivors:
                continue
            frees.setdefault(max(at, self.last_use.get(b, at)),
                             []).append(b)
        allocs: Dict[int, List[int]] = {}
        for b, at in self.alloc_at.items():
            allocs.setdefault(at, []).append(b)
        size = [buf[0] for buf in self.buffers]
        live = sum(size[b] for b in self.pre)
        peak, peak_src = live, "resident"
        for i, name in enumerate(self.ops):
            live += sum(size[b] for b in allocs.get(i, ()))
            bump = self.workspace.get(i, 0)
            if live + bump > peak:
                peak = live + bump
                peak_src = "op[%d]:%s" % (i, name)
            for b in frees.get(i, ()):
                live -= size[b]
        resident = sum(size[b] for b in self.pre) + \
            sum(size[b] for b in survivors)
        donated = sum(size[b] for b in self.pre if b in self.written)
        top = sorted(range(len(self.buffers)), key=lambda b: -size[b])[:5]
        return {
            "peak_mb": round(peak / MIB, 3),
            "resident_mb": round(resident / MIB, 3),
            "donated_mb": round(donated / MIB, 3),
            "peak_bytes": int(peak),
            "resident_bytes": int(resident),
            "donated_bytes": int(donated),
            "workspace_bytes": int(sum(self.workspace.values())),
            "peak_src": peak_src,
            "written": sorted(self.buffers[b][1] for b in self.pre
                              if b in self.written),
            "top_buffers": [
                {"mb": round(size[b] / MIB, 3), "src": self.buffers[b][1],
                 "shape": self.buffers[b][2], "dtype": self.buffers[b][3]}
                for b in top],
        }


def estimate_callable(fn: Callable, args: Sequence[Any] = (),
                      roots: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The plan of one call ``fn(*args)``: its resident set is every
    tensor ``fn``'s object (bound instance, closure) and ``args`` hold,
    or what ``roots`` (name -> object) hold. Runs the call on the
    tensors it is given: hand it CPU or ``meta`` tensors (see
    :func:`shadow`) to keep the device untouched."""
    from veles_tpu_torch.ops import launches
    if roots is None:
        roots = {"": fn, "args": list(args)}
    trace = MemTrace(held_tensors(roots))
    with launches.workspace_listener(trace.note_workspace), trace:
        result = fn(*args)
    # what the call returns is the caller's: it stays resident
    return trace.footprint()


# -- meta shadows -------------------------------------------------------------

def _meta_like(t: torch.Tensor,
               storages: Dict[int, Any]) -> torch.Tensor:
    key = _storage_key(t)
    st = storages.get(key)
    if st is None:
        st = torch.empty(_storage_bytes(t), dtype=torch.uint8,
                         device="meta").untyped_storage()
        storages[key] = st
    return torch.empty(0, dtype=t.dtype, device="meta").set_(
        st, t.storage_offset(), t.shape, t.stride())


def _shadow_value(value: Any, storages: Dict[int, Any]) -> Any:
    if isinstance(value, torch.Tensor):
        return _meta_like(value, storages)
    if isinstance(value, dict):
        return {k: _shadow_value(v, storages) for k, v in value.items()}
    if isinstance(value, list):
        return [_shadow_value(v, storages) for v in value]
    if isinstance(value, tuple):
        return tuple(_shadow_value(v, storages) for v in value)
    return value


def shadow(obj: Any) -> Any:
    """A shallow copy of ``obj`` whose tensor attributes (in dicts,
    lists and tuples too) are ``meta`` tensors of the same shapes,
    strides, dtypes and storage sharing: running a method of it touches
    no device memory, and a meta storage has its original's bytes."""
    twin = copy.copy(obj)
    storages: Dict[int, Any] = {}
    for key, value in list(vars(obj).items()):
        setattr(twin, key, _shadow_value(value, storages))
    return twin


class _PlanAxis:
    """A mesh axis of one rank: the collectives are the identity."""

    size = 1
    index = 0


class _PlanServe:
    """A ``ServeContext`` whose collectives are identities: a rank's
    round planned over its own shards."""

    tensor = False
    expert = False

    def __init__(self) -> None:
        self.model = self.seq = self.tokens = _PlanAxis()


def plan_round(engine, sampling: bool = False) -> Dict[str, Any]:
    """The plan of ``engine``'s decode round (a paged or slab
    generative engine) at its own geometry, touching no device memory:
    the round body runs on a :func:`shadow` of the engine, the kernels'
    plain versions standing in (with their declared workspace). On a
    mesh the rank plans its own shards (its collectives become
    identities: an all-reduce is in place)."""
    twin = shadow(engine)
    if getattr(engine, "_serve", None) is not None:
        twin._serve = _PlanServe()
    body = (lambda: twin._round_fn(sampling)) \
        if hasattr(twin, "_round_fn") else twin._decode_fn
    with torch.inference_mode():
        return estimate_callable(body, (), roots={"": twin})


# -- what the card measures ------------------------------------------------------

def cublas_workspace_bytes() -> int:
    """The bytes cuBLAS takes from PyTorch's caching allocator for each
    (handle, stream) pair it runs on, as PyTorch sizes it:
    ``CUBLAS_WORKSPACE_CONFIG`` (``:KIB:COUNT`` pairs), else 4096 KiB x
    8 on Hopper and later, 4096 KiB x 2 + 16 KiB x 8 before."""
    import re
    config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if not config:
        major = torch.cuda.get_device_capability()[0] \
            if torch.cuda.is_available() else 0
        config = ":4096:8" if major >= 9 else ":4096:2:16:8"
    pairs = re.findall(r":(\d+):(\d+)", config)
    return sum(int(kib) * int(n) for kib, n in pairs) * 1024


def _active_blocks() -> Set[Tuple[int, int]]:
    return {(block["address"], block["size"])
            for segment in torch.cuda.memory_snapshot()
            for block in segment["blocks"]
            if block["state"] == "active_allocated"}


def measure_call(fn: Callable, args: Sequence[Any] = (),
                 base: Optional[int] = None) -> Dict[str, int]:
    """One call ``fn(*args)`` on the card: its peak and what stays
    allocated after it, in bytes above ``base`` (``torch.cuda.
    memory_allocated()`` before the call's owner was built; now when
    None). A captured entry's first call is its warm-up and capture, so
    its figures are the resident set plus the graph's pool. cuBLAS takes
    a workspace (:func:`cublas_workspace_bytes`) for every new (handle,
    stream) pair it runs on — a capture's side and capture streams, the
    autograd thread's handle — which stays allocated and which no plan
    of the computation holds: the new blocks of exactly that size are
    counted (``workspaces``) and ``*_net`` leaves them out."""
    torch.cuda.synchronize()
    if base is None:
        base = torch.cuda.memory_allocated()
    blocks = _active_blocks()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    after = torch.cuda.memory_allocated() - base
    ws = cublas_workspace_bytes()
    n = sum(1 for _, size in _active_blocks() - blocks if size == ws)
    return {"peak": peak, "after": after, "workspaces": n,
            "workspace_bytes": n * ws, "peak_net": peak - n * ws,
            "after_net": after - n * ws}


# -- the registry ---------------------------------------------------------------

def _seeded_growth(fn: Callable) -> Callable:
    """VELES_MEMPLAN_DRIFT test hook: a 16 MiB ballast live across the
    whole call — a deliberate >5% peak rise on any small computation."""
    def wrapped(*args):
        ballast = torch.zeros(4 * MIB)                     # 16 MiB
        out = fn(*args)
        ballast.add_(0)
        return out
    return wrapped


def donation_matches(name: str, labels: Sequence[str]) -> List[str]:
    """The written-in-place labels a declared donation name covers: a
    label component (leading underscores stripped) equal to it."""
    return [label for label in labels
            if name in [part.lstrip("_") for part in label.split(".")]]


def plan_all(drift: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Plan every registry computation on the CPU (the first entry gets
    the seeded ballast when ``drift`` is set)."""
    from veles_tpu_torch.aot.registry import canonical_computations
    out: Dict[str, Dict[str, Any]] = {}
    for i, comp in enumerate(canonical_computations()):
        torch.manual_seed(0)
        fn, args = comp.build("cpu")
        roots = {"": fn, "args": list(args)}
        if drift and i == 0:
            fn = _seeded_growth(fn)
        plan = estimate_callable(fn, args, roots=roots)
        plan["donation"] = list(comp.donation)
        plan["captured"] = comp.captured
        out[comp.name] = plan
    return out


def check_donations(plans: Dict[str, Dict[str, Any]]) -> List[str]:
    """Declared donations that their site does not update in place."""
    failures = []
    for name, plan in sorted(plans.items()):
        for donated in plan.get("donation", ()):
            if not donation_matches(donated, plan["written"]):
                failures.append(
                    "%s: declared donation %r is not updated in place "
                    "(written in place: %s)"
                    % (name, donated, ", ".join(plan["written"]) or
                       "nothing"))
    return failures


# -- footprint baseline I/O ---------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(baselines_dir(), "memplan_baseline.json")


def default_static_baseline_path() -> str:
    return os.path.join(baselines_dir(), "memplan_static_baseline.json")


def load_footprint_baseline(path: str) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
    """(this torch release's computations, full doc)."""
    return load_baseline(path)


def save_footprint_baseline(path: str, plans: Dict[str, Dict[str, Any]],
                            reason: str, previous: Dict[str, Any]) -> None:
    entries = {name: {key: plan[key] for key in
                      ("peak_mb", "resident_mb", "donated_mb", "peak_src",
                       "top_buffers")}
               for name, plan in sorted(plans.items())}
    save_golden(path, "computations", entries, reason, previous,
                "golden device-memory footprints per steady-state "
                "computation (veles_tpu_torch.aot.registry), from "
                "analysis/memplan live-range accounting, one set a torch "
                "release; regenerate with --update-baseline --reason "
                "'...'")


def compare_footprints(current: Dict[str, Dict[str, Any]],
                       baseline: Dict[str, Dict[str, Any]],
                       tolerance: float = PEAK_TOLERANCE) -> List[str]:
    """Gate failures: new/vanished computations and peaks above the
    per-entry allowance, naming the buffers that grew."""
    failures: List[str] = []
    for name in sorted(set(current) | set(baseline)):
        cur, base = current.get(name), baseline.get(name)
        if base is None:
            failures.append(
                "%s: NEW computation (no golden footprint) — record it "
                "with --update-baseline --reason" % name)
            continue
        if cur is None:
            failures.append(
                "%s: computation VANISHED from the registry — re-record "
                "with --update-baseline --reason" % name)
            continue
        if cur["peak_mb"] <= base["peak_mb"] * (1.0 + tolerance):
            continue
        base_bufs = base.get("top_buffers", [])

        def _covered(buf):
            return any(b["shape"] == buf["shape"] and
                       b["dtype"] == buf["dtype"] and
                       buf["mb"] <= b["mb"] * (1.0 + tolerance)
                       for b in base_bufs)

        grew = [b for b in cur.get("top_buffers", []) if not _covered(b)]
        detail = "; ".join(
            "%s %s[%s] %.3f MB" % (b["src"], b["dtype"], b["shape"],
                                   b["mb"]) for b in grew) or \
            "(no single top-5 buffer grew — aggregate live-range growth)"
        failures.append(
            "%s: peak %.3f MB > golden %.3f MB (+%.1f%%, allowance "
            "+%.0f%%, at %s) — grown buffers: %s"
            % (name, cur["peak_mb"], base["peak_mb"],
               (cur["peak_mb"] / base["peak_mb"] - 1.0) * 100.0
               if base["peak_mb"] else float("inf"),
               tolerance * 100.0, cur.get("peak_src", "?"), detail))
    return failures


def run_footprint_gate(baseline_path: Optional[str] = None,
                       update: bool = False, reason: Optional[str] = None,
                       drift: Optional[str] = None) -> Tuple[int, int]:
    """(exit status, finding count) — the golden-footprint gate."""
    path = baseline_path or default_baseline_path()
    if update and not reason:
        print("memplan: --update-baseline requires --reason: the golden "
              "footprints only change deliberately — say why")
        return 1, 0
    plans = plan_all(drift=drift)
    failures = check_donations(plans)
    if update:
        if failures:
            for line in failures:
                print("memplan: %s" % line)
            print("memplan: FAIL — a declared donation is fixed in the "
                  "registry or the site, never baselined")
            return 1, len(failures)
        _, previous = load_footprint_baseline(path)
        save_footprint_baseline(path, plans, reason, previous)
        print("memplan: baseline updated (%d computations, torch %s) -> "
              "%s" % (len(plans), torch_release(), path))
        print("memplan: justification recorded: %s" % reason)
        return 0, 0
    baseline, doc = load_footprint_baseline(path)
    if not baseline:
        failures.append(
            "no golden footprints for torch %s in %s (releases: %s) — "
            "record them with --update-baseline --reason"
            % (torch_release(), path,
               ", ".join(sorted(doc.get("torch", {}))) or "none"))
    else:
        failures += compare_footprints(plans, baseline)
    for line in failures:
        print("memplan: %s" % line)
    if failures:
        print("memplan: FAIL — %d finding(s)" % len(failures))
        return 1, len(failures)
    print("memplan: PASS (%d computation(s) within the golden footprint "
          "of torch %s)" % (len(plans), torch_release()))
    return 0, 0


# -- CLI ------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis.memplan",
        description="device-memory plan: VM residency rules + the "
                    "golden-footprint gate")
    parser.add_argument("files", nargs="*",
                        help="check specific files (strict: any VM "
                             "finding fails; no baselines)")
    parser.add_argument("--static-only", action="store_true",
                        help="skip the footprint gate")
    parser.add_argument("--footprint-only", action="store_true",
                        help="skip the VM static rules")
    parser.add_argument("--baseline", default=default_baseline_path(),
                        help="footprint baseline JSON")
    parser.add_argument("--static-baseline",
                        default=default_static_baseline_path(),
                        help="VM-rule count baseline JSON")
    parser.add_argument("--no-baseline", action="store_true",
                        help="strict static mode: ignore the count "
                             "baseline")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--reason",
                        help="justification recorded with "
                             "--update-baseline (required for the "
                             "footprint baseline)")
    args = parser.parse_args(argv)

    if args.files:
        sources = []
        for path in args.files:
            with open(path, "r", encoding="utf-8") as fin:
                sources.append((path, fin.read()))
        findings = check_sources(sources)
        for finding in findings:
            print(finding)
        return 1 if findings else 0

    status = 0
    if not args.footprint_only:
        from veles_tpu_torch.analysis.baseline import gate_counts
        findings = check_package()
        for finding in findings:
            print("memplan: %s" % finding)
        status = max(status, gate_counts(
            "memplan", count_by_file_rule(findings,
                                          relative_to=repo_root()),
            args.static_baseline, no_baseline=args.no_baseline,
            update=args.update_baseline))
    if not args.static_only:
        rc, _ = run_footprint_gate(
            args.baseline, update=args.update_baseline,
            reason=args.reason,
            drift=os.environ.get("VELES_MEMPLAN_DRIFT"))
        status = max(status, rc)
    return status


if __name__ == "__main__":
    raise SystemExit(main())
