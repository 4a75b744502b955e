"""Golden dispatch-graph drift gate + dtype-policy audit (rule VJ005);
port of ``veles_tpu/analysis/jaxpr_audit.py``, which audits jaxprs.
This one audits aten dispatch graphs: the ops a computation actually
dispatches, as a ``TorchDispatchMode`` sees them.

The static half of the capture-surface contract
(:mod:`veles_tpu_torch.analysis.jitcheck`) reads the SOURCE; this half
reads the GRAPHS. It runs every steady-state computation the AOT plane
enumerates (``veles_tpu_torch.aot.registry``: engine bucket forwards,
prefill and decode of the slab and paged engines, the speculative
round, both trainers' ``step_many``, the loader-rides-the-dispatch
step) once on the CPU at its canonical config, the kernels' plain
versions standing in, under a :class:`DispatchTrace`, and checks two
properties:

**VJ005 — dtype-policy leak.** Count the ops whose output is a WIDE
(>= :data:`WIDE_ELEMENTS` elements) f32 tensor and which read a wide
bf16/f16 tensor: an explicit ``.float()`` (``aten._to_copy``) and an
implicit upcast by type promotion (``bf16 + f32``) alike. The dtype
policy keeps a few f32 islands (layer-norm stats, the loss head, the
f32 master gradients) and each registry entry documents how many wide
upcasts those cost (``allowed_f32_upcasts``, reasons in ``notes``).
One MORE is an accidental upcast silently doubling a tensor's
footprint: the audit fails and names the shapes.

**Golden-graph drift.** Each computation is fingerprinted by its aten
op histogram, output-dtype histogram and op count, and compared with
the committed ``analysis/baselines/jaxpr_baseline.json``. The graphs
depend on the torch release (its decompositions), so the file keeps
one golden set per ``major.minor``; a release without one fails the
gate until it is recorded. ``--update-baseline`` REQUIRES a
``--reason``, recorded in the file.

Test hook: ``VELES_JAXPR_DRIFT=extra-op|dtype`` seeds one extra op into
the first registry computation / one wide bf16->f32 upcast into the
slab prefill, proving end to end that the gate trips.

CLI::

    python -m veles_tpu_torch.analysis.jaxpr_audit            # gate
    python -m veles_tpu_torch.analysis.jaxpr_audit --update-baseline \\
        --reason "why the graphs changed"
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: tensors at or above this many elements are "wide" for VJ005
WIDE_ELEMENTS = 4096

#: dtypes whose lift to f32 doubles a tensor's footprint
_NARROW_FLOATS = (torch.bfloat16, torch.float16)


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _shape(t: torch.Tensor) -> str:
    return "x".join(str(int(d)) for d in t.shape) or "scalar"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class DispatchTrace(TorchDispatchMode):
    """Records every aten op dispatched inside the block: its name, its
    output dtypes and the wide bf16/f16 -> f32 upcasts (VJ005).
    :meth:`on_op` is the hook a subclass extends (the memory plan's
    live ranges)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[str] = []
        self.dtypes: Dict[str, int] = {}
        self.upcasts: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        self.ops.append(name)
        inputs = _tensors((args, kwargs))
        outputs = _tensors(out)
        for t in outputs:
            key = _dtype_name(t.dtype)
            self.dtypes[key] = self.dtypes.get(key, 0) + 1
        wide_narrow = [t for t in inputs if t.dtype in _NARROW_FLOATS and
                       t.numel() >= WIDE_ELEMENTS]
        if wide_narrow:
            for t in outputs:
                if t.dtype == torch.float32 and \
                        t.numel() >= WIDE_ELEMENTS:
                    src = wide_narrow[0]
                    self.upcasts.append("%s:%s[%s]->f32" % (
                        name, _dtype_name(src.dtype), _shape(src)))
                    break
        self.on_op(func, args, kwargs, inputs, out, outputs)
        return out

    def on_op(self, func, args, kwargs, inputs: List[torch.Tensor],
              out: Any, outputs: List[torch.Tensor]) -> None:
        """Called after each op (a subclass's hook)."""

    def stats(self) -> Dict[str, Any]:
        """The drift fingerprint plus the VJ005 evidence."""
        prims: Dict[str, int] = {}
        for name in self.ops:
            prims[name] = prims.get(name, 0) + 1
        return {"eqns": len(self.ops), "prims": prims,
                "dtypes": dict(self.dtypes),
                "wide_f32_upcasts": len(self.upcasts),
                "upcast_shapes": sorted(self.upcasts)}


def torch_release() -> str:
    """``major.minor`` of the running torch (the goldens' key)."""
    return ".".join(torch.__version__.split("+")[0].split(".")[:2])


def trace_call(fn: Callable, args: tuple,
               trace: Optional[DispatchTrace] = None) -> DispatchTrace:
    """One call of ``fn(*args)`` under ``trace`` (a fresh
    :class:`DispatchTrace` by default)."""
    trace = trace if trace is not None else DispatchTrace()
    with trace:
        fn(*args)
    return trace


# -- the audit ---------------------------------------------------------------

def _seeded_drift(fn: Callable, mode: str) -> Callable:
    """Test hook: ``fn`` plus one seeded change in its dispatched graph:
    ``extra-op`` one more arithmetic op; ``dtype`` one wide bf16->f32
    upcast (a seeded dtype-policy leak)."""
    def wrapped(*args):
        out = fn(*args)
        if mode == "extra-op":
            torch.sin(torch.zeros(8))
        else:
            torch.zeros((64, 128), dtype=torch.bfloat16).float()
        return out
    return wrapped


def audit_all(drift: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Run + fingerprint every registry computation on the CPU.
    ``drift`` (``extra-op``/``dtype``) seeds the test-hook change:
    ``extra-op`` into the first registry entry, ``dtype`` into the slab
    prefill."""
    from veles_tpu_torch.aot.registry import canonical_computations
    out: Dict[str, Dict[str, Any]] = {}
    for i, comp in enumerate(canonical_computations()):
        torch.manual_seed(0)
        fn, args = comp.build("cpu")
        seeded = (i == 0) if drift == "extra-op" else \
            (comp.name == "generative_prefill")
        if drift and seeded:
            fn = _seeded_drift(fn, drift)
        stats = trace_call(fn, args).stats()
        stats["allowed_f32_upcasts"] = comp.allowed_f32_upcasts
        stats["notes"] = comp.notes
        out[comp.name] = stats
    return out


def check_dtype_policy(audits: Dict[str, Dict[str, Any]]) -> List[str]:
    """VJ005: computations whose wide bf16->f32 upcast count exceeds
    the registry's documented allowance."""
    failures = []
    for name, stats in sorted(audits.items()):
        n, allowed = stats["wide_f32_upcasts"], \
            stats["allowed_f32_upcasts"]
        if n > allowed:
            failures.append(
                "VJ005 %s: %d wide bf16/f16->f32 upcast(s), allowance "
                "%d (%s) — upcasts: %s"
                % (name, n, allowed, stats["notes"] or "none",
                   ", ".join(stats["upcast_shapes"])))
    return failures


def _hist_diff(kind: str, old: Dict[str, int],
               new: Dict[str, int]) -> List[str]:
    out = []
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key, 0), new.get(key, 0)
        if a != b:
            out.append("%s %s %d->%d" % (kind, key, a, b))
    return out


def compare(current: Dict[str, Dict[str, Any]],
            baseline: Dict[str, Dict[str, Any]]) -> List[str]:
    """Drift failures: new/vanished computations, op-count growth, op-
    or dtype-histogram changes."""
    failures = []
    for name in sorted(set(current) | set(baseline)):
        cur, base = current.get(name), baseline.get(name)
        if base is None:
            failures.append(
                "%s: NEW computation (not in the golden baseline) — "
                "record it with --update-baseline --reason" % name)
            continue
        if cur is None:
            failures.append(
                "%s: computation VANISHED from the registry — "
                "re-record with --update-baseline --reason" % name)
            continue
        diffs = _hist_diff("op", base.get("prims", {}),
                           cur.get("prims", {}))
        diffs += _hist_diff("dtype", base.get("dtypes", {}),
                            cur.get("dtypes", {}))
        if cur.get("eqns") != base.get("eqns"):
            diffs.append("ops %s->%s" % (base.get("eqns"),
                                         cur.get("eqns")))
        if cur.get("wide_f32_upcasts") != base.get("wide_f32_upcasts"):
            diffs.append("wide_f32_upcasts %s->%s"
                         % (base.get("wide_f32_upcasts"),
                            cur.get("wide_f32_upcasts")))
        if diffs:
            failures.append("%s: golden-graph drift — %s"
                            % (name, "; ".join(diffs)))
    return failures


# -- baseline I/O -------------------------------------------------------------

def default_baseline_path() -> str:
    from veles_tpu_torch.analysis.lint import baselines_dir
    return os.path.join(baselines_dir(), "jaxpr_baseline.json")


def load_baseline(path: str, release: Optional[str] = None
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(this release's computations, full doc); empty when absent."""
    if not os.path.exists(path):
        return {}, {}
    with open(path) as fin:
        doc = json.load(fin)
    release = release or torch_release()
    return doc.get("torch", {}).get(release, {}).get(
        "computations", {}), doc


def save_golden(path: str, key: str, entries: Dict[str, Any],
                reason: str, previous: Dict[str, Any],
                comment: str) -> None:
    """Write this torch release's golden set (other releases' sets
    stay) and append the justification."""
    doc = {"comment": comment,
           "justifications": list(previous.get("justifications", [])) +
           [reason],
           "torch": dict(previous.get("torch", {}))}
    doc["torch"][torch_release()] = {"torch": torch.__version__,
                                     key: entries}
    with open(path, "w") as fout:
        json.dump(doc, fout, indent=2, sort_keys=True)
        fout.write("\n")


def save_baseline(path: str, audits: Dict[str, Dict[str, Any]],
                  reason: str, previous: Dict[str, Any]) -> None:
    entries = {name: {"eqns": s["eqns"], "prims": s["prims"],
                      "dtypes": s["dtypes"],
                      "wide_f32_upcasts": s["wide_f32_upcasts"]}
               for name, s in sorted(audits.items())}
    save_golden(path, "computations", entries, reason, previous,
                "golden aten dispatch fingerprints per steady-state "
                "computation (veles_tpu_torch.aot.registry), one set a "
                "torch release; regenerate with --update-baseline "
                "--reason '...'")


# -- gate ---------------------------------------------------------------------

def run_gate(baseline_path: Optional[str] = None, update: bool = False,
             reason: Optional[str] = None,
             drift: Optional[str] = None) -> Tuple[int, int]:
    """(exit status, finding count). ``drift`` is normally read from
    ``VELES_JAXPR_DRIFT`` by the caller (test hook)."""
    path = baseline_path or default_baseline_path()
    if update and not reason:
        print("jaxpr: --update-baseline requires --reason: the golden "
              "graphs only change deliberately — say why")
        return 1, 0
    audits = audit_all(drift=drift)
    failures = check_dtype_policy(audits)
    if update:
        if failures:
            for line in failures:
                print("jaxpr: %s" % line)
            print("jaxpr: FAIL — dtype-policy (VJ005) findings are fixed "
                  "or allowlisted in the registry, never baselined")
            return 1, len(failures)
        _, previous = load_baseline(path)
        save_baseline(path, audits, reason, previous)
        print("jaxpr: baseline updated (%d computations, torch %s) -> %s"
              % (len(audits), torch_release(), path))
        print("jaxpr: justification recorded: %s" % reason)
        return 0, 0
    baseline, doc = load_baseline(path)
    if not baseline:
        failures.append(
            "no golden graphs for torch %s in %s (releases: %s) — "
            "record them with --update-baseline --reason"
            % (torch_release(), path,
               ", ".join(sorted(doc.get("torch", {}))) or "none"))
    else:
        failures += compare(audits, baseline)
    for line in failures:
        print("jaxpr: %s" % line)
    if failures:
        print("jaxpr: FAIL — %d finding(s)" % len(failures))
        return 1, len(failures)
    print("jaxpr: PASS (%d computation(s) match the golden baseline of "
          "torch %s)" % (len(audits), torch_release()))
    return 0, 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis.jaxpr_audit",
        description="golden dispatch-graph drift gate + VJ005 dtype "
                    "audit")
    parser.add_argument("--baseline", default=default_baseline_path())
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--reason",
                        help="justification line recorded with "
                             "--update-baseline (required)")
    args = parser.parse_args(argv)
    status, _ = run_gate(args.baseline, update=args.update_baseline,
                         reason=args.reason,
                         drift=os.environ.get("VELES_JAXPR_DRIFT"))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
