"""Capture-surface contract analysis (rules VJ001-VJ003; port of
``veles_tpu/analysis/jitcheck.py``).

The VL lint (``analysis/lint.py``) guards what Python code does
*around* a capture; the VC pass (``analysis/concurrency.py``) guards
the threads; this third whole-package pass guards the **compute surface
itself** — the functions a :class:`~veles_tpu_torch.graphs.StepGraph`
captures into a CUDA graph, and everything they reach through
same-package calls (``analysis.lint.capture_surface``). A replay runs
the kernels the capture recorded, on the addresses the capture saw:
the defect classes that cost real device time or silently wrong
numbers without failing a single CPU test are control flow decided at
capture time, state rebound after the capture, and captures keyed by
raw request shapes. Each gets a named rule; the whole package checks
clean on an EMPTY baseline (``analysis/baselines/jitcheck_baseline.json``).
The dynamic half — the golden dispatch-graph gate over the ops the
registry's computations actually dispatch — lives in
:mod:`veles_tpu_torch.analysis.jaxpr_audit`.

Rules:

=======  ============================================================
VJ001    Python ``if``/``while``/``assert`` or a conditional
         expression (``a if t else b``) on a tensor inside a capture
         root: the test reads a device value (a sync, which raises
         during the capture on the card), or the capture bakes the one
         branch it took into every replay. An identity test (``x is
         None``) reads no value. Checked interprocedurally over the
         capture surface.
VJ002    a captured method reads ``self.X`` that some OTHER method
         rebinds after ``__init__``: the graph keeps the address of
         the tensor the capture saw, and every replay reads (or
         writes) that one while the object has moved on — the port's
         in-place discipline (``copy_``, never rebind) is what makes a
         capture valid. A deliberate capture of a rebound attribute
         (immutable config, a rebind before any capture) is declared
         with a ``# veles-jit: static`` marker on the ``def`` line.
VJ003    a serve-plane capture (``StepGraph(...)``) or replay with
         arguments (``graph.replay(x)``) in ``veles_tpu_torch/serve/``
         whose enclosing function never calls ``bucket_for`` (and
         carries no ``# veles-jit: bucketed`` marker): raw request
         shapes key one graph each, an unbounded set of captures and
         memory pools.
=======  ============================================================

VJ004 of the reference (a ``jnp.dot``-family call over compute-dtype
operands without ``preferred_element_type``) has no counterpart: a
torch matmul has no per-call accumulation dtype to declare (a bf16 x
bf16 product accumulates in f32 and returns bf16), and torch refuses a
matmul over mixed bf16/f32 operands instead of promoting them, so the
silent f32 upcast the rule guards against cannot enter through a
product. Upcasts by elementwise type promotion are what VJ005
(:mod:`jaxpr_audit`) counts in the dispatched graphs.

Suppression: inline ``# noqa: VJ002`` exactly like the VL/VC rules
(bare ``# noqa`` silences everything).

CLI (baseline mechanics identical to the VL/VC passes)::

    python -m veles_tpu_torch.analysis.jitcheck                # gate
    python -m veles_tpu_torch.analysis.jitcheck --no-baseline  # strict
    python -m veles_tpu_torch.analysis.jitcheck --update-baseline
    python -m veles_tpu_torch.analysis.jitcheck file.py ...    # strict
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from veles_tpu_torch.analysis.lint import (PACKAGE, Finding, Function,
                                           Module, PackageIndex,
                                           _dotted, _flag_into,
                                           _self_attr, apply_noqa,
                                           baselines_dir,
                                           is_step_graph,
                                           is_tensor_expr, read_package,
                                           repo_root, tensor_names)

RULES: Dict[str, str] = {
    "VJ001": "Python control flow on a tensor inside a capture root",
    "VJ002": "captured method reads self state that another method "
             "rebinds after __init__",
    "VJ003": "serve-plane capture or replay whose shapes bypass the "
             "pow2 bucket helper",
}

_STATIC_MARKER_RE = re.compile(r"#\s*veles-jit:\s*static")
_BUCKETED_MARKER_RE = re.compile(r"#\s*veles-jit:\s*bucketed")

#: constructor-ish methods: assignments there are initialization, not
#: mutation (mirrors the VC pass)
_CTOR_METHODS = {"__init__", "init_unpickled", "__post_init__"}


def _check_vj001(fn: Function, findings: List[Finding]) -> None:
    names = tensor_names(fn.node)
    for node in ast.walk(fn.node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            test, kind = node.test, {ast.If: "if", ast.While: "while",
                                     ast.IfExp: "if-else"}[type(node)]
        elif isinstance(node, ast.Assert):
            test, kind = node.test, "assert"
        else:
            continue
        if is_tensor_expr(test, names):
            _flag_into(findings, "VJ001", fn.path, node,
                       "Python `%s` on a tensor inside capture root %s: "
                       "the branch is decided when the graph is "
                       "captured (a host sync, which raises while "
                       "capturing) — use torch.where/masking, or hoist "
                       "the check out of the captured function"
                       % (kind, fn.qualname))


def _check_vj002(fn: Function, mod: Module,
                 findings: List[Finding]) -> None:
    if fn.cls is None or _STATIC_MARKER_RE.search(fn.def_line):
        return
    assigns = mod.class_assigns.get(fn.cls, {})
    flagged: Set[str] = set()
    for node in ast.walk(fn.node):
        attr = _self_attr(node)
        if attr is None or attr in flagged or \
                not isinstance(node.ctx, ast.Load):
            continue
        mutators = assigns.get(attr, set()) - _CTOR_METHODS
        if not mutators:
            continue
        flagged.add(attr)
        _flag_into(findings, "VJ002", fn.path, node,
                   "captured method %s reads self.%s, which %s rebinds "
                   "after __init__: a replay keeps the address the "
                   "capture saw — update it in place (copy_), or mark "
                   "the def `# veles-jit: static` if the capture is "
                   "deliberate" % (fn.qualname, attr, "/".join(
                       sorted("%s.%s" % (fn.cls, m) for m in mutators))))


def _in_serve_plane(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(parts[i:i + 2] == [PACKAGE, "serve"]
               for i in range(len(parts) - 1))


def _check_vj003(mod: Module, findings: List[Finding]) -> None:
    if not _in_serve_plane(mod.path):
        return
    for fn in list(mod.functions.values()) + list(mod.methods.values()):
        if _BUCKETED_MARKER_RE.search(fn.def_line):
            continue
        calls = [c for c in ast.walk(fn.node) if isinstance(c, ast.Call)]
        if any((_dotted(c.func) or "").rsplit(".", 1)[-1] == "bucket_for"
               for c in calls):
            continue
        for call in calls:
            if is_step_graph(call.func):
                what = "StepGraph(...)"
            elif isinstance(call.func, ast.Attribute) and \
                    call.func.attr == "replay" and call.args:
                what = "%s(...)" % (_dotted(call.func) or ".replay")
            else:
                continue
            _flag_into(findings, "VJ003", fn.path, call,
                       "serve-plane %s in %s, and the function never "
                       "routes its shapes through bucket_for: raw "
                       "request shapes key one graph (and one memory "
                       "pool) each — bucket first, or mark the def "
                       "`# veles-jit: bucketed` when the shapes are "
                       "provably fixed" % (what, fn.qualname))


def check_sources(sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Analyze ``(path, source)`` pairs as one closed package."""
    index = PackageIndex.from_sources(sources)
    findings: List[Finding] = []
    for fn, mod in index.capture_surface().items():
        _check_vj001(fn, findings)
        _check_vj002(fn, mod, findings)
    for mod in index.modules.values():
        _check_vj003(mod, findings)
    seen: Set[Tuple[str, str, int, str]] = set()
    unique = []
    for finding in findings:
        key = (finding.rule, finding.path, finding.line, finding.message)
        if key not in seen:
            seen.add(key)
            unique.append(finding)

    def lines_of(path: str) -> List[str]:
        mod = index.by_path.get(path)
        return mod.lines if mod is not None else []

    kept = apply_noqa(lines_of, unique)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def check_source(source: str, path: str = "<string>") -> List[Finding]:
    """Analyze one source string (tests/fixtures)."""
    return check_sources([(path, source)])


def check_package(package_dir: Optional[str] = None) -> List[Finding]:
    """Analyze the whole veles_tpu_torch package."""
    sources, findings = read_package(package_dir, "VJ000")
    return findings + check_sources(sources)


def _default_baseline_path() -> str:
    return os.path.join(baselines_dir(), "jitcheck_baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from veles_tpu_torch.analysis.baseline import gate_counts
    from veles_tpu_torch.analysis.lint import count_by_file_rule

    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis.jitcheck",
        description="veles_tpu_torch capture-surface contract analysis "
                    "(VJ001-VJ003)")
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
        findings = check_sources(sources)
        for finding in findings:
            print(finding)
        print("veles_jitcheck: %d finding(s) in %d file(s)"
              % (len(findings), len(args.files)))
        return 1 if findings else 0

    findings = check_package()
    for finding in findings:
        print(finding)
    counts = count_by_file_rule(findings, relative_to=repo_root())
    return gate_counts("veles_jitcheck", counts, args.baseline,
                       no_baseline=args.no_baseline,
                       update=args.update_baseline)


if __name__ == "__main__":
    raise SystemExit(main())
