"""ONE static-analysis gate for the port: ruff + the VL lint + the VC
concurrency pass + the VJ capture-surface pass + the golden dispatch-
graph gate + the device-memory plan, each against its own baseline
(the counterpart of ``scripts/analysis_gate.py``).

The AST legs gate on the same mechanics (per-(file, rule) counts
against a checked-in baseline; MORE findings than recorded fail, fewer
invite tightening) and their baselines in ``analysis/baselines/`` are
all EMPTY: the package is clean, and its suppressions are inline and
justified. The ``jaxpr`` leg compares golden GRAPH fingerprints
(``analysis/jaxpr_audit.py``) and re-recording them requires
``--reason``; the ``memplan`` leg is a hybrid: its VM rules gate on
counts (empty baseline), its golden-footprint half compares per-
computation plans and shares the ``--reason`` discipline.

Usage::

    python -m veles_tpu_torch.analysis                  # all tools, gate
    python -m veles_tpu_torch.analysis --tool lint      # one tool
    python -m veles_tpu_torch.analysis --update-baseline [--tool X]
    python -m veles_tpu_torch.analysis --update-baseline --tool jaxpr \\
        --reason "why the golden graphs changed"
    python -m veles_tpu_torch.analysis --no-baseline    # strict
    python -m veles_tpu_torch.analysis --json out.json  # summary

``--json`` writes ``{"status", "tools": {name: {"status",
"findings"}}}``. ruff is optional: where it is not installed the ruff
leg reports ``skipped`` and does not fail the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from veles_tpu_torch.analysis.baseline import gate_counts
from veles_tpu_torch.analysis.lint import (baselines_dir,
                                           count_by_file_rule, repo_root)

#: tool name -> baseline file (under ``analysis/baselines/``)
BASELINES = {
    "ruff": "ruff_baseline.json",
    "lint": "lint_baseline.json",
    "concurrency": "concurrency_baseline.json",
    "jitcheck": "jitcheck_baseline.json",
    "jaxpr": "jaxpr_baseline.json",
    "memplan": "memplan_static_baseline.json",
}

TOOLS = tuple(BASELINES)

#: tools whose baseline update is a justified, deliberate act: they
#: require --reason, run first, and abort the update on rejection
REASON_TOOLS = ("jaxpr", "memplan")

Result = Tuple[int, Dict[str, object]]


def _path(tool: str) -> str:
    return os.path.join(baselines_dir(), BASELINES[tool])


def run_ruff(args) -> Result:
    binary = shutil.which("ruff")
    if binary is None:
        print("ruff: skipped (not installed)")
        return 0, {"status": "skipped", "findings": 0}
    root = repo_root()
    tests = sorted(f for f in os.listdir(os.path.join(root, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    proc = subprocess.run(
        [binary, "check", "veles_tpu_torch",
         *[os.path.join("tests", f) for f in tests],
         "--output-format", "concise", "--no-cache"],
        cwd=root, capture_output=True, text=True)
    counts: Dict[Tuple[str, str], int] = {}
    for line in proc.stdout.splitlines():
        # "<path>:<line>:<col>: <CODE> <message>"
        parts = line.split(":", 3)
        if len(parts) < 4:
            continue
        code = parts[3].strip().split(" ", 1)[0]
        if not code or not code[0].isalpha():
            continue
        key = (parts[0].replace(os.sep, "/"), code)
        counts[key] = counts.get(key, 0) + 1
        print("ruff: %s" % line)
    rc = gate_counts("ruff", counts, _path("ruff"), args.no_baseline,
                     args.update_baseline)
    return rc, {"status": "fail" if rc else "pass",
                "findings": sum(counts.values())}


def _run_counted(tool: str, findings, args) -> Result:
    for finding in findings:
        print("%s: %s" % (tool, finding))
    counts = count_by_file_rule(findings, relative_to=repo_root())
    rc = gate_counts(tool, counts, _path(tool), args.no_baseline,
                     args.update_baseline)
    return rc, {"status": "fail" if rc else "pass",
                "findings": len(findings)}


def run_lint(args) -> Result:
    from veles_tpu_torch.analysis.lint import lint_package
    return _run_counted("lint", lint_package(), args)


def run_concurrency(args) -> Result:
    from veles_tpu_torch.analysis.concurrency import analyze_package
    return _run_counted("concurrency", analyze_package(), args)


def run_jitcheck(args) -> Result:
    from veles_tpu_torch.analysis.jitcheck import check_package
    return _run_counted("jitcheck", check_package(), args)


def run_jaxpr(args) -> Result:
    from veles_tpu_torch.analysis import jaxpr_audit
    rc, findings = jaxpr_audit.run_gate(
        _path("jaxpr"), update=args.update_baseline, reason=args.reason,
        drift=os.environ.get("VELES_JAXPR_DRIFT"))
    return rc, {"status": "fail" if rc else "pass", "findings": findings}


def run_memplan(args) -> Result:
    """Both memplan halves: the VM rules against their (empty) count
    baseline, and the golden-footprint gate."""
    from veles_tpu_torch.analysis import memplan
    rc, info = _run_counted("memplan", memplan.check_package(), args)
    foot_rc, foot_findings = memplan.run_footprint_gate(
        memplan.default_baseline_path(), update=args.update_baseline,
        reason=args.reason, drift=os.environ.get("VELES_MEMPLAN_DRIFT"))
    rc = max(rc, foot_rc)
    info["status"] = "fail" if rc else "pass"
    info["findings"] = int(info["findings"]) + foot_findings
    return rc, info


RUNNERS = {
    "ruff": run_ruff,
    "lint": run_lint,
    "concurrency": run_concurrency,
    "jitcheck": run_jitcheck,
    "jaxpr": run_jaxpr,
    "memplan": run_memplan,
}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.analysis",
        description="the port's static-analysis gate (ruff + VL lint + "
                    "VC concurrency + VJ capture surface + golden "
                    "dispatch graphs + memory plan)")
    parser.add_argument("--tool", choices=TOOLS, action="append",
                        help="run only the named tool(s); default all")
    parser.add_argument("--no-baseline", action="store_true",
                        help="strict mode: any finding fails")
    parser.add_argument("--update-baseline", action="store_true",
                        help="re-record each selected tool's baseline")
    parser.add_argument("--reason",
                        help="justification line, REQUIRED when "
                             "--update-baseline covers the jaxpr or "
                             "memplan tools")
    parser.add_argument("--json", metavar="PATH",
                        help="write {status, tools: {name: {status, "
                             "findings}}}")
    args = parser.parse_args(argv)
    tools = args.tool if args.tool else list(TOOLS)
    reasoned = [t for t in REASON_TOOLS if t in tools]
    if args.update_baseline and reasoned:
        if not args.reason:
            # validate BEFORE any runner writes a baseline file
            print("analysis: --update-baseline covering %s requires "
                  "--reason — no baselines were touched"
                  % "/".join(reasoned))
            return 1
        # these legs can REJECT an update: run them first and stop on
        # rejection, so the count baselines stay untouched too
        tools = reasoned + [t for t in tools if t not in reasoned]
    status = 0
    summary: Dict[str, Dict[str, object]] = {}
    for tool in tools:
        rc, info = RUNNERS[tool](args)
        status = max(status, rc)
        summary[tool] = info
        if rc and args.update_baseline:
            print("analysis: %s rejected the baseline update — stopping "
                  "before the remaining tools write theirs" % tool)
            break
    if args.json:
        with open(args.json, "w") as fout:
            json.dump({"status": "fail" if status else "pass",
                       "tools": summary}, fout, indent=2, sort_keys=True)
            fout.write("\n")
    print("analysis: FAIL" if status else
          "analysis: PASS (%s)" % ", ".join(tools))
    return status


if __name__ == "__main__":
    sys.exit(main())
