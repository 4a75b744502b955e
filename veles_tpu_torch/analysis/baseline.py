"""THE baseline mechanics for every static gate of the port — one
implementation (port of ``veles_tpu/analysis/baseline.py``).

``python -m veles_tpu_torch.analysis.lint``, ``.concurrency``,
``.jitcheck``, ``.memplan`` and the unified ``python -m
veles_tpu_torch.analysis`` all gate the same way: a
checked-in JSON baseline records per-``(file, rule)`` finding counts;
MORE findings than recorded fail (a new violation fails CI even in a
file with grandfathered ones), FEWER are reported as an invitation to
tighten with ``--update-baseline``, and fixing violations never fails
the gate. This module is that logic, once — a change to baseline
semantics lands in every CLI by construction.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

Counts = Dict[Tuple[str, str], int]


def load_baseline(path: str) -> Counts:
    """``{(file, rule): allowed}`` from a baseline JSON (empty when
    the file does not exist)."""
    if not os.path.exists(path):
        return {}
    with open(path) as fin:
        doc = json.load(fin)
    return {(e["file"], e["rule"]): int(e["count"])
            for e in doc.get("findings", [])}


def save_baseline(path: str, counts: Counts, tool: str) -> None:
    findings = [{"file": f, "rule": r, "count": n}
                for (f, r), n in sorted(counts.items())]
    with open(path, "w") as fout:
        json.dump({"comment": "%s grandfathered findings; regenerate "
                              "with --update-baseline" % tool,
                   "findings": findings}, fout, indent=2)
        fout.write("\n")


def gate_counts(tool: str, counts: Counts, baseline_path: str,
                no_baseline: bool = False,
                update: bool = False) -> int:
    """Compare ``counts`` against the baseline; print the verdict
    with a ``tool:`` prefix; 0 pass / 1 fail. ``update=True``
    re-records the baseline instead and passes."""
    if update:
        save_baseline(baseline_path, counts, tool)
        print("%s: baseline updated (%d entries) -> %s"
              % (tool, len(counts), baseline_path))
        return 0
    baseline = {} if no_baseline else load_baseline(baseline_path)
    regressions = []
    improvements = []
    for key, count in sorted(counts.items()):
        allowed = baseline.get(key, 0)
        if count > allowed:
            regressions.append((key, allowed, count))
        elif count < allowed:
            improvements.append((key, allowed, count))
    for (path, rule), allowed, count in improvements:
        print("%s: %s %s improved %d -> %d (tighten with "
              "--update-baseline)" % (tool, path, rule, allowed,
                                      count))
    if regressions:
        for (path, rule), allowed, count in regressions:
            print("%s: NEW %s finding(s) in %s: %d (baseline allows "
                  "%d)" % (tool, rule, path, count, allowed))
        print("%s: FAIL — %d (file, rule) pair(s) above baseline"
              % (tool, len(regressions)))
        return 1
    total = sum(counts.values())
    print("%s: PASS (%d finding(s), all within baseline)"
          % (tool, total))
    return 0
