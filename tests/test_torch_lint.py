"""The port's VL lint (``veles_tpu_torch/analysis/lint.py``) and its
one static gate (``python -m veles_tpu_torch.analysis``) on the CPU:
the counterparts of ``tests/test_analysis.py``'s lint tests and of the
gate tests in ``tests/test_concurrency.py``.

VL001 and VL002 are retargeted to the capture surface (host syncs
inside a callable handed to ``StepGraph``, captures made in a loop
body); VL003-VL007 carry no JAX and give the reference's ``(line,
rule)`` findings on the reference's own fixtures.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from veles_tpu_torch.analysis import lint
from veles_tpu_torch.analysis.baseline import gate_counts
from veles_tpu_torch.analysis.lint import (Finding, lint_package,
                                           lint_source, lint_sources)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "veles_tpu_torch")

NEUTRAL = ("VL003", "VL004", "VL005", "VL006", "VL007")


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# VL001: host syncs inside a capture root
# ---------------------------------------------------------------------------

CAPTURED = textwrap.dedent("""
    import torch
    from veles_tpu_torch.graphs import StepGraph

    def helper(x):
        n = int(x.sum())
        return x * n

    class Engine:
        def __init__(self):
            self.x = torch.zeros(4)
            self.graph = StepGraph(self._step)
            self.other = StepGraph(lambda: self.x.max().item())

        def _step(self):
            y = helper(self.x)
            host = y.cpu()
            flag = bool((y > 0).any())
            torch.cuda.synchronize()
            return y.tolist(), host, flag

        def eager(self):
            return float(self.x.sum()), self.x.numpy()
""")


def test_vl001_host_syncs_in_capture_roots_and_their_callees():
    findings = [f for f in lint_source(CAPTURED) if f.rule == "VL001"]
    lines = sorted(f.line for f in findings)
    # helper's int(tensor) (reached from _step), the lambda's .item(),
    # _step's .cpu(), bool(tensor), synchronize and .tolist()
    assert lines == [6, 13, 17, 18, 19, 20], findings
    assert any("capture root" in f.message for f in findings)


def test_vl001_ignores_host_side_code():
    """``eager`` is never captured: its syncs are the host's business."""
    findings = lint_source(CAPTURED)
    assert not [f for f in findings if f.line == 23]


def test_vl001_host_metadata_is_not_a_sync():
    """float()/int() of host values under a capture is legal: shapes,
    sizes, Python numbers (the ``nn/rbm.py`` false positive the
    reference's rule gave: ``float(max(size, 1))``)."""
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        def body(x, size: int):
            n = float(max(size, 1))
            rows = int(x.shape[0]) + int(x.numel()) + int(x.size(1))
            d = float(x.element_size())
            return x / n * rows * d

        graph = StepGraph(body)
    """)
    assert not lint_source(src)


def test_vl001_reaches_through_package_imports():
    """A helper in another module of the package, imported by name, is
    on the surface of the capture that calls it."""
    a = textwrap.dedent("""
        def leak(x):
            return x.item()
    """)
    b = textwrap.dedent("""
        from veles_tpu_torch.a import leak
        from veles_tpu_torch.graphs import StepGraph

        def body(x):
            return leak(x)

        g = StepGraph(body)
    """)
    findings = lint_sources([("veles_tpu_torch/a.py", a),
                             ("veles_tpu_torch/b.py", b)])
    assert [(f.path, f.rule) for f in findings] == \
        [("veles_tpu_torch/a.py", "VL001")]
    assert not lint_sources([("veles_tpu_torch/a.py", a)])


def test_vl001_capture_context_marker():
    src = textwrap.dedent("""
        def captured_elsewhere(x):  # veles-lint: capture-context
            return x.cpu()
    """)
    assert _rules(lint_source(src)) == ["VL001"]


def test_rbm_is_clean():
    """``nn/rbm.py:51`` comes out clean (``size`` is an int)."""
    assert not lint.lint_file(os.path.join(PORT, "nn", "rbm.py"))


def test_the_port_has_capture_roots():
    """The surface the VL/VJ/VM rules check is not empty: the engines'
    bucket forward and decode rounds and the trainer's step."""
    sources, _ = lint.read_package(PORT)
    surface = lint.capture_surface(sources)
    names = {"%s:%s" % (f.module, f.qualname) for f in surface}
    for want in ("veles_tpu_torch.serve.engine:GenerativeEngine._decode_fn",
                 "veles_tpu_torch.serve.engine:"
                 "PagedGenerativeEngine._round_fn",
                 "veles_tpu_torch.models.transformer:"
                 "TransformerTrainer._train_step",
                 "veles_tpu_torch.models.transformer:paged_decode_step",
                 "veles_tpu_torch.ops.flash_attention:flash_decode_paged"):
        assert want in names, want


# ---------------------------------------------------------------------------
# VL002: captures in loop bodies
# ---------------------------------------------------------------------------

def test_vl002_capture_in_loop():
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        def capture_all(fns):
            out = []
            for fn in fns:
                out.append(StepGraph(fn))
            while out:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    pass
                out.pop()
            return out
    """)
    findings = lint_source(src)
    assert _rules(findings) == ["VL002", "VL002", "VL002"]
    assert "loop" in findings[0].message


def test_vl002_capture_outside_loop_ok():
    src = textwrap.dedent("""
        from veles_tpu_torch.graphs import StepGraph

        def capture_once(fn, xs):
            graph = StepGraph(fn)
            return [graph.replay(x) for x in xs]
    """)
    assert not lint_source(src)


# ---------------------------------------------------------------------------
# VL003-VL007 and suppression
# ---------------------------------------------------------------------------

def test_vl003_daemon_thread_names_the_ports_pool():
    src = "import threading\nthreading.Thread(target=print, daemon=True)\n"
    findings = lint_source(src)
    assert _rules(findings) == ["VL003"]
    assert "veles_tpu_torch.thread_pool" in findings[0].message


def test_vl007_obs_door_is_the_ports():
    flagged = ("import time\n"
               "def f(m, t0):\n"
               "    m.observe(time.monotonic() - t0)\n")
    assert _rules(lint_source(flagged, "veles_tpu_torch/serve/x.py")) == \
        ["VL007"]
    assert lint_source(flagged, "veles_tpu_torch/obs/trace.py") == []
    assert "obs" in lint_source(flagged, "x.py")[0].message


def test_noqa_suppression_exact_code_and_bare():
    base = ("import threading\n"
            "t = threading.Thread(target=print, daemon=True)%s\n")
    assert len(lint_source(base % "")) == 1
    assert not lint_source(base % "  # noqa: VL003")
    assert not lint_source(base % "  # noqa")
    assert len(lint_source(base % "  # noqa: VL001")) == 1


def _reference_fixtures():
    """The reference's VL003-VL007 fixture sources (tests/test_analysis.py
    and tests/test_obs.py), with the path each was linted under."""
    import ast
    out = []
    for rel in ("test_analysis.py", "test_obs.py"):
        with open(os.path.join(REPO, "tests", rel)) as fin:
            tree = ast.parse(fin.read())
        for node in tree.body:
            if not (isinstance(node, ast.FunctionDef) and
                    node.name.startswith(("test_vl003", "test_vl004",
                                          "test_vl005", "test_vl006",
                                          "test_vl007", "test_noqa"))):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str) and "\n" in sub.value:
                    out.append((node.name, textwrap.dedent(sub.value)))
    return out


REF_FIXTURES = _reference_fixtures()


def test_reference_fixtures_were_found():
    assert len(REF_FIXTURES) >= 12


@pytest.mark.parametrize("index", range(len(REF_FIXTURES)))
@pytest.mark.parametrize("path", ["x.py", "pkg/serve/x.py",
                                  "pkg/obs/trace.py"])
def test_vl_neutral_rules_parity_with_the_reference(index, path):
    """VL003-VL007 give the reference's (line, rule) findings on the
    reference's fixtures (its VL007 door ``veles_tpu/obs/`` maps to the
    port's ``veles_tpu_torch/obs/``)."""
    from veles_tpu.analysis.lint import lint_source as ref_lint
    _, src = REF_FIXTURES[index]
    try:
        want = [(f.line, f.rule) for f in ref_lint(
            src, path.replace("pkg", "veles_tpu")) if f.rule in NEUTRAL]
    except SyntaxError:
        return
    got = [(f.line, f.rule) for f in lint_source(
        src, path.replace("pkg", "veles_tpu_torch")) if f.rule in NEUTRAL]
    assert sorted(got) == sorted(want), src


def test_package_self_lint_clean():
    findings = lint_package()
    assert not findings, "\n".join(str(f) for f in findings)


def test_lint_cli_explicit_file(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    pass\nexcept:\n    pass\n")
    proc = subprocess.run([sys.executable, "-m",
                           "veles_tpu_torch.analysis.lint", str(bad)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "VL005" in proc.stdout
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = subprocess.run([sys.executable, "-m",
                           "veles_tpu_torch.analysis.lint", str(good)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0


# ---------------------------------------------------------------------------
# the baseline mechanics and the one gate
# ---------------------------------------------------------------------------

def test_baseline_gates_new_findings(tmp_path, capsys):
    baseline = str(tmp_path / "baseline.json")
    counts = {("veles_tpu_torch/x.py", "VC002"): 1}
    assert gate_counts("t", counts, baseline) == 1
    assert gate_counts("t", counts, baseline, update=True) == 0
    assert gate_counts("t", counts, baseline) == 0
    assert gate_counts("t", {("veles_tpu_torch/x.py", "VC002"): 0},
                       baseline) == 0                 # improvement
    assert "improved" in capsys.readouterr().out
    counts[("veles_tpu_torch/x.py", "VC002")] = 2
    assert gate_counts("t", counts, baseline) == 1
    assert gate_counts("t", {("veles_tpu_torch/x.py", "VC002"): 1},
                       baseline, no_baseline=True) == 1


def test_count_by_file_rule_is_relative():
    findings = [Finding("VL005", os.path.join(PORT, "x.py"), 3, 0, "m"),
                Finding("VL005", os.path.join(PORT, "x.py"), 9, 0, "m")]
    assert lint.count_by_file_rule(findings, relative_to=REPO) == \
        {("veles_tpu_torch/x.py", "VL005"): 2}


@pytest.mark.parametrize("name", ["ruff", "lint", "concurrency",
                                  "jitcheck", "memplan_static"])
def test_ast_baselines_are_empty(name):
    """Every count baseline of the port grandfathers nothing."""
    path = os.path.join(PORT, "analysis", "baselines",
                        "%s_baseline.json" % name)
    with open(path) as fin:
        assert json.load(fin)["findings"] == [], name


def test_gate_single_tool(capsys):
    from veles_tpu_torch.analysis.__main__ import main
    assert main(["--tool", "lint"]) == 0
    assert main(["--tool", "concurrency", "--tool", "jitcheck"]) == 0
    assert "PASS" in capsys.readouterr().out


_GATE = textwrap.dedent("""
    import json, runpy, sys
    sys.argv = ["veles_tpu_torch.analysis", "--json", sys.argv[1]]
    try:
        runpy.run_module("veles_tpu_torch.analysis", run_name="__main__")
    except SystemExit as e:
        code = e.code
    tops = {m.split(".")[0] for m in sys.modules}
    print(json.dumps({"rc": code, "jax": sorted(tops & {"jax", "jaxlib",
                                                        "veles_tpu"})}))
""")


def test_the_gate_passes_without_jax(tmp_path):
    """``python -m veles_tpu_torch.analysis --json out.json`` exits 0
    with ``JAX_PLATFORMS`` unset, never importing jax; every leg passes
    (ruff: skipped where it is not installed)."""
    out = tmp_path / "gate.json"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _GATE, str(out)],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "jax": []}, proc.stdout[-3000:]
    doc = json.loads(out.read_text())
    assert doc["status"] == "pass"
    assert set(doc["tools"]) == {"ruff", "lint", "concurrency",
                                 "jitcheck", "jaxpr", "memplan"}
    for name, leg in doc["tools"].items():
        want = ("pass", "skipped") if name == "ruff" else ("pass",)
        assert leg["status"] in want, (name, leg)
        assert leg["findings"] == 0, (name, leg)
    import shutil
    if shutil.which("ruff") is None:
        assert doc["tools"]["ruff"]["status"] == "skipped"
