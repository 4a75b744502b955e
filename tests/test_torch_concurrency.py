"""The port's concurrency pass (``veles_tpu_torch/analysis/
concurrency.py``, VC001-VC005) on the CPU: the counterpart of
``tests/test_concurrency.py``'s static tests.

Parity: every fixture source of the JAX package's concurrency tests
goes through the reference's checker and the port's, which must report
the same ``(line, rule)`` findings (the rules are language-neutral and
the pass is ported as it is). On ``veles_tpu_torch/`` itself both
checkers agree: clean, and the three ``TokenBatcher`` VC003 findings
back the moment their justified suppressions are stripped. The repairs
the pass found are pinned: the suppressions, ``ops/_build.py``'s
per-kernel build lock and the hot modules' annotations.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from veles_tpu_torch.analysis.concurrency import (analyze_package,
                                                  analyze_source,
                                                  analyze_sources)
from veles_tpu_torch.analysis.lint import read_package

# keep the CPU work of parallel workers to one thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "veles_tpu_torch")
REFERENCE_TESTS = os.path.join(REPO, "tests", "test_concurrency.py")


def _rules(findings):
    return [f.rule for f in findings]


def _fixtures(path):
    """``{test name: [source, ...]}``: the ``textwrap.dedent`` literals
    of each test function of a reference test file, and the module
    constants (``ABBA``) it names."""
    with open(path) as fin:
        tree = ast.parse(fin.read())
    constants = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                ast.unparse(node.value.func) == "textwrap.dedent" and \
                isinstance(node.value.args[0], ast.Constant):
            constants[node.targets[0].id] = textwrap.dedent(
                node.value.args[0].value)
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef) and
                node.name.startswith("test_")):
            continue
        sources = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and \
                    ast.unparse(sub.func) == "textwrap.dedent" and \
                    sub.args and isinstance(sub.args[0], ast.Constant):
                sources.append(textwrap.dedent(sub.args[0].value))
            elif isinstance(sub, ast.Name) and sub.id in constants:
                sources.append(constants[sub.id])
        if sources:
            out[node.name] = sources
    return out


VC_FIXTURES = _fixtures(REFERENCE_TESTS)


def _lines(findings):
    return sorted((f.path, f.line, f.rule) for f in findings)


def test_reference_fixtures_were_found():
    """The extraction sees the reference's detection tests (a silent
    zero would make the parity cases vacuous)."""
    assert len(VC_FIXTURES) >= 20, sorted(VC_FIXTURES)
    assert "test_vc001_abba_cycle_detected_with_witness" in VC_FIXTURES


@pytest.mark.parametrize("name", sorted(VC_FIXTURES))
def test_vc_parity_with_the_reference(name):
    """The reference's checker and the port's give the same (line,
    rule) findings on each fixture, alone and (cross-file fixtures) as
    one unit."""
    from veles_tpu.analysis import concurrency as ref
    sources = [s for s in VC_FIXTURES[name] if s.strip()]
    for src in sources:
        try:
            want = _lines(ref.analyze_source(src))
        except SyntaxError:
            continue
        assert _lines(analyze_source(src)) == want, src
    if len(sources) > 1:
        unit = [("f%d.py" % i, s) for i, s in enumerate(sources)]
        assert _lines(analyze_sources(unit)) == \
            _lines(ref.analyze_sources(unit))


ABBA = textwrap.dedent("""
    import threading

    class Pair:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def ba(self):
            with self._b:
                with self._a:
                    pass
""")


def test_vc001_abba_cycle_detected_with_witness():
    findings = analyze_source(ABBA)
    assert _rules(findings) == ["VC001"]
    assert "Pair._a" in findings[0].message and \
        "Pair._b" in findings[0].message


def test_vc003_off_thread_access_and_runs_on_marker():
    src = textwrap.dedent("""
        class B:
            def __init__(self):
                self._slots = {}  # owned-by: dispatch

            def _loop(self):  # runs-on: dispatch
                self._slots[1] = "x"

            def off_thread(self):
                return len(self._slots)
    """)
    findings = analyze_source(src)
    assert _rules(findings) == ["VC003"]
    assert "off_thread" in findings[0].message


def test_vc004_subprocess_under_a_lock_interprocedurally():
    """The shape ops/_build.py had: a registry lock held across a
    helper that runs a compiler by subprocess."""
    src = textwrap.dedent("""
        import subprocess
        import threading

        _lock = threading.Lock()

        def build(name):
            return subprocess.run(["cc", name])

        def library(name):
            with _lock:
                return build(name)
    """)
    findings = analyze_source(src)
    assert _rules(findings) == ["VC004"]
    assert "subprocess.run" in findings[0].message


def test_vc005_naked_condition_wait():
    src = textwrap.dedent("""
        import threading

        class W:
            def __init__(self):
                self._cond = threading.Condition()
                self.ready = False

            def bad(self):
                with self._cond:
                    self._cond.wait()

            def good(self):
                with self._cond:
                    while not self.ready:
                        self._cond.wait()
    """)
    assert _rules(analyze_source(src)) == ["VC005"]


def test_package_self_analysis_clean():
    """The whole port analyzes clean on an EMPTY baseline."""
    findings = analyze_package()
    assert not findings, "\n".join(str(f) for f in findings)


def test_reference_pass_over_the_port_agrees():
    """The reference's VC pass, run over ``veles_tpu_torch/``, finds
    what the port's finds: nothing."""
    from veles_tpu.analysis import concurrency as ref
    findings = ref.analyze_package(PORT)
    assert not findings, "\n".join(str(f) for f in findings)


def test_batcher_suppressions_silence_exactly_the_three_vc003():
    """Strip the TokenBatcher's justified ``# noqa: VC003`` (two
    advisory capability reads, the drain's emptiness peek and the
    ``active_sequences`` gauge, as the reference carries them; four
    since the gauge was ported) and both checkers report the same four
    off-thread reads."""
    from veles_tpu.analysis import concurrency as ref
    sources, _ = read_package(PORT)
    batcher = os.path.join(PORT, "serve", "batcher.py")
    stripped = [(p, re.sub(r"\s*# noqa: VC003", "", s) if p == batcher
                 else s) for p, s in sources]
    mine = [f for f in analyze_sources(stripped) if f.rule == "VC003"]
    theirs = [f for f in ref.analyze_sources(stripped)
              if f.rule == "VC003"]
    assert _lines(mine) == _lines(theirs)
    assert len(mine) == 4
    assert {f.path for f in mine} == {batcher}
    assert sum("TokenBatcher.engine" in f.message for f in mine) == 2
    assert sum("TokenBatcher._by_slot" in f.message for f in mine) == 2


def test_build_library_does_not_wait_on_another_kernels_build(
        monkeypatch):
    """``ops/_build.py``: while one kernel's ``nvcc`` runs (under its
    own lock), ``library()`` of an already loaded kernel and of a
    kernel of another name return at once; a second caller of the
    building kernel waits for it and gets the same library."""
    from veles_tpu_torch.ops import _build
    release = threading.Event()
    entered = threading.Event()
    builds = []

    def fake_build(names):
        name = names[0]
        builds.append(name)
        if name == "slow":
            entered.set()
            assert release.wait(30)
        return {name: "/%s.so" % name}

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.veles_error_string = lambda rc: b""

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_libs", {"loaded": FakeLib("/l.so")})
    monkeypatch.setattr(_build, "_name_locks", {})
    got = {}
    slow = threading.Thread(target=lambda: got.setdefault(
        "slow", _build.library("slow")))
    second = threading.Thread(target=lambda: got.setdefault(
        "slow2", _build.library("slow")))
    slow.start()
    assert entered.wait(30)
    second.start()
    t0 = time.monotonic()
    assert _build.library("loaded").path == "/l.so"
    assert _build.library("other").path == "/other.so"
    assert time.monotonic() - t0 < 5.0
    assert "slow" not in got and "slow2" not in got
    release.set()
    slow.join(30)
    second.join(30)
    assert got["slow"] is got["slow2"]
    assert builds.count("slow") == 1 and builds.count("other") == 1


HOT_MODULES = ["serve/batcher.py", "serve/router.py", "serve/fleet.py",
               "distributed/server.py", "distributed/relay.py",
               "sched/scheduler.py", "checkpoint.py", "thread_pool.py",
               "aot/cache.py", "ops/_build.py"]


@pytest.mark.parametrize("rel", HOT_MODULES)
def test_hot_modules_carry_annotations(rel):
    """The annotation sweep stays in place: every hot threaded module
    of the port declares machine-checked guarded or owned state."""
    with open(os.path.join(PORT, rel)) as fin:
        text = fin.read()
    assert "guarded-by:" in text or "owned-by:" in text, \
        "%s lost its concurrency annotations" % rel


def test_port_keeps_every_reference_annotation():
    """Every ``# owned-by:``, ``# runs-on:`` and ``# holds:`` the
    reference's modules carry stands in the port's counterpart of the
    module, and the batcher's ownership story is machine-checked."""
    pattern = re.compile(r"#.*?\b(owned-by|runs-on|holds):\s*"
                         r"([\w-]+(?:\s*,\s*[\w-]+)*)")
    ref_root = os.path.join(REPO, "veles_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref_root):
        if "analysis" in dirpath.split(os.sep):
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), ref_root)
            port = os.path.join(PORT, rel)
            with open(os.path.join(dirpath, name)) as fin:
                want = pattern.findall(fin.read())
            if not want or not os.path.exists(port):
                continue
            with open(port) as fin:
                have = pattern.findall(fin.read())
            for item in want:
                if item in have:
                    have.remove(item)
                else:
                    missing.append((rel, item))
    assert not missing, missing
    with open(os.path.join(PORT, "serve", "batcher.py")) as fin:
        batcher = fin.read()
    assert "# owned-by: dispatch" in batcher
    assert "# runs-on: dispatch" in batcher


def test_checker_cli_module_runs_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.concurrency"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout


def test_checker_cli_explicit_file_strict(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(ABBA)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.concurrency",
         str(bad)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    assert "VC001" in proc.stdout
