"""The port's capture-surface pass (``veles_tpu_torch/analysis/
jitcheck.py``, VJ001-VJ003) and its golden dispatch-graph gate with the
VJ005 dtype audit (``analysis/jaxpr_audit.py``) on the CPU: the
counterparts of ``tests/test_jitcheck.py``.

The compute surface is what ``StepGraph`` captures, not ``jax.jit``:
VJ001 flags control flow on tensors there, VJ002 state rebound under a
capture (the port updates in place), VJ003 serve-plane captures whose
shapes skip ``bucket_for``. VJ004 has no counterpart (torch matmuls
declare no accumulation dtype). The golden graphs are the aten ops a
registry entry dispatches, one set a torch release.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from veles_tpu_torch.analysis import jaxpr_audit, jitcheck
from veles_tpu_torch.analysis.jitcheck import (check_package,
                                               check_source,
                                               check_sources)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "veles_tpu_torch")
BASELINES = os.path.join(PORT, "analysis", "baselines")


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# VJ001
# ---------------------------------------------------------------------------

def test_vj001_if_and_assert_on_a_tensor_in_a_capture():
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        class Step:
            def __init__(self):
                self.graph = StepGraph(self._body)

            def _body(self, x):
                if (x > 0).any():
                    x = x + 1
                assert torch.isfinite(x).all()
                while x.sum() > 10:
                    x = x / 2
                return x
    """)
    findings = check_source(src)
    assert _rules(findings) == ["VJ001", "VJ001", "VJ001"]
    assert "captured" in findings[0].message


def test_vj001_reaches_through_package_calls():
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        def helper(x):
            m = x.max()
            if m > 0:
                return x / m
            return x

        def body(x):
            return helper(x)

        g = StepGraph(body)
    """)
    findings = check_source(src)
    assert [(f.rule, f.line) for f in findings] == [("VJ001", 7)]


def test_vj001_host_control_flow_is_clean():
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        class Step:
            def __init__(self, config):
                self.config = config
                self.graph = StepGraph(self._body)

            def _body(self, x, active=None):
                if active is not None and x.shape[0] > 1:
                    x = x * active
                if self.config.heads > 2 and x.ndim == 3:
                    x = x.sum(dim=-1)
                for _ in range(x.shape[0]):
                    x = x + 1
                return x

            def eager(self, x):
                if x.sum() > 0:
                    return x
    """)
    assert not check_source(src)


# ---------------------------------------------------------------------------
# VJ002
# ---------------------------------------------------------------------------

REBOUND = textwrap.dedent("""
    import torch
    from veles_tpu_torch.graphs import StepGraph

    class Engine:
        def __init__(self):
            self.cache = torch.zeros(4)
            self.scale = 2.0
            self.graph = StepGraph(self._round)

        def _round(self):%s
            return self.cache * self.scale

        def reset(self):
            self.cache = torch.zeros(4)
""")


def test_vj002_rebound_state_under_a_capture():
    findings = check_source(REBOUND % "")
    assert _rules(findings) == ["VJ002"]
    assert "self.cache" in findings[0].message
    assert "Engine.reset" in findings[0].message


def test_vj002_static_marker_and_in_place_update_clean():
    assert not check_source(REBOUND % "  # veles-jit: static")
    in_place = (REBOUND % "").replace(
        "    def reset(self):\n        self.cache = torch.zeros(4)",
        "    def reset(self):\n        self.cache.zero_()")
    assert in_place != REBOUND % ""
    assert not check_source(in_place)


def test_vj002_roots_are_class_scoped():
    """A method captured in one class does not taint a same-named
    method of another class."""
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        class A:
            def __init__(self):
                self.x = torch.zeros(2)
                self.g = StepGraph(self.step)

            def step(self):
                return self.x + 1

        class B:
            def __init__(self):
                self.x = torch.zeros(2)

            def step(self):
                return self.x + 1

            def swap(self):
                self.x = torch.ones(2)
    """)
    assert not check_source(src)


# ---------------------------------------------------------------------------
# VJ003
# ---------------------------------------------------------------------------

SERVE = textwrap.dedent("""
    from veles_tpu_torch.graphs import StepGraph
    from veles_tpu_torch.serve.engine import bucket_for

    class Engine:
        def raw(self, x):
            g = StepGraph(self.fn, inputs=(x,))
            return g.replay(x)

        def bucketed(self, x):
            n = bucket_for(x.shape[0])
            return StepGraph(self.fn).replay(x[:n])

        def fixed(self):  # veles-jit: bucketed
            return StepGraph(self.fn).replay()

        def fn(self, x):
            return x
""")


def test_vj003_raw_shape_capture_flagged_in_the_serve_plane():
    findings = check_sources([("veles_tpu_torch/serve/x.py", SERVE)])
    assert [(f.rule, f.line) for f in findings] == [("VJ003", 7),
                                                    ("VJ003", 8)]
    assert "Engine.raw" in findings[0].message


def test_vj003_only_applies_to_the_serve_plane():
    assert not check_sources([("veles_tpu_torch/parallel/x.py", SERVE)])


def test_vj004_has_no_counterpart_and_says_why():
    assert set(jitcheck.RULES) == {"VJ001", "VJ002", "VJ003"}
    doc = jitcheck.__doc__
    assert "VJ004" in doc and "no counterpart" in doc
    assert "preferred_element_type" in doc


def test_noqa_suppresses():
    src = (REBOUND % "").replace("return self.cache * self.scale",
                                 "return self.cache * self.scale"
                                 "  # noqa: VJ002")
    assert not check_source(src)


def test_package_self_check_green():
    findings = check_package()
    assert not findings, "\n".join(str(f) for f in findings)


def test_package_markers_are_the_deliberate_ones():
    """Every ``# veles-jit:`` marker of the port is a deliberate one,
    with its reason beside it: the serve-plane captures of fixed (slots)
    or already-bucketed shapes, and the trainer step's params bound
    before any capture."""
    found = []
    for dirpath, _, files in os.walk(PORT):
        if os.path.basename(dirpath) == "analysis":
            continue              # the rules' own docstrings
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fin:
                    for line in fin:
                        if "# veles-jit:" in line and "def " in line:
                            found.append((name, line.split("(")[0]
                                          .split()[-1],
                                          line.split("veles-jit:")[1]
                                          .strip()))
    assert sorted(found) == [
        ("engine.py", "_device_apply", "bucketed"),
        ("engine.py", "_device_decode", "bucketed"),
        ("engine.py", "_graph_for", "bucketed"),
        ("engine.py", "_run_round", "bucketed"),
        ("transformer.py", "_train_step", "static")]


def test_jitcheck_cli_module_runs_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.jitcheck"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout


def test_jitcheck_cli_explicit_file_strict(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(REBOUND % "")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.jitcheck",
         str(bad)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1 and "VJ002" in proc.stdout


# ---------------------------------------------------------------------------
# VJ005 and the golden dispatch graphs
# ---------------------------------------------------------------------------

def test_vj005_counts_wide_upcasts_explicit_and_by_promotion():
    wide = torch.zeros((64, jaxpr_audit.WIDE_ELEMENTS // 64),
                       dtype=torch.bfloat16)
    small = torch.zeros(8, dtype=torch.bfloat16)
    f32 = torch.zeros((64, jaxpr_audit.WIDE_ELEMENTS // 64))

    def leaky():
        a = wide.float()              # explicit
        b = wide + f32                # implicit: bf16 + f32 -> f32
        c = small.float()             # narrow: below the threshold
        d = wide * 2                  # stays bf16
        return a, b, c, d

    stats = jaxpr_audit.trace_call(leaky, ()).stats()
    assert stats["wide_f32_upcasts"] == 2
    assert all("bfloat16[64x64]->f32" in s
               for s in stats["upcast_shapes"])
    stats.update(allowed_f32_upcasts=1, notes="none")
    failures = jaxpr_audit.check_dtype_policy({"leaky": stats})
    assert len(failures) == 1 and "VJ005" in failures[0]
    stats["allowed_f32_upcasts"] = 2
    assert jaxpr_audit.check_dtype_policy({"leaky": stats}) == []


def test_fingerprint_histograms():
    x = torch.ones(4)
    stats = jaxpr_audit.trace_call(lambda: (x + 1) * x, ()).stats()
    assert stats["eqns"] == 2
    assert stats["prims"] == {"aten.add.Tensor": 1, "aten.mul.Tensor": 1}
    assert stats["dtypes"] == {"float32": 2}


def test_registry_names_match_the_reference_and_the_golden_file():
    """One golden entry for each of the 11 registry names (the
    reference's names), for every torch release recorded, this one
    included."""
    from veles_tpu.aot.registry import canonical_computations as ref
    from veles_tpu_torch.aot.registry import canonical_computations
    names = {c.name for c in canonical_computations()}
    assert names == {c.name for c in ref()} and len(names) == 11
    with open(os.path.join(BASELINES, "jaxpr_baseline.json")) as fin:
        doc = json.load(fin)
    assert jaxpr_audit.torch_release() in doc["torch"]
    for release, entry in doc["torch"].items():
        assert set(entry["computations"]) == names, release
    assert doc["justifications"]


def test_registry_allowances_are_named():
    """Each entry's allowance is what its graph holds, and a non-zero
    allowance names its upcasts in ``notes``."""
    from veles_tpu_torch.aot.registry import canonical_computations
    with open(os.path.join(BASELINES, "jaxpr_baseline.json")) as fin:
        golden = json.load(fin)["torch"][jaxpr_audit.torch_release()][
            "computations"]
    for comp in canonical_computations():
        assert golden[comp.name]["wide_f32_upcasts"] == \
            comp.allowed_f32_upcasts, comp.name
        if comp.allowed_f32_upcasts:
            assert "upcast" in comp.notes or "f32" in comp.notes, comp.name


def _gate(args=(), env_extra=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=env)


def test_jaxpr_gate_flips_on_seeded_extra_op():
    proc = _gate(("--tool", "jaxpr"), {"VELES_JAXPR_DRIFT": "extra-op"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "engine_forward" in proc.stdout
    assert "drift" in proc.stdout and "aten.sin" in proc.stdout


def test_jaxpr_gate_flips_on_seeded_dtype_change():
    proc = _gate(("--tool", "jaxpr"), {"VELES_JAXPR_DRIFT": "dtype"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "generative_prefill" in proc.stdout
    assert "VJ005" in proc.stdout and "dtype" in proc.stdout


def _digest():
    return {name: hashlib.sha256(open(os.path.join(BASELINES, name),
                                      "rb").read()).hexdigest()
            for name in sorted(os.listdir(BASELINES))}


def test_gate_update_without_reason_touches_no_baselines():
    before = _digest()
    proc = _gate(("--update-baseline",), timeout=120)
    assert proc.returncode == 1
    assert "--reason" in proc.stdout
    assert "no baselines were touched" in proc.stdout
    assert _digest() == before


def test_jaxpr_update_baseline_requires_reason(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.jaxpr_audit",
         "--baseline", str(tmp_path / "b.json"), "--update-baseline"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "--reason" in proc.stdout
    assert not (tmp_path / "b.json").exists()


def test_jaxpr_update_baseline_records_justification(tmp_path):
    path = tmp_path / "b.json"
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.jaxpr_audit",
         "--baseline", str(path), "--update-baseline",
         "--reason", "test-justification line"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(path.read_text())
    assert doc["justifications"] == ["test-justification line"]
    entry = doc["torch"][jaxpr_audit.torch_release()]
    assert set(entry["computations"]) >= {"engine_forward",
                                          "lm_step_many"}
    # a second release's set would sit beside it; the gate reads this
    # release's
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.jaxpr_audit",
         "--baseline", str(path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_gate_names_new_and_vanished_computations():
    failures = jaxpr_audit.compare(
        {"a": {"eqns": 1, "prims": {}, "dtypes": {}},
         "b": {"eqns": 1, "prims": {}, "dtypes": {}}},
        {"b": {"eqns": 2, "prims": {}, "dtypes": {}},
         "c": {"eqns": 1, "prims": {}, "dtypes": {}}})
    assert len(failures) == 3
    assert failures[0].startswith("a: NEW")
    assert failures[1].startswith("b: golden-graph drift")
    assert failures[2].startswith("c: computation VANISHED")


@pytest.mark.parametrize("release", ["1.0", "9.9"])
def test_a_release_without_goldens_fails(tmp_path, release):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"torch": {release: {"computations": {
        "x": {}}}}}))
    assert jaxpr_audit.load_baseline(str(path))[0] == {}
