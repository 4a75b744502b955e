"""The port's device-memory plan (``veles_tpu_torch/analysis/
memplan.py``) on the CPU: the counterpart of ``tests/test_memplan.py``.

The static half (VM001-VM004) reads the port's source: rebinding state
that should be updated in place, large tensors created under a
capture, per-step host pulls and device allocations in dispatch loops.
The dynamic half scans the aten ops a computation dispatches with
free-at-last-use live ranges (``MemTrace``), and gates the registry's
footprints against a committed golden file, one set a torch release.

The registry's configs and params are the reference's, so the plans'
``resident_mb`` and ``donated_mb`` are held to the reference's
``scripts/memplan_baseline.json``; where they differ by more than
0.01 MB the test names the tensors that make the difference and checks
the difference is their bytes. ``PagedGenerativeEngine.plan_footprint``
plans a live engine's round on ``meta`` shadows (no tensor of the
engine is touched), on one device and on each rank of a tp=2 world.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from veles_tpu_torch.analysis import memplan
from veles_tpu_torch.analysis.jaxpr_audit import torch_release
from veles_tpu_torch.analysis.memplan import check_source

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "veles_tpu_torch")
GOLDEN = os.path.join(PORT, "analysis", "baselines",
                      "memplan_baseline.json")
MIB = 1024 * 1024


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# the static VM rules
# ---------------------------------------------------------------------------

def test_vm001_rebinding_state_from_itself():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def __init__(self):
                self.cache = torch.zeros(4)
                self.cache = self.cache + 1      # constructor: fine

            def step(self):
                self.cache = torch.where(self.cache > 0, self.cache, 0.0)

            def round(self):
                self.cache = self._dev("_device_round", self.cache)
    """)
    findings = check_source(src)
    assert _rules(findings) == ["VM001", "VM001"]
    assert "in place" in findings[0].message


def test_vm001_in_place_update_is_clean():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def __init__(self):
                self.cache = torch.zeros(4)

            def step(self):
                self.cache.copy_(torch.where(self.cache > 0, self.cache,
                                             0.0))
                self.count = self.count + 1       # a host int
    """)
    assert not check_source(src)


def test_vm002_large_tensor_inside_a_capture_root():
    src = textwrap.dedent("""
        import torch
        from veles_tpu_torch.graphs import StepGraph

        def body(x):
            scratch = torch.zeros((1024, 1024))          # 4 MiB f32
            small = torch.zeros(16, dtype=torch.bfloat16)
            return x + scratch.sum() + small.sum()

        def eager(x):
            return x + torch.zeros((1024, 1024)).sum()

        g = StepGraph(body)
    """)
    findings = check_source(src)
    assert [(f.rule, f.line) for f in findings] == [("VM002", 6)]
    assert "4.0 MiB" in findings[0].message


def test_vm003_per_step_pull_and_round_trip():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def loop(self, steps):
                for _ in range(steps):
                    out = self.graph.replay()
                    host = out.cpu()
                return host

            def once(self, steps):
                for _ in range(steps):
                    out = self.graph.replay()
                return out.cpu()

            def round_trip(self):
                out = self._dev("_device_round")
                host = out.cpu()
                return torch.as_tensor(host, device="cuda")
    """)
    findings = check_source(src)
    assert [(f.rule, f.line) for f in findings] == [("VM003", 8),
                                                    ("VM003", 19)]


def test_vm004_allocation_in_a_dispatch_loop_and_reupload():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def loop(self, steps):
                for _ in range(steps):
                    mask = torch.zeros(8, device=self.device)
                    self.graph.replay(mask)

            def hoisted(self, steps):
                mask = torch.zeros(8, device=self.device)
                for _ in range(steps):
                    self.graph.replay(mask)

            def reupload(self):
                table = torch.as_tensor(self._tables, device=self.device)
                return self._dev("_device_round", table)
    """)
    findings = check_source(src)
    assert [(f.rule, f.line) for f in findings] == [("VM004", 7),
                                                    ("VM004", 16)]


def test_vm_noqa_suppression():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def reupload(self):
                table = torch.as_tensor(  # noqa: VM004
                    self._tables, device=self.device)
                return self._dev("_device_round", table)
    """)
    assert not check_source(src)


def test_package_static_rules_clean():
    findings = memplan.check_package()
    assert not findings, "\n".join(str(f) for f in findings)


# ---------------------------------------------------------------------------
# live ranges
# ---------------------------------------------------------------------------

def test_in_place_write_is_the_donation_and_allocates_nothing():
    state = {"x": torch.zeros(1024)}                      # 4 KiB

    def step():
        state["x"].add_(1.0)

    plan = memplan.estimate_callable(step, (), roots={"": state})
    assert plan["peak_bytes"] == plan["resident_bytes"] == 4096
    assert plan["donated_bytes"] == 4096
    assert plan["written"] == ["x"]


def test_temporaries_free_at_last_use():
    """a -> b -> c: at most two temporaries of 4 KiB live at once (each
    freed after its last use), c survives as the output."""
    x = torch.ones(1024)
    keep = {}

    def chain():
        a = x * 2
        b = a + 1
        keep["c"] = b * 3

    plan = memplan.estimate_callable(chain, (), roots={"x": x})
    assert plan["peak_bytes"] == 3 * 4096          # x + two temporaries
    assert plan["resident_bytes"] == 2 * 4096      # x + the survivor c
    assert plan["donated_bytes"] == 0


def test_views_allocate_nothing_and_copies_do():
    x = torch.ones(64, 64)

    def views():
        y = x.t().reshape(-1)                       # a copy (not viewable)
        return x[:, :8], x.view(-1), y

    plan = memplan.estimate_callable(views, (), roots={"x": x})
    assert plan["resident_bytes"] == 2 * 64 * 64 * 4


def test_footprint_provenance_fields():
    from veles_tpu_torch.aot.registry import canonical_computations
    comp = canonical_computations()[0]
    fn, args = comp.build("cpu")
    plan = memplan.estimate_callable(fn, args)
    for key in ("peak_mb", "resident_mb", "donated_mb", "peak_src",
                "top_buffers", "workspace_bytes", "written"):
        assert key in plan
    assert plan["peak_src"].startswith(("op[", "resident"))
    top = plan["top_buffers"][0]
    assert set(top) == {"mb", "src", "shape", "dtype"}
    assert top["src"] == "params.0.w" and top["shape"] == "64x128"


def test_kernel_workspace_is_added_where_the_plain_version_runs():
    """K5's split partials are added at the wrapper: the plan of a paged
    decode attend is the plain version's plus ``part``'s bytes."""
    from veles_tpu_torch.ops import flash_attention as fa
    b, h, d, ps, n_blk = 2, 4, 32, 16, 8
    q = torch.zeros(b, h, d)
    pages = torch.zeros(b * n_blk + 1, ps, h, d)
    tables = torch.arange(b * n_blk, dtype=torch.int32).reshape(b, n_blk)
    lengths = torch.tensor([5, 100], dtype=torch.int32)
    plan = memplan.estimate_callable(
        lambda: fa.flash_decode_paged(q, pages, pages, tables, lengths),
        (), roots={"": [q, pages, tables, lengths]})
    want = fa.kernel_workspace("flash_decode_paged", b, h, d,
                               capacity=n_blk * ps)
    assert want == b * h * fa.decode_chunks(n_blk * ps) * (d + 2) * 4
    assert plan["workspace_bytes"] == want


# ---------------------------------------------------------------------------
# the registry and the golden footprints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    return memplan.plan_all()


def test_committed_baseline_covers_the_whole_registry():
    from veles_tpu.aot.registry import canonical_computations as ref
    with open(GOLDEN) as fin:
        doc = json.load(fin)
    names = {c.name for c in ref()}
    assert torch_release() in doc["torch"]
    for release, entry in doc["torch"].items():
        assert set(entry["computations"]) == names, release
        for plan in entry["computations"].values():
            assert plan["peak_mb"] >= plan["resident_mb"] > 0
    assert doc["justifications"]


def test_footprints_match_the_committed_golden(plans):
    baseline, _ = memplan.load_footprint_baseline(GOLDEN)
    assert memplan.compare_footprints(plans, baseline) == []


def test_registry_donations_are_written_in_place(plans):
    """Each entry's declared donation names tensors its site updates in
    place (the counterpart of ``donate_argnums`` being declared)."""
    assert memplan.check_donations(plans) == []
    for name, plan in plans.items():
        for donated in plan["donation"]:
            assert memplan.donation_matches(donated, plan["written"]), \
                (name, donated)


def test_a_lost_donation_is_flagged(plans):
    fake = {"paged_decode": dict(plans["paged_decode"],
                                 donation=["cache", "draft_cache"])}
    failures = memplan.check_donations(fake)
    assert len(failures) == 1 and "draft_cache" in failures[0]


def test_donation_name_matching():
    labels = ["_cache.k", "_state.lengths", "engine._last_tokens"]
    assert memplan.donation_matches("cache", labels) == ["_cache.k"]
    assert memplan.donation_matches("lengths", labels) == \
        ["_state.lengths"]
    assert memplan.donation_matches("last_tokens", labels)
    assert memplan.donation_matches("state", labels) == ["_state.lengths"]
    assert not memplan.donation_matches("k", ["_cache.kv"])


def _storages(tree):
    return {k: t for k, (_, t) in memplan.held_tensors({"": tree}).items()}


def _reference_plans():
    with open(os.path.join(REPO, "scripts", "memplan_baseline.json")) as f:
        return json.load(f)["computations"]


def _explained(name):
    """The port's tensors that make its resident set differ from the
    reference's at the canonical config, and their bytes."""
    from veles_tpu_torch.aot import registry
    if name not in ("generative_decode", "paged_decode"):
        return {}
    build = registry._build_generative_decode \
        if name == "generative_decode" else registry._build_paged_decode
    engine = build("cpu")[0].__self__
    params = _storages(engine.params)
    extra = {"_weights not shared with params (compute_weights: the "
             "bf16 copies of the matrices and the f32 LM-head operand)":
             sum(t.untyped_storage().nbytes() for k, t in
                 _storages(engine._weights).items() if k not in params)}
    if name == "paged_decode":
        # the pool's trash page: the port's cache holds n_pages + 1
        # pages, the reference's n_pages
        extra["_cache trash page"] = sum(
            t.numel() * t.element_size()
            for t in engine._cache.values()) - \
            _reference_paged_cache_bytes()
    return extra


def _reference_paged_cache_bytes():
    """The reference's paged K/V pool bytes at the canonical config."""
    from veles_tpu.aot import registry as ref
    engine = ref._paged_engine()
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in engine._cache.values())


@pytest.mark.parametrize("name", ["engine_forward", "generative_decode",
                                  "paged_decode", "lm_step_many"])
def test_resident_and_donated_match_the_reference(plans, name):
    """Same configs, same params: resident and donated MB are the
    reference's within 0.01 MB, or differ by exactly the bytes of the
    named port tensors."""
    ref = _reference_plans()[name]
    mine = plans[name]
    extra = _explained(name)
    explained_mb = sum(extra.values()) / MIB
    assert abs(mine["resident_mb"] - ref["resident_mb"] -
               explained_mb) <= 0.01, (name, mine["resident_mb"],
                                       ref["resident_mb"], extra)
    donated_extra = extra.get("_cache trash page", 0) / MIB
    assert abs(mine["donated_mb"] - ref["donated_mb"] -
               donated_extra) <= 0.01, (name, mine["donated_mb"],
                                        ref["donated_mb"], extra)
    if name in ("generative_decode", "paged_decode"):
        assert extra and all(v > 0 for v in extra.values()), extra
        assert abs(mine["resident_mb"] - ref["resident_mb"]) > 0.01


@pytest.mark.parametrize("name", ["engine_forward", "generative_decode",
                                  "paged_decode", "lm_step_many"])
def test_peak_within_2x_of_the_reference(plans, name):
    """Peak bound, 2x either way: the same computation planned over
    other ops. The reference scans XLA's fused graph (no f32 copies of
    K/V, no unfused softmax temporaries); the port scans eager aten ops
    through the kernels' plain versions, which materialize f32 copies
    and blocked score tiles the kernels keep in registers, and holds
    its bf16 weight copies resident."""
    ref = _reference_plans()[name]["peak_mb"]
    mine = plans[name]["peak_mb"]
    assert ref / 2 <= mine <= ref * 2, (name, mine, ref)


def _run_memplan(args=(), env=None, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.analysis.memplan", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


def test_footprint_gate_flips_on_seeded_peak_growth():
    proc = _run_memplan(("--footprint-only",),
                        {"VELES_MEMPLAN_DRIFT": "grow"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "engine_forward" in proc.stdout
    assert "16.000 MB" in proc.stdout


def test_footprint_update_requires_reason(tmp_path):
    path = tmp_path / "b.json"
    proc = _run_memplan(("--footprint-only", "--baseline", str(path),
                         "--update-baseline"))
    assert proc.returncode == 1
    assert "--reason" in proc.stdout
    assert not path.exists()


def test_footprint_update_records_justifications(tmp_path):
    path = tmp_path / "b.json"
    for reason in ("first", "second"):
        proc = _run_memplan(("--footprint-only", "--baseline", str(path),
                             "--update-baseline", "--reason", reason))
        assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(path.read_text())
    assert doc["justifications"] == ["first", "second"]
    assert len(doc["torch"][torch_release()]["computations"]) == 11


def test_gate_names_new_and_vanished_computations():
    base = {"a": {"peak_mb": 1.0, "top_buffers": []},
            "b": {"peak_mb": 1.0, "top_buffers": []}}
    cur = {"b": {"peak_mb": 1.2, "peak_src": "op[3]:aten.mm",
                 "top_buffers": [{"mb": 0.2, "src": "op[3]:aten.mm",
                                  "shape": "8x8", "dtype": "float32"}]},
           "c": {"peak_mb": 1.0, "top_buffers": []}}
    failures = memplan.compare_footprints(cur, base)
    assert [f.split(":")[0] for f in failures] == ["a", "b", "c"]
    assert "VANISHED" in failures[0] and "NEW" in failures[2]
    assert "8x8" in failures[1] and "+20.0%" in failures[1]
    cur["b"]["peak_mb"] = 1.04                        # within 5%
    assert len(memplan.compare_footprints(cur, base)) == 2


# ---------------------------------------------------------------------------
# a live engine's plan
# ---------------------------------------------------------------------------

def _paged_engine(**kwargs):
    from veles_tpu_torch.aot import registry
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve import PagedGenerativeEngine
    config = registry._lm_config()
    return PagedGenerativeEngine(config, init_params(config, seed=0),
                                 max_slots=4, page_size=16, device="cpu",
                                 **kwargs)


def test_plan_footprint_touches_no_tensor_of_the_engine(plans):
    """The round runs on meta shadows: after a plan of an engine with a
    live sequence, every tensor of the engine is bitwise what it was,
    and the plan is the registry's paged_decode plan (same geometry)."""
    engine = _paged_engine()
    engine.admit([np.arange(1, 17, dtype=np.int32)])
    held = memplan.held_tensors({"": engine})
    before = {k: t.clone() for k, (_, t) in held.items()}
    plan = engine.plan_footprint()
    for key, (label, t) in held.items():
        assert torch.equal(t, before[key]), label
    assert t.device.type == "cpu"
    # the registry entry runs decode_many (the host's uploads and the
    # round's transfer around the body): within a few bytes
    for key in ("peak_bytes", "resident_bytes"):
        assert abs(plan[key] - plans["paged_decode"][key]) <= 64, key
    assert "tp" not in plan
    assert plan["workspace_bytes"] > 0         # K5's partials, declared


def test_plan_footprint_scales_with_the_pool():
    small = _paged_engine(n_pages=16).plan_footprint()
    large = _paged_engine(n_pages=64).plan_footprint()
    page = 2 * 2 * 16 * 4 * 32 * 2          # K and V, 2 layers, bf16
    assert large["resident_bytes"] - small["resident_bytes"] == 48 * page
    assert large["donated_bytes"] - small["donated_bytes"] == 48 * page


def test_plan_footprint_on_a_tp2_world():
    """On each rank of a gloo world of 2, the plan is the rank's over
    its shards, with ``tp`` and ``kv_mb_per_shard`` beside it: half the
    K/V of one device, and less resident than one device holds."""
    import torch_memplan_workers as W

    from veles_tpu_torch.aot import registry
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.parallel import multiprocess as mp
    config = registry._lm_config()
    params = init_params(config, seed=0)
    ranks = mp.run_world(W.plan_world, 2, "gloo", "cpu",
                         args=(config, params), timeout_s=300, threads=1)
    one = _paged_engine().plan_footprint()
    one_kv = sum(t.numel() * t.element_size()
                 for t in _paged_engine()._cache.values())
    for out in ranks:
        plan = out["plan"]
        assert plan["tp"] == 2
        assert out["kv_bytes"] * 2 == one_kv
        assert plan["kv_mb_per_shard"] == round(out["kv_bytes"] / 1e6, 3)
        assert plan["resident_bytes"] < one["resident_bytes"]
        assert plan["peak_bytes"] < one["peak_bytes"]
    assert ranks[0]["plan"] == ranks[1]["plan"]


def test_pool_sizing_names_the_plan():
    from veles_tpu_torch.serve.paging import PagePool
    assert "plan_footprint" in PagePool.from_device.__doc__


def test_hbm_gauges_carry_the_plan():
    from veles_tpu_torch.obs import metrics
    samples = [s for s in metrics.hbm_samples()
               if s.metric.startswith("veles_hbm_plan_")]
    names = {dict(s.labels)["computation"] for s in samples}
    assert len(names) == 11
    kinds = {s.metric for s in samples}
    assert kinds == {"veles_hbm_plan_peak_mb", "veles_hbm_plan_resident_mb",
                     "veles_hbm_plan_donated_mb"}
    text = metrics.REGISTRY.prometheus_text()
    assert 'veles_hbm_plan_peak_mb{computation="paged_decode"}' in text
