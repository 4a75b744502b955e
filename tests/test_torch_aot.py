"""The port's AOT plane (``veles_tpu_torch.aot``) and capture counter
(``analysis/recompile.py``) on the CPU: the counterparts of the JAX
package's ``tests/test_aot.py`` and ``tests/test_analysis.py``
recompile tests, where a capture record stands for an exported
computation (a captured CUDA graph cannot be serialized).

On the CPU nothing is captured: the engines record each new shape in a
capture's place and the records carry no launches (nothing launches),
so the plan's hits, misses, mismatches and fallbacks, the startup
report and the warm ladders run here as on the card; the card tests
(``tests/test_torch_cuda.py -k aot``) count real captures and launch
tallies. A planned run is bitwise an unplanned one (records never
change which kernels run). The kernel layer (``DIR/kernels/``) is
driven with a stand-in ``nvcc`` on ``PATH`` that writes a file and
logs its calls.
"""

import ast
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import torch_serve_workers as W
import veles_tpu_torch
from veles_tpu_torch import aot
from veles_tpu_torch.analysis.recompile import (CaptureWatcher,
                                                RecompileError,
                                                assert_max_captures)
from veles_tpu_torch.aot import cache as aot_cache
from veles_tpu_torch.aot import export, registry
from veles_tpu_torch.aot import package as aot_package
from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerTrainer,
                                                init_params)
from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.ops import _build
from veles_tpu_torch.parallel import multiprocess as mp
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
from veles_tpu_torch.serve.engine import (GenerativeEngine, InferenceEngine,
                                          PagedGenerativeEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(os.path.abspath(veles_tpu_torch.__file__))

MLP_SPECS = (("fc", "tanh"), ("fc", "softmax"))
LM = TransformerConfig(vocab=61, embed=32, heads=2, layers=1, seq_len=32)
LM_PARAMS = init_params(LM, seed=3)


def _mlp_params(seed=0, fan_in=8, hidden=16, out=4):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((fan_in, hidden)).astype(np.float32),
             "b": np.zeros(hidden, np.float32)},
            {"w": rng.standard_normal((hidden, out)).astype(np.float32),
             "b": np.zeros(out, np.float32)}]


def _mlp(**kw):
    return InferenceEngine.from_specs(MLP_SPECS, _mlp_params(),
                                      device="cpu", **kw)


@pytest.fixture
def aot_env(tmp_path, monkeypatch):
    """A cache directory, the extraction cache under ``tmp_path``, and
    no plan or kernel directory left behind."""
    monkeypatch.setattr(aot_package, "_cache_root",
                        lambda: str(tmp_path / "extract"))
    aot_package.clear_extraction_memo()
    yield str(tmp_path / "cache")
    aot.deactivate()
    _build.set_library_dir(None)
    aot_package.clear_extraction_memo()


# -- the blob and the record --------------------------------------------------

def _record(name="forward/2x8", fp="f" * 64, launches=None):
    return export.make_record(name, fp, [[[2, 8], "float32"]], (),
                              launches or {}, True)


def test_blob_format_rejects_corruption():
    blob = export.pack_record(_record())
    assert export.unpack_record(blob)["name"] == "forward/2x8"
    flipped = bytearray(blob)
    flipped[-3] ^= 0x40
    with pytest.raises(export.AotUnavailable, match="crc"):
        export.unpack_record(bytes(flipped))
    with pytest.raises(export.AotUnavailable, match="length"):
        export.unpack_record(blob[:-5])
    with pytest.raises(export.AotUnavailable, match="header"):
        export.unpack_record(export.BLOB_MAGIC + b"{not json\n")
    # the JAX package's StableHLO blob: a clean miss, never a parse
    from veles_tpu.aot.export import pack_blob as r_pack_blob
    with pytest.raises(export.AotUnavailable, match="bad magic"):
        export.unpack_record(r_pack_blob(b"\x00stablehlo", {"name": "x"}))
    # a record of another format version is refused
    other = export.pack_blob(json.dumps(_record()).encode(),
                             {"name": "x", "fingerprint": "f",
                              "format": 99})
    with pytest.raises(export.AotUnavailable, match="format"):
        export.unpack_record(other)


def test_record_differences_name_the_fields():
    a = _record(launches={"lrn_fwd": 2})
    assert export.record_differences(a, dict(a)) == []
    b = dict(a, launches={"lrn_fwd": 3}, donation=["cache"])
    assert export.record_differences(a, b) == ["donation", "launches"]


def test_artifact_cache_lru_eviction(tmp_path):
    blobs = [export.pack_record(_record("e%d" % i)) for i in range(4)]
    c = aot_cache.ArtifactCache(str(tmp_path), max_bytes=3 * len(blobs[0]))
    for i in range(3):
        c.put("fp", "e%d" % i, blobs[i])
        os.utime(os.path.join(tmp_path, "fp", aot_cache.entry_file(
            "e%d" % i)), (1000 + i, 1000 + i))
    assert c.get("fp", "e0") is not None          # e0 is now the newest
    c.put("fp", "e3", blobs[3])
    assert c.stats()["evictions"] == 1
    assert sorted(c.entries("fp")) == ["e0", "e2", "e3"]
    assert c.total_bytes() <= 3 * len(blobs[0])


def test_artifact_cache_counters_and_corrupt_entry(tmp_path):
    c = aot_cache.ArtifactCache(str(tmp_path))
    assert c.get("fp", "x") is None
    c.put("fp", "x", export.pack_record(_record()))
    assert c.get("fp", "x") is not None
    path = os.path.join(tmp_path, "fp", aot_cache.entry_file("x"))
    with open(path, "r+b") as f:
        f.seek(-2, 2)
        f.write(b"!!")
    assert c.get("fp", "x") is None
    assert not os.path.exists(path)
    stats = c.stats()
    assert (stats["hits"], stats["misses"], stats["puts"],
            stats["corrupt"]) == (1, 2, 1, 1)


def test_aot_metrics_registered(aot_env):
    plan = aot.configure(cache_dir=aot_env)
    _mlp().apply(np.zeros((2, 8), np.float32))
    text = obs_metrics.REGISTRY.prometheus_text()
    for name in ("veles_aot_hits_total", "veles_aot_misses_total",
                 "veles_aot_fallbacks_total", "veles_aot_cache_bytes"):
        assert name in text
    assert plan.status_doc()["misses"] == 1
    aot.deactivate()
    assert "veles_aot_" not in obs_metrics.REGISTRY.prometheus_text()


# -- fingerprints -------------------------------------------------------------

_FP_SCRIPT = """
import numpy as np
from veles_tpu_torch.serve.engine import InferenceEngine, GenerativeEngine
from veles_tpu_torch.models.transformer import TransformerConfig, init_params
rng = np.random.default_rng(0)
params = [{"w": rng.standard_normal((8, 16)).astype(np.float32),
           "b": np.zeros(16, np.float32)},
          {"w": rng.standard_normal((16, 4)).astype(np.float32),
           "b": np.zeros(4, np.float32)}]
e = InferenceEngine.from_specs((("fc", "tanh"), ("fc", "softmax")), params,
                               device="cpu")
c = TransformerConfig(vocab=61, embed=32, heads=2, layers=1, seq_len=32)
g = GenerativeEngine(c, init_params(c, seed=3), max_slots=2, device="cpu")
print(e._fingerprint(), g._fingerprint())
"""


def test_fingerprints_stable_across_processes():
    out = subprocess.run([sys.executable, "-c", _FP_SCRIPT], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    here = [_mlp()._fingerprint(), GenerativeEngine(
        LM, LM_PARAMS, max_slots=2, device="cpu")._fingerprint()]
    assert out.stdout.split() == here


def test_fingerprint_changes_with_each_identity_field(monkeypatch):
    base = _mlp()._fingerprint()
    assert _mlp()._fingerprint() == base               # deterministic
    # weights ride as tensors: other values, the same fingerprint
    assert InferenceEngine.from_specs(
        MLP_SPECS, _mlp_params(seed=1), device="cpu")._fingerprint() == base
    others = {
        "config": InferenceEngine.from_specs(
            (("fc", "relu"), ("fc", "softmax")), _mlp_params(),
            device="cpu"),
        "param shape": InferenceEngine.from_specs(
            MLP_SPECS, _mlp_params(hidden=12), device="cpu"),
        "dtype policy": _mlp(compute_dtype="bfloat16"),
        "input dtype": _mlp(input_dtype=np.float16),
    }
    prints = {k: e._fingerprint() for k, e in others.items()}
    assert base not in prints.values(), prints
    assert len(set(prints.values())) == len(prints)
    leaf = [{"w": np.zeros((2, 3), np.float32)}]
    assert export.fingerprint("k", {"p": export.tree_signature(leaf)}) != \
        export.fingerprint("k", {"p": export.tree_signature(
            [{"w": np.zeros((2, 3), np.float16)}])})
    # the slab shape
    slab = GenerativeEngine(LM, LM_PARAMS, max_slots=2, device="cpu")
    assert GenerativeEngine(LM, LM_PARAMS, max_slots=4, device="cpu") \
        ._fingerprint() != slab._fingerprint()
    assert GenerativeEngine(LM, LM_PARAMS, max_slots=2, max_len=16,
                            device="cpu")._fingerprint() != \
        slab._fingerprint()
    # the environment: another card, toolkit or kernel source
    env = export.environment_signature("cpu")
    assert env["platform"] == "cpu" and env["capability"] is None
    for key, value in (("device", "NVIDIA H100 80GB HBM3"),
                       ("cuda", "12.8"), ("kernels", "0" * 16)):
        monkeypatch.setattr(export, "environment_signature",
                            lambda device=None, k=key, v=value:
                            dict(env, **{k: v}))
        assert _mlp()._fingerprint() != base, key
    monkeypatch.undo()
    assert _mlp()._fingerprint() == base


def test_mesh_topology_enters_aot_fingerprint():
    """On a tp=2 serve mesh (a gloo world of 2) every engine's
    signature carries the mesh and its fingerprint differs from the
    unsharded engine's; both ranks agree; an engine off a mesh carries
    no mesh field."""
    ranks = mp.run_world(W.aot_fingerprint_world, 2, "gloo", "cpu",
                         args=(LM, LM_PARAMS), timeout_s=300, threads=1)
    assert ranks[0] == ranks[1]
    for name, (single, sharded, fp1, fp2) in ranks[0].items():
        assert single is None, name
        assert ["model", 2] in sharded["axes"] and \
            sharded["processes"] == 2, name
        assert fp1 != fp2, name
    assert ranks[0]["slab"][2] == GenerativeEngine(
        LM, LM_PARAMS, max_slots=2, device="cpu")._fingerprint()


# -- the plan on the engines and trainers -------------------------------------

def _engines():
    return {
        "apply": _mlp(),
        "slab": GenerativeEngine(LM, LM_PARAMS, max_slots=2, device="cpu"),
        "paged": PagedGenerativeEngine(LM, LM_PARAMS, max_slots=2,
                                       page_size=8, device="cpu")}


def _drive(engines):
    engines["apply"].apply(np.ones((3, 8), np.float32))
    engines["slab"].generate([np.arange(1, 5, dtype=np.int32)], 3)
    engines["paged"].generate([np.arange(1, 5, dtype=np.int32)], 3)


def _outcomes(sites):
    return {k: (s.aot_hits, s.aot_misses, s.aot_fallbacks)
            for k, s in sites.items()}


def test_plan_hit_miss_mismatch_on_the_three_engines(aot_env):
    plan = aot.configure(cache_dir=aot_env)
    first = _engines()
    _drive(first)
    assert _outcomes(first) == {k: (0, 1, 0) for k in first}
    assert plan.misses == 3 and plan.exports == 3
    names = sorted(plan.planned(first["apply"]._fingerprint()))
    assert names == ["forward/4x8"]
    assert plan.planned(first["slab"]._fingerprint()) == ["decode"]
    assert plan.planned(first["paged"]._fingerprint()) == ["decode"]
    # a second process on the same directory: every entry planned
    plan = aot.configure(cache_dir=aot_env)
    second = _engines()
    _drive(second)
    assert _outcomes(second) == {k: (1, 0, 0) for k in second}
    assert (plan.hits, plan.misses, plan.fallbacks) == (3, 0, 0)
    # a record unlike the capture: logged, a fallback, rewritten
    fp = second["apply"]._fingerprint()
    tampered = dict(export.unpack_record(plan.cache.get(fp, "forward/4x8")),
                    launches={"lrn_fwd": 2})
    plan.cache.put(fp, "forward/4x8", export.pack_record(tampered))
    plan = aot.configure(cache_dir=aot_env)
    third = _engines()
    _drive(third)
    assert _outcomes(third)["apply"] == (0, 0, 1)
    assert (plan.mismatches, plan.fallbacks) == (1, 1)
    assert export.unpack_record(plan.cache.get(fp, "forward/4x8"))[
        "launches"] == {}
    # a corrupt record: removed, a miss, captured afresh
    path = os.path.join(aot_env, "artifacts", fp,
                        aot_cache.entry_file("forward/4x8"))
    with open(path, "wb") as f:
        f.write(b"torn")
    plan = aot.configure(cache_dir=aot_env)
    fourth = _engines()
    _drive(fourth)
    assert _outcomes(fourth)["apply"] == (0, 1, 0)
    assert plan.cache.stats()["corrupt"] == 1


def test_unplanned_engine_counts_nothing(aot_env):
    engines = _engines()
    _drive(engines)
    assert _outcomes(engines) == {k: (0, 0, 0) for k in engines}
    # a custom forward opts out of the plan
    plan = aot.configure(cache_dir=aot_env)
    custom = InferenceEngine(lambda p, x: x * 2, [], device="cpu")
    assert custom.aot_signature is None
    custom.apply(np.ones((2, 3), np.float32))
    assert plan.misses == 0 and custom.aot_misses == 0


def _mlp_trainer():
    return FusedClassifierTrainer(MLP_SPECS, _mlp_params(),
                                  learning_rate=0.1, device="cpu")


def _batches(k=2, n=6):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((k, n, 8)).astype(np.float32),
            rng.integers(0, 4, (k, n)))


def _lm_tokens(k=2):
    rng = np.random.default_rng(9)
    return rng.integers(0, LM.vocab, (k, 2, LM.seq_len + 1))


def _loader_setup(trainer):
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    rng = np.random.default_rng(4)
    data = rng.standard_normal((32, 8)).astype(np.float32)
    labels = rng.integers(0, 4, 32).astype(np.int32)

    class Loader(FullBatchLoader):
        def load_data(self):
            self.has_labels = True
            self.original_data = data
            self.original_labels = labels
            self.class_lengths[:] = [0, 0, len(data)]

    loader = Loader(AcceleratedWorkflow(None, name="wf"), minibatch_size=4,
                    shuffle_limit=0)
    loader.initialize(device=Device(backend="cpu"))
    loader.minibatch_class = TRAIN
    return trainer.make_loader_step(loader, steps_per_dispatch=2), loader


def _state(trainer):
    if isinstance(trainer, TransformerTrainer):
        return [t.detach().clone() for t in
                export._tree_leaves([trainer.params, trainer.opt_m,
                                     trainer.opt_v])]
    return [t.detach().clone() for t in
            export._tree_leaves([trainer.params, trainer.velocity])]


def _run(kind, dispatches, resume=None):
    """(trainer, [losses]) after ``dispatches`` dispatches of ``kind``;
    ``resume``: the state to continue from (a trainer restored by
    ``load_state``, as a new process would)."""
    if kind == "lm":
        trainer = TransformerTrainer(LM, device="cpu", seed=1)
        if resume is not None:
            trainer.load_state(*resume)
        step = lambda: trainer.step_many(_lm_tokens())  # noqa: E731
    else:
        trainer = _mlp_trainer()
        if resume is not None:
            trainer.load_state(*resume)
        if kind == "mlp":
            xs, ys = _batches()
            step = lambda: trainer.step_many(xs, ys)  # noqa: E731
        else:
            step, loader = _loader_setup(trainer)
            if resume is not None:
                # where the first run's loader stood: 2 dispatches of 2
                for _ in range(4):
                    loader.run()
    losses = [step()["loss"].clone() for _ in range(dispatches)]
    return trainer, losses


def _saved(kind, trainer):
    if kind == "lm":
        def host(tree):
            return {k: (v.detach().numpy().copy()
                        if torch.is_tensor(v) else host(v))
                    for k, v in tree.items()} if isinstance(tree, dict) \
                else [host(v) for v in tree]
        return (host(trainer.params), host(trainer.opt_m),
                host(trainer.opt_v), trainer._step_count)
    return (trainer.params_numpy(),
            [{k: v.numpy().copy() for k, v in p.items()}
             for p in trainer.velocity], trainer._step_counter)


@pytest.mark.parametrize("kind, entry", [
    ("mlp", "mlp_step_many/k2_6x8_6"), ("loader", "loader_step_many/k2_32x8"),
    ("lm", "lm_step_many/2x33")])
def test_trainer_resume_under_a_plan_is_bitwise_unplanned(kind, entry,
                                                          aot_env):
    """Four dispatches unplanned against two under a cold plan, then a
    trainer restored from their state continuing two more under the
    warm plan (hits): the same losses and state, bitwise."""
    base, base_losses = _run(kind, 4)
    plan = aot.configure(cache_dir=aot_env)
    half, losses = _run(kind, 2)
    assert (half.aot_hits, half.aot_misses) == (0, 1)
    assert entry in [e for fp in os.listdir(os.path.join(
        aot_env, "artifacts")) for e in plan.cache.entries(fp)]
    plan = aot.configure(cache_dir=aot_env)
    rest, more = _run(kind, 2, resume=_saved(kind, half))
    assert (rest.aot_hits, rest.aot_misses, rest.aot_fallbacks) == (1, 0, 0)
    for a, b in zip(base_losses, losses + more):
        assert torch.equal(a, b)
    for a, b in zip(_state(base), _state(rest)):
        assert torch.equal(a, b)


# -- startup, export, bundles -------------------------------------------------

def test_status_doc_and_startup_report(aot_env, caplog):
    plan = aot.configure(cache_dir=aot_env)
    engine = _mlp()
    engine.warm_max_batch = 4
    assert aot.warm_engine(engine) == 3                   # buckets 1, 2, 4
    with caplog.at_level("INFO", logger="veles_aot"):
        report = aot.startup_report("serve")
    assert report["captures_before_ready"] == 3
    assert report["aot_misses"] == 3 and report["fresh_builds"] == 0
    assert "aot startup (serve): 0 fresh kernel build(s)" in caplog.text
    assert aot.startup_report("serve") == report         # closed once
    engine.apply(np.ones((3, 8), np.float32))            # bucket 4: warm
    assert plan.status_doc()["captures_after_ready"] == 0
    engine.apply(np.ones((7, 8), np.float32))            # bucket 8: new
    doc = aot.status_doc()
    assert doc["captures_after_ready"] == 1
    assert doc["captures_before_ready"] == 3 and doc["misses"] == 4
    assert doc["cache"]["puts"] == 4 and doc["cold_start_s"] >= 0


def test_aot_export_then_read_bundle_with_several_fingerprints(aot_env,
                                                               tmp_path):
    target = str(tmp_path / "bundle.zip")
    plan = aot.configure(export_to=target)
    _mlp().apply(np.ones((2, 8), np.float32))
    GenerativeEngine(LM, LM_PARAMS, max_slots=2, device="cpu").generate(
        [np.arange(1, 4, dtype=np.int32)], 2)
    assert plan.flush_export() == target
    bundle = aot.read_bundle(target)
    assert len(bundle.fingerprints) == 2
    assert sorted(n.split("/", 1)[1] for n in bundle.entry_names()) == \
        ["decode", "forward/2x8"]
    fp = _mlp()._fingerprint()
    assert bundle.entries_for(fp) == ["forward/2x8"]
    assert export.unpack_record(bundle.get(fp, "forward/2x8"))[
        "fingerprint"] == fp
    assert bundle.get(fp, "forward/4x8") is None
    with zipfile.ZipFile(target) as zf:
        assert all(n.startswith("aot/") for n in zf.namelist())


def _package(path, seed=0):
    """A package archive of the MLP (the reference's layout)."""
    params = _mlp_params(seed)
    units = [{"class": "All2AllTanh", "uuid": "veles.tpu.all2all",
              "name": "fc0", "properties": {"activation": "tanh"},
              "arrays": {"weights": "0000_weights.npy",
                         "bias": "0001_bias.npy"}},
             {"class": "All2AllSoftmax", "uuid": "veles.tpu.all2all",
              "name": "fc1", "properties": {"activation": "softmax"},
              "arrays": {"weights": "0002_weights.npy",
                         "bias": "0003_bias.npy"}}]
    arrays = [("0000_weights.npy", params[0]["w"]),
              ("0001_bias.npy", params[0]["b"]),
              ("0002_weights.npy", params[1]["w"]),
              ("0003_bias.npy", params[1]["b"])]
    aot_package.write_package(path, {"workflow": "Mlp", "checksum": "",
                                     "precision": "float32",
                                     "units": units}, arrays)
    return path


def test_bundle_in_a_package_plans_an_engine_without_a_global_plan(
        aot_env, tmp_path):
    pkg = _package(str(tmp_path / "mlp.zip"))
    aot.configure(export_to=pkg)
    InferenceEngine.from_package(pkg, device="cpu").apply(
        np.ones((5, 8), np.float32))
    aot.flush_export()
    aot.deactivate()
    engine = InferenceEngine.from_package(pkg, device="cpu")
    assert aot.active() is None and engine._aot_bundle is not None
    engine.input_hint = None                 # the bundle's entries only
    assert aot.warm_engine(engine) == 1 and engine.buckets == [8]
    assert (engine.aot_hits, engine.aot_misses) == (1, 0)
    engine.apply(np.ones((1, 8), np.float32))          # not in the bundle
    assert engine.aot_misses == 1
    assert np.array_equal(engine.apply(np.ones((5, 8), np.float32)),
                          _mlp().apply(np.ones((5, 8), np.float32)))


def test_reference_stablehlo_bundle_is_a_clean_miss(aot_env, tmp_path):
    """A JAX package's package whose ``aot/`` holds StableHLO serves in
    the port; its entries are other fingerprints and another magic:
    every capture a clean miss, nothing raised."""
    import jax.numpy as jnp

    from veles_tpu import aot as r_aot
    from veles_tpu.serve.engine import InferenceEngine as REngine
    pkg = _package(str(tmp_path / "ref.zip"))
    r_aot.configure(cache_dir=str(tmp_path / "ref_cache"), export_to=pkg)
    try:
        engine = REngine.from_package(pkg, compute_dtype=jnp.float32)
        want = np.asarray(engine.apply(np.ones((3, 8), np.float32)))
        assert r_aot.flush_export() == pkg
    finally:
        r_aot.deactivate()
    plan = aot.configure(cache_dir=aot_env)
    engine = InferenceEngine.from_package(pkg, device="cpu")
    assert engine._aot_bundle is not None
    got = engine.apply(np.ones((3, 8), np.float32))
    assert (engine.aot_hits, engine.aot_misses) == (0, 1)
    assert plan.hits == 0 and plan.misses == 1
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    member = [n for n in engine._aot_bundle.entry_names()][0]
    fp, name = member.split("/", 1)
    with pytest.raises(export.AotUnavailable, match="bad magic"):
        export.unpack_record(engine._aot_bundle.get(fp, name))


# -- the capture counter ------------------------------------------------------

def test_capture_watcher_counts_and_bounds_churn():
    engine = _mlp()
    with CaptureWatcher() as outer:
        with CaptureWatcher(max_captures=2, label="warm") as inner:
            engine.apply(np.ones((1, 8), np.float32))
            engine.apply(np.ones((3, 8), np.float32))
            engine.apply(np.ones((4, 8), np.float32))    # bucket 4 again
        assert inner.capture_count == 2 and inner.shape_count == 2
        assert inner.graph_count == 0
        with assert_max_captures(0, "steady state"):
            engine.apply(np.ones((2, 8), np.float32)[:1])
            engine.apply(np.ones((3, 8), np.float32))
        with pytest.raises(RecompileError, match="churn"):
            with assert_max_captures(0, "steady state"):
                engine.apply(np.ones((9, 8), np.float32))
    assert outer.capture_count == 3
    w = CaptureWatcher()
    with w:
        with pytest.raises(RuntimeError, match="reentrant"):
            w.__enter__()


# -- the kernel layer (DIR/kernels/) ------------------------------------------

_FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "Cuda compilation tools, release 12.8, V12.8.93"; exit 0
fi
echo "$@" >> "%s"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi; shift
done
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    calls = tmp_path / "nvcc_calls"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(_FAKE_NVCC % calls)
    (bindir / "nvcc").chmod(0o755)
    monkeypatch.setenv("PATH", "%s:%s" % (bindir, os.environ["PATH"]))
    monkeypatch.setattr(_build, "_TOOLCHAIN", {})
    monkeypatch.setattr(_build, "_COUNTED", set())
    monkeypatch.setattr(_build, "BUILDS", {"fresh": 0, "cached": 0,
                                           "fresh_s": 0.0})
    yield calls
    _build.set_library_dir(None)


def test_kernel_cache_builds_once_then_loads(aot_env, fake_nvcc):
    aot.configure(cache_dir=aot_env)
    kernels = os.path.join(aot_env, "kernels")
    assert _build.library_dir() == kernels
    assert _build.toolchain()["nvcc"] == "12.8"
    with CaptureWatcher() as cold:
        built = _build.build()
    assert cold.fresh_build_count == 5 and cold.cached_build_count == 0
    assert sorted(built) == _build.sources()
    assert all(os.path.dirname(p) == kernels for p in built.values())
    assert len(fake_nvcc.read_text().splitlines()) == 5
    assert _build.build(["rng"])["rng"] == built["rng"]   # counted once
    assert _build.BUILDS["cached"] == 0
    assert aot.startup_report()["fresh_builds"] == 5
    # a second process on the same directory: no nvcc
    _build._COUNTED.clear()
    aot.configure(cache_dir=aot_env)
    with CaptureWatcher() as warm:
        assert _build.build() == built
    assert warm.fresh_build_count == 0 and warm.cached_build_count == 5
    assert len(fake_nvcc.read_text().splitlines()) == 5
    report = aot.startup_report()
    assert (report["fresh_builds"], report["cached_builds"]) == (0, 5)
    # the key names the card and the toolkit: another one never loads
    _build._TOOLCHAIN["capability"] = "sm_80"
    assert _build._paths("rng")[0] != built["rng"]
    aot.deactivate()
    assert _build.library_dir() == _build.BUILD_DIR


def test_kernel_commit_keeps_the_first_library(tmp_path):
    lib = tmp_path / "k.so"
    lib.write_bytes(b"first")
    tmp = tmp_path / "k.so.1.tmp"
    tmp.write_bytes(b"second")
    _build._commit(str(tmp), str(lib))
    assert lib.read_bytes() == b"first" and not tmp.exists()
    tmp.write_bytes(b"third")
    _build._commit(str(tmp), str(tmp_path / "new.so"))
    assert (tmp_path / "new.so").read_bytes() == b"third"


# -- the registry -------------------------------------------------------------

def _functions_calling(names):
    """{"file:Class.method"} of the port's functions that call one of
    ``names`` (the capture sites and eager records)."""
    found = set()
    for dirpath, _, files in os.walk(PORT):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, PORT)
            tree = ast.parse(open(path).read())
            for cls in [n for n in tree.body
                        if isinstance(n, ast.ClassDef)]:
                for fn in cls.body:
                    if not isinstance(fn, ast.FunctionDef):
                        continue
                    for node in ast.walk(fn):
                        if isinstance(node, ast.Call):
                            f = node.func
                            called = f.attr if isinstance(
                                f, ast.Attribute) else getattr(f, "id", "")
                            if called in names:
                                found.add("%s:%s.%s" % (rel, cls.name,
                                                        fn.name))
    return found


def test_registry_covers_every_capture_site():
    """The registry names the reference's computations, and every class
    of the port that captures a step or records a dispatch has a
    registry site (a new capture site without an entry fails here)."""
    from veles_tpu.aot.registry import canonical_computations as ref
    comps = registry.canonical_computations()
    assert sorted(c.name for c in comps) == sorted(c.name for c in ref())
    captures = _functions_calling({"StepGraph"})
    records = _functions_calling({"_aot_note", "_dispatch_record"})

    def owner(site):
        return site.rsplit(".", 1)[0]

    assert {owner(s) for s in captures | records} == \
        {owner(c.site) for c in comps}
    assert {c.site for c in comps if c.entry} <= records
    for comp in comps:
        assert comp.captured == (comp.site in captures), comp.name
        assert isinstance(comp.donation, tuple), comp.name


def test_registry_builds_run_and_plan(aot_env):
    """Every registry computation runs on its canonical config and
    hands its record to the plan under one of its entry names."""
    plan = aot.configure(cache_dir=aot_env)
    for comp in registry.canonical_computations():
        fn, args = comp.build("cpu")
        fn(*args)
    entries = set()
    for fp in os.listdir(os.path.join(aot_env, "artifacts")):
        entries.update(plan.cache.entries(fp))
    prefixes = registry.entry_names()
    assert all(any(e == p or (p.endswith("/") and e.startswith(p))
                   for p in prefixes) for e in entries), entries
    assert {p for p in prefixes if not p.endswith("/sampled")} <= {
        p for p in prefixes if any(e == p or e.startswith(p)
                                   for e in entries)}


# -- the command line ---------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _popen(args, log):
    return subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch"] + args, env=_env(),
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)


def _until(predicate, what, timeout=120.0, step=0.05):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(step)


def _http(url, doc=None, timeout=30):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_a_package_archive(tmp_path):
    """``--serve model.zip -d cpu`` in this process answers ``/apply``
    with the package's outputs; a stop drains it and it returns 0."""
    from veles_tpu_torch.__main__ import Main
    pkg = _package(str(tmp_path / "mlp.zip"))
    main = Main([pkg, "-d", "cpu", "--serve", "127.0.0.1:0"])
    outcome = {}
    thread = threading.Thread(target=lambda: outcome.update(rc=main.run()))
    thread.start()
    try:
        _until(lambda: main.serve_server is not None or
               not thread.is_alive(), "never served")
        url = "http://%s:%d/apply" % main.serve_server.endpoint
        x = np.random.default_rng(2).standard_normal((3, 8)).astype(
            np.float32)
        got = np.asarray(_http(url, {"input": x.tolist()})["output"])
        want = InferenceEngine.from_package(pkg, device="cpu").apply(x)
        assert np.abs(got - want).max() <= 1e-6
    finally:
        main.stop_serving()
        thread.join(timeout=60)
    assert outcome.get("rc") == 0


def _startup(text):
    m = re.search(r"aot startup \(serve\): (\d+) fresh kernel build\(s\) "
                  r"in \S+, (\d+) from the cache, (\d+) capture\(s\) before "
                  r"ready, (\d+) planned \S+ hit, (\d+) missed, (\d+) "
                  r"record\(s\) written", text)
    return tuple(int(g) for g in m.groups()) if m else None


def test_warm_serve_subprocess_plans_every_capture(tmp_path):
    """Two ``--serve pkg --aot-cache D`` processes: the first records
    its warm ladder; the second hits every entry the first recorded,
    misses none, and mixed-size requests after ready capture nothing
    (``compile_count`` unmoved, ``captures_after_ready`` 0)."""
    pkg = _package(str(tmp_path / "mlp.zip"))
    cache = str(tmp_path / "cache")
    runs = []
    for i in range(2):
        log_path = tmp_path / ("serve%d.log" % i)
        with open(log_path, "w") as log:
            proc = _popen([pkg, "-d", "cpu", "-v", "--serve", "127.0.0.1:0",
                           "--serve-max-batch", "8", "--aot-cache", cache],
                          log)
        try:
            def url():
                m = re.search(r"serving \S+ on http://(\S+?) ",
                              log_path.read_text())
                return m.group(1) if m else None

            _until(lambda: url() or proc.poll() is not None,
                   "never served", timeout=180)
            assert url(), log_path.read_text()[-3000:]
            base = "http://%s" % url()
            before = _http(base + "/metrics")["default"]["compile_count"]
            for n in (1, 3, 8, 2, 5):
                _http(base + "/apply", {"input": np.ones(
                    (n, 8)).tolist()})
            doc = _http(base + "/metrics")
            runs.append((_startup(log_path.read_text()), before,
                         doc["default"]["compile_count"],
                         doc["_aot"]["captures_after_ready"]))
        finally:
            proc.send_signal(signal.SIGINT)
            assert proc.wait(60) == 0, log_path.read_text()[-3000:]
    (cold, b0, a0, after0), (warm, b1, a1, after1) = runs
    # 0 fresh builds on the CPU (no kernel), buckets 1..8 captured
    assert cold == (0, 0, 4, 0, 4, 4), cold
    assert warm == (0, 0, 4, 4, 0, 0), warm
    assert (b0, a0, after0) == (4, 4, 0) and (b1, a1, after1) == (4, 4, 0)


def test_route_rollout_swaps_both_replicas(tmp_path):
    """``--route --replicas 2`` over one package, ``--rollout`` of a
    second (other weights): once the rollout is logged, every replica
    answers with the second package's outputs; SIGINT exits 0."""
    first = _package(str(tmp_path / "one.zip"), seed=0)
    second = _package(str(tmp_path / "two.zip"), seed=1)
    port = _free_port()
    log_path = tmp_path / "route.log"
    with open(log_path, "w") as log:
        proc = _popen([first, "-d", "cpu", "-v", "--route",
                       "127.0.0.1:%d" % port, "--replicas", "2",
                       "--rollout", second], log)
    try:
        _until(lambda: "rolled out over 2 replica" in log_path.read_text()
               or proc.poll() is not None, "never rolled out", timeout=240)
        assert proc.poll() is None, log_path.read_text()[-3000:]
        x = np.random.default_rng(5).standard_normal((2, 8)).astype(
            np.float32)
        want = InferenceEngine.from_package(second, device="cpu").apply(x)
        seen = set()
        for i in (1, 2):
            got = np.asarray(_http("http://127.0.0.1:%d/apply" % (port + i),
                                   {"input": x.tolist()})["output"])
            assert np.abs(got - want).max() <= 1e-6, i
        for _ in range(6):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/apply" % port,
                data=json.dumps({"input": x.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                seen.add(resp.headers.get("X-Replica"))
                got = np.asarray(json.loads(resp.read())["output"])
            assert np.abs(got - want).max() <= 1e-6
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(90)
    assert rc == 0, log_path.read_text()[-3000:]
    assert re.findall(r"replica (r\d) \(pid \d+\) exited with 0",
                      log_path.read_text()) == ["r0", "r1"]


def test_spawn_argv_aot_flags():
    """--aot-cache passes through to spawned workers and replicas (they
    warm-start from the shared directory); --aot-export is stripped
    from both (the export is the producer's)."""
    from veles_tpu_torch.distributed.spawn import replica_argv, worker_argv
    argv = ["wf.py", "--aot-cache", "/tmp/c", "--aot-cache-mb", "64",
            "--aot-export", "/tmp/p.zip", "-l", "127.0.0.1:5000",
            "--workers", "2"]
    for out in (worker_argv(argv, "127.0.0.1:5000"),
                replica_argv(argv, "127.0.0.1:6001")):
        assert "--aot-cache" in out and "/tmp/c" in out
        assert out[out.index("--aot-cache-mb") + 1] == "64"
        assert "--aot-export" not in out and "/tmp/p.zip" not in out
