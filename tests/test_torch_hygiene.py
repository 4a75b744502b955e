"""Guards of the port's boundary, for every slice: ``veles_tpu_torch``
imports neither JAX nor anything of the ``veles_tpu`` package, and
never falls back to the CPU on its own."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import veles_tpu_torch
from veles_tpu_torch import device as port_device

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(os.path.abspath(veles_tpu_torch.__file__))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PORT], prefix="veles_tpu_torch."))


def test_import_closure_has_no_jax_and_no_veles_tpu():
    """In a fresh interpreter, importing every module of the port
    leaves ``jax`` and every module whose top-level name is
    ``veles_tpu`` out of ``sys.modules`` (compare the first dotted
    component: ``veles_tpu_torch`` starts with ``veles_tpu``)."""
    modules = _port_modules()
    for name in ("serve.engine", "parallel.fused", "models.flagship",
                 "nn.conv", "nn.lrn", "nn.pooling", "ops.lrn", "ops.rng",
                 "sched", "sched.scheduler", "analysis", "analysis.graph",
                 "units", "plumbing", "workflow", "config", "mutable",
                 "distributable", "backends", "memory",
                 "accelerated_units", "prng", "thread_pool", "logger",
                 "loader.prefetch", "loader.image", "loader.hdf5",
                 "loader.interactive", "mean_disp_normalizer",
                 "input_joiner", "avatar", "downloader", "nn.deconv",
                 "nn.rnn", "nn.rbm", "nn.kohonen", "models.autoencoder",
                 "models.lenet", "models.cifar", "models.vgg",
                 "models.stl10", "checkpoint", "snapshotter",
                 "models.lm", "ensemble", "ensemble.workflows",
                 "genetics", "genetics.core", "genetics.optimizer",
                 "parallel.mesh", "parallel.collectives",
                 "parallel.multiprocess", "parallel.ring_attention",
                 "parallel.pipeline"):
        assert "veles_tpu_torch." + name in modules
    script = (
        "import importlib, json, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(tops & {'jax', 'jaxlib', "
        "'veles_tpu'})))\n" % (modules,))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax_and_no_veles_tpu():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|veles_tpu)\b(?!_torch)|"
        r"from\s+(jax|jaxlib|veles_tpu)\b(?!_torch))", re.M)
    offenders = []
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as fin:
                    if pattern.search(fin.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    with open(os.path.join(REPO, "chip_smoke.py")) as fin:
        assert not pattern.search(fin.read())


def test_no_silent_cpu_fallback(monkeypatch):
    """``device=None`` means the CUDA card; without one it raises and
    tells the caller to ask for the CPU, which then works."""
    from veles_tpu_torch.models.flagship import flagship_specs
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer,
                                                    init_kv_cache,
                                                    init_params)
    from veles_tpu_torch.ops.rng import uniform_fill
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    from veles_tpu_torch.serve import GenerativeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = TransformerConfig(vocab=16, embed=16, heads=2, layers=1,
                               seq_len=8)
    params = init_params(config, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerativeEngine(config, params, max_slots=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(config, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerTrainer(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedClassifierTrainer(*flagship_specs((4, 2), in_dim=3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        uniform_fill(0, (4,))
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        Device()
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        AcceleratedWorkflow(None, name="wf").initialize()
    from veles_tpu_torch.models.autoencoder import (AutoencoderWorkflow,
                                                    ConvAutoencoderWorkflow)
    from veles_tpu_torch.models.cifar import CifarWorkflow
    from veles_tpu_torch.models.lenet import LenetWorkflow
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.models.stl10 import Stl10Workflow
    from veles_tpu_torch.models.vgg import VggWorkflow
    for make in (lambda: VggWorkflow(depth=16), AutoencoderWorkflow,
                 ConvAutoencoderWorkflow, LenetWorkflow, CifarWorkflow,
                 Stl10Workflow,
                 lambda: StandardWorkflow(layers=[
                     {"type": "lstm", "hidden": 4},
                     {"type": "softmax", "output_sample_shape": 10}])):
        with pytest.raises(RuntimeError, match="backend='cpu'"):
            make().initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.RandomGenerator("x", seed=0).uniform((4,))
    assert Device(backend="cpu").torch_device == torch.device("cpu")
    engine = GenerativeEngine(config, params, max_slots=1, device="cpu")
    assert engine.device == torch.device("cpu")
    assert engine.generate([np.asarray([1, 2], np.int32)], 2)[0].size == 2


def test_input_pipeline_entry_points_need_the_card(monkeypatch):
    """The input pipeline's entry points take the card by default and
    raise without one: a prefetch ring over a loader with no device,
    the input units on a workflow's default Device, a normalized
    engine with no device."""
    import types

    from veles_tpu_torch import normalization
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.loader import PrefetchingServer
    from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = PrefetchingServer(types.SimpleNamespace(device=None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.start()
    unit = MeanDispNormalizer.from_dataset(
        AcceleratedWorkflow(None, name="wf"), np.ones((4, 3), np.float32))
    unit.input = Array(np.ones((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        unit.initialize()
    params = [{"w": np.ones((3, 2), np.float32),
               "b": np.zeros(2, np.float32)}]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_specs(
            [("fc", "softmax")], params,
            normalizer=normalization.normalizer("none"))


def test_mesh_entry_points_pick_neither_the_cpu_nor_gloo(monkeypatch):
    """The mesh's entry points take the card by default and NCCL as the
    transport: without a card ``initialize`` raises (naming
    ``device='cpu'`` and gloo as the caller's choice), a mesh raises
    without a joined group, and nothing joins one on its own."""
    import inspect

    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.parallel import multiprocess
    from veles_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert inspect.signature(multiprocess.initialize).parameters[
        "backend"].default == "nccl"
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multiprocess.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiprocess.initialize("127.0.0.1:1", 1, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="joined process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="joined process group"):
        Device(backend="cpu").mesh({"data": 1})
    assert not multiprocess.is_initialized()


def test_compute_dtype_policy():
    assert port_device.compute_dtype("float32") is torch.float32
    assert port_device.compute_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        port_device.compute_dtype("float16")


def test_kernel_build_is_lazy():
    """Importing the kernel wrappers builds and loads nothing: the
    libraries come at the first launch on a CUDA tensor."""
    script = ("from veles_tpu_torch.ops import _build, flash_attention\n"
              "from veles_tpu_torch.ops import lrn, rng\n"
              "from veles_tpu_torch.parallel import fused\n"
              "print(len(_build._libs), _build.sources())\n")
    out = subprocess.run([sys.executable, "-c", script],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(None, 1) == [
        "0", "['flash_bwd', 'flash_decode', 'flash_fwd', 'lrn', 'rng']\n"]


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is keyed by its source and by the shared
    ``csrc/*.cuh`` headers: an edit of a header rebuilds the kernels
    that include it, and a header is not built as a kernel of its own."""
    from veles_tpu_torch.ops import _build
    for fname in ("flash_fwd.cu", "flash_common.cuh"):
        shutil.copy(os.path.join(_build.CSRC, fname), tmp_path / fname)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.sources() == ["flash_fwd"]
    assert _build.headers() == ["flash_common.cuh"]
    before = _build._paths("flash_fwd")
    assert _build._paths("flash_fwd") == before
    with open(tmp_path / "flash_common.cuh", "a") as fout:
        fout.write("// edited\n")
    assert _build._paths("flash_fwd") != before
