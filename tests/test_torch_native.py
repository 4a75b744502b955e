"""The port's binding to the native C++ runtime (``veles_tpu_torch.native``)
against the JAX package's, on the CPU.

The library builds with ``g++`` into the port's own build directory
(``veles_tpu_torch/ops/csrc/build/native/``), never into ``native/``
where the reference's ``make`` writes. For each of the reference's
round trips (tests/test_native.py) the port's ``package_export`` runs
in ``NativeWorkflow`` and agrees with the port's CPU forward within the
reference's bounds (rtol 1e-4 / atol 1e-5 for dense stacks, 1e-3 /
1e-4 for conv and deconv stacks, exact Kohonen winners); the
reference's export of the same initial params (the two packages draw
them bitwise equal from the same seed) runs to the same output, and
``emit_stablehlo`` gives the same text from either archive.
``run_stablehlo`` raises ``StableHLORuntimeUnavailable`` (the port has
no StableHLO runtime: a deliberate divergence).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.memory as R_memory
import veles_tpu.prng as R_prng
import veles_tpu.workflow as R_workflow
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.prng as P_prng
import veles_tpu_torch.workflow as P_workflow
from veles_tpu_torch import native

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable")

REF = dict(backends=R_backends, memory=R_memory, workflow=R_workflow,
           nn="veles_tpu.nn", pkg="veles_tpu")
PORT = dict(backends=P_backends, memory=P_memory, workflow=P_workflow,
            nn="veles_tpu_torch.nn", pkg="veles_tpu_torch")

DENSE = dict(rtol=1e-4, atol=1e-5)
CONV = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def lib():
    return native.load_library()


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.random.seed = 7
        c.root.common.engine.compute_type = "float32"
    R_prng.reset()
    P_prng.reset()
    yield
    for c, (dtype, seed) in zip((R_config, P_config), saved):
        c.root.common.engine.compute_type = dtype
        c.root.common.random.seed = seed
    R_prng.reset()
    P_prng.reset()


def _mod(mods, name):
    import importlib
    return importlib.import_module("%s.%s" % (mods["pkg"], name))


def _fc(mods, wf):
    nn = _mod(mods, "nn")
    nn.All2AllTanh(wf, name="fc1", output_sample_shape=16)
    nn.All2AllSoftmax(wf, name="fc2", output_sample_shape=5)
    return np.random.RandomState(3).rand(4, 12).astype(np.float32), DENSE


def _conv_stack(mods, wf):
    nn = _mod(mods, "nn")
    nn.Conv(wf, name="c1", n_kernels=4, kx=3, padding=1)
    nn.LRNormalizerForward(wf, name="lrn")
    nn.MaxPooling(wf, name="pool", kx=2)
    nn.ConvRELU(wf, name="c2", n_kernels=6, kx=3, sliding=(2, 2))
    nn.Dropout(wf, name="drop", dropout_ratio=0.5)
    nn.All2AllSoftmax(wf, name="fc", output_sample_shape=3)
    return np.random.RandomState(5).rand(2, 12, 12, 3).astype(
        np.float32), CONV


def _mean_disp(mods, wf):
    nn = _mod(mods, "nn")
    norm = _mod(mods, "mean_disp_normalizer")
    dataset = np.random.RandomState(8).rand(20, 6).astype(np.float32) * 4
    norm.MeanDispNormalizer.from_dataset(wf, dataset)
    nn.All2AllTanh(wf, name="fc", output_sample_shape=3)
    return dataset[:4], DENSE


def _deconv(mods, wf):
    deconv = _mod(mods, "nn.deconv")
    nn = _mod(mods, "nn")
    nn.ConvRELU(wf, name="enc", n_kernels=4, kx=3, padding=1,
                sliding=(2, 2))
    deconv.Depooling(wf, name="up", kx=2)
    deconv.Deconv(wf, name="dec", n_kernels=3, kx=3)
    return np.random.RandomState(9).rand(2, 12, 12, 3).astype(
        np.float32), CONV


def _lstm(mods, wf):
    _mod(mods, "nn.rnn").LSTM(wf, name="rec", hidden=6)
    return np.random.RandomState(13).rand(3, 5, 4).astype(np.float32), DENSE


def _rbm(mods, wf):
    _mod(mods, "nn.rbm").RBM(wf, name="rbm", n_hidden=7)
    return np.random.RandomState(4).rand(3, 12).astype(np.float32), DENSE


def _kohonen(mods, wf):
    _mod(mods, "nn.kohonen").KohonenForward(wf, name="som", shape=(3, 4))
    return np.random.RandomState(6).rand(5, 6).astype(np.float32), None


def _grouped_conv(mods, wf):
    nn = _mod(mods, "nn")
    nn.Conv(wf, name="c1", n_kernels=6, kx=3, padding=1)
    nn.ConvRELU(wf, name="c2", n_kernels=8, kx=3, n_groups=2)
    return np.random.RandomState(7).rand(2, 10, 10, 3).astype(
        np.float32), CONV


CHAINS = {"fc": _fc, "conv_stack": _conv_stack, "mean_disp": _mean_disp,
            "deconv": _deconv, "lstm": _lstm, "rbm": _rbm,
            "kohonen": _kohonen, "grouped_conv": _grouped_conv}


def _chain(mods, kind):
    """(workflow, input, bounds, CPU forward output) of one chain in
    one package: the unit chain initialized and run on the CPU."""
    wf = mods["workflow"].Workflow()
    wf.thread_pool = None
    x, bounds = CHAINS[kind](mods, wf)
    device = mods["backends"].Device(backend="cpu")
    arr = mods["memory"].Array(data=np.asarray(x, dtype=np.float32))
    arr.initialize(device)
    prev = arr
    for unit in wf.units:
        if not hasattr(unit, "export_spec"):
            continue
        unit.input = prev
        if hasattr(unit, "minibatch_class"):
            unit.minibatch_class = 1  # VALID: dropout = identity
        assert unit.initialize(device=device) is None
        unit.run()
        prev = unit.output
    return wf, x, bounds, np.asarray(prev.map_read())


def test_library_builds_into_the_ports_directory(lib):
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(
        os.path.join("veles_tpu_torch", "ops", "csrc", "build", "native"))
    assert native.build() == path  # keyed: found, not built again
    assert hasattr(lib, "veles_native_emit_stablehlo")


def test_build_failure_raises_native_build_error(monkeypatch, tmp_path):
    """A compiler that fails surfaces as NativeBuildError with its
    output, never a silent fallback."""
    bad = tmp_path / "g++"
    bad.write_text("#!/bin/sh\necho 'no such compiler' >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(native.NativeBuildError, match="no such compiler"):
        native.build()


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_round_trip_matches_cpu_forward_and_reference(kind, lib, tmp_path):
    wf, x, bounds, expected = _chain(PORT, kind)
    port_pkg = str(tmp_path / "port.zip")
    wf.package_export(port_pkg)
    nwf = native.NativeWorkflow(port_pkg)
    got = nwf.run(x)
    if bounds is None:  # Kohonen: winner indices as f32
        np.testing.assert_array_equal(got.astype(np.int32).ravel(),
                                      expected.ravel())
    else:
        assert got.shape == expected.shape
        np.testing.assert_allclose(got, expected, **bounds)

    rwf, rx, _, _ = _chain(REF, kind)
    np.testing.assert_array_equal(rx, x)
    ref_pkg = str(tmp_path / "ref.zip")
    rwf.package_export(ref_pkg)
    ref_nwf = native.NativeWorkflow(ref_pkg)
    assert ref_nwf.unit_uuids == nwf.unit_uuids
    np.testing.assert_array_equal(ref_nwf.run(x), got)

    if kind == "kohonen":
        with pytest.raises(RuntimeError, match="no StableHLO lowering"):
            nwf.emit_stablehlo(x.shape)
        return
    text, params = nwf.emit_stablehlo(x.shape)
    ref_text, ref_params = ref_nwf.emit_stablehlo(x.shape)
    assert text == ref_text
    assert len(params) == len(ref_params)
    for a, b in zip(params, ref_params):
        np.testing.assert_array_equal(a, b)


def test_run_stablehlo_is_unavailable(lib, tmp_path):
    wf, x, _, _ = _chain(PORT, "fc")
    pkg = str(tmp_path / "m.zip")
    wf.package_export(pkg)
    nwf = native.NativeWorkflow(pkg)
    with pytest.raises(native.StableHLORuntimeUnavailable,
                       match="InferenceEngine.from_package"):
        nwf.run_stablehlo(x)
    assert issubclass(native.StableHLORuntimeUnavailable, RuntimeError)


def test_native_matches_the_engine_of_the_same_package(lib, tmp_path):
    """The host runtime and the port's engine (what serves a package on
    the card) agree on one archive, here both on the CPU."""
    from veles_tpu_torch.serve.engine import InferenceEngine
    wf, x, bounds, _ = _chain(PORT, "conv_stack")
    pkg = str(tmp_path / "m.zip")
    wf.package_export(pkg)
    engine = InferenceEngine.from_package(pkg, device="cpu")
    np.testing.assert_allclose(native.NativeWorkflow(pkg).run(x),
                               engine.apply(x), **bounds)
