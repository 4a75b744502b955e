"""Package archives of the port (``veles_tpu_torch.aot.package``,
``Workflow.package_export``, ``InferenceEngine.from_package``) against
the JAX package's, on the CPU.

Parity: a reference unit graph's weights carried into the port's
(``models.standard.load_params``), both exported. ``contents.json`` is
equal but for ``checksum``, which hashes each package's own source
file of the workflow class (``workflow.py:_compute_checksum``), so it
differs by construction; every array is bitwise equal (same dtype, same
bytes). Each package's ``from_package`` serves the other package's
archive within 1e-4 relative of the other package's engine (f32; the
sums run in another order), and the port's engine from either archive
equals the port's ``from_workflow`` engine bitwise.

The extraction checks every member name before writing anything: a
member that would leave the extraction directory (absolute, ``..``,
a symlink or hardlink) refuses the whole archive. The reference writes
such members where they point (``veles_tpu/aot/package.py:101-119``,
``:145-151``): a deliberate divergence (ROADMAP.md queue 3).
"""

import io
import json
import os
import stat
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.models.alexnet as R_alexnet
import veles_tpu.models.mnist as R_mnist
import veles_tpu.prng as R_prng
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.models.alexnet as P_alexnet
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.models.standard as P_standard
import veles_tpu_torch.prng as P_prng
from veles_tpu.aot import package as R_package
from veles_tpu.serve.engine import InferenceEngine as REngine
from veles_tpu_torch.aot import package as P_package
from veles_tpu_torch.serve.engine import InferenceEngine

torch.set_num_threads(1)

TOL = 1e-4

MNIST = dict(layers=(32, 10), max_epochs=1,
             loader_kwargs=dict(n_train=100, n_valid=50, minibatch_size=50))
ALEXNET = dict(n_classes=10, image_size=64, max_epochs=1,
               layers=R_alexnet.alexnet_layers(10, dropout=0.5),
               loader_kwargs=dict(n_train=20, n_valid=20,
                                  minibatch_size=20, image_size=64))
MODELS = {"mnist": (R_mnist.MnistWorkflow, P_mnist.MnistWorkflow, MNIST,
                    (5, 784)),
          "alexnet": (R_alexnet.AlexNetWorkflow, P_alexnet.AlexNetWorkflow,
                      ALEXNET, (3, 64, 64, 3))}


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 5
    yield
    for c, p, (ct, seed) in zip((R_config, P_config), (R_prng, P_prng),
                                saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pair(name):
    """(reference workflow, port workflow) on the CPU, the port's
    weights carried from the reference's."""
    r_cls, p_cls, kw, _ = MODELS[name]
    R_prng.reset()
    ref = r_cls(**kw)
    ref.initialize(device=R_backends.Device(backend="cpu"))
    P_prng.reset()
    P_prng.get("default").seed(6)    # other weights until carried
    port = p_cls(**kw)
    port.initialize(device=P_backends.Device(backend="cpu"))
    P_standard.load_params(port, [
        {"weights": np.asarray(u.weights.map_read()),
         "bias": np.asarray(u.bias.map_read())}
        if hasattr(u, "weights") else {} for u in ref.forwards])
    return ref, port


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packages_agree_across_packages(name, tmp_path):
    ref, port = _pair(name)
    try:
        paths = [str(tmp_path / "ref.zip"), str(tmp_path / "port.tgz")]
        ref.package_export(paths[0])
        port.package_export(paths[1])
    finally:
        ref.thread_pool.shutdown()
        port.thread_pool.shutdown()
    (rc, ra), (pc, pa) = R_package.read_package(paths[0]), \
        P_package.read_package(paths[1])
    # checksum: each package hashes its own workflow source file
    assert rc.pop("checksum") != pc.pop("checksum")
    assert pc == rc
    assert sorted(pa) == sorted(ra)
    for key in ra:
        assert pa[key].dtype == ra[key].dtype and \
            np.array_equal(pa[key], ra[key]), key
    x = np.random.default_rng(3).standard_normal(
        MODELS[name][3]).astype(np.float32)
    ref_on_port = np.asarray(REngine.from_package(paths[1]).apply(x))
    ref_on_ref = np.asarray(REngine.from_package(paths[0]).apply(x))
    port_on_ref = InferenceEngine.from_package(paths[0],
                                               device="cpu").apply(x)
    port_on_port = InferenceEngine.from_package(paths[1],
                                                device="cpu").apply(x)
    assert _rel(ref_on_port, port_on_port) < TOL
    assert _rel(port_on_ref, ref_on_ref) < TOL
    assert np.array_equal(port_on_ref, port_on_port)
    assert np.array_equal(port_on_port, InferenceEngine.from_workflow(
        port, device="cpu").apply(x))


def test_export_warns_on_a_transforming_unit_without_export_spec(
        tmp_path, caplog, monkeypatch):
    P_prng.reset()
    port = P_mnist.MnistWorkflow(**MNIST)
    port.initialize(device=P_backends.Device(backend="cpu"))
    monkeypatch.setattr(type(port.forwards[0]), "export_spec", None)
    try:
        port.package_export(str(tmp_path / "m.zip"))
    finally:
        port.thread_pool.shutdown()
    assert "transforms data but has no export_spec" in caplog.text
    contents, _ = P_package.read_package(str(tmp_path / "m.zip"))
    assert len(contents["units"]) == len(port.forwards) - 1


def _archive(path, members):
    """A zip (or tar) archive of ``{name: bytes}`` written verbatim."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path, "w") as zf:
            for name, blob in members.items():
                zf.writestr(name, blob)
    else:
        with tarfile.open(path, "w") as tf:
            for name, blob in members.items():
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    return path


def _contents(units=()):
    return json.dumps({"workflow": "W", "checksum": "", "precision":
                       "float32", "units": list(units)}).encode()


@pytest.fixture
def pkg_cache(tmp_path, monkeypatch):
    """The extraction cache under ``tmp_path`` and a fresh memo."""
    root = tmp_path / "extract"
    monkeypatch.setattr(P_package, "_cache_root", lambda: str(root))
    P_package.clear_extraction_memo()
    yield root
    P_package.clear_extraction_memo()


def test_package_extracted_once_per_content(tmp_path, pkg_cache):
    path = _archive(str(tmp_path / "p.zip"), {
        "contents.json": _contents(), "0000_w.npy": _npy(np.ones(3))})
    before = P_package.ARCHIVE_BYTES_READ
    first = P_package.extract_package(path)
    moved = P_package.ARCHIVE_BYTES_READ - before
    assert moved > 0
    assert P_package.extract_package(path) is first
    P_package.clear_extraction_memo()          # another process
    second = P_package.extract_package(path)
    assert P_package.ARCHIVE_BYTES_READ - before == moved
    assert second.root == first.root and second.members == first.members
    # rewritten with other bytes: extracted again, into a fresh dir
    _archive(path, {"contents.json": _contents(),
                    "0000_w.npy": _npy(np.zeros(3))})
    os.utime(path, ns=(1, 1))
    third = P_package.extract_package(path)
    assert third.root != first.root
    assert P_package.ARCHIVE_BYTES_READ - before > moved
    assert np.array_equal(third.array("0000_w.npy"), np.zeros(3))


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.mark.parametrize("suffix", [".zip", ".tar"])
@pytest.mark.parametrize("member", [
    "../escaped", "/abs/escaped", "a/../../escaped", "a/./../../escaped",
    "..\\escaped"])
def test_escaping_members_are_refused_before_anything_is_written(
        tmp_path, pkg_cache, suffix, member):
    os.makedirs(tmp_path / "bad")
    path = _archive(str(tmp_path / "bad" / ("p" + suffix)),
                    {"contents.json": _contents(), member: b"x"})
    with pytest.raises(P_package.UnsafeArchive):
        P_package.extract_package(path)
    with pytest.raises(P_package.UnsafeArchive):
        InferenceEngine.from_package(path, device="cpu")
    assert not os.path.exists(pkg_cache) or os.listdir(pkg_cache) == []
    for where in (tmp_path, tmp_path / "bad", tmp_path.parent, "/abs"):
        assert not os.path.exists(os.path.join(where, "escaped"))


def test_link_members_are_refused(tmp_path, pkg_cache):
    zpath = str(tmp_path / "link.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("contents.json", _contents())
        info = zipfile.ZipInfo("w.npy")
        info.external_attr = (stat.S_IFLNK | 0o777) << 16
        zf.writestr(info, "/etc/passwd")
    tpath = str(tmp_path / "link.tar")
    with tarfile.open(tpath, "w") as tf:
        for kind, name in ((tarfile.SYMTYPE, "sym"),
                           (tarfile.LNKTYPE, "hard")):
            info = tarfile.TarInfo(name)
            info.type, info.linkname = kind, "/etc/passwd"
            tf.addfile(info)
    for path in (zpath, tpath):
        with pytest.raises(P_package.UnsafeArchive, match="link"):
            P_package.extract_package(path)
    assert not os.path.exists(pkg_cache) or os.listdir(pkg_cache) == []


def test_safe_member_names_normalize():
    assert P_package.safe_member_name("./a/b.npy") == "a/b.npy"
    assert P_package.safe_member_name("a/../b.npy") == "b.npy"
    for bad in ("", "..", "/x", "a/../..", "c:\\x", "a\x00b"):
        with pytest.raises(P_package.UnsafeArchive):
            P_package.safe_member_name(bad)


def test_from_package_refuses_an_unknown_unit(tmp_path, pkg_cache):
    path = _archive(str(tmp_path / "u.zip"), {"contents.json": _contents([
        {"class": "LSTM", "uuid": "veles.tpu.lstm", "name": "lstm",
         "properties": {}, "arrays": {}}])})
    with pytest.raises(ValueError, match="no serving translation"):
        InferenceEngine.from_package(path, device="cpu")
    bundle_only = _archive(str(tmp_path / "b.zip"),
                           {"aot/manifest.json": b"{}"})
    with pytest.raises(ValueError, match="not a package archive"):
        InferenceEngine.from_package(bundle_only, device="cpu")


def test_packages_carry_no_shared_library(tmp_path, pkg_cache):
    """``package_export`` and ``--aot-export`` write weights and JSON
    records only: no member is a shared library or other code."""
    from veles_tpu_torch import aot
    ref, port = _pair("mnist")
    ref.thread_pool.shutdown()
    path = str(tmp_path / "m.zip")
    port.package_export(path)
    plan = aot.configure(cache_dir=str(tmp_path / "cache"), export_to=path)
    try:
        InferenceEngine.from_workflow(port, device="cpu").apply(
            np.zeros((2, 784), np.float32))
        assert plan.flush_export() == path
    finally:
        aot.deactivate()
        port.thread_pool.shutdown()
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
    assert "aot/manifest.json" in names
    assert all(n == "contents.json" or n.endswith((".npy", ".rec", ".json"))
               for n in names), names
    assert not any(n.endswith((".so", ".dll", ".dylib", ".py", ".pyc"))
                   for n in names)
