"""ctypes binding to the repo's native C++ inference runtime
(``native/src``; port of ``veles_tpu/native.py``).

The native runtime is the libVeles-equivalent deployment path
(reference: libVeles/src/workflow_loader.cc:40-133): it loads a
``Workflow.package_export`` archive and runs the trained graph with a
thread-pool engine over one arena-packed buffer, on the host — no
Python, no PyTorch — for embedding into C++ applications. This module
is the binding: plain ctypes over the runtime's C ABI (``capi.cc``).

The library is built here with ``g++`` from ``native/src/*.cc`` (one
compiler process a source, all started together, then one link) into
``veles_tpu_torch/ops/csrc/build/native/libveles_native-<key>.so``,
the key hashing the sources, the headers, the flags and the compiler's
release; a build goes through a tmp file and an atomic link, so two
processes building the same key use the first one committed. A failed
build raises :class:`NativeBuildError` with the compiler's output. The
C++ is the repo's own and is not edited.

Running a package on the card is :meth:`InferenceEngine.from_package
<veles_tpu_torch.serve.engine.InferenceEngine.from_package>`;
:meth:`NativeWorkflow.run_stablehlo` (the reference runs the emitted
StableHLO through jaxlib's PJRT client) raises
:class:`StableHLORuntimeUnavailable` here.

>>> wf.package_export("model.zip")
>>> nwf = NativeWorkflow("model.zip")
>>> probs = nwf.run(batch)          # numpy in, numpy out
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the runtime's sources (the reference's ``native/src``)
NATIVE_SRC = os.path.join(_REPO, "native", "src")
#: where the library is built (git-ignored with the kernels' builds)
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "ops", "csrc", "build", "native")
#: the translation units of ``libveles_native.so`` (native/Makefile's
#: ``SRC`` plus the C ABI)
SOURCES = ("json.cc", "npy.cc", "stablehlo.cc", "archive.cc", "engine.cc",
           "memory_optimizer.cc", "unit_factory.cc", "nn_units.cc",
           "workflow.cc", "workflow_loader.cc", "capi.cc")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
LDLIBS = ("-lz", "-pthread")

#: seconds the last fresh build of this process took (0.0: none)
BUILD_STATS: Dict[str, float] = {"fresh_s": 0.0, "fresh": 0}

_lock = threading.Lock()  # guards _lib only, never held across a build
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock


class NativeBuildError(RuntimeError):
    pass


class StableHLORuntimeUnavailable(RuntimeError):
    """No in-process runtime executes the emitted StableHLO text here
    (the reference uses jaxlib's PJRT client)."""


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("no C++ compiler: g++ is not on PATH "
                               "(or set CXX)")
    return cxx


def library_key() -> str:
    """Hash of the sources, the headers, the flags and the compiler's
    release: a library built from anything else is never loaded."""
    digest = hashlib.sha256()
    for name in sorted(os.listdir(NATIVE_SRC)):
        if name.endswith((".cc", ".h")):
            digest.update(name.encode())
            with open(os.path.join(NATIVE_SRC, name), "rb") as fin:
                digest.update(fin.read())
    digest.update(repr((SOURCES, CXXFLAGS, LDLIBS)).encode())
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True)
    digest.update(cxx.encode() + version.stdout.encode())
    return digest.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, "libveles_native-%s.so" % library_key())


def _compile(lib: str) -> None:
    """Objects in parallel into a scratch directory, one link to a tmp
    file, then an atomic link to ``lib``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = _cxx()
    scratch = tempfile.mkdtemp(prefix="objs-", dir=BUILD_DIR)
    t0 = time.monotonic()
    try:
        procs = []
        for src in SOURCES:
            obj = os.path.join(scratch, src[:-3] + ".o")
            procs.append((src, obj, subprocess.Popen(
                [cxx, *CXXFLAGS, "-c", "-o", obj,
                 os.path.join(NATIVE_SRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _, proc in procs:
            text = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append("%s (rc %d):\n%s"
                              % (src, proc.returncode, text))
        if failed:
            raise NativeBuildError("native build failed: "
                                   + "\n".join(failed))
        tmp = os.path.join(scratch, "lib.so")
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-shared", "-o", tmp,
             *(obj for _, obj, _ in procs), *LDLIBS],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError("native link failed (rc %d):\n%s\n%s"
                                   % (proc.returncode, proc.stdout,
                                      proc.stderr))
        with open(tmp, "rb") as fin:
            os.fsync(fin.fileno())
        try:
            os.link(tmp, lib)
        except FileExistsError:
            pass  # another builder committed this key first
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    BUILD_STATS["fresh_s"] = time.monotonic() - t0
    BUILD_STATS["fresh"] += 1


def build(force: bool = False) -> str:
    """Build the library unless this key's is there (``force``: build
    anew); returns its path. Raises :class:`NativeBuildError`."""
    lib = library_path()
    if force and os.path.isfile(lib):
        # unlink first: the relink writes a NEW inode, so a dlopen of
        # the path never returns a stale mapping
        os.unlink(lib)
    if not os.path.isfile(lib):
        _compile(lib)
    return lib


def load_library() -> ctypes.CDLL:
    """dlopen the runtime, building it on first use. The build runs
    outside the lock: two threads building at once commit one library
    (the atomic link), and the first loaded stays."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    lib = ctypes.CDLL(build())
    if not hasattr(lib, "veles_native_emit_stablehlo"):
        raise NativeBuildError(
            "the built library lacks veles_native_emit_stablehlo")
    _declare(lib)
    with _lock:
        if _lib is None:
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every C entry."""
    lib.veles_native_load.restype = ctypes.c_void_p
    lib.veles_native_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.veles_native_free.argtypes = [ctypes.c_void_p]
    lib.veles_native_num_units.restype = ctypes.c_int
    lib.veles_native_num_units.argtypes = [ctypes.c_void_p]
    lib.veles_native_unit_uuid.restype = ctypes.c_char_p
    lib.veles_native_unit_uuid.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.veles_native_run.restype = ctypes.c_int64
    lib.veles_native_run.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int]
    lib.veles_native_emit_stablehlo.restype = ctypes.c_void_p
    lib.veles_native_emit_stablehlo.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.veles_native_hlo_text.restype = ctypes.c_char_p
    lib.veles_native_hlo_text.argtypes = [ctypes.c_void_p]
    lib.veles_native_hlo_num_args.restype = ctypes.c_int
    lib.veles_native_hlo_num_args.argtypes = [ctypes.c_void_p]
    lib.veles_native_hlo_arg_name.restype = ctypes.c_char_p
    lib.veles_native_hlo_arg_name.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
    lib.veles_native_hlo_arg_rank.restype = ctypes.c_int
    lib.veles_native_hlo_arg_rank.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
    lib.veles_native_hlo_arg_dim.restype = ctypes.c_int64
    lib.veles_native_hlo_arg_dim.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int]
    lib.veles_native_hlo_arg_data.restype = \
        ctypes.POINTER(ctypes.c_float)
    lib.veles_native_hlo_arg_data.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
    lib.veles_native_hlo_free.argtypes = [ctypes.c_void_p]


class NativeWorkflow:
    """A loaded native inference graph."""

    def __init__(self, package_path: str, n_threads: int = 0) -> None:
        self.package_path = package_path
        lib = load_library()
        err = ctypes.create_string_buffer(512)
        self._handle = lib.veles_native_load(
            os.fsencode(package_path), n_threads, err, len(err))
        if not self._handle:
            raise RuntimeError("native load failed: %s" %
                               err.value.decode("utf-8", "replace"))
        self._lib = lib

    @property
    def unit_uuids(self):
        n = self._lib.veles_native_num_units(self._handle)
        return [self._lib.veles_native_unit_uuid(self._handle, i)
                .decode() for i in range(n)]

    def run(self, x: np.ndarray) -> np.ndarray:
        """Run inference on a C-contiguous float32 batch."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        in_shape = (ctypes.c_int64 * x.ndim)(*x.shape)
        out_shape = (ctypes.c_int64 * 8)()
        out_rank = ctypes.c_int(0)
        err = ctypes.create_string_buffer(512)
        xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        # First call sizes the output (capacity 0), second fills it.
        n = self._lib.veles_native_run(
            self._handle, xp, in_shape, x.ndim, None, 0, out_shape,
            ctypes.byref(out_rank), err, len(err))
        if n < 0:
            raise RuntimeError("native run failed: %s" %
                               err.value.decode("utf-8", "replace"))
        out = np.empty(int(n), dtype=np.float32)
        op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n2 = self._lib.veles_native_run(
            self._handle, xp, in_shape, x.ndim, op, n, out_shape,
            ctypes.byref(out_rank), err, len(err))
        if n2 != n:
            raise RuntimeError("native run failed on fill pass")
        shape = tuple(int(out_shape[i]) for i in range(out_rank.value))
        return out.reshape(shape)

    def emit_stablehlo(self, input_shape):
        """Lower the graph to a StableHLO module for ``input_shape``.

        Returns ``(mlir_text, params)`` — params are the runtime
        parameter arrays (copies) in ``@main`` argument order after
        the input. The module runs on any PJRT plugin."""
        lib = self._lib
        shape = (ctypes.c_int64 * len(input_shape))(*input_shape)
        err = ctypes.create_string_buffer(512)
        emission = lib.veles_native_emit_stablehlo(
            self._handle, shape, len(input_shape), err, len(err))
        if not emission:
            raise RuntimeError("stablehlo emission failed: %s" %
                               err.value.decode("utf-8", "replace"))
        try:
            text = lib.veles_native_hlo_text(emission).decode()
            params = []
            for i in range(lib.veles_native_hlo_num_args(emission)):
                rank = lib.veles_native_hlo_arg_rank(emission, i)
                dims = tuple(lib.veles_native_hlo_arg_dim(emission, i, d)
                             for d in range(rank))
                n = int(np.prod(dims)) if dims else 1
                ptr = lib.veles_native_hlo_arg_data(emission, i)
                params.append(np.ctypeslib.as_array(
                    ptr, shape=(n,)).reshape(dims).copy())
            return text, params
        finally:
            lib.veles_native_hlo_free(emission)

    def run_stablehlo(self, x: np.ndarray,
                      platform: str = "cpu") -> np.ndarray:
        """The reference executes the emitted module through jaxlib's
        in-process PJRT client. The port has no StableHLO runtime (a
        deliberate divergence): it raises
        :class:`StableHLORuntimeUnavailable`. Run a package on the card
        with ``InferenceEngine.from_package(path)``, or on the host
        with :meth:`run`; :meth:`emit_stablehlo` still lowers the
        graph for any PJRT plugin outside this package."""
        raise StableHLORuntimeUnavailable(
            "veles_tpu_torch runs no StableHLO (platform %r): serve the "
            "package on the card with InferenceEngine.from_package(%r), "
            "or run it on the host with NativeWorkflow.run"
            % (platform, self.package_path))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.veles_native_free(handle)
            self._handle = None
