"""Build and load the port's CUDA C++ kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded through
``ctypes``. Builds start together (one ``nvcc`` per source, in
parallel) on first use. ``ptxas`` resource usage (registers, shared
memory, spills) is kept beside each library as ``<name>-<key>.log``.

A library's key hashes the source, the shared headers
(``csrc/*.cuh``), the flags, the card's compute capability, the
``nvcc`` release and ``torch.version.cuda``, so a library built from
other sources, or for another card or toolkit, is never loaded. The
libraries land in ``ops/csrc/build/``, or under the directory
:func:`set_library_dir` names (``--aot-cache DIR`` names
``DIR/kernels/``: a fresh checkout or a second process then loads them
with no ``nvcc`` run). A library is written through a tmp file, fsync
and an atomic link: a concurrent builder of the same key uses the
first one committed. :data:`BUILDS` counts fresh builds (``nvcc``
runs) apart from libraries found already built, each library once a
process, and the capture counter (``analysis.recompile``) sees both.

Nothing here runs at import: the CPU-only test machine has no
``nvcc``, and only a launch on a CUDA tensor asks for a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the library each launch counter's kernel lives in
LIBRARY_OF = {"flash_fwd": "flash_fwd", "flash_bwd_dkv": "flash_bwd",
              "flash_bwd_dq": "flash_bwd", "flash_decode": "flash_decode",
              "flash_decode_paged": "flash_decode", "lrn_fwd": "lrn",
              "lrn_bwd": "lrn", "uniform_fill": "rng"}

#: guards ``_libs``, ``_name_locks``, ``BUILDS`` and ``_COUNTED``; held
#: only for dictionary work, never across a build
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
#: one lock a kernel name, held across that kernel's build and load: a
#: second caller of the same kernel waits for the library it needs,
#: while callers of other kernels (built or not) go on
_name_locks: Dict[str, threading.Lock] = {}  # guarded-by: _lock
#: where libraries are looked up and built (None: ``BUILD_DIR``)
_LIB_DIR: Dict[str, Optional[str]] = {"dir": None}
_TOOLCHAIN: Dict[str, str] = {}
#: libraries built by ``nvcc`` (``fresh``) and found already built
#: (``cached``) in this process, and the seconds the fresh builds took
BUILDS: Dict[str, float] = {"fresh": 0, "cached": 0, "fresh_s": 0.0}
#: the library paths BUILDS has counted (each once a process)
_COUNTED: set = set()
#: called as ``fn(kind, n)`` with kind "fresh" or "cached" (the capture
#: counter's hook)
_LISTENERS: List[Callable[[str, int], None]] = []


def sources() -> List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", ""),
                                   "bin", "nvcc"),
                      "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "a machine with the CUDA toolkit (PATH, CUDA_HOME "
                       "or /usr/local/cuda)")


def headers() -> List[str]:
    """The shared headers (``csrc/*.cuh``) every kernel may include."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def set_library_dir(directory: Optional[str]) -> None:
    """Look libraries up and build them under ``directory`` (None:
    back to ``BUILD_DIR``). Libraries already loaded stay loaded."""
    _LIB_DIR["dir"] = directory


def library_dir() -> str:
    return _LIB_DIR["dir"] or BUILD_DIR


def source_digest(name: str) -> str:
    """Hash of a kernel's source, the shared headers and the flags."""
    digest = hashlib.sha256()
    for fname in [name + ".cu"] + headers():
        with open(os.path.join(CSRC, fname), "rb") as fin:
            digest.update(fin.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def sources_key() -> str:
    """One hash over every kernel's :func:`source_digest` (the kernel
    part of an AOT fingerprint's environment)."""
    digest = hashlib.sha256()
    for name in sources():
        digest.update(("%s:%s;" % (name, source_digest(name))).encode())
    return digest.hexdigest()[:16]


def toolchain() -> Dict[str, str]:
    """The card's compute capability, the ``nvcc`` release and the CUDA
    version torch was built with (asked once a process; ``none`` where
    a machine has no card or no ``nvcc``, which then builds nothing)."""
    if not _TOOLCHAIN:
        capability = release = "none"
        if torch.cuda.is_available():
            capability = "sm_%d%d" % torch.cuda.get_device_capability()
        try:
            text = subprocess.run([nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  check=True).stdout
            m = re.search(r"release (\S+?),", text)
            release = m.group(1) if m else text.strip()[-40:]
        except (RuntimeError, OSError, subprocess.CalledProcessError):
            pass
        _TOOLCHAIN.update(capability=capability, nvcc=release,
                          torch_cuda=str(torch.version.cuda))
    return dict(_TOOLCHAIN)


def library_key(name: str) -> str:
    """A library's key: its sources, flags, card and toolkit."""
    digest = hashlib.sha256(source_digest(name).encode())
    for k, v in sorted(toolchain().items()):
        digest.update(("%s=%s;" % (k, v)).encode())
    return digest.hexdigest()[:16]


def _paths(name: str):
    stem = os.path.join(library_dir(), "%s-%s" % (name, library_key(name)))
    return stem + ".so", stem + ".log"


def _notify(kind: str, n: int) -> None:
    if n:
        with _lock:
            BUILDS[kind] += n
        for fn in list(_LISTENERS):
            fn(kind, n)


def _count_once(lib: str) -> bool:
    """Whether ``lib`` is counted now (each library once a process)."""
    with _lock:
        if lib in _COUNTED:
            return False
        _COUNTED.add(lib)
        return True


def _commit(tmp: str, lib: str) -> None:
    """fsync ``tmp`` and link it to ``lib``; a library another builder
    committed first stays, and ``tmp`` goes."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    try:
        os.link(tmp, lib)
    except FileExistsError:
        pass
    finally:
        os.unlink(tmp)


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every listed kernel whose library is missing, all
    ``nvcc`` processes at once; returns name -> library path. Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(library_dir(), exist_ok=True)
    procs = []
    out: Dict[str, str] = {}
    t0 = time.monotonic()
    cached = 0
    for name in names:
        lib, log = _paths(name)
        out[name] = lib
        if os.path.exists(lib):
            if _count_once(lib):
                cached += 1
            continue
        tmp = "%s.%d.%d.tmp" % (lib, os.getpid(), threading.get_ident())
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs.append((name, lib, log, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, log, tmp, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        with open(log, "w") as fout:
            fout.write(text)
        if proc.returncode != 0:
            failed.append("%s (nvcc rc %d):\n%s"
                          % (name, proc.returncode, text))
            continue
        _commit(tmp, lib)
        _count_once(lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    if procs:
        with _lock:
            BUILDS["fresh_s"] += time.monotonic() - t0
    _notify("fresh", len(procs))
    _notify("cached", cached)
    return out


def build_log(name: str) -> str:
    """The compiler's output (ptxas resource usage) for a built kernel."""
    with open(_paths(name)[1]) as fin:
        return fin.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use. The
    build runs under that kernel's own lock, outside the registry's: a
    kernel already loaded, or one of another name, never waits out this
    kernel's ``nvcc``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            lib.veles_error_string.argtypes = [ctypes.c_int]
            lib.veles_error_string.restype = ctypes.c_char_p
            with _lock:
                _libs[name] = lib
        return lib


def resolve_impl(impl: Optional[str], device: torch.device,
                 entry: str) -> str:
    """A kernel wrapper's ``impl``: None -> "cuda" on a CUDA device,
    else "plain"; "cuda" on another device raises."""
    if impl not in (None, "plain", "cuda"):
        raise ValueError("%s impl must be 'plain', 'cuda' or None, got %r"
                         % (entry, impl))
    if impl is None:
        return "cuda" if device.type == "cuda" else "plain"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError("%s impl='cuda' needs CUDA tensors, got %s"
                         % (entry, device))
    return impl


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a C entry returned a CUDA error (the launch never
    ran: a refused launch is invisible to ``torch.cuda.synchronize``)."""
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, rc, lib.veles_error_string(rc)
                              .decode(errors="replace")))
