"""Build and load the port's CUDA C++ kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded through
``ctypes``. Builds start together (one ``nvcc`` per source, in
parallel) on first use and land in ``ops/csrc/build/``, keyed by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an unchanged kernel is built once per checkout. ``ptxas`` resource usage (registers, shared memory,
spills) is kept beside each library as ``<name>-<key>.log``.

Nothing here runs at import: the CPU-only test machine has no
``nvcc``, and only a launch on a CUDA tensor asks for a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _paths(name: str):
    digest = hashlib.sha256()
    for fname in [name + ".cu"] + headers():
        with open(os.path.join(CSRC, fname), "rb") as fin:
            digest.update(fin.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.join(BUILD_DIR, "%s-%s" % (name, digest.hexdigest()[:16]))
    return stem + ".so", stem + ".log"


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every listed kernel whose library is missing, all
    ``nvcc`` processes at once; returns name -> library path. Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    out: Dict[str, str] = {}
    for name in names:
        lib, log = _paths(name)
        out[name] = lib
        if os.path.exists(lib):
            continue
        tmp = "%s.%d.tmp" % (lib, os.getpid())
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
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output (ptxas resource usage) for a built kernel."""
    with open(_paths(name)[1]) as fin:
        return fin.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            lib.veles_error_string.argtypes = [ctypes.c_int]
            lib.veles_error_string.restype = ctypes.c_char_p
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
