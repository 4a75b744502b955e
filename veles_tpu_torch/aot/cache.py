"""The persistent cache behind ``--aot-cache DIR``: two layers, one
directory.

Port of ``veles_tpu/aot/cache.py``. The reference keeps jax's XLA
compilation cache (the compile skip) and ``jax.export`` blobs (the
trace skip). The port's counterparts:

* ``DIR/kernels/`` — the compile layer: the kernel libraries
  (``ops/_build.py``), keyed by their sources, flags, the card's
  compute capability and the CUDA toolkit. A second process on the same
  directory loads them and runs no ``nvcc``
  (:func:`configure_kernel_cache`, the counterpart of
  ``configure_xla_cache``). Only the operator's directory holds them:
  packages never carry a shared library, since loading native code out
  of an archive that arrives over ``/admin/swap`` would run whatever
  the archive holds.
* ``DIR/artifacts/<fingerprint>/<entry>`` — the capture layer:
  :class:`ArtifactCache` of capture records (``aot/export.py``). A
  record says which captures a warm start makes before traffic.

The discipline is ``checkpoint.py``'s: records are written through tmp
+ fsync + atomic rename and validate themselves (a corrupt or torn
entry logs a warning, is unlinked, and the caller captures afresh,
never a crash). The cache is bounded with LRU eviction by the records'
mtimes (a hit touches its record). Its counters register in the obs
``REGISTRY`` as ``veles_aot_*`` (``aot/warmup.py``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Dict, List, Optional

from veles_tpu_torch.aot.export import AotUnavailable, unpack_blob
from veles_tpu_torch.checkpoint import atomic_write_bytes

log = logging.getLogger("veles_aot")

#: default artifact-cache bound (LRU-evicted beyond it)
DEFAULT_MAX_BYTES = 512 << 20

RECORD_SUFFIX = ".rec"


def configure_kernel_cache(directory: Optional[str]) -> None:
    """Build and load the kernel libraries under ``directory`` (None:
    back to ``ops/csrc/build/``)."""
    from veles_tpu_torch.ops import _build
    if directory is not None:
        os.makedirs(directory, exist_ok=True)
    _build.set_library_dir(directory)


def entry_file(name: str) -> str:
    """The file name of entry ``name`` (readable, collision-free)."""
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)
    return "%s-%s%s" % (safe, hashlib.sha256(name.encode()).hexdigest()[:8],
                        RECORD_SUFFIX)


class ArtifactCache:
    """On-disk capture-record cache: ``root/<fingerprint>/<entry>.rec``
    blob files (self-validating; mtime = last use), LRU-bounded by
    ``max_bytes``."""

    def __init__(self, root: str, max_bytes: int = DEFAULT_MAX_BYTES) -> None:
        self.root = root
        self.max_bytes = int(max_bytes)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # counters (guarded-by: _lock)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.corrupt = 0

    def _path(self, fingerprint: str, name: str) -> str:
        return os.path.join(self.root, fingerprint, entry_file(name))

    def _drop_corrupt(self, path: str, what: str, err) -> None:
        # holds: _lock
        self.corrupt += 1
        log.warning("aot cache: corrupt entry %s (%s): removed, "
                    "capturing afresh", what, err)
        try:
            os.unlink(path)
        except OSError:
            pass

    def get(self, fingerprint: str, name: str) -> Optional[bytes]:
        """The packed record of ``fingerprint/name``, or None (a miss,
        or a corrupt entry, which is removed)."""
        path = self._path(fingerprint, name)
        with self._lock:
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                self.misses += 1
                return None
            try:
                unpack_blob(blob)
            except AotUnavailable as e:
                self.misses += 1
                self._drop_corrupt(path, "%s/%s" % (fingerprint[:12], name),
                                   e)
                return None
            self.hits += 1
            try:
                os.utime(path, None)   # the LRU stamp
            except OSError:
                pass
            return blob

    def put(self, fingerprint: str, name: str, blob: bytes) -> None:
        """Store a packed record (atomic write), then evict the least
        recently used records past ``max_bytes``."""
        path = self._path(fingerprint, name)
        with self._lock:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                atomic_write_bytes(path, blob)
            except OSError:
                log.warning("aot cache: cannot write %s under %s", name,
                            self.root, exc_info=True)
                return
            self.puts += 1
            self._evict()

    def entries(self, fingerprint: str) -> List[str]:
        """The entry names recorded under ``fingerprint`` (a corrupt
        record is removed and left out)."""
        directory = os.path.join(self.root, fingerprint)
        try:
            files = sorted(f for f in os.listdir(directory)
                           if f.endswith(RECORD_SUFFIX))
        except OSError:
            return []
        names = []
        with self._lock:
            for fname in files:
                path = os.path.join(directory, fname)
                try:
                    with open(path, "rb") as f:
                        _, meta = unpack_blob(f.read())
                    names.append(str(meta["name"]))
                except (OSError, KeyError, AotUnavailable) as e:
                    self._drop_corrupt(path, fname, e)
        return names

    def _records(self):
        for dirpath, _, files in os.walk(self.root):
            for fname in files:
                if fname.endswith(RECORD_SUFFIX):
                    path = os.path.join(dirpath, fname)
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    yield st.st_mtime, path, st.st_size

    def _evict(self) -> None:
        # holds: _lock
        sized = sorted(self._records())
        total = sum(n for _, _, n in sized)
        for _, path, nbytes in sized:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= nbytes
            self.evictions += 1

    def total_bytes(self) -> int:
        return sum(n for _, _, n in self._records())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "puts": self.puts, "evictions": self.evictions,
                    "corrupt": self.corrupt, "bytes": self.total_bytes()}


__all__ = ["ArtifactCache", "configure_kernel_cache", "DEFAULT_MAX_BYTES",
           "entry_file"]
