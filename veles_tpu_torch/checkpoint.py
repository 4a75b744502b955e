"""Crash-safe sharded checkpointing with an asynchronous writer.

Port of ``veles_tpu/checkpoint.py``; the on-disk format is the
reference's, byte for byte, so either package reads an arrays-only
store the other wrote:

* **Generations**: every save is a new numbered generation
  (``<prefix>-<NNNNNN>/`` shard directory + ``<prefix>-<NNNNNN>.json``
  manifest). Nothing is modified in place, so a crash at any point
  leaves every committed generation untouched.
* **Atomic commit**: shards are written and fsynced first; the
  manifest goes to a tmp file, is fsynced and ``os.replace``d into its
  name, then the directory is fsynced. The manifest rename is the
  commit point.
* **Per-shard crc32**: ``load`` detects torn or bit-rotted shards and
  falls back to the previous good generation with a log line.
* **Sharding and resume on another shard count**: arrays larger than
  ``shard_bytes`` split along axis 0; the manifest records the logical
  shape; :func:`reshard` re-splits a loaded array for any count.
* **AsyncCheckpointer**: the training thread pays only the capture;
  the device-to-host copy, crc, disk write and fsync run on a writer
  thread.

Capture differs from the reference's in one place. JAX arrays are
immutable, so the reference captures them by reference. The port's
trainers update their tensors in place (a captured CUDA graph reads
the same storage every step), so a CUDA tensor given to
``save(arrays=...)`` is cloned on the device at capture, on the current
stream, and a CUDA event is recorded after the clone; the writer waits
on that event before it copies the clone to the host. A later in-place
update cannot reach the saved value. A CPU tensor or a numpy array is
copied on the host at capture. A bf16 tensor is saved as f32 (numpy has
no bf16).

Two capture flavours share the store: ``save(arrays={...})``, a named
dict of arrays, and ``save(obj=workflow)``, a whole-object pickle
(protocol 5: every large numpy buffer leaves the stream out of band
and becomes its own crc-checked shard).
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
import queue
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.thread_pool import ManagedThreads

FORMAT_VERSION = 1
DEFAULT_SHARD_BYTES = 64 << 20


class CheckpointUnavailable(Exception):
    """No generation of the checkpoint could be loaded (none committed,
    or every committed generation failed its checksum verification)."""


class CheckpointSuperseded(Exception):
    """A queued save was coalesced away by a newer one before it
    started: its generation was never written. ``save(block=True)``
    raises this; non-blocking callers can test ``ticket.superseded``."""


# -- atomic file primitives (shared with snapshotter.py) -------------------

def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp + fsync + ``os.replace``: a
    crash at any point leaves either the old file or the new one,
    never a truncation."""
    with atomic_file(path) as f:
        f.write(data)


class atomic_file:
    """Context manager handing out a temp file object whose content is
    atomically renamed to ``path`` on clean exit (fsynced first) and
    deleted on error — the writer discipline for every snapshot sink.

    ``opener`` lets codec writers (gzip.open/bz2.open/lzma.open) wrap
    the temp path; fsync happens on the underlying file after the
    codec has flushed its trailer.
    """

    def __init__(self, path: str, opener=open, mode: str = "wb") -> None:
        self.path = path
        self.tmp = "%s.tmp.%d" % (path, os.getpid())
        self._opener = opener
        self._mode = mode
        self._file = None

    def __enter__(self):
        self._file = self._opener(self.tmp, self._mode)
        return self._file

    def __exit__(self, exc_type, exc, tb):
        try:
            self._file.close()
        except Exception:
            if exc_type is None:
                raise
        if exc_type is not None:
            try:
                os.unlink(self.tmp)
            except OSError:
                pass
            return False
        # Re-open to fsync what the codec actually wrote: codecs
        # buffer, and close() flushed to the OS, not to the platter.
        with open(self.tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(self.tmp, self.path)
        fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        return False


# -- the store -------------------------------------------------------------

_MANIFEST_RE = re.compile(r"-(\d{6})\.json$")
_MANIFEST_NAME_RE = re.compile(r"(.+)-(\d{6})\.json$")


def parse_manifest_name(name: str) -> Optional[Tuple[str, int]]:
    """``(prefix, generation)`` from a manifest filename
    ``<prefix>-NNNNNN.json``, or None when ``name`` is not one — the
    single parser behind every named-manifest restore path."""
    match = _MANIFEST_NAME_RE.match(name)
    if not match:
        return None
    return match.group(1), int(match.group(2))


def _crc(data) -> int:
    return zlib.crc32(memoryview(data).cast("B")) & 0xFFFFFFFF


class CheckpointStore(Logger):
    """Generation-numbered sharded checkpoints under one directory.

    Layout (``prefix`` defaults to ``ckpt``)::

        <dir>/<prefix>-000007/000_weights.0.shard   raw array bytes
        <dir>/<prefix>-000007/001_extra.pickle      pickled non-array state
        <dir>/<prefix>-000007.json                  manifest = commit point

    ``keep`` generations are retained (>= 2, so one corrupt commit can
    always fall back).
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keep: int = 2,
                 shard_bytes: int = DEFAULT_SHARD_BYTES) -> None:
        super().__init__()
        self.directory = str(directory)
        self.prefix = prefix
        self.keep = max(2, int(keep))
        self.shard_bytes = max(1, int(shard_bytes))
        self._gen_lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)
        self._next_gen = self._scan_next_generation()  # guarded-by: _gen_lock
        #: test/fault hook: called after shards are written, before the
        #: manifest rename commits the generation (the kill-mid-save
        #: window)
        self.mid_commit_hook = None

    # -- generation bookkeeping -------------------------------------------
    def _manifest_path(self, gen: int) -> str:
        return os.path.join(self.directory,
                            "%s-%06d.json" % (self.prefix, gen))

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.directory,
                            "%s-%06d" % (self.prefix, gen))

    def _scan_next_generation(self) -> int:
        last = 0
        pattern = os.path.join(self.directory, "%s-*" % self.prefix)
        for path in glob.glob(pattern):
            match = _MANIFEST_RE.search(path)
            if match:
                last = max(last, int(match.group(1)))
            else:
                match = re.search(r"-(\d{6})$", path)
                if match:  # a shard dir whose commit never happened
                    last = max(last, int(match.group(1)))
        return last + 1

    def generations(self) -> List[int]:
        """Committed generation numbers, ascending (manifest exists)."""
        gens = []
        for path in glob.glob(os.path.join(
                self.directory, "%s-*.json" % self.prefix)):
            match = _MANIFEST_RE.search(path)
            if match:
                gens.append(int(match.group(1)))
        return sorted(gens)

    def reserve_generation(self) -> int:
        with self._gen_lock:
            gen = self._next_gen
            self._next_gen += 1
        return gen

    # -- commit ------------------------------------------------------------
    def commit(self, arrays: Optional[Dict[str, Any]] = None,
               meta: Optional[dict] = None,
               obj_payload: Optional[bytes] = None,
               obj_buffers: Optional[List[Any]] = None,
               generation: Optional[int] = None) -> int:
        """Write one generation and atomically commit it; returns the
        generation number. Callers pass EITHER ``arrays`` (named-array
        capture) or ``obj_payload`` (+``obj_buffers``, the protocol-5
        whole-object capture from :func:`capture_object`)."""
        gen = self.reserve_generation() if generation is None \
            else generation
        gdir = self._gen_dir(gen)
        os.makedirs(gdir, exist_ok=True)
        manifest: Dict[str, Any] = {
            "format": FORMAT_VERSION,
            "generation": gen,
            "prefix": self.prefix,
            "created": time.time(),
            "meta": meta or {},
        }
        counter = 0

        def write_shard(name: str, data) -> Tuple[str, dict]:
            nonlocal counter
            fname = "%03d_%s.shard" % (counter, name)
            counter += 1
            path = os.path.join(gdir, fname)
            view = memoryview(data).cast("B")
            with open(path, "wb") as f:
                f.write(view)
                f.flush()
                os.fsync(f.fileno())
            return fname, {"file": fname, "crc32": _crc(view),
                           "size": len(view)}

        if arrays is not None:
            entries = {}
            for name, value in arrays.items():
                shards = value if isinstance(value, (list, tuple)) \
                    else self._split(np.asarray(value))
                shards = [np.ascontiguousarray(s) for s in shards]
                logical = list(shards[0].shape)
                if len(shards) > 1:
                    logical[0] = sum(s.shape[0] for s in shards)
                recs = []
                for shard in shards:
                    _, rec = write_shard(name, shard.data)
                    rec["shape"] = list(shard.shape)
                    recs.append(rec)
                entries[name] = {
                    "dtype": np.dtype(shards[0].dtype).str,
                    "shape": logical,
                    "shards": recs,
                }
            manifest["arrays"] = entries
        if obj_payload is not None:
            _, rec = write_shard("object.pickle", obj_payload)
            bufrecs = []
            for buf in obj_buffers or ():
                _, brec = write_shard("buffer", buf)
                bufrecs.append(brec)
            manifest["object"] = {"payload": rec, "buffers": bufrecs}
        fsync_dir(gdir)
        if self.mid_commit_hook is not None:
            # The kill-mid-save window: shards durable, commit pending.
            self.mid_commit_hook(gen)
        atomic_write_bytes(
            self._manifest_path(gen),
            json.dumps(manifest, indent=1).encode())
        self._gc(gen)
        return gen

    def _split(self, arr: np.ndarray) -> List[np.ndarray]:
        if arr.nbytes <= self.shard_bytes or arr.ndim == 0 or \
                arr.shape[0] < 2:
            return [arr]
        n = min(int(np.ceil(arr.nbytes / self.shard_bytes)),
                arr.shape[0])
        return [chunk for chunk in np.array_split(arr, n)
                if chunk.shape[0]]

    def _gc(self, newest: int) -> None:
        """Drop generations older than the ``keep`` newest committed
        ones (and any orphaned shard dirs they left)."""
        gens = self.generations()
        for gen in gens[:-self.keep]:
            try:
                os.unlink(self._manifest_path(gen))
            except OSError:
                pass
            shutil.rmtree(self._gen_dir(gen), ignore_errors=True)
        # orphaned shard dirs (commit crashed before the manifest):
        # older than the newest committed generation they are garbage
        committed = set(self.generations())
        for path in glob.glob(os.path.join(
                self.directory, "%s-*" % self.prefix)):
            match = re.search(r"-(\d{6})$", path)
            if match and os.path.isdir(path):
                gen = int(match.group(1))
                if gen < newest and gen not in committed:
                    shutil.rmtree(path, ignore_errors=True)

    # -- load --------------------------------------------------------------
    def _read_shard(self, gdir: str, rec: dict, writable: bool = False):
        path = os.path.join(gdir, rec["file"])
        with open(path, "rb") as f:
            data = f.read()
        if len(data) != rec["size"]:
            raise CheckpointUnavailable(
                "shard %s truncated: %d of %d bytes" %
                (rec["file"], len(data), rec["size"]))
        if _crc(data) != rec["crc32"]:
            raise CheckpointUnavailable(
                "shard %s crc mismatch" % rec["file"])
        return bytearray(data) if writable else data

    def _load_generation(self, gen: int):
        with open(self._manifest_path(gen)) as f:
            manifest = json.load(f)
        if manifest.get("format", 0) > FORMAT_VERSION:
            raise CheckpointUnavailable(
                "manifest format %s is newer than this build" %
                manifest.get("format"))
        gdir = self._gen_dir(gen)
        arrays = None
        if "arrays" in manifest:
            arrays = {}
            for name, entry in manifest["arrays"].items():
                dtype = np.dtype(entry["dtype"])
                parts = []
                for rec in entry["shards"]:
                    raw = self._read_shard(gdir, rec)
                    parts.append(np.frombuffer(
                        raw, dtype=dtype).reshape(rec["shape"]).copy())
                arrays[name] = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
                if list(arrays[name].shape) != list(entry["shape"]):
                    raise CheckpointUnavailable(
                        "array %s re-stacked to %s, manifest says %s" %
                        (name, arrays[name].shape, entry["shape"]))
        obj = None
        if "object" in manifest:
            payload = self._read_shard(gdir, manifest["object"]["payload"])
            buffers = [self._read_shard(gdir, rec, writable=True)
                       for rec in manifest["object"]["buffers"]]
            obj = pickle.loads(payload, buffers=buffers)
        return arrays, obj, manifest.get("meta", {}), gen

    def load_latest(self, max_generation: Optional[int] = None):
        """``(arrays, obj, meta, generation)`` from the newest loadable
        generation (optionally capped at ``max_generation`` — restore
        a named manifest with fallback to only OLDER generations). A
        generation failing verification (corrupt/missing shard, torn
        manifest) logs a clear line and falls back to the previous
        one; raises :class:`CheckpointUnavailable` when none
        survive."""
        gens = self.generations()
        if max_generation is not None:
            gens = [g for g in gens if g <= max_generation]
        last_error: Optional[Exception] = None
        for gen in reversed(gens):
            try:
                return self._load_generation(gen)
            except (CheckpointUnavailable, OSError, ValueError,
                    KeyError, pickle.UnpicklingError, EOFError) as e:
                last_error = e
                older = [g for g in gens if g < gen]
                self.warning(
                    "checkpoint generation %d of %s is corrupt (%s); "
                    "falling back to generation %s", gen, self.prefix,
                    e, older[-1] if older else "<none>")
        raise CheckpointUnavailable(
            "no loadable %s checkpoint in %s (newest error: %s)" %
            (self.prefix, self.directory, last_error))

    def load_generation(self, gen: int):
        """Load one specific committed generation (no fallback)."""
        return self._load_generation(gen)


def reshard(arr: np.ndarray, num_shards: int) -> List[np.ndarray]:
    """Split a logical array into ``num_shards`` parts along axis 0: a
    checkpoint saved in one shard count restores into another.
    ``np.array_split`` semantics: works for any num_shards <= len."""
    if num_shards <= 1 or arr.ndim == 0:
        return [arr]
    return np.array_split(arr, min(num_shards, max(arr.shape[0], 1)))


class HostPickler(pickle.Pickler):
    """A pickler that refuses device tensors: a snapshot or checkpoint
    holds host data only (numpy, through the Arrays' host copies and
    the trainers' host state), so it loads in a process without a
    card. A unit that keeps a CUDA tensor outside a transient
    (trailing-underscore) attribute is a bug this names."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise TypeError(
                "refusing to pickle a %s tensor %s %s: snapshots hold "
                "host data only" % (obj.device, tuple(obj.shape),
                                    obj.dtype))
        return NotImplemented


def dump_host(obj, file, protocol: int = pickle.HIGHEST_PROTOCOL,
              buffer_callback=None) -> None:
    """``pickle.dump`` through :class:`HostPickler`."""
    HostPickler(file, protocol=protocol,
                buffer_callback=buffer_callback).dump(obj)


def dumps_host(obj, protocol: int = pickle.HIGHEST_PROTOCOL,
               buffer_callback=None) -> bytes:
    """``pickle.dumps`` through :class:`HostPickler`."""
    out = io.BytesIO()
    dump_host(obj, out, protocol, buffer_callback)
    return out.getvalue()


def capture_object(obj) -> Tuple[bytes, List[bytes]]:
    """Protocol-5 capture: ``(payload, buffers)`` where every large
    array buffer left the pickle stream out-of-band. Buffer bytes are
    COPIED here (the live arrays keep mutating under training), so the
    caller pays one host memcpy and nothing else."""
    raw: List[pickle.PickleBuffer] = []
    payload = dumps_host(obj, protocol=5, buffer_callback=raw.append)
    buffers = []
    for pb in raw:
        try:
            view = pb.raw()
        except BufferError:  # non-contiguous: rare, copy via cast
            view = memoryview(bytes(memoryview(pb)))
        buffers.append(bytes(view))
    return payload, buffers




class _DeviceCapture:
    """A CUDA tensor cloned at capture, with the event recorded after
    the clone on the capturing thread's stream. :meth:`to_host` (the
    writer thread) waits for the event, then copies to the host."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor.detach().clone()
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(tensor.device))

    def to_host(self) -> np.ndarray:
        self.event.synchronize()
        t = self.tensor
        if t.dtype == torch.bfloat16:
            t = t.float()
        out = t.cpu().numpy()
        self.tensor = None  # free the device clone now
        return out


def _capture(value):
    """The capture of one array for :meth:`AsyncCheckpointer.save`: a
    CUDA tensor cloned on the device (:class:`_DeviceCapture`); a CPU
    tensor or anything numpy takes copied on the host."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            return _DeviceCapture(value)
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(value)


def _to_host(value) -> np.ndarray:
    return value.to_host() if isinstance(value, _DeviceCapture) else value


class _Ticket:
    """Handle for one queued save."""

    __slots__ = ("generation", "arrays", "payload", "buffers", "meta",
                 "done", "error", "superseded")

    def __init__(self, generation, arrays, payload, buffers, meta):
        self.generation = generation
        self.arrays = arrays
        self.payload = payload
        self.buffers = buffers
        self.meta = meta
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.superseded = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class AsyncCheckpointer(Logger):
    """Snapshot state off the training thread.

    ``save`` captures (a device clone for CUDA tensors, a memcpy for
    host arrays, a protocol-5 dump for whole objects) and enqueues; a
    ManagedThreads writer does the device-to-host copy, shard writes,
    crc and the atomic manifest commit. The training thread's cost is
    the capture, summed in ``stall_seconds``; the writer's in
    ``save_seconds``, the bytes it wrote in ``bytes_written``.

    ``coalesce=True`` (default): when saves outpace the disk, a queued
    not-yet-started save is superseded by the newer one.
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keep: int = 2, shard_bytes: int = DEFAULT_SHARD_BYTES,
                 threads: Optional[ManagedThreads] = None,
                 coalesce: bool = True) -> None:
        super().__init__()
        self.store = CheckpointStore(directory, prefix=prefix,
                                     keep=keep, shard_bytes=shard_bytes)
        self._threads = threads if threads is not None else \
            ManagedThreads(name="checkpointer")
        self._own_threads = threads is None
        self._queue: "queue.Queue[_Ticket]" = queue.Queue()
        self._pending_lock = threading.Lock()
        # queued, not started
        self._pending: Optional[_Ticket] = None  # guarded-by: _pending_lock
        self._inflight: Optional[_Ticket] = None  # guarded-by: _pending_lock
        self.coalesce = coalesce
        self.stall_seconds = 0.0
        self.save_seconds = 0.0      # writer-side time (overlapped)
        self.bytes_written = 0
        self.saves_requested = 0
        self.saves_committed = 0
        self.saves_superseded = 0
        self.failures = 0
        self.last_error: Optional[BaseException] = None
        self.last_generation: Optional[int] = None
        self._started = False                    # guarded-by: _start_lock
        self._start_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def _ensure_writer(self) -> None:
        if self._threads.stop_requested:
            # A save enqueued after stop() would wait forever on a
            # writer that already exited: fail loudly instead.
            raise RuntimeError(
                "AsyncCheckpointer %s is stopped; refusing to save" %
                self.store.prefix)
        with self._start_lock:
            if not self._started:
                self._threads.spawn(self._writer_loop, name="ckpt-writer",
                                    on_error=self._on_writer_error)
                self._started = True

    def _on_writer_error(self, exc: BaseException) -> None:
        # fires only if the loop itself dies (per-ticket errors are
        # caught inside); the next save restarts the writer
        self.failures += 1
        self.last_error = exc
        with self._start_lock:
            self._started = False

    def stop(self, timeout: float = 30.0) -> None:
        """Flush queued saves and stop the writer (joins only threads
        this checkpointer owns)."""
        self.wait(timeout=timeout)
        if self._own_threads:
            self._threads.join_all(timeout=timeout)

    # -- save --------------------------------------------------------------
    def save(self, arrays: Optional[Dict[str, Any]] = None,
             obj: Any = None, meta: Optional[dict] = None,
             block: bool = False) -> _Ticket:
        """Queue one checkpoint of ``arrays`` (name -> tensor or numpy
        array, or a list of them: the shards of one array) or ``obj``
        (whole-object protocol-5 capture). Returns a ticket;
        ``block=True`` waits for the commit."""
        if (arrays is None) == (obj is None):
            raise ValueError("save() wants exactly one of arrays=/obj=")
        self._ensure_writer()
        t0 = time.perf_counter()
        payload = buffers = captured = None
        if obj is not None:
            payload, buffers = capture_object(obj)
        else:
            captured = {
                name: [_capture(v) for v in value]
                if isinstance(value, (list, tuple)) else _capture(value)
                for name, value in arrays.items()}
        gen = self.store.reserve_generation()
        ticket = _Ticket(gen, captured, payload, buffers, meta)
        with self._pending_lock:
            if self.coalesce and self._pending is not None and \
                    not self._pending.done.is_set():
                self._pending.superseded = True
                self._pending.error = CheckpointSuperseded(
                    "checkpoint generation %d superseded by %d before "
                    "it was written" % (self._pending.generation, gen))
                self._pending.arrays = None  # drop device clones now
                self._pending.done.set()
                self.saves_superseded += 1
            self._pending = ticket
        self._queue.put(ticket)
        self.saves_requested += 1
        self.stall_seconds += time.perf_counter() - t0
        if block:
            ticket.wait()
            if ticket.error is not None:
                raise ticket.error
        return ticket

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued save has committed (or failed)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            with self._pending_lock:
                pending = self._pending
                inflight = self._inflight
            target = None
            if pending is not None and not pending.done.is_set():
                target = pending
            elif inflight is not None and not inflight.done.is_set():
                target = inflight
            if target is None:
                return True
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            if not target.wait(left):
                return False

    # -- writer ------------------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            try:
                ticket = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._threads.stop_requested:
                    return
                continue
            if ticket.superseded:
                continue
            with self._pending_lock:
                if self._pending is ticket:
                    self._pending = None
                self._inflight = ticket
            t0 = time.perf_counter()
            try:
                arrays = ticket.arrays
                if arrays is not None:
                    # device -> host off the training thread
                    arrays = {
                        name: ([_to_host(v) for v in value]
                               if isinstance(value, list)
                               else _to_host(value))
                        for name, value in arrays.items()}
                    ticket.arrays = None
                    nbytes = sum(
                        sum(v.nbytes for v in value)
                        if isinstance(value, list) else value.nbytes
                        for value in arrays.values())
                else:
                    nbytes = len(ticket.payload) + sum(
                        len(b) for b in ticket.buffers or ())
                self.store.commit(arrays=arrays,
                                  meta=ticket.meta,
                                  obj_payload=ticket.payload,
                                  obj_buffers=ticket.buffers,
                                  generation=ticket.generation)
                ticket.payload = ticket.buffers = None
                self.saves_committed += 1
                self.bytes_written += nbytes
                self.last_generation = ticket.generation
            except BaseException as e:  # noqa: BLE001 — surfaced via ticket
                ticket.error = e
                self.failures += 1
                self.last_error = e
                self.warning("checkpoint generation %d failed: %s",
                             ticket.generation, e)
            finally:
                self.save_seconds += time.perf_counter() - t0
                with self._pending_lock:
                    if self._inflight is ticket:
                        self._inflight = None
                ticket.done.set()

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "saves_requested": self.saves_requested,
            "saves_committed": self.saves_committed,
            "saves_superseded": self.saves_superseded,
            "failures": self.failures,
            "stall_seconds": self.stall_seconds,
            "save_seconds": self.save_seconds,
            "bytes_written": self.bytes_written,
            "last_generation": self.last_generation,
        }
