"""Snapshotter: periodic whole-workflow checkpoints and resume.

Port of ``veles_tpu/snapshotter.py``: pickles the whole workflow
(units, weights, loader cursors, random streams) with a compression
codec through tmp + fsync + rename, keeps a ``<prefix>_current``
symlink, throttles by interval, falls back to an older sibling when
the newest snapshot is corrupt, and in ``sharded=True`` mode hands the
write to :class:`veles_tpu_torch.checkpoint.AsyncCheckpointer`.

A snapshot holds host data only. Arrays pickle their host copy (a
device result is read back first), a trainer unit pickles its
parameters and optimizer state as numpy, and the pickler refuses a
CUDA tensor (``checkpoint.HostPickler``): a snapshot loads in a process
without a card, and ``initialize(device=...)`` puts the state on the
device again. Gate Bools and attribute links stay live through the
pickle graph, and the random streams carry their state, so a restored
workflow continues the same trajectory.

The non-finite guard that every save runs reads the device once: the
float tensors of every unit's ``weights`` and ``bias`` and of each
trainer's params are reduced on the device (their max-abs through
``torch._foreach_norm``), the results stacked, and one host read tells
which are not finite.
"""

from __future__ import annotations

import bz2
import glob as _glob
import gzip
import logging
import lzma
import os
import pickle
import random
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.checkpoint import dump_host, dumps_host
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit


class SnapshotUnavailable(Exception):
    """A snapshot sink or endpoint could not be reached within the
    configured timeout and retry budget (dead or locked database,
    missing file, every generation corrupt). Callers get one clean
    error, not an indefinite block."""


CODECS = {
    "": (open, ""),
    None: (open, ""),
    "gz": (gzip.open, ".gz"),
    "bz2": (bz2.open, ".bz2"),
    "xz": (lzma.open, ".xz"),
}


def _opener_for(path: str):
    for codec, (opener, ext) in CODECS.items():
        if ext and path.endswith(ext):
            return opener
    return open


def _backoff(attempt: int, base: float, cap: float = 5.0) -> float:
    """Exponential backoff with jitter: ~base at attempt 1, doubling up
    to ``cap``, scaled by a uniform factor in [0.5, 1.5)."""
    delay = min(cap, base * (2 ** max(attempt - 1, 0)))
    return delay * (0.5 + random.random())


def _param_leaves(tree) -> List[Any]:
    """The leaves of a trainer's parameter tree (dicts in key order,
    lists in order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _param_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in _param_leaves(node)]
    return [tree]


class Snapshotter(Unit):
    """Writes ``<directory>/<prefix>_<suffix>.pickle[.codec]`` and
    refreshes the ``<prefix>_current`` symlink.

    kwargs: ``prefix``, ``directory`` (default
    ``root.common.dirs.snapshots``), ``compression`` in
    {None, "gz", "bz2", "xz"}, ``interval`` (take every Nth trigger),
    ``time_interval`` (min seconds between snapshots), ``sharded``
    (write through an AsyncCheckpointer), ``keep_generations``.

    Wire after the Decision unit and gate with::

        snap.gate_skip = ~(loader.epoch_ended & decision.improved)
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.prefix: str = kwargs.pop("prefix", "wf")
        self.directory: str = kwargs.pop(
            "directory", None) or str(root.common.dirs.snapshots)
        self.compression: Optional[str] = kwargs.pop("compression", "gz")
        self.interval: int = kwargs.pop("interval", 1)
        self.time_interval: float = kwargs.pop("time_interval", 0.0)
        #: sharded=True delegates to checkpoint.AsyncCheckpointer:
        #: protocol-5 array shards + crc manifest, written off the
        #: training thread with an atomic generation commit
        self.sharded: bool = kwargs.pop("sharded", False)
        self.keep_generations: int = kwargs.pop("keep_generations", 3)
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)
        if self.compression not in CODECS:
            raise ValueError("unknown compression %r" % self.compression)
        self.suffix: str = ""          # may be linked from decision
        self.destination: Optional[str] = None
        self.counter = 0
        self._last_snapshot_time = 0.0
        self._checkpointer_ = None     # transient (threads, queues)

    @property
    def checkpointer(self):
        """The owned AsyncCheckpointer (sharded mode), created lazily
        so it never rides the workflow pickle."""
        if getattr(self, "_checkpointer_", None) is None:
            from veles_tpu_torch.checkpoint import AsyncCheckpointer
            # coalesce=False: every epoch snapshot is a distinct
            # restore point; a fast epoch must not supersede the
            # previous epoch's save
            self._checkpointer_ = AsyncCheckpointer(
                self.directory, prefix=self.prefix,
                keep=self.keep_generations, coalesce=False)
            # Workflow.stop's service-thread sweep joins the writer
            self._service_threads_ = self._checkpointer_._threads
        return self._checkpointer_

    def stop(self) -> None:
        if getattr(self, "_checkpointer_", None) is not None:
            self._checkpointer_.stop()
        super().stop()

    def run(self) -> None:
        self.counter += 1
        if self.counter % max(self.interval, 1):
            return
        now = time.time()
        if self.time_interval and \
                now - self._last_snapshot_time < self.time_interval:
            return
        self._last_snapshot_time = now
        self.destination = self.save()

    def make_suffix(self) -> str:
        if self.suffix:
            return self.suffix
        decision = getattr(self.workflow, "decision", None)
        if decision is not None and \
                getattr(decision, "epoch_number", None) is not None:
            err = getattr(decision, "min_validation_error", None)
            if err is not None and err == err and err != float("inf"):
                return "%d_%.2fpt" % (decision.epoch_number, err)
            return "%d" % decision.epoch_number
        return time.strftime("%Y%m%d_%H%M%S")

    def _guarded_leaves(self) -> List[Tuple[str, Any]]:
        """(name, value) of every array the guard checks: each unit's
        ``weights`` and ``bias`` (the newer of an Array's two copies: a
        device tensor, or the host array after a host write; an Array
        that GD units share with their forward twins, once) and every
        leaf of an attached trainer's ``params``."""
        out = []
        seen = set()
        for unit in getattr(self.workflow, "units", []):
            uname = getattr(unit, "name", unit)
            for attr in ("weights", "bias"):
                value = getattr(unit, attr, None)
                if id(value) in seen:
                    continue
                seen.add(id(value))
                if isinstance(value, Array):
                    value = value.devmem_ if value.devmem_ is not None \
                        and not value._host_dirty_ else value.mem
                if value is not None:
                    out.append(("%s.%s" % (uname, attr), value))
            params = getattr(getattr(unit, "_trainer_", None), "params",
                             None)
            if params is not None:
                for i, leaf in enumerate(_param_leaves(params)):
                    out.append(("%s._trainer_.params[%d]" % (uname, i),
                                leaf))
        return out

    def nonfinite_params(self) -> list:
        """Names of the workflow's parameter arrays holding non-finite
        values (see :meth:`_guarded_leaves`): the pre-commit guard
        :meth:`save` runs, so a NaN'd model never overwrites the last
        good restore point. Device tensors are reduced on their device
        (max-abs, which a NaN or an Inf makes non-finite) and read back
        in one transfer a device; host arrays are checked on the
        host."""
        bad = []
        by_device = {}
        for name, value in self._guarded_leaves():
            if isinstance(value, torch.Tensor):
                if value.is_floating_point() and value.numel():
                    names, leaves = by_device.setdefault(value.device,
                                                         ([], []))
                    names.append(name)
                    leaves.append(value.detach())
                continue
            arr = np.asarray(value)
            if arr.dtype.kind == "f" and arr.size and \
                    not np.isfinite(arr).all():
                bad.append(name)
        for names, leaves in by_device.values():
            with torch.no_grad():
                peaks = torch._foreach_norm(leaves, float("inf"))
                finite = torch.isfinite(
                    torch.stack([p.float() for p in peaks])).cpu()
            bad.extend(n for n, ok in zip(names, finite.tolist())
                       if not ok)
        return bad

    def _guard_nonfinite(self, force: bool) -> None:
        """The pre-commit guard every save path runs."""
        bad = self.nonfinite_params()
        if bad and not force:
            self.error(
                "REFUSING to snapshot: non-finite values in %s; a NaN'd "
                "model must not overwrite the last good restore point "
                "(pass force=True to override)", ", ".join(bad))
            raise SnapshotUnavailable(
                "refusing to snapshot non-finite params (%s); use "
                "force=True to override" % ", ".join(bad))
        if bad:
            self.warning("snapshotting DESPITE non-finite values in "
                         "%s (force=True)", ", ".join(bad))

    def save(self, force: bool = False) -> str:
        """Write one snapshot; returns its restore path.

        Refuses (raises :class:`SnapshotUnavailable`) when the
        workflow's parameters hold non-finite values, unless
        ``force=True``. The single-pickle mode writes through tmp +
        fsync + ``os.replace``: a crash mid-save leaves the previous
        snapshot untouched. Sharded mode hands the write to the
        AsyncCheckpointer: the capture is the training thread's only
        cost, and the returned path is the generation's manifest."""
        self._guard_nonfinite(force)
        os.makedirs(self.directory, exist_ok=True)
        if self.sharded:
            ticket = self.checkpointer.save(
                obj=self.workflow,
                meta={"suffix": self.make_suffix(),
                      "prefix": self.prefix})
            path = self.checkpointer.store._manifest_path(
                ticket.generation)
            self.info("snapshot (async, sharded) -> %s", path)
            return path
        from veles_tpu_torch.checkpoint import atomic_file
        opener, ext = CODECS[self.compression]
        fname = "%s_%s.pickle%s" % (self.prefix, self.make_suffix(), ext)
        path = os.path.join(self.directory, fname)
        with atomic_file(path, opener=opener) as f:
            dump_host(self.workflow, f)
        size = os.path.getsize(path)
        self.info("snapshot -> %s (%.1f KiB)", path, size / 1024)
        link = os.path.join(self.directory,
                            "%s_current.pickle%s" % (self.prefix, ext))
        try:
            if os.path.islink(link) or os.path.exists(link):
                os.unlink(link)
            os.symlink(fname, link)
        except OSError:
            # filesystems without symlinks: a real copy, so the
            # <prefix>_current pointer still resolves
            import shutil
            shutil.copyfile(path, link)
        return path

    @staticmethod
    def load(path: str):
        """Restore a workflow from a snapshot and mark every unit
        ``_restored_from_snapshot_``. Re-``initialize`` with a device,
        then ``run`` to resume training.

        ``path`` is a pickle file, a sharded-checkpoint manifest
        (``<prefix>-NNNNNN.json``) or checkpoint directory, or a
        database URI ``db://<sqlite-file>[#<key>]`` (no key = the latest
        snapshot). A corrupt snapshot falls back to the previous one in
        the same directory with a log line; checksum-verified shards do
        the same per generation."""
        if path.startswith("db://"):
            return SnapshotterToDB.load_uri(path)
        if os.path.isdir(path) or path.endswith(".json"):
            return Snapshotter._load_sharded(path)
        log = logging.getLogger("Snapshotter")
        try:
            opener = _opener_for(path)
            with opener(path, "rb") as f:
                workflow = pickle.load(f)
            return _mark_restored(workflow)
        except (pickle.UnpicklingError, EOFError, OSError, zlib.error,
                lzma.LZMAError, ValueError) as e:
            if not os.path.exists(path):
                raise SnapshotUnavailable("no snapshot at %s" % path) \
                    from e
            log.warning("snapshot %s is corrupt (%s); looking for the "
                        "previous generation", path, e)
            return Snapshotter._load_fallback(path, e)

    @staticmethod
    def _load_fallback(path: str, cause: Exception):
        """Try older sibling snapshots (same prefix, newest first) after
        ``path`` failed to unpickle."""
        log = logging.getLogger("Snapshotter")
        directory = os.path.dirname(os.path.abspath(path))
        # "<prefix>_<suffix>.pickle[.codec]": both standard suffix forms
        # ("<epoch>_<err>pt", "%Y%m%d_%H%M%S") take the last two
        # underscore fields, and a prefix may hold underscores itself
        fields = os.path.basename(path).split(".pickle", 1)[0] \
            .split("_")
        token = "_".join(fields[:-2]) if len(fields) > 2 else fields[0]
        candidates = [
            p for p in _glob.glob(
                os.path.join(directory, "%s_*.pickle*" % token))
            if os.path.abspath(p) != os.path.abspath(path)
            and "_current.pickle" not in os.path.basename(p)
            and ".tmp." not in os.path.basename(p)]
        candidates.sort(key=os.path.getmtime, reverse=True)
        for candidate in candidates:
            try:
                opener = _opener_for(candidate)
                with opener(candidate, "rb") as f:
                    workflow = pickle.load(f)
                log.warning("fell back to previous snapshot %s",
                            candidate)
                return _mark_restored(workflow)
            except (pickle.UnpicklingError, EOFError, OSError,
                    zlib.error, lzma.LZMAError, ValueError) as e:
                log.warning("snapshot %s also corrupt (%s)", candidate, e)
        raise SnapshotUnavailable(
            "snapshot %s is corrupt and no loadable previous "
            "generation exists (%s)" % (path, cause)) from cause

    @staticmethod
    def _load_sharded(path: str):
        """Restore from a sharded checkpoint: ``path`` is a manifest or
        the checkpoint directory (the newest manifest wins). A named
        manifest restores that generation, falling back only to older
        ones."""
        from veles_tpu_torch.checkpoint import (CheckpointStore,
                                                CheckpointUnavailable,
                                                parse_manifest_name)
        max_gen = None
        if os.path.isdir(path):
            manifests = _glob.glob(os.path.join(path, "*-*.json"))
            if not manifests:
                raise SnapshotUnavailable(
                    "no checkpoint manifests in %s" % path)
            newest = max(manifests, key=os.path.getmtime)
            directory, name = path, os.path.basename(newest)
        else:
            directory, name = os.path.split(os.path.abspath(path))
        parsed = parse_manifest_name(name)
        if parsed is None:
            raise SnapshotUnavailable(
                "%s is not a checkpoint manifest" % path)
        prefix = parsed[0]
        if not os.path.isdir(path):
            max_gen = parsed[1]
        store = CheckpointStore(directory, prefix=prefix)
        try:
            _, obj, _, _ = store.load_latest(max_generation=max_gen)
        except CheckpointUnavailable as e:
            raise SnapshotUnavailable(str(e)) from e
        if obj is None:
            raise SnapshotUnavailable(
                "checkpoint %s has no whole-object capture" % path)
        return _mark_restored(obj)


def _mark_restored(workflow):
    for unit in workflow.units:
        unit._restored_from_snapshot_ = True
    workflow._restored_from_snapshot_ = True
    return workflow


_COMPRESSORS = {
    None: (lambda b: b, lambda b: b),
    "": (lambda b: b, lambda b: b),
    "gz": (gzip.compress, gzip.decompress),
    "bz2": (bz2.compress, bz2.decompress),
    "xz": (lzma.compress, lzma.decompress),
}


class SnapshotterToDB(Snapshotter):
    """Database snapshot sink: rows of (prefix, suffix, codec, created,
    size, blob) in a sqlite file.

    kwargs: ``database``, the sqlite file (created on demand);
    ``timeout`` and ``attempts``, the endpoint budget; everything else
    as :class:`Snapshotter`. ``destination`` after a save is a
    ``db://<file>#<key>`` URI that :meth:`Snapshotter.load` restores.
    """

    TABLE = ("CREATE TABLE IF NOT EXISTS snapshots ("
             "id INTEGER PRIMARY KEY AUTOINCREMENT, "
             "prefix TEXT NOT NULL, suffix TEXT NOT NULL, "
             "codec TEXT, created REAL NOT NULL, "
             "size INTEGER NOT NULL, blob BLOB NOT NULL)")

    #: endpoint budget: per-attempt sqlite busy timeout, attempt count
    #: and the base of the jittered backoff between attempts; a dead or
    #: locked endpoint raises SnapshotUnavailable after about
    #: attempts x timeout seconds instead of blocking
    DB_TIMEOUT = 10.0
    DB_ATTEMPTS = 3
    DB_RETRY_DELAY = 0.25

    def __init__(self, workflow, **kwargs: Any) -> None:
        database = kwargs.pop("database", None)
        if not database:
            raise ValueError("SnapshotterToDB needs a database= path")
        self.database = str(database)
        self.db_timeout: float = kwargs.pop("timeout", self.DB_TIMEOUT)
        self.db_attempts: int = kwargs.pop("attempts", self.DB_ATTEMPTS)
        super().__init__(workflow, **kwargs)

    @staticmethod
    def _with_retry(op, what: str, timeout: float, attempts: int,
                    retry_delay: float):
        """Run ``op(timeout)`` with bounded retries and jittered
        exponential backoff; a still-dead endpoint raises one
        :class:`SnapshotUnavailable`."""
        import sqlite3
        last: Optional[Exception] = None
        for attempt in range(max(1, attempts)):
            try:
                return op(timeout)
            except sqlite3.Error as e:
                last = e
                if attempt + 1 < attempts:
                    delay = _backoff(attempt + 1, retry_delay)
                    logging.getLogger("SnapshotterToDB").warning(
                        "%s failed (%s); retry %d/%d in %.2fs", what,
                        e, attempt + 1, attempts - 1, delay)
                    time.sleep(delay)
        raise SnapshotUnavailable(
            "%s failed after %d attempts (timeout %.1fs each): %s" %
            (what, attempts, timeout, last)) from last

    def save(self, force: bool = False) -> str:
        import sqlite3
        self._guard_nonfinite(force)
        compress, _ = _COMPRESSORS[self.compression]
        blob = compress(dumps_host(self.workflow))
        suffix = self.make_suffix()
        parent = os.path.dirname(os.path.abspath(self.database))
        os.makedirs(parent, exist_ok=True)

        def insert(timeout):
            with sqlite3.connect(self.database, timeout=timeout) as conn:
                conn.execute(self.TABLE)
                conn.execute(
                    "INSERT INTO snapshots "
                    "(prefix, suffix, codec, created, size, blob) "
                    "VALUES (?, ?, ?, ?, ?, ?)",
                    (self.prefix, suffix, self.compression or "",
                     time.time(), len(blob), sqlite3.Binary(blob)))

        self._with_retry(insert, "snapshot insert into %s" % self.database,
                         self.db_timeout, self.db_attempts,
                         self.DB_RETRY_DELAY)
        key = "%s_%s" % (self.prefix, suffix)
        uri = "db://%s#%s" % (self.database, key)
        self.info("snapshot -> %s (%.1f KiB)", uri, len(blob) / 1024)
        return uri

    @staticmethod
    def load_uri(uri: str, timeout: Optional[float] = None,
                 attempts: Optional[int] = None):
        """``db://<sqlite-file>[#<key>]``; no key = the newest row. The
        key is ``<prefix>_<suffix>`` as reported at save time. A missing
        file or a locked or dead database raises
        :class:`SnapshotUnavailable` after the bounded retry budget."""
        import sqlite3
        body = uri[len("db://"):]
        database, _, key = body.partition("#")
        if not os.path.exists(database):
            raise SnapshotUnavailable(
                "snapshot database %s does not exist" % database)

        def query(budget):
            with sqlite3.connect(database, timeout=budget) as conn:
                if key:
                    # prefix and suffix may both hold underscores: match
                    # the composed key exactly
                    return conn.execute(
                        "SELECT codec, blob FROM snapshots WHERE "
                        "prefix || '_' || suffix = ? "
                        "ORDER BY id DESC LIMIT 1", (key,)).fetchone()
                return conn.execute(
                    "SELECT codec, blob FROM snapshots "
                    "ORDER BY id DESC LIMIT 1").fetchone()

        row = SnapshotterToDB._with_retry(
            query, "snapshot load from %s" % database,
            SnapshotterToDB.DB_TIMEOUT if timeout is None else timeout,
            SnapshotterToDB.DB_ATTEMPTS if attempts is None else attempts,
            SnapshotterToDB.DB_RETRY_DELAY)
        if row is None:
            raise FileNotFoundError(
                "no snapshot %r in %s" % (key or "<latest>", database))
        codec, blob = row
        _, decompress = _COMPRESSORS[codec or None]
        return _mark_restored(pickle.loads(decompress(bytes(blob))))

    @staticmethod
    def list(database: str):
        """Snapshot metadata rows, newest first."""
        import sqlite3
        with sqlite3.connect(database) as conn:
            try:
                rows = conn.execute(
                    "SELECT prefix, suffix, codec, created, size "
                    "FROM snapshots ORDER BY id DESC").fetchall()
            except sqlite3.OperationalError:
                return []
        return [{"prefix": p, "suffix": s, "codec": c,
                 "created": t, "size": n}
                for p, s, c, t, n in rows]


class SnapshotterToDict(Snapshotter):
    """In-memory snapshot sink for tests and the ensemble layer."""

    storage: dict = {}

    def save(self, force: bool = False) -> str:
        self._guard_nonfinite(force)
        key = "%s_%s" % (self.prefix, self.make_suffix())
        SnapshotterToDict.storage[key] = dumps_host(self.workflow)
        return key

    @staticmethod
    def load_key(key: str):
        return _mark_restored(
            pickle.loads(SnapshotterToDict.storage[key]))


def attach_snapshotter(workflow, **kwargs) -> Snapshotter:
    """Insert a Snapshotter between Decision and the backward chain of a
    StandardWorkflow-shaped graph, gated to fire at improved-epoch
    boundaries."""
    snap = Snapshotter(workflow, **kwargs)
    decision = workflow.decision
    loader = workflow.loader
    snap.link_from(decision)
    gds0 = workflow.gds[0]
    gds0.unlink_from(decision)
    gds0.link_from(snap)
    snap.gate_skip = ~(loader.epoch_ended & decision.improved)
    return snap
