"""Package-archive I/O: one extraction, shared by every consumer.

Port of ``veles_tpu/aot/package.py``. A ``Workflow.package_export``
archive (``contents.json`` + ``NNNN_<name>.npy`` weights, optionally
``aot/`` capture records) is read by several consumers
(``InferenceEngine.from_package``, the AOT bundle loader, a replica's
``POST /admin/swap``). It is extracted ONCE into a content-addressed
directory under the temp dir (``veles-torch-pkg-<sha256[:16]>``;
extract to a tmp dir, fsync, atomic rename, so a half-extracted
directory is never seen) and the parsed members are memoized in the
process, so two engines from one package cost one archive read.
The archives are byte-compatible with the reference's: either package
reads the other's.

Every member name is checked before anything is written: a name that
is absolute, holds a ``..`` component that leaves the extraction
directory once normalized, or names a symlink, hardlink or device
member raises :class:`UnsafeArchive`, and the archive is not extracted
at all. The reference writes each member to ``os.path.join(tmp,
name)`` unchecked; since ``/admin/swap`` takes the path from an HTTP
body, the port refuses such archives (a deliberate divergence).

Packages carry data only: weights and JSON capture records, never a
shared library.

:data:`ARCHIVE_BYTES_READ` counts the bytes decompressed from archives
(a second consumer of the same package must not move it).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import posixpath
import shutil
import stat
import tarfile
import tempfile
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

#: bytes decompressed from package archives so far (process-wide);
#: reads served from the memo or an earlier extraction do not count
ARCHIVE_BYTES_READ = 0

#: archive member prefix holding the AOT bundle (manifest + records)
AOT_PREFIX = "aot/"
AOT_MANIFEST = AOT_PREFIX + "manifest.json"

_lock = threading.Lock()
# guarded-by: _lock
_memo: Dict[Tuple[str, int, int], "ExtractedPackage"] = {}


class UnsafeArchive(ValueError):
    """An archive member would land outside the extraction directory
    (or is a link or a device): the archive is refused whole."""


def safe_member_name(name: str) -> str:
    """The normalized relative path of an archive member, or
    :class:`UnsafeArchive` when it is empty, absolute, holds a
    backslash or a NUL, or leaves the extraction directory."""
    if not name or "\x00" in name or "\\" in name:
        raise UnsafeArchive("archive member %r: empty, NUL or backslash "
                            "in the name" % (name,))
    if name.startswith("/") or (len(name) > 1 and name[1] == ":"):
        raise UnsafeArchive("archive member %r is an absolute path"
                            % (name,))
    norm = posixpath.normpath(name)
    if norm in (".", "..") or norm.startswith("../"):
        raise UnsafeArchive("archive member %r leaves the extraction "
                            "directory" % (name,))
    return norm


def _zip_members(zf: zipfile.ZipFile) -> List[Tuple[str, zipfile.ZipInfo]]:
    out = []
    for info in zf.infolist():
        if info.is_dir():
            safe_member_name(info.filename)
            continue
        kind = stat.S_IFMT(info.external_attr >> 16)
        if kind not in (0, stat.S_IFREG):
            raise UnsafeArchive("archive member %r is a link or a device "
                                "(mode %o)" % (info.filename, kind))
        out.append((safe_member_name(info.filename), info))
    return out


def _tar_members(tf: tarfile.TarFile) -> List[Tuple[str, tarfile.TarInfo]]:
    out = []
    for member in tf.getmembers():
        name = safe_member_name(member.name)
        if member.isdir():
            continue
        if not member.isfile():
            raise UnsafeArchive("archive member %r is a link or a device"
                                % (member.name,))
        out.append((name, member))
    return out


def _read_archive_blobs(path: str) -> Dict[str, bytes]:
    """{member name: bytes}: every name is checked first, then the
    members are read; the only place archive bytes are decompressed
    (bumps :data:`ARCHIVE_BYTES_READ`)."""
    global ARCHIVE_BYTES_READ
    blobs: Dict[str, bytes] = {}
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            for name, info in _zip_members(zf):
                blobs[name] = zf.read(info)
    else:
        with tarfile.open(path) as tf:
            for name, member in _tar_members(tf):
                blobs[name] = tf.extractfile(member).read()
    ARCHIVE_BYTES_READ += sum(len(b) for b in blobs.values())
    return blobs


class ExtractedPackage:
    """Parsed view of one archive: ``contents`` (the contents.json
    dict, None for a bundle-only archive), ``arrays`` (npy member name
    -> ndarray, loaded lazily), the ``aot/`` members' bytes."""

    def __init__(self, root: str, members: List[str]) -> None:
        self.root = root
        self.members = members
        self._arrays: Dict[str, np.ndarray] = {}
        self._contents: Optional[dict] = None
        self._contents_loaded = False

    def _path(self, name: str) -> str:
        return os.path.join(self.root, safe_member_name(name))

    @property
    def contents(self) -> Optional[dict]:
        if not self._contents_loaded:
            self._contents_loaded = True
            path = os.path.join(self.root, "contents.json")
            if os.path.exists(path):
                with open(path) as f:
                    self._contents = json.load(f)
        return self._contents

    def array(self, name: str) -> np.ndarray:
        arr = self._arrays.get(name)
        if arr is None:
            arr = np.load(self._path(name), allow_pickle=False)
            self._arrays[name] = arr
        return arr

    @property
    def arrays(self) -> Dict[str, np.ndarray]:
        """All ``*.npy`` members, loaded (memoized per instance)."""
        for name in self.members:
            if name.endswith(".npy") and not name.startswith(AOT_PREFIX):
                self.array(name)
        return self._arrays

    def aot_blob(self, name: str) -> bytes:
        """Raw bytes of an ``aot/`` member."""
        with open(self._path(name), "rb") as f:
            return f.read()


def _cache_root() -> str:
    return os.path.join(tempfile.gettempdir(), "veles-torch-pkg-cache")


def _commit(blobs: Dict[str, bytes], root: str, digest: str) -> None:
    """Write ``blobs`` into ``root`` through a tmp dir, fsync, rename;
    a concurrent process that committed the same content first wins."""
    tmp = "%s.tmp.%d.%d" % (root, os.getpid(), threading.get_ident())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    real_tmp = os.path.realpath(tmp)
    for name, blob in blobs.items():
        dest = os.path.join(tmp, name)
        # the name was checked; this holds it against what the file
        # system makes of it
        if not os.path.realpath(dest).startswith(real_tmp + os.sep):
            shutil.rmtree(tmp, ignore_errors=True)
            raise UnsafeArchive("archive member %r leaves the extraction "
                                "directory" % (name,))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write(digest)
    try:
        os.rename(tmp, root)
    except OSError:
        # a concurrent process committed the same content first; its
        # extraction is byte-identical
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.exists(os.path.join(root, ".complete")):
            raise


def extract_package(path: str) -> ExtractedPackage:
    """Extract (or reuse an earlier extraction of) ``path``.

    Keyed in the process on ``(realpath, size, mtime_ns)`` and on disk
    on the archive's content hash, so a re-exported archive lands in a
    fresh directory and processes serving one package share one
    extraction. Raises :class:`UnsafeArchive` before writing anything
    when a member would escape."""
    real = os.path.realpath(path)
    st = os.stat(real)
    key = (real, st.st_size, st.st_mtime_ns)
    with _lock:
        hit = _memo.get(key)
    if hit is not None:
        return hit
    with open(real, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_cache_root(), exist_ok=True)
    root = os.path.join(_cache_root(), digest)
    if not os.path.exists(os.path.join(root, ".complete")):
        blobs = _read_archive_blobs(real)
        _commit(blobs, root, digest)
        members = sorted(blobs)
    else:
        members = []
        for dirpath, _, files in os.walk(root):
            for fname in files:
                if fname == ".complete":
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                members.append(rel.replace(os.sep, "/"))
        members.sort()
    pkg = ExtractedPackage(root, members)
    with _lock:
        _memo[key] = pkg
    return pkg


def clear_extraction_memo() -> None:
    """Forget the in-process extractions (the directories stay)."""
    with _lock:
        _memo.clear()


def read_package(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(contents dict, {npy name: ndarray}) of a package archive."""
    pkg = extract_package(path)
    if pkg.contents is None:
        raise ValueError("%s is not a package archive (no contents.json)"
                         % path)
    return pkg.contents, pkg.arrays


def write_package(filename: str, contents: dict,
                  arrays: List[Tuple[str, np.ndarray]],
                  extra_files: Optional[Dict[str, bytes]] = None) -> str:
    """Write a package archive (zip, or tar[.gz]) from its pieces: the
    archive half of ``Workflow.package_export``. ``extra_files`` maps
    member names (``aot/...``) to raw bytes."""
    tmpdir = tempfile.mkdtemp(prefix="veles_torch_pkg_")
    try:
        members: List[Tuple[str, str]] = []
        cpath = os.path.join(tmpdir, "contents.json")
        with open(cpath, "w") as fout:
            json.dump(contents, fout, indent=2, default=_json_default)
        members.append(("contents.json", cpath))
        for fname, arr in arrays:
            p = os.path.join(tmpdir, fname)
            np.save(p, arr)
            members.append((fname, p))
        for fname, blob in (extra_files or {}).items():
            p = os.path.join(tmpdir, fname.replace("/", "__"))
            with open(p, "wb") as f:
                f.write(blob)
            members.append((fname, p))
        _write_members(filename, members)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return filename


def _tar_mode(filename: str) -> str:
    return "w:gz" if filename.endswith((".tgz", ".tar.gz")) else "w"


def _write_members(filename: str, members: List[Tuple[str, str]]) -> None:
    if filename.endswith(".zip"):
        with zipfile.ZipFile(filename, "w", zipfile.ZIP_DEFLATED) as zf:
            for name, p in members:
                zf.write(p, name)
    else:
        with tarfile.open(filename, _tar_mode(filename)) as tf:
            for name, p in members:
                tf.add(p, name)


def embed_files(path: str, files: Dict[str, bytes]) -> None:
    """Rewrite archive ``path`` with ``files`` added or replaced (how
    ``--aot-export`` lands the ``aot/`` bundle inside a package); the
    rewritten archive replaces the old one with ``os.replace``."""
    blobs = _read_archive_blobs(path)
    blobs.update(files)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        if zipfile.is_zipfile(path) or path.endswith(".zip"):
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, blob in blobs.items():
                    zf.writestr(name, blob)
        else:
            with tarfile.open(tmp, _tar_mode(path)) as tf:
                for name, blob in blobs.items():
                    info = tarfile.TarInfo(name)
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    clear_extraction_memo()


def write_bundle_archive(path: str, files: Dict[str, bytes]) -> None:
    """A standalone AOT bundle archive (``aot/`` members only, no
    weights): the ``--aot-export`` target when PATH is no package."""
    tmpdir = tempfile.mkdtemp(prefix="veles_torch_aot_")
    try:
        members = []
        for name, blob in files.items():
            p = os.path.join(tmpdir, name.replace("/", "__"))
            with open(p, "wb") as f:
                f.write(blob)
            members.append((name, p))
        _write_members(path, members)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _json_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError("%r is not JSON serializable" % (obj,))
