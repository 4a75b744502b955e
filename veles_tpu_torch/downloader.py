"""Downloader: fetch and extract a dataset at initialize time.

Port of ``veles_tpu/downloader.py``: ``source`` may be a local path,
a ``file://`` URL or an ``http(s)://`` URL (urllib). Archives (zip,
tar, tgz, txz) are extracted, tar members through the ``data``
extraction filter where Python has it; other files are copied. A stamp
file makes a second initialize skip a completed download.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile
from typing import Any, Optional

from veles_tpu_torch.config import root
from veles_tpu_torch.units import Unit


def fetch(source: str, directory: str) -> str:
    """Fetch ``source`` into ``directory``; returns the local file."""
    parsed = urllib.parse.urlparse(source)
    os.makedirs(directory, exist_ok=True)
    if parsed.scheme in ("", "file"):
        path = parsed.path if parsed.scheme == "file" else source
        dest = os.path.join(directory, os.path.basename(path))
        if os.path.abspath(path) != os.path.abspath(dest):
            shutil.copy(path, dest)
        return dest
    dest = os.path.join(directory, os.path.basename(parsed.path))
    with urllib.request.urlopen(source) as resp, open(dest, "wb") as out:
        shutil.copyfileobj(resp, out)
    return dest


def _extractall(tf: tarfile.TarFile, directory: str) -> None:
    """extractall with the safe 'data' filter where supported (the
    filter kwarg exists from Python 3.10.12/3.11.4 on)."""
    try:
        tf.extractall(directory, filter="data")
    except TypeError:
        tf.extractall(directory)  # noqa: S202 - older Python


def extract(path: str, directory: str) -> None:
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(directory)  # noqa: S202 - trusted dataset
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            _extractall(tf, directory)
    # plain files stay as fetched


class Downloader(Unit):
    """kwargs: ``url`` (or local path), ``directory`` (default:
    root.common.dirs.datasets)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.url: str = kwargs.pop("url")
        self.directory: Optional[str] = kwargs.pop("directory", None)
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        directory = self.directory or str(root.common.dirs.datasets)
        stamp = os.path.join(
            directory, ".downloaded_%s" %
            os.path.basename(urllib.parse.urlparse(self.url).path
                             or "dataset"))
        if os.path.exists(stamp):
            return None
        local = fetch(self.url, directory)
        extract(local, directory)
        with open(stamp, "w") as fout:
            fout.write(self.url)
        self.info("fetched %s -> %s", self.url, directory)
        return None

    def run(self) -> None:
        pass  # all work happens at initialize, as in the reference
