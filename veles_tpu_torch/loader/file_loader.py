"""File-scanning loader bases: datasets defined by directories or file
lists per TEST/VALID/TRAIN class.

Port of ``veles_tpu/loader/file_loader.py``: :func:`scan_files` expands
paths into a sorted, pattern-filtered file list, and
:class:`FileListLoaderBase` builds one ``(path, index in file)`` table
over the three classes; subclasses say how many samples a file holds
and how to read them.
"""

from __future__ import annotations

import fnmatch
import os
from typing import Any, List, Optional, Sequence, Tuple

from veles_tpu_torch.loader.base import TEST, TRAIN, VALID, Loader


def scan_files(paths: Sequence[str], pattern: str = "*",
               recursive: bool = True) -> List[str]:
    """Expand a list of files/directories into a sorted file list;
    directories are walked (optionally recursively) and filtered by
    fnmatch pattern. Deterministic order (sorted) so index-based
    train/valid splits are reproducible."""
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
        elif os.path.isdir(path):
            if recursive:
                for dirpath, dirnames, filenames in os.walk(path):
                    dirnames.sort()
                    for fname in sorted(filenames):
                        if fnmatch.fnmatch(fname, pattern):
                            out.append(os.path.join(dirpath, fname))
            else:
                for fname in sorted(os.listdir(path)):
                    full = os.path.join(path, fname)
                    if os.path.isfile(full) and \
                            fnmatch.fnmatch(fname, pattern):
                        out.append(full)
        else:
            raise FileNotFoundError("dataset path %s does not exist" % path)
    return out


class FileListLoaderBase(Loader):
    """Scans ``test_paths`` / ``validation_paths`` / ``train_paths``
    into per-class file tables. Subclasses decide how many samples one
    file holds (``samples_in_file``) and how to read them."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.test_paths: Sequence[str] = kwargs.pop("test_paths", ())
        self.validation_paths: Sequence[str] = kwargs.pop(
            "validation_paths", ())
        self.train_paths: Sequence[str] = kwargs.pop("train_paths", ())
        self.file_pattern: str = kwargs.pop("file_pattern", "*")
        self.recursive_scan: bool = kwargs.pop("recursive_scan", True)
        super().__init__(workflow, **kwargs)
        self.class_files: List[List[str]] = [[], [], []]
        # flat table: global sample index -> (path, index inside file)
        self.sample_table: List[Tuple[str, int]] = []

    def samples_in_file(self, path: str) -> int:
        """Default: one sample per file."""
        return 1

    def label_of_file(self, path: str) -> Optional[Any]:
        """Default label = name of the containing directory (the usual
        imagenet-style layout); subclasses may override."""
        return os.path.basename(os.path.dirname(path))

    def load_data(self) -> None:
        class_paths = (self.test_paths, self.validation_paths,
                       self.train_paths)
        for klass in (TEST, VALID, TRAIN):
            files = scan_files(class_paths[klass], self.file_pattern,
                               self.recursive_scan)
            self.class_files[klass] = files
            count = 0
            for path in files:
                n = self.samples_in_file(path)
                for i in range(n):
                    self.sample_table.append((path, i))
                count += n
            self.class_lengths[klass] = count
