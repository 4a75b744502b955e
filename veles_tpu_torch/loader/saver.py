"""Minibatch record and replay: ``MinibatchesSaver`` writes every served
minibatch to one compressed file; ``MinibatchesLoader`` replays it as a
dataset.

Port of ``veles_tpu/loader/saver.py`` with its file format unchanged (a
gzip stream of pickles: a ``{"version": 1}`` header, then one
``(klass, size, data, labels)`` record of numpy arrays a minibatch), so
a file written by either package reads back in the other.
"""

from __future__ import annotations

import gzip
import pickle
from typing import Any, List, Optional

import numpy as np

from veles_tpu_torch.loader.base import LABEL_DTYPE, Loader
from veles_tpu_torch.units import Unit

FORMAT_VERSION = 1


class MinibatchesSaver(Unit):
    """Attach after a loader: writes each minibatch served.

    kwargs: ``file`` output path. Demands loader attrs via link_attrs:
    minibatch_data, minibatch_labels, minibatch_class, minibatch_size.
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.file: str = kwargs.pop("file", "minibatches.dat.gz")
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)
        self.minibatch_data = None
        self.minibatch_labels = None
        self.minibatch_class: Optional[int] = None
        self.minibatch_size: Optional[int] = None
        self.demand("minibatch_data", "minibatch_class", "minibatch_size")

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._fout_ = None

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        self._fout_ = gzip.open(self.file, "wb")
        pickle.dump({"version": FORMAT_VERSION}, self._fout_)
        return None

    def run(self) -> None:
        size = int(self.minibatch_size)
        data = np.asarray(self.minibatch_data.map_read()[:size])
        labels = None
        if self.minibatch_labels:
            labels = np.asarray(self.minibatch_labels.map_read()[:size])
        pickle.dump((int(self.minibatch_class), size, data, labels),
                    self._fout_, protocol=4)

    def stop(self) -> None:
        if self._fout_ is not None:
            self._fout_.close()
            self._fout_ = None
        super().stop()


def read_minibatches(path: str):
    """Yield (klass, size, data, labels) records from a saver file."""
    with gzip.open(path, "rb") as fin:
        header = pickle.load(fin)
        if header.get("version") != FORMAT_VERSION:
            raise ValueError("unsupported minibatches file version")
        while True:
            try:
                yield pickle.load(fin)
            except EOFError:
                return


class MinibatchesLoader(Loader):
    """Replays a MinibatchesSaver file as a dataset (the full stream is
    materialized; the file was sized by max_minibatch_size chunks)."""

    MAPPING = "minibatches"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.file: str = kwargs.pop("file", "minibatches.dat.gz")
        super().__init__(workflow, **kwargs)
        self._data: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None

    def load_data(self) -> None:
        per_class_data: List[List[np.ndarray]] = [[], [], []]
        per_class_labels: List[List[np.ndarray]] = [[], [], []]
        for klass, size, data, labels in read_minibatches(self.file):
            per_class_data[klass].append(data[:size])
            if labels is not None:
                per_class_labels[klass].append(labels[:size])
                self.has_labels = True
        datas, lbls = [], []
        for klass in range(3):
            if per_class_data[klass]:
                cat = np.concatenate(per_class_data[klass], axis=0)
                self.class_lengths[klass] = len(cat)
                datas.append(cat)
                if per_class_labels[klass]:
                    lbls.append(np.concatenate(per_class_labels[klass]))
        if not datas:
            raise ValueError("empty minibatches file %s" % self.file)
        self._data = np.concatenate(datas, axis=0)
        if self.has_labels:
            self._labels = np.concatenate(lbls).astype(LABEL_DTYPE)

    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size,) + self._data.shape[1:]
        self.minibatch_data.reset(np.zeros(shape, dtype=self._data.dtype))
        if self.has_labels:
            self.minibatch_labels.reset(
                np.zeros(self.max_minibatch_size, dtype=LABEL_DTYPE))

    def fill_minibatch(self) -> None:
        size = self.minibatch_size
        idx = np.asarray(self.minibatch_indices.map_read()[:size])
        self.minibatch_data.map_invalidate()[:size] = self._data[idx]
        if self.has_labels:
            for i, lbl in enumerate(self._labels[idx]):
                self.raw_minibatch_labels[i] = int(lbl)
