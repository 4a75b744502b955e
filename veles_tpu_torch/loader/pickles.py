"""Pickled-array dataset loader: one pickle file per sample class.

Port of ``veles_tpu/loader/pickles.py``. Each pickle holds an ndarray
``[N, ...]``, a ``(data, labels)`` tuple or a ``{"data", "labels"}``
dict; the data becomes an f32 full-batch dataset gathered on the
device.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np

from veles_tpu_torch.loader.base import LABEL_DTYPE, TEST, TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def _unpack(obj):
    if isinstance(obj, dict):
        return np.asarray(obj["data"]), obj.get("labels")
    if isinstance(obj, tuple) and len(obj) == 2:
        return np.asarray(obj[0]), obj[1]
    return np.asarray(obj), None


class PicklesLoader(FullBatchLoader):
    """kwargs: ``test_path``/``validation_path``/``train_path``."""

    MAPPING = "pickles"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.test_path: Optional[str] = kwargs.pop("test_path", None)
        self.validation_path: Optional[str] = kwargs.pop(
            "validation_path", None)
        self.train_path: Optional[str] = kwargs.pop("train_path", None)
        super().__init__(workflow, **kwargs)

    def load_data(self) -> None:
        paths = (self.test_path, self.validation_path, self.train_path)
        datas, labels, n_labels = [], [], 0
        for klass in (TEST, VALID, TRAIN):
            if paths[klass] is None:
                continue
            with open(paths[klass], "rb") as fin:
                data, lbl = _unpack(pickle.load(fin))
            datas.append(data.astype(np.float32))
            self.class_lengths[klass] = len(data)
            if lbl is not None:
                labels.append(np.asarray(lbl))
                n_labels += len(lbl)
        if not datas:
            raise ValueError("PicklesLoader: no files given")
        self.original_data = np.concatenate(datas, axis=0)
        if labels:
            if n_labels != len(self.original_data):
                raise ValueError("labels/data length mismatch")
            self.has_labels = True
            self.original_labels = np.concatenate(labels).astype(
                LABEL_DTYPE)
