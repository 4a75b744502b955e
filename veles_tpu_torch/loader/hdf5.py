"""HDF5 dataset loader: train/validation/test files with data and label
datasets, loaded once into a full-batch dataset gathered on the device.

Port of ``veles_tpu/loader/hdf5.py``. Each file holds datasets named
``data`` and (optionally) ``labels``. h5py is imported when the data is
loaded and the loader raises without it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from veles_tpu_torch.loader.base import LABEL_DTYPE, TEST, TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    """kwargs: ``test_file``/``validation_file``/``train_file`` paths;
    ``data_name``/``labels_name`` dataset names."""

    MAPPING = "hdf5"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.test_file: Optional[str] = kwargs.pop("test_file", None)
        self.validation_file: Optional[str] = kwargs.pop(
            "validation_file", None)
        self.train_file: Optional[str] = kwargs.pop("train_file", None)
        self.data_name: str = kwargs.pop("data_name", "data")
        self.labels_name: str = kwargs.pop("labels_name", "labels")
        super().__init__(workflow, **kwargs)

    def load_data(self) -> None:
        try:
            import h5py
        except ImportError as e:
            raise RuntimeError(
                "HDF5Loader requires h5py, which is unavailable") from e
        files = (self.test_file, self.validation_file, self.train_file)
        datas, labels = [], []
        for klass in (TEST, VALID, TRAIN):
            if files[klass] is None:
                continue
            with h5py.File(files[klass], "r") as f:
                data = np.asarray(f[self.data_name], dtype=np.float32)
                datas.append(data)
                self.class_lengths[klass] = len(data)
                if self.labels_name in f:
                    labels.append(np.asarray(f[self.labels_name]))
        if not datas:
            raise ValueError("HDF5Loader: no files given")
        self.original_data = np.concatenate(datas, axis=0)
        if labels:
            if sum(map(len, labels)) != len(self.original_data):
                raise ValueError("labels/data length mismatch")
            self.has_labels = True
            self.original_labels = np.concatenate(labels).astype(
                LABEL_DTYPE)
