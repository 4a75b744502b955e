"""Full-batch loaders: the whole dataset resident on the device, each
minibatch one gather there.

Port of ``veles_tpu/loader/fullbatch.py``. ``FullBatchLoader`` keeps the
dataset, its mapped labels and the epoch's permutation (padded by one
minibatch) on the unit's device. A minibatch is one ``index_select``
of ``max_minibatch_size`` rows through the permutation's window, the
normalizer's ``apply_torch`` on the result, and the rows past the short
tail's ``size`` zeroed (labels -1), as the reference's jit gather does:
no minibatch is copied through the host. The permutation is uploaded
once per shuffle; a job's indices (``apply_data_from_master``) patch
its window in place (``copy_``), where the reference donates the buffer
to a ``dynamic_update_slice``. The host path (``fill_minibatch``) serves
the normalizer's analysis pass and ``store_on_device=False``. With
``external_gather`` set (by ``FusedClassifierTrainer.make_loader_step``)
``run()`` keeps the epoch and offset bookkeeping and the permutation
upload but gathers nothing: the fused step gathers the window itself,
through :meth:`FullBatchLoader.gather`, the one gather both use.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.loader.base import (CLASS_NAME, INDEX_DTYPE,
                                        LABEL_DTYPE, TRAIN, Loader)
from veles_tpu_torch.memory import Array


class FullBatchLoader(Loader, AcceleratedUnit):
    """In-memory dataset with a device-side minibatch gather.

    Subclasses implement :meth:`load_data`, which fills
    ``original_data`` (ndarray ``[N, ...]``), optionally
    ``original_labels`` (length N) and ``class_lengths``.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.store_on_device = kwargs.pop("store_on_device", True)
        super().__init__(workflow, **kwargs)
        self.original_data: Optional[np.ndarray] = None
        self.original_labels: Optional[np.ndarray] = None
        #: set by a fused consumer (``make_loader_step``) that gathers
        #: the served window itself: ``run()`` then serves TRAIN
        #: bookkeeping only and refuses any other class
        self.external_gather = False

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._dataset_dev_ = None
        self._labels_dev_ = None
        self._stats_dev_ = None
        self._perm_dev_ = None

    # -- ILoader -----------------------------------------------------------
    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size,) + self.original_data.shape[1:]
        self.minibatch_data.reset(
            np.zeros(shape, dtype=self.original_data.dtype))
        if self.has_labels:
            self.minibatch_labels.reset(
                np.zeros(self.max_minibatch_size, dtype=LABEL_DTYPE))

    def fill_minibatch(self) -> None:
        """The host path (normalization analysis, ``store_on_device=
        False``)."""
        size = self.minibatch_size
        idx = np.asarray(self.minibatch_indices.map_read()[:size])
        self.minibatch_data.map_invalidate()[:size] = self.original_data[idx]
        if self.has_labels:
            labels = np.asarray(self.original_labels)[idx]
            for i, lbl in enumerate(labels):
                self.raw_minibatch_labels[i] = lbl.item() \
                    if hasattr(lbl, "item") else lbl

    # -- device-side serve -------------------------------------------------
    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        # the served buffers live on the unit's device, as the units
        # that read them do
        for arr in (self.minibatch_data, self.minibatch_labels,
                    self.minibatch_indices):
            if arr:
                arr.initialize(self.device)
        if self.store_on_device:
            self._put_dataset()
        return None

    def _put_dataset(self) -> None:
        self._dataset_dev_ = self.device.put(self.original_data)
        if self.has_labels:
            mapped = np.asarray(
                [self.labels_mapping.get(
                    lbl.item() if hasattr(lbl, "item") else lbl,
                    lbl if isinstance(lbl, (int, np.integer)) else -1)
                 for lbl in self.original_labels], dtype=LABEL_DTYPE)
            self._labels_dev_ = self.device.put(mapped)
        self._stats_dev_ = {k: self.device.put(v) for k, v in
                            self.normalizer.stat_arrays().items()}

    def gather(self, start: int, size: int,
               dataset: Optional[torch.Tensor] = None,
               perm: Optional[torch.Tensor] = None):
        """Minibatch ``(data, labels)`` of the permutation's window
        ``[start, start + max_minibatch_size)``, rows from ``size`` on
        zeroed (labels -1): :meth:`gather_indices` of that window.
        ``dataset`` (default ``_dataset_dev_``) and ``perm`` (default
        ``_perm_dev_``) let a fused step gather from its compute-dtype
        copy and from a window taken before a reshuffle."""
        perm = self._perm_dev_ if perm is None else perm
        indices = perm[start:start + self.max_minibatch_size]
        valid = None if size == len(indices) else torch.full(
            (), size, dtype=torch.int64, device=indices.device)
        return self.gather_indices(indices, valid, dataset)

    def gather_indices(self, indices: torch.Tensor,
                       size: Optional[torch.Tensor] = None,
                       dataset: Optional[torch.Tensor] = None):
        """Minibatch ``(data, labels)`` of a window already on the
        device: ``indices`` holds its ``max_minibatch_size`` sample
        indices (a slice of a permutation), ``size`` (a 0-d integer
        tensor on the device, or None for a full window) its valid
        rows; rows from ``size`` on read sample 0 and are zeroed
        (labels -1). One gather on the device, then the normalizer.
        Nothing is read back to the host, so a captured loader step
        gathers this way, its window and size rewritten in place
        between replays."""
        if dataset is None:
            dataset = self._dataset_dev_
        keep = None
        if size is not None:
            keep = torch.arange(len(indices), device=indices.device) < size
            indices = torch.where(keep, indices, 0)
        data = self.normalizer.apply_torch(
            dataset.index_select(0, indices), self._stats_dev_)
        if self.has_labels:
            labels = self._labels_dev_.index_select(0, indices)
        else:
            labels = torch.zeros(len(indices), dtype=torch.int32,
                                 device=data.device)
        if keep is not None:
            data = torch.where(
                keep.view((-1,) + (1,) * (data.ndim - 1)), data, 0)
            if self.has_labels:
                labels = torch.where(keep, labels, -1)
        return data, labels

    def shuffle(self) -> bool:
        changed = super().shuffle()
        if changed:
            self._perm_dev_ = None  # the device copy is stale
        return changed

    def apply_data_from_master(self, data) -> None:
        # the job's indices land in shuffled_indices: patch the same
        # window of the device permutation in place, O(minibatch), not
        # a re-upload of the whole epoch
        super().apply_data_from_master(data)
        if self._perm_dev_ is None:
            return
        start = self.minibatch_offset - self.minibatch_size
        patch = np.asarray(data["indices"], dtype=INDEX_DTYPE)
        self._perm_dev_[start:start + len(patch)].copy_(
            torch.from_numpy(patch))

    def fill_indices(self, start: int, size: int) -> bool:
        """The whole serve on the device."""
        mem = self.minibatch_indices.map_write()
        mem[:size] = self.shuffled_indices[start:start + size]
        mem[size:] = -1
        if self._dataset_dev_ is None or self.is_master:
            return False
        if self._perm_dev_ is None:
            # one upload per (re)shuffle, padded by a minibatch so the
            # window of the last minibatch stays inside the buffer
            perm = np.concatenate([
                np.asarray(self.shuffled_indices.map_read(),
                           dtype=INDEX_DTYPE),
                np.zeros(self.max_minibatch_size, dtype=INDEX_DTYPE)])
            self._perm_dev_ = self.device.put(perm)
        if self.external_gather:
            # a fused consumer gathers this window itself: serving here
            # would double the work, and minibatch_data stays stale, so
            # a class the fused step does not consume must not pass
            if self.minibatch_class != TRAIN:
                # requeue the window, so that the error is loud but
                # loses nothing: once the flag is cleared, the next
                # run() serves this same (offset, size)
                self.failed_minibatches.append(
                    (self.minibatch_offset, self.minibatch_size))
                raise RuntimeError(
                    "external_gather is active but a %s minibatch was "
                    "served; set loader.external_gather = False before "
                    "serving VALID/TEST data to other consumers" %
                    CLASS_NAME[self.minibatch_class])
            return True
        data, labels = self.gather(start, size)
        self.minibatch_data.devmem = data
        if self.has_labels:
            self.minibatch_labels.devmem = labels
        return True

    def __getstate__(self):
        """Keep the dataset out of snapshots: load_data() fills it again
        when the restored loader is initialized."""
        state = super().__getstate__()
        for key in ("original_data", "original_labels", "original_targets"):
            if key in state:
                state[key] = None
        return state


class FullBatchLoaderMSE(FullBatchLoader):
    """Full-batch loader with regression targets, gathered beside the
    data."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.original_targets: Optional[np.ndarray] = None
        self.minibatch_targets = Array()

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._targets_dev_ = None

    def create_minibatch_data(self) -> None:
        super().create_minibatch_data()
        shape = (self.max_minibatch_size,) + self.original_targets.shape[1:]
        self.minibatch_targets.reset(
            np.zeros(shape, dtype=self.original_targets.dtype))

    def fill_minibatch(self) -> None:
        super().fill_minibatch()
        size = self.minibatch_size
        idx = np.asarray(self.minibatch_indices.map_read()[:size])
        self.minibatch_targets.map_invalidate()[:size] = \
            self.original_targets[idx]

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        self.minibatch_targets.initialize(self.device)
        if self._dataset_dev_ is not None:
            self._targets_dev_ = self.device.put(self.original_targets)
        return None

    def gather_targets(self, start: int, size: int) -> torch.Tensor:
        """The targets of the window :meth:`gather` serves, rows from
        ``size`` on zeroed."""
        out = self._targets_dev_.index_select(
            0, self._perm_dev_[start:start + self.max_minibatch_size])
        out[size:] = 0
        return out

    def fill_indices(self, start: int, size: int) -> bool:
        if self.external_gather:
            # the fused classifier step gathers no targets, so
            # minibatch_targets would go stale
            raise RuntimeError(
                "external_gather is not supported on MSE loaders: the "
                "fused classifier step does not gather targets, so "
                "minibatch_targets would go stale")
        served = super().fill_indices(start, size)
        if served and self._targets_dev_ is not None:
            self.minibatch_targets.devmem = self.gather_targets(start, size)
        return served
