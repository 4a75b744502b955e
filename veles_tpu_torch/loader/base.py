"""Loader base: minibatch serving over TEST/VALID/TRAIN sample classes.

Port of ``veles_tpu/loader/base.py``. A ``Loader`` serves minibatches
across the three sample classes of an epoch, in the order TEST, VALID,
TRAIN (class offsets are cumulative); it shuffles the TRAIN slice with
its stream's numpy generator (the reference's exact permutation for the
same seed and stream name), runs the normalizer's analysis pass and the
label mapping over TRAIN, and keeps the ``last_minibatch`` /
``epoch_ended`` / ``train_ended`` / ``test_ended`` flags. The epoch
ends when the last VALID minibatch is served (TRAIN when there is no
VALID class). On a coordinator it schedules minibatch index slices as
jobs with failed and pending tracking and requeues a dropped worker's
slices; the farm that calls those hooks is a later slice.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import normalization
from veles_tpu_torch import prng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit, UnitRegistry
from veles_tpu_torch.workflow import IResultProvider

TEST = 0
VALID = 1
TRAIN = 2
CLASS_NAME = ("test", "validation", "train")

LABEL_DTYPE = np.int32
INDEX_DTYPE = np.int32


class UserLoaderRegistry(UnitRegistry):
    """name -> loader class for config-driven instantiation
    (reference: veles/loader/base.py:83-93). The actual recording now
    happens in the generic UnitRegistry MAPPING mechanism (Loader sets
    ``MAPPING_GROUP = "loader"``); this class remains the loaders'
    metaclass and exposes the familiar ``loaders`` view so there is
    exactly ONE registry underneath."""

    class _LoadersView:
        def __get__(self, obj, objtype=None) -> Dict[str, type]:
            return UnitRegistry.mapped.get("loader", {})

    loaders = _LoadersView()


class ILoader:
    """The loader interface (reference: veles/loader/base.py:100-115)."""

    def load_data(self) -> None:
        """Discover the dataset: set ``class_lengths`` (and keep any
        handles needed by fill_minibatch)."""
        raise NotImplementedError

    def create_minibatch_data(self) -> None:
        """Allocate ``minibatch_data`` for ``max_minibatch_size``."""
        raise NotImplementedError

    def fill_minibatch(self) -> None:
        """Copy the samples selected by ``minibatch_indices`` into
        ``minibatch_data`` (and labels)."""
        raise NotImplementedError


class Loader(Unit, IResultProvider, ILoader, metaclass=UserLoaderRegistry):
    """Serves minibatches; schedules index slices when distributed."""

    hide_from_registry = True
    MAPPING: Optional[str] = None
    MAPPING_GROUP = "loader"  # -> UnitRegistry.mapped["loader"]

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.minibatch_size_requested = kwargs.pop("minibatch_size", 100)
        self.shuffle_limit = kwargs.pop("shuffle_limit", np.iinfo(np.int64).max)
        self.normalization_type = kwargs.pop("normalization_type", "none")
        self.normalization_parameters = kwargs.pop(
            "normalization_parameters", {})
        self.train_ratio = kwargs.pop("train_ratio", 1.0)
        prng_stream = kwargs.pop("prng_stream", "loader")
        kwargs.setdefault("view_group", "LOADER")
        super().__init__(workflow, **kwargs)

        self.class_lengths: List[int] = [0, 0, 0]
        self.has_labels = False

        # control-flow flags consumed by Decision units and gates
        self.last_minibatch = Bool(False, name="last_minibatch")
        self.epoch_ended = Bool(False, name="epoch_ended")
        self.train_ended = Bool(False, name="train_ended")
        self.test_ended = Bool(False, name="test_ended")
        self.epoch_number = 0
        self.samples_served = 0
        self.minibatches_served = 0
        self.global_offset = 0

        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.minibatch_size = 0
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_indices = Array()
        self.raw_minibatch_labels: List[Any] = []
        self.labels_mapping: Dict[Any, int] = {}

        self.shuffled_indices = Array()
        self.failed_minibatches: List[Tuple[int, int]] = []
        self.rand = prng.get(prng_stream)
        self.normalizer = None

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self.pending_minibatches_: Dict[Any, List[Tuple[int, int]]] = \
            defaultdict(list)
        self._serve_timestamp_ = time.time()

    # -- derived geometry --------------------------------------------------
    @property
    def total_samples(self) -> int:
        return sum(self.class_lengths)

    @property
    def effective_total_samples(self) -> int:
        """train_ratio < 1 serves only a head slice of TRAIN
        (reference: veles/loader/base.py:560-566)."""
        return self.total_samples - int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])

    @property
    def class_end_offsets(self) -> List[int]:
        out, acc = [], 0
        for length in self.class_lengths:
            acc += length
            out.append(acc)
        return out

    @property
    def max_minibatch_size(self) -> int:
        longest = max(self.class_lengths) if any(self.class_lengths) else 1
        return max(1, min(self.minibatch_size_requested, longest))

    def class_index_by_sample_index(self, offset: int) -> Tuple[int, int]:
        """(class, samples remaining in that class after offset)."""
        ends = self.class_end_offsets
        for klass, end in enumerate(ends):
            if offset < end and self.class_lengths[klass]:
                if klass == TRAIN:
                    end = min(end, self.effective_total_samples)
                return klass, end - offset
        raise ValueError("offset %d outside dataset (%d samples)" %
                         (offset, self.total_samples))

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        self.normalizer = normalization.normalizer(
            self.normalization_type, **dict(self.normalization_parameters))
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("load_data() found no samples")
        self.info("dataset: test=%d valid=%d train=%d, minibatch=%d",
                  self.class_lengths[TEST], self.class_lengths[VALID],
                  self.class_lengths[TRAIN], self.max_minibatch_size)
        self.minibatch_indices.reset(
            np.zeros(self.max_minibatch_size, dtype=INDEX_DTYPE))
        self.raw_minibatch_labels = [None] * self.max_minibatch_size
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise RuntimeError(
                "minibatch_data must be allocated by create_minibatch_data()")
        self.analyze_dataset()
        if not getattr(self, "_restored_from_snapshot_", False):
            self.shuffle()
        return None

    def analyze_dataset(self) -> None:
        """Normalization analysis + label mapping over the TRAIN class
        (reference: veles/loader/base.py:755-803)."""
        if self.class_lengths[TRAIN] == 0:
            # No train samples to analyze: a stateful normalizer must
            # arrive pre-initialized (normalizer.state), as the
            # reference asserts (veles/loader/base.py analyze_dataset).
            if not isinstance(self.normalizer,
                              normalization.StatelessNormalizer) \
                    and not self.normalizer.is_initialized:
                raise RuntimeError(
                    "No TRAIN samples and stateful normalizer %r has no "
                    "state; provide normalizer.state or use a stateless "
                    "normalization_type" % self.normalization_type)
            if isinstance(self.normalizer,
                          normalization.StatelessNormalizer):
                self.normalizer.analyze(np.zeros((1, 1), dtype=np.float32))
            self._build_label_mapping()
            return
        if isinstance(self.normalizer, normalization.StatelessNormalizer):
            self.normalizer.analyze(np.zeros((1, 1), dtype=np.float32))
            if self.has_labels and not self.labels_mapping:
                self._scan_train_labels()
            return
        labels: Dict[Any, int] = defaultdict(int)

        def callback(size):
            self.normalizer.analyze(self.minibatch_data.map_read()[:size])
            if self.has_labels:
                for lbl in self.raw_minibatch_labels[:size]:
                    labels[lbl] += 1

        self._iterate_train(callback)
        self._build_label_mapping(labels)

    def _iterate_train(self, callback) -> None:
        """Walk the TRAIN class minibatch by minibatch on the host
        (reference: veles/loader/base.py:911-924 _iterate_class)."""
        if not self.shuffled_indices:
            self.shuffled_indices.reset(
                np.arange(self.total_samples, dtype=INDEX_DTYPE))
        start = self.class_end_offsets[VALID]
        stop = min(self.class_end_offsets[TRAIN],
                   self.effective_total_samples)
        mbs = self.max_minibatch_size
        for begin in range(start, stop, mbs):
            size = min(mbs, stop - begin)
            self.minibatch_size = size
            self.minibatch_indices.map_write()[:size] = \
                self.shuffled_indices[begin:begin + size]
            self.fill_minibatch()
            callback(size)

    def _scan_train_labels(self) -> None:
        labels: Dict[Any, int] = defaultdict(int)

        def callback(size):
            for lbl in self.raw_minibatch_labels[:size]:
                labels[lbl] += 1

        self._iterate_train(callback)
        self._build_label_mapping(labels)

    def _build_label_mapping(self, train_labels=None) -> None:
        if self.has_labels and not self.labels_mapping:
            if train_labels:
                keys = sorted(train_labels)
                self.labels_mapping = {k: i for i, k in enumerate(keys)}

    def map_minibatch_labels(self) -> None:
        """raw labels -> int labels; unknown labels are an error, as in
        the reference (base.py:807-819 raised on unmapped labels)."""
        if not self.has_labels:
            return
        mem = self.minibatch_labels.map_invalidate()
        for i, lbl in enumerate(
                self.raw_minibatch_labels[:self.minibatch_size]):
            if self.labels_mapping:
                try:
                    mem[i] = self.labels_mapping[lbl]
                except KeyError:
                    raise KeyError(
                        "Label %r (sample %d) is absent from the TRAIN "
                        "label mapping %s" %
                        (lbl, i, sorted(self.labels_mapping)))
            elif isinstance(lbl, (int, np.integer)):
                mem[i] = lbl
            else:
                raise ValueError(
                    "Non-integer label %r but no labels_mapping was "
                    "built; set labels_mapping in load_data()" % (lbl,))

    # -- shuffling ---------------------------------------------------------
    def shuffle(self) -> bool:
        """Shuffle the TRAIN slice with the keyed stream
        (reference: veles/loader/base.py:711-724). Returns True when
        the index array changed (created or reshuffled) so caching
        subclasses can invalidate device copies without re-deriving
        this method's guard."""
        changed = False
        if not self.shuffled_indices:
            self.shuffled_indices.reset(
                np.arange(self.total_samples, dtype=INDEX_DTYPE))
            changed = True
        if self.shuffle_limit <= 0 or self.class_lengths[TRAIN] == 0:
            return changed
        self.shuffle_limit -= 1
        mem = self.shuffled_indices.map_write()
        self.rand.shuffle(mem[self.class_end_offsets[VALID]:])
        return True

    # -- serving -----------------------------------------------------------
    def run(self) -> None:
        self.pending_minibatches_.pop(None, None)
        self.serve_next_minibatch(None)
        self._on_successful_serve()

    def serve_next_minibatch(self, slave_id) -> None:
        """(reference: veles/loader/base.py:726-754)"""
        if self.failed_minibatches:
            minibatch_def = self.failed_minibatches.pop()
        else:
            minibatch_def = self._advance_global_offset()
        offset, size = minibatch_def
        self.pending_minibatches_[slave_id].append(minibatch_def)
        self.minibatch_offset, self.minibatch_size = offset, size
        self._update_flags()

        if self.fill_indices(offset - size, size):
            return  # device-side gather did everything
        if self.is_master:
            return  # coordinator ships indices only
        self.fill_minibatch()
        self.normalize_minibatch()
        self.map_minibatch_labels()
        if size < self.max_minibatch_size:
            self.minibatch_data.map_write()[size:] = 0
            if self.has_labels:
                self.minibatch_labels.map_write()[size:] = -1
            self.minibatch_indices.map_write()[size:] = -1

    def fill_indices(self, start: int, size: int) -> bool:
        """Copy shuffled indices for [start, start+size) into
        minibatch_indices. Return True if an accelerated path did the
        whole serve (reference: fullbatch device gather)."""
        self.minibatch_indices.map_write()[:size] = \
            self.shuffled_indices[start:start + size]
        return False

    def normalize_minibatch(self) -> None:
        self.normalizer.normalize(
            self.minibatch_data.map_write()[:self.minibatch_size])

    @property
    def class_ended(self) -> bool:
        offset = self.global_offset
        for end in self.class_end_offsets:
            if offset == end or offset == min(
                    end, self.effective_total_samples):
                return True
            if offset < end:
                return False
        return True

    def _update_flags(self) -> None:
        """(reference: veles/loader/base.py:862-878)"""
        if self.is_slave:
            return  # set explicitly in apply_data_from_master
        last_mb = (self.class_ended and
                   (not self.is_master or
                    not sum(map(len, self.pending_minibatches_.values())))
                   and not self.failed_minibatches)
        self.last_minibatch <<= last_mb
        klass = self.minibatch_class
        self.epoch_ended <<= last_mb and (
            klass == VALID or
            (klass == TEST and self.class_lengths[TRAIN] ==
             self.class_lengths[VALID] == 0) or
            (klass == TRAIN and self.class_lengths[VALID] == 0))

    def _advance_global_offset(self) -> Tuple[int, int]:
        """(reference: veles/loader/base.py:880-898)"""
        if self.is_slave:
            return self.minibatch_offset, self.minibatch_size
        if self.global_offset >= self.effective_total_samples:
            self.global_offset = 0
            self.epoch_number += 1
            self.shuffle()
        self.minibatch_class, remainder = self.class_index_by_sample_index(
            self.global_offset)
        size = min(remainder, self.max_minibatch_size)
        self.global_offset += size
        self.train_ended <<= \
            self.global_offset >= self.effective_total_samples
        self.test_ended <<= self.global_offset >= self.class_end_offsets[TEST]
        return self.global_offset, size

    def _on_successful_serve(self) -> None:
        self.samples_served += self.minibatch_size
        self.minibatches_served += 1
        now = time.time()
        if now - self._serve_timestamp_ >= 10:
            self._serve_timestamp_ = now
            self.info("served %d samples (epoch %d); failed %d pending %d",
                      self.samples_served, self.epoch_number,
                      len(self.failed_minibatches),
                      sum(map(len, self.pending_minibatches_.values())))

    # -- distributed index-slice scheduling --------------------------------
    # (reference: veles/loader/base.py:631-687)
    def generate_data_for_master(self):
        """Ship the served-minibatch geometry so the coordinator's
        Decision sees which class/size the update belongs to."""
        return {"minibatch_class": self.minibatch_class,
                "minibatch_size": self.minibatch_size,
                "minibatch_offset": self.minibatch_offset}

    def generate_data_for_slave(self, slave=None):
        self.serve_next_minibatch(slave)
        data = {
            "indices": np.array(
                self.minibatch_indices.map_read()[:self.minibatch_size]),
            "minibatch_class": self.minibatch_class,
            "minibatch_size": self.minibatch_size,
            "minibatch_offset": self.minibatch_offset,
            "epoch_number": self.epoch_number,
        }
        self.has_data_for_slave = (not self.class_ended or
                                   bool(self.failed_minibatches))
        return data

    def apply_data_from_master(self, data) -> None:
        for attr in ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number"):
            setattr(self, attr, data[attr])
        self.last_minibatch <<= False
        self.epoch_ended <<= False
        self.train_ended <<= False
        indices = data["indices"]
        if indices.size != self.minibatch_size:
            raise ValueError("minibatch size mismatch in job data")
        if not self.shuffled_indices:
            self.shuffled_indices.reset(
                np.arange(self.total_samples, dtype=INDEX_DTYPE))
        if self.minibatch_offset > len(self.shuffled_indices):
            raise ValueError("job minibatch offset %d overflows dataset "
                             "of %d" % (self.minibatch_offset,
                                        len(self.shuffled_indices)))
        start = self.minibatch_offset - self.minibatch_size
        if start < 0:
            raise ValueError(
                "job minibatch offset %d < size %d" %
                (self.minibatch_offset, self.minibatch_size))
        self.shuffled_indices.map_write()[
            start:self.minibatch_offset] = indices

    def apply_data_from_slave(self, data, slave=None) -> None:
        if slave is None:
            return
        pending = self.pending_minibatches_.get(slave)
        if not pending:
            raise RuntimeError(
                "no pending minibatch recorded for worker %r" % (slave,))
        # FIFO: with a pipelined coordinator a worker holds several
        # minibatches at once, and its updates arrive in issue order
        # (per-connection ordering) — popping LIFO would attribute
        # update N to minibatch N+1's geometry. Identical to the old
        # .pop() when at most one job is in flight.
        self.minibatch_offset, self.minibatch_size = pending.pop(0)
        if isinstance(data, dict):
            self.minibatch_class = data["minibatch_class"]
        self._update_flags()
        self._on_successful_serve()
        if not self.has_data_for_slave:
            self.has_data_for_slave = bool(self.last_minibatch)

    def retract_data_for_slave(self, slave=None) -> None:
        """Take back the minibatch recorded by an aborted generation
        call (a later unit raised NoMoreJobs after this loader already
        served): requeue ONLY the newest pending entry — the slave's
        older entries belong to jobs genuinely in flight."""
        pending = self.pending_minibatches_.get(slave)
        if pending:
            self.failed_minibatches.append(pending.pop())
            if not pending:
                del self.pending_minibatches_[slave]
            self.has_data_for_slave = True

    def requeue_one_for_slave(self, slave=None) -> None:
        """Relay retract: a downstream worker behind a relay died, so
        ONE of the relay's in-flight jobs comes back. Requeue the
        OLDEST pending entry — the same FIFO discipline the apply
        path attributes by — so count-level exactness survives
        out-of-order resolution (identity attribution is approximate
        once a relay multiplexes workers; every pending index is
        still re-served exactly once)."""
        pending = self.pending_minibatches_.get(slave)
        if pending:
            self.failed_minibatches.append(pending.pop(0))
            if not pending:
                del self.pending_minibatches_[slave]
            self.has_data_for_slave = True

    def drop_slave(self, slave=None) -> None:
        if slave in self.pending_minibatches_:
            self.failed_minibatches.extend(self.pending_minibatches_[slave])
            del self.pending_minibatches_[slave]
            self.has_data_for_slave = True
            self.warning("worker %r dropped; %d minibatches requeued",
                         slave, len(self.failed_minibatches))

    # -- results -----------------------------------------------------------
    def get_metric_names(self):
        return {"Total epochs"}

    def get_metric_values(self):
        return {"Total epochs": self.epoch_number}
