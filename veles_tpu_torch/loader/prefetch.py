"""Prefetching input pipeline: the loader's serve path on a background
producer thread, feeding a depth-N ring of batches on the device.

Port of ``veles_tpu/loader/prefetch.py``:

- a producer thread drives ``loader.run()`` (epoch bookkeeping,
  shuffling, the gather or the host fill, normalization, label
  mapping), snapshots the served minibatch (data, labels, class, size,
  offset and the ``last_minibatch`` / ``epoch_ended`` / ``train_ended``
  flags), puts it on the device and enqueues it into a bounded ring of
  ``depth`` slots;
- the consumer takes batches in the loader's serve order (one
  producer, so the order is deterministic) and never touches the host
  path, so its steps overlap the production of the next batches;
- a producer exception poisons the ring and re-raises in the consumer
  on every later ``get()``;
- shutdown goes through :class:`veles_tpu_torch.thread_pool.\
ManagedThreads`: ``stop()`` wakes a producer blocked on a full ring and
  joins it.

Device work and streams. A loader that serves on the device
(``FullBatchLoader``'s gather) hands over fresh tensors each serve,
which are staged as they are; a host-served minibatch is copied out of
the loader's reused buffers, then placed (``place``, default: a pinned
copy sent with ``non_blocking=True`` to the loader's device).
``transform`` (e.g. a cast to the trainer's compute dtype, so the ring
holds half-width batches) runs on the producer thread after placement.
The producer enqueues its device work on the stream that was current
on the thread that called ``start()`` (:attr:`PrefetchingServer.stream`),
the consumer's: the producer's gathers and the consumer's steps are
ordered on one stream, so a batch is complete before a step reads it
and the caching allocator never hands a staged batch's memory to
another stream.
"""

from __future__ import annotations

import contextlib
import queue
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from veles_tpu_torch.device import resolve
from veles_tpu_torch.thread_pool import ManagedThreads


@dataclass
class PrefetchedBatch:
    """One served minibatch on the device, with the loader's
    bookkeeping taken at serve time."""

    data: Any                 # tensor [max_minibatch_size, ...]
    labels: Optional[Any]     # tensor [max_minibatch_size] or None
    size: int                 # valid rows (the tail is padding)
    minibatch_class: int      # TEST / VALID / TRAIN
    offset: int               # loader.minibatch_offset at serve
    epoch_number: int
    last_minibatch: bool
    epoch_ended: bool
    train_ended: bool
    serial: int               # 0-based serve sequence number


class _Poison:
    __slots__ = ("failure",)

    def __init__(self, failure: Optional[BaseException]) -> None:
        self.failure = failure


class PrefetchingServer:
    """Wraps any :class:`veles_tpu_torch.loader.base.Loader` with a
    background producer and a depth-N ring of staged batches.

    >>> server = PrefetchingServer(loader, depth=3)
    >>> with server:
    ...     for batch in server.batches(100):
    ...         trainer.step(batch.data, batch.labels)

    ``place(data, labels) -> (data, labels)`` puts a host-served
    minibatch (numpy) on the device (default: the loader's device, the
    CUDA card for a loader without one); a device-served minibatch is
    staged as it is. ``transform(data) -> data`` runs on the producer
    thread after placement.
    """

    def __init__(self, loader, depth: int = 2,
                 place: Optional[Callable] = None,
                 transform: Optional[Callable] = None,
                 name: str = "prefetch") -> None:
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1, got %d" % depth)
        self.loader = loader
        self.depth = depth
        self._place = place
        self._transform = transform
        self._ring: "queue.Queue" = queue.Queue(maxsize=depth)
        self._threads = ManagedThreads(name=name)
        self._failure: Optional[BaseException] = None
        self._serial = 0
        self._started = False
        #: the CUDA stream the producer enqueues on (the one current
        #: on the thread that called start()); None off the card
        self.stream = None

    # -- lifecycle ---------------------------------------------------------
    def _device(self) -> torch.device:
        device = getattr(self.loader, "device", None)
        return device.torch_device if device is not None else resolve(None)

    def start(self) -> "PrefetchingServer":
        if self._started:
            raise RuntimeError("PrefetchingServer already started")
        self._started = True
        device = self._device()
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
        self._threads.spawn(self._produce, name="producer")
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Interrupt and join the producer; idempotent. The ring is
        drained so that a producer blocked on ``put`` wakes at once
        (and once more after the join: the wake-up may land one last
        batch before the producer sees the stop)."""
        self._threads.request_stop()
        self._drain()
        leaked = self._threads.join_all(timeout=timeout)
        self._drain()
        if leaked:
            raise RuntimeError(
                "prefetch producer leaked threads: %s" %
                [t.name for t in leaked])

    def _drain(self) -> None:
        while True:
            try:
                self._ring.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "PrefetchingServer":
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()

    @property
    def stopped(self) -> bool:
        return self._threads.stop_requested

    # -- producer ----------------------------------------------------------
    def _produce(self) -> None:
        on_stream = torch.cuda.stream(self.stream) \
            if self.stream is not None else contextlib.nullcontext()
        try:
            with on_stream:
                while not self._threads.stop_requested:
                    self.loader.run()
                    batch = self._snapshot()
                    while not self._threads.stop_requested:
                        try:
                            self._ring.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._failure = e
            # poison without blocking: the consumer must see the
            # failure even when the ring is full of good batches
            try:
                self._ring.put_nowait(_Poison(e))
            except queue.Full:
                try:
                    self._ring.get_nowait()
                except queue.Empty:
                    pass
                try:
                    self._ring.put_nowait(_Poison(e))
                except queue.Full:
                    pass

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host copy on the loader's device: pinned and sent without
        blocking the stream (the caching host allocator keeps the
        pinned buffer until its copy is done)."""
        device = self._device()
        t = torch.from_numpy(arr)
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _put(self, data: np.ndarray, labels: Optional[np.ndarray]):
        """The default ``place``."""
        return self._to_device(data), (
            self._to_device(labels) if labels is not None else None)

    def _snapshot(self) -> PrefetchedBatch:
        ld = self.loader
        data_arr = ld.minibatch_data
        labels_arr = ld.minibatch_labels if ld.has_labels else None
        if data_arr._device_dirty_:
            # device-side serve (the full-batch gather): fresh tensors
            # each serve, staged as they are
            data = data_arr.devmem_
            if labels_arr is not None and labels_arr._device_dirty_:
                labels = labels_arr.devmem_
            elif labels_arr is not None:
                labels = self._to_device(np.array(labels_arr.map_read()))
            else:
                labels = None
        else:
            # host-side serve: COPY out of the loader's reused buffers
            # before the next run() overwrites them, then place
            data = np.array(data_arr.map_read())
            labels = np.array(labels_arr.map_read()) \
                if labels_arr is not None else None
            place = self._place if self._place is not None else self._put
            data, labels = place(data, labels)
        if self._transform is not None:
            data = self._transform(data)
        batch = PrefetchedBatch(
            data=data, labels=labels, size=int(ld.minibatch_size),
            minibatch_class=int(ld.minibatch_class),
            offset=int(ld.minibatch_offset),
            epoch_number=int(ld.epoch_number),
            last_minibatch=bool(ld.last_minibatch),
            epoch_ended=bool(ld.epoch_ended),
            train_ended=bool(ld.train_ended),
            serial=self._serial)
        self._serial += 1
        return batch

    # -- consumer ----------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> PrefetchedBatch:
        """Next minibatch in serve order; re-raises a producer failure.
        Raises ``queue.Empty`` on timeout and RuntimeError after
        stop()."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._threads.stop_requested:
                # a failure outranks the stop (stop() runs in teardown
                # paths after an error too)
                if self._failure is not None:
                    self._reraise()
                raise RuntimeError("PrefetchingServer is stopped")
            try:
                item = self._ring.get(timeout=0.1 if deadline is None else
                                      max(0.0, min(0.1, deadline -
                                                   time.monotonic())))
            except queue.Empty:
                if self._failure is not None:
                    self._reraise()
                if self._threads.stop_requested:
                    raise RuntimeError(
                        "PrefetchingServer is stopped") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                continue
            if isinstance(item, _Poison):
                self._reraise()
            return item

    def _reraise(self) -> None:
        # sticky: every get() after the producer died re-raises the
        # original exception, never a hang or a generic error
        if self._failure is None:
            raise RuntimeError("prefetch producer failed")
        raise self._failure

    def get_many(self, k: int,
                 timeout: Optional[float] = None) -> List[PrefetchedBatch]:
        """K consecutive minibatches (one multi-step dispatch's worth)."""
        return [self.get(timeout=timeout) for _ in range(k)]

    def batches(self, n: int, timeout: Optional[float] = None):
        """Yield the next ``n`` minibatches in serve order."""
        for _ in range(n):
            yield self.get(timeout=timeout)
