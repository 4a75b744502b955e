"""One metrics registry, one renderer (port of
``veles_tpu/obs/metrics.py``: the serving slice's converters, the
instruments and the farm's wire form).

A :class:`Sample` is ``(metric, kind, series, labels, value)``;
``render`` is the one Prometheus text renderer, grouping samples by
metric so each family's lines stay contiguous. The process-wide
:data:`REGISTRY` holds named collectors (the tracer's health and the
device-memory reading) that every ``/metrics`` exposition appends.
The JSON snapshot keys of the engine and batcher are the contract;
the text is derived from them (:func:`serve_samples`,
:func:`gen_samples`, :func:`sched_samples`). The farm adds direct
instruments (``counter``/``gauge``/``summary``), absorbs its workers'
registries through their wire form (``as_wire``/``absorb``), and
renders its wire and checkpoint stats (:func:`wire_samples`,
:func:`checkpoint_samples`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

Labels = Tuple[Tuple[str, str], ...]


class Sample:
    """One exposition point."""

    __slots__ = ("metric", "kind", "series", "labels", "value")

    def __init__(self, metric: str, kind: str, value: float,
                 labels: Labels = (),
                 series: Optional[str] = None) -> None:
        self.metric = metric
        self.kind = kind          # counter | gauge | summary | histogram
        self.series = series if series is not None else metric
        self.labels = tuple(labels)
        self.value = value

    def as_wire(self) -> List[Any]:
        return [self.metric, self.kind, self.series,
                [list(kv) for kv in self.labels], self.value]

    @staticmethod
    def from_wire(doc: Any) -> Optional["Sample"]:
        try:
            metric, kind, series, labels, value = doc
            return Sample(str(metric), str(kind), float(value),
                          tuple((str(k), str(v)) for k, v in labels),
                          series=str(series))
        except (TypeError, ValueError):
            return None

    def __repr__(self) -> str:
        return "<Sample %s%r %g>" % (self.series, self.labels,
                                     self.value)


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(labels: Labels) -> str:
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (key, _escape_label(value))
        for key, value in labels)


def _format_value(value: float) -> str:
    """Integral values render exactly (``%g`` would round counters
    past 6 significant digits); everything else as ``%g``."""
    if isinstance(value, bool):
        return "%d" % value
    if isinstance(value, int) or (isinstance(value, float) and
                                  value.is_integer() and
                                  abs(value) < 2 ** 53):
        return "%d" % value
    return "%g" % value


def render(samples: Iterable[Sample]) -> str:
    """THE Prometheus text renderer: samples grouped by metric
    (first-appearance order), one ``# TYPE`` line per metric."""
    groups: Dict[str, List[Sample]] = {}
    kinds: Dict[str, str] = {}
    for sample in samples:
        groups.setdefault(sample.metric, []).append(sample)
        kinds.setdefault(sample.metric, sample.kind)
    lines: List[str] = []
    for metric, group in groups.items():
        lines.append("# TYPE %s %s" % (metric, kinds[metric]))
        for sample in group:
            lines.append("%s%s %s" % (sample.series,
                                      _label_str(sample.labels),
                                      _format_value(sample.value)))
    return "\n".join(lines) + ("\n" if lines else "")


class _Instrument:
    """Direct counter/gauge: one value per label set."""

    __slots__ = ("name", "kind", "_lock", "_values")

    def __init__(self, name: str, kind: str) -> None:
        self.name = name
        self.kind = kind
        self._lock = threading.Lock()
        self._values: Dict[Labels, float] = {}

    def _key(self, labels: Dict[str, Any]) -> Labels:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def get(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> List[Sample]:
        with self._lock:
            items = list(self._values.items())
        return [Sample(self.name, self.kind, value, labels)
                for labels, value in items]


class _Summary:
    """Bounded-reservoir quantile summary (the platform's existing
    p50/p95/p99 idiom, now behind the shared model)."""

    __slots__ = ("name", "_lock", "_window", "_values", "quantiles")

    def __init__(self, name: str, window: int = 2048,
                 quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
                 ) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._window = window
        self._values: Dict[Labels, Any] = {}
        self.quantiles = quantiles

    def observe(self, value: float, **labels: Any) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            reservoir = self._values.get(key)
            if reservoir is None:
                from collections import deque
                reservoir = self._values[key] = deque(
                    maxlen=self._window)
            reservoir.append(float(value))

    def collect(self) -> List[Sample]:
        import numpy as np
        with self._lock:
            items = [(labels, list(r))
                     for labels, r in self._values.items()]
        out = []
        for labels, values in items:
            if not values:
                continue
            pts = np.percentile(np.asarray(values),
                                [q * 100 for q in self.quantiles])
            for q, v in zip(self.quantiles, pts):
                out.append(Sample(
                    self.name, "summary", float(v),
                    labels + (("quantile", "%g" % q),)))
        return out


class MetricsRegistry:
    """Named collectors + direct instruments + absorbed peers ->
    one sample stream, one JSON snapshot, one Prometheus text."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collectors: Dict[str, Callable[[], Iterable[Sample]]] = {}
        self._instruments: Dict[str, Any] = {}
        self._absorbed: Dict[str, Tuple[Labels, List[Sample]]] = {}

    # -- sources -----------------------------------------------------------
    def register(self, name: str,
                 collector: Callable[[], Iterable[Sample]]) -> None:
        """Add/replace a named collector (``collector()`` -> samples).
        Replacement semantics keep a re-created component (new server,
        new coordinator) from double-reporting."""
        with self._lock:
            self._collectors[name] = collector

    def unregister(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def _instrument(self, name: str, kind: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _Instrument(name, kind)
            elif inst.kind != kind:
                raise ValueError("metric %r is a %s, not a %s"
                                 % (name, inst.kind, kind))
            return inst

    def counter(self, name: str) -> _Instrument:
        return self._instrument(name, "counter")

    def gauge(self, name: str) -> _Instrument:
        return self._instrument(name, "gauge")

    def summary(self, name: str, window: int = 2048) -> _Summary:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _Summary(name, window)
            elif not isinstance(inst, _Summary):
                raise ValueError("metric %r is not a summary" % name)
            return inst

    # -- farm-wide aggregation ---------------------------------------------
    def absorb(self, peer: str, wire: Any,
               labels: Optional[Dict[str, Any]] = None) -> int:
        """Store a peer registry document (``as_wire()`` output) under
        ``peer``; its samples join :meth:`samples` with ``labels``
        appended (e.g. ``worker="w0001"``). Replacement per peer — a
        worker's next document supersedes its last."""
        extra: Labels = tuple(sorted(
            (k, str(v)) for k, v in (labels or {}).items()))
        samples = []
        if isinstance(wire, (list, tuple)):
            for doc in wire:
                sample = Sample.from_wire(doc)
                if sample is not None:
                    samples.append(Sample(
                        sample.metric, sample.kind, sample.value,
                        sample.labels + extra, series=sample.series))
        with self._lock:
            self._absorbed[peer] = (extra, samples)
        return len(samples)

    def forget(self, peer: str, subtree: bool = False) -> None:
        """Drop a departed peer's absorbed samples. ``subtree=True``
        also drops every ``"<peer>/..."`` key — a relay's downstream
        workers were absorbed under relay-scoped names, and they
        depart with it."""
        with self._lock:
            self._absorbed.pop(peer, None)
            if subtree:
                prefix = peer + "/"
                for key in [k for k in self._absorbed
                            if k.startswith(prefix)]:
                    del self._absorbed[key]

    # -- reading -----------------------------------------------------------
    def samples(self) -> List[Sample]:
        with self._lock:
            collectors = list(self._collectors.values())
            instruments = list(self._instruments.values())
            absorbed = [s for _, ss in self._absorbed.values()
                        for s in ss]
        out: List[Sample] = []
        for instrument in instruments:
            out.extend(instrument.collect())
        for collector in collectors:
            try:
                out.extend(collector())
            except Exception:  # noqa: BLE001 — one sick source must
                # not take down the whole exposition
                continue
        out.extend(absorbed)
        return out

    def as_wire(self) -> List[List[Any]]:
        return [s.as_wire() for s in self.samples()]

    def snapshot(self) -> Dict[str, Any]:
        """JSON surface: {series: {label-string: value}} (flat label
        string keys keep the document greppable and diffable)."""
        doc: Dict[str, Any] = {}
        for sample in self.samples():
            series = doc.setdefault(sample.series, {})
            series[_label_str(sample.labels) or "_"] = sample.value
        return doc

    def prometheus_text(self) -> str:
        return render(self.samples())


#: process-default registry — the "ONE complete /metrics" source
REGISTRY = MetricsRegistry()


def serve_samples(model: str, snap: Dict[str, Any]) -> List[Sample]:
    """``ServeMetrics.snapshot()`` → the ``veles_serve_*`` series
    (the reference's names and label scheme)."""
    label: Labels = (("model", model),)
    out = [
        Sample("veles_serve_qps", "gauge", snap["qps"], label),
        Sample("veles_serve_queue_depth", "gauge",
               snap["queue_depth"], label),
        Sample("veles_serve_requests_total", "counter",
               snap["requests_total"], label),
        Sample("veles_serve_rejected_total", "counter",
               snap["rejected_total"], label),
        Sample("veles_serve_shed_total", "counter",
               snap["shed_total"], label),
        Sample("veles_serve_expired_total", "counter",
               snap["expired_total"], label),
        Sample("veles_serve_poisoned_total", "counter",
               snap["poisoned_total"], label),
        Sample("veles_serve_errors_total", "counter",
               snap["errors_total"], label),
    ]
    for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        out.append(Sample("veles_serve_latency_ms", "summary",
                          snap["latency_ms"][key],
                          label + (("quantile", q),)))
    cumulative = 0
    hist = snap.get("batch_size_histogram") or {}
    for bound in sorted(hist, key=int):
        cumulative += int(hist[bound])
        out.append(Sample(
            "veles_serve_batch_size", "histogram", cumulative,
            label + (("le", bound),),
            series="veles_serve_batch_size_bucket"))
    cumulative += int(snap.get("batch_size_overflow", 0))
    out.append(Sample("veles_serve_batch_size", "histogram",
                      cumulative, label + (("le", "+Inf"),),
                      series="veles_serve_batch_size_bucket"))
    out.append(Sample("veles_serve_batch_size", "histogram",
                      cumulative, label,
                      series="veles_serve_batch_size_count"))
    return out


def gen_samples(model: str, snap: Dict[str, Any]) -> List[Sample]:
    """``GenMetrics.snapshot()`` -> the ``veles_gen_*`` series."""
    label: Labels = (("model", model),)
    out = [
        Sample("veles_gen_tokens_per_sec", "gauge",
               snap["tokens_per_sec"], label),
        Sample("veles_gen_queue_depth", "gauge",
               snap["queue_depth"], label),
        Sample("veles_gen_requests_total", "counter",
               snap["requests_total"], label),
        Sample("veles_gen_tokens_total", "counter",
               snap["tokens_total"], label),
        Sample("veles_gen_rejected_total", "counter",
               snap["rejected_total"], label),
        Sample("veles_gen_expired_total", "counter",
               snap["expired_total"], label),
        Sample("veles_gen_nonfinite_total", "counter",
               snap["nonfinite_total"], label),
    ]
    for q, key in (("0.5", "p50"), ("0.99", "p99")):
        out.append(Sample("veles_gen_decode_ms", "summary",
                          snap["decode_ms"][key],
                          label + (("quantile", q),)))
    for gauge in ("active_sequences", "slot_occupancy",
                  "compile_count",
                  # paged decode plane (PagedGenerativeEngine): the
                  # page-pool economy + speculative acceptance
                  "pages_total", "pages_free", "pages_shared",
                  "token_occupancy", "oversubscription",
                  "spec_accept_rate"):
        if gauge in snap:
            out.append(Sample("veles_gen_%s" % gauge, "gauge",
                              snap[gauge], label))
    for counter in ("cow_total", "preempted_total",
                    "spec_proposed_total", "spec_accepted_total"):
        if counter in snap:
            out.append(Sample("veles_gen_%s" % counter, "counter",
                              snap[counter], label))
    return out


def sched_samples(snap: Dict[str, Any]) -> List[Sample]:
    """``Scheduler.snapshot()`` -> the ``veles_sched_*`` series."""
    out: List[Sample] = []
    tenants = snap.get("tenants") or {}
    for metric, kind, key in (
            ("quanta_total", "counter", "quanta"),
            ("device_ms_total", "counter", "device_ms"),
            ("share", "gauge", "share"),
            ("weight", "gauge", "weight"),
            ("preemptions_total", "counter", "preemptions")):
        for name, t in tenants.items():
            out.append(Sample("veles_sched_%s" % metric, kind,
                              t[key], (("tenant", name),)))
    for name, t in tenants.items():
        for q, key in (("0.5", "p50"), ("0.99", "p99")):
            out.append(Sample(
                "veles_sched_queue_wait_ms", "summary",
                t["queue_wait_ms"][key],
                (("tenant", name), ("quantile", q))))
    return out


def wire_samples(stats: Dict[str, Any],
                 labels: Labels = ()) -> List[Sample]:
    """``WireStats.as_dict()`` / ``Coordinator.wire_stats()`` -> the
    ``veles_wire_*`` series."""
    kinds = {"compression_ratio": "gauge"}
    out = []
    for key, value in sorted(stats.items()):
        if not isinstance(value, (int, float)):
            continue
        out.append(Sample("veles_wire_%s" % key,
                          kinds.get(key, "counter"), value, labels))
    return out


def checkpoint_samples(stats: Optional[Dict[str, Any]],
                       labels: Labels = ()) -> List[Sample]:
    """``checkpoint_stats()`` -> the ``veles_ckpt_*`` series."""
    if not stats:
        return []
    out = []
    for key, value in sorted(stats.items()):
        if isinstance(value, bool) or not isinstance(value,
                                                     (int, float)):
            continue
        out.append(Sample("veles_ckpt_%s" % key, "gauge", value,
                          labels))
    return out


def trace_samples() -> List[Sample]:
    """The tracer's own health -> ``veles_trace_*``."""
    from veles_tpu_torch.obs.trace import EXEMPLARS, TRACER
    stats = TRACER.stats()
    return [
        Sample("veles_trace_spans_recorded_total", "counter",
               stats["recorded"]),
        Sample("veles_trace_spans_dropped_total", "counter",
               stats["dropped"]),
        Sample("veles_trace_buffered", "gauge", stats["buffered"]),
        Sample("veles_trace_enabled", "gauge",
               1 if stats["enabled"] else 0),
        Sample("veles_trace_requests_total", "counter",
               EXEMPLARS.requests),
    ]


def hbm_runtime_stats() -> Dict[str, int]:
    """Device-memory reading of the current CUDA device from PyTorch's
    caching allocator (``torch.cuda.memory_stats``): bytes held by live
    tensors, their peak, bytes the allocator reserved, and the card's
    total memory as ``bytes_limit``. Empty without a CUDA device —
    callers treat "no reading" as a real state."""
    import torch
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    device = torch.cuda.current_device()
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(
            torch.cuda.get_device_properties(device).total_memory),
    }


_MEMPLAN_CACHE: Optional[Dict[str, Any]] = None


def _memplan_doc() -> Dict[str, Any]:
    """This torch release's committed golden footprints (the static
    per-computation plans of ``analysis/memplan.py``), cached after the
    first read; empty when the file or the release's set is missing."""
    global _MEMPLAN_CACHE
    if _MEMPLAN_CACHE is None:
        try:
            from veles_tpu_torch.analysis.memplan import (
                default_baseline_path, load_footprint_baseline)
            _MEMPLAN_CACHE = load_footprint_baseline(
                default_baseline_path())[0]
        except (OSError, ValueError):
            _MEMPLAN_CACHE = {}
    return _MEMPLAN_CACHE


def hbm_samples() -> List[Sample]:
    """The device-memory reading next to the static memory plan ->
    ``veles_hbm_*`` gauges: the allocator's bytes, and per registry
    computation ``veles_hbm_plan_{peak,resident,donated}_mb``, so a
    drift between plan and reality is one exposition."""
    out = [Sample("veles_hbm_%s" % key, "gauge", value)
           for key, value in sorted(hbm_runtime_stats().items())]
    for name, plan in sorted(_memplan_doc().items()):
        label: Labels = (("computation", name),)
        for field in ("peak_mb", "resident_mb", "donated_mb"):
            if field in plan:
                out.append(Sample("veles_hbm_plan_%s" % field, "gauge",
                                  plan[field], label))
    return out


def kernel_samples() -> List[Sample]:
    """The kernel wrappers' launch counters (replays included) ->
    ``veles_kernel_launches_total{kernel=...}``: how a process's
    ``/metrics`` shows which hand-written kernels its paths ran."""
    from veles_tpu_torch.ops import flash_attention, lrn, rng
    return [Sample("veles_kernel_launches_total", "counter", float(n),
                   (("kernel", name),))
            for mod in (flash_attention, lrn, rng)
            for name, n in sorted(mod.LAUNCHES.items())]


REGISTRY.register("trace", trace_samples)
REGISTRY.register("hbm", hbm_samples)
REGISTRY.register("kernels", kernel_samples)
