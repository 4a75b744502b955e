"""One metrics registry, one renderer (port of
``veles_tpu/obs/metrics.py``, trimmed to the serving slice).

A :class:`Sample` is ``(metric, kind, series, labels, value)``;
``render`` is the one Prometheus text renderer, grouping samples by
metric so each family's lines stay contiguous. The process-wide
:data:`REGISTRY` holds named collectors (the tracer's health and the
device-memory reading) that every ``/metrics`` exposition appends.
The JSON snapshot keys of the engine and batcher are the contract;
the text is derived from them (:func:`serve_samples`,
:func:`gen_samples`).
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


class MetricsRegistry:
    """Named collectors -> one sample stream, one JSON snapshot, one
    Prometheus text."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collectors: Dict[str, Callable[[], Iterable[Sample]]] = {}

    def register(self, name: str,
                 collector: Callable[[], Iterable[Sample]]) -> None:
        """Add/replace a named collector (``collector()`` -> samples)."""
        with self._lock:
            self._collectors[name] = collector

    def samples(self) -> List[Sample]:
        with self._lock:
            collectors = list(self._collectors.values())
        out: List[Sample] = []
        for collector in collectors:
            try:
                out.extend(collector())
            except Exception:  # noqa: BLE001 — one sick source must
                # not take down the whole exposition
                continue
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON surface: {series: {label-string: value}}."""
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


def hbm_samples() -> List[Sample]:
    """The device-memory reading -> ``veles_hbm_*`` gauges."""
    return [Sample("veles_hbm_%s" % key, "gauge", value)
            for key, value in sorted(hbm_runtime_stats().items())]


REGISTRY.register("trace", trace_samples)
REGISTRY.register("hbm", hbm_samples)
