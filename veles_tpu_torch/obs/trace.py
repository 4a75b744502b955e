"""Lightweight request tracing (port of ``veles_tpu/obs/trace.py``,
trimmed to what the serving slice records).

Spans are (name, category, ids, monotonic t0/t1) records in a bounded
ring buffer — two clock reads, a tuple and a deque append, cheap
enough to leave on. A :class:`TraceContext` is the propagated
identity: an HTTP request's ticket carries its trace id through the
batcher queue and the prefill/decode dispatch. Export is Chrome-trace
JSON (``GET /debug/trace``). The :class:`ExemplarTable` keeps the N
slowest requests with their queue-vs-device breakdown.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: span id source; next() on a C-level iterator is atomic under the GIL
_IDS = itertools.count(1)

#: one microsecond, the Chrome-trace time unit
_US = 1e6


def elapsed_s(t0: float) -> float:
    """Seconds since ``t0`` (a prior ``time.monotonic()`` reading)."""
    return time.monotonic() - t0


def new_trace_id() -> str:
    return "%016x" % random.getrandbits(64)


class TraceContext:
    """The propagated identity of one request: a trace id plus the
    parent span id new spans attach under. Immutable."""

    __slots__ = ("trace_id", "parent_id")

    def __init__(self, trace_id: str,
                 parent_id: Optional[int] = None) -> None:
        self.trace_id = trace_id
        self.parent_id = parent_id

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(new_trace_id())

    def __repr__(self) -> str:
        return "<TraceContext %s/%s>" % (self.trace_id, self.parent_id)


class Tracer:
    """Bounded ring-buffer span collector.

    Each record is a plain tuple ``(name, cat, trace_id, span_id,
    parent_id, t0, t1, (pid, tid), args)``; the deque's ``maxlen`` is
    the memory bound — old spans fall off and ``dropped`` counts them."""

    def __init__(self, capacity: int = 16384,
                 enabled: bool = True) -> None:
        self.capacity = int(capacity)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self.recorded = 0

    def add(self, name: str, cat: str, ctx: Optional[TraceContext],
            t0: float, t1: float, **args: Any) -> Optional[int]:
        """Record one finished span; returns its id (None when tracing
        is off or the span carries no context to stitch by)."""
        if not self.enabled or ctx is None:
            return None
        span_id = next(_IDS)
        record = (name, cat, ctx.trace_id, span_id, ctx.parent_id,
                  t0, t1, (os.getpid(), threading.get_ident()),
                  args or None)
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(record)
            self.recorded += 1
        return span_id

    def spans(self, trace_id: Optional[str] = None
              ) -> List[Dict[str, Any]]:
        """Span dicts, oldest first; optionally one trace."""
        with self._lock:
            records = list(self._spans)
        out = []
        for (name, cat, tid_, span_id, parent, t0, t1, (pid, tid),
             args) in records:
            if trace_id is not None and tid_ != trace_id:
                continue
            span = {"name": name, "cat": cat, "trace": tid_,
                    "id": span_id, "parent": parent, "t0": t0,
                    "t1": t1, "pid": pid, "tid": tid}
            if args:
                span["args"] = args
            out.append(span)
        return out

    def export_chrome(self, trace_id: Optional[str] = None
                      ) -> Dict[str, Any]:
        """Chrome-trace JSON object (``traceEvents`` "X" complete
        events) for ``chrome://tracing`` or Perfetto."""
        events = []
        for span in self.spans(trace_id):
            ev_args = {"trace": span["trace"], "span": span["id"]}
            if span["parent"] is not None:
                ev_args["parent"] = span["parent"]
            ev_args.update(span.get("args") or {})
            events.append({
                "ph": "X", "name": span["name"], "cat": span["cat"],
                "ts": span["t0"] * _US,
                "dur": max(span["t1"] - span["t0"], 0.0) * _US,
                "pid": span["pid"], "tid": span["tid"], "args": ev_args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            buffered = len(self._spans)
        return {"enabled": self.enabled, "capacity": self.capacity,
                "buffered": buffered, "recorded": self.recorded,
                "dropped": self.dropped}


class ExemplarTable:
    """The N slowest requests with their latency breakdown (queue wait
    vs device time, in ms), recorded once per completed request."""

    def __init__(self, capacity: int = 16) -> None:
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._rows: List[Dict[str, Any]] = []
        self.requests = 0

    def record(self, name: str, trace_id: Optional[str],
               total_ms: float, **breakdown_ms: float) -> None:
        row = {"name": name, "trace": trace_id,
               "total_ms": round(total_ms, 3)}
        for key, value in breakdown_ms.items():
            row[key] = round(value, 3)
        with self._lock:
            self.requests += 1
            self._rows.append(row)
            if len(self._rows) > self.capacity:
                self._rows.sort(key=lambda r: -r["total_ms"])
                del self._rows[self.capacity:]

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return sorted(self._rows, key=lambda r: -r["total_ms"])


#: process-wide collector instances (VELES_TRACE=0 disables tracing)
TRACER = Tracer(enabled=os.environ.get("VELES_TRACE", "1") != "0")
EXEMPLARS = ExemplarTable()
