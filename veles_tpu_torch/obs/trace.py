"""Lightweight request and job tracing (port of
``veles_tpu/obs/trace.py``: the serving slice's spans plus the farm's
wire form, and the ``span`` scope and file export the fleet and the
command line use).

Spans are (name, category, ids, monotonic t0/t1) records in a bounded
ring buffer — two clock reads, a tuple and a deque append, cheap
enough to leave on. A :class:`TraceContext` is the propagated
identity: an HTTP request's ticket carries its trace id through the
batcher queue and the prefill/decode dispatch. Export is Chrome-trace
JSON (``GET /debug/trace``). The :class:`ExemplarTable` keeps the N
slowest requests with their queue-vs-device breakdown. A farm worker
ships its job's spans in the wire form of :func:`make_span` with its
update, and the coordinator stitches them in (:meth:`Tracer.ingest`).
"""

from __future__ import annotations

import itertools
import json
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

    def child(self, span_id: int) -> "TraceContext":
        return TraceContext(self.trace_id, span_id)

    # -- wire form (job frames) --------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        wire: Dict[str, Any] = {"t": self.trace_id}
        if self.parent_id is not None:
            wire["s"] = self.parent_id
        return wire

    @staticmethod
    def from_wire(wire: Any) -> Optional["TraceContext"]:
        """None on anything that is not a well-formed context: a peer's
        junk degrades to 'untraced', never raises."""
        if not isinstance(wire, dict):
            return None
        trace_id = wire.get("t")
        if not isinstance(trace_id, str) or not trace_id:
            return None
        parent = wire.get("s")
        return TraceContext(
            trace_id, parent if isinstance(parent, int) else None)

    def __repr__(self) -> str:
        return "<TraceContext %s/%s>" % (self.trace_id, self.parent_id)


class _SpanScope:
    """Context manager recording one span on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_ctx", "_args", "_t0",
                 "span_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 ctx: Optional[TraceContext], args: Dict) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._ctx = ctx
        self._args = args
        self._t0 = 0.0
        self.span_id: Optional[int] = None

    def __enter__(self) -> "_SpanScope":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.span_id = self._tracer.add(
            self._name, self._cat, self._ctx, self._t0,
            time.monotonic(), **self._args)
        return None


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

    def span(self, name: str, cat: str = "app",
             ctx: Optional[TraceContext] = None,
             **args: Any) -> _SpanScope:
        """``with TRACER.span("prefill", "serve", ctx):`` records on
        exit; ``scope.span_id`` is then valid for child contexts."""
        return _SpanScope(self, name, cat, ctx, args)

    def ingest(self, spans: Optional[List[Dict[str, Any]]]) -> int:
        """Absorb span dicts shipped by a peer (worker -> relay ->
        coordinator stitching), in the :meth:`spans` field names;
        malformed entries are skipped, never raised: a peer cannot
        poison the collector. Returns the spans taken."""
        if not spans or not self.enabled:
            return 0
        n = 0
        with self._lock:
            for span in spans:
                if not isinstance(span, dict):
                    continue
                trace_id = span.get("trace")
                t0, t1 = span.get("t0"), span.get("t1")
                if not isinstance(trace_id, str) or \
                        not isinstance(t0, (int, float)) or \
                        not isinstance(t1, (int, float)):
                    continue
                if len(self._spans) == self.capacity:
                    self.dropped += 1
                self._spans.append((
                    str(span.get("name", "?")),
                    str(span.get("cat", "app")), trace_id,
                    span.get("id") or next(_IDS), span.get("parent"),
                    float(t0), float(t1),
                    (span.get("pid", 0), span.get("tid", 0)),
                    span.get("args")))
                self.recorded += 1
                n += 1
        return n

    def spans(self, trace_id: Optional[str] = None
              ) -> List[Dict[str, Any]]:
        """Span dicts (the :meth:`ingest` schema), oldest first;
        optionally one trace."""
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

    def export_json(self, trace_id: Optional[str] = None) -> str:
        return json.dumps(self.export_chrome(trace_id))

    def write(self, path: str) -> int:
        """``--trace-out``: write the Chrome trace; returns the event
        count."""
        doc = self.export_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            buffered = len(self._spans)
        return {"enabled": self.enabled, "capacity": self.capacity,
                "buffered": buffered, "recorded": self.recorded,
                "dropped": self.dropped}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.recorded = 0


def make_span(name: str, cat: str, ctx: TraceContext, t0: float,
              t1: float, **args: Any) -> Dict[str, Any]:
    """A wire-form span dict (the :meth:`Tracer.ingest` schema): what a
    farm worker attaches to its update so the coordinator can stitch
    the job's timeline across processes."""
    span = {"name": name, "cat": cat, "trace": ctx.trace_id,
            "id": next(_IDS), "parent": ctx.parent_id,
            "t0": t0, "t1": t1, "pid": os.getpid(),
            "tid": threading.get_ident()}
    if args:
        span["args"] = args
    return span


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

    def clear(self) -> None:
        """Forget every row and the request count."""
        with self._lock:
            self._rows = []
            self.requests = 0


#: process-wide collector instances (VELES_TRACE=0 disables tracing)
TRACER = Tracer(enabled=os.environ.get("VELES_TRACE", "1") != "0")
EXEMPLARS = ExemplarTable()
