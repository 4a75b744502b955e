"""Class-scoped logging mixin, the event timeline and structured log
correlation.

Port of ``veles_tpu/logger.py``: :class:`Logger` gives each class its
own named logger and an event API (``event(name, etype, **info)``)
that records a structured timeline into :data:`timeline` (an in-memory
ring, plus a JSONL file when ``VELES_TPU_EVENT_LOG`` names one);
``with log_context(model="lm", trace=ctx.trace_id):`` stores ids in a
thread-local, and once :func:`enable_log_context` installed the filter,
every log line emitted inside carries them as a grep-able
``[model=lm trace=3b33]`` suffix. Off by default: then the context is
one thread-local dict store and log lines are unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional


class EventTimeline:
    """Structured event sink: in-memory ring buffer + optional JSONL file.

    Events are dicts with ``name``, ``etype`` ("begin"|"end"|"single"),
    ``time`` and arbitrary attributes (reference: veles/logger.py:264-289).
    """

    def __init__(self, maxlen: int = 65536) -> None:
        self._events: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._file = None
        path = os.environ.get("VELES_TPU_EVENT_LOG")
        if path:
            self._file = open(path, "a")

    def record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)
            if self._file is not None:
                json.dump(event, self._file)
                self._file.write("\n")
                self._file.flush()

    def snapshot(self):
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: Global timeline instance shared by all Logger users.
timeline = EventTimeline()


# ---------------------------------------------------------------------------
# structured log correlation (the obs plane's grep handle)
# ---------------------------------------------------------------------------

#: thread-local correlation ids (trace/ticket/job/wid); the batchers,
#: dispatch loops and farm workers set it around their work units
_log_ctx = threading.local()

#: installed filter (None = correlation OFF, the default: setting the
#: thread-local still happens but nothing reads it — zero cost)
_ctx_filter: Optional["_ContextFilter"] = None


class _ContextFilter(logging.Filter):
    """Appends the active correlation ids to every record's message,
    grep-ably: ``... [trace=3b33 job=17]``. Installed on the root
    logger by :func:`enable_log_context` only — off by default, log
    lines are byte-identical to before."""

    def filter(self, record: logging.LogRecord) -> bool:
        # idempotent per record: one record runs this filter once per
        # handler (and once more via the root logger) — mark it so
        # the suffix is appended exactly once
        if getattr(record, "_veles_ctx_done", False):
            return True
        fields = getattr(_log_ctx, "fields", None)
        if fields:
            suffix = " ".join("%s=%s" % kv for kv in fields.items())
            record.msg = "%s [%s]" % (record.getMessage(), suffix)
            record.args = ()
            record._veles_ctx_done = True
        return True


class log_context:
    """``with log_context(trace=ctx.trace_id, job=job_id):`` — log
    lines emitted inside carry the ids (when correlation is enabled;
    otherwise this is one thread-local dict store). None values are
    dropped; nesting merges and restores on exit."""

    __slots__ = ("_fields", "_saved")

    def __init__(self, **fields: Any) -> None:
        self._fields = {k: v for k, v in fields.items()
                        if v is not None}
        self._saved: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "log_context":
        self._saved = getattr(_log_ctx, "fields", None)
        merged = dict(self._saved) if self._saved else {}
        merged.update(self._fields)
        _log_ctx.fields = merged
        return self

    def __exit__(self, *exc) -> None:
        _log_ctx.fields = self._saved
        return None


def enable_log_context() -> None:
    """Turn log correlation ON: install the context filter on the
    root logger's handlers (idempotent)."""
    global _ctx_filter
    if _ctx_filter is None:
        _ctx_filter = _ContextFilter()
    root = logging.getLogger()
    if _ctx_filter not in root.filters:
        root.addFilter(_ctx_filter)
    for handler in root.handlers:
        if _ctx_filter not in handler.filters:
            handler.addFilter(_ctx_filter)


def disable_log_context() -> None:
    global _ctx_filter
    if _ctx_filter is None:
        return
    root = logging.getLogger()
    if _ctx_filter in root.filters:
        root.removeFilter(_ctx_filter)
    for handler in root.handlers:
        if _ctx_filter in handler.filters:
            handler.removeFilter(_ctx_filter)


class Logger:
    """Mixin granting ``self.logger`` plus debug/info/… helpers.

    Each class gets a logger named after it; levels can be set per class
    via :meth:`set_logging_level` (reference: veles/logger.py:59+).
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._logger_ = logging.getLogger(type(self).__name__)

    @property
    def logger(self) -> logging.Logger:
        if getattr(self, "_logger_", None) is None:
            self._logger_ = logging.getLogger(type(self).__name__)
        return self._logger_

    # convenience delegates
    def debug(self, msg: str, *args: Any) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self.logger.error(msg, *args)

    def exception(self, msg: str = "Exception", *args: Any) -> None:
        self.logger.exception(msg, *args)

    @staticmethod
    def set_logging_level(level: int, cls: Optional[str] = None) -> None:
        logging.getLogger(cls if cls else None).setLevel(level)

    # -- event timeline ----------------------------------------------------
    def event(self, name: str, etype: str, **info: Any) -> None:
        """Record a timeline event. etype in {"begin", "end", "single"}."""
        if etype not in ("begin", "end", "single"):
            raise ValueError("etype must be begin/end/single, got %r" % etype)
        ev = {"name": name, "etype": etype, "time": time.time(),
              "cls": type(self).__name__}
        ev.update(info)
        timeline.record(ev)

    class _EventScope:
        def __init__(self, owner: "Logger", name: str, info: Dict[str, Any]):
            self.owner, self.name, self.info = owner, name, info

        def __enter__(self):
            self.owner.event(self.name, "begin", **self.info)
            return self

        def __exit__(self, *exc):
            self.owner.event(self.name, "end", **self.info)
            return False

    def event_scope(self, name: str, **info: Any) -> "_EventScope":
        """Context manager recording begin/end event pairs."""
        return Logger._EventScope(self, name, info)


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%H:%M:%S")
