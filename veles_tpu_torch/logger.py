"""Structured log correlation (port of the ``log_context`` part of
``veles_tpu/logger.py``).

``with log_context(model="lm", trace=ctx.trace_id):`` stores the ids
in a thread-local; once :func:`enable_log_context` installed the
filter, every log line emitted inside carries them as a grep-able
``[model=lm trace=3b33]`` suffix. Off by default: then the context is
one thread-local dict store and log lines are unchanged.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

#: thread-local correlation ids (model/trace/slot)
_log_ctx = threading.local()

#: installed filter (None = correlation off, the default)
_ctx_filter: Optional["_ContextFilter"] = None


class _ContextFilter(logging.Filter):
    """Appends the active correlation ids to every record's message,
    once per record."""

    def filter(self, record: logging.LogRecord) -> bool:
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
    """``with log_context(trace=..., model=...):`` — log lines emitted
    inside carry the ids (when correlation is enabled). None values
    are dropped; nesting merges and restores on exit."""

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
    """Turn log correlation on: install the context filter on the root
    logger and its handlers (idempotent)."""
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
    if _ctx_filter is None:
        return
    root = logging.getLogger()
    if _ctx_filter in root.filters:
        root.removeFilter(_ctx_filter)
    for handler in root.handlers:
        if _ctx_filter in handler.filters:
            handler.removeFilter(_ctx_filter)
