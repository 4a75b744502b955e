"""Named model registry with atomic hot-swap (port of
``veles_tpu/serve/registry.py``).

One serving process fronts several models: each registered name owns
an engine plus its batcher and metrics — a forward-plane
:class:`ServedModel` (``POST /apply``), a bare callable backend
(:class:`CallableModel`) or a decode-plane :class:`GenerativeModel`
(``POST /generate``). ``swap`` replaces a live model's engine between
batches.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from veles_tpu_torch.obs.trace import elapsed_s
from veles_tpu_torch.serve.batcher import (GenMetrics, MicroBatcher,
                                           ServeMetrics, TokenBatcher)




class ServedModel:
    """One registry entry: engine + batcher + metrics."""

    def __init__(self, name: str, engine, **batcher_kwargs: Any) -> None:
        self.name = name
        self.engine = engine
        self.batcher = MicroBatcher(engine, name=name, **batcher_kwargs)
        self.metrics = self.batcher.metrics

    def submit(self, batch: np.ndarray, timeout: float = 30.0,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive",
               ctx=None) -> np.ndarray:
        return self.batcher.submit(batch, timeout=timeout,
                                   deadline_ms=deadline_ms,
                                   priority=priority, ctx=ctx)

    @property
    def queue_depth(self) -> int:
        return self.batcher.queue_depth

    @property
    def stuck_for_s(self) -> float:
        """Dispatch-watchdog heartbeat (seconds the current device
        call has been out; 0 between calls)."""
        return self.batcher.stuck_for_s

    @property
    def drain_rate_rows_per_s(self) -> float:
        return self.batcher.drain_rate_rows_per_s

    def swap(self, engine) -> None:
        """Atomic engine replacement (between batches)."""
        old = self.engine
        self.batcher.swap_engine(engine)
        self.engine = engine
        return old

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot(self.queue_depth)
        compile_count = getattr(self.engine, "compile_count", None)
        if compile_count is not None:
            snap["compile_count"] = compile_count
            snap["buckets"] = getattr(self.engine, "buckets", [])
        snap["stuck_for_s"] = self.stuck_for_s
        return snap

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text(self.name, self.queue_depth)

    def metrics_samples(self):
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.serve_samples(
            self.name, self.metrics.snapshot(self.queue_depth))

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.batcher.stop(drain=drain, timeout=timeout)


class CallableModel:
    """A registry entry over a bare ``submit(batch, timeout)`` callable
    — no batcher of its own (the backend batches, or doesn't). Keeps
    the same metrics surface so /metrics covers the legacy path too."""

    def __init__(self, name: str,
                 submit_fn: Callable[..., np.ndarray],
                 metrics: Optional[ServeMetrics] = None) -> None:
        self.name = name
        self._submit = submit_fn
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.engine = None

    def submit(self, batch: np.ndarray, timeout: float = 30.0,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive",
               ctx=None) -> np.ndarray:
        # legacy backends know nothing of deadlines/classes/traces:
        # honor the deadline as a tighter timeout, ignore the rest
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1000.0)
        start = time.monotonic()
        out = self._submit(batch, timeout=timeout)
        self.metrics.observe_request(elapsed_s(start), len(batch))
        return out

    @property
    def queue_depth(self) -> int:
        return 0

    @property
    def stuck_for_s(self) -> float:
        return 0.0

    @property
    def drain_rate_rows_per_s(self) -> float:
        # no batcher, no EWMA — the completion-window qps is the best
        # available service-rate signal for a bare callable backend
        return self.metrics.qps()

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot(self.queue_depth)

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text(self.name, self.queue_depth)

    def metrics_samples(self):
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.serve_samples(
            self.name, self.metrics.snapshot(self.queue_depth))

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        pass


class GenerativeModel:
    """One registry entry for the decode plane: a
    :class:`~veles_tpu_torch.serve.engine.GenerativeEngine` behind a
    continuous :class:`TokenBatcher`. Serves ``POST /generate``."""

    def __init__(self, name: str, engine,
                 **batcher_kwargs: Any) -> None:
        self.name = name
        self.engine = engine
        self.batcher = TokenBatcher(engine, name=name,
                                    **batcher_kwargs)
        self.metrics: GenMetrics = self.batcher.metrics

    def generate(self, prompt, max_tokens: int = 16,
                 eos: Optional[int] = None, timeout: float = 60.0,
                 deadline_ms: Optional[float] = None,
                 ctx=None, temperature=None, top_k=None, top_p=None,
                 seed=None, draft: bool = False) -> np.ndarray:
        return self.batcher.submit(prompt, max_tokens=max_tokens,
                                   eos=eos, timeout=timeout,
                                   deadline_ms=deadline_ms, ctx=ctx,
                                   temperature=temperature,
                                   top_k=top_k, top_p=top_p,
                                   seed=seed, draft=draft)

    def stream(self, prompt, max_tokens: int = 16,
               eos: Optional[int] = None, timeout: float = 60.0,
               deadline_ms: Optional[float] = None, ctx=None,
               temperature=None, top_k=None, top_p=None, seed=None,
               draft: bool = False):
        """Token iterator for the chunked ``"stream": true`` form of
        ``POST /generate`` (admission errors raise eagerly)."""
        return self.batcher.stream(prompt, max_tokens=max_tokens,
                                   eos=eos, timeout=timeout,
                                   deadline_ms=deadline_ms, ctx=ctx,
                                   temperature=temperature,
                                   top_k=top_k, top_p=top_p,
                                   seed=seed, draft=draft)

    def swap(self, engine):
        """Hot-swap the engine: active sequences finish on the old one
        (their KV cache lives in its slab); new admissions land on the
        new one once it drains."""
        old = self.engine
        self.batcher.swap_engine(engine)
        self.engine = engine
        return old

    @property
    def queue_depth(self) -> int:
        return self.batcher.queue_depth

    @property
    def stuck_for_s(self) -> float:
        return self.batcher.stuck_for_s

    @property
    def drain_rate_rows_per_s(self) -> float:
        return self.batcher.drain_rate_rows_per_s

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot(self.queue_depth,
                                     engine=self.engine)
        snap["stuck_for_s"] = self.stuck_for_s
        return snap

    def prometheus_text(self) -> str:
        """This model's Prometheus exposition, rendered from
        :meth:`metrics_samples`."""
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.render(self.metrics_samples())

    def metrics_samples(self):
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.gen_samples(
            self.name,
            self.metrics.snapshot(self.queue_depth, engine=self.engine))

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.batcher.stop(drain=drain, timeout=timeout)


class ModelRegistry:
    """Name -> served model; first registration is the default."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._models: Dict[str, Any] = {}
        self._default: Optional[str] = None

    def add(self, name: str, engine, **batcher_kwargs: Any) -> ServedModel:
        """Register a forward engine under ``name`` with its own
        micro-batcher (the ``POST /apply`` plane)."""
        return self._register(name, ServedModel(name, engine,
                                                **batcher_kwargs))

    def add_callable(self, name: str, submit_fn: Callable[..., np.ndarray],
                     metrics: Optional[ServeMetrics] = None) -> \
            CallableModel:
        """Register a bare submit backend."""
        return self._register(name, CallableModel(name, submit_fn,
                                                  metrics))

    def add_generative(self, name: str, engine,
                       **batcher_kwargs: Any) -> GenerativeModel:
        """Register a GenerativeEngine under ``name`` with its own
        continuous token batcher (the ``POST /generate`` plane)."""
        return self._register(name, GenerativeModel(name, engine,
                                                    **batcher_kwargs))

    def _register(self, name: str, model):
        with self._lock:
            if name not in self._models:
                self._models[name] = model
                if self._default is None:
                    self._default = name
                return model
        model.stop(drain=False)
        raise ValueError("model %r already registered" % name)

    def get(self, name: Optional[str] = None):
        """The named model (default model when name is None/'')."""
        with self._lock:
            key = name or self._default
            if key is None or key not in self._models:
                raise KeyError(name or "<no models registered>")
            return self._models[key]

    def swap(self, name: str, engine) -> None:
        """Hot-swap the named model's engine; raises KeyError when the
        name is unknown and TypeError on a batcher-less entry."""
        model = self.get(name)
        if not hasattr(model, "swap"):
            raise TypeError("model %r has no swappable engine" % name)
        model.swap(engine)

    def remove(self, name: str, drain: bool = True) -> None:
        with self._lock:
            model = self._models.pop(name)
            if self._default == name:
                self._default = next(iter(self._models), None)
        model.stop(drain=drain)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._models)

    @property
    def default_name(self) -> Optional[str]:
        return self._default

    def queue_depth(self) -> int:
        return sum(self.get(name).queue_depth for name in self.names())

    def metrics_snapshot(self) -> Dict[str, Any]:
        return {name: self.get(name).metrics_snapshot()
                for name in self.names()}

    def prometheus_text(self) -> str:
        """ONE grouped exposition over every model (samples gathered,
        rendered once, so a metric family never splits)."""
        from veles_tpu_torch.obs import metrics as obs_metrics
        samples = []
        for name in self.names():
            samples.extend(self.get(name).metrics_samples())
        return obs_metrics.render(samples)

    def stuck_for_s(self) -> float:
        """The worst dispatch-watchdog heartbeat across models: the
        longest time any batcher's current device call has been out (0
        when every dispatch thread is between calls), as
        :meth:`admission_signals` reports it unrounded."""
        return max((self.get(name).stuck_for_s for name in self.names()),
                   default=0.0)

    def admission_signals(self) -> Dict[str, Any]:
        """Per-model queue depth / drain rate / watchdog heartbeat plus
        aggregates — what ``/healthz`` exports for a router."""
        per_model: Dict[str, Any] = {}
        depth_total, rate_total, worst_stuck = 0, 0.0, 0.0
        for name in self.names():
            model = self.get(name)
            depth = model.queue_depth
            rate = model.drain_rate_rows_per_s
            stuck = model.stuck_for_s
            per_model[name] = {
                "queue_depth": depth,
                "drain_rate_rows_per_s": round(rate, 3),
                "stuck_for_s": round(stuck, 3),
            }
            depth_total += depth
            rate_total += rate
            worst_stuck = max(worst_stuck, stuck)
        return {
            "queue_depth": depth_total,
            "drain_rate_rows_per_s": round(rate_total, 3),
            "stuck_for_s": round(worst_stuck, 3),
            "models": per_model,
        }

    def stop_all(self, drain: bool = True,
                 timeout: float = 30.0) -> None:
        for name in self.names():
            self.get(name).stop(drain=drain, timeout=timeout)
