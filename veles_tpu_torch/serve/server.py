"""HTTP front of the port's serving plane (port of
``veles_tpu/serve/server.py``).

- ``POST /apply`` — forward a batch through the default forward-plane
  model (``ModelRegistry.add``); ``POST /apply/<name>`` targets one by
  name (``/apply`` is the default ``path``; a server built with
  ``path="/predict"`` answers ``/predict`` and ``/predict/<name>``). Body ``{"input": rows}`` (a non-empty ``[N, ...]`` batch in the
  engine's ``input_dtype``), optional ``"deadline_ms"`` (or
  ``X-Deadline-Ms``) and ``"priority"`` (or ``X-Priority``:
  ``interactive`` | ``batch``). A body of ``Content-Type:
  application/octet-stream`` is the batch's raw bytes instead (native
  byte order, the engine's ``input_dtype``), its shape in ``X-Shape:
  N,d1,...``, the options in the headers. -> ``{"output": rows}``. 400
  on a malformed body or a model that serves ``/generate``, 404 on an
  unknown model, 422 when this request's rows made the batch fail
  (bisection isolated them), and the admission, deadline and drain
  replies of ``/generate``.
- ``POST /generate`` — autoregressive generation against a generative
  registry entry; ``POST /generate/<name>`` targets one by name. Body
  ``{"prompt": [t0, t1, ...]}`` (one prompt) or ``{"prompt": [[...],
  [...]]}`` (several — each joins the continuous batch on its own),
  optional ``"max_tokens"`` (default 16) and ``"eos"``. ->
  ``{"tokens": [[...], ...]}``, the GENERATED tokens per prompt, EOS
  included when hit. 400 on malformed bodies or over-long prompts, 404
  on unknown models, 503 + ``Retry-After`` when admission control
  rejects or the server drains, 504 on timeout, 500 with a distinct
  ``non-finite logits`` error when only this sequence went non-finite.
  With ``"stream": true`` (one prompt) the reply is chunked ND-JSON:
  one ``{"token": t}`` record per token as it decodes, closed by
  ``{"done": true, "tokens": [...]}`` (an error after the stream
  started arrives as a final ``{"error"}`` record).
- ``GET /healthz`` — 200 ``{"status": "ok", ...admission signals}``
  while serving; 503 ``draining`` once a drain began, 503 ``stuck``
  while a device call has been out longer than ``watchdog_s``.
- ``GET /metrics`` — JSON per model (tokens, decode latency, compile
  count, slot gauges) plus ``_slowest`` exemplars and ``_obs``, and
  ``_scheduler`` (per-tenant accounting) when the server was given a
  ``scheduler``; ``?format=prometheus`` (or ``Accept: text/plain``)
  returns the one Prometheus exposition of the same numbers
  (``veles_sched_*`` for the scheduler).
- ``GET /debug/trace[?trace=ID]`` — Chrome-trace JSON of the span ring.
- ``POST /admin/swap`` — ``{"package": path[, "model": name]}``:
  hot-swap a model's engine from a package archive, the fleet's
  rollout channel into a replica process. Off unless ``admin_swap``
  (404). The new engine (``InferenceEngine.from_package_like``) is
  built on the served engine's device and warmed over its buckets
  before the swap; a package that fails to load or to warm answers
  500 and the served engine stays; a generative model answers 409.

The fleet's hooks: ``draining``, :meth:`ServeServer.blackhole` (accept,
answer nothing for a window) and :meth:`ServeServer.kill` (sever every
live connection, as a process death would).

Stop is a graceful drain by default: /healthz flips unhealthy, new
POSTs get 503, accepted work finishes, then the listener closes.
"""

from __future__ import annotations

import json
import math
import re
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.obs.trace import EXEMPLARS, TRACER, TraceContext
from veles_tpu_torch.serve.batcher import (DeadlineExceeded, Draining,
                                           NonFiniteLogits,
                                           PoisonedRequest, QueueFull,
                                           Shed)
from veles_tpu_torch.serve.registry import ModelRegistry
from veles_tpu_torch.thread_pool import ManagedThreads

#: client-supplied X-Trace-Id must be plain hex (it is stored and
#: exported; arbitrary bytes would be an injection vector)
_TRACE_ID_RE = re.compile(r"^[0-9a-fA-F]{1,64}$")

#: /generate fans each prompt out to a collector thread; this caps
#: the fan-out one request body can demand.
MAX_PROMPTS_PER_REQUEST = 64


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers its live client sockets, so a
    chaos :meth:`ServeServer.kill` can sever in-flight connections the
    way a process death would (peers see a reset mid-exchange, not a
    clean reply): the failure the fleet router's failover absorbs."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._client_lock = threading.Lock()
        self._client_socks: set = set()
        self.killed = False

    def get_request(self):
        sock, addr = super().get_request()
        with self._client_lock:
            self._client_socks.add(sock)
        return sock, addr

    def shutdown_request(self, request) -> None:
        with self._client_lock:
            self._client_socks.discard(request)
        super().shutdown_request(request)

    def sever_connections(self) -> None:
        with self._client_lock:
            socks = list(self._client_socks)
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def handle_error(self, request, client_address) -> None:
        # connection-level errors are ordinary here: streaming clients
        # disconnect, chaos kills sever sockets mid-reply
        exc = sys.exc_info()[1]
        if isinstance(exc, (OSError, ConnectionError)) or self.killed:
            return
        super().handle_error(request, client_address)


class ServeServer:
    """Threaded HTTP server over a :class:`ModelRegistry`."""

    def __init__(self, registry: ModelRegistry,
                 host: str = "127.0.0.1", port: int = 0,
                 path: str = "/apply",
                 timeout: float = 30.0, scheduler=None,
                 watchdog_s: Optional[float] = 30.0,
                 default_deadline_ms: Optional[float] = None,
                 admin_swap: bool = False) -> None:
        self.registry = registry
        #: the forward plane's route: ``path`` serves the default
        #: model, ``path/<name>`` a named one (``RESTfulAPI`` sets it)
        self.path = path
        self.timeout = float(timeout)
        #: a veles_tpu_torch.sched.Scheduler whose per-tenant accounting
        #: rides /metrics (``_scheduler`` key in the JSON document,
        #: ``veles_sched_*`` series in the Prometheus exposition)
        self.scheduler = scheduler
        #: dispatch watchdog: once any batcher's CURRENT device call
        #: has been out longer than this, /healthz answers 503
        #: ``{"stuck": true}``. None disables.
        self.watchdog_s = watchdog_s
        #: deadline applied to requests that carry none (the CLI's
        #: ``--serve-deadline-ms``); None = patient clients
        self.default_deadline_ms = default_deadline_ms
        #: ``POST /admin/swap``: off by default (an open swap endpoint
        #: replaces weights); fleet-spawned replicas enable it through
        #: ``VELES_SERVE_ADMIN=1``
        self.admin_swap = bool(admin_swap)
        #: chaos: monotonic instant until which this server accepts
        #: connections but never answers (``blackhole@N:MS``)
        self._blackhole_until: Optional[float] = None
        self._draining = False
        self._httpd = _TrackingHTTPServer((host, port),
                                          self._make_handler())
        # joined in stop(): the listener must not outlive the server
        self._threads = ManagedThreads(name="serve-http")
        self._threads.spawn(self._httpd.serve_forever, name="listener")

    # -- addresses ---------------------------------------------------------
    @property
    def endpoint(self):
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        """The generation endpoint of the default model."""
        return "http://%s:%d/generate" % self.endpoint

    @property
    def draining(self) -> bool:
        return self._draining

    def _model_for(self, path: str, base: str):
        """Registry entry for a <base>[/name] path."""
        if path == base:
            return self.registry.get(None)
        prefix = base + "/"
        if path.startswith(prefix):
            return self.registry.get(path[len(prefix):])
        raise LookupError(path)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 for chunked streaming; every other reply carries
            # an explicit Content-Length, so keep-alive stays correct
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args) -> None:
                pass

            #: set per request by do_POST; replies echo it
            _trace_ctx: Optional[TraceContext] = None

            def _reply(self, code: int, doc: Any,
                       content_type: str = "application/json",
                       headers: Optional[dict] = None) -> None:
                body = doc.encode() if isinstance(doc, str) else \
                    json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if self._trace_ctx is not None:
                    self.send_header("X-Trace-Id",
                                     self._trace_ctx.trace_id)
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def _deadline(self, doc) -> Optional[float]:
                """Body ``deadline_ms``, else ``X-Deadline-Ms``, else
                the server-wide default. Raises ValueError on junk."""
                deadline = doc.get("deadline_ms")
                if deadline is None:
                    header = self.headers.get("X-Deadline-Ms")
                    deadline = float(header) if header else None
                else:
                    deadline = float(deadline)
                if deadline is None:
                    deadline = server.default_deadline_ms
                if deadline is not None and deadline <= 0:
                    raise ValueError("deadline_ms must be > 0")
                return deadline

            @staticmethod
            def _retry_headers(e) -> dict:
                return {"Retry-After": str(max(1, math.ceil(
                    getattr(e, "retry_after", 1.0))))}

            def _read_body(self) -> bytes:
                """Drain the body up front: an early error reply that
                leaves body bytes unread desyncs keep-alive."""
                try:
                    length = int(self.headers.get("Content-Length")
                                 or 0)
                except ValueError:
                    length = 0
                return self.rfile.read(length) if length > 0 else b""

            def _error_reply(self, r: BaseException) -> None:
                if isinstance(r, (QueueFull, Shed, Draining)):
                    self._reply(503, {"error": type(r).__name__},
                                headers=self._retry_headers(r))
                elif isinstance(r, DeadlineExceeded):
                    self._reply(504, {"error": "deadline exceeded"})
                elif isinstance(r, TimeoutError):
                    # the batcher says which: generation or inference
                    self._reply(504, {"error": str(r)})
                elif isinstance(r, NonFiniteLogits):
                    # only THIS request's sequence went non-finite;
                    # its slot is already freed
                    self._reply(500, {"error": "non-finite logits: %s"
                                      % r})
                elif isinstance(r, PoisonedRequest):
                    # THIS request's rows made the batch fail; its
                    # co-batched innocents were answered
                    self._reply(422, {"error": "poisoned request: %s"
                                      % r})
                elif isinstance(r, ValueError):
                    self._reply(400, {"error": str(r)})
                else:
                    self._reply(500, {"error": repr(r)})

            # -- POST /apply[/<model>] ----------------------------------
            def _do_apply(self, url, raw: bytes) -> None:
                try:
                    model = server._model_for(url.path, server.path)
                except KeyError as e:
                    self._reply(404, {"error": "unknown model %s" % e})
                    return
                if not hasattr(model, "submit"):
                    self._reply(400, {"error": "model %r serves "
                                      "/generate, not /apply"
                                      % model.name})
                    return
                if server._draining:
                    self._reply(503, {"error": "draining"},
                                headers={"Retry-After": "1"})
                    return
                # per-model input dtype: f32 rows for classifiers,
                # int32 token rows for LM engines
                dtype = getattr(getattr(model, "engine", None),
                                "input_dtype", np.float32)
                try:
                    if self.headers.get("Content-Type", "").startswith(
                            "application/octet-stream"):
                        # raw rows: no JSON to parse under the
                        # interpreter lock the tenants' threads share
                        doc = {}
                        batch = np.frombuffer(raw, dtype=dtype).reshape(
                            [int(d) for d in
                             self.headers["X-Shape"].split(",")]).copy()
                    else:
                        doc = json.loads(raw)
                        batch = np.asarray(doc["input"], dtype=dtype)
                    deadline_ms = self._deadline(doc)
                    priority = doc.get("priority") or \
                        self.headers.get("X-Priority") or "interactive"
                except (ValueError, KeyError, TypeError,
                        AttributeError):
                    self._reply(400, {"error": "bad request"})
                    return
                if batch.ndim < 2 or batch.shape[0] == 0:
                    self._reply(400, {"error": "input must be a "
                                      "non-empty batch of samples"})
                    return
                try:
                    out = model.submit(batch, timeout=server.timeout,
                                       deadline_ms=deadline_ms,
                                       priority=priority,
                                       ctx=self._trace_ctx)
                except Exception as e:  # noqa: BLE001 — an engine
                    # error answers, it never tears the keep-alive
                    # connection down mid-exchange
                    self._error_reply(e)
                    return
                self._reply(200, {"output": np.asarray(out).tolist()})

            # -- POST /generate[/<model>] -------------------------------
            def _do_generate(self, url, raw: bytes) -> None:
                try:
                    model = server._model_for(url.path, "/generate")
                except KeyError as e:
                    self._reply(404, {"error": "unknown model %s" % e})
                    return
                if not hasattr(model, "generate"):
                    self._reply(400, {"error": "model %r is not "
                                      "generative" % model.name})
                    return
                if server._draining:
                    self._reply(503, {"error": "draining"},
                                headers={"Retry-After": "1"})
                    return
                try:
                    doc = json.loads(raw)
                    prompt = doc["prompt"]
                    max_tokens = int(doc.get("max_tokens", 16))
                    eos = doc.get("eos")
                    eos = int(eos) if eos is not None else None
                    stream = bool(doc.get("stream", False))
                    # sampling knobs: range and capability checks in
                    # the batcher (ValueError -> 400; this plane is
                    # greedy-only), type garbage dies here
                    sampling = {}
                    for key, cast in (("temperature", float),
                                      ("top_k", int), ("top_p", float),
                                      ("seed", int)):
                        value = doc.get(key)
                        if value is not None and cast(value) != value:
                            raise ValueError(key)
                        sampling[key] = None if value is None \
                            else cast(value)
                    draft = doc.get("draft", False)
                    if not isinstance(draft, bool):
                        raise ValueError("draft must be a boolean")
                    sampling["draft"] = draft
                    deadline_ms = self._deadline(doc)
                    single = not (prompt and
                                  isinstance(prompt[0], list))
                    prompts = [np.asarray(p, dtype=np.int64)
                               for p in ([prompt] if single
                                         else prompt)]
                except (ValueError, KeyError, TypeError,
                        AttributeError):
                    self._reply(400, {"error": "bad request"})
                    return
                if not prompts or any(p.ndim != 1 or p.size == 0
                                      for p in prompts):
                    self._reply(400, {"error": "prompt must be a "
                                      "non-empty token list (or a "
                                      "list of them)"})
                    return
                if len(prompts) > MAX_PROMPTS_PER_REQUEST:
                    self._reply(400, {"error": "at most %d prompts "
                                      "per request"
                                      % MAX_PROMPTS_PER_REQUEST})
                    return
                if stream:
                    self._do_generate_stream(model, prompts, max_tokens,
                                             eos, deadline_ms, sampling)
                    return
                # each prompt joins the continuous batch on its own,
                # from its own thread, like an independent client
                results: list = [None] * len(prompts)

                def gen(i):
                    try:
                        results[i] = model.generate(
                            prompts[i], max_tokens=max_tokens, eos=eos,
                            timeout=server.timeout,
                            deadline_ms=deadline_ms,
                            ctx=self._trace_ctx, **sampling)
                    except BaseException as e:  # noqa: BLE001
                        results[i] = e

                if len(prompts) == 1:
                    gen(0)
                else:
                    threads = [threading.Thread(target=gen, args=(i,))
                               for i in range(len(prompts))]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                for r in results:
                    if isinstance(r, BaseException):
                        self._error_reply(r)
                        return
                self._reply(200, {"tokens": [np.asarray(r).tolist()
                                             for r in results]})

            # -- POST /generate + "stream": true ------------------------
            def _do_generate_stream(self, model, prompts, max_tokens,
                                    eos, deadline_ms, sampling) -> None:
                if len(prompts) != 1:
                    self._reply(400, {"error": "stream mode takes "
                                      "exactly one prompt"})
                    return
                try:
                    # admission/validation errors raise EAGERLY, so
                    # the status code can still say 4xx/5xx
                    tokens = model.stream(prompts[0],
                                          max_tokens=max_tokens, eos=eos,
                                          timeout=server.timeout,
                                          deadline_ms=deadline_ms,
                                          ctx=self._trace_ctx, **sampling)
                except BaseException as e:  # noqa: BLE001
                    self._error_reply(e)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                if self._trace_ctx is not None:
                    self.send_header("X-Trace-Id",
                                     self._trace_ctx.trace_id)
                self.end_headers()

                def chunk(obj) -> bool:
                    """False when the client is gone."""
                    data = (json.dumps(obj) + "\n").encode()
                    try:
                        self.wfile.write(b"%x\r\n" % len(data) +
                                         data + b"\r\n")
                        self.wfile.flush()
                        return True
                    except OSError:
                        self.close_connection = True
                        return False

                got: list = []
                alive = True
                try:
                    for token in tokens:
                        got.append(token)
                        alive = chunk({"token": token})
                        if not alive:
                            break
                    if alive:
                        alive = chunk({"done": True, "tokens": got})
                except BaseException as e:  # noqa: BLE001 — mid-
                    # stream: the status line already went out
                    if alive:
                        alive = chunk({"error": repr(e)})
                finally:
                    # closing the generator frees an abandoned slot at
                    # the next token boundary
                    tokens.close()
                if alive:
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        self.close_connection = True

            def _blackholed(self) -> bool:
                """The ``blackhole@N:MS`` window: hold the request
                until the window passes, then drop the connection
                without a reply, what a wedged but accepting replica
                looks like from a router."""
                until = server._blackhole_until
                if until is None:
                    return False
                remaining = until - time.monotonic()
                if remaining <= 0:
                    server._blackhole_until = None
                    return False
                time.sleep(remaining)
                self.close_connection = True
                return True

            # -- POST /admin/swap ---------------------------------------
            def _do_admin_swap(self, raw: bytes) -> None:
                if not server.admin_swap:
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    doc = json.loads(raw)
                    package = doc["package"]
                    name = doc.get("model") or \
                        server.registry.default_name
                except (ValueError, KeyError, TypeError):
                    self._reply(400, {"error": "bad request"})
                    return
                try:
                    from veles_tpu_torch.serve.engine import \
                        InferenceEngine
                    from veles_tpu_torch.serve.registry import \
                        GenerativeModel
                    model = server.registry.get(name)
                    if isinstance(model, GenerativeModel):
                        self._reply(409, {
                            "error": "model %r serves /generate; a "
                                     "package holds a forward engine"
                                     % name})
                        return
                    engine = InferenceEngine.from_package_like(
                        package, getattr(model, "engine", None))
                    server.registry.swap(name, engine)
                except KeyError:
                    self._reply(404, {"error": "unknown model %r"
                                      % name})
                    return
                except Exception as e:  # noqa: BLE001 — a bad
                    # package answers, it never tears the connection
                    self._reply(500, {"error": "swap failed: %s" % e})
                    return
                self._reply(200, {"swapped": name, "package": package})

            def do_POST(self) -> None:
                # reset FIRST: the handler persists across keep-alive
                # requests, and a stale ctx would stamp this reply
                self._trace_ctx = None
                if self._blackholed():
                    return
                url = urlparse(self.path)
                if "chunked" in (self.headers.get(
                        "Transfer-Encoding") or "").lower():
                    self.close_connection = True
                    self._reply(411, {"error": "chunked request "
                                      "bodies unsupported; send "
                                      "Content-Length"})
                    return
                if TRACER.enabled:
                    supplied = self.headers.get("X-Trace-Id")
                    if supplied and not _TRACE_ID_RE.match(supplied):
                        supplied = None  # junk id: mint our own
                    self._trace_ctx = TraceContext(supplied) \
                        if supplied else TraceContext.new()
                http_t0 = time.monotonic()
                try:
                    raw = self._read_body()
                    if url.path == "/generate" or \
                            url.path.startswith("/generate/"):
                        self._do_generate(url, raw)
                    elif url.path == "/admin/swap":
                        self._do_admin_swap(raw)
                    elif url.path == server.path or \
                            url.path.startswith(server.path + "/"):
                        self._do_apply(url, raw)
                    else:
                        self._reply(404, {"error": "not found"})
                finally:
                    if self._trace_ctx is not None:
                        TRACER.add("http", "http", self._trace_ctx,
                                   http_t0, time.monotonic(),
                                   path=url.path)

            # -- GET /healthz | /metrics | /debug/trace -----------------
            def do_GET(self) -> None:
                self._trace_ctx = None
                if self._blackholed():
                    return
                url = urlparse(self.path)
                if url.path == "/healthz":
                    if server._draining:
                        self._reply(503, {"status": "draining"})
                        return
                    signals = server.registry.admission_signals()
                    stuck_s = signals["stuck_for_s"]
                    if server.watchdog_s is not None and \
                            stuck_s >= server.watchdog_s:
                        self._reply(503, {
                            "status": "stuck", "stuck": True,
                            "stuck_for_s": stuck_s,
                            "queue_depth": signals["queue_depth"]})
                        return
                    self._reply(200, {
                        "status": "ok",
                        "models": server.registry.names(),
                        "queue_depth": signals["queue_depth"],
                        "drain_rate_rows_per_s":
                            signals["drain_rate_rows_per_s"],
                        "stuck_for_s": stuck_s,
                        "signals": signals["models"]})
                    return
                if url.path == "/metrics":
                    fmt = parse_qs(url.query).get("format", [""])[0]
                    accept = self.headers.get("Accept", "")
                    if fmt == "prometheus" or (
                            not fmt and "text/plain" in accept):
                        text = server.registry.prometheus_text()
                        if server.scheduler is not None:
                            text += server.scheduler.prometheus_text()
                        text += obs_metrics.REGISTRY.prometheus_text()
                        self._reply(
                            200, text,
                            content_type="text/plain; version=0.0.4")
                    else:
                        doc = server.registry.metrics_snapshot()
                        if server.scheduler is not None:
                            doc["_scheduler"] = \
                                server.scheduler.snapshot()
                        doc["_slowest"] = EXEMPLARS.snapshot()
                        doc["_obs"] = obs_metrics.REGISTRY.snapshot()
                        from veles_tpu_torch import aot
                        plan = aot.active()
                        if plan is not None:
                            doc["_aot"] = plan.status_doc()
                        self._reply(200, doc)
                    return
                if url.path == "/debug/trace":
                    trace_id = parse_qs(url.query).get(
                        "trace", [None])[0]
                    self._reply(200, TRACER.export_chrome(trace_id))
                    return
                self._reply(404, {"error": "not found"})

        return Handler

    # -- chaos hooks -------------------------------------------------------
    def blackhole(self, seconds: float) -> None:
        """Arm ``blackhole@N:MS``: for ``seconds`` this server accepts
        connections but answers nothing (requests are held through the
        window, then dropped without a reply)."""
        self._blackhole_until = time.monotonic() + float(seconds)

    def kill(self) -> None:
        """Abrupt chaos death: stop accepting, sever every live
        connection (peers see a reset mid-exchange), refuse whatever
        arrives in the gap. No drain and no join: call :meth:`stop`
        afterwards. Safe from a batcher's dispatch thread."""
        self._draining = True
        self._httpd.killed = True
        # sever first: shutdown() blocks up to a poll interval, and in
        # that window live handlers would still answer cleanly
        self._httpd.sever_connections()
        self._httpd.shutdown()
        self._httpd.server_close()
        # connections accepted during the shutdown window
        self._httpd.sever_connections()

    # -- lifecycle ---------------------------------------------------------
    def begin_drain(self) -> None:
        """Flip unhealthy + refuse new work; accepted work continues."""
        self._draining = True

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful by default: drain, then close the listener."""
        self.begin_drain()
        self.registry.stop_all(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._threads.join_all(timeout)
