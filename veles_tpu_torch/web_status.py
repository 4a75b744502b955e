"""Web status server: aggregates heartbeat JSON from running
coordinators and serves a live dashboard (port of
``veles_tpu/web_status.py``; the wire format is the reference's, so a
reporter of either package feeds a server of the other).

Reference capability: veles/web_status.py:66-266 — a tornado+MongoDB
server that masters POST periodic status to (name, user, per-worker
states, workflow graph source, plots url; payload built in
veles/launcher.py:852-885) and that renders a dashboard. Here: stdlib
ThreadingHTTPServer, in-memory store with a bounded history, no
database; the dashboard is one self-refreshing HTML page reading
``/status.json``.

Endpoints:
- ``POST /update``    one JSON status document per master/run
- ``GET  /status.json`` aggregate {run_id: latest-status}
- ``GET  /metrics``   the runs' forwarded obs registries
  (``doc["metrics"]``), one sample set per run; ``?format=prometheus``
  renders the whole fleet as ONE text exposition with a ``run`` label
  per series
- ``GET  /``           HTML dashboard (cards, the scheduler's tenant
  table, the fleet card and the slowest-requests exemplar table: queue
  vs sched-wait vs device breakdown per request, from
  ``doc["slowest"]``)

Documents hold host values only (numbers, str, lists, dicts): the
reporter's thread never reads a device tensor, since a read would wait
on the training stream (and, during a graph capture, stall). The
server process imports no CUDA state (``python -m
veles_tpu_torch.web_status`` starts no CUDA context).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib import request as urlrequest

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.thread_pool import ManagedThreads

_DASHBOARD = """<!doctype html>
<html><head><meta charset="utf-8"><title>veles_tpu_torch status</title>
<style>
 .viz-root {
   color-scheme: light;
   --surface-1: #fcfcfb; --surface-2: #f2f1ec;
   --text-primary: #0b0b0b; --text-secondary: #52514e;
   --series-1: #2a78d6; --grid: #dddcd5;
   --status-warning: #eda100;
 }
 @media (prefers-color-scheme: dark) {
   :root:where(:not([data-theme=\"light\"])) .viz-root {
     color-scheme: dark;
     --surface-1: #1a1a19; --surface-2: #242422;
     --text-primary: #ffffff; --text-secondary: #c3c2b7;
     --series-1: #3987e5; --grid: #3a3a37;
     --status-warning: #c98500;
   }
 }
 body { margin: 0; }
 .viz-root { background: var(--surface-1); color: var(--text-primary);
   font: 14px/1.45 system-ui, sans-serif; min-height: 100vh;
   padding: 24px; box-sizing: border-box; }
 h1 { font-size: 18px; margin: 0 0 16px; }
 .cards { display: flex; flex-wrap: wrap; gap: 16px; }
 .card { background: var(--surface-2); border-radius: 8px;
   padding: 14px 16px; min-width: 320px; }
 .card h2 { font-size: 15px; margin: 0 0 2px; }
 .meta { color: var(--text-secondary); font-size: 12px;
   margin-bottom: 8px; }
 .stale { color: var(--status-warning); font-weight: 600; }
 .stats { display: flex; gap: 20px; margin-bottom: 8px; }
 .stat .v { font-size: 20px; font-weight: 650;
   font-variant-numeric: tabular-nums; }
 .stat .l { color: var(--text-secondary); font-size: 11px;
   text-transform: uppercase; letter-spacing: .04em; }
 svg text { fill: var(--text-secondary); font-size: 10px; }
 table { border-collapse: collapse; font-size: 12px; width: 100%; }
 td, th { text-align: left; padding: 2px 10px 2px 0;
   border-bottom: 1px solid var(--grid); }
 th { color: var(--text-secondary); font-weight: 500; }
 .empty { color: var(--text-secondary); }
</style></head>
<body><div class="viz-root"><h1>veles_tpu_torch runs</h1>
<div class="cards" id="cards"><p class="empty">no runs yet</p></div>
</div>
<script>
function spark(hist) {
  // single-series line: best validation error over report time
  const pts = hist.filter(h => typeof h.best_error === "number");
  if (pts.length < 2) return "";
  const W = 288, H = 48, P = 4;
  const t0 = pts[0].t, t1 = pts[pts.length - 1].t || t0 + 1;
  const errs = pts.map(p => p.best_error);
  const lo = Math.min(...errs), hi = Math.max(...errs);
  const x = t => P + (W - 2 * P) * (t - t0) / Math.max(t1 - t0, 1e-9);
  const y = e => P + (H - 2 * P) * (1 - (e - lo) / Math.max(hi - lo, 1e-9));
  const d = pts.map((p, i) =>
    (i ? "L" : "M") + x(p.t).toFixed(1) + " " + y(p.best_error).toFixed(1)
  ).join(" ");
  const last = pts[pts.length - 1];
  return `<svg width="${W}" height="${H + 14}" role="img"
    aria-label="best validation error over time">
    <path d="${d}" fill="none" stroke="var(--series-1)"
      stroke-width="2" stroke-linecap="round"/>
    <circle cx="${x(last.t)}" cy="${y(last.best_error)}" r="3"
      fill="var(--series-1)"/>
    <text x="${P}" y="${H + 11}">best error ${
      last.best_error.toFixed(2)}% (range ${lo.toFixed(2)}–${
      hi.toFixed(2)})</text></svg>`;
}
function workerTable(workers) {
  const ids = Object.keys(workers || {});
  if (!ids.length) return "";
  const rows = ids.sort().map(w => {
    const s = workers[w];
    return `<tr><td>${w}</td><td>${s.state}</td>` +
      `<td>${s.jobs_done}</td><td>${(+s.power).toFixed(1)}</td>` +
      `<td>${s.reconnects ?? 0}</td></tr>`;
  }).join("");
  return `<table><tr><th>worker</th><th>state</th><th>jobs</th>` +
    `<th>power</th><th>reconnects</th></tr>${rows}</table>`;
}
function schedTable(sched) {
  // per-tenant scheduler accounting (veles_tpu_torch.sched snapshot)
  const names = Object.keys((sched || {}).tenants || {});
  if (!names.length) return "";
  const rows = names.sort().map(n => {
    const t = sched.tenants[n];
    const hold = t.holding ? " ●" : (t.waiting ? " …" : "");
    return `<tr><td>${n}${hold}</td><td>${t.weight}</td>` +
      `<td>${t.priority}</td><td>${t.quanta}</td>` +
      `<td>${(+t.device_ms).toFixed(0)}</td>` +
      `<td>${(100 * t.share).toFixed(1)}%/${
             (100 * t.weighted_share).toFixed(1)}%</td>` +
      `<td>${(+t.queue_wait_ms.p50).toFixed(1)}/${
             (+t.queue_wait_ms.p99).toFixed(1)}</td>` +
      `<td>${t.preemptions}</td></tr>`;
  }).join("");
  return `<table><tr><th>tenant</th><th>w</th><th>prio</th>` +
    `<th>quanta</th><th>dev ms</th><th>share/target</th>` +
    `<th>wait p50/p99</th><th>preempt</th></tr>${rows}</table>`;
}
function serveStats(serve) {
  // decode-plane / serving gauges per registered model
  const names = Object.keys(serve || {});
  if (!names.length) return "";
  const rows = names.sort().map(n => {
    const m = serve[n];
    const rate = m.tokens_per_sec !== undefined
      ? `${(+m.tokens_per_sec).toFixed(1)} tok/s`
      : `${(+(m.qps ?? 0)).toFixed(1)} qps`;
    const occ = m.slot_occupancy !== undefined
      ? `<td>${m.active_sequences ?? 0} act · ${
           (100 * m.slot_occupancy).toFixed(0)}% slots</td>`
      : `<td>q=${m.queue_depth ?? 0}</td>`;
    // resilience counters: shed on arrival / expired before
    // the device / poisoned-row or NaN-slot isolations; a non-zero
    // watchdog heartbeat means a device call is out RIGHT NOW
    const bad = (m.poisoned_total ?? 0) + (m.nonfinite_total ?? 0);
    const res = `${m.shed_total ?? 0} shed · ${
       m.expired_total ?? 0} exp · ${bad} pois`;
    const stuck = (m.stuck_for_s ?? 0) > 1
      ? ` <span class="stale">⚠ ${
           (+m.stuck_for_s).toFixed(0)}s out</span>` : "";
    // paged decode plane: page-pool economy + speculative
    // acceptance; slab engines show a dash
    const pages = m.pages_total !== undefined
      ? `<td>${m.pages_free}/${m.pages_total} free · ${
           m.pages_shared} shr · ${
           (100 * (m.token_occupancy ?? 0)).toFixed(0)}% tok` +
        ((m.oversubscription ?? 0) > 1
          ? ` · ${(+m.oversubscription).toFixed(1)}x over` : "") +
        ((m.preempted_total ?? 0) > 0
          ? ` · ${m.preempted_total} pre` : "") +
        (m.spec_accept_rate !== undefined
          ? ` · acc ${(100 * m.spec_accept_rate).toFixed(0)}%` : "") +
        `</td>`
      : `<td>—</td>`;
    return `<tr><td>${n}</td><td>${rate}</td>${occ}${pages}` +
      `<td>${res}${stuck}</td></tr>`;
  }).join("");
  return `<table><tr><th>model</th><th>rate</th>` +
    `<th>occupancy</th><th>pages</th>` +
    `<th>shed/exp/poison</th></tr>${rows}</table>`;
}
function esc(s) {
  // status docs arrive from arbitrary POST /update JSON: everything
  // interpolated into innerHTML must be entity-escaped
  return String(s ?? "").replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;",
    '"': "&quot;", "'": "&#39;"}[c]));
}
function slowTable(rows) {
  // obs exemplar table: the N slowest requests with their
  // queue-vs-sched-wait-vs-device breakdown ("where did this
  // request's 180 ms go?")
  if (!rows || !rows.length) return "";
  const body = rows.slice(0, 8).map(r =>
    `<tr><td>${esc(r.name)}</td>` +
    `<td title="${esc(r.trace)}">${esc(r.trace).slice(0, 8)}</td>` +
    `<td>${(+r.total_ms).toFixed(1)}</td>` +
    `<td>${(+(r.queue_ms ?? 0)).toFixed(1)}</td>` +
    `<td>${(+(r.sched_ms ?? 0)).toFixed(1)}</td>` +
    `<td>${(+(r.device_ms ?? 0)).toFixed(1)}</td></tr>`).join("");
  return `<table><tr><th>slowest</th><th>trace</th><th>total ms</th>` +
    `<th>queue</th><th>sched</th><th>device</th></tr>${body}</table>`;
}
function fleetTable(fleet) {
  // fleet-router card (FleetManager.status_doc): per-replica routing
  // state + rollout state machine + autoscale/failover counters
  if (!fleet || !fleet.replicas) return "";
  const names = Object.keys(fleet.replicas);
  if (!names.length) return "";
  // numeric fields coerced with +(...): the doc arrives from
  // arbitrary POST /update JSON and everything reaching innerHTML
  // must be a number or esc()'d (the slowTable discipline)
  const rows = names.sort().map(n => {
    const r = fleet.replicas[n];
    const dot = r.routable ? "●" : (r.healthy ? "◐" : "○");
    return `<tr><td>${esc(n)} ${dot}</td><td>${esc(r.address)}</td>` +
      `<td>${+(r.queue_depth ?? 0)}</td>` +
      `<td>${(+(r.drain_rate_rows_per_s ?? 0)).toFixed(1)}</td>` +
      `<td>${+(r.in_flight ?? 0)}</td>` +
      `<td>${esc(r.reason ?? "")}${r.paused ? " ⏸" : ""}</td></tr>`;
  }).join("");
  const ro = fleet.rollout || {};
  const auto = fleet.autoscale || {};
  const meta = `rollout: ${esc(ro.state ?? "idle")}` +
    (ro.reason ? ` — ${esc(ro.reason)}` : "") +
    (auto.enabled
      ? ` · autoscale +${+(auto.spawned ?? 0)}/−${+(auto.retired ?? 0)}`
      : "") +
    ` · failovers ${+((fleet.router || {}).failovers_total ?? 0)}` +
    ` · re-admits ${+((fleet.router || {}).readmitted_total ?? 0)}`;
  return `<div class="meta">${meta}</div>` +
    `<table><tr><th>replica</th><th>address</th><th>queue</th>` +
    `<th>rows/s</th><th>in-flt</th><th>state</th></tr>${rows}</table>`;
}
function ckptStat(ckpt) {
  // Coordinator.checkpoint_stats() = AsyncCheckpointer.stats():
  // last_generation / stall_seconds are its actual keys
  if (!ckpt || ckpt.last_generation === undefined) return "";
  const stall = 1000 * (ckpt.stall_seconds ?? 0);
  return `<div class="stat"><div class="v">g${ckpt.last_generation}` +
    ` · ${stall.toFixed(1)}ms</div>` +
    `<div class="l">ckpt gen · stall total</div></div>`;
}
function aotStat(aot) {
  // aot.warmup.Plan.status_doc(): artifact hit rate + the process's
  // own measured cold start. Numbers coerced with +(...) — the doc
  // arrives from arbitrary POST /update JSON (slowTable discipline).
  if (!aot) return "";
  const hits = +(aot.hits ?? 0), misses = +(aot.misses ?? 0);
  const total = hits + misses;
  const rate = total ? (100 * hits / total).toFixed(0) + "%" : "–";
  const cold = aot.cold_start_s === undefined ? "–"
    : (+aot.cold_start_s).toFixed(2) + "s";
  const fresh = aot.fresh_compiles === undefined ? ""
    : ` · ${+aot.fresh_compiles} fresh`;
  return `<div class="stat"><div class="v">${rate} · ${cold}` +
    `${fresh}</div>` +
    `<div class="l">aot hit rate · cold start</div></div>`;
}
async function refresh() {
  try {
    const [status, history] = await Promise.all([
      fetch("status.json").then(r => r.json()),
      fetch("history.json").then(r => r.json())]);
    const ids = Object.keys(status).sort();
    const el = document.getElementById("cards");
    if (!ids.length) {
      el.innerHTML = '<p class="empty">no runs yet</p>'; return;
    }
    el.innerHTML = ids.map(id => {
      const doc = status[id];
      const age = doc.age ?? 0;  // computed server-side (no clock skew)
      const stale = age > 30;
      return `<div class="card"><h2>${id}</h2>
        <div class="meta">${doc.workflow || ""} · ${doc.mode || "?"}
          · ${doc.device || ""}
          ${stale ? '<span class="stale">⚠ stale ' +
                    age.toFixed(0) + 's</span>' : ""}</div>
        <div class="stats">
          <div class="stat"><div class="v">${doc.epoch ?? "–"}</div>
            <div class="l">epoch</div></div>
          <div class="stat"><div class="v">${
            typeof doc.best_error === "number"
              ? doc.best_error.toFixed(2) + "%" : "–"}</div>
            <div class="l">best error</div></div>
          <div class="stat"><div class="v">${
            Object.keys(doc.workers || {}).length}</div>
            <div class="l">workers</div></div>
          ${ckptStat(doc.checkpoint)}
          ${aotStat(doc.aot)}
        </div>
        ${spark(history[id] || [])}
        ${fleetTable(doc.fleet)}
        ${serveStats(doc.serve)}
        ${slowTable(doc.slowest)}
        ${schedTable(doc.scheduler)}
        ${workerTable(doc.workers)}</div>`;
    }).join("");
  } catch (e) { /* server restarting; retry next tick */ }
}
refresh();
setInterval(refresh, 5000);
</script></body></html>
"""

#: points kept per run for the dashboard sparkline
HISTORY_LIMIT = 720


class _StatusStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._runs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._history: Dict[str, list] = {}         # guarded-by: _lock

    def update(self, doc: Dict[str, Any]) -> None:
        run_id = str(doc.get("id", doc.get("name", "run")))
        doc["received"] = time.time()
        with self._lock:
            self._runs[run_id] = doc
            hist = self._history.get(run_id)
            if hist is None:
                hist = self._history[run_id] = deque(
                    maxlen=HISTORY_LIMIT)
            hist.append({"t": doc["received"],
                         "epoch": doc.get("epoch"),
                         "best_error": doc.get("best_error")})

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._runs)

    def history(self) -> Dict[str, list]:
        with self._lock:
            return {run: list(h) for run, h in self._history.items()}


class _Handler(BaseHTTPRequestHandler):
    store: _StatusStore  # set by server factory

    def log_message(self, *args) -> None:  # silence default stderr spam
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:
        if self.path != "/update":
            self._send(404, b'{"error": "not found"}')
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            doc = json.loads(self.rfile.read(length))
        except (ValueError, UnicodeDecodeError):
            self._send(400, b'{"error": "bad json"}')
            return
        self.store.update(doc)
        self._send(200, b'{"ok": true}')

    def do_GET(self) -> None:
        if self.path.split("?")[0] == "/metrics":
            from veles_tpu_torch.obs import metrics as obs_metrics
            docs = self.store.snapshot()
            if "format=prometheus" in self.path:
                samples = []
                for run, doc in sorted(docs.items()):
                    for wire in doc.get("metrics") or ():
                        sample = obs_metrics.Sample.from_wire(wire)
                        if sample is not None:
                            sample.labels += (("run", run),)
                            samples.append(sample)
                self._send(200, obs_metrics.render(samples).encode(),
                           "text/plain; version=0.0.4")
                return
            out = {}
            for run, doc in docs.items():
                registry = obs_metrics.MetricsRegistry()
                registry.absorb(run, doc.get("metrics"))
                out[run] = registry.snapshot()
            self._send(200, json.dumps(out, default=str).encode())
            return
        if self.path == "/status.json":
            now = time.time()
            # per-request copies: the store's live docs are shared
            # across handler threads, and mutating one mid-serialize
            # races another request's json.dumps
            docs = {run: dict(doc)
                    for run, doc in self.store.snapshot().items()}
            for doc in docs.values():
                # age computed here so the browser needs no clock sync
                doc["age"] = round(now - doc["received"], 1)
            self._send(200, json.dumps(docs, default=str).encode())
        elif self.path == "/history.json":
            self._send(200, json.dumps(self.store.history(),
                                       default=str).encode())
        elif self.path == "/":
            self._send(200, _DASHBOARD.encode(), "text/html")
        else:
            self._send(404, b'{"error": "not found"}')


class WebStatusServer(Logger):
    """Owns the HTTP thread; ``endpoint`` is (host, port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.store = _StatusStore()
        handler = type("BoundHandler", (_Handler,),
                       {"store": self.store})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        # Joined in close() via the ManagedThreads discipline — no
        # fire-and-forget daemon listener.
        self._threads = ManagedThreads(name="web-status")
        self._thread = self._threads.spawn(
            self._httpd.serve_forever, name="listener")
        self.info("web status on http://%s:%d", *self.endpoint)

    @property
    def endpoint(self):
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        return "http://%s:%d" % self.endpoint

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._threads.join_all(timeout=5)


def _host_value(obj: Any) -> str:
    """``json.dumps`` fallback of a status document: ``str`` of a
    host object (the reference's ``default=str``), refusing a tensor."""
    if type(obj).__module__.split(".")[0] == "torch":
        raise TypeError("status documents hold host values only, got a "
                        "%s" % type(obj).__name__)
    return str(obj)


class StatusReporter:
    """Client side: periodic POST of a status document (what the
    reference's Launcher._notify_status did every N seconds)."""

    def __init__(self, url: str, run_id: str,
                 interval: float = 10.0) -> None:
        self.url = url.rstrip("/") + "/update"
        self.run_id = run_id
        self.interval = interval
        self._timer: Optional[threading.Timer] = None
        self._source = None
        self._lock = threading.Lock()
        self._stopped = False

    def start(self, source) -> None:
        """``source()`` -> status dict, called on each tick."""
        self._source = source
        self._tick()

    def _tick(self) -> None:
        self.post(self._source() if self._source else {})
        # Re-arm under the lock: Timer.cancel() is a no-op once the
        # callback fired, so stop() must be able to veto the re-arm or
        # a leaked reporter would post a stale run's doc forever.
        with self._lock:
            if self._stopped:
                return
            self._timer = threading.Timer(self.interval, self._tick)
            self._timer.daemon = True
            self._timer.start()

    def post(self, doc: Dict[str, Any]) -> bool:
        """POST one document; False when the server is unreachable.
        Raises TypeError on a tensor anywhere in ``doc``: documents
        hold host values only (a device read here would wait on the
        training stream)."""
        doc = dict(doc)
        doc.setdefault("id", self.run_id)
        data = json.dumps(doc, default=_host_value).encode()
        req = urlrequest.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urlrequest.urlopen(req, timeout=5) as resp:
                return resp.status == 200
        except OSError:
            return False

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()


def main(argv=None) -> int:
    """Standalone dashboard daemon (what the reference ran as the
    veles.web_status service): ``python -m veles_tpu_torch.web_status
    [--host H] [--port P]``."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(prog="veles_tpu_torch.web_status")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8090)
    args = parser.parse_args(argv)
    server = WebStatusServer(host=args.host, port=args.port)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
