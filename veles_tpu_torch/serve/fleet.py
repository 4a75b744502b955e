"""Fleet manager: replica lifecycle, rolling rollouts with canary
auto-rollback, queue-depth autoscaling, and chaos arming.

Port of ``veles_tpu/serve/fleet.py``.

``serve/router.py`` answers "where does this request go"; this module
answers "what replicas exist and what weights do they run". The two
meet at the router's pause/resume surface: every state change here —
a rollout step, a retirement, a chaos kill — is drain-then-act, so
the router's traffic never sees a half-changed replica.

Replica handles come in two shapes behind one duck type
(``address`` / ``alive`` / ``signals`` / ``counters`` / ``swap`` /
``kill`` / ``respawn`` / ``stop``):

- :class:`LocalReplica` — a full serve stack (registry + batcher +
  ServeServer) in THIS process; the engines come from a factory so a
  respawn or a rollout builds a fresh one. The chaos and acceptance
  tests run on these: in-process replicas share the tracer, so one
  request's trace covers router → replica → engine without any
  cross-process stitching.
- :class:`ProcessReplica` — a ``python -m veles_tpu_torch ... --serve``
  subprocess (``distributed/spawn.py`` machinery), the production
  form the CLI's ``--route --replicas N`` spawns; rollouts reach it
  through the replica's ``POST /admin/swap`` package channel, and
  discovery beacons (``--announce``, role=replica) are its
  zero-config registration plane.

ROLLING ROLLOUT (``FleetManager.rollout``) — the registry-hot-swap
state machine, one replica at a time::

    idle -> canary -> baking -> rolling -> done
                        \\-> rolled_back (counter spike)

The first replica is the CANARY: pause routing to it, wait for its
queue to drain, hot-swap (the registry swap keeps in-flight streams
on the old engine — never torn), resume, then BAKE: watch its
``errors_total + poisoned_total + nonfinite_total`` delta against the
rest of the fleet's. A spike (>= ``min_bad_events`` bad outcomes AND
> ``spike_factor`` x the fleet baseline) swaps the old engine back and
aborts — zero non-canary replicas ever saw the bad weights. A quiet
bake rolls the remaining replicas through the same
pause/drain/swap/resume step.

AUTOSCALE (``FleetManager.autoscale``): the router's scraped
queue-depth signals drive spawn/retire decisions — sustained backlog
above ``high_queue`` rows per replica spawns one (``spawn_fn``),
sustained idleness below ``low_queue`` retires the newest
(drain-then-stop), bounded by [min_replicas, max_replicas]. Dead
replicas respawn with backoff regardless (the supervision loop), so
the fleet recovers to full weight after a chaos kill.
"""

from __future__ import annotations

import gc
import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.obs.trace import elapsed_s
from veles_tpu_torch.thread_pool import ManagedThreads

_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def _http_json(host: str, port: int, method: str, path: str,
               doc: Optional[dict] = None,
               timeout: float = 5.0) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(doc).encode() if doc is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        out = json.loads(data or b"{}")
        out["_status"] = resp.status
        return out
    finally:
        conn.close()


def _bad_total(snapshots: Dict[str, Any]) -> Dict[str, int]:
    """{"requests": N, "bad": M} over a registry metrics snapshot —
    the canary-health read. "bad" is every outcome a weight push can
    poison: engine errors, bisection-isolated poisoned rows, and
    non-finite decode sentinels."""
    requests = bad = 0
    for snap in snapshots.values():
        if not isinstance(snap, dict):
            continue
        requests += int(snap.get("requests_total") or 0)
        bad += int(snap.get("errors_total") or 0)
        bad += int(snap.get("poisoned_total") or 0)
        bad += int(snap.get("nonfinite_total") or 0)
    return {"requests": requests, "bad": bad}


class LocalReplica(Logger):
    """A whole replica serve stack in this process (tests, the bench
    fleet arm, and single-host fleets). ``engine_factory()`` builds a
    fresh engine per incarnation; ``generative=True`` serves
    ``POST /generate`` through a TokenBatcher instead of /apply.

    The engine is always wrapped in a
    :class:`~veles_tpu_torch.distributed.faults.ReplicaFaultEngine`
    (transparent until armed), so ``kill-replica@N`` can fire at the
    NEXT device call — a mid-request death, which is the case the
    router's failover exists for."""

    def __init__(self, name: str, engine_factory: Callable[[], Any],
                 generative: bool = False, host: str = "127.0.0.1",
                 port: int = 0,
                 batcher_kwargs: Optional[Dict[str, Any]] = None,
                 watchdog_s: Optional[float] = 5.0,
                 default_deadline_ms: Optional[float] = None) -> None:
        super().__init__()
        self.name = name
        self.generative = bool(generative)
        self._factory = engine_factory
        self._host = host
        self._port = int(port)
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self._watchdog_s = watchdog_s
        self._default_deadline_ms = default_deadline_ms
        self.server = None
        self.registry = None
        self._fault_engine = None
        self._dead = False
        self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        from veles_tpu_torch.distributed.faults import ReplicaFaultEngine
        from veles_tpu_torch.serve.registry import ModelRegistry
        from veles_tpu_torch.serve.server import ServeServer
        registry = ModelRegistry()
        self._fault_engine = ReplicaFaultEngine(self._factory(),
                                                self.kill)
        if self.generative:
            registry.add_generative("default", self._fault_engine,
                                    **self._batcher_kwargs)
        else:
            registry.add("default", self._fault_engine,
                         **self._batcher_kwargs)
        self.registry = registry
        self.server = ServeServer(
            registry, host=self._host, port=self._port,
            watchdog_s=self._watchdog_s,
            default_deadline_ms=self._default_deadline_ms)
        # the first bind picks the port; every respawn REUSES it so
        # the router's table stays valid across the death
        self._port = self.server.endpoint[1]
        self._dead = False

    @property
    def address(self) -> str:
        return "%s:%d" % (self._host, self._port)

    @property
    def alive(self) -> bool:
        return not self._dead and self.server is not None

    def kill(self) -> None:
        """Abrupt chaos death (listener + live connections severed).
        Safe from a batcher dispatch thread; :meth:`respawn` or
        :meth:`stop` does the real cleanup later."""
        self._dead = True
        if self.server is not None:
            self.server.kill()

    def respawn(self) -> None:
        """Fresh engine + registry + server on the SAME port.

        The dead incarnation's engine is released on this thread, and
        collected, before the factory builds the next one: a new
        engine captures CUDA graphs, and the old one's graphs must not
        be freed by a collection in the middle of that capture."""
        self._teardown(drain=False)
        self.registry = None
        self._fault_engine = None
        gc.collect()
        self.start()
        self.info("replica %s respawned at %s", self.name,
                  self.address)

    def _teardown(self, drain: bool) -> None:
        server, self.server = self.server, None
        if server is not None:
            try:
                server.stop(drain=drain,
                            timeout=10.0 if drain else 2.0)
            except Exception:  # noqa: BLE001 — a wedged dead server
                # must not block the respawn that replaces it
                self.warning("teardown of %s raised", self.name,
                             exc_info=True)

    def stop(self) -> None:
        self._dead = True
        self._teardown(drain=True)

    # -- fleet surface -----------------------------------------------------
    def signals(self) -> Dict[str, Any]:
        if self.registry is None:
            return {"queue_depth": 0}
        return self.registry.admission_signals()

    def counters(self) -> Dict[str, int]:
        if self.registry is None:
            return {"requests": 0, "bad": 0}
        return _bad_total(self.registry.metrics_snapshot())

    def swap(self, new: Any):
        """Hot-swap the served engine; ``new`` is an engine instance
        or a package-archive path. Returns the engine it replaced
        (the fleet manager's rollback token)."""
        if isinstance(new, str):
            from veles_tpu_torch.serve.engine import InferenceEngine
            model = self.registry.get("default")
            new = InferenceEngine.from_package_like(
                new, getattr(model, "engine", None))
        return self.registry.get("default").swap(new)

    # -- chaos -------------------------------------------------------------
    def arm_kill(self) -> None:
        """``kill-replica@N``: die at the next device call."""
        self._fault_engine.arm()

    def blackhole(self, ms: float) -> None:
        """``blackhole@N:MS``: accept, answer nothing, for MS ms."""
        self.server.blackhole(ms / 1000.0)


class ProcessReplica(Logger):
    """A replica subprocess (``--serve`` CLI) under fleet
    supervision — the shape ``--route --replicas N`` spawns. Swap
    goes through the replica's ``POST /admin/swap`` package channel
    (the process's memory is not ours to reach into)."""

    def __init__(self, name: str, proc) -> None:
        super().__init__()
        self.name = name
        self._proc = proc  # distributed.spawn.ReplicaProcess
        self._package: Optional[str] = None  # last rolled-out archive

    @property
    def address(self) -> str:
        return self._proc.serve_addr

    @property
    def alive(self) -> bool:
        return self._proc.alive

    @property
    def pid(self) -> int:
        return self._proc.pid

    def kill(self) -> None:
        self._proc.kill()

    def respawn(self) -> None:
        self._proc.respawn()

    def stop(self) -> Optional[int]:
        """Stop the process; returns its exit code."""
        return self._proc.stop()

    def _endpoint(self):
        host, _, port = self.address.rpartition(":")
        return host or "127.0.0.1", int(port)

    def signals(self) -> Dict[str, Any]:
        try:
            return _http_json(*self._endpoint(), "GET", "/healthz")
        except _TRANSPORT_ERRORS + (ValueError,):
            return {"queue_depth": 0}

    def counters(self) -> Dict[str, int]:
        try:
            doc = _http_json(*self._endpoint(), "GET", "/metrics")
        except _TRANSPORT_ERRORS + (ValueError,):
            return {"requests": 0, "bad": 0}
        doc.pop("_status", None)
        return _bad_total(doc)

    def swap(self, new: Any):
        if not isinstance(new, str):
            raise TypeError(
                "a process replica swaps via a package archive path; "
                "got %r" % (type(new).__name__,))
        doc = _http_json(*self._endpoint(), "POST", "/admin/swap",
                         {"package": new}, timeout=60.0)
        if doc.get("_status") != 200:
            raise RuntimeError("swap on %s failed: %s"
                               % (self.name, doc))
        return self._swapped_from(new)

    def _swapped_from(self, package: str) -> str:
        # the rollback token for a process replica is the PREVIOUS
        # package path; the fleet records what it rolled out before
        previous = getattr(self, "_package", None)
        self._package = package
        return previous

    def arm_kill(self) -> None:
        # a subprocess version of the next-call kill needs no engine
        # wrapper: SIGKILL is the real thing
        self._proc.kill()

    def blackhole(self, ms: float) -> None:
        raise NotImplementedError(
            "blackhole on a process replica needs the in-process "
            "hook; run fleet chaos on LocalReplica handles")


class FleetManager(Logger):
    """Owns the replica handles behind one :class:`Router`: respawn
    supervision, rolling rollout with canary auto-rollback, and
    queue-depth autoscaling."""

    def __init__(self, router, replicas: List[Any] = (),
                 respawn: bool = True,
                 respawn_backoff_s: float = 0.25,
                 max_respawns: int = 10,
                 supervise_interval_s: float = 0.1) -> None:
        super().__init__()
        # accept a RouterServer too — the manager only needs the core
        self.router = getattr(router, "router", router)
        self.respawn = respawn
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.max_respawns = int(max_respawns)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Any] = {}      # guarded-by: _lock
        self._order: List[str] = []              # guarded-by: _lock
        self._respawns: Dict[str, int] = {}      # guarded-by: _lock
        self._respawn_due: Dict[str, float] = {}  # owned-by: supervisor
        self._rollout: Dict[str, Any] = {"state": "idle"}  # guarded-by: _lock
        self._autoscale_doc: Dict[str, Any] = {"enabled": False}
        self._spawned = 0
        self._threads = ManagedThreads(name="fleet")
        for handle in replicas:
            self.add(handle)
        self._threads.spawn(self._supervise,
                            float(supervise_interval_s),
                            name="supervisor")

    # -- membership --------------------------------------------------------
    def add(self, handle) -> str:
        with self._lock:
            self._replicas[handle.name] = handle
            self._order.append(handle.name)
            self._respawns.setdefault(handle.name, 0)
        self.router.add_replica(handle.address, name=handle.name)
        return handle.name

    def remove(self, name: str) -> None:
        with self._lock:
            handle = self._replicas.pop(name, None)
            if name in self._order:
                self._order.remove(name)
        self.router.remove_replica(name)
        if handle is not None:
            handle.stop()

    def handles(self) -> List[Any]:
        with self._lock:
            return [self._replicas[name] for name in self._order]

    def handle(self, name: str):
        with self._lock:
            return self._replicas[name]

    # -- supervision -------------------------------------------------------
    def _supervise(self, interval_s: float) -> None:  # runs-on: supervisor
        while not self._threads.wait_stop(interval_s):
            if not self.respawn:
                continue
            now = time.monotonic()
            for handle in self.handles():
                if handle.alive:
                    self._respawn_due.pop(handle.name, None)
                    continue
                due = self._respawn_due.get(handle.name)
                if due is None:
                    # the respawn BUDGET is shared with add() and
                    # status_doc() readers — count it under the lock
                    with self._lock:
                        count = self._respawns.get(handle.name, 0)
                        if count >= self.max_respawns:
                            continue
                        self._respawns[handle.name] = count + 1
                    delay = self.respawn_backoff_s * (2 ** count)
                    self._respawn_due[handle.name] = now + delay
                    self.warning(
                        "replica %s died; respawn %d/%d in %.2fs",
                        handle.name, count + 1, self.max_respawns,
                        delay)
                elif now >= due:
                    del self._respawn_due[handle.name]
                    try:
                        handle.respawn()
                    except Exception:  # noqa: BLE001 — a failed
                        # respawn retries on the next death check
                        self.warning("respawn of %s failed",
                                     handle.name, exc_info=True)
                        continue
                    # probe immediately: the fleet recovers to full
                    # weight without waiting out a health tick
                    self.router.scrape(handle.name)

    # -- chaos -------------------------------------------------------------
    def arm_faults(self, plan) -> None:
        """Install a FaultPlan's fleet verbs: ``kill-replica@N``
        arms replica index N (registration order) to die at its next
        engine call; ``blackhole@N:MS`` opens replica N's
        accept-but-never-answer window now."""
        order = self.handles()
        for idx in sorted(plan.replica_kills):
            if idx < len(order):
                self.info("arming kill-replica@%d (%s)", idx,
                          order[idx].name)
                order[idx].arm_kill()
        for idx, ms in sorted(plan.replica_blackholes.items()):
            if idx < len(order):
                self.info("arming blackhole@%d:%g (%s)", idx, ms,
                          order[idx].name)
                order[idx].blackhole(ms)

    # -- rolling rollout ---------------------------------------------------
    def rollout_status(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._rollout)

    def _set_rollout(self, **fields: Any) -> None:
        with self._lock:
            self._rollout.update(fields)

    def _drain_then_swap(self, handle, new: Any,
                         drain_timeout_s: float):
        """One rollout step: stop routing to the replica, wait for
        its pending queue to empty (in-flight streams keep running —
        the registry swap itself defers until the old engine's active
        sequences retire, so streams are NEVER torn), swap, resume."""
        self.router.pause(handle.name)
        try:
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                if int(handle.signals().get("queue_depth") or 0) == 0:
                    break
                time.sleep(0.01)
            return handle.swap(new)
        finally:
            self.router.resume(handle.name)

    def _roll_back(self, handle, old: Any,
                   drain_timeout_s: float) -> None:
        """Undo the canary swap. ``old`` is the token the swap
        returned; a ProcessReplica's FIRST rollout has none (its
        original weights came from the workflow argv, not a package
        we could re-push), so the rollback there is kill + respawn —
        the fresh process serves its birth weights."""
        if old is not None:
            self._drain_then_swap(handle, old, drain_timeout_s)
            return
        self.warning("no swap-back token for %s; respawning it to "
                     "its original weights", handle.name)
        self.router.pause(handle.name)
        try:
            handle.kill()
            handle.respawn()
            self.router.scrape(handle.name)
        finally:
            self.router.resume(handle.name)

    def rollout(self, make_engine: Optional[Callable[[], Any]] = None,
                package: Optional[str] = None,
                replicas: Optional[List[str]] = None,
                bake_s: float = 0.75, poll_s: float = 0.05,
                min_bad_events: int = 3, spike_factor: float = 3.0,
                drain_timeout_s: float = 10.0) -> bool:
        """Roll new weights through the fleet one replica at a time;
        returns True on completion, False on canary auto-rollback.

        ``make_engine()`` builds one fresh engine per replica
        (in-process fleets); ``package`` is the archive path a
        process fleet swaps via ``/admin/swap``. The FIRST replica in
        ``replicas`` (default: registration order) is the canary; its
        ``bad`` counter delta over the bake window is compared
        against the busiest other replica's — a spike of at least
        ``min_bad_events`` exceeding ``spike_factor`` x the baseline
        swaps the old engine back and aborts with state
        ``rolled_back``. Non-canary replicas never see the bad
        weights (that IS the zero-failed-requests guarantee)."""
        if (make_engine is None) == (package is None):
            raise ValueError(
                "rollout takes exactly one of make_engine/package")

        def new_for(_handle):
            return make_engine() if make_engine is not None \
                else package

        order = replicas if replicas is not None else \
            [h.name for h in self.handles()]
        if not order:
            raise ValueError("rollout over an empty fleet")
        canary = order[0]
        self._set_rollout(state="canary", canary=canary,
                          completed=[], target=list(order),
                          reason=None)
        handle = self.handle(canary)
        others = [self.handle(name) for name in order[1:]]
        before_canary = handle.counters()
        before_others = [other.counters() for other in others]
        old = self._drain_then_swap(handle, new_for(handle),
                                    drain_timeout_s)
        # -- bake: canary bad-delta vs the fleet baseline ------------------
        self._set_rollout(state="baking")
        bake_t0 = time.monotonic()
        while elapsed_s(bake_t0) < bake_s:
            time.sleep(poll_s)
            now_canary = handle.counters()
            bad = now_canary["bad"] - before_canary["bad"]
            if bad < min_bad_events:
                continue
            baseline = max(
                (other.counters()["bad"] - b0["bad"]
                 for other, b0 in zip(others, before_others)),
                default=0)
            if bad > spike_factor * max(baseline, 1):
                reason = ("canary %s bad-outcome spike: +%d vs fleet "
                          "baseline +%d over %.2fs"
                          % (canary, bad, baseline,
                             elapsed_s(bake_t0)))
                self.warning("ROLLBACK: %s", reason)
                self._roll_back(handle, old, drain_timeout_s)
                self._set_rollout(state="rolled_back", reason=reason)
                return False
        self._set_rollout(state="rolling",
                          completed=[canary])
        for other in others:
            self._drain_then_swap(other, new_for(other),
                                  drain_timeout_s)
            with self._lock:
                self._rollout["completed"].append(other.name)
        self._set_rollout(state="done")
        self.info("rollout complete across %d replica(s)", len(order))
        return True

    # -- autoscale ---------------------------------------------------------
    def autoscale(self, spawn_fn: Callable[[], Any],
                  min_replicas: int = 1, max_replicas: int = 4,
                  high_queue: float = 8.0, low_queue: float = 1.0,
                  sustain_ticks: int = 3,
                  interval_s: float = 0.25) -> None:
        """Start the queue-depth autoscaler: when the mean scraped
        queue depth per routable replica stays >= ``high_queue`` for
        ``sustain_ticks`` ticks, ``spawn_fn()`` adds a replica (a
        handle — LocalReplica factory or a spawn.py process); when it
        stays <= ``low_queue``, the newest spawned replica retires
        (drain-then-stop). Bounded by [min_replicas, max_replicas]."""
        state = {"high": 0, "low": 0, "spawned": 0, "retired": 0}
        self._autoscale_doc = {
            "enabled": True, "min": min_replicas, "max": max_replicas,
            "high_queue": high_queue, "low_queue": low_queue,
            "spawned": 0, "retired": 0}

        def loop() -> None:
            while not self._threads.wait_stop(interval_s):
                states = self.router.states()
                routable = [s for s in states.values()
                            if s["routable"]]
                if not routable:
                    continue
                mean_queue = sum(s["queue_depth"]
                                 for s in routable) / len(routable)
                n = len(self.handles())
                if mean_queue >= high_queue and n < max_replicas:
                    state["high"] += 1
                    state["low"] = 0
                    if state["high"] >= sustain_ticks:
                        state["high"] = 0
                        try:
                            handle = spawn_fn()
                        except Exception:  # noqa: BLE001 — a failed
                            # spawn must not kill the autoscaler
                            self.warning("autoscale spawn failed",
                                         exc_info=True)
                            continue
                        self.add(handle)
                        state["spawned"] += 1
                        self._autoscale_doc["spawned"] = \
                            state["spawned"]
                        self.info("autoscale: +1 replica (%s) at "
                                  "mean queue %.1f", handle.name,
                                  mean_queue)
                elif mean_queue <= low_queue and n > min_replicas:
                    state["low"] += 1
                    state["high"] = 0
                    if state["low"] >= sustain_ticks:
                        state["low"] = 0
                        with self._lock:
                            victim = self._order[-1]
                        self.router.pause(victim)
                        # account BEFORE the blocking drain-stop:
                        # remove() joins the victim's threads, and a
                        # reader polling handles()+status_doc() must
                        # never see the shrunken fleet with a stale
                        # retired counter
                        state["retired"] += 1
                        self._autoscale_doc["retired"] = \
                            state["retired"]
                        self.info("autoscale: -1 replica (%s) at "
                                  "mean queue %.1f", victim,
                                  mean_queue)
                        self.remove(victim)
                else:
                    state["high"] = state["low"] = 0

        self._threads.spawn(loop, name="autoscale")

    # -- status ------------------------------------------------------------
    def status_doc(self) -> Dict[str, Any]:
        """The fleet's status document (replicas, rollout, autoscale,
        respawns, router counters)."""
        with self._lock:
            respawns = dict(self._respawns)
        return {
            "replicas": self.router.states(),
            "rollout": self.rollout_status(),
            "autoscale": dict(self._autoscale_doc),
            "respawns": respawns,
            "router": self.router.metrics.snapshot(),
        }

    # -- lifecycle ---------------------------------------------------------
    def stop(self, stop_replicas: bool = True) -> None:
        self._threads.request_stop()
        self._threads.join_all(timeout=10)
        if stop_replicas:
            for handle in self.handles():
                try:
                    handle.stop()
                except Exception:  # noqa: BLE001 — best-effort stop
                    self.warning("stop of %s raised", handle.name,
                                 exc_info=True)
