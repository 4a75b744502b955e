"""Port parity of the serving fleet: ``veles_tpu_torch.serve.router``
(``Router``, ``RouterServer``) and ``serve.fleet`` (``LocalReplica``,
``FleetManager``) on the CPU.

The machinery tests are the reference's ``tests/test_fleet.py`` run
against the port's classes with the same stub engines (placement,
failover, affinity, streaming, chaos, rollouts, autoscale, discovery).
The parity tests hold the port to the reference: greedy tokens through
the port's router over two replicas of the port's ``GenerativeEngine``
equal the reference engine's token for token (f32); ``/apply`` through
it over the port's ``InferenceEngine`` (64 x 64 AlexNet, f32) agrees
with the reference engine within 1e-4 of the output's scale (the port's
f32 bound: summation order only); and each package's router fronts the
other package's replicas with the same bodies, headers and status
codes. Every wait is an event or a bounded poll, never a bare sleep.
"""

import http.client
import json
import select
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from veles_tpu_torch.distributed.faults import FaultPlan
from veles_tpu_torch.serve.fleet import FleetManager, LocalReplica
from veles_tpu_torch.serve.registry import ModelRegistry
from veles_tpu_torch.serve.router import Router, RouterServer
from veles_tpu_torch.serve.server import ServeServer

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

WAIT_S = 30.0


def _until(predicate, what, timeout=WAIT_S, step=0.01):
    """Poll ``predicate`` until true or fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(step)


# ---------------------------------------------------------------------------
# stub engines (the reference's): the fleet tests exercise the router
# and the fleet; engine exactness is held by the parity tests below
# ---------------------------------------------------------------------------

class StubEngine:
    """Row-aligned ``apply = scale * x`` with an optional delay."""

    input_dtype = np.dtype(np.float32)

    def __init__(self, scale=2.0, delay=0.0):
        self.scale = scale
        self.delay = delay
        self.compile_count = 0
        self.buckets = []

    def apply(self, x):
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(x, np.float32) * self.scale


class RaisingEngine(StubEngine):
    """Every batch blows up: the poisoned-weights stand-in."""

    def apply(self, x):
        raise RuntimeError("poisoned package")


class StubGenEngine:
    """Decode-plane fake: next token = (last + step) % 97."""

    max_len = 256

    def __init__(self, max_slots=4, step=1, delay=0.0):
        self.max_slots = max_slots
        self.step = step
        self.delay = delay
        self._last = {}  # slot -> last token
        self.last_finite = np.ones(max_slots, bool)

    @property
    def free_slots(self):
        return self.max_slots - len(self._last)

    def admit(self, prompts):
        slots, first = [], []
        for prompt in prompts:
            slot = next(i for i in range(self.max_slots)
                        if i not in self._last)
            token = (int(prompt[-1]) + self.step) % 97
            self._last[slot] = token
            slots.append(slot)
            first.append(token)
        return slots, np.asarray(first, np.int64)

    def decode(self):
        if self.delay:
            time.sleep(self.delay)
        out = np.zeros(self.max_slots, np.int64)
        for slot, last in list(self._last.items()):
            token = (last + self.step) % 97
            self._last[slot] = token
            out[slot] = token
        return out

    def release(self, slot):
        self._last.pop(slot, None)


def expected_tokens(prompt_last, n, step=1):
    out, cur = [], prompt_last
    for _ in range(n):
        cur = (cur + step) % 97
        out.append(cur)
    return out


# ---------------------------------------------------------------------------
# HTTP helpers
# ---------------------------------------------------------------------------

def _post(url, doc, timeout=30, headers=None):
    body = json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=body, headers={
            "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _stream_lines(url, doc, timeout=60, headers=None, first=None):
    """POST a streaming /generate; yields its ND-JSON records (sets
    ``first`` once the first one arrived)."""
    body = json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=body, headers={
            "Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            if line.strip():
                if first is not None:
                    first.set()
                yield json.loads(line)


# ---------------------------------------------------------------------------
# fleets by hand (every handle stopped: the conftest's thread-leak
# fixture fails anything left running)
# ---------------------------------------------------------------------------

def _apply_replica(name, scale=2.0, delay=0.0, **kwargs):
    return LocalReplica(
        name, lambda: StubEngine(scale=scale, delay=delay),
        batcher_kwargs={"max_batch": 8, "max_delay_ms": 1.0},
        watchdog_s=None, **kwargs)


def _gen_replica(name, step=1, delay=0.0):
    return LocalReplica(
        name, lambda: StubGenEngine(step=step, delay=delay),
        generative=True, watchdog_s=None)


def _fleet(replicas, health_interval_s=0.05, **fleet_kwargs):
    """(RouterServer, FleetManager) over in-process replicas, every
    replica routable."""
    server = RouterServer(Router(health_interval_s=health_interval_s))
    fleet = FleetManager(server.router, replicas=replicas,
                         **fleet_kwargs)
    _until(lambda: server.router.routable_count() == len(replicas),
           "replicas never became routable")
    return server, fleet


def _teardown(server, fleet):
    fleet.stop()
    server.stop()


def _pin_session(url, prefix, want_replica, generative=False,
                 limit=64):
    """A session id the router pins to ``want_replica``."""
    for i in range(limit):
        session = "%s-%d" % (prefix, i)
        if generative:
            code, doc, headers = _post(
                url + "/generate",
                {"prompt": [5], "max_tokens": 1, "session": session})
        else:
            code, doc, headers = _post(
                url + "/apply",
                {"input": [[1.0, 2.0]], "session": session})
        assert code == 200, doc
        if headers.get("X-Replica") == want_replica:
            return session
    raise AssertionError("no session pinned to %s" % want_replica)


# ===========================================================================
# /healthz admission signals and the fault grammar
# ===========================================================================

def test_healthz_exports_admission_signals():
    replica = _apply_replica("solo")
    try:
        url = "http://%s" % replica.address
        for _ in range(3):  # calibrate the drain-rate EWMA
            code, doc, _ = _post(url + "/apply", {"input": [[1.0, 2.0]]})
            assert code == 200
        code, body, _ = _get(url + "/healthz")
        assert code == 200
        doc = json.loads(body)
        assert doc["status"] == "ok"
        assert doc["queue_depth"] == 0
        assert doc["drain_rate_rows_per_s"] > 0
        assert doc["stuck_for_s"] >= 0.0
        assert set(doc["signals"]["default"]) == {
            "queue_depth", "drain_rate_rows_per_s", "stuck_for_s"}
    finally:
        replica.stop()


def test_fault_plan_fleet_grammar():
    plan = FaultPlan("kill-replica@2;blackhole@0:250")
    assert plan.replica_kills == {2}
    assert plan.replica_blackholes == {0: 250.0}
    described = plan.describe()
    assert "kill replica 2" in described
    assert "blackhole replica 0" in described
    for bad in ("kill-replica@x", "blackhole@1"):
        with pytest.raises(ValueError):
            FaultPlan(bad)


# ===========================================================================
# router: placement, failover, edge shed, observability
# ===========================================================================

def test_router_balances_and_proxies_apply():
    server, fleet = _fleet([_apply_replica("r0"), _apply_replica("r1")])
    try:
        x = [[1.0, 2.0], [3.0, 4.0]]
        seen = set()
        for _ in range(24):
            code, doc, headers = _post(server.url + "/apply",
                                       {"input": x})
            assert code == 200
            np.testing.assert_allclose(doc["output"],
                                       np.asarray(x) * 2.0)
            assert "X-Ticket-Id" in headers
            seen.add(headers["X-Replica"])
        assert seen == {"r0", "r1"}
        snap = server.metrics.snapshot()
        assert snap["requests_total"] == 24
        assert set(snap["routed"]) == {"r0", "r1"}
    finally:
        _teardown(server, fleet)


def test_router_healthz_and_empty_fleet_503():
    server = RouterServer(Router(health_interval_s=0.05))
    try:
        code, body, _ = _get(server.url + "/healthz")
        assert code == 503
        assert json.loads(body)["routable"] == 0
        code, doc, headers = _post(server.url + "/apply",
                                   {"input": [[1.0]]})
        assert code == 503 and "Retry-After" in headers
        assert server.metrics.snapshot()["no_replica_total"] == 1
    finally:
        server.stop()


def test_failover_readmits_ticket_exactly_once_on_sibling():
    """A replica armed to die at its next engine call takes a request
    down mid-flight; the router re-admits the ticket on the sibling,
    exactly once, and the client sees one clean 200."""
    server, fleet = _fleet([_apply_replica("r0"), _apply_replica("r1")])
    try:
        session = _pin_session(server.url, "kill", "r0")
        fleet.arm_faults(FaultPlan("kill-replica@0"))
        code, doc, headers = _post(
            server.url + "/apply",
            {"input": [[2.0, 3.0]], "session": session})
        assert code == 200, doc
        np.testing.assert_allclose(doc["output"], [[4.0, 6.0]])
        assert headers["X-Replica"] == "r1"
        snap = server.metrics.snapshot()
        assert snap["readmitted_total"] == 1
        assert snap["failovers_total"] == 1
        assert not server._may_readmit(headers["X-Ticket-Id"])
    finally:
        _teardown(server, fleet)


def test_blackhole_routes_around_and_recovers():
    server, fleet = _fleet([_apply_replica("r0"), _apply_replica("r1")])
    try:
        session = _pin_session(server.url, "hole", "r0")
        fleet.arm_faults(FaultPlan("blackhole@0:400"))
        t0 = time.monotonic()
        code, doc, headers = _post(
            server.url + "/apply",
            {"input": [[1.0, 1.0]], "session": session})
        assert code == 200
        assert headers["X-Replica"] == "r1"
        assert time.monotonic() - t0 < 5.0
        _until(lambda: server.router.routable_count() == 2,
               "blackholed replica never rejoined")
    finally:
        _teardown(server, fleet)


def test_edge_shed_doomed_deadline_503_with_retry_after():
    server, fleet = _fleet([_apply_replica("slow", delay=0.05)])
    try:
        for _ in range(3):  # calibrate the replica's drain EWMA
            code, _, _ = _post(server.url + "/apply", {"input": [[1.0]]})
            assert code == 200
        _until(lambda: server.router.states()["slow"]
               ["drain_rate_rows_per_s"] > 0, "no calibrated scrape")
        code, doc, headers = _post(
            server.url + "/apply", {"input": [[1.0]]},
            headers={"X-Deadline-Ms": "2"})
        assert code == 503 and "shed" in doc["error"]
        assert "Retry-After" in headers
        assert server.metrics.snapshot()["shed_total"] == 1
    finally:
        _teardown(server, fleet)


def test_one_trace_id_covers_router_replica_engine():
    """The route span (router), http span (replica front) and the
    queue, device and request spans (engine dispatch) stitch under one
    trace id. The http and route spans close just after their replies
    went out, so they are awaited (bounded), not assumed."""
    from veles_tpu_torch.obs.trace import TRACER
    enabled, TRACER.enabled = TRACER.enabled, True
    server, fleet = _fleet([_apply_replica("r0")])
    try:
        trace_id = "feedc0de" * 2
        code, _, headers = _post(
            server.url + "/apply", {"input": [[1.0, 2.0]]},
            headers={"X-Trace-Id": trace_id})
        assert code == 200
        assert headers["X-Trace-Id"] == trace_id
        want = {"route", "http", "queue", "device", "request"}
        _until(lambda: want <= {s["name"]
                                for s in TRACER.spans(trace_id)},
               "spans never stitched")
    finally:
        TRACER.enabled = enabled
        _teardown(server, fleet)


def test_router_metrics_aggregate_replicas_under_labels():
    server, fleet = _fleet([_apply_replica("r0"), _apply_replica("r1")])
    try:
        for _ in range(8):
            code, _, _ = _post(server.url + "/apply",
                               {"input": [[1.0, 2.0]]})
            assert code == 200
        code, body, _ = _get(server.url + "/metrics?format=prometheus")
        assert code == 200
        text = body.decode()
        for name in ("r0", "r1"):
            assert 'veles_serve_requests_total{model="default",' \
                   'replica="%s"}' % name in text
        assert "veles_router_requests_total" in text
        assert text.count(
            "# TYPE veles_serve_requests_total counter") == 1
        code, body, _ = _get(server.url + "/metrics")
        doc = json.loads(body)
        assert set(doc["replicas"]) == {"r0", "r1"}
        assert doc["_router"]["requests_total"] >= 8
    finally:
        _teardown(server, fleet)


def test_router_400_on_non_numeric_deadline_body_field():
    server, fleet = _fleet([_apply_replica("d0")])
    try:
        for bad in ([50], -1):
            code, doc, _ = _post(server.url + "/apply",
                                 {"input": [[1.0]], "deadline_ms": bad})
            assert code == 400 and "bad request" in doc["error"]
        code, _, _ = _post(server.url + "/apply", {"input": [[1.0]]})
        assert code == 200
    finally:
        _teardown(server, fleet)


def test_stale_pooled_connection_is_not_a_replica_fault():
    """A pooled keep-alive connection whose replica closed it while
    idle is dropped before it is sent on (its socket is readable), so
    the request goes out on a fresh connection: no failover, no
    re-admission spent (a deliberate divergence from the reference,
    which tells staleness by a 0.1 s clock alone)."""
    server, fleet = _fleet([_apply_replica("r0")])
    try:
        code, _, _ = _post(server.url + "/apply", {"input": [[1.0]]})
        assert code == 200
        pooled = server._pool._idle[("127.0.0.1",
                                     int(fleet.handle("r0").address
                                         .rpartition(":")[2]))]
        assert pooled
        # the replica side closes every idle connection
        fleet.handle("r0").server._httpd.sever_connections()
        _until(lambda: all(not c.sock or select.select(
            [c.sock], [], [], 0)[0] for c in pooled),
            "the replica's close never arrived")
        code, doc, headers = _post(server.url + "/apply",
                                   {"input": [[3.0]]})
        assert code == 200 and doc["output"] == [[6.0]]
        snap = server.metrics.snapshot()
        assert snap["failovers_total"] == 0
        assert snap["readmitted_total"] == 0
        assert server._may_readmit(headers["X-Ticket-Id"])
    finally:
        _teardown(server, fleet)


# ===========================================================================
# generative plane through the router: affinity, streaming, chaos
# ===========================================================================

def test_generate_session_affinity_sticks_and_streams():
    server, fleet = _fleet([_gen_replica("g0"), _gen_replica("g1")])
    try:
        session = _pin_session(server.url, "aff", "g0", generative=True)
        for _ in range(4):
            code, doc, headers = _post(
                server.url + "/generate",
                {"prompt": [10], "max_tokens": 4, "session": session})
            assert code == 200
            assert headers["X-Replica"] == "g0"
            assert doc["tokens"] == [expected_tokens(10, 4)]
        assert server.metrics.snapshot()["affinity_hits_total"] >= 4
        records = list(_stream_lines(
            server.url + "/generate",
            {"prompt": [20], "max_tokens": 5, "stream": True,
             "session": session}))
        tokens = [r["token"] for r in records if "token" in r]
        assert tokens == expected_tokens(20, 5)
        assert records[-1]["done"] is True
        assert records[-1]["tokens"] == expected_tokens(20, 5)
    finally:
        _teardown(server, fleet)


def test_chaos_kill_one_of_three_replicas_mid_stream():
    """With 3 replicas and live streaming and non-streaming traffic, a
    seeded kill of one replica mid-stream re-admits its non-streaming
    tickets exactly once on survivors (token-exact), hands its
    streaming client a clean final error record, leaves the others
    untouched, and the fleet recovers to full weight on respawn."""
    replicas = [_gen_replica("g0", delay=0.01),
                _gen_replica("g1", delay=0.01),
                _gen_replica("g2", delay=0.01)]
    server, fleet = _fleet(replicas, respawn_backoff_s=0.1)
    try:
        victim_session = _pin_session(server.url, "victim", "g1",
                                      generative=True)
        innocent_session = _pin_session(server.url, "innocent", "g0",
                                        generative=True)
        results = {}
        started = threading.Event()

        def stream(key, session, prompt_last, n, first=None):
            try:
                results[key] = list(_stream_lines(
                    server.url + "/generate",
                    {"prompt": [prompt_last], "max_tokens": n,
                     "stream": True, "session": session}, first=first))
            except BaseException as e:  # noqa: BLE001 — recorded
                results[key] = e

        def generate(key, session, prompt_last, n):
            try:
                results[key] = _post(
                    server.url + "/generate",
                    {"prompt": [prompt_last], "max_tokens": n,
                     "session": session}, timeout=60)
            except BaseException as e:  # noqa: BLE001 — recorded
                results[key] = e

        threads = [
            threading.Thread(target=stream, args=(
                "victim_stream", victim_session, 7, 200, started)),
            threading.Thread(target=stream, args=(
                "innocent_stream", innocent_session, 9, 30)),
            threading.Thread(target=generate, args=(
                "readmit_a", victim_session, 11, 120)),
            threading.Thread(target=generate, args=(
                "readmit_b", victim_session, 13, 120)),
        ]
        for t in threads:
            t.start()
        # the kill fires once the victim's stream is flowing and all
        # three of its sequences sit in g1's slots: mid-stream and
        # mid-request by construction
        victim_engine = replicas[1].registry.get("default").engine
        assert started.wait(WAIT_S)
        _until(lambda: len(victim_engine._engine._last) == 3,
               "the victim's sequences never joined")
        fleet.arm_faults(FaultPlan("kill-replica@1", seed=7))
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a client hung after the kill"

        victim = results["victim_stream"]
        assert isinstance(victim, list), repr(victim)
        assert "error" in victim[-1], victim[-1]
        assert victim[-1].get("replica") == "g1"
        streamed = [r["token"] for r in victim if "token" in r]
        assert streamed == expected_tokens(7, len(streamed))
        assert 0 < len(streamed) < 200

        innocent = results["innocent_stream"]
        assert isinstance(innocent, list), repr(innocent)
        assert [r["token"] for r in innocent if "token" in r] == \
            expected_tokens(9, 30)
        assert innocent[-1].get("done") is True

        for key, last in (("readmit_a", 11), ("readmit_b", 13)):
            code, doc, headers = results[key]
            assert code == 200, (key, doc)
            assert doc["tokens"] == [expected_tokens(last, 120)]
            assert headers["X-Replica"] != "g1"
        snap = server.metrics.snapshot()
        assert snap["readmitted_total"] == 2, snap
        assert snap["stream_errors_total"] == 1, snap

        _until(lambda: server.router.routable_count() == 3,
               "fleet never recovered")
        code, doc, headers = _post(server.url + "/generate",
                                   {"prompt": [3], "max_tokens": 2})
        assert code == 200
    finally:
        _teardown(server, fleet)


# ===========================================================================
# rollouts
# ===========================================================================

def _traffic_lanes(url, n, failures, stop, rows=lambda lane: [[1.0,
                                                               1.0]]):
    def traffic(lane):
        while not stop.is_set():
            code, doc, headers = _post(url + "/apply",
                                       {"input": rows(lane)})
            if code != 200:
                failures.append((code, headers.get("X-Replica"),
                                 doc.get("error")))
            stop.wait(0.002)

    lanes = [threading.Thread(target=traffic, args=(i,))
             for i in range(n)]
    for t in lanes:
        t.start()
    return lanes


def _join_lanes(lanes, stop):
    stop.set()
    for t in lanes:
        t.join(timeout=30)


@pytest.mark.parametrize("poisoned", [True, False],
                         ids=["poisoned-canary-rolls-back",
                              "clean-rolls-one-at-a-time"])
def test_rollout(poisoned):
    """A canary swapped to poisoned weights trips the rollback on its
    counter spike with zero failed requests off the canary, and serves
    the old weights after; a clean rollout walks every replica canary
    first without a failed request, and the fleet answers from the new
    weights."""
    names = ["c0", "c1", "c2"]
    server, fleet = _fleet([_apply_replica(n) for n in names])
    failures, stop = [], threading.Event()
    lanes = _traffic_lanes(server.url, 4, failures, stop,
                           rows=lambda lane: [[1.0, float(lane)]])
    try:
        if poisoned:
            ok = fleet.rollout(make_engine=RaisingEngine, bake_s=15.0,
                               min_bad_events=3, spike_factor=3.0)
        else:
            ok = fleet.rollout(make_engine=lambda: StubEngine(scale=3.0),
                               bake_s=0.3)
        _join_lanes(lanes, stop)
        status = fleet.rollout_status()
        scale = 2.0 if poisoned else 3.0
        if poisoned:
            assert ok is False and status["state"] == "rolled_back"
            assert "c0" in status["reason"]
            assert [f for f in failures if f[1] != "c0"] == []
            assert failures, "the canary never saw the bad weights"
        else:
            assert ok is True and status["state"] == "done"
            assert status["completed"] == names
            assert failures == [], failures[:3]
        seen = {}
        _until(lambda: seen.update({h["X-Replica"]: d["output"]
                                    for c, d, h in [_post(
                                        server.url + "/apply",
                                        {"input": [[1.0, 2.0]]})]})
               or len(seen) == 3, "some replica never answered")
        for name, out in seen.items():
            np.testing.assert_allclose(out, [[scale, 2 * scale]],
                                       err_msg=name)
    finally:
        _join_lanes(lanes, stop)
        _teardown(server, fleet)


def test_streaming_pinned_replica_survives_rollout_of_others():
    server, fleet = _fleet([_gen_replica("s0", step=1, delay=0.008),
                            _gen_replica("s1", step=1),
                            _gen_replica("s2", step=1)])
    try:
        session = _pin_session(server.url, "pin", "s0", generative=True)
        records, first = [], threading.Event()

        def stream():
            records.extend(_stream_lines(
                server.url + "/generate",
                {"prompt": [30], "max_tokens": 80, "stream": True,
                 "session": session}, first=first))

        thread = threading.Thread(target=stream)
        thread.start()
        assert first.wait(WAIT_S)
        ok = fleet.rollout(make_engine=lambda: StubGenEngine(step=2),
                           replicas=["s1", "s2"], bake_s=0.2)
        assert ok is True
        thread.join(timeout=60)
        assert not thread.is_alive(), "pinned stream never finished"
        tokens = [r["token"] for r in records if "token" in r]
        assert tokens == expected_tokens(30, 80, step=1)
        assert records[-1].get("done") is True
        session1 = _pin_session(server.url, "rolled", "s1",
                                generative=True)
        code, doc, _ = _post(
            server.url + "/generate",
            {"prompt": [40], "max_tokens": 4, "session": session1})
        assert code == 200
        assert doc["tokens"] == [expected_tokens(40, 4, step=2)]
    finally:
        _teardown(server, fleet)


class _StubHandle:
    """Replica handle whose swap returns no rollback token (a process
    replica's first rollout) and whose counters spike after a swap."""

    def __init__(self, name, spike_after_swap=False):
        self.name = name
        self.address = "127.0.0.1:1"  # never dialed in this test
        self.alive = True
        self.swapped = []
        self.killed = False
        self.respawned = False
        self._spike = spike_after_swap

    def signals(self):
        return {"queue_depth": 0}

    def counters(self):
        bad = 50 if (self._spike and self.swapped) else 0
        return {"requests": 100, "bad": bad}

    def swap(self, new):
        self.swapped.append(new)
        return None

    def kill(self):
        self.killed = True

    def respawn(self):
        self.respawned = True
        self.swapped = []

    def stop(self):
        pass


def test_rollback_without_swap_token_respawns_canary():
    router = Router(health_interval_s=5.0)
    canary = _StubHandle("p0", spike_after_swap=True)
    other = _StubHandle("p1")
    fleet = FleetManager(router, replicas=[canary, other], respawn=False)
    try:
        ok = fleet.rollout(make_engine=lambda: "bad-weights",
                           bake_s=5.0, poll_s=0.01, min_bad_events=3,
                           spike_factor=3.0, drain_timeout_s=0.1)
        assert ok is False
        assert fleet.rollout_status()["state"] == "rolled_back"
        assert canary.killed and canary.respawned
        assert other.swapped == []
    finally:
        fleet.stop(stop_replicas=False)
        router.stop()


def test_autoscale_spawns_on_backlog_and_retires_when_idle():
    server, fleet = _fleet([_apply_replica("a0", delay=0.04)])
    spawned = []

    def spawn_fn():
        handle = _apply_replica("a%d" % (len(spawned) + 1), delay=0.04)
        spawned.append(handle)
        return handle

    stop = threading.Event()

    def flood():
        while not stop.is_set():
            try:
                _post(server.url + "/apply",
                      {"input": [[1.0, 1.0]] * 4}, timeout=60)
            except OSError:
                pass

    lanes = [threading.Thread(target=flood) for _ in range(12)]
    try:
        fleet.autoscale(spawn_fn, min_replicas=1, max_replicas=2,
                        high_queue=4.0, low_queue=0.5,
                        sustain_ticks=2, interval_s=0.05)
        for t in lanes:
            t.start()
        _until(lambda: len(fleet.handles()) == 2,
               "autoscale never spawned under backlog")
        _join_lanes(lanes, stop)
        _until(lambda: len(fleet.handles()) == 1,
               "autoscale never retired when idle")
        doc = fleet.status_doc()
        assert doc["autoscale"]["spawned"] >= 1
        assert doc["autoscale"]["retired"] >= 1
    finally:
        _join_lanes(lanes, stop)
        _teardown(server, fleet)
        for handle in spawned:
            handle.stop()


# ===========================================================================
# role-tagged discovery
# ===========================================================================

def test_mixed_beacons_roles_never_cross_match():
    import socket as socket_mod

    from veles_tpu_torch.distributed import discovery

    probe = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    kw = dict(port=port, interval=0.05, targets=["127.0.0.1"])
    announcers = [
        discovery.Announcer("127.0.0.1:6100", checksum="farm-a", **kw),
        discovery.Announcer("127.0.0.1:7100", checksum="fleet-b",
                            role="replica", **kw),
        discovery.Announcer("127.0.0.1:7101", checksum="fleet-b",
                            role="replica", **kw)]
    for a in announcers:
        a.start()
    try:
        assert discovery.discover_coordinator(
            timeout=10.0, port=port) == "127.0.0.1:6100"
        assert sorted(discovery.discover_replicas(
            timeout=10.0, port=port, expect=2)) == \
            ["127.0.0.1:7100", "127.0.0.1:7101"]
        assert discovery.discover_replicas(
            timeout=1.0, port=port, checksum="someone-else") == []
        junk = socket_mod.socket(socket_mod.AF_INET,
                                 socket_mod.SOCK_DGRAM)
        junk.sendto(json.dumps({
            "veles_tpu_coordinator": "garbage-no-port",
            "role": "replica"}).encode(), ("127.0.0.1", port))
        junk.close()
        found = discovery.discover_replicas(timeout=1.0, port=port,
                                            expect=3)
        assert "garbage-no-port" not in found
    finally:
        for a in announcers:
            a.stop()


def test_replica_beacon_payload_carries_role_and_serve_port():
    from veles_tpu_torch.distributed.discovery import Announcer
    payload = json.loads(Announcer("127.0.0.1:7007", checksum="x",
                                   role="replica").payload)
    assert payload["role"] == "replica"
    assert payload["serve_port"] == 7007
    payload = json.loads(Announcer("127.0.0.1:6006",
                                   checksum="x").payload)
    assert payload["role"] == "coordinator"
    with pytest.raises(ValueError):
        Announcer("127.0.0.1:1", checksum="x", role="gateway")


# ===========================================================================
# mixed fleet: a plain `--serve` replica of the command line next to an
# in-process one
# ===========================================================================

class StubMnistShim:
    """28 x 28 in, 10 out, so the in-process replica takes the mnist
    CLI replica's requests."""

    input_dtype = np.dtype(np.float32)
    compile_count = 0
    buckets = []

    def apply(self, x):
        x = np.asarray(x, np.float32).reshape(len(x), -1)
        logits = x[:, :10]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


def test_mixed_fleet_old_argv_replica_interops_with_new():
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    main = Main([
        "veles_tpu_torch/models/mnist.py", "-d", "cpu",
        "--serve", "127.0.0.1:0", "--serve-max-delay-ms", "1",
        "root.mnist.layers=(8, 10)",
        "root.mnist.loader_kwargs={'n_train': 60, 'n_valid': 20, "
        "'minibatch_size': 20}"])
    result = {}

    def body():
        try:
            result["rc"] = main.run()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            result["error"] = e

    thread = threading.Thread(target=body)
    thread.start()
    server = fleet = None
    try:
        _until(lambda: main.serve_server is not None or
               not thread.is_alive(), "the CLI replica never served",
               timeout=120)
        assert main.serve_server is not None, result
        old_addr = "%s:%d" % main.serve_server.endpoint
        new = LocalReplica(
            "new", StubMnistShim,
            batcher_kwargs={"max_batch": 8, "max_delay_ms": 1.0},
            watchdog_s=None)
        server = RouterServer(Router(health_interval_s=0.05))
        fleet = FleetManager(server.router, replicas=[new])
        server.router.add_replica(old_addr, name="old")
        _until(lambda: server.router.routable_count() == 2,
               "mixed fleet never routable")
        x = np.random.default_rng(3).random((2, 28, 28)).astype(
            np.float32)
        seen = set()
        for _ in range(32):
            code, doc, headers = _post(server.url + "/apply",
                                       {"input": x.tolist()})
            assert code == 200, doc
            assert np.asarray(doc["output"]).shape == (2, 10)
            seen.add(headers["X-Replica"])
            if seen == {"old", "new"}:
                break
        assert seen == {"old", "new"}
        states = server.router.states()
        assert states["old"]["healthy"] and states["new"]["healthy"]
    finally:
        if fleet is not None:
            fleet.stop()
        if server is not None:
            server.stop()
        main.stop_serving()
        thread.join(timeout=60)
        root.mnist = {}
    assert result.get("rc") == 0, result


# ===========================================================================
# parity with the reference
# ===========================================================================

SMALL = dict(vocab=64, embed=64, heads=2, layers=2, seq_len=64)


def _lm():
    from veles_tpu.models.transformer import TransformerConfig as JConfig
    from veles_tpu.models.transformer import init_params
    jconfig = JConfig(**SMALL, attention_impl="lax")
    return jconfig, init_params(jconfig, seed=5)


def test_router_greedy_tokens_equal_the_reference_engine():
    """Six prompts through the port's router over two replicas (2
    layers, f32): the port's GenerativeEngine and its paged engine, one
    prompt streamed, give the reference GenerativeEngine's greedy tokens
    token for token."""
    from veles_tpu.serve.engine import GenerativeEngine as JEngine
    from veles_tpu_torch.models.transformer import TransformerConfig
    from veles_tpu_torch.serve.engine import (GenerativeEngine,
                                              PagedGenerativeEngine)
    jconfig, params = _lm()
    config = TransformerConfig(**SMALL)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, SMALL["vocab"], n).astype(np.int32)
               for n in (3, 7, 12, 20, 5, 9)]
    want = [g.tolist() for g in JEngine(jconfig, params, max_slots=8)
            .generate(prompts, 12)]
    replicas = [
        LocalReplica("g0", lambda: GenerativeEngine(
            config, params, max_slots=4, device="cpu"),
            generative=True, watchdog_s=None),
        LocalReplica("g1", lambda: PagedGenerativeEngine(
            config, params, max_slots=4, page_size=16, n_pages=32,
            device="cpu"), generative=True, watchdog_s=None)]
    server, fleet = _fleet(replicas)
    try:
        got, seen = [], set()
        for i, prompt in enumerate(prompts[1:]):
            code, doc, headers = _post(
                server.url + "/generate",
                {"prompt": prompt.tolist(), "max_tokens": 12,
                 "session": "s%d" % i})
            assert code == 200, doc
            got.append(doc["tokens"][0])
            seen.add(headers["X-Replica"])
        records = list(_stream_lines(
            server.url + "/generate",
            {"prompt": prompts[0].tolist(), "max_tokens": 12,
             "stream": True}))
        assert records[-1]["done"] is True
        streamed = [r["token"] for r in records if "token" in r]
        assert [streamed] + got == want
        assert seen == {"g0", "g1"}
    finally:
        _teardown(server, fleet)


def test_router_apply_matches_the_reference_engine():
    """/apply through the port's router over two replicas of the
    port's InferenceEngine (the 10-class 64 x 64 AlexNet, f32) agrees
    with the reference engine within 1e-4 of the output's scale."""
    import veles_tpu.models.flagship as JF
    from veles_tpu.serve.engine import InferenceEngine as JEngine
    from veles_tpu_torch.serve.engine import InferenceEngine
    specs, params, _ = JF.alexnet_fused(n_classes=10, image_size=64)
    x = np.random.default_rng(5).random((3, 64, 64, 3),
                                        dtype=np.float32)
    want = JEngine.from_specs(specs, params).apply(x)
    replicas = [LocalReplica(
        name, lambda: InferenceEngine.from_specs(specs, params,
                                                 device="cpu"),
        batcher_kwargs={"max_batch": 4, "max_delay_ms": 1.0},
        watchdog_s=None) for name in ("a0", "a1")]
    server, fleet = _fleet(replicas)
    try:
        seen = set()
        for _ in range(4):
            code, doc, headers = _post(server.url + "/apply",
                                       {"input": x.tolist()})
            assert code == 200, doc
            out = np.asarray(doc["output"])
            assert out.shape == (3, 10)
            assert np.abs(out - want).max() / np.abs(want).max() <= 1e-4
            seen.add(headers["X-Replica"])
        assert seen == {"a0", "a1"}
    finally:
        _teardown(server, fleet)


def _wire_transcript(router_mod, fleet_mod, plan_cls):
    """One fleet conversation: the exchanges' status codes, bodies and
    the fleet headers that came back (ticket ids by presence). An
    ``/apply`` fleet of two replicas and a ``/generate`` fleet of one,
    each behind its own router."""
    routers = [router_mod.RouterServer(router_mod.Router(
        health_interval_s=0.05)) for _ in range(2)]
    apply_url, gen_url = routers[0].url, routers[1].url
    fleets = [
        fleet_mod.FleetManager(routers[0].router, replicas=[
            fleet_mod.LocalReplica(
                name, StubEngine, batcher_kwargs={"max_batch": 8,
                                                  "max_delay_ms": 1.0},
                watchdog_s=None) for name in ("r0", "r1")]),
        fleet_mod.FleetManager(routers[1].router, replicas=[
            fleet_mod.LocalReplica("g0", StubGenEngine, generative=True,
                                   watchdog_s=None)])]
    out = []

    def record(code, doc, headers):
        out.append((code, doc, sorted(
            k for k in ("X-Replica", "X-Ticket-Id", "Retry-After")
            if k in headers), headers.get("X-Replica")))

    try:
        for server, n in zip(routers, (2, 1)):
            _until(lambda: server.router.routable_count() == n,
                   "never routable")
        session = _pin_session(apply_url, "w", "r0")
        record(*_post(apply_url + "/apply",
                      {"input": [[1.0, 2.0]], "session": session}))
        record(*_post(apply_url + "/apply",
                      {"input": [[1.0]], "deadline_ms": [50]}))
        code, body, headers = _get(apply_url + "/nothing")
        out.append((code, json.loads(body)))
        record(*_post(gen_url + "/generate",
                      {"prompt": [4], "max_tokens": 3}))
        out.append(list(_stream_lines(
            gen_url + "/generate",
            {"prompt": [4], "max_tokens": 3, "stream": True})))
        fleets[0].arm_faults(plan_cls("kill-replica@0"))
        record(*_post(apply_url + "/apply",
                      {"input": [[2.0, 3.0]], "session": session}))
        snap = routers[0].metrics.snapshot()
        counters = (snap["readmitted_total"], snap["failovers_total"])
        code, body, _ = _get(apply_url + "/healthz")
        doc = json.loads(body)
        out.append((code, doc["role"], doc["replicas"]))
    finally:
        for fleet, server in zip(fleets, routers):
            fleet.stop()
            server.stop()
    return out, counters


def test_wire_interop_both_ways():
    """The reference's RouterServer in front of port replicas, and the
    port's in front of reference replicas, route, fail over and stream
    with the same JSON bodies, headers and status codes as the port in
    front of its own."""
    import veles_tpu.distributed.faults as R_faults
    import veles_tpu.serve.fleet as R_fleet
    import veles_tpu.serve.router as R_router
    import veles_tpu_torch.serve.fleet as P_fleet
    import veles_tpu_torch.serve.router as P_router
    port_port, counters = _wire_transcript(P_router, P_fleet, FaultPlan)
    ref_port, _ = _wire_transcript(R_router, P_fleet, FaultPlan)
    port_ref, ref_counters = _wire_transcript(P_router, R_fleet,
                                              R_faults.FaultPlan)
    assert ref_port == port_port
    assert port_ref == port_port
    assert port_port[0][:2] == (200, {"output": [[2.0, 4.0]]})
    assert port_port[1][0] == 400
    assert port_port[-2][3] == "r1"      # failed over to the sibling
    # the port's router re-admits exactly once, whichever replicas
    # (the reference's may answer the kill as a drain: no counter
    # here, see _forward_once)
    assert counters == ref_counters == (1, 1)


# ===========================================================================
# the replica server's fleet hooks
# ===========================================================================

def test_kill_severs_a_live_connection():
    """A streaming client mid-reply sees its connection severed, never
    a clean end of stream."""
    registry = ModelRegistry()
    registry.add_generative("lm", StubGenEngine(delay=0.02))
    server = ServeServer(registry, watchdog_s=None)
    first = threading.Event()
    outcome = {}

    def client():
        try:
            outcome["records"] = list(_stream_lines(
                server.url, {"prompt": [1], "max_tokens": 200,
                             "stream": True}, first=first))
        except BaseException as e:  # noqa: BLE001 — recorded
            outcome["error"] = e

    thread = threading.Thread(target=client)
    thread.start()
    try:
        assert first.wait(WAIT_S)
        server.kill()
        thread.join(timeout=WAIT_S)
        assert not thread.is_alive()
        records = outcome.get("records")
        assert "error" in outcome or not records[-1].get("done"), \
            outcome
        with pytest.raises(OSError):
            http.client.HTTPConnection(*server.endpoint,
                                       timeout=5).request("GET",
                                                          "/healthz")
    finally:
        server.stop(drain=False, timeout=5)


def test_blackhole_holds_then_drops():
    registry = ModelRegistry()
    registry.add("m", StubEngine())
    server = ServeServer(registry, watchdog_s=None)
    try:
        server.blackhole(0.3)
        conn = http.client.HTTPConnection(*server.endpoint, timeout=10)
        t0 = time.monotonic()
        with pytest.raises((http.client.RemoteDisconnected,
                            ConnectionError)):
            conn.request("GET", "/healthz")
            conn.getresponse()
        assert time.monotonic() - t0 >= 0.3
        conn.close()
        code, _, _ = _get("http://%s:%d/healthz" % server.endpoint)
        assert code == 200
    finally:
        server.stop()


def test_default_deadline_applies_to_a_request_without_one():
    seen = []

    def submit(batch, timeout=30.0):
        seen.append(timeout)  # a callable model's deadline is its timeout
        return batch

    registry = ModelRegistry()
    registry.add_callable("m", submit)
    server = ServeServer(registry, watchdog_s=None,
                         default_deadline_ms=250.0)
    base = "http://%s:%d/apply" % server.endpoint
    try:
        assert _post(base, {"input": [[1.0]]})[0] == 200
        assert _post(base, {"input": [[1.0]]},
                     headers={"X-Deadline-Ms": "900"})[0] == 200
        assert _post(base, {"input": [[1.0]], "deadline_ms": 40})[0] \
            == 200
        assert seen == [0.25, 0.9, 0.04]
    finally:
        server.stop()


def _package_of(path, scale):
    """A package archive (the reference's layout) of one identity-sized
    FC layer times ``scale``: [[x]] -> [[scale * x]]."""
    from veles_tpu_torch.aot.package import write_package
    contents = {"workflow": "Scaled", "checksum": "", "precision":
                "float32", "units": [{
                    "class": "All2All", "uuid": "veles.tpu.all2all",
                    "name": "fc", "properties": {"activation": "linear"},
                    "arrays": {"weights": "0000_weights.npy",
                               "bias": "0001_bias.npy"}}]}
    write_package(path, contents, [
        ("0000_weights.npy", np.full((1, 1), scale, np.float32)),
        ("0001_bias.npy", np.zeros(1, np.float32))])
    return path


@pytest.mark.parametrize("admin", [False, True])
def test_admin_swap_is_off_by_default_and_swaps_a_package(admin, tmp_path):
    """Off: 404 and the engine stays. On: the package's engine is built
    on the served engine's device, warmed over its buckets, and
    answers the next request; a broken package answers 500 and the
    served engine stays."""
    from veles_tpu_torch.serve.engine import InferenceEngine
    registry = ModelRegistry()
    engine = InferenceEngine.from_package(
        _package_of(str(tmp_path / "two.zip"), 2.0), device="cpu")
    registry.add("m", engine)
    server = ServeServer(registry, watchdog_s=None, admin_swap=admin)
    url = "http://%s:%d" % server.endpoint
    try:
        assert _post(url + "/apply", {"input": [[1.0]]})[1] == \
            {"output": [[2.0]]}
        code, doc, _ = _post(url + "/admin/swap", {"package": _package_of(
            str(tmp_path / "three.zip"), 3.0)})
        if admin:
            assert code == 200 and doc["swapped"] == "m"
            swapped = registry.get("m").engine
            assert swapped is not engine and swapped.buckets == [1]
            assert _post(url + "/apply", {"input": [[1.0]]})[1] == \
                {"output": [[3.0]]}
            code, doc, _ = _post(url + "/admin/swap",
                                 {"package": "/nonexistent.zip"})
            assert code == 500 and doc["error"].startswith("swap failed")
            assert registry.get("m").engine is swapped
        else:
            assert code == 404
            assert _post(url + "/apply", {"input": [[1.0]]})[1] == \
                {"output": [[2.0]]}
    finally:
        server.stop()


def test_rollout_of_a_package_over_local_replicas(tmp_path):
    """``rollout(package=)`` over in-process replicas: each swaps in the
    package's engine (on its engine's device, warmed over its buckets),
    canary first, and the fleet answers from the new weights."""
    from veles_tpu_torch.serve.engine import InferenceEngine
    two = _package_of(str(tmp_path / "two.zip"), 2.0)
    three = _package_of(str(tmp_path / "three.zip"), 3.0)
    names = ["p0", "p1"]
    server, fleet = _fleet([LocalReplica(
        name, lambda: InferenceEngine.from_package(two, device="cpu"),
        batcher_kwargs={"max_batch": 8, "max_delay_ms": 1.0},
        watchdog_s=None) for name in names])
    try:
        assert _post(server.url + "/apply", {"input": [[1.0]]})[1] == \
            {"output": [[2.0]]}
        assert fleet.rollout(package=three, bake_s=0.2) is True
        assert fleet.rollout_status()["completed"] == names
        seen = {}
        _until(lambda: seen.update({h["X-Replica"]: d["output"]
                                    for c, d, h in [_post(
                                        server.url + "/apply",
                                        {"input": [[1.0]]})]})
               or len(seen) == 2, "some replica never answered")
        assert seen == {name: [[3.0]] for name in names}
        for name in names:
            engine = fleet.handle(name).registry.get("default").engine
            assert engine.device == torch.device("cpu")
    finally:
        _teardown(server, fleet)
