"""The port's forward serving plane around the engine: ``MicroBatcher``
(ticket routing, deadlines, shedding, quiet close, poison isolation),
``ServeMetrics``, ``most_urgent_budget_ms``, the registry's forward
entries and ``POST /apply`` through ``ServeServer``. The cases mirror
the JAX package's ``tests/test_serve.py``; the batcher and the HTTP
front are host code, so a stub engine stands in where the reference's
tests use one, and a real ``InferenceEngine`` where they check
outputs (against the JAX package's engine, f32, 1e-4 relative)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from veles_tpu.serve.engine import InferenceEngine as JEngine
from veles_tpu_torch.models.transformer import TransformerConfig
from veles_tpu_torch.serve import (DeadlineExceeded, GenerativeEngine,
                                   InferenceEngine, MicroBatcher,
                                   ModelRegistry, PoisonedRequest,
                                   QueueFull, ServeMetrics, ServeServer,
                                   Shed)
from veles_tpu_torch.serve.batcher import most_urgent_budget_ms

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)


class StubEngine:
    """Row-aligned fake: ``apply = scale * x`` with an optional delay;
    records every dispatched batch size."""

    input_dtype = np.dtype(np.float32)

    def __init__(self, scale=2.0, delay=0.0):
        self.scale = scale
        self.delay = delay
        self.calls = []
        self.compile_count = 0
        self.buckets = []

    def apply(self, x):
        self.calls.append(len(x))
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(x, dtype=np.float32) * self.scale


class PoisonableEngine(StubEngine):
    """A batch holding a NaN row fails whole, as a compiled batch
    would."""

    def apply(self, x):
        if np.isnan(np.asarray(x)).any():
            self.calls.append(len(x))
            raise RuntimeError("non-finite input row")
        return super().apply(x)


def _post(url, doc, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _concurrently(fn, args):
    threads = [threading.Thread(target=fn, args=a) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


# -- the batcher: ticket routing -------------------------------------------

def test_batcher_merges_concurrent_requests():
    """4 x 2-row requests close as ONE full 8-row batch (the early
    close disabled, so the merge is deterministic)."""
    stub = StubEngine()
    batcher = MicroBatcher(stub, max_batch=8, max_delay_ms=2000,
                           quiet_ms=2000)
    try:
        rng = np.random.default_rng(5)
        inputs = [rng.random((2, 3), dtype=np.float32) for _ in range(4)]
        outs = [None] * 4

        def client(i):
            outs[i] = batcher.submit(inputs[i], timeout=30)

        _concurrently(client, [(i,) for i in range(4)])
        for i in range(4):
            np.testing.assert_allclose(outs[i], inputs[i] * 2.0)
        assert stub.calls == [8]
        snap = batcher.metrics.snapshot()
        assert snap["batch_size_histogram"]["8"] == 1
        assert snap["requests_total"] == 4 and snap["rows_total"] == 8
    finally:
        batcher.stop()


def test_batcher_splits_and_routes_mixed_sizes_and_shapes():
    """A 9-row request splits across dispatches and reassembles in
    order; concurrent sizes route back to their tickets; another
    trailing shape runs as its own group and the thread survives."""
    stub = StubEngine()
    batcher = MicroBatcher(stub, max_batch=8, max_delay_ms=5)
    try:
        x = np.arange(27, dtype=np.float32).reshape(9, 3)
        np.testing.assert_allclose(batcher.submit(x, timeout=30), x * 2)
        assert stub.calls[0] == 8 and sum(stub.calls) == 9
        rng = np.random.default_rng(6)
        sizes = [1, 3, 5, 9, 2, 8, 4, 1]
        inputs = [rng.random((s, 4), dtype=np.float32) for s in sizes]
        inputs.append(np.ones((2, 5), np.float32))
        outs = [None] * len(inputs)

        def client(i):
            outs[i] = batcher.submit(inputs[i], timeout=30)

        _concurrently(client, [(i,) for i in range(len(inputs))])
        for i, x in enumerate(inputs):
            np.testing.assert_allclose(outs[i], x * 2.0,
                                       err_msg="request %d" % i)
        assert max(stub.calls) <= 8
        assert sum(stub.calls) == 9 + sum(sizes) + 2
    finally:
        batcher.stop()


def test_batcher_admission_control_and_errors():
    """Beyond max_queue_rows submit raises QueueFull at once; an engine
    error reaches the submitter; bad priorities and batches raise."""
    stub = StubEngine(delay=0.5)
    batcher = MicroBatcher(stub, max_batch=2, max_delay_ms=1,
                           max_queue_rows=4)
    try:
        filler = threading.Thread(target=lambda: batcher.submit(
            np.zeros((2, 3), np.float32), timeout=30))
        filler.start()
        time.sleep(0.2)                 # the filler's rows are on device
        queued = threading.Thread(target=lambda: batcher.submit(
            np.zeros((4, 3), np.float32), timeout=30))
        queued.start()
        time.sleep(0.1)
        with pytest.raises(QueueFull) as exc:
            batcher.submit(np.zeros((1, 3), np.float32), timeout=5)
        assert exc.value.retry_after > 0
        assert batcher.metrics.snapshot()["rejected_total"] == 1
        filler.join(timeout=30)
        queued.join(timeout=30)
        with pytest.raises(ValueError, match="priority"):
            batcher.submit(np.ones((1, 3), np.float32), priority="x")
        with pytest.raises(ValueError, match="non-empty"):
            batcher.submit(np.ones(3, np.float32))
    finally:
        batcher.stop()

    class Exploding(StubEngine):
        def apply(self, x):
            raise RuntimeError("boom")

    batcher = MicroBatcher(Exploding(), max_batch=4, max_delay_ms=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.submit(np.zeros((1, 3), np.float32), timeout=10)
        assert batcher.metrics.snapshot()["errors_total"] == 1
    finally:
        batcher.stop()


# -- the batcher: deadlines, shedding, poison ------------------------------

def test_expired_and_orphaned_tickets_never_reach_the_device():
    """A ticket whose deadline passes while queued, and one whose
    client timed out, are dropped whole at batch formation."""
    for kwargs, error in ((dict(deadline_ms=50), DeadlineExceeded),
                          (dict(timeout=0.05), TimeoutError)):
        stub = StubEngine(delay=0.25)
        batcher = MicroBatcher(stub, max_batch=4, max_delay_ms=1)
        try:
            occupier = threading.Thread(target=lambda: batcher.submit(
                np.ones((1, 2), np.float32), timeout=10))
            occupier.start()
            time.sleep(0.08)                # the occupier is on device
            with pytest.raises(error):
                batcher.submit(np.full((2, 2), 5.0, np.float32),
                               **dict(dict(timeout=10), **kwargs))
            occupier.join(timeout=10)
            time.sleep(0.3)                 # a stray dispatch lands now
            assert sum(stub.calls) == 1
            assert batcher.metrics.expired_total == 1
        finally:
            batcher.stop(drain=False)


def test_shed_on_arrival_and_batch_class_first():
    """A request that cannot make its deadline is refused on arrival
    with a Retry-After from the drain rate; batch-class traffic sheds
    once the queue passes its fraction, interactive does not."""
    stub = StubEngine(delay=0.1)
    batcher = MicroBatcher(stub, max_batch=8, max_delay_ms=1,
                           max_queue_rows=4096)
    try:
        assert batcher.eta_seconds() is None
        batcher.submit(np.ones((8, 2), np.float32), timeout=10)
        assert batcher.eta_seconds() is not None
        assert batcher.drain_rate_rows_per_s > 0
        backlog = [threading.Thread(target=lambda: batcher.submit(
            np.ones((8, 2), np.float32), timeout=30)) for _ in range(3)]
        for t in backlog:
            t.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        with pytest.raises(Shed) as exc:
            batcher.submit(np.ones((1, 2), np.float32), timeout=10,
                           deadline_ms=30)
        assert time.monotonic() - t0 < 0.05
        assert exc.value.retry_after > 0
        assert batcher.metrics.shed_total == 1
        assert batcher.submit(np.ones((1, 2), np.float32),
                              timeout=30).shape == (1, 2)
        for t in backlog:
            t.join(timeout=30)
    finally:
        batcher.stop()

    stub = StubEngine(delay=0.06)
    batcher = MicroBatcher(stub, max_batch=4, max_delay_ms=1,
                           max_queue_rows=16, batch_class_frac=0.25)
    try:
        blocker = threading.Thread(target=lambda: batcher.submit(
            np.ones((12, 2), np.float32), timeout=30))
        blocker.start()
        time.sleep(0.03)            # 4 rows on the device, 8 queued
        with pytest.raises(Shed):
            batcher.submit(np.ones((1, 2), np.float32), timeout=10,
                           priority="batch")
        assert batcher.submit(np.ones((1, 2), np.float32), timeout=30,
                              priority="interactive").shape == (1, 2)
        blocker.join(timeout=30)
        # occupancy, not occupancy + request: an idle queue admits a
        # batch-class request larger than the headroom
        assert batcher.submit(np.ones((8, 2), np.float32), timeout=30,
                              priority="batch").shape == (8, 2)
    finally:
        batcher.stop()


def test_poison_bisection_isolates_the_offending_rows():
    stub = PoisonableEngine()
    batcher = MicroBatcher(stub, max_batch=8, max_delay_ms=25)
    clean_a = np.ones((3, 2), np.float32)
    poisoned = np.ones((2, 2), np.float32)
    poisoned[1, 0] = np.nan
    clean_b = np.full((1, 2), 3.0, np.float32)
    results = {}

    def submit(key, arr):
        try:
            results[key] = batcher.submit(arr, timeout=30)
        except BaseException as e:  # noqa: BLE001 — under test
            results[key] = e

    try:
        _concurrently(submit, [("a", clean_a), ("bad", poisoned),
                               ("b", clean_b)])
        np.testing.assert_allclose(results["a"], clean_a * 2.0)
        np.testing.assert_allclose(results["b"], clean_b * 2.0)
        assert isinstance(results["bad"], PoisonedRequest)
        assert isinstance(results["bad"].__cause__, RuntimeError)
        assert batcher.metrics.poisoned_total == 1
        np.testing.assert_allclose(batcher.submit(
            np.ones((2, 2), np.float32), timeout=10), 2.0)
    finally:
        batcher.stop()


def test_most_urgent_budget_and_serve_metrics():
    class T:
        def __init__(self, deadline):
            self.deadline = deadline

    now = time.monotonic()
    assert most_urgent_budget_ms([T(None), T(None)]) is None
    urgent = most_urgent_budget_ms([T(now + 5.0), T(None), T(now + 0.5)])
    assert 0.0 < urgent <= 500.0
    assert most_urgent_budget_ms([T(now - 1.0), T(now + 2.0)]) == 0.0
    metrics = ServeMetrics()
    for rows in (1, 3, 2000):
        metrics.observe_batch(rows)
    metrics.observe_request(0.01, 3)
    metrics.observe_shed()
    metrics.observe_poisoned(2)
    snap = metrics.snapshot(queue_depth=7)
    assert snap["dispatches_total"] == 3 and snap["batch_size_overflow"] == 1
    assert snap["batch_size_histogram"]["1"] == 1
    assert snap["batch_size_histogram"]["4"] == 1
    assert snap["shed_total"] == 1 and snap["poisoned_total"] == 2
    assert snap["queue_depth"] == 7 and snap["qps"] > 0
    assert set(snap["latency_ms"]) == {"p50", "p95", "p99"}
    text = metrics.prometheus_text("m", 7)
    assert 'veles_serve_batch_size_bucket{model="m",le="+Inf"} 3' in text
    assert 'veles_serve_queue_depth{model="m"} 7' in text


# -- the registry ----------------------------------------------------------

def test_registry_forward_entries_swap_and_remove():
    a, b = StubEngine(scale=1.0), StubEngine(scale=3.0)
    registry = ModelRegistry()
    model = registry.add("m", a, max_batch=4, max_delay_ms=1)
    registry.add_callable("legacy", lambda x, timeout: np.asarray(x) + 1)
    try:
        assert registry.default_name == "m"
        assert registry.queue_depth() == 0
        x = np.ones((1, 3), np.float32)
        np.testing.assert_allclose(model.submit(x), x)
        registry.swap("m", b)
        np.testing.assert_allclose(registry.get("m").submit(x), 3 * x)
        np.testing.assert_allclose(registry.get("legacy").submit(x), x + 1)
        with pytest.raises(TypeError, match="swappable"):
            registry.swap("legacy", a)
        with pytest.raises(ValueError, match="already registered"):
            registry.add("m", a)
        snap = registry.metrics_snapshot()
        assert snap["m"]["requests_total"] == 2
        assert snap["legacy"]["requests_total"] == 1
        text = registry.prometheus_text()
        assert text.count("# TYPE veles_serve_qps gauge") == 1
        assert 'veles_serve_qps{model="legacy"}' in text
        registry.remove("m")
        assert registry.default_name == "legacy"
        assert registry.names() == ["legacy"]
    finally:
        registry.stop_all()


# -- POST /apply ------------------------------------------------------------

def _mlp_params(seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((6, 8)).astype(np.float32) / 3,
             "b": np.zeros(8, np.float32)},
            {"w": rng.standard_normal((8, 4)).astype(np.float32) / 3,
             "b": np.zeros(4, np.float32)}]


def test_http_apply_serves_the_engine_like_the_reference():
    """200 with the reference engine's outputs (default model and by
    name), 404 for an unknown model or path, 400 for a malformed body
    and for a model that serves /generate, compile_count on
    /metrics."""
    specs = [("fc", "tanh"), ("fc", "softmax")]
    registry = ModelRegistry()
    for name, seed in (("mlp", 1), ("other", 2)):
        engine = InferenceEngine.from_specs(specs, _mlp_params(seed),
                                            device="cpu")
        engine.warmup((6,), 8)
        registry.add(name, engine, max_delay_ms=1)
    lm = TransformerConfig(vocab=16, embed=16, heads=2, layers=1,
                           seq_len=8)
    from veles_tpu_torch.models.transformer import init_params
    registry.add_generative("lm", GenerativeEngine(
        lm, init_params(lm), max_slots=1, device="cpu"))
    server = ServeServer(registry, port=0)
    base = "http://%s:%d" % server.endpoint
    x = np.random.default_rng(3).random((5, 6), dtype=np.float32)
    try:
        for path, seed in (("/apply", 1), ("/apply/other", 2)):
            code, doc, _ = _post(base + path, {"input": x.tolist()})
            assert code == 200
            ref = JEngine.from_specs(specs, _mlp_params(seed)).apply(x)
            np.testing.assert_allclose(doc["output"], ref, rtol=1e-4,
                                       atol=1e-6)
        for bad in ([], [1.0, 2.0], "nope"):
            assert _post(base + "/apply", {"input": bad})[0] == 400
        assert _post(base + "/apply", {"wrong_key": []})[0] == 400
        assert _post(base + "/apply", {"input": x.tolist(),
                                       "deadline_ms": "soon"})[0] == 400
        assert _post(base + "/apply", {"input": x.tolist(),
                                       "priority": "nope"})[0] == 400
        code, doc, _ = _post(base + "/apply/lm", {"input": [[1]]})
        assert code == 400 and "/generate" in doc["error"]
        code, doc, _ = _post(base + "/generate/mlp", {"prompt": [1]})
        assert code == 400 and "not generative" in doc["error"]
        assert _post(base + "/apply/nosuch", {"input": [[1.0]]})[0] == 404
        assert _post(base + "/other", {"input": [[1.0]]})[0] == 404
        code, body = _get(base + "/metrics")
        snap = json.loads(body)["mlp"]
        assert snap["compile_count"] == 4 and snap["buckets"] == [1, 2, 4, 8]
        assert snap["requests_total"] == 1
        code, body = _get(base + "/metrics?format=prometheus")
        assert 'veles_serve_requests_total{model="mlp"} 1' in body.decode()
    finally:
        server.stop(drain=False)


def test_http_apply_takes_raw_rows():
    """An ``application/octet-stream`` body (the rows' f32 bytes, their
    shape in ``X-Shape``, the deadline in ``X-Deadline-Ms``) is answered
    bitwise as its JSON twin; 400 without a shape or with bytes that do
    not fill it."""
    engine = InferenceEngine.from_specs([("fc", "tanh"), ("fc", "softmax")],
                                        _mlp_params(1), device="cpu")
    registry = ModelRegistry()
    registry.add("mlp", engine, max_delay_ms=1)
    server = ServeServer(registry, port=0)
    url = "http://%s:%d/apply" % server.endpoint
    x = np.random.default_rng(4).random((3, 6), dtype=np.float32)

    def post_raw(body, headers):
        req = urllib.request.Request(url, data=body, headers=dict(
            headers, **{"Content-Type": "application/octet-stream"}))
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.load(resp)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    try:
        code, doc = post_raw(x.tobytes(), {"X-Shape": "3,6",
                                           "X-Deadline-Ms": "30000"})
        assert code == 200
        want = _post(url, {"input": x.tolist()})[1]["output"]
        assert np.array_equal(np.asarray(doc["output"], np.float32),
                              np.asarray(want, np.float32))
        assert post_raw(x.tobytes(), {})[0] == 400
        assert post_raw(x.tobytes()[:-4], {"X-Shape": "3,6"})[0] == 400
        assert post_raw(x.tobytes(), {"X-Shape": "3,x"})[0] == 400
    finally:
        server.stop(drain=False)


def test_http_apply_poison_deadline_and_drain():
    """422 for this request's poisoned row (its clean co-row served),
    500 for a lone failing row, 504 for a deadline that passes while
    queued, 503 with Retry-After once the server drains."""
    stub = PoisonableEngine(delay=0.2)
    registry = ModelRegistry()
    registry.add("default", stub, max_batch=4, max_delay_ms=1)
    server = ServeServer(registry, port=0)
    url = "http://%s:%d/apply" % server.endpoint
    try:
        occupier = threading.Thread(target=lambda: _post(
            url, {"input": [[9.0, 9.0]] * 4}))
        occupier.start()
        time.sleep(0.08)
        code, doc, _ = _post(url, {"input": [[1.0, 2.0]],
                                   "deadline_ms": 40})
        assert code == 504 and "deadline" in doc["error"]
        occupier.join(timeout=30)
        code, doc, _ = _post(url, {"input": [[1.0, 1.0],
                                             [1.0, float("nan")]]})
        assert code == 422 and "poisoned" in doc["error"]
        code, doc, _ = _post(url, {"input": [[1.0, float("nan")]]})
        assert code == 500
        assert _post(url, {"input": [[1.0, 2.0]]})[0] == 200
        server.begin_drain()
        code, doc, headers = _post(url, {"input": [[1.0, 2.0]]})
        assert code == 503 and headers.get("Retry-After")
        assert _get("http://%s:%d/healthz" % server.endpoint)[0] == 503
    finally:
        server.stop(drain=False)
