"""Port parity of the serving plane: ``veles_tpu_torch.serve``
(GenerativeEngine, TokenBatcher, ModelRegistry, ServeServer) on the
CPU against the JAX package's ``GenerativeEngine`` on the same
numpy-seeded weights. The bar is exactness: greedy tokens are
compared token for token (f32)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from veles_tpu.models.transformer import TransformerConfig as JConfig
from veles_tpu.models.transformer import init_params
from veles_tpu.serve.engine import GenerativeEngine as JEngine
from veles_tpu_torch.models.transformer import TransformerConfig
from veles_tpu_torch.serve import (GenerativeEngine, ModelRegistry,
                                   NonFiniteLogits, QueueFull,
                                   ServeServer, TokenBatcher)

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=64, embed=64, heads=2, layers=2, seq_len=64)
CONFIG = TransformerConfig(**SMALL)
JCONFIG = JConfig(**SMALL, attention_impl="lax")
PARAMS = init_params(JCONFIG, seed=5)


def _engine(**kw):
    return GenerativeEngine(CONFIG, PARAMS, device="cpu", **kw)


def _jax_generate(prompts, n, eos=None, slots=4):
    engine = JEngine(JCONFIG, PARAMS, max_slots=slots)
    return [g.tolist() for g in engine.generate(prompts, n, eos=eos)]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMALL["vocab"], n).astype(np.int32)
            for n in lens]


def test_engine_generate_matches_jax_engine():
    prompts = _prompts(1, (3, 7, 12, 20))
    engine = _engine(max_slots=4)
    got = [g.tolist() for g in engine.generate(prompts, 24)]
    assert got == _jax_generate(prompts, 24)
    assert engine.free_slots == 4 and engine.active_slots == 0
    # one (4, 32) prefill bucket + one decode step, as the reference
    assert engine.compile_count == 2
    assert engine.prefill_buckets == [(4, 32)]


def test_engine_eos_stops_early_like_jax():
    prompt = [np.asarray([1, 2, 3], np.int32)]
    full = _jax_generate(prompt, 10)[0]
    eos = full[4]
    engine = _engine(max_slots=2)
    got = engine.generate(prompt, 10, eos=eos)[0].tolist()
    assert got == _jax_generate(prompt, 10, eos=eos)[0]
    assert got == full[:full.index(eos) + 1]
    assert engine.free_slots == 2


def test_engine_slot_reuse_matches_jax():
    """Freed slots are reallocated and fully overwritten: three waves
    through the same two slots give the JAX engine's tokens."""
    engine = _engine(max_slots=2)
    for wave in range(3):
        prompts = _prompts(10 + wave, (4 + wave, 6))
        got = [g.tolist() for g in engine.generate(prompts, 6)]
        assert got == _jax_generate(prompts, 6, slots=2), "wave %d" % wave
    assert engine.free_slots == 2


def test_engine_admit_over_capacity_raises():
    engine = _engine(max_slots=2)
    with pytest.raises(ValueError, match="free slots"):
        engine.admit([np.asarray([1, 2], np.int32)] * 3)
    with pytest.raises(ValueError, match="max_len"):
        engine.admit([np.arange(SMALL["seq_len"] + 1, dtype=np.int32)])
    with pytest.raises(ValueError, match="empty"):
        engine.admit([np.asarray([], np.int32)])
    assert engine.free_slots == 2


def test_sentinel_flags_only_the_injected_slot():
    engine = _engine(max_slots=3)
    slots, _ = engine.admit(_prompts(2, (4, 5, 6)))
    engine.decode_fault_hook = lambda step: [slots[1]] if step == 1 else []
    engine.decode()
    assert engine.last_finite.all()
    engine.decode()
    flags = engine.last_finite
    assert not flags[slots[1]]
    assert flags[slots[0]] and flags[slots[2]]


def test_engine_swap_params_and_warm():
    other = init_params(JCONFIG, seed=11)
    prompt = [np.asarray([4, 9, 2], np.int32)]
    engine = _engine(max_slots=2, max_len=16)
    assert engine.warm() == engine.compile_count == 2 * 2 + 1
    engine.swap_params(other)
    got = engine.generate(prompt, 8)[0].tolist()
    ref = JEngine(JCONFIG, other, max_slots=2).generate(prompt, 8)
    assert got == ref[0].tolist()
    with pytest.raises(ValueError):
        engine.swap_params(init_params(JConfig(**dict(SMALL, layers=1)),
                                       seed=0))


def test_token_batcher_join_leave_matches_jax():
    """More concurrent clients than slots: requests join the running
    batch as slots free mid-flight; every reply equals the JAX
    engine's tokens and the engine ends empty."""
    engine = _engine(max_slots=3)
    batcher = TokenBatcher(engine)
    n_clients = 7
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, SMALL["vocab"], int(rng.integers(2, 10)))
               .astype(np.int32) for _ in range(n_clients)]
    lengths = [int(rng.integers(3, 9)) for _ in range(n_clients)]
    results = [None] * n_clients

    def client(i):
        try:
            results[i] = batcher.submit(prompts[i], max_tokens=lengths[i],
                                        timeout=120)
        except BaseException as e:  # noqa: BLE001
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(n_clients):
            assert isinstance(results[i], np.ndarray), results[i]
            assert results[i].tolist() == _jax_generate(
                [prompts[i]], lengths[i])[0], "client %d" % i
        assert engine.active_slots == 0 and engine.free_slots == 3
        snap = batcher.metrics.snapshot(engine=engine)
        assert snap["requests_total"] == n_clients
        assert snap["tokens_total"] == sum(lengths)
        assert snap["decode_steps_total"] > 0
    finally:
        batcher.stop()


def test_token_batcher_admission_and_sentinel():
    engine = _engine(max_slots=1)
    batcher = TokenBatcher(engine, max_queue=1)
    try:
        with pytest.raises(ValueError, match="max_len"):
            batcher.submit(np.arange(60, dtype=np.int32), max_tokens=30)
        with pytest.raises(ValueError, match="greedy-only"):
            batcher.submit(np.asarray([1], np.int32), temperature=0.5)
        engine.decode_fault_hook = lambda step: [0]
        with pytest.raises(NonFiniteLogits):
            batcher.submit(np.asarray([1, 2], np.int32), max_tokens=4,
                           timeout=60)
        engine.decode_fault_hook = None
        assert batcher.submit(np.asarray([1, 2], np.int32),
                              max_tokens=3, timeout=60).size == 3
        assert engine.free_slots == 1
        assert batcher.metrics.snapshot()["nonfinite_total"] == 1
        stream = batcher.stream(np.asarray([3], np.int32), max_tokens=60)
        next(stream)  # slot held, decoding
        deadline = time.monotonic() + 30
        rejected = False
        while not rejected and time.monotonic() < deadline:
            try:
                batcher.submit(np.asarray([2], np.int32), max_tokens=1,
                               timeout=0.01)
            except QueueFull:
                rejected = True
            except TimeoutError:
                pass
        stream.close()
        assert rejected, "bounded queue never rejected"
    finally:
        batcher.stop()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_server_generate_plain_and_stream_match_jax():
    registry = ModelRegistry()
    registry.add_generative("lm", _engine(max_slots=2))
    server = ServeServer(registry, port=0)
    base = "http://%s:%d" % server.endpoint
    prompts = [p.tolist() for p in _prompts(6, (5, 11))]
    want = _jax_generate([np.asarray(p, np.int32) for p in prompts], 9)
    try:
        with _post(server.url, {"prompt": prompts,
                                "max_tokens": 9}) as resp:
            assert json.loads(resp.read())["tokens"] == want
        with _post(base + "/generate/lm", {"prompt": prompts[0],
                                           "max_tokens": 9,
                                           "stream": True}) as resp:
            records = [json.loads(line) for line in resp]
        assert [r["token"] for r in records[:-1]] == want[0]
        assert records[-1] == {"done": True, "tokens": want[0]}
        with urllib.request.urlopen(base + "/metrics") as resp:
            doc = json.loads(resp.read())
        assert doc["lm"]["tokens_total"] == 27
        assert doc["lm"]["compile_count"] == 3
        with urllib.request.urlopen(
                base + "/metrics?format=prometheus") as resp:
            text = resp.read().decode()
        assert 'veles_gen_tokens_total{model="lm"} 27' in text
        assert 'veles_gen_compile_count{model="lm"} 3' in text
        with urllib.request.urlopen(base + "/healthz") as resp:
            assert json.loads(resp.read())["status"] == "ok"
        # /apply on a model that serves /generate
        for path, doc, code in (("/apply", {"input": [[1]]}, 400),
                                ("/generate/nope", {"prompt": [1]}, 404),
                                ("/generate", {"prompt": []}, 400),
                                ("/generate", {"prompt": [1],
                                               "top_k": 2.5}, 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + path, doc)
            assert err.value.code == code, path
        server.begin_drain()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.url, {"prompt": [1]})
        assert err.value.code == 503
    finally:
        server.stop()


@pytest.fixture
def empty_exemplars():
    """The process-wide exemplar table emptied for one test and
    restored after: it keeps the 16 slowest requests of the process, so
    requests of earlier tests in the same worker can crowd out a fast
    one of this test."""
    from veles_tpu_torch.obs.trace import EXEMPLARS
    with EXEMPLARS._lock:
        saved, EXEMPLARS._rows = EXEMPLARS._rows, []
    try:
        yield EXEMPLARS
    finally:
        with EXEMPLARS._lock:
            EXEMPLARS._rows = saved


def test_server_trace_round_trip(empty_exemplars):
    """A client-supplied X-Trace-Id is echoed, its spans (HTTP front,
    queue, prefill, decode, request) come back from /debug/trace, and
    the request shows up among /metrics' slowest exemplars."""
    from veles_tpu_torch.obs.trace import TRACER

    registry = ModelRegistry()
    registry.add_generative("lm", _engine(max_slots=1))
    server = ServeServer(registry, port=0)
    base = "http://%s:%d" % server.endpoint
    enabled, TRACER.enabled = TRACER.enabled, True
    trace_id = "5eed%012x" % np.random.default_rng(7).integers(2 ** 40)
    try:
        req = urllib.request.Request(
            server.url, data=json.dumps({"prompt": [1, 2],
                                         "max_tokens": 3}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Trace-Id": trace_id})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["X-Trace-Id"] == trace_id
            assert len(json.loads(resp.read())["tokens"][0]) == 3
        # the HTTP span closes just after the reply went out
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(
                    base + "/debug/trace?trace=" + trace_id) as resp:
                events = json.loads(resp.read())["traceEvents"]
            if "http" in {e["name"] for e in events} or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert {e["name"] for e in events} == {
            "http", "queue", "prefill", "decode_step", "request"}
        assert all(e["args"]["trace"] == trace_id for e in events)
        with urllib.request.urlopen(base + "/metrics") as resp:
            doc = json.loads(resp.read())
        assert trace_id in [row["trace"] for row in doc["_slowest"]]
        assert "veles_trace_spans_recorded_total" in doc["_obs"]
    finally:
        TRACER.enabled = enabled
        server.stop()


def test_engine_from_trainer_serves_its_params():
    """``from_trainer`` takes anything with ``.config``/``.params``."""
    from types import SimpleNamespace

    prompt = [np.asarray([4, 9, 2], np.int32)]
    engine = GenerativeEngine.from_trainer(
        SimpleNamespace(config=CONFIG, params=PARAMS), max_slots=1,
        device="cpu")
    assert engine.name == "generative_lm"
    assert engine.generate(prompt, 5)[0].tolist() == \
        _jax_generate(prompt, 5)[0]


def test_registry_swap_serves_the_new_engine():
    """A hot-swapped engine answers the next request (the old one has
    no active sequence, so the swap lands at once)."""
    other = init_params(JCONFIG, seed=11)
    registry = ModelRegistry()
    model = registry.add_generative("lm", _engine(max_slots=1))
    prompt = np.asarray([4, 9, 2], np.int32)
    try:
        first = model.generate(prompt, max_tokens=6).tolist()
        assert first == _jax_generate([prompt], 6)[0]
        registry.swap("lm", GenerativeEngine(CONFIG, other, max_slots=1,
                                             device="cpu"))
        ref = JEngine(JCONFIG, other, max_slots=1).generate([prompt], 6)
        assert model.generate(prompt, max_tokens=6).tolist() == \
            ref[0].tolist()
        with pytest.raises(KeyError):
            registry.swap("nope", model.engine)
        with pytest.raises(ValueError, match="already registered"):
            registry.add_generative("lm", model.engine)
    finally:
        registry.stop_all()


def test_log_context_tags_log_lines():
    import logging

    from veles_tpu_torch.logger import (disable_log_context,
                                        enable_log_context, log_context)

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    root = logging.getLogger()
    handler = Keep(logging.INFO)
    root.addHandler(handler)
    level = root.level
    root.setLevel(logging.INFO)
    try:
        enable_log_context()
        with log_context(model="lm", trace=None):
            with log_context(slot=3):
                logging.getLogger().info("step done")
        logging.getLogger().info("outside")
        disable_log_context()
        with log_context(model="lm"):
            logging.getLogger().info("off")
    finally:
        disable_log_context()
        root.removeHandler(handler)
        root.setLevel(level)
    assert records == ["step done [model=lm slot=3]", "outside", "off"]


def _normalized_events(doc):
    """A Chrome-trace document's events with the process's ids and the
    clock readings taken out (span ids replaced by their order)."""
    events = doc["traceEvents"]
    order = {e["args"]["span"]: i for i, e in enumerate(events)}
    out = []
    for e in events:
        args = dict(e["args"])
        args["span"] = order[args["span"]]
        if "parent" in args:
            args["parent"] = order.get(args["parent"], "outside")
        out.append({"ph": e["ph"], "name": e["name"], "cat": e["cat"],
                    "args": args, "dur_ok": e["dur"] >= 0})
    return {"displayTimeUnit": doc["displayTimeUnit"], "events": out}


def _nested_spans(tracer, ctx_cls):
    ctx = ctx_cls("abc123")
    with tracer.span("outer", "serve", ctx, path="/apply") as outer:
        with tracer.span("inner", "device", ctx):
            pass
    with tracer.span("leaf", ctx=ctx.child(outer.span_id), rows=3):
        pass
    with tracer.span("untraced"):  # no context: nothing recorded
        pass
    return outer


def test_trace_span_scopes_and_exports_match_reference(tmp_path):
    """``Tracer.span`` records on exit (its id then valid for child
    contexts, nothing without a context), and ``export_json`` and
    ``write`` give the reference's documents for the same spans."""
    from veles_tpu.obs import trace as R_trace
    from veles_tpu_torch.obs import trace as P_trace

    docs, written = [], []
    for mod in (R_trace, P_trace):
        tracer = mod.Tracer()
        outer = _nested_spans(tracer, mod.TraceContext)
        assert outer.span_id is not None
        spans = tracer.spans("abc123")
        assert [s["name"] for s in spans] == ["inner", "outer", "leaf"]
        assert spans[2]["parent"] == outer.span_id
        docs.append(_normalized_events(json.loads(tracer.export_json())))
        path = tmp_path / ("%s.json" % mod.__name__)
        assert tracer.write(str(path)) == 3
        written.append(_normalized_events(json.loads(path.read_text())))
        assert json.loads(tracer.export_json("nobody"))[
            "traceEvents"] == []
    assert docs[1] == docs[0]
    assert written[1] == written[0] == docs[0]
