"""Scheduler tenancy of the port's trainers and serving planes, on the
CPU at tiny widths (f32).

The reference's promise: a tenant's trajectory under the scheduler is
bitwise that of an unscheduled run, since leases are revocable only
between quanta. So with a tenant (and a second tenant contending for
the device between every quantum) the port's trainers give bitwise the
losses and parameters they give without one, and stay within the
bounds ``tests/test_torch_train.py`` and ``tests/test_torch_fused.py``
hold them to against the JAX package (LM losses 1e-4 relative,
parameters 2 lr per Adam step; classifier parameters 1e-4 of each
leaf's scale); the slab and paged engines' greedy tokens and the
forward plane's rows are equal with and without a tenant. The serving
hooks are checked too: every dispatch takes a quantum, the most urgent
client deadline reaches ``TenantHandle.quantum``, traced requests gain
``sched_wait`` spans, engine warm-ups capture inside a quantum, and
``/metrics`` carries ``_scheduler`` and the ``veles_sched_*`` series.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import veles_tpu.models.transformer as JT
import veles_tpu.parallel.fused as JFused
import veles_tpu_torch.models.transformer as PT
from veles_tpu_torch.obs.trace import TRACER, TraceContext
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
from veles_tpu_torch.sched import Scheduler, SchedulerStopped
from veles_tpu_torch.serve import (GenerativeEngine, InferenceEngine,
                                   MicroBatcher, ModelRegistry,
                                   PagedGenerativeEngine, ServeServer,
                                   TokenBatcher)

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=64, embed=64, heads=4, layers=2, seq_len=32)
LR = 3e-3
SERVE = dict(vocab=61, embed=32, heads=2, layers=2, seq_len=64)
SERVE_PARAMS = JT.init_params(JT.TransformerConfig(**SERVE,
                                                   attention_impl="lax"),
                              seed=5)


class _Contender:
    """A second tenant that takes the device between every quantum of
    the tenant under test (a busy serve loop)."""

    def __init__(self, tenant, work_s=0.001):
        self.tenant = tenant
        self.stop = threading.Event()
        self.quanta = 0
        self.thread = threading.Thread(target=self._loop, args=(work_s,))

    def _loop(self, work_s):
        while not self.stop.is_set():
            try:
                with self.tenant.quantum():
                    time.sleep(work_s)
            except SchedulerStopped:
                return
            self.quanta += 1

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        return False


def _scheduled(name="t"):
    sched = Scheduler()
    return sched, sched.register(name, weight=1), \
        sched.register("contender", weight=4)


# ----------------------------------------------------------------- trainers

def _lm_tokens(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (2, SMALL["seq_len"] + 1) if k is None else \
        (k, 2, SMALL["seq_len"] + 1)
    return rng.integers(0, SMALL["vocab"], shape).astype(np.int32)


def _lm_run(trainer, batches):
    losses = []
    for kind, tok in batches:
        if kind == "step":
            losses.append(float(trainer.step(tok)["loss"]))
        else:
            losses.extend(np.asarray(trainer.step_many(tok)["loss"]
                                     ).tolist())
    return losses


def test_lm_trainer_with_a_tenant_is_bitwise_the_free_run():
    batches = [("step", _lm_tokens(0)), ("many", _lm_tokens(1, k=3)),
               ("step", _lm_tokens(2))]
    config = PT.TransformerConfig(**SMALL)
    free = PT.TransformerTrainer(config, device="cpu", learning_rate=LR,
                                 seed=3)
    free_losses = _lm_run(free, batches)

    sched, tenant, other = _scheduled("train")
    scheduled = PT.TransformerTrainer(config, device="cpu",
                                      learning_rate=LR, seed=3)
    scheduled.sched_tenant = tenant
    with _Contender(other):
        losses = _lm_run(scheduled, batches)
    snap = sched.snapshot()
    sched.stop()
    assert losses == free_losses
    for a, b in zip(PT._tree_leaves(free.params),
                    PT._tree_leaves(scheduled.params)):
        assert torch.equal(a, b)
    assert snap["tenants"]["train"]["quanta"] == 3  # one per dispatch

    jtr = JT.TransformerTrainer(
        JT.TransformerConfig(**SMALL, attention_impl="lax"), mesh=None,
        learning_rate=LR, seed=3)
    ref_losses = _lm_run(jtr, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    import jax
    ref_leaves = [np.asarray(x) for x in PT._tree_leaves(
        jax.tree.map(np.asarray, jtr.params))]
    for ours, theirs in zip(PT._tree_leaves(scheduled.params),
                            ref_leaves):
        assert np.abs(ours.detach().numpy() - theirs).max() <= \
            2 * LR * len(losses)


def _fc_specs_params(seed=0):
    rng = np.random.default_rng(seed)
    dims = [12, 16, 4]
    specs, params = [], []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs.append("softmax" if i == len(dims) - 2 else "tanh")
        params.append({"w": (rng.standard_normal((a, b)) /
                             np.sqrt(a)).astype(np.float32),
                       "b": np.zeros(b, np.float32)})
    return tuple(specs), params


def _fc_run(trainer, windows, xs, labels):
    losses = []
    for _ in range(windows):
        losses.extend(np.asarray(trainer.step_many(xs, labels)["loss"]
                                 ).tolist())
    losses.append(float(trainer.step(xs[0], labels[0])["loss"]))
    return losses


def test_fused_trainer_preempted_at_every_window_is_bitwise_the_free_run():
    """The reference's acceptance case on the port: a classifier
    trainer preempted at EVERY K-window edge by a busy serve tenant
    ends bitwise where an uninterrupted run ends."""
    k, windows = 4, 4
    rng = np.random.default_rng(42)
    xs = rng.random((k, 8, 12), dtype=np.float32)
    labels = rng.integers(0, 4, (k, 8)).astype(np.int32)
    specs, params = _fc_specs_params()
    hyper = dict(learning_rate=0.05, momentum=0.9)
    free = FusedClassifierTrainer(specs, params, device="cpu", **hyper)
    free_losses = _fc_run(free, windows, xs, labels)

    sched, tenant, other = _scheduled("train")
    sub = FusedClassifierTrainer(specs, params, device="cpu", **hyper)
    sub.sched_tenant = tenant
    with _Contender(other) as contender:
        losses = _fc_run(sub, windows, xs, labels)
    snap = sched.snapshot()
    sched.stop()
    assert losses == free_losses
    for a, b in zip(free.params_numpy(), sub.params_numpy()):
        for key in a:
            assert np.array_equal(a[key], b[key]), key
    assert snap["tenants"]["train"]["quanta"] == windows + 1
    assert contender.quanta >= windows

    ref = JFused.FusedClassifierTrainer(specs, params, **hyper)
    ref_losses = _fc_run(ref, windows, xs, labels)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for ours, layer in zip(sub.params_numpy(), ref.params):
        for key, value in layer.items():
            theirs = np.asarray(value)
            scale = max(np.abs(theirs).max(), 1e-30)
            assert np.abs(ours[key] - theirs).max() <= 1e-4 * scale


# ----------------------------------------------------------- serving planes

def _serve_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SERVE["vocab"], n).astype(np.int32)
            for n in lens]


def _batcher_tokens(engine, prompts, max_tokens, tenant=None):
    batcher = TokenBatcher(engine, tenant=tenant)
    results = [None] * len(prompts)

    def client(i):
        results[i] = batcher.submit(prompts[i], max_tokens=max_tokens,
                                    timeout=120).tolist()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.stop()
    return results


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_with_a_tenant_equal_those_without(paged):
    config = PT.TransformerConfig(**SERVE)

    def engine():
        if paged:
            return PagedGenerativeEngine(config, SERVE_PARAMS, max_slots=3,
                                         page_size=16, device="cpu")
        return GenerativeEngine(config, SERVE_PARAMS, max_slots=3,
                                device="cpu")

    prompts = _serve_prompts(3, (4, 9, 15, 6, 11))
    free = _batcher_tokens(engine(), prompts, 7)
    sched, tenant, other = _scheduled("serve")
    with _Contender(other):
        got = _batcher_tokens(engine(), prompts, 7, tenant=tenant)
    snap = sched.snapshot()["tenants"]["serve"]
    sched.stop()
    assert got == free
    # at least one prefill and one decode round per generated token
    # beyond the first, each a quantum
    assert snap["quanta"] >= 7


def test_microbatcher_rows_with_a_tenant_equal_those_without():
    specs = [("fc", "tanh"), ("fc", "softmax")]
    rng = np.random.default_rng(1)
    params = [{"w": rng.standard_normal((6, 8)).astype(np.float32) / 3,
               "b": np.zeros(8, np.float32)},
              {"w": rng.standard_normal((8, 4)).astype(np.float32) / 3,
               "b": np.zeros(4, np.float32)}]
    rows = [rng.random((n, 6), dtype=np.float32) for n in (1, 3, 5, 2)]

    def serve(tenant):
        engine = InferenceEngine.from_specs(specs, params, device="cpu")
        batcher = MicroBatcher(engine, max_batch=8, max_delay_ms=1,
                               tenant=tenant)
        try:
            return [batcher.submit(r, timeout=60) for r in rows]
        finally:
            batcher.stop()

    free = serve(None)
    sched, tenant, other = _scheduled("apply")
    with _Contender(other):
        got = serve(tenant)
    quanta = sched.snapshot()["tenants"]["apply"]["quanta"]
    sched.stop()
    for a, b in zip(got, free):
        assert np.array_equal(a, b)
    assert quanta == len(rows)


class _RecordingTenant:
    """Wraps a TenantHandle: records the deadline each acquire hands
    to ``quantum``."""

    def __init__(self, tenant):
        self._tenant = tenant
        self.deadlines = []
        self.threads = None

    def quantum(self, deadline_ms=None):
        self.deadlines.append(deadline_ms)
        return self._tenant.quantum(deadline_ms=deadline_ms)


def test_deadline_handoff_reaches_the_tenant_quantum():
    """A request's remaining client budget rides each dispatch's
    acquire (the most urgent of the co-batched tickets); a patient
    request hands None."""
    sched = Scheduler()
    rec = _RecordingTenant(sched.register("serve"))

    class Stub:
        input_dtype = np.dtype(np.float32)

        def apply(self, x):
            return np.asarray(x) * 2

    batcher = MicroBatcher(Stub(), max_batch=4, max_delay_ms=1,
                           tenant=rec)
    try:
        batcher.submit(np.ones((1, 3), np.float32), deadline_ms=5000)
        batcher.submit(np.ones((1, 3), np.float32))
    finally:
        batcher.stop()
    assert rec.deadlines[0] is not None and 0 < rec.deadlines[0] <= 5000
    assert rec.deadlines[-1] is None

    gen = TokenBatcher(GenerativeEngine(
        PT.TransformerConfig(**SERVE), SERVE_PARAMS, max_slots=2,
        device="cpu"), tenant=rec)
    rec.deadlines.clear()
    try:
        gen.submit(np.asarray([1, 2, 3], np.int32), max_tokens=3,
                   deadline_ms=60000, timeout=60)
    finally:
        gen.stop()
    sched.stop()
    # one prefill + two decode rounds, each carrying the budget
    assert len(rec.deadlines) == 3
    assert all(d is not None and 0 < d <= 60000 for d in rec.deadlines)
    assert rec.deadlines == sorted(rec.deadlines, reverse=True)


def _span_names(trace_id):
    return [e["name"] for e in TRACER.export_chrome(trace_id)[
        "traceEvents"]]


def test_sched_wait_spans_are_recorded():
    """Traced requests gain a ``sched_wait`` span per dispatch with a
    scheduler attached, and none without one."""
    enabled, TRACER.enabled = TRACER.enabled, True
    sched = Scheduler()
    tenant = sched.register("serve")

    class Stub:
        input_dtype = np.dtype(np.float32)

        def apply(self, x):
            return np.asarray(x)

    try:
        for with_tenant in (False, True):
            batcher = MicroBatcher(
                Stub(), max_delay_ms=1,
                tenant=tenant if with_tenant else None)
            ctx = TraceContext.new()
            try:
                batcher.submit(np.ones((2, 3), np.float32), ctx=ctx)
            finally:
                batcher.stop()
            names = _span_names(ctx.trace_id)
            assert names.count("sched_wait") == int(with_tenant)
            assert "device" in names
        gen = TokenBatcher(GenerativeEngine(
            PT.TransformerConfig(**SERVE), SERVE_PARAMS, max_slots=1,
            device="cpu"), tenant=tenant)
        ctx = TraceContext.new()
        try:
            gen.submit(np.asarray([4, 5], np.int32), max_tokens=3,
                       ctx=ctx, timeout=60)
        finally:
            gen.stop()
        names = _span_names(ctx.trace_id)
        # prefill + two decode rounds
        assert names.count("sched_wait") == 3
        assert names.count("decode_step") == 2 and "prefill" in names
    finally:
        TRACER.enabled = enabled
        sched.stop()


def test_warm_and_warmup_run_inside_the_tenant_quantum():
    """The engines know nothing of the scheduler: the caller that owns
    the tenant warms (captures) inside one of its quanta, and the
    batcher's own quanta follow on the same tenant."""
    sched = Scheduler()
    tenant = sched.register("serve")
    engine = GenerativeEngine(PT.TransformerConfig(**SERVE), SERVE_PARAMS,
                              max_slots=2, device="cpu")
    batcher = TokenBatcher(engine, tenant=tenant)
    try:
        assert not hasattr(engine, "sched_tenant")
        with tenant.quantum():
            engine.warm()
        assert tenant.quanta == 1
        assert len(batcher.submit([1, 2, 3], max_tokens=2, timeout=60)) == 2
        assert tenant.quanta > 1
    finally:
        batcher.stop()
    fwd = InferenceEngine.from_specs([("fc", "softmax")], [
        {"w": np.eye(3, dtype=np.float32), "b": np.zeros(3, np.float32)}],
        device="cpu")
    mb = MicroBatcher(fwd, tenant=tenant)
    try:
        before = tenant.quanta
        with tenant.quantum():
            assert fwd.warmup((3,), 4) == 3
        assert tenant.quanta == before + 1
        row = np.eye(3, dtype=np.float32)[:1]
        assert np.array_equal(mb.submit(row, timeout=60), fwd.apply(row))
        assert tenant.quanta == before + 2
    finally:
        mb.stop()
        sched.stop()


def test_scheduler_stop_request_stops_the_batcher_threads():
    """A tenant without its own ManagedThreads adopts the batcher's:
    ``Scheduler.stop()`` request-stops the dispatch loop, which the
    owner then joins."""
    sched = Scheduler()
    tenant = sched.register("serve")

    class Stub:
        input_dtype = np.dtype(np.float32)

        def apply(self, x):
            return np.asarray(x)

    batcher = MicroBatcher(Stub(), tenant=tenant)
    assert tenant.threads is batcher._threads
    sched.stop()
    assert batcher._threads.stop_requested
    batcher.stop(drain=False)
    assert not any(t.is_alive() for t in batcher._threads._threads)


def test_metrics_carry_the_scheduler():
    sched = Scheduler(name="card")
    serve = sched.register("serve", weight=4)
    sched.register("train", weight=1)
    registry = ModelRegistry()
    registry.add_generative("lm", GenerativeEngine(
        PT.TransformerConfig(**SERVE), SERVE_PARAMS, max_slots=1,
        device="cpu"), tenant=serve)
    server = ServeServer(registry, port=0, scheduler=sched)
    base = "http://%s:%d" % server.endpoint
    try:
        req = urllib.request.Request(
            server.url, data=json.dumps({"prompt": [1, 2],
                                         "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert len(json.loads(resp.read())["tokens"][0]) == 2
        with urllib.request.urlopen(base + "/metrics") as resp:
            doc = json.loads(resp.read())
        tenants = doc["_scheduler"]["tenants"]
        assert set(tenants) == {"serve", "train"}
        assert tenants["serve"]["quanta"] == 2
        assert doc["_scheduler"]["name"] == "card"
        with urllib.request.urlopen(
                base + "/metrics?format=prometheus") as resp:
            text = resp.read().decode()
        assert 'veles_sched_quanta_total{tenant="serve"} 2' in text
        assert 'veles_sched_weight{tenant="train"} 4' not in text
        assert 'veles_sched_weight{tenant="serve"} 4' in text
        assert "veles_sched_queue_wait_ms" in text
    finally:
        server.stop()
        sched.stop()
    plain = ServeServer(ModelRegistry(), port=0)
    try:
        with urllib.request.urlopen(
                "http://%s:%d/metrics" % plain.endpoint) as resp:
            assert "_scheduler" not in json.loads(resp.read())
    finally:
        plain.stop()
