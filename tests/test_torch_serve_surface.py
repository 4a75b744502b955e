"""The last public methods of the serving and tracing planes, each held
against the JAX package's method on the same sequence of calls (CPU,
f32): ``TokenBatcher.active_sequences`` and ``.draining``,
``ModelRegistry.stuck_for_s()``, ``GenerativeModel.prometheus_text()``
and ``ExemplarTable.clear()``.

Each is a read of state both packages keep alike, so the values are
compared exactly, except what a clock measures: the watchdog
heartbeat (``stuck_for_s``) to within the time the test itself takes
between the two reads (1 s), and the Prometheus samples by family,
labels and every value that counts (requests, tokens, prefills), not
the latency sums and the uptime.
"""

import time

import numpy as np
import pytest
import torch

from veles_tpu.models.transformer import TransformerConfig as JConfig
from veles_tpu.models.transformer import init_params
from veles_tpu.obs.trace import ExemplarTable as JExemplars
from veles_tpu.serve.batcher import TokenBatcher as JBatcher
from veles_tpu.serve.engine import GenerativeEngine as JEngine
from veles_tpu.serve.registry import ModelRegistry as JRegistry
from veles_tpu_torch.models.transformer import TransformerConfig
from veles_tpu_torch.obs.trace import ExemplarTable
from veles_tpu_torch.serve import (GenerativeEngine, ModelRegistry,
                                   TokenBatcher)

torch.set_num_threads(1)

SMALL = dict(vocab=64, embed=32, heads=2, layers=1, seq_len=64)
PARAMS = init_params(JConfig(**SMALL), seed=5)
#: counters of the generative exposition that do not depend on a clock
COUNTED = ("requests_total", "tokens_total", "prefills_total",
           "decode_steps_total", "errors_total", "rejected_total")


def _engines():
    return {"ref": JEngine(JConfig(**SMALL, attention_impl="lax"), PARAMS,
                           max_slots=2),
            "port": GenerativeEngine(TransformerConfig(**SMALL), PARAMS,
                                     max_slots=2, device="cpu")}


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_token_batcher_active_sequences_and_draining(engines):
    """Fresh: none active, not draining; a streaming request holds its
    slot from its first token until it retires; after ``drain`` the
    batcher drains. The same readings on both packages."""
    readings = {}
    prompt = np.arange(1, 6, dtype=np.int32)
    for side, batcher_cls in (("ref", JBatcher), ("port", TokenBatcher)):
        batcher = batcher_cls(engines[side])
        got = [batcher.active_sequences, batcher.draining]
        try:
            stream = batcher.stream(prompt, max_tokens=12, timeout=120)
            next(stream)
            got.append(batcher.active_sequences)
            rest = list(stream)
            deadline = time.monotonic() + 30
            while batcher.active_sequences and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            got += [len(rest), batcher.active_sequences, batcher.draining]
            assert batcher.drain(timeout=30)
            got += [batcher.draining, batcher.active_sequences]
        finally:
            batcher.stop(drain=False)
        readings[side] = got
    assert readings["port"] == readings["ref"] == [0, False, 1, 11, 0,
                                                   False, True, 0]


def test_registry_stuck_for_s_is_the_worst_heartbeat(engines):
    """Idle models read 0.0; a model whose device call has been out for
    5 s reads 5 s (the worst over the registry), the unrounded value of
    ``admission_signals``; an empty registry reads 0.0."""
    readings = {}
    for side, registry_cls in (("ref", JRegistry), ("port", ModelRegistry)):
        assert registry_cls().stuck_for_s() == 0.0
        registry = registry_cls()
        models = [registry.add_generative(name, engines[side])
                  for name in ("a", "b")]
        try:
            idle = registry.stuck_for_s()
            models[1].batcher._dispatch_t0 = time.monotonic() - 5.0
            stuck = registry.stuck_for_s()
            signal = registry.admission_signals()["stuck_for_s"]
            models[1].batcher._dispatch_t0 = None
            readings[side] = (idle, stuck, signal)
        finally:
            models[1].batcher._dispatch_t0 = None
            registry.stop_all(drain=False)
    for side in readings:
        idle, stuck, signal = readings[side]
        assert idle == 0.0
        assert 5.0 <= stuck < 6.0 and abs(signal - stuck) < 1e-3 + 1.0
    assert abs(readings["port"][1] - readings["ref"][1]) < 1.0


def _samples(text):
    """{(name, labels): value} of an exposition's sample lines, and its
    families (the ``# TYPE`` lines)."""
    samples, families = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            families.append(line)
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    return samples, families


def test_generative_model_prometheus_text(engines):
    """After the same two requests, the port's exposition holds the
    reference's families and samples, with equal counts."""
    texts = {}
    for side, registry_cls in (("ref", JRegistry), ("port", ModelRegistry)):
        registry = registry_cls()
        model = registry.add_generative("lm", engines[side])
        try:
            for n in (3, 7):
                model.generate(np.arange(1, n + 1, dtype=np.int32),
                               max_tokens=4, timeout=120)
            texts[side] = model.prometheus_text()
            # the registry's grouped exposition holds the same samples
            assert sorted(_samples(registry.prometheus_text())[0]) == \
                sorted(_samples(texts[side])[0])
        finally:
            registry.stop_all(drain=False)
    ref, ref_families = _samples(texts["ref"])
    port, port_families = _samples(texts["port"])
    assert port_families == ref_families
    assert sorted(port) == sorted(ref)
    counted = [key for key in ref if any(c in key for c in COUNTED)]
    assert counted
    for key in counted:
        assert port[key] == ref[key], key
    assert any("tokens_total" in key and port[key] == 8 for key in port)


def test_exemplar_table_clear():
    """Rows and the request count go; the table records anew as a fresh
    one does, on both packages."""
    snaps = {}
    for side, cls in (("ref", JExemplars), ("port", ExemplarTable)):
        table = cls(capacity=2)
        for i, ms in enumerate((5.0, 1.0, 9.0)):
            table.record("m", "t%d" % i, ms, queue=ms / 2)
        before = (table.snapshot(), table.requests)
        table.clear()
        cleared = (table.snapshot(), table.requests)
        table.record("m", "t9", 3.0, queue=1.0)
        snaps[side] = (before, cleared, table.snapshot(), table.requests)
    assert snaps["port"] == snaps["ref"]
    assert snaps["port"][1] == ([], 0)
    assert snaps["port"][3] == 1
