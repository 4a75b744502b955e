"""The host plane around the port's captured steps, on the CPU: the
``cuda_graphs`` device policy, the compute-dtype weights the serving
steps read, the static-buffer decode paths (slab, paged greedy, paged
sampled, speculative) with their in-place swaps, the trainer's device
step count and learning rate, and the step profiler
(``veles_tpu_torch.obs.profile``, mirrored from the JAX package's
``tests/test_obs.py`` cases on a stub backend).

Nothing is captured here (the CPU has no graphs): the decode rounds and
the train step run eagerly through the same bodies the card captures,
on the same static buffers. Tolerances: greedy tokens exact against
the JAX engines (f32); the cached compute-dtype weights give logits
bitwise equal to the per-step casts (the same rounding, once); the
trainer's losses within 1e-4 relative of the JAX trainer's and its
params within 2 lr per step (``tests/test_torch_train.py``'s bounds).
"""

import numpy as np
import pytest
import torch

import jax

import veles_tpu.models.transformer as JT
from veles_tpu.serve import engine as jengine
from veles_tpu_torch.graphs import use_graphs
from veles_tpu_torch.models import transformer as PT
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
from veles_tpu_torch.serve import (GenerativeEngine, InferenceEngine,
                                   MicroBatcher, PagedGenerativeEngine,
                                   TokenBatcher)

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=61, embed=32, heads=2, layers=2, seq_len=64)
CONFIG = PT.TransformerConfig(**SMALL)
JCONFIG = JT.TransformerConfig(**SMALL, attention_impl="lax")
PARAMS = JT.init_params(JCONFIG, seed=5)
PARAMS_B = JT.init_params(JCONFIG, seed=6)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMALL["vocab"], n).astype(np.int32)
            for n in lens]


def _lists(gens):
    return [g.tolist() for g in gens]


# -- the device policy -----------------------------------------------------

ENTRY_POINTS = {
    "slab": lambda **kw: GenerativeEngine(CONFIG, PARAMS, max_slots=2,
                                          device="cpu", **kw),
    "paged": lambda **kw: PagedGenerativeEngine(CONFIG, PARAMS, max_slots=2,
                                                device="cpu", **kw),
    "trainer": lambda **kw: PT.TransformerTrainer(CONFIG, device="cpu",
                                                  **kw),
    "forward": lambda **kw: InferenceEngine(lambda p, x: x, [],
                                            device="cpu", **kw),
    "classifier": lambda **kw: FusedClassifierTrainer(
        (("fc", "softmax"),), [{"w": np.eye(3, dtype=np.float32),
                                "b": np.zeros(3, np.float32)}],
        device="cpu", **kw),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_graphs_need_a_cuda_device(entry):
    """On the CPU there are no graphs: asking for them raises, the
    default and ``cuda_graphs=False`` run eagerly."""
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        ENTRY_POINTS[entry](cuda_graphs=True)
    for value in (None, False):
        assert not ENTRY_POINTS[entry](cuda_graphs=value)._graphs_on


def test_use_graphs_resolution():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert use_graphs(None, cuda) and not use_graphs(None, cpu)
    assert use_graphs(True, cuda) and not use_graphs(False, cuda)
    with pytest.raises(ValueError):
        use_graphs(True, cpu)


def test_collector_pauses_for_captures_and_restores():
    """The cyclic collector is off while any capture is under way (on
    any thread) and comes back as it was when the last one ends."""
    import gc
    import threading

    from veles_tpu_torch.graphs import _collector_paused

    was = gc.isenabled()
    try:
        for before in (True, False):
            (gc.enable if before else gc.disable)()
            inside, second_open, first_done = [], threading.Event(), \
                threading.Event()

            def second():
                with _collector_paused():
                    second_open.set()
                    first_done.wait(10)
                    inside.append(gc.isenabled())

            with _collector_paused():
                inside.append(gc.isenabled())
                t = threading.Thread(target=second)
                t.start()
                assert second_open.wait(10)
            first_done.set()
            t.join(10)
            assert inside == [False, False]
            assert gc.isenabled() == before
            with pytest.raises(RuntimeError):
                with _collector_paused():
                    raise RuntimeError("a capture that fails")
            assert gc.isenabled() == before
    finally:
        (gc.enable if was else gc.disable)()


# -- the serving weights ---------------------------------------------------

def test_compute_weights_equal_the_per_step_casts_bitwise():
    """bf16: every serving step over the cached weights gives the
    logits of the same step over the f32 master params, which cast in
    the step (the eager path before the cache) — bitwise. At f32 the
    cache is the params themselves."""
    cfg = PT.TransformerConfig(**SMALL, compute="bfloat16")
    params = PT.params_from_numpy(PARAMS, cfg, "cpu")
    weights = PT.compute_weights(params, cfg)
    assert weights["blocks"][0]["qkv"].dtype == torch.bfloat16
    assert weights["embed"] is params["embed"]
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, 61, (3, 16)))
    lengths = torch.tensor([16, 9, 4])
    active = torch.tensor([True, True, False])
    outs = []
    for tree in (params, weights):
        with torch.inference_mode():
            logits, cache = PT.prefill(tree, tokens, lengths, cfg)
            slab = PT.init_kv_cache(cfg, 3, 32, device="cpu")
            slab["k"][:, :, :16], slab["v"][:, :, :16] = cache["k"], \
                cache["v"]
            step, _, _ = PT.decode_step(tree, tokens[:, 0], slab, lengths,
                                        cfg, active=active)
            pool = PT.init_paged_kv_cache(cfg, 8, 8, device="cpu")
            tables = torch.arange(6).reshape(3, 2).int()
            paged, _, _ = PT.paged_decode_step(tree, tokens[:, 0], pool,
                                               lengths, tables, cfg,
                                               active=active)
            verify, _ = PT.verify_step(tree, tokens[:, :3], pool, lengths,
                                       tables, cfg, active=active)
        outs.append((logits, step, paged, verify))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    f32 = PT.compute_weights(PT.params_from_numpy(PARAMS, CONFIG, "cpu"),
                             CONFIG)
    assert f32["blocks"][1]["mlp_in"] is f32["blocks"][1]["mlp_in"].float()


# -- the static-buffer decode paths ----------------------------------------

def _jax_tokens(params, prompts, n):
    engine = jengine.GenerativeEngine(JCONFIG, params, max_slots=3)
    return _lists(engine.generate(prompts, n))


@pytest.mark.parametrize("plane", ["slab", "paged", "spec"])
def test_static_buffer_decode_matches_reference_across_swaps(plane):
    """Slab, paged greedy and speculative (self-draft) engines whose
    rounds read only static buffers: with a fault hook that NaNs
    nothing (the fault mask is live but all False), with slots joining
    and retiring, then after an in-place swap of the weights, greedy
    tokens equal the JAX engine's on each set of weights (the draft
    does not swap, so after the swap it proposes worse, not wrong)."""
    if plane == "slab":
        engine = GenerativeEngine(CONFIG, PARAMS, max_slots=3, device="cpu")
    else:
        kw = dict(draft_params=PARAMS, draft_config=CONFIG,
                  draft_tokens=3) if plane == "spec" else {}
        engine = PagedGenerativeEngine(CONFIG, PARAMS, max_slots=3,
                                       page_size=8, device="cpu", **kw)
    engine.decode_fault_hook = lambda step: []
    sampling = [{"draft": True}] * 3 if plane == "spec" else None
    kwargs = {} if sampling is None else {"sampling": sampling}
    leaves = [id(t) for t in PT._tree_leaves(engine._weights)]
    buffers = [engine._active_dev, engine._inject_dev]
    for params, seed in ((PARAMS, 1), (PARAMS_B, 2)):
        if params is PARAMS_B:
            engine.swap_params(params)
        prompts = _prompts(seed, (5, 12, 3))
        got = _lists(engine.generate(prompts, 10, **kwargs))
        assert got == _jax_tokens(params, prompts, 10)
        assert engine.active_slots == 0
    # rewritten in place, never rebound: a captured round reads them
    assert [id(t) for t in PT._tree_leaves(engine._weights)] == leaves
    assert all(a is b for a, b in zip(
        [engine._active_dev, engine._inject_dev], buffers))
    if plane == "spec":
        assert engine.decode_stats()["spec_proposed_total"] > 0


def test_sampled_rounds_reproduce_across_fault_masks():
    """A seeded sampled slot draws the same tokens whether or not the
    fault mask NaN'd its greedy neighbour in an earlier round (the mask
    buffer goes back to all False), and only the neighbour fails."""
    prompts = _prompts(3, (6, 9))
    knobs = [dict(temperature=0.9, top_k=20, top_p=0.95, seed=77), None]

    def run(fault_step):
        engine = PagedGenerativeEngine(CONFIG, PARAMS, max_slots=2,
                                       page_size=8, device="cpu")
        slots, first = engine.admit(prompts, knobs)
        engine.decode_fault_hook = lambda step: \
            [slots[1]] if step == fault_step else []
        out, finite = [int(first[0])], []
        for _ in range(6):
            tokens, _ = engine.decode_many()
            out.append(int(tokens[slots[0], 0]))
            finite.append(bool(engine.last_finite[slots[1]]))
            assert engine.last_finite[slots[0]]
        return out, finite

    clean, finite = run(None)
    assert all(finite)
    faulted, finite = run(1)
    assert faulted == clean
    assert finite == [True, False, True, True, True, True]


def test_decode_stats_touch_no_device_tensor():
    """/metrics runs on another thread than the dispatch loop: its
    gauges come from host mirrors, so a read never syncs the device
    (a sync during a capture would break it)."""
    for engine in (GenerativeEngine(CONFIG, PARAMS, max_slots=2,
                                    device="cpu"),
                   PagedGenerativeEngine(CONFIG, PARAMS, max_slots=2,
                                         device="cpu")):
        slots, _ = engine.admit(_prompts(4, (5, 9)))
        for _ in range(3):
            engine.decode() if hasattr(engine, "decode") \
                else engine.decode_many()
        expect = 5 + 9 + 2 * 3
        name = "_lengths" if hasattr(engine, "_lengths") else "_state"
        state = engine.__dict__.pop(name)
        try:
            assert engine.decode_stats()["cache_tokens"] == expect
        finally:
            setattr(engine, name, state)
        for s in slots:
            engine.release(s)


# -- the trainer's device step count and learning rate ---------------------

def test_trainer_device_step_count_and_lr_match_jax():
    """Three steps against the JAX trainer, the learning rate changed
    before the third: the device scalars carry both into the step."""
    lr = 1e-3
    jt = JT.TransformerTrainer(JCONFIG, mesh=None, learning_rate=lr, seed=2)
    pt = PT.TransformerTrainer(CONFIG, device="cpu", learning_rate=lr,
                               seed=2)
    rng = np.random.default_rng(9)
    for i in range(3):
        if i == 2:
            jt.learning_rate = pt.learning_rate = lr / 4
            assert float(pt._lr) == np.float32(lr / 4)
        tok = rng.integers(0, SMALL["vocab"], (2, SMALL["seq_len"] + 1))
        ref = float(jt.step(tok.astype(np.int32))["loss"])
        got = float(pt.step(tok)["loss"])
        assert abs(got - ref) <= 1e-4 * abs(ref)
    assert pt._step.dtype == torch.float32 and float(pt._step) == 3.0
    for a, b in zip(PT._tree_leaves(pt.params),
                    jax.tree.leaves(jax.tree.map(np.asarray, jt.params))):
        assert np.abs(a.detach().numpy() - b).max() <= 2 * lr * 3


def test_trainer_load_state_copies_into_its_tensors():
    """A captured step reads the trainer's tensors at their addresses:
    load_state rewrites them in place and sets the device count."""
    pt = PT.TransformerTrainer(CONFIG, device="cpu", seed=0)
    tok = np.random.default_rng(1).integers(0, 61, (2, 65))
    pt.step(tok)
    ids = [id(t) for t in PT._tree_leaves(pt.params) +
           PT._tree_leaves(pt.opt_m) + PT._tree_leaves(pt.opt_v)]
    fresh = PT.init_params(CONFIG, seed=4)
    pt.load_state(fresh, step=7)
    assert [id(t) for t in PT._tree_leaves(pt.params) +
            PT._tree_leaves(pt.opt_m) + PT._tree_leaves(pt.opt_v)] == ids
    assert float(pt._step) == 7.0 and pt._step_count == 7
    assert all(p.requires_grad for p in PT._tree_leaves(pt.params))
    assert not any(float(m.abs().max()) for m in PT._tree_leaves(pt.opt_m))
    other = PT.TransformerTrainer(CONFIG, device="cpu", seed=4)
    other.load_state(fresh, step=7)
    assert torch.equal(pt.step(tok)["loss"], other.step(tok)["loss"])


# -- the step profiler (tests/test_obs.py's cases) -------------------------

class FakeBackend:
    def __init__(self, fail_start=False):
        self.events = []
        self.fail_start = fail_start

    def start(self, out_dir):
        if self.fail_start:
            raise RuntimeError("no profiler here")
        self.events.append(("start", out_dir))

    def stop(self):
        self.events.append(("stop",))


@pytest.fixture
def profiler(tmp_path):
    backend = FakeBackend()
    prof = obs_profile.configure("1000@1", str(tmp_path), backend=backend)
    yield prof
    obs_profile.configure(None, str(tmp_path))
    assert obs_profile.PROFILER is None


def test_profile_spec_parse():
    assert obs_profile.parse_profile_spec("20") == (20, 0)
    assert obs_profile.parse_profile_spec("20@5") == (20, 5)
    for bad in ("", "x", "0", "3@-1", "@5"):
        with pytest.raises(ValueError):
            obs_profile.parse_profile_spec(bad)


def test_profiler_windows(tmp_path):
    """K=0 opens at once and one step closes a 1-step window; N@K
    captures exactly [K, K+N); a step_many window of K counts K; a
    backend that cannot start disables the capture."""
    backend = FakeBackend()
    prof = obs_profile.StepProfiler(str(tmp_path), steps=1, backend=backend)
    assert backend.events == [("start", str(tmp_path))]
    prof.on_step()
    assert backend.events[-1] == ("stop",) and prof.stats()["done"]
    backend = FakeBackend()
    prof = obs_profile.StepProfiler(str(tmp_path / "p"), steps=3, start=2,
                                    backend=backend)
    for _ in range(10):
        prof.on_step()
    assert backend.events == [("start", str(tmp_path / "p")), ("stop",)]
    assert prof.stats()["failed"] is None
    backend = FakeBackend()
    prof = obs_profile.StepProfiler(str(tmp_path), steps=4, start=1,
                                    backend=backend)
    prof.on_step(1)                  # opens after step 0
    prof.on_step(4)                  # a window of 4 closes it
    assert backend.events == [("start", str(tmp_path)), ("stop",)]
    prof = obs_profile.StepProfiler(str(tmp_path), steps=1,
                                    backend=FakeBackend(fail_start=True))
    assert prof.stats()["done"] and "no profiler" in prof.stats()["failed"]
    prof.on_step()                   # a failed capture stays quiet
    obs_profile.on_step()            # unconfigured: a no-op


def test_profiler_hooks_fire_where_the_reference_hooks(profiler):
    """The trainers count a step per step and K per step_many(K); the
    batchers count each dispatch (the forward batch, the prefill, the
    decode step)."""
    trainer = PT.TransformerTrainer(CONFIG, device="cpu")
    tok = np.random.default_rng(2).integers(0, 61, (2, 2, 65))
    seen = profiler.seen
    trainer.step(tok[0])
    trainer.step_many(tok)
    assert profiler.seen - seen == 3
    fc = FusedClassifierTrainer(["softmax"], [
        {"w": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)}],
        device="cpu")
    seen = profiler.seen
    fc.step(np.ones((2, 4), np.float32), np.array([0, 1]))
    fc.step_many(np.ones((3, 2, 4), np.float32), np.zeros((3, 2), np.int64))
    assert profiler.seen - seen == 4

    class Stub:
        def apply(self, x):
            return x

    batcher = MicroBatcher(Stub(), max_batch=4, max_delay_ms=1)
    seen = profiler.seen
    try:
        batcher.submit(np.ones((2, 3), np.float32), timeout=10)
    finally:
        batcher.stop()
    assert profiler.seen - seen == 1
    gen = TokenBatcher(GenerativeEngine(CONFIG, PARAMS, max_slots=1,
                                        device="cpu"))
    seen = profiler.seen
    try:
        gen.submit(np.array([1, 2, 3]), max_tokens=3, timeout=30)
    finally:
        gen.stop()
    assert profiler.seen - seen == 3     # one prefill, two decode steps


def test_a_capture_tallies_its_own_stream_only(monkeypatch):
    """While a graph is captured on a stream, the wrapper calls made on
    that stream (from any thread: autograd runs the backward on its
    own) go to the capture's tally; launches on another stream in that
    window (a sibling replica replaying) count as usual and are not
    taken back; a replay adds the tally. Streams stand in as names
    here (no card on the CPU)."""
    import threading

    from veles_tpu_torch.ops import launches
    stream = threading.local()
    monkeypatch.setattr(launches, "_stream_key",
                        lambda: getattr(stream, "name", "default"))
    counter = {"k": 0}
    inside = threading.Event()

    def on(name, n):
        stream.name = name
        assert inside.wait(30)
        for _ in range(n):
            launches.count(counter, "k")

    sibling = threading.Thread(target=on, args=("sibling", 5))
    backward = threading.Thread(target=on, args=("capture", 3))
    sibling.start()
    stream.name = "capture"
    with launches.capturing() as tally:
        launches.count(counter, "k")
        launches.count(counter, "k")
        inside.set()
        backward.start()
        backward.join(30)
        sibling.join(30)
    assert counter == {"k": 5}
    assert tally == [(counter, {"k": 5})]
    launches.add(tally)
    launches.add(tally)
    assert counter == {"k": 15}
    launches.count(counter, "k")  # no capture under way
    assert counter == {"k": 16}


def test_overlapping_captures_keep_their_own_tallies(monkeypatch):
    """Two captures under way at once on two streams (a respawn and a
    rollout building engines on two threads) each keep the calls of
    their own stream, and either may end first; a second capture on a
    stream that is capturing raises and leaves the first's tally in
    place."""
    import threading

    from veles_tpu_torch.ops import launches
    stream = threading.local()
    monkeypatch.setattr(launches, "_stream_key",
                        lambda: getattr(stream, "name", "default"))
    counter = {"k": 0}
    first_in = threading.Event()
    second_out = threading.Event()
    tallies = {}

    def second():
        stream.name = "b"
        assert first_in.wait(30)
        with launches.capturing() as tally:
            for _ in range(2):
                launches.count(counter, "k")
        tallies["b"] = tally
        second_out.set()

    thread = threading.Thread(target=second)
    thread.start()
    stream.name = "a"
    with launches.capturing() as tally:
        launches.count(counter, "k")
        first_in.set()
        assert second_out.wait(30)
        with pytest.raises(RuntimeError, match="already under way"):
            with launches.capturing():
                pass
        launches.count(counter, "k")
        launches.count(counter, "k")
    thread.join(30)
    assert counter == {"k": 0}
    assert tally == [(counter, {"k": 3})]
    assert tallies["b"] == [(counter, {"k": 2})]
    assert not launches._TALLIES
    launches.count(counter, "k")
    assert counter == {"k": 1}
