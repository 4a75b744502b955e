"""Port parity of the acceleration layer: ``veles_tpu_torch``'s
backends (``Device``), memory (``Array``, ``Watcher``),
accelerated_units (``AcceleratedUnit``, ``AcceleratedWorkflow``,
``jit_cache``) and ``prng`` against the JAX package's, on the CPU.

Host draws of a ``prng`` stream must equal the reference's bitwise
(both come from ``np.random.default_rng([seed, crc32(name)])``), also
after a state save and restore and after
``from_reference_state``. Device fills are the port's Philox (K8's
plain version on a CPU tensor), not JAX's threefry: they are held to
the plain ``ops.rng.uniform_fill`` bitwise under the stream's key
schedule, and the normal fill to its distribution (mean and standard
deviation within 5 standard errors at 2^16 draws).
"""

import pickle
import zlib

import numpy as np
import pytest
import torch

from veles_tpu import prng as ref_prng
from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               AcceleratedWorkflow,
                                               jit_cache)
from veles_tpu_torch.backends import CpuDevice, CudaDevice, Device
from veles_tpu_torch.memory import Array, Watcher
from veles_tpu_torch.ops import rng as rng_ops
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)


@pytest.fixture
def device():
    return Device(backend="cpu")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ----------------------------------------------------------------- Device

def test_device_factory_and_cpu_backend(device):
    assert isinstance(device, CpuDevice)
    assert device.torch_device == torch.device("cpu")
    assert device.device_count == 1 and device.backend_name == "cpu"
    assert device.precision_dtype == np.float32
    assert device.compute_dtype is torch.bfloat16
    with pytest.raises(ValueError, match="Unknown backend"):
        Device(backend="tpu")
    with pytest.raises(RuntimeError, match="joined process group"):
        device.mesh({"data": 1})


def test_device_auto_is_cuda_and_raises_without_a_gpu(no_gpu):
    """``Device()`` is the card: without one it raises and names the
    CPU backend, never falling back on its own."""
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        Device()
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        Device(backend="auto")
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        CudaDevice()
    # one name for the card: the knob's "auto"
    with pytest.raises(ValueError, match="Unknown backend"):
        Device(backend="cuda")


def test_put_get_sync_roundtrip(device):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = device.put(x)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    x[0, 0] = 99           # a copy: the host array does not alias it
    np.testing.assert_array_equal(device.get(t)[0], [0, 1, 2, 3])
    device.sync(t)
    bf = device.put(torch.ones(3, dtype=torch.bfloat16))
    assert device.get(bf).dtype == np.float32


def test_benchmark_and_computing_power(device):
    assert device.benchmark(size=64, repeats=2) > 0
    assert device.computing_power > 0


def test_device_pickles_as_configuration(device):
    dev2 = pickle.loads(pickle.dumps(device))
    assert isinstance(dev2, CpuDevice)
    assert dev2.torch_device == torch.device("cpu")


# ------------------------------------------------------------------ Array

def test_array_host_device_coherence(device):
    a = Array(np.ones((4, 4), dtype=np.float32)).initialize(device)
    dev = a.devmem
    assert isinstance(dev, torch.Tensor)
    a.devmem = dev * 2
    np.testing.assert_array_equal(a.map_read(), 2 * np.ones((4, 4)))
    # the host copy is a copy, never a view of the device tensor
    a.map_read()[0, 0] = -1
    assert float(a.devmem_[0, 0]) == 2.0


def test_array_host_write_pushes_and_items(device):
    a = Array(np.zeros(3, dtype=np.float32)).initialize(device)
    a.map_write()[1] = 7
    np.testing.assert_array_equal(device.get(a.devmem), [0, 7, 0])
    b = Array(shape=(2, 2), dtype=np.float32).initialize(device)
    b[0, 0] = 5
    assert b[0, 0] == 5
    c = Array(np.arange(4, dtype=np.float32)).initialize(device)
    c.devmem = c.devmem + 1
    c.map_invalidate()[:] = 0     # overwrite without pulling
    np.testing.assert_array_equal(device.get(c.devmem), [0, 0, 0, 0])
    assert (len(c), c.size, c.nbytes, bool(c)) == (4, 4, 16, True)
    assert "dev" in repr(c)


def test_array_pickle_maps_read_first(device):
    a = Array(np.zeros(2, dtype=np.float32)).initialize(device)
    a.devmem = torch.ones(2)
    a2 = pickle.loads(pickle.dumps(a))
    np.testing.assert_array_equal(a2.mem, [1, 1])
    assert a2.devmem_ is None


def test_array_bf16_result_reads_as_f32(device):
    a = Array(np.zeros(3, dtype=np.float32)).initialize(device)
    a.devmem = torch.full((3,), 1.5, dtype=torch.bfloat16)
    assert a.map_read().dtype == np.float32
    np.testing.assert_array_equal(a.map_read(), [1.5, 1.5, 1.5])


def test_array_without_a_device_needs_the_gpu(no_gpu):
    a = Array(np.zeros(2, dtype=np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        a.devmem


def test_watcher_bytes(device):
    import gc
    gc.collect()
    before = Watcher.mem_in_use
    a = Array(np.zeros((10, 10), dtype=np.float32)).initialize(device)
    assert Watcher.mem_in_use == before + 400
    a.devmem = torch.zeros((5, 5), dtype=torch.float64)
    assert Watcher.mem_in_use == before + 200
    a._release_devmem()
    assert Watcher.mem_in_use == before
    b = Array(np.zeros((64, 64), dtype=np.float32)).initialize(device)
    assert Watcher.max_mem_in_use >= before + 16384
    del b
    gc.collect()
    assert Watcher.mem_in_use == before


def test_watcher_finalizer_under_the_lock_does_not_deadlock(device):
    """A collection can finalize an Array while its thread holds the
    Watcher's lock (inside ``add`` or ``sub``; seen as a hang of a
    workflow run mid-``devmem``): the finalizer must not block, and its
    bytes are settled by the next ``add``."""
    import gc
    import threading
    gc.collect()
    a = Array(np.zeros(4, dtype=np.float32)).initialize(device)
    before = Watcher.mem_in_use
    done = threading.Event()

    def finalize_under_the_lock():
        with Watcher._lock:
            a.__del__()
        done.set()

    thread = threading.Thread(target=finalize_under_the_lock, daemon=True)
    thread.start()
    thread.join(10.0)
    assert done.is_set(), "the finalizer blocked on the Watcher's lock"
    Watcher.add(0)
    assert Watcher.mem_in_use == before - 16
    assert a._accounted_ == 0


# ---------------------------------------------------------- AcceleratedUnit

class DoubleUnit(AcceleratedUnit):
    """Minimal accelerated unit: out = 2*x through a shared callable."""

    @staticmethod
    def _kernel(x):
        return x * 2

    def initialize(self, **kwargs):
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        self.init_array("output", shape=self.input.shape)
        return None

    def run(self):
        fn = self.jit(DoubleUnit._kernel)
        self.output.devmem = fn(self.input.devmem)


def test_accelerated_workflow_end_to_end(device):
    wf = AcceleratedWorkflow(None, name="awf")
    u = DoubleUnit(wf, name="dbl")
    u.input = Array(np.arange(4, dtype=np.float32))
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    wf.initialize(device=device)
    u.input.initialize(device)
    wf.run()
    np.testing.assert_array_equal(u.output.map_read(), [0, 2, 4, 6])
    assert u.device is device and u.output.device_ is device
    wf.thread_pool.shutdown()


def test_accelerated_workflow_needs_the_gpu_by_default(no_gpu):
    wf = AcceleratedWorkflow(None, name="awf")
    u = DoubleUnit(wf, name="dbl")
    u.input = Array(np.arange(4, dtype=np.float32))
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        wf.initialize()
    forced = DoubleUnit(Workflow(None, name="w2"), force_cpu=True)
    forced.input = Array(np.zeros(2, dtype=np.float32))
    forced.initialize()
    assert isinstance(forced.device, CpuDevice)


def test_jit_cache_shared():
    f1 = jit_cache(DoubleUnit._kernel)
    f2 = jit_cache(DoubleUnit._kernel)
    assert f1 is f2 is DoubleUnit._kernel
    assert jit_cache(DoubleUnit._kernel, static_argnums=(0,)) is f1


# ------------------------------------------------------------------- prng

@pytest.fixture
def fresh_streams():
    prng.reset()
    ref_prng.reset()
    yield
    prng.reset()
    ref_prng.reset()


def _host_draws(rng):
    arr = np.arange(20)
    rng.shuffle(arr)
    host = np.zeros((3, 4), np.float64)
    rng.fill_normal_host(host, stddev=0.5)
    return [arr, rng.permutation(17), rng.randint(0, 1000, 8),
            rng.random_sample(5), rng.choice(np.arange(9), 4, False),
            rng.randint(5), host]


@pytest.mark.parametrize("seed,name", [(0, "default"), (42, "loader"),
                                       (2 ** 40 + 7, "w"), (3, "")])
def test_host_draws_equal_the_reference(seed, name):
    ours = _host_draws(prng.RandomGenerator(name, seed=seed))
    theirs = _host_draws(ref_prng.RandomGenerator(name, seed=seed))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_save_restore_and_pickle():
    rng = prng.RandomGenerator("s", seed=9)
    rng.permutation(5)
    rng.uniform((3,), device="cpu")
    state = rng.state
    a = (rng.permutation(10), rng.uniform((16,), device="cpu"))
    rng.state = state
    b = (rng.permutation(10), rng.uniform((16,), device="cpu"))
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])
    rng2 = pickle.loads(pickle.dumps(rng))
    assert torch.equal(rng2.uniform((8,), device="cpu"),
                       rng.uniform((8,), device="cpu"))
    seed, counter, key, np_state = rng.state
    assert (seed, counter) == (9, 3) and key.dtype == np.uint32
    assert key.shape == (2,)
    assert rng.state_at_seed[1] == 0


def test_from_reference_state_continues_the_host_draws():
    """A reference stream's state (numpy, or its pickled dict) carried
    into the port: the host draws go on exactly as the reference's,
    and the device fills follow the port's key of that seed and
    name."""
    ref = ref_prng.RandomGenerator("carry", seed=77)
    ref.permutation(30)
    ref.normal((4,))                  # advances the reference's counter
    for given in (ref.state, ref.__getstate__()):
        port = prng.RandomGenerator("carry", seed=0)
        port.state = prng.from_reference_state(
            given, name="carry") if not isinstance(given, dict) \
            else prng.from_reference_state(given)
        twin = pickle.loads(pickle.dumps(ref))
        for a, b in zip(_host_draws(port), _host_draws(twin)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert port.state[1] == 1 and port.state[0] == 77
        assert port.key == prng.RandomGenerator("carry", seed=77).key


def test_uniform_is_k8_under_the_stream_key_schedule():
    """``uniform`` is ``ops.rng.uniform_fill`` keyed by
    ``fold_in(fold_in(seed, crc32(name)), counter)``; ``bernoulli`` is
    ``fill < p``; both advance the counter once."""
    rng = prng.RandomGenerator("smoke", seed=5)
    key = rng_ops.fold_in(5, zlib.crc32(b"smoke"))
    assert rng.key == key
    got = rng.uniform((8, 128), device="cpu")
    want = rng_ops.uniform_fill(rng_ops.fold_in(key, 1), (8, 128),
                                device="cpu", impl="plain")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    scaled = rng.uniform((100,), low=-2.0, high=3.0, device="cpu")
    assert torch.equal(scaled, rng_ops.uniform_fill(
        rng_ops.fold_in(key, 2), (100,), low=-2.0, high=3.0,
        device="cpu", impl="plain"))
    mask = rng.bernoulli((1000,), p=0.25, device="cpu")
    assert torch.equal(mask, rng_ops.uniform_fill(
        rng_ops.fold_in(key, 3), (1000,), device="cpu",
        impl="plain") < 0.25)
    assert mask.dtype == torch.bool and 150 < int(mask.sum()) < 350


def test_normal_is_box_muller_over_two_fills():
    rng = prng.RandomGenerator("n", seed=1)
    z = rng.normal((1 << 16,), stddev=2.0, device="cpu")
    assert z.dtype == torch.float32 and torch.isfinite(z).all()
    se = 2.0 / 256.0
    assert abs(float(z.mean())) < 5 * se
    assert abs(float(z.std()) - 2.0) < 5 * se * 1.5
    again = prng.RandomGenerator("n", seed=1).normal(
        (1 << 16,), stddev=2.0, device="cpu")
    assert torch.equal(z, again)


def test_device_fills_need_the_gpu_by_default(no_gpu):
    rng = prng.RandomGenerator("x", seed=0)
    for fill in (rng.uniform, rng.normal, rng.bernoulli):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fill((4,))


def test_get_seed_all_reset(fresh_streams):
    from veles_tpu_torch.config import root
    saved = root.common.random.seed
    try:
        a = prng.get("w")
        assert prng.get("w") is a
        prng.seed_all(123)
        x1 = a.uniform((4,), device="cpu")
        prng.seed_all(123)
        x2 = a.uniform((4,), device="cpu")
        assert torch.equal(x1, x2)
        prng.reset()
        assert prng.get("w") is not a
        assert prng.get("w").state[0] == 123
    finally:
        root.common.random.seed = saved


def test_reinit_replays_rng_like_the_reference():
    """``_initialize_reproducibly``: re-initializing replays the
    streams, so init-time draws repeat (also for a stream created
    inside initialize), in both packages alike for the host draws."""
    from veles_tpu.units import TrivialUnit as RefTrivialUnit
    from veles_tpu.workflow import Workflow as RefWorkflow

    def build(unit_cls, wf_cls, rg_cls):
        class ParamUnit(unit_cls):
            def __init__(self, workflow, **kwargs):
                super().__init__(workflow, **kwargs)
                self.rand = rg_cls("param", seed=3)
                self.lazy = None
                self.weights = None

            def initialize(self, **kwargs):
                if self.lazy is None:
                    self.lazy = rg_cls("lazy", seed=5)
                self.weights = np.concatenate([
                    self.rand.permutation(6), self.lazy.random_sample(3)])
                return super().initialize(**kwargs)

        wf = wf_cls(None, name="wf")
        u = ParamUnit(wf, name="p")
        u.link_from(wf.start_point)
        wf.end_point.link_from(u)
        return wf, u

    seen = []
    for args in ((TrivialUnit, Workflow, prng.RandomGenerator),
                 (RefTrivialUnit, RefWorkflow, ref_prng.RandomGenerator)):
        wf, u = build(*args)
        draws = []
        for _ in range(3):
            wf.initialize()
            draws.append(u.weights.copy())
        wf.thread_pool.shutdown()
        for d in draws[1:]:
            np.testing.assert_array_equal(draws[0], d)
        seen.append(draws[0])
    np.testing.assert_array_equal(seen[0], seen[1])
