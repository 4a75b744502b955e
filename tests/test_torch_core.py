"""Port parity of the core of the unit graph: ``veles_tpu_torch``'s
config, mutable, distributable, units, plumbing, workflow and
analysis.graph against the JAX package's (pure Python on both sides).

The reference's own core cases run on both packages (``pkg``). Parity
tests then build the same graphs in both and hold the port to the
reference exactly: the run order of the units and their counters
(Repeater loops, barrier and skip gates, ``link_attrs``, the ``demand``
requeue, run on one thread so the order is deterministic), the config
trees after the same operations, the values of the same ``Bool``
expressions under the same flips, and the verifier's codes, severities,
units and messages on the same miswired graphs (messages compared with
the package name normalized).
"""

import pickle
import time
import types

import numpy as np
import pytest

import veles_tpu.analysis.graph as ref_graph
import veles_tpu.config as ref_config
import veles_tpu.mutable as ref_mutable
import veles_tpu.plumbing as ref_plumbing
import veles_tpu.units as ref_units
import veles_tpu.workflow as ref_workflow
import veles_tpu_torch.analysis.graph as port_graph
import veles_tpu_torch.config as port_config
import veles_tpu_torch.mutable as port_mutable
import veles_tpu_torch.plumbing as port_plumbing
import veles_tpu_torch.units as port_units
import veles_tpu_torch.workflow as port_workflow


def _namespace(config, mutable, plumbing, units, workflow, graph):
    return types.SimpleNamespace(
        Config=config.Config, ConfigError=config.ConfigError,
        apply_overrides=config.apply_overrides,
        apply_config_file=config.apply_config_file, root=config.root,
        get=config.get, Bool=mutable.Bool,
        LinkableAttribute=mutable.LinkableAttribute, link=mutable.link,
        Repeater=plumbing.Repeater, FireStarter=plumbing.FireStarter,
        TrivialUnit=units.TrivialUnit, Unit=units.Unit,
        RunAfterStopError=units.RunAfterStopError,
        Workflow=workflow.Workflow, NoMoreJobs=workflow.NoMoreJobs,
        graph=graph)


PACKAGES = {
    "reference": _namespace(ref_config, ref_mutable, ref_plumbing,
                            ref_units, ref_workflow, ref_graph),
    "port": _namespace(port_config, port_mutable, port_plumbing,
                       port_units, port_workflow, port_graph),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class _Holder:
    pass


def _counting(pkg):
    class CountingUnit(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.count = 0

        def run(self):
            self.count += 1

    return CountingUnit


# ---------------------------------------------------------------- mutable

def test_bool_basic_and_live_algebra(pkg):
    b = pkg.Bool(True)
    assert bool(b)
    b <<= False
    assert not bool(b)
    a, b = pkg.Bool(False), pkg.Bool(False)
    c = a | b
    assert not bool(c)
    a <<= True
    assert bool(c)
    d = a & b
    assert not bool(d)
    b <<= True
    assert bool(d) and not bool(~d) and not bool(a ^ b)
    b <<= False
    assert bool(a ^ b)
    e = pkg.Bool(False)
    e <<= a                 # e tracks a
    a <<= False
    assert not bool(e)


def test_bool_pickle_keeps_expressions_live(pkg):
    a = pkg.Bool(False)
    c2 = pickle.loads(pickle.dumps(~a))
    assert bool(c2)
    complete = pkg.Bool(False, name="complete")
    epoch_ended = pkg.Bool(False, name="epoch_ended")
    gate = ~complete & ~epoch_ended
    r_complete, r_epoch, r_gate = pickle.loads(
        pickle.dumps((complete, epoch_ended, gate)))
    assert bool(r_gate)
    r_complete <<= True
    assert not bool(r_gate)
    r_complete <<= False
    r_epoch <<= True
    assert not bool(r_gate)
    frozen = pkg.Bool(lambda: True)
    assert bool(pickle.loads(pickle.dumps(frozen)))


def _random_expression(pkg, rng, leaves, depth):
    if depth == 0 or rng.random() < 0.25:
        return leaves[int(rng.integers(len(leaves)))]
    op = int(rng.integers(4))
    a = _random_expression(pkg, rng, leaves, depth - 1)
    if op == 0:
        return ~a
    b = _random_expression(pkg, rng, leaves, depth - 1)
    return (a | b) if op == 1 else (a & b) if op == 2 else (a ^ b)


@pytest.mark.parametrize("seed", range(4))
def test_bool_expressions_evaluate_like_the_reference(seed):
    """The same random expression DAGs over the same leaves, then the
    same random flips (and ``<<=`` re-pointing): equal values, also
    after a pickle round trip."""
    values = {}
    for key, pkg in PACKAGES.items():
        rng = np.random.default_rng(seed)
        leaves = [pkg.Bool(bool(rng.integers(2)), name="l%d" % i)
                  for i in range(5)]
        exprs = [_random_expression(pkg, rng, leaves, 4)
                 for _ in range(12)]
        out = []
        for _ in range(30):
            i = int(rng.integers(len(leaves)))
            if i and rng.random() < 0.2:
                # re-point to a lower leaf only: the refs stay acyclic
                leaves[i] <<= leaves[int(rng.integers(i))]
            else:
                leaves[i] <<= bool(rng.integers(2))
            out.append([bool(e) for e in exprs])
        restored = pickle.loads(pickle.dumps(exprs))
        out.append([bool(e) for e in restored])
        out.append([e._name for e in exprs])
        values[key] = out
    assert values["port"] == values["reference"]


def test_linkable_attribute_one_way_two_way_and_relink(pkg):
    src, dst = _Holder(), _Holder()
    src.value = 10
    pkg.link(dst, "value", src, "value")
    assert dst.value == 10
    src.value = 20
    assert dst.value == 20
    with pytest.raises(AttributeError):
        dst.value = 30
    pkg.LinkableAttribute(dst, "value", (src, "value"), two_way=True)
    dst.value = 5
    assert src.value == 5
    pkg.LinkableAttribute.unlink(dst, "value")
    src.value = 6
    assert dst.value == 5


# ----------------------------------------------------------------- config

def test_config_autovivify_merge_protect(pkg):
    cfg = pkg.Config("test")
    cfg.a.b.c = 3
    assert cfg.a.b.c == 3
    assert not cfg.a.nonexistent
    cfg.update({"x": {"y": 1, "z": 2}})
    cfg.update({"x": {"z": 3}})
    assert cfg.x.y == 1 and cfg.x.z == 3
    cfg.k = 1
    cfg.protect("k")
    with pytest.raises(pkg.ConfigError):
        cfg.k = 2
    assert pkg.get(cfg.missing, 7) == 7 and pkg.get(cfg.k) == 1
    assert "x" in cfg and "missing" not in cfg


def test_config_trees_equal_the_reference(tmp_path):
    """The same updates, overrides and config file on a fresh tree and
    on the global root give the same trees in both packages."""
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "root.parity_test.file.lr = 0.5\n"
        "root.parity_test.file.layers = (8, 10)\n"
        "root.parity_test.file.update({'nested': {'a': [1, 2]}})\n")
    overrides = ["root.parity_test.ov.n=123", "parity_test.ov.s=hello",
                 "root.parity_test.ov.t=(1, 'x')",
                 "root.parity_test.ov.d={'k': {'j': 2.5}}",
                 "root.parity_test.ov.b=True"]
    trees = {}
    for key, pkg in PACKAGES.items():
        cfg = pkg.Config("test")
        cfg.update({"model": {"layers": [1, 2], "act": "tanh"},
                    "lr": 0.1})
        cfg.model.update({"act": "relu", "extra": {"depth": 3}})
        cfg.empty_probe.never_set   # auto-vivified, stays empty
        try:
            pkg.apply_overrides(overrides)
            pkg.apply_config_file(str(cfg_file))
            with pytest.raises(pkg.ConfigError):
                pkg.apply_overrides(["no_equals_sign"])
            trees[key] = (cfg._as_dict_(),
                          pkg.root.parity_test._as_dict_(), repr(cfg))
        finally:
            pkg.root.parity_test = {}
    assert trees["port"] == trees["reference"]


def test_port_config_defaults():
    """The port's own tree: the defaults its modules read."""
    root = port_config.root
    assert root.common.engine.backend == "auto"
    assert root.common.engine.precision_type == "float32"
    assert root.common.engine.compute_type == "bfloat16"
    assert root.common.train.nan_policy == "warn"
    assert root.common.analysis.verify == "error"
    assert root.common.random.seed == 42
    assert root.common.exceptions.run_after_stop is True
    assert root is not ref_config.root


# ------------------------------------------------------------- unit graph

class _Recorder:
    """A shared run log: (unit name, the unit's run count)."""

    def __init__(self):
        self.log = []


def _recording(pkg, recorder):
    class Rec(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.count = 0

        def run(self):
            self.count += 1
            recorder.log.append((self.name, self.count))

    return Rec


def _serial(wf):
    """Run the graph on the calling thread: without a pool every
    fan-out goes through the trampoline in link order, so the run order
    is deterministic (the same code path as the pool's last branch)."""
    if wf.thread_pool is not None:
        wf.thread_pool.shutdown()
    wf.thread_pool = None


def _graph_loop_with_gates(pkg, recorder):
    """start -> reset -> rpt -> a -> (b, c) -> join (barrier) -> decide
    -> (rpt | end), five passes a run; ``c`` skipped on odd passes (gate_skip), ``b`` reads
    ``a``'s output through link_attrs and is initialized by the demand
    requeue."""
    Rec = _recording(pkg, recorder)

    class Producer(Rec):
        def initialize(self, **kwargs):
            self.output = 0
            return super().initialize(**kwargs)

        def run(self):
            super().run()
            self.output = self.count * 10

    class Consumer(Rec):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.demand("input")

        def initialize(self, **kwargs):
            if self.input is None:
                return True
            return super().initialize(**kwargs)

        def run(self):
            super().run()
            recorder.log.append(("read", self.input))

    wf = pkg.Workflow(None, name="parity")
    rpt = pkg.Repeater(wf)
    a = Producer(wf, name="a")
    b = Consumer(wf, name="b")
    c = Rec(wf, name="c")
    join = Rec(wf, name="join")
    done = pkg.Bool(False, name="done")
    odd = pkg.Bool(False, name="odd")

    class Decide(Rec):
        def run(self):
            super().run()
            done.__ilshift__(self.count % 5 == 0)
            odd.__ilshift__(self.count % 2 == 1)

    class Reset(Rec):
        def run(self):
            super().run()
            done.__ilshift__(False)

    decide = Decide(wf, name="decide")
    reset = Reset(wf, name="reset")
    reset.link_from(wf.start_point)
    rpt.link_from(reset)
    a.link_from(rpt)
    b.link_from(a)
    c.link_from(a)
    join.link_from(b, c)
    decide.link_from(join)
    rpt.link_from(decide)
    wf.end_point.link_from(decide)
    rpt.gate_block = done
    wf.end_point.gate_block = ~done
    c.gate_skip = odd
    b.link_attrs(a, ("input", "output"))
    return wf, [reset, a, b, c, join, decide]


def _graph_fan_out(pkg, recorder):
    """start -> (x, y, z) -> w (barrier over three) -> end, with y
    blocked by gate_block after its first run of a second pass."""
    Rec = _recording(pkg, recorder)
    wf = pkg.Workflow(None, name="fan")
    xs = [Rec(wf, name=n) for n in ("x", "y", "z")]
    w = Rec(wf, name="w")
    for u in xs:
        u.link_from(wf.start_point)
    w.link_from(*xs)
    wf.end_point.link_from(w)
    return wf, xs + [w]


@pytest.mark.parametrize("build", [_graph_loop_with_gates, _graph_fan_out])
def test_graph_run_order_and_counters_equal_the_reference(build):
    """The same graph in both packages, initialized (demand requeue
    included) and run twice: the same unit run order, the same
    counters, the same dependency order, DOT graph and run stats
    names."""
    results = {}
    for key, pkg in PACKAGES.items():
        recorder = _Recorder()
        wf, units = build(pkg, recorder)
        wf.initialize()
        _serial(wf)
        wf.run()
        wf.run()
        results[key] = dict(
            log=recorder.log, counts=[u.count for u in units],
            order=[u.name for u in wf.units_in_dependency_order],
            dot=wf.generate_graph(write_on_disk=False),
            stats=sorted(s[0] for s in wf.get_unit_run_time_stats()),
            ids=[u.id for u in wf.units], run_count=wf.run_count)
    assert results["port"] == results["reference"]
    assert results["port"]["log"]


def test_linear_chain_barrier_and_repeater(pkg):
    CountingUnit = _counting(pkg)
    wf = pkg.Workflow(None, name="t")
    a = CountingUnit(wf, name="a")
    b = CountingUnit(wf, name="b")
    j = CountingUnit(wf, name="join")
    a.link_from(wf.start_point)
    b.link_from(wf.start_point)
    j.link_from(a, b)
    wf.end_point.link_from(j)
    wf.initialize()
    wf.run()
    assert (a.count, b.count, j.count) == (1, 1, 1)
    wf.thread_pool.shutdown()

    wf = pkg.Workflow(None, name="loop")
    rpt = pkg.Repeater(wf)
    work = CountingUnit(wf, name="work")

    class Decide(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.complete = pkg.Bool(False)

        def run(self):
            if work.count >= 5:
                self.complete <<= True

    dec = Decide(wf, name="decide")
    rpt.link_from(wf.start_point)
    work.link_from(rpt)
    dec.link_from(work)
    rpt.link_from(dec)
    rpt.gate_block = dec.complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~dec.complete
    wf.initialize()
    wf.run()
    assert work.count == 5
    wf.thread_pool.shutdown()


def test_gate_skip_propagates(pkg):
    CountingUnit = _counting(pkg)
    wf = pkg.Workflow(None, name="t")
    a = CountingUnit(wf, name="a")
    b = CountingUnit(wf, name="b")
    a.link_from(wf.start_point)
    b.link_from(a)
    wf.end_point.link_from(b)
    a.gate_skip = pkg.Bool(True)
    wf.initialize()
    wf.run()
    assert a.count == 0 and b.count == 1
    wf.thread_pool.shutdown()


def test_initialize_deadlock_detected(pkg):
    class Needy(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.demand("never_set")

    wf = pkg.Workflow(None, name="t")
    n = Needy(wf, name="needy")
    n.link_from(wf.start_point)
    wf.end_point.link_from(n)
    with pytest.raises(RuntimeError, match="deadlock"):
        wf.initialize()
    wf.thread_pool.shutdown()


def test_checksum_stable_and_structural(pkg):
    def build(extra):
        wf = pkg.Workflow(None, name="wf")
        u = pkg.TrivialUnit(wf, name="u")
        u.link_from(wf.start_point)
        last = u
        if extra:
            last = pkg.TrivialUnit(wf, name="v")
            last.link_from(u)
        wf.end_point.link_from(last)
        return wf

    assert build(False).checksum == build(False).checksum
    assert build(False).checksum != build(True).checksum


def test_job_roundtrip_postpone_and_pairing_by_id(pkg):
    class JobUnit(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.jobs_sent = 0
            self.applied = []
            self.updates = []

        def generate_data_for_slave(self, slave=None):
            self.jobs_sent += 1
            return {"minibatch": self.jobs_sent, "unit": self.name}

        def apply_data_from_master(self, data):
            self.applied.append(data)

        def generate_data_for_master(self):
            return {"grad": 1.0}

        def apply_data_from_slave(self, data, slave=None):
            self.updates.append(data)

    def build(name):
        wf = pkg.Workflow(None, name=name)
        a = JobUnit(wf, name="a")
        b = JobUnit(wf, name="b")
        a.link_from(wf.start_point)
        b.link_from(a)
        wf.end_point.link_from(b)
        wf.initialize()
        return wf, a, b

    master, ma, mb = build("master")
    worker, wa, wb = build("worker")
    job = master.generate_data_for_slave("s1")
    received = []
    worker.do_job(dict(reversed(list(job.items()))), None,
                  received.append)
    assert wa.applied[0]["unit"] == "a" and wb.applied[0]["unit"] == "b"
    master.apply_data_from_slave(received[0], "s1")
    assert ma.updates == [{"grad": 1.0}] and mb.updates == [{"grad": 1.0}]
    assert master.generate_initial_data_for_slave("s1") == {}

    class NoData(pkg.TrivialUnit):
        def init_unpickled(self):
            super().init_unpickled()
            self.has_data_for_slave = False

    wf = pkg.Workflow(None, name="m")
    NoData(wf, name="nd").link_from(wf.start_point)
    wf.end_point.link_from(wf.units[-1])
    wf.initialize()
    assert wf.generate_data_for_slave("s") is False

    class Done(pkg.TrivialUnit):
        def generate_data_for_slave(self, slave=None):
            raise pkg.NoMoreJobs()

    wf = pkg.Workflow(None, name="done")
    Done(wf, name="d").link_from(wf.start_point)
    wf.end_point.link_from(wf.units[-1])
    with pytest.raises(pkg.NoMoreJobs):
        wf.generate_data_for_slave("s")
    for w in (master, worker):
        w.thread_pool.shutdown()


@pytest.mark.parametrize("closing_edge_last", [False, True])
def test_long_cycle_no_recursion(pkg, closing_edge_last):
    CountingUnit = _counting(pkg)
    wf = pkg.Workflow(None, name="loop")
    rpt = pkg.Repeater(wf)
    body = CountingUnit(wf, name="body")
    done = pkg.Bool(False, name="done")
    rpt.link_from(wf.start_point)
    body.link_from(rpt)
    if closing_edge_last:
        wf.end_point.link_from(body)
        rpt.link_from(body)
    else:
        rpt.link_from(body)
        wf.end_point.link_from(body)
    wf.end_point.gate_block = ~done
    rpt.gate_block = done
    orig_run = body.run

    def run():
        orig_run()
        if body.count >= 3000:
            done.__ilshift__(True)

    body.run = run
    wf.initialize()
    wf.run()
    assert body.count >= 3000
    wf.thread_pool.shutdown()


def test_workflow_pickle_keeps_gates_and_links_live(pkg):
    wf = pkg.Workflow(None, name="wf")
    u = pkg.TrivialUnit(wf, name="u")
    v = pkg.TrivialUnit(wf, name="v")
    u.link_from(wf.start_point)
    v.link_from(u)
    wf.end_point.link_from(v)
    flag = pkg.Bool(False, name="flag")
    u.complete = flag
    wf.end_point.gate_block = ~flag
    u.payload = 41
    v.link_attrs(u, "payload")
    wf2 = pickle.loads(pickle.dumps(wf))
    u2 = next(x for x in wf2.units if x.name == "u")
    v2 = next(x for x in wf2.units if x.name == "v")
    assert bool(wf2.end_point.gate_block)
    u2.complete <<= True
    assert not bool(wf2.end_point.gate_block)
    assert v2.payload == 41
    u2.payload = 99
    assert v2.payload == 99


def test_run_after_stop_firestarter_and_rerun(pkg):
    CountingUnit = _counting(pkg)
    wf = pkg.Workflow(None, name="wf")
    u = CountingUnit(wf, name="u")
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    wf.initialize()
    wf.run()
    wf.stop()
    assert u.stopped
    wf.stopped = False
    with pytest.raises(pkg.RunAfterStopError):
        u._check_gate_and_run(None)
    wf.run()                       # an explicit re-run restarts cleanly
    assert u.count == 2
    fs = pkg.FireStarter(wf, units=[u])
    u.stop()
    fs.run()
    assert not u.stopped
    wf.thread_pool.shutdown()


def test_unit_failure_propagates(pkg):
    class Boom(pkg.TrivialUnit):
        def run(self):
            raise ValueError("boom")

    wf = pkg.Workflow(None, name="wf")
    b = Boom(wf, name="boom")
    b.link_from(wf.start_point)
    wf.end_point.link_from(b)
    wf.initialize()
    with pytest.raises(ValueError, match="boom"):
        wf.run()
    wf.thread_pool.shutdown()


def test_stall_detected_and_unknown_kwargs(pkg):
    """A gate that never opens at run time (not provable statically)
    reports a stall instead of hanging; a misspelled kwarg fails
    fast."""
    CountingUnit = _counting(pkg)
    wf = pkg.Workflow(None, name="stall")
    u = CountingUnit(wf, name="u")
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    wf.end_point.gate_block = pkg.Bool(lambda: True)
    wf.initialize()
    with pytest.raises(RuntimeError, match="stalled"):
        wf.run()
    wf.thread_pool.shutdown()
    with pytest.raises(TypeError, match="unexpected kwargs"):
        pkg.TrivialUnit(wf, nmae="typo")


def test_unit_ids_unique_after_removal(pkg):
    wf = pkg.Workflow(None, name="wf")
    a = pkg.TrivialUnit(wf)
    b = pkg.TrivialUnit(wf)
    a.workflow = pkg.Workflow(None, name="other")
    c = pkg.TrivialUnit(wf)
    ids = [u.id for u in wf.units]
    assert len(ids) == len(set(ids))
    assert b.id != c.id


def test_nested_workflow_run_inside_unit(pkg):
    class InnerCounter(pkg.TrivialUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.count = 0
            self.done = pkg.Bool(False, name="done")

        def run(self):
            self.count += 1
            if self.count >= 50:
                self.done <<= True

    def make_inner():
        inner = pkg.Workflow(None, name="inner")
        unit = InnerCounter(inner)
        rpt = pkg.Repeater(inner)
        rpt.link_from(inner.start_point)
        unit.link_from(rpt)
        rpt.link_from(unit)
        rpt.gate_block = unit.done
        inner.end_point.link_from(unit)
        inner.end_point.gate_block = ~unit.done
        inner.initialize()
        return inner, unit

    counts = []

    class Outer(pkg.TrivialUnit):
        def run(self):
            for _ in range(3):
                inner, unit = make_inner()
                inner.run()
                inner.thread_pool.shutdown()
                counts.append(unit.count)

    outer = pkg.Workflow(None, name="outer")
    runner = Outer(outer)
    runner.link_from(outer.start_point)
    outer.end_point.link_from(runner)
    outer.initialize()
    t0 = time.time()
    outer.run()
    outer.thread_pool.shutdown()
    assert time.time() - t0 < 30
    assert counts == [50, 50, 50]


def test_port_package_export_writes_an_archive_the_reference_reads(
        tmp_path):
    """A graph without exportable units exports an empty package in
    the reference's layout (the full parity: tests/test_torch_package.py)."""
    from veles_tpu.aot.package import read_package
    wf = port_workflow.Workflow(None, name="wf")
    path = str(tmp_path / "model.zip")
    assert wf.package_export(path) == path
    contents, arrays = read_package(path)
    assert contents["workflow"] == "Workflow"
    assert contents["units"] == [] and arrays == {}
    assert contents["checksum"] == wf.checksum


# -------------------------------------------------------------- verifier

def _miswired(pkg, case):
    """One miswired (or clean) graph per case, built alike in both
    packages."""
    wf = pkg.Workflow(None, name=case)
    T = pkg.TrivialUnit
    if case == "clean":
        a = T(wf, name="a")
        a.link_from(wf.start_point)
        wf.end_point.link_from(a)
    elif case == "orphan":                       # WG001
        a = T(wf, name="a")
        a.link_from(wf.start_point)
        wf.end_point.link_from(a)
        T(wf, name="orphan")
    elif case == "no_end":                       # WG002 (warning)
        a = T(wf, name="a")
        a.link_from(wf.start_point)
    elif case == "cycle":                        # WG003 + WG002
        a, b = T(wf, name="a"), T(wf, name="b")
        a.link_from(wf.start_point, b)
        b.link_from(a)
        wf.end_point.link_from(b)
    elif case == "dead_barrier":                 # WG004
        a, dead = T(wf, name="a"), T(wf, name="dead")
        src = T(wf, name="src")
        a.link_from(wf.start_point)
        dead.link_from(src)
        j = T(wf, name="join")
        j.link_from(a, dead)
        wf.end_point.link_from(a)
        src.link_from(j)
    elif case == "dangling":                     # WG005 error + warning
        a, b = T(wf, name="a"), T(wf, name="b")
        a.link_from(wf.start_point)
        b.link_from(a)
        wf.end_point.link_from(b)
        gone = T(pkg.Workflow(None, name="other"), name="gone")
        gone.value = 1
        b.link_attrs(gone, "value")
        a.link_attrs(b, ("typo", "no_such_attr"))
    elif case == "relinked":                     # WG006
        a, b = T(wf, name="a"), T(wf, name="b")
        a.link_from(wf.start_point)
        b.link_from(a)
        wf.end_point.link_from(b)
        a.x, a.y = 1, 2
        b.link_attrs(a, ("v", "x"))
        b.link_attrs(a, ("v", "y"))
    elif case == "demands":                      # WG007 error + warning
        a, b = T(wf, name="a"), T(wf, name="b")
        a.link_from(wf.start_point)
        b.link_from(a)
        wf.end_point.link_from(b)
        a.demand("p")
        b.demand("q", "never")
        a.link_attrs(b, ("p", "q"))
        b.link_attrs(a, ("q", "p"))
    elif case == "blocked":                      # WG008
        a = T(wf, name="a")
        a.link_from(wf.start_point)
        wf.end_point.link_from(a)
        a.gate_block = pkg.Bool(True)
    return wf


CASES = ["clean", "orphan", "no_end", "cycle", "dead_barrier",
         "dangling", "relinked", "demands", "blocked"]


@pytest.mark.parametrize("case", CASES)
def test_verifier_codes_equal_the_reference(case):
    """The same miswired graph: the same codes, severities, units and
    (package name aside) messages, and ``initialize`` raises in both
    exactly when an error is among them."""
    report = {}
    for key, pkg in PACKAGES.items():
        wf = _miswired(pkg, case)
        diags = pkg.graph.verify_graph(wf)
        rows = [(d.code, d.severity, d.units,
                 d.message.replace("veles_tpu_torch.", "veles_tpu."))
                for d in diags]
        errors = any(d.is_error for d in diags)
        raised = False
        try:
            wf.initialize()
        except pkg.graph.WorkflowVerificationError as e:
            raised = True
            assert [d.code for d in e.diagnostics] == \
                [d.code for d in diags]
        except RuntimeError:
            pass   # a demand deadlock after a clean verify
        if wf.thread_pool is not None:
            wf.thread_pool.shutdown()
        report[key] = (rows, errors, raised,
                       pkg.graph.format_report(diags, case).replace(
                           "veles_tpu_torch.", "veles_tpu."))
    assert report["port"] == report["reference"]
    rows, errors, raised, _ = report["port"]
    assert raised == errors
    if case != "clean":
        assert rows


@pytest.mark.parametrize("mode", ["warn", "off"])
def test_verify_policy_modes(pkg, mode):
    """"warn" logs errors instead of raising, "off" skips the pass;
    the config key picks the default."""
    wf = _miswired(pkg, "cycle")
    diags = [str(d) for d in wf.verify(mode)]
    assert (diags == []) == (mode == "off")
    saved = pkg.root.common.analysis.verify
    pkg.root.common.analysis.verify = mode
    try:
        assert [str(d) for d in wf.verify()] == diags
    finally:
        pkg.root.common.analysis.verify = saved
