"""Port parity of the service subsystems (``veles_tpu_torch.ensemble`` and
``veles_tpu_torch.genetics`` against the JAX package's), on the CPU.

Ensembles: three MNIST members trained in-process from the
``"ensemble"`` stream's seeds; the seeds, each member's metrics and
fused params, and the tester's ``ensemble_error_pt`` and
``ensemble_n_err`` are the reference's (f32: equal error counts; the
params within 1e-4 of their scale, the two frameworks' sum orders
differ); the job methods hand members out and take results back
in-process (the cluster runs are tests/test_torch_farm_users.py's).
Genetics: a seeded population with a deterministic evaluator evolves
exactly as the reference's, both encodings (its genes are host floats
drawn from the same numpy streams); the Gray code round-trips; the
optimizer's workflow and job methods behave as the reference's; a
scheduler tenant takes exactly one quantum per evaluation.
"""

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.ensemble as R_ensemble
import veles_tpu.genetics as R_genetics
import veles_tpu.loader.datasets as R_datasets
import veles_tpu.models.mnist as R_mnist
import veles_tpu.prng as R_prng
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.ensemble as P_ensemble
import veles_tpu_torch.genetics as P_genetics
import veles_tpu_torch.loader.datasets as P_datasets
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.sched import Scheduler
from veles_tpu_torch.workflow import NoMoreJobs

torch.set_num_threads(1)

TOL = 1e-4

REF = dict(backends=R_backends, config=R_config, prng=R_prng,
           ensemble=R_ensemble, genetics=R_genetics, datasets=R_datasets,
           mnist=R_mnist)
PORT = dict(backends=P_backends, config=P_config, prng=P_prng,
            ensemble=P_ensemble, genetics=P_genetics, datasets=P_datasets,
            mnist=P_mnist)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 17
    R_prng.reset()
    P_prng.reset()
    yield
    for c, p, (ct, seed) in zip((R_config, P_config), (R_prng, P_prng),
                                saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# -- ensemble ---------------------------------------------------------------

def _member_factory(mods, device):
    def factory(index, seed, train_ratio):
        mods["config"].root.common.random.seed = seed
        mods["prng"].reset()
        wf = mods["mnist"].MnistWorkflow(
            layers=(16, 10), max_epochs=1,
            loader_kwargs=dict(n_train=200, n_valid=80, minibatch_size=40,
                               train_ratio=train_ratio))
        wf.thread_pool = None
        wf.initialize(device=device)
        wf.run()
        return wf
    return factory


def _ensemble(mods):
    device = mods["backends"].Device(backend="cpu")
    wf = mods["ensemble"].EnsembleTrainerWorkflow(
        model_factory=_member_factory(mods, device), size=3,
        train_ratio=0.8)
    wf.thread_pool = None
    wf.initialize(device=device)
    wf.run()
    rand = mods["prng"].RandomGenerator("held_out", seed=123)
    data, labels = mods["datasets"].synthetic_digits(200, rand)
    test_wf = mods["ensemble"].EnsembleTesterWorkflow(members=wf.members)
    test_wf.thread_pool = None
    test_wf.tester.data = data
    test_wf.tester.labels = labels
    test_wf.initialize(device=device)
    test_wf.run()
    return wf, test_wf


def test_ensemble_matches_reference():
    (r_wf, r_test), (p_wf, p_test) = (_ensemble(m) for m in (REF, PORT))
    p_members, r_members = p_wf.members, r_wf.members
    assert all(m is not None for m in p_members)
    assert [m["seed"] for m in p_members] == [m["seed"] for m in r_members]
    assert len({m["seed"] for m in p_members}) == 3
    for p, r in zip(p_members, r_members):
        assert p["index"] == r["index"]
        assert p["train_ratio"] == r["train_ratio"]
        assert sorted(p["metrics"]) == sorted(r["metrics"])
        for key, want in r["metrics"].items():
            if isinstance(want, float):      # the loss
                assert p["metrics"][key] == pytest.approx(want, rel=TOL)
            else:                            # counts, error percentages
                assert p["metrics"][key] == want, key
        assert tuple(p["specs"]) == tuple(r["specs"])
        for pl, rl in zip(p["params"], r["params"]):
            for key in rl:
                assert _rel(pl[key], rl[key]) < TOL
    assert bool(p_wf.trainer.complete)
    assert p_wf.gather_results()["members"] == \
        [m["metrics"] for m in p_members]
    p_res, r_res = p_test.gather_results(), r_test.gather_results()
    assert p_res["ensemble_n_err"] == r_res["ensemble_n_err"]
    assert p_res["ensemble_error_pt"] == r_res["ensemble_error_pt"]
    assert bool(p_test.tester.complete)


def test_ensemble_job_methods_in_process():
    """A coordinator's trainer hands out member indices, a worker's
    trains the one it was given, and the result lands in the
    coordinator's slot; a dropped worker's members are handed out
    again; once complete, NoMoreJobs."""
    device = P_backends.Device(backend="cpu")
    factory = _member_factory(PORT, device)
    master = P_ensemble.EnsembleTrainerWorkflow(model_factory=factory,
                                                size=2)
    worker = P_ensemble.EnsembleTrainerWorkflow(model_factory=factory,
                                                size=2)
    mt, wt = master.trainer, worker.trainer
    job = mt.generate_data_for_slave("w1")
    assert job["index"] == 0 and mt._outstanding_ == {"w1": [0]}
    mt.drop_slave("w1")
    assert mt._outstanding_ == {} and mt.has_data_for_slave
    job = mt.generate_data_for_slave("w1")
    second = mt.generate_data_for_slave("w2")
    assert second["index"] == 1
    assert mt.generate_data_for_slave("w3") is False
    mt.retract_data_for_slave("w2")
    assert "w2" not in mt._outstanding_
    worker.is_standalone, worker.is_slave = False, True
    wt.apply_data_from_master(job)
    wt.run()
    mt.apply_data_from_slave(wt.generate_data_for_master(), "w1")
    assert mt.results[0]["index"] == 0 and not bool(mt.complete)
    wt.apply_data_from_master(mt.generate_data_for_slave("w2"))
    wt.run()
    mt.apply_data_from_slave(wt.generate_data_for_master(), "w2")
    assert bool(mt.complete)
    with pytest.raises(NoMoreJobs):
        mt.generate_data_for_slave("w1")


# -- genetics ---------------------------------------------------------------

def _tuneables(mods):
    g = mods["genetics"]
    return [g.Tuneable("root.test_ga.x", g.Range(0.0, -5.0, 5.0)),
            g.Tuneable("root.test_ga.lr", g.Range(0.01, 1e-4, 1.0)),
            g.Tuneable("root.test_ga.n", g.Range(8, 2, 64))]


def _evaluate(values):
    x = values["root.test_ga.x"]
    return -(x - 1.25) ** 2 - abs(np.log10(values["root.test_ga.lr"]) + 2) \
        - abs(values["root.test_ga.n"] - 20) / 10.0


@pytest.mark.parametrize("encoding", ["real", "gray"])
def test_population_evolves_as_the_reference(encoding):
    histories = []
    for mods in (REF, PORT):
        mods["prng"].reset()
        pop = mods["genetics"].Population(_tuneables(mods), size=8,
                                          encoding=encoding)
        history = []
        for _ in range(3):
            for c in pop.unevaluated:
                c.fitness = _evaluate(c.config_values(pop.tuneables))
            history.append([(list(c.genes), c.fitness)
                            for c in pop.chromosomes])
            pop.next_generation()
        history.append([list(c.genes) for c in pop.chromosomes])
        history.append((pop.best.fitness,
                        pop.best.config_values(pop.tuneables),
                        pop.generation))
        histories.append(history)
    assert histories[1] == histories[0]


def test_gray_encoding_round_trip():
    pop = P_genetics.Population(_tuneables(PORT), size=4, encoding="gray")
    ref = R_genetics.Population(_tuneables(REF), size=4, encoding="gray")
    for t, rt in zip(pop.tuneables, ref.tuneables):
        for u in (0.0, 0.1234, 0.5, 0.99, 1.0):
            v = t.from_unit(u)
            code = pop._encode(t, v)
            assert code == ref._encode(rt, v)
            assert pop._decode(t, code) == ref._decode(rt, code)
            step = (t.range.max_value - t.range.min_value) / \
                ((1 << P_genetics.Population.GRAY_BITS) - 1)
            if not t.log:
                assert abs(pop._decode(t, code) - v) <= step
        for q in range(0, 1 << 16, 4099):
            gray = q ^ (q >> 1)
            assert abs(t.to_unit(pop._decode(t, gray)) -
                       q / ((1 << 16) - 1)) < 1e-9
    with pytest.raises(ValueError, match="encoding"):
        P_genetics.Population(_tuneables(PORT), encoding="binary")


def test_config_ranges_and_paths():
    root = P_config.root
    root.test_scan.a = P_genetics.Range(0.5, 0.0, 1.0)
    root.test_scan.deep.b = P_genetics.Range(3, 1, 10)
    try:
        found = P_genetics.scan_config_ranges(root.test_scan,
                                              "root.test_scan")
        assert sorted(t.path for t in found) == ["root.test_scan.a",
                                                 "root.test_scan.deep.b"]
        assert [t.range.is_integer for t in sorted(
            found, key=lambda t: t.path)] == [False, True]
        P_genetics.set_config_path("root.test_scan.deep.b", 7)
        assert root.test_scan.deep.b == 7
    finally:
        del root.__dict__["test_scan"]


def test_optimization_workflow_matches_reference():
    out = []
    for mods in (REF, PORT):
        mods["prng"].reset()
        calls = []

        def evaluate(values):
            calls.append(dict(values))
            return _evaluate(values)

        wf = mods["genetics"].OptimizationWorkflow(
            evaluate=evaluate, size=6, generations=3,
            tuneables=_tuneables(mods))
        wf.thread_pool = None
        wf.initialize(device=mods["backends"].Device(backend="cpu"))
        wf.run()
        assert wf.optimizer.population.generation == 3
        assert len(calls) == 6 + 2 * (6 - 2)
        out.append((calls, wf.gather_results()))
    assert out[1] == out[0]


def test_default_evaluator_trains_the_model():
    """``default_evaluator`` patches the config, trains the model
    workflow on the given device and returns -min validation error."""
    P_config.root.test_ga_model.epochs = 1

    def factory():
        return P_mnist.MnistWorkflow(
            layers=(8, 10), max_epochs=P_config.root.test_ga_model.epochs,
            loader_kwargs=dict(n_train=60, n_valid=20, minibatch_size=20))

    try:
        fitness = P_genetics.default_evaluator(
            factory, device=P_backends.Device(backend="cpu"))(
                {"root.test_ga_model.epochs": 2})
        assert P_config.root.test_ga_model.epochs == 2
        assert -100.0 <= fitness <= 0.0
    finally:
        del P_config.root.__dict__["test_ga_model"]


def test_postponed_generation_keeps_in_flight_jobs():
    wf = P_genetics.OptimizationWorkflow(
        evaluate=lambda cfg: 0.0, size=2, generations=1,
        tuneables=_tuneables(PORT))
    wf.thread_pool = None
    wf.is_standalone, wf.is_master = False, True
    wf.initialize(device=P_backends.Device(backend="cpu"))
    assert wf.generate_data_for_slave("w1") is not False
    assert wf.generate_data_for_slave("w2") is not False
    wf.optimizer.apply_data_from_slave(
        {"index": 1, "fitness": 0.5, "generation": 0}, "w2")
    assert wf.optimizer.has_data_for_slave
    assert wf.generate_data_for_slave("w1") is False
    assert wf.optimizer._outstanding_["w1"] == [0]
    assert wf.generate_data_for_slave("w2") is False
    assert wf.optimizer._outstanding_["w1"] == [0]
    wf.optimizer.apply_data_from_slave(
        {"index": 0, "fitness": 0.25, "generation": 0}, "w1")
    assert bool(wf.optimizer.complete)
    with pytest.raises(NoMoreJobs):
        wf.optimizer.generate_data_for_slave("w1")


def test_genetics_tenant_takes_one_quantum_per_evaluation():
    """A GA tenant yields between chromosome evaluations: one quantum
    each, and no unit-level ``sched_tenant_`` marker (which would wrap
    a whole generation in one quantum)."""
    sched = Scheduler()
    tenant = sched.register("tune", weight=1)
    wf = P_genetics.OptimizationWorkflow(
        evaluate=lambda cfg: -(cfg["root.t.x"] ** 2), size=6,
        generations=2,
        tuneables=[P_genetics.Tuneable("root.t.x",
                                       P_genetics.Range(0.0, -5.0, 5.0))],
        sched_tenant=tenant)
    opt = wf.optimizer
    assert getattr(opt, "sched_tenant_", None) is None
    evaluations = 0
    for _ in range(2):
        evaluations += len(opt.population.unevaluated)
        opt.run()
    snap = sched.snapshot()
    sched.stop()
    assert evaluations == 6 + (6 - 2)
    assert snap["tenants"]["tune"]["quanta"] == evaluations
    assert bool(opt.complete)
