"""Port parity of the service subsystems against the JAX package's, on
the CPU: ``ensemble`` and ``genetics``; web status, plotting,
publishing, ``Shell``, the frontend and the manhole.

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

Web status and plotting: the plotter units emit the reference's spec
dicts for the same inputs; a port ``StatusReporter`` feeds a reference
``WebStatusServer`` and the reverse, with equal ``/status.json`` and
``/metrics`` documents. Specs and status documents hold host values
only: a plotter turns a tensor it is linked to into numpy; a spec or a
status document that still holds a tensor is refused (TypeError). The
renderer child and the web-status daemon start no CUDA context.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.ensemble as R_ensemble
import veles_tpu.genetics as R_genetics
import veles_tpu.loader.datasets as R_datasets
import veles_tpu.memory as R_memory
import veles_tpu.models.mnist as R_mnist
import veles_tpu.plotting as R_plotting
import veles_tpu.prng as R_prng
import veles_tpu.publishing.publisher as R_publisher
import veles_tpu.units as R_units
import veles_tpu.web_status as R_web
import veles_tpu.workflow as R_workflow
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.ensemble as P_ensemble
import veles_tpu_torch.genetics as P_genetics
import veles_tpu_torch.loader.datasets as P_datasets
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.plotting as P_plotting
import veles_tpu_torch.prng as P_prng
import veles_tpu_torch.publishing.publisher as P_publisher
import veles_tpu_torch.units as P_units
import veles_tpu_torch.web_status as P_web
import veles_tpu_torch.workflow as P_workflow
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


# -- web status, plotting, publishing, Shell, frontend, manhole -------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVC_REF = dict(memory=R_memory, plotting=R_plotting, workflow=R_workflow,
               publisher=R_publisher, units=R_units)
SVC_PORT = dict(memory=P_memory, plotting=P_plotting, workflow=P_workflow,
                publisher=P_publisher, units=P_units)


def _plain_wf(mods):
    wf = mods["workflow"].Workflow()
    wf.thread_pool = None
    return wf


def _plot_inputs(kind, mods, rng):
    """(unit class name, kwargs, input attribute, value) of one kind."""
    arr = mods["memory"].Array
    if kind == "curve":
        return "AccumulatingPlotter", {}, "input", [1.5, 0.25, 3.0]
    if kind == "matrix":
        return "MatrixPlotter", {}, "input", rng.integers(0, 9, (4, 4))
    if kind == "histogram":
        return "Histogram", {"n_bins": 7}, "input", arr(
            data=rng.random(60).astype(np.float32))
    if kind == "image":
        return "ImagePlotter", {}, "input", rng.random((2, 5, 5, 3))
    return "MultiHistogram", {"n_bins": 5}, "inputs", [
        arr(data=rng.random(30).astype(np.float32)),
        rng.standard_normal(40).astype(np.float32)]


@pytest.mark.parametrize("kind", ["curve", "matrix", "histogram", "image",
                                  "multi_histogram"])
def test_plotter_specs_match_reference(kind):
    """Each plotter unit publishes, for the same inputs, the reference's
    spec dicts, dict for dict (an accumulating curve grows per run)."""
    specs = []
    for mods in (SVC_REF, SVC_PORT):
        rng = np.random.default_rng(5)
        wf = _plain_wf(mods)
        sink = mods["plotting"].InlineSink()
        wf.graphics_sink_ = sink
        name, kwargs, attr, value = _plot_inputs(kind, mods, rng)
        unit = getattr(mods["plotting"], name)(wf, plot_name=kind,
                                               **kwargs)
        for v in (value if kind == "curve" else [value]):
            setattr(unit, attr, v)
            unit.run()
        specs.append(sink.specs)
    assert specs[1] == specs[0]
    assert len(specs[1]) == (3 if kind == "curve" else 1)


def test_plotters_turn_tensors_into_numpy():
    """A plotter linked to a tensor (or an Array holding one) reads it
    into numpy on the graph's thread: its spec equals the numpy
    input's, and holds no tensor."""
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 5, (3, 3))
    vals = rng.random(40).astype(np.float32)
    for_tensor, for_numpy = P_plotting.InlineSink(), P_plotting.InlineSink()
    for sink, wrap in ((for_tensor, torch.from_numpy),
                       (for_numpy, lambda a: a)):
        wf = _plain_wf(SVC_PORT)
        wf.graphics_sink_ = sink
        m = P_plotting.MatrixPlotter(wf, plot_name="m")
        m.input = wrap(mat)
        m.run()
        h = P_plotting.Histogram(wf, plot_name="h", n_bins=4)
        h.input = wrap(vals)
        h.run()
        c = P_plotting.AccumulatingPlotter(wf, plot_name="c")
        c.input = wrap(np.float32(0.5)) if wrap is not torch.from_numpy \
            else torch.tensor(0.5)
        c.run()
    assert for_tensor.specs == for_numpy.specs
    json.dumps(for_tensor.specs)  # plain JSON types only


def test_specs_and_status_documents_refuse_tensors(tmp_path):
    """A spec or a status document that holds a tensor is refused with
    TypeError (pickling one would carry its storage into the renderer;
    a device read would wait on the training stream)."""
    spec = {"kind": "curve", "name": "c", "y": [torch.tensor(1.0)]}
    with pytest.raises(TypeError, match="host values"):
        P_plotting.InlineSink().publish(spec)
    server = P_plotting.GraphicsServer(out_dir=str(tmp_path),
                                       spawn_process=False)
    try:
        with pytest.raises(TypeError, match="host values"):
            server.publish({"kind": "matrix", "name": "m",
                            "matrix": torch.eye(2)})
    finally:
        server.close()
    reporter = P_web.StatusReporter("http://127.0.0.1:1", "r")
    with pytest.raises(TypeError, match="host values"):
        reporter.post({"best_error": torch.tensor(3.0)})


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def _strip(status):
    return {run: {k: v for k, v in doc.items()
                  if k not in ("received", "age")}
            for run, doc in status.items()}


def test_status_and_metrics_documents_cross_package():
    """A port StatusReporter feeds a reference WebStatusServer, and a
    reference reporter feeds a port server, the same documents (with
    both packages' obs registries on the wire): ``/status.json``,
    ``/history.json``, ``/metrics`` and its Prometheus exposition are
    equal."""
    from veles_tpu.obs import metrics as R_metrics
    from veles_tpu_torch.obs import metrics as P_metrics
    docs = [{"mode": "standalone", "workflow": "MnistWorkflow",
             "device": "cpu", "epoch": e, "best_error": err,
             "run_time": 1.5 * e, "workers": {"w1": {"state": "WORK"}},
             "metrics": P_metrics.REGISTRY.as_wire() +
             R_metrics.REGISTRY.as_wire(),
             "slowest": [{"name": "apply", "trace": "ab", "total_ms": 3}]}
            for e, err in ((0, 40.0), (1, 12.5))]
    ref_srv, port_srv = R_web.WebStatusServer(), P_web.WebStatusServer()
    try:
        port_rep = P_web.StatusReporter(ref_srv.url, "run7", interval=99)
        ref_rep = R_web.StatusReporter(port_srv.url, "run7", interval=99)
        for doc in docs:
            assert port_rep.post(doc) and ref_rep.post(doc)
        a = json.loads(_get(ref_srv.url + "/status.json"))
        b = json.loads(_get(port_srv.url + "/status.json"))
        assert _strip(a) == _strip(b) and a["run7"]["epoch"] == 1
        ha = json.loads(_get(ref_srv.url + "/history.json"))
        hb = json.loads(_get(port_srv.url + "/history.json"))
        strip_t = [[{k: v for k, v in h.items() if k != "t"}
                    for h in hist["run7"]] for hist in (ha, hb)]
        assert strip_t[0] == strip_t[1] == [
            {"epoch": 0, "best_error": 40.0},
            {"epoch": 1, "best_error": 12.5}]
        assert json.loads(_get(ref_srv.url + "/metrics")) == \
            json.loads(_get(port_srv.url + "/metrics"))
        prom = _get(port_srv.url + "/metrics?format=prometheus").decode()
        assert prom == _get(ref_srv.url +
                            "/metrics?format=prometheus").decode()
        assert 'run="run7"' in prom
        page = _get(port_srv.url + "/").decode()
        for table in ("schedTable", "fleetTable", "slowTable"):
            assert table in page
    finally:
        ref_srv.close()
        port_srv.close()


def test_web_status_rejects_bad_posts_and_bounds_history():
    server = P_web.WebStatusServer()
    try:
        req = urllib.request.Request(server.url + "/update", data=b"{",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 400
        for i in range(P_web.HISTORY_LIMIT + 5):
            server.store.update({"id": "r", "epoch": i})
        assert len(server.store.history()["r"]) == P_web.HISTORY_LIMIT
        assert server.store.history()["r"][-1]["epoch"] == \
            P_web.HISTORY_LIMIT + 4
    finally:
        server.close()


def _block_matplotlib(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("matplotlib blocked for this test")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)


@pytest.mark.parametrize("branch", ["matplotlib", "jsonl"])
def test_workflow_plotters_write_through_inline_sink(branch, tmp_path,
                                                     monkeypatch):
    """StandardWorkflow(plotters=True) under the port's Launcher: one
    validation-error curve and one confusion matrix an epoch, each
    epoch's plots read before the next minibatch starts; rendered as
    PNGs, or appended to ``plots.jsonl`` where matplotlib is missing."""
    if branch == "matplotlib":
        pytest.importorskip("matplotlib")
    else:
        _block_matplotlib(monkeypatch)
    from veles_tpu_torch.launcher import Launcher
    launcher = Launcher()
    wf = P_mnist.MnistWorkflow(launcher, layers=(16, 10), max_epochs=3,
                               plotters=True,
                               loader_kwargs=dict(n_train=120, n_valid=40,
                                                  minibatch_size=40))
    sink = P_plotting.InlineSink(str(tmp_path))
    try:
        launcher.initialize(backend="cpu")
        wf.graphics_sink_ = sink
        launcher.run()
    finally:
        launcher.stop()
    names = [s["name"] for s in sink.specs]
    epochs = len(wf.decision.epoch_errors[1])
    assert names.count("validation_error") == \
        names.count("confusion") >= epochs - 1 >= 1
    curve = [s for s in sink.specs if s["name"] == "validation_error"][-1]
    assert curve["y"] == sorted(curve["y"], reverse=True)
    assert all(np.asarray(s["matrix"]).sum() == 40 for s in sink.specs
               if s["name"] == "confusion")
    if branch == "matplotlib":
        assert sorted(os.listdir(tmp_path)) == ["confusion.png",
                                                "validation_error.png"]
    else:
        assert os.listdir(tmp_path) == ["plots.jsonl"]
        lines = (tmp_path / "plots.jsonl").read_text().splitlines()
        # the two plotters publish from pool threads: compare as sets
        assert sorted(lines) == sorted(json.dumps(s) for s in sink.specs)
        with pytest.raises(ImportError):
            P_publisher.render_pdf(P_publisher.gather_info(wf))


def test_graphics_server_child_and_broadcast(tmp_path):
    """The renderer child draws every published spec; a broadcast
    subscriber (``_client_main``, the child's own body) gets the same
    stream; close() drains both and stops every thread and process."""
    server = P_plotting.GraphicsServer(out_dir=str(tmp_path / "child"),
                                       spawn_process=True,
                                       broadcast="127.0.0.1:0")
    sub_out = tmp_path / "sub"
    host, port = server.broadcast_endpoint
    sub = threading.Thread(target=P_plotting._client_main, args=(
        ["--endpoint", "%s:%d" % (host, port), "--out", str(sub_out)],))
    sub.start()
    try:
        deadline = time.monotonic() + 30
        while not server._subscribers:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        server.publish({"kind": "curve", "name": "child_curve",
                        "y": [1.0, 0.5, 0.25]})
        server.publish({"kind": "histogram", "name": "h",
                        "counts": [1, 2], "edges": [0.0, 0.5, 1.0]})
    finally:
        server.close()
        sub.join(timeout=30)
    assert not sub.is_alive()
    for out in (tmp_path / "child", sub_out):
        written = sorted(os.listdir(out))
        assert written in (["child_curve.png", "h.png"], ["plots.jsonl"])
    assert server._child.returncode == 0


def _renderer_stand_in(monkeypatch, code):
    """Spawn ``python -c code`` in place of the renderer child; the
    endpoint the server passes is its ``sys.argv[2]``."""
    popen = subprocess.Popen

    def spawn(cmd, **kwargs):
        return popen([sys.executable, "-c", code] + list(cmd[3:]),
                     **kwargs)
    monkeypatch.setattr(P_plotting.subprocess, "Popen", spawn)


def test_graphics_server_waits_for_a_slow_renderer(tmp_path, monkeypatch):
    """A renderer that connects after the reference's 10 s accept
    timeout would have passed still gets its connection: the server
    waits while the child lives (here 1.5 s late, the wait scaled to
    12x that)."""
    monkeypatch.setattr(P_plotting, "RENDERER_START_S", 18.0)
    _renderer_stand_in(monkeypatch, (
        "import socket, sys, time\n"
        "time.sleep(1.5)\n"
        "host, port = sys.argv[2].rsplit(':', 1)\n"
        "s = socket.create_connection((host, int(port)))\n"
        "s.recv(1)\n"))
    t0 = time.monotonic()
    server = P_plotting.GraphicsServer(out_dir=str(tmp_path),
                                       spawn_process=True)
    try:
        assert time.monotonic() - t0 >= 1.5
        assert server._conn is not None
    finally:
        server.close()


@pytest.mark.parametrize("code, error", [
    ("import sys; sys.exit(3)", RuntimeError),
    ("import time; time.sleep(30)", TimeoutError)])
def test_graphics_server_refuses_a_renderer_that_never_connects(
        tmp_path, monkeypatch, code, error):
    """A renderer that exits raises at once, naming its code; one that
    lives but never connects is killed at RENDERER_START_S."""
    monkeypatch.setattr(P_plotting, "RENDERER_START_S", 2.0)
    _renderer_stand_in(monkeypatch, code)
    t0 = time.monotonic()
    threads = set(threading.enumerate())
    with pytest.raises(error):
        P_plotting.GraphicsServer(out_dir=str(tmp_path), spawn_process=True,
                                  broadcast="127.0.0.1:0")
    assert time.monotonic() - t0 < 10
    assert set(threading.enumerate()) <= threads   # nothing left running


def test_services_start_no_cuda_context():
    """The renderer's body, the web-status daemon and the forge daemon
    (their servers, then their ``main`` until SIGTERM), driven in a
    fresh interpreter, leave ``torch.cuda.is_initialized()`` false."""
    script = r"""
import json, os, sys, tempfile, threading, urllib.request
import torch
from veles_tpu_torch import plotting, web_status
from veles_tpu_torch.forge import ForgeServer
d = tempfile.mkdtemp()
status = web_status.WebStatusServer()
web_status.StatusReporter(status.url, "r").post({"epoch": 1, "metrics": []})
urllib.request.urlopen(status.url + "/metrics?format=prometheus").read()
graphics = plotting.GraphicsServer(out_dir=d, spawn_process=False,
                                   broadcast="127.0.0.1:0")
host, port = graphics.broadcast_endpoint
sub = threading.Thread(target=plotting._client_main, args=(
    ["--endpoint", "%s:%d" % (host, port), "--out", d + "/sub"],))
sub.start()
while not graphics._subscribers:
    pass
graphics.publish({"kind": "curve", "name": "c", "y": [1.0]})
graphics.close()
sub.join()
forge = ForgeServer(d + "/store")
urllib.request.urlopen(forge.url + "/service?query=list").read()
forge.close()
status.close()
# the daemons' own entry points, stopped by SIGTERM as a service is
import signal, time
from veles_tpu_torch.forge import server as forge_server
for entry, argv in ((web_status.main, ["--host", "127.0.0.1", "--port",
                                       "0"]),
                    (forge_server.main, ["--root", d + "/s2", "--port",
                                         "0"])):
    threading.Timer(1.0, os.kill, (os.getpid(), signal.SIGTERM)).start()
    assert entry(argv) == 0
print(json.dumps(torch.cuda.is_initialized()))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "false"


def _catalog_names(pkg):
    script = (
        "import importlib, json\n"
        "for m in ('nn', 'loader', 'plotting', 'restful_api',\n"
        "          'interaction', 'publishing'):\n"
        "    importlib.import_module('%s.' + m)\n"
        "from %s.frontend import registry_catalog\n"
        "print(json.dumps(sorted({c['class'] for c in "
        "registry_catalog()})))\n" % (pkg, pkg))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


#: registered units of one package that the other lacks (the port's
#: frontend introspects the port's registry; these are the only
#: differences, each a unit one side has on purpose)
CATALOG_ONLY_REF = set()
CATALOG_ONLY_PORT = set()


def test_registry_catalog_matches_reference():
    """``registry_catalog()`` lists the port's unit classes; over the
    same modules its class names are the reference's, but for the
    differences named above. Run in fresh interpreters so that units
    other tests define do not enter either registry."""
    ref, port = _catalog_names("veles_tpu"), _catalog_names(
        "veles_tpu_torch")
    assert ref - port == CATALOG_ONLY_REF
    assert port - ref == CATALOG_ONLY_PORT
    assert {"All2AllTanh", "Conv", "AccumulatingPlotter", "RESTfulAPI",
            "Shell", "Publisher"} <= port


def test_frontend_page_composes_the_ports_command():
    import veles_tpu_torch.nn  # noqa: F401 - populate the registry
    from veles_tpu_torch.frontend import (generate_frontend_html,
                                          registry_catalog)
    catalog = registry_catalog()
    conv = next(c for c in catalog if c["class"] == "Conv")
    assert conv["module"] == "veles_tpu_torch.nn.conv"
    assert all(p["name"] not in ("self", "workflow", "kwargs")
               for p in conv["params"])
    page = generate_frontend_html()
    assert "command composer" in page and "All2AllTanh" in page
    assert '"python", "-m", "veles_tpu_torch"' in page
    assert '"-d", device' in page and '"-l", addr' in page


def test_manhole_repl_dumps_stacks_and_restores_sigusr2():
    from veles_tpu_torch import manhole
    previous = signal.getsignal(signal.SIGUSR2)
    marker = {}
    hole = manhole.install(namespace={"marker": marker})
    try:
        assert manhole.install() is hole  # idempotent
        assert os.path.basename(hole.path) == \
            "veles_tpu_torch.manhole.%d" % os.getpid()
        assert oct(os.stat(hole.path).st_mode & 0o777) == "0o600"
        assert signal.getsignal(signal.SIGUSR2) is not previous
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(30)
        sock.connect(hole.path)
        sock.sendall(b"marker['x'] = 6 * 7\n"
                     b"print('stacks', len(dump_threads()) > 0)\n")
        data = b""
        while b"stacks True" not in data:
            chunk = sock.recv(4096)
            assert chunk, data
            data += chunk
        sock.close()
        assert marker["x"] == 42
        text = manhole.dump_threads(file=open(os.devnull, "w"))
        assert "MainThread" in text
    finally:
        hole.close()
    assert signal.getsignal(signal.SIGUSR2) is previous
    assert not os.path.exists(hole.path)
    assert manhole._installed is None


def test_shell_scripted_commands_and_interval():
    from veles_tpu_torch.interaction import Shell
    wf = _plain_wf(SVC_PORT)
    shell = Shell(wf, commands=["probe = len(wf.units)",
                                "doubled = probe * 2"])
    shell.run()
    assert shell.last_result["doubled"] == shell.last_result["probe"] * 2
    assert shell.last_result["np"] is np
    every_other = Shell(wf, interval=2, commands=["x = 1"])
    every_other.run()
    assert "x" not in every_other.last_result
    every_other.run()
    assert every_other.last_result["x"] == 1


def _metric_wf(mods):
    class _MetricUnit(mods["units"].Unit, mods["workflow"].IResultProvider):
        hide_from_registry = True

        def run(self):
            pass

        def get_metric_names(self):
            return {"accuracy"}

        def get_metric_values(self):
            return {"accuracy": 0.97, "n_err": np.int64(3)}

    wf = _plain_wf(mods)
    _MetricUnit(wf, name="metric")
    return wf


@pytest.mark.parametrize("backend", ["markdown", "html", "json",
                                     "confluence", "ipynb"])
def test_publishing_renders_as_the_reference(backend, tmp_path):
    """For one info dict, each port renderer writes the reference's
    text (the notebook's metadata key is the port's name)."""
    info = P_publisher.gather_info(_metric_wf(SVC_PORT))
    ref_info = R_publisher.gather_info(_metric_wf(SVC_REF))
    assert set(info) == set(ref_info)
    assert info["results"] == ref_info["results"]
    ours = P_publisher.BACKENDS[backend](info)
    theirs = R_publisher.BACKENDS[backend](info)
    if backend == "ipynb":
        theirs = theirs.replace('"veles_tpu": {', '"veles_tpu_torch": {')
    assert ours == theirs
    path = P_publisher.render_report(_metric_wf(SVC_PORT), backend,
                                     str(tmp_path))
    assert os.path.getsize(path) > 0
    with pytest.raises(ValueError, match="unknown publishing backend"):
        P_publisher.render_report(_metric_wf(SVC_PORT), "docx",
                                  str(tmp_path))


def test_report_of_a_trained_workflow_holds_no_tensor(tmp_path):
    """render_report of a trained MnistWorkflow: the json parses to
    plain JSON types only (results are host numbers); the Publisher
    unit writes the same markdown report."""
    from veles_tpu_torch.publishing import Publisher, render_report
    wf = P_mnist.MnistWorkflow(layers=(16, 10), max_epochs=1,
                               loader_kwargs=dict(n_train=60, n_valid=20,
                                                  minibatch_size=20))
    wf.initialize(device=P_backends.Device(backend="cpu"))
    wf.run()
    try:
        doc = json.loads(open(render_report(wf, "json",
                                            str(tmp_path))).read())

        def walk(value):
            assert isinstance(value, (dict, list, str, int, float,
                                      type(None))), type(value)
            for v in (value.values() if isinstance(value, dict) else
                      value if isinstance(value, list) else ()):
                walk(v)

        walk(doc)
        assert doc["workflow"] == "MnistWorkflow"
        assert "cpu" in doc["device"]
        unit = Publisher(wf, backend="markdown", directory=str(tmp_path))
        unit.run()
        assert unit.report_path.endswith(".md")
        assert "# Training report: MnistWorkflow" in open(
            unit.report_path).read()
    finally:
        wf.thread_pool.shutdown()


def test_publish_confluence_posts_page():
    """The Confluence backend POSTs the storage-format page with the
    bearer token, here to a stub wiki on the loopback."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from veles_tpu_torch.publishing import publish_confluence
    received = {}

    class Stub(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            received["path"] = self.path
            received["auth"] = self.headers.get("Authorization")
            length = int(self.headers.get("Content-Length", 0))
            received["doc"] = json.loads(self.rfile.read(length))
            body = b'{"id": "12345"}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = HTTPServer(("127.0.0.1", 0), Stub)
    thread = threading.Thread(target=httpd.serve_forever)
    thread.start()
    try:
        out = publish_confluence(
            _metric_wf(SVC_PORT),
            "http://127.0.0.1:%d" % httpd.server_address[1], space="ML",
            token="tok123")
        assert out["id"] == "12345"
        assert received["path"] == "/rest/api/content"
        assert received["auth"] == "Bearer tok123"
        assert "accuracy" in received["doc"]["body"]["storage"]["value"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
