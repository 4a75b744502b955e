"""The port's command line, ``python -m veles_tpu_torch`` (``Main``),
on the CPU with ``-d cpu``: the reference's ``tests/test_cli.py`` run
against the port, and what the port adds to it.

Parity: the mnist run's ``--result-file`` equals the reference CLI's
(``veles_tpu.__main__.Main``, in this process) from the same seed and
overrides at f32, within the bound the unit-graph classifier's parity
uses (``tests/test_torch_standard.py``): error counts and epochs
exactly, the loss within 1e-4 of its scale.

A test runs the CLI in a subprocess where it is about processes (the
farm, the fleet, a SIGKILLed coordinator); the rest drive ``Main`` in
this process and restore the config trees and random streams they
touch. Every wait is bounded.
"""

import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

REPO = __file__.rsplit("/tests/", 1)[0]

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

MNIST = [
    "root.mnist.layers=(8, 10)",
    "root.mnist.loader_kwargs={'n_train': 100, 'n_valid': 50, "
    "'minibatch_size': 50}",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch"] + args,
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO)


def _popen(args, log):
    return subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch"] + args, env=_env(),
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _until(predicate, what, timeout=120.0, step=0.05):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(step)


@pytest.fixture
def port_state():
    """Main in this process changes the port's config tree and random
    streams: restore both."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    seed = root.common.random.seed
    dtype = root.common.engine.compute_type
    try:
        yield root
    finally:
        for key in ("mnist", "lm"):
            setattr(root, key, {})
        root.common.random.seed = seed
        root.common.engine.compute_type = dtype
        prng.reset()


def _main(args):
    from veles_tpu_torch.__main__ import Main
    main = Main(args)
    assert main.run() == 0
    return main


def test_cli_trains_mnist_like_the_reference_cli(tmp_path):
    """The port's CLI in a subprocess against the reference's Main in
    this process: same seed, same overrides, f32 on both sides."""
    from veles_tpu import prng as R_prng
    from veles_tpu.__main__ import Main as RMain
    from veles_tpu.config import root as R_root
    args = ["-r", "7", "-d", "cpu", "root.mnist.max_epochs=2",
            "root.common.engine.compute_type='float32'",
            "root.mnist.layers=(16, 10)",
            "root.mnist.loader_kwargs={'n_train': 300, 'n_valid': 100, "
            "'minibatch_size': 50}"]
    port_file = tmp_path / "port.json"
    proc = _cli(["veles_tpu_torch/models/mnist.py", "--result-file",
                 str(port_file)] + args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_file = tmp_path / "ref.json"
    saved = (R_root.common.random.seed, R_root.common.engine.compute_type)
    try:
        assert RMain(["veles_tpu/models/mnist.py", "--result-file",
                      str(ref_file)] + args).run() == 0
    finally:
        R_root.mnist = {}
        R_root.common.random.seed, R_root.common.engine.compute_type = \
            saved
        R_prng.reset()
    port = json.loads(port_file.read_text())
    ref = json.loads(ref_file.read_text())
    assert port.keys() == ref.keys()
    for key in ("epochs", "n_err", "min_validation_error_pt",
                "min_validation_epoch", "min_train_error_pt"):
        assert port[key] == ref[key], key
    assert abs(port["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert port["min_validation_error_pt"] < 85.0


def test_cli_dry_run_init_writes_the_graph(tmp_path, port_state):
    graph = tmp_path / "graph.dot"
    _main(["veles_tpu_torch/models/mnist.py", "--dry-run", "init",
           "--workflow-graph", str(graph), "-d", "cpu",
           "root.mnist.max_epochs=1"] + MNIST)
    dot = graph.read_text()
    assert "digraph" in dot and "Repeater" in dot


def test_main_api_inprocess(tmp_path, port_state):
    port_state.common.random.seed = 5
    result = tmp_path / "res.json"
    _main(["veles_tpu_torch/models/mnist.py", "--result-file",
           str(result), "-d", "cpu", "root.mnist.max_epochs=1"] + MNIST)
    assert "min_validation_error_pt" in json.loads(result.read_text())


def test_cli_snapshot_restore(tmp_path, port_state):
    """-w restores and resumes; a raised max_epochs extends training
    past the snapshot's horizon."""
    snapdir = tmp_path / "snaps"
    _main(["veles_tpu_torch/models/mnist.py", "-d", "cpu", "-r", "11",
           "root.mnist.max_epochs=2",
           "root.mnist.snapshot_dir=%r" % str(snapdir),
           "root.mnist.snapshot_prefix='cli'"] + MNIST)
    paths = sorted(glob.glob(str(snapdir / "cli_*_*.pickle.gz")))
    assert paths, "workflow-level snapshotting wrote nothing"
    result = tmp_path / "res2.json"
    main = _main(["veles_tpu_torch/models/mnist.py", "-d", "cpu",
                  "-w", paths[-1], "--result-file", str(result),
                  "root.mnist.max_epochs=4"])
    assert main._restored
    assert json.loads(result.read_text())["epochs"] >= 3


def test_cli_optimize_mode(tmp_path, port_state):
    config = tmp_path / "opt.py"
    config.write_text(
        "from veles_tpu_torch.genetics import Range\n"
        "root.mnist.max_epochs = 1\n"
        "root.mnist.layers = (8, 10)\n"
        "root.mnist.loader_kwargs = {'minibatch_size': 50,"
        " 'n_train': 150, 'n_valid': 50}\n"
        "root.mnist.learning_rate = Range(0.1, 0.02, 0.3)\n")
    result = tmp_path / "opt.json"
    _main(["veles_tpu_torch/models/mnist.py", str(config), "-d", "cpu",
           "--optimize", "3:2", "-r", "5", "--result-file", str(result)])
    results = json.loads(result.read_text())
    assert results["generations"] == 2
    lr = results["best_config"]["root.mnist.learning_rate"]
    assert 0.02 <= lr <= 0.3


def test_cli_ensemble_train_then_test(tmp_path, port_state):
    config = tmp_path / "ens.py"
    config.write_text(
        "root.mnist.max_epochs = 1\n"
        "root.mnist.layers = (8, 10)\n"
        "root.mnist.loader_kwargs = {'minibatch_size': 50,"
        " 'n_train': 150, 'n_valid': 50}\n")
    members = tmp_path / "members.pickle.gz"
    _main(["veles_tpu_torch/models/mnist.py", str(config), "-d", "cpu",
           "--ensemble-train", "2:0.8", "-r", "6",
           "--ensemble-file", str(members)])
    assert members.exists()
    result = tmp_path / "etest.json"
    _main(["veles_tpu_torch/models/mnist.py", str(config), "-d", "cpu",
           "--ensemble-test", str(members), "-r", "6",
           "--result-file", str(result)])
    assert 0.0 <= json.loads(result.read_text())["ensemble_error_pt"] \
        <= 100.0


def test_cli_trains_lm_rung(tmp_path, port_state):
    result = tmp_path / "results.json"
    _main(["veles_tpu_torch/models/lm.py", "--result-file", str(result),
           "-r", "7", "-d", "cpu", "root.lm.max_epochs=2",
           "root.lm.loader_kwargs={'minibatch_size': 16, "
           "'n_tokens': 1632}"])
    results = json.loads(result.read_text())
    assert results["epochs"] >= 1
    # below the uniform-vocab entropy (ln 64 = 4.16): it learned
    assert results["min_validation_loss"] < 4.16


def _mnist_farm_config(tmp_path, epochs, n_train):
    config = tmp_path / "cfg.py"
    config.write_text(
        "root.mnist.max_epochs = %d\n"
        "root.mnist.layers = (8, 10)\n"
        "root.mnist.loader_kwargs = {'minibatch_size': 50,"
        " 'n_train': %d, 'n_valid': 80}\n" % (epochs, n_train))
    return str(config)


def test_cli_optimize_distributed(tmp_path):
    """--optimize with -l/-m farms the chromosomes to a worker."""
    config = tmp_path / "opt.py"
    config.write_text(
        "from veles_tpu_torch.genetics import Range\n"
        "root.mnist.max_epochs = 1\n"
        "root.mnist.layers = (8, 10)\n"
        "root.mnist.loader_kwargs = {'minibatch_size': 50,"
        " 'n_train': 150, 'n_valid': 50}\n"
        "root.mnist.learning_rate = Range(0.1, 0.02, 0.3)\n")
    addr = "127.0.0.1:%d" % _free_port()
    result = tmp_path / "opt.json"
    common = ["veles_tpu_torch/models/mnist.py", str(config), "-d",
              "cpu", "--optimize", "3:2", "-r", "5"]
    with open(tmp_path / "coord.log", "w") as clog, \
            open(tmp_path / "worker.log", "w") as wlog:
        coord = _popen(common + ["-l", addr, "--result-file",
                                 str(result)], clog)
        worker = _popen(common + ["-m", addr], wlog)
        try:
            assert coord.wait(240) == 0, \
                (tmp_path / "coord.log").read_text()[-2000:]
            worker.wait(60)
        finally:
            for proc in (coord, worker):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    results = json.loads(result.read_text())
    assert results["generations"] == 2
    assert "root.mnist.learning_rate" in results["best_config"]


def test_cli_coordinator_spawns_workers_with_fault_injection(tmp_path):
    """-l + --workers 2 --respawn: the coordinator spawns two worker
    processes of the port's CLI; they die now and then and are
    respawned, and training completes."""
    result = tmp_path / "r.json"
    proc = _cli(["veles_tpu_torch/models/mnist.py",
                 _mnist_farm_config(tmp_path, 2, 100), "-d", "cpu",
                 "-r", "5", "-l", "127.0.0.1:%d" % _free_port(),
                 "--workers", "2", "--respawn",
                 "--slave-death-probability", "0.2",
                 "--result-file", str(result)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(result.read_text())["epochs"] >= 2


def test_cli_join_adds_workers_to_live_int8_farm(tmp_path):
    """A coordinator with --encoding int8 and one spawned worker; a
    separate `--join ADDR --workers 2` adds two more while it runs."""
    config = _mnist_farm_config(tmp_path, 3, 400)
    addr = "127.0.0.1:%d" % _free_port()
    result = tmp_path / "r.json"
    with open(tmp_path / "coord.log", "w") as clog, \
            open(tmp_path / "join.log", "w") as jlog:
        coord = _popen(["veles_tpu_torch/models/mnist.py", config, "-d",
                        "cpu", "-r", "5", "-l", addr, "--workers", "1",
                        "--encoding", "int8", "--result-file",
                        str(result)], clog)
        joiner = _popen(["veles_tpu_torch/models/mnist.py", config,
                         "-d", "cpu", "-r", "5", "--join", addr,
                         "--workers", "2"], jlog)
        try:
            assert coord.wait(240) == 0, \
                (tmp_path / "coord.log").read_text()[-3000:]
            assert joiner.wait(60) == 0, \
                (tmp_path / "join.log").read_text()[-2000:]
        finally:
            for proc in (coord, joiner):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert json.loads(result.read_text())["epochs"] >= 3


def test_cli_checkpoint_then_resume(tmp_path):
    """--checkpoint DIR with a kill-coordinator fault: the coordinator
    SIGKILLs itself after 4 applied updates, leaving committed
    manifests (its orphaned worker is killed with its process group);
    --resume auto picks the newest one up and finishes."""
    config = _mnist_farm_config(tmp_path, 2, 200)
    ckpt = tmp_path / "ckpt"
    addr = "127.0.0.1:%d" % _free_port()
    base = ["veles_tpu_torch/models/mnist.py", config, "-d", "cpu", "-v",
            "-r", "5", "-l", addr, "--workers", "1", "--checkpoint",
            str(ckpt), "--checkpoint-every", "2"]
    log_path = tmp_path / "killed.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch"] + base +
            ["--faults", "kill-coordinator@4"], env=_env(), cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            code = proc.wait(180)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    assert code == -signal.SIGKILL, log_path.read_text()[-3000:]
    assert glob.glob(str(ckpt / "farm-*.json"))
    result = tmp_path / "r.json"
    proc = _cli(base + ["--resume", "auto", "--result-file",
                        str(result)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed farm workflow" in proc.stderr
    assert json.loads(result.read_text())["epochs"] >= 2


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _post_json(url, doc, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def test_cli_route_spawns_replicas_that_answer_and_drain(tmp_path):
    """`--route 127.0.0.1:0 --replicas 2 -d cpu`: two `--serve`
    processes answer /apply through the router; SIGINT stops the
    fleet, every process exits 0 and none is left."""
    log_path = tmp_path / "route.log"
    with open(log_path, "w") as log:
        router = _popen(["veles_tpu_torch/models/mnist.py", "-d", "cpu",
                         "-v", "--route", "127.0.0.1:0", "--replicas",
                         "2"] + MNIST, log)
        try:
            def url():
                m = re.search(r"fleet router on (http://\S+)",
                              log_path.read_text())
                return m.group(1) if m else None

            _until(lambda: url() or router.poll() is not None,
                   "the router never bound")
            base = url()
            assert base, log_path.read_text()[-3000:]

            def routable():
                try:
                    return _get_json(base + "/healthz")[1]["routable"]
                except OSError:
                    return 0

            _until(lambda: routable() == 2 or router.poll() is not None,
                   "the replicas never became routable", timeout=180)
            assert routable() == 2, log_path.read_text()[-3000:]
            rows = [[0.5] * 784] * 2
            seen = set()
            for _ in range(16):
                code, doc, headers = _post_json(base + "/apply",
                                                {"input": rows})
                assert code == 200
                assert len(doc["output"]) == 2
                assert len(doc["output"][0]) == 10
                seen.add(headers["X-Replica"])
                if seen == {"r0", "r1"}:
                    break
            assert seen == {"r0", "r1"}
            router.send_signal(signal.SIGINT)
            assert router.wait(60) == 0, log_path.read_text()[-3000:]
        finally:
            if router.poll() is None:
                router.kill()
                router.wait()
    text = log_path.read_text()
    exits = re.findall(r"replica (r\d) \(pid (\d+)\) exited with (-?\d+)",
                       text)
    assert sorted((name, code) for name, _, code in exits) == \
        [("r0", "0"), ("r1", "0")], text[-3000:]
    for _, pid, _ in exits:
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid), 0)


def test_cli_serve_while_training_answers_generate(tmp_path, port_state):
    """--serve-while-training on the LM: the serve tenant answers
    /generate while the train tenant steps; --trace-out writes the
    spans at exit."""
    from veles_tpu_torch.__main__ import Main
    trace = tmp_path / "trace.json"
    main = Main(["veles_tpu_torch/models/lm.py", "-d", "cpu", "-r", "7",
                 "--serve-while-training", "127.0.0.1:0",
                 "--serve-refresh-s", "0.05", "--serve-gen-slots", "2",
                 "--trace-out", str(trace), "root.lm.max_epochs=40",
                 "root.lm.loader_kwargs={'minibatch_size': 16, "
                 "'n_tokens': 1632}"])
    outcome = {}

    def body():
        try:
            outcome["rc"] = main.run()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            outcome["error"] = e

    thread = threading.Thread(target=body)
    thread.start()
    try:
        _until(lambda: main.serve_server is not None or
               not thread.is_alive(), "never served")
        assert main.serve_server is not None, outcome
        url = "http://%s:%d/generate" % main.serve_server.endpoint
        code, doc, _ = _post_json(url, {"prompt": [1, 2, 3],
                                        "max_tokens": 4})
        assert code == 200 and len(doc["tokens"][0]) == 4
    finally:
        thread.join(timeout=180)
    assert not thread.is_alive()
    assert outcome.get("rc") == 0, outcome
    names = {e["name"] for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert {"http", "request"} <= names


@pytest.mark.parametrize("flag", ["manhole", "fleet-reporter"])
def test_unported_flags_exit_naming_their_item(flag, port_state,
                                               monkeypatch):
    """The two service flags that exited before the services were
    ported now work: ``--manhole`` opens its socket and its REPL
    answers during the run (closed again at exit); ``--route`` with
    ``root.common.web.status_url`` posts the fleet card to a
    web-status server. (The name is the refusal test's, kept so that
    this case replaces it one for one.)"""
    import threading
    import urllib.request

    from veles_tpu_torch import manhole
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.web_status import WebStatusServer
    if flag == "manhole":
        seen = {}
        close = manhole.Manhole.close

        def checked_close(hole):
            seen["path"] = hole.path
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(30)
            sock.connect(hole.path)
            sock.sendall(b"print(6 * 7)\n")
            data = b""
            while b"42" not in data:
                chunk = sock.recv(4096)
                assert chunk, data
                data += chunk
            sock.close()
            seen["answer"] = True
            close(hole)

        monkeypatch.setattr(manhole.Manhole, "close", checked_close)
        _main(["veles_tpu_torch/models/mnist.py", "-d", "cpu",
               "--manhole", "root.mnist.max_epochs=1",
               "root.mnist.layers=(8, 10)",
               "root.mnist.loader_kwargs={'n_train': 40, 'n_valid': 20, "
               "'minibatch_size': 20}"])
        assert seen.get("answer"), seen
        assert not os.path.exists(seen["path"])
        assert manhole._installed is None
        return
    status = WebStatusServer()
    main = Main(["veles_tpu_torch/models/mnist.py", "-d", "cpu",
                 "--route", "127.0.0.1:0",
                 "root.common.web.status_url=%r" % status.url,
                 "root.common.web.status_interval=0.2"])
    outcome = {}
    thread = threading.Thread(
        target=lambda: outcome.setdefault("rc", main.run()))
    thread.start()
    try:
        deadline = time.monotonic() + 60
        docs = {}
        while time.monotonic() < deadline:
            docs = json.load(urllib.request.urlopen(
                status.url + "/status.json", timeout=10))
            if any("fleet" in d for d in docs.values()):
                break
            time.sleep(0.1)
        (doc,) = [d for d in docs.values() if "fleet" in d]
        assert doc["mode"] == "router"
        assert "replicas" in doc["fleet"]
        page = urllib.request.urlopen(status.url + "/",
                                      timeout=10).read().decode()
        assert "fleetTable" in page
    finally:
        main._serve_stop.set()
        thread.join(timeout=60)
        status.close()
        port_state.common.web.status_url = None
        port_state.common.web.status_interval = 10.0
    assert not thread.is_alive()
    assert outcome.get("rc") == 0


def test_cli_serve_mesh_tp2_matches_one_rank(tmp_path, port_state):
    """`--serve --serve-mesh tp=2` over two CPU ranks (gloo; rank 0
    serves, rank 1 follows its device calls) generates the tokens of
    a one-rank engine over the same workflow's weights (f32: exact);
    SIGINT on the leader releases the follower and both exit 0."""
    from veles_tpu_torch.serve.engine import GenerativeEngine
    rendezvous = "127.0.0.1:%d" % _free_port()
    logs = [tmp_path / ("rank%d.log" % i) for i in range(2)]
    procs = []
    files = [open(path, "w") for path in logs]
    try:
        for i, log in enumerate(files):
            procs.append(_popen([
                "veles_tpu_torch/models/lm.py", "-d", "cpu", "-v",
                "--serve", "127.0.0.1:0", "--serve-mesh", "tp=2",
                "--serve-gen-slots", "2", "--mesh-processes", "2",
                "--mesh-coordinator", rendezvous, "--mesh-process-id",
                str(i)], log))
        main = _main(["veles_tpu_torch/models/lm.py", "-d", "cpu",
                      "--dry-run", "init"])
        engine = GenerativeEngine.from_trainer(
            main.workflow.trainer_unit._trainer_, max_slots=2,
            device="cpu")
        want = engine.generate([[1, 2, 3]], 6)[0].tolist()

        def url():
            m = re.search(r"serving \S+ on (http://\S+)",
                          logs[0].read_text())
            return m.group(1) if m else None

        _until(lambda: url() or procs[0].poll() is not None,
               "the leader never served")
        assert url(), logs[0].read_text()[-3000:]
        code, doc, _ = _post_json(url() + "/generate",
                                  {"prompt": [1, 2, 3], "max_tokens": 6})
        assert code == 200 and doc["tokens"] == [want]
        assert "follows its leader" in logs[1].read_text()
        procs[0].send_signal(signal.SIGINT)
        assert [p.wait(60) for p in procs] == [0, 0], \
            [path.read_text()[-2000:] for path in logs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
