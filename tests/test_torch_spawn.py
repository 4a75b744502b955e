"""Worker spawning of the port's farm
(``veles_tpu_torch.distributed.spawn``), the JAX package's
``tests/test_spawn.py`` cases: ssh transport + respawn supervision
(reference: remote node launch, veles/launcher.py:617-660).

The ssh binary is substituted with a recording stub — the transport
contract (argv shape, quoting, cwd, node fan-out) is what's under
test; real ssh reachability belongs to deployment.
"""

import time

from veles_tpu_torch.distributed.spawn import WorkerPool


def _stub_ssh(tmp_path, body="sleep 30"):
    """A fake ssh: logs 'node<TAB>command' to ssh.log, then runs
    ``body``. Returns (stub_path, log_path)."""
    log = tmp_path / "ssh.log"
    stub = tmp_path / "fake_ssh"
    stub.write_text(
        "#!/bin/sh\n"
        "node=\"$1\"; shift\n"
        "printf '%%s\\t%%s\\n' \"$node\" \"$*\" >> %s\n"
        "%s\n" % (log, body))
    stub.chmod(0o755)
    return str(stub), log


def _wait_for(predicate, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_ssh_spawn_command_shape(tmp_path):
    stub, log = _stub_ssh(tmp_path)
    pool = WorkerPool(
        2, "127.0.0.1:5000",
        argv=["wf.py", "cfg.py", "-l", "127.0.0.1:5000",
              "--workers", "2", "--nodes", "n1,n2"],
        respawn=False,
        nodes=["n1", "n2"], ssh_command=[stub],
        remote_python="/opt/py/bin/python3",
        remote_cwd="/srv/veles")
    try:
        assert _wait_for(lambda: log.exists() and
                         len(log.read_text().splitlines()) == 2)
        lines = sorted(log.read_text().splitlines())
        nodes = [line.split("\t")[0] for line in lines]
        assert nodes == ["n1", "n2"]  # round-robin fan-out
        for line in lines:
            cmd = line.split("\t")[1]
            assert cmd.startswith("cd /srv/veles && ")
            assert "/opt/py/bin/python3 -m veles_tpu_torch wf.py cfg.py" in cmd
            # worker argv: spawn flags stripped, -m master added
            assert "-m 127.0.0.1:5000" in cmd
            assert "--workers" not in cmd
            assert "--nodes" not in cmd
    finally:
        pool.stop(grace=2.0)


def test_ssh_worker_respawns_with_backoff(tmp_path):
    stub, log = _stub_ssh(tmp_path, body="exit 1")
    pool = WorkerPool(
        1, "127.0.0.1:5000", argv=["wf.py"],
        respawn=True, max_respawns=2, backoff=0.05,
        nodes=["deadhost"], ssh_command=[stub])
    try:
        # initial spawn + 2 respawns = 3 stub invocations, then the
        # budget is exhausted and the slot is dropped
        assert _wait_for(lambda: log.exists() and
                         len(log.read_text().splitlines()) == 3)
        time.sleep(0.3)
        assert len(log.read_text().splitlines()) == 3
        assert pool.alive == 0
    finally:
        pool.stop(grace=2.0)


def test_local_marker_keeps_slot_on_this_machine(tmp_path):
    """nodes=['local', 'n1']: slot 0 spawns sys.executable directly,
    slot 1 goes through ssh."""
    stub, log = _stub_ssh(tmp_path)
    marker = tmp_path / "local_ran"
    pool = WorkerPool(
        2, "127.0.0.1:5000", argv=["wf.py"], respawn=False,
        nodes=["local", "n1"], ssh_command=[stub])
    # slot 0 is a real local `python -m veles_tpu_torch wf.py ...` which
    # exits nonzero fast (wf.py does not exist) — only slot 1 must
    # reach the stub, exactly once.
    try:
        assert _wait_for(lambda: log.exists() and
                         len(log.read_text().splitlines()) == 1)
        assert log.read_text().split("\t")[0] == "n1"
        time.sleep(0.3)
        assert len(log.read_text().splitlines()) == 1
    finally:
        pool.stop(grace=2.0)


class TestNodeDiscovery:
    """--nodes resolution: hostfile + TPU/GCE metadata (the YARN-RM
    equivalent, reference veles/launcher.py:887-906)."""

    def test_hostfile(self, tmp_path):
        from veles_tpu_torch.distributed.discovery import resolve_nodes
        hf = tmp_path / "hosts"
        hf.write_text(
            "# pod workers\n"
            "tpu-w0 slots=4\n"
            "\n"
            "tpu-w1\n"
            "local   # keep one slot here\n")
        assert resolve_nodes("@%s" % hf) == ["tpu-w0", "tpu-w1",
                                             "local"]
        assert resolve_nodes("hostfile:%s" % hf) == [
            "tpu-w0", "tpu-w1", "local"]

    def test_literal_list_and_none(self):
        from veles_tpu_torch.distributed.discovery import resolve_nodes
        assert resolve_nodes("h1, h2") == ["h1", "h2"]
        assert resolve_nodes(None) is None
        assert resolve_nodes("") is None

    def test_auto_from_env(self, monkeypatch):
        from veles_tpu_torch.distributed import discovery
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "t0,t1,t2")
        assert discovery.resolve_nodes("auto") == ["t0", "t1", "t2"]

    def test_auto_from_metadata_server(self, monkeypatch):
        """A fake GCE metadata server serving the TPU pod's
        worker-network-endpoints attribute."""
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer

        from veles_tpu_torch.distributed import discovery

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                assert self.headers["Metadata-Flavor"] == "Google"
                if "worker-network-endpoints" in self.path:
                    body = (b"uid1:10.0.0.2:8470,"
                            b"uid2:10.0.0.3:8470")
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):
                pass

        srv = HTTPServer(("127.0.0.1", 0), Handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
            monkeypatch.setenv(
                discovery.METADATA_BASE_ENV,
                "http://127.0.0.1:%d" % srv.server_address[1])
            assert discovery.resolve_nodes("auto") == [
                "10.0.0.2", "10.0.0.3"]
        finally:
            srv.shutdown()

    def test_auto_without_sources_errors(self, monkeypatch):
        import pytest

        from veles_tpu_torch.distributed import discovery
        monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
        monkeypatch.setenv(discovery.METADATA_BASE_ENV,
                           "http://127.0.0.1:1")  # nothing listens
        with pytest.raises(SystemExit, match="nodes auto"):
            discovery.resolve_nodes("auto")


def test_worker_argv_strips_elastic_and_codec_flags():
    """--join/--encoding/--announce are coordinator/launcher-side
    flags: a spawned worker's argv must not carry them (a worker
    re-running --join would fork workers of its own, forever)."""
    from veles_tpu_torch.distributed.spawn import worker_argv

    argv = worker_argv(
        ["wf.py", "cfg.py", "--join", "10.0.0.1:5555", "--workers",
         "4", "--encoding", "int8", "--announce", "--respawn",
         "--encoding=bf16", "--join=auto", "-r", "7"],
        "127.0.0.1:5000")
    assert argv == ["wf.py", "cfg.py", "-r", "7",
                    "-m", "127.0.0.1:5000"]


def test_join_pool_spawns_against_live_address(tmp_path):
    """`--join ADDR` reuses WorkerPool against an external master: the
    spawned command line targets that address with -m (transport
    contract only; liveness is test_distributed's job)."""
    stub, log = _stub_ssh(tmp_path, body="sleep 30")
    pool = WorkerPool(
        2, "10.1.2.3:5555",
        argv=["wf.py", "--join", "10.1.2.3:5555", "--workers", "2"],
        respawn=False, nodes=["n1", "n2"], ssh_command=[stub])
    try:
        assert _wait_for(lambda: log.exists() and
                         len(log.read_text().splitlines()) == 2)
        for line in log.read_text().splitlines():
            cmd = line.split("\t")[1]
            assert "-m 10.1.2.3:5555" in cmd
            assert "--join" not in cmd
            assert "--workers" not in cmd
    finally:
        pool.stop()
