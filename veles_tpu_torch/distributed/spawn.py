"""Worker process spawning + respawn supervision (local and ssh).

Port of ``veles_tpu/distributed/spawn.py``: spawned commands run
``python -m veles_tpu_torch`` (the port's CLI, ``__main__.py``); a
caller's transport prefix (``WorkerPool(ssh_command=)``) runs them on
other hosts.

Reference capability: veles/launcher.py:808-842 (_launch_nodes — one
slave process per device spec, slave cmdline = own argv filtered +
``-m host:port``), :617-660 (remote nodes over ssh with filtered
argv) and veles/server.py:637-655 (_respawn — relaunch dead slaves
with exponential backoff). Workers are subprocesses: local ``python
-m veles_tpu_torch`` by default, or ``ssh node '...'`` when the slot maps
to a remote node (``--nodes host1,host2``). The ssh transport keeps
the same supervision: a dead ssh session is a dead worker and gets
respawned with backoff.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.thread_pool import ManagedThreads


def worker_argv(argv: List[str], master_addr: str) -> List[str]:
    """Own argv -> a worker's argv: strip coordinator/spawn flags, add
    ``-m master_addr`` (reference: filter_argv + '-m host:port -b')."""
    out: List[str] = []
    skip_next = False
    for token in argv:
        if skip_next:
            skip_next = False
            continue
        if token in ("-l", "--listen", "-m", "--master", "--workers",
                     "--result-file", "--mesh-process-id", "--nodes",
                     "--remote-python", "--remote-cwd", "--join",
                     "--encoding",
                     # obs outputs are the COORDINATOR's: a spawned
                     # worker re-running this argv would clobber the
                     # same --trace-out file / profile dir with its
                     # own (worker spans ship upstream instead).
                     # Ditto --aot-export (the producer's artifact);
                     # --aot-cache deliberately PASSES THROUGH so
                     # spawned workers warm-start from the shared
                     # compile cache.
                     "--trace-out", "--profile-steps",
                     "--profile-dir", "--aot-export"):
            skip_next = True
            continue
        if token.startswith(("--listen=", "--master=", "--workers=",
                             "--result-file=", "--mesh-process-id=",
                             "--nodes=", "--remote-python=",
                             "--remote-cwd=", "--join=",
                             "--encoding=", "--trace-out=",
                             "--profile-steps=", "--profile-dir=",
                             "--aot-export=")):
            continue
        # attached short-option forms: -l127.0.0.1:5000 / -mADDR
        if len(token) > 2 and token[:2] in ("-l", "-m") and \
                token[2] != "-":
            continue
        if token in ("--respawn", "--announce"):
            continue
        out.append(token)
    out += ["-m", master_addr]
    return out


#: flags a spawned serve replica must not inherit from the router's
#: argv (value-taking ones skip their operand too). --aot-cache
#: deliberately passes through: fleet respawn/autoscale replicas
#: warm-start from the shared compile cache.
_REPLICA_STRIP_VALUED = (
    "--route", "--replicas", "--rollout", "--serve", "-l", "--listen",
    "-m", "--master", "--workers", "--result-file", "--nodes",
    "--remote-python", "--remote-cwd", "--join", "--encoding",
    "--trace-out", "--profile-steps", "--profile-dir",
    "--aot-export")
_REPLICA_STRIP_BARE = ("--respawn", "--announce")


def replica_argv(argv: List[str], serve_addr: str) -> List[str]:
    """Router argv -> one serve replica's argv: strip the fleet/farm
    flags, pin ``--serve serve_addr``, and add ``--announce`` so the
    replica beacons its serve address (``role=replica``) on the
    discovery plane the router watches. The workflow/config/override
    positionals pass through — a replica runs the same model the
    router was launched for."""
    out: List[str] = []
    skip_next = False
    for token in argv:
        if skip_next:
            skip_next = False
            continue
        if token in _REPLICA_STRIP_VALUED:
            skip_next = True
            continue
        if token.startswith(tuple(
                flag + "=" for flag in _REPLICA_STRIP_VALUED
                if flag.startswith("--"))):
            continue
        if len(token) > 2 and token[:2] in ("-l", "-m") and \
                token[2] != "-":
            continue
        if token in _REPLICA_STRIP_BARE:
            continue
        out.append(token)
    out += ["--serve", serve_addr, "--announce"]
    return out


class ReplicaProcess(Logger):
    """One supervised ``python -m veles_tpu_torch ... --serve`` subprocess —
    the fleet manager's production replica shape (``--route
    --replicas N``). The same respawn discipline as :class:`WorkerPool`
    applies, but per-replica and driven by the FleetManager's
    supervision loop (which owns the backoff), so :meth:`respawn`
    here is immediate."""

    def __init__(self, serve_addr: str,
                 argv: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 admin_swap: bool = True,
                 fault_index: Optional[int] = None) -> None:
        super().__init__()
        self.serve_addr = serve_addr
        self.argv = replica_argv(
            list(argv if argv is not None else sys.argv[1:]),
            serve_addr)
        self._env = dict(os.environ, **(env or {}))
        if admin_swap:
            # opens POST /admin/swap — the fleet's rollout channel
            # into this process (see serve/server.py)
            self._env["VELES_SERVE_ADMIN"] = "1"
        if fault_index is not None:
            self._env["VELES_FAULT_INDEX"] = str(fault_index)
        self._proc = self._spawn()

    def _spawn(self) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "veles_tpu_torch"] + self.argv
        self.info("spawning replica at %s: %s", self.serve_addr,
                  " ".join(cmd))
        return subprocess.Popen(cmd, env=self._env)

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    @property
    def pid(self) -> int:
        return self._proc.pid

    def respawn(self) -> None:
        if self.alive:
            return
        self._proc = self._spawn()

    def kill(self) -> None:
        """SIGKILL — the chaos form; peers see severed connections."""
        if self.alive:
            self._proc.kill()

    def stop(self, grace: float = 10.0) -> Optional[int]:
        """SIGTERM (a ``--serve`` process drains and exits 0), SIGKILL
        after ``grace`` seconds; returns the exit code."""
        if self._proc.poll() is None:
            self._proc.terminate()
        try:
            self._proc.wait(grace)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(grace)
        return self._proc.returncode


class WorkerPool(Logger):
    """Spawns N worker subprocesses and supervises them: a worker that
    dies while the pool is live is respawned with exponential backoff
    up to ``max_respawns`` times (reference: --respawn).

    ``nodes``: optional remote host list; worker slot s runs on
    ``nodes[s % len(nodes)]`` over ssh (reference: veles launched
    slaves on other machines with the same filtered argv —
    veles/launcher.py:617-660). The entry ``"local"`` (or ``""``)
    keeps that slot on this machine. ``ssh_command`` is the transport
    argv prefix — tests substitute a stub; production uses
    ``["ssh", "-o", "BatchMode=yes"]``."""

    SSH = ("ssh", "-o", "BatchMode=yes")

    def __init__(self, n_workers: int, master_addr: str,
                 argv: Optional[List[str]] = None,
                 respawn: bool = True, max_respawns: int = 10,
                 backoff: float = 1.0,
                 nodes: Optional[Sequence[str]] = None,
                 ssh_command: Optional[Sequence[str]] = None,
                 remote_python: str = "python3",
                 remote_cwd: Optional[str] = None) -> None:
        super().__init__()
        self.master_addr = master_addr
        self.argv = worker_argv(
            list(argv if argv is not None else sys.argv[1:]),
            master_addr)
        self.respawn = respawn
        self.max_respawns = max_respawns
        self.backoff = backoff
        self.nodes = [n.strip() for n in nodes] if nodes else []
        if respawn and any(
                t == "--mesh-processes" or
                t.startswith("--mesh-processes=") for t in self.argv):
            # A respawned mesh worker would re-join a process group
            # whose init barrier is long complete: it hangs
            # for the timeout, dies, and crash-loops through the
            # respawn budget while masking the real failure. A worker
            # death already poisons the surviving ranks' collectives —
            # the run must be restarted whole.
            self.warning("respawn disabled: global-mesh workers "
                         "cannot re-join a completed mesh init")
            self.respawn = False
        self.ssh_command = list(ssh_command if ssh_command is not None
                                else self.SSH)
        self.remote_python = remote_python
        self.remote_cwd = remote_cwd
        self._procs: Dict[int, subprocess.Popen] = {}
        self._respawns: Dict[int, int] = {}
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._threads = ManagedThreads(name="worker-pool")
        for slot in range(n_workers):
            self._procs[slot] = self._spawn(slot)
            self._respawns[slot] = 0
        self._supervisor = self._threads.spawn(
            self._watch, name="supervisor")

    def _node_for(self, slot: int) -> Optional[str]:
        if not self.nodes:
            return None
        node = self.nodes[slot % len(self.nodes)]
        return None if node in ("", "local") else node

    def _spawn(self, slot: int) -> subprocess.Popen:
        worker_cmd = ["-m", "veles_tpu_torch"] + self.argv
        if any(t == "--mesh-processes" or
               t.startswith("--mesh-processes=") for t in self.argv):
            # Global-mesh runs: the coordinator is rank 0; worker slot
            # s joins as rank s+1 (worker_argv stripped any rank flag).
            worker_cmd += ["--mesh-process-id", str(slot + 1)]
        node = self._node_for(slot)
        # Fault-plan targeting (distributed/faults.py): kill:W@J etc.
        # address workers by index; each spawned child learns its own
        # through VELES_FAULT_INDEX (the plan itself rides VELES_FAULTS,
        # inherited — or forwarded in env_prefix for ssh workers).
        env = None
        env_prefix = []
        if os.environ.get("VELES_FAULTS"):
            if node is None:
                env = dict(os.environ, VELES_FAULT_INDEX=str(slot))
            else:
                env_prefix = [
                    "env",
                    "VELES_FAULTS=%s" % os.environ["VELES_FAULTS"],
                    "VELES_FAULT_SEED=%s" % os.environ.get(
                        "VELES_FAULT_SEED", "0"),
                    "VELES_FAULT_INDEX=%d" % slot]
        if node is None:
            cmd = [sys.executable] + worker_cmd
        else:
            remote = env_prefix + [self.remote_python] + worker_cmd
            line = " ".join(shlex.quote(c) for c in remote)
            if self.remote_cwd:
                line = "cd %s && %s" % (shlex.quote(self.remote_cwd),
                                        line)
            cmd = self.ssh_command + [node, line]
        self.info("spawning worker %d%s: %s", slot,
                  " on %s" % node if node else "", " ".join(cmd))
        return subprocess.Popen(cmd, env=env)

    def _watch(self) -> None:
        # Per-slot respawn schedule — backoff must not serialize
        # other slots' respawns (no sleeping under the lock).
        due: Dict[int, float] = {}
        while not self._stopped.is_set():
            now = time.time()
            to_spawn = []
            with self._lock:
                for slot, proc in list(self._procs.items()):
                    rc = proc.poll()
                    if rc is None or rc == 0:
                        continue
                    if slot in due:
                        if now >= due[slot]:
                            del due[slot]
                            to_spawn.append(slot)
                        continue
                    if not self.respawn or \
                            self._respawns[slot] >= self.max_respawns:
                        self.warning(
                            "worker %d exited rc=%d; respawn budget "
                            "exhausted", slot, rc)
                        del self._procs[slot]
                        continue
                    self._respawns[slot] += 1
                    delay = self.backoff * (
                        2 ** (self._respawns[slot] - 1))
                    due[slot] = now + delay
                    self.warning(
                        "worker %d died rc=%d; respawn %d/%d in %.1fs",
                        slot, rc, self._respawns[slot],
                        self.max_respawns, delay)
            # fork/exec (possibly a multi-second ssh dial) OUTSIDE the
            # lock: `alive` polls and stop() must not stall behind a
            # slow spawn. stop() normally joins this thread before
            # snapshotting _procs, but its join is TIMED — if a slow
            # spawn outlives it, stop()'s snapshot misses the child,
            # so terminate it here ourselves once stop was requested
            # (terminate on an already-terminated proc is a no-op).
            for slot in to_spawn:
                if self._stopped.is_set():
                    break
                proc = self._spawn(slot)
                with self._lock:
                    self._procs[slot] = proc
                if self._stopped.is_set():
                    # stop() may already have snapshotted _procs
                    # without this child: terminate AND reap it (a
                    # bare terminate leaves a zombie for the parent's
                    # lifetime)
                    proc.terminate()
                    try:
                        proc.wait(5.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        try:
                            proc.wait(1.0)
                        except subprocess.TimeoutExpired:
                            pass
            self._stopped.wait(0.5)

    @property
    def alive(self) -> int:
        with self._lock:
            return sum(1 for p in self._procs.values()
                       if p.poll() is None)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every worker process has exited."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                proc.wait(remaining)
            except subprocess.TimeoutExpired:
                pass

    def stop(self, grace: float = 10.0) -> None:
        """Stop supervising; terminate anything still running."""
        self._stopped.set()
        self._threads.join_all(timeout=5)
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + grace
        for proc in procs:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
