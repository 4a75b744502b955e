"""Deterministic fault injection for the distributed farm.

Port of ``veles_tpu/distributed/faults.py`` (the grammar and the
schedules are the reference's). The serving fault engines are ported
with it; ``serve/fleet.py`` wires them into a fleet
(``FleetManager.arm_faults``, ``LocalReplica``).

The reference had exactly one chaos knob — ``--slave-death-probability``
(veles/client.py:303-307), a per-job coin flip. A probability cannot
script the failure you actually need to test ("worker 2 dies while its
second job is in flight, THEN the coordinator crashes mid-save"), and
it cannot replay the schedule that broke last night. This module is
the scripted, seeded replacement: a :class:`FaultPlan` parses a
compact event grammar and the client/server/relay consult it at their
natural fault points, so a chaos run is reproducible end to end.

Grammar — semicolon-separated events (CLI ``--faults``, env
``VELES_FAULTS``)::

    kill:W@J             worker index W dies (WorkerDeath) after
                         completing J jobs — once, not on respawn
    drop:W@J             worker W hard-closes its connection after J
                         jobs; its reconnect/backoff path takes over
    delay:W@J:MS         worker W's next frame after J jobs is delayed
                         MS milliseconds (stalls the wire, tests the
                         coordinator's adaptive timeout headroom)
    truncate:W@J         worker W writes a torn frame after J jobs and
                         loses the connection (tests the receiver's
                         framing + the drop/requeue path)
    kill-coordinator@U   the coordinator crash-stops after U applied
                         updates (``Coordinator.kill()`` in process,
                         ``SIGKILL`` with ``sigkill=True`` — the
                         subprocess chaos harness)
    poison-row@N         serve plane: the chaos harness poisons the
                         payload of request N (``should_poison_request``)
                         and the :class:`ServeFaultEngine` test hook
                         raises on any batch containing a poisoned
                         (non-finite) row — exercising the
                         MicroBatcher's split-and-retry isolation
    nan-logits@S@T       serve plane: slot S's logits go NaN in-graph
                         at decode step T (``arm_generative`` installs
                         the ``GenerativeEngine.decode_fault_hook``) —
                         exercising the per-slot finite-logits
                         sentinel end to end
    hang-batch@N:MS      serve plane: the Nth dispatched batch blocks
                         MS milliseconds inside the engine call (the
                         dispatch-watchdog window: /healthz flips
                         ``{"stuck": true}`` and recovers)
    slow-batch@N:MS      serve plane: like hang-batch but below the
                         watchdog threshold — a tail-latency event,
                         not a health event
    kill-replica@N       fleet plane: serve replica index N dies
                         ABRUPTLY at its next engine call once the
                         fleet harness arms the plan — listener and
                         every live connection severed mid-exchange
                         (``FleetManager.arm_faults`` installs it),
                         exercising the router's failover: in-flight
                         non-streaming tickets re-admit on siblings,
                         streaming clients get a clean error record
    blackhole@N:MS       fleet plane: replica N accepts connections
                         but answers NOTHING for MS milliseconds
                         (requests held through the window, then
                         dropped without a reply) — the
                         wedged-but-listening failure mode a router
                         must route around on timeout, not 5xx
    hang-save@G          the checkpoint writer hangs before committing
                         generation G (arms
                         ``CheckpointStore.mid_commit_hook``; the
                         kill-mid-save harness SIGKILLs the process
                         inside this window)
    drop-upstream@J      a relay drops its upstream connection after
                         relaying J jobs (tests the lazy-redial
                         self-healing)

Worker indices are assigned by the harness (``Worker(fault_index=N)``;
the CLI numbers spawned workers by slot). The seed drives only the
jitter of :func:`jittered_backoff` — the *schedule* is exact by
construction, which is the point.
"""

from __future__ import annotations

import glob
import os
import random
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch.logger import Logger

#: reconnect backoff defaults (client.py)
BACKOFF_BASE = 0.5
BACKOFF_CAP = 15.0


def jittered_backoff(attempt: int, base: float = BACKOFF_BASE,
                     cap: float = BACKOFF_CAP,
                     rand=random.random) -> float:
    """Exponential backoff with full-ish jitter: attempt 1 sleeps
    ~base, doubling up to ``cap``, scaled by a uniform factor in
    [0.5, 1.5) so a herd of reconnecting workers does not synchronize
    against a restarting coordinator."""
    delay = min(cap, base * (2 ** max(attempt - 1, 0)))
    return delay * (0.5 + rand())


class _OneShotSendFault:
    """Armed on a Connection: fires on the next ``send`` and disarms."""

    def __init__(self, kind: str, arg: float = 0.0) -> None:
        self.kind = kind
        self.arg = arg

    def on_send(self, conn, obj) -> None:
        conn.fault = None
        if self.kind == "delay":
            time.sleep(self.arg / 1e3)
            return
        if self.kind == "truncate":
            # A torn frame: half a v2 header, then a hard close. The
            # peer's framed recv fails cleanly ("peer closed" /
            # short read), never desyncs into garbage decode.
            try:
                conn.sock.sendall(b"VTP2\x00")
            except OSError:
                pass
            conn.close()
            raise ConnectionError(
                "fault injection: truncated frame on the wire")


class WorkerFaults:
    """Per-worker view of a plan; consulted at job boundaries."""

    def __init__(self, index: int,
                 events: List[Tuple[int, str, float]]) -> None:
        self.index = index
        #: [(job, kind, arg)], consumed in order as jobs_done passes
        self._events = sorted(events)

    def at_job(self, jobs_done: int, conn) -> None:
        """Fire every event scheduled at or before ``jobs_done``.
        Raises WorkerDeath (kill) or ConnectionError (drop/truncate's
        immediate half) — the worker's normal death/reconnect paths
        take it from there."""
        while self._events and self._events[0][0] <= jobs_done:
            job, kind, arg = self._events.pop(0)
            if kind == "kill":
                from veles_tpu_torch.distributed.client import WorkerDeath
                conn.close()
                raise WorkerDeath()
            if kind == "drop":
                conn.close()
                raise ConnectionError(
                    "fault injection: connection dropped at job %d"
                    % job)
            if kind in ("delay", "truncate"):
                conn.fault = _OneShotSendFault(kind, arg)

    @property
    def pending(self) -> int:
        return len(self._events)


_EVENT_RE = re.compile(
    r"^\s*(kill|drop|delay|truncate):(\d+)@(\d+)(?::([\d.]+))?\s*$")
_COORD_RE = re.compile(r"^\s*kill-coordinator@(\d+)\s*$")
_HANG_RE = re.compile(r"^\s*hang-save@(\d+)\s*$")
_RELAY_RE = re.compile(r"^\s*drop-upstream@(\d+)\s*$")
_POISON_RE = re.compile(r"^\s*poison-row@(\d+)\s*$")
_NANL_RE = re.compile(r"^\s*nan-logits@(\d+)@(\d+)\s*$")
_BATCH_RE = re.compile(
    r"^\s*(hang-batch|slow-batch)@(\d+):([\d.]+)\s*$")
_KILL_REPLICA_RE = re.compile(r"^\s*kill-replica@(\d+)\s*$")
_BLACKHOLE_RE = re.compile(r"^\s*blackhole@(\d+):([\d.]+)\s*$")


class FaultPlan(Logger):
    """A parsed, seeded fault schedule shared by one chaos run."""

    def __init__(self, spec: str = "", seed: int = 0,
                 sigkill: bool = False) -> None:
        super().__init__()
        self.spec = spec or ""
        self.seed = seed
        self.sigkill = sigkill
        self.rand = random.Random(seed)
        self._worker_events: Dict[int, List[Tuple[int, str, float]]] = {}
        self.coordinator_kill_at: Optional[int] = None
        self.hang_save_at: Optional[int] = None
        self.relay_drop_at: Optional[int] = None
        #: serve-plane events (consumed via ServeFaultEngine /
        #: arm_generative / should_poison_request test hooks)
        self.poison_requests: set = set()
        self.nan_logits: List[Tuple[int, int]] = []  # (slot, step)
        self._batch_faults: Dict[int, Tuple[str, float]] = {}
        #: fleet-plane events (consumed via FleetManager.arm_faults)
        self.replica_kills: set = set()              # replica indices
        self.replica_blackholes: Dict[int, float] = {}  # index -> ms
        self._coordinator_killed = False
        self._relay_dropped = False
        for event in filter(None,
                            (e.strip() for e in self.spec.split(";"))):
            match = _EVENT_RE.match(event)
            if match:
                kind, widx, job, arg = match.groups()
                self._worker_events.setdefault(int(widx), []).append(
                    (int(job), kind, float(arg or 0.0)))
                continue
            match = _COORD_RE.match(event)
            if match:
                self.coordinator_kill_at = int(match.group(1))
                continue
            match = _HANG_RE.match(event)
            if match:
                self.hang_save_at = int(match.group(1))
                continue
            match = _RELAY_RE.match(event)
            if match:
                self.relay_drop_at = int(match.group(1))
                continue
            match = _POISON_RE.match(event)
            if match:
                self.poison_requests.add(int(match.group(1)))
                continue
            match = _NANL_RE.match(event)
            if match:
                self.nan_logits.append((int(match.group(1)),
                                        int(match.group(2))))
                continue
            match = _BATCH_RE.match(event)
            if match:
                kind, n, ms = match.groups()
                self._batch_faults[int(n)] = (kind, float(ms))
                continue
            match = _KILL_REPLICA_RE.match(event)
            if match:
                self.replica_kills.add(int(match.group(1)))
                continue
            match = _BLACKHOLE_RE.match(event)
            if match:
                self.replica_blackholes[int(match.group(1))] = \
                    float(match.group(2))
                continue
            raise ValueError("unparseable fault event %r (grammar: "
                             "see distributed/faults.py)" % event)
        if self.spec:
            self.info("fault plan armed: %s", self.describe())

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Plan from ``VELES_FAULTS`` / ``VELES_FAULT_SEED`` (None when
        unset) — the injection hook for spawned worker processes whose
        argv the harness does not control."""
        spec = os.environ.get("VELES_FAULTS", "")
        if not spec:
            return None
        seed = int(os.environ.get("VELES_FAULT_SEED", "0"))
        return cls(spec, seed=seed)

    def describe(self) -> str:
        parts = []
        for widx in sorted(self._worker_events):
            for job, kind, arg in sorted(self._worker_events[widx]):
                parts.append("%s worker %d @ job %d%s" % (
                    kind, widx, job, ":%g" % arg if arg else ""))
        if self.coordinator_kill_at is not None:
            parts.append("kill coordinator @ update %d"
                         % self.coordinator_kill_at)
        if self.hang_save_at is not None:
            parts.append("hang save @ generation %d" % self.hang_save_at)
        if self.relay_drop_at is not None:
            parts.append("drop relay upstream @ job %d"
                         % self.relay_drop_at)
        if self.poison_requests:
            parts.append("poison requests %s"
                         % sorted(self.poison_requests))
        for slot, step in sorted(self.nan_logits):
            parts.append("NaN logits slot %d @ decode step %d"
                         % (slot, step))
        for n in sorted(self._batch_faults):
            kind, ms = self._batch_faults[n]
            parts.append("%s %d for %gms" % (kind, n, ms))
        for idx in sorted(self.replica_kills):
            parts.append("kill replica %d" % idx)
        for idx in sorted(self.replica_blackholes):
            parts.append("blackhole replica %d for %gms"
                         % (idx, self.replica_blackholes[idx]))
        return "; ".join(parts) or "<empty>"

    # -- per-role views ----------------------------------------------------
    def for_worker(self, index: Optional[int]) -> Optional[WorkerFaults]:
        if index is None or index not in self._worker_events:
            return None
        return WorkerFaults(index, self._worker_events[index])

    def coordinator_crash_due(self, applied_updates: int) -> bool:
        """True exactly once, when the scripted kill point passes."""
        if self._coordinator_killed or self.coordinator_kill_at is None:
            return False
        if applied_updates >= self.coordinator_kill_at:
            self._coordinator_killed = True
            return True
        return False

    def relay_drop_due(self, jobs_relayed: int) -> bool:
        if self._relay_dropped or self.relay_drop_at is None:
            return False
        if jobs_relayed >= self.relay_drop_at:
            self._relay_dropped = True
            return True
        return False

    # -- serve-plane views -------------------------------------------------
    def should_poison_request(self, request_index: int) -> bool:
        """True when the chaos harness should poison request N's
        payload (inject a non-finite row before submitting) — paired
        with :class:`ServeFaultEngine`, which refuses any batch
        carrying one the way a compiled call blows up on bad input."""
        return request_index in self.poison_requests

    def batch_fault(self,
                    call_index: int) -> Optional[Tuple[str, float]]:
        """``(kind, ms)`` scheduled for the Nth engine call (0-based;
        bisection retries count — they are engine calls too), or
        None."""
        return self._batch_faults.get(call_index)

    def arm_generative(self, engine) -> None:
        """Install the ``nan-logits@S@T`` events on a
        :class:`~veles_tpu_torch.serve.engine.GenerativeEngine`: its
        ``decode_fault_hook`` NaNs slot S's logits IN-GRAPH at decode
        step T, so the chaos run exercises the real per-slot
        finite-logits sentinel, not a mock of it."""
        if not self.nan_logits:
            return
        by_step: Dict[int, List[int]] = {}
        for slot, step in self.nan_logits:
            by_step.setdefault(step, []).append(slot)

        def hook(step: int) -> List[int]:
            slots = by_step.get(step, [])
            if slots:
                self.warning("fault injection: NaN logits for slots "
                             "%s at decode step %d", slots, step)
            return slots
        engine.decode_fault_hook = hook

    def arm_checkpoint_store(self, store,
                             hang_seconds: float = 3600.0) -> None:
        """Install the ``hang-save@G`` window on a CheckpointStore:
        shards of generation G are durable, the manifest commit never
        happens — the SIGKILL-mid-save harness kills the process here
        and asserts the restore path's fallback."""
        if self.hang_save_at is None:
            return
        target = self.hang_save_at

        def hook(gen: int) -> None:
            if gen >= target:
                self.warning("fault injection: hanging save of "
                             "generation %d pre-commit", gen)
                time.sleep(hang_seconds)
        store.mid_commit_hook = hook


class PoisonedRow(RuntimeError):
    """:class:`ServeFaultEngine`'s stand-in for a compiled call blown
    up by one bad input row. The real failure mode is a device error
    for the WHOLE batch — which is exactly why the MicroBatcher must
    bisect to find the row instead of trusting the exception to name
    it."""


class ServeFaultEngine(Logger):
    """Engine wrapper for serve-side chaos runs: delegates everything
    to the wrapped engine, firing the plan's batch-scoped events on
    ``apply``:

    - ``hang-batch@N:MS`` / ``slow-batch@N:MS`` block the Nth engine
      call MS milliseconds before dispatching (the former sized past
      ``watchdog_s`` to flip ``/healthz``, the latter under it — a
      tail-latency event);
    - a batch containing any non-finite row raises
      :class:`PoisonedRow` for the whole call, modelling a compiled
      call destroyed by bad input — the batcher's split-and-retry
      isolation is what keeps innocents alive.
    """

    def __init__(self, engine, plan: FaultPlan) -> None:
        super().__init__()
        self._engine = engine
        self._plan = plan
        self._calls = 0
        self._calls_lock = threading.Lock()

    def __getattr__(self, name):
        # everything the batcher/registry reads off an engine
        # (buckets, compile_count, swap_params, ...) passes through
        return getattr(self._engine, name)

    @property
    def calls(self) -> int:
        """Engine calls observed (bisection retries included)."""
        return self._calls

    def apply(self, rows: np.ndarray) -> np.ndarray:
        with self._calls_lock:
            index = self._calls
            self._calls += 1
        fault = self._plan.batch_fault(index)
        if fault is not None:
            kind, ms = fault
            self.warning("fault injection: %s call %d for %g ms",
                         kind, index, ms)
            time.sleep(ms / 1e3)
        if np.issubdtype(rows.dtype, np.floating) and \
                not np.isfinite(rows).all():
            raise PoisonedRow(
                "fault injection: non-finite input row in batch of "
                "%d" % len(rows))
        return self._engine.apply(rows)


class ReplicaKilled(ConnectionError):
    """Raised inside a replica's engine call when ``kill-replica@N``
    fires — unwinds the in-flight batch/decode step while the serve
    front's connections are being severed, so every in-flight ticket
    on the dying replica fails the way a process death fails them."""


class ReplicaFaultEngine(Logger):
    """Engine wrapper for fleet chaos runs (the ``kill-replica@N``
    hookup, installed by ``FleetManager.arm_faults``): delegates
    everything to the wrapped engine; once :meth:`arm` fires, the
    NEXT device call — apply, prefill admit, or decode step, i.e.
    mid-request by construction — severs the replica via ``kill_fn``
    (listener + live connections) and raises :class:`ReplicaKilled`.
    Composable over :class:`ServeFaultEngine` for mixed schedules."""

    def __init__(self, engine, kill_fn) -> None:
        super().__init__()
        self._engine = engine
        self._kill_fn = kill_fn
        self._armed = threading.Event()

    def arm(self) -> None:
        self._armed.set()

    def __getattr__(self, name):
        # free_slots, release, max_len, last_finite, swap_params, ...
        attr = getattr(self._engine, name)
        if name == "decode_many":
            # a paged engine's decode round: killable like decode(),
            # and absent (hasattr False) over a slab engine
            def decode_many():
                self._maybe_kill()
                return attr()
            return decode_many
        return attr

    def _maybe_kill(self) -> None:
        if not self._armed.is_set():
            return
        self._armed.clear()
        self.warning("fault injection: killing replica mid-call")
        self._kill_fn()
        raise ReplicaKilled(
            "fault injection: replica killed mid-request")

    def apply(self, rows):
        self._maybe_kill()
        return self._engine.apply(rows)

    def admit(self, prompts, *sampling):
        # a paged engine's admit takes the tickets' sampling options too
        self._maybe_kill()
        return self._engine.admit(prompts, *sampling)

    def decode(self):
        self._maybe_kill()
        return self._engine.decode()


def corrupt_shard(directory: str, prefix: Optional[str] = None,
                  generation: Optional[int] = None,
                  offset: int = 16) -> str:
    """Flip one byte of a committed shard file — the bit-rot /
    torn-write simulator behind the corrupt-checkpoint chaos event and
    the fallback tests. Returns the corrupted path."""
    if generation is not None:
        pattern = "%s-%06d" % (prefix or "*", generation)
    else:
        pattern = "%s-*" % (prefix or "*")
    dirs = [d for d in glob.glob(os.path.join(directory, pattern))
            if os.path.isdir(d)]
    if not dirs:
        raise FileNotFoundError(
            "no shard directories matching %s in %s" %
            (pattern, directory))
    gdir = max(dirs)  # newest generation (zero-padded names sort)
    shards = sorted(glob.glob(os.path.join(gdir, "*.shard")))
    if not shards:
        raise FileNotFoundError("no shards in %s" % gdir)
    path = shards[0]
    with open(path, "rb+") as f:
        f.seek(min(offset, max(os.path.getsize(path) - 1, 0)))
        byte = f.read(1)
        f.seek(-1 if byte else 0, os.SEEK_CUR)
        f.write(bytes([(byte[0] ^ 0xFF) if byte else 0xFF]))
    return path
