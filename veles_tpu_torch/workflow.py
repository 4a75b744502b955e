"""Workflow: a container of units forming a gated control-flow graph.

Port of ``veles_tpu/workflow.py``: ``initialize`` verifies the graph
(``analysis.graph``), then initializes the units in dependency order
with the partial-init requeue; ``run`` drives the graph to completion
on the thread pool and reports a stall when every unit went idle
before the end point ran; the job-farm methods
(``generate_data_for_slave`` ... ``apply_initial_data_from_master``,
pieces matched by unit id, ``NoMoreJobs``, postponement) are host-side,
called by the farm's coordinator and workers
(``veles_tpu_torch.distributed``); DOT
graph export, per-unit run-time stats, results JSON through
``IResultProvider`` and a checksum pairing coordinator and workers.
``package_export`` raises until the package archive is ported.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.memory import Array
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import StartPoint, EndPoint
from veles_tpu_torch.units import Container, Unit, fresh_trampoline


class NoMoreJobs(Exception):
    """Raised by a unit's generate_data_for_slave when training is done
    (reference: veles/workflow.py:500-502)."""


class IResultProvider:
    """Units implementing get_metric_names/get_metric_values contribute
    to the results JSON (reference: veles/result_provider.py)."""

    def get_metric_names(self):
        return set()

    def get_metric_values(self):
        return {}


class Workflow(Container):
    """The unit container and the engine that runs it."""

    hide_from_registry = True

    # shadow Unit's delegating properties — the workflow owns the mode
    is_standalone = True
    is_master = False
    is_slave = False

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        self._units: List[Unit] = []
        self._sync_event_ = threading.Event()
        super().__init__(workflow, **kwargs)
        self.thread_pool_ = None
        self.device_ = None
        self.stopped = True
        self.is_standalone = True
        self.is_master = False
        self.is_slave = False
        self.interactive = False
        self._restored_from_snapshot_ = False
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self._job_callback_ = None
        self._run_time_started_ = None
        self.run_count = 0

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._sync_event_ = threading.Event()
        self._units_lock_ = threading.RLock()
        self._inflight_lock_ = threading.Lock()
        self._inflight_ = 0
        self._stalled_ = False
        self._failure_ = None
        self.thread_pool_ = None
        self.device_ = None
        self._job_callback_ = None
        self._run_time_started_ = None
        if not hasattr(self, "_units"):
            self._units = []

    # thread_pool and device are transient resources (executor threads,
    # device handles) — excluded from pickle by the trailing-
    # underscore discipline and recreated on initialize after restore.
    @property
    def thread_pool(self):
        return self.thread_pool_

    @thread_pool.setter
    def thread_pool(self, value):
        self.thread_pool_ = value

    @property
    def device(self):
        return self.device_

    @device.setter
    def device(self, value):
        self.device_ = value

    # -- unit membership ---------------------------------------------------
    def add_ref(self, unit: Unit) -> None:
        with getattr(self, "_units_lock_", threading.RLock()):
            if unit is not self and unit not in self._units:
                # Deterministic workflow-scoped id: same workflow code run
                # on coordinator and worker constructs units in the same
                # order, so ids agree across processes. A monotonic
                # counter (not len(_units)) keeps ids unique even after
                # removals.
                seq = getattr(self, "_unit_seq", 0)
                self._unit_seq = seq + 1
                unit.id = "%04d.%s.%s" % (
                    seq, type(unit).__name__, unit.name)
                self._units.append(unit)

    def del_ref(self, unit: Unit) -> None:
        if unit in self._units:
            self._units.remove(unit)

    @property
    def units(self) -> List[Unit]:
        return list(self._units)

    @property
    def units_in_dependency_order(self) -> List[Unit]:
        """Topological-ish order by BFS from start_point; unreachable
        units appended in insertion order."""
        order: List[Unit] = []
        seen = set()
        frontier = [self.start_point]
        while frontier:
            nxt: List[Unit] = []
            for u in frontier:
                if id(u) in seen:
                    continue
                seen.add(id(u))
                order.append(u)
                nxt.extend(u.links_to)
            frontier = nxt
        for u in self._units:
            if id(u) not in seen:
                order.append(u)
        return order

    def __getitem__(self, idx):
        return self._units[idx]

    def __len__(self) -> int:
        return len(self._units)

    def index_of(self, unit: Unit) -> int:
        return self._units.index(unit)

    def change_unit(self, old: Unit, new: Unit) -> None:
        """Splice ``new`` into ``old``'s place in the graph
        (reference: veles/workflow.py:977-1051)."""
        for src in list(old.links_from):
            new.link_from(src)
        for dst in list(old.links_to):
            dst.link_from(new)
        old.unlink_all()
        if old in self._units:
            self._units[self._units.index(old)] = new
        elif new not in self._units:
            self._units.append(new)
        new._workflow = self

    # -- lifecycle ---------------------------------------------------------
    def verify(self, mode: Optional[str] = None):
        """Static graph verification (veles_tpu_torch.analysis.graph).

        Detects gate deadlocks, Repeater-less cycles, unreachable
        units, dangling/duplicate attribute links and initialize-order
        violations *before* anything runs. Called automatically at the
        top of :meth:`initialize`; ``root.common.analysis.verify``
        picks the policy — "error" (default) raises
        :class:`~veles_tpu_torch.analysis.graph.WorkflowVerificationError`,
        "warn" logs every diagnostic, "off" skips the pass. Returns
        the diagnostic list."""
        from veles_tpu_torch.analysis.graph import verify_or_raise
        return verify_or_raise(self, mode)

    def initialize(self, device=None, **kwargs: Any) -> None:
        """Initialize all units in dependency order with requeue.

        A unit returning True from initialize (missing demanded attrs) is
        retried after the others; no progress across a full sweep raises
        (reference: veles/workflow.py:303-349)."""
        self.verify()
        self.device = device if device is not None else self.device
        if self.thread_pool is None:
            from veles_tpu_torch.thread_pool import ThreadPool
            self.thread_pool = ThreadPool(name=self.name)
        pending = self.units_in_dependency_order
        sweep = 0
        while pending:
            requeued: List[Unit] = []
            for unit in pending:
                if unit._initialize_reproducibly(device=self.device,
                                                 **kwargs):
                    requeued.append(unit)
            if len(requeued) == len(pending):
                missing = {u.name: u.verify_demands() for u in requeued}
                raise RuntimeError(
                    "Workflow %s initialize deadlock: units with unmet "
                    "demands: %s" % (self.name, missing))
            pending = requeued
            sweep += 1
        super().initialize(**kwargs)
        self.debug("initialized %d units in %d sweeps", len(self._units),
                   sweep)

    def run(self) -> None:
        """Run the graph to completion (synchronous)
        (reference: veles/workflow.py:351-369)."""
        self.event("workflow_run", "begin", workflow=self.name)
        self.stopped = False
        # An explicit (re-)run is intentional: clear unit-level stopped
        # flags so a stop()ped workflow can be run again.
        # RunAfterStopError still catches triggers arriving after a
        # mid-run stop — the actual miswiring case.
        for unit in self._units:
            unit.stopped = False
        self._stalled_ = False
        self._sync_event_.clear()
        self._run_time_started_ = time.perf_counter()
        self.run_count += 1
        self._failure_ = None
        self._inflight_inc()
        # Fresh trampoline frame: a nested run() from inside an outer
        # graph's unit (ensemble member training, genetics evaluation)
        # must drain its own graph instead of enqueueing on the
        # caller's active loop (which is blocked under us) — deadlock.
        with fresh_trampoline():
            self.start_point._check_gate_and_run(None)
        self._sync_event_.wait()
        self.event("workflow_run", "end", workflow=self.name)
        # The failed unit stores its exception on the workflow *before*
        # the sync event is set (on_unit_failure), so a failure can never
        # be mistaken for success even if the pool's own bookkeeping has
        # not caught up yet.
        if self._failure_ is not None:
            failure, self._failure_ = self._failure_, None
            if self.thread_pool is not None:
                self.thread_pool.failure = None
            raise failure
        if self.thread_pool is not None and self.thread_pool.failure:
            failure = self.thread_pool.failure
            self.thread_pool.failure = None
            raise failure
        if self._stalled_:
            raise RuntimeError(
                "Workflow %s stalled: all units went idle before the end "
                "point ran — the control graph is miswired (no open path "
                "to end_point). Set workflow.detect_stall=False if units "
                "are re-triggered externally." % self.name)

    # -- stall detection ---------------------------------------------------
    detect_stall = True

    def _inflight_inc(self) -> None:
        with self._inflight_lock_:
            self._inflight_ += 1

    def _inflight_dec(self) -> None:
        with self._inflight_lock_:
            self._inflight_ -= 1
            if (self._inflight_ == 0 and self.detect_stall and
                    not self.stopped and not self._sync_event_.is_set()):
                self._stalled_ = True
                self.stopped = True
                self._sync_event_.set()

    def stop(self) -> None:
        self.stopped = True
        for unit in self._units:
            unit.stop()
        # Teardown backstop: any unit-owned service threads (stream
        # loader accept/recv loops, prefetch producers — everything on
        # the ManagedThreads discipline) must not outlive the workflow
        # as daemon leaks. Units normally join in their own stop();
        # this sweep catches owners whose stop() was overridden.
        for unit in self._units:
            threads = getattr(unit, "_service_threads_", None)
            if threads is None:
                continue
            leaked = threads.join_all()
            if leaked:
                self.warning(
                    "unit %s leaked service threads after stop: %s",
                    unit.name, [t.name for t in leaked])
        self._sync_event_.set()

    def on_workflow_finished(self) -> None:
        self.stopped = True
        if self._job_callback_ is not None:
            cb, self._job_callback_ = self._job_callback_, None
            cb()
        self._sync_event_.set()

    def on_unit_failure(self, unit: Unit, exc: BaseException) -> None:
        self.warning("unit %s failed (%s); stopping workflow",
                     unit.name, exc)
        if self._failure_ is None:
            self._failure_ = exc
        self.stopped = True
        self._sync_event_.set()

    @property
    def total_run_time(self) -> float:
        if self._run_time_started_ is None:
            return 0.0
        return time.perf_counter() - self._run_time_started_

    # -- distributed plumbing (host-level job farming) ---------------------
    # Job data travels as {unit.id: piece} dicts: pieces are matched by
    # each unit's stable uuid, never by enumeration order, so coordinator
    # and worker cannot mis-pair data even if they enumerate units
    # differently (the original design zips by order and
    # relies on its checksum, veles/workflow.py:476-548).

    def _units_by_id(self) -> Dict[str, Unit]:
        return {unit.id: unit for unit in self._units}

    def _resolve_unit(self, index: Dict[str, Unit], unit_id: str) -> Unit:
        unit = index.get(unit_id)
        if unit is None:
            raise KeyError(
                "Job data references unknown unit id %s — coordinator "
                "and worker run different workflows" % unit_id)
        return unit

    def generate_data_for_slave(self, slave=None, include_params=True):
        """Collect each unit's job piece for ``slave``.

        Returns ``{unit_id: piece}``, ``False`` when some unit postponed
        (no data right now), or raises NoMoreJobs
        (reference: veles/workflow.py:476-511).

        ``include_params=False`` skips units that flag their job piece
        as parameter state (``job_data_is_param_state``, e.g. the GD
        units shipping weights with replacement semantics): the
        pipelined coordinator uses it when the target worker's local
        params are provably at least as new as the master's — shipping
        them would both waste wire bytes and CLOBBER the worker's own
        newer state (distributed/server.py module docstring)."""
        order = self.units_in_dependency_order
        for unit in order:
            if not unit.negotiates_on_connect:
                if not unit.has_data_for_slave:
                    return False
        data = {}
        generated = []
        try:
            for unit in order:
                if unit.negotiates_on_connect:
                    continue
                if not include_params and \
                        getattr(unit, "job_data_is_param_state", False):
                    data[unit.id] = None  # skipped by the worker apply
                    continue
                with unit.data_lock():
                    piece = unit.generate_data_for_slave(slave)
                if piece is False:
                    # The unit postponed INSIDE generation (e.g. the
                    # genetics optimizer found every remaining
                    # chromosome already outstanding): the whole job
                    # is postponed. Under pipelined issue this is
                    # routine at generation boundaries — the request
                    # for job N+1 races the apply of update N — and
                    # shipping the raw False as a piece would crash
                    # the worker.
                    # NOTE: the postponing unit is NOT in `generated`
                    # — it recorded nothing, and retracting it would
                    # pop a genuinely in-flight entry instead
                    self._retract_job_pieces(generated, slave)
                    return False
                generated.append(unit)
                data[unit.id] = piece
        except NoMoreJobs:
            self._retract_job_pieces(generated, slave)
            raise
        return data

    def _retract_job_pieces(self, generated, slave) -> None:
        """Undo the per-slave records of units that already generated
        a piece in an aborted ``generate_data_for_slave`` call (a
        later unit raised NoMoreJobs or postponed): the loader has
        already marked a minibatch pending and must take back exactly
        that one. The slave may hold other, legitimately in-flight
        jobs whose pending records a blanket ``drop_slave`` would
        wrongly requeue — a double-apply under pipelined issue."""
        for unit in generated:
            retract = getattr(unit, "retract_data_for_slave", None)
            if retract is not None:
                with unit.data_lock():
                    retract(slave)

    @property
    def param_state_unit_ids(self):
        """Unit ids whose job/update pieces are full parameter state
        with replacement semantics (``job_data_is_param_state``).
        Handed to relay-tier sub-coordinators at welcome: in a batch
        of coalesced updates only the LAST param payload matters, so
        a relay may strip the others — every receiver here already
        skips ``None`` pieces."""
        return [unit.id for unit in self._units
                if getattr(unit, "job_data_is_param_state", False)]

    def requeue_one_job(self, slave=None) -> None:
        """Take back exactly ONE of ``slave``'s in-flight jobs (the
        relay retract path: a downstream worker died and its jobs ride
        the relay's slave id, so a blanket ``drop_slave`` would
        requeue the relay's healthy in-flight jobs too).

        Identity note: resolution order through a relay is not issue
        order, so per-slave attribution is count-exact, not
        identity-exact. Each unit chooses its own safe discipline via
        ``requeue_one_for_slave``: the loader pops its OLDEST pending
        minibatch (matching its FIFO apply attribution), the
        value-keyed units (genetics, ensemble) requeue the slave's
        whole outstanding set because their idempotent applies make
        duplicates harmless while a wrongly-guessed single pop could
        strand the dead record forever. ``retract_data_for_slave``
        (newest-pop, for aborted generation) is deliberately NOT a
        fallback here — it answers a different question."""
        for unit in self.units_in_dependency_order:
            requeue = getattr(unit, "requeue_one_for_slave", None)
            if requeue is not None:
                with unit.data_lock():
                    requeue(slave)

    def farm_resume(self, active_wids=()) -> None:
        """Post-restore sweep for a resumed coordinator
        (``distributed.server.resume_farm``): every worker of the dead
        incarnation is gone, so each recorded wid's in-flight jobs are
        requeued through the normal drop discipline (the loader's
        pending minibatches, the value-keyed units' outstanding sets).
        Marks the graph restored and runnable again; counters restart
        per coordinator incarnation (exactly-once holds within each —
        jobs lost between the last commit and the crash are simply
        re-served, which replacement-semantics updates absorb)."""
        for wid in active_wids:
            self.drop_slave(wid)
        self.stopped = False
        for unit in self._units:
            unit.stopped = False
            unit._restored_from_snapshot_ = True
        self._restored_from_snapshot_ = True

    @property
    def job_stream_complete(self) -> bool:
        """True once some unit has latched end-of-training (e.g. the
        decision's ``complete``): the coordinator discards updates for
        jobs that were still in flight when completion latched, so
        pipelined issue cannot walk the weights past the stop-and-wait
        trajectory."""
        for unit in self._units:
            if bool(getattr(unit, "job_stream_complete", False)):
                return True
        return False

    def apply_data_from_master(self, data) -> None:
        index = self._units_by_id()
        for unit_id, piece in data.items():
            if piece is None:
                continue
            unit = self._resolve_unit(index, unit_id)
            with unit.data_lock():
                unit.apply_data_from_master(piece)

    def generate_data_for_master(self):
        data = {}
        for unit in self.units_in_dependency_order:
            with unit.data_lock():
                data[unit.id] = unit.generate_data_for_master()
        return data

    def apply_data_from_slave(self, data, slave=None) -> None:
        """(reference: veles/workflow.py:531-548)"""
        index = self._units_by_id()
        for unit_id, piece in data.items():
            if piece is None:
                continue
            unit = self._resolve_unit(index, unit_id)
            with unit.data_lock():
                unit.apply_data_from_slave(piece, slave)

    def drop_slave(self, slave=None) -> None:
        # data_lock: drops run concurrently with job generation and
        # update application once the coordinator pumps jobs outside
        # its global lock (distributed/server.py producer thread)
        for unit in self.units_in_dependency_order:
            with unit.data_lock():
                unit.drop_slave(slave)

    def do_job(self, data, update, callback) -> None:
        """Worker-side: apply job, run one pass, call back with the update
        (reference: veles/workflow.py:558-573)."""
        self.apply_data_from_master(data)
        if update is not None:
            self.apply_data_from_slave(update, None)

        def finished():
            callback(self.generate_data_for_master())

        self._job_callback_ = finished
        self.run()

    def generate_initial_data_for_slave(self, slave=None):
        """Handshake payload (reference: veles/workflow.py:578-615)."""
        data = {}
        for unit in self.units_in_dependency_order:
            if unit.negotiates_on_connect:
                with unit.data_lock():
                    data[unit.id] = unit.generate_data_for_slave(slave)
        return data

    def apply_initial_data_from_master(self, data) -> None:
        index = self._units_by_id()
        for unit_id, piece in data.items():
            if piece is None:
                continue
            unit = self._resolve_unit(index, unit_id)
            with unit.data_lock():
                unit.apply_data_from_master(piece)

    @property
    def computing_power(self) -> float:
        """Worker capability score used for load balancing
        (reference: veles/workflow.py:617-623; measured by a matmul
        probe, see veles_tpu_torch.backends.Device.benchmark)."""
        dev = self.device
        return dev.computing_power if dev is not None else 1.0

    # -- identity ----------------------------------------------------------
    @property
    def checksum(self) -> str:
        """SHA1 pairing coordinator and workers: defining source file +
        per-unit (class, name) in dependency order + the control-edge
        list — so structurally different graphs can't pair
        (strengthens reference veles/workflow.py:851-866, which hashed
        only the file and the unit count). Cached on first access, so
        mode-specific rewiring (worker single-pass gating) after that
        does not desynchronize the coordinator/worker pairing.
        """
        cached = getattr(self, "_checksum_cache", None)
        if cached is not None:
            return cached
        self._checksum_cache = self._compute_checksum()
        return self._checksum_cache

    def _compute_checksum(self) -> str:
        sha1 = hashlib.sha1()
        try:
            srcfile = inspect.getsourcefile(type(self))
            with open(srcfile, "rb") as fin:
                sha1.update(fin.read())
        except (TypeError, OSError):
            sha1.update(type(self).__name__.encode())
        order = self.units_in_dependency_order
        index = {id(u): i for i, u in enumerate(order)}
        for i, unit in enumerate(order):
            sha1.update(("%d:%s:%s" % (
                i, type(unit).__name__, unit.name)).encode())
            for dst in unit.links_to:
                if id(dst) in index:
                    sha1.update(("->%d" % index[id(dst)]).encode())
        return sha1.hexdigest()

    # -- observability -----------------------------------------------------
    def get_unit_run_time_stats(self, top: Optional[int] = None):
        """[(name, total_s, calls, avg_s)] sorted by total desc
        (reference: veles/workflow.py:767-787)."""
        stats = sorted(
            ((u.name, u.total_run_time_, u.run_count_, u.average_run_time)
             for u in self._units if u.run_count_),
            key=lambda t: -t[1])
        return stats[:top] if top else stats

    def print_stats(self, top: int = 10) -> None:
        stats = self.get_unit_run_time_stats(top)
        total = sum(t[1] for t in stats) or 1.0
        self.info("unit run-time stats (top %d):", top)
        for name, tot, calls, avg in stats:
            self.info("  %-30s %8.3fs %6d calls %8.3fms avg %5.1f%%",
                      name, tot, calls, avg * 1000, tot / total * 100)

    def generate_graph(self, filename: Optional[str] = None,
                       write_on_disk: bool = True) -> str:
        """Emit the control graph in DOT format
        (reference: veles/workflow.py:628-754, pydot there)."""
        lines = ["digraph %s {" % type(self).__name__.replace(" ", "_"),
                 '  rankdir=TB;',
                 '  node [shape=box, style=filled, fillcolor="#c5e8f7"];']
        ids = {id(u): "u%d" % i
               for i, u in enumerate(self.units_in_dependency_order)}
        for u in self.units_in_dependency_order:
            lines.append('  %s [label="%s"];' % (ids[id(u)], u.name))
        for u in self.units_in_dependency_order:
            for dst in u.links_to:
                if id(dst) in ids:
                    lines.append("  %s -> %s;" % (ids[id(u)], ids[id(dst)]))
        lines.append("}")
        source = "\n".join(lines)
        if write_on_disk and filename:
            with open(filename, "w") as fout:
                fout.write(source)
        return source

    # -- results -----------------------------------------------------------
    def gather_results(self) -> Dict[str, Any]:
        """Merge metric dicts from all IResultProvider units
        (reference: veles/workflow.py:827-849)."""
        results: Dict[str, Any] = {}
        for unit in self._units:
            if isinstance(unit, IResultProvider):
                results.update(unit.get_metric_values())
        return results

    def write_results(self, file: Optional[str] = None) -> None:
        results = self.gather_results()
        results["workflow"] = type(self).__name__
        results["run_time"] = self.total_run_time
        if file:
            with open(file, "w") as fout:
                json.dump(results, fout, indent=2, default=_json_default)
        else:
            json.dump(results, sys.stdout, indent=2, default=_json_default)
            sys.stdout.write("\n")

    # -- package export ----------------------------------------------------
    def package_export(self, filename: str, precision: str = "float32"):
        """Export the trained graph to an inference archive, the
        reference's layout (reference: veles/workflow.py:868-975):
        ``contents.json`` describing the units in execution order plus
        ``NNNN_<name>.npy`` arrays, zip or tar[.gz]. Units take part by
        implementing ``export_spec() -> (props, {name: array})``, each
        array read to the host once (``Array.map_read``). A unit that
        transforms data but cannot export is warned about: the
        exported graph would skip it. ``InferenceEngine.from_package``
        (either package's) serves the archive."""
        units_json = []
        arrays: List[tuple] = []
        counter = 0
        for unit in self.units_in_dependency_order:
            spec = getattr(unit, "export_spec", None)
            if spec is None:
                demands = getattr(unit, "_demanded", ())
                # trainer and evaluator units stay out of an inference
                # package; anything else mapping input -> output is part
                # of the forward graph
                training_only = getattr(unit, "view_group", None) in (
                    "TRAINER", "EVALUATOR")
                if not training_only and \
                        isinstance(getattr(unit, "output", None), Array) and \
                        any(d.startswith("input") for d in demands):
                    self.warning(
                        "package_export: unit %s (%s) transforms data "
                        "but has no export_spec — the exported graph "
                        "will NOT apply it", unit.name, type(unit).__name__)
                continue
            props, unit_arrays = spec()
            refs = {}
            for aname, arr in unit_arrays.items():
                fname = "%04d_%s.npy" % (counter, aname)
                refs[aname] = fname
                arrays.append((fname, np.asarray(arr, dtype=precision)))
                counter += 1
            units_json.append({
                "class": type(unit).__name__,
                "uuid": getattr(unit, "EXPORT_UUID", type(unit).__name__),
                "name": unit.name,
                "properties": props,
                "arrays": refs,
            })
        contents = {
            "workflow": type(self).__name__,
            "checksum": self.checksum,
            "precision": precision,
            "units": units_json,
        }
        from veles_tpu_torch.aot.package import write_package
        write_package(filename, contents, arrays)
        self.info("exported package to %s (%d arrays)", filename, counter)
        return filename


def _json_default(obj):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, Bool):
        return bool(obj)
    return str(obj)
