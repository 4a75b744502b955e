"""Launcher: owns the run mode, device and workflow lifecycle.

Port of ``veles_tpu/launcher.py``. Reference: veles/launcher.py —
decides standalone/master/slave from ``-l/-m`` flags (:333-356), owns
the Twisted reactor and thread pool, spawns remote slaves over ssh,
reports status. The modes:

- **standalone** — one host, one card (or a mesh of ranks joined
  through ``mesh_join``, one process a rank);
- **coordinator / worker** — host-level elastic job farming over the
  distributed layer (``veles_tpu_torch.distributed``), with gradient
  traffic on the mesh collectives, not the job channel.

The reactor collapses to plain threads: CUDA launches are asynchronous
already, so the host side only needs the unit thread pool. The launcher
owns two services, both off by default: the plot renderer
(``root.common.graphics.dir``, :class:`~veles_tpu_torch.plotting.
GraphicsServer`) and the periodic status POST to a web-status server
(``root.common.web.status_url``, :class:`~veles_tpu_torch.web_status.
StatusReporter`). Their documents hold host values only: the
reporter's thread reads the decision's host numbers, never a device
tensor (a read would wait on the training stream, and for the whole
window while a step graph is being captured).
"""

from __future__ import annotations

import time
from typing import Any, Optional

from veles_tpu_torch.backends import Device
from veles_tpu_torch.logger import Logger


class Launcher(Logger):
    """Runs a workflow in a mode; the CLI's `main` object.

    >>> launcher = Launcher()
    >>> wf = SomeWorkflow(launcher)      # launcher can be the parent
    >>> launcher.initialize()
    >>> launcher.run()
    """

    def __init__(self, interactive: bool = False,
                 mode: str = "standalone",
                 mesh_join: Optional[dict] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.interactive = interactive
        self.mode = mode
        #: Multi-process mesh membership: {"coordinator": "host:port",
        #: "num_processes": N, "process_id": I} (and optionally
        #: ``backend``/``device``), joined at initialize through
        #: ``parallel.multiprocess.initialize`` before the device binds.
        self.mesh_join = mesh_join
        self.workflow = None
        self.device: Optional[Device] = None
        self._start_time = None
        #: multi-tenant device pool (veles_tpu_torch.sched): set by the
        #: --serve-while-training path so the status reporter can
        #: publish per-tenant accounting alongside the run document
        self.scheduler = None
        #: serve registry co-hosted with a training run — its
        #: decode-plane / qps gauges ride the same status document
        self.serve_registry = None

    # -- container duck-typing so Workflow(launcher) works ------------------
    @property
    def is_standalone(self) -> bool:
        return self.mode == "standalone"

    @property
    def is_master(self) -> bool:
        return self.mode in ("master", "coordinator")

    @property
    def is_slave(self) -> bool:
        return self.mode in ("slave", "worker")

    def add_ref(self, workflow) -> None:
        self.workflow = workflow

    def del_ref(self, workflow) -> None:
        if self.workflow is workflow:
            self.workflow = None

    @property
    def thread_pool(self):
        return self.workflow.thread_pool if self.workflow else None

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, backend: Optional[str] = None,
                   **kwargs: Any) -> None:
        if self.workflow is None:
            raise RuntimeError("no workflow attached to the launcher")
        if self.mesh_join:
            from veles_tpu_torch.parallel import multiprocess
            multiprocess.initialize(**self.mesh_join)
            self.info("joined global mesh: process %d/%d",
                      multiprocess.process_index(),
                      multiprocess.process_count())
        self.device = Device(backend=backend)
        self.info("mode=%s device=%r", self.mode, self.device)
        self.workflow.is_standalone = self.is_standalone
        self.workflow.is_master = self.is_master
        self.workflow.is_slave = self.is_slave
        self.workflow.initialize(device=self.device, **kwargs)
        # Reporter lives from initialize to stop so coordinator runs
        # (which bypass Launcher.run) report too.
        self._reporter = self._start_status_reporter()
        self._graphics = self._start_graphics()

    def _start_graphics(self):
        """Own the plot renderer when configured (reference: the
        Launcher launched GraphicsServer — veles/launcher.py:431-548).
        Plotter units publish through workflow.graphics_sink_
        (trailing underscore: sinks hold sockets and must stay out of
        snapshots — Pickleable drops *_ attributes)."""
        from veles_tpu_torch.config import get, root
        directory = get(root.common.graphics.dir)
        if not directory or self.is_slave:
            return None
        from veles_tpu_torch.plotting import GraphicsServer
        server = GraphicsServer(
            out_dir=str(directory),
            spawn_process=bool(get(root.common.graphics.spawn_process,
                                   True)),
            # root.common.graphics.broadcast = "0.0.0.0:5001" opens
            # the any-machine subscription stream (subscribers:
            # python -m veles_tpu_torch.plotting --endpoint host:5001
            # --out dir)
            broadcast=get(root.common.graphics.broadcast) or None)
        server.attach(self.workflow)
        if server.broadcast_endpoint:
            self.info("graphics renderer -> %s (broadcast on %s:%d)",
                      directory, *server.broadcast_endpoint)
        else:
            self.info("graphics renderer -> %s", directory)
        return server

    def _start_status_reporter(self):
        """Periodic status POST to a web-status server when configured
        (reference: veles/launcher.py:852-885 _notify_status — masters
        and standalone runs report; workers do not)."""
        from veles_tpu_torch.config import get, root
        url = get(root.common.web.status_url)
        if not url or self.is_slave:
            return None
        import os

        from veles_tpu_torch.web_status import StatusReporter
        run_id = "%s-%d" % (type(self.workflow).__name__, os.getpid())
        reporter = StatusReporter(
            url, run_id,
            interval=float(get(root.common.web.status_interval, 10.0)))

        def source():
            wf = self.workflow
            doc = {"mode": self.mode,
                   "workflow": type(wf).__name__,
                   "device": repr(self.device),
                   "run_time": time.monotonic() - (
                       self._start_time or time.monotonic())}
            decision = getattr(wf, "decision", None)
            if decision is not None:
                doc["epoch"] = decision.epoch_number
                doc["best_error"] = float(decision.min_validation_error)
            server = getattr(wf, "_coordinator_", None)
            if server is not None and hasattr(server, "worker_states"):
                doc["workers"] = server.worker_states()
            if server is not None and \
                    hasattr(server, "checkpoint_stats"):
                stats = server.checkpoint_stats()
                if stats:
                    doc["checkpoint"] = stats
            sched = self.scheduler
            if sched is None:
                tenant = getattr(wf, "sched_pool_tenant_", None)
                sched = getattr(tenant, "scheduler", None)
            if sched is not None:
                doc["scheduler"] = sched.snapshot()
            if self.serve_registry is not None:
                doc["serve"] = self.serve_registry.metrics_snapshot()
            from veles_tpu_torch import aot
            aot_doc = aot.status_doc()
            if aot_doc:
                doc["aot"] = aot_doc
            # the obs plane: this process's registry (tracer health +
            # registered collectors), the coordinator's farm-wide
            # registry when one runs here, and the slowest-requests
            # exemplars — web_status serves /metrics and renders the
            # breakdown table from exactly these keys
            from veles_tpu_torch.obs.trace import EXEMPLARS
            from veles_tpu_torch.obs import metrics as obs_metrics
            samples = obs_metrics.REGISTRY.as_wire()
            if server is not None and hasattr(server, "metrics_wire"):
                samples += server.metrics_wire()
            doc["metrics"] = samples
            slowest = EXEMPLARS.snapshot()
            if slowest:
                doc["slowest"] = slowest
            return doc

        reporter.start(source)
        return reporter

    def run(self) -> None:
        self._start_time = time.monotonic()
        try:
            self.workflow.run()
        finally:
            from veles_tpu_torch.obs.trace import elapsed_s
            self.info("workflow finished in %.1f s",
                      elapsed_s(self._start_time))

    def stop(self) -> None:
        reporter = getattr(self, "_reporter", None)
        if reporter is not None:
            reporter.stop()
            self._reporter = None
        # Quiesce the graph + pool BEFORE closing graphics: leaf
        # plotter tasks may still be publishing when run() returns.
        if self.workflow is not None:
            self.workflow.stop()
        if self.thread_pool is not None:
            self.thread_pool.shutdown()
        graphics = getattr(self, "_graphics", None)
        if graphics is not None:
            self._graphics = None
            try:
                graphics.close()
            except Exception as e:  # noqa: BLE001 - shutdown best effort
                self.warning("graphics close failed: %s", e)

    def boot(self, backend: Optional[str] = None, **kwargs: Any) -> None:
        """initialize + run + stop (reference Launcher.boot).
        initialize is INSIDE the try: it starts the status reporter and
        graphics renderer, which must be torn down if a later startup
        step (e.g. the renderer handshake) fails."""
        try:
            self.initialize(backend=backend, **kwargs)
            self.run()
        finally:
            self.stop()
