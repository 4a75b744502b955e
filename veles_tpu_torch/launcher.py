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
already, so the host side only needs the unit thread pool. The graphics
server and the status reporter are not ported yet (ROADMAP.md queue 1
item 11): a config that asks for one (``root.common.graphics.dir``,
``root.common.web.status_url``) makes :meth:`Launcher.initialize`
raise. Both are off by default.
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
        """The plot renderer (reference: the Launcher launched
        GraphicsServer, veles/launcher.py:431-548) is not ported yet:
        a config that asks for it raises."""
        from veles_tpu_torch.config import get, root
        directory = get(root.common.graphics.dir)
        if not directory or self.is_slave:
            return None
        raise NotImplementedError(
            "root.common.graphics.dir=%r: the graphics server waits for "
            "the port's plotting (ROADMAP.md queue 1 item 11)"
            % (directory,))

    def _start_status_reporter(self):
        """The periodic status POST to a web-status server (reference:
        veles/launcher.py:852-885 _notify_status) is not ported yet: a
        config that asks for it raises."""
        from veles_tpu_torch.config import get, root
        url = get(root.common.web.status_url)
        if not url or self.is_slave:
            return None
        raise NotImplementedError(
            "root.common.web.status_url=%r: the status reporter waits "
            "for the port's web_status (ROADMAP.md queue 1 item 11)"
            % (url,))

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
