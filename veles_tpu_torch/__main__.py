"""Main entry point: ``python -m veles_tpu_torch workflow.py [config.py]
[root.k=v ...]``.

Port of ``veles_tpu/__main__.py``. ``Main`` loads the workflow module,
executes the config file and the trailing overrides, seeds the random
streams, optionally restores a snapshot (``-w``) or a farm checkpoint
(``--resume``), then calls the module's ``run(load, main)``: the
workflow file calls ``load(WorkflowClass, **kwargs)`` to construct or
restore, then ``main(**kwargs)`` to initialize and run.

Modes: standalone training; ``--serve`` (an LM workflow serves ``POST
/generate`` through ``GenerativeEngine.from_trainer``, anything else
``POST /apply`` through ``InferenceEngine.from_workflow``);
``--serve-while-training``; the farm (``-l``/``-m``, ``--workers``,
``--join``); ``--route --replicas N`` (the serving fleet);
``--optimize``, ``--ensemble-train`` and ``--ensemble-test``.

Everything runs on the CUDA card unless ``-d cpu`` asks for the host.
``--serve`` of a ``package_export`` archive (``model.zip``, ``.tar``,
``.tgz``) serves it through ``InferenceEngine.from_package`` with no
workflow module. ``--aot-cache DIR`` arms the AOT plan
(``veles_tpu_torch.aot``) before anything is built: kernel libraries
under ``DIR/kernels/``, capture records under ``DIR/artifacts/``; a
serving process builds every kernel and captures every planned entry
before its port opens, and logs the startup report. ``--aot-export PKG`` writes the records
into PKG at exit. ``--route --replicas N --rollout PKG`` rolls a
package through the fleet canary-first. ``--manhole`` opens a
unix-socket REPL into the process (``veles_tpu_torch.manhole``);
``root.common.web.status_url`` makes a training run, and the
``--route`` fleet, POST status documents to a web-status server.

A ``--serve`` or ``--route`` process drains and exits 0 on SIGINT and
on SIGTERM (the fleet stops its replica processes with SIGTERM).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Any, Optional, Tuple

from veles_tpu_torch import prng
from veles_tpu_torch.config import apply_config_file, apply_overrides, root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.snapshotter import Snapshotter

_PACKAGE_SUFFIXES = (".zip", ".tar", ".tgz", ".tar.gz")


class Main:
    """One CLI invocation."""

    def __init__(self, argv=None) -> None:
        from veles_tpu_torch.cmdline import make_parser
        self._argv = list(argv) if argv is not None else sys.argv[1:]
        # intermixed: trailing `root.k=v` overrides may follow flags
        self.args = make_parser().parse_intermixed_args(self._argv)
        # a `key=value` token in the config slot is an override
        if self.args.config and "=" in self.args.config and \
                not os.path.exists(self.args.config):
            self.args.overrides.insert(0, self.args.config)
            self.args.config = None
        self.launcher: Optional[Launcher] = None
        self.workflow = None
        self._restored = False
        self.exit_code = 0
        self.serve_server = None          # set in --serve mode(s)
        self.router_server = None         # set in --route mode
        self.fleet = None                 # set in --route mode
        self._serve_stop = threading.Event()
        self.scheduler = None             # --serve-while-training
        self._train_tenant = None
        self._refresh_threads = None
        self._serve_bind = None
        self._early_pool = None
        self._manhole = None              # --manhole

    # -- pieces ------------------------------------------------------------
    def _setup_logging(self) -> None:
        level = (logging.WARNING, logging.INFO,
                 logging.DEBUG)[min(self.args.verbose, 2)]
        logging.basicConfig(level=level)
        if self.args.timings:
            root.common.trace.run = True
            if level > logging.DEBUG:
                logging.getLogger().setLevel(logging.DEBUG)

    def _is_package(self) -> bool:
        """The workflow argument is a package archive."""
        return os.path.isfile(self.args.workflow) and \
            self.args.workflow.endswith(_PACKAGE_SUFFIXES)

    def _load_model(self):
        """Import the workflow file as a module (or a dotted name)."""
        path = self.args.workflow
        if os.path.exists(path):
            name = os.path.splitext(os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
            return module
        return importlib.import_module(path)

    def _apply_config(self) -> None:
        if self.args.config:
            apply_config_file(self.args.config)
        if self.args.overrides:
            apply_overrides(self.args.overrides)

    def _seed_random(self) -> None:
        if self.args.random_seed is not None:
            prng.seed_all(self.args.random_seed)

    def _mode(self) -> str:
        if self.args.listen:
            return "coordinator"
        if self.args.master:
            return "worker"
        return "standalone"

    def _mesh_join(self) -> Optional[dict]:
        """--mesh-processes N joins this process to an N-rank
        torch.distributed group (gloo with ``-d cpu``, else NCCL); the
        rendezvous defaults to the control-plane address (-l/-m) with
        port + 1."""
        n = self.args.mesh_processes
        if not n:
            return None
        coord = self.args.mesh_coordinator
        if coord is None:
            addr = self.args.listen or self.args.master
            if addr is None:
                raise SystemExit(
                    "--mesh-processes needs -l/-m or --mesh-coordinator")
            host, port = addr.rsplit(":", 1)
            coord = "%s:%d" % (host or "127.0.0.1", int(port) + 1)
        pid = self.args.mesh_process_id
        if pid is None:
            if self._mode() != "coordinator":
                raise SystemExit(
                    "worker processes must pass --mesh-process-id")
            pid = 0
        cpu = self.args.device == "cpu"
        return {"coordinator": coord, "num_processes": n,
                "process_id": pid, "backend": "gloo" if cpu else "nccl",
                "device": "cpu" if cpu else None}

    def _serve_mesh(self):
        """--serve-mesh tp=N: a serve mesh over the joined group (one
        process a rank, ``--mesh-processes``), or None."""
        spec = self.args.serve_mesh
        if not spec:
            return None
        from veles_tpu_torch.serve.sharding import (parse_mesh_spec,
                                                    serve_mesh)
        tp = parse_mesh_spec(spec)["tp"]
        if tp == 1:
            return None
        return serve_mesh(tp, device=self._engine_device())

    def _engine_device(self):
        """The torch device the launcher bound (the card unless -d
        cpu)."""
        if self.launcher is not None and self.launcher.device is not None:
            return self.launcher.device.torch_device
        return "cpu" if self.args.device == "cpu" else None

    # -- the two callbacks handed to the workflow module -------------------
    def _fault_plan(self):
        """The session's FaultPlan (None without --faults or the
        environment's); kill-coordinator is a real SIGKILL here."""
        from veles_tpu_torch.distributed.faults import FaultPlan
        if self.args.faults:
            # exported so --workers children inherit the plan
            os.environ["VELES_FAULTS"] = self.args.faults
            os.environ["VELES_FAULT_SEED"] = str(self.args.fault_seed)
            return FaultPlan(self.args.faults,
                             seed=self.args.fault_seed, sigkill=True)
        plan = FaultPlan.from_env()
        if plan is not None:
            plan.sigkill = True
        return plan

    def _try_resume(self) -> bool:
        """--resume PATH|auto: restore the master workflow from the
        newest committed farm checkpoint; False when auto found none."""
        if not self.args.resume:
            return False
        from veles_tpu_torch.distributed.server import resume_farm
        path = self.args.resume
        auto = path == "auto"
        if auto:
            if not self.args.checkpoint:
                raise SystemExit("--resume auto needs --checkpoint DIR "
                                 "(the directory to resume from)")
            path = self.args.checkpoint
        workflow, meta, gen = resume_farm(path, required=not auto)
        if workflow is None:
            logging.info("--resume auto: no checkpoint in %s yet — "
                         "cold start", path)
            return False
        self.workflow = workflow
        self.workflow.workflow = self.launcher
        self._restored = True
        logging.info("resumed farm workflow from %s (generation %s, "
                     "%s applied updates at capture)", path, gen,
                     (meta or {}).get("applied", "?"))
        return True

    def _load(self, workflow_class, **kwargs) -> Tuple[Any, bool]:
        self.launcher = Launcher(mode=self._mode(),
                                 mesh_join=self._mesh_join())
        if self._try_resume():
            if kwargs and hasattr(self.workflow, "resume_overrides"):
                self.workflow.resume_overrides(**kwargs)
        elif self.args.snapshot:
            self.workflow = Snapshotter.load(self.args.snapshot)
            self.workflow.workflow = self.launcher
            self._restored = True
            logging.info("restored workflow from %s", self.args.snapshot)
            if kwargs:
                # config and overrides act on the resumed run too (a
                # raised max_epochs extends training)
                if hasattr(self.workflow, "resume_overrides"):
                    self.workflow.resume_overrides(**kwargs)
                else:
                    logging.warning(
                        "restored workflow has no resume_overrides; "
                        "ignoring kwargs %s", sorted(kwargs))
        else:
            self.workflow = workflow_class(self.launcher, **kwargs)
        return self.workflow, self._restored

    def _lm_trainer(self):
        """The TransformerTrainer of an LM workflow, else None."""
        trainer = getattr(getattr(self.workflow, "trainer_unit", None),
                          "_trainer_", None)
        if trainer is not None and hasattr(trainer, "config"):
            return trainer
        return None

    def _main(self, **kwargs) -> None:
        if self.args.workflow_graph:
            self.workflow.generate_graph(self.args.workflow_graph)
        if self.args.verify_only:
            from veles_tpu_torch.analysis.graph import (format_report,
                                                        verify_graph)
            diags = verify_graph(self.workflow)
            print(format_report(diags, self.workflow.name))
            self.exit_code = 1 if any(d.is_error for d in diags) else 0
            return
        if self.args.dry_run == "load":
            return
        if self.args.dry_run == "exec" and \
                hasattr(self.workflow, "prepare_single_pass"):
            self.workflow.prepare_single_pass()
        if self.args.serve_while_training:
            # tenancy markers go on before initialize
            self._setup_serve_while_training()
        self.launcher.initialize(backend=self.args.device, **kwargs)
        if self.args.dry_run == "init":
            self.launcher.stop()
            return
        if self.args.serve:
            # serve mode replaces the training run: expose the current
            # (constructed, or -w restored) parameters
            from veles_tpu_torch.serve.engine import (GenerativeEngine,
                                                      InferenceEngine)
            trainer = self._lm_trainer()
            device = self._engine_device()
            try:
                mesh = self._serve_mesh()
                if trainer is not None:
                    engine = GenerativeEngine.from_trainer(
                        trainer, max_slots=self.args.serve_gen_slots,
                        mesh=mesh, device=device)
                else:
                    engine = InferenceEngine.from_workflow(
                        self.workflow, mesh=mesh, device=device)
                self._serve(engine)
            finally:
                self.launcher.stop()
            return
        if self.args.serve_while_training:
            self._start_serve_while_training()
        decision = getattr(self.workflow, "decision", None)
        already_done = (
            self._restored and decision is not None and
            bool(getattr(decision, "complete", False)))
        if already_done:
            logging.warning(
                "restored workflow already completed training (epoch "
                "%s); pass e.g. max_epochs=N in the config/overrides "
                "to extend it — skipping run",
                getattr(decision, "epoch_number", "?"))
        try:
            if already_done:
                pass
            elif self._mode() == "coordinator":
                self._run_coordinator()
            elif self._mode() == "worker":
                self._run_worker()
            else:
                self.launcher.run()
        finally:
            # serve drains first: with the trainer done its tenant
            # stops asking, and queued serve work runs unopposed
            self._stop_serve_while_training()
            self.launcher.stop()
        self.workflow.print_stats()
        if self.args.result_file:
            with open(self.args.result_file, "w") as f:
                json.dump(self.workflow.gather_results(), f, indent=2,
                          default=str)

    def _spawned_pool(self):
        """WorkerPool for --workers N (None when not asked): workers
        re-run this invocation's argv with -l swapped for -m."""
        if self._early_pool is not None:
            return self._early_pool
        if self.args.workers <= 0:
            return None
        if self.args.listen.endswith(":0"):
            raise SystemExit(
                "--workers needs an explicit -l port (workers "
                "connect to the address you pass)")
        from veles_tpu_torch.distributed import WorkerPool
        from veles_tpu_torch.distributed.discovery import resolve_nodes
        return WorkerPool(self.args.workers, self.args.listen,
                          argv=self._argv, respawn=self.args.respawn,
                          nodes=resolve_nodes(self.args.nodes),
                          remote_python=self.args.remote_python,
                          remote_cwd=self.args.remote_cwd)

    def _coordinator_kwargs(self) -> dict:
        return dict(max_outstanding=self.args.max_outstanding,
                    encoding=self.args.encoding,
                    announce=self.args.announce,
                    checkpoint_dir=self.args.checkpoint,
                    checkpoint_every=self.args.checkpoint_every,
                    fault_plan=self._fault_plan())

    def _run_coordinator(self) -> None:
        from veles_tpu_torch.distributed import run_coordinator
        pool = self._spawned_pool()
        try:
            run_coordinator(self.workflow, self.args.listen,
                            **self._coordinator_kwargs())
        finally:
            if pool is not None:
                pool.stop()

    def _run_worker(self) -> None:
        from veles_tpu_torch.distributed import run_worker
        run_worker(self.workflow, self.args.master,
                   death_probability=self.args.slave_death_probability,
                   fault_plan=self._fault_plan())

    # -- serve mode ---------------------------------------------------------
    def _wait_for_stop(self) -> None:
        """Block until :meth:`stop_serving`, or on the main thread
        SIGINT or SIGTERM (handled, so a second signal during the
        drain cannot break it)."""
        previous = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                previous[sig] = signal.signal(
                    sig, lambda *_: self._serve_stop.set())
        try:
            while not self._serve_stop.wait(0.25):
                pass
            logging.info("stop requested: draining")
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _serve(self, engine) -> None:
        """Build the registry and HTTP front over ``engine`` and block
        until stopped; the stop drains. On a serve mesh only the
        leader of the ``model`` slice serves: the other ranks follow
        its device calls until it releases them. With ``--announce``
        the replica beacons its serve address (``role=replica``)."""
        from veles_tpu_torch.serve.engine import GenerativeEngine
        from veles_tpu_torch.serve.registry import ModelRegistry
        from veles_tpu_torch.serve.server import ServeServer
        addr = self.args.serve
        host, _, port = addr.rpartition(":")
        if not port.isdigit():
            raise SystemExit(
                "--serve needs ADDR:PORT (port 0 = ephemeral); got %r"
                % addr)
        shard = getattr(engine, "_shard", None)
        if shard is not None and not shard.leader:
            logging.info("serve mesh rank %d follows its leader",
                         shard.mesh.rank)
            engine.follow()
            self._leave_mesh(shard)
            return
        generative = isinstance(engine, GenerativeEngine)
        self._warm(engine, "serve")
        registry = ModelRegistry()
        if generative:
            registry.add_generative("default", engine,
                                    max_queue=self.args.serve_gen_queue)
        else:
            registry.add("default", engine,
                         max_batch=self.args.serve_max_batch,
                         max_delay_ms=self.args.serve_max_delay_ms,
                         max_queue_rows=self.args.serve_queue_rows)
        self.serve_server = ServeServer(
            registry, host=host or "127.0.0.1", port=int(port or 0),
            watchdog_s=self.args.serve_watchdog_s or None,
            default_deadline_ms=self.args.serve_deadline_ms,
            # only a fleet-spawned replica opens /admin/swap
            admin_swap=os.environ.get("VELES_SERVE_ADMIN") == "1")
        announcer = None
        if self.args.announce:
            from veles_tpu_torch.distributed.discovery import Announcer
            announcer = Announcer(
                "%s:%d" % self.serve_server.endpoint,
                checksum=os.path.basename(self.args.workflow),
                role="replica")
            announcer.start()
        logging.info("serving %s on http://%s:%d (/%s; healthz and "
                     "metrics alongside)", engine.name,
                     *self.serve_server.endpoint,
                     "generate" if generative else "apply")
        try:
            self._wait_for_stop()
        finally:
            if announcer is not None:
                announcer.stop()
            self.serve_server.stop(drain=True)
            engine.stop_followers()
            self._leave_mesh(shard)

    @staticmethod
    def _leave_mesh(shard) -> None:
        """A serve mesh's ranks leave their group together once the
        leader has released its followers."""
        if shard is not None and shard.tp > 1:
            from veles_tpu_torch.parallel import multiprocess
            multiprocess.leave()

    def stop_serving(self) -> None:
        """Ask a blocked serve or route loop to drain and return."""
        self._serve_stop.set()

    def _warm(self, engine, context: str, tenant=None) -> None:
        """The cold-start tax before the port opens. Under an AOT plan:
        every kernel library built or loaded (on the card), every
        planned entry and the warm ladder captured (the
        micro-batcher's whole bucket range), then the startup report.
        Without one, a generative engine on the card warms its ladder
        (every prefill bucket, the decode round captured)."""
        from veles_tpu_torch import aot
        from veles_tpu_torch.serve.engine import InferenceEngine
        plan = aot.active()
        quantum = tenant.quantum() if tenant is not None else \
            contextlib.nullcontext()
        if plan is None:
            if not isinstance(engine, InferenceEngine) and \
                    engine.device.type == "cuda":
                with quantum:
                    engine.warm()
            return
        if engine.device.type == "cuda":
            # every library built (all nvcc at once) or found under
            # DIR/kernels/, inside the startup window
            from veles_tpu_torch.ops import _build
            _build.build()
        engine.warm_max_batch = self.args.serve_max_batch
        with quantum:
            warmed = aot.warm_engine(engine)
        report = aot.startup_report(context=context)
        logging.info("aot: warmed %d capture(s); start-to-ready %.2fs",
                     warmed, report["seconds"])

    def _serve_package(self) -> int:
        """``--serve`` with a package archive as the workflow
        argument: the engine straight from the archive (no module, no
        launcher, no training graph). With ``--serve-mesh`` the process
        joins its mesh first."""
        from veles_tpu_torch.serve.engine import InferenceEngine
        join = self._mesh_join()
        if join:
            from veles_tpu_torch.parallel import multiprocess
            multiprocess.initialize(**join)
        self._serve(InferenceEngine.from_package(
            self.args.workflow, mesh=self._serve_mesh(),
            device=self._engine_device()))
        return 0

    # -- multi-tenant serve-while-training ----------------------------------
    def _setup_serve_while_training(self) -> None:
        """Before initialize: the scheduler, and the training
        workflow's device units as the ``train`` tenant."""
        from veles_tpu_torch import sched
        addr = self.args.serve_while_training
        host, _, port = addr.rpartition(":")
        if not port.isdigit():
            raise SystemExit(
                "--serve-while-training needs ADDR:PORT (port 0 = "
                "ephemeral); got %r" % addr)
        self._serve_bind = (host or "127.0.0.1", int(port))
        self.scheduler = sched.Scheduler(
            aging_ms=self.args.sched_aging_ms)
        self._train_tenant = self.scheduler.register(
            "train", weight=self.args.sched_train_weight)
        sched.attach_workflow(self.workflow, self._train_tenant)

    def _start_serve_while_training(self) -> None:
        """After initialize: the initialized workflow's parameters as
        the ``serve`` tenant of the same device, and the HTTP front."""
        from veles_tpu_torch.serve.engine import (GenerativeEngine,
                                                  InferenceEngine)
        from veles_tpu_torch.serve.registry import ModelRegistry
        from veles_tpu_torch.serve.server import ServeServer
        host, port = self._serve_bind
        serve_tenant = self.scheduler.register(
            "serve", weight=self.args.sched_serve_weight,
            deadline_ms=self.args.sched_serve_deadline_ms)
        registry = ModelRegistry()
        trainer = self._lm_trainer()
        device = self._engine_device()
        if trainer is not None:
            engine = GenerativeEngine.from_trainer(
                trainer, max_slots=self.args.serve_gen_slots,
                device=device)
            registry.add_generative(
                "default", engine,
                max_queue=self.args.serve_gen_queue,
                tenant=serve_tenant)

            def current_params():
                return trainer.params
        else:
            engine = InferenceEngine.from_workflow(self.workflow,
                                                   device=device)
            registry.add(
                "default", engine,
                max_batch=self.args.serve_max_batch,
                max_delay_ms=self.args.serve_max_delay_ms,
                max_queue_rows=self.args.serve_queue_rows,
                tenant=serve_tenant)

            def current_params():
                from veles_tpu_torch.parallel.fused import fuse_forwards
                return fuse_forwards(self.workflow.forwards)[1]
        # before the port opens, inside the serve tenant's quantum: the
        # training tenant has not stepped yet
        self._warm(engine, "serve-while-training", tenant=serve_tenant)
        self.serve_server = ServeServer(
            registry, host=host, port=port,
            scheduler=self.scheduler,
            watchdog_s=self.args.serve_watchdog_s or None,
            default_deadline_ms=self.args.serve_deadline_ms)
        if self.args.serve_refresh_s > 0:
            self._start_serve_refresh(engine, current_params)
        self.launcher.scheduler = self.scheduler
        self.launcher.serve_registry = registry
        logging.info(
            "serving WHILE training on http://%s:%d (tenants: train "
            "w=%g, serve w=%g deadline=%gms; weight refresh every %gs)",
            *self.serve_server.endpoint,
            self.args.sched_train_weight, self.args.sched_serve_weight,
            self.args.sched_serve_deadline_ms,
            self.args.serve_refresh_s)

    def _start_serve_refresh(self, engine, current_params) -> None:
        """Every ``--serve-refresh-s`` seconds, clone the trainer's
        current parameters on the device inside the ``refresh``
        tenant's quantum (so no train step runs while they are read:
        the trainers update their tensors in place) and
        ``swap_params`` the clone into the live engine."""
        from veles_tpu_torch.sched import SchedulerStopped
        from veles_tpu_torch.thread_pool import ManagedThreads
        self._refresh_threads = ManagedThreads(name="serve-refresh")
        refresh_tenant = self.scheduler.register(
            "refresh", weight=0.25, threads=self._refresh_threads)

        def refresh_loop():
            while not self._refresh_threads.wait_stop(
                    self.args.serve_refresh_s):
                try:
                    with refresh_tenant.quantum():
                        params = _clone_tree(current_params())
                    engine.swap_params(params)
                except SchedulerStopped:
                    return
                except Exception:  # noqa: BLE001 — keep serving
                    logging.warning("serve weight refresh failed; "
                                    "serving the previous weights",
                                    exc_info=True)

        self._refresh_threads.spawn(refresh_loop, name="refresh")

    def _stop_serve_while_training(self) -> None:
        """Stop the refresh tenant, drain the serve plane, then stop
        granting quanta."""
        if self._refresh_threads is not None:
            self._refresh_threads.request_stop()
            self._refresh_threads.join_all()
        if self.serve_server is not None and \
                self.args.serve_while_training:
            self.serve_server.stop(drain=True)
        if self.scheduler is not None:
            self.scheduler.stop()

    # -- alternate run modes ------------------------------------------------
    def _train_once(self, setup=None) -> Any:
        """One full standalone training of the model workflow through
        the module's run(load, main); returns the workflow.
        ``setup(workflow)`` runs after construction, before
        initialize."""
        module = self._module
        holder = {}

        def load(workflow_class, **kwargs):
            launcher = Launcher()
            wf = workflow_class(launcher, **kwargs)
            holder["launcher"], holder["wf"] = launcher, wf
            if setup is not None:
                setup(wf)
            return wf, False

        def main(**kwargs):
            launcher = holder["launcher"]
            launcher.initialize(backend=self.args.device, **kwargs)
            try:
                launcher.run()
            finally:
                launcher.stop()

        module.run(load, main)
        return holder["wf"]

    @staticmethod
    def _fitness_of(workflow) -> float:
        """Higher is better: the negated error or RMSE."""
        results = workflow.gather_results()
        for key in ("min_validation_error_pt", "min_validation_rmse"):
            if results.get(key) is not None:
                return -float(results[key])
        raise RuntimeError(
            "--optimize needs a min_validation_* metric; results have "
            "%s" % sorted(results))

    def _run_job_workflow(self, wf) -> None:
        """Run an outer job workflow (GA, ensemble) standalone or
        farmed over the coordinator/worker channel."""
        wf.thread_pool = None
        mode = self._mode()
        if mode == "standalone":
            wf.initialize()
            wf.run()
            return
        wf.is_standalone = False
        if mode == "coordinator":
            wf.is_master = True
            wf.initialize()
            from veles_tpu_torch.distributed import run_coordinator
            pool = self._spawned_pool()
            try:
                run_coordinator(wf, self.args.listen,
                                **self._coordinator_kwargs())
            finally:
                if pool is not None:
                    pool.stop()
        else:
            wf.is_slave = True
            wf.initialize()
            from veles_tpu_torch.distributed import run_worker
            run_worker(wf, self.args.master,
                       death_probability=self.args.
                       slave_death_probability,
                       fault_plan=self._fault_plan())

    def _write_results(self, results) -> None:
        if self.args.result_file:
            with open(self.args.result_file, "w") as f:
                json.dump(results, f, indent=2, default=str)

    def _run_optimize(self) -> None:
        """GA over the Range() markers of the config tree."""
        from veles_tpu_torch.genetics import OptimizationWorkflow
        from veles_tpu_torch.genetics.core import set_config_path
        parts = self.args.optimize.split(":")
        size = int(parts[0])
        generations = int(parts[1]) if len(parts) > 1 else 10

        def evaluate(config_values):
            for path, value in config_values.items():
                set_config_path(path, value)
            prng.reset()
            return self._fitness_of(self._train_once())

        opt = OptimizationWorkflow(
            evaluate=evaluate, size=size, generations=generations,
            config_root=root)
        self._run_job_workflow(opt)
        results = opt.gather_results()
        logging.info("optimization done: best %s -> fitness %.4f",
                     results.get("best_config"),
                     results.get("best_fitness", float("nan")))
        self._write_results(results)

    def _run_ensemble_train(self) -> None:
        """Train N members on random train subsets and save them."""
        import gzip
        import pickle

        from veles_tpu_torch.ensemble import EnsembleTrainerWorkflow
        parts = self.args.ensemble_train.split(":")
        size = int(parts[0])
        ratio = float(parts[1]) if len(parts) > 1 else 0.8

        def factory(index, seed, train_ratio):
            root.common.random.seed = seed
            prng.reset()

            def setup(wf):
                loader = getattr(wf, "loader", None)
                if loader is not None:
                    loader.train_ratio = train_ratio

            return self._train_once(setup)

        ens = EnsembleTrainerWorkflow(
            model_factory=factory, size=size, train_ratio=ratio)
        self._run_job_workflow(ens)
        with gzip.open(self.args.ensemble_file, "wb") as f:
            pickle.dump(ens.members, f, protocol=4)
        logging.info("ensemble: %d members -> %s", size,
                     self.args.ensemble_file)
        self._write_results(ens.gather_results())

    def _run_ensemble_test(self) -> None:
        """The members' combined evaluation on the model workflow's
        VALID set."""
        import gzip
        import pickle

        import numpy as np

        from veles_tpu_torch.ensemble import EnsembleTesterWorkflow
        from veles_tpu_torch.loader.base import VALID
        with gzip.open(self.args.ensemble_test, "rb") as f:
            members = pickle.load(f)
        holder = {}

        def load(workflow_class, **kwargs):
            launcher = Launcher()
            holder["wf"] = workflow_class(launcher, **kwargs)
            holder["launcher"] = launcher
            return holder["wf"], False

        def main(**kwargs):
            holder["launcher"].initialize(backend=self.args.device,
                                          **kwargs)
            holder["launcher"].stop()

        self._module.run(load, main)
        loader = holder["wf"].loader
        ends = loader.class_end_offsets
        lo, hi = ends[0], ends[VALID]
        data = _host(loader.original_data)[lo:hi]
        labels = np.asarray(_host(loader.original_labels)[lo:hi])

        test_wf = EnsembleTesterWorkflow(members=members)
        test_wf.thread_pool = None
        test_wf.tester.data = data
        test_wf.tester.labels = labels
        from veles_tpu_torch.backends import Device
        test_wf.initialize(device=Device(backend=self.args.device))
        test_wf.run()
        results = test_wf.gather_results()
        logging.info("ensemble test: %s", results)
        self._write_results(results)

    # -- fleet router mode --------------------------------------------------
    def _run_route(self) -> int:
        """``--route ADDR:PORT``: the replica-router tier. No workflow
        runs here: ``--replicas N`` processes re-run this command line
        with ``--serve`` swapped in (ports router + 1 .. router + N)
        under fleet supervision, and ``--announce`` also admits any
        replica beaconing ``role=replica``."""
        from veles_tpu_torch.distributed.spawn import ReplicaProcess
        from veles_tpu_torch.serve.fleet import (FleetManager,
                                                 ProcessReplica)
        from veles_tpu_torch.serve.router import RouterServer
        addr = self.args.route
        host, _, port = addr.rpartition(":")
        if not port.isdigit():
            raise SystemExit(
                "--route needs ADDR:PORT (port 0 = ephemeral); got %r"
                % addr)
        if self.args.serve or self.args.serve_while_training:
            raise SystemExit("--route runs the router tier; pass "
                             "exactly one of --route / --serve / "
                             "--serve-while-training")
        self._apply_config()
        server = RouterServer(
            host=host or "127.0.0.1", port=int(port),
            default_deadline_ms=self.args.serve_deadline_ms)
        self.router_server = server
        fleet = FleetManager(server.router)
        self.fleet = fleet
        base_port = server.endpoint[1]
        for i in range(self.args.replicas):
            replica_addr = "127.0.0.1:%d" % (base_port + 1 + i)
            fleet.add(ProcessReplica(
                "r%d" % i,
                ReplicaProcess(replica_addr, argv=self._argv,
                               fault_index=i)))
        if self.args.announce:
            # replicas beacon checksum=basename(workflow): two fleets
            # of different models on one network never cross-join
            server.router.watch_beacons(
                checksum=os.path.basename(self.args.workflow))
        reporter = self._start_fleet_reporter(fleet)
        logging.info(
            "fleet router on %s (%d spawned replica(s)%s)",
            server.url, self.args.replicas,
            ", watching replica beacons" if self.args.announce
            else "")
        try:
            if self.args.rollout:
                self._route_rollout(server, fleet)
            self._wait_for_stop()
        finally:
            if reporter is not None:
                reporter.stop()
            handles = fleet.handles()
            fleet.stop(stop_replicas=False)
            for handle in handles:
                code = handle.stop()
                logging.info("replica %s (pid %d) exited with %s",
                             handle.name, handle.pid, code)
            server.stop()
        return self.exit_code

    #: how long ``--rollout`` waits for the spawned replicas
    ROLLOUT_WAIT_S = 600.0

    def _route_rollout(self, server, fleet) -> None:
        """``--rollout PKG``: wait until every spawned replica is
        routable, then roll the package through the fleet canary-first
        (a canary whose bad outcomes spike is swapped back)."""
        want = max(self.args.replicas, 1)
        deadline = time.monotonic() + self.ROLLOUT_WAIT_S
        while server.router.routable_count() < want and \
                time.monotonic() < deadline and \
                not self._serve_stop.is_set():
            time.sleep(0.25)
        if server.router.routable_count() == 0:
            logging.error("--rollout: no routable replica came up")
            self.exit_code = 1
            return
        ok = fleet.rollout(package=os.path.abspath(self.args.rollout))
        if ok:
            logging.info("--rollout: %s rolled out over %d replica(s)",
                         self.args.rollout, len(fleet.handles()))
        else:
            logging.error("--rollout: canary auto-rollback tripped (%s)",
                          fleet.rollout_status().get("reason"))
            self.exit_code = 1

    def _start_fleet_reporter(self, fleet):
        """Periodic fleet-card POST to web_status when configured
        (the same ``root.common.web.status_url`` plumbing training
        runs use; the dashboard renders ``doc["fleet"]``)."""
        from veles_tpu_torch.config import get
        url = get(root.common.web.status_url)
        if not url:
            return None
        from veles_tpu_torch.web_status import StatusReporter
        reporter = StatusReporter(
            url, "router-%d" % os.getpid(),
            interval=float(get(root.common.web.status_interval, 10.0)))

        def source():
            from veles_tpu_torch.obs import metrics as obs_metrics
            return {"mode": "router",
                    "workflow": os.path.basename(self.args.workflow),
                    "fleet": fleet.status_doc(),
                    "metrics": obs_metrics.REGISTRY.as_wire()}

        reporter.start(source)
        return reporter

    # -- elastic scale-out --------------------------------------------------
    def _run_join(self) -> int:
        """``--join ADDR:PORT|auto``: spawn worker processes against a
        live coordinator and wait for them."""
        from veles_tpu_torch.distributed import WorkerPool
        from veles_tpu_torch.distributed.discovery import (
            discover_coordinator, resolve_nodes)
        address = self.args.join
        if address == "auto":
            address = discover_coordinator(timeout=60.0)
            if not address:
                raise SystemExit(
                    "--join auto: no coordinator beacon heard in 60s "
                    "— is the coordinator running with --announce?")
            logging.info("discovered coordinator at %s", address)
        n = max(1, self.args.workers)
        pool = WorkerPool(n, address, argv=self._argv,
                          respawn=self.args.respawn,
                          nodes=resolve_nodes(self.args.nodes),
                          remote_python=self.args.remote_python,
                          remote_cwd=self.args.remote_cwd)
        try:
            pool.wait()
        finally:
            pool.stop()
        return 0

    # -- observability ------------------------------------------------------
    def _setup_obs(self) -> None:
        """--log-context / --profile-steps: the obs plane's
        process-wide hooks, before any plane starts stepping."""
        if self.args.log_context:
            from veles_tpu_torch.logger import enable_log_context
            enable_log_context()
        if self.args.profile_steps:
            from veles_tpu_torch.obs import profile as obs_profile
            out_dir = self.args.profile_dir
            if not out_dir:
                out_dir = os.path.join(self.args.checkpoint, "profile") \
                    if self.args.checkpoint else "profiles"
            obs_profile.configure(self.args.profile_steps, out_dir)

    def _finish_obs(self) -> None:
        """--trace-out and the profiler's flush at exit."""
        from veles_tpu_torch.obs import profile as obs_profile
        if obs_profile.PROFILER is not None:
            obs_profile.configure(None, "")
        if self.args.trace_out:
            from veles_tpu_torch.obs.trace import TRACER
            n = TRACER.write(self.args.trace_out)
            logging.info("wrote %d trace event(s) to %s (open in "
                         "chrome://tracing or Perfetto)", n,
                         self.args.trace_out)

    # -- the AOT plane -------------------------------------------------------
    def _setup_aot(self) -> None:
        """--aot-cache / --aot-export: arm the process's plan before
        anything builds or captures, in every mode (--serve, replicas,
        workers, training)."""
        if not (self.args.aot_cache or self.args.aot_export):
            return
        from veles_tpu_torch import aot
        aot.configure(cache_dir=self.args.aot_cache,
                      export_to=self.args.aot_export,
                      max_bytes=self.args.aot_cache_mb << 20)

    def _finish_aot(self) -> None:
        from veles_tpu_torch import aot
        if aot.active() is None:
            return
        # a training run reports at exit, so the counts always log
        aot.startup_report(context="exit")
        aot.flush_export()

    # -- entry -------------------------------------------------------------
    def run(self) -> int:
        try:
            return self._run()
        finally:
            if self._manhole is not None:
                self._manhole.close()
            self._finish_aot()
            self._finish_obs()

    def _run(self) -> int:
        self._setup_logging()
        self._setup_obs()
        self._setup_aot()
        if self.args.serve and self.args.serve_while_training:
            raise SystemExit(
                "--serve REPLACES training; pass exactly one of "
                "--serve / --serve-while-training")
        if self.args.join:
            return self._run_join()
        if self.args.route:
            return self._run_route()
        if self.args.manhole:
            from veles_tpu_torch import manhole
            self._manhole = manhole.install(namespace={"main": self})
            logging.info("manhole at %s (SIGUSR2 dumps stacks)",
                         self._manhole.path)
        join = self._mesh_join()
        if join and self._mode() == "coordinator" and self.args.workers:
            if join["num_processes"] != self.args.workers + 1:
                raise SystemExit(
                    "--mesh-processes must equal --workers + 1 "
                    "(coordinator is rank 0; got %d processes for %d "
                    "workers)" % (join["num_processes"],
                                  self.args.workers))
            # the join blocks until every rank connects, so the
            # spawned workers must exist before the launcher joins
            self._early_pool = self._spawned_pool()
        try:
            self._apply_config()
            self._seed_random()
            if self.args.serve and self._is_package():
                return self._serve_package()
            self._module = self._load_model()
            if not hasattr(self._module, "run"):
                print("workflow module %s has no run(load, main)" %
                      self.args.workflow, file=sys.stderr)
                return 1
            if self.args.optimize:
                self._run_optimize()
            elif self.args.ensemble_train:
                self._run_ensemble_train()
            elif self.args.ensemble_test:
                self._run_ensemble_test()
            else:
                self._module.run(self._load, self._main)
        finally:
            if self._early_pool is not None:
                self._early_pool.stop()
        return self.exit_code


def _clone_tree(tree):
    """A copy of a parameter tree: tensors cloned on their device,
    numpy arrays copied."""
    import numpy as np
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _host(x):
    """Host numpy of an Array, a tensor or an array."""
    import numpy as np
    if hasattr(x, "map_read"):
        x = x.map_read()
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def main(argv=None) -> int:
    return Main(argv).run()


if __name__ == "__main__":
    sys.exit(main())
