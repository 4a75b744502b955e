"""Command-line surface of ``python -m veles_tpu_torch``.

Port of ``veles_tpu/cmdline.py``: every flag of the reference, so that
``replica_argv``/``worker_argv`` and any reference command line parse
alike. ``-d/--device`` takes the port's device names: ``auto`` (the
card; also the default) and ``cpu``. Flags whose planes are not ported
yet parse, and ``__main__`` refuses them naming what they wait for.
Services add options through :func:`register_arguments` hooks.
"""

from __future__ import annotations

import argparse
from typing import Callable, List

_EXTRA_ARG_HOOKS: List[Callable[[argparse.ArgumentParser], None]] = []


def register_arguments(hook: Callable[[argparse.ArgumentParser], None]):
    """Service modules contribute options (reference:
    CommandLineArgumentsRegistry metaclass)."""
    _EXTRA_ARG_HOOKS.append(hook)
    return hook


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="dataflow deep-learning framework on PyTorch and "
                    "CUDA (the port of veles_tpu)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument(
        "workflow", help="path to the workflow python file (defines "
        "run(load, main)) or dotted module name")
    parser.add_argument(
        "config", nargs="?", default=None,
        help="optional config python file executed with `root` in scope")
    parser.add_argument(
        "overrides", nargs="*", default=[],
        help="trailing config overrides: root.path.key=value")
    parser.add_argument(
        "-w", "--snapshot", default=None,
        help="restore and resume from this snapshot file "
             "(reference: -w)")
    parser.add_argument(
        "-r", "--random-seed", type=int, default=None,
        help="seed every PRNG stream (reference: -r)")
    parser.add_argument(
        "-d", "--device", default=None, choices=("auto", "cpu"),
        help="backend selection: auto = the CUDA card (the default), "
             "cpu = the plain PyTorch path on the host")
    parser.add_argument(
        "--result-file", default=None,
        help="write gathered IResultProvider metrics JSON here")
    parser.add_argument(
        "--dry-run", default="no", choices=("load", "init", "exec", "no"),
        help="stop after loading / initializing / one exec pass")
    parser.add_argument(
        "--workflow-graph", default=None,
        help="write the unit graph in DOT format to this file")
    parser.add_argument(
        "--verify-only", action="store_true",
        help="construct the workflow, run the static graph verifier "
             "(veles_tpu_torch.analysis: gate deadlocks, Repeater-less "
             "cycles, unreachable units, dangling attribute links) "
             "and exit — 0 when clean, 1 on errors; nothing is "
             "initialized or run")
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="-v info, -vv debug")
    parser.add_argument(
        "-l", "--listen", default=None, metavar="ADDR:PORT",
        help="run as coordinator listening on ADDR:PORT")
    parser.add_argument(
        "-m", "--master", default=None, metavar="ADDR:PORT",
        help="run as worker connecting to a coordinator")
    parser.add_argument(
        "--join", default=None, metavar="ADDR:PORT|auto",
        help="elastic scale-out: spawn --workers N (default 1) worker "
             "processes against an already-RUNNING coordinator and "
             "wait for them — no coordinator or workflow runs in this "
             "process. 'auto' discovers the coordinator via its "
             "--announce UDP beacon (first beacon heard wins: when "
             "several farms announce on one network, pass the "
             "explicit ADDR:PORT — workers still refuse a mismatched "
             "workflow at handshake, so the wrong farm fails loudly, "
             "not silently)")
    parser.add_argument(
        "--encoding", default="none",
        choices=("none", "bf16", "int8"),
        help="coordinator mode: update/param wire encoding with "
             "per-worker error-feedback residuals (int8 successive-"
             "state deltas = 4x fewer update bytes, bf16 = 2x); "
             "negotiated per connection, so old workers interop at "
             "'none'")
    parser.add_argument(
        "--announce", action="store_true",
        help="broadcast a role-tagged UDP discovery beacon: a "
             "coordinator announces role=coordinator (elastic "
             "'--join auto' workers find the farm), a --serve "
             "replica announces role=replica + its serve port (a "
             "--route --announce router adds it to the fleet), and a "
             "--route router LISTENS for replica beacons. Roles "
             "never cross-match, so a farm and a serve fleet share "
             "one LAN safely")
    parser.add_argument(
        "--checkpoint", default=None, metavar="DIR",
        help="coordinator mode: write crash-safe sharded farm "
             "checkpoints (params + loader cursors + conservation "
             "meta) into DIR — async, committed via tmp+fsync+atomic "
             "rename with per-shard crc32, at dispatch-window edges")
    parser.add_argument(
        "--checkpoint-every", type=int, default=16, metavar="K",
        help="coordinator mode: checkpoint every K applied updates "
             "(a SIGKILL never loses more than one such interval)")
    parser.add_argument(
        "--resume", default=None, metavar="PATH|auto",
        help="coordinator mode: restore the master workflow from the "
             "newest committed farm checkpoint instead of "
             "constructing it — PATH is the checkpoint directory (or "
             "a manifest inside it); 'auto' resumes from --checkpoint "
             "DIR when a checkpoint exists and cold-starts otherwise "
             "(the crash-loop/systemd-restart form). In-flight jobs "
             "of the dead incarnation requeue; reconnecting workers "
             "bootstrap via the normal full-param join path")
    parser.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="seeded fault-injection plan (chaos testing): semicolon-"
             "separated events like 'kill:0@5;drop:1@3;"
             "kill-coordinator@20' — see veles_tpu_torch/distributed/"
             "faults.py for the grammar; also via env VELES_FAULTS "
             "(+VELES_FAULT_INDEX for spawned workers)")
    parser.add_argument(
        "--fault-seed", type=int, default=0, metavar="N",
        help="seed for the fault plan's backoff jitter stream")
    parser.add_argument(
        "--max-outstanding", type=int, default=2, metavar="K",
        help="coordinator mode: per-worker credit window — up to K "
             "jobs in flight per worker so communication overlaps "
             "computation (parameter-server request pipelining); 1 "
             "restores strict stop-and-wait issue")
    parser.add_argument(
        "--workers", type=int, default=0, metavar="N",
        help="coordinator mode: also spawn N local worker processes "
             "with this command line (reference: _launch_nodes, one "
             "process per device — veles/launcher.py:808-842)")
    parser.add_argument(
        "--nodes", default=None, metavar="HOST1,HOST2,...",
        help="with --workers: launch worker slot s on "
             "nodes[s %% len] over ssh (BatchMode, same filtered "
             "argv; 'local' keeps a slot on this machine). Also "
             "'@hostfile' (one host per line) or 'auto' (GCE "
             "metadata discovery — the YARN-RM equivalent, reference "
             "veles/launcher.py:887-906). The nodes need the package "
             "importable by --remote-python")
    parser.add_argument(
        "--remote-python", default="python3", metavar="PATH",
        help="python executable used on --nodes hosts")
    parser.add_argument(
        "--remote-cwd", default=None, metavar="DIR",
        help="working directory on --nodes hosts (default: login dir)")
    parser.add_argument(
        "--respawn", action="store_true",
        help="restart spawned workers that die, with exponential "
             "backoff (reference: --respawn, veles/server.py:637-655)")
    parser.add_argument(
        "--mesh-processes", type=int, default=0, metavar="N",
        help="join an N-process torch.distributed group (one process "
             "a rank) before creating the device; the rendezvous "
             "address is derived from -l/-m (port+1) unless "
             "--mesh-coordinator is given")
    parser.add_argument(
        "--mesh-process-id", type=int, default=None, metavar="I",
        help="this process's rank in the global mesh (defaults to 0 "
             "for the coordinator; workers MUST pass it)")
    parser.add_argument(
        "--mesh-coordinator", default=None, metavar="ADDR:PORT",
        help="explicit rendezvous endpoint (overrides the "
             "-l/-m derived default)")
    parser.add_argument(
        "--serve", default=None, metavar="ADDR:PORT",
        help="serve mode: instead of training, expose the loaded "
             "model (construct, or restore via -w) over HTTP — "
             "POST /apply, GET /healthz, GET /metrics — through the "
             "veles_tpu_torch.serve engine + dynamic micro-batcher. The "
             "workflow argument may also be a package_export archive "
             "(.zip/.tar/.tgz), served directly without a module")
    parser.add_argument(
        "--serve-max-batch", type=int, default=64, metavar="ROWS",
        help="serve mode: rows per dispatched batch")
    parser.add_argument(
        "--serve-max-delay-ms", type=float, default=2.0, metavar="MS",
        help="serve mode: max time the oldest queued request waits "
             "before a partial batch dispatches")
    parser.add_argument(
        "--serve-queue-rows", type=int, default=1024, metavar="ROWS",
        help="serve mode: admission-control bound; beyond it POSTs "
             "get 503 + Retry-After")
    parser.add_argument(
        "--serve-deadline-ms", type=float, default=None, metavar="MS",
        help="serve mode: default end-to-end client deadline applied "
             "to requests that carry none (requests may override via "
             "the deadline_ms body field / X-Deadline-Ms header). "
             "Expired work is shed before it reaches the device and "
             "answers 504; work that provably cannot make its "
             "deadline is shed on arrival with 503 + a Retry-After "
             "computed from the observed drain rate. Unset = patient "
             "clients")
    parser.add_argument(
        "--serve-watchdog-s", type=float, default=30.0, metavar="S",
        help="serve mode: dispatch watchdog — once any model's "
             "CURRENT device call has been out this long, /healthz "
             "answers 503 {\"stuck\": true} (the load-balancer "
             "removal signal) and recovers the moment the call "
             "returns. 0 disables")
    parser.add_argument(
        "--serve-gen-slots", type=int, default=8, metavar="N",
        help="serve mode, LM workflows: concurrent sequences in the "
             "KV-cache slab (a transformer workflow serves POST "
             "/generate through the continuous token batcher; N is "
             "the continuous-batch width)")
    parser.add_argument(
        "--serve-gen-queue", type=int, default=64, metavar="N",
        help="serve mode, LM workflows: pending-generation admission "
             "bound; beyond it POSTs get 503 + Retry-After")
    parser.add_argument(
        "--serve-mesh", default=None, metavar="SPEC",
        help="serve mode: run the engine SPMD on a device mesh — "
             "'tp=N' shards attention heads (Megatron column/row "
             "weights, head-partitioned KV slab/page pool) over N "
             "devices via jit in_shardings/out_shardings; per-chip "
             "KV bytes divide by N and decode stays one compile. "
             "tp must divide both the visible device count and the "
             "model's head count. Multi-process replicas (joined via "
             "--mesh-processes/--mesh-coordinator) shard over the "
             "GLOBAL device list. Unset = single-device engine. "
             "Passes through replica_argv, so --replicas fleets "
             "spawn sharded")
    parser.add_argument(
        "--route", default=None, metavar="ADDR:PORT",
        help="fleet mode: run the replica ROUTER tier instead of a "
             "workflow — load-balance POST /apply and POST /generate "
             "(incl. streaming) over replica ServeServers using "
             "their /healthz signals (drain-rate EWMA, queue depth, "
             "stuck flag), with session affinity, deadline-aware "
             "edge shedding, and exactly-once failover of in-flight "
             "non-streaming tickets when a replica dies. Pair with "
             "--replicas N to spawn local replica processes, "
             "--announce to also discover external replicas via "
             "their role=replica UDP beacons, and --rollout to push "
             "a package through the fleet canary-first")
    parser.add_argument(
        "--replicas", type=int, default=0, metavar="N",
        help="--route mode: spawn N local replica serve processes "
             "(this command line with --serve swapped in, ports "
             "router+1..router+N) under fleet supervision — dead "
             "replicas respawn with backoff and rejoin the router")
    parser.add_argument(
        "--rollout", default=None, metavar="PACKAGE",
        help="--route mode: once the fleet is healthy, roll this "
             "package_export archive out one replica at a time via "
             "each replica's registry hot-swap (POST /admin/swap) — "
             "the first replica is the canary; a spike of its "
             "poisoned/non-finite/error counters vs the fleet "
             "baseline rolls it back automatically and aborts")
    parser.add_argument(
        "--serve-while-training", default=None, metavar="ADDR:PORT",
        help="multi-tenant mode: run the training workflow AND an "
             "HTTP serving engine over the SAME device pool in one "
             "process, time-sliced by the cooperative scheduler "
             "(veles_tpu_torch.sched). The trainer yields at dispatch-"
             "window/unit boundaries, the serve batcher at batch/"
             "token boundaries; leases are revocable only between "
             "quanta, so the training trajectory stays bit-identical "
             "to an unscheduled run. Serves the constructed "
             "workflow's current parameters (an LM workflow serves "
             "POST /generate, everything else POST /apply); "
             "per-tenant quanta/device-ms/queue-wait ride GET "
             "/metrics and the web-status dashboard")
    parser.add_argument(
        "--sched-train-weight", type=float, default=1.0, metavar="W",
        help="--serve-while-training: the training tenant's WFQ "
             "weight (device-time share is proportional to weight "
             "when both tenants are backlogged)")
    parser.add_argument(
        "--sched-serve-weight", type=float, default=4.0, metavar="W",
        help="--serve-while-training: the serving tenant's WFQ weight")
    parser.add_argument(
        "--sched-serve-deadline-ms", type=float, default=50.0,
        metavar="MS",
        help="--serve-while-training: queue-wait deadline for the "
             "serving tenant — a serve batch waiting longer than this "
             "outranks every priority class (bounds serve tail "
             "latency under a backlogged trainer)")
    parser.add_argument(
        "--serve-refresh-s", type=float, default=5.0, metavar="S",
        help="--serve-while-training: how often the served engine "
             "hot-swaps in the trainer's current weights (no "
             "recompile; the capture runs as its own scheduler "
             "tenant, so it never reads a torn mid-dispatch tree). "
             "0 disables — serve the initialization-time weights "
             "for the whole run")
    parser.add_argument(
        "--sched-aging-ms", type=float, default=250.0, metavar="MS",
        help="scheduler starvation aging: a waiter gains one "
             "effective priority step per this many ms waited, so a "
             "low-priority tenant's queue wait is bounded by "
             "aging_ms x priority gap")
    parser.add_argument(
        "--aot-cache", default=None, metavar="DIR",
        help="persistent AOT cache (the cold-start plane): kernel "
             "libraries built and loaded under DIR/kernels/ (keyed by "
             "sources, flags, compute capability and CUDA versions), "
             "capture records under DIR/artifacts/; a serving process "
             "warms every recorded entry before its port opens. Shared "
             "by every process pointed at DIR (spawned replicas and "
             "workers inherit it)")
    parser.add_argument(
        "--aot-cache-mb", type=int, default=512, metavar="MB",
        help="--aot-cache size bound of the capture records (LRU "
             "evicted beyond it)")
    parser.add_argument(
        "--aot-export", default=None, metavar="PKG",
        help="at exit, write this process's capture records into PKG "
             "(aot/ members of an existing package archive, else a "
             "standalone bundle); packages never carry a shared "
             "library")
    parser.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="observability: at exit, write the span ring buffer as "
             "Chrome-trace/Perfetto JSON to PATH (the same document "
             "a ServeServer exposes live at GET /debug/trace). "
             "Tracing itself is on by default (VELES_TRACE=0 "
             "disables); spans cover HTTP handling, batcher queue "
             "waits, scheduler quantum waits, prefill/decode "
             "dispatch, and farm job hops stitched coordinator -> "
             "relay -> worker")
    parser.add_argument(
        "--profile-steps", default=None, metavar="N[@K]",
        help="observability: capture a torch.profiler trace for N "
             "steps starting at step K (default 0) on whatever plane "
             "this process runs — trainer dispatch windows, serve "
             "batches/decode steps, farm worker jobs. Artifacts land "
             "in --profile-dir (TensorBoard profile plugin / "
             "Perfetto read them)")
    parser.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="--profile-steps output directory (default: "
             "<--checkpoint DIR>/profile next to the checkpoints, "
             "else ./profiles)")
    parser.add_argument(
        "--log-context", action="store_true",
        help="observability: append the active trace/ticket/job ids "
             "to log lines emitted inside instrumented scopes "
             "(grep-able '[trace=... job=...]' suffix); off by "
             "default at zero cost")
    parser.add_argument(
        "--manhole", action="store_true",
        help="open a unix-socket REPL for attaching to this (possibly "
             "hung) process: python -m veles_tpu_torch.manhole PID "
             "attaches; SIGUSR2 dumps every thread's stack")
    parser.add_argument(
        "--timings", action="store_true",
        help="per-unit run-time debug prints "
             "(reference: --timings, veles/units.py:144-149)")
    parser.add_argument(
        "--slave-death-probability", type=float, default=0.0,
        help="fault injection: probability a worker dies per job "
             "(reference: veles/client.py:303-307)")
    parser.add_argument(
        "--optimize", default=None, metavar="SIZE[:GENERATIONS]",
        help="genetic hyperparameter search over Range() markers in "
             "the config tree; each chromosome trains the model "
             "workflow (reference: --optimize, veles/__main__.py:334)")
    parser.add_argument(
        "--ensemble-train", default=None, metavar="N[:RATIO]",
        help="train N model instances on random train subsets and "
             "save the member archive (reference: --ensemble-train)")
    parser.add_argument(
        "--ensemble-test", default=None, metavar="MEMBERS_FILE",
        help="evaluate a saved ensemble member archive "
             "(reference: --ensemble-test)")
    parser.add_argument(
        "--ensemble-file", default="ensemble_members.pickle.gz",
        help="member archive path for --ensemble-train/--ensemble-test")
    for hook in _EXTRA_ARG_HOOKS:
        hook(parser)
    return parser
