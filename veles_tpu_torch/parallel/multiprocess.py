"""Multi-process mesh: N processes join one ``torch.distributed`` group.

Port of ``veles_tpu/parallel/multiprocess.py``. The reference's
processes join one JAX runtime and then see one global device list;
here each process is one rank of a process group (one process a rank,
SPMD), and a mesh over the group names which ranks talk over which
axis::

    from veles_tpu_torch.parallel import multiprocess as mp
    mp.initialize("10.0.0.1:9999", num_processes=4, process_id=rank,
                  backend="nccl")
    mesh = mp.global_mesh(MeshConfig(data=4))
    ...
    mp.shutdown()

The backend is the caller's: ``"nccl"`` (CUDA tensors go straight
through) or ``"gloo"`` (CPU tensors; CUDA tensors are staged through
host memory by ``parallel.collectives``). Nothing switches between
them quietly: NCCL with more local ranks than cards raises. The device
is explicit too: None is ``cuda:<local_rank % device_count>`` (raising
without a card), ``"cpu"`` only when the caller passes it.

:func:`run_world` spawns such a world of local processes around a
function, each with a deadline, for tests and smoke runs.
"""

from __future__ import annotations

import os
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from veles_tpu_torch.parallel.mesh import MeshConfig, make_mesh

_STATE: dict = {"membership": None, "device": None}


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "nccl", device=None, timeout_s: int = 60,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None) -> None:
    """Join the group: ``init_process_group(init_method="tcp://" +
    coordinator, world_size=num_processes, rank=process_id)`` with a
    timeout of ``timeout_s`` on the join and on every collective. A
    second call with the same membership is a no-op (another raises).

    ``local_rank``/``local_world_size`` (default: ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` from the environment, else all processes on
    this host) pick the card and let NCCL refuse to put two ranks on
    one card, which it cannot do."""
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    membership = (coordinator, int(num_processes), int(process_id), backend)
    if is_initialized():
        if _STATE["membership"] == membership:
            return
        raise RuntimeError("this process already joined %r; shutdown() "
                           "before joining %r" % (_STATE["membership"],
                                                  membership))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              num_processes))
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("NCCL moves CUDA tensors; device %r needs "
                             "backend='gloo'" % (device,))
        if local_world_size > cards:
            raise RuntimeError(
                "NCCL needs a card per local rank: %d local ranks on %d "
                "card(s) (NCCL refuses two ranks on one card); pass "
                "backend='gloo' to share a card through host-staged "
                "collectives" % (local_world_size, cards))
    if device is None:
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (with backend='gloo') to run "
                               "the ranks on the CPU")
        device = torch.device("cuda", local_rank % cards)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timedelta(seconds=timeout_s))
    _STATE["membership"] = membership
    _STATE["device"] = device


def shutdown() -> None:
    """Leave the group (a no-op when not joined)."""
    if is_initialized():
        dist.destroy_process_group()
    _STATE["membership"] = None
    _STATE["device"] = None


def membership() -> Optional[tuple]:
    """(coordinator, num_processes, process_id, backend) of the group
    :func:`initialize` joined (None before)."""
    return _STATE["membership"]


def device() -> Optional[torch.device]:
    """The device :func:`initialize` chose for this rank (None before)."""
    return _STATE["device"]


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def global_mesh(config: Optional[MeshConfig] = None):
    """The mesh over every process of the group (axis order data, seq,
    model: the chatty axes on neighbouring ranks)."""
    return make_mesh(config)


def _spec_slices(mesh, spec: Sequence[Any], shape) -> tuple:
    out = []
    for dim, names in enumerate(tuple(spec) + (None,) * (
            len(shape) - len(spec))):
        if names is None:
            out.append(slice(None))
            continue
        names = (names,) if isinstance(names, str) else tuple(names)
        n, i = mesh.size(*names), mesh.index(*names)
        if shape[dim] % n:
            raise ValueError("dim %d of %s does not split %d ways over %s"
                             % (dim, tuple(shape), n, names))
        step = shape[dim] // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def host_to_global(mesh, spec: Sequence[Any], arr) -> torch.Tensor:
    """This rank's shard of a host array (identical on every process)
    under ``spec``: one entry a dim, an axis name, a tuple of names, or
    None (replicated), as a ``PartitionSpec``. Only the shard crosses to
    the device."""
    arr = np.asarray(arr)
    part = np.ascontiguousarray(arr[_spec_slices(mesh, spec, arr.shape)])
    return torch.from_numpy(part).to(mesh.device)


def local_batch_to_global(mesh, spec: Sequence[Any], local,
                          global_batch: Optional[int] = None
                          ) -> torch.Tensor:
    """This rank's rows of a global batch that the loader gave it alone
    (the data never leaves the process that read it): checked against
    ``global_batch`` and placed on the rank's device."""
    local = np.ascontiguousarray(local)
    names = spec[0] if spec else None
    n = 1 if names is None else mesh.size(
        *((names,) if isinstance(names, str) else names))
    if global_batch is not None and local.shape[0] * n != global_batch:
        raise ValueError("%d local rows x %d shards != global batch %d"
                         % (local.shape[0], n, global_batch))
    return torch.from_numpy(local).to(mesh.device)


# ---------------------------------------------------------------------------
# a local world of spawned processes
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port of this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_main(fn, rank, n, port, backend, device, timeout_s, args,
                queue, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize("127.0.0.1:%d" % port, n, rank, backend=backend,
                   device=device, timeout_s=timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            shutdown()
        queue.put((rank, True, result))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, n: int, backend: str, device=None,
              args: tuple = (), timeout_s: float = 300,
              threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes joined as one
    group over ``backend`` on ``127.0.0.1`` (each rank on ``device``;
    None: the card of its local rank) and return the ranks' results in
    rank order. ``fn`` must be importable by the children (a module
    function) and return picklable values. Raises the first rank's
    error; ``timeout_s`` bounds the whole world, the join and every
    collective, and the processes are ended whatever happens."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_world_main, daemon=True,
                         args=(fn, r, n, port, backend, device,
                               int(timeout_s), args, queue, threads))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("world of %d: %d rank(s) answered in "
                                   "%.0f s" % (n, len(results), timeout_s))
            try:
                rank, ok, value = queue.get(timeout=min(left, 1.0))
            except Exception:  # noqa: BLE001 — queue.Empty: poll again
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and queue.empty():
                    raise RuntimeError(
                        "a rank died (exit code %s) before answering"
                        % dead[0].exitcode) from None
                continue
            if not ok:
                raise RuntimeError("rank %d of %d failed:\n%s"
                                   % (rank, n, value))
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        queue.close()
    return [results[r] for r in range(n)]
