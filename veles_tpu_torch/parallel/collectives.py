"""The collectives of the mesh, differentiable.

The reference has no such module: XLA inserts its collectives from the
shardings (and ``shard_map`` bodies name ``psum``/``ppermute``). Here
each is a ``torch.autograd.Function`` over a mesh :class:`~veles_tpu_
torch.parallel.mesh.Axis`, with the reference's transposes:

- :func:`psum` (sum over the axis) <-> :func:`pvary` (the identity,
  whose cotangent is summed over the axis);
- :func:`all_gather` (concatenate the axis's shards) <->
  :func:`reduce_scatter_sum` (sum, then keep this rank's shard);
- :func:`ppermute` (send to a permuted rank) <-> the inverse
  permutation.

The typing is JAX's: a value every rank of the axis holds alike
(invariant, e.g. the output of :func:`psum`) has one cotangent, the
same on every rank; a value that differs by rank (varying) has a
cotangent by rank, and the objective is their sum. :func:`all_gather`
returns a varying value (its transpose sums the ranks' cotangents);
:func:`all_gather_invariant` returns an invariant one (its transpose
keeps this rank's slice of the one cotangent), and :func:`shard` slices
an invariant value (its transpose sums the ranks' slices).

An axis of one rank makes every collective the identity.

Transport is the group's backend, as the caller chose it. NCCL takes
CUDA tensors as they are. Gloo takes CPU tensors only (its partial CUDA
support is not relied on), so a CUDA tensor goes through a pinned host
buffer: the device-to-host copy is queued on the rank's current stream
and waited for through an event recorded after it, and the result goes
back ``non_blocking``. :data:`STAGED_BYTES` counts the bytes that
crossed, both ways. Gloo has no reduce-scatter: there it is an
all-reduce followed by the slice. bf16 crosses gloo as its bits
(in an f16 tensor) and is summed in f32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

#: bytes staged through host memory for gloo: device to host, host to
#: device
STAGED_BYTES: Dict[str, int] = {"to_host": 0, "to_device": 0}


def reset_staged() -> None:
    for key in STAGED_BYTES:
        STAGED_BYTES[key] = 0


def _staged(x: torch.Tensor, axis) -> bool:
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a pinned host buffer, complete when this returns: the
    copy runs on the current stream after the work that produced
    ``x``, and an event recorded after the copy is waited for."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    STAGED_BYTES["to_host"] += host.numel() * host.element_size()
    return host


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A host buffer back on ``device``, queued on the current stream
    (``non_blocking``; the caching host allocator keeps the pinned
    buffer alive until the copy has run)."""
    STAGED_BYTES["to_device"] += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The tensor as it crosses the transport: contiguous, bf16 as its
    bits in an f16 tensor (gloo moves f16 and has no bf16 or int16;
    the gathers and sends copy bytes, they compute nothing)."""
    x = x.contiguous()
    return x.view(torch.float16) if x.dtype == torch.bfloat16 else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bfloat16) if dtype == torch.bfloat16 else x


# ---------------------------------------------------------------------------
# the transport (no autograd)
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the axis (a new tensor; bf16 summed in
    f32, returned in bf16)."""
    if axis.size == 1:
        return x.clone()
    dtype, device = x.dtype, x.device
    y = x.float() if dtype == torch.bfloat16 else x.clone()
    staged = _staged(y, axis)
    buf = to_host(y) if staged else y.contiguous()
    dist.all_reduce(buf, group=axis.group)
    if staged:
        buf = to_device(buf, device)
    return buf.to(dtype)


def _gather_list(x: torch.Tensor, axis) -> List[torch.Tensor]:
    staged = _staged(x, axis)
    wire = _wire(to_host(x) if staged else x)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    parts = [_unwire(p, x.dtype) for p in parts]
    if staged:
        parts = [to_device(p, x.device) for p in parts]
    return parts


def all_gather_cat(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The axis's shards of ``x`` concatenated along ``dim`` in index
    order."""
    if axis.size == 1:
        return x
    return torch.cat(_gather_list(x, axis), dim=dim)


def reduce_scatter_sum(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the axis, this rank's equal shard along
    ``dim`` of it."""
    if axis.size == 1:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError("reduce_scatter: dim %d of %s does not split %d "
                         "ways" % (dim, tuple(x.shape), axis.size))
    if dist.get_backend(axis.group) == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // axis.size,) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=axis.group)
        return out.movedim(0, dim)
    total = all_reduce_sum(x, axis)
    return total.chunk(axis.size, dim=dim)[axis.index].contiguous()


def exchange(x: torch.Tensor, axis, dst: int, src: int) -> torch.Tensor:
    """Send ``x`` to the axis index ``dst`` and return the tensor of
    ``x``'s shape and dtype received from index ``src`` (posted
    together, so a ring of these cannot deadlock)."""
    if dst == axis.index and src == axis.index:
        return x
    staged = _staged(x, axis)
    wire = _wire(to_host(x) if staged else x)
    buf = torch.empty(wire.shape, dtype=wire.dtype, device=wire.device,
                      pin_memory=staged)
    peer_dst, peer_src = axis.ranks[dst], axis.ranks[src]
    if dist.get_backend(axis.group) == "nccl":
        # NCCL runs a lone send and a lone recv in order on its stream:
        # two ranks sending to each other first would wait forever
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, peer_dst, axis.group),
            dist.P2POp(dist.irecv, buf, peer_src, axis.group)])
    else:
        works = [dist.isend(wire, peer_dst, group=axis.group),
                 dist.irecv(buf, peer_src, group=axis.group)]
    for work in works:
        work.wait()
    out = _unwire(buf, x.dtype)
    return to_device(out, x.device) if staged else out


def send(x: torch.Tensor, axis, dst: int) -> None:
    """Send ``x`` to the axis index ``dst`` (blocking)."""
    staged = _staged(x, axis)
    wire = _wire(to_host(x) if staged else x)
    dist.send(wire, axis.ranks[dst], group=axis.group)


def recv(shape, dtype, device, axis, src: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from the axis index
    ``src`` onto ``device`` (blocking)."""
    staged = torch.device(device).type == "cuda" and \
        dist.get_backend(axis.group) == "gloo"
    wire_dtype = torch.float16 if dtype == torch.bfloat16 else dtype
    buf = torch.empty(shape, dtype=wire_dtype,
                      device="cpu" if staged else device,
                      pin_memory=staged)
    dist.recv(buf, axis.ranks[src], group=axis.group)
    out = _unwire(buf, dtype)
    return to_device(out, device) if staged else out


def sum_flat(tensors: Sequence[torch.Tensor], axis) -> List[torch.Tensor]:
    """The sums over the axis of ``tensors`` (f32), by ONE all-reduce
    of one flat buffer: the data-axis gradient reduction."""
    if axis.size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = all_reduce_sum(flat, axis)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.axis, ctx.dim), None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.index], None, \
            None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dst, src):
        ctx.axis, ctx.dst, ctx.src = axis, dst, src
        return exchange(x, axis, dst, src)

    @staticmethod
    def backward(ctx, g):
        # the inverse permutation: the cotangent goes back to where the
        # value came from
        return exchange(g, ctx.axis, ctx.src, ctx.dst), None, None, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the axis; the cotangent passes through unchanged."""
    return x if axis.size == 1 else _Psum.apply(x, axis)


def pvary(x: torch.Tensor, axis) -> torch.Tensor:
    """The identity on a value every rank of the axis holds; its
    cotangent is summed over the axis (the transpose of :func:`psum`,
    JAX's ``pvary``): where each rank's use of the value yields part of
    its gradient."""
    return x if axis.size == 1 else _Pvary.apply(x, axis)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The shards of the axis concatenated along ``dim``; the cotangent
    is reduce-scattered back."""
    return x if axis.size == 1 else _AllGather.apply(x, axis, dim)


def all_gather_invariant(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The shards of the axis concatenated along ``dim``, as a value
    every rank holds alike (JAX's ``all_gather_invariant``): its one
    cotangent is sliced back, not summed."""
    return x if axis.size == 1 else _AllGatherInvariant.apply(x, axis, dim)


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``x`` moved along ``perm``, a list of ``(source, destination)``
    axis indices that is a permutation: this rank sends its ``x`` to
    its destination and returns what its source sent. The cotangent
    takes the inverse permutation."""
    if axis.size == 1:
        return x
    dst = dict(perm)[axis.index]
    src = {d: s for s, d in perm}[axis.index]
    return _Ppermute.apply(x, axis, dst, src)


def shard(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's equal shard along ``dim`` of a value every rank of
    the axis holds (:func:`pvary` then the slice: the cotangent of the
    whole is the sum of the ranks' slices' cotangents)."""
    if axis.size == 1:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError("shard: dim %d of %s does not split %d ways"
                         % (dim, tuple(x.shape), axis.size))
    return pvary(x, axis).chunk(axis.size, dim=dim)[axis.index]
