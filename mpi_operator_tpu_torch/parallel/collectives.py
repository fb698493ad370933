"""Named collectives over a ``torch.distributed`` process group (≙ the
MPI/Horovod verbs), and Megatron's conjugate pair over the ``tensor`` axis.

Port of ``mpi_operator_tpu/parallel/collectives.py``. There a verb names a
mesh axis and runs under ``shard_map``; here it takes the process group of
one axis of a ``DeviceMesh`` (``mesh.get_group(axis)``, or
``runtime.topology.axis_group``) and runs eagerly on this rank's tensor. The verbs return new tensors and leave their input as it
is, as the JAX ones do.

| here              | reference stack                                        |
|-------------------|--------------------------------------------------------|
| ``psum``          | ``MPI_Allreduce(SUM)`` / Horovod allreduce (ring/NCCL) |
| ``pmean``         | Horovod's averaged allreduce (DistributedOptimizer)    |
| ``reduce_to_root``| ``MPI_Reduce`` to rank 0 (examples/pi/pi.cc:44)        |
| ``all_gather``    | ``MPI_Allgather``                                      |
| ``reduce_scatter``| ``MPI_Reduce_scatter``                                 |
| ``ring_shift``    | the ring topology Horovod builds internally            |
| ``all_to_all``    | ``MPI_Alltoall`` (MoE dispatch)                        |
| ``broadcast_root``| ``MPI_Bcast`` / ``hvd.broadcast_global_variables``     |

Point-to-point peers are global ranks (``dist.get_global_rank``): a rank's
index along an axis is not its rank in the world. :func:`ring_shift` is
differentiable, as JAX's ``ppermute`` is: its backward shifts the gradient
the other way round the ring (the pipeline's hand-off trains the stages
before it).

:func:`copy_to_tp` and :func:`reduce_from_tp` are the two halves of a
tensor-parallel block (Megatron-LM's ``f`` and ``g``): the identity whose
backward sums over the ``tensor`` ranks, put before column-parallel
products, and the sum over the ``tensor`` ranks whose backward is the
identity, put after row-parallel ones. With no group both are the identity.
:func:`scatter_to_group` and :func:`gather_from_group` are the same kind of
pair for a value every rank of a group holds whole (the MoE layer's expert
buffers, the pipeline's output rows): this rank's block of it, whose
backward gathers the blocks' gradients, and the gather of the blocks, whose
backward keeps this rank's block of the gradient.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    """This rank's coordinate along the group's axis (≙ MPI_Comm_rank)."""
    return dist.get_group_rank(group, dist.get_rank())


def axis_size(group) -> int:
    """Ranks along the group's axis (≙ MPI_Comm_size)."""
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum-allreduce (≙ MPI_Allreduce(SUM) / hvd.allreduce)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean-allreduce (≙ Horovod's DistributedOptimizer gradient average);
    a sum then a division, since gloo has no AVG."""
    return psum(x, group) / axis_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.MIN)


def reduce_to_root(x: torch.Tensor, group) -> torch.Tensor:
    """Sum-reduce with the result kept only on index 0, zeros elsewhere (the
    π example's ``MPI_Reduce(&in, &out, 1, MPI_SUM, 0)``), as the JAX
    package defines it."""
    total = psum(x, group)
    return total if axis_index(group) == 0 else torch.zeros_like(total)


def broadcast_root(x: torch.Tensor, group) -> torch.Tensor:
    """Index 0's value on every rank (≙ MPI_Bcast)."""
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


def all_gather(x: torch.Tensor, group, *, gather_axis: int = 0, tiled: bool = False):
    """Every rank's ``x`` along ``gather_axis``: stacked on a new axis there,
    or concatenated with ``tiled`` (≙ MPI_Allgather)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, gather_axis) if tiled else torch.stack(parts, gather_axis)


def reduce_scatter(x: torch.Tensor, group, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the ranks, then rank i keeps the i-th of N equal pieces along
    ``scatter_axis`` (≙ MPI_Reduce_scatter; JAX's tiled ``psum_scatter``)."""
    n = axis_size(group)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not split over {n} ranks")
    pieces = [p.contiguous() for p in x.chunk(n, scatter_axis)]
    out = torch.empty_like(pieces[0])
    dist.reduce_scatter(out, pieces, group=group)
    return out


def all_to_all(x: torch.Tensor, group, *, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``x`` into N pieces along ``split_axis``, send piece j to rank
    j, and concatenate the pieces received along ``concat_axis``
    (≙ MPI_Alltoall; JAX's tiled ``all_to_all``)."""
    n = axis_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not split over {n} ranks")
    pieces = [p.contiguous() for p in x.chunk(n, split_axis)]
    received = [torch.empty_like(p) for p in pieces]
    dist.all_to_all(received, pieces, group=group)
    return torch.cat(received, concat_axis)


def ring_shift_start(tensors: List[torch.Tensor], group, *, shift: int = 1):
    """Post the sends of :func:`ring_shift` for several tensors in one
    ``batch_isend_irecv``: each goes to index ``(i + shift) mod N``, and as
    many arrive from ``(i - shift) mod N``. Returns (the receive buffers,
    the requests); the buffers hold the data once every request has been
    waited on (:func:`ring_shift_wait`), so compute can run meanwhile."""
    n = axis_size(group)
    if n == 1:
        return list(tensors), []
    i = axis_index(group)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    ops, received = [], []
    for t in tensors:
        buf = torch.empty_like(t)
        # every rank posts in the same order: a send, then its receive
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        received.append(buf)
    return received, dist.batch_isend_irecv(ops)


def ring_shift_wait(requests) -> None:
    for r in requests:
        r.wait()


def _ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    (out,), reqs = ring_shift_start([x], group, shift=shift)
    ring_shift_wait(reqs)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group, *, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: index i's ``x`` moves to index
    ``(i + shift) mod N`` (one send and one receive per rank; the building
    block of ring attention and pipeline hand-off). Differentiable: the
    gradient moves ``-shift``. Every rank of the group must take part in
    the backward of each shift, as in its forward."""
    if x.requires_grad and torch.is_grad_enabled():
        return _RingShift.apply(x, group, shift)
    return _ring_shift(x, group, shift)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(axis_size(group), dim)[axis_index(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, gather_axis=ctx.dim, tiled=True), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, gather_axis=dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(axis_size(ctx.group), ctx.dim)[axis_index(ctx.group)].contiguous(),
                None, None)


def scatter_to_group(x: torch.Tensor, group: Optional[object], dim: int = 0) -> torch.Tensor:
    """This rank's block (its index's of N equal chunks along ``dim``) of a
    value every rank of ``group`` holds whole; the backward gathers the
    blocks' gradients, so each rank gets the whole gradient."""
    if group is None:
        return x
    if x.shape[dim] % axis_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{axis_size(group)} ranks")
    return _ScatterToGroup.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group: Optional[object], dim: int = 0) -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` (a whole value on each
    rank); the backward keeps this rank's block of the gradient, as every
    rank differentiates the same whole value."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim)


def copy_to_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the ``tensor``
    ranks. Put on the input of a column-parallel product."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Sum over the ``tensor`` ranks forward; identity backward. Put on the
    partial output of a row-parallel product."""
    return x if group is None else _ReduceFromTP.apply(x, group)
