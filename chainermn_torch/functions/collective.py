"""Differentiable collective communication functions.

Counterpart of ``chainermn_tpu/functions/collective.py`` (reference:
chainermn/functions/collective_communication.py): communicator-first
functions, each a ``torch.autograd.Function`` with the reference's
backward. Every rank calls each function and runs backward on its own
loss; the gradients are those of the sum of the ranks' losses, as the JAX
package's are under ``shard_map``:

* ``allgather`` ↔ reduce-scatter of the output gradient;
* ``alltoall`` ↔ the reverse alltoall;
* ``bcast`` → the ranks' output gradients summed at the root;
* ``gather`` ↔ ``scatter``: the root gets the rank-ordered stack, the
  other ranks a zero delegate scalar (tie it into the loss, as the
  reference's delegate variable); backward scatters the root's gradient;
* ``scatter``: ``x`` is read on the root only (the others may pass
  None); backward gathers the gradients to the root;
* ``allreduce`` (``sum`` or ``mean``) ↔ the all-reduce of the gradient.
"""

from __future__ import annotations

import torch

from chainermn_torch.functions.point_to_point import anchor

__all__ = ["allgather", "alltoall", "bcast", "gather", "scatter",
           "allreduce"]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.allgather(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.allreduce(g)[ctx.comm.rank]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.alltoall(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.alltoall(g)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x, root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g)
        return None, None, (total if ctx.comm.rank == ctx.root
                            else torch.zeros_like(g))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root = comm, root
        out = comm.gather(x, root)
        return out if out is not None else x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return None, None, comm.scatter(g if comm.rank == ctx.root
                                        else None, ctx.root)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, anchor_, x):
        ctx.comm, ctx.root = comm, root
        return comm.scatter(x, root)

    @staticmethod
    def backward(ctx, g):
        stack = ctx.comm.gather(g, ctx.root)
        return None, None, None, stack


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, op, x):
        ctx.comm, ctx.op = comm, op
        return comm.allreduce(x, op)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.comm.allreduce(g, ctx.op)


def allgather(communicator, x):
    """Every rank's ``x`` on every rank, stacked on axis 0. Backward:
    reduce-scatter of the output gradient."""
    return _AllGather.apply(communicator, x)


def alltoall(communicator, x):
    """Chunk exchange: this rank's chunk ``s`` goes to rank ``s``'s slot
    ``rank``; ``x``'s leading axis must be divisible by the communicator
    size. Backward: the reverse alltoall."""
    return _AllToAll.apply(communicator, x)


def bcast(communicator, x, root: int = 0):
    """``root``'s ``x`` on every rank (every rank passes a tensor of the
    same shape). Backward: the output gradients summed at the root."""
    return _Bcast.apply(communicator, root, x)


def gather(communicator, x, root: int = 0):
    """The rank-ordered stack of every rank's ``x`` on ``root``; a zero
    delegate scalar on the other ranks. Backward: scatter."""
    return _Gather.apply(communicator, root, x)


def scatter(communicator, x, root: int = 0):
    """This rank's slice ``x[rank]`` of ``root``'s stacked ``x`` (the
    other ranks' ``x`` is not read; None will do). Backward: gather of
    the gradients to the root."""
    return _Scatter.apply(communicator, root, anchor(), x)


def allreduce(communicator, x, op: str = "sum"):
    """All-reduce (``sum`` or ``mean`` under autograd; the reference
    exposes it at the communicator level only, the JAX package adds it
    here for orthogonality). Backward: the same all-reduce of the
    gradient."""
    if op not in ("sum", "mean") and torch.is_grad_enabled() \
            and x.requires_grad:
        raise ValueError(f"allreduce op {op!r} has no gradient here; "
                         f"use 'sum' or 'mean'")
    return _AllReduce.apply(communicator, op, x)
