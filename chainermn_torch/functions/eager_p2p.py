"""Eager differentiable point-to-point communication.

Counterpart of ``chainermn_tpu/functions/eager_p2p.py`` (reference:
chainermn/functions/point_to_point_communication.py): each rank runs its
own program, and a send or receive happens where it is called, under
autograd. ``eager_send`` returns a scalar delegate token (value 0.0) that
carries the autograd edge; its backward receives the gradient of ``x``
from the destination. ``eager_recv`` returns the received value; its
backward sends the gradient back to the source. Backward messages ride a
channel of their own (:func:`_grad_tag`), never a forward one.

The JAX package's contracts carry over:

* every rank issues its sends and receives in one global order (MPI's
  rule; backward replays the reverse order);
* ``eager_recv`` declares what it receives: ``shape`` and ``dtype``, or
  ``like=`` an example (a mismatch with the message raises);
* ``anchor=``: a tensor on the receiver's differentiation path (a
  parameter, an earlier token). The receive hangs off it, so backward
  visits it and sends the gradient back; without an anchor the receive
  is forward-only and the sender's backward would wait forever. In the
  port the anchor is any tensor that requires a gradient; its own
  gradient from the receive is zero.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from chainermn_torch.comm import p2p
from chainermn_torch.functions.point_to_point import grad_tag as _grad_tag

__all__ = ["eager_send", "eager_recv"]


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dest, tag, spec, *leaves):
        ctx.comm, ctx.dest, ctx.tag = comm, dest, tag
        ctx.devices = [t.device for t in leaves]
        comm.send(p2p.unflatten(spec, list(leaves)), dest, tag=tag)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return torch.zeros((), device=dev)

    @staticmethod
    def backward(ctx, _):
        got, _spec = p2p.flatten(ctx.comm.recv(ctx.dest,
                                               tag=_grad_tag(ctx.tag)))
        return (None, None, None, None,
                *[g.to(dev) for g, dev in zip(got, ctx.devices)])


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, src, tag, box, anchor):
        ctx.comm, ctx.src, ctx.tag = comm, src, tag
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        leaves, spec = p2p.flatten(comm.recv(src, tag=tag))
        box.append(spec)
        return tuple(leaves)

    @staticmethod
    def backward(ctx, *grads):
        ctx.comm.send(list(grads), ctx.src, tag=_grad_tag(ctx.tag))
        shape, dtype, device = ctx.anchor
        return None, None, None, None, torch.zeros(shape, dtype=dtype,
                                                   device=device)


def recv_tree(communicator, rank: int, anchor, tag: int = 0):
    """Receive the next message from ``rank`` under autograd, hung off
    ``anchor``; the structure, shapes and dtypes come from the
    message."""
    box: List[Any] = []
    leaves = _Recv.apply(communicator, int(rank), tag, box, anchor)
    return p2p.unflatten(box[0], list(leaves))


def eager_send(x, communicator, rank: int, tag: int = 0) -> torch.Tensor:
    """Differentiable eager send of ``x`` (a tensor or a nested structure
    of them) to ``rank``.

    Returns a scalar delegate token (0.0) carrying the autograd edge: tie
    it into the local loss (add it, or :func:`pseudo_connect`) so backward
    visits the send, which then receives the gradient of ``x`` from
    ``rank``'s matching :func:`eager_recv`."""
    leaves, spec = p2p.flatten(x)
    return _Send.apply(communicator, int(rank), tag, spec, *leaves)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def eager_recv(communicator, rank: int, shape=None, dtype=None, like=None,
               anchor=None, tag: int = 0):
    """Differentiable eager receive from ``rank``.

    Declare the incoming value: ``shape`` + ``dtype`` for one tensor, or
    ``like=`` an example tensor (or array) or a structure of them; the
    result has ``like``'s structure. ``anchor``: a
    tensor on this rank's differentiation path (see the module
    docstring); without one the receive is forward-only."""
    if like is None:
        if shape is None or dtype is None:
            raise ValueError(
                "eager_recv needs the incoming aval: pass shape= and "
                "dtype=, or like= an example structure (the JAX package's "
                "contract; the message's own header is checked against "
                "it)")
        like = torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                           device="meta")
    examples, spec = p2p.flatten(like)
    want = [(tuple(t.shape), t.dtype) for t in examples]
    if anchor is None:
        anchor = torch.zeros(())
    got = recv_tree(communicator, rank, anchor, tag)
    leaves, _ = p2p.flatten(got)
    have = [(tuple(t.shape), t.dtype) for t in leaves]
    if have != want:
        raise ValueError(f"eager_recv from rank {rank} declared {want}, "
                         f"the message holds {have}")
    return p2p.unflatten(spec, leaves)
