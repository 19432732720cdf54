"""Differentiable point-to-point communication.

Counterpart of ``chainermn_tpu/functions/point_to_point.py`` (reference:
chainermn/functions/point_to_point_communication.py). The JAX package
compiles a transfer into one ``lax.ppermute`` that every shard of a
``shard_map`` program executes; the port is multi-controller, one process
per rank, so the same program text runs on every rank and each rank does
its own part of the transfer: a source sends, a destination receives, a
bystander does nothing. The contract is the JAX package's:

* :func:`transfer` moves values along ``edges``; a destination gets its
  source's value, every other rank zeros of its own input's shape;
* ``send(x, comm, dest, self_rank=src)`` is the transfer of one edge (it
  sends only on rank ``src`` and receives only on rank ``dest``) and
  returns a :class:`DelegateVariable`;
* ``recv(comm, src, delegate_variable=phi)`` returns the received value
  on ``dest`` and zeros on the other ranks;
* :func:`pseudo_connect` ties a delegate into real values.

Each transfer is a ``torch.autograd.Function`` whose backward runs the
reverse transfer on the gradient channel of its tag (:func:`grad_tag`):
a destination sends its output's gradient back, a source receives it as
its input's. A destination has no input that requires a gradient, and
torch prunes a node without one, which would leave the source's backward
waiting forever; so every transfer takes an anchor, a zero scalar that
requires a gradient, as ChainerMN's recv took its dummy variable. A rank
runs a source's backward only if its loss depends on the transfer's
output: tie a send whose output is unused in with :func:`pseudo_connect`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from chainermn_torch.comm import p2p

__all__ = ["DelegateVariable", "transfer", "send", "recv",
           "pseudo_connect", "grad_tag", "anchor"]


class DelegateVariable:
    """Carries a transfer's result from :func:`send` to :func:`recv`:
    the value on the destination, zeros elsewhere, with the transfer on
    its autograd graph."""

    def __init__(self, data, src: int, dest: int):
        self.data = data
        self.src = src
        self.dest = dest


def grad_tag(tag: int) -> int:
    """The channel of a tag's backward messages, apart from every
    forward channel."""
    if not 0 <= tag < p2p.MAX_TAG:
        raise ValueError(f"tag must be in [0, {p2p.MAX_TAG}), got {tag}")
    return p2p.MAX_TAG + tag


def anchor() -> torch.Tensor:
    """A zero scalar that requires a gradient when autograd records (the
    input that keeps a receive on the graph), else a plain zero."""
    return torch.zeros((), requires_grad=torch.is_grad_enabled())


class _Transfer(torch.autograd.Function):
    """Move ``leaves`` along ``edges``; backward moves the gradients
    along the reversed edges."""

    @staticmethod
    def forward(ctx, comm, edges, tag, anchor_, *leaves):
        me = comm.rank
        ctx.comm, ctx.edges, ctx.tag = comm, edges, tag
        ctx.devices = [t.device for t in leaves]
        got = comm.exchange(
            sends=[(d, tag, list(leaves)) for s, d in edges
                   if s == me and d != me],
            recvs=[(s, tag) for s, d in edges if d == me and s != me])
        if got:
            return tuple(t.to(dev) for t, dev in zip(got[0], ctx.devices))
        if (me, me) in edges:
            return tuple(t.clone() for t in leaves)
        return tuple(torch.zeros_like(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        comm, me, tag = ctx.comm, ctx.comm.rank, grad_tag(ctx.tag)
        got = comm.exchange(
            sends=[(s, tag, list(grads)) for s, d in ctx.edges
                   if d == me and s != me],
            recvs=[(d, tag) for s, d in ctx.edges if s == me and d != me])
        if got:
            gx = [t.to(dev) for t, dev in zip(got[0], ctx.devices)]
        elif (me, me) in ctx.edges:
            gx = list(grads)
        else:
            gx = [torch.zeros_like(g) for g in grads]
        return (None, None, None, None, *gx)


def transfer(x, communicator, edges: Sequence[Tuple[int, int]],
             tag: int = 0):
    """Move each rank's ``x`` (a tensor or a nested structure of them)
    along ``edges`` = ``[(src, dest), ...]``: a destination receives its
    source's value, every other rank gets zeros shaped like its own
    ``x``. Every rank calls it with the same edges; a rank is the
    destination of at most one edge. Differentiable: the gradients go
    back along the reversed edges on :func:`grad_tag`'s channel."""
    edges = [(int(s), int(d)) for s, d in edges]
    dests = [d for _, d in edges]
    if len(set(dests)) != len(dests):
        raise ValueError(f"a rank may receive along one edge only: "
                         f"{edges}")
    leaves, spec = p2p.flatten(x)
    moved = _Transfer.apply(communicator, edges, tag, anchor(), *leaves)
    return p2p.unflatten(spec, list(moved))


def send(x, communicator, rank: int, *, self_rank: Optional[int] = None,
         tag: int = 0) -> DelegateVariable:
    """Send ``x`` from rank ``self_rank`` to rank ``rank``: every rank
    runs this line, only ``self_rank`` sends and only ``rank`` receives.
    Returns the :class:`DelegateVariable` to hand to :func:`recv`."""
    if self_rank is None:
        raise ValueError(
            "send() in a program that every rank runs needs the sending "
            "rank spelled out: send(x, comm, dest, self_rank=src)")
    moved = transfer(x, communicator, [(self_rank, rank)], tag=tag)
    return DelegateVariable(moved, src=self_rank, dest=rank)


def recv(communicator, rank: int,
         delegate_variable: Optional[DelegateVariable] = None,
         tag: int = 0):
    """The value sent from rank ``rank``: on the destination the sent
    value, zeros on the other ranks. Pass the matching
    :class:`DelegateVariable` from :func:`send`; gradients flow back
    through the reverse transfer."""
    if delegate_variable is None:
        raise ValueError(
            "recv() consumes the DelegateVariable returned by the "
            "matching send(); a free-standing receive is eager_recv()")
    if delegate_variable.src != rank:
        raise ValueError(
            f"recv(rank={rank}) does not match delegate sent from "
            f"rank {delegate_variable.src}")
    return delegate_variable.data


def pseudo_connect(delegate_variable, *actual_variables):
    """Tie a delegate (a :class:`DelegateVariable` or a delegate tensor
    such as :func:`eager_send`'s token) into real tensors: each comes back
    plus a zero that depends on the delegate, so backward reaches the
    transfer behind it (reference: chainermn/functions/pseudo_connect.py).
    Without tensors, the delegate comes back."""
    data = (delegate_variable.data
            if isinstance(delegate_variable, DelegateVariable)
            else delegate_variable)
    if not actual_variables:
        return delegate_variable
    leaves, _ = p2p.flatten(data)

    def tie(v):
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        for leaf in leaves:
            zero = zero + (leaf.sum() * 0).to(v.dtype).to(v.device)
        return v + zero

    out = tuple(tie(v) for v in actual_variables)
    return out[0] if len(out) == 1 else out
