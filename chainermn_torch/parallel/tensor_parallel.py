"""Megatron-style intra-layer tensor parallelism.

Counterpart of ``chainermn_tpu/parallel/tensor_parallel.py``. Where JAX
names a mesh axis (``axis_name``), the port passes the communicator over
that axis (``DistributedCommunicator.over_mesh(mesh, axes=(name,))``);
every rank of it runs the same program on its own slice of the weights.

* **column-parallel** Dense: the weight split on its output features; the
  activations stay split, no collective in the forward;
* **row-parallel** Dense: the weight split on its input features; the
  forward ends in a sum over the ranks, then adds the replicated bias.

Megatron's two operators are ``torch.autograd.Function`` s of the port's
own:

* *f*, :func:`copy_to_tp_region`: the identity forward and a sum over the
  ranks backward (JAX's ``custom_vjp`` of ``psum``), at the entry of every
  column-parallel region, so the gradient leaving it is the whole sum;
* *g*, :func:`reduce_from_tp_region`: a sum over the ranks forward and the
  IDENTITY backward, which is ``psum``'s transpose under JAX's
  replication typing. Every rank backpropagates the same replicated loss,
  so an all-reducing backward (``functions.allreduce``, ChainerMN's
  semantics for a per-rank loss) would scale every gradient by the number
  of ranks.

``vocab_parallel_cross_entropy`` is the loss-parallel epilogue of a
column-parallel LM head: the softmax normaliser, the max shift and the
target logit come from one max and two sums of ``[...]`` arrays over the
ranks; the full logits never exist on one rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["copy_to_tp_region", "reduce_from_tp_region",
           "ColumnParallelDense", "RowParallelDense", "TensorParallelMLP",
           "vocab_parallel_cross_entropy", "pmax_stop_gradient"]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.allreduce(g)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        return comm.allreduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_tp_region(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's *f*: the identity forward, the sum of the ranks'
    gradients backward."""
    return _CopyToTP.apply(comm, x)


def reduce_from_tp_region(x: torch.Tensor, comm) -> torch.Tensor:
    """Megatron's *g*: the sum over the ranks forward (JAX's ``psum``),
    the identity backward."""
    return _ReduceFromTP.apply(comm, x)


def pmax_stop_gradient(x: torch.Tensor, comm) -> torch.Tensor:
    """The maximum over the ranks, with no gradient (JAX's zero-cotangent
    ``pmax``): the log-sum-exp shift and the accuracy need none."""
    return comm.allreduce(x.detach(), "max")


def _compute_dtype(dtype, x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """flax ``nn.Dense(dtype=None)`` promotes the input and the kernel."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               w.dtype)


def _linear(x, weight, bias, dtype):
    cdt = _compute_dtype(dtype, x, weight)
    return F.linear(x.to(cdt), weight.to(cdt),
                    None if bias is None else bias.to(cdt))


class ColumnParallelDense(nn.Module):
    """Dense with its ``features`` output features split over ``comm``:
    this rank holds ``features // comm.size`` of them (``dense``, an
    ``nn.Linear``: flax's ``Dense_0``). The input is replicated and rides
    :func:`copy_to_tp_region`; the output is split on the feature dim."""

    def __init__(self, in_features: int, features: int, comm,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        n = comm.size
        if features % n:
            raise ValueError(f"features {features} not divisible by axis "
                             f"{n}")
        self.comm, self.dtype = comm, dtype
        self.dense = nn.Linear(in_features, features // n, bias=use_bias,
                               device=device)

    def forward(self, x):
        x = copy_to_tp_region(x, self.comm)
        return _linear(x, self.dense.weight, self.dense.bias, self.dtype)


class RowParallelDense(nn.Module):
    """Dense with its input features split over ``comm`` (``in_features``
    is this rank's share: the column-parallel output); the forward sums
    the ranks' partial products (:func:`reduce_from_tp_region`) and then
    adds the replicated ``bias``."""

    def __init__(self, in_features: int, features: int, comm,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.comm, self.dtype = comm, dtype
        self.dense = nn.Linear(in_features, features, bias=False,
                               device=device)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = reduce_from_tp_region(
            _linear(x, self.dense.weight, None, self.dtype), self.comm)
        if self.bias is not None:
            y = y + self.bias       # f32 parameter: promotes, as in flax
        return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # flax nn.gelu's default


class TensorParallelMLP(nn.Module):
    """Column → activation → row: one sum over the ranks a block.
    ``hidden`` is the whole hidden width (this rank holds
    ``hidden // comm.size`` of it)."""

    def __init__(self, in_features: int, hidden: int, out: int, comm,
                 act: Callable = _gelu, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.act = act
        self.column = ColumnParallelDense(in_features, hidden, comm,
                                          dtype=dtype, device=device)
        self.row = RowParallelDense(hidden // comm.size, out, comm,
                                    dtype=dtype, device=device)

    def forward(self, x):
        return self.row(self.act(self.column(x)))


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets,
                                 comm) -> torch.Tensor:
    """Cross-entropy over vocabulary-split logits.

    ``logits``: ``[..., V_local]``, this rank's contiguous slice
    ``[rank·V_local, (rank+1)·V_local)`` (the layout
    :class:`ColumnParallelDense` produces); ``targets``: ``[...]`` global
    ids, the same on every rank. Returns the per-token loss ``[...]`` in
    f32, the same on every rank; its gradient in ``logits`` is this
    rank's slice of softmax − onehot."""
    vl = logits.shape[-1]
    lo = comm.rank * vl
    logits = logits.float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    m = pmax_stop_gradient(logits.amax(-1), comm)
    z = reduce_from_tp_region(torch.exp(logits - m[..., None]).sum(-1), comm)
    local_t = targets - lo
    in_shard = (local_t >= 0) & (local_t < vl)
    safe_t = local_t.clamp(0, vl - 1)
    tlogit = logits.gather(-1, safe_t[..., None])[..., 0]
    tlogit = reduce_from_tp_region(
        torch.where(in_shard, tlogit, torch.zeros_like(tlogit)), comm)
    return m + torch.log(z) - tlogit
