"""Cross-replica batch normalization of the port.

Counterpart of ``chainermn_tpu/links/batch_normalization.py``
``MultiNodeBatchNormalization`` (reference: chainermn/links/
multi_node_batch_normalization.py), with the semantics of the flax
``BatchNorm`` the JAX link is built on:

* train mode computes the batch mean and the mean of squares in f32 (also
  for bf16 inputs); with a communicator the two are packed into one
  buffer and all-reduced to their mean over the ranks, as the reference
  packs them. The variance is max(0, E[x²] − E[x]²);
* the output is ``(x − mean)·rsqrt(var + eps)·scale + bias`` computed in
  f32 and cast to ``dtype`` (default: x's type promoted with f32, flax's
  rule);
* the backward runs through the statistics; with a communicator it
  all-reduces the two per-channel gradient sums (Σdy and Σdy·x̂) in one
  buffer, so each rank's input gradient is that of the loss summed over
  every rank's batch (what the JAX link's ``pmean`` transposes to);
* the running statistics update as ``running = decay·running + (1 −
  decay)·batch`` with the BIASED batch variance; eval mode normalises
  with them.

``torch.nn.BatchNorm2d``, ``F.batch_norm(training=True)`` and
``SyncBatchNorm`` keep the unbiased variance in their running statistics
and weight them by the other side of the momentum, so none of them is
this module. With ``comm=None`` it is the plain per-replica batch norm
that ``ResNet`` uses (flax ``nn.BatchNorm``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch
from torch import nn

from chainermn_torch.device import resolve_device

__all__ = ["MultiNodeBatchNormalization", "batch_norm_layers",
           "frozen_batch_stats"]


def _stat_shape(x: torch.Tensor) -> List[int]:
    return [1, x.shape[1]] + [1] * (x.dim() - 2)


class _TrainBatchNorm(torch.autograd.Function):
    """Train-mode normalisation over axis 1 (``[N, C, *spatial]``);
    returns ``(y, batch mean, batch variance)``, the last two without
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, comm, out_dtype):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = _stat_shape(x)
        xf = x.float()
        mean = xf.mean(dims)
        meansq = xf.square().mean(dims)
        if comm is not None:
            stats = comm.allreduce(torch.stack([mean, meansq]), "mean")
            mean, meansq = stats[0], stats[1]
        var = (meansq - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        # flax's order, (x - mean)·(rsqrt(var + eps)·scale) + bias: the
        # centred value keeps its digits where |mean| >> std
        y = torch.addcmul(bias.view(shape), xf - mean.view(shape),
                          (weight * invstd).view(shape))
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.comm = comm
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, invstd, weight = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = _stat_shape(x)
        dyf = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        count = x.numel() // x.shape[1]
        g_sum, g_sum_xhat = sum_dy, sum_dy_xhat
        if ctx.comm is not None:
            packed = ctx.comm.allreduce(torch.stack([sum_dy, sum_dy_xhat]),
                                        "sum")
            g_sum, g_sum_xhat = packed[0], packed[1]
            count *= ctx.comm.size
        dx = (dyf - (g_sum / count).view(shape)
              - xhat * (g_sum_xhat / count).view(shape))
        dx = dx * (weight * invstd).view(shape)
        # the scale and bias gradients are this rank's; the multi-node
        # optimizer averages them over the ranks
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None


class MultiNodeBatchNormalization(nn.Module):
    """Batch norm over axis 1 whose train-mode statistics span every rank
    of ``comm`` (none: this rank's batch alone).

    Args:
      comm: communicator whose ranks share the statistics, or None.
      size: the number of channels (flax infers it; torch needs it).
      decay: weight of the old running statistics (flax's ``momentum``).
      eps: added to the variance (the reference's 2e-5; ``ResNet`` pins
        1e-5).
      dtype: output type; None → the input's type promoted with f32.
      scale_init: the constant the scale starts at (flax's ``ones_init``
        → 1.0, ``zeros_init`` → 0.0).
      device: ``cuda`` unless ``"cpu"`` is asked for.

    Parameters ``weight`` (flax ``scale``) and ``bias`` and the buffers
    ``running_mean`` / ``running_var`` (flax ``batch_stats`` ``mean`` /
    ``var``) are f32. Every rank must pass a batch of the same size: the
    statistics are the mean of the ranks' means, as ``pmean`` takes it.
    """

    def __init__(self, comm=None, size: Optional[int] = None,
                 decay: float = 0.9, eps: float = 2e-5,
                 dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0, device=None):
        super().__init__()
        if size is None:
            raise ValueError("size (the channel count) is required: torch "
                             "allocates the parameters at construction")
        dev = resolve_device(device)
        self.comm = comm
        self.size = int(size)
        self.decay = decay
        self.eps = eps
        self.dtype = dtype
        #: False while a checkpointed forward is recomputed, so the
        #: running statistics update once per step (frozen_batch_stats)
        self.update_stats = True
        self.weight = nn.Parameter(torch.full((self.size,),
                                              float(scale_init),
                                              device=dev))
        self.bias = nn.Parameter(torch.zeros(self.size, device=dev))
        self.register_buffer("running_mean",
                             torch.zeros(self.size, device=dev))
        self.register_buffer("running_var", torch.ones(self.size,
                                                       device=dev))

    def extra_repr(self) -> str:
        return (f"{self.size}, decay={self.decay}, eps={self.eps}, "
                f"cross_replica={self.comm is not None}")

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """``x`` ``[N, C, *spatial]``; ``use_running_average`` None →
        ``not self.training``."""
        if x.shape[1] != self.size:
            raise ValueError(f"expected {self.size} channels on axis 1, got "
                             f"shape {tuple(x.shape)}")
        use_ra = use_running_average
        if use_ra is None:
            use_ra = not self.training
        out_dtype = self.dtype or torch.promote_types(x.dtype,
                                                      torch.float32)
        if use_ra:
            shape = _stat_shape(x)
            a = self.weight * torch.rsqrt(self.running_var + self.eps)
            return torch.addcmul(self.bias.view(shape),
                                 x - self.running_mean.view(shape),
                                 a.view(shape)).to(out_dtype)
        y, mean, var = _TrainBatchNorm.apply(x, self.weight, self.bias,
                                             self.eps, self.comm, out_dtype)
        if self.update_stats:
            with torch.no_grad():
                d = self.decay
                self.running_mean.copy_(d * self.running_mean
                                        + (1 - d) * mean)
                self.running_var.copy_(d * self.running_var + (1 - d) * var)
        return y


def batch_norm_layers(module: nn.Module
                      ) -> List[MultiNodeBatchNormalization]:
    """Every :class:`MultiNodeBatchNormalization` in ``module``, in
    registration order."""
    return [m for m in module.modules()
            if isinstance(m, MultiNodeBatchNormalization)]


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Inside, train-mode forwards of ``module``'s batch norms leave their
    running statistics alone (a recomputed forward under
    ``torch.utils.checkpoint`` must not update them a second time)."""
    layers = batch_norm_layers(module)
    before = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m, b in zip(layers, before):
            m.update_stats = b
