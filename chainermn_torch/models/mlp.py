"""MLP: the bring-up model (config #1, the reference's
examples/mnist/train_mnist.py three-layer MLP).

Counterpart of ``chainermn_tpu/models/mlp.py``: 784 → n_units → n_units →
n_out with ReLU, the input flattened as the flax module flattens it. The
layers start as flax's Dense layers do (LeCun-normal kernels truncated at
two standard deviations, zero biases), drawn on the CPU from torch's
global generator and then moved to ``device``, so one ``torch.manual_seed``
gives the same parameters on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.device import resolve_device

__all__ = ["MLP", "lecun_normal_", "flax_dense"]

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal")
# divides by the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal of variance 1/fan_in
    truncated at two standard deviations, drawn from ``generator`` (torch's
    global generator by default)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def flax_dense(n_in: int, n_out: int) -> nn.Linear:
    """A ``Linear`` that starts as flax's ``Dense`` does (LeCun-normal
    kernel, zero bias)."""
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, n_in)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """784 → ``n_units`` → ``n_units`` → ``n_out``; layers ``l1``..``l3``
    (the reference example's names; ``mlp_params_from_flax`` maps the
    flax ``Dense_0``..``Dense_2`` onto them)."""

    def __init__(self, n_units: int = 1000, n_out: int = 10, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.l1 = flax_dense(28 * 28, n_units)
        self.l2 = flax_dense(n_units, n_units)
        self.l3 = flax_dense(n_units, n_out)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.l1.weight.device

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.l1(x))
        x = F.relu(self.l2(x))
        return self.l3(x)
