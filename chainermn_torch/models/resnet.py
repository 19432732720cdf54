"""ResNet family of the port: configs #2 (ImageNet ResNet-50) and #3 (the
CIFAR ResNet with MultiNodeBatchNormalization).

Counterpart of ``chainermn_tpu/models/resnet.py``:

* ``forward(x, train=True)`` takes the dataset's NHWC batch, casts it to
  ``dtype`` and permutes it once to NCHW; the permuted view already has
  ``torch.channels_last`` strides, which the convolution weights share,
  so cuDNN runs NHWC kernels;
* with ``dtype=torch.bfloat16`` every convolution casts its f32 weight
  and its input to bf16; batch-norm statistics and parameters stay f32
  (:class:`~chainermn_torch.links.MultiNodeBatchNormalization` with
  ``decay=0.9``, ``eps=1e-5``, as the JAX ``ResNet`` pins them for both
  of its norm layers); the head is an f32 ``Dense`` over the spatial mean
  and the logits are f32;
* ``comm`` makes every batch norm cross-replica (config #3);
* convolutions pad as flax's ``padding="SAME"`` does: the total
  ``max((out − 1)·stride + k − n, 0)`` with the smaller half first, so a
  stride-2 3x3 convolution on an even input pads (0, 1), not torch's
  (1, 1); the max pool pads (0, 1) with −inf the same way; the
  space-to-depth stem pads [(1, 2), (1, 2)] and the 7x7 stem (3, 3);
* parameters start as flax's do (truncated LeCun-normal convolution and
  dense kernels, zero biases, batch-norm scale 1 and 0 on each block's
  last one), drawn on the CPU from torch's global generator and then
  moved to ``device``, so one ``torch.manual_seed`` gives the same model
  on every device.

The submodules carry flax's names (``conv_init``, ``bn_init``,
``ResNetBlock_<i>``/``BottleneckResNetBlock_<i>`` with ``Conv_<j>``,
``BatchNorm_<j>``, ``conv_proj``, ``norm_proj``, and ``Dense_0``), which
``models.convert.resnet_params_from_flax`` maps a flax tree onto.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.device import resolve_device
from chainermn_torch.links import MultiNodeBatchNormalization
from chainermn_torch.models.mlp import flax_dense, lecun_normal_

__all__ = ["same_padding", "Conv", "ResNetBlock", "BottleneckResNetBlock",
           "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "CifarResNet"]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` on NCHW: a square ``kernel``,
    ``stride``, and ``padding`` "SAME" or explicit ((top, bottom), (left,
    right)); input and weight are cast to ``dtype``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding="SAME", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        lecun_normal_(self.weight, c_in * kernel * kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            pads = tuple(same_padding(n, k, self.stride)
                         for n in x.shape[2:])
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


def _norm(comm, dtype, size, scale_init=1.0):
    # both branches of the JAX ResNet pin decay 0.9 and eps 1e-5
    return MultiNodeBatchNormalization(comm, size, decay=0.9, eps=1e-5,
                                       dtype=dtype, scale_init=scale_init,
                                       device="cpu")


class ResNetBlock(nn.Module):
    """Basic two-convolution block (ResNet-18/34 and the CIFAR ResNets)."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, comm, dtype):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 3, stride, dtype=dtype)
        self.BatchNorm_0 = _norm(comm, dtype, filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = _norm(comm, dtype, filters, scale_init=0.0)
        self.has_proj = c_in != filters or stride != 1
        if self.has_proj:
            self.conv_proj = Conv(c_in, filters, 1, stride, dtype=dtype)
            self.norm_proj = _norm(comm, dtype, filters)

    def forward(self, x, train: bool):
        ra = not train
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), ra))
        y = self.BatchNorm_1(self.Conv_1(y), ra)
        residual = x
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(x), ra)
        return F.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """1-3-1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, comm, dtype):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(c_in, filters, 1, dtype=dtype)
        self.BatchNorm_0 = _norm(comm, dtype, filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.BatchNorm_1 = _norm(comm, dtype, filters)
        self.Conv_2 = Conv(filters, out, 1, dtype=dtype)
        self.BatchNorm_2 = _norm(comm, dtype, out, scale_init=0.0)
        self.has_proj = c_in != out or stride != 1
        if self.has_proj:
            self.conv_proj = Conv(c_in, out, 1, stride, dtype=dtype)
            self.norm_proj = _norm(comm, dtype, out)

    def forward(self, x, train: bool):
        ra = not train
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), ra))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), ra))
        y = self.BatchNorm_2(self.Conv_2(y), ra)
        residual = x
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(x), ra)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Configurable ResNet (see the module docstring).

    Args:
      stage_sizes: blocks per stage; stage i > 0 starts with stride 2.
      block_cls: :class:`ResNetBlock` or :class:`BottleneckResNetBlock`.
      num_classes: width of the f32 head.
      num_filters: channels of the stem and of stage 0.
      comm: communicator for cross-replica batch norm, or None.
      dtype: compute type of the convolutions and activations.
      small_inputs: the CIFAR stem (3x3 convolution, no max pool).
      space_to_depth: the ImageNet stem that reshapes [H, W, 3] to [H/2,
        W/2, 12] and runs a 4x4 stride-1 convolution (covers the 7x7
        stride-2 receptive field); needs even H and W.
      device: ``cuda`` unless ``"cpu"`` is asked for.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, num_filters: int = 64, comm=None,
                 dtype: torch.dtype = torch.float32,
                 small_inputs: bool = False, space_to_depth: bool = False,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.comm = comm
        self.dtype = dtype
        self.small_inputs = small_inputs
        self.space_to_depth = space_to_depth
        if small_inputs:
            self.conv_init = Conv(3, num_filters, 3, dtype=dtype)
        elif space_to_depth:
            self.conv_init = Conv(12, num_filters, 4,
                                  padding=((1, 2), (1, 2)), dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2,
                                  padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = _norm(comm, dtype, num_filters)
        self.block_names: List[str] = []
        c = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                setattr(self, name, block_cls(c, filters, stride, comm,
                                              dtype))
                self.block_names.append(name)
                c = filters * block_cls.expansion
        self.Dense_0 = flax_dense(c, num_classes)
        self.to(dev, memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.weight.device

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """NHWC images → f32 logits ``[N, num_classes]``; ``train`` uses
        (and updates) batch statistics, else the running ones."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if self.space_to_depth and not self.small_inputs:
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem needs even H and W, got {(h, w)}; "
                    "pad/resize the input or set space_to_depth=False")
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)          # NCHW, channels_last strides
        x = F.relu(self.bn_init(self.conv_init(x), not train))
        if not self.small_inputs:
            (top, bottom), (left, right) = (same_padding(n, 3, 2)
                                            for n in x.shape[2:])
            x = F.max_pool2d(F.pad(x, (left, right, top, bottom),
                                   value=float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        # jnp.mean of bf16 sums in f32 and rounds the mean to bf16
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x.float())


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)


def CifarResNet(num_classes: int = 100, depth: int = 20, comm=None,
                dtype: torch.dtype = torch.float32,
                device=None) -> ResNet:
    """CIFAR-style ResNet (6n+2 layers, 3 stages of 16/32/64 channels)
    with optional cross-replica batch norm: config #3's model."""
    if (depth - 2) % 6:
        raise ValueError(f"depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    return ResNet(stage_sizes=[n, n, n], block_cls=ResNetBlock,
                  num_classes=num_classes, num_filters=16, comm=comm,
                  dtype=dtype, small_inputs=True, device=device)
