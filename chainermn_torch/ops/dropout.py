"""Dropout with explicit keys: the port's counterpart of flax's
``nn.Dropout`` under ``rngs={"dropout": key}``.

A key is a Python int. :func:`fold_in` derives a new key from a key and
an int, as ``jax.random.fold_in`` does (the values differ: bitwise
agreement with ``jax.random`` is not a goal). The train step folds the
rank and the micro-step into the caller's key, a model folds in the
index of each block and of each dropout site, and :func:`dropout` seeds a
``torch.Generator`` on the tensor's device from the final key. A mask is
therefore a pure function of (key, rank, micro-step, site): the same key
gives the same masks, and a forward that ``torch.utils.checkpoint``
recomputes draws the very masks of the first pass (checkpoint replays
the global RNG states, not a hand-made generator's, so a generator that
kept its state between sites would not).

The masks of a CPU and a CUDA generator differ for one key.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fold_in", "dropout"]

_M64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _M64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from ``key`` and ``data`` (both ints)."""
    return _mix((_mix(int(key) & _M64) + 0x9E3779B97F4A7C15
                 * ((int(data) & _M64) + 1)) & _M64)


def dropout(x: torch.Tensor, rate: float, key: Optional[int],
            train: bool) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``: each element
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``
    in ``x``'s dtype, zero otherwise. The mask comes from a generator on
    ``x.device`` seeded with ``key``; ``train=False`` or ``rate == 0``
    returns ``x``, and a train-mode call with ``rate > 0`` needs a key
    (flax raises without a dropout rng too)."""
    if not train or rate == 0.0:
        return x
    if key is None:
        raise ValueError("dropout in train mode needs a key: build the "
                         "step with with_rng=True and pass rng")
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    g = torch.Generator(device=x.device)
    g.manual_seed(int(key) & _M64)
    keep = torch.rand(x.shape, generator=g, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
