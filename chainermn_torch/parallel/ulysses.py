"""Ulysses sequence parallelism: an all-to-all from "sequence split, all
heads" to "whole sequence, heads split", attention, and one back.

Counterpart of ``chainermn_tpu/parallel/ulysses.py``. Where the ring
rotates K/V n times, Ulysses moves each of q, k, v once: every rank then
runs the port's :func:`~chainermn_torch.ops.flash_attention.
flash_attention` (the hand-written kernels on CUDA tensors) on its
``H/n`` heads over the whole sequence, and the output moves back once.
The exchanges are the port's differentiable ``alltoall`` (its backward is
the reverse exchange), so no custom backward is needed.

The port's ``alltoall`` splits the leading axis, so the head groups move
to the front before the exchange, and the received sequence slices fold
into the sequence in rank order: the sequence is globally ordered and
causal masking needs no offset.
"""

from __future__ import annotations

from typing import Optional

from chainermn_torch.functions import alltoall
from chainermn_torch.ops.flash_attention import flash_attention

__all__ = ["ulysses_attention"]


def _to_heads(comm, x):
    """``[B, L/n, H, D]`` → ``[B, L, H/n, D]``: head group s goes to rank
    s, and rank r's sequence slice lands at position r."""
    n = comm.size
    b, ll, h, d = x.shape
    x = x.reshape(b, ll, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    y = alltoall(comm, x)                   # [n (source), B, L/n, H/n, D]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * ll, h // n, d)


def _to_sequence(comm, o):
    """``[B, L, H/n, D]`` → ``[B, L/n, H, D]``: sequence slice s goes to
    rank s, and rank r's head group lands at heads ``[r·H/n, …)``."""
    n = comm.size
    b, l, hl, d = o.shape
    x = o.reshape(b, n, l // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    y = alltoall(comm, x)                   # [n (source), B, L/n, H/n, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, l // n, n * hl, d)


def ulysses_attention(q, k, v, comm, causal: bool = False,
                      scale: Optional[float] = None):
    """Attention over a sequence split on ``comm``'s ranks: q, k, v
    ``[B, L_local, H, D]`` on each rank, H divisible by ``comm.size`` →
    ``[B, L_local, H, D]``."""
    n = comm.size
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"'{comm.axis_name}' axis size ({n}); use ring_flash_attention "
            "for few-head long-sequence cases")
    o = flash_attention(_to_heads(comm, q), _to_heads(comm, k),
                        _to_heads(comm, v), causal, scale)
    return _to_sequence(comm, o)
