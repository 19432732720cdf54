"""Rotary position embeddings (RoPE), split-half convention.

Counterpart of ``chainermn_tpu/ops/rotary.py``: the head dim splits into
two halves rotated against each other, computed in f32 and cast back.
Plain elementwise tensor code; no kernel.
"""

from __future__ import annotations

import torch

__all__ = ["rope_angles", "apply_rope"]


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions ``[...]`` → (cos, sin) of shape ``[..., dim // 2]``."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x ``[B, L, H, D]`` (D even); positions ``[L]`` or ``[B, L]``."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]   # head axis
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
