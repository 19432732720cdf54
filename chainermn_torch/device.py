"""Where the port runs: CUDA by default, the CPU only when asked."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``. A CUDA device with no CUDA available raises:
    the port never falls back to the CPU on its own; pass
    ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; chainermn_torch runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev
