"""Where the port runs: CUDA by default, the CPU only when asked."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "cuda_index_of", "bind_thread_device"]


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


def cuda_index_of(engine) -> Optional[int]:
    """The CUDA device index an engine (anything with a ``device``
    attribute) runs on, or ``None`` for a CPU or device-less one. An
    index-less ``cuda`` resolves to the calling thread's current card,
    so read it on the thread that built the engine."""
    dev = getattr(engine, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    dev = torch.device(dev)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def bind_thread_device(index: Optional[int]) -> None:
    """Make ``index`` (from :func:`cuda_index_of`) the calling thread's
    current CUDA device; ``None`` does nothing. torch.cuda's current
    device is per thread, so every worker thread that drives an engine
    calls this first."""
    if index is not None:
        torch.cuda.set_device(index)
