"""On-device token sampling with per-slot counter-based random state.

Counterpart of ``chainermn_tpu/serving/sampling.py``. The encoding is the
same: ``temperature <= 0`` → greedy argmax (first index on ties, as
``jnp.argmax``), ``top_k <= 0`` → the full vocabulary, keys are an
``[n, 2]`` integer matrix the engine threads as state.

The random stream differs. A key row here is ``(seed, counter)``. A draw
hashes ``(seed, counter, vocab index)`` into uniform noise on the device
and takes the Gumbel-max of the scaled logits; the counter then advances
by one. So, as in the reference: one draw per sampled token per slot,
independent of ``decode_k``, of chunking and of the neighbouring rows, and
no host round trip inside a multi-token dispatch (a ``torch.Generator``
per slot would need the host to know which rows are still alive). The
bits are not ``jax.random``'s threefry bits.
"""

from __future__ import annotations

import torch

__all__ = ["request_key", "init_keys", "split_keys", "sample_tokens"]

_M32 = 0xFFFFFFFF


def request_key(seed: int, device=None) -> torch.Tensor:
    """Key row ``[2]`` (seed, counter 0) for one request."""
    return torch.tensor([int(seed) & _M32, 0], dtype=torch.int64,
                        device=device)


def init_keys(n: int, device=None) -> torch.Tensor:
    """The engine's resting key state: ``[n, 2]`` zeros."""
    return torch.zeros((n, 2), dtype=torch.int64, device=device)


def split_keys(keys: torch.Tensor):
    """``[n, 2]`` → (advanced keys, the keys this draw uses)."""
    return keys + torch.tensor([0, 1], device=keys.device), keys


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) held in int64, without
    overflowing 64 bits."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[n, vocab]`` f32, a pure function of the key
    rows."""
    row = _fmix32(_fmix32(keys[:, 0] & _M32) ^ (keys[:, 1] & _M32))
    col = _fmix32(torch.arange(vocab, device=keys.device, dtype=torch.int64)
                  * 0x9E3779B9 & _M32)
    bits = _fmix32(row[:, None] ^ col[None, :])
    u = (bits.double() + 0.5) * 2.0 ** -32
    return (-torch.log(-torch.log(u))).float()


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, temperature,
                  top_k):
    """One token per row: logits ``[n, vocab]``, keys ``[n, 2]``,
    temperature ``[n]`` (``<= 0`` greedy), top_k ``[n]`` (``<= 0`` full
    vocab) → ``(tokens [n] int64, new_keys [n, 2])``. Every row consumes
    one draw, greedy rows too; callers freeze the keys of rows that did
    not really sample."""
    logits = logits.float()
    n, v = logits.shape
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=logits.device)
    greedy = logits.argmax(-1)
    new_keys, sub = split_keys(keys)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    # top-k with a per-row k: keep everything >= the k-th largest
    kth_idx = (top_k - 1).clamp(0, v - 1)
    srt = scaled.sort(dim=-1, descending=True).values
    kth = srt.gather(-1, kth_idx[:, None])
    truncated = scaled.masked_fill(scaled < kth, float("-inf"))
    scaled = torch.where((top_k > 0)[:, None], truncated, scaled)
    sampled = (scaled + gumbel_noise(sub, v)).argmax(-1)
    tokens = torch.where(temperature > 0, sampled, greedy)
    return tokens, new_keys
