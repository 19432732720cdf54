"""On-device token sampling, on ``jax.random``'s threefry stream.

Counterpart of ``chainermn_tpu/serving/sampling.py``, bit for bit. The
encoding is the same: ``temperature <= 0`` → greedy argmax (first index
on ties, as ``jnp.argmax``), ``top_k <= 0`` → the full vocabulary, and
the keys are an ``[n, 2]`` matrix of raw ``jax.random.PRNGKey`` rows the
engine threads as state. One key split per sampled token per slot, greedy
rows too: the stream depends only on how many tokens a slot has sampled,
never on ``decode_k``, chunking or the neighbouring rows.

The random stream is JAX's, rebuilt in torch integer arithmetic. A key
word is a uint32 value held in an ``int64`` tensor and masked to 32 bits
after every add and shift (``torch.uint32`` has few kernels). The parts
follow jax 0.9's ``jax/_src/prng.py`` and ``jax/_src/random.py`` under
``jax_threefry_partitionable=True`` (jax 0.9's default) and
``jax_use_high_dynamic_range_gumbel=False`` (``categorical``'s
``mode=None`` resolves to ``"low"``):

* :func:`threefry2x32`: the 20-round Threefry-2x32 hash;
* :func:`split`: the fold-like split, threefry over the counts
  ``(hi, lo)`` of ``iota(num)`` as a 64-bit index, row ``i`` the two
  output words;
* :func:`random_bits`: ``bits1 ^ bits2`` of threefry over the same
  64-bit iota of the flattened shape;
* :func:`uniform`: the top 23 bits OR'd into the exponent of 1.0, minus
  1.0, scaled into ``[minval, maxval)`` and clamped at ``minval``;
* :func:`gumbel`: ``-log(-log(uniform(minval=tiny)))``;
* :func:`categorical`: ``argmax(gumbel + logits)`` along the last axis.

Key rows and bits equal JAX's exactly. The noise passes through ``log``,
whose last bit may differ between XLA's CPU, torch's CPU and CUDA; the
tokens then agree wherever the top-2 margin of ``scaled + noise`` is not
a last-bit tie. A jax upgrade that flips either flag changes JAX's
stream, and this module must follow it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["request_key", "init_keys", "split_keys", "sample_tokens",
           "any_sampling", "draft_shadow_keys", "threefry2x32", "split", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def request_key(seed: int, device=None) -> torch.Tensor:
    """Key row ``[2]`` of one request: ``jax.random.PRNGKey(seed)`` with
    64-bit types off, i.e. ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def init_keys(n: int, device=None) -> torch.Tensor:
    """The engine's resting key state: ``[n, 2]`` zeros."""
    return torch.zeros((n, 2), dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the count pairs ``(x1, x2)`` under
    the key ``(k1, k2)``; all uint32 values in ``int64`` tensors that
    broadcast together → the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _iota_2x32(shape, device) -> tuple:
    """``iota(prod(shape))`` as a 64-bit row-major index over ``shape``,
    split into its (high, low) 32-bit words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _M32


def _hash(key: torch.Tensor, shape) -> tuple:
    """Threefry of the 64-bit iota over ``shape`` under each key row of
    ``key`` ``[..., 2]`` → two words ``[..., *shape]``."""
    hi, lo = _iota_2x32(tuple(shape), key.device)
    lead = key.shape[:-1] + (1,) * len(shape)
    return threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                        hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key rows ``[..., 2]`` → ``[..., num, 2]``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in ``int64``) for
    each key row of ``key`` ``[..., 2]`` → ``[..., *shape]``."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 for each key row → ``[..., *shape]``."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, ``mode="low"``, for each key row."""
    u = uniform(key, shape, minval=_F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis for ONE
    key row ``[2]``: the Gumbel-max of the whole array, its noise drawn
    over ``logits.shape``."""
    return (gumbel(key, tuple(logits.shape)) + logits).argmax(-1)


def split_keys(keys: torch.Tensor):
    """Per-row key split: ``[n, 2]`` → (advanced keys, subkeys)."""
    both = split(keys, 2)
    return both[:, 0], both[:, 1]


def any_sampling(temperature, live=None) -> bool:
    """Whether some row (of ``live``, where given) samples, i.e. has a
    temperature above 0, read where the engine keeps both: on the host.
    Values on a card are not read (that would wait for it) and count as
    sampling."""
    def host(x):
        if torch.is_tensor(x):
            return None if x.device.type != "cpu" else x.numpy()
        return np.asarray(x)

    t = host(temperature)
    if t is None:
        return True
    rows = t > 0
    m = None if live is None else host(live)
    if m is not None:
        rows = rows & m.astype(bool)
    return bool(rows.any())


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, temperature,
                  top_k, noise: bool = True):
    """One token per row: logits ``[n, vocab]``, keys ``[n, 2]``,
    temperature ``[n]`` (``<= 0`` greedy), top_k ``[n]`` (``<= 0`` full
    vocab) → ``(tokens [n] int64, new_keys [n, 2])``: ``jax.vmap`` of
    ``jax.random.categorical`` over the rows' subkeys. Every row consumes
    one split, greedy rows too; callers freeze the keys of rows that did
    not really sample. ``noise=False`` says that no row whose token is
    kept samples (:func:`any_sampling`): the Gumbel draw is skipped and
    every row takes the greedy argmax, while the keys split all the
    same, so the stream does not change."""
    logits = logits.float()
    n, v = logits.shape
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=logits.device)
    greedy = logits.argmax(-1)
    new_keys, sub = split_keys(keys)
    if not noise:
        return greedy, new_keys
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    # top-k with a per-row k: keep everything >= the k-th largest
    kth_idx = (top_k - 1).clamp(0, v - 1)
    srt = scaled.sort(dim=-1, descending=True).values
    kth = srt.gather(-1, kth_idx[:, None])
    truncated = scaled.masked_fill(scaled < kth, float("-inf"))
    scaled = torch.where((top_k > 0)[:, None], truncated, scaled)
    sampled = (gumbel(sub, (v,)) + scaled).argmax(-1)
    tokens = torch.where(temperature > 0, sampled, greedy)
    return tokens, new_keys


def draft_shadow_keys(keys: torch.Tensor) -> torch.Tensor:
    """SHADOW copy of the target's per-slot key rows for a speculative
    draft pass (``serving/speculative.py``): the draft samples its
    proposals with the SAME key values, at the same stream positions,
    that the target will verify with, so the Gumbel-max draws coincide
    wherever the two models' logits are close. The shadow is thrown away
    after every round; only the verify pass advances the real rows, one
    draw per emitted token, which keeps accepted streams equal to plain
    decode's. A draft-sampled token is never committed from this stream
    without a verify pass blessing it."""
    return keys.clone()
