"""Paged, ring-buffered KV cache and the serving step functions.

Counterpart of ``chainermn_tpu/serving/kv_cache.py`` for f32 and bf16
pages. The cache is a dict ``{"block_i": {"k", "v", "idx"}}``: one page
per transformer block, ``k``/``v`` of shape ``[n_slots, capacity,
n_kv_heads, d_head]`` and a per-slot cursor vector ``idx [n_slots]``
(int64). The write position of token ``p`` of a slot is ``p % capacity``;
a stream that outgrows its page overwrites its oldest tokens.

The reference's functions are pure and return a new tree; these update
the pages IN PLACE and return the same dict (pages are hundreds of MB at
serving size). Scatters keep the reference's ``mode="drop"`` semantics:
a slot id or column outside the page is dropped (the engine's sentinel
slot id ``n_slots`` marks a padding row), a negative one wraps.

``ServingStep`` owns the pages and runs each dispatch eagerly on the
model's device; ``decode_k`` loops ``k`` decode steps on the device with
no host synchronisation inside. Every function runs under
``torch.no_grad``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from chainermn_torch.device import resolve_device
from chainermn_torch.models.transformer import compute_copy
from chainermn_torch.serving.sampling import sample_tokens

__all__ = ["cache_spec", "cache_bytes", "init_cache", "decode_apply",
           "prefill_apply", "prefill_chunk_apply", "decode_k_apply",
           "ServingStep"]

#: page storage dtypes of this slice (int8-block pages are still to port)
PAGE_DTYPES = (torch.float32, torch.bfloat16)


def cache_spec(model) -> Dict[str, int]:
    """The numbers page shapes and the sizing math derive from."""
    return dict(n_layers=model.n_layers, n_kv_heads=model.n_kv_heads,
                d_head=model.d_model // model.n_heads)


def cache_bytes(model, n_slots: int, capacity: int,
                dtype: Optional[torch.dtype] = None) -> int:
    """Resident footprint: ``n_layers · n_slots · capacity · 2 ·
    n_kv_heads · d_head · itemsize``."""
    spec = cache_spec(model)
    cells = (spec["n_layers"] * n_slots * capacity * 2
             * spec["n_kv_heads"] * spec["d_head"])
    return cells * (dtype or model.dtype).itemsize


def init_cache(model, n_slots: int, capacity: int,
               dtype: Optional[torch.dtype] = None, device=None):
    """Zeroed pages and cursors on ``device`` (default: the model's)."""
    dt = dtype or model.dtype
    if dt not in PAGE_DTYPES:
        raise ValueError(f"page dtype {dt} not in {PAGE_DTYPES}")
    dev = model.device if device is None else torch.device(device)
    spec = cache_spec(model)
    shape = (n_slots, capacity, spec["n_kv_heads"], spec["d_head"])
    return {f"block_{i}": {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "idx": torch.zeros(n_slots, dtype=torch.int64, device=dev),
    } for i in range(spec["n_layers"])}


def _drop_index(idx: torch.Tensor, size: int):
    """``.at[idx]`` with ``mode="drop"``: (in-range mask, wrapped index)."""
    keep = (idx >= -size) & (idx < size)
    return keep, torch.remainder(idx, size)


@torch.no_grad()
def decode_apply(model, cache, tokens):
    """One token for every slot: tokens ``[n_slots]`` → (logits
    ``[n_slots, vocab]``, cache). The cursors double as learned-position
    offsets."""
    tokens = torch.as_tensor(tokens, device=model.device)
    logits = model.forward_cached(tokens[:, None], cache)
    return logits[:, 0], cache


@torch.no_grad()
def prefill_apply(model, cache, tokens, lengths, slot_ids):
    """Cohort prefill: tokens ``[S, L]`` (right-padded), lengths ``[S]``,
    slot_ids ``[S]`` (``n_slots`` = padding row, dropped). Runs the slab
    forward on a fresh ``[S, L]`` cache, scatters its K/V into the pages,
    sets the cursors to ``lengths`` and returns (last-real-position
    logits ``[S, vocab]``, cache)."""
    dev = model.device
    tokens = torch.as_tensor(tokens, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).long()
    sid = torch.as_tensor(slot_ids, device=dev).long()
    s, l = tokens.shape
    page0 = cache["block_0"]["k"]
    n_slots, capacity = page0.shape[:2]
    if l > capacity:
        raise ValueError(
            f"prefill bucket length {l} exceeds page capacity {capacity}")
    # every slab column is written before it is read, so no zero fill
    slab = {name: {"k": torch.empty((s, l) + page0.shape[2:],
                                    dtype=page0.dtype, device=dev),
                   "v": torch.empty((s, l) + page0.shape[2:],
                                    dtype=page0.dtype, device=dev),
                   "idx": torch.zeros((), dtype=torch.int64, device=dev)}
            for name in cache}
    logits = model.forward_cached(tokens, slab)
    last = logits[torch.arange(s, device=dev), lengths - 1]
    keep, rows = _drop_index(sid, n_slots)
    rows = rows[keep]
    for name, page in cache.items():
        page["k"][rows, :l] = slab[name]["k"][keep]
        page["v"][rows, :l] = slab[name]["v"][keep]
        page["idx"][rows] = lengths[keep]
    return last, cache


@torch.no_grad()
def prefill_chunk_apply(model, cache, tokens, starts, valid, slot_ids):
    """Chunk prefill against the pages: tokens ``[S, C]`` (right-padded),
    starts ``[S]`` (each slot's fill), valid ``[S]`` (real tokens in this
    chunk), slot_ids ``[S]`` (``n_slots`` = padding row). The chunk
    attends the cached prefix plus itself; its K/V land at ``[start,
    start + valid)``, cursors advance to ``start + valid``. Returns
    (last-real-position logits ``[S, vocab]``, cache). No-wrap contract:
    prompts fit the page."""
    dev = model.device
    tokens = torch.as_tensor(tokens, device=dev)
    starts = torch.as_tensor(starts, device=dev).long()
    valid = torch.as_tensor(valid, device=dev).long()
    sid = torch.as_tensor(slot_ids, device=dev).long()
    s, c = tokens.shape
    n_slots, capacity = cache["block_0"]["k"].shape[:2]
    if c > capacity:
        raise ValueError(
            f"prefill chunk length {c} exceeds page capacity {capacity}")
    gid = sid.clamp(0, n_slots - 1)   # sentinels read row 0; writes drop
    sub = {name: {"k": page["k"][gid], "v": page["v"][gid], "idx": starts}
           for name, page in cache.items()}
    logits = model.forward_cached(tokens, sub, chunked=True)
    ar = torch.arange(c, device=dev)[None]
    last = logits[torch.arange(s, device=dev),
                  (valid - 1).clamp(0, c - 1)]
    # padding columns point past the page end and drop, as the sentinel
    # slot id does on the row axis
    cols = torch.where(ar < valid[:, None], starts[:, None] + ar,
                       torch.full_like(starts[:, None] + ar, capacity))
    rows_i = torch.arange(s, device=dev)[:, None].expand(s, c)
    kr, rr = _drop_index(sid[:, None].expand(s, c), n_slots)
    kc, cc = _drop_index(cols, capacity)
    keep = kr & kc
    src_cols = cols.clamp(0, capacity - 1)
    krow, wrow = _drop_index(sid, n_slots)
    for name, page in cache.items():
        uk = sub[name]["k"][rows_i, src_cols]
        uv = sub[name]["v"][rows_i, src_cols]
        page["k"][rr[keep], cc[keep]] = uk[keep]
        page["v"][rr[keep], cc[keep]] = uv[keep]
        page["idx"][wrow[krow]] = (starts + valid)[krow]
    return last, cache


@torch.no_grad()
def decode_k_apply(model, cache, tokens, keys, temps, top_ks, eos_ids,
                   remaining, live, park, k: int):
    """``k`` decode steps with on-device sampling, each step's token fed
    to the next. tokens ``[n]``; keys ``[n, 2]`` (sampling.py); temps,
    top_ks ``[n]``; eos_ids ``[n]`` (< 0: none); remaining ``[n]`` token
    budget; live ``[n]`` bool; park ``[n]`` — the real fill of each
    non-live slot, pinned around the loop so ride-along steps never move
    its cursor.

    Returns ``(toks [n, k] — -1 where the slot did not sample,
    last_logits [n, vocab], keys, cache)``."""
    dev = model.device
    tok = torch.as_tensor(tokens, device=dev).long()
    live = torch.as_tensor(live, device=dev, dtype=torch.bool)
    park = torch.as_tensor(park, device=dev).long()
    rem = torch.as_tensor(remaining, device=dev).long()
    eos_ids = torch.as_tensor(eos_ids, device=dev).long()
    temps = torch.as_tensor(temps, device=dev, dtype=torch.float32)
    top_ks = torch.as_tensor(top_ks, device=dev).long()

    def pin():
        for page in cache.values():
            page["idx"] = torch.where(live, page["idx"], park)

    pin()
    alive = live
    outs = []
    last = None
    for _ in range(k):
        last, _ = decode_apply(model, cache, tok)
        nxt, keys2 = sample_tokens(last, keys, temps, top_ks)
        # only rows that really sampled advance their key
        keys = torch.where(alive[:, None], keys2, keys)
        valid = alive
        rem = rem - valid.long()
        hit_eos = (nxt == eos_ids) & (eos_ids >= 0)
        alive = alive & ~hit_eos & (rem > 0)
        tok = torch.where(valid, nxt, tok)
        outs.append(torch.where(valid, nxt, torch.full_like(nxt, -1)))
    pin()
    return torch.stack(outs, dim=1), last, keys, cache


def _as(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


class ServingStep:
    """The prefill/decode dispatches of one engine, owning its pages.

    ``model`` must already live on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``). The step serves a snapshot of
    it taken here (:func:`~chainermn_torch.models.transformer.compute_copy`,
    for every dtype): a bf16 model's f32 Dense and embedding weights are
    cast once, not on every dispatch, and later in-place updates of
    ``model`` (training steps, ``load_state_dict``) do not reach the
    step; :meth:`load_params` is how new weights get in. Each method runs
    eagerly and returns device tensors; the engine pulls only integer
    token ids to the host.
    """

    def __init__(self, model, n_slots: int, capacity: int, *,
                 cache_dtype: Optional[torch.dtype] = None, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, the serving "
                             f"step on {self.device}")
        self.model = compute_copy(model)
        self.n_slots = int(n_slots)
        self.capacity = int(capacity)
        self.cache_dtype = cache_dtype or model.dtype
        self.cache = init_cache(model, self.n_slots, self.capacity,
                                self.cache_dtype)
        self.last_decode_logits: Optional[torch.Tensor] = None

    def cache_bytes(self) -> int:
        return cache_bytes(self.model, self.n_slots, self.capacity,
                           self.cache_dtype)

    def decode(self, tokens):
        """One token for every slot → logits ``[n_slots, vocab]``. Rows of
        free slots are garbage and must be ignored."""
        logits, self.cache = decode_apply(
            self.model, self.cache, _as(tokens, torch.int64, self.device))
        return logits

    def prefill(self, tokens, lengths, slot_ids):
        """Cohort prefill (see :func:`prefill_apply`) → logits."""
        logits, self.cache = prefill_apply(self.model, self.cache, tokens,
                                           lengths, slot_ids)
        return logits

    def _sample_rows(self, last, slot_ids, keys, temps, top_ks):
        sid = _as(slot_ids, torch.int64, self.device)
        gid = sid.clamp(0, self.n_slots - 1)
        temps = _as(temps, torch.float32, self.device)
        top_ks = _as(top_ks, torch.int64, self.device)
        tok, newk = sample_tokens(last, keys[gid], temps[gid], top_ks[gid])
        return sid, gid, tok, newk

    def prefill_sampled(self, tokens, lengths, slot_ids, keys, temps,
                        top_ks):
        """Cohort prefill + first-token sampling on the device → ``(tok
        [S], new keys)``; sentinel rows leave every key untouched."""
        last, self.cache = prefill_apply(self.model, self.cache, tokens,
                                         lengths, slot_ids)
        sid, _, tok, newk = self._sample_rows(last, slot_ids, keys, temps,
                                              top_ks)
        keep, rows = _drop_index(sid, self.n_slots)
        keys = keys.clone()
        keys[rows[keep]] = newk[keep]
        return tok, keys

    def prefill_chunk(self, tokens, starts, valid, slot_ids, final, keys,
                      temps, top_ks):
        """One ``[S, C]`` prompt chunk (see :func:`prefill_chunk_apply`),
        sampling the first token for rows whose chunk is ``final`` →
        ``(tok [S] — -1 for non-final rows, new keys)``. Only a completing
        chunk advances its slot's key."""
        last, self.cache = prefill_chunk_apply(
            self.model, self.cache, tokens, starts, valid, slot_ids)
        sid, gid, tok, newk = self._sample_rows(last, slot_ids, keys, temps,
                                                top_ks)
        final = _as(final, torch.bool, self.device)
        adv = final & (sid < self.n_slots)
        keep, rows = _drop_index(sid, self.n_slots)
        keys = keys.clone()
        keys[rows[keep]] = torch.where(adv[:, None], newk, keys[gid])[keep]
        tok = torch.where(final, tok, torch.full_like(tok, -1))
        return tok, keys

    def decode_k(self, tokens, keys, temps, top_ks, eos_ids, remaining,
                 live, park, k: int):
        """``k`` decode steps + sampling in one dispatch (see
        :func:`decode_k_apply`) → ``(toks [n, k], new keys)``; the final
        step's logits stay on the device in ``last_decode_logits``."""
        toks, last, keys, self.cache = decode_k_apply(
            self.model, self.cache, tokens, keys, temps, top_ks, eos_ids,
            remaining, live, park, int(k))
        self.last_decode_logits = last
        return toks, keys

    def load_params(self, state_dict) -> None:
        """Swap the served weights in place (same shapes; no page is
        touched), the one way to update them after construction. f32
        weights are cast to the snapshot's dtypes."""
        self.model.load_state_dict(state_dict)

    def reset(self) -> None:
        """Zero every page and cursor (all slots freed)."""
        self.cache = init_cache(self.model, self.n_slots, self.capacity,
                                self.cache_dtype)
