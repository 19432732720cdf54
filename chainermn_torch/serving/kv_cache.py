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

int8-block pages (``kv_dtype="int8-block"``): each page stores
``k_q``/``v_q`` (int8 codes, the page shape) and ``k_s``/``v_s`` (f32
scales, one per block of ``page_block(model)`` elements of a cache
column) — the blockwise codec of ``collectives/quantized.py`` moved into
the cache, so an exported slot's flattened codes and scales are a valid
``block_dequantize`` payload. Every dispatch computes against an f32
view of the pages (:func:`unpack_cache`) and requantizes only the
columns it wrote (:func:`repack_cache`): every other column keeps its
resident bytes exactly. The codes and scales are JAX's bit for bit: its
compiled commit multiplies ``amax`` by the f32 reciprocal of 127 (XLA
folds the division by the constant into that product), and so does
:func:`_quant_rows`. No ring wrap in this mode: the engine enforces
``prompt + max_new_tokens <= capacity`` at submit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from chainermn_torch.collectives.quantized import QUANT_BLOCK, _scale
from chainermn_torch.device import resolve_device
from chainermn_torch.models.transformer import compute_copy
from chainermn_torch.serving.sampling import any_sampling, sample_tokens

__all__ = ["cache_spec", "cache_bytes", "init_cache", "decode_apply",
           "prefill_apply", "prefill_chunk_apply", "decode_k_apply",
           "ServingStep", "KV_PAGE_DTYPES", "page_block", "unpack_cache",
           "repack_cache", "cache_is_quantized"]

#: page storage modes: raw (``f32``: the cache dtype, f32 or bf16) and
#: int8-block (blockwise int8 codes + f32 scales)
KV_PAGE_DTYPES = ("f32", "int8-block")
_QUANT_LEAVES = ("k_q", "k_s", "v_q", "v_s")


def _normalize_kv_dtype(kv_dtype: Optional[str]) -> str:
    mode = kv_dtype or "f32"
    if mode not in KV_PAGE_DTYPES:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} not in {KV_PAGE_DTYPES}")
    return mode


def cache_spec(model) -> Dict[str, int]:
    """The numbers page shapes and the sizing math derive from."""
    return dict(n_layers=model.n_layers, n_kv_heads=model.n_kv_heads,
                d_head=model.d_model // model.n_heads)


def page_block(model) -> int:
    """int8-block block size for this model: ``gcd(256, n_kv_heads ·
    d_head)``, so every cache column is a whole number of blocks."""
    spec = cache_spec(model)
    return math.gcd(QUANT_BLOCK, spec["n_kv_heads"] * spec["d_head"])


def cache_bytes(model, n_slots: int, capacity: int,
                dtype: Optional[torch.dtype] = None,
                kv_dtype: Optional[str] = None) -> int:
    """Resident footprint: ``n_layers · n_slots · capacity · 2 ·
    n_kv_heads · d_head · itemsize``; int8-block pages cost ``1 +
    4/block`` bytes an element (codes plus the amortized f32 scale)."""
    spec = cache_spec(model)
    cells = (spec["n_layers"] * n_slots * capacity * 2
             * spec["n_kv_heads"] * spec["d_head"])
    if _normalize_kv_dtype(kv_dtype) == "int8-block":
        return cells + cells // page_block(model) * 4
    return cells * (dtype or model.dtype).itemsize


def init_cache(model, n_slots: int, capacity: int,
               dtype: Optional[torch.dtype] = None, device=None,
               kv_dtype: Optional[str] = None,
               n_kv_heads: Optional[int] = None):
    """Zeroed pages and cursors on ``device`` (default: the model's).
    int8-block pages hold ``k_q``/``v_q`` codes and ``k_s``/``v_s``
    scales initialised to 1.0, what the codec emits for an all-zero
    block. ``n_kv_heads``: the heads a page holds (default: the model's
    all; a head-sharded step's pages hold this rank's)."""
    dt = dtype or model.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"page dtype {dt} not in "
                         f"{(torch.float32, torch.bfloat16)}")
    dev = model.device if device is None else torch.device(device)
    spec = cache_spec(model)
    shape = (n_slots, capacity, n_kv_heads or spec["n_kv_heads"],
             spec["d_head"])
    if _normalize_kv_dtype(kv_dtype) == "int8-block":
        s_shape = (n_slots, capacity,
                   spec["n_kv_heads"] * spec["d_head"] // page_block(model))

        def page():
            return {"k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_s": torch.ones(s_shape, device=dev),
                    "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v_s": torch.ones(s_shape, device=dev),
                    "idx": torch.zeros(n_slots, dtype=torch.int64,
                                       device=dev)}
    else:
        def page():
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev),
                    "idx": torch.zeros(n_slots, dtype=torch.int64,
                                       device=dev)}
    return {f"block_{i}": page() for i in range(spec["n_layers"])}


def _quant_rows(x: torch.Tensor, block: int):
    """Blockwise-quantize the trailing ``n_kv_heads × d_head`` row of
    ``x`` → (int8 codes of ``x``'s shape, scales ``[..., r/block]`` in
    ``x``'s dtype): the codec's op sequence per block, with the scale
    ``amax`` times the f32 reciprocal of 127, as JAX's compiled commit
    computes it."""
    shape = x.shape
    r = shape[-2] * shape[-1]
    b = x.reshape(shape[:-2] + (r // block, block))
    amax = b.abs().amax(dim=-1)
    scale = _scale(amax, 127.0, True).to(x.dtype)
    q = torch.clamp(torch.round(b / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_quant_rows` (codes times scales, in f32)."""
    shape = q.shape
    b = q.reshape(shape[:-2] + (scale.shape[-1], -1)).float()
    return (b * scale[..., None].float()).reshape(shape)


def cache_is_quantized(cache) -> bool:
    """True when ``cache`` holds int8-block pages."""
    return "k_q" in cache["block_0"]


def unpack_cache(cache):
    """int8-block pages → a NEW f32 ``{"k", "v", "idx"}`` view every
    apply function computes against (the cursors are copies); the pages
    themselves for raw pages."""
    if not cache_is_quantized(cache):
        return cache
    return {name: {"k": _dequant_rows(page["k_q"], page["k_s"]),
                   "v": _dequant_rows(page["v_q"], page["v_s"]),
                   "idx": page["idx"].clone()}
            for name, page in cache.items()}


def repack_cache(old, new, start, count, width: Optional[int] = None):
    """Quantize-on-commit: fold the f32 view ``new`` (an apply function's
    output) back into the resident pages ``old``, IN PLACE, requantizing
    only the columns the dispatch wrote; returns ``old`` (``new`` for raw
    pages, which the dispatch updated itself).

    ``start`` ``[n_slots]`` — each slot's first written column (absolute;
    the ring position is ``start % capacity``); ``count`` — columns
    written per slot (scalar or ``[n_slots]``; 0: untouched). ``width``
    bounds ``count`` (default: the capacity); only that many columns a
    slot are gathered and quantized. A column outside its slot's written
    window keeps its resident bytes exactly."""
    if not cache_is_quantized(old):
        return new
    page0 = old["block_0"]["k_q"]
    n_slots, capacity = page0.shape[:2]
    dev = page0.device
    w = min(capacity if width is None else int(width), capacity)
    start = torch.as_tensor(start, device=dev).long().reshape(-1)
    start = start.expand(n_slots) if start.numel() == 1 else start
    count = torch.as_tensor(count, device=dev).long().reshape(-1)
    count = count.expand(n_slots) if count.numel() == 1 else count
    ar = torch.arange(w, device=dev)
    cols = torch.remainder(start[:, None] + ar, capacity)      # [n, w]
    written = ar[None] < count[:, None]
    rows = torch.arange(n_slots, device=dev)[:, None].expand(n_slots, w)
    blk = page0[0, 0].numel() // old["block_0"]["k_s"].shape[-1]
    for name, page in old.items():
        for kv in ("k", "v"):
            q, s = _quant_rows(new[name][kv][rows, cols], blk)
            qo, so = page[kv + "_q"], page[kv + "_s"]
            qo[rows, cols] = torch.where(written[..., None, None], q,
                                         qo[rows, cols])
            so[rows, cols] = torch.where(written[..., None], s,
                                         so[rows, cols])
        page["idx"] = new[name]["idx"]
    return old


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
    noise = any_sampling(temps, live)
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
        nxt, keys2 = sample_tokens(last, keys, temps, top_ks, noise)
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


def _head_shard(model, mesh, axis: Optional[str]):
    """The :class:`~chainermn_torch.models.transformer.KVHeadShard` of a
    step over ``mesh``'s ``axis`` (JAX's ``_shardings``: pages split on
    the KV-head axis when ``n_kv_heads`` divides by the axis size), or
    None: no mesh, or pages kept whole on every rank (JAX's ``P()``)."""
    from chainermn_torch.models.transformer import KVHeadShard

    if mesh is None:
        return None
    names = tuple(mesh.axis_names)
    axis = axis or names[0]
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in the mesh axes {names}")
    comm = mesh if names == (axis,) else mesh.over_mesh(mesh.mesh,
                                                         axes=(axis,))
    if comm.size == 1 or model.n_kv_heads % comm.size:
        return None
    return KVHeadShard(comm, model.n_kv_heads)


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
    token ids to the host. ``kv_dtype="int8-block"`` keeps the pages as
    int8 codes + f32 scales between dispatches (module docstring).

    ``mesh``/``axis`` (JAX's names): head-sharded pages. ``mesh`` is a
    communicator (``comm``, or one from ``comm.over_mesh(...)``) and
    ``axis`` one of its axis names (default its first); the pages split
    over the communicator on that axis by KV head when ``n_kv_heads``
    divides by its size, and stay whole on every rank otherwise. The
    parameters and cursors are replicated. Each rank projects q, k and v
    whole, attends over its own heads (prefill through the flash
    kernel), and all-gathers the heads' outputs before the output
    projection, so the logits, the sampled tokens and the streams are the
    same on every rank and equal to the one-rank step's. The step is
    SPMD: every rank makes every call, in one order. ``cache_bytes()`` is
    one rank's. int8-block pages do not compose with a mesh.
    """

    def __init__(self, model, n_slots: int, capacity: int, *,
                 cache_dtype: Optional[torch.dtype] = None, device=None,
                 kv_dtype: Optional[str] = None, mesh=None,
                 axis: Optional[str] = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, the serving "
                             f"step on {self.device}")
        self.kv_dtype = _normalize_kv_dtype(kv_dtype)
        if self.kv_dtype == "int8-block" and mesh is not None:
            raise ValueError(
                "kv_dtype='int8-block' does not compose with mesh-sharded "
                "pages: the blockwise scales span the head axis; serve "
                "int8 pages unsharded or keep f32 pages under the mesh")
        self.model = compute_copy(model)
        self.model.kv_head_shard = self.heads = _head_shard(model, mesh,
                                                            axis)
        self.n_slots = int(n_slots)
        self.capacity = int(capacity)
        self.cache_dtype = cache_dtype or model.dtype
        self.reset()
        self.last_decode_logits: Optional[torch.Tensor] = None

    def cache_bytes(self) -> int:
        """The pages' resident bytes on this rank."""
        whole = cache_bytes(self.model, self.n_slots, self.capacity,
                            self.cache_dtype, kv_dtype=self.kv_dtype)
        return whole // self.heads.comm.size if self.heads else whole

    def cursors(self) -> np.ndarray:
        """Device→host pull of the per-slot fill levels (debug/report)."""
        return self.cache["block_0"]["idx"].cpu().numpy()

    def _scatter_window(self, slot_ids, starts, counts):
        """Per-SLOT (start, count) written-column windows of a cohort
        scatter — the :func:`repack_cache` mask inputs. Sentinel rows
        (``sid == n_slots``) drop out, so their slots' counts stay 0."""
        sid = _as(slot_ids, torch.int64, self.device)
        keep, rows = _drop_index(sid, self.n_slots)
        start = torch.zeros(self.n_slots, dtype=torch.int64,
                            device=self.device)
        count = torch.zeros_like(start)
        start[rows[keep]] = _as(starts, torch.int64,
                                self.device).expand(sid.shape)[keep]
        count[rows[keep]] = _as(counts, torch.int64,
                                self.device).expand(sid.shape)[keep]
        return start, count

    def _commit(self, view, start, count, width: int) -> None:
        self.cache = repack_cache(self.cache, view, start, count, width)

    def decode(self, tokens):
        """One token for every slot → logits ``[n_slots, vocab]``. Rows of
        free slots are garbage and must be ignored."""
        view = unpack_cache(self.cache)
        start = view["block_0"]["idx"].clone()
        logits, view = decode_apply(
            self.model, view, _as(tokens, torch.int64, self.device))
        self._commit(view, start, 1, 1)
        return logits

    def prefill(self, tokens, lengths, slot_ids):
        """Cohort prefill (see :func:`prefill_apply`) → logits."""
        view = unpack_cache(self.cache)
        last, view = prefill_apply(self.model, view, tokens, lengths,
                                   slot_ids)
        width = int(np.shape(tokens)[1])
        start, count = self._scatter_window(slot_ids, 0, width)
        self._commit(view, start, count, width)
        return last

    def _sample_rows(self, last, slot_ids, keys, temps, top_ks):
        sid = _as(slot_ids, torch.int64, self.device)
        gid = sid.clamp(0, self.n_slots - 1)
        noise = any_sampling(temps)
        temps = _as(temps, torch.float32, self.device)
        top_ks = _as(top_ks, torch.int64, self.device)
        tok, newk = sample_tokens(last, keys[gid], temps[gid], top_ks[gid],
                                  noise)
        return sid, gid, tok, newk

    def prefill_sampled(self, tokens, lengths, slot_ids, keys, temps,
                        top_ks):
        """Cohort prefill + first-token sampling on the device → ``(tok
        [S], new keys)``; sentinel rows leave every key untouched."""
        last = self.prefill(tokens, lengths, slot_ids)
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
        view = unpack_cache(self.cache)
        last, view = prefill_chunk_apply(self.model, view, tokens, starts,
                                         valid, slot_ids)
        start, count = self._scatter_window(slot_ids, starts, valid)
        self._commit(view, start, count, int(np.shape(tokens)[1]))
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
        view = unpack_cache(self.cache)
        # every row writes k columns from its PINNED cursor: live rows
        # from idx, ride-along rows from park
        start = torch.where(_as(live, torch.bool, self.device),
                            view["block_0"]["idx"],
                            _as(park, torch.int64, self.device))
        toks, last, keys, view = decode_k_apply(
            self.model, view, tokens, keys, temps, top_ks, eos_ids,
            remaining, live, park, int(k))
        self._commit(view, start, int(k), int(k))
        self.last_decode_logits = last
        return toks, keys

    def export_slot(self, slot: int, fill: int) -> Dict[str, Dict]:
        """Pull one slot's populated KV rows to the host: ``{"block_i":
        {"k", "v"}}``, each ``[fill, n_kv_heads, d_head]`` numpy (a
        head-sharded step gathers every rank's heads: a collective, and
        the one-rank format, so any engine imports it), f32 for
        f32 pages and for bf16 pages (numpy has no bf16; the widening is
        exact, so a bf16 import round-trips bitwise). ``fill`` must not
        exceed the page (a wrapped ring has overwritten its prefix).

        int8-block pages export RESIDENT form: ``{"k_q", "k_s", "v_q",
        "v_s"}`` a block, codes ``[fill, n_kv_heads, d_head]`` int8 and
        scales ``[fill, r/block]`` f32 — shipped verbatim, never
        recomputed (a recompute could differ from the resident scale)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        if not 0 < fill <= self.capacity:
            raise ValueError(
                f"fill {fill} outside (0, capacity={self.capacity}] — a "
                "wrapped slot cannot be exported")
        leaves = (_QUANT_LEAVES if self.kv_dtype == "int8-block"
                  else ("k", "v"))

        def host(t):
            t = t[slot, :fill]
            if self.heads is not None:   # every rank's heads, in order
                t = self.heads.gather(t)
            return (t.float() if t.dtype == torch.bfloat16 else t
                    ).cpu().numpy()

        return {name: {leaf: host(page[leaf]) for leaf in leaves}
                for name, page in self.cache.items()}

    def import_slot(self, slot: int, pages, cursor: int) -> None:
        """Inverse of :meth:`export_slot`: write handed-off KV rows into
        ``slot`` and set its cursor to ``cursor``. Raw rows into raw pages
        round-trip BITWISE. ``pages`` may hold raw ``{"k", "v"}`` rows or
        int8-resident ``{"k_q", "k_s", "v_q", "v_s"}`` rows, and either
        lands in either page mode: resident→int8 adopts the codes
        verbatim, resident→raw dequantizes once, raw→int8 quantizes once
        (the one quantization a local commit pays)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        if not 0 < cursor <= self.capacity:
            raise ValueError(
                f"cursor {cursor} outside (0, capacity={self.capacity}]")
        if set(pages) != set(self.cache):
            raise ValueError(
                "handoff pages do not match this model's cache layout: "
                f"got {sorted(pages)}, want {sorted(self.cache)}")
        resident = "k_q" in next(iter(pages.values()))
        blk = page_block(self.model)
        dev = self.device
        spec = cache_spec(self.model)
        want = (cursor, spec["n_kv_heads"], spec["d_head"])
        mine = (slice(None) if self.heads is None else
                slice(self.heads.start, self.heads.start
                      + self.heads.kv_heads))
        for name, page in self.cache.items():
            if resident:
                # dlint: disable=DL121 — handoff pages are host arrays
                rows = {leaf: torch.from_numpy(
                    np.array(pages[name][leaf])).to(dev)
                    for leaf in _QUANT_LEAVES}
            else:
                # dlint: disable=DL121 — handoff pages are host arrays
                rows = {kv: torch.from_numpy(
                    np.array(pages[name][kv], np.float32)).to(dev)
                    for kv in ("k", "v")}
                if (tuple(rows["k"].shape) != want
                        or tuple(rows["v"].shape) != want):
                    raise ValueError(
                        f"handoff rows for {name} have shape "
                        f"{tuple(rows['k'].shape)}, want {want}")
            if self.kv_dtype == "int8-block":
                if not resident:
                    rows["k_q"], rows["k_s"] = _quant_rows(rows["k"], blk)
                    rows["v_q"], rows["v_s"] = _quant_rows(rows["v"], blk)
                for leaf in _QUANT_LEAVES:
                    page[leaf][slot, :cursor] = rows[leaf].to(
                        page[leaf].dtype)
            else:
                if resident:
                    rows["k"] = _dequant_rows(rows["k_q"], rows["k_s"])
                    rows["v"] = _dequant_rows(rows["v_q"], rows["v_s"])
                for kv in ("k", "v"):
                    page[kv][slot, :cursor] = rows[kv][:, mine].to(
                        page[kv].dtype)
            page["idx"][slot] = int(cursor)

    def load_params(self, state_dict) -> None:
        """Swap the served weights in place (same shapes; no page is
        touched), the one way to update them after construction. f32
        weights are cast to the snapshot's dtypes."""
        self.model.load_state_dict(state_dict)

    def reset(self) -> None:
        """Zero every page and cursor (all slots freed)."""
        self.cache = init_cache(
            self.model, self.n_slots, self.capacity, self.cache_dtype,
            kv_dtype=self.kv_dtype,
            n_kv_heads=self.heads.kv_heads if self.heads else None)
