"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``chainermn_tpu/serving/speculative.py``. A small draft
``TransformerLM`` — its own raw pages, never int8 — proposes ``spec_k``
tokens a round, and the target verifies all of them in ONE chunk
forward. Each round is two dispatches for the whole slot grid:

1. **Propose** (:func:`propose_apply`): a width-2 catch-up chunk writes
   the tokens the draft pages lack (the current token; plus the previous
   round's bonus token after a full accept), its last-position logits
   sample the first draft ``d_1``, and ``spec_k - 1`` draft decode steps
   sample ``d_2 .. d_spec_k``. Sampling uses a SHADOW copy of the
   target's key rows (:func:`~.sampling.draft_shadow_keys`), thrown away
   after the round.
2. **Verify** (:func:`verify_apply`): a chunk forward of ``[cur, d_1 ..
   d_spec_k]`` at each slot's fill gives per-position logits ``L_0 ..
   L_spec_k``; an acceptance loop samples ``s_j`` from ``L_j`` with the
   REAL key rows, advancing a row's key only where it emits (one draw a
   sampled token), and emits the longest accepted prefix (``s_j ==
   d_{j+1}``) plus one more target-sampled token: the correction at the
   first mismatch, or the bonus ``s_spec_k`` after a full accept.
   EOS/budget stops mirror ``decode_k_apply``. The host pulls ONE
   ``[n_slots, spec_k + 1]`` integer array.

Every emitted token is sampled by the TARGET with the plain engine's own
key stream, so a speculative stream equals plain decode's wherever the
verify chunk's logits equal decode's. In the JAX package they do bitwise
(its squeezed-q decode contractions); here the chunk path
(``TransformerBlock._chunk_attention``) and the decode path
(``_decode_attention``) run GEMMs of different shapes, which a BLAS
library may sum in different orders, so the two logits can differ in
their last bits and a token whose top-2 margin is below that gap can
differ. The draft only decides how far a round advances.

Garbage discipline: rejected-draft K/V beyond the accepted prefix stays
in the target pages, but the next verify window starts at the new fill
and rewrites every such column before attention reads it. Ride-along
rows (mid-prefill, held) keep their cursors parked at their real fill.

No-wrap contract: ``submit`` enforces ``prompt + max_new + spec_k <=
capacity`` — the verify chunk's absolute-position mask has no ring
semantics, and the margin keeps the draft's pages from wrapping too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chainermn_torch.models.transformer import compute_copy
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import (
    _as,
    decode_apply,
    init_cache,
    prefill_apply,
    prefill_chunk_apply,
    repack_cache,
    unpack_cache,
)
from chainermn_torch.serving.sampling import (any_sampling,
                                             draft_shadow_keys,
                                             sample_tokens)

__all__ = ["DraftStep", "SpeculativeEngine", "propose_apply",
           "verify_apply"]


@torch.no_grad()
def propose_apply(model, cache, prev, cur, valid, starts, keys, temps,
                  top_ks, live, park, spec_k: int):
    """Draft proposal for the whole grid: one catch-up chunk + ``spec_k -
    1`` decode steps, on the draft's pages IN PLACE.

    prev/cur ``[n]`` — the previous round's bonus token (used only where
    ``valid == 2``) and each slot's current token; valid ``[n]`` (1
    normally, 2 after a full accept); starts ``[n]`` = fill - (valid -
    1); keys ``[n, 2]`` — the TARGET's key rows, shadow-copied here and
    discarded; live/park as in ``decode_k_apply``.

    Returns ``(drafts [n, spec_k] on the device, cache)``. Between rounds
    a live slot's draft pages hold exactly the stream positions ``[0,
    fill)``, as the target's do, so the catch-up never needs more than
    width 2."""
    dev = model.device
    noise = any_sampling(temps, live)
    cur = _as(cur, torch.int64, dev)
    prev = _as(prev, torch.int64, dev)
    valid = _as(valid, torch.int64, dev)
    live = _as(live, torch.bool, dev)
    park = _as(park, torch.int64, dev)
    n = cur.shape[0]
    two = valid == 2
    chunk = torch.stack([torch.where(two, prev, cur),
                         torch.where(two, cur, torch.zeros_like(cur))], 1)
    last, cache = prefill_chunk_apply(model, cache, chunk, starts, valid,
                                      torch.arange(n, device=dev))
    shadow = draft_shadow_keys(keys)
    tok, shadow = sample_tokens(last, shadow, temps, top_ks, noise)
    drafts = [tok]
    for _ in range(spec_k - 1):
        logits, cache = decode_apply(model, cache, tok)
        tok, shadow = sample_tokens(logits, shadow, temps, top_ks, noise)
        # dlint: disable=DL125 — drafts go to verify_apply, no stream
        drafts.append(tok)
    # ride-along rows: cursors back to their real fill, like decode_k
    for page in cache.values():
        page["idx"] = torch.where(live, page["idx"], park)
    return torch.stack(drafts, dim=1), cache


@torch.no_grad()
def verify_apply(model, cache, cur, drafts, keys, temps, top_ks, eos_ids,
                 remaining, live, park, spec_k: int):
    """Target verification + acceptance for the whole grid, on raw (or
    unpacked) pages IN PLACE.

    One chunk forward of ``[cur, d_1 .. d_spec_k]`` (width ``spec_k +
    1``) at ``starts = fill``; the acceptance loop samples ``s_j`` from
    position ``j`` with the real key rows and emits while ``s_j ==
    d_{j+1}``, then one correction or bonus token. Key rows advance ONLY
    on emission.

    Returns ``(emitted [n, spec_k+1] — -1 past each row's stop, new keys,
    cache)``. Live cursors land at ``fill + emitted``; ride-along rows
    stay parked."""
    dev = model.device
    w = spec_k + 1
    noise = any_sampling(temps, live)
    cur = _as(cur, torch.int64, dev)
    drafts = _as(drafts, torch.int64, dev)
    live = _as(live, torch.bool, dev)
    park = _as(park, torch.int64, dev)
    eos_ids = _as(eos_ids, torch.int64, dev)
    rem = _as(remaining, torch.int64, dev)
    temps = _as(temps, torch.float32, dev)
    top_ks = _as(top_ks, torch.int64, dev)
    n = cur.shape[0]
    start = torch.where(live, cache["block_0"]["idx"], park)
    chunk = torch.cat([cur[:, None], drafts], dim=1)
    # the pages ARE the batch (every slot rides along): the chunk writes
    # each column at its absolute position (dropped past the page end)
    # before attention reads it
    sub = {name: {"k": page["k"], "v": page["v"], "idx": start}
           for name, page in cache.items()}
    logits = model.forward_cached(chunk, sub, chunked=True)   # [n, w, V]
    nxt_draft = torch.cat([drafts, torch.full((n, 1), -1, dtype=torch.int64,
                                              device=dev)], dim=1)
    alive = live
    accepting = live
    m = torch.zeros(n, dtype=torch.int64, device=dev)
    outs = []
    for j in range(w):
        s, keys2 = sample_tokens(logits[:, j], keys, temps, top_ks, noise)
        emit = accepting & alive
        # only emitting rows consume a draw
        keys = torch.where(emit[:, None], keys2, keys)
        rem = rem - emit.long()
        hit_eos = (s == eos_ids) & (eos_ids >= 0)
        alive = alive & ~(emit & (hit_eos | (rem <= 0)))
        accepting = accepting & alive & (j < w - 1) & (s == nxt_draft[:, j])
        outs.append(torch.where(emit, s, torch.full_like(s, -1)))
        m = m + emit.long()
    idx = torch.where(live, start + m, park)
    for page in cache.values():
        page["idx"] = idx
    return torch.stack(outs, dim=1), keys, cache


class DraftStep:
    """The draft model's dispatches and raw pages (never int8 — the
    draft's logits only pick how far a round advances). Mirrors the
    target's admission writes (:meth:`mirror_prefill` /
    :meth:`mirror_chunk`, logits discarded) and runs the proposal
    (:meth:`propose`). Serves a :func:`compute_copy` snapshot of
    ``model``, which must live on ``device``."""

    def __init__(self, model, n_slots: int, capacity: int, *, device):
        if model.device.type != torch.device(device).type:
            raise ValueError(f"draft model lives on {model.device}, the "
                             f"serving step on {device}")
        self.device = torch.device(device)
        self.model = compute_copy(model)
        self.n_slots = int(n_slots)
        self.capacity = int(capacity)
        self.cache = init_cache(self.model, self.n_slots, self.capacity)

    def mirror_prefill(self, tokens, lengths, slot_ids) -> None:
        """Write a monolithic prefill cohort's prompts into the draft
        pages (the target samples; the draft's logits are discarded)."""
        prefill_apply(self.model, self.cache, tokens, lengths, slot_ids)

    def mirror_chunk(self, tokens, starts, valid, slot_ids) -> None:
        """Chunked twin of :meth:`mirror_prefill`."""
        prefill_chunk_apply(self.model, self.cache, tokens, starts, valid,
                            slot_ids)

    def propose(self, prev, cur, valid, starts, keys, temps, top_ks,
                live, park, spec_k: int):
        """One proposal dispatch (see :func:`propose_apply`) → drafts
        ``[n, spec_k]`` on the device."""
        drafts, self.cache = propose_apply(
            self.model, self.cache, prev, cur, valid, starts, keys, temps,
            top_ks, live, park, int(spec_k))
        return drafts

    def load_params(self, state_dict) -> None:
        """Swap draft weights (cast to the snapshot's dtypes)."""
        self.model.load_state_dict(state_dict)

    def reset(self) -> None:
        self.cache = init_cache(self.model, self.n_slots, self.capacity)


class SpeculativeEngine(Engine):
    """The continuous-batching engine with speculative rounds replacing
    ``decode_k`` dispatches. Scheduling, admission, chunked prefill,
    token budgets, holds, and exports are inherited — a round reserves
    ``spec_k + 1`` cache columns a slot (:meth:`_max_decode_advance`),
    and the admission hooks mirror every prompt write into the draft
    pages, so the draft is always one token behind the target.

    ``config.decode_k`` is ignored: the verify width is ``spec_k + 1``.
    Works with raw or int8-block target pages (``config.kv_dtype``).
    Exports read target state only, so a speculative replica hands off
    to any engine; imports mirror the adopted prefix into the draft
    pages in fixed-width chunks before the next round."""

    #: draft-prefix mirror chunk width for imports when the engine is
    #: not running chunked prefill
    _IMPORT_MIRROR_CHUNK = 32

    def __init__(self, model, draft_model,
                 config: EngineConfig = EngineConfig(), *,
                 spec_k: int = 4, device=None, report=None, time_fn=None,
                 weights_version: Optional[str] = None):
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        super().__init__(model, config, device=device, report=report,
                         time_fn=time_fn, weights_version=weights_version)
        if draft_model.vocab != model.vocab:
            raise ValueError(
                f"draft vocab {draft_model.vocab} != target vocab "
                f"{model.vocab} — proposals would not be sampleable "
                "by the target")
        self.spec_k = int(spec_k)
        self.draft = DraftStep(draft_model, config.n_slots, config.capacity,
                               device=self.device)
        n = config.n_slots
        # full-accept bookkeeping: after a round that emitted spec_k + 1
        # tokens, the bonus token was never written to the draft pages —
        # the next catch-up chunk is width 2
        self._spec_full = np.zeros(n, bool)
        self._spec_prev = np.zeros(n, np.int64)

    # -- scheduling integration ---------------------------------------

    def _max_decode_advance(self) -> int:
        return self.spec_k + 1

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               **kwargs):
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        budget = (max_new_tokens if max_new_tokens is not None
                  else self.config.max_new_tokens)
        if prompt_arr.size + budget + self.spec_k > self.config.capacity:
            raise ValueError(
                "speculative decode forbids ring wrap: prompt "
                f"({prompt_arr.size}) + max_new_tokens ({budget}) + "
                f"spec_k ({self.spec_k}) exceeds the page capacity "
                f"({self.config.capacity}) — the verify chunk and the "
                "draft pages both need the absolute-position no-wrap "
                "margin")
        return super().submit(prompt, max_new_tokens, **kwargs)

    def _install(self, req, slot: int) -> None:
        super()._install(req, slot)
        self._spec_full[slot] = False
        self._spec_prev[slot] = 0

    def _on_prefill(self, tokens, lengths, slot_ids) -> None:
        self.draft.mirror_prefill(tokens, lengths, slot_ids)

    def _on_prefill_chunk(self, tokens, starts, valid, slot_ids,
                          final) -> None:
        self.draft.mirror_chunk(tokens, starts, valid, slot_ids)

    def import_handoff(self, handoff: dict, prompt,
                       max_new_tokens: Optional[int] = None):
        req = super().import_handoff(handoff, prompt,
                                     max_new_tokens=max_new_tokens)
        if req.slot is not None:    # terminal handoffs retired already
            if (req.prompt.size + req.max_new_tokens + self.spec_k
                    > self.config.capacity):
                self._retire(req, aborted=True)
                raise ValueError(
                    "adopted session does not fit the speculative "
                    f"no-wrap margin (prompt {req.prompt.size} + budget "
                    f"{req.max_new_tokens} + spec_k {self.spec_k} > "
                    f"capacity {self.config.capacity})")
            # the draft pages must hold the adopted stream's positions
            # [0, fill) before the next round's catch-up
            prefix = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
            self._mirror_prefix(req.slot, prefix)
            self._spec_full[req.slot] = False
            self._spec_prev[req.slot] = 0
        return req

    def _mirror_prefix(self, slot: int, prefix: np.ndarray) -> None:
        c = self.config.prefill_chunk or min(self._IMPORT_MIRROR_CHUNK,
                                             self.config.capacity)
        pos = 0
        while pos < prefix.size:
            v = int(min(c, prefix.size - pos))
            tokens = np.zeros((1, c), np.int64)
            tokens[0, :v] = prefix[pos:pos + v]
            self.draft.mirror_chunk(
                tokens, np.array([pos], np.int64),
                np.array([v], np.int64), np.array([slot], np.int64))
            pos += v

    # -- the speculative round ----------------------------------------

    def _verify(self, cur, drafts, remaining, live, park):
        steps = self.steps
        w = self.spec_k + 1
        view = unpack_cache(steps.cache)
        start = torch.where(_as(live, torch.bool, self.device),
                            view["block_0"]["idx"],
                            _as(park, torch.int64, self.device))
        emitted, keys, view = verify_apply(
            steps.model, view, cur, drafts, self._keys, self._temps,
            self._topks, self._eos, remaining, live, park, self.spec_k)
        # the chunk DROPS columns past the page end (never wraps), so the
        # int8 commit window stops there too
        count = torch.clamp(steps.capacity - start, 0, w)
        steps.cache = repack_cache(steps.cache, view, start, count, w)
        return emitted, keys

    def _decode(self) -> int:
        """One speculative ROUND for the whole grid (propose + verify,
        two dispatches) in place of the base engine's one ``decode_k``
        dispatch; the host pulls a single ``[n_slots, spec_k + 1]``
        integer array and replays the device's emissions."""
        cfg = self.config
        n = cfg.n_slots
        w = self.spec_k + 1
        live = np.zeros(n, bool)
        remaining = np.ones(n, np.int64)
        fills = np.zeros(n, np.int64)
        for slot, req in self.active.items():
            live[slot] = True
            remaining[slot] = req.max_new_tokens - len(req.tokens)
            fills[slot] = req.prompt.size + len(req.tokens) - 1
        park = np.zeros(n, np.int64)
        for slot, req in self.prefilling.items():
            park[slot] = req.prefill_pos
        for slot, req in self.held.items():
            park[slot] = req.prompt.size + len(req.tokens) - 1
        valid = np.where(live & self._spec_full, 2, 1).astype(np.int64)
        starts = np.where(live, fills - (valid - 1), park)
        drafts = self.draft.propose(
            self._spec_prev, self.cur_tokens, valid, starts, self._keys,
            self._temps, self._topks, live, park, self.spec_k)
        emitted_dev, self._keys = self._verify(
            self.cur_tokens, drafts, remaining, live, park)
        toks = emitted_dev.cpu().numpy()    # the round's ONLY host pull
        self.report.record_host_bytes(toks.nbytes)
        emitted = 0
        for slot, req in list(self.active.items()):
            m = 0
            for j in range(w):
                t = int(toks[slot, j])
                if t < 0:
                    break
                self._emit(req, t)
                m += 1
                emitted += 1
                if req.finished:
                    break
            # the round's last token is always target-sampled
            # (correction, bonus, or terminal) → accepted = m - 1
            self.report.record_spec_round(self.spec_k, max(m - 1, 0), m)
            self._spec_full[slot] = m == w
            if m == w:
                self._spec_prev[slot] = int(toks[slot, w - 2])
        return emitted
