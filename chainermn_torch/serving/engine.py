"""Continuous-batching engine: iteration-level scheduling over the paged
KV cache.

Counterpart of ``chainermn_tpu/serving/engine.py``'s ``Engine``,
``EngineConfig`` and ``Request``. Every ``step()`` is one scheduler
iteration under an optional per-iteration token budget:

1. **Prefill** — one monolithic same-bucket cohort (up to
   ``prefill_cohort`` prompts right-padded to the bucket length, sentinel
   rows filling the fixed shape) or, with ``prefill_chunk`` set, fixed
   ``[S, C]`` prompt chunks written at each slot's cursor.
2. **Decode** — one ``decode_k`` dispatch advances every live slot up to
   ``k`` tokens with sampling on the device; the host pulls one
   ``[n_slots, k]`` integer array.
3. **Retirement** — slots whose request emitted ``eos_id`` or reached its
   budget are freed.

Each step starts with the chaos hook (``resilience/chaos.py``
``on_step``, the JAX engine's). Requests submitted with ``hold=True``
park in ``held`` at their end, slot and pages intact, for
``export_handoff`` (the prefill side of a disaggregated fleet); a
decoding request freezes with ``export_session``; ``import_handoff`` and
``import_session`` adopt either on another engine, and the stream goes
on as it would have on the exporting one. ``swap_weights`` installs new
weights on a drained engine, and ``weights_version`` fences handoffs
minted under other weights (:class:`WeightsVersionSkew`).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chainermn_torch.resilience import chaos
from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.serving.reports import ServingReport
from chainermn_torch.serving.sampling import init_keys, request_key

__all__ = ["Engine", "EngineConfig", "Request", "WeightsVersionSkew",
           "default_buckets"]


class WeightsVersionSkew(ValueError):
    """A handoff/session was minted under a different weights version
    than this engine serves. Adoption is REFUSED — continuing a
    prefill-v2 stream on a decode-v1 replica would silently mix model
    versions inside one output; the caller re-prefills the stream or
    replays it from its seed, so it stays one version."""


def default_buckets(capacity: int, lo: int = 8) -> Tuple[int, ...]:
    """Power-of-two bucket table up to the page capacity."""
    out = []
    b = lo
    while b < capacity:
        out.append(b)
        b *= 2
    out.append(capacity)
    return tuple(out)


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    capacity: int = 256
    max_new_tokens: int = 64          # default per-request budget
    prefill_cohort: int = 2           # S — cohort width (fixed shape)
    buckets: Optional[Sequence[int]] = None  # None → default_buckets()
    cache_dtype: Optional[torch.dtype] = None
    decode_k: int = 4                 # tokens per decode dispatch
    prefill_chunk: Optional[int] = None  # chunk width C; None → monolithic
    token_budget: Optional[int] = None   # per-iteration budget; None → ∞
    max_prefill_defer: int = 4        # iterations prefill may yield
    kv_dtype: Optional[str] = None    # page storage: None/'f32' (the
    #                                   cache dtype) or 'int8-block' (no
    #                                   ring wrap: submit enforces
    #                                   prompt + max_new <= capacity)

    def bucket_table(self) -> Tuple[int, ...]:
        return (tuple(sorted(self.buckets)) if self.buckets
                else default_buckets(self.capacity))


@dataclasses.dataclass(eq=False)   # identity semantics (prompt is an array)
class Request:
    """One generation stream; ``tokens`` grows as the engine emits.
    ``temperature`` ``None``/``0`` → greedy, ``top_k`` ``None``/``0`` →
    full vocabulary, ``seed`` keys the slot's random stream."""
    request_id: int
    prompt: np.ndarray                # int32 [L]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"             # queued|running|held|done|aborted
    slot: Optional[int] = None
    prefill_pos: int = 0              # chunked prefill: tokens written
    hold: bool = False                # retire → 'held' (slot kept bound
    #                                   for export_handoff)

    @property
    def finished(self) -> bool:
        return self.state in ("done", "aborted")


class Engine:
    """Single-threaded scheduler core: ``submit()`` queues, ``step()``
    advances one iteration, ``run_until_drained()`` loops until idle.
    ``model`` must already live on ``device`` (default ``cuda``). The
    engine serves a snapshot of its weights taken at construction; later
    updates reach it only through :meth:`swap_weights` (or
    ``engine.steps.load_params``). ``mesh``/``axis`` give head-sharded
    pages (:class:`~chainermn_torch.serving.kv_cache.ServingStep`); the
    engine is then SPMD: every rank is given the same requests in the
    same order, and every rank emits the same tokens."""

    def __init__(self, model, config: EngineConfig = EngineConfig(), *,
                 device=None, mesh=None, axis: Optional[str] = None,
                 report: Optional[ServingReport] = None,
                 time_fn=None, weights_version: Optional[str] = None):
        self.config = config
        #: which published weights this engine serves (None: unversioned,
        #: every skew check passes)
        self.weights_version = weights_version
        if config.decode_k < 1:
            raise ValueError("decode_k must be >= 1")
        if config.prefill_chunk is not None and config.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.steps = ServingStep(model, config.n_slots, config.capacity,
                                 cache_dtype=config.cache_dtype,
                                 device=device, kv_dtype=config.kv_dtype,
                                 mesh=mesh, axis=axis)
        self.device = self.steps.device
        self.report = report or (ServingReport(time_fn) if time_fn
                                 else ServingReport())
        self.queue: deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot → decoding
        self.prefilling: Dict[int, Request] = {}      # slot → mid-chunk
        self.held: Dict[int, Request] = {}            # slot → awaiting
        #                                               export (handoff)
        self.free_slots: List[int] = list(range(config.n_slots))
        self.cur_tokens = np.zeros(config.n_slots, np.int64)
        # per-slot sampling state (sampling.py encoding)
        self._keys = init_keys(config.n_slots, self.device)
        self._temps = np.zeros(config.n_slots, np.float32)
        self._topks = np.zeros(config.n_slots, np.int64)
        self._eos = np.full(config.n_slots, -1, np.int64)
        self._prefill_defer = 0
        self.iteration = 0
        self._ids = itertools.count()
        self._buckets = config.bucket_table()
        if self._buckets[-1] < config.capacity:
            raise ValueError("largest bucket must reach capacity")

    @property
    def last_logits(self) -> Optional[np.ndarray]:
        """Final decode-step logits ``[n_slots, vocab]``, pulled from the
        device only when read (a debug and parity hook)."""
        dev = self.steps.last_decode_logits
        return None if dev is None else dev.cpu().numpy()

    # ----------------------------------------------------------------
    # request lifecycle
    # ----------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, seed: int = 0,
               hold: bool = False) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if self.config.prefill_chunk is not None:
            if prompt.size > self.config.capacity:
                raise ValueError(
                    f"prompt length {prompt.size} exceeds the page "
                    f"capacity ({self.config.capacity})")
        elif prompt.size > self._buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest prefill "
                f"bucket ({self._buckets[-1]})")
        budget = (max_new_tokens if max_new_tokens is not None
                  else self.config.max_new_tokens)
        if (self.steps.kv_dtype == "int8-block"
                and prompt.size + budget > self.config.capacity):
            raise ValueError(
                f"int8-block pages forbid ring wrap: prompt ({prompt.size})"
                f" + max_new_tokens ({budget}) exceeds the page capacity "
                f"({self.config.capacity})")
        req = Request(request_id=next(self._ids), prompt=prompt,
                      max_new_tokens=budget, eos_id=eos_id,
                      temperature=temperature, top_k=top_k, seed=seed,
                      hold=hold)
        self.queue.append(req)
        self.report.record_submit(req.request_id)
        return req

    def _bucket_for(self, length: int) -> int:
        for b in self._buckets:
            if b >= length:
                return b
        raise ValueError(f"no bucket covers prompt length {length}")

    def _install(self, req: Request, slot: int) -> None:
        """Bind a request to a slot: sampling rows + random key."""
        req.slot = slot
        req.state = "running"
        self._temps[slot] = (req.temperature
                             if req.temperature is not None else 0.0)
        self._topks[slot] = req.top_k if req.top_k is not None else 0
        self._eos[slot] = req.eos_id if req.eos_id is not None else -1
        self._keys[slot] = request_key(req.seed, self.device)

    def _emit(self, req: Request, token: int) -> None:
        req.tokens.append(int(token))
        self.report.record_token(req.request_id)
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            if req.hold:
                self._hold(req)
            else:
                self._retire(req)
        elif req.slot is not None:
            self.cur_tokens[req.slot] = token

    def _retire(self, req: Request, aborted: bool = False) -> None:
        req.state = "aborted" if aborted else "done"
        if req.slot is not None:
            self.free_slots.append(req.slot)
            self.active.pop(req.slot, None)
            self.prefilling.pop(req.slot, None)
            self.held.pop(req.slot, None)
            req.slot = None
        self.report.record_retire(req.request_id, aborted=aborted)

    def _hold(self, req: Request) -> None:
        """Terminal-by-budget request parks in 'held' instead of
        retiring: the slot stays bound (its KV rows, cursor, and PRNG
        key intact) until ``export_handoff`` + ``release_held`` — the
        prefill side of a disaggregated fleet. The release may wait until
        the handoff's transport reports a terminal status, so a slot may
        stay held across many engine steps while its bytes are in flight
        — ``export_handoff`` is a pure read precisely so that window is
        harmless."""
        req.state = "held"
        self.active.pop(req.slot, None)
        self.prefilling.pop(req.slot, None)
        self.held[req.slot] = req

    def release_held(self, req: Request, aborted: bool = False) -> None:
        """Free a held request's slot (after ``export_handoff`` reached
        a terminal outcome — adopted by a peer, or abandoned)."""
        if req.state != "held" or self.held.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not held by this engine")
        self._retire(req, aborted=aborted)

    def abort_held(self, req: Request) -> None:
        """Release a held slot whose handoff could NOT be delivered
        (transport attempt budget exhausted): the slot frees cleanly,
        the retire is counted as an abort, and the receiver's clean
        re-prefill owns the stream from here — this engine must not
        keep decoding it."""
        self.release_held(req, aborted=True)

    def export_handoff(self, req: Request) -> dict:
        """Package a HELD request's device state for a decode replica:
        per-block KV rows up to the real fill level, the cursor, the
        post-sampling PRNG key row, the emitted tokens, and the sampling
        knobs. Pages are host numpy rows (``ServingStep.export_slot``);
        the key row is this package's ``(seed, counter)`` encoding.
        Raw-page round trips are bitwise, so the importing engine
        continues the exact stream."""
        if req.state != "held" or self.held.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not held by this engine")
        slot = req.slot
        # every emitted token except the newest has been written into
        # the cache (the newest is the decode input still in flight)
        fill = int(req.prompt.size + len(req.tokens) - 1)
        return {
            "pages": self.steps.export_slot(slot, fill),
            "cursor": fill,
            "tokens": list(req.tokens),
            "key": self._keys[slot].cpu().numpy(),
            "prompt_len": int(req.prompt.size),
            "eos_id": req.eos_id,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "seed": req.seed,
            "weights_version": self.weights_version,
            # the handoff codec's cue: these f32 rows were widened from
            # bf16 pages and cross the wire as bf16 (never in a manifest)
            "page_dtype": ("bfloat16"
                           if (self.steps.cache_dtype == torch.bfloat16
                               and self.steps.kv_dtype != "int8-block")
                           else None),
        }

    def export_session(self, req: Request) -> dict:
        """Freeze an ACTIVELY DECODING request at its current token
        boundary and package it for another engine — the decode→decode
        generalization of ``export_handoff``. The slot moves to 'held'
        (decode stops advancing it; ``_decode``'s park pins its cursor),
        so the exported KV rows, PRNG key row, and token history are a
        consistent snapshot no matter how many steps run while the
        bytes are in flight. The dict is ``export_handoff``'s plus the
        remaining-budget field ``max_new_tokens``; ``import_session``
        on the adopting engine continues the stream BITWISE (raw wire),
        because the per-slot key already consumed exactly one split per
        sampled token. Terminal outcomes mirror the prefill conveyor:
        ``release_held`` after the peer adopts, ``abort_held`` if the
        transport gives up (the stream then replays from seed), or
        ``resume_session`` to keep decoding here."""
        if req.state == "held" and self.held.get(req.slot) is req:
            raise ValueError(
                f"request {req.request_id} is a held prefill-handoff "
                "slot — migrate it with export_handoff (the "
                "prefill→decode conveyor); export_session moves "
                "actively DECODING slots")
        if req.slot is not None and self.prefilling.get(req.slot) is req:
            raise ValueError(
                f"request {req.request_id} is mid-prefill — a "
                "partially written slot cannot migrate; let prefill "
                "finish (first token sampled) or re-queue the request "
                "on the destination")
        if req.slot is None or self.active.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not actively decoding on "
                f"this engine (state={req.state!r})")
        self.active.pop(req.slot)
        req.state = "held"
        self.held[req.slot] = req
        out = self.export_handoff(req)
        out["max_new_tokens"] = int(req.max_new_tokens)
        return out

    def resume_session(self, req: Request) -> None:
        """Un-freeze a session ``export_session`` held: the slot's KV
        rows, cursor, key, and sampling rows never moved, so decoding
        continues here exactly where it stopped (the migration was
        abandoned before the destination adopted)."""
        if req.state != "held" or self.held.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not held by this engine")
        hit_eos = (req.eos_id is not None and req.tokens
                   and req.tokens[-1] == req.eos_id)
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            raise ValueError(
                f"request {req.request_id} is terminal (a prefill-hold "
                "park, not a frozen session) — release_held it")
        del self.held[req.slot]
        req.state = "running"
        self.active[req.slot] = req
        self.cur_tokens[req.slot] = req.tokens[-1]

    def import_session(self, session: dict, prompt) -> Request:
        """Adopt a migrated decode session (``export_session``'s dict,
        or its wire-decoded form). The per-request budget
        travels IN the session — the continued stream stops exactly
        where the unmigrated one would have."""
        if "max_new_tokens" not in session:
            raise ValueError(
                "not a decode-session export (no max_new_tokens) — "
                "prefill handoffs are adopted with import_handoff")
        return self.import_handoff(
            session, prompt,
            max_new_tokens=int(session["max_new_tokens"]))

    def import_handoff(self, handoff: dict, prompt,
                       max_new_tokens: Optional[int] = None) -> Request:
        """Adopt an exported slot: bind a free slot, write the KV rows
        and cursor, restore the PRNG key and sampling rows, and resume
        decoding from the handed-off last token. The resumed stream is
        bitwise-identical to the exporting engine continuing (raw wire
        format) — the disaggregation contract bench.py gates."""
        if not self.free_slots:
            raise RuntimeError("no free slot to import a handoff into")
        hv = handoff.get("weights_version")
        if (hv is not None and self.weights_version is not None
                and hv != self.weights_version):
            raise WeightsVersionSkew(
                f"handoff was minted under weights {hv!r} but this "
                f"engine serves {self.weights_version!r} — refusing "
                "the adoption (fall back to a clean re-prefill / "
                "replay-from-seed so the stream stays one version)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size != int(handoff["prompt_len"]):
            raise ValueError(
                f"handoff prompt_len {handoff['prompt_len']} does not "
                f"match the supplied prompt ({prompt.size})")
        if not handoff["tokens"]:
            raise ValueError("handoff carries no sampled token")
        req = Request(
            request_id=next(self._ids), prompt=prompt,
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens),
            eos_id=handoff["eos_id"], temperature=handoff["temperature"],
            top_k=handoff["top_k"], seed=handoff["seed"],
            tokens=list(handoff["tokens"]), state="running")
        self.report.record_submit(req.request_id)
        slot = self.free_slots.pop(0)
        req.slot = slot
        self._temps[slot] = (req.temperature
                             if req.temperature is not None else 0.0)
        self._topks[slot] = req.top_k if req.top_k is not None else 0
        self._eos[slot] = req.eos_id if req.eos_id is not None else -1
        # the handed-off key CONTINUES the stream (one draw consumed
        # per sampled token so far) — never re-derive from the seed
        self._keys[slot] = torch.as_tensor(
            np.array(handoff["key"], np.int64), device=self.device)
        # a wire-decoded handoff from an int8-resident source carries
        # the verbatim codes next to the dequantized pages — an int8
        # destination adopts those bytes directly (zero extra
        # quantization error)
        pages = handoff["pages"]
        if (self.steps.kv_dtype == "int8-block"
                and handoff.get("pages_q8")):
            pages = handoff["pages_q8"]
        self.steps.import_slot(slot, pages, int(handoff["cursor"]))
        last = req.tokens[-1]
        hit_eos = req.eos_id is not None and last == req.eos_id
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self._retire(req)              # already terminal at handoff
        else:
            self.cur_tokens[slot] = last
            self.active[slot] = req
        return req

    def abort_all(self, requeue: bool = False) -> List[Request]:
        """Watchdog-bounded teardown: every in-flight request aborts (or
        requeues for a warm restart) and every queued request drains back
        to the caller. Returns the affected requests."""
        hit = []
        inflight = (list(self.active.values())
                    + list(self.prefilling.values())
                    + list(self.held.values()))
        for req in inflight:
            if requeue:
                req.state = "queued"
                req.tokens = []
                req.prefill_pos = 0
                if req.slot is not None:
                    self.free_slots.append(req.slot)
                    self.active.pop(req.slot, None)
                    self.prefilling.pop(req.slot, None)
                    self.held.pop(req.slot, None)
                    req.slot = None
                self.queue.appendleft(req)
            else:
                self._retire(req, aborted=True)
            hit.append(req)
        if not requeue:
            while self.queue:
                req = self.queue.popleft()
                req.state = "aborted"
                self.report.record_retire(req.request_id, aborted=True)
                hit.append(req)
        return hit

    def swap_weights(self, params, weights_version: Optional[str] = None,
                     *, converted: bool = False):
        """Install new weights (a model state dict) on a QUIESCENT engine
        (the swap leg of a rolling update). Refused while any request is
        queued, decoding, prefilling, or held: a mid-stream weight change
        would mix model versions inside one output. Drain first, swap,
        then readmit. The pages are not touched.

        Returns ``(old_params, old_version)`` — the previous weights as
        the engine's INTERNAL state dict (a copy of the served snapshot,
        in its compute dtypes), so a failed rollout can walk this
        replica back with ``swap_weights(old_params, old_version,
        converted=True)``. ``converted=True`` loads such a dict as it is;
        otherwise ``params`` is the caller's model state dict, cast as
        ``ServingStep.load_params`` casts."""
        if self.queue or self.active or self.prefilling or self.held:
            raise RuntimeError(
                "swap_weights requires a drained engine — "
                f"{len(self.queue)} queued, {len(self.active)} active, "
                f"{len(self.prefilling)} prefilling, "
                f"{len(self.held)} held")
        old_params = {k: v.detach().clone()
                      for k, v in self.steps.model.state_dict().items()}
        old_version = self.weights_version
        if converted:
            self.steps.model.load_state_dict(params)
        else:
            self.steps.load_params(params)
        self.weights_version = weights_version
        return old_params, old_version

    # ----------------------------------------------------------------
    # scheduler iterations
    # ----------------------------------------------------------------

    def _max_decode_advance(self) -> int:
        """Cache columns one decode iteration may write per slot — the
        wrap guard's and token budget's reservation unit. The base
        engine advances ``decode_k``; ``speculative.SpeculativeEngine``
        overrides this with its verify width (``spec_k + 1``)."""
        return self.config.decode_k

    def _on_prefill(self, tokens, lengths, slot_ids) -> None:
        """Subclass hook, fired after every monolithic prefill dispatch
        with the cohort's host-side arrays (sentinel rows included).
        ``SpeculativeEngine`` mirrors the prompts into the draft model's
        pages here; the base engine does nothing."""

    def _on_prefill_chunk(self, tokens, starts, valid, slot_ids,
                          final) -> None:
        """Chunked twin of :meth:`_on_prefill` — fired after every
        chunk dispatch with that dispatch's host-side arrays."""

    def _admit(self, avail: float) -> int:
        """One monolithic prefill cohort: same-bucket FIFO prompts into
        free slots, first token sampled on the device."""
        if not self.queue or not self.free_slots:
            return 0
        s = self.config.prefill_cohort
        bucket = self._bucket_for(self.queue[0].prompt.size)
        if (bucket > avail and self.active
                and self._prefill_defer < self.config.max_prefill_defer):
            self._prefill_defer += 1
            return 0
        self._prefill_defer = 0
        cohort: List[Request] = []
        while (self.queue and self.free_slots and len(cohort) < s
               and self._bucket_for(self.queue[0].prompt.size) == bucket):
            req = self.queue.popleft()
            self._install(req, self.free_slots.pop(0))
            self.active[req.slot] = req
            cohort.append(req)
        tokens = np.zeros((s, bucket), np.int64)
        lengths = np.ones(s, np.int64)          # sentinel rows: length 1
        slot_ids = np.full(s, self.steps.n_slots, np.int64)  # sentinel
        for i, req in enumerate(cohort):
            tokens[i, :req.prompt.size] = req.prompt
            lengths[i] = req.prompt.size
            slot_ids[i] = req.slot
        tok, self._keys = self.steps.prefill_sampled(
            tokens, lengths, slot_ids, self._keys, self._temps, self._topks)
        self._on_prefill(tokens, lengths, slot_ids)
        first = tok.cpu().numpy()               # [S] ids, never logits
        self.report.record_host_bytes(first.nbytes)
        for i, req in enumerate(cohort):
            self._emit(req, int(first[i]))
        return len(cohort)

    def _advance_prefill_chunks(self, avail: float) -> int:
        """Chunked prefill: spend the iteration's leftover budget on
        chunk cohorts — in-flight prefills first (oldest first), fresh
        admissions filling the rest. The wrap guard (a prefilling slot
        within ``decode_k`` of the page end finishes first) and the
        livelock guard (one cohort runs if nothing else can) beat the
        budget."""
        cfg = self.config
        c = cfg.prefill_chunk
        s = cfg.prefill_cohort
        admitted = 0
        spent = 0
        dispatched = False
        while True:
            forced = sorted(
                slot for slot, r in self.prefilling.items()
                if (r.prefill_pos + self._max_decode_advance()
                    > self.steps.capacity))
            if not forced:
                if not (self.prefilling
                        or (self.queue and self.free_slots)):
                    break
                if dispatched and cfg.token_budget is None:
                    break       # unbudgeted: one cohort per iteration
                over = spent + c > avail
                starved = self._prefill_defer >= cfg.max_prefill_defer
                if over and not starved and (self.active or dispatched):
                    self._prefill_defer += 1
                    break
            cohort = [(slot, self.prefilling[slot]) for slot in forced[:s]]
            for slot, req in sorted(self.prefilling.items(),
                                    key=lambda kv: kv[1].request_id):
                if len(cohort) >= s:
                    break
                if all(slot != s0 for s0, _ in cohort):
                    cohort.append((slot, req))
            while len(cohort) < s and self.queue and self.free_slots:
                req = self.queue.popleft()
                slot = self.free_slots.pop(0)
                self._install(req, slot)
                self.prefilling[slot] = req
                admitted += 1
                cohort.append((slot, req))
            if not cohort:
                break
            self._prefill_defer = 0
            spent += len(cohort) * c
            self._dispatch_chunk(cohort)
            dispatched = True
        return admitted

    def _dispatch_chunk(self, cohort) -> None:
        """One fixed-shape ``[S, C]`` chunk dispatch; completing rows
        sample their first token and move to decode."""
        c = self.config.prefill_chunk
        s = self.config.prefill_cohort
        tokens = np.zeros((s, c), np.int64)
        starts = np.zeros(s, np.int64)
        valid = np.ones(s, np.int64)            # sentinel rows: 1 token
        sids = np.full(s, self.steps.n_slots, np.int64)
        final = np.zeros(s, bool)
        for i, (slot, req) in enumerate(cohort):
            pos = req.prefill_pos
            v = min(c, req.prompt.size - pos)
            tokens[i, :v] = req.prompt[pos:pos + v]
            starts[i] = pos
            valid[i] = v
            sids[i] = slot
            final[i] = pos + v == req.prompt.size
        tok, self._keys = self.steps.prefill_chunk(
            tokens, starts, valid, sids, final, self._keys, self._temps,
            self._topks)
        self._on_prefill_chunk(tokens, starts, valid, sids, final)
        first = tok.cpu().numpy()               # [S] ids (-1 = not final)
        self.report.record_host_bytes(first.nbytes)
        for i, (slot, req) in enumerate(cohort):
            req.prefill_pos += int(valid[i])
            if final[i]:
                del self.prefilling[slot]
                self.active[slot] = req
                self._emit(req, int(first[i]))

    def _decode(self) -> int:
        """One ``decode_k`` dispatch for the whole grid; the host pulls a
        single ``[n_slots, k]`` integer array (-1 = no token) and replays
        the device's EOS/budget retirements."""
        cfg = self.config
        n = cfg.n_slots
        live = np.zeros(n, bool)
        remaining = np.ones(n, np.int64)
        for slot, req in self.active.items():
            live[slot] = True
            remaining[slot] = req.max_new_tokens - len(req.tokens)
        park = np.zeros(n, np.int64)
        for slot, req in self.prefilling.items():
            park[slot] = req.prefill_pos
        for slot, req in self.held.items():
            # a held slot's rows await export: pin its cursor to the
            # real fill so the ride-along steps cannot wrap it
            park[slot] = req.prompt.size + len(req.tokens) - 1
        toks_dev, self._keys = self.steps.decode_k(
            self.cur_tokens, self._keys, self._temps, self._topks,
            self._eos, remaining, live, park, cfg.decode_k)
        toks = toks_dev.cpu().numpy()           # the only per-token pull
        self.report.record_host_bytes(toks.nbytes)
        emitted = 0
        for slot, req in list(self.active.items()):
            for j in range(cfg.decode_k):
                t = int(toks[slot, j])
                if t < 0:
                    break
                self._emit(req, t)
                emitted += 1
                if req.finished:
                    break
        return emitted

    def step(self) -> dict:
        """One scheduler iteration: chaos hook → token budget → prefill
        (chunked or monolithic) → decode_k → retirement."""
        chaos.on_step(self.iteration)
        self.iteration += 1
        budget = self.config.token_budget
        avail = (float("inf") if budget is None
                 else budget - len(self.active) * self._max_decode_advance())
        if self.config.prefill_chunk is not None:
            admitted = self._advance_prefill_chunks(avail)
        else:
            admitted = self._admit(avail)
        emitted = self._decode() if self.active else 0
        self.report.record_step(
            len(self.queue),
            (len(self.active) + len(self.prefilling)) / self.config.n_slots)
        return {"admitted": admitted, "emitted": emitted,
                "active": len(self.active), "queued": len(self.queue)}

    def idle(self) -> bool:
        return not self.queue and not self.active and not self.prefilling

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        """Step until no queued or active work remains; returns the
        number of iterations."""
        n = 0
        while not self.idle():
            if n >= max_steps:
                raise RuntimeError(
                    f"engine failed to drain within {max_steps} steps")
            self.step()  # dlint: disable=DL104
            n += 1
        return n
