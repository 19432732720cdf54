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

Not ported yet: handoff and session export/import, ``swap_weights`` and
the chaos hook.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.serving.reports import ServingReport
from chainermn_torch.serving.sampling import init_keys, request_key

__all__ = ["Engine", "EngineConfig", "Request", "default_buckets"]


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
    state: str = "queued"             # queued|running|done|aborted
    slot: Optional[int] = None
    prefill_pos: int = 0              # chunked prefill: tokens written

    @property
    def finished(self) -> bool:
        return self.state in ("done", "aborted")


class Engine:
    """Single-threaded scheduler core: ``submit()`` queues, ``step()``
    advances one iteration, ``run_until_drained()`` loops until idle.
    ``model`` must already live on ``device`` (default ``cuda``)."""

    def __init__(self, model, config: EngineConfig = EngineConfig(), *,
                 device=None, report: Optional[ServingReport] = None,
                 time_fn=None):
        self.config = config
        if config.decode_k < 1:
            raise ValueError("decode_k must be >= 1")
        if config.prefill_chunk is not None and config.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.steps = ServingStep(model, config.n_slots, config.capacity,
                                 cache_dtype=config.cache_dtype,
                                 device=device)
        self.device = self.steps.device
        self.report = report or (ServingReport(time_fn) if time_fn
                                 else ServingReport())
        self.queue: deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot → decoding
        self.prefilling: Dict[int, Request] = {}      # slot → mid-chunk
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
               top_k: Optional[int] = None, seed: int = 0) -> Request:
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
        req = Request(request_id=next(self._ids), prompt=prompt,
                      max_new_tokens=budget, eos_id=eos_id,
                      temperature=temperature, top_k=top_k, seed=seed)
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
            self._retire(req)
        elif req.slot is not None:
            self.cur_tokens[req.slot] = token

    def _retire(self, req: Request, aborted: bool = False) -> None:
        req.state = "aborted" if aborted else "done"
        if req.slot is not None:
            self.free_slots.append(req.slot)
            self.active.pop(req.slot, None)
            self.prefilling.pop(req.slot, None)
            req.slot = None
        self.report.record_retire(req.request_id, aborted=aborted)

    # ----------------------------------------------------------------
    # scheduler iterations
    # ----------------------------------------------------------------

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
                if r.prefill_pos + cfg.decode_k > self.steps.capacity)
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
        """One scheduler iteration: token budget → prefill (chunked or
        monolithic) → decode_k → retirement."""
        self.iteration += 1
        budget = self.config.token_budget
        avail = (float("inf") if budget is None
                 else budget - len(self.active) * self.config.decode_k)
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
            self.step()
            n += 1
        return n
