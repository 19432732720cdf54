"""Disaggregated prefill/decode pools over two serving engines.

Counterpart of ``chainermn_tpu/fleet/pools.py``.

The disaggregation argument (DistServe/Splitwise, PAPERS.md): prefill
is compute-bound and bursty, decode is memory-bandwidth-bound and
steady — co-locating them makes every long prompt a head-of-line stall
for every active decode stream. Here the split is explicit:

* :class:`PrefillPool` owns an engine that runs ``prefill_chunk`` to
  completion with ``max_new_tokens=1, hold=True`` — the first token is
  sampled on device and the finished slot PARKS (``Engine.held``: KV
  rows, cursor, and post-split PRNG key stay bound) instead of
  retiring. The slot stays held until the TRANSPORT reports a terminal
  status for its handoff (deferred release), so an aborted transfer
  can still fall back cleanly.
* :class:`DecodePool` owns an engine that adopts exported slots
  (``Engine.import_handoff``) and decodes them to termination.
* :class:`DisaggregatedFleet` is the conveyor between them. Every held
  prefill slot is exported, serialized through the
  :mod:`~chainermn_torch.fleet.handoff` codec (``wire_format`` — ``f32``
  raw or ``int8-block``), and shipped over a
  :mod:`~chainermn_torch.fleet.transport` — seq-numbered, SHA-verified
  frames with NACK → bounded re-send, the layer the wire-level chaos
  faults (drop/delay/dup/corrupt/truncate) tear at.

Two conveyor disciplines:

* **synchronous** (default) — ``step()`` does export → send → place
  inline; the step thread pays every wire millisecond. Simple, and the
  bitwise reference the async path is checked against.
* **asynchronous** (``async_conveyor=True``) — encode+send move onto a
  bounded worker queue (the ``AsyncSnapshotPlane`` double-buffer
  discipline, checkpointing/async_plane.py) so the wire overlaps
  decode steps. Engine calls — export, release, import — STAY on the
  step thread (the engine is not thread-safe and ``_decode`` iterates
  ``held``); only serialization and transport ride the worker.
  ``backpressure="block"`` stalls the step thread when ``max_pending``
  transfers are queued; ``"skip"`` leaves the slot held and retries
  next step (counted in ``stats["skipped"]``). ``drain(deadline_s=)``
  bounds shutdown; worker errors surface on the next ``step()``.

Contracts the tests pin: raw-format streams are BITWISE-identical to
the single-engine path (export → import is exact f32 bytes and the PRNG
key continues, never re-derives) in BOTH conveyor modes; a handoff the
transport cannot deliver intact within its attempt budget falls back to
a CLEAN re-prefill of the full prompt on the decode engine — same seed,
so the one-split-per-token contract replays the identical stream — and
never a poisoned slot.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from chainermn_torch.device import bind_thread_device, cuda_index_of
from chainermn_torch.fleet.handoff import (HANDOFF_FORMAT_STREAMED,
                                         HandoffError, decode_handoff,
                                         decode_handoff_streamed,
                                         encode_handoff,
                                         encode_handoff_streamed,
                                         streamed_chunk_sid,
                                         streamed_parent_sid,
                                         streamed_wire_bytes)
from chainermn_torch.fleet.reports import FleetReport
from chainermn_torch.fleet.transport import InProcessTransport
from chainermn_torch.serving.engine import WeightsVersionSkew

__all__ = ["Stream", "PrefillPool", "DecodePool", "DisaggregatedFleet",
           "StreamAssembler"]


class Stream:
    """One client stream crossing the prefill→decode boundary. The
    terminal ``tokens`` list is the SAME sequence a single engine's
    ``generate()`` would emit for this prompt/seed (bitwise under the
    raw wire format)."""

    def __init__(self, stream_id: int, prompt, max_new_tokens: int,
                 kw: dict):
        self.stream_id = stream_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.kw = dict(kw)            # eos_id / temperature / top_k / seed
        self.tokens: List[int] = []
        self.state = "queued"         # queued|prefill|decode|done
        self.fell_back = False        # handoff failed → re-prefilled
        self.fallback_reason: Optional[str] = None  # why the wire failed

    @property
    def finished(self) -> bool:
        return self.state == "done"


class PrefillPool:
    """Prefill-side engine wrapper: prompts in, held slots out."""

    def __init__(self, engine):
        self.engine = engine
        self._by_id: Dict[int, Stream] = {}   # request_id → stream

    def submit(self, stream: Stream) -> None:
        req = self.engine.submit(stream.prompt, max_new_tokens=1,
                                 hold=True, **stream.kw)
        self._by_id[req.request_id] = stream
        stream.state = "prefill"

    def depth(self) -> int:
        """Streams submitted here and not yet released — the
        least-depth signal for prefill-pool choice."""
        return len(self._by_id)

    def step(self) -> bool:
        """Advance iff there is prefill work (held slots alone are not
        work — they pin their cursors and wait for export)."""
        if self.engine.idle():
            return False
        self.engine.step()
        return True

    def ready(self) -> List[Tuple[Stream, object]]:
        """Held (stream, request) pairs awaiting export, oldest first."""
        reqs = sorted(self.engine.held.values(),
                      key=lambda r: r.request_id)
        return [(self._by_id[r.request_id], r) for r in reqs]

    def export(self, req) -> dict:
        """Export one held slot (a pure read of device state). The slot
        STAYS held until :meth:`release` — deferred so the conveyor can
        wait for the transport's terminal status and, on an aborted
        transfer, release with the abort accounted."""
        return self.engine.export_handoff(req)

    def release(self, req, aborted: bool = False) -> None:
        """Release a held slot whose handoff reached a terminal
        transport status (``adopted``/``duplicate`` → clean retire;
        ``failed`` → aborted retire, the receiver re-prefills)."""
        if aborted:
            self.engine.abort_held(req)
        else:
            self.engine.release_held(req)
        self._by_id.pop(req.request_id, None)


class DecodePool:
    """Decode-side engine wrapper: adopts handoffs, drains streams."""

    def __init__(self, engine):
        self.engine = engine
        self._inflight: List[Tuple[object, Stream]] = []

    def has_room(self) -> bool:
        return bool(self.engine.free_slots)

    def depth(self) -> int:
        """Streams this pool is currently responsible for — the
        router's least-depth placement signal, applied to decode-pool
        choice in the m×n conveyor."""
        return len(self._inflight)

    def place(self, stream: Stream, handoff: dict) -> None:
        """Adopt a VERIFIED handoff: the imported slot resumes the
        exporting engine's exact stream."""
        req = self.engine.import_handoff(
            handoff, stream.prompt, max_new_tokens=stream.max_new_tokens)
        stream.state = "decode"
        self._inflight.append((req, stream))

    def fallback(self, stream: Stream,
                 reason: Optional[str] = None) -> None:
        """Handoff failed verification or delivery → CLEAN re-prefill
        of the full prompt on this engine. Same seed, so the per-token
        key-split contract replays the identical stream; the suspect
        bytes never touch a slot. ``reason`` is the wire's defect
        history (transport NACK reasons / codec error) so the fallback
        log says WHY, not just that it happened."""
        req = self.engine.submit(stream.prompt,
                                 max_new_tokens=stream.max_new_tokens,
                                 **stream.kw)
        stream.state = "decode"
        stream.fell_back = True
        stream.fallback_reason = reason or "delivery failed"
        self._inflight.append((req, stream))

    def step(self) -> bool:
        worked = False
        if not self.engine.idle():
            self.engine.step()
            worked = True
        still = []
        for req, stream in self._inflight:
            if req.finished:
                stream.tokens = list(req.tokens)
                stream.state = "done"
            else:
                still.append((req, stream))
        self._inflight = still
        return worked


class StreamAssembler:
    """Receiver-side reassembly of streamed (format-5) handoffs.

    Chunk frames ride the transport under their own (negative) stream
    ids — per-frame SHA verify, NACK/re-send, and duplicate fencing all
    apply per chunk — and park here until the closing frame commits the
    stream. ``decode_handoff_streamed`` then proves the set against the
    closing table; a chunk that never survived its delivery budget is
    simply missing at assembly time, which fails verification and
    becomes a clean re-prefill — chunk-level loss can never poison a
    decode slot, and its defect history rides along for the log."""

    def __init__(self) -> None:
        self.chunks: Dict[int, Dict[int, Tuple[dict, bytes]]] = {}
        self.defects: Dict[int, List[str]] = {}

    def add_chunk(self, arrival) -> None:
        """File one chunk arrival under its parent stream."""
        sid, idx = streamed_parent_sid(arrival.stream_id)
        if arrival.failed:
            why = "; ".join(arrival.defects) or "delivery failed"
            self.defects.setdefault(sid, []).append(
                f"chunk {idx}: {why}")
            return
        self.chunks.setdefault(sid, {})[idx] = (arrival.manifest,
                                                arrival.blob)

    def take(self, sid: int) -> Tuple[List[Tuple[dict, bytes]],
                                      List[str]]:
        """Pop everything held for ``sid``: ``(chunks_in_index_order,
        defect_notes)``. Called exactly once per closing frame (or on
        the stream's failure), so fenced streams leave no residue."""
        held = self.chunks.pop(sid, {})
        return ([held[i] for i in sorted(held)],
                self.defects.pop(sid, []))


class DisaggregatedFleet:
    """The conveyor: submit → prefill → handoff transport → decode.

    ``wire_format`` picks the handoff codec (``"f32"`` raw/bitwise,
    ``"int8-block"`` quantized at ~0.254× the wire bytes); ``report``
    accumulates the fleet counters (handoffs, wire bytes by format,
    fallbacks) that ``bench.py``'s fleet gate reads; ``transport``
    defaults to an :class:`~chainermn_torch.fleet.transport.
    InProcessTransport` (pass one with ``wire_delay_ms`` to model DCN
    latency, or wire the pools across processes via
    ``tools/fleet_lm.py --hosts``).

    **m×n pools** — both engine arguments accept a single engine or a
    list. Every prefill pool feeds every decode pool: the destination
    for each handoff is chosen at transfer time by the router's
    least-depth logic over the decode pools, with the saturated-
    survivor precheck — when NO decode pool has a free slot the slot
    stays held (``stats["deferred"]``) instead of shipping bytes that
    would have nowhere to adopt. One transport per decode pool
    (``transport`` may be a matching list); arrivals adopt on the pool
    whose transport delivered them.

    **streamed handoffs** (``streamed=True``) — each handoff ships as
    format-5 per-layer chunk frames plus a closing manifest
    (:func:`~chainermn_torch.fleet.handoff.encode_handoff_streamed`).
    Every chunk is its own transport frame — SHA-verified, NACKed, and
    re-sent independently, so a corrupt chunk costs one chunk's
    re-send — and the receiver's :class:`StreamAssembler` holds them
    until the closing frame proves the set. Any gap fails assembly and
    falls back to a clean re-prefill.

    With ``async_conveyor=True`` the encode+send leg runs on a worker
    thread behind a bounded queue — see the module docstring for the
    threading discipline and backpressure semantics. ``stats`` then
    separates ``stall_ms_total`` (step-thread time lost to the
    conveyor) from ``transfer_ms_total`` (worker wall-time on the
    wire); their ratio is :attr:`overlap_fraction`. The synchronous
    conveyor books every transfer millisecond as stall — by
    construction its overlap is 0.
    """

    _POLL_S = 0.05

    def __init__(self, prefill_engine, decode_engine, *,
                 wire_format: str = "f32",
                 report: Optional[FleetReport] = None,
                 transport=None,
                 async_conveyor: bool = False,
                 max_pending: int = 2,
                 backpressure: str = "block",
                 streamed: bool = False):
        if backpressure not in ("block", "skip"):
            raise ValueError(
                f"backpressure must be 'block' or 'skip': {backpressure!r}")
        pre = (list(prefill_engine)
               if isinstance(prefill_engine, (list, tuple))
               else [prefill_engine])
        dec = (list(decode_engine)
               if isinstance(decode_engine, (list, tuple))
               else [decode_engine])
        if not pre or not dec:
            raise ValueError("need at least one engine per side")
        self.prefills = [PrefillPool(e) for e in pre]
        self.decodes = [DecodePool(e) for e in dec]
        # the 1×1 aliases older callers (and half the tests) use
        self.prefill = self.prefills[0]
        self.decode = self.decodes[0]
        self.wire_format = wire_format
        self.streamed = bool(streamed)
        self.report = report or FleetReport()
        if transport is None:
            self.transports = [InProcessTransport() for _ in self.decodes]
        elif isinstance(transport, (list, tuple)):
            if len(transport) != len(self.decodes):
                raise ValueError(
                    f"{len(transport)} transports for "
                    f"{len(self.decodes)} decode pools")
            self.transports = list(transport)
        else:
            if len(self.decodes) != 1:
                raise ValueError("a single transport needs a single "
                                 "decode pool — pass one per pool")
            self.transports = [transport]
        self.transport = self.transports[0]
        self.async_conveyor = bool(async_conveyor)
        self.backpressure = backpressure
        self._ids = itertools.count()
        self.streams: List[Stream] = []
        self._by_sid: Dict[int, Stream] = {}
        self._asm = StreamAssembler()
        self._pending_place: list = []   # (decode_idx, Arrival) buffered
        self.stats = {"transfers": 0, "skipped": 0, "deferred": 0,
                      "streamed_chunks": 0,
                      "stall_ms_total": 0.0, "transfer_ms_total": 0.0}
        if self.async_conveyor:
            self._q: queue.Queue = queue.Queue(max(1, int(max_pending)))
            # sid → (owning prefill pool, held req)
            self._inflight: Dict[int, Tuple[PrefillPool, object]] = {}
            self._done: collections.deque = collections.deque()
            self._error: Optional[BaseException] = None
            self._stop = threading.Event()
            self._cuda_index = cuda_index_of(self.prefill.engine)
            self._worker = threading.Thread(
                target=self._run_worker, name="fleet-conveyor", daemon=True)
            self._worker.start()

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               **kw) -> Stream:
        mnt = (max_new_tokens if max_new_tokens is not None
               else self.prefill.engine.config.max_new_tokens)
        stream = Stream(next(self._ids), prompt, mnt, kw)
        self.streams.append(stream)
        self._by_sid[stream.stream_id] = stream
        # least-depth over the prefill pools (ties break by index)
        pool = min(enumerate(self.prefills),
                   key=lambda e: (e[1].depth(), e[0]))[1]
        pool.submit(stream)
        return stream

    # -- destination choice (m×n) ----------------------------------------

    def _pick_dest(self) -> Optional[int]:
        """Least-depth decode pool WITH a free slot (ties break by
        index — deterministic, like the router's ``_pick_dest``).
        ``None`` means every pool is saturated: the saturated-survivor
        precheck — shipping bytes now would leave them with nowhere to
        adopt, so the held slot defers until someone drains."""
        cands = [(pool.depth(), di)
                 for di, pool in enumerate(self.decodes)
                 if pool.has_room()]
        if not cands:
            return None
        return min(cands)[1]

    def _send_handoff(self, di: int, sid: int, handoff: dict) -> str:
        """Encode + ship one handoff on ``transports[di]``; returns
        the terminal status of the frame that commits the stream.

        Streamed mode ships each KV block as its own transport frame
        (chunk stream ids) — verified, NACKed, and re-sent per chunk —
        then the closing frame under the real stream id. A chunk that
        exhausts its budget is NOT fatal here: the receiver's assembly
        check catches the gap at adoption and re-prefills cleanly."""
        transport = self.transports[di]
        if not self.streamed:
            manifest, blob = encode_handoff(handoff, self.wire_format)
            self.report.record_handoff(self.wire_format, len(blob))
            return transport.send(sid, manifest, blob)
        chunks, closing, closing_blob = encode_handoff_streamed(
            handoff, self.wire_format)
        self.report.record_handoff(self.wire_format,
                                   streamed_wire_bytes(closing))
        for i, (man, blob) in enumerate(chunks):
            transport.send(streamed_chunk_sid(sid, i), man, blob)
            self.stats["streamed_chunks"] += 1
        return transport.send(sid, closing, closing_blob)

    # -- arrivals (both modes; step thread only) -------------------------

    def _pump_arrivals(self) -> None:
        for di, transport in enumerate(self.transports):
            for arr in transport.poll():
                self._pending_place.append((di, arr))

    def _place(self) -> bool:
        """Adopt or fall back every buffered arrival its decode pool
        has room for (fallback re-submits through the engine queue, so
        it never needs a free slot up front). Chunk frames file into
        the assembler; the closing frame adopts the whole stream."""
        placed = False
        still = []
        for di, arr in self._pending_place:
            if arr.stream_id < 0:
                self._asm.add_chunk(arr)
                placed = True
                continue
            stream = self._by_sid.get(arr.stream_id)
            if stream is None or stream.state != "prefill":
                continue          # fenced/unknown stream: nothing to do
            pool = self.decodes[di]
            if arr.failed:
                _, notes = self._asm.take(arr.stream_id)
                reason = "; ".join(arr.defects) or "delivery failed"
                if notes:
                    reason += " [" + "; ".join(notes) + "]"
                self.report.record_fallback()
                pool.fallback(stream, reason)
                placed = True
                continue
            if not pool.has_room():
                still.append((di, arr))
                continue
            manifest = arr.manifest
            notes: List[str] = []
            try:
                if (isinstance(manifest, dict)
                        and manifest.get("format")
                        == HANDOFF_FORMAT_STREAMED):
                    chunks, notes = self._asm.take(arr.stream_id)
                    handoff = decode_handoff_streamed(
                        manifest, arr.blob, chunks)
                else:
                    handoff = decode_handoff(manifest, arr.blob)
                pool.place(stream, handoff)
            except (HandoffError, WeightsVersionSkew) as e:
                # wire-verified but structurally unusable (format skew,
                # missing/foreign chunk) or minted under a DIFFERENT
                # weights version than the decode engine serves (a
                # rollout in flight): same clean-re-prefill answer as a
                # failed delivery — the re-prefilled stream is entirely
                # the decode engine's version — with the per-chunk
                # defect history attached, so the log says WHY
                reason = str(e)
                if notes:
                    reason += " [" + "; ".join(notes) + "]"
                self.report.record_fallback()
                pool.fallback(stream, reason)
            placed = True
        self._pending_place = still
        return placed

    # -- synchronous conveyor --------------------------------------------

    def _transfer(self) -> bool:
        """Move every exportable held slot some decode pool has room
        for: export → encode → transport (seq/SHA frames, bounded
        re-send) → place, with delivery failure answered by a clean
        re-prefill. The step thread pays the wire inline — all of it
        booked as stall so the async path has an honest baseline."""
        moved = False
        for pool in self.prefills:
            for stream, req in pool.ready():
                di = self._pick_dest()
                if di is None:
                    self.stats["deferred"] += 1
                    return moved
                handoff = pool.export(req)
                t0 = time.monotonic()
                status = self._send_handoff(di, stream.stream_id,
                                            handoff)
                spent_ms = (time.monotonic() - t0) * 1000.0
                self.stats["transfer_ms_total"] += spent_ms
                self.stats["stall_ms_total"] += spent_ms
                self.stats["transfers"] += 1
                pool.release(req, aborted=(status == "failed"))
                # place immediately so has_room stays accurate for the
                # next held slot in this same pass
                self._pump_arrivals()
                self._place()
                moved = True
        return moved

    # -- asynchronous conveyor -------------------------------------------

    def _run_worker(self) -> None:
        """Worker leg: serialize + ship. No engine calls here — the
        handoff dict was exported on the step thread; errors are
        captured and re-raised from the next ``step()``."""
        bind_thread_device(self._cuda_index)
        while not self._stop.is_set():
            try:
                sid, handoff, di = self._q.get(timeout=self._POLL_S)
            except queue.Empty:
                continue
            try:
                t0 = time.monotonic()
                status = self._send_handoff(di, sid, handoff)
                self.stats["transfer_ms_total"] += (
                    (time.monotonic() - t0) * 1000.0)
                self._done.append((sid, status))
            except BaseException as e:  # noqa: BLE001 — surfaced in step()
                if self._error is None:
                    self._error = e
                self._done.append((sid, "failed"))
            finally:
                self.stats["transfers"] += 1
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async conveyor transfer failed") from e

    def _offer(self) -> bool:
        """Export ready held slots on the step thread and hand them to
        the worker (destination decode pool chosen here, at offer
        time, by least depth). ``skip`` backpressure leaves the slot
        held on a full queue (it re-offers next step); ``block`` waits
        — that wait is the only stall the async conveyor books. When
        every decode pool is saturated the slot defers instead."""
        offered = False
        for pool in self.prefills:
            for stream, req in pool.ready():
                sid = stream.stream_id
                if sid in self._inflight:
                    continue       # already on the wire; release pending
                di = self._pick_dest()
                if di is None:
                    self.stats["deferred"] += 1
                    return offered
                if self.backpressure == "skip" and self._q.full():
                    self.stats["skipped"] += 1
                    return offered
                handoff = pool.export(req)
                if self.backpressure == "skip":
                    try:
                        self._q.put_nowait((sid, handoff, di))
                    except queue.Full:  # raced the check: same answer
                        self.stats["skipped"] += 1
                        return offered
                else:
                    try:
                        self._q.put_nowait((sid, handoff, di))
                    except queue.Full:
                        # only a wait on a full queue is a stall (the
                        # clock would otherwise book the host's
                        # scheduling noise around an immediate put)
                        t0 = time.monotonic()
                        while True:
                            self._raise_pending()  # a dead worker
                            try:                   # never drains
                                self._q.put((sid, handoff, di),
                                            timeout=self._POLL_S)
                                break
                            except queue.Full:
                                continue
                        self.stats["stall_ms_total"] += (
                            (time.monotonic() - t0) * 1000.0)
                self._inflight[sid] = (pool, req)
                offered = True
        return offered

    def _reap(self) -> bool:
        """Release held slots whose transfers reached a terminal
        status (step thread — the engine's held map is not safe to
        mutate from the worker)."""
        reaped = False
        while self._done:
            sid, status = self._done.popleft()
            ent = self._inflight.pop(sid, None)
            if ent is not None:
                pool, req = ent
                pool.release(req, aborted=(status == "failed"))
            reaped = True
        return reaped

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Wait for every queued and in-flight transfer to reach a
        terminal transport status, then reap and place. ``deadline_s``
        is seconds from now; a missed deadline returns ``False`` (never
        raises for lateness — mirror of ``AsyncSnapshotPlane.drain``).
        Synchronous conveyors have nothing in flight: always ``True``."""
        if not self.async_conveyor:
            return True
        deadline = (None if deadline_s is None
                    else time.monotonic() + float(deadline_s))
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                if deadline is None:
                    self._q.all_tasks_done.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._q.all_tasks_done.wait(timeout=left)
        self._reap()
        self._pump_arrivals()
        self._place()
        return True

    def close(self) -> None:
        """Drain outstanding transfers and stop the worker. Idempotent;
        a closed fleet can still ``step()`` its engines (the conveyor
        leg is simply empty)."""
        if not self.async_conveyor or self._stop.is_set():
            return
        self._q.join()
        self._stop.set()
        self._worker.join()
        self._reap()

    # -- the conveyor loop ------------------------------------------------

    def step(self) -> bool:
        """One conveyor iteration; returns whether anything advanced."""
        if not self.async_conveyor:
            worked = False
            for pool in self.prefills:
                # each pool step syncs internally (int32 token pulls)
                worked = pool.step() or worked  # dlint: disable=DL104
            worked = self._transfer() or worked
            self._pump_arrivals()
            worked = self._place() or worked
            for pool in self.decodes:
                # each pool step syncs internally (int32 token pulls)
                worked = pool.step() or worked  # dlint: disable=DL104
            return worked
        self._raise_pending()
        worked = False
        for pool in self.prefills:
            # each pool step syncs internally (int32 token pulls)
            worked = pool.step() or worked  # dlint: disable=DL104
        worked = self._reap() or worked
        worked = self._offer() or worked
        self._pump_arrivals()
        worked = self._place() or worked
        for pool in self.decodes:
            # each pool step syncs internally (int32 token pulls)
            worked = pool.step() or worked  # dlint: disable=DL104
        return worked

    def idle(self) -> bool:
        for pool in self.prefills:
            if not pool.engine.idle() or pool.engine.held:
                return False
        for pool in self.decodes:
            if not pool.engine.idle():
                return False
        if self._pending_place:
            return False
        if self.async_conveyor and (self._inflight or self._done
                                    or self._q.unfinished_tasks):
            return False
        return True

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        n = 0
        while not self.idle():
            if n >= max_steps:
                raise RuntimeError(
                    f"fleet failed to drain within {max_steps} steps")
            # each engine step syncs internally (int32 token pulls)
            worked = self.step()  # dlint: disable=DL104
            if self.async_conveyor:
                if not worked:
                    time.sleep(0.001)   # transfer in flight: yield
                elif self._q.unfinished_tasks:
                    # steps that only re-poll held slots would keep the
                    # GIL from the worker they are waiting on
                    time.sleep(0)
            n += 1
        return n

    @property
    def overlap_fraction(self) -> float:
        """Fraction of wire wall-time hidden behind decode steps:
        ``1 − stall/transfer`` clamped to [0, 1]. The synchronous
        conveyor books stall == transfer, so it reads 0."""
        xfer = self.stats["transfer_ms_total"]
        if xfer <= 0:
            return 0.0
        return max(0.0, min(1.0,
                            1.0 - self.stats["stall_ms_total"] / xfer))

    def reports(self):
        return ([pool.engine.report for pool in self.prefills]
                + [pool.engine.report for pool in self.decodes])

    def transport_totals(self) -> dict:
        """Live wire-health counters folded across every transport:
        retransmits (delivery attempts beyond the first), reconnects
        (socket planes), duplicate-fenced frames, and streamed-chunk
        NACKs — the numbers that prove per-chunk re-send granularity
        and restart fencing actually engaged."""
        tot = {"retransmits": 0, "reconnects": 0, "dup_fenced": 0,
               "chunk_nacks": 0}
        for transport in self.transports:
            s = getattr(transport, "stats", {})
            tot["retransmits"] += max(
                0, int(s.get("attempts", 0)) - int(s.get("sent", 0)))
            r = transport.receiver_stats
            tot["dup_fenced"] += int(r.get("duplicates", 0))
            tot["chunk_nacks"] += int(r.get("chunk_nacked", 0))
            plane_stats = getattr(getattr(transport, "plane", None),
                                  "stats", None)
            if plane_stats:
                tot["reconnects"] += int(plane_stats.get("reconnects", 0))
        return tot

    def summary(self) -> dict:
        out = self.report.summary(self.reports())
        # fold the LIVE transport counters on top of whatever finished
        # transports were already recorded into the report
        live = out["fleet"]["transport"]
        for key, val in self.transport_totals().items():
            live[key] += val
        return out
