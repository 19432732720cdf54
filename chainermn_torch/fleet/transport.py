"""HandoffTransport — how a prefill→decode handoff actually travels.

Counterpart of ``chainermn_tpu/fleet/transport.py``; the frames are
plain dicts of ints, strings, bytes and JSON-able manifests, so a port
host and a JAX host exchange them over one plane.

``fleet/pools.py`` decides *when* a populated KV slot moves; this module
decides *how* the bytes get there and what happens when the wire lies.
Two implementations of one contract:

* :class:`InProcessTransport` — the single-process queue pair the
  original conveyor used, now with the same framing/verification
  discipline as the real wire (so the tier-1 fault matrix runs without
  spawning processes, and an optional ``wire_delay_ms`` models DCN
  latency for the bench's overlap gate).
* :class:`ObjectPlaneTransport` — ships frames between processes over
  any object plane exposing ``send_obj``/``try_recv_obj`` (the
  default process group's store via
  :class:`~chainermn_torch.comm.object_plane.ObjectPlane`, the TCP
  :class:`~chainermn_torch.comm.socket_plane.SocketObjectPlane`, or the
  restart-tolerant :class:`~chainermn_torch.comm.object_plane.
  FsObjectPlane` the supervised cross-host drill uses).

The reliability protocol (both implementations):

* **frames** — each handoff travels as ``{seq, stream_id, manifest,
  blob}``. The sender assigns a monotonic per-channel sequence number;
  the manifest already carries ``bytes`` + ``sha256`` over the blob, so
  the receiver verifies every frame before it can touch an engine:
  truncation fails the length check, corruption fails the digest,
  duplication is fenced by the resolved-stream set, and reordering is
  detected by the sequence gap (and is harmless — adoption is keyed by
  stream, not arrival order).
* **NACK → bounded re-send → clean re-prefill** — a frame that fails
  verification is NACKed; the sender re-sends up to ``max_attempts``
  with the :class:`~chainermn_torch.resilience.policy.RpcPolicy` jittered
  backoff between attempts. A receiver that has NACKed the same
  sequence number ``max_attempts`` times gives up: it acks ``failed``
  and surfaces the stream for a clean re-prefill. Either side giving up
  resolves the stream, so a late/duplicate frame can never poison a
  decode slot afterwards (the *fence*).
* **every blocking receive is bounded** — ack waits use
  ``RpcPolicy.handoff_ack_ms()`` per attempt, receiver polls take an
  explicit ``timeout_ms``; nothing in this module can wait forever on a
  dead peer (the DL117 contract this module is the clean exemplar for).

Chaos: every delivery attempt passes through ``chaos.on_wire`` —
``drop_handoff`` / ``delay_handoff`` / ``dup_handoff`` /
``corrupt_handoff`` tear at exactly this layer, which is how the drill
proves the protocol above is not decorative.
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from chainermn_torch.resilience import chaos
from chainermn_torch.resilience.policy import RpcPolicy, policy

__all__ = ["TransportError", "Arrival", "InProcessTransport",
           "ObjectPlaneTransport", "LoopbackPlane", "PairedTransport",
           "HANDOFF_DATA_TAG", "HANDOFF_ACK_TAG"]

#: object-plane tags for the two handoff channels (data and acks ride
#: separate p2p channels so a slow blob never blocks an ack read)
HANDOFF_DATA_TAG = 7001
HANDOFF_ACK_TAG = 7002

#: terminal ack statuses a sender can observe for one frame
_ACK_STATUSES = ("adopted", "duplicate", "failed")


class TransportError(RuntimeError):
    """The transport itself is broken (not a per-frame defect)."""


class Arrival:
    """One verified receiver-side outcome. ``manifest is None`` means
    the frame could not be delivered intact within the attempt budget —
    the caller must answer with a clean re-prefill (the blob never
    touches an engine). ``defects`` is then the per-attempt defect
    history (every ``_frame_defect`` reason this frame's seq
    accumulated), so the fallback log can say WHY the wire failed
    instead of just that it did."""

    __slots__ = ("stream_id", "manifest", "blob", "defects")

    def __init__(self, stream_id: int, manifest: Optional[dict],
                 blob: Optional[bytes],
                 defects: Tuple[str, ...] = ()):
        self.stream_id = int(stream_id)
        self.manifest = manifest
        self.blob = blob
        self.defects = tuple(defects)

    @property
    def failed(self) -> bool:
        return self.manifest is None


def _frame_defect(manifest: dict, blob: bytes) -> Optional[str]:
    """Cheap wire-level verification (the manifest vouches for the
    blob): returns a reason string for a torn/corrupt frame, or None.
    This is the SAME check ``decode_handoff`` re-runs before touching
    an engine — verified twice, adopted once."""
    import hashlib
    try:
        want = int(manifest["bytes"])
        if len(blob) != want:
            return f"truncated: {len(blob)} bytes, manifest says {want}"
        if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
            return "corrupt: sha256 mismatch"
    except Exception as e:  # broken manifest structure → same contract
        return f"undecodable manifest: {type(e).__name__}: {e}"
    return None


class _ReceiverState:
    """Sequence/fence bookkeeping shared by both transports."""

    def __init__(self, max_attempts: int):
        self.max_attempts = max_attempts
        self.resolved: set = set()          # stream_ids fenced off
        self.expect_seq = 0                 # next frame seq (stats only)
        self.nacks: Dict[int, int] = {}     # seq → failed deliveries
        self.defects: Dict[int, List[str]] = {}  # seq → defect history
        self.stats = {"delivered": 0, "duplicates": 0, "nacked": 0,
                      "reordered": 0, "failed": 0, "chunk_nacked": 0}

    def admit(self, seq: int, stream_id: int, manifest: dict,
              blob: bytes) -> Tuple[str, Optional[Arrival]]:
        """Classify one raw frame. Returns ``(ack_status, arrival)``
        where ack_status is ``adopted``/``duplicate``/``failed`` or
        ``nack``; arrival is non-None for adopted and failed."""
        if stream_id in self.resolved:
            self.stats["duplicates"] += 1
            return "duplicate", None
        if seq != self.expect_seq:
            # a gap (sender moved on / restarted) or a late re-send:
            # harmless either way — adoption is keyed by stream id, the
            # counter only tracks that reordering was SEEN
            self.stats["reordered"] += 1
        defect = _frame_defect(manifest, blob)
        if defect is None:
            self.expect_seq = max(self.expect_seq, seq + 1)
            self.resolved.add(stream_id)
            self.stats["delivered"] += 1
            self.defects.pop(seq, None)
            return "adopted", Arrival(stream_id, manifest, blob)
        self.defects.setdefault(seq, []).append(defect)
        bad = self.nacks.get(seq, 0) + 1
        self.nacks[seq] = bad
        if bad >= self.max_attempts:
            # give up on the wire for this frame: fence the stream and
            # hand it back for a clean re-prefill — with the full
            # defect history attached, so the fallback log names the
            # wire's failure mode instead of just the outcome
            self.expect_seq = max(self.expect_seq, seq + 1)
            self.resolved.add(stream_id)
            self.stats["failed"] += 1
            return "failed", Arrival(stream_id, None, None,
                                     defects=tuple(
                                         self.defects.pop(seq, ())))
        self.stats["nacked"] += 1
        if isinstance(manifest, dict) and manifest.get("format") == 5 \
                and manifest.get("kind") == "chunk":
            # a streamed chunk re-sends alone — the counter the
            # fleet-report gate uses to prove per-chunk granularity
            self.stats["chunk_nacked"] += 1
        return "nack", None


class InProcessTransport:
    """The queue pair, with real framing: sender and receiver faces of
    one object, safe to drive from the conveyor's worker thread (send)
    and step thread (poll) concurrently.

    ``wire_delay_ms`` sleeps each delivery attempt — canned DCN latency
    for the bench's overlap gate and the backpressure tests; real
    latency comes from a real plane. ``backoff`` enables the RpcPolicy
    jittered sleep between re-sends (off by default: an in-process
    retry has nobody to wait for, and the fault matrix stays fast)."""

    def __init__(self, max_attempts: int = 4,
                 pol: Optional[RpcPolicy] = None,
                 wire_delay_ms: float = 0.0, backoff: bool = False,
                 chaos_kind: str = "handoff"):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.policy = pol or policy()
        self.max_attempts = max_attempts
        self.wire_delay_ms = float(wire_delay_ms)
        self.backoff = backoff
        #: which chaos wire faults target this transport's traffic —
        #: "handoff" (corrupt_handoff) or "rollout"
        #: (corrupt_rollout_chunk); generic drop/delay/dup hit both
        self.chaos_kind = chaos_kind
        self._lock = threading.Lock()
        self._recv = _ReceiverState(max_attempts)
        self._arrivals: deque = deque()
        self._send_seq = 0
        self.stats = {"sent": 0, "attempts": 0, "dropped": 0,
                      "send_failed": 0}
        #: defect history of the most recent ``failed`` send (why the
        #: wire failed, not just that it did)
        self.last_send_defects: Tuple[str, ...] = ()

    # -- sender face -----------------------------------------------------

    def send(self, stream_id: int, manifest: dict, blob: bytes) -> str:
        """Deliver one handoff; returns the terminal ack status
        (``adopted``/``duplicate``/``failed``). Bounded: at most
        ``max_attempts`` delivery attempts, each re-rolled through the
        chaos wire, then the stream is fenced and surfaced for a clean
        re-prefill — this call cannot spin forever."""
        with self._lock:
            seq = self._send_seq
            self._send_seq += 1
            self.stats["sent"] += 1
        for attempt in range(self.max_attempts):
            self.stats["attempts"] += 1
            verdict, wire = chaos.on_wire(blob, kind=self.chaos_kind)
            if self.wire_delay_ms:
                time.sleep(self.wire_delay_ms / 1000.0)
            if verdict == "drop":
                self.stats["dropped"] += 1
                status = None              # nothing arrived: like a lost
            else:                          # frame, the "ack" times out
                status = self._deliver(seq, stream_id, manifest, wire)
                if verdict == "dup":
                    dup = self._deliver(seq, stream_id, manifest, wire)
                    status = status if status in _ACK_STATUSES else dup
            if status in _ACK_STATUSES:
                return status
            if self.backoff and attempt + 1 < self.max_attempts:
                time.sleep(
                    self.policy.backoff_ms(attempt) / 1000.0)
        # attempts exhausted with no intact delivery: fence + fallback
        with self._lock:
            self.stats["send_failed"] += 1
            defects = tuple(self._recv.defects.pop(seq, ())) or (
                f"no intact delivery in {self.max_attempts} attempts "
                "(frames dropped in flight)",)
            self.last_send_defects = defects
            if stream_id not in self._recv.resolved:
                self._recv.resolved.add(stream_id)
                self._recv.stats["failed"] += 1
                self._arrivals.append(
                    Arrival(stream_id, None, None, defects=defects))
        return "failed"

    def _deliver(self, seq: int, stream_id: int, manifest: dict,
                 blob: bytes) -> Optional[str]:
        with self._lock:
            status, arrival = self._recv.admit(seq, stream_id,
                                               manifest, blob)
            if arrival is not None:
                self._arrivals.append(arrival)
        return status if status in _ACK_STATUSES else None

    # -- receiver face ---------------------------------------------------

    def poll(self, timeout_ms: int = 0) -> List[Arrival]:
        """Drain verified arrivals (non-blocking; the in-process wire
        has no latency for a timeout to cover)."""
        del timeout_ms
        out = []
        with self._lock:
            while self._arrivals:
                out.append(self._arrivals.popleft())
        return out

    def resolve(self, stream_id: int) -> None:
        """Fence a stream the caller resolved out-of-band (deadline
        fallback): later frames for it drop as duplicates."""
        with self._lock:
            self._recv.resolved.add(stream_id)

    @property
    def receiver_stats(self) -> dict:
        with self._lock:
            return dict(self._recv.stats)

    def close(self) -> None:
        pass


class ObjectPlaneTransport:
    """Handoff frames over a cross-process object plane.

    One instance per directed (sender, receiver) pair; the sender host
    calls :meth:`send`, the receiver host calls :meth:`poll` — the same
    faces as :class:`InProcessTransport`, so ``fleet/pools.py`` and
    ``tools/fleet_lm.py`` are transport-agnostic.

    ``plane`` needs three methods (both
    :class:`~chainermn_torch.comm.object_plane.ObjectPlane` and
    :class:`~chainermn_torch.comm.object_plane.FsObjectPlane` qualify):

    * ``send_obj(obj, dest, tag)`` — publish one object;
    * ``try_recv_obj(src, tag, timeout_ms)`` — bounded receive that
      raises ``TimeoutError`` WITHOUT consuming the channel position,
      so a poll can come back later;
    * ``process_index`` — this host's rank.

    If the plane also exposes ``gc(src, tag)`` (FsObjectPlane), the
    transport calls it after each resolved frame/ack so a long drill
    does not accumulate one file per frame on disk.

    Restart tolerance: adoption is keyed by ``stream_id``, not by
    sequence number, so a restarted sender (fresh seq counter, replayed
    streams) is answered with ``duplicate`` acks for everything the
    receiver already resolved — the fenced re-queue the SIGKILL drill
    pins."""

    def __init__(self, plane, peer: int, *,
                 max_attempts: int = 4,
                 pol: Optional[RpcPolicy] = None,
                 data_tag: int = HANDOFF_DATA_TAG,
                 ack_tag: int = HANDOFF_ACK_TAG,
                 chaos_kind: str = "handoff"):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.plane = plane
        self.peer = int(peer)
        self.policy = pol or policy()
        self.max_attempts = max_attempts
        self.data_tag = data_tag
        self.ack_tag = ack_tag
        self.chaos_kind = chaos_kind     # see InProcessTransport
        self._recv = _ReceiverState(max_attempts)
        self._send_seq = 0
        self._acks: Dict[int, str] = {}     # seq → status (sender side)
        self._nack_reasons: Dict[int, List[str]] = {}  # seq → defects
        self.stats = {"sent": 0, "attempts": 0, "ack_timeouts": 0,
                      "send_failed": 0}
        #: defect history of the most recent ``failed`` send — the
        #: receiver's NACK reasons plus local ack timeouts, so the
        #: fallback log can say WHY the wire failed
        self.last_send_defects: Tuple[str, ...] = ()

    # -- sender face -----------------------------------------------------

    def send(self, stream_id: int, manifest: dict, blob: bytes) -> str:
        """Ship one handoff frame and wait for its ack. Bounded end to
        end: ``max_attempts`` attempts, each with an
        ``RpcPolicy.handoff_ack_ms()`` ack deadline and a jittered
        backoff before the re-send; exhaustion returns ``failed`` (the
        receiver's own give-up or deadline fallback re-prefills)."""
        seq = self._send_seq
        self._send_seq += 1
        self.stats["sent"] += 1
        frame = {"kind": "handoff", "seq": seq, "stream_id": int(stream_id),
                 "manifest": manifest}
        for attempt in range(self.max_attempts):
            self.stats["attempts"] += 1
            verdict, wire = chaos.on_wire(blob, kind=self.chaos_kind)
            if verdict != "drop":
                self.plane.send_obj(dict(frame, blob=wire), self.peer,
                                    tag=self.data_tag)
                if verdict == "dup":
                    self.plane.send_obj(dict(frame, blob=wire), self.peer,
                                        tag=self.data_tag)
            status = self._await_ack(seq)
            if status in _ACK_STATUSES:
                self._gc_plane(self.ack_tag)
                self._nack_reasons.pop(seq, None)
                return status
            if attempt + 1 < self.max_attempts:
                time.sleep(self.policy.backoff_ms(attempt) / 1000.0)
        self.stats["send_failed"] += 1
        self.last_send_defects = tuple(self._nack_reasons.pop(seq, ()))
        return "failed"

    def _gc_plane(self, tag: int) -> None:
        """Prune consumed frame files on planes that support it
        (FsObjectPlane) — a long drill must not accumulate one file
        per frame forever. Best-effort: a racing unlink is not an
        error, and memory planes simply have no ``gc``."""
        gc = getattr(self.plane, "gc", None)
        if gc is None:
            return
        try:
            gc(self.peer, tag=tag)
        except OSError:
            pass

    def _await_ack(self, seq: int) -> Optional[str]:
        """Wait (bounded) for the ack of frame ``seq``. Acks arrive in
        channel order; entries for older frames are recorded and
        skipped, a missing ack within the budget returns None (the
        caller re-sends)."""
        cached = self._acks.pop(seq, None)
        if cached is not None:
            return cached
        budget_ms = self.policy.handoff_ack_ms()
        deadline = time.monotonic() + budget_ms / 1000.0
        while True:
            left_ms = (deadline - time.monotonic()) * 1000.0
            if left_ms <= 0:
                self.stats["ack_timeouts"] += 1
                self._nack_reasons.setdefault(seq, []).append(
                    f"no ack within {int(budget_ms)} ms "
                    "(frame or ack lost in flight)")
                return None
            try:
                ack = self.plane.try_recv_obj(
                    self.peer, tag=self.ack_tag,
                    timeout_ms=max(1, int(min(left_ms,
                                              self.policy.probe_ms))))
            except TimeoutError:
                continue                      # bounded by the deadline
            if not isinstance(ack, dict) or "seq" not in ack:
                continue                      # unintelligible: ignore
            if ack.get("kind") == "nack" and int(ack["seq"]) == seq:
                self._nack_reasons.setdefault(seq, []).append(
                    str(ack.get("reason", "receiver NACK")))
                return None                   # damaged in flight: re-send
            if ack.get("kind") == "ack":
                if int(ack["seq"]) == seq:
                    return str(ack.get("status", "adopted"))
                # an ack for another frame (late ack after our earlier
                # timeout): remember it for that frame's caller
                self._acks[int(ack["seq"])] = str(
                    ack.get("status", "adopted"))

    # -- receiver face ---------------------------------------------------

    def poll(self, timeout_ms: int = 0) -> List[Arrival]:
        """Drain frames available within ``timeout_ms``: verify, ack or
        NACK each, and return the verified arrivals. Every wait is an
        explicit bounded ``try_recv_obj``; an empty wire returns an
        empty list rather than blocking."""
        out: List[Arrival] = []
        deadline = time.monotonic() + max(0, timeout_ms) / 1000.0
        while True:
            left_ms = (deadline - time.monotonic()) * 1000.0
            wait_ms = max(1, int(min(max(left_ms, 0),
                                     self.policy.probe_ms)))
            try:
                frame = self.plane.try_recv_obj(
                    self.peer, tag=self.data_tag, timeout_ms=wait_ms)
            except TimeoutError:
                if time.monotonic() >= deadline:
                    return out
                continue
            arrival = self._admit_frame(frame)
            if arrival is not None:
                out.append(arrival)
            if time.monotonic() >= deadline:
                return out

    def _admit_frame(self, frame) -> Optional[Arrival]:
        if not isinstance(frame, dict) or frame.get("kind") != "handoff":
            return None                      # garbage on the channel
        try:
            seq = int(frame["seq"])
            stream_id = int(frame["stream_id"])
            manifest = frame["manifest"]
            blob = frame["blob"]
        except Exception:
            return None
        status, arrival = self._recv.admit(seq, stream_id, manifest, blob)
        if status == "nack":
            hist = self._recv.defects.get(seq) or ["frame defect"]
            self.plane.send_obj({"kind": "nack", "seq": seq,
                                 "reason": hist[-1]}, self.peer,
                                tag=self.ack_tag)
        else:
            self.plane.send_obj({"kind": "ack", "seq": seq,
                                 "status": status}, self.peer,
                                tag=self.ack_tag)
            self._gc_plane(self.data_tag)
        return arrival

    def resolve(self, stream_id: int) -> None:
        """Fence a stream resolved out-of-band (the receiver's deadline
        fallback re-prefilled it): any later frame for it is answered
        ``duplicate`` and dropped."""
        self._recv.resolved.add(stream_id)

    @property
    def receiver_stats(self) -> dict:
        return dict(self._recv.stats)

    def close(self) -> None:
        pass


class PairedTransport:
    """Two :class:`ObjectPlaneTransport` endpoints glued into the
    single-object transport interface ``DisaggregatedFleet`` expects.

    A real object plane has one process per end, so the sender face
    and the receiver face of a channel live in different transports.
    When one process holds BOTH ends — the bench's localhost-socket
    drill, the tier-1 socket harness — this adapter routes ``send``
    to the sender-side transport and ``poll``/``resolve`` to the
    receiver-side one, while forwarding the stats surfaces
    (``stats``, ``receiver_stats``, ``last_send_defects``, ``plane``)
    the fleet's wire-health accounting reads."""

    def __init__(self, sender: ObjectPlaneTransport,
                 receiver: ObjectPlaneTransport):
        self.sender = sender
        self.receiver = receiver
        self.plane = sender.plane

    def send(self, stream_id: int, manifest: dict, blob: bytes) -> str:
        return self.sender.send(stream_id, manifest, blob)

    def poll(self, timeout_ms: int = 0) -> List[Arrival]:
        return self.receiver.poll(timeout_ms=timeout_ms)

    def resolve(self, stream_id: int) -> None:
        self.receiver.resolve(stream_id)

    @property
    def stats(self) -> dict:
        return self.sender.stats

    @property
    def receiver_stats(self) -> dict:
        return self.receiver.receiver_stats

    @property
    def last_send_defects(self):
        return self.sender.last_send_defects

    def close(self) -> None:
        pass


class LoopbackPlane:
    """An in-memory object plane (``send_obj``/``try_recv_obj``) wiring
    two :class:`ObjectPlaneTransport` endpoints inside one process —
    the tier-1 harness for the full cross-process protocol (acks,
    NACKs, re-sends, fences) without spawning processes. Channels are
    keyed exactly like the real plane's (src, dst, tag) triples."""

    def __init__(self, n: int = 2):
        self.process_count = n
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._chan: Dict[Tuple[int, int, int], deque] = {}

    def endpoint(self, index: int) -> "_LoopbackEndpoint":
        return _LoopbackEndpoint(self, index)


class _LoopbackEndpoint:
    def __init__(self, plane: LoopbackPlane, index: int):
        self._plane = plane
        self.process_index = int(index)
        self.process_count = plane.process_count

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        # pickle round-trip: the frame crosses a byte boundary exactly
        # like the real plane (no shared mutable state leaks across)
        data = pickle.dumps(obj)
        with self._plane._cond:
            self._plane._chan.setdefault(
                (self.process_index, int(dest), int(tag)),
                deque()).append(data)
            self._plane._cond.notify_all()

    def try_recv_obj(self, src: int, tag: int = 0,
                     timeout_ms: Optional[int] = None) -> Any:
        deadline = time.monotonic() + (timeout_ms or 0) / 1000.0
        key = (int(src), self.process_index, int(tag))
        with self._plane._cond:
            while True:
                q = self._plane._chan.get(key)
                if q:
                    return pickle.loads(q.popleft())
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"no object on channel {key} within "
                        f"{timeout_ms} ms")
                self._plane._cond.wait(timeout=left)
