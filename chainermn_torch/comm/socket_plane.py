"""SocketObjectPlane — the real network data plane.

Counterpart of ``chainermn_tpu/comm/socket_plane.py``; its frames are
byte for byte that module's, so a port host and a JAX host share a wire.

TCP point-to-point object transport behind the exact object-plane
contract (``send_obj`` / ``recv_obj`` / ``try_recv_obj``, per-channel
tags and sequence numbers), so :class:`~chainermn_torch.fleet.transport.
ObjectPlaneTransport` runs over it unchanged — the production sibling
of the coordinator-KV :class:`~chainermn_torch.comm.object_plane.
ObjectPlane` and the drill-harness :class:`~chainermn_torch.comm.
object_plane.FsObjectPlane`.

Wire discipline:

* **length-prefixed, SHA-framed messages** — every frame is a fixed
  binary header (magic, kind, src, tag, seq, payload length, sha256)
  followed by the pickled payload. A torn stream (partial write, RST
  mid-frame) fails the length or digest check; the reader drops the
  connection rather than deliver damaged bytes — the sender reconnects
  and the layer above re-sends.
* **frame batching / coalescing** — frames smaller than
  ``coalesce_bytes`` (acks, NACKs, control messages) are buffered per
  peer and flushed in one ``sendall`` when the batch fills, a large
  frame follows, or the ``coalesce_ms`` window closes (a background
  flusher bounds the added latency) — the small-ack syscall storm of a
  chatty handoff protocol collapses into a few writes.
* **RpcPolicy-budgeted timeouts everywhere** — connects and reads run
  under ``settimeout`` derived from :class:`~chainermn_torch.resilience.
  policy.RpcPolicy` (connect = one probe slice, reconnect attempts ride
  the jittered ``backoff_ms`` ladder, bounded by an attempt cap). No
  socket in this module ever blocks unbounded on a dead peer.
* **half-open detection** — a connection is not usable until its
  HELLO/HELLO-ACK handshake round-trips within the probe budget, so a
  connect that lands in a dead NAT entry (or a peer that accepted and
  wedged) times out and retries instead of wedging the sender; an
  established connection that stops accepting bytes hits the send
  timeout, is torn down, and is re-handshaked.
* **restart fencing (the FsObjectPlane HWM discipline over TCP)** — the
  HELLO carries the sender's incarnation and per-tag sequence
  high-water marks; the HELLO-ACK answers with the receiver's consumed
  positions. A reborn *sender* (fresh counters) is bumped up to the
  receiver's position so it never reuses a sequence number — its
  replayed streams arrive as fresh frames and the transport's resolved
  fence answers them ``duplicate``. A reborn *receiver* fast-forwards
  past frames a previous incarnation consumed, and frames lost with a
  dead connection become known holes the reader skips (``floor``) —
  the layer above's ack timeout owns their re-send. Stale frames below
  the consumed position are counted and dropped, never re-delivered.

Delivery semantics match the other planes: ``send_obj`` is fire-and-
forget — it tries to put the frame on a live connection (reconnecting
under the backoff ladder if needed) and on exhaustion counts the frame
as dropped rather than raising, because loss is exactly what the
transport's RpcPolicy-bounded ack/NACK/re-send protocol exists to
absorb. ``try_recv_obj`` commits the reader position only on success:
a timeout leaves the channel intact for the next poll.

Chaos: ``chaos.on_socket("send")`` can answer ``reset_conn`` (the
connection dies under the frame) or ``partial_write`` (half the frame
is written, then the connection dies); ``chaos.on_socket("accept")``
sleeps the acceptor (``stall_accept``). Either connection fault tears
the socket down and the plane re-sends the same frame on a fresh
connection — against a live peer a connection fault costs a redial,
never a frame, because ctrl traffic above the plane has no ack/re-send
of its own. The socket drills drive the same bitwise oracle as the
transport's wire-chaos matrix through these.
"""

from __future__ import annotations

import hashlib
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from chainermn_torch.resilience import chaos as _chaos
from chainermn_torch.resilience.policy import RpcPolicy, policy as _rpc_policy

__all__ = ["SocketObjectPlane", "pick_free_endpoints"]

_MAGIC = b"CMTP"
_KIND_HELLO = 0
_KIND_HELLO_ACK = 1
_KIND_OBJ = 2

#: header: magic(4s) kind(B) src(I) tag(q) seq(Q) length(Q) sha256(32s)
_HDR = struct.Struct("!4sBIqQQ32s")


def pick_free_endpoints(n: int) -> List[str]:
    """``n`` localhost ``host:port`` endpoints with currently-free
    ports (bind-0 probe; tests and the bench gate hand these to every
    rank before any plane binds — a tiny race window on a busy CI box,
    same trade every ephemeral-port harness makes)."""
    eps = []
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            eps.append(f"127.0.0.1:{s.getsockname()[1]}")
    finally:
        for s in socks:
            s.close()
    return eps


def _encode_frame(kind: int, src: int, tag: int, seq: int,
                  payload: bytes) -> bytes:
    digest = hashlib.sha256(payload).digest()
    return _HDR.pack(_MAGIC, kind, src, tag, seq,
                     len(payload), digest) + payload


class _PeerOut:
    """Sender-side state for one destination: the connection, the
    per-tag sequence counters, and the coalescing buffer."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.seq: Dict[int, int] = {}       # tag → next seq
        self.lost: Dict[int, int] = {}      # tag → maybe-lost HWM
        self.batch: List[bytes] = []        # coalesced small frames
        self.batch_bytes = 0
        self.batch_since = 0.0              # monotonic of oldest frame

    def mark_lost(self) -> None:
        """Every seq assigned so far may be lost (the connection died
        or delivery was abandoned) — the next HELLO advertises this
        high-water mark so the receiver can skip the holes."""
        for tag, nxt in self.seq.items():
            if nxt > self.lost.get(tag, 0):
                self.lost[tag] = nxt


class SocketObjectPlane:
    """TCP object plane over ``endpoints[i] = "host:port"`` per rank.

    Binds ``endpoints[index]`` and accepts peer connections on a
    daemon thread; outgoing connections are made lazily per
    destination. ``incarnation`` defaults to the supervisor's restart
    counter (``$CHAINERMN_TPU_RESTART_COUNT``) so a reborn process
    re-handshakes as a new incarnation without any caller wiring."""

    #: bounded connect/delivery attempts per send (the jittered
    #: backoff ladder between them; exhaustion drops the frame)
    CONNECT_ATTEMPTS = 4

    def __init__(self, endpoints: List[str], index: int, *,
                 pol: Optional[RpcPolicy] = None,
                 incarnation: Optional[int] = None,
                 coalesce_ms: float = 2.0,
                 coalesce_bytes: int = 4096,
                 coalesce_frames: int = 16) -> None:
        self.endpoints = [self._parse(e) for e in endpoints]
        self.process_index = int(index)
        self.process_count = len(endpoints)
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"index {index} outside "
                             f"[0, {self.process_count})")
        self.policy = pol or _rpc_policy()
        if incarnation is None:
            import os
            try:
                incarnation = int(
                    os.environ.get("CHAINERMN_TPU_RESTART_COUNT", "0"))
            except ValueError:
                incarnation = 0
        self.incarnation = int(incarnation)
        self.coalesce_ms = float(coalesce_ms)
        self.coalesce_bytes = int(coalesce_bytes)
        self.coalesce_frames = int(coalesce_frames)
        self.stats = {"connects": 0, "reconnects": 0, "frames_sent": 0,
                      "frames_recv": 0, "bytes_sent": 0, "bytes_recv": 0,
                      "batched_frames": 0, "flushes": 0,
                      "stale_frames": 0, "corrupt_frames": 0,
                      "send_dropped": 0, "resent_frames": 0,
                      "hellos": 0}
        self._out: Dict[int, _PeerOut] = {}
        self._out_lock = threading.Lock()
        # receiver side: (src, tag) → {seq: payload}; positions commit
        # only on a successful try_recv (the poller contract)
        self._cond = threading.Condition()
        self._buf: Dict[Tuple[int, int], Dict[int, bytes]] = {}
        self._pos: Dict[Tuple[int, int], int] = {}
        self._floor: Dict[Tuple[int, int], int] = {}  # known-lost holes
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # accepted connections, so close() can wake their readers
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.settimeout(self._probe_s())
        self._srv.bind(self.endpoints[self.process_index])
        self._srv.listen(max(4, 2 * self.process_count))
        self._spawn(self._accept_loop, "sockplane-accept")
        self._spawn(self._flush_loop, "sockplane-flush")

    # -- plumbing --------------------------------------------------------

    @staticmethod
    def _parse(ep) -> Tuple[str, int]:
        """Accepts ``"host:port"`` (bare ``:port`` → 127.0.0.1) or an
        already-split ``(host, port)`` pair."""
        if isinstance(ep, (tuple, list)):
            host, port = ep
            return (str(host) or "127.0.0.1", int(port))
        host, _, port = ep.rpartition(":")
        return (host or "127.0.0.1", int(port))

    def _probe_s(self) -> float:
        """One probe slice in seconds — the per-socket-op timeout (and
        the half-open detection bound: no read/connect/accept waits
        longer than this before re-checking liveness/stop)."""
        return max(0.05, min(self.policy.probe_ms, 10_000) / 1000.0)

    def _spawn(self, fn, name: str) -> None:
        th = threading.Thread(target=fn, name=name, daemon=True)
        th.start()
        self._threads.append(th)

    def close(self) -> None:
        self._stop.set()
        # shutdown wakes the threads blocked in accept() and recv() now,
        # instead of at their next probe-slice timeout
        with self._conns_lock:
            conns = list(self._conns)
        for sock in [self._srv] + conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._out_lock:
            peers = list(self._out.items())
        for dest, peer in peers:
            with peer.lock:
                # a frame sent right before close() (an eof, a final
                # ack) may still sit in the coalescing batch — put it
                # on the wire before the connection dies
                self._flush_batch(peer, dest)
                self._drop_conn(peer)
        for th in self._threads:
            th.join(timeout=2 * self._probe_s())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def gc(self, src: int, tag: int = 0) -> int:
        """Frames are freed as they are consumed; nothing to prune
        (the transport calls this on planes that need it)."""
        return 0

    # -- sender face -----------------------------------------------------

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        if dest == self.process_index:
            raise RuntimeError("send_obj to self has no wire")
        payload = pickle.dumps(obj)
        peer = self._peer(dest)
        with peer.lock:
            # connect (and handshake) BEFORE drawing a seq: the
            # HELLO-ACK seeds this peer's counters from the receiver's
            # consumed position, so a reborn sender's very first frame
            # already carries a never-before-used sequence number
            sock = self._conn(peer, dest)
            seq = peer.seq.get(tag, 0)
            # the frame owns this seq even if delivery fails — a lost
            # seq is a hole the next HELLO advertises, mirroring
            # FsObjectPlane's never-reuse discipline
            peer.seq[tag] = seq + 1
            frame = _encode_frame(_KIND_OBJ, self.process_index,
                                  tag, seq, payload)
            fault = _chaos.on_socket("send")
            if fault is not None:
                self._apply_send_fault(peer, dest, frame, fault)
                return
            if sock is None:
                # connect budget already exhausted under the ladder —
                # the frame is lost; the layer above re-sends
                peer.mark_lost()
                self.stats["send_dropped"] += 1
                return
            if len(frame) < self.coalesce_bytes:
                if not peer.batch:
                    peer.batch_since = time.monotonic()
                peer.batch.append(frame)
                peer.batch_bytes += len(frame)
                self.stats["batched_frames"] += 1
                if (len(peer.batch) >= self.coalesce_frames
                        or peer.batch_bytes >= self.coalesce_bytes):
                    self._flush_batch(peer, dest)
                return
            self._flush_batch(peer, dest)
            self._write(peer, dest, frame)

    def _peer(self, dest: int) -> _PeerOut:
        with self._out_lock:
            peer = self._out.get(dest)
            if peer is None:
                peer = self._out[dest] = _PeerOut()
            return peer

    def _apply_send_fault(self, peer: _PeerOut, dest: int,
                          frame: bytes, fault: str) -> None:
        """Injected connection fault (chaos.on_socket): the batch is
        flushed first so only THIS frame is hit. The connection dies
        (for ``partial_write``, with a torn half-frame on the wire the
        reader will discard at EOF) — then the SAME frame is re-sent
        through the reconnect ladder. Against a live peer a connection
        fault costs a redial, never a frame: the plane must not leak
        loss to ack-less traffic (ctrl frames) riding above it."""
        self._flush_batch(peer, dest)
        sock = self._conn(peer, dest)
        if fault == "partial_write" and sock is not None:
            try:
                sock.sendall(frame[:max(1, len(frame) // 2)])
            except OSError:
                pass
        self._drop_conn(peer)
        self.stats["reconnects"] += 1
        self.stats["resent_frames"] += 1
        self._write(peer, dest, frame)

    def _conn(self, peer: _PeerOut,
              dest: int) -> Optional[socket.socket]:
        """The live connection to ``dest``, dialing + handshaking under
        the backoff ladder if needed (caller holds ``peer.lock``)."""
        if peer.sock is not None:
            return peer.sock
        for attempt in range(self.CONNECT_ATTEMPTS):
            if self._stop.is_set():
                return None
            try:
                sock = socket.create_connection(
                    self.endpoints[dest], timeout=self._probe_s())
                sock.settimeout(self._probe_s())
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
                self._handshake(sock, peer)
                if peer.sock is None:
                    self.stats["connects"] += 1
                else:  # pragma: no cover — replaced conn (defensive)
                    self.stats["reconnects"] += 1
                peer.sock = sock
                return sock
            except (OSError, TimeoutError, pickle.PickleError,
                    ValueError):
                # connect refused/timed out, or a half-open peer ate
                # the HELLO without answering: back off and redial
                if attempt + 1 < self.CONNECT_ATTEMPTS:
                    time.sleep(self.policy.backoff_ms(attempt) / 1000.0)
        return None

    def _handshake(self, sock: socket.socket, peer: _PeerOut) -> None:
        """HELLO → HELLO-ACK within one probe budget, or the connection
        is unusable (half-open detection). Seeds this sender's seq
        counters from the receiver's consumed positions so a reborn
        incarnation never reuses a sequence number."""
        hello = {"src": self.process_index,
                 "incarnation": self.incarnation,
                 "seqs": dict(peer.lost)}
        payload = pickle.dumps(hello)
        sock.sendall(_encode_frame(_KIND_HELLO, self.process_index,
                                   0, 0, payload))
        kind, _src, _tag, _seq, ack = self._read_frame(sock)
        if kind != _KIND_HELLO_ACK:
            raise ValueError(f"expected HELLO-ACK, got kind {kind}")
        positions = pickle.loads(ack).get("positions", {})
        for tag, pos in positions.items():
            peer.seq[int(tag)] = max(peer.seq.get(int(tag), 0), int(pos))
        self.stats["hellos"] += 1

    def _drop_conn(self, peer: _PeerOut) -> None:
        if peer.sock is not None:
            try:
                peer.sock.close()
            except OSError:
                pass
            peer.sock = None
        peer.batch, peer.batch_bytes = [], 0
        peer.mark_lost()

    def _write(self, peer: _PeerOut, dest: int, data: bytes) -> None:
        """Put bytes on the wire, reconnecting once per attempt under
        the ladder; exhaustion counts the frame dropped (the transport
        above re-sends — loss here is a NACK/timeout there)."""
        for attempt in range(self.CONNECT_ATTEMPTS):
            sock = self._conn(peer, dest)
            if sock is None:
                break
            try:
                sock.sendall(data)
                self.stats["frames_sent"] += 1
                self.stats["bytes_sent"] += len(data)
                return
            except OSError:
                # send timeout or RST: half-open/dead conn — tear down,
                # back off, re-handshake, retry the same bytes
                self._drop_conn(peer)
                self.stats["reconnects"] += 1
                if attempt + 1 < self.CONNECT_ATTEMPTS:
                    time.sleep(self.policy.backoff_ms(attempt) / 1000.0)
        peer.mark_lost()
        self.stats["send_dropped"] += 1

    def _flush_batch(self, peer: _PeerOut, dest: int) -> None:
        if not peer.batch:
            return
        data = b"".join(peer.batch)
        n = len(peer.batch)
        peer.batch, peer.batch_bytes = [], 0
        self.stats["flushes"] += 1
        self._write(peer, dest, data)
        self.stats["frames_sent"] += n - 1   # _write counted one

    def _flush_loop(self) -> None:
        """Background flusher: closes every coalescing window within
        ``coalesce_ms`` so a lone ack never waits on more traffic."""
        while not self._stop.is_set():
            time.sleep(self.coalesce_ms / 1000.0)
            with self._out_lock:
                items = list(self._out.items())
            now = time.monotonic()
            for dest, peer in items:
                with peer.lock:
                    if (peer.batch and now - peer.batch_since
                            >= self.coalesce_ms / 1000.0):
                        self._flush_batch(peer, dest)

    # -- receiver face ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            _chaos.on_socket("accept")
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return                     # listener closed
            conn.settimeout(self._probe_s())
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            self._spawn(lambda c=conn: self._reader(c), "sockplane-read")

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("peer closed")
            buf += part
        return buf

    def _read_frame(self, sock: socket.socket):
        """One framed message off ``sock``; raises on torn/corrupt
        bytes (the caller drops the connection — resync happens at the
        next handshake, never inside a damaged stream)."""
        while True:
            try:
                hdr = self._read_exact(sock, _HDR.size)
                break
            except socket.timeout:
                if self._stop.is_set():
                    raise ConnectionError("plane closed") from None
        magic, kind, src, tag, seq, length, digest = _HDR.unpack(hdr)
        if magic != _MAGIC:
            raise ValueError("bad frame magic (desynced stream)")
        payload = self._read_exact(sock, length)
        if hashlib.sha256(payload).digest() != digest:
            raise ValueError("frame sha256 mismatch")
        return kind, src, tag, seq, payload

    def _reader(self, conn: socket.socket) -> None:
        src = None
        try:
            while not self._stop.is_set():
                try:
                    kind, fsrc, tag, seq, payload = self._read_frame(conn)
                except socket.timeout:
                    continue               # idle conn: keep listening
                if kind == _KIND_HELLO:
                    src = self._on_hello(conn, payload)
                elif kind == _KIND_OBJ:
                    self._on_obj(fsrc, tag, seq, payload)
                self.stats["frames_recv"] += 1
                self.stats["bytes_recv"] += _HDR.size + len(payload)
        except (ConnectionError, ValueError, OSError) as e:
            if isinstance(e, ValueError):
                self.stats["corrupt_frames"] += 1
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _on_hello(self, conn: socket.socket, payload: bytes) -> int:
        hello = pickle.loads(payload)
        src = int(hello["src"])
        with self._cond:
            for tag, nxt in hello.get("seqs", {}).items():
                chan = (src, int(tag))
                # frames below the sender's announced counter that we
                # neither consumed nor hold are lost with the old
                # connection: known holes the read path may skip
                self._floor[chan] = max(self._floor.get(chan, 0),
                                        int(nxt))
            # consumed position, pushed past anything still buffered
            # from the old incarnation, so a reborn sender seeded from
            # it can never collide with an undelivered frame
            positions: Dict[int, int] = {}
            for (s, tag), pos in self._pos.items():
                if s == src:
                    positions[tag] = pos
            for (s, tag), pending in self._buf.items():
                if s == src and pending:
                    positions[tag] = max(positions.get(tag, 0),
                                         max(pending) + 1)
            self._cond.notify_all()
        ack = pickle.dumps({"positions": positions,
                            "incarnation": self.incarnation})
        conn.sendall(_encode_frame(_KIND_HELLO_ACK, self.process_index,
                                   0, 0, ack))
        return src

    def _on_obj(self, src: int, tag: int, seq: int,
                payload: bytes) -> None:
        chan = (src, tag)
        with self._cond:
            if seq < self._pos.get(chan, 0):
                self.stats["stale_frames"] += 1   # already consumed
                return
            self._buf.setdefault(chan, {})[seq] = payload
            self._cond.notify_all()

    def recv_obj(self, src: int, tag: int = 0) -> Any:
        return self.try_recv_obj(src, tag,
                                 timeout_ms=self.policy.timeout_ms)

    def try_recv_obj(self, src: int, tag: int = 0,
                     timeout_ms: Optional[int] = None) -> Any:
        """Bounded receive; the reader position advances only on
        success, so a timed-out poll retries the same slot later.
        Holes below the re-handshake floor (frames lost with a dead
        connection) are skipped — their payloads re-arrive under fresh
        sequence numbers when the layer above re-sends."""
        if timeout_ms is None:
            timeout_ms = self.policy.timeout_ms
        deadline = time.monotonic() + max(0, timeout_ms) / 1000.0
        chan = (src, tag)
        with self._cond:
            while True:
                pos = self._pos.get(chan, 0)
                buf = self._buf.get(chan, {})
                floor = self._floor.get(chan, 0)
                while pos < floor and pos not in buf:
                    pos += 1               # known-lost hole: skip
                if pos in buf:
                    payload = buf.pop(pos)
                    self._pos[chan] = pos + 1
                    return pickle.loads(payload)
                # position commits only on delivery — a skipped hole
                # is re-evaluated next poll, so a frame that was
                # merely slow (not lost) is never discarded
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"no object on channel {chan} within "
                        f"{timeout_ms} ms")
                self._cond.wait(timeout=min(left, self._probe_s()))
