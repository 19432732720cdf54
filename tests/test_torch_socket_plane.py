"""SocketObjectPlane: the real TCP data plane, tier-1 and drilled.

Tier-1 (threads, no subprocesses): framed round-trips, bounded
receives, coalescing (including the close()-flushes-the-batch
contract), restart fencing via the HELLO/HELLO-ACK seq handshake,
connection-level chaos (``reset_conn``, ``partial_write``,
``stall_accept``), and the full ObjectPlaneTransport protocol over a
real socket pair — plus a 2-process ``fleet_lm --transport socket``
smoke. Slow: the transport's wire-chaos matrix and the mid-transfer SIGKILL
drill re-run over TCP, m×n, against the same bitwise single-engine
oracle.

The port's copy of ``tests/fleet_tests/test_socket_plane.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from chainermn_torch.comm.socket_plane import (SocketObjectPlane,
                                             pick_free_endpoints)
from chainermn_torch.fleet.handoff import decode_handoff, encode_handoff
from chainermn_torch.fleet.transport import ObjectPlaneTransport
from chainermn_torch.resilience import chaos
from chainermn_torch.resilience.policy import RpcPolicy

from tests.test_torch_fleet_fake import FakeEngine

_FAST = RpcPolicy(timeout_ms=2000, probe_ms=100)
#: the tag of a frame sent to an endpoint nobody listens on: it has no
#: receiver by design
_DEAD_PEER_TAG = 22


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)


@pytest.fixture
def plane_pair():
    planes = []

    def make(n=2, **kw):
        eps = pick_free_endpoints(n)
        out = [SocketObjectPlane(eps, i, pol=kw.pop("pol", _FAST), **kw)
               for i in range(n)]
        planes.extend(out)
        return out

    yield make
    for p in planes:
        p.close()


def test_round_trip_in_order_both_directions(plane_pair):
    a, b = plane_pair()
    for n in (1, 2, 3):
        a.send_obj({"n": n}, 1, tag=11)
    b.send_obj({"back": True}, 0, tag=12)
    for n in (1, 2, 3):
        assert b.try_recv_obj(0, tag=11, timeout_ms=2000)["n"] == n
    assert a.try_recv_obj(1, tag=12, timeout_ms=2000)["back"] is True


def test_timeout_does_not_consume_position(plane_pair):
    a, b = plane_pair()
    with pytest.raises(TimeoutError):
        b.try_recv_obj(0, tag=13, timeout_ms=50)
    a.send_obj({"n": 1}, 1, tag=13)
    assert b.try_recv_obj(0, tag=13, timeout_ms=2000)["n"] == 1


def test_tuple_endpoints_accepted():
    eps = pick_free_endpoints(2)
    split = [tuple(e.rsplit(":", 1)) for e in eps]
    a = SocketObjectPlane(split, 0, pol=_FAST)
    b = SocketObjectPlane(eps, 1, pol=_FAST)
    try:
        a.send_obj({"n": 1}, 1, tag=14)
        assert b.try_recv_obj(0, tag=14, timeout_ms=2000)["n"] == 1
    finally:
        a.close()
        b.close()


def test_send_to_self_rejected(plane_pair):
    (a,) = plane_pair(n=1)
    with pytest.raises(RuntimeError, match="self"):
        a.send_obj({"n": 1}, 0)


def test_small_frames_coalesce_and_all_deliver(plane_pair):
    a, b = plane_pair()
    for n in range(40):                # well past coalesce_frames=16
        a.send_obj({"n": n}, 1, tag=16)
    for n in range(40):
        assert b.try_recv_obj(0, tag=16, timeout_ms=2000)["n"] == n
    assert a.stats["batched_frames"] >= 40
    assert 0 < a.stats["flushes"] < 40  # fewer writes than frames


def test_close_flushes_the_coalescing_batch():
    """A frame sent right before close() (an eof, a final ack) must hit
    the wire, not die in the batch buffer with the connection."""
    eps = pick_free_endpoints(2)
    a = SocketObjectPlane(eps, 0, pol=_FAST)
    b = SocketObjectPlane(eps, 1, pol=_FAST)
    try:
        a.send_obj({"eof": True}, 1, tag=17)
        a.close()                      # immediately: batch still open
        assert b.try_recv_obj(0, tag=17, timeout_ms=2000)["eof"] is True
    finally:
        a.close()
        b.close()


def test_reborn_sender_never_reuses_seq(plane_pair):
    """The HELLO-ACK seeds a fresh incarnation's counters from the
    receiver's consumed position: the reborn sender's first frame is a
    NEW sequence number, delivered — never a stale replay."""
    eps = pick_free_endpoints(2)
    b = SocketObjectPlane(eps, 1, pol=_FAST)
    a = SocketObjectPlane(eps, 0, pol=_FAST, incarnation=0)
    try:
        a.send_obj({"n": 1}, 1, tag=18)
        assert b.try_recv_obj(0, tag=18, timeout_ms=2000)["n"] == 1
        a.close()                                  # SIGKILL stand-in
        reborn = SocketObjectPlane(eps, 0, pol=_FAST, incarnation=1)
        try:
            # fresh counters: seeded from the consumed position
            reborn.send_obj({"n": 2}, 1, tag=18)
            assert b.try_recv_obj(0, tag=18, timeout_ms=2000)["n"] == 2
        finally:
            reborn.close()
        assert b.stats["stale_frames"] == 0
    finally:
        a.close()
        b.close()


def test_reset_conn_resends_the_frame_on_a_fresh_connection(
        monkeypatch, plane_pair):
    """``reset_conn`` kills the connection under the frame; the plane
    redials and re-sends the SAME frame — against a live peer a
    connection fault costs a reconnect, never a frame (ctrl traffic
    above the plane has no ack/re-send of its own)."""
    monkeypatch.setenv(chaos.ENV_VAR, "reset_conn@times=1")
    a, b = plane_pair()
    a.send_obj({"n": 1}, 1, tag=19)  # faulted, then re-sent
    a.send_obj({"n": 2}, 1, tag=19)
    assert b.try_recv_obj(0, tag=19, timeout_ms=2000)["n"] == 1
    assert b.try_recv_obj(0, tag=19, timeout_ms=2000)["n"] == 2
    assert a.stats["resent_frames"] == 1
    assert a.stats["send_dropped"] == 0
    assert a.stats["reconnects"] >= 1


def test_partial_write_never_delivers_damaged_bytes(monkeypatch,
                                                    plane_pair):
    """Half a frame then RST: the reader discards the torn bytes at
    EOF, and the plane re-sends the frame whole on a fresh connection
    — the damaged payload is never surfaced, the frame never lost."""
    monkeypatch.setenv(chaos.ENV_VAR, "partial_write@times=1")
    a, b = plane_pair()
    a.send_obj({"n": 1}, 1, tag=20)  # torn mid-frame, then re-sent
    a.send_obj({"n": 2}, 1, tag=20)
    assert b.try_recv_obj(0, tag=20, timeout_ms=2000)["n"] == 1
    assert b.try_recv_obj(0, tag=20, timeout_ms=2000)["n"] == 2
    assert a.stats["resent_frames"] == 1
    with pytest.raises(TimeoutError):  # no third (ghost) delivery
        b.try_recv_obj(0, tag=20, timeout_ms=100)


def test_genuinely_lost_frame_becomes_a_skipped_hole():
    """A frame lost for real (connect ladder exhausted: no listener
    yet) is a hole; once the peer exists, the next send's HELLO
    advertises the lost HWM and the receiver skips past the hole
    instead of waiting forever."""
    eps = pick_free_endpoints(2)
    a = SocketObjectPlane(eps, 0,
                          pol=RpcPolicy(timeout_ms=500, probe_ms=50))
    b = None
    try:
        a.send_obj({"n": 1}, 1, tag=15)  # no listener: exhausts, lost
        assert a.stats["send_dropped"] == 1
        b = SocketObjectPlane(eps, 1, pol=_FAST)
        a.send_obj({"n": 2}, 1, tag=15)  # reconnect + lost-HWM HELLO
        assert b.try_recv_obj(0, tag=15, timeout_ms=2000)["n"] == 2
    finally:
        a.close()
        if b is not None:
            b.close()


def test_stall_accept_is_bounded_not_fatal(monkeypatch, plane_pair):
    """A wedged acceptor delays the connect; the bounded ladder rides
    it out and the frame still lands."""
    monkeypatch.setenv(chaos.ENV_VAR, "stall_accept@ms=150,times=1")
    a, b = plane_pair()
    a.send_obj({"n": 1}, 1, tag=21)
    assert b.try_recv_obj(0, tag=21, timeout_ms=5000)["n"] == 1


def test_connect_to_dead_peer_drops_not_hangs():
    """No listener at the far endpoint: the bounded connect ladder
    exhausts and counts the frame dropped — send_obj never blocks
    unbounded and never raises."""
    eps = pick_free_endpoints(2)
    a = SocketObjectPlane(eps, 0,
                          pol=RpcPolicy(timeout_ms=500, probe_ms=50))
    try:
        t0 = time.monotonic()
        a.send_obj({"n": 1}, 1, tag=_DEAD_PEER_TAG)
        assert time.monotonic() - t0 < 10.0
        assert a.stats["send_dropped"] == 1
    finally:
        a.close()


# ---------------------------------------------------------------------------
# ObjectPlaneTransport over the real socket wire
# ---------------------------------------------------------------------------


def _fake_handoff():
    eng = FakeEngine(n_slots=1, max_new_tokens=4)
    req = eng.submit([3, 1, 4], max_new_tokens=1, seed=9, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104
    return encode_handoff(eng.export_handoff(req), "f32")


def _pump(receiver, stop, arrivals):
    while not stop.is_set():
        arrivals.extend(receiver.poll(timeout_ms=50))


def test_transport_protocol_adopts_bitwise_over_tcp(plane_pair):
    manifest, blob = _fake_handoff()
    pa, pb = plane_pair()
    sender = ObjectPlaneTransport(pa, peer=1, pol=_FAST)
    receiver = ObjectPlaneTransport(pb, peer=0, pol=_FAST)
    stop, arrivals = threading.Event(), []
    th = threading.Thread(target=_pump, args=(receiver, stop, arrivals),
                          daemon=True)
    th.start()
    try:
        assert sender.send(5, manifest, blob) == "adopted"
        assert sender.send(5, manifest, blob) == "duplicate"
    finally:
        stop.set()
        th.join()
    (arr,) = arrivals
    out = decode_handoff(arr.manifest, arr.blob)
    assert out["tokens"] and arr.stream_id == 5
    assert receiver.receiver_stats["duplicates"] == 1


def test_transport_fence_survives_reborn_sender_over_tcp(plane_pair):
    """A prefill host SIGKILLed after its stream was adopted replays
    it with a fresh transport + fresh plane incarnation: the receiver's
    resolved fence answers ``duplicate`` across the restart."""
    manifest, blob = _fake_handoff()
    eps = pick_free_endpoints(2)
    pb = SocketObjectPlane(eps, 1, pol=_FAST)
    receiver = ObjectPlaneTransport(pb, peer=0, pol=_FAST)
    pa = SocketObjectPlane(eps, 0, pol=_FAST, incarnation=0)
    sender = ObjectPlaneTransport(pa, peer=1, pol=_FAST)
    stop, arrivals = threading.Event(), []
    th = threading.Thread(target=_pump, args=(receiver, stop, arrivals),
                          daemon=True)
    th.start()
    try:
        assert sender.send(5, manifest, blob) == "adopted"
        pa.close()                                 # SIGKILL stand-in
        pa2 = SocketObjectPlane(eps, 0, pol=_FAST, incarnation=1)
        try:
            reborn = ObjectPlaneTransport(pa2, peer=1, pol=_FAST)
            assert reborn.send(5, manifest, blob) == "duplicate"
        finally:
            pa2.close()
    finally:
        stop.set()
        th.join()
        pa.close()
        pb.close()
    assert len(arrivals) == 1          # the replay never re-surfaced


# ---------------------------------------------------------------------------
# fleet_lm over the socket wire: tier-1 smoke + the slow drill matrix
# ---------------------------------------------------------------------------

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_LM = ["-m", "chainermn_torch.tools.fleet_lm", "--device", "cpu"]

N_REQ, PROMPT_LEN, MAX_NEW, SEED = 4, 4, 5, 0


def _cmd(rank, tmp, endpoints, *, hosts=2, prefill_hosts=1,
         deadline_s=120, n_req=N_REQ, max_new=MAX_NEW, streamed=True):
    argv = [sys.executable, *FLEET_LM,
            "--out", str(tmp / "streams.jsonl"),
            "--report", str(tmp / "report.json"),
            "--hosts", str(hosts), "--host-rank", str(rank),
            "--prefill-hosts", str(prefill_hosts),
            "--transport", "socket", "--endpoints", ",".join(endpoints),
            "--handoff-deadline-s", str(deadline_s),
            "--requests", str(n_req), "--prompt-len", str(PROMPT_LEN),
            "--max-new-tokens", str(max_new), "--n-layers", "1",
            "--seed", str(SEED)]
    if streamed:
        argv.append("--streamed")
    return argv


def _env(chaos_spec=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT
    env.pop("CHAINERMN_TPU_CHAOS", None)
    # a decode host mid-compile must not look like a dead peer: give
    # each ack wait a wide bounded budget (still a deadline, not forever)
    env["CHAINERMN_TPU_RPC_PROBE_MS"] = "30000"
    if chaos_spec:
        env["CHAINERMN_TPU_CHAOS"] = chaos_spec
    return env


def _merged_rows(tmp):
    rows, ids = {}, []
    import glob
    for path in sorted(glob.glob(str(tmp / "streams.jsonl") + "*")):
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                rows[r["request_id"]] = r
                ids.append(r["request_id"])
    return rows, ids


def _run_fleet(tmp, *, hosts=2, prefill_hosts=1, chaos_prefill=None,
               deadline_s=120, n_req=N_REQ, max_new=MAX_NEW,
               timeout=500):
    eps = pick_free_endpoints(hosts)
    procs = []
    for rank in range(1, hosts):
        is_prefill = rank < prefill_hosts
        procs.append(subprocess.Popen(
            _cmd(rank, tmp, eps, hosts=hosts,
                 prefill_hosts=prefill_hosts, deadline_s=deadline_s,
                 n_req=n_req, max_new=max_new),
            env=_env(chaos_prefill if is_prefill else None),
            stderr=subprocess.PIPE, text=True))
    try:
        r0 = subprocess.run(
            _cmd(0, tmp, eps, hosts=hosts, prefill_hosts=prefill_hosts,
                 deadline_s=deadline_s, n_req=n_req, max_new=max_new),
            env=_env(chaos_prefill), capture_output=True, text=True,
            timeout=timeout)
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    except Exception:
        for p in procs:
            p.kill()
        raise
    assert r0.returncode == 0, r0.stderr[-2000:]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-2000:]


def test_fleet_lm_socket_smoke(tmp_path):
    """Tier-1: a real 2-process serve over TCP drains every stream
    exactly once and ships mergeable reports with transport counters.
    (Bitwise-vs-oracle lives in the slow drills — this smoke skips the
    in-process oracle to stay inside the tier-1 budget.)"""
    _run_fleet(tmp_path, n_req=2, max_new=3)
    rows, ids = _merged_rows(tmp_path)
    assert sorted(rows) == [0, 1] and sorted(ids) == [0, 1]
    assert all(len(r["tokens"]) == 3 for r in rows.values())
    with open(str(tmp_path / "report.json") + ".h0") as f:
        wire = json.load(f)
    counters = wire["fleet"]["counters"]
    assert "transport_retransmits" in counters    # wire health shipped
    assert counters["handoffs"] == 2


@pytest.mark.slow
class TestSocketDrills:
    """The transport's wire-chaos matrix + SIGKILL, re-run over real TCP."""

    def _oracle(self, n_req=N_REQ, max_new=MAX_NEW):
        """One in-process engine on fleet_lm's own seeded model."""
        from chainermn_torch.tools import fleet_lm

        args = fleet_lm.parse_args(
            ["--out", "unused", "--device", "cpu", "--n-layers", "1",
             "--max-new-tokens", str(max_new), "--seed", str(SEED)])
        eng = fleet_lm._engine_factory(args)()
        rng = np.random.RandomState(SEED)
        refs = {}
        for i in range(n_req):
            p = rng.randint(0, 43, (PROMPT_LEN,)).astype(np.int32)
            refs[i] = (p.tolist(), eng.submit(p, seed=SEED + i))
        eng.run_until_drained()
        return {i: (p, req.tokens) for i, (p, req) in refs.items()}

    def _check_bitwise(self, tmp, n_req=N_REQ):
        rows, ids = _merged_rows(tmp)
        assert sorted(rows) == list(range(n_req)), (
            f"fleet did not drain: got ids {sorted(rows)}")
        assert sorted(ids) == list(range(n_req)), (
            f"duplicated emission: {sorted(ids)}")
        for i, (prompt, tokens) in self._oracle(n_req).items():
            assert rows[i]["prompt"] == prompt
            assert rows[i]["tokens"] == tokens, (
                f"stream {i} diverged from the single-engine oracle")

    def test_socket_two_host_streamed_bitwise(self, tmp_path):
        _run_fleet(tmp_path)
        self._check_bitwise(tmp_path)

    def test_socket_mxn_bitwise(self, tmp_path):
        """2 prefill hosts × 2 decode hosts, streamed, over TCP: every
        stream lands bitwise on whichever decode host the least-
        shipped choice routed it to."""
        _run_fleet(tmp_path, hosts=4, prefill_hosts=2)
        self._check_bitwise(tmp_path)

    def test_socket_wire_and_conn_chaos_heals_bitwise(self, tmp_path):
        """Frame-level faults (drop/dup/corrupt/delay) AND connection-
        level faults (RST with the frame, torn half-frame, wedged
        acceptor) each fire once on the prefill side: the protocol
        absorbs all of them and every stream still lands bitwise."""
        spec = ("drop_handoff@times=1;dup_handoff@times=1;"
                "corrupt_handoff@offset=0,times=1;"
                "delay_handoff@ms=50,times=1;reset_conn@times=1;"
                "partial_write@times=1;stall_accept@ms=200,times=1")
        _run_fleet(tmp_path, chaos_prefill=spec)
        self._check_bitwise(tmp_path)

    def test_socket_persistent_corruption_falls_back_bitwise(
            self, tmp_path):
        """EVERY delivery corrupts: the per-chunk NACK budget exhausts
        and each stream re-prefills from seed — still bitwise, with
        the fallback's defect history naming the dead chunk."""
        from chainermn_torch.fleet import FleetReport

        _run_fleet(tmp_path, chaos_prefill="corrupt_handoff@offset=0")
        self._check_bitwise(tmp_path)
        merged = FleetReport()
        for rank in (0, 1):
            with open(str(tmp_path / "report.json") + f".h{rank}") as f:
                merged.absorb(FleetReport.from_wire(
                    json.load(f)["fleet"]))
        assert merged.handoff_fallbacks >= N_REQ
        rows, _ids = _merged_rows(tmp_path)
        reasons = [r.get("fallback_reason", "") for r in rows.values()]
        assert any("chunk" in why for why in reasons), reasons

    def test_socket_sigkill_prefill_mid_transfer_heals_bitwise(
            self, tmp_path):
        """Chaos SIGKILLs the real prefill process at its third
        conveyor iteration — frames possibly mid-TCP-stream — and the
        Supervisor restarts it as a new plane incarnation. The HELLO
        handshake fences the dead incarnation's seqs, the receiver's
        resolved fences answer replays ``duplicate``, and the merged
        output is bitwise the oracle."""
        from chainermn_torch.resilience.supervisor import Supervisor

        eps = pick_free_endpoints(2)
        deadline_s = 300
        decode = subprocess.Popen(
            _cmd(1, tmp_path, eps, deadline_s=deadline_s), env=_env(),
            stderr=subprocess.PIPE, text=True)
        try:
            sup = Supervisor(
                _cmd(0, tmp_path, eps, deadline_s=deadline_s),
                max_restarts=3, window_s=600.0,
                env=_env("kill@step=2,run=0"),
                policy=RpcPolicy(timeout_ms=5000, probe_ms=1000))
            rc = sup.run()
            d_err = decode.communicate(timeout=500)[1]
        except Exception:
            decode.kill()
            raise
        assert rc == 0
        assert decode.returncode == 0, d_err[-2000:]
        kinds = [r.kind for r in sup.history]
        assert kinds[0] == "crash", kinds   # SIGKILL really landed
        assert kinds[-1] == "clean"
        self._check_bitwise(tmp_path)


# ---------------------------------------------------------------------------
# a JAX host and a port host share one TCP wire
# ---------------------------------------------------------------------------

from chainermn_tpu.comm import socket_plane as jax_socket  # noqa: E402
from chainermn_tpu.fleet import handoff as jax_handoff  # noqa: E402
from chainermn_tpu.fleet import transport as jax_transport  # noqa: E402
from chainermn_tpu.resilience.policy import RpcPolicy as JaxRpcPolicy  # noqa: E402,E501


def test_encode_frame_is_jaxs():
    from chainermn_torch.comm import socket_plane as ours

    for kind, src, tag, seq, payload in ((1, 0, 7001, 0, b""),
                                         (2, 3, 7002, 41, b"x" * 300),
                                         (3, 1, 2**20, 2**40, b"\x00\xff")):
        assert ours._encode_frame(kind, src, tag, seq, payload) \
            == jax_socket._encode_frame(kind, src, tag, seq, payload)
    assert ours._HDR.size == jax_socket._HDR.size == 65


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_jax_host_and_a_port_host_exchange_handoffs_over_tcp(direction):
    frames = []
    for sid, (prompt, seed) in enumerate((([3, 1, 4], 9), ([5, 9], 2))):
        eng = FakeEngine(n_slots=1, max_new_tokens=4)
        req = eng.submit(prompt, max_new_tokens=1, seed=seed, hold=True)
        while not eng.held:
            eng.step()  # dlint: disable=DL104
        frames.append((sid, *encode_handoff(
            eng.export_handoff(req), ("f32", "int8-block")[sid])))
    eps = pick_free_endpoints(2)
    jpol = JaxRpcPolicy(timeout_ms=2000, probe_ms=100)
    if direction == "jax_to_port":
        pa = jax_socket.SocketObjectPlane(eps, 0, pol=jpol)
        pb = SocketObjectPlane(eps, 1, pol=_FAST)
        sender = jax_transport.ObjectPlaneTransport(pa, peer=1, pol=jpol)
        receiver = ObjectPlaneTransport(pb, peer=0, pol=_FAST)
        decode = decode_handoff
    else:
        pa = SocketObjectPlane(eps, 0, pol=_FAST)
        pb = jax_socket.SocketObjectPlane(eps, 1, pol=jpol)
        sender = ObjectPlaneTransport(pa, peer=1, pol=_FAST)
        receiver = jax_transport.ObjectPlaneTransport(pb, peer=0, pol=jpol)
        decode = jax_handoff.decode_handoff
    stop, arrivals = threading.Event(), []
    th = threading.Thread(target=_pump, args=(receiver, stop, arrivals),
                          daemon=True)
    th.start()
    try:
        assert [sender.send(s, m, b) for s, m, b in frames] \
            == ["adopted", "adopted"]
        assert sender.send(*frames[0]) == "duplicate"
    finally:
        stop.set()
        th.join(timeout=30)
        pa.close()
        pb.close()
    by_sid = {a.stream_id: a for a in arrivals}
    assert sorted(by_sid) == [0, 1]
    for sid, manifest, blob in frames:
        arr = by_sid[sid]
        assert arr.manifest == manifest and arr.blob == blob
        got, want = decode(arr.manifest, arr.blob), decode_handoff(
            manifest, blob)
        assert got["tokens"] == want["tokens"]
        assert got["key"].tolist() == want["key"].tolist()
        for blk in want["pages"]:
            for leaf in ("k", "v"):
                np.testing.assert_array_equal(
                    np.asarray(got["pages"][blk][leaf], np.float32),
                    want["pages"][blk][leaf])
