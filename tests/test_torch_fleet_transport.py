"""Handoff transport: framing, the fault matrix, and the fence.

Tier-1 (no devices, no subprocesses): the InProcessTransport runs the
full seq/SHA/NACK protocol against the chaos wire hook, and the
ObjectPlaneTransport runs the REAL cross-process protocol (acks, NACKs,
re-sends, duplicate fencing, restart continuation) over the in-memory
LoopbackPlane and the on-disk FsObjectPlane. Every fault ends in one of
exactly two outcomes: bitwise adoption, or a surfaced failure the
caller answers with a clean re-prefill — never a poisoned frame handed
to an engine.

The port's copy of ``tests/fleet_tests/test_transport.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import threading
import time

import numpy as np
import pytest

from chainermn_torch.comm.object_plane import FsObjectPlane
from chainermn_torch.fleet.handoff import decode_handoff, encode_handoff
from chainermn_torch.fleet.transport import (HANDOFF_ACK_TAG,
                                           HANDOFF_DATA_TAG,
                                           InProcessTransport,
                                           LoopbackPlane,
                                           ObjectPlaneTransport)
from chainermn_torch.resilience import chaos
from chainermn_torch.resilience.policy import RpcPolicy

from tests.test_torch_fleet_fake import FakeEngine


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)


def _fake_handoff(wire_format="f32"):
    """A real (manifest, blob) pair off the FakeEngine's handoff face —
    actual array bytes for the digest to verify."""
    eng = FakeEngine(n_slots=1, max_new_tokens=4)
    req = eng.submit([3, 1, 4], max_new_tokens=1, seed=9, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104
    handoff = eng.export_handoff(req)
    return encode_handoff(handoff, wire_format), handoff


# ---------------------------------------------------------------------------
# InProcessTransport: the protocol against the chaos wire
# ---------------------------------------------------------------------------


def test_clean_send_adopts_bitwise():
    (manifest, blob), handoff = _fake_handoff()
    t = InProcessTransport()
    assert t.send(5, manifest, blob) == "adopted"
    (arr,) = t.poll()
    assert arr.stream_id == 5 and not arr.failed
    out = decode_handoff(arr.manifest, arr.blob)
    np.testing.assert_array_equal(out["pages"]["block0"]["k"],
                                  handoff["pages"]["block0"]["k"])
    assert out["tokens"] == handoff["tokens"]
    assert t.receiver_stats["delivered"] == 1


def test_resend_of_adopted_stream_is_fenced():
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport()
    assert t.send(5, manifest, blob) == "adopted"
    assert t.send(5, manifest, blob) == "duplicate"
    assert len(t.poll()) == 1          # one arrival, not two
    assert t.receiver_stats["duplicates"] == 1


def test_resolve_fences_a_late_frame():
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport()
    t.resolve(5)                       # deadline fallback happened
    assert t.send(5, manifest, blob) == "duplicate"
    assert t.poll() == []


def test_truncated_frame_is_never_surfaced_intact():
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport(max_attempts=2)
    assert t.send(5, manifest, blob[:10]) == "failed"
    (arr,) = t.poll()
    assert arr.failed and arr.manifest is None
    assert t.receiver_stats["nacked"] == 1
    assert t.receiver_stats["failed"] == 1


@pytest.mark.parametrize("spec, expect_status", [
    ("drop_handoff@times=1", "adopted"),        # lost once, re-sent
    ("dup_handoff@times=1", "adopted"),         # delivered twice, deduped
    ("delay_handoff@ms=2,times=1", "adopted"),  # late but intact
    ("corrupt_handoff@offset=0,times=1", "adopted"),   # NACK → re-send
    ("corrupt_handoff@offset=0", "failed"),     # every attempt damaged
    ("corrupt_handoff@keep=10", "failed"),      # truncated every attempt
])
def test_wire_fault_matrix(monkeypatch, spec, expect_status):
    """Each wire fault ends in adoption or a clean surfaced failure."""
    monkeypatch.setenv(chaos.ENV_VAR, spec)
    (manifest, blob), handoff = _fake_handoff()
    t = InProcessTransport(max_attempts=4)
    status = t.send(5, manifest, blob)
    assert status == expect_status
    (arr,) = t.poll()
    if expect_status == "adopted":
        out = decode_handoff(arr.manifest, arr.blob)   # bitwise intact
        np.testing.assert_array_equal(out["key"], handoff["key"])
    else:
        assert arr.failed              # → caller re-prefills cleanly


def test_drop_once_costs_exactly_one_extra_attempt(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "drop_handoff@times=1")
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport(max_attempts=4)
    assert t.send(5, manifest, blob) == "adopted"
    assert t.stats["attempts"] == 2 and t.stats["dropped"] == 1


def test_dup_delivery_counts_one_duplicate(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "dup_handoff@times=1")
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport()
    assert t.send(5, manifest, blob) == "adopted"
    assert len(t.poll()) == 1
    assert t.receiver_stats["duplicates"] == 1


def test_persistent_drop_exhausts_and_surfaces(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "drop_handoff")
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport(max_attempts=3)
    assert t.send(5, manifest, blob) == "failed"
    assert t.stats["attempts"] == 3
    assert t.stats["send_failed"] == 1
    (arr,) = t.poll()
    assert arr.failed


# ---------------------------------------------------------------------------
# ObjectPlaneTransport over LoopbackPlane: the cross-process protocol
# ---------------------------------------------------------------------------

_FAST = RpcPolicy(timeout_ms=2000, probe_ms=100)


def _pair(plane=None):
    plane = plane or LoopbackPlane(2)
    sender = ObjectPlaneTransport(plane.endpoint(0), peer=1, pol=_FAST)
    receiver = ObjectPlaneTransport(plane.endpoint(1), peer=0, pol=_FAST)
    return sender, receiver


def _pump(receiver, stop, arrivals):
    while not stop.is_set():
        arrivals.extend(receiver.poll(timeout_ms=10))


def _with_receiver(receiver):
    """Context: a thread polling the receiver face (the sender's
    ``send`` blocks on acks, so the two faces must run concurrently —
    exactly the cross-process shape)."""
    stop = threading.Event()
    arrivals = []
    th = threading.Thread(target=_pump, args=(receiver, stop, arrivals),
                          daemon=True)
    th.start()
    return stop, th, arrivals


def test_loopback_clean_adopt_and_ack():
    (manifest, blob), handoff = _fake_handoff()
    sender, receiver = _pair()
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "adopted"
    finally:
        stop.set()
        th.join()
    (arr,) = arrivals
    out = decode_handoff(arr.manifest, arr.blob)
    assert out["tokens"] == handoff["tokens"]
    assert sender.stats["attempts"] == 1


def test_loopback_corrupt_once_nack_resend_heals(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=0,times=1")
    (manifest, blob), _ = _fake_handoff()
    sender, receiver = _pair()
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "adopted"
    finally:
        stop.set()
        th.join()
    assert len(arrivals) == 1 and not arrivals[0].failed
    assert sender.stats["attempts"] == 2            # NACK → one re-send
    assert receiver.receiver_stats["nacked"] == 1


def test_loopback_persistent_corruption_fails_cleanly(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=0")
    (manifest, blob), _ = _fake_handoff()
    sender, receiver = _pair(plane=None)
    sender.max_attempts = receiver._recv.max_attempts = 3
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "failed"
    finally:
        stop.set()
        th.join()
    # the receiver's give-up surfaced the stream for a clean re-prefill
    assert any(a.failed for a in arrivals)
    assert receiver.receiver_stats["failed"] == 1


def test_loopback_restarted_sender_is_fenced():
    """A restarted prefill host replays its streams with a FRESH seq
    counter; everything the receiver already resolved must answer
    ``duplicate`` — the fence the SIGKILL drill depends on."""
    (manifest, blob), _ = _fake_handoff()
    plane = LoopbackPlane(2)
    sender, receiver = _pair(plane)
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "adopted"
        reborn = ObjectPlaneTransport(plane.endpoint(0), peer=1,
                                      pol=_FAST)   # seq resets to 0
        assert reborn.send(3, manifest, blob) == "duplicate"
    finally:
        stop.set()
        th.join()
    assert len(arrivals) == 1          # the replay never re-arrived


def test_loopback_dead_receiver_send_is_bounded():
    """No receiver polling at all: send must return ``failed`` within
    its attempt x ack-budget envelope, never hang (the DL117 contract)."""
    (manifest, blob), _ = _fake_handoff()
    sender, _ = _pair()
    sender.max_attempts = 2
    t0 = time.monotonic()
    assert sender.send(3, manifest, blob) == "failed"
    assert time.monotonic() - t0 < 5.0
    assert sender.stats["ack_timeouts"] == 2


def test_loopback_garbage_on_channel_is_ignored():
    (manifest, blob), _ = _fake_handoff()
    plane = LoopbackPlane(2)
    sender, receiver = _pair(plane)
    ep = plane.endpoint(0)
    ep.send_obj("not a frame", 1, tag=HANDOFF_DATA_TAG)
    ep.send_obj({"kind": "mystery"}, 1, tag=HANDOFF_DATA_TAG)
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "adopted"
    finally:
        stop.set()
        th.join()
    assert len(arrivals) == 1


# ---------------------------------------------------------------------------
# FsObjectPlane: the restart-tolerant plane under the transport
# ---------------------------------------------------------------------------


def test_fs_plane_delivers_in_order(tmp_path):
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    a.send_obj({"n": 1}, 1, tag=4)
    a.send_obj({"n": 2}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2


def test_fs_plane_timeout_does_not_consume_position(tmp_path):
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    with pytest.raises(TimeoutError):
        b.try_recv_obj(0, tag=4, timeout_ms=10)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1


def test_fs_plane_restarted_sender_continues_seq(tmp_path):
    """A reborn sender derives its next seq from the files on disk —
    the receiver's channel position still lines up after a SIGKILL."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    reborn = FsObjectPlane(str(tmp_path), 0, 2)
    reborn.send_obj({"n": 2}, 1, tag=4)  # dlint: disable=DL102
    b = FsObjectPlane(str(tmp_path), 1, 2)
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2


def test_fs_plane_carries_the_full_transport_protocol(tmp_path):
    (manifest, blob), handoff = _fake_handoff()
    sender = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 0, 2),
                                  peer=1, pol=_FAST)
    receiver = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 1, 2),
                                    peer=0, pol=_FAST)
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(7, manifest, blob) == "adopted"
    finally:
        stop.set()
        th.join()
    (arr,) = arrivals
    assert decode_handoff(arr.manifest, arr.blob)["tokens"] \
        == handoff["tokens"]


# ---------------------------------------------------------------------------
# FsObjectPlane GC: consumed frames prune, fences and seqs survive
# ---------------------------------------------------------------------------


def _objs(chan_dir):
    import os
    try:
        return sorted(n for n in os.listdir(chan_dir)
                      if n.endswith(".obj"))
    except FileNotFoundError:
        return []


def test_fs_plane_gc_prunes_consumed_frames_only(tmp_path):
    """gc unlinks exactly the frames this receiver already consumed:
    the unread tail stays on disk and still delivers afterwards."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    for n in (1, 2, 3):
        a.send_obj({"n": n}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2
    assert b.gc(0, tag=4) == 2
    assert _objs(b._chan_dir(0, 1, 4)) == ["00000002.obj"]
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 3
    assert b.gc(0, tag=4) == 1         # and the tail prunes next round
    assert _objs(b._chan_dir(0, 1, 4)) == []


def test_fs_plane_gc_reborn_sender_continues_past_the_prune(tmp_path):
    """After a FULL prune the channel directory holds no .obj to count
    — a reborn sender must take its next seq from the HWM file, or it
    would re-issue seq 0 and the receiver (already past it) would hang
    forever on a slot that can never fill again."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    assert b.gc(0, tag=4) == 1
    reborn = FsObjectPlane(str(tmp_path), 0, 2)      # SIGKILL + restart
    reborn.send_obj({"n": 2}, 1, tag=4)  # dlint: disable=DL102
    assert _objs(b._chan_dir(0, 1, 4)) == ["00000001.obj"]
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2


def test_fs_plane_gc_reborn_receiver_seeds_from_hwm(tmp_path):
    """A restarted receiver's position starts at the HWM, not 0 — it
    must not wait on frames gc already unlinked."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    b.gc(0, tag=4)
    a.send_obj({"n": 2}, 1, tag=4)  # dlint: disable=DL102
    reborn = FsObjectPlane(str(tmp_path), 1, 2)      # SIGKILL + restart
    assert reborn.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2


def test_transport_gc_fence_survives_reborn_sender_after_prune(tmp_path):
    """The long-haul composition: the transport's built-in GC prunes
    both channels after a clean adopt, and a reborn sender replaying
    the resolved stream with a fresh counter STILL answers
    ``duplicate`` — the fence outlives the frames it was built from."""
    (manifest, blob), _ = _fake_handoff()
    sender = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 0, 2),
                                  peer=1, pol=_FAST)
    receiver = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 1, 2),
                                    peer=0, pol=_FAST)
    data_chan = receiver.plane._chan_dir(0, 1, HANDOFF_DATA_TAG)
    ack_chan = sender.plane._chan_dir(1, 0, HANDOFF_ACK_TAG)
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(3, manifest, blob) == "adopted"
        assert _objs(data_chan) == []    # receiver GCed the data frame
        assert _objs(ack_chan) == []     # sender GCed the consumed ack
        reborn = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 0, 2),
                                      peer=1, pol=_FAST)  # seq resets
        assert reborn.send(3, manifest, blob) == "duplicate"
    finally:
        stop.set()
        th.join()
    assert len(arrivals) == 1          # the replay never re-surfaced


# ---------------------------------------------------------------------------
# Satellite hardening: double-resolve and GC racing a reborn receiver
# ---------------------------------------------------------------------------


def test_resolve_called_twice_still_fences(tmp_path):
    """resolve() is idempotent: the deadline fallback and a late
    supervisor retry may both fence the same stream, and the second
    call must neither error nor un-fence — a frame arriving after
    either call still answers ``duplicate``."""
    (manifest, blob), _ = _fake_handoff()
    sender = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 0, 2),
                                  peer=1, pol=_FAST)
    receiver = ObjectPlaneTransport(FsObjectPlane(str(tmp_path), 1, 2),
                                    peer=0, pol=_FAST)
    receiver.resolve(9)
    receiver.resolve(9)                # second call: no-op, no error
    stop, th, arrivals = _with_receiver(receiver)
    try:
        assert sender.send(9, manifest, blob) == "duplicate"
    finally:
        stop.set()
        th.join()
    assert arrivals == []              # fenced frame never surfaced


def test_inprocess_resolve_twice_is_idempotent():
    (manifest, blob), _ = _fake_handoff()
    t = InProcessTransport()
    t.resolve(5)
    t.resolve(5)
    assert t.send(5, manifest, blob) == "duplicate"
    assert t.poll() == []


def test_fs_plane_gc_racing_reborn_receiver_seeds_lazily(tmp_path):
    """A reborn receiver CONSTRUCTED before the dying incarnation's gc
    commits must still land past the prune: the reader position seeds
    lazily from the HWM at FIRST ACCESS, not at __init__ — otherwise
    this interleaving (rebirth, then a straggler gc from the old
    incarnation) waits forever on frames that no longer exist."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    a.send_obj({"n": 2}, 1, tag=4)  # absorbed by the line above
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 2
    reborn = FsObjectPlane(str(tmp_path), 1, 2)   # born BEFORE the gc
    assert b.gc(0, tag=4) == 2                    # straggler gc lands
    a.send_obj({"n": 3}, 1, tag=4)  # dlint: disable=DL102
    # first channel access AFTER the prune: seeds from HWM=2, not 0
    assert reborn.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 3


def test_fs_plane_gc_concurrent_with_inflight_recv(tmp_path):
    """gc never unlinks seq >= position, so a receive in flight on the
    unread slot survives any number of concurrent gc passes — the
    frame lands mid-race and is delivered, not re-deleted."""
    a = FsObjectPlane(str(tmp_path), 0, 2)
    b = FsObjectPlane(str(tmp_path), 1, 2)
    a.send_obj({"n": 1}, 1, tag=4)  # dlint: disable=DL102
    assert b.try_recv_obj(0, tag=4, timeout_ms=500)["n"] == 1
    got = []

    def _recv():
        got.append(b.try_recv_obj(0, tag=4, timeout_ms=5000))

    th = threading.Thread(target=_recv, daemon=True)
    th.start()                         # polls the empty seq-1 slot
    for _ in range(20):                # gc storms while the poll spins
        b.gc(0, tag=4)
        time.sleep(0.002)
    a.send_obj({"n": 2}, 1, tag=4)  # dlint: disable=DL102
    th.join(timeout=10)
    assert not th.is_alive()
    assert got and got[0]["n"] == 2
    b.gc(0, tag=4)                     # and the consumed frame prunes
    assert _objs(b._chan_dir(0, 1, 4)) == []


# ---------------------------------------------------------------------------
# a JAX host and a port host share one FsObjectPlane
# ---------------------------------------------------------------------------

from chainermn_tpu.comm import object_plane as jax_plane  # noqa: E402
from chainermn_tpu.fleet import handoff as jax_handoff  # noqa: E402
from chainermn_tpu.fleet import transport as jax_transport  # noqa: E402
from chainermn_tpu.resilience.policy import RpcPolicy as JaxRpcPolicy  # noqa: E402,E501

_JAX_FAST = JaxRpcPolicy(timeout_ms=2000, probe_ms=100)


def _interop_frames():
    """Three handoffs a port host would ship: an f32 and an int8-block
    prefill handoff and an f32 session (int64 key rows)."""
    out = []
    for sid, (prompt, seed) in enumerate((([3, 1, 4], 9), ([5, 9], 2),
                                          ([2, 6, 5, 3], 4))):
        eng = FakeEngine(n_slots=1, max_new_tokens=4)
        req = eng.submit(prompt, max_new_tokens=1, seed=seed, hold=True)
        while not eng.held:
            eng.step()  # dlint: disable=DL104
        handoff = eng.export_handoff(req)
        if sid == 2:
            handoff["max_new_tokens"] = 6
        wire = "int8-block" if sid == 1 else "f32"
        out.append((sid, *encode_handoff(handoff, wire)))
    return out


def _exchange(sender, receiver, frames):
    """Ship ``frames`` from ``sender`` while ``receiver`` polls on a
    thread; returns the statuses and the arrivals."""
    stop, arrivals = threading.Event(), []

    def pump():
        while not stop.is_set():
            arrivals.extend(receiver.poll(timeout_ms=50))

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        statuses = [sender.send(sid, m, b) for sid, m, b in frames]
    finally:
        stop.set()
        th.join(timeout=30)
    return statuses, arrivals


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_jax_host_and_a_port_host_exchange_handoffs_over_fs(tmp_path,
                                                             direction):
    frames = _interop_frames()
    if direction == "jax_to_port":
        sender = jax_transport.ObjectPlaneTransport(
            jax_plane.FsObjectPlane(str(tmp_path), 0, 2), peer=1,
            pol=_JAX_FAST)
        receiver = ObjectPlaneTransport(
            FsObjectPlane(str(tmp_path), 1, 2), peer=0, pol=_FAST)
        decode = decode_handoff
    else:
        sender = ObjectPlaneTransport(
            FsObjectPlane(str(tmp_path), 0, 2), peer=1, pol=_FAST)
        receiver = jax_transport.ObjectPlaneTransport(
            jax_plane.FsObjectPlane(str(tmp_path), 1, 2), peer=0,
            pol=_JAX_FAST)
        decode = jax_handoff.decode_handoff
    statuses, arrivals = _exchange(sender, receiver, frames)
    assert statuses == ["adopted"] * 3
    assert sorted(a.stream_id for a in arrivals) == [0, 1, 2]
    by_sid = {a.stream_id: a for a in arrivals}
    for sid, manifest, blob in frames:
        arr = by_sid[sid]
        assert arr.manifest == manifest and arr.blob == blob
        got, want = decode(arr.manifest, arr.blob), decode_handoff(
            manifest, blob)
        for blk in want["pages"]:
            for leaf in ("k", "v"):
                np.testing.assert_array_equal(
                    np.asarray(got["pages"][blk][leaf], np.float32),
                    want["pages"][blk][leaf])
        assert got["tokens"] == want["tokens"]
        assert got["key"].tolist() == want["key"].tolist()
        assert got.get("max_new_tokens") == want.get("max_new_tokens")
    # the fence is the same protocol: a replay is a duplicate
    again, _ = _exchange(sender, receiver, frames[:1])
    assert again == ["duplicate"]
