"""Async conveyor discipline: overlap, backpressure, drain, errors.

Tier-1 (FakeEngine, no devices): the asynchronous conveyor must emit
streams BITWISE-identical to the synchronous one while hiding the wire
behind decode steps — plus the operational contracts: a bounded queue
that blocks or skips under backpressure, a ``drain`` that honours its
deadline, worker errors that surface on the step thread, and a
transport failure that ends in an aborted prefill slot and a clean
re-prefill (never a poisoned decode slot).

The port's copy of ``tests/fleet_tests/test_conveyor.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import time

import pytest

from chainermn_torch.fleet.pools import DisaggregatedFleet
from chainermn_torch.fleet.transport import InProcessTransport
from chainermn_torch.resilience import chaos

from tests.test_torch_fleet_fake import FakeEngine, expected_tokens

PROMPTS = [[3, 1, 4], [1, 5, 9, 2], [6, 5], [3, 5, 8, 9, 7]]


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)


def _run(fleet, n=6):
    streams = [fleet.submit(p, max_new_tokens=n, seed=11 + i)
               for i, p in enumerate(PROMPTS)]
    fleet.run_until_drained()
    if fleet.async_conveyor:
        fleet.close()
    return streams


def _check_bitwise(streams, n=6):
    for i, s in enumerate(streams):
        assert s.tokens == expected_tokens(PROMPTS[i], 11 + i, n), \
            f"stream {i} diverged"


def test_sync_conveyor_books_all_wire_time_as_stall():
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2),
        transport=InProcessTransport(wire_delay_ms=2.0))
    _check_bitwise(_run(fleet))
    assert fleet.stats["transfers"] == len(PROMPTS)
    assert fleet.stats["stall_ms_total"] == fleet.stats["transfer_ms_total"]
    assert fleet.overlap_fraction == 0.0


def test_async_conveyor_is_bitwise_and_overlaps():
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2, step_delay_s=0.002),
        transport=InProcessTransport(wire_delay_ms=5.0),
        async_conveyor=True, max_pending=2)
    _check_bitwise(_run(fleet))
    assert fleet.stats["transfers"] == len(PROMPTS)
    # the wire ran while decode stepped: most transfer time is hidden
    assert fleet.overlap_fraction > 0.5
    assert fleet.stats["stall_ms_total"] < fleet.stats["transfer_ms_total"]


def test_async_matches_sync_token_for_token():
    sync = DisaggregatedFleet(FakeEngine(2), FakeEngine(2))
    a = _run(sync)
    asy = DisaggregatedFleet(FakeEngine(2), FakeEngine(2),
                             async_conveyor=True)
    b = _run(asy)
    assert [s.tokens for s in a] == [s.tokens for s in b]
    assert not any(s.fell_back for s in b)


def test_drain_deadline_miss_returns_false_not_raises():
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2),
        transport=InProcessTransport(wire_delay_ms=200.0),
        async_conveyor=True, max_pending=2)
    for i, p in enumerate(PROMPTS[:2]):
        fleet.submit(p, max_new_tokens=4, seed=11 + i)
    # push work into flight, then ask for an impossible drain
    for _ in range(30):
        fleet.step()  # dlint: disable=DL104
        if fleet.stats["transfers"] or fleet._q.unfinished_tasks:
            break
    assert fleet.drain(deadline_s=0.01) is False
    assert fleet.drain(deadline_s=30.0) is True     # and then it lands
    fleet.run_until_drained()
    fleet.close()


def test_skip_backpressure_leaves_slot_held_and_counts():
    fleet = DisaggregatedFleet(
        FakeEngine(4), FakeEngine(4),
        transport=InProcessTransport(wire_delay_ms=50.0),
        async_conveyor=True, max_pending=1, backpressure="skip")
    streams = _run(fleet)
    _check_bitwise(streams)
    assert fleet.stats["skipped"] > 0          # the queue DID fill
    assert fleet.stats["transfers"] == len(PROMPTS)   # nothing lost


def test_block_backpressure_books_stall():
    fleet = DisaggregatedFleet(
        FakeEngine(4), FakeEngine(4),
        transport=InProcessTransport(wire_delay_ms=30.0),
        async_conveyor=True, max_pending=1, backpressure="block")
    _check_bitwise(_run(fleet))
    assert fleet.stats["skipped"] == 0
    assert fleet.stats["stall_ms_total"] > 0   # put() waited on the queue


def test_bad_backpressure_mode_rejected():
    with pytest.raises(ValueError, match="backpressure"):
        DisaggregatedFleet(FakeEngine(2), FakeEngine(2),
                           backpressure="yolo")


class _ExplodingTransport:
    """A transport whose wire is gone: send raises; poll is empty."""

    def send(self, stream_id, manifest, blob):
        raise OSError("wire on fire")

    def poll(self, timeout_ms=0):
        return []

    def resolve(self, stream_id):
        pass


def test_worker_error_surfaces_on_step_thread():
    fleet = DisaggregatedFleet(FakeEngine(2), FakeEngine(2),
                               transport=_ExplodingTransport(),
                               async_conveyor=True)
    fleet.submit(PROMPTS[0], max_new_tokens=4, seed=11)
    with pytest.raises(RuntimeError, match="async conveyor"):
        for _ in range(200):
            fleet.step()  # dlint: disable=DL104
            time.sleep(0.005)          # let the worker hit the wire
    fleet.close()


def test_transport_failure_aborts_held_slot_and_falls_back(monkeypatch):
    """Persistent corruption: every frame fails delivery → the prefill
    slot retires as an ABORT (freed, not poisoned) and the decode side
    re-prefills cleanly — the stream still finishes bitwise."""
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=0")
    prefill, decode = FakeEngine(2), FakeEngine(2)
    fleet = DisaggregatedFleet(prefill, decode,
                               transport=InProcessTransport(max_attempts=3))
    streams = _run(fleet)
    _check_bitwise(streams)
    assert all(s.fell_back for s in streams)
    assert fleet.report.handoff_fallbacks == len(PROMPTS)
    assert prefill.report.raw()["aborted"] == len(PROMPTS)
    assert not prefill.held and not prefill.active
    assert sorted(prefill.free_slots) == [0, 1]


def test_async_transport_failure_same_contract(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=0")
    prefill = FakeEngine(2)
    fleet = DisaggregatedFleet(prefill, FakeEngine(2),
                               transport=InProcessTransport(max_attempts=3),
                               async_conveyor=True)
    streams = _run(fleet)
    _check_bitwise(streams)
    assert all(s.fell_back for s in streams)
    assert prefill.report.raw()["aborted"] == len(PROMPTS)


def test_close_is_idempotent_and_engines_still_step():
    fleet = DisaggregatedFleet(FakeEngine(2), FakeEngine(2),
                               async_conveyor=True)
    _check_bitwise(_run(fleet))
    fleet.close()
    fleet.close()
    assert fleet.step() is False       # drained fleet: nothing advances


# ---------------------------------------------------------------------------
# Streamed (format-5) handoffs over the conveyor
# ---------------------------------------------------------------------------

from chainermn_torch.fleet.handoff import streamed_chunk_sid
from chainermn_torch.fleet.pools import StreamAssembler
from chainermn_torch.fleet.transport import Arrival


def test_stream_assembler_orders_chunks_and_keeps_defects():
    asm = StreamAssembler()
    asm.add_chunk(Arrival(streamed_chunk_sid(7, 1), {"index": 1}, b"B"))
    asm.add_chunk(Arrival(streamed_chunk_sid(7, 0), {"index": 0}, b"A"))
    asm.add_chunk(Arrival(streamed_chunk_sid(7, 2), None, None,
                          defects=("sha256 mismatch",)))
    asm.add_chunk(Arrival(streamed_chunk_sid(8, 0), {"index": 0}, b"X"))
    chunks, notes = asm.take(7)
    assert [b for _m, b in chunks] == [b"A", b"B"]   # index order
    assert notes == ["chunk 2: sha256 mismatch"]     # the WHY survives
    assert asm.take(7) == ([], [])                   # take drains
    chunks8, notes8 = asm.take(8)                    # stream 8 untouched
    assert [b for _m, b in chunks8] == [b"X"] and notes8 == []


@pytest.mark.parametrize("asynchronous", [False, True])
def test_streamed_conveyor_is_bitwise(asynchronous):
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2),
        transport=InProcessTransport(wire_delay_ms=1.0),
        streamed=True, async_conveyor=asynchronous,
        max_pending=2)
    _check_bitwise(_run(fleet))
    assert fleet.stats["transfers"] == len(PROMPTS)
    assert not any(s.fell_back for s in fleet.streams)


def test_streamed_corrupt_chunk_falls_back_with_defect_history(monkeypatch):
    """Persistent chunk corruption exhausts the per-chunk NACK budget;
    the stream's fallback must carry the per-frame defect history —
    WHICH chunk died and WHY — not just that delivery failed."""
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=8")
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2),
        transport=InProcessTransport(), streamed=True)
    streams = _run(fleet)
    _check_bitwise(streams)            # clean re-prefill still matches
    assert all(s.fell_back for s in streams)
    for s in streams:
        assert s.fallback_reason and "chunk 0" in s.fallback_reason, \
            s.fallback_reason
        assert "sha" in s.fallback_reason or "byte" in s.fallback_reason


def test_streamed_corrupt_once_resends_only_that_chunk(monkeypatch):
    """The acceptance bar: ONE corrupt chunk frame costs one chunk
    NACK + one re-send — the stream still adopts (no fallback) and the
    counters prove the damage stayed chunk-sized."""
    monkeypatch.setenv(chaos.ENV_VAR, "corrupt_handoff@offset=8,times=1")
    fleet = DisaggregatedFleet(
        FakeEngine(2), FakeEngine(2),
        transport=InProcessTransport(), streamed=True)
    streams = _run(fleet)
    _check_bitwise(streams)
    assert not any(s.fell_back for s in streams)
    t = fleet.transports[0]
    assert t.receiver_stats["chunk_nacked"] == 1
    # exactly one extra delivery attempt: the re-send of the one chunk
    assert t.stats["attempts"] == t.stats["sent"] + 1
