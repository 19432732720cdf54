"""Replica drain + live decode→decode session migration.

``Router.drain`` takes a replica out of service without losing a
token: placement stops, the never-admitted backlog re-queues, and
every actively decoding session freezes (``export_session``), crosses
the handoff transport as a SHA-verified frame, and resumes on a
survivor (``import_session``) — bitwise, because the handed-off PRNG
key row CONTINUES instead of re-deriving. Every fault the migration
chaos campaign throws (corrupt/dropped/duplicated frames, the source
dying mid-drain, the DESTINATION dying right after adopting) must end
in exactly one of two states, both bitwise-equal to the oracle:
"migrated" or "replayed from seed". Zero dropped, zero duplicated
tokens, under every spec.

Fast FakeEngine drills run in tier-1; the real-engine drain drill is
slow (tests/serving_tests/test_migration.py owns the real engine's
export/import unit matrix).

The port's copy of ``tests/fleet_tests/test_migration.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import threading
import time

import numpy as np
import pytest

from chainermn_torch.fleet import Router
from chainermn_torch.resilience.policy import RpcPolicy

from tests.test_torch_fleet_fake import FakeEngine, expected_tokens


def _prompts(n, seed=0, lo=3, hi=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 43, (rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


def _set_chaos(monkeypatch, spec):
    """Point the process-wide chaos plan at ``spec``, forcing a
    re-parse even if an earlier test consumed the same spec string's
    ``times=`` budget."""
    from chainermn_torch.resilience import chaos
    monkeypatch.setenv("CHAINERMN_TPU_CHAOS", spec)
    monkeypatch.setattr(chaos, "_plan", None)
    monkeypatch.setattr(chaos, "_plan_spec", None)


def _until_decoding(engine, min_tokens: int = 1,
                    timeout_s: float = 20.0) -> None:
    """Wait (bounded) until ``engine`` holds a stream mid-decode with at
    least ``min_tokens`` emitted: a drain that races the dispatch loop
    finds nothing to move, so the port's copies wait for the state
    instead of sleeping a fixed time (a busy test box may not have
    placed anything yet)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(len(r.tokens) >= min_tokens
               for r in list(engine.active.values())):
            return
        time.sleep(0.002)
    raise AssertionError("no stream reached decode on the replica")


def _fleet(n=3, slots=2, max_new=40, delay=0.01):
    return [FakeEngine(n_slots=slots, max_new_tokens=max_new,
                       step_delay_s=delay) for _ in range(n)]


# ---------------------------------------------------------------------------
# the clean drain: migrate mid-stream, bitwise, tokens continuous
# ---------------------------------------------------------------------------


def test_drain_migrates_mid_stream_bitwise_and_counts_every_token():
    """The tentpole contract: sessions caught mid-decode by a drain
    continue on survivors bitwise-equal to never-migrated streams, and
    the fleet-wide engine-emitted token count equals the sum of the
    final stream lengths — each token was emitted EXACTLY once (a
    re-derived PRNG key or a replayed suffix would double-count)."""
    engines = _fleet()
    prompts = _prompts(4)
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        _until_decoding(engines[0])    # streams mid-decode
        out = router.drain(0, deadline_ms=20_000)
        reqs = [router.result(f, timeout_ms=30_000) for f in futs]
    assert out["state"] == "DRAINED"
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        assert req.tokens == expected_tokens(p, i, 40), (
            f"stream {i} diverged across the drain")
    assert router.report.replicas_drained == 1
    assert router.report.migrations == out["migrated"]
    assert router.report.migration_fallbacks == 0
    assert out["migrated"] > 0, "drain never caught a live session"
    # migrations carry exact wire bytes under the configured format
    assert set(router.report.migration_wire_bytes) == {"f32"}
    assert router.report.migration_wire_bytes["f32"] > 0
    # continuous per-session token count: emitted-once, fleet-wide
    emitted = sum(e.report.raw()["tokens_emitted"] for e in engines)
    assert emitted == sum(len(r.tokens) for r in reqs)
    # lifecycle surfaced: the drained replica is out, nobody DRAINING
    summary = router.summary()
    assert summary["fleet"]["replica_states"][0] == "DRAINED"
    assert summary["fleet"]["draining"] == []
    assert summary["fleet"]["replicas_drained"] == 1


def test_drained_replica_takes_no_new_work():
    engines = _fleet(n=2, delay=0.0)
    with Router(engines) as router:
        router.drain(0, deadline_ms=5_000)
        futs = [router.submit(p, seed=i)
                for i, p in enumerate(_prompts(4, seed=2))]
        for i, f in enumerate(futs):
            router.result(f, timeout_ms=30_000)
    assert engines[0].report.submitted == 0
    assert engines[1].report.submitted == 4


def test_drain_is_idempotent():
    engines = _fleet(n=2, delay=0.0)
    with Router(engines) as router:
        first = router.drain(0, deadline_ms=5_000)
        again = router.drain(0, deadline_ms=5_000)
    assert first["state"] == "DRAINED"
    assert again == {"migrated": 0, "requeued": 0, "state": "DRAINED"}


def test_drain_refusals():
    """Unknown replica, dead replica, and the last placeable replica
    are all refused with a reason — a drain must never be the thing
    that strands sessions."""
    engines = _fleet(n=2, delay=0.0)
    with Router(engines) as router:
        with pytest.raises(ValueError, match="unknown replica"):
            router.drain(7)
        router.replicas[1].kill()
        deadline = time.monotonic() + 10
        while 1 in router.health.alive():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(ValueError, match="dead"):
            router.drain(1)
        with pytest.raises(ValueError, match="last placeable"):
            router.drain(0)


def test_sticky_session_remaps_to_survivor_across_drain():
    prompts = _prompts(3, seed=3)
    engines = _fleet(n=2, max_new=20)
    with Router(engines) as router:
        fut = router.submit(prompts[0], session="chat", seed=0)
        deadline = time.monotonic() + 10
        while "chat" not in router._sessions:
            assert time.monotonic() < deadline, "session never placed"
            time.sleep(0.005)
        home = router._sessions["chat"]
        router.drain(home, deadline_ms=20_000)
        req = router.result(fut, timeout_ms=30_000)
        assert req.tokens == expected_tokens(prompts[0], 0, 20)
        for i, p in enumerate(prompts[1:], start=1):
            f = router.submit(p, session="chat", max_new_tokens=4, seed=i)
            assert router.result(f, timeout_ms=30_000).tokens == \
                expected_tokens(p, i, 4)
        assert router._sessions["chat"] != home


def test_drain_deadline_evacuates_to_replay():
    """A deadline too tight to migrate anything falls back to the
    death path: evacuate + replay from seed on survivors — slower,
    never wrong."""
    engines = _fleet(delay=0.02)
    prompts = _prompts(4, seed=5)
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        _until_decoding(engines[0])
        out = router.drain(0, deadline_ms=1)
        reqs = [router.result(f, timeout_ms=30_000) for f in futs]
    assert out["state"] == "DRAINED"
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        assert req.tokens == expected_tokens(p, i, 40)


def test_drain_waits_out_saturated_survivor_without_fallback():
    """Every survivor slot full at export time is TRANSIENT, not a
    failure: the drain must keep the session decoding on the source
    and retry once a slot frees — burning the replay fallback here
    would double-bill tokens for a non-failure. One-slot fleet: the
    survivor is busy with a short stream while the victim's long
    stream waits to migrate."""
    engines = [FakeEngine(n_slots=1, max_new_tokens=40,
                          step_delay_s=0.01) for _ in range(2)]
    prompts = _prompts(2, seed=9)
    with Router(engines) as router:
        long_fut = router.submit(prompts[0], seed=0)       # replica 0
        short_fut = router.submit(prompts[1], seed=1,      # replica 1
                                  max_new_tokens=6)
        deadline = time.monotonic() + 10
        while not (engines[0].active and engines[1].active):
            assert time.monotonic() < deadline, "streams never placed"
            time.sleep(0.005)
        out = router.drain(0, deadline_ms=20_000)
        long_req = router.result(long_fut, timeout_ms=30_000)
        short_req = router.result(short_fut, timeout_ms=30_000)
    assert out == {"migrated": 1, "requeued": 0, "state": "DRAINED"}
    assert long_req.tokens == expected_tokens(prompts[0], 0, 40)
    assert short_req.tokens == expected_tokens(prompts[1], 1, 6)
    assert router.report.migration_fallbacks == 0
    emitted = sum(e.report.raw()["tokens_emitted"] for e in engines)
    assert emitted == len(long_req.tokens) + len(short_req.tokens)


def test_shed_pending_cancels_only_never_started_work():
    """SIGUSR1's router half: the shed cancels queued work at every
    tier (router backlog, inbox, engine queue) and leaves actively
    decoding streams to finish — bitwise."""
    engines = [FakeEngine(n_slots=1, max_new_tokens=12,
                          step_delay_s=0.02) for _ in range(2)]
    prompts = _prompts(8, seed=6)
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        time.sleep(0.1)                # 2 decoding, 6 queued somewhere
        shed = router.shed_pending()
        assert shed > 0, "nothing was queued to shed"
        done, cancelled = 0, 0
        for i, f in enumerate(futs):
            if f.cancelled():
                cancelled += 1
                continue
            req = router.result(f, timeout_ms=30_000)
            assert req.tokens == expected_tokens(prompts[i], i, 12)
            done += 1
    assert cancelled == shed
    assert done + cancelled == len(prompts)


def test_retry_after_scales_with_aggregate_backlog():
    """Satellite: the admission retry hint is the base backoff exactly
    at the bound and grows linearly with the excess backlog per
    replica-slot of headroom, capped at 16x."""
    engines = _fleet(n=2, delay=0.0)
    pol = RpcPolicy(backoff_base_ms=250)
    with Router(engines, max_queue_depth=2, rpc_policy=pol) as router:
        assert router._retry_after_ms(pol, total=4, bound=4,
                                      n_live=2) == 250
        assert router._retry_after_ms(pol, total=10, bound=4,
                                      n_live=2) == int(250 * 2.5)
        assert router._retry_after_ms(pol, total=10_000, bound=4,
                                      n_live=2) == 250 * 16


def test_summary_surfaces_draining_replicas():
    engines = _fleet(n=2, delay=0.0)
    with Router(engines) as router:
        router.replicas[1].draining = True
        summary = router.summary()
        assert summary["fleet"]["draining"] == [1]
        assert summary["fleet"]["replica_states"] == {0: "UP",
                                                      1: "DRAINING"}
        router.replicas[1].draining = False


# ---------------------------------------------------------------------------
# the migration chaos campaign: every fault ends bitwise
# ---------------------------------------------------------------------------

_CHAOS_MATRIX = [
    # (spec, expects) — expects checked against the router report
    pytest.param("corrupt_handoff@offset=0,times=1", "migrated",
                 id="corrupt-once-heals-by-resend"),
    pytest.param("corrupt_handoff@offset=0", "fallback",
                 id="corrupt-always-exhausts-to-replay"),
    pytest.param("drop_handoff@times=1", "migrated",
                 id="drop-once-heals-by-resend"),
    pytest.param("drop_handoff@", "fallback",
                 id="drop-always-exhausts-to-replay"),
    pytest.param("dup_handoff@times=2", "migrated",
                 id="duplicate-frames-fenced"),
    pytest.param("kill_dest@times=1", "killed",
                 id="dest-dies-after-adopt"),
    # the delay holds each migration frame in flight for 60 ms, so the
    # drain provably spans the source worker's 12th step — the kill
    # lands MID-drain, not before or after it
    pytest.param("delay_handoff@ms=60;kill_replica@step=12,replica=0",
                 "killed", id="source-dies-mid-drain"),
]


@pytest.mark.parametrize("spec,expects", _CHAOS_MATRIX)
def test_migration_chaos_ends_bitwise(monkeypatch, spec, expects):
    """The campaign's acceptance gate: under every wire and process
    fault, a drain ends with every session either migrated-bitwise or
    replayed-bitwise — the streams are indistinguishable from a fleet
    that never saw the fault."""
    _set_chaos(monkeypatch, spec)
    engines = _fleet()                 # 3 replicas: kill_dest needs a
    prompts = _prompts(4, seed=7)      # survivor for the replay too
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        # JAX's copy sleeps 80 ms (~8 steps); the source-dies case needs
        # the drain to span the source's 12th working step, so it starts
        # 2-3 steps before it (a token a step)
        _until_decoding(engines[0], min_tokens=9)
        out = router.drain(0, deadline_ms=20_000)
        reqs = [router.result(f, timeout_ms=30_000) for f in futs]
        report = router.report
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        assert req.tokens == expected_tokens(p, i, 40), (
            f"stream {i} dropped or duplicated tokens under {spec!r}")
    if expects == "migrated":
        assert report.migrations > 0
        assert report.migration_fallbacks == 0
        assert out["state"] == "DRAINED"
    elif expects == "fallback":
        assert report.migration_fallbacks > 0
        assert report.migrations == 0
        assert out["state"] == "DRAINED"
    else:                              # a replica died along the way
        assert report.replicas_dead >= 1


def test_drain_while_submissions_race():
    """Clients keep submitting while the drain runs: nothing lands on
    the draining replica after the flag flips, and every stream —
    pre-drain, mid-drain, post-drain — completes bitwise."""
    engines = _fleet(max_new=8)
    prompts = _prompts(12, seed=8)
    with Router(engines) as router:
        futs = {}
        for i in range(4):
            futs[i] = router.submit(prompts[i], seed=i)
        done = threading.Event()
        drained = {}

        def _drain():
            drained.update(router.drain(0, deadline_ms=20_000))
            done.set()

        t = threading.Thread(target=_drain)
        t.start()
        for i in range(4, 12):
            futs[i] = router.submit(prompts[i], seed=i)
            time.sleep(0.005)
        t.join(timeout=30)
        assert done.is_set(), "drain wedged"
        for i, f in sorted(futs.items()):
            assert router.result(f, timeout_ms=30_000).tokens == \
                expected_tokens(prompts[i], i, 8)
    assert drained["state"] == "DRAINED"
    assert engines[0].report.submitted + engines[1].report.submitted \
        + engines[2].report.submitted >= 12
