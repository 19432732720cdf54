"""The replica-kill drill: a fleet replica dies
mid-stream — chaos fault, direct kill, or a real engine under chaos —
and the router re-queues its unfinished slots onto survivors. Every
client stream still completes with ZERO dropped and ZERO duplicated
tokens: re-queued requests replay from their seed, and the one-key-
split-per-token contract makes the survivor's stream identical to the
one the dead replica was emitting. Fast fake-replica variants run in
tier-1; the real-engine and subprocess fleet_lm drills are slow.

The port's copy of ``tests/fleet_tests/test_fleet_drill.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from chainermn_torch.fleet import Router

from tests.test_torch_fleet_fake import FakeEngine, expected_tokens

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prompts(n, seed=0, lo=3, hi=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 43, (rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


def test_chaos_kill_replica_requeues_onto_survivor(monkeypatch):
    """The tier-1 drill: chaos kills replica 1's worker at its third
    WORKING iteration — mid-stream, with admitted slots and an inbox
    backlog abandoned in place. The router declares it dead, re-queues
    everything onto replica 0, and every future resolves with exactly
    the oracle tokens: none dropped, none duplicated."""
    monkeypatch.setenv("CHAINERMN_TPU_CHAOS", "kill_replica@step=3,replica=1")
    prompts = _prompts(8)
    engines = [FakeEngine(n_slots=2), FakeEngine(n_slots=2)]
    with Router(engines) as router:
        futs = [router.submit(p, max_new_tokens=6, seed=i)
                for i, p in enumerate(prompts)]
        reqs = [router.result(f, timeout_ms=30000) for f in futs]
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        assert req.tokens == expected_tokens(p, i, 6), (
            f"stream {i} dropped or duplicated tokens across the kill")
    assert router.report.replicas_dead == 1
    assert router.report.requeued > 0
    assert router.health.alive() == [0]
    # the survivor absorbed the re-queued load (replays count as fresh
    # submissions on the surviving engine)
    assert engines[0].report.submitted >= len(prompts) // 2


def test_manual_kill_remaps_sticky_sessions(monkeypatch):
    """A session pinned to the dead replica is unpinned: its in-flight
    request replays on a survivor and LATER submissions of the same
    session stick to the new home rather than routing into the void."""
    prompts = _prompts(3, seed=3)
    engines = [FakeEngine(n_slots=2, step_delay_s=0.01),
               FakeEngine(n_slots=2, step_delay_s=0.01)]
    with Router(engines) as router:
        fut = router.submit(prompts[0], session="chat", max_new_tokens=8,
                            seed=0)
        deadline = time.monotonic() + 10
        while "chat" not in router._sessions:
            assert time.monotonic() < deadline, "session never placed"
            time.sleep(0.005)
        home = router._sessions["chat"]
        router.replicas[home].kill()
        req = router.result(fut, timeout_ms=30000)
        assert req.tokens == expected_tokens(prompts[0], 0, 8)
        for i, p in enumerate(prompts[1:], start=1):
            f = router.submit(p, session="chat", max_new_tokens=4, seed=i)
            assert router.result(f, timeout_ms=30000).tokens == \
                expected_tokens(p, i, 4)
        assert router._sessions["chat"] != home
    assert router.report.replicas_dead == 1


def test_every_replica_dead_fails_futures_fast():
    """No survivor can ever take the work: the router fails the open
    futures promptly instead of letting clients ride out the full RPC
    deadline against a fleet that no longer exists."""
    engines = [FakeEngine(n_slots=1, step_delay_s=0.05),
               FakeEngine(n_slots=1, step_delay_s=0.05)]
    with Router(engines) as router:
        futs = [router.submit(p, max_new_tokens=50, seed=i)
                for i, p in enumerate(_prompts(4, seed=4))]
        time.sleep(0.1)                    # let work reach the replicas
        for rep in router.replicas.values():
            rep.kill()
        t0 = time.monotonic()
        for f in futs:
            with pytest.raises(RuntimeError, match="no live replicas"):
                router.result(f, timeout_ms=30000)
        assert time.monotonic() - t0 < 10.0
    assert router.report.replicas_dead == 2


@pytest.mark.slow
def test_real_engine_chaos_kill_stays_bitwise(monkeypatch):
    """Two real port engines on JAX's converted parameters; chaos kills
    replica 1's worker two working iterations in. The re-queued streams
    finish on replica 0 equal to JAX's ``generate()``."""
    from tests.test_torch_fleet_pools import _engine, _oracle

    monkeypatch.setenv("CHAINERMN_TPU_CHAOS", "kill_replica@step=2,replica=1")
    prompts = [p for p in _prompts(6, seed=1, lo=3, hi=5)]
    with Router([_engine(), _engine()]) as router:
        futs = [router.submit(p, max_new_tokens=6) for p in prompts]
        reqs = [router.result(f, timeout_ms=120000) for f in futs]
    for p, req in zip(prompts, reqs):
        np.testing.assert_array_equal(np.asarray(req.tokens), _oracle(p))
    assert router.report.replicas_dead == 1
    assert router.report.requeued > 0


@pytest.mark.slow
def test_fleet_lm_subprocess_drill_drains_bitwise(tmp_path):
    """The port's fleet_lm under the same fault, as a subprocess: the
    kill is absorbed inside the process, the run exits 0, and the JSONL
    matches an unkilled in-process engine on the published weights."""
    from chainermn_torch.tools import fleet_lm

    out = str(tmp_path / "streams.jsonl")
    weights = str(tmp_path / "weights.npz")
    report = str(tmp_path / "fleet.json")
    n_req, max_new, prompt_len = 5, 6, 4
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    env["CHAINERMN_TPU_CHAOS"] = "kill_replica@step=2,replica=1"
    argv = ["--out", out, "--weights", weights, "--requests", str(n_req),
            "--prompt-len", str(prompt_len), "--max-new-tokens",
            str(max_new), "--n-layers", "1", "--replicas", "2", "--seed",
            "0", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.fleet_lm", *argv,
         "--report", report], env=env, cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(report) as f:
        assert json.load(f)["fleet"]["replicas_dead"] == 1
    with open(out) as f:
        rows = {r["request_id"]: r
                for r in (json.loads(line) for line in f if line.strip())}
    assert sorted(rows) == list(range(n_req)), "fleet did not drain"
    eng = fleet_lm._engine_factory(fleet_lm.parse_args(argv))()
    rng = np.random.RandomState(0)
    reqs = {}
    for i in range(n_req):
        prompt = rng.randint(0, 43, (prompt_len,)).astype(np.int32)
        assert rows[i]["prompt"] == prompt.tolist()
        reqs[i] = eng.submit(prompt, seed=i)
    eng.run_until_drained()
    for i, req in reqs.items():
        assert rows[i]["tokens"] == req.tokens, (
            f"stream {i} diverged across the replica kill")
