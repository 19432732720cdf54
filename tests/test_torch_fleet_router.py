"""Router behavior over fake replicas: least-depth + session-affine
placement, admission backpressure with the RpcPolicy retry hint,
deadline-bounded results, replica health, and teardown semantics.
(The replica-death re-queue drills live in test_fleet_drill.py.)

The port's copy of ``tests/fleet_tests/test_router.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import time

import numpy as np
import pytest

from chainermn_torch.fleet import FleetHealth, Router
from chainermn_torch.resilience.policy import RpcPolicy, policy
from chainermn_torch.serving.frontend import (AdmissionRejected,
                                            DeadlineExceeded)

from tests.test_torch_fleet_fake import FakeEngine, expected_tokens


def _prompts(n, seed=0, lo=3, hi=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 43, (rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


def test_routed_streams_match_oracle_and_spread_load():
    prompts = _prompts(8)
    engines = [FakeEngine(n_slots=2), FakeEngine(n_slots=2)]
    with Router(engines) as router:
        futs = [router.submit(p, max_new_tokens=5, seed=i)
                for i, p in enumerate(prompts)]
        reqs = [router.result(f, timeout_ms=30000) for f in futs]
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        assert req.tokens == expected_tokens(p, i, 5)
    # least-depth placement used BOTH replicas, not one hot spot
    assert all(e.report.submitted > 0 for e in engines)
    assert sum(e.report.submitted for e in engines) == len(prompts)


def test_session_affinity_sticks_to_one_replica():
    prompts = _prompts(6, seed=1)
    engines = [FakeEngine(n_slots=2), FakeEngine(n_slots=2)]
    with Router(engines) as router:
        for i, p in enumerate(prompts):
            fut = router.submit(p, session="chat-1", max_new_tokens=3,
                                seed=i)
            router.result(fut, timeout_ms=30000)
    counts = [e.report.submitted for e in engines]
    # every request of the session landed on the SAME replica even
    # though the other one was idle the whole time
    assert sorted(counts) == [0, len(prompts)]


def test_admission_rejected_when_all_replicas_at_bound():
    engines = [FakeEngine(n_slots=1), FakeEngine(n_slots=1)]
    pol = RpcPolicy(backoff_base_ms=250)
    with Router(engines, max_queue_depth=0, rpc_policy=pol) as router:
        with pytest.raises(AdmissionRejected) as ei:
            router.submit(np.array([1, 2, 3], np.int32))
        assert ei.value.retry_after_ms == 250
        assert router.report.rejected == 1


def test_backpressure_releases_as_the_fleet_drains():
    """Bound > 0: early submissions pass, a burst beyond the fleet's
    headroom sheds, and after a retry-after-style pause the fleet
    accepts again — the backpressure contract end to end."""
    engines = [FakeEngine(n_slots=1, step_delay_s=0.02),
               FakeEngine(n_slots=1, step_delay_s=0.02)]
    with Router(engines, max_queue_depth=2) as router:
        accepted, rejected = [], 0
        for i in range(20):
            try:
                accepted.append(router.submit(
                    np.array([i + 1], np.int32), max_new_tokens=4,
                    seed=i))
            except AdmissionRejected as e:
                rejected += 1
                assert e.retry_after_ms == policy().backoff_base_ms
                time.sleep(e.retry_after_ms / 1e3)
        assert rejected > 0, "burst never hit the bound"
        for fut in accepted:
            req = router.result(fut, timeout_ms=30000)
            assert len(req.tokens) == 4
        assert router.report.rejected == rejected


def test_result_deadline_is_bounded():
    engines = [FakeEngine(n_slots=1, step_delay_s=0.2)]
    with Router(engines) as router:
        fut = router.submit(np.array([5], np.int32), max_new_tokens=50)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            router.result(fut, timeout_ms=80)
        assert time.monotonic() - t0 < 5.0


def test_submit_after_close_refused():
    router = Router([FakeEngine()])
    router.close()
    with pytest.raises(RuntimeError, match="closed"):
        router.submit(np.array([1], np.int32))


def test_close_fails_open_futures():
    engines = [FakeEngine(n_slots=1, step_delay_s=0.2)]
    router = Router(engines)
    fut = router.submit(np.array([3], np.int32), max_new_tokens=100)
    router.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)


def test_fleet_health_deadline_and_marks():
    clock = [0.0]
    h = FleetHealth([0, 1, 2], timeout_ms=1000, time_fn=lambda: clock[0])
    assert h.alive() == [0, 1, 2]
    clock[0] = 0.9
    h.beat(1)
    assert h.check() == []                 # nobody past the deadline yet
    clock[0] = 1.5
    assert h.check() == [0, 2]             # 1 beat at 0.9 and survives
    assert h.check() == []                 # idempotent: reported once
    assert h.alive() == [1]
    h.mark_dead(1, "worker thread died")
    assert h.alive() == []
    assert set(h.dead) == {0, 1, 2}
    h.beat(0)                              # beats from the dead ignored
    assert not h.is_alive(0)


def test_summary_merges_replica_reports_with_fleet_counters():
    prompts = _prompts(4, seed=2)
    engines = [FakeEngine(n_slots=2), FakeEngine(n_slots=2)]
    with Router(engines) as router:
        futs = [router.submit(p, max_new_tokens=3, seed=i)
                for i, p in enumerate(prompts)]
        for f in futs:
            router.result(f, timeout_ms=30000)
        summary = router.summary()
    assert summary["replicas"] == 2
    assert summary["requests"]["completed"] == len(prompts)
    assert summary["tokens_emitted"] == 3 * len(prompts)
    assert summary["fleet"]["replicas_dead"] == 0


# ---------------------------------------------------------------------------
# one JAX-published snapshot, served by both CLIs
# ---------------------------------------------------------------------------

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(path):
    with open(path) as f:
        return {r["request_id"]: r for r in (json.loads(line)
                                             for line in f if line.strip())}


def test_a_jax_published_snapshot_gives_equal_jsonls_from_both_clis(
        tmp_path):
    """JAX's ``tools/fleet_lm.py`` and the port's ``fleet_lm`` warm-load
    one snapshot the JAX package published (fleet_lm's default model:
    vocab 43, d 32, 2 layers; LM head scaled 4x for greedy margin) and
    write the same JSONL rows: routed, and the port also disaggregated
    over streamed frames."""
    import jax
    import jax.numpy as jnp

    from chainermn_tpu.models.transformer import TransformerLM as JaxLM
    from chainermn_tpu.serving import weights as jweights

    jm = JaxLM(vocab=43, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               max_len=32, attention="reference", pos_emb="rope")
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    weights = str(tmp_path / "weights.npz")
    jweights.publish_weights(params, weights)
    common = ["--weights", weights, "--requests", "5",
              "--max-new-tokens", "6"]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, JAX_PLATFORMS="cpu")
    env.pop("CHAINERMN_TPU_CHAOS", None)
    runs = {
        "jax": [os.path.join(REPO_ROOT, "tools", "fleet_lm.py")],
        "port": ["-m", "chainermn_torch.tools.fleet_lm", "--device", "cpu"],
        "port-disagg": ["-m", "chainermn_torch.tools.fleet_lm", "--device",
                        "cpu", "--disaggregate", "--streamed"],
    }
    rows = {}
    for name, argv in runs.items():
        out = str(tmp_path / f"{name}.jsonl")
        proc = subprocess.run(
            [sys.executable, *argv, "--out", out, *common], env=env,
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "warm weights loaded" in proc.stderr
        rows[name] = _rows(out)
    assert sorted(rows["jax"]) == list(range(5))
    assert rows["port"] == rows["jax"]
    assert rows["port-disagg"] == rows["jax"]
