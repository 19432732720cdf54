"""Zero-downtime rolling weight updates.

``RolloutController`` walks a live fleet from weights v1 to v2 —
CANARY → DRAIN → SWAP → READMIT, one replica at a time — with zero
dropped or duplicated tokens: every client stream resolves exactly
once, bitwise-equal to exactly ONE version's oracle (the skew fence
refuses cross-version adoptions, so a stream is never silently mixed).
The chaos campaign drives every planned failure to its contracted
outcome: ``canary_mismatch`` aborts with the fleet untouched,
transient ``corrupt_rollout_chunk`` heals through the NACK/re-send
budget, persistent corruption rolls the fleet back to v1 through the
same drain path, and ``kill_mid_swap`` classifies as a crash the walk
survives.

Fast FakeEngine drills run in tier-1; the real-engine drill is slow.

The port's copy of ``tests/fleet_tests/test_rollout.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from chainermn_torch.fleet import (RolloutController, RolloutError, Router)
from chainermn_torch.fleet.handoff import (decode_handoff,
                                         decode_handoff_streamed,
                                         encode_handoff,
                                         encode_handoff_streamed)
from chainermn_torch.fleet.reports import FleetReport
from chainermn_torch.serving.engine import WeightsVersionSkew
from chainermn_torch.serving.weights import encode_weights

from tests.test_torch_fleet_migration import _until_decoding
from tests.test_torch_fleet_fake import (FakeEngine, expected_tokens,
                                           fake_params, fake_salt)

V1_SALT, V2_SALT = 0, 5
MAX_NEW = 30



def _prompts(n, seed=0, lo=3, hi=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 43, (rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


def _set_chaos(monkeypatch, spec):
    from chainermn_torch.resilience import chaos
    monkeypatch.setenv("CHAINERMN_TPU_CHAOS", spec)
    monkeypatch.setattr(chaos, "_plan", None)
    monkeypatch.setattr(chaos, "_plan_spec", None)


def _fleet(n=3, delay=0.005, version="v1"):
    return [FakeEngine(n_slots=2, max_new_tokens=MAX_NEW,
                       step_delay_s=delay, salt=V1_SALT,
                       weights_version=version) for _ in range(n)]


def _factory(params, version):
    """The off-traffic canary engine: a fake whose 'weights' are the
    decoded candidate params."""
    return FakeEngine(n_slots=2, max_new_tokens=MAX_NEW,
                      salt=fake_salt(params), weights_version=version)


def _controller(router, **kw):
    kw.setdefault("chunk_bytes", 64)    # several chunks per snapshot
    return RolloutController(router, _factory, **kw)


def _canary(n=2, seed0=7, n_tok=6, salt=V2_SALT):
    prompts = [(list(p), seed0 + i, n_tok)
               for i, p in enumerate(_prompts(n, seed=9))]
    oracle = [expected_tokens(p, s, k, salt=salt)
              for (p, s, k) in prompts]
    return prompts, oracle


def _snapshot_frames(params, version, chunk_bytes=64):
    """How many wire frames one relay hop ships (chunks + closing)."""
    _man, data = encode_weights(params, weights_version=version)
    return math.ceil(len(data) / chunk_bytes) + 1


# ---------------------------------------------------------------------------
# the happy path: v1 → v2 under live traffic
# ---------------------------------------------------------------------------


def test_rollout_walks_fleet_to_v2_under_traffic_every_stream_one_version():
    """The tentpole contract: a 3-replica fleet under continuous
    traffic walks v1 → v2 with every replica ending UP on v2, every
    client future resolving exactly once, and every finished stream
    bitwise-equal to exactly ONE version's oracle — the skew fence
    turns would-be mixed streams into whole replays."""
    engines = _fleet(version=None)      # unversioned incumbents
    prompts = _prompts(5)
    can_p, can_o = _canary()
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        _until_decoding(engines[0])     # streams mid-decode
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=can_o, from_version="v1")
        reqs = [router.result(f, timeout_ms=60_000) for f in futs]
        summary = router.summary()
    assert out["status"] == "completed"
    assert out["swapped"] == [0, 1, 2] and not out["crashed"]
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        v1 = expected_tokens(p, i, MAX_NEW, salt=V1_SALT)
        v2 = expected_tokens(p, i, MAX_NEW, salt=V2_SALT)
        assert req.tokens in (v1, v2), (
            f"stream {i} is neither version's oracle — a mixed stream")
    assert summary["fleet"]["weights_versions"] == {0: "v2", 1: "v2",
                                                    2: "v2"}
    assert summary["fleet"]["replica_states"] == {0: "UP", 1: "UP",
                                                  2: "UP"}
    assert summary["fleet"]["rollouts"] == {
        "completed": 1, "rolled_back": 0, "canary_failures": 0,
        "wire_bytes": out["relay_wire_bytes"]}


def test_rollout_publisher_egress_is_one_snapshot_regardless_of_fleet_size():
    """The relay-tree claim: each finished receiver forwards the next
    hop, so the publisher's egress stays ~1× the encoded snapshot no
    matter how many replicas the walk visits."""
    can_p, can_o = _canary()
    egress = {}
    for n in (2, 3):
        with Router(_fleet(n=n, delay=0.0)) as router:
            out = _controller(router).rollout(
                fake_params(V2_SALT), "v2", canary_prompts=can_p,
                canary_oracle=can_o)
        assert out["status"] == "completed"
        egress[n] = out["publisher_egress_bytes"]
        # every hop re-ships the same frames: total = hops × egress
        assert out["relay_wire_bytes"] == n * egress[n]
    assert egress[2] == egress[3] > 0


def test_rollout_refuses_a_fleet_too_small_to_drain():
    can_p, can_o = _canary()
    with Router(_fleet(n=1, delay=0.0)) as router:
        with pytest.raises(RolloutError, match="at least 2"):
            _controller(router).rollout(
                fake_params(V2_SALT), "v2", canary_prompts=can_p,
                canary_oracle=can_o)
    with Router(_fleet(n=2, delay=0.0)) as router:
        with pytest.raises(RolloutError, match="oracle"):
            _controller(router).rollout(
                fake_params(V2_SALT), "v2", canary_prompts=can_p,
                canary_oracle=can_o[:-1])


# ---------------------------------------------------------------------------
# the canary gate
# ---------------------------------------------------------------------------


def test_canary_miscompare_aborts_with_fleet_untouched():
    """A candidate that does not reproduce the pinned prompt set
    bitwise never touches the fleet: here the 'v2 oracle' was minted
    under the WRONG salt, so the off-traffic canary miscompares."""
    can_p, _ = _canary()
    wrong_oracle = [expected_tokens(p, s, k, salt=V1_SALT)
                    for (p, s, k) in can_p]
    engines = _fleet(delay=0.0)
    with Router(engines) as router:
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=wrong_oracle)
        summary = router.summary()
    assert out["status"] == "aborted"
    assert "miscompared" in out["reason"]
    assert out["publisher_egress_bytes"] == 0, "traffic moved fleet-ward"
    assert summary["fleet"]["weights_versions"] == {0: "v1", 1: "v1",
                                                    2: "v1"}
    assert summary["fleet"]["rollouts"]["canary_failures"] == 1
    assert all(e.salt == V1_SALT for e in engines)
    assert all(e.report.submitted == 0 for e in engines), (
        "canary replay leaked onto a fleet engine")


def test_chaos_canary_mismatch_forces_the_abort(monkeypatch):
    _set_chaos(monkeypatch, "canary_mismatch@times=1")
    can_p, can_o = _canary()
    with Router(_fleet(delay=0.0)) as router:
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=can_o)
        assert out["status"] == "aborted"
        assert router.report.canary_failures == 1
        # the fleet still serves after the abort
        fut = router.submit(np.asarray([1, 2, 3], np.int32), seed=4)
        req = router.result(fut, timeout_ms=30_000)
    assert req.tokens == expected_tokens([1, 2, 3], 4, MAX_NEW,
                                         salt=V1_SALT)


# ---------------------------------------------------------------------------
# relay corruption: heal, then roll back
# ---------------------------------------------------------------------------


def test_transient_corrupt_chunk_heals_through_nack_resend(monkeypatch):
    """One damaged chunk frame: the receiver's SHA check NACKs it, the
    re-send is clean, the rollout completes."""
    _set_chaos(monkeypatch, "corrupt_rollout_chunk@offset=8,times=1")
    can_p, can_o = _canary()
    with Router(_fleet(delay=0.0)) as router:
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=can_o)
        assert out["status"] == "completed"
        assert router.summary()["fleet"]["weights_versions"] == {
            0: "v2", 1: "v2", 2: "v2"}


def test_persistent_corruption_mid_walk_rolls_back_to_v1(monkeypatch):
    """Corruption that outlives the re-send budget fails the hop; the
    rollout rolls BACK: the already-swapped replica walks back to v1
    through the same drain path, and the whole fleet ends serving v1.
    ``after=`` spares the first hop so the rollback is non-trivial."""
    hop_frames = _snapshot_frames(fake_params(V2_SALT), "v2")
    _set_chaos(monkeypatch,
               f"corrupt_rollout_chunk@offset=8,after={hop_frames},"
               "prob=1.0")
    can_p, can_o = _canary()
    engines = _fleet(delay=0.0)
    with Router(engines) as router:
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=can_o)
        summary = router.summary()
        # the fleet still serves, fully on v1
        fut = router.submit(np.asarray([4, 4], np.int32), seed=1)
        req = router.result(fut, timeout_ms=30_000)
    assert out["status"] == "rolled_back"
    assert out["rolled_back"] == [0], "hop 0 swapped, then walked back"
    assert "relay" in out["reason"]
    assert summary["fleet"]["weights_versions"] == {0: "v1", 1: "v1",
                                                    2: "v1"}
    assert summary["fleet"]["replica_states"] == {0: "UP", 1: "UP",
                                                  2: "UP"}
    assert summary["fleet"]["rollouts"]["rolled_back"] == 1
    assert all(e.salt == V1_SALT for e in engines)
    assert req.tokens == expected_tokens([4, 4], 1, MAX_NEW,
                                         salt=V1_SALT)


def test_kill_mid_swap_classifies_as_crash_and_the_walk_continues(
        monkeypatch):
    """A replica lost inside its swap window (drained, never
    readmitted — the in-process analogue of a SIGKILLed host, whose
    supervisor restart loads whichever version its local manifest
    verifies) is a CRASH, not a rollout failure: the walk finishes on
    the survivors."""
    _set_chaos(monkeypatch, "kill_mid_swap@replica=1,times=1")
    can_p, can_o = _canary()
    with Router(_fleet(delay=0.0)) as router:
        out = _controller(router).rollout(
            fake_params(V2_SALT), "v2", canary_prompts=can_p,
            canary_oracle=can_o)
        summary = router.summary()
        fut = router.submit(np.asarray([2, 9], np.int32), seed=3)
        req = router.result(fut, timeout_ms=30_000)
    assert out["status"] == "completed"
    assert out["crashed"] == [1] and out["swapped"] == [0, 2]
    assert summary["fleet"]["replica_states"][1] == "DRAINED"
    assert summary["fleet"]["weights_versions"] == {0: "v2", 1: "v1",
                                                    2: "v2"}
    assert req.tokens == expected_tokens([2, 9], 3, MAX_NEW,
                                         salt=V2_SALT)


# ---------------------------------------------------------------------------
# version-skew fencing
# ---------------------------------------------------------------------------


def test_cross_version_handoff_is_refused_at_import():
    src = FakeEngine(n_slots=1, max_new_tokens=4, weights_version="v2")
    dst = FakeEngine(n_slots=1, max_new_tokens=8, weights_version="v1")
    req = src.submit(np.asarray([3, 1, 4], np.int32), seed=2, hold=True)
    while req.state != "held":
        src.step()  # dlint: disable=DL104
    handoff = src.export_handoff(req)
    assert handoff["weights_version"] == "v2"
    with pytest.raises(WeightsVersionSkew, match="v2.*v1"):
        dst.import_handoff(handoff, req.prompt)
    # an UNVERSIONED side always passes: the fence only fires when
    # both ends know their version and they disagree
    open_dst = FakeEngine(n_slots=1, max_new_tokens=8,
                          weights_version=None)
    adopted = open_dst.import_handoff(handoff, req.prompt)
    assert list(adopted.tokens) == list(req.tokens)


def test_handoff_manifest_round_trips_weights_version_all_formats():
    src = FakeEngine(n_slots=1, max_new_tokens=4, weights_version="v7")
    req = src.submit(np.asarray([5, 5], np.int32), seed=1, hold=True)
    while req.state != "held":
        src.step()  # dlint: disable=DL104
    handoff = src.export_handoff(req)
    for wf in ("f32", "int8-block"):
        man, blob = encode_handoff(handoff, wire_format=wf)
        assert man["meta"]["weights_version"] == "v7"
        assert decode_handoff(man, blob)["weights_version"] == "v7"
    chunks, closing_man, closing_blob = encode_handoff_streamed(handoff)
    assert closing_man["meta"]["weights_version"] == "v7"
    out = decode_handoff_streamed(closing_man, closing_blob, chunks)
    assert out["weights_version"] == "v7"


def test_legacy_manifests_without_weights_version_stay_loadable():
    """Pre-PR-19 manifests carry no ``weights_version``: they decode
    with the field None — and None never trips the fence."""
    src = FakeEngine(n_slots=1, max_new_tokens=4, weights_version=None)
    req = src.submit(np.asarray([5, 5], np.int32), seed=1, hold=True)
    while req.state != "held":
        src.step()  # dlint: disable=DL104
    handoff = src.export_handoff(req)
    man, blob = encode_handoff(handoff)
    assert "weights_version" not in man["meta"], (
        "unversioned export grew a key")
    out = decode_handoff(man, blob)
    assert out["weights_version"] is None
    dst = FakeEngine(n_slots=1, max_new_tokens=8, weights_version="v2")
    dst.import_handoff(out, req.prompt)     # fence passes on None


def test_skew_refused_migration_replays_entirely_under_one_version():
    """The mixed-fleet moment every walk passes through: draining a v1
    replica whose survivors already run v2. The skew fence refuses the
    adoptions and the streams replay from seed — each finishes as a
    complete v2 stream, never a v1 prefix with a v2 tail."""
    engines = [FakeEngine(n_slots=4, max_new_tokens=MAX_NEW,
                          step_delay_s=0.005, salt=V1_SALT,
                          weights_version="v1"),
               FakeEngine(n_slots=4, max_new_tokens=MAX_NEW,
                          step_delay_s=0.005, salt=V2_SALT,
                          weights_version="v2")]
    prompts = _prompts(4, seed=5)
    with Router(engines) as router:
        futs = [router.submit(p, seed=i) for i, p in enumerate(prompts)]
        _until_decoding(engines[0])     # streams mid-decode
        _until_decoding(engines[1])
        router.drain(0, deadline_ms=30_000)
        reqs = [router.result(f, timeout_ms=60_000) for f in futs]
    assert router.report.migration_fallbacks > 0, (
        "no migration was ever skew-refused — the drill proved nothing")
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        v1 = expected_tokens(p, i, MAX_NEW, salt=V1_SALT)
        v2 = expected_tokens(p, i, MAX_NEW, salt=V2_SALT)
        assert req.tokens in (v1, v2), f"stream {i} mixed versions"


# ---------------------------------------------------------------------------
# readmit + report plumbing
# ---------------------------------------------------------------------------


def test_readmit_requires_a_cleanly_drained_replica():
    with Router(_fleet(n=2, delay=0.0)) as router:
        with pytest.raises(ValueError, match="unknown"):
            router.readmit(9)
        with pytest.raises(ValueError, match="DRAINED"):
            router.readmit(0)           # still UP
        router.drain(0, deadline_ms=5_000)
        router.readmit(0)
        assert router.summary()["fleet"]["replica_states"][0] == "UP"
        # the readmitted replica takes work again
        fut = router.submit(np.asarray([1, 1], np.int32), seed=0)
        router.result(fut, timeout_ms=30_000)


def test_fleet_report_rollout_counters_round_trip_and_absorb():
    a = FleetReport()
    a.record_rollout_completed()
    a.record_canary_failure()
    a.record_rollout_wire(1234)
    wire = json.loads(json.dumps(a.to_wire()))
    b = FleetReport.from_wire(wire)
    assert b.to_wire() == a.to_wire()
    host2 = FleetReport()
    host2.record_rollout_rolled_back()
    host2.record_rollout_wire(766)
    b.absorb(host2)
    assert (b.rollouts_completed, b.rollouts_rolled_back,
            b.canary_failures, b.rollout_wire_bytes) == (1, 1, 1, 2000)
    out = b.summary([])
    assert out["fleet"]["rollouts"] == {
        "completed": 1, "rolled_back": 1, "canary_failures": 1,
        "wire_bytes": 2000}


# ---------------------------------------------------------------------------
# the real engine, slow tier
# ---------------------------------------------------------------------------


def _port_versions(*seeds):
    """Port engines' state dicts of JAX's converted inits (the LM head
    scaled 4x), one per seed, and a versioned-engine factory."""
    from chainermn_torch.serving.engine import Engine, EngineConfig
    from tests.test_torch_fleet_pools import _cfg_kw, _setup

    model = _setup(0)[2]
    sds = [{k: v.clone() for k, v in _setup(s)[2].state_dict().items()}
           for s in seeds]

    def mk_engine(params, version):
        eng = Engine(model, EngineConfig(**_cfg_kw()), device="cpu",
                     weights_version=version)
        eng.steps.load_params(params)
        return eng

    return model, sds, mk_engine


@pytest.mark.slow
def test_real_engine_rollout_bitwise_and_corruption_rollback(monkeypatch):
    """The real thing twice over on port engines: a 3-replica fleet
    under live traffic (1) completes v1 → v2 with every stream one
    version's single-engine oracle, then (2) a persistently corrupted
    relay rolls a second rollout back to v2, the fleet still serving
    v2."""
    max_new = 6
    model, (params_v1, params_v2, params_v3), mk_engine = \
        _port_versions(0, 1, 2)

    def oracle(params, p):
        eng = mk_engine(params, None)
        req = eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
        return list(req.tokens)

    prompts = _prompts(4, seed=1, lo=3, hi=5)
    can_p = [(list(p), 0, max_new) for p in prompts[:2]]
    can_o = [oracle(params_v2, p) for p in prompts[:2]]
    engines = [mk_engine(params_v1, "v1") for _ in range(3)]
    with Router(engines, health_timeout_ms=300_000) as router:
        rc = RolloutController(router, mk_engine, like=params_v1,
                               chunk_bytes=1 << 16)
        futs = [router.submit(p, max_new_tokens=max_new)
                for p in prompts]
        out = rc.rollout(params_v2, "v2", canary_prompts=can_p,
                         canary_oracle=can_o)
        reqs = [router.result(f, timeout_ms=120_000) for f in futs]
        assert out["status"] == "completed"
        assert router.summary()["fleet"]["weights_versions"] == {
            0: "v2", 1: "v2", 2: "v2"}
        for p, req in zip(prompts, reqs):
            assert req.tokens in (oracle(params_v1, p),
                                  oracle(params_v2, p)), (
                "a stream crossed versions")
        hop_frames = _snapshot_frames(params_v2, "v3",
                                      chunk_bytes=1 << 16)
        _set_chaos(monkeypatch,
                   f"corrupt_rollout_chunk@offset=8,after={hop_frames},"
                   "prob=1.0")
        rc2 = RolloutController(router, mk_engine, like=params_v1,
                                chunk_bytes=1 << 16)
        out2 = rc2.rollout(
            params_v3, "v3",
            canary_prompts=[(list(prompts[0]), 0, max_new)],
            canary_oracle=[oracle(params_v3, prompts[0])])
        assert out2["status"] == "rolled_back"
        assert router.summary()["fleet"]["weights_versions"] == {
            0: "v2", 1: "v2", 2: "v2"}
        fut = router.submit(prompts[0], max_new_tokens=max_new)
        req = router.result(fut, timeout_ms=120_000)
        assert req.tokens == oracle(params_v2, prompts[0]), (
            "post-rollback fleet is not serving v2 bitwise")


@pytest.mark.slow
def test_fleet_lm_sighup_rollout_publishes_and_stays_idempotent(tmp_path):
    """The port's fleet_lm end to end on JAX-published snapshots: SIGHUP
    mid-serve runs the live rolling update, the run exits 0 with every
    stream one version's, the report counts the completed rollout, and
    the candidate re-published to ``--weights`` names the new
    version."""
    import jax
    import jax.numpy as jnp

    from chainermn_tpu.models.transformer import TransformerLM as JaxLM
    from chainermn_tpu.serving import weights as jweights
    from chainermn_torch.tools import fleet_lm

    out = str(tmp_path / "streams.jsonl")
    weights = str(tmp_path / "weights.npz")
    v2_path = str(tmp_path / "v2.npz")
    report = str(tmp_path / "fleet.json")
    errlog = str(tmp_path / "stderr.log")
    # enough traffic that the port's CPU fleet is still serving when
    # the SIGHUP lands
    n_req, max_new, prompt_len = 60, 12, 4
    jm = JaxLM(vocab=43, d_model=32, n_heads=4, n_layers=1, d_ff=64,
               max_len=32, attention="reference", pos_emb="rope")
    zeros = jnp.zeros((1, 4), jnp.int32)
    v1_path = str(tmp_path / "v1.npz")        # the incumbent, kept
    for seed, path, version in ((0, weights, "v1"), (0, v1_path, "v1"),
                                (1, v2_path, None)):
        prm = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(seed), zeros)["params"])
        prm["lm_head"]["kernel"] = prm["lm_head"]["kernel"] * 4.0
        jweights.publish_weights(prm, path, weights_version=version)
    argv = ["--out", out, "--requests", str(n_req), "--prompt-len",
            str(prompt_len), "--max-new-tokens", str(max_new),
            "--n-layers", "1", "--replicas", "3", "--seed", "0",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    env.pop("CHAINERMN_TPU_CHAOS", None)
    with open(errlog, "w") as ef:
        proc = subprocess.Popen(
            [sys.executable, "-m", "chainermn_torch.tools.fleet_lm", *argv,
             "--weights", weights, "--report", report, "--rollout",
             v2_path], env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
            stderr=ef)
        try:
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    break
                with open(errlog) as f:
                    if "queued" in f.read():
                        break
                time.sleep(0.1)
            assert proc.poll() is None, open(errlog).read()[-2000:]
            time.sleep(0.05)
            os.kill(proc.pid, signal.SIGHUP)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
    stderr_text = open(errlog).read()
    assert rc == 0, stderr_text[-2000:]
    assert '"status": "completed"' in stderr_text, stderr_text[-2000:]
    with open(report) as f:
        fleet = json.load(f)["fleet"]
    assert fleet["rollouts"]["completed"] == 1
    assert all(v == "v2.npz" for v in fleet["weights_versions"].values())
    with open(weights + ".json") as f:
        assert json.load(f)["weights_version"] == "v2.npz"
    args = fleet_lm.parse_args(argv)
    fab = fleet_lm._engine_factory(args)
    versions = [fleet_lm.load_state(p, fab.model)[0]
                for p in (v1_path, v2_path)]
    rng = np.random.RandomState(0)
    prompts = {i: rng.randint(0, 43, (prompt_len,)).astype(np.int32)
               for i in range(n_req)}
    refs = {i: [] for i in prompts}
    for prm in versions:
        eng = fab.make(prm)
        reqs = {i: eng.submit(p, seed=i) for i, p in prompts.items()}
        eng.run_until_drained()
        for i, r in reqs.items():
            refs[i].append(r.tokens)
    with open(out) as f:
        rows = {r["request_id"]: r
                for r in (json.loads(line) for line in f if line.strip())}
    assert sorted(rows) == list(range(n_req)), "fleet did not drain"
    for i in prompts:
        assert rows[i]["tokens"] in refs[i], (
            f"stream {i} is neither version's oracle")
