"""The fleet slice as a whole: real small port engines, routed and
disaggregated, against JAX's ``Router``/``DisaggregatedFleet`` over JAX
engines on the same parameters.

Tier-1: the port's Router (clean, and with a replica killed by chaos)
and DisaggregatedFleet (f32 and int8-block wire, sync and async
conveyor, streamed format-5 frames) give JAX's greedy streams; f32
streams are equal token for token, and so are int8-block ones here
(the int8 logit error stays within JAX's calibrated bound, 10 x half
the coarsest per-block scale, which ``test_torch_fleet_handoff.py``
checks; at these margins it moves no argmax). The JAX side runs once
per mode and is cached. The slow tier mirrors
``tests/fleet_tests/test_pools.py`` on the port (JAX marks that file
slow), holding each stream to JAX's ``generate()``.

Model: vocab 43, d 32, 2 layers (``fleet_lm``'s defaults), JAX's
parameters converted into the port's model with the LM head scaled 4x
so greedy margins stay far above the two frameworks' f32 disagreement
(about 1e-6).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu import fleet as jfleet
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.serving.engine import Engine as JaxEngine
from chainermn_tpu.serving.engine import EngineConfig as JaxEngineConfig
from chainermn_torch.fleet import (DisaggregatedFleet, FleetReport,
                                   InProcessTransport, Router)
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving.engine import Engine, EngineConfig

VOCAB = 43
N_NEW = 6
CFG = dict(vocab=VOCAB, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=32, attention="reference", pos_emb="rope")


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    """(JAX model, its params with the head scaled, the port's model)."""
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _cfg_kw(**kw):
    # exact-length buckets + singleton cohorts, as JAX's test_pools
    base = dict(n_slots=2, capacity=16, max_new_tokens=N_NEW,
                prefill_cohort=1, buckets=[3, 4, 16])
    base.update(kw)
    return base


def _engine(**kw):
    return Engine(_setup()[2], EngineConfig(**_cfg_kw(**kw)), device="cpu")


def _jax_engine(**kw):
    jm, params, _tm = _setup()
    return JaxEngine(jm, params, JaxEngineConfig(**_cfg_kw(**kw)))


def _prompts(seed=0, lens=(3, 4, 4, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# the slice as a whole: the port's fleets give JAX's fleets' streams
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_disagg_streams(wire_format):
    fleet = jfleet.DisaggregatedFleet(_jax_engine(), _jax_engine(),
                                      wire_format=wire_format)
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in _prompts()]
    fleet.run_until_drained()
    assert fleet.report.handoff_fallbacks == 0
    return tuple(tuple(s.tokens) for s in streams)


@functools.lru_cache(maxsize=None)
def _jax_router_streams():
    prompts = _prompts(seed=2, lens=(3, 4, 4, 3, 4, 3))
    with jfleet.Router([_jax_engine(), _jax_engine()]) as router:
        futs = [router.submit(p, max_new_tokens=N_NEW) for p in prompts]
        reqs = [router.result(f, timeout_ms=120_000) for f in futs]
    return prompts, tuple(tuple(r.tokens) for r in reqs)


_MODES = [("f32", False, False), ("f32", True, False), ("f32", False, True),
          ("int8-block", False, False), ("int8-block", True, True)]


@pytest.mark.parametrize("wire_format,async_conveyor,streamed", _MODES,
                         ids=["f32-sync", "f32-async", "f32-streamed",
                              "int8-sync", "int8-async-streamed"])
def test_disaggregated_fleet_gives_jaxs_streams(wire_format, async_conveyor,
                                                streamed):
    want = _jax_disagg_streams(wire_format)
    report = FleetReport()
    fleet = DisaggregatedFleet(_engine(), _engine(),
                               wire_format=wire_format, report=report,
                               transport=InProcessTransport(),
                               async_conveyor=async_conveyor,
                               streamed=streamed)
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in _prompts()]
    fleet.run_until_drained()
    fleet.close()
    assert tuple(tuple(s.tokens) for s in streams) == want
    assert all(s.finished and not s.fell_back for s in streams)
    assert report.handoffs == len(streams)
    assert report.handoff_wire_bytes[wire_format] > 0
    if async_conveyor:
        assert fleet.stats["transfers"] == len(streams)


def test_the_two_wires_and_the_two_packages_agree_on_f32():
    """JAX's own disaggregated f32 streams are its routed streams'
    prompts' single-engine streams: the oracle the modes above share."""
    jm, params, _tm = _setup()
    for p, toks in zip(_prompts(), _jax_disagg_streams("f32")):
        ref = np.asarray(jax_generate(jm, params, p[None], N_NEW))
        assert list(toks) == ref[0, len(p):].tolist()


@pytest.mark.parametrize("chaos_spec", [None, "kill_replica@step=2,replica=1"],
                         ids=["clean", "kill-replica"])
def test_router_gives_jaxs_streams(monkeypatch, chaos_spec):
    from chainermn_torch.resilience import chaos

    prompts, want = _jax_router_streams()
    if chaos_spec:
        monkeypatch.setenv(chaos.ENV_VAR, chaos_spec)
    else:
        monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    monkeypatch.setattr(chaos, "_plan", None)
    monkeypatch.setattr(chaos, "_plan_spec", None)
    with Router([_engine(), _engine()]) as router:
        futs = [router.submit(p, max_new_tokens=N_NEW) for p in prompts]
        reqs = [router.result(f, timeout_ms=120_000) for f in futs]
        fleet = router.summary()["fleet"]
    assert tuple(tuple(r.tokens) for r in reqs) == want
    assert fleet["replicas_dead"] == (1 if chaos_spec else 0)
    if chaos_spec:
        assert fleet["requeued"] > 0


def test_a_drained_replica_migrates_sessions_bitwise():
    """Router.drain on real port engines: sessions frozen mid-decode
    move to the survivor over the handoff wire and finish as JAX's
    routed streams; tokens are emitted once."""
    import time

    prompts, want = _jax_router_streams()
    engines = [_engine(max_new_tokens=N_NEW), _engine()]
    with Router(engines) as router:
        futs = [router.submit(p, max_new_tokens=N_NEW) for p in prompts]
        deadline = time.monotonic() + 60
        while not any(len(r.tokens) >= 2
                      for r in list(engines[0].active.values())):
            assert time.monotonic() < deadline, "nothing reached decode"
            time.sleep(0.001)
        out = router.drain(0, deadline_ms=60_000)
        reqs = [router.result(f, timeout_ms=120_000) for f in futs]
        summary = router.summary()
    assert out["state"] == "DRAINED"
    assert tuple(tuple(r.tokens) for r in reqs) == want
    assert summary["fleet"]["replicas_drained"] == 1
    assert summary["tokens_emitted"] == sum(len(t) for t in want)


# ---------------------------------------------------------------------------
# the slow tier: tests/fleet_tests/test_pools.py on the port
# ---------------------------------------------------------------------------


def _oracle(p):
    jm, params, _tm = _setup()
    return np.asarray(jax_generate(jm, params, p[None], N_NEW))[0, len(p):]


@pytest.mark.slow
@pytest.mark.parametrize("chunk", [None, 3, 5])
def test_raw_disagg_streams_bitwise_vs_single_engine(chunk):
    prompts = _prompts()
    pre = (_engine(prefill_chunk=chunk, buckets=None) if chunk
           else _engine())
    fleet = DisaggregatedFleet(pre, _engine())
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fleet.run_until_drained()
    single = _engine()
    reqs = [single.submit(p, max_new_tokens=N_NEW) for p in prompts]
    single.run_until_drained()
    for p, s, r in zip(prompts, streams, reqs):
        ref = _oracle(p)
        np.testing.assert_array_equal(np.asarray(s.tokens), ref)
        np.testing.assert_array_equal(np.asarray(r.tokens), ref)
        assert s.finished and not s.fell_back
    assert fleet.report.handoffs == len(prompts)
    assert fleet.report.handoff_fallbacks == 0


@pytest.mark.slow
def test_sampled_disagg_streams_bitwise_vs_single_engine():
    prompts = _prompts(seed=5)
    kw = dict(temperature=0.8, top_k=7)
    fleet = DisaggregatedFleet(_engine(), _engine())
    streams = [fleet.submit(p, max_new_tokens=N_NEW, seed=i, **kw)
               for i, p in enumerate(prompts)]
    fleet.run_until_drained()
    single = _engine()
    reqs = [single.submit(p, max_new_tokens=N_NEW, seed=i, **kw)
            for i, p in enumerate(prompts)]
    single.run_until_drained()
    for s, r in zip(streams, reqs):
        assert s.tokens == r.tokens


@pytest.mark.slow
def test_int8_handoff_drains_with_wire_accounted():
    prompts = _prompts()
    report = FleetReport()
    fleet = DisaggregatedFleet(_engine(), _engine(),
                               wire_format="int8-block", report=report)
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fleet.run_until_drained()
    assert all(s.finished and len(s.tokens) == N_NEW for s in streams)
    assert report.handoffs == len(prompts)
    assert report.handoff_wire_bytes["int8-block"] > 0
    summary = fleet.summary()
    assert summary["fleet"]["handoffs"] == len(prompts)
    assert summary["requests"]["completed"] == 2 * len(prompts)


@pytest.mark.slow
@pytest.mark.parametrize("spec,n", [("corrupt_handoff@offset=64", 4),
                                    ("corrupt_handoff@keep=32", 2)],
                         ids=["corrupt", "truncated"])
def test_damaged_handoff_falls_back_to_clean_reprefill(monkeypatch, spec,
                                                       n):
    from chainermn_torch.resilience import chaos

    monkeypatch.setenv(chaos.ENV_VAR, spec)
    monkeypatch.setattr(chaos, "_plan", None)
    monkeypatch.setattr(chaos, "_plan_spec", None)
    prompts = _prompts()[:n]
    fleet = DisaggregatedFleet(_engine(), _engine())
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fleet.run_until_drained()
    for p, s in zip(prompts, streams):
        np.testing.assert_array_equal(np.asarray(s.tokens), _oracle(p))
        assert s.fell_back
    assert fleet.report.handoff_fallbacks == n
    assert sorted(fleet.decode.engine.free_slots) == [0, 1]
    assert sorted(fleet.prefill.engine.free_slots) == [0, 1]


@pytest.mark.slow
def test_eos_at_prefill_crosses_handoff():
    prompt = _prompts()[0]
    eos = int(_oracle(prompt)[0])
    fleet = DisaggregatedFleet(_engine(), _engine())
    stream = fleet.submit(prompt, max_new_tokens=N_NEW, eos_id=eos)
    fleet.run_until_drained()
    assert stream.tokens == [eos]
    assert stream.finished


@pytest.mark.slow
def test_streamed_disagg_streams_bitwise_vs_generate():
    prompts = _prompts()
    report = FleetReport()
    fleet = DisaggregatedFleet(_engine(), _engine(), streamed=True,
                               report=report)
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fleet.run_until_drained()
    for p, s in zip(prompts, streams):
        np.testing.assert_array_equal(np.asarray(s.tokens), _oracle(p))
        assert not s.fell_back
    mono = DisaggregatedFleet(_engine(), _engine(), report=FleetReport())
    for p in prompts:
        mono.submit(p, max_new_tokens=N_NEW)
    mono.run_until_drained()
    assert report.handoff_wire_bytes["f32"] \
        == mono.report.handoff_wire_bytes["f32"]


def test_a_bf16_fleet_ships_bf16_pages():
    """A bf16 port fleet's f32 wire carries the pages at 2 B an element
    (JAX's width for its bf16 cache) and still finishes every stream as
    the bf16 single engine does."""
    _jm, _params, tm = _setup()
    bm = TransformerLM(**CFG, dtype=torch.bfloat16, device="cpu")
    bm.load_state_dict(tm.state_dict())

    def eng():
        return Engine(bm, EngineConfig(**_cfg_kw()), device="cpu")

    prompts = _prompts()
    report = FleetReport()
    fleet = DisaggregatedFleet(eng(), eng(), report=report)
    streams = [fleet.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fleet.run_until_drained()
    single = eng()
    reqs = [single.submit(p, max_new_tokens=N_NEW) for p in prompts]
    single.run_until_drained()
    assert [s.tokens for s in streams] == [r.tokens for r in reqs]
    # fill = prompt, 2 layers x k,v x [fill, 4 heads, 8] bf16 + int64 key
    want = sum(2 * 2 * len(p) * 4 * 8 * 2 + 16 for p in prompts)
    assert report.handoff_wire_bytes["f32"] == want
