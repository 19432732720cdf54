"""Port parity: chainermn_torch's serving Engine against the JAX
package's Engine, plus the port's sampling contract and cache sizing.

Both engines serve the same prompts with the same converted parameters
and the flash attention path (the Pallas kernel in interpret mode on the
JAX side, the plain PyTorch version on the port's). Greedy streams must
be EQUAL: the LM head is scaled up 4x so the top-2 logit margins stay
far above the f32 disagreement (about 1e-6) of the two frameworks.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu.serving.engine import Engine as JaxEngine
from chainermn_tpu.serving.engine import EngineConfig as JaxEngineConfig
from chainermn_tpu.serving.reports import ServingReport as JaxReport
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving import kv_cache as tkv
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.reports import ServingReport
from chainermn_torch.serving.sampling import (gumbel, request_key,
                                              sample_tokens)

CFG = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=48, max_len=64, pos_emb="rope", attention="flash")
BASE = dict(n_slots=3, capacity=32, max_new_tokens=6, prefill_cohort=2,
            buckets=[8, 16, 32])
PROMPT_LENS = (3, 7, 12, 5, 9)


@functools.lru_cache(maxsize=None)
def _models():
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab"], (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _serve_torch(tm, cfg, prompts, **submit):
    eng = Engine(tm, cfg, device="cpu")
    reqs = [eng.submit(p, **submit) for p in prompts]
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("extra", [dict(decode_k=1), dict(decode_k=4),
                                   dict(decode_k=2, prefill_chunk=4)],
                         ids=["mono-k1", "mono-k4", "chunked-k2"])
def test_greedy_streams_equal_the_jax_engine(extra):
    jm, params, tm = _models()
    prompts = _prompts()
    jeng = JaxEngine(jm, params, JaxEngineConfig(**BASE, **extra))
    jreqs = [jeng.submit(p) for p in prompts]
    jeng.run_until_drained()
    eng, reqs = _serve_torch(tm, EngineConfig(**BASE, **extra), prompts)
    for j, t in zip(jreqs, reqs):
        assert t.state == j.state == "done"
        assert t.tokens == j.tokens
    assert eng.idle() and sorted(eng.free_slots) == [0, 1, 2]
    assert eng.report.summary()["tokens_emitted"] == 6 * len(prompts)


def test_last_decode_logits_match_the_jax_engine():
    """Greedy token equality sits on logit parity: compare the final
    decode dispatch's logits of both engines (f32, 1e-4)."""
    jm, params, tm = _models()
    prompt = _prompts()[1]
    cfg = dict(BASE, n_slots=1, decode_k=2)
    jeng = JaxEngine(jm, params, JaxEngineConfig(**cfg))
    jeng.submit(prompt, max_new_tokens=3)
    jeng.step()
    eng = Engine(tm, EngineConfig(**cfg), device="cpu")
    eng.submit(prompt, max_new_tokens=3)
    eng.step()
    np.testing.assert_allclose(eng.last_logits, jeng.last_logits,
                               rtol=1e-4, atol=1e-4)


def test_a_greedy_engine_draws_no_noise_on_the_same_key_stream(
        monkeypatch):
    """An engine whose live rows are all greedy skips the Gumbel draw
    (the temperatures are on the host) and still splits every row's key
    once a token: its tokens and key rows equal a run that draws the
    noise for every row."""
    import chainermn_torch.serving.kv_cache as kvc
    import chainermn_torch.serving.sampling as samp

    _, _, tm = _models()
    prompts = _prompts(3)
    cfg = EngineConfig(**BASE, decode_k=2, prefill_chunk=4)
    with monkeypatch.context() as m:
        m.setattr(kvc, "any_sampling", lambda *a, **k: True)
        drawn, drawn_reqs = _serve_torch(tm, cfg, prompts)

    def no_draw(*a, **k):
        raise AssertionError("a greedy engine drew Gumbel noise")

    monkeypatch.setattr(samp, "gumbel", no_draw)
    eng, reqs = _serve_torch(tm, cfg, prompts)
    assert [r.tokens for r in reqs] == [r.tokens for r in drawn_reqs]
    np.testing.assert_array_equal(eng._keys.numpy(), drawn._keys.numpy())


@pytest.mark.parametrize("extra", [dict(), dict(prefill_chunk=4)],
                         ids=["mono", "chunked"])
def test_sampled_stream_is_independent_of_decode_k(extra):
    """One draw per sampled token per slot: a seed replays the same
    stream at decode_k 1 and 4, and chunked prefill changes nothing."""
    _, _, tm = _models()
    prompts = _prompts(seed=1)
    streams = []
    for k in (1, 4):
        cfg = EngineConfig(**BASE, decode_k=k, **extra)
        eng = Engine(tm, cfg, device="cpu")
        reqs = [eng.submit(p, temperature=1.0, top_k=0 if i % 2 else 8,
                           seed=11 + i) for i, p in enumerate(prompts)]
        eng.run_until_drained()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
    _, greedy = _serve_torch(tm, EngineConfig(**BASE), prompts)
    assert streams[0] != [r.tokens for r in greedy]
    if extra:
        _, mono = _serve_torch(tm, EngineConfig(**BASE, decode_k=4),
                               prompts, temperature=1.0)
        _, chunk = _serve_torch(tm, EngineConfig(**BASE, decode_k=4,
                                                 **extra),
                                prompts, temperature=1.0)
        assert [r.tokens for r in mono] == [r.tokens for r in chunk]


def test_sampling_encoding():
    """temp <= 0 is greedy (first index on ties), top_k = 1 is greedy
    too, every row advances its key by exactly one split (JAX's), and
    the noise is a pure function of the key."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.5, 0.1, 0.2, 0.4],
                           [0.0, 0.0, 5.0, 0.0]])
    keys = torch.stack([request_key(s) for s in (1, 2, 3)])
    tok, new = sample_tokens(logits, keys, torch.tensor([0.0, 1.0, 2.0]),
                             torch.tensor([0, 1, 0]))
    assert tok[0] == 1 and tok[1] == 0
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in (1, 2, 3)])
    want = jax.vmap(lambda k: jax.random.split(k, 2))(jkeys)[:, 0]
    np.testing.assert_array_equal(new.numpy(), np.asarray(want))
    assert torch.equal(gumbel(keys, (8,)), gumbel(keys, (8,)))
    assert not torch.equal(gumbel(keys, (8,)), gumbel(new, (8,)))
    # a categorical draw, not an argmax: frequencies follow softmax
    many = torch.stack([request_key(s) for s in range(4000)])
    p = torch.tensor([[0.0, 1.0, 2.0]]).expand(4000, 3)
    draws, _ = sample_tokens(p, many, torch.ones(4000),
                             torch.zeros(4000, dtype=torch.int64))
    freq = torch.bincount(draws, minlength=3).float() / 4000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(p[0], 0).numpy(), atol=0.03)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_equal_the_jax_figure(dtype):
    jm, _, tm = _models()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jkv.cache_bytes(jm, 8, 2048, jd)
    assert tkv.cache_bytes(tm, 8, 2048, td) == want
    eng = Engine(tm, EngineConfig(n_slots=2, capacity=16, cache_dtype=td),
                 device="cpu")
    assert eng.steps.cache_bytes() == jkv.cache_bytes(jm, 2, 16, jd)


def test_serving_report_matches_the_jax_report():
    """The port's copy of ServingReport summarises the same events to
    the same numbers under one injected clock."""
    def drive(report_cls):
        clock = iter(np.arange(0.0, 100.0, 0.25).tolist())
        rep = report_cls(lambda: next(clock))
        for rid in range(3):
            rep.record_submit(rid)
        for rid in (0, 1, 0, 2, 1, 0):
            rep.record_token(rid)
        rep.record_host_bytes(48)
        rep.record_step(2, 0.5)
        rep.record_retire(0)
        rep.record_retire(1, aborted=True)
        return rep.json()          # NaN fields compare as text

    assert drive(ServingReport) == drive(JaxReport)


def test_report_wire_envelope_is_the_jax_packages():
    """``to_wire`` of the same events is JAX's envelope, JSON and all;
    ``from_wire`` takes either package's envelope back to the same
    ``raw()``, and refuses another kind or version with JAX's texts."""
    import json

    from chainermn_tpu.serving.reports import (
        ServingReport as JaxWireReport)
    from chainermn_torch.serving.reports import REPORT_WIRE_VERSION

    def drive(report_cls):
        clock = iter(np.arange(0.0, 100.0, 0.25).tolist())
        rep = report_cls(lambda: next(clock))
        rep.record_submit(0)
        rep.record_token(0)
        rep.record_spec_round(4, 2, 3)
        rep.record_retire(0)
        return rep

    wire = drive(ServingReport).to_wire()
    assert json.dumps(wire) == json.dumps(drive(JaxWireReport).to_wire())
    back = ServingReport.from_wire(json.loads(json.dumps(wire)))
    assert back.raw() == drive(ServingReport).raw()
    with pytest.raises(ValueError, match="not a serving_report envelope"):
        ServingReport.from_wire({"kind": "other"})
    with pytest.raises(ValueError, match="mixed-version fleet"):
        ServingReport.from_wire(dict(wire,
                                     version=REPORT_WIRE_VERSION + 1))
    with pytest.raises(ValueError, match="missing keys"):
        ServingReport.from_wire(dict(wire, raw={}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_engine_serves_a_snapshot_that_only_load_params_updates(dtype):
    """Whatever the model's dtype, the engine serves the weights it saw
    at construction: it shares no storage with the model and takes no
    .grad, an in-place update of the model does not reach it, and
    load_params (which casts) does."""
    torch.manual_seed(3)
    tm = TransformerLM(**CFG, dtype=dtype, device="cpu")
    tm.lm_head.weight.grad = torch.ones_like(tm.lm_head.weight)
    cfg = EngineConfig(**BASE)
    prompts = _prompts(seed=4)[:3]

    def streams(eng):
        reqs = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
        return [r.tokens for r in reqs]

    eng = Engine(tm, cfg, device="cpu")
    snap = eng.steps.model
    ptrs = {p.data_ptr() for p in tm.parameters()}
    assert all(p.grad is None and p.data_ptr() not in ptrs
               for p in snap.parameters())
    assert snap.blocks[0].q_proj.weight.dtype == dtype
    assert snap.lm_head.weight.dtype == torch.float32
    before = streams(eng)
    with torch.no_grad():
        tm.lm_head.weight.neg_()
    assert streams(eng) == before
    fresh = streams(Engine(tm, cfg, device="cpu"))
    assert fresh != before
    eng.steps.load_params(tm.state_dict())
    assert streams(eng) == fresh
