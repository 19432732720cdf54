"""Speculative decoding of the port, mirroring the JAX package's
``tests/serving_tests/test_speculative.py``, plus ``generate``'s sampled
path.

Every emitted token is sampled by the target with the plain engine's key
stream, so speculative streams must EQUAL the port's plain engine's,
greedy and sampled, raw and int8 pages, at several scheduler shapes and
``spec_k``. The port's verify chunk and decode step run GEMMs of
different shapes, which on the CPU differ in their last bits (the gap is
measured here: under 1e-5); the LM head is scaled 4x so top-2 margins,
and Gumbel-max margins, stay far above it. A self-draft accepts every
proposal (acceptance 1.0, 4 tokens a dispatch at ``spec_k`` 3), the
wrap and vocabulary refusals use JAX's texts, an import into a
speculative engine continues the source's stream, and the greedy
speculative stream equals JAX's speculative engine's.

Small models (vocab 43, d 32; target 2 layers, draft 1);
``attention="reference"`` except in the one flash case.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving.engine import EngineConfig as JaxEngineConfig
from chainermn_tpu.serving.speculative import (
    SpeculativeEngine as JaxSpeculativeEngine)
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM, generate
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import (decode_apply, init_cache,
                                              prefill_apply)
from chainermn_torch.serving.speculative import SpeculativeEngine

VOCAB = 43


def _cfg(n_layers, attention):
    return dict(vocab=VOCAB, d_model=32, n_heads=4, n_layers=n_layers,
                d_ff=48, max_len=64, attention=attention, pos_emb="rope")


@functools.lru_cache(maxsize=None)
def _pair(n_layers, seed, attention="reference"):
    jm = JaxLM(**_cfg(n_layers, attention))
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**_cfg(n_layers, attention), device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _models(attention="reference"):
    return _pair(2, 0, attention)[2], _pair(1, 1, attention)[2]


def _prompts(seed=0, lens=(3, 4, 5, 4)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


def _run(eng, prompts, kws):
    reqs = [eng.submit(p, **kw) for p, kw in zip(prompts, kws)]
    eng.run_until_drained()
    return [list(r.tokens) for r in reqs]


_MODES = {
    "greedy": lambda i: {},
    "sampled": lambda i: dict(temperature=0.9, top_k=8, seed=100 + i),
    "mixed": lambda i: ({} if i % 2 == 0
                        else dict(temperature=0.8, top_k=6, seed=100 + i)),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("kv_dtype", [None, "int8-block"])
def test_spec_streams_equal_the_plain_engine(mode, kv_dtype):
    tgt, draft = _models()
    prompts = _prompts()
    kws = [_MODES[mode](i) for i in range(len(prompts))]
    cfg = EngineConfig(n_slots=2, capacity=32, max_new_tokens=7,
                       prefill_cohort=1, buckets=[8, 32], kv_dtype=kv_dtype)
    want = _run(Engine(tgt, cfg, device="cpu"), prompts, kws)
    spec = SpeculativeEngine(tgt, draft, cfg, spec_k=3, device="cpu")
    assert _run(spec, prompts, kws) == want
    assert spec.report.spec_dispatches > 0


@pytest.mark.parametrize("cfg_kw, spec_k", [
    (dict(buckets=[32], prefill_chunk=2, max_new_tokens=6), 2),
    (dict(buckets=[8, 32], max_new_tokens=6, token_budget=8), 3),
    (dict(buckets=[8, 32], max_new_tokens=6, decode_k=1), 1),
])
def test_spec_parity_across_scheduler_shapes(cfg_kw, spec_k):
    tgt, draft = _models()
    prompts = _prompts()
    cfg = EngineConfig(n_slots=2, capacity=32, prefill_cohort=1, **cfg_kw)
    kws = [dict(temperature=0.7, top_k=5, seed=7) for _ in prompts]
    want = _run(Engine(tgt, cfg, device="cpu"), prompts, kws)
    spec = SpeculativeEngine(tgt, draft, cfg, spec_k=spec_k, device="cpu")
    assert _run(spec, prompts, kws) == want


def test_spec_eos_retirement_parity():
    tgt, draft = _models()
    prompt = _prompts()[0]
    cfg = EngineConfig(n_slots=1, capacity=32, max_new_tokens=8,
                       prefill_cohort=1, buckets=[8, 32])
    full = _run(Engine(tgt, cfg, device="cpu"), [prompt], [{}])[0]
    eos = full[3]
    want = _run(Engine(tgt, cfg, device="cpu"), [prompt], [dict(eos_id=eos)])
    got = _run(SpeculativeEngine(tgt, draft, cfg, spec_k=4, device="cpu"),
               [prompt], [dict(eos_id=eos)])
    assert got == want and len(got[0]) < 8


def test_self_draft_accepts_everything():
    """Draft == target: identical weights on identical mirrored pages
    propose what the target samples, so every round emits spec_k + 1."""
    tgt, _ = _models()
    prompt = _prompts()[0]
    cfg = EngineConfig(n_slots=1, capacity=32, max_new_tokens=9,
                       prefill_cohort=1, buckets=[8, 32])
    for kw in ({}, dict(temperature=0.8, top_k=6, seed=11)):
        want = _run(Engine(tgt, cfg, device="cpu"), [prompt], [kw])
        spec = SpeculativeEngine(tgt, tgt, cfg, spec_k=3, device="cpu")
        assert _run(spec, [prompt], [kw]) == want
        s = spec.report.summary()
        assert s["acceptance_rate"] == 1.0
        assert s["tokens_per_dispatch"] == 4.0
        assert s["draft_tokens_proposed"] == 6
        assert s["draft_tokens_accepted"] == 6


def test_acceptance_telemetry_is_deterministic():
    tgt, draft = _models()
    prompts = _prompts()
    cfg = EngineConfig(n_slots=2, capacity=32, max_new_tokens=7,
                       prefill_cohort=1, buckets=[8, 32])

    def run():
        spec = SpeculativeEngine(tgt, draft, cfg, spec_k=3, device="cpu")
        toks = _run(spec, prompts, [dict(temperature=0.9, top_k=8,
                                         seed=100 + i)
                                    for i in range(len(prompts))])
        raw = spec.report.raw()
        return toks, {k: raw[k] for k in ("draft_tokens_proposed",
                                          "draft_tokens_accepted",
                                          "spec_dispatches",
                                          "spec_tokens_emitted")}

    (t1, s1), (t2, s2) = run(), run()
    assert t1 == t2 and s1 == s2 and s1["spec_dispatches"] > 0
    assert s1["spec_tokens_emitted"] >= s1["spec_dispatches"]


def test_submit_rejects_wrap_risk_and_vocab_mismatch():
    tgt, draft = _models()
    cfg = EngineConfig(n_slots=1, capacity=32, max_new_tokens=8,
                       prefill_cohort=1, buckets=[8, 32])
    spec = SpeculativeEngine(tgt, draft, cfg, spec_k=4, device="cpu")
    prompt = np.arange(8, dtype=np.int32) % VOCAB
    spec.submit(prompt, max_new_tokens=32 - 8 - 4)
    with pytest.raises(ValueError, match="speculative decode forbids ring"):
        spec.submit(prompt, max_new_tokens=32 - 8 - 4 + 1)
    other = TransformerLM(**dict(_cfg(1, "reference"), vocab=44),
                          device="cpu")
    with pytest.raises(ValueError, match="draft vocab 44 != target"):
        SpeculativeEngine(tgt, other, cfg, spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        SpeculativeEngine(tgt, draft, cfg, spec_k=0, device="cpu")


def test_spec_import_handoff_continues_the_stream():
    tgt, draft = _models()
    prompt = _prompts()[0]
    cfg = EngineConfig(n_slots=1, capacity=32, max_new_tokens=10,
                       prefill_cohort=1, buckets=[8, 32])
    knobs = dict(temperature=0.8, top_k=6, seed=3)
    src = Engine(tgt, cfg, device="cpu")
    held = src.submit(prompt, max_new_tokens=4, hold=True, **knobs)
    src.run_until_drained()
    dst = SpeculativeEngine(tgt, draft, cfg, spec_k=3, device="cpu")
    adopted = dst.import_handoff(src.export_handoff(held), prompt,
                                 max_new_tokens=8)
    dst.run_until_drained()
    want = _run(Engine(tgt, cfg, device="cpu"), [prompt],
                [dict(max_new_tokens=8, **knobs)])[0]
    assert adopted.tokens == want


def test_spec_import_rejects_wrap_risk():
    tgt, draft = _models()
    prompt = np.arange(8, dtype=np.int32) % VOCAB
    cfg = EngineConfig(n_slots=1, capacity=32, max_new_tokens=24,
                       prefill_cohort=1, buckets=[8, 32])
    src = Engine(tgt, cfg, device="cpu")
    held = src.submit(prompt, max_new_tokens=4, hold=True)
    src.run_until_drained()
    dst = SpeculativeEngine(tgt, draft, cfg, spec_k=4, device="cpu")
    with pytest.raises(ValueError, match="speculative no-wrap margin"):
        dst.import_handoff(src.export_handoff(held), prompt,
                           max_new_tokens=24)
    assert dst.idle() and dst.free_slots == [0]


def test_chunk_versus_decode_logit_gap_is_last_bits():
    """The verify chunk's logits against decode's at the same positions:
    not bitwise on the CPU (GEMMs of other shapes), but within 1e-5."""
    tgt, _ = _models()
    toks = torch.as_tensor(np.random.RandomState(4).randint(0, VOCAB,
                                                            (2, 12)))
    caches = []
    for _ in range(2):
        c = init_cache(tgt, 2, 32)
        prefill_apply(tgt, c, toks[:, :6], torch.tensor([6, 6]),
                      torch.arange(2))
        caches.append(c)
    dec = torch.stack([decode_apply(tgt, caches[0], toks[:, j])[0]
                       for j in range(6, 12)], dim=1)
    with torch.no_grad():
        chunk = tgt.forward_cached(toks[:, 6:], caches[1], chunked=True)
    assert float((chunk - dec).abs().max()) < 1e-5


def test_greedy_spec_stream_equals_jaxs():
    """The port's speculative engine and JAX's, both on the flash path
    and the same converted weights: the same greedy streams."""
    jt, jtp, tgt = _pair(2, 0, "flash")
    jd, jdp, draft = _pair(1, 1, "flash")
    prompts = _prompts(seed=2)[:2]
    kw = dict(n_slots=2, capacity=32, max_new_tokens=6, prefill_cohort=1,
              buckets=[8, 32])
    jeng = JaxSpeculativeEngine(jt, jtp, jd, jdp, JaxEngineConfig(**kw),
                                spec_k=2)
    jreqs = [jeng.submit(p) for p in prompts]
    jeng.run_until_drained()
    spec = SpeculativeEngine(tgt, draft, EngineConfig(**kw), spec_k=2,
                             device="cpu")
    assert _run(spec, prompts, [{}, {}]) == [r.tokens for r in jreqs]


def test_generate_samples_deterministically_within_top_k():
    """``generate``'s sampled path: one seed replays its streams (cached
    and recomputed paths alike), another seed differs, every token lies
    in its step's top-k, and rng=None stays greedy."""
    tgt, _ = _models()
    prompt = torch.as_tensor(np.random.RandomState(5).randint(0, VOCAB,
                                                              (3, 4)))
    a = generate(tgt, prompt, 8, rng=3, temperature=1.5, top_k=4)
    assert torch.equal(a, generate(tgt, prompt, 8, rng=3, temperature=1.5,
                                   top_k=4))
    assert torch.equal(a, generate(tgt, prompt, 8, rng=3, temperature=1.5,
                                   top_k=4, use_cache=False))
    assert not torch.equal(a, generate(tgt, prompt, 8, rng=4,
                                       temperature=1.5, top_k=4))
    with torch.no_grad():
        logits = tgt(a[:, :-1])[:, 3:]           # the logits each drew from
    kth = logits.topk(4, dim=-1).values[..., -1:]
    drawn = logits.gather(-1, a[:, 4:, None])
    assert bool((drawn >= kth).all())
    greedy = generate(tgt, prompt, 8)
    with torch.no_grad():
        again = tgt(greedy[:, :-1])[:, 3:].argmax(-1)
    assert torch.equal(greedy[:, 4:], again)
    assert not torch.equal(a, greedy)
