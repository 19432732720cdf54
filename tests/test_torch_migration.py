"""Handoffs, sessions, aborts and weight swaps on the port's Engine,
mirroring the JAX package's ``tests/serving_tests/test_migration.py``.

A stream frozen mid-decode by ``export_session`` and adopted by
``import_session`` on a second engine finishes EQUAL, token for token,
to the stream the unmigrated engine produces, at every scheduler shape,
greedy and sampled; a prefill handoff (``hold=True`` →
``export_handoff`` → ``import_handoff``) continues likewise. Raw-page
round trips are bitwise, and all four page-mode crossings (raw→raw,
int8→int8 adopting the codes verbatim, int8→raw dequantizing once,
raw→int8 quantizing once) write the bytes they promise. Every misuse is
refused with the JAX package's text. One case crosses frameworks: pages
that JAX's engine exported, imported by the port's engine on converted
parameters, continue JAX's greedy stream. Streams are compared exactly;
the LM head is scaled 4x so greedy margins stay far above the f32
disagreement of the two frameworks (about 1e-6).

Small model (vocab 43, d 32, 1 layer); ``attention="reference"`` except
in the cross-framework case, which runs flash on both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving.engine import Engine as JaxEngine
from chainermn_tpu.serving.engine import EngineConfig as JaxEngineConfig
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving import kv_cache as tkv
from chainermn_torch.serving.engine import (Engine, EngineConfig,
                                            WeightsVersionSkew)

VOCAB = 43
N_NEW = 10
LENS = [4, 5]
CFG = dict(vocab=VOCAB, d_model=32, n_heads=4, n_layers=1, d_ff=48,
           max_len=64, pos_emb="rope")


@functools.lru_cache(maxsize=None)
def _setup(attention="reference", seed=0):
    jm = JaxLM(**CFG, attention=attention)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**CFG, attention=attention, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _cfg(**kw):
    base = dict(n_slots=2, capacity=32, max_new_tokens=N_NEW,
                prefill_cohort=1, buckets=sorted(set(LENS)) + [32])
    base.update(kw)
    return EngineConfig(**base)


def _engine(**kw):
    return Engine(_setup()[2], _cfg(**kw), device="cpu")


def _prompts(seed=0, lens=LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


def _until_mid_decode(eng, req, min_tokens=2, max_steps=200):
    for _ in range(max_steps):
        if (req.slot is not None and eng.active.get(req.slot) is req
                and len(req.tokens) >= min_tokens):
            return
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    raise AssertionError(f"request {req.request_id} never reached "
                         f"mid-decode (state={req.state!r})")


def _migrate(src, dst, req, prompt):
    adopted = dst.import_session(src.export_session(req), prompt)
    src.release_held(req)
    return adopted


def _unmigrated(shape, prompts, **submit):
    base = _engine(**shape)
    refs = [base.submit(p, **submit) for p in prompts]
    base.run_until_drained()
    return [list(r.tokens) for r in refs]


SHAPES = [dict(), dict(decode_k=3), dict(prefill_chunk=2),
          dict(decode_k=2, prefill_chunk=3, token_budget=8)]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["k1-mono", "k3-mono", "k1-chunk2",
                              "k2-chunk3-budget8"])
def test_mid_stream_migration_is_exact_and_counts_every_token(shape):
    prompts = _prompts()
    want = _unmigrated(shape, prompts)
    a, b = _engine(**shape), _engine(**shape)
    r0, r1 = [a.submit(p) for p in prompts]
    _until_mid_decode(a, r0)
    n_at_export = len(r0.tokens)
    assert 0 < n_at_export < N_NEW
    adopted = _migrate(a, b, r0, prompts[0])
    a.run_until_drained()
    b.run_until_drained()
    assert adopted.state == "done" and r1.state == "done"
    assert list(adopted.tokens) == want[0]
    assert list(r1.tokens) == want[1]
    a_tok = a.report.raw()["tokens_emitted"]
    b_tok = b.report.raw()["tokens_emitted"]
    assert a_tok == n_at_export + len(want[1])
    assert b_tok == len(want[0]) - n_at_export


def test_sampled_session_migrates_exactly():
    prompts = _prompts(seed=3)
    knobs = [dict(temperature=1.2, top_k=7, seed=100 + i)
             for i in range(len(prompts))]
    base = _engine()
    refs = [base.submit(p, **k) for p, k in zip(prompts, knobs)]
    base.run_until_drained()
    want = [list(r.tokens) for r in refs]
    assert any(len(set(w)) > 1 for w in want)
    a, b = _engine(), _engine()
    r0, r1 = [a.submit(p, **k) for p, k in zip(prompts, knobs)]
    _until_mid_decode(a, r0, min_tokens=3)
    adopted = _migrate(a, b, r0, prompts[0])
    a.run_until_drained()
    b.run_until_drained()
    assert list(adopted.tokens) == want[0]
    assert list(r1.tokens) == want[1]


def test_prefill_handoff_continues_the_stream():
    """hold=True parks the request after its first token; the handoff
    carries the rows up to the real fill, the cursor and the advanced
    key row, and the adopting engine finishes the unmigrated stream."""
    prompts = _prompts(seed=5)
    knobs = dict(temperature=0.9, top_k=5, seed=7)
    want = _unmigrated({}, prompts, **knobs)
    src, dst = _engine(), _engine()
    held = [src.submit(p, max_new_tokens=1, hold=True, **knobs)
            for p in prompts]
    while len(src.held) < 2:
        src.step()  # dlint: disable=DL104 — pulls its token ids
    got = []
    for req, p in zip(held, prompts):
        h = src.export_handoff(req)
        assert h["cursor"] == len(p) and h["tokens"] == req.tokens
        assert h["key"].tolist() == src._keys[req.slot].tolist()
        got.append(dst.import_handoff(h, p, max_new_tokens=N_NEW))
        src.release_held(req)
    assert src.idle() and sorted(src.free_slots) == [0, 1]
    dst.run_until_drained()
    assert [list(r.tokens) for r in got] == want


def test_terminal_sessions_retire_at_adoption_without_decoding():
    a = _engine()
    req = a.submit(_prompts()[0])
    _until_mid_decode(a, req)
    session = a.export_session(req)
    a.release_held(req)
    spent = dict(session, max_new_tokens=len(session["tokens"]))
    b = _engine()
    got = b.import_session(spent, _prompts()[0])
    assert got.state == "done" and got.tokens == session["tokens"]
    assert sorted(b.free_slots) == [0, 1] and b.idle()
    eosed = dict(session, eos_id=session["tokens"][-1])
    c = _engine()
    got = c.import_session(eosed, _prompts()[0])
    assert got.state == "done" and got.tokens == session["tokens"]
    assert sorted(c.free_slots) == [0, 1] and c.idle()


def test_export_session_refuses_held_prefill_park():
    eng = _engine()
    req = eng.submit(_prompts()[0], max_new_tokens=1, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    with pytest.raises(ValueError, match="export_handoff"):
        eng.export_session(req)
    eng.release_held(req)


def test_export_session_refuses_mid_prefill_slot():
    eng = _engine(prefill_chunk=2)
    req = eng.submit(_prompts()[1])
    eng.step()
    assert eng.prefilling
    with pytest.raises(ValueError, match="mid-prefill"):
        eng.export_session(req)
    eng.run_until_drained()


def test_export_session_refuses_non_decoding_requests():
    eng = _engine(n_slots=1)
    first = eng.submit(_prompts()[0])
    queued = eng.submit(_prompts()[1])
    _until_mid_decode(eng, first)
    with pytest.raises(ValueError, match="not actively decoding"):
        eng.export_session(queued)
    eng.run_until_drained()
    with pytest.raises(ValueError, match="not actively decoding"):
        eng.export_session(first)
    with pytest.raises(ValueError, match="is not held by this engine"):
        eng.export_handoff(first)


def test_import_session_refuses_budget_less_handoffs():
    eng = _engine()
    req = eng.submit(_prompts()[0], max_new_tokens=1, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    handoff = eng.export_handoff(req)
    dst = _engine()
    with pytest.raises(ValueError, match="max_new_tokens"):
        dst.import_session(handoff, _prompts()[0])
    with pytest.raises(ValueError, match="does not match the supplied"):
        dst.import_handoff(handoff, _prompts()[1])
    with pytest.raises(ValueError, match="no sampled token"):
        dst.import_handoff(dict(handoff, tokens=[]), _prompts()[0])
    eng.release_held(req)


def test_resume_session_continues_exactly_after_freeze():
    prompts = _prompts()
    want = _unmigrated({}, prompts)
    eng = _engine()
    r0, r1 = [eng.submit(p) for p in prompts]
    _until_mid_decode(eng, r0)
    eng.export_session(r0)
    n_frozen = len(r0.tokens)
    for _ in range(4):
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    assert len(r0.tokens) == n_frozen
    eng.resume_session(r0)
    eng.run_until_drained()
    assert [list(r0.tokens), list(r1.tokens)] == want


def test_resume_session_refuses_terminal_holds():
    eng = _engine()
    req = eng.submit(_prompts()[0], max_new_tokens=1, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    with pytest.raises(ValueError, match="terminal"):
        eng.resume_session(req)
    eng.abort_held(req)
    assert req.state == "aborted" and eng.report.aborted == 1
    with pytest.raises(ValueError, match="is not held by this engine"):
        eng.release_held(req)


def _filled_rows(kv_dtype, fill=6):
    """One slot prefilled on an engine of page mode ``kv_dtype``, its
    export and the engine."""
    eng = _engine(kv_dtype=kv_dtype)
    req = eng.submit(np.arange(fill) % VOCAB, max_new_tokens=1, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    return eng.export_handoff(req)["pages"], eng


@pytest.mark.parametrize("src,dst", [("f32", "f32"), ("int8-block",
                                                      "int8-block"),
                                     ("int8-block", "f32"),
                                     ("f32", "int8-block")])
def test_the_four_page_mode_crossings(src, dst):
    pages, _ = _filled_rows(src)
    fill = 6
    eng = _engine(kv_dtype=dst)
    eng.steps.import_slot(1, pages, fill)
    back = eng.steps.export_slot(1, fill)
    blk = tkv.page_block(eng.steps.model)
    assert eng.steps.cursors()[1] == fill
    for name, rows in pages.items():
        if src == dst:               # raw→raw bitwise; int8 verbatim
            for leaf, arr in rows.items():
                np.testing.assert_array_equal(back[name][leaf], arr)
        elif src == "int8-block":    # dequantized once
            for kv in ("k", "v"):
                want = tkv._dequant_rows(
                    torch.from_numpy(rows[kv + "_q"]),
                    torch.from_numpy(rows[kv + "_s"])).numpy()
                np.testing.assert_array_equal(back[name][kv], want)
        else:                        # quantized once
            for kv in ("k", "v"):
                q, s = tkv._quant_rows(torch.from_numpy(rows[kv]), blk)
                np.testing.assert_array_equal(back[name][kv + "_q"],
                                              q.numpy())
                np.testing.assert_array_equal(back[name][kv + "_s"],
                                              s.numpy())
    # the other slot is untouched
    assert eng.steps.cursors()[0] == 0


def test_bf16_pages_round_trip_bitwise():
    torch.manual_seed(1)
    tm = TransformerLM(**CFG, attention="reference", dtype=torch.bfloat16,
                       device="cpu")
    a = Engine(tm, _cfg(), device="cpu")
    req = a.submit(np.arange(7), max_new_tokens=1, hold=True)
    while not a.held:
        a.step()  # dlint: disable=DL104 — pulls its token ids
    pages = a.export_handoff(req)["pages"]
    assert pages["block_0"]["k"].dtype == np.float32
    b = Engine(tm, _cfg(), device="cpu")
    b.steps.import_slot(0, pages, 7)
    for name, page in a.steps.cache.items():
        for kv in ("k", "v"):
            assert torch.equal(b.steps.cache[name][kv][0, :7],
                               page[kv][req.slot, :7])


def test_import_slot_refusals_use_jaxs_texts():
    pages, eng = _filled_rows("f32")
    with pytest.raises(ValueError, match=r"slot 2 outside \[0, 2\)"):
        eng.steps.import_slot(2, pages, 6)
    with pytest.raises(ValueError, match=r"cursor 33 outside"):
        eng.steps.import_slot(0, pages, 33)
    with pytest.raises(ValueError, match="do not match this model's cache"):
        eng.steps.import_slot(0, {"block_9": pages["block_0"]}, 6)
    with pytest.raises(ValueError, match="handoff rows for block_0 have"):
        eng.steps.import_slot(0, pages, 5)
    with pytest.raises(ValueError, match="a wrapped slot cannot be"):
        eng.steps.export_slot(0, 40)
    with pytest.raises(RuntimeError, match="no free slot"):
        full = _engine(n_slots=1)
        full.submit(_prompts()[0])
        full.step()
        full.import_handoff({"weights_version": None}, _prompts()[0])


@pytest.mark.parametrize("requeue", [False, True])
def test_abort_all(requeue):
    eng = _engine(n_slots=1)
    reqs = [eng.submit(p) for p in _prompts()]
    _until_mid_decode(eng, reqs[0])
    hit = eng.abort_all(requeue=requeue)
    # requeue: the in-flight request goes back to the queue's head; the
    # queued one stays where it is
    assert hit == (reqs[:1] if requeue else reqs)
    assert sorted(eng.free_slots) == [0]
    if requeue:
        assert all(r.state == "queued" and r.tokens == [] for r in reqs)
        assert list(eng.queue) == reqs
        eng.run_until_drained()
        assert [list(r.tokens) for r in reqs] == _unmigrated(
            dict(n_slots=1), _prompts())
    else:
        assert all(r.state == "aborted" for r in reqs)
        assert eng.idle() and eng.report.aborted == 2


def test_swap_weights_refusal_skew_and_round_trip():
    _, _, tm = _setup()
    prompts = _prompts()
    eng = Engine(tm, _cfg(), device="cpu", weights_version="v1")
    req = eng.submit(prompts[0])
    with pytest.raises(RuntimeError, match="requires a drained engine"):
        eng.swap_weights(tm.state_dict(), "v2")
    eng.run_until_drained()
    before = list(req.tokens)
    torch.manual_seed(9)
    other = TransformerLM(**CFG, attention="reference", device="cpu")
    old, old_version = eng.swap_weights(other.state_dict(), "v2")
    assert old_version == "v1" and eng.weights_version == "v2"
    fresh = Engine(other, _cfg(), device="cpu")
    a, b = eng.submit(prompts[0]), fresh.submit(prompts[0])
    eng.run_until_drained()
    fresh.run_until_drained()
    assert a.tokens == b.tokens != before
    # a session minted under v2 is refused by a v1 engine
    src = Engine(other, _cfg(), device="cpu", weights_version="v2")
    r = src.submit(prompts[0])
    _until_mid_decode(src, r)
    v1 = Engine(tm, _cfg(), device="cpu", weights_version="v1")
    with pytest.raises(WeightsVersionSkew, match="'v2'.*'v1'"):
        v1.import_session(src.export_session(r), prompts[0])
    # the walk-back: the internal dict goes back in unconverted
    eng.swap_weights(old, old_version, converted=True)
    c = eng.submit(prompts[0])
    eng.run_until_drained()
    assert c.tokens == before and eng.weights_version == "v1"


def test_jax_handoff_pages_continue_jaxs_stream_on_the_port():
    """JAX's engine prefills under hold=True and exports; the port's
    engine adopts the numpy pages (the key is JAX's, so greedy only)
    and finishes the stream JAX's unmigrated engine produces."""
    jm, params, tm = _setup("flash")
    prompt = _prompts(seed=8)[1]
    jcfg = dict(n_slots=2, capacity=32, max_new_tokens=N_NEW,
                prefill_cohort=1, buckets=[8, 32])
    full = JaxEngine(jm, params, JaxEngineConfig(**jcfg))
    ref = full.submit(prompt)
    full.run_until_drained()
    src = JaxEngine(jm, params, JaxEngineConfig(**jcfg))
    req = src.submit(prompt, max_new_tokens=1, hold=True)
    while not src.held:
        src.step()  # dlint: disable=DL104 — pulls its token ids
    handoff = src.export_handoff(req)
    dst = Engine(tm, EngineConfig(**jcfg), device="cpu")
    got = dst.import_handoff(handoff, prompt, max_new_tokens=N_NEW)
    dst.run_until_drained()
    assert got.tokens == ref.tokens
