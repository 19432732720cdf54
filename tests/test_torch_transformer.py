"""Port parity: chainermn_torch's TransformerLM, parameter conversion,
KV-cache step functions and generate against the JAX package.

Both sides get the same parameters (the flax tree, converted with
``params_from_flax``) and the same numpy inputs. Sizes are small (2
layers, d_model 32, vocab 64). Tolerance: f32 at rtol = atol = 1e-4 (the
two frameworks sum in different orders); greedy tokens must be equal.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import (TransformerLM, compute_copy,
                                                generate)
from chainermn_torch.serving import kv_cache as tkv

TOL = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    "mha-learned": dict(pos_emb="learned"),
    "mha-rope": dict(pos_emb="rope"),
    "gqa-rope": dict(pos_emb="rope", n_kv_heads=2),
    "gqa-learned-window": dict(pos_emb="learned", n_kv_heads=2,
                               attention_window=5),
}


def _cfg(name, **over):
    cfg = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
               max_len=32, attention="flash", **CONFIGS[name])
    cfg.update(over)
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """(JAX model, numpy params, port model on the CPU) — one config."""
    cfg = _cfg(name)
    jm = JaxLM(**cfg)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _tokens(shape, seed=0, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _np_cache(cache):
    return {name: {leaf: np.asarray(x) for leaf, x in page.items()}
            for name, page in cache.items()}


def _torch_cache(np_cache):
    return {name: {leaf: torch.from_numpy(np.array(x)).to(
        torch.int64 if leaf == "idx" else torch.float32)
        for leaf, x in page.items()} for name, page in np_cache.items()}


def _assert_caches_close(tcache, jcache):
    for name, page in jcache.items():
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tcache[name][leaf].numpy(),
                                       np.asarray(page[leaf]), **TOL)
        np.testing.assert_array_equal(tcache[name]["idx"].numpy(),
                                      np.asarray(page["idx"]))


def _random_cache(jm, n_slots, capacity, cursors, seed=3):
    """A populated cache (random K/V, given cursors) as a numpy tree."""
    rng = np.random.RandomState(seed)
    tree = _np_cache(jkv.init_cache(jm, n_slots, capacity))
    for page in tree.values():
        page["k"] = rng.randn(*page["k"].shape).astype(np.float32)
        page["v"] = rng.randn(*page["v"].shape).astype(np.float32)
        page["idx"] = np.asarray(cursors, np.int32)
    return tree


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_flax_fills_every_parameter(name):
    jm, params, tm = _pair(name)
    sd = params_from_flax(tm, params)
    assert set(sd) == set(tm.state_dict())
    for key, value in tm.state_dict().items():
        assert tuple(sd[key].shape) == tuple(value.shape), key
    # kernel [in, out] → weight [out, in]
    k = params["block_0"]["attn_out"]["kernel"]
    np.testing.assert_array_equal(tm.blocks[0].attn_out.weight.detach(),
                                  k.T)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_forward_logits_match(name):
    jm, params, tm = _pair(name)
    toks = _tokens((2, 12))
    ref = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["mha-learned", "gqa-rope",
                                  "gqa-learned-window"])
def test_prefill_apply_matches(name):
    """Cohort prefill into pages, with a sentinel (dropped) row."""
    jm, params, tm = _pair(name)
    n_slots, cap = 3, 16
    toks = _tokens((3, 8), seed=1)
    lengths = np.array([8, 5, 1], np.int32)
    slot_ids = np.array([2, 0, n_slots], np.int32)   # last row: sentinel
    jcache = jkv.init_cache(jm, n_slots, cap)
    jl, jcache = jkv.prefill_apply(jm, params, jcache, jnp.asarray(toks),
                                   lengths, slot_ids)
    tcache = tkv.init_cache(tm, n_slots, cap)
    tl, tcache = tkv.prefill_apply(tm, tcache, torch.from_numpy(toks),
                                   lengths, slot_ids)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tcache, jcache)
    assert tcache["block_0"]["idx"].tolist() == [5, 0, 8]


@pytest.mark.parametrize("name", ["mha-learned", "gqa-rope",
                                  "gqa-learned-window"])
def test_prefill_chunk_apply_matches(name):
    """A chunk at each slot's cursor over a populated page: padding
    columns and the sentinel row drop."""
    jm, params, tm = _pair(name)
    n_slots, cap = 3, 16
    tree = _random_cache(jm, n_slots, cap, [4, 0, 7])
    toks = _tokens((3, 4), seed=2)
    starts = np.array([4, 0, 2], np.int32)
    valid = np.array([4, 2, 1], np.int32)
    slot_ids = np.array([0, 1, n_slots], np.int32)
    jl, jcache = jkv.prefill_chunk_apply(
        jm, params, jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(toks), starts, valid, slot_ids)
    tl, tcache = tkv.prefill_chunk_apply(tm, _torch_cache(tree),
                                         torch.from_numpy(toks), starts,
                                         valid, slot_ids)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_apply_matches_across_a_ring_wrap(name):
    """Per-slot cursors below, at and past the page end: the ring write
    position and the ring-inverted key mask must match."""
    jm, params, tm = _pair(name)
    n_slots, cap = 4, 8
    tree = _random_cache(jm, n_slots, cap, [3, 8, 13, 0])
    toks = _tokens((n_slots,), seed=4)
    jl, jcache = jkv.decode_apply(jm, params,
                                  jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(toks))
    tl, tcache = tkv.decode_apply(tm, _torch_cache(tree),
                                  torch.from_numpy(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("name", ["mha-rope", "gqa-learned-window"])
def test_decode_k_apply_matches(name):
    """k greedy steps with stop masks: a live slot, one that hits its
    budget, one that hits eos, a parked ride-along slot."""
    jm, params, tm = _pair(name)
    n_slots, cap, k = 4, 16, 3
    tree = _random_cache(jm, n_slots, cap, [5, 7, 2, 9])
    toks = _tokens((n_slots,), seed=5)
    temps = np.zeros(n_slots, np.float32)
    top_ks = np.zeros(n_slots, np.int32)
    remaining = np.array([3, 1, 3, 1], np.int32)
    live = np.array([True, True, True, False])
    park = np.array([0, 0, 0, 4], np.int32)
    # eos = the token slot 2 emits first, found from a JAX greedy step
    first, _ = jkv.decode_apply(jm, params,
                                jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(toks))
    eos = np.array([-1, -1, int(np.argmax(np.asarray(first)[2])), -1],
                   np.int32)
    jt, jlast, _, jcache = jkv.decode_k_apply(
        jm, params, jax.tree_util.tree_map(jnp.asarray, tree), toks,
        jnp.zeros((n_slots, 2), jnp.uint32), temps, top_ks, eos, remaining,
        live, park, k)
    tt, tlast, _, tcache = tkv.decode_k_apply(
        tm, _torch_cache(tree), torch.from_numpy(toks),
        torch.zeros(n_slots, 2, dtype=torch.int64), temps, top_ks, eos,
        remaining, live, park, k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt[3] == -1).all() and (tt[1, 1:] == -1).all()
    assert (tt[2, 1:] == -1).all()
    np.testing.assert_allclose(tlast[:3].detach().numpy(),
                               np.asarray(jlast)[:3], **TOL)
    _assert_caches_close(tcache, jcache)


@functools.lru_cache(maxsize=None)
def _jax_greedy(name):
    """JAX's greedy stream for one prompt (its cached and full-recompute
    paths are equal by the JAX package's own tests)."""
    jm, params, _ = _pair(name)
    prompt = _tokens((2, 5), seed=6)
    return prompt, np.asarray(jax_generate(jm, params, jnp.asarray(prompt),
                                           8))


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("name", ["mha-learned", "gqa-rope"])
def test_generate_greedy_tokens_equal(name, use_cache):
    _, _, tm = _pair(name)
    prompt, ref = _jax_greedy(name)
    out = generate(tm, torch.from_numpy(prompt), 8, use_cache=use_cache)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_eos_pads_like_jax():
    jm, params, tm = _pair("mha-rope")
    prompt = _tokens((2, 5), seed=7)
    free = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 6))
    eos = int(free[0, 7])
    ref = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 6,
                                  eos_id=eos, pad_id=63))
    out = generate(tm, torch.from_numpy(prompt), 6, eos_id=eos, pad_id=63)
    np.testing.assert_array_equal(out.numpy(), ref)


# ----- the numeric traps at the JAX/torch seam -----------------------------

def test_layernorm_epsilon_is_flax_default():
    """flax LayerNorm uses eps 1e-6 (torch's default 1e-5 would differ
    visibly on low-variance rows)."""
    x = (np.random.RandomState(8).randn(4, 32) * 1e-3).astype(np.float32)
    ref = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(32), "bias": jnp.zeros(32)}}, x))
    _, _, tm = _pair("mha-rope")
    ln = tm.blocks[0].ln_attn
    with torch.no_grad():
        ln.weight.fill_(1.0)
        ln.bias.zero_()
        out = F.layer_norm(torch.from_numpy(x), (32,), ln.weight, ln.bias,
                           ln.eps)
        torch_default = F.layer_norm(torch.from_numpy(x), (32,))
    tm.load_state_dict(params_from_flax(tm, _pair("mha-rope")[1]))
    assert ln.eps == 1e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)
    assert np.abs(torch_default.numpy() - ref).max() > 1e-2


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, ref, rtol=1e-6, atol=1e-6)
    assert np.abs(exact - ref).max() > 1e-4


def test_lm_head_runs_in_f32_in_a_bf16_model():
    """bf16 model: the head's weight and logits stay f32 in both
    frameworks; logits agree to bf16 drift (0.05) over 2 layers. Every
    parameter is f32 (flax's param_dtype); the serving copy stores the
    Dense and embedding weights in bf16, the head in f32."""
    cfg = _cfg("mha-rope")
    jm = JaxLM(**cfg, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, _pair("mha-rope")[1])
    tm = TransformerLM(**cfg, dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    twin = compute_copy(tm)
    assert twin.lm_head.weight.dtype == torch.float32
    assert twin.blocks[0].qkv.weight.dtype == torch.bfloat16
    assert twin.tok_emb.weight.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(twin(torch.from_numpy(_tokens((1, 10), seed=9))),
                           tm(torch.from_numpy(_tokens((1, 10), seed=9))))
    toks = _tokens((1, 10), seed=9)
    ref = jm.apply({"params": params}, toks)
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0.05,
                               atol=0.05)


def test_learned_positions_past_max_len_read_nan_like_jnp_take():
    """jnp.take's default fill mode: a cursor past max_len gives a NaN
    row (only idle slots get there); the other rows are untouched."""
    jm, params, tm = _pair("mha-learned")
    tree = _random_cache(jm, 2, 8, [3, 40])          # max_len is 32
    toks = _tokens((2,), seed=10)
    jl, _ = jkv.decode_apply(jm, params,
                             jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(toks))
    tl, _ = tkv.decode_apply(tm, _torch_cache(tree), torch.from_numpy(toks))
    jl, tl = np.asarray(jl), tl.detach().numpy()
    assert np.isnan(jl[1]).all() and np.isnan(tl[1]).all()
    np.testing.assert_allclose(tl[0], jl[0], **TOL)


def test_int32_token_ids_are_accepted():
    _, _, tm = _pair("mha-rope")
    toks = torch.from_numpy(_tokens((1, 6), seed=11))
    assert toks.dtype == torch.int32
    with torch.no_grad():
        a = tm(toks)
        b = tm(toks.long())
    assert torch.equal(a, b)
