"""Port parity: ``chainermn_torch/serving/sampling.py`` against
``jax.random`` and the JAX package's samplers, bit for bit.

Key rows, splits, random bits and uniforms must be EQUAL to JAX's. The
Gumbel noise passes through ``log`` twice, whose last bit may differ
between XLA and torch, so it is held within ``rtol 1e-6`` (plus ``atol
1e-6`` where it crosses 0); tokens must
be equal on every row whose top-2 margin of ``scaled + noise`` (read
from JAX's own values) exceeds ``1e-5``, and the test reports how many
rows that excludes. ``generate`` (cached and not) must emit JAX's
tokens; its LM head is scaled 4x, as in the serving parity tests.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.serving import sampling as jsamp
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM, generate
from chainermn_torch.serving import sampling as tsamp

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31, -1, -12345, 2 ** 32 + 5]
TINY = float(np.finfo(np.float32).tiny)
MARGIN = 1e-5


def _key(seed):
    """A fresh key pair for one check: JAX's and the port's."""
    return jax.random.PRNGKey(seed), tsamp.request_key(seed)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _split(seed, num):
    jk, tk = _key(seed)
    return _np(tsamp.split(tk, num)), np.asarray(jax.random.split(jk, num))


def _bits(seed, shape):
    jk, tk = _key(seed)
    return (_np(tsamp.random_bits(tk, shape)),
            np.asarray(jax.random.bits(jk, shape)))


def _uniform(seed, shape, **kw):
    jk, tk = _key(seed)
    return (_np(tsamp.uniform(tk, shape, **kw)),
            np.asarray(jax.random.uniform(jk, shape, **kw)))


def _gumbel(seed, shape):
    jk, tk = _key(seed)
    return (_np(tsamp.gumbel(tk, shape)),
            np.asarray(jax.random.gumbel(jk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_bits_and_uniforms_are_jaxs(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    for num in (2, 5):
        np.testing.assert_array_equal(*_split(seed, num))
    for shape in ((7,), (3, 33)):
        np.testing.assert_array_equal(*_bits(seed, shape))
    np.testing.assert_array_equal(*_uniform(seed, (257,)))
    np.testing.assert_array_equal(*_uniform(seed, (2, 300), minval=TINY))
    # the noise crosses 0, where a last-bit difference of the inner log
    # is large relative to the value: hold it within rtol 1e-6 plus an
    # absolute 1e-6 (the largest difference seen is 1.2e-7)
    np.testing.assert_allclose(*_gumbel(seed, (4, 500)), rtol=1e-6,
                               atol=1e-6)


def test_a_batch_of_key_rows_is_jaxs_vmap():
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    ja, jb = jsamp.split_keys(jkeys)
    ta, tb = tsamp.split_keys(tkeys)
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    np.testing.assert_array_equal(
        _np(tsamp.random_bits(tkeys, (40,))),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (40,)))(jkeys)))
    # the raw uint32 rows a JAX engine hands off go in as they are
    np.testing.assert_array_equal(
        _np(tsamp.split_keys(torch.as_tensor(
            np.asarray(jkeys).astype(np.int64)))[0]), np.asarray(ja))


@pytest.mark.parametrize("temp,top_k", [(1.0, 0), (0.8, 40), (2.0, 5),
                                        (0.3, 1), (0.0, 0)])
def test_sample_tokens_are_jaxs(temp, top_k):
    rng = np.random.RandomState(int(temp * 10) + top_k)
    n, v = 16, 512
    logits = (rng.randn(n, v) * 3).astype(np.float32)
    temps = np.full(n, temp, np.float32)
    temps[::5] = 0.0                       # greedy rows ride along
    topks = np.full(n, top_k, np.int64)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in range(100, 100 + n)])
    jt, jnew = jsamp.sample_tokens(jnp.asarray(logits), jkeys, temps,
                                   topks.astype(np.int32))
    tt, tnew = tsamp.sample_tokens(
        torch.from_numpy(logits),
        torch.from_numpy(np.asarray(jkeys).astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(topks))
    np.testing.assert_array_equal(_np(tnew), np.asarray(jnew))
    # JAX's own scaled + noise, for the margins (the same keys again)
    _, sub = jsamp.split_keys(jnp.stack(
        [jax.random.PRNGKey(s) for s in range(100, 100 + n)]))
    scaled = logits / np.maximum(temps, 1e-6)[:, None]
    if top_k > 0:
        kth = -np.sort(-scaled, axis=-1)[:, top_k - 1:top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    noisy = np.asarray(jax.vmap(lambda k, s: jax.random.gumbel(
        k, s.shape) + s)(sub, jnp.asarray(scaled)))
    top2 = -np.sort(-noisy, axis=-1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1] > MARGIN) | (temps <= 0)
    print(f"rows excluded as near-ties: {int((~clear).sum())} of {n}")
    assert clear.sum() >= n - 1
    np.testing.assert_array_equal(_np(tt)[clear], np.asarray(jt)[clear])


def test_greedy_rows_skip_the_noise_and_split_as_jax():
    """``noise=False`` (no kept row samples, known on the host through
    ``any_sampling``) draws no Gumbel noise: the tokens are JAX's greedy
    ones and the keys split as JAX's, one split a row."""
    rng = np.random.RandomState(7)
    n, v = 6, 300
    logits = (rng.randn(n, v) * 3).astype(np.float32)
    temps = np.zeros(n, np.float32)
    topks = np.zeros(n, np.int64)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in range(n)])
    jt, jnew = jsamp.sample_tokens(jnp.asarray(logits), jkeys, temps,
                                   topks.astype(np.int32))
    assert not tsamp.any_sampling(temps)
    tt, tnew = tsamp.sample_tokens(
        torch.from_numpy(logits),
        torch.from_numpy(np.asarray(jkeys).astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(topks), noise=False)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tnew), np.asarray(jnew))
    # a sampled row counts only where it is live; values left on a card
    # (here the meta device) are not read and count as sampling
    temps[2] = 0.8
    live = np.ones(n, bool)
    assert tsamp.any_sampling(temps, live)
    assert tsamp.any_sampling(torch.from_numpy(temps), torch.ones(n) > 0)
    live[2] = False
    assert not tsamp.any_sampling(temps, live)
    assert tsamp.any_sampling(torch.zeros(n, device="meta"))


CFG = dict(vocab=61, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=48, max_len=64, pos_emb="rope", attention="flash")


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


@pytest.mark.parametrize("use_cache,temp,top_k,seed", [
    (True, 1.0, None, 0), (True, 0.7, 8, 3), (True, 1.5, 20, 2 ** 31),
    (False, 0.7, 8, 3)], ids=["cached-t1", "cached-k8", "cached-k20",
                              "full-k8"])
def test_generate_samples_jaxs_tokens(use_cache, temp, top_k, seed):
    jm, params, tm = _models()
    prompt = np.random.RandomState(seed % 97).randint(
        0, CFG["vocab"], (3, 5)).astype(np.int32)
    want = jax_generate(jm, params, jnp.asarray(prompt), 8,
                        rng=jax.random.PRNGKey(seed), temperature=temp,
                        top_k=top_k, use_cache=use_cache)
    got = generate(tm, prompt, 8, rng=seed, temperature=temp, top_k=top_k,
                   use_cache=use_cache)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # a raw key row is the same stream as its seed
    again = generate(tm, prompt, 8, rng=np.asarray(jax.random.PRNGKey(seed)),
                     temperature=temp, top_k=top_k, use_cache=use_cache)
    assert torch.equal(got, again)
