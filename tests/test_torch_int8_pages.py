"""int8-block KV pages of the port against the JAX package's.

* The codes and scales of ``_quant_rows`` and ``repack_cache`` equal
  what JAX's COMPILED commit writes for the same f32 rows, bit for bit
  (``jax.jit`` folds ``amax / 127`` into a product with the f32
  reciprocal; the port computes that product).
* A dispatch requantizes only the columns it wrote: every other byte of
  the resident pages is unchanged across a decode.
* ``cache_bytes`` equals JAX's figure in both page modes.
* The decode-logit error of int8 pages stays within JAX's calibrated
  bound (10 × half the coarsest resident scale) against the port's own
  raw f32-page control driven by the same token stream, whose logits
  equal the full forward's (atol 1e-5: the port's cached and full
  forwards are not bitwise).

Small model (vocab 64, d 32, 2 layers, GQA); ``attention="reference"``
except in the one flash case.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import kv_cache as jkv
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving import kv_cache as tkv
from chainermn_torch.serving.engine import Engine, EngineConfig

CFG = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=48, max_len=64, pos_emb="rope", attention="reference")
BASE = dict(n_slots=3, capacity=32, max_new_tokens=6, prefill_cohort=2,
            buckets=[8, 16, 32])


@functools.lru_cache(maxsize=None)
def _models(attention="reference"):
    cfg = dict(CFG, attention=attention)
    jm = JaxLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return jm, params, tm


def _rows(seed, shape):
    """f32 rows with magnitudes spread over four decades and one
    all-zero block (its scale must be 1.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(1e-3, 10.0, shape[:-2] + (1, 1)).astype(np.float32)
    x.reshape(-1, shape[-2] * shape[-1])[0] = 0.0
    return x


def test_quant_rows_codes_and_scales_are_jaxs_jitted_bit_for_bit():
    _, _, tm = _models()
    blk = tkv.page_block(tm)
    assert blk == 16
    x = _rows(0, (6, 40, 2, 8))
    jq, js = jax.jit(jkv._quant_rows, static_argnums=1)(x, blk)
    tq, ts = tkv._quant_rows(torch.from_numpy(x), blk)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.numpy().reshape(-1)[0] == 1.0
    np.testing.assert_array_equal(
        tkv._dequant_rows(tq, ts).numpy(),
        np.asarray(jax.jit(jkv._dequant_rows)(jq, js)))


def test_repack_cache_writes_jaxs_bytes_and_only_the_window():
    """Resident pages + a new f32 view + per-slot windows (one wrapping
    the ring, one empty): JAX's jitted repack and the port's give the
    same codes, scales and cursors, and outside the windows the old
    bytes stay."""
    jm, _, tm = _models()
    n, cap = 3, 16
    old_j = jkv.init_cache(jm, n, cap, kv_dtype="int8-block")
    old_t = tkv.init_cache(tm, n, cap, kv_dtype="int8-block")
    blk = tkv.page_block(tm)
    rng = np.random.default_rng(1)
    new_j, new_t = {}, {}
    for i, name in enumerate(sorted(old_j)):
        resident = {}
        for kv in ("k", "v"):
            q, s = tkv._quant_rows(torch.from_numpy(
                _rows(10 + i, (n, cap, 2, 8))), blk)
            resident[kv + "_q"], resident[kv + "_s"] = q.numpy(), s.numpy()
        old_j[name] = {**{k: jnp.asarray(v) for k, v in resident.items()},
                       "idx": jnp.zeros((n,), jnp.int32)}
        for k, v in resident.items():
            old_t[name][k].copy_(torch.from_numpy(v))
        view = {kv: _rows(20 + i * 2 + j, (n, cap, 2, 8))
                for j, kv in enumerate(("k", "v"))}
        idx = rng.integers(0, cap, (n,))
        new_j[name] = {"k": view["k"], "v": view["v"],
                       "idx": jnp.asarray(idx, jnp.int32)}
        new_t[name] = {"k": torch.from_numpy(view["k"]),
                       "v": torch.from_numpy(view["v"]),
                       "idx": torch.from_numpy(idx)}
    start = np.array([3, 14, 7])      # slot 1's window wraps the ring
    count = np.array([4, 5, 0])       # slot 2 untouched
    before = {name: {k: v.clone() for k, v in page.items()}
              for name, page in old_t.items()}
    want = jax.jit(jkv.repack_cache)(old_j, new_j, start, count)
    got = tkv.repack_cache(old_t, new_t, torch.from_numpy(start),
                           torch.from_numpy(count), width=5)
    cols = np.arange(cap)[None]
    written = ((cols - start[:, None]) % cap) < count[:, None]
    for name in sorted(want):
        for leaf in ("k_q", "k_s", "v_q", "v_s"):
            np.testing.assert_array_equal(got[name][leaf].numpy(),
                                          np.asarray(want[name][leaf]))
            keep = ~written
            np.testing.assert_array_equal(
                got[name][leaf].numpy()[keep],
                before[name][leaf].numpy()[keep])
        np.testing.assert_array_equal(got[name]["idx"].numpy(),
                                      np.asarray(want[name]["idx"]))


@pytest.mark.parametrize("kv_dtype", [None, "int8-block"])
def test_cache_bytes_equal_jaxs_in_both_modes(kv_dtype):
    jm, _, tm = _models()
    assert (tkv.cache_bytes(tm, 8, 2048, kv_dtype=kv_dtype)
            == jkv.cache_bytes(jm, 8, 2048, kv_dtype=kv_dtype))
    eng = Engine(tm, EngineConfig(**BASE, kv_dtype=kv_dtype), device="cpu")
    assert eng.steps.cache_bytes() == jkv.cache_bytes(
        jm, 3, 32, kv_dtype=kv_dtype)
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.init_cache(tm, 1, 8, kv_dtype="int4")


def test_a_decode_changes_only_the_columns_it_wrote():
    _, _, tm = _models()
    eng = Engine(tm, EngineConfig(**BASE, decode_k=3,
                                  kv_dtype="int8-block"), device="cpu")
    rng = np.random.RandomState(0)
    for n in (5, 7):                  # one bucket: one prefill cohort
        eng.submit(rng.randint(0, 64, (n,)), max_new_tokens=12)
    eng.step()                        # prefill cohort + one decode_k
    fills = eng.steps.cursors().copy()
    before = {name: {k: v.clone() for k, v in page.items()}
              for name, page in eng.steps.cache.items()}
    eng.step()                        # one decode_k dispatch
    cap = BASE["capacity"]
    cols = np.arange(cap)[None]
    live = np.array([s in eng.active for s in range(3)])
    start = np.where(live, fills, 0)   # free slot 2 rides parked at 0
    written = ((cols - start[:, None]) % cap) < 3
    changed = np.zeros_like(written)
    for name, page in eng.steps.cache.items():
        for leaf in ("k_q", "k_s", "v_q", "v_s"):
            diff = (page[leaf] != before[name][leaf]).numpy()
            diff = diff.reshape(diff.shape[:2] + (-1,)).any(-1)
            assert not diff[~written].any(), (name, leaf)
            changed |= diff
    assert changed[0].any() and changed[1].any()
    np.testing.assert_array_equal(eng.steps.cursors()[:2], fills[:2] + 3)


def test_int8_submit_refuses_ring_wrap():
    _, _, tm = _models()
    eng = Engine(tm, EngineConfig(**BASE, kv_dtype="int8-block"),
                 device="cpu")
    with pytest.raises(ValueError, match="int8-block pages forbid ring"):
        eng.submit(np.arange(20), max_new_tokens=13)
    eng.submit(np.arange(20), max_new_tokens=12)


@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_int8_logit_error_within_the_calibrated_bound(attention):
    """One greedy token stream (off the raw control's logits) drives a
    raw f32-page step and an int8 step: the control equals the full
    forward, and the int8 logits stay within 10 × half the coarsest
    resident scale of it (JAX's bound)."""
    _, _, tm = _models(attention)
    b, lp, n_new = 2, 6, 5
    prompt = torch.as_tensor(np.random.RandomState(2).randint(0, 64,
                                                              (b, lp)))
    f32 = tkv.ServingStep(tm, b, 16, device="cpu")
    q8 = tkv.ServingStep(tm, b, 16, device="cpu", kv_dtype="int8-block")
    rows_f = [f32.prefill(prompt, [lp] * b, list(range(b)))]
    rows_q = [q8.prefill(prompt, [lp] * b, list(range(b)))]
    toks = prompt
    for _ in range(n_new):
        nxt = rows_f[-1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
        rows_f.append(f32.decode(nxt))
        rows_q.append(q8.decode(nxt))
    with torch.no_grad():
        full = tm(toks)
    for t, row in enumerate(rows_f):
        np.testing.assert_allclose(row.numpy(), full[:, lp - 1 + t].numpy(),
                                   atol=1e-5, rtol=0)
    max_step = 0.0
    for slot in range(b):
        pages = q8.export_slot(slot, int(q8.cursors()[slot]))
        for page in pages.values():
            for leaf in ("k_s", "v_s"):
                max_step = max(max_step, float(np.abs(page[leaf]).max()) / 2)
    worst = max(float((rq - rf).abs().max())
                for rf, rq in zip(rows_f, rows_q))
    assert 0 < worst <= 10 * max_step, (worst, max_step)
