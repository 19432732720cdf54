"""Port parity: head-sharded serving pages (``ServingStep(mesh=, axis=)``,
``Engine(mesh=, axis=)``) on 2- and 4-rank gloo worlds, against the
port's one-rank step and JAX's ``ServingStep(mesh=, axis=)``.

A small LM (vocab 61, d 32, 4 heads, 2 layers, RoPE, flash) with
``n_kv_heads`` 4 and 2: on 2 ranks both split the pages by KV head; on 4
ranks 4 splits (one head a rank) and 2 stays whole on every rank (JAX's
``P()`` fallback). On every rank:

* the sharded step's prefill and decode logits are BITWISE the one-rank
  step's, as JAX's test holds its sharded step to its unsharded one
  (``tests/serving_tests/test_kv_cache.py::test_explicit_mesh_shardings``);
  the projections run whole and are sliced, so no GEMM changes shape;
* ``cache_bytes()`` is the one-rank step's over N where the pages split;
* a sharded Engine, given the same requests on every rank, emits the
  one-rank Engine's greedy streams; a held request's handoff, exported
  from the sharded engine (its rows gathered into the one-rank format),
  continues on a one-rank engine to the unmigrated stream;
* ``kv_dtype="int8-block"`` with a mesh is refused with JAX's text.

The logits are then held against JAX's sharded step on the CPU mesh
(N devices), fed the same converted parameters, at rtol/atol 1e-5 (the
f32 disagreement of the two frameworks).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving.kv_cache import ServingStep as JaxStep
from tests.test_torch_mp import assert_ranks_ok, run_world

CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=48,
           max_len=64, pos_emb="rope", attention="flash")
SLOTS, CAP, DECODES = 2, 32, 3
LENS = [5, 3]

_WORKER = r'''
import json, os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import ServingStep

d = sys.argv[1]
with open(os.path.join(d, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
res = {}
for hkv, params in inp["params"].items():
    model = TransformerLM(**inp["cfg"], n_kv_heads=hkv, device="cpu")
    model.load_state_dict(params_from_flax(model, params))
    one = ServingStep(model, inp["slots"], inp["cap"], device="cpu")
    sh = ServingStep(model, inp["slots"], inp["cap"], device="cpu",
                     mesh=comm, axis=comm.axis_names[0])
    split = hkv % n == 0
    assert (sh.heads is not None) == split, (hkv, n)
    assert sh.cache_bytes() * (n if split else 1) == one.cache_bytes()
    page = sh.cache["block_0"]["k"]
    assert page.shape[2] == (hkv // n if split else hkv), page.shape
    prompt = inp["prompt"]
    a = one.prefill(prompt, inp["lens"], [0, 1])
    b = sh.prefill(prompt, inp["lens"], [0, 1])
    assert torch.equal(a, b), (hkv, (a - b).abs().max())
    logits = [b.numpy()]
    tok = a.argmax(-1)
    for _ in range(inp["decodes"]):
        da, db = one.decode(tok), sh.decode(tok)
        assert torch.equal(da, db), (hkv, (da - db).abs().max())
        logits.append(db.numpy())
        tok = da.argmax(-1)
    res[hkv] = {"logits": logits, "split": split,
                "bytes": [sh.cache_bytes(), one.cache_bytes()]}

    # the engines: the same requests on every rank, greedy
    cfg = EngineConfig(n_slots=2, capacity=inp["cap"], max_new_tokens=6,
                       prefill_cohort=2, decode_k=2, buckets=[8, 32])
    prompts = [np.asarray(p, np.int32) for p in inp["prompts"]]
    ref = Engine(model, cfg, device="cpu")
    want = [ref.submit(p) for p in prompts]
    ref.run_until_drained()
    eng = Engine(model, cfg, device="cpu", mesh=comm)
    got = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    assert [q.tokens for q in got] == [q.tokens for q in want]
    # a held prefill handed off from the sharded engine to a one-rank one
    held = eng.submit(prompts[0], max_new_tokens=1, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — pulls its token ids
    handoff = eng.export_handoff(held)
    assert handoff["pages"]["block_0"]["k"].shape[1] == hkv
    dst = Engine(model, cfg, device="cpu")
    cont = dst.import_handoff(handoff, prompts[0], max_new_tokens=6)
    dst.run_until_drained()
    assert cont.tokens == want[0].tokens, (cont.tokens, want[0].tokens)
    res[hkv]["streams"] = [q.tokens for q in got]
try:
    ServingStep(model, 2, 16, device="cpu", kv_dtype="int8-block",
                mesh=comm)
except ValueError as e:
    assert "does not compose with mesh-sharded pages" in str(e)
else:
    raise AssertionError("int8-block pages under a mesh were served")
with open(os.path.join(d, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, CFG["vocab"], (SLOTS, max(LENS))).astype(
        np.int32)
    prompts = [rng.randint(0, CFG["vocab"], (k,)).tolist()
               for k in (7, 4, 12)]
    params = {}
    for hkv in (4, 2):
        jm = JaxLM(**CFG, n_kv_heads=hkv)
        p = jm.init(jax.random.PRNGKey(hkv), jnp.asarray(prompt))["params"]
        p = jax.tree_util.tree_map(np.asarray, p)
        # a 4x head keeps greedy margins above the frameworks' f32
        # disagreement, as in the serving parity tests
        p["lm_head"]["kernel"] = p["lm_head"]["kernel"] * 4.0
        params[hkv] = p
    return dict(cfg=CFG, params=params, prompt=prompt, lens=LENS,
                slots=SLOTS, cap=CAP, decodes=DECODES, prompts=prompts)


def _jax_logits(hkv, n):
    """JAX's sharded step on an ``n``-device CPU mesh: prefill and the
    greedy decodes the port's worker runs."""
    inp = _inputs()
    jm = JaxLM(**CFG, n_kv_heads=hkv)
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    step = JaxStep(jm, inp["params"][hkv], SLOTS, CAP, mesh=mesh,
                   axis="model")
    out = [np.asarray(step.prefill(inp["prompt"], LENS, [0, 1]))]
    tok = jnp.argmax(out[0], -1).astype(jnp.int32)
    for _ in range(DECODES):
        # the logits oracle — full rows on purpose
        out.append(np.asarray(step.decode(tok)))  # dlint: disable=DL110
        tok = jnp.argmax(out[-1], -1).astype(jnp.int32)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pages_are_the_one_rank_step_and_jaxs(n, tmp_path):
    inp = _inputs()
    with open(os.path.join(tmp_path, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    assert_ranks_ok(run_world(_WORKER, n, timeout=240,
                              args=[str(tmp_path)]))
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for hkv in (4, 2):
        assert ranks[0][hkv]["split"] == (hkv % n == 0)
        sharded, whole = ranks[0][hkv]["bytes"]
        assert sharded == (whole // n if hkv % n == 0 else whole)
        # every rank emits the same logits and streams
        for res in ranks[1:]:
            for a, b in zip(res[hkv]["logits"], ranks[0][hkv]["logits"]):
                np.testing.assert_array_equal(a, b)
            assert res[hkv]["streams"] == ranks[0][hkv]["streams"]
        want = _jax_logits(hkv, n)
        for got, ref in zip(ranks[0][hkv]["logits"], want):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    print(json.dumps({hkv: ranks[0][hkv]["bytes"] for hkv in (4, 2)}))
