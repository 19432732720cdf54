"""The port's sequence parallelism (``chainermn_torch.parallel``:
``ring_attention``, ``ring_flash_attention``, ``ulysses_attention`` and
the sequence-parallel ``TransformerLM``) against the JAX package's.

One 4-rank gloo world (``run_world``) holds the sequence split over its
ranks (8 positions a rank of 32) and writes each rank's outputs and the
gradients of its q, k, v shards under the loss ``Σ out·cos(out)`` (the
sum over ranks is the global loss, so a rank's k/v gradients gather
every rank's contribution through the ring); ``ring_flash_attention``
runs the flash kernels' plain versions on these CPU tensors. JAX runs
the same functions under ``shard_map`` on 4 of the 8 CPU devices (its
ring-flash and Ulysses through the Pallas kernels in interpret mode) on
the same numpy-seeded inputs.

Tolerances: f32 forwards rtol 2e-4 / atol 2e-5 and gradients rtol 2e-3
/ atol 2e-4 (JAX's own ring tests against the oracle); the bf16
ring-flash at JAX's bf16 test tolerances (out rtol 5e-2, atol 2% of
the largest; gradients rtol 1e-1, atol 3% of the largest). The
sequence-parallel LM (2 layers, learned and rope positions, each rank
passing its first global position as ``pos_offset``): logits rtol 2e-4
/ atol 2e-5 against JAX's sequence-parallel model from the same flax
parameters.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.models.transformer import TransformerLM as JLM
from chainermn_tpu.parallel import (local_attention_reference as
                                    j_reference, ring_attention as j_ring,
                                    ring_flash_attention as j_ring_flash,
                                    ulysses_attention as j_ulysses)
from chainermn_torch.parallel import local_attention_reference
from tests.test_torch_mp import assert_ranks_ok, run_world

N, B, L, H, D = 4, 2, 32, 4, 8
FUNCS = {"ring": j_ring, "ring_flash": j_ring_flash, "ulysses": j_ulysses}
CASES = [(name, causal) for name in FUNCS for causal in (False, True)]
LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=L)
LM_CASES = [(impl, pos) for impl in FUNCS for pos in ("learned", "rope")]


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(3)]


def _tokens():
    return np.random.RandomState(5).randint(
        0, LM["vocab"], size=(B, L)).astype(np.int32)


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.parallel import (ring_attention, ring_flash_attention,
                                      ulysses_attention)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
FUNCS = {"ring": ring_attention, "ring_flash": ring_flash_attention,
         "ulysses": ulysses_attention}
ll = inp["qkv"][0].shape[1] // n
mine = slice(r * ll, (r + 1) * ll)
res = {}


def run(fn, causal, dtype):
    qkv = [torch.tensor(a[:, mine]).to(dtype).requires_grad_(True)
           for a in inp["qkv"]]
    out = fn(*qkv, comm, causal=causal)
    of = out.float()
    (of * torch.cos(of)).sum().backward()
    return (of.detach().numpy(), [t.grad.float().numpy() for t in qkv])


for name, causal in inp["cases"]:
    res[(name, causal)] = run(FUNCS[name], causal, torch.float32)
res["bf16"] = run(ring_flash_attention, True, torch.bfloat16)
# Ulysses refuses a head count the ranks do not divide
try:
    q = torch.zeros(1, ll, 2, 8)
    ulysses_attention(q, q, q, comm)
    res["indivisible"] = None
except ValueError as e:
    res["indivisible"] = str(e)
try:
    q = torch.zeros(1, ll, 4, 8)
    ring_flash_attention(q, q[:, :-1], q[:, :-1], comm)
    res["unequal"] = None
except ValueError as e:
    res["unequal"] = str(e)
toks = torch.tensor(inp["tokens"][:, mine]).long()
for (impl, pos), tree in inp["lm"].items():
    model = TransformerLM(**inp["cfg"], pos_emb=pos, attention=impl,
                          seq_axis="sp", comms={"sp": comm}, device="cpu")
    model.load_state_dict(params_from_flax(model, tree))
    with torch.no_grad():
        res[("lm", impl, pos)] = model(toks, pos_offset=r * ll).numpy()
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("sp",))


@pytest.fixture(scope="module")
def lm_params():
    x = jnp.asarray(_tokens())
    return {(impl, pos): jax.tree_util.tree_map(
        np.asarray, JLM(**LM, pos_emb=pos, attention="reference").init(
            jax.random.PRNGKey(1 + (pos == "rope")), x)["params"])
        for impl, pos in LM_CASES}


@pytest.fixture(scope="module")
def world(tmp_path_factory, lm_params):
    d = tmp_path_factory.mktemp("ring")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"qkv": _qkv(), "cases": CASES, "tokens": _tokens(),
                     "cfg": LM, "lm": lm_params}, f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


def _jax_run(mesh, fn, causal, cast=None):
    """JAX's function under shard_map: the global output and the
    gradients of Σ out·cos(out) in q, k, v."""
    spec = P(None, "sp")

    def loss(q, k, v):
        def f(q, k, v):
            if cast is not None:
                q, k, v = (t.astype(cast) for t in (q, k, v))
            return fn(q, k, v, axis_name="sp", causal=causal)

        out = shard_map(f, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=spec)(q, k, v).astype(jnp.float32)
        return jnp.sum(out * jnp.cos(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(a) for a in _qkv()))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _shard(a, r):
    ll = a.shape[1] // N
    return a[:, r * ll:(r + 1) * ll]


@pytest.mark.parametrize("name,causal", CASES,
                         ids=[f"{n}-{'causal' if c else 'full'}"
                              for n, c in CASES])
def test_sequence_parallel_attention_matches_jax(world, mesh, name, causal):
    out, grads = _jax_run(mesh, FUNCS[name], causal)
    for r, res in enumerate(world):
        got_out, got_grads = res[(name, causal)]
        np.testing.assert_allclose(got_out, _shard(out, r), rtol=2e-4,
                                   atol=2e-5)
        for got, want in zip(got_grads, grads):
            np.testing.assert_allclose(got, _shard(want, r), rtol=2e-3,
                                       atol=2e-4)


def test_ring_flash_bf16_matches_jax(world, mesh):
    out, grads = _jax_run(mesh, j_ring_flash, True, cast=jnp.bfloat16)
    for r, res in enumerate(world):
        got_out, got_grads = res["bf16"]
        want = _shard(out, r)
        np.testing.assert_allclose(got_out, want, rtol=5e-2,
                                   atol=0.02 * np.abs(out).max())
        for got, g in zip(got_grads, grads):
            np.testing.assert_allclose(got, _shard(g, r), rtol=1e-1,
                                       atol=0.03 * np.abs(g).max())


def test_refusals_carry_jaxs_texts(world, mesh):
    """Ulysses with heads the axis does not divide raises JAX's message
    (with the communicator's axis name); ring-flash refuses unequal
    shards, as JAX asserts."""
    q = jnp.zeros((1, 8 * N, 2, 8))
    with pytest.raises(ValueError) as err:
        shard_map(lambda q: j_ulysses(q, q, q, axis_name="r"),
                  mesh=Mesh(mesh.devices, ("r",)),
                  in_specs=P(None, "r"), out_specs=P(None, "r"))(q)
    for res in world:
        assert res["indivisible"] == str(err.value)
        assert "ring shards must be equal-sized" in res["unequal"]


def test_local_attention_reference_matches_jax():
    q, k, v = _qkv(2)
    for causal in (False, True):
        got = local_attention_reference(*(torch.tensor(a) for a in (q, k, v)),
                                        causal=causal)
        want = j_reference(*(jnp.asarray(a) for a in (q, k, v)),
                           causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("impl,pos", LM_CASES,
                         ids=[f"{i}-{p}" for i, p in LM_CASES])
def test_sequence_parallel_lm_matches_jax(world, mesh, lm_params, impl,
                                          pos):
    """The 2-layer LM with ``attention=impl`` and ``seq_axis``: each
    rank's logits equal JAX's sequence-parallel model's on its shard."""
    model = JLM(**LM, pos_emb=pos, attention=impl, seq_axis="sp")
    ll = L // N

    def f(params, toks):
        off = jax.lax.axis_index("sp") * ll
        return model.apply({"params": params}, toks, pos_offset=off)

    logits = np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(), P(None, "sp")),
        out_specs=P(None, "sp")))(lm_params[(impl, pos)],
                                  jnp.asarray(_tokens())))
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[("lm", impl, pos)],
                                   _shard(logits, r), rtol=2e-4, atol=2e-5)
