"""The port's expert parallelism (``chainermn_torch.parallel``
``switch_dispatch``, ``topk_dispatch``, ``ExpertParallelMLP``; the MoE
``TransformerLM``; ``training.init_expert_parallel_state`` and
``make_expert_parallel_train_step``) against the JAX package's.

* Dispatch: ``switch_dispatch`` and ``topk_dispatch`` (k = 1, 2) on the
  same router probabilities, in and over capacity and with tied rows,
  give JAX's dispatch and combine tensors bit for bit (so the same
  (token, expert, slot) bookings: the queue positions), and its aux
  loss within 1e-6.
* One 4-rank gloo world (``run_world``; JAX under ``shard_map`` on 4 of
  the 8 CPU devices): ``ExpertParallelMLP`` (2 experts a rank) forward
  and the gradients of ``Σ_r (Σ y_r² + 0.01 aux_r)`` in x, the router and
  the expert tables against JAX's (rtol 2e-4 / atol 2e-5 out, rtol 2e-3
  / atol 2e-4 gradients: JAX's own MoE-vs-oracle test's); capacity
  overflow drops every token after an expert's first to zero, with aux
  1; and 3 steps of ``make_expert_parallel_train_step`` with Adam on the
  1-layer MoE LM against JAX's step from the same
  ``init_expert_parallel_state`` tree (losses rtol 2e-5, parameters rtol
  2e-4 / atol 5e-5: the FSDP step tests' bounds, from JAX's).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chainermn_tpu.comm.xla import XlaCommunicator
from chainermn_tpu.models.transformer import (TransformerLM as JLM,
                                               lm_loss_with_aux as j_loss)
from chainermn_tpu.parallel import ExpertParallelMLP as JMLP
from chainermn_tpu.parallel.expert_parallel import (
    switch_dispatch as j_switch, topk_dispatch as j_topk)
from chainermn_tpu.training.step import (
    init_expert_parallel_state as j_init,
    make_expert_parallel_train_step as j_make_step)
from chainermn_torch.parallel.expert_parallel import (switch_dispatch,
                                                      topk_dispatch)
from tests.test_torch_mp import assert_ranks_ok, run_world

N, EPD, D, HID, T_LOCAL = 4, 2, 6, 8, 8
LM = dict(vocab=13, d_model=16, n_heads=2, n_layers=1, d_ff=32,
          max_len=32, attention="reference", capacity_factor=4.0)
STEPS, LR, SEQ, PER = 3, 5e-3, 8, 2


def _probs(kind: str):
    rs = np.random.RandomState(3)
    if kind == "tied":
        p = np.full((16, 4), 0.25, np.float32)
        p[::3] = [0.4, 0.4, 0.1, 0.1]
        return p
    logits = rs.randn(64, 8).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))


DISPATCH = [(kind, cap, k) for kind in ("random", "tied")
            for cap in (3, 64) for k in (1, 2)]


@pytest.mark.parametrize("kind,capacity,k", DISPATCH,
                         ids=[f"{a}-c{b}-k{c}" for a, b, c in DISPATCH])
def test_dispatch_is_jaxs_bit_for_bit(kind, capacity, k):
    probs = _probs(kind)
    want = jax.jit(lambda p: j_topk(p, capacity, k))(jnp.asarray(probs))
    got = topk_dispatch(torch.tensor(probs), capacity, k)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the same bookings: each (token, expert) at the same queue slot
    assert (np.argwhere(got[0].numpy()).tolist()
            == np.argwhere(np.asarray(want[0])).tolist())
    np.testing.assert_allclose(got[2].item(), float(want[2]), atol=1e-6)
    if k == 1:
        sw = j_switch(jnp.asarray(probs), capacity)
        for g, w in zip(switch_dispatch(torch.tensor(probs), capacity),
                        sw):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0,
                                       rtol=0 if g.dim() else 1e-6)


def _make_params(rng):
    e_tot = N * EPD
    return dict(router=rng.randn(D, e_tot).astype(np.float32) * 0.5,
                w1=rng.randn(e_tot, D, HID).astype(np.float32) * 0.3,
                b1=rng.randn(e_tot, HID).astype(np.float32) * 0.1,
                w2=rng.randn(e_tot, HID, D).astype(np.float32) * 0.3,
                b2=rng.randn(e_tot, D).astype(np.float32) * 0.1)


def _lm_batches():
    rs = np.random.RandomState(7)
    toks = rs.randint(0, LM["vocab"], size=(STEPS, N * PER, SEQ + 1))
    return toks.astype(np.int32)


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import rank_params_from_flax
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux)
from chainermn_torch.parallel import ExpertParallelMLP
from chainermn_torch.training import (init_expert_parallel_state,
                                      make_expert_parallel_train_step)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
t = lambda a: torch.tensor(np.asarray(a))
res = {}


def mlp(p, epd, cf):
    m = ExpertParallelMLP(p["router"].shape[0], p["w1"].shape[-1], comm,
                          experts_per_device=epd, capacity_factor=cf,
                          device="cpu")
    mine = slice(r * epd, (r + 1) * epd)
    with torch.no_grad():
        m.router.weight.copy_(t(p["router"]).T)
        for k in ("w1", "b1", "w2", "b2"):
            getattr(m, k).copy_(t(p[k][mine]))
    return m


tl = inp["t_local"]
xs = t(inp["x"][r * tl:(r + 1) * tl]).requires_grad_(True)
m = mlp(inp["mlp"], inp["epd"], float(n * inp["epd"]))
y, aux = m(xs)
((y ** 2).sum() + 0.01 * aux).backward()
router = comm.allreduce(m.router.weight.grad)     # replicated: summed
res["mlp"] = (y.detach().numpy(), aux.item(), xs.grad.numpy(),
              router.numpy(), {k: getattr(m, k).grad.numpy()
                               for k in ("w1", "b1", "w2", "b2")})
# overflow: every token to expert 0, one slot each
p = dict(inp["mlp"], router=np.zeros_like(inp["mlp"]["router"][:, :n]),
         **{k: v[::inp["epd"]] for k, v in inp["mlp"].items()
            if k != "router"})
m = mlp(p, 1, 0.25 * n)
with torch.no_grad():
    y, aux = m(t(inp["x"][r * 4:(r + 1) * 4, :]))
res["overflow"] = (y.numpy(), aux.item())
# the expert-parallel step on the MoE LM
model = TransformerLM(**inp["lm_cfg"], moe_experts_per_device=inp["epd"],
                      expert_axis="r", comms={"r": comm}, device="cpu")
model.load_state_dict(rank_params_from_flax(model, inp["lm_tree"], r, n))
opt = torch.optim.Adam(model.parameters(), lr=inp["lr"], eps=1e-8)
step = make_expert_parallel_train_step(model, opt, comm,
                                       loss_fn=lm_loss_with_aux)
losses = []
per = inp["per"]
for toks in inp["batches"]:
    toks = t(toks[r * per:(r + 1) * per]).long()
    losses.append(float(step(toks[:, :-1], toks[:, 1:])["main/loss"]))
res["step"] = (losses, {k: v.numpy() for k, v in model.state_dict().items()})
# init_expert_parallel_state on models drawn differently on each rank
torch.manual_seed(100 + r)
model = TransformerLM(**inp["lm_cfg"], moe_experts_per_device=inp["epd"],
                      expert_axis="r", comms={"r": comm}, device="cpu")
specs = init_expert_parallel_state(model, comm, seed=0)
res["init"] = (specs, {k: v.numpy() for k, v in model.state_dict().items()})
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("r",))


def _mlp_apply(mesh, mlp, p, x, loss=False):
    """JAX's MLP under shard_map: (y, aux per rank) or, with ``loss``,
    Σ_r (Σ y_r² + 0.01 aux_r)."""
    def f(router, w1, b1, w2, b2, xs):
        y, aux = mlp.apply({"params": {"router": {"kernel": router},
                                       "w1": w1, "b1": b1, "w2": w2,
                                       "b2": b2}}, xs)
        if loss:
            return (jnp.sum(y ** 2) + 0.01 * aux)[None]
        return y, aux[None]

    out = shard_map(f, mesh=mesh,
                    in_specs=(P(),) + (P("r"),) * 5,
                    out_specs=P("r") if loss else (P("r"), P("r")),
                    check_vma=False)(p["router"], p["w1"], p["b1"],
                                     p["w2"], p["b2"], x)
    return jnp.sum(out) if loss else out


@pytest.fixture(scope="module")
def jax_side(mesh):
    rng = np.random.RandomState(0)
    p = _make_params(rng)
    x = rng.randn(N * T_LOCAL, D).astype(np.float32)
    mlp = JMLP(hidden=HID, experts_per_device=EPD, axis_name="r",
               capacity_factor=float(N * EPD))
    y, aux = jax.jit(lambda p, x: _mlp_apply(mesh, mlp, p, x))(p, x)
    grads = jax.jit(jax.grad(
        lambda p, x: _mlp_apply(mesh, mlp, p, x, loss=True),
        argnums=(0, 1)))(p, x)
    over = {k: (v[::EPD] if k != "router" else np.zeros((D, N), np.float32))
            for k, v in p.items()}
    omlp = JMLP(hidden=HID, experts_per_device=1, axis_name="r",
                capacity_factor=0.25)
    oy, oaux = jax.jit(lambda p, x: _mlp_apply(mesh, omlp, p, x))(
        over, x[:N * 4])
    # the expert-parallel step
    comm = XlaCommunicator(mesh)
    model = JLM(**LM, moe_experts_per_device=EPD, expert_axis="r")
    batches = _lm_batches()
    tx = optax.adam(LR)
    state, specs = j_init(model, comm, jax.random.PRNGKey(0),
                          batches[0][:1, :-1], tx)
    tree = jax.tree_util.tree_map(np.asarray, state[0])
    # the port's converter takes every leaf stacked over the ranks
    stacked = jax.tree_util.tree_map(
        lambda leaf, spec: leaf if spec == P("r")
        else np.concatenate([leaf] * N), tree, specs)
    step = j_make_step(model, tx, comm, specs, loss_fn=j_loss,
                       donate=False)
    dsh = NamedSharding(mesh, P("r"))
    losses = []
    for toks in batches:
        x_ = jax.device_put(jnp.asarray(toks[:, :-1]), dsh)
        y_ = jax.device_put(jnp.asarray(toks[:, 1:]), dsh)
        state, m = step(state, x_, y_)
        losses.append(float(m["main/loss"]))    # sync every step
    final = jax.tree_util.tree_map(np.asarray, state[0])
    return dict(inputs=dict(mlp=p, x=x, epd=EPD, t_local=T_LOCAL,
                            lm_cfg=LM, lm_tree=stacked, lr=LR,
                            batches=batches, per=PER),
                mlp=(np.asarray(y), np.asarray(aux),
                     jax.tree_util.tree_map(np.asarray, grads)),
                overflow=(np.asarray(oy), np.asarray(oaux)),
                step=(losses, final, specs))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    d = tmp_path_factory.mktemp("ep")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(jax_side["inputs"], f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


def test_expert_parallel_mlp_matches_jax(world, jax_side):
    y, aux, (gp, gx) = jax_side["mlp"]
    for r, res in enumerate(world):
        out, a, dx, drouter, dtables = res["mlp"]
        np.testing.assert_allclose(out, y[r * T_LOCAL:(r + 1) * T_LOCAL],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(a, aux[r], rtol=1e-6)
        np.testing.assert_allclose(dx, gx[r * T_LOCAL:(r + 1) * T_LOCAL],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(drouter, gp["router"].T, rtol=2e-3,
                                   atol=2e-4)
        for k, g in dtables.items():
            np.testing.assert_allclose(g, gp[k][r * EPD:(r + 1) * EPD],
                                       rtol=2e-3, atol=2e-4, err_msg=k)


def test_capacity_overflow_drops_to_zero(world, jax_side):
    """Uniform router logits send every token to expert 0; with one slot
    a rank only each rank's first token is kept (Switch), and aux is 1."""
    oy, oaux = jax_side["overflow"]
    for r, res in enumerate(world):
        y, aux = res["overflow"]
        assert np.abs(y[0]).max() > 0
        np.testing.assert_array_equal(y[1:], 0.0)
        np.testing.assert_allclose(y, oy[r * 4:(r + 1) * 4], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(aux, 1.0, rtol=1e-5)
        np.testing.assert_allclose(aux, oaux[r], rtol=1e-6)


def test_expert_parallel_step_matches_jax(world, jax_side):
    """3 Adam steps: the ranks' mean losses equal JAX's step's, every
    rank's shared leaves equal JAX's replicated ones, and its experts
    JAX's shard of the expert tables."""
    losses, final, specs = jax_side["step"]
    for r, res in enumerate(world):
        got_losses, sd = res["step"]
        np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
        for name, v in sd.items():
            want = _flax_leaf_of(name, final, specs, r)
            np.testing.assert_allclose(v, want, rtol=2e-4, atol=5e-5,
                                       err_msg=name)


def _flax_leaf_of(name, tree, specs, r):
    """The JAX leaf (rank r's shard of an expert table) for the port's
    parameter ``name``, in the port's layout."""
    parts = name.split(".")
    path = []
    for i, part in enumerate(parts):
        if part == "blocks":
            continue
        if i and parts[i - 1] == "blocks":
            path.append(f"block_{part}")
        else:
            path.append({"ln_attn": "LayerNorm_0", "ln_ffn": "LayerNorm_1",
                         "ln_f": "LayerNorm_0", "pos_embedding": "pos_emb",
                         "tok_emb": "tok_emb"}.get(part, part))
    leaf, spec = tree, specs
    last = path[-1]
    if last == "weight":
        owner = path[-2]
        path[-1] = ("scale" if owner.startswith("LayerNorm")
                    else "embedding" if owner == "tok_emb" else "kernel")
    for k in path:
        leaf, spec = leaf[k], spec[k]
    if spec == P("r"):
        per = leaf.shape[0] // N
        leaf = leaf[r * per:(r + 1) * per]
    return leaf.T if path[-1] == "kernel" else leaf


def test_init_gives_each_rank_its_experts_and_rank_0s_shared_leaves(world):
    """``init_expert_parallel_state``: the expert tables (``moe`` but not
    the router) are each rank's own draw; every other leaf, the router
    among them, is rank 0's."""
    specs, sd0 = world[0]["init"]
    own = sorted(k for k, e in specs.items() if e)
    assert own == [f"blocks.0.moe.{k}" for k in ("b1", "b2", "w1", "w2")]
    assert "blocks.0.moe.router.weight" in specs
    for res in world[1:]:
        assert res["init"][0] == specs
        sd = res["init"][1]
        for k, v in sd.items():
            if specs[k]:
                if k.endswith("w1") or k.endswith("w2"):
                    assert np.abs(v - sd0[k]).max() > 1e-3, k
            else:
                np.testing.assert_array_equal(v, sd0[k], err_msg=k)
