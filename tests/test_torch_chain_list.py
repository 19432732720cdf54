"""The port's ``MultiNodeChainList`` (config #5's model parallelism)
against the JAX package's and against the unsplit model.

Two graphs, in one 4-rank gloo world: config #5's linear chain (the
model-parallel example's ``Block``s, 12 → 16 → 16 → 16 → 10 over ranks 0-3)
and the JAX test's branching graph (rank 0 fans out to ranks 1 and 2, rank
3 joins them). Parameters come from the JAX chain's ``init`` (converted by
``dense_stage_params_from_flax``); every rank computes the loss Σ y·c of
the replicated output and runs backward on it. The outputs and every
stage's gradients are held to the JAX chain's (``jax.grad`` through
``shard_map`` on a 4-device mesh) and to the unsplit port model in one
process, so the owner of the output gets the loss's gradient once, not
once per rank.

Tolerance: 1e-5 absolute and relative (f32 products of width ≤ 16 in
another order; the split and unsplit port models agree to the bit).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import inspect
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.comm.xla import XlaCommunicator
from chainermn_tpu.links import MultiNodeChainList as JaxChainList
from chainermn_torch.links import MultiNodeChainList
from chainermn_torch.models.convert import dense_stage_params_from_flax
from tests.test_torch_mp import assert_ranks_ok, run_world

N = 4
TOL = 1e-5


# -- the JAX stages (the JAX chain-list test's Part and Join, the
# model-parallel example's Block) ------------------------------------------


class JPart(fnn.Module):
    feat: int

    @fnn.compact
    def __call__(self, x):
        return jnp.tanh(fnn.Dense(self.feat)(x))


class JJoin(fnn.Module):
    feat: int

    @fnn.compact
    def __call__(self, a, b):
        return fnn.Dense(self.feat)(jnp.concatenate([a, b], axis=-1))


class JBlock(fnn.Module):
    feat: int
    act: bool = True

    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(self.feat)(x.reshape((x.shape[0], -1)))
        return fnn.relu(x) if self.act else x


# -- the graphs: (stage kind, width in, width out, act, rank, in, out) -------

GRAPHS = {
    "linear": [("block", 12, 16, True, 0, None, 1),
               ("block", 16, 16, True, 1, 0, 2),
               ("block", 16, 16, True, 2, 1, 3),
               ("block", 16, 10, False, 3, 2, None)],
    "branching": [("part", 12, 8, True, 0, None, [1, 2]),
                  ("part", 8, 6, True, 1, 0, 3),
                  ("part", 8, 6, True, 2, 0, 3),
                  ("join", 12, 4, True, 3, [1, 2], None)],
}

# the port's stages, for the workers (which run their source) and the
# unsplit model


class Part(nn.Module):
    def __init__(self, n_in, feat):
        super().__init__()
        self.dense = nn.Linear(n_in, feat)

    def forward(self, x):
        return torch.tanh(self.dense(x))


class Join(nn.Module):
    def __init__(self, n_in, feat):
        super().__init__()
        self.dense = nn.Linear(n_in, feat)

    def forward(self, a, b):
        return self.dense(torch.cat([a, b], dim=-1))


class Block(nn.Module):
    def __init__(self, n_in, feat, act):
        super().__init__()
        self.dense = nn.Linear(n_in, feat)
        self.act = act

    def forward(self, x):
        x = self.dense(x.reshape(x.shape[0], -1))
        return F.relu(x) if self.act else x


def port_stage(kind, n_in, feat, act):
    if kind == "block":
        return Block(n_in, feat, act)
    return Part(n_in, feat) if kind == "part" else Join(n_in, feat)


_PORT_STAGES = "\n\n".join(inspect.getsource(o)
                            for o in (Part, Join, Block, port_stage))


def jax_stage(kind, n_in, feat, act):
    if kind == "block":
        return JBlock(feat, act)
    return JPart(feat) if kind == "part" else JJoin(feat)


def inputs(name):
    rs = np.random.RandomState(1)
    x = rs.randn(5, 4, 3).astype(np.float32)
    if name == "branching":
        x = x.reshape(5, 12)
    out = GRAPHS[name][-1][2]
    return x, rs.randn(5, out).astype(np.float32)


def jax_chain(name):
    comm = XlaCommunicator(Mesh(np.array(jax.devices()[:N]), ("r",)))
    chain = JaxChainList(comm)
    for kind, n_in, feat, act, rank, rin, rout in GRAPHS[name]:
        chain.add_link(jax_stage(kind, n_in, feat, act), rank=rank,
                       rank_in=rin, rank_out=rout)
    x, c = inputs(name)
    params = chain.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)

    def apply(params, x):
        return jax.jit(shard_map(lambda x: chain.apply(params, x),
                                 mesh=comm.mesh, in_specs=(P(),),
                                 out_specs=P()))(x)

    y = np.asarray(apply(params, jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.sum(apply(p, jnp.asarray(x)) * c))(
        params)
    return params, y, jax.tree_util.tree_map(np.asarray, grads)


def port_state(name, trees):
    """Each stage's flax tree (params or gradients) → the stage's state
    dict."""
    return [dense_stage_params_from_flax(
        port_stage(kind, n_in, feat, act), tree)
        for (kind, n_in, feat, act, *_), tree in zip(GRAPHS[name], trees)]


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
import torch.nn.functional as F
from torch import nn
from chainermn_torch.links import MultiNodeChainList
''' + _PORT_STAGES + r'''

out = sys.argv[1]
with open(os.path.join(out, "setup.pkl"), "rb") as f:
    setup = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
res = {}
for name, (graph, states, x, c) in setup.items():
    chain = MultiNodeChainList(comm)
    for i, (kind, n_in, feat, act, rank, rin, rout) in enumerate(graph):
        chain.add_link(port_stage(kind, n_in, feat, act), rank=rank,
                       rank_in=rin, rank_out=rout)
    chain.load_state_dict({f"stage{i}.{k}": v for i, sd in enumerate(states)
                           for k, v in sd.items()
                           if graph[i][4] == comm.rank})
    y = chain(torch.from_numpy(x))
    (y * torch.from_numpy(c)).sum().backward()
    res[name] = (y.detach().numpy(),
                 {k: p.grad.numpy() for k, p in chain.named_parameters()})
comm.barrier()
with open(os.path.join(out, f"rank{comm.rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{comm.rank} OK", flush=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX chains, and the port world's outputs and gradients."""
    out = tmp_path_factory.mktemp("chain")
    jax_runs, setup = {}, {}
    for name in GRAPHS:
        params, y, grads = jax_chain(name)
        jax_runs[name] = (params, y, grads)
        x, c = inputs(name)
        setup[name] = (GRAPHS[name], port_state(name, params), x, c)
    with open(out / "setup.pkl", "wb") as f:
        pickle.dump(setup, f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=120, args=[str(out)]))
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return jax_runs, ranks


def unsplit(name, states):
    """The port's stages in one process, in graph order: output and each
    stage's gradients of Σ y·c."""
    mods = []
    for (kind, n_in, feat, act, *_), sd in zip(GRAPHS[name], states):
        m = port_stage(kind, n_in, feat, act)
        m.load_state_dict(sd)
        mods.append(m)
    x, c = (torch.from_numpy(a) for a in inputs(name))
    if name == "linear":
        y = x
        for m in mods:
            y = m(y)
    else:
        h = mods[0](x)
        y = mods[3](mods[1](h), mods[2](h))
    (y * c).sum().backward()
    return y.detach().numpy(), [{k: p.grad.numpy()
                                 for k, p in m.named_parameters()}
                                for m in mods]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_output_reaches_every_rank_and_equals_the_jax_chains(runs, name):
    jax_runs, ranks = runs
    _, want, _ = jax_runs[name]
    for r in range(N):
        np.testing.assert_allclose(ranks[r][name][0], want, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_every_stage_gradient_equals_the_jax_chains(runs, name):
    jax_runs, ranks = runs
    _, _, grads = jax_runs[name]
    want = port_state(name, grads)
    for i, stage in enumerate(GRAPHS[name]):
        got = ranks[stage[4]][name][1]
        for k, v in want[i].items():
            np.testing.assert_allclose(got[f"stage{i}.{k}"], v.numpy(),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_outputs_and_gradients_equal_the_unsplit_model(runs, name):
    """Every rank runs backward on the same loss; the output's owner
    takes its gradient once (no N× gradient), the senders get theirs
    through the reverse transfers."""
    jax_runs, ranks = runs
    y, grads = unsplit(name, port_state(name, jax_runs[name][0]))
    for r in range(N):
        np.testing.assert_allclose(ranks[r][name][0], y, rtol=TOL, atol=TOL)
    for i, stage in enumerate(GRAPHS[name]):
        got = ranks[stage[4]][name][1]
        assert sorted(got) == sorted(
            f"stage{j}.{k}" for j, st in enumerate(GRAPHS[name])
            if st[4] == stage[4] for k in grads[j])
        for k, v in grads[i].items():
            np.testing.assert_allclose(got[f"stage{i}.{k}"], v, rtol=TOL,
                                       atol=TOL)


def _fake_comm(rank=0, size=N):
    """The chain list's view of a communicator before any message."""
    return SimpleNamespace(rank=rank, size=size, device=torch.device("cpu"))


def test_bad_wiring_raises_before_any_message():
    chain = MultiNodeChainList(_fake_comm())
    chain.add_link(Part(3, 4), rank=0, rank_in=None, rank_out=1)
    chain.add_link(Part(4, 4), rank=1, rank_in=2, rank_out=None)
    with pytest.raises(ValueError, match="expects input from rank 2"):
        chain(torch.zeros(2, 3))
    chain = MultiNodeChainList(_fake_comm())
    chain.add_link(Part(3, 4), rank=0, rank_in=None, rank_out=1)
    with pytest.raises(ValueError, match="no output stage"):
        chain(torch.zeros(2, 3))


def test_add_link_requires_rank_and_keeps_only_own_stages():
    chain = MultiNodeChainList(_fake_comm(rank=1),
                               replicated_param_budget_bytes=1)
    with pytest.raises(ValueError, match="rank"):
        chain.add_link(Part(3, 4))
    chain.add_link(Part(3, 4), rank=0, rank_out=1)
    chain.add_link(Part(4, 4), rank=1, rank_in=0)
    assert [n for n, _ in chain.named_parameters()] == [
        "stage1.dense.weight", "stage1.dense.bias"]
    # the pipeline lowerings: stage 0's module, not this rank's, is read
    # for its shapes only; this rank's row is stage 1's parameters
    for lower in (chain.to_hetero_pipeline, chain.to_branching_pipeline):
        pipe = lower(None, torch.zeros(2, 3))
        assert pipe.S == 2 and pipe.param_elems == 4 * 4 + 4
        own = dict(chain.named_parameters())
        np.testing.assert_array_equal(
            pipe.pack_params(1)[:4 * 4 + 4].numpy(), torch.cat(
                [own["stage1.dense.bias"],
                 own["stage1.dense.weight"].reshape(-1)]).detach().numpy())


def test_stages_of_other_ranks_keep_no_data():
    """A stage this rank does not own is kept as a meta copy for the
    lowerings' shapes: the caller's module is untouched and not held."""
    import gc
    import weakref

    chain = MultiNodeChainList(_fake_comm(rank=1))
    other = Part(3, 4)
    chain.add_link(other, rank=0, rank_out=1)
    chain.add_link(Part(4, 4), rank=1, rank_in=0)
    kept = chain._stages[0].shapes
    assert all(p.is_meta for p in kept.parameters())
    assert [tuple(p.shape) for p in kept.parameters()] == [
        tuple(p.shape) for p in other.parameters()]
    assert not any(p.is_meta for p in other.parameters())
    gone = weakref.ref(other)
    del other
    gc.collect()
    assert gone() is None


def test_one_rank_chain_runs_every_stage_locally():
    """A world of one owns every stage: edges stay in the process."""
    chain = MultiNodeChainList(_fake_comm(rank=0, size=1))
    torch.manual_seed(0)
    a, b = Part(3, 4), Part(4, 2)
    chain.add_link(a, rank=0, rank_out=0)
    chain.add_link(b, rank=0, rank_in=0)
    x = torch.randn(2, 3)
    chain_y = chain(x)
    torch.testing.assert_close(chain_y, b(a(x)), rtol=0, atol=0)
