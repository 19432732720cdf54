"""The port's model-parallel examples (config #5) on the CPU:
``train_mnist_model_parallel`` against the JAX example's first steps on 2
and 4 ranks, and the eager send/recv example across two ranks
(tolerances beside them).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_torch.iterators import SerialIterator
from tests.test_torch_mp import assert_ranks_ok, run_world


# -- config #5: the model-parallel examples ---------------------------------
# The first losses of train_mnist_model_parallel against the JAX example's
# steps: the JAX MultiNodeChainList of Blocks (one stage per rank) under
# shard_map on the virtual CPU mesh, the same parameters (the JAX chain's
# init, converted stage by stage) and batches (synthetic_mnist and
# SerialIterator, seed 0), optax.adam(1e-3). Tolerance 1e-4 relative (f32
# products in other orders through 3 Adam steps).

MP_ARGS = ["--device", "cpu", "--unit", "16", "--n-train", "96",
           "--batchsize", "32", "--epoch", "1"]


class _JBlock:
    """The JAX example's Block (a flax module built on first use, so this
    file's import stays light)."""

    @staticmethod
    def make(feat, act):
        import flax.linen as fnn

        class Block(fnn.Module):
            feat: int
            act: bool = True

            @fnn.compact
            def __call__(self, x):
                x = fnn.Dense(self.feat)(x.reshape((x.shape[0], -1)))
                return fnn.relu(x) if self.act else x

        return Block(feat, act)


def _jax_model_parallel(n_stages):
    from jax import shard_map

    from chainermn_tpu.datasets.toy import synthetic_mnist
    from chainermn_tpu.iterators import SerialIterator as JIter
    from chainermn_tpu.links import MultiNodeChainList as JChain

    comm = chainermn_tpu.create_communicator("xla")
    chain = JChain(comm)
    for s in range(n_stages):
        last = s == n_stages - 1
        chain.add_link(_JBlock.make(10 if last else 16, not last), rank=s,
                       rank_in=None if s == 0 else s - 1,
                       rank_out=None if last else s + 1)
    train = synthetic_mnist(96, seed=0)
    x0 = np.stack([train[i][0] for i in range(2)])
    params = chain.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    start = jax.tree_util.tree_map(np.asarray, params)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    def loss_fn(params, x, y):
        logits = shard_map(lambda x: chain.apply(params, x), mesh=comm.mesh,
                           in_specs=(P(),), out_specs=P())(x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    vg = jax.jit(jax.value_and_grad(loss_fn))
    it = JIter(train, 32, shuffle=True, seed=0)
    losses = []
    for _ in range(3):
        batch = it.next()
        x = jnp.asarray(np.stack([b[0] for b in batch]))
        y = jnp.asarray(np.stack([b[1] for b in batch]))
        loss, g = vg(params, x, y)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return start, losses


_MP_WORKER = r'''
import os, pickle, sys
from chainermn_torch.examples import train_mnist_model_parallel as mp

out, argv = sys.argv[1], sys.argv[2:]
with open(os.path.join(out, "stages.pkl"), "rb") as f:
    stages = pickle.load(f)
comm, chain, opt, it = mp.build(mp.parse_args(argv))
chain.load_state_dict({f"stage{s}.{k}": v for s, sd in enumerate(stages)
                       if s == comm.rank for k, v in sd.items()})
losses, _ = mp.train(comm, chain, opt, it, 1)
if comm.rank == 0:
    with open(os.path.join(out, "losses.pkl"), "wb") as f:
        pickle.dump(losses, f)
print(f"RANK{comm.rank} OK", flush=True)
comm.finalize()
'''


@pytest.mark.parametrize("ranks", [2, 4])
def test_model_parallel_matches_the_jax_examples_steps(tmp_path, ranks):
    """``train_mnist_model_parallel`` in a gloo world of 2 and of 4 ranks
    (stages = min(--stages 4, ranks)), each rank one stage."""
    from chainermn_torch.examples import train_mnist_model_parallel as mp
    from chainermn_torch.models.convert import dense_stage_params_from_flax

    start, want = _jax_model_parallel(ranks)
    blocks = mp.stage_blocks(ranks, 16)
    with open(tmp_path / "stages.pkl", "wb") as f:
        pickle.dump([dense_stage_params_from_flax(b, p)
                     for b, p in zip(blocks, start)], f)
    assert_ranks_ok(run_world(_MP_WORKER, ranks, timeout=120,
                              args=[str(tmp_path), *MP_ARGS]))
    got = pickle.loads((tmp_path / "losses.pkl").read_bytes())
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


_EAGER_WORKER = r'''
import os
from chainermn_torch.examples import train_mnist_eager_p2p as ex

losses = ex.worker(ex.parse_args(["--device", "cpu", "--steps", "12"]))
rank = int(os.environ["RANK"])
if rank == 1:
    print("LOSSES", losses[0], losses[-1], flush=True)
print(f"RANK{rank} OK", flush=True)
'''


def test_eager_p2p_example_trains_across_two_ranks():
    """Rank 0's half learns only through the gradients rank 1's backward
    sends back; the loss falls."""
    results = run_world(_EAGER_WORKER, 2, timeout=120)
    assert_ranks_ok(results)
    line = [ln for ln in results[1][1].splitlines()
            if ln.startswith("LOSSES")][0]
    first, last = map(float, line.split()[1:])
    assert last < 0.5 * first
