"""The port's MNIST example (config #1) with its gradient reducers on 2
gloo ranks against the JAX reducers' steps (tolerances beside them).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chainermn_tpu
from chainermn_torch.training import classifier_loss
from tests.test_torch_mp import assert_ranks_ok, run_world


# The MNIST example's gradient reducers on 2 ranks against the JAX
# reducers. Each port rank quantizes its own gradient; in the JAX
# example's step autodiff sums the gradients before the reducer sees them
# (shard_map's replication typing), so its quantized reducer quantizes
# the mean on every rank. The reference below is therefore the JAX
# example's math with each rank holding its gradient: the JAX MLP's
# per-rank gradients on the batches the port's ranks took, put in the
# port's layout (its parameter order, torch's transposed weights: the
# blocks of a quantized bucket depend on both), reduced by the JAX reducer
# under ``shard_map`` on 2 CPU devices (with its residuals), then
# optax.adam(1e-3). The hierarchical reducer runs on a ("dcn", "ici") =
# (1, 2) mesh (JAX's axes mode; its groups mode needs
# ``psum(axis_index_groups=)``, which the CPU refuses), the port's on two
# ranks of one node (intra 2). Tolerance: losses at 1e-5 relative (the
# JAX and port gradients differ by f32 rounding, ~1e-7 relative, which
# moves an int8-block code only where a value sits on a rounding edge;
# measured on the CPU: 7.0e-7 hierarchical, 6.0e-7 int8-block).

_MNIST_REDUCER_WORKER = r'''
import os, pickle, sys
from chainermn_torch.examples import train_mnist

out, argv = sys.argv[1], sys.argv[2:]
with open(os.path.join(out, "params.pkl"), "rb") as f:
    sd = pickle.load(f)
trainer, model = train_mnist.build_trainer(train_mnist.parse_args(argv))
model.load_state_dict(sd)
up, seen = trainer.updater, []
step = up.step_fn


def recording(x, y):
    m = step(x, y)
    seen.append((x.numpy().copy(), y.numpy().copy(), float(m["main/loss"])))
    return m


up.step_fn = recording
trainer.run()
rank = up.comm.rank
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(seen, f)
up.comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def _jax_mnist_reducer_losses(params, batches, reducer_of):
    """``batches[step][rank] = (x, y)`` → the JAX steps' mean losses, the
    gradients reduced by ``reducer_of(jcomm)`` in the port's layout."""
    from chainermn_tpu.models import MLP as JaxMLP
    from chainermn_tpu.training.step import classifier_loss as jax_loss
    from chainermn_torch.models.convert import mlp_params_from_flax
    from tests.test_torch_reducers import _smap

    jm = JaxMLP(n_units=32, n_out=10)
    vg = jax.jit(jax.value_and_grad(
        lambda p, x, y: jax_loss(jm, p, x, y)[0]))
    jcomm, red = reducer_of()
    keys = list(mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))

    def to_port(tree):
        sd = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        return [sd[k].numpy() for k in keys]

    def to_flax(leaves):
        out = {}
        for i in range(3):
            w, b = leaves[2 * i], leaves[2 * i + 1]
            out[f"Dense_{i}"] = {"kernel": jnp.asarray(w.T),
                                 "bias": jnp.asarray(b)}
        return out

    assert keys == [f"l{i}.{k}" for i in (1, 2, 3)
                    for k in ("weight", "bias")]
    opt = optax.adam(1e-3)
    state = opt.init(params)
    rstate = jax.tree_util.tree_map(
        lambda t: np.zeros((2, *t.shape), t.dtype),
        red.init(to_port(params)))
    losses = []
    for per_rank in batches:
        vals, grads = zip(*(vg(params, x, y) for x, y in per_rank))
        stacked = [np.stack(a) for a in zip(*map(to_port, grads))]
        reduced, rstate = _smap(jcomm, lambda g, s: red.reduce(list(g), s),
                                stacked, rstate)
        g = to_flax([r[0] for r in reduced])
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(sum(vals) / len(vals)))
    return losses


@pytest.mark.parametrize("reducer", ["hierarchical", "int8-block"])
def test_mnist_grad_reducers_match_the_jax_steps(tmp_path, reducer):
    """``train_mnist --grad-reducer hierarchical`` and ``--grad-reducer
    quantized --wire-format int8-block`` (error feedback) in a 2-rank
    gloo world, MLP(32) from the JAX example's initial parameters, 256
    synthetic samples, per-rank batch 16 (8 steps): the losses (equal on
    both ranks) against the JAX steps on both ranks' batches with the
    JAX reducer (see the comment above)."""
    from chainermn_tpu.collectives import HierarchicalReducer as JHier
    from chainermn_tpu.collectives import QuantizedReducer as JQuant
    from chainermn_tpu.comm.xla import XlaCommunicator
    from chainermn_tpu.models import MLP as JaxMLP
    from chainermn_torch.models.convert import mlp_params_from_flax

    params = JaxMLP(n_units=32, n_out=10).init(
        jax.random.PRNGKey(0), np.zeros((2, 28, 28), np.float32))["params"]
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(mlp_params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)), f)
    flags = (["--grad-reducer", "hierarchical"] if reducer == "hierarchical"
             else ["--grad-reducer", "quantized", "--wire-format",
                   "int8-block"])
    argv = ["--device", "cpu", "--communicator", "naive", "--epoch", "1",
            "--unit", "32", "--n-train", "256", "--batchsize", "16",
            "--out", str(tmp_path), *flags]
    results = run_world(_MNIST_REDUCER_WORKER, 2, timeout=120,
                        args=[str(tmp_path), *argv])
    assert_ranks_ok(results)
    assert "B wire" in results[0][1]          # the ReductionReport rows
    ranks = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    assert [s[2] for s in ranks[0]] == [s[2] for s in ranks[1]]
    devs = np.array(jax.devices()[:2])

    def reducer_of():
        if reducer == "hierarchical":
            jc = XlaCommunicator(Mesh(devs.reshape(1, 2), ("dcn", "ici")))
            return jc, JHier(jc)
        jc = XlaCommunicator(Mesh(devs, ("r",)))
        return jc, JQuant(jc, mode="int8-block", ef=True)

    want = _jax_mnist_reducer_losses(
        params, [[(r[i][0], r[i][1]) for r in ranks]
                 for i in range(len(ranks[0]))], reducer_of)
    assert len(want) == 8
    np.testing.assert_allclose([s[2] for s in ranks[0]], want, rtol=1e-5)
