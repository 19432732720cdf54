"""The port's ``MultiNodeBatchNormalization`` against the JAX link (flax
``BatchNorm``) and, in a 2-rank gloo world, against batch norm over the
concatenated batch (the JAX package's own oracle,
``tests/links_tests/test_multi_node_batch_normalization.py``).

Both sides get the same seeded numpy input, NHWC for flax and NCHW for
the port. Tolerances: f32 outputs, gradients and running statistics at
rtol 1e-5 / atol 1e-5 (f32 sums in another order). bf16 (``dtype=bf16``,
statistics in f32 on both sides): outputs and input gradients are bf16,
so they are held to one bf16 rounding of the largest values, rtol 1e-2
and atol 2e-2 (2^-7 of values up to ~3); the scale and bias gradients
and the running statistics are f32 sums of bf16 terms, rtol 1e-3 and
atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.links import \
    MultiNodeBatchNormalization as JaxMNBN
from chainermn_torch.links import (MultiNodeBatchNormalization,
                                   batch_norm_layers, frozen_batch_stats)
from tests.test_torch_mp import assert_ranks_ok, run_world

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=2e-2)}
TOL_STATS = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=1e-3, atol=1e-3)}
EPS = 2e-5


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    # an offset and a per-channel scale, so the mean and the variance both
    # matter
    c = shape[-1]
    x = rs.randn(*shape) * rs.uniform(0.5, 2.0, c) + rs.randn(c)
    return x.astype(np.float32), rs.randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _jax_run(dtype, x, w, scale, bias, steps):
    """``steps`` train-mode applications of the JAX link (stats carried),
    then the gradients of sum(y * w) at the last one, and an eval-mode
    output."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    link = JaxMNBN(comm=None, eps=EPS, dtype=jdt)
    v = link.init(jax.random.PRNGKey(0), x[:1], use_running_average=False)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = v["batch_stats"]

    def loss(p, xx, stats):
        y, new = link.apply({"params": {"BatchNorm_0": p},
                             "batch_stats": stats}, xx.astype(jdt),
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, new["batch_stats"])

    for _ in range(steps):
        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x),
                                                stats)
    y_eval = link.apply({"params": {"BatchNorm_0": params},
                         "batch_stats": stats}, jnp.asarray(x).astype(jdt),
                        use_running_average=True)
    return dict(y=np.asarray(y.astype(jnp.float32)),
                gx=np.asarray(gx, np.float32),
                gscale=np.asarray(gp["scale"]), gbias=np.asarray(gp["bias"]),
                mean=np.asarray(stats["BatchNorm_0"]["mean"]),
                var=np.asarray(stats["BatchNorm_0"]["var"]),
                y_eval=np.asarray(y_eval.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 5, 7, 4), (10, 3)])
def test_train_and_eval_match_the_jax_link(dtype, shape):
    """Two train-mode steps (running statistics carried), the output and
    the input, scale and bias gradients of sum(y * w) at the second,
    then eval mode with the running statistics: each against the JAX link
    (flax BatchNorm, decay 0.9, eps 2e-5) on the same input."""
    x, w = _inputs(shape, seed=len(shape))
    rs = np.random.RandomState(7)
    c = shape[-1]
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    want = _jax_run(dtype, x, w, scale, bias, steps=2)

    tdt = getattr(torch, dtype)
    bn = MultiNodeBatchNormalization(size=c, eps=EPS, dtype=tdt,
                                     device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    for _ in range(2):
        xt = _nchw(x).to(tdt).requires_grad_()
        bn.zero_grad()
        y = bn(xt, use_running_average=False)
        (y.float() * _nchw(w)).sum().backward()
    assert y.dtype == tdt
    tol, tol_s = TOL[dtype], TOL_STATS[dtype]
    np.testing.assert_allclose(_nhwc(y), want["y"], **tol)
    np.testing.assert_allclose(_nhwc(xt.grad), want["gx"], **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), want["gscale"],
                               **tol_s)
    np.testing.assert_allclose(bn.bias.grad.numpy(), want["gbias"], **tol_s)
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                               **tol_s)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"], **tol_s)
    y_eval = bn.eval()(_nchw(x).to(tdt))
    np.testing.assert_allclose(_nhwc(y_eval), want["y_eval"], **tol)


def test_running_variance_is_the_biased_batch_variance():
    """One step from the initial statistics (0, 1): running_var = 0.9 +
    0.1 * var(x) with the biased variance (ddof 0), where torch's
    BatchNorm2d would take the unbiased one; exactly the formula's f32
    values up to rounding (1e-6)."""
    x, _ = _inputs((3, 2, 2, 5), seed=3)
    bn = MultiNodeBatchNormalization(size=5, device="cpu").train()
    bn(_nchw(x))
    var = x.reshape(-1, 5).astype(np.float64).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-6, atol=1e-6)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 5).var(0, ddof=1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, rtol=1e-3)


def test_mode_defaults_frozen_stats_and_refusals():
    """Without an explicit mode the module follows ``training``; a frozen
    forward (a checkpoint's recomputation) leaves the running statistics
    as they are and restores the switch; a wrong channel count and a
    missing size are refused."""
    x, _ = _inputs((4, 3, 3, 2), seed=5)
    bn = MultiNodeBatchNormalization(size=2, device="cpu")
    net = torch.nn.Sequential(bn)
    assert batch_norm_layers(net) == [bn]
    bn.eval()(_nchw(x))
    assert torch.equal(bn.running_mean, torch.zeros(2))
    bn.train()
    with frozen_batch_stats(net):
        y_frozen = bn(_nchw(x))
    assert torch.equal(bn.running_mean, torch.zeros(2)) and bn.update_stats
    y = bn(_nchw(x))
    assert torch.equal(y, y_frozen)
    assert not torch.equal(bn.running_mean, torch.zeros(2))
    with pytest.raises(ValueError, match="channels"):
        bn(torch.zeros(2, 3, 1, 1))
    with pytest.raises(ValueError, match="size"):
        MultiNodeBatchNormalization(device="cpu")


_MNBN_WORKER = r'''
import os, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.links import MultiNodeBatchNormalization

rank = int(os.environ["RANK"])
data = np.load(sys.argv[1])
comm = create_communicator("pure_nccl", device="cpu")
n = data["x"].shape[0] // comm.size
rows = slice(rank * n, (rank + 1) * n)
c = data["x"].shape[-1]
bn = MultiNodeBatchNormalization(comm, size=c, eps=2e-5, device="cpu")
with torch.no_grad():
    bn.weight.copy_(torch.from_numpy(data["scale"]))
    bn.bias.copy_(torch.from_numpy(data["bias"]))
nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
nhwc = lambda t: np.moveaxis(t.detach().numpy(), 1, -1)
for _ in range(2):
    x = nchw(data["x"][rows]).requires_grad_()
    bn.zero_grad()
    y = bn(x, use_running_average=False)
    # each rank's part of sum(y * w) over the concatenated batch
    (y * nchw(data["w"][rows])).sum().backward()
tol = dict(rtol=1e-5, atol=1e-5)
np.testing.assert_allclose(nhwc(y), data["y"][rows], **tol)
np.testing.assert_allclose(nhwc(x.grad), data["gx"][rows], **tol)
g = [bn.weight.grad, bn.bias.grad]
comm.allreduce_grad(g, "sum")
np.testing.assert_allclose(g[0].numpy(), data["gscale"], **tol)
np.testing.assert_allclose(g[1].numpy(), data["gbias"], **tol)
np.testing.assert_allclose(bn.running_mean.numpy(), data["mean"], **tol)
np.testing.assert_allclose(bn.running_var.numpy(), data["var"], **tol)
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_two_ranks_match_batch_norm_over_the_concatenated_batch(tmp_path):
    """``MultiNodeBatchNormalization(comm)`` in a 2-rank gloo world, each
    rank with half of a [8, 3, 5, 4] batch, two train steps: each rank's
    output and input gradient equal the rows of flax BatchNorm over the
    whole batch (the JAX package's oracle), the scale and bias gradients
    summed over the ranks equal the whole batch's, and the running
    statistics are the whole batch's on both ranks (f32, 1e-5)."""
    x, w = _inputs((8, 3, 5, 4), seed=11)
    rs = np.random.RandomState(12)
    scale = rs.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rs.randn(4).astype(np.float32)
    want = _jax_run("float32", x, w, scale, bias, steps=2)
    path = tmp_path / "bn.npz"
    np.savez(path, x=x, w=w, scale=scale, bias=bias, **want)
    assert_ranks_ok(run_world(_MNBN_WORKER, 2, timeout=120,
                              args=[str(path)]))
