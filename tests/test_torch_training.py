"""Port parity: chainermn_torch's training path (communicator, multi-node
optimizer, data-parallel train step, f32 parameters, bhld loading)
against the JAX package.

Both sides get the same flax parameters (converted with
``params_from_flax``) and the same seeded numpy batches; the LM is small
(2 layers, d_model 32, vocab 256, L 32). Tolerances are stated per test:
f32 losses at 1e-4 and parameters at 1e-5 absolute unless a reason is
given. The 2-rank tests run a real gloo world of two processes
(``run_world`` in ``tests/test_torch_mp.py``).
"""

import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.comm.xla import plan_buckets as jax_plan_buckets
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import \
    lm_loss_with_aux as jax_lm_loss
from chainermn_tpu.models.resnet import CifarResNet as JaxCifarResNet
from chainermn_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from chainermn_tpu.training.step import \
    classifier_loss as jax_classifier_loss
from chainermn_tpu.training.step import \
    make_data_parallel_train_step as jax_make_step
from chainermn_tpu.training.step import make_eval_step as jax_make_eval_step
from chainermn_torch.comm import create_communicator, plan_buckets
from chainermn_torch.extensions import (AllreducePersistent,
                                        allreduce_persistent)
from chainermn_torch.links import batch_norm_layers
from chainermn_torch.models.convert import (params_from_flax,
                                            resnet_params_from_flax)
from chainermn_torch.models.resnet import CifarResNet
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux)
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import (classifier_loss,
                                      make_data_parallel_train_step,
                                      make_eval_step)
from tests.test_torch_mp import assert_ranks_ok, run_world
from tests.test_torch_resnet import _randomised

TOL_LOSS = dict(rtol=1e-4, atol=1e-4)
# parameters after a few AdamW steps: the two frameworks' gradients agree
# to f32 summation order, and Adam's normalised update (about lr per
# element) carries that relative error, so 1e-5 absolute is far inside
# the lr-sized steps being compared
TOL_PARAMS = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3
CFG = dict(vocab=256, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32,
           pos_emb="rope")


@pytest.fixture(scope="module")
def comm():
    """A size-1 gloo communicator of this process."""
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


@functools.lru_cache(maxsize=None)
def _flax_params(dtype=jnp.float32, seed=0, **over):
    jm = JaxLM(**dict(CFG, **over), attention="reference", dtype=dtype)
    return jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"])


def _port_model(params, dtype=torch.float32, **over):
    tm = TransformerLM(**dict(CFG, **over), dtype=dtype, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return tm


def _batches(n, b=16, seed=0):
    """n seeded (x, y) next-token batches [b, L]."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, CFG["vocab"], size=(n, b, CFG["max_len"] + 1))
    toks = toks.astype(np.int32)
    return toks[:, :, :-1], toks[:, :, 1:]


def _assert_params_close(tm, flax_params, **tol):
    want = params_from_flax(tm, jax.tree_util.tree_map(np.asarray,
                                                       flax_params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name,
                                   **tol)


def _adamw():
    # optax.adamw's defaults: decay 1e-4 on every leaf (torch's is 1e-2)
    return optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _torch_adamw(model, lr=LR):
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


# -- the f32-parameter repair ---------------------------------------------

def test_one_adamw_step_from_converted_params_matches_optax(comm):
    """A bf16 model keeps f32 parameters, gradients and AdamW state, as
    flax's param_dtype does: one AdamW step from the converted parameters
    with the JAX gradients gives optax.adamw's f32 parameters (1e-6; both
    do the same f32 arithmetic). Its own bf16-compute loss and gradients
    sit within bf16 drift of the JAX model's (loss 1e-2, each gradient
    5e-2 relative L2)."""
    params = _flax_params(jnp.bfloat16)
    jm = JaxLM(**CFG, attention="reference", dtype=jnp.bfloat16)
    x, y = (a[0, :4] for a in _batches(1))
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jm, p, x, y)[0]))(params)
    opt = optax.adamw(3e-4)

    @jax.jit
    def adamw_step(g, p):
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates)

    new_params = adamw_step(grads, params)

    tm = _port_model(params, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    loss_t, _ = lm_loss_with_aux(tm, torch.from_numpy(x), torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-2)
    jgrads = params_from_flax(tm, jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32, name
        rel = (p.grad - jgrads[name]).norm() / jgrads[name].norm()
        assert rel < 5e-2, (name, rel.item())
        p.grad = jgrads[name].clone()
    wrapped = create_multi_node_optimizer(_torch_adamw(tm, lr=3e-4), comm)
    wrapped.step()
    assert all(s["exp_avg"].dtype == torch.float32
               for s in wrapped.state.values())
    _assert_params_close(tm, new_params, rtol=1e-6, atol=1e-6)


# -- the communicator -----------------------------------------------------

def test_size_one_communicator_topology_and_collectives(comm):
    assert (comm.rank, comm.size) == (0, 1)
    assert (comm.intra_rank, comm.intra_size) == (0, 1)
    assert (comm.inter_rank, comm.inter_size) == (0, 1)
    assert comm.is_master and comm.device == torch.device("cpu")
    x = torch.arange(6.0)
    assert torch.equal(comm.allreduce(x, "mean"), x)
    assert torch.equal(comm.bcast(x), x)
    grads = [torch.ones(3), torch.full((2, 2), 2.0)]
    comm.allreduce_grad(grads, "mean")
    assert torch.equal(grads[1], torch.full((2, 2), 2.0))
    comm.barrier()
    sub = comm.split(0, 0)
    assert (sub.rank, sub.size, sub.members) == (0, 1, (0,))
    assert torch.equal(sub.allreduce(x), x)
    sub.finalize()
    for call in (lambda: comm.send(x, 0), lambda: comm.recv(0)):
        with pytest.raises(RuntimeError, match="no peer"):
            call()
    assert torch.equal(comm.alltoall(x[None]), x[None])
    assert torch.equal(comm.gather(x), x[None])
    assert torch.equal(comm.scatter(x[None]), x)
    # the object collectives of a world of one (2-3 ranks:
    # tests/test_torch_objects.py)
    assert comm.bcast_obj({"a": 1}) == {"a": 1}
    assert comm.allreduce_obj(1) == 1 and comm.allreduce_obj(5, "mean") == 5
    with pytest.raises(RuntimeError, match="no peer"):
        comm.send_obj(1, 0)
    # the host-staged path by its name (multi-rank: test_torch_p2p.py)
    staged = create_communicator("non_cuda_aware", device="cpu")
    assert staged.name == "non_cuda_aware"
    assert torch.equal(staged.allreduce(x), x) and staged.staged_bytes == 0
    staged.finalize()
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("mpi", device="cpu")


@pytest.mark.parametrize("bucket_bytes", [1, 100, 4096, 1 << 30])
def test_plan_buckets_is_the_jax_packages(bucket_bytes):
    rs = np.random.RandomState(bucket_bytes % 97)
    items = [(f"p{i}", int(n)) for i, n in enumerate(rs.randint(1, 2000,
                                                                 40))]
    assert plan_buckets(items, bucket_bytes) == jax_plan_buckets(
        items, bucket_bytes)


_WORKER = r'''
import os, sys
import torch
from chainermn_torch.comm import create_communicator, distributed
from chainermn_torch.models.transformer import TransformerLM, lm_loss_with_aux
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import (classifier_loss,
                                      make_data_parallel_train_step)

rank = int(os.environ["RANK"])
distributed.DEFAULT_BUCKET_BYTES = 64   # several buckets below
comm = create_communicator("pure_nccl", device="cpu")
assert (comm.rank, comm.size) == (rank, 2)
assert (comm.intra_rank, comm.intra_size, comm.inter_size) == (rank, 2, 1)

# allreduce_grad mean, over several flat buckets of at most 64 bytes
shapes = [(3,), (5, 4), (1,), (7,)]
grads = [torch.full(s, float(rank + 1)) * (i + 1)
         for i, s in enumerate(shapes)]
comm.allreduce_grad(grads, "mean")
for i, g in enumerate(grads):
    assert torch.equal(g, torch.full_like(g, 1.5 * (i + 1))), (i, g)
grads = {"a": torch.full((4,), float(rank))}
comm.allreduce_grad(grads, "sum")
assert torch.equal(grads["a"], torch.ones(4))

# allreduce_grad_dtype: the wire carries bf16; 1 + 2^-9 rounds to 1
c16 = create_communicator("pure_nccl", device="cpu",
                          allreduce_grad_dtype=torch.bfloat16)
g = [torch.full((6,), 1.0 + 2.0 ** -9) * (rank + 1)]
c16.allreduce_grad(g, "mean")
want = (torch.full((6,), 1.0 + 2.0 ** -9).bfloat16()
        + (2 * torch.full((6,), 1.0 + 2.0 ** -9)).bfloat16()).float() / 2
assert g[0].dtype == torch.float32 and torch.equal(g[0], want), g[0]

# allreduce / allgather / bcast / bcast_data
assert torch.equal(comm.allreduce(torch.tensor([rank + 1.0]), "mean"),
                   torch.tensor([1.5]))
assert torch.equal(comm.allgather(torch.tensor([rank, 10 + rank])),
                   torch.tensor([[0, 10], [1, 11]]))
assert torch.equal(comm.bcast(torch.tensor([rank + 5.0]), root=1),
                   torch.tensor([6.0]))
torch.manual_seed(100 + rank)          # different weights on each rank
model = TransformerLM(vocab=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                      max_len=8, pos_emb="rope", device="cpu")
comm.bcast_data(model)
torch.manual_seed(100)
ref = TransformerLM(vocab=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                    max_len=8, pos_emb="rope", device="cpu")
for (n, p), q in zip(model.named_parameters(), ref.parameters()):
    assert torch.equal(p, q), n

# two data-parallel steps on half the batch each == the full-batch steps
gen = torch.Generator().manual_seed(7)
toks = torch.randint(0, 64, (2, 4, 9), generator=gen)
x, y = toks[..., :-1], toks[..., 1:]
half = slice(2 * rank, 2 * rank + 2)
opt = create_multi_node_optimizer(
    torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4), comm)
step = make_data_parallel_train_step(model, opt, comm,
                                     loss_fn=lm_loss_with_aux, scan_steps=2)
m = step(x[:, half], y[:, half])
ropt = torch.optim.AdamW(ref.parameters(), lr=1e-2, weight_decay=1e-4)
losses = []
for i in range(2):
    ropt.zero_grad()
    loss, _ = lm_loss_with_aux(ref, x[i], y[i])
    loss.backward()
    ropt.step()
    losses.append(loss.item())
torch.testing.assert_close(m["main/loss"], torch.tensor(losses), rtol=1e-5,
                           atol=1e-5)
for (n, p), q in zip(model.named_parameters(), ref.parameters()):
    torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=n)
c16.finalize()
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_two_rank_gloo_world():
    """A real 2-process gloo world: ``allreduce_grad`` mean and sum over
    several flat buckets (exact: small integers), ``allreduce_grad_dtype``
    (bf16 on the wire, exact to bf16's rounding), ``allreduce``,
    ``allgather``, ``bcast``, ``bcast_data``, and two data-parallel steps
    on half the batch each against the full-batch steps in one process
    (1e-5)."""
    assert_ranks_ok(run_world(_WORKER, 2, timeout=120))


# -- the optimizer wrapper ------------------------------------------------

@pytest.mark.parametrize("double_buffering", [False, True])
def test_multi_node_optimizer_against_the_jax_wrapper(comm,
                                                      double_buffering):
    """SGD with momentum through each package's wrapper, fed the same
    gradient sequence: the port's step() equals the JAX update, with
    double buffering's one-step lag (step 1 applies zeros, step t the
    gradients of step t-1). f32 at 1e-6."""
    # one rank on each side: a one-device mesh
    comm_j = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("r",)))
    opt_j = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1, momentum=0.9), comm_j,
        double_buffering=double_buffering)
    rs = np.random.RandomState(1)
    w0 = rs.randn(3, 4).astype(np.float32)
    grads = [rs.randn(3, 4).astype(np.float32) for _ in range(3)]

    def local(g, state, p):
        upd, state = opt_j.update(g, state, p)
        return optax.apply_updates(p, upd), state

    update = jax.jit(jax.shard_map(local, mesh=comm_j.mesh,
                                   in_specs=(P(), P(), P()),
                                   out_specs=(P(), P())))

    pj, sj = jnp.asarray(w0), opt_j.init(jnp.asarray(w0))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = create_multi_node_optimizer(
        torch.optim.SGD([w], lr=0.1, momentum=0.9), comm,
        double_buffering=double_buffering)
    for i, g in enumerate(grads):
        pj, sj = update(jnp.asarray(g), sj, pj)
        w.grad = torch.from_numpy(g.copy())
        opt_t.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-6)
        if double_buffering and i == 0:
            np.testing.assert_array_equal(w.detach().numpy(), w0)
    with pytest.raises(ValueError, match="unknown grad_reducer"):
        create_multi_node_optimizer(torch.optim.SGD([w], lr=0.1), comm,
                                    grad_reducer=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_multi_node_optimizer(torch.optim.SGD([w], lr=0.1), comm,
                                    tune=True)


# -- the data-parallel train step -----------------------------------------

def test_unfused_step_matches_the_jax_step(comm):
    """``make_data_parallel_train_step`` with ``lm_loss_with_aux``,
    ``grad_accum=2`` and ``scan_steps=2`` against the JAX step on the
    8-device CPU mesh over the same global batch (16 rows: 8 shards of 2
    rows, so each micro-batch of the JAX step is 1 row per shard): the 4
    steps' losses and accuracies (1e-4) and the final parameters."""
    params = _flax_params()
    jm = JaxLM(**CFG, attention="reference")
    comm_j = chainermn_tpu.create_communicator("xla")
    opt_j = chainermn_tpu.create_multi_node_optimizer(_adamw(), comm_j)
    step_j = jax_make_step(jm, opt_j, comm_j, loss_fn=jax_lm_loss,
                           donate=False, grad_accum=2, scan_steps=2)
    # the port's flash entry (its plain version on the CPU) against the
    # JAX model's dense reference attention: both exact softmax attention
    tm = _port_model(params, attention="flash")
    opt_t = create_multi_node_optimizer(_torch_adamw(tm), comm)
    step_t = make_data_parallel_train_step(tm, opt_t, comm,
                                           loss_fn=lm_loss_with_aux,
                                           grad_accum=2, scan_steps=2)
    xs, ys = _batches(4)
    state = (comm_j.bcast_data(params), opt_j.init(params))
    for call in range(2):
        xk, yk = xs[2 * call:2 * call + 2], ys[2 * call:2 * call + 2]
        state, mj = step_j(state, xk, yk)
        mt = step_t(torch.from_numpy(xk), torch.from_numpy(yk))
        assert mt["main/loss"].shape == (2,)
        np.testing.assert_allclose(mt["main/loss"].numpy(),
                                   np.asarray(mj["main/loss"]), **TOL_LOSS)
        np.testing.assert_allclose(mt["main/accuracy"].numpy(),
                                   np.asarray(mj["main/accuracy"]),
                                   **TOL_LOSS)
    _assert_params_close(tm, state[0], **TOL_PARAMS)


def test_fused_step_matches_jax_fused_lm_loss_and_optax(comm):
    """The port's step with ``fused_lm_loss`` (``grad_accum=2``,
    ``scan_steps=2``) against ``jax.value_and_grad(fused_lm_loss)`` with
    the same two micro-batches per step and ``optax.adamw``, outside
    shard_map (the Pallas CE kernels run in interpret mode there, not
    under shard_map): 4 steps' losses (1e-4) and the final parameters."""
    params = _flax_params()
    jm = JaxLM(**CFG, attention="reference")
    opt = _adamw()

    @jax.jit
    def micro(p, x, y):
        (loss, (acc, _)), g = jax.value_and_grad(
            lambda p_: jax_fused_lm_loss(jm, p_, x, y, block_rows=64,
                                         block_v=128), has_aux=True)(p)
        return loss, acc, g

    tm = _port_model(params)
    opt_t = create_multi_node_optimizer(_torch_adamw(tm), comm)
    step_t = make_data_parallel_train_step(tm, opt_t, comm,
                                           loss_fn=fused_lm_loss,
                                           grad_accum=2, scan_steps=2)
    xs, ys = _batches(4, b=4, seed=1)
    p, s = params, opt.init(params)
    want = []
    for i in range(4):
        parts = [micro(p, xs[i, h:h + 2], ys[i, h:h + 2]) for h in (0, 2)]
        g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, parts[0][2],
                                   parts[1][2])
        upd, s = opt.update(g, s, p)
        p = optax.apply_updates(p, upd)
        want.append((float(parts[0][0] + parts[1][0]) / 2,
                     float(parts[0][1] + parts[1][1]) / 2))
    got = [step_t(torch.from_numpy(xs[c:c + 2]), torch.from_numpy(ys[c:c + 2]))
           for c in (0, 2)]
    losses = torch.cat([m["main/loss"] for m in got]).numpy()
    accs = torch.cat([m["main/accuracy"] for m in got]).numpy()
    np.testing.assert_allclose(losses, [w[0] for w in want], **TOL_LOSS)
    np.testing.assert_allclose(accs, [w[1] for w in want], **TOL_LOSS)
    assert losses[-1] < losses[0]
    _assert_params_close(tm, p, **TOL_PARAMS)


def test_remat_changes_no_value(comm):
    """``remat`` (per block in the model, around the loss in the step)
    recomputes the flash Function's forward in the backward and gives the
    same losses and parameters (1e-6)."""
    params = _flax_params()
    xs, ys = (torch.from_numpy(a) for a in _batches(2, b=4, seed=2))
    out = []
    for model_remat, step_remat in ((False, False), (True, False),
                                    (False, True)):
        tm = _port_model(params, remat=model_remat)
        opt = create_multi_node_optimizer(_torch_adamw(tm), comm)
        step = make_data_parallel_train_step(tm, opt, comm,
                                             loss_fn=fused_lm_loss,
                                             remat=step_remat, scan_steps=2)
        out.append((np.asarray(step(xs, ys)["main/loss"]), tm.state_dict()))
    for losses, sd in out[1:]:
        np.testing.assert_allclose(losses, out[0][0], rtol=1e-6, atol=1e-6)
        for name, t in sd.items():
            torch.testing.assert_close(t, out[0][1][name], rtol=1e-6,
                                       atol=1e-6, msg=name)


def test_classifier_loss_is_the_default_loss_and_matches_jax(comm):
    """The step's default loss: softmax cross-entropy and accuracy of an
    (x, y) classifier, against the JAX ``classifier_loss`` on a flax Dense
    layer with the same weights (1e-5); one default step updates it."""
    import flax.linen as fnn

    rs = np.random.RandomState(6)
    x = rs.randn(8, 5).astype(np.float32)
    y = rs.randint(0, 3, size=(8,)).astype(np.int32)
    dense = fnn.Dense(3)
    params = dense.init(jax.random.PRNGKey(0), x)["params"]
    loss_j, (acc_j, _) = jax_classifier_loss(dense, params, x, y)
    lin = torch.nn.Linear(5, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(np.asarray(params["kernel"]).T))
        lin.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    loss_t, (acc_t, _) = classifier_loss(lin, torch.from_numpy(x),
                                         torch.from_numpy(y))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert acc_t.item() == pytest.approx(float(acc_j))
    opt = create_multi_node_optimizer(torch.optim.SGD(lin.parameters(),
                                                      lr=0.5), comm)
    step = make_data_parallel_train_step(lin, opt, comm)
    first = step(torch.from_numpy(x), torch.from_numpy(y))["main/loss"]
    np.testing.assert_allclose(first.item(), float(loss_j), rtol=1e-5)
    assert step(torch.from_numpy(x),
                torch.from_numpy(y))["main/loss"].item() < first.item()


def test_step_refuses_what_waits_for_later_slices(comm):
    """``mutable`` names only ``batch_stats``, and a batch-norm model
    needs it (the JAX step fails on such a model without it); a scan
    needs a leading axis."""
    tm = _port_model(_flax_params())
    opt = create_multi_node_optimizer(_torch_adamw(tm), comm)
    with pytest.raises(ValueError, match="batch_stats"):
        make_data_parallel_train_step(tm, opt, comm, mutable=("bn",))
    bn_model = CifarResNet(num_classes=10, depth=8, device="cpu")
    bn_opt = create_multi_node_optimizer(
        torch.optim.SGD(bn_model.parameters(), lr=0.1), comm)
    with pytest.raises(ValueError, match="mutable"):
        make_data_parallel_train_step(bn_model, bn_opt, comm)
    step = make_data_parallel_train_step(tm, opt, comm, scan_steps=2,
                                         loss_fn=lm_loss_with_aux)
    x, y = (torch.from_numpy(a[0]) for a in _batches(1, b=4))
    with pytest.raises(ValueError, match="leading axis"):
        step(x, y)


# -- the training surface of the model ------------------------------------

@pytest.mark.parametrize("kv", [None, 2])
def test_params_from_flax_loads_a_bhld_tree(kv):
    """A tree trained with ``qkv_layout="bhld"`` (head-major kernels,
    fused MHA or GQA) loads into the port, whose logits equal the JAX
    bhld model's (f32, 1e-4): the JAX forward runs the Pallas flash
    kernel in interpret mode."""
    cfg = dict(CFG, n_kv_heads=kv)
    jm = JaxLM(**cfg, qkv_layout="bhld")
    toks = _batches(1, b=2, seed=3)[0][0]
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(4), jnp.asarray(toks))["params"])
    assert any(k.endswith("_bhld") for k in params["block_0"])
    tm = _port_model(params, n_kv_heads=kv)
    ref = np.asarray(jm.apply({"params": params}, toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, **TOL_LOSS)


def test_return_hidden_and_lm_loss_with_aux_match_jax():
    """``return_hidden`` gives the final post-LN states; the unfused loss
    and accuracy equal the JAX ``lm_loss_with_aux`` (1e-4)."""
    params = _flax_params()
    jm = JaxLM(**CFG, attention="reference")
    x, y = (a[0, :4] for a in _batches(1, seed=5))
    hid_j = jm.clone(return_hidden=True).apply({"params": params}, x)
    tm = _port_model(params, return_hidden=True)
    with torch.no_grad():
        hid_t = tm(torch.from_numpy(x))
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **TOL_LOSS)
    loss_j, (acc_j, _) = jax_lm_loss(jm, params, x, y)
    tm.return_hidden = False
    loss_t, (acc_t, _) = lm_loss_with_aux(tm, torch.from_numpy(x),
                                          torch.from_numpy(y))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL_LOSS)
    assert acc_t.item() == pytest.approx(float(acc_j), abs=1e-6)


# -- batch statistics: the mutable step and the eval step -----------------
#
# The CIFAR ResNet of depth 8 (config #3's model, 16x16 images, 10
# classes) with every parameter and statistic redrawn at random, SGD 0.02
# with momentum 0.9 (optax's trace starts at zero, torch's buffer at the
# first gradient: the same updates). At the CIFAR example's 0.05 one of
# the two draws sits where SGD amplifies the f32 rounding of the updated
# parameters about a thousandfold per step (the f64 oracle keeps them in
# f64), and the third step's updates part by 4e-2; at 0.02 they stay
# within 3e-5 of each other. The JAX step runs in f64
# (``jax.enable_x64``, the model's dtype f64): flax's f32 batch norm
# differentiates E[x²] − E[x]², whose two terms cancel where |mean| >> std,
# and on these [0, 1) images its f32 gradients of the first stage are
# 1e-2 (relative L2) from the f64 ones, where the port's f32 gradients,
# which use Σdy and Σdy·x̂, are 1e-6 from them. Losses, parameters and
# running statistics at 1e-4 (rtol and atol): the port's f32 rounding
# carried through 8 layers and 3 steps.

BN_LR = 0.02
TOL_BN = dict(rtol=1e-4, atol=1e-4)


def _mesh_comm(n):
    return chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:n]), ("data",)))


@functools.lru_cache(maxsize=None)
def _bn_case(cross_replica=False, n_dev=1):
    """(flax model, params, batch_stats, xs [3, 8, 16, 16, 3], ys)."""
    jm = JaxCifarResNet(num_classes=10, depth=8,
                        comm=_mesh_comm(n_dev) if cross_replica else None)
    rs = np.random.RandomState(21)
    xs = rs.rand(3, 8, 16, 16, 3).astype(np.float32)
    ys = rs.randint(0, 10, size=(3, 8)).astype(np.int32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), xs[0, :1])
    return (jm, _randomised(v["params"], 22),
            _randomised(v["batch_stats"], 23), xs, ys)


def _jax_bn_run(jm, params, stats, xs, ys, n_dev=1, **kw):
    """The JAX step in f64 (see above); results back in f32 numpy."""
    f64 = functools.partial(jax.tree_util.tree_map,
                            lambda a: np.asarray(a, np.float64))
    f32 = functools.partial(jax.tree_util.tree_map,
                            lambda a: np.asarray(a, np.float32))
    with jax.enable_x64(True):
        comm_j = _mesh_comm(n_dev)
        opt = chainermn_tpu.create_multi_node_optimizer(
            optax.sgd(BN_LR, momentum=0.9), comm_j)
        step = jax_make_step(jm.clone(dtype=jnp.float64), opt, comm_j,
                             mutable=("batch_stats",), donate=False, **kw)
        params = f64(params)
        state = (params, opt.init(params), {"batch_stats": f64(stats)})
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x.astype(np.float64), y)
            losses.append(float(m["main/loss"]))
        return losses, f32(state[0]), f32(state[2]["batch_stats"])


def _port_bn_model(comm, cross_replica, params, stats):
    model = CifarResNet(num_classes=10, depth=8,
                        comm=comm if cross_replica else None, device="cpu")
    model.load_state_dict(resnet_params_from_flax(model, params, stats))
    return model


def _port_bn_run(comm, cross_replica, params, stats, xs, ys, **kw):
    model = _port_bn_model(comm, cross_replica, params, stats)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=BN_LR, momentum=0.9), comm)
    step = make_data_parallel_train_step(model, opt, comm,
                                         mutable=("batch_stats",), **kw)
    losses = [step(torch.from_numpy(x), torch.from_numpy(y))[
        "main/loss"].item() for x, y in zip(xs, ys)]
    return losses, model


def _assert_bn_state(model, params, stats):
    want = resnet_params_from_flax(model, params, stats)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, msg=k, **TOL_BN)


@pytest.mark.parametrize("cross_replica", [False, True])
def test_mutable_step_matches_the_jax_step_on_one_rank(comm,
                                                       cross_replica):
    """Three SGD steps with ``mutable=("batch_stats",)`` against the JAX
    step on a one-device mesh: losses, parameters and running
    statistics, with per-replica and with cross-replica batch norm."""
    jm, params, stats, xs, ys = _bn_case(cross_replica)
    want, p_j, s_j = _jax_bn_run(jm, params, stats, xs, ys)
    got, model = _port_bn_run(comm, cross_replica, params, stats, xs, ys)
    np.testing.assert_allclose(got, want, **TOL_BN)
    _assert_bn_state(model, p_j, s_j)


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(remat=True),
                                dict(grad_accum=2, remat=True)],
                         ids=["grad_accum", "remat", "both"])
def test_grad_accum_and_remat_carry_batch_stats_as_the_jax_step(comm, kw):
    """``grad_accum=2`` passes the statistics through the two
    micro-batches in order and ``remat=True`` updates them once (the
    recomputed forward leaves them alone): after three steps the running
    statistics and parameters equal the JAX step's with the same
    options. Without the freeze, remat would apply each update twice."""
    jm, params, stats, xs, ys = _bn_case()
    want, p_j, s_j = _jax_bn_run(jm, params, stats, xs, ys, **kw)
    got, model = _port_bn_run(comm, False, params, stats, xs, ys, **kw)
    np.testing.assert_allclose(got, want, **TOL_BN)
    _assert_bn_state(model, p_j, s_j)


_BN_WORKER = r'''
import os, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.resnet import CifarResNet
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import make_data_parallel_train_step

rank = int(os.environ["RANK"])
data = torch.load(sys.argv[1], weights_only=False)
comm = create_communicator("pure_nccl", device="cpu")
half = slice(4 * rank, 4 * rank + 4)
for cross, case in data["cases"].items():
    model = CifarResNet(num_classes=10, depth=8,
                        comm=comm if cross else None, device="cpu")
    model.load_state_dict(case["init"])
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.02, momentum=0.9), comm)
    step = make_data_parallel_train_step(model, opt, comm,
                                         mutable=("batch_stats",))
    losses = [step(torch.from_numpy(x[half]), torch.from_numpy(y[half]))[
        "main/loss"].item() for x, y in zip(data["xs"], data["ys"])]
    np.testing.assert_allclose(losses, case["losses"], rtol=1e-4, atol=1e-4)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, case["final"][k], rtol=1e-4,
                                   atol=1e-4, msg=f"{cross} {k}")
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_mutable_step_on_two_ranks_matches_the_jax_step_on_two_devices(
        tmp_path):
    """A 2-rank gloo world, each rank with half of each 8-image batch,
    against the JAX step on a 2-device mesh over the whole batch, for
    per-replica batch norm (running statistics pmean-ed after each step)
    and cross-replica batch norm (statistics and their gradient sums
    all-reduced): three steps' losses, and the parameters and running
    statistics on both ranks (1e-4)."""
    cases = {}
    for cross in (False, True):
        jm, params, stats, xs, ys = _bn_case(cross, n_dev=2)
        losses, p_j, s_j = _jax_bn_run(jm, params, stats, xs, ys, n_dev=2)
        model = CifarResNet(num_classes=10, depth=8, device="cpu")
        cases[cross] = {
            "init": resnet_params_from_flax(model, params, stats),
            "final": resnet_params_from_flax(model, p_j, s_j),
            "losses": losses}
    path = tmp_path / "bn_case.pt"
    torch.save({"cases": cases, "xs": xs, "ys": ys}, path)
    assert_ranks_ok(run_world(_BN_WORKER, 2, timeout=180,
                              args=[str(path)]))


def test_eval_step_of_a_batch_norm_model_uses_the_running_stats(comm):
    """``make_eval_step`` passes ``train=False``: its metrics equal the
    JAX ``make_eval_step`` over the same state (1e-5) and the loss with
    running statistics, differ from the train-mode loss, and leave the
    running statistics untouched."""
    jm, params, stats, xs, ys = _bn_case()
    comm_j = _mesh_comm(1)
    ev_j = jax_make_eval_step(jm, comm_j, extra_vars_in_state=True)
    mj = ev_j((params, (), {"batch_stats": stats}), xs[0], ys[0])
    model = _port_bn_model(comm, False, params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mt = make_eval_step(model, comm)(torch.from_numpy(xs[0]),
                                     torch.from_numpy(ys[0]))
    for k in ("validation/main/loss", "validation/main/accuracy"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-5,
                                   atol=1e-5)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        train_loss, _ = classifier_loss(model, torch.from_numpy(xs[0]),
                                        torch.from_numpy(ys[0]), train=True)
    assert abs(train_loss.item() - mt["validation/main/loss"].item()) > 1e-3


def test_allreduce_persistent_averages_running_stats_in_place(comm):
    """``allreduce_persistent`` on a module reduces its batch norms'
    running statistics (a world of one: the mean is the value itself, in
    f32 even when the communicator sends gradients in bf16) and returns
    the module; ``AllreducePersistent`` calls it with the getter's state
    and hands the result to the setter."""
    model = CifarResNet(num_classes=10, depth=8, device="cpu")
    with torch.no_grad():
        for m in batch_norm_layers(model):
            m.running_mean.normal_()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert allreduce_persistent(model, comm) is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    c16 = create_communicator("pure_nccl", device="cpu",
                              allreduce_grad_dtype=torch.bfloat16)
    stats = {"m": torch.tensor([1.0 + 2.0 ** -9])}
    seen = []
    AllreducePersistent(lambda: stats, c16, seen.append)()
    assert seen == [stats] and stats["m"].item() == 1.0 + 2.0 ** -9


# -- with_rng: dropout keys ------------------------------------------------
# The tiny ViT of tests/test_torch_vit.py with dropout 0.2 on every site.
# Masks are a function of (rng, rank, micro-step, site), so equal keys
# give bitwise-equal steps on the CPU; the rate-0 step against the JAX
# with_rng step at 1e-5 (f32 sums in another order).

VIT = dict(num_classes=10, patch=8, d_model=32, n_layers=2, n_heads=4,
           d_ff=64)


def _vit_batch(n=8, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, size=n).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _vit_flax_params():
    from chainermn_tpu.models.vit import ViT as JaxViT

    return jax.tree_util.tree_map(np.asarray, JaxViT(**VIT).init(
        jax.random.PRNGKey(0), _vit_batch(2)[0])["params"])


def _vit(rate, **kw):
    from chainermn_torch.models.convert import vit_params_from_flax
    from chainermn_torch.models.vit import ViT

    tm = ViT(**VIT, image_size=32, dropout_rate=rate, device="cpu", **kw)
    tm.load_state_dict(vit_params_from_flax(_vit_flax_params()))
    return tm


def _vit_step(comm, rate=0.2, model_kw=None, **kw):
    tm = _vit(rate, **(model_kw or {}))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(tm.parameters(), lr=0.1), comm)
    return tm, make_data_parallel_train_step(tm, opt, comm, **kw)


def _recording_loss(record):
    def loss_fn(model, x, y, train=True, mutable=None, rng=None):
        out = classifier_loss(model, x, y, train, mutable, rng=rng)
        record.append(out[0].item())
        return out
    return loss_fn


def test_with_rng_same_key_same_masks_other_key_other_masks(comm):
    """``step(x, y, rng)``: the same key gives the same step bit for bit,
    another key other masks (another loss); a missing key raises, as
    flax does without a dropout rng."""
    x, y = (torch.from_numpy(a) for a in _vit_batch())
    runs = []
    for key in (7, 7, 8):
        tm, step = _vit_step(comm, with_rng=True)
        runs.append((step(x, y, key)["main/loss"].item(), tm.state_dict()))
    assert runs[0][0] == runs[1][0] != runs[2][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    with pytest.raises(TypeError, match="rng"):
        step(x, y)
    tm, plain = _vit_step(comm)
    with pytest.raises(ValueError, match="key"):
        plain(x, y)


def test_with_rng_decorrelates_micro_steps(comm):
    """``grad_accum=2`` on a batch whose two halves are the same images:
    each micro-step folds its index into the key, so their masks (and
    losses) differ; without dropout they are equal."""
    x, y = _vit_batch(4)
    x, y = (torch.from_numpy(np.concatenate([a, a])) for a in (x, y))
    for rate in (0.2, 0.0):
        seen = []
        tm, step = _vit_step(comm, rate, with_rng=True, grad_accum=2,
                             loss_fn=_recording_loss(seen))
        step(x, y, 3)["main/loss"].item()
        assert len(seen) == 2
        assert (seen[0] != seen[1]) == (rate > 0), (rate, seen)


def test_with_rng_at_rate_zero_is_the_plain_step_and_the_jax_step(comm):
    """Dropout 0 with keys equals the step without them bit for bit, and
    the JAX ``with_rng`` step (1e-5)."""
    from chainermn_tpu.models.vit import ViT as JaxViT

    x, y = _vit_batch()
    comm_j = _mesh_comm(1)
    opt_j = chainermn_tpu.create_multi_node_optimizer(optax.sgd(0.1), comm_j)
    step_j = jax_make_step(JaxViT(**VIT), opt_j, comm_j, with_rng=True,
                           donate=False)
    params = _vit_flax_params()
    (p_j, _), m_j = step_j((params, opt_j.init(params)), x, y,
                           jax.random.PRNGKey(5))
    out = []
    for kw, args in ((dict(with_rng=True), (5,)), ({}, ())):
        tm, step = _vit_step(comm, 0.0, **kw)
        out.append((step(torch.from_numpy(x), torch.from_numpy(y),
                         *args)["main/loss"].item(), tm.state_dict()))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][0], float(m_j["main/loss"]),
                               rtol=1e-5)
    from chainermn_torch.models.convert import vit_params_from_flax

    want = vit_params_from_flax(jax.tree_util.tree_map(np.asarray, p_j))
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k
        torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-5, msg=k)


@pytest.mark.parametrize("where", ["model", "step"])
def test_remat_recomputes_the_same_dropout_masks(comm, where):
    """Under ``remat`` (the model's per-block checkpoint, or the step's
    around the loss) the recomputed forward draws the first pass's masks:
    the step's loss and parameters equal the un-rematted step's bit for
    bit. ``torch.utils.checkpoint`` does not replay a hand-made
    generator's state; the masks are keyed by site instead."""
    x, y = (torch.from_numpy(a) for a in _vit_batch())
    out = []
    for remat in (False, True):
        model_kw = {"remat": remat} if where == "model" else {}
        step_kw = {"remat": remat} if where == "step" else {}
        tm, step = _vit_step(comm, model_kw=model_kw, with_rng=True,
                             **step_kw)
        out.append((step(x, y, 9)["main/loss"].item(), tm.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_eval_mode_ignores_dropout():
    """``train=False`` is deterministic and equals the model without
    dropout, with or without a key; train mode with a key drops."""
    x = torch.from_numpy(_vit_batch(2)[0])
    tm, plain = _vit(0.2), _vit(0.0)
    with torch.no_grad():
        a, b = tm(x, train=False), tm(x, train=False, rng=4)
        c = plain(x, train=False)
        d = tm(x, train=True, rng=4)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.allclose(a, d)


_RNG_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.vit import ViT
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import (classifier_loss,
                                      make_data_parallel_train_step)

rank = int(os.environ["RANK"])
with open(sys.argv[1], "rb") as f:
    case = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
seen = []

def loss_fn(model, x, y, train=True, mutable=None, rng=None):
    out = classifier_loss(model, x, y, train, mutable, rng=rng)
    seen.append(out[0].item())
    return out

for rate in (0.2, 0.0):
    tm = ViT(**case["cfg"], image_size=32, dropout_rate=rate, device="cpu")
    tm.load_state_dict(case["init"])
    opt = create_multi_node_optimizer(
        torch.optim.SGD(tm.parameters(), lr=0.1), comm)
    step = make_data_parallel_train_step(tm, opt, comm, with_rng=True,
                                         loss_fn=loss_fn)
    step(torch.from_numpy(case["x"]), torch.from_numpy(case["y"]), 3)
losses = comm.allgather_obj(seen)
# the same images and key on both ranks: the rank folded into the key
# gives other masks; without dropout the ranks agree
assert losses[0][0] != losses[1][0], losses
assert losses[0][1] == losses[1][1], losses
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_with_rng_decorrelates_ranks(tmp_path):
    """A 2-rank gloo world, both ranks with the same images and key: each
    rank folds its rank into the key, so their dropout masks differ."""
    from chainermn_torch.models.convert import vit_params_from_flax

    x, y = _vit_batch(4)
    path = tmp_path / "case.pkl"
    with open(path, "wb") as f:
        pickle.dump({"cfg": VIT, "x": x, "y": y,
                     "init": vit_params_from_flax(_vit_flax_params())}, f)
    assert_ranks_ok(run_world(_RNG_WORKER, 2, timeout=120,
                              args=[str(path)]))
