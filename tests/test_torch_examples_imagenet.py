"""The port's ImageNet example with ResNet-50 (config #2) on the CPU:
``train_imagenet``'s optimizer against optax's SGD with Nesterov momentum
and ``warmup_cosine_decay_schedule``, its on-device uint8 decode against
the JAX example's, a ``--loader`` run, and ``--optimizer lars|lamb``
against optax's LARS and LAMB (tolerances beside them): the optimizer
against optax at 1e-6 (the same f32 arithmetic); the decode exactly.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu
from chainermn_torch.comm import create_communicator
from chainermn_torch.examples import train_imagenet


@pytest.fixture(scope="module")
def comm():
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


@pytest.mark.parametrize("warmup_epochs", [0.0, 1.5])
def test_imagenet_optimizer_matches_optax(comm, warmup_epochs):
    """``make_optimizer``: SGD with Nesterov momentum 0.9 (and, with
    ``--warmup-epochs 1.5`` over 3 epochs of 4 steps, the warmup-cosine
    schedule evaluated at each update's count) fed 12 fixed gradients
    equals ``optax.sgd(schedule, momentum=0.9, nesterov=True)`` behind the
    JAX wrapper (1e-6), the schedule reaching 0 at the last step."""
    args = train_imagenet.parse_args(
        ["--lr", "0.1", "--epoch", "3", "--warmup-epochs",
         str(warmup_epochs)])
    lr = 0.1
    if warmup_epochs:
        lr = optax.warmup_cosine_decay_schedule(0.0, 0.1, 6, 12)
    comm_j = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("r",)))
    opt_j = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(lr, momentum=0.9, nesterov=True), comm_j)

    def local(g, state, p):
        upd, state = opt_j.update(g, state, p)
        return optax.apply_updates(p, upd), state

    update = jax.jit(jax.shard_map(local, mesh=comm_j.mesh,
                                   in_specs=(P(), P(), P()),
                                   out_specs=(P(), P())))
    rs = np.random.RandomState(4)
    w0 = rs.randn(5, 3).astype(np.float32)
    pj, sj = jnp.asarray(w0), opt_j.init(jnp.asarray(w0))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = train_imagenet.make_optimizer(args, [w], comm,
                                          steps_per_epoch=4)
    for i in range(12):
        g = rs.randn(5, 3).astype(np.float32)
        pj, sj = update(jnp.asarray(g), sj, pj)
        w.grad = torch.from_numpy(g.copy())
        opt_t.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-6, err_msg=str(i))
    if warmup_epochs:
        assert opt_t.param_groups[0]["lr"] == pytest.approx(0.0, abs=1e-12)


def test_warmup_cosine_lr_is_optaxs_schedule():
    """Every count of a 3-step warmup and 10-step schedule, and past its
    end, equals optax's (f32 there: 1e-6); a schedule with no room for
    the decay is refused."""
    want = optax.warmup_cosine_decay_schedule(0.0, 0.4, 3, 10)
    got = train_imagenet.warmup_cosine_lr(0.4, 3, 10)
    for count in range(14):
        assert got(count) == pytest.approx(float(want(count)), abs=1e-6)
    with pytest.raises(ValueError, match="exceed"):
        train_imagenet.warmup_cosine_lr(0.1, 4, 4)


def test_on_device_decode_is_the_jax_examples():
    """The ``--loader`` loss decodes uint8 rows as ``x.to(bf16) / 255``,
    the JAX example's ``x.astype(bf16) / jnp.asarray(255.0, bf16)``: every
    byte value gives the same bf16."""
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16)
                       / jnp.asarray(255.0, jnp.bfloat16)).astype(
                           jnp.float32))
    got = (torch.from_numpy(x).to(torch.bfloat16) / 255.0).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_imagenet_loader_run_on_the_cpu(tmp_path, capsys):
    """``train_imagenet --loader`` trains 2 steps of ResNet-50 (f32, 32²,
    per-rank batch 2) from the uint8 files it writes under ``--out``,
    through the native loader: the loss is finite and the throughput line
    is printed."""
    trainer = train_imagenet.main(
        ["--device", "cpu", "--loader", "--iterations", "2", "--image-size",
         "32", "--n-train", "8", "--batchsize", "2", "--dtype", "float32",
         "--out", str(tmp_path)])
    obs = trainer.observation
    assert obs["iteration"] == 2 and np.isfinite(obs["main/loss"])
    assert (tmp_path / "synthetic_u8_x.npy").is_file()
    assert "throughput:" in capsys.readouterr().out


@pytest.mark.parametrize("warmup_epochs", [0.0, 1.5])
@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_imagenet_large_batch_optimizers_match_optax(comm, name,
                                                     warmup_epochs):
    """``make_optimizer`` with ``--optimizer lars|lamb`` (and the warm-up
    cosine schedule over 3 epochs of 4 steps) fed 12 fixed gradients on a
    convolution kernel, a vector and an all-zero vector equals
    ``optax.lars(lr, weight_decay=1e-4, momentum=0.9)`` /
    ``optax.lamb(lr, weight_decay=1e-4)`` behind the JAX wrapper, the JAX
    example's calls (1e-6)."""
    args = train_imagenet.parse_args(
        ["--lr", "0.1", "--epoch", "3", "--optimizer", name,
         "--warmup-epochs", str(warmup_epochs)])
    lr = 0.1
    if warmup_epochs:
        lr = optax.warmup_cosine_decay_schedule(0.0, 0.1, 6, 12)
    tx = (optax.lars(lr, weight_decay=1e-4, momentum=0.9) if name == "lars"
          else optax.lamb(lr, weight_decay=1e-4))
    comm_j = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("r",)))
    opt_j = chainermn_tpu.create_multi_node_optimizer(tx, comm_j)

    def local(g, state, p):
        upd, state = opt_j.update(g, state, p)
        return optax.apply_updates(p, upd), state

    update = jax.jit(jax.shard_map(local, mesh=comm_j.mesh,
                                   in_specs=(P(), P(), P()),
                                   out_specs=(P(), P())))
    rs = np.random.RandomState(4)
    shapes = [(4, 3, 3, 3), (4,), (4,)]
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes[:2]] + [
        np.zeros(shapes[2], np.float32)]
    pj = [jnp.asarray(w) for w in w0]
    sj = opt_j.init(pj)
    ws = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt_t = train_imagenet.make_optimizer(args, ws, comm, steps_per_epoch=4)
    for i in range(12):
        gs = [(rs.randn(*s) * 0.1).astype(np.float32) for s in shapes]
        pj, sj = update([jnp.asarray(g) for g in gs], sj, pj)
        for w, g in zip(ws, gs):
            w.grad = torch.from_numpy(g.copy())
        opt_t.step()
        for w, want in zip(ws, pj):
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_imagenet_resnet50_first_step_with_large_batch_optimizers(
        tmp_path, name):
    """``train_imagenet --optimizer lars|lamb`` on ResNet-50 (f32, 32²,
    batch 2, one iteration): a finite loss, and the update equals
    optax's (``optax.lars``/``optax.lamb`` as the JAX example calls them)
    on the gradients the example's step reduced, every leaf (batch-norm
    scales and biases too) one optax leaf; 1e-6."""
    trainer, model = train_imagenet.build_trainer(train_imagenet.parse_args(
        ["--device", "cpu", "--optimizer", name, "--iterations", "1",
         "--image-size", "32", "--n-train", "8", "--batchsize", "2",
         "--dtype", "float32", "--lr", "0.1", "--out", str(tmp_path)]))
    inner = trainer.updater.optimizer.actual_optimizer
    params = [p for g in inner.param_groups for p in g["params"]]
    seen = []
    step = inner.step

    def recording(*a, **k):
        if not seen:
            seen.append(([p.detach().numpy().copy() for p in params],
                         [p.grad.numpy().copy() for p in params]))
        out = step(*a, **k)
        if len(seen) == 1:
            seen.append([p.detach().numpy().copy() for p in params])
        return out

    inner.step = recording
    try:
        trainer.run()
    finally:
        trainer.updater.comm.finalize()
    assert np.isfinite(trainer.observation["main/loss"])
    (p0, g0), p1 = seen[0], seen[1]
    tx = (optax.lars(0.1, weight_decay=1e-4, momentum=0.9)
          if name == "lars" else optax.lamb(0.1, weight_decay=1e-4))
    pj = [jnp.asarray(p) for p in p0]
    upd, _ = tx.update([jnp.asarray(g) for g in g0], tx.init(pj), pj)
    want = optax.apply_updates(pj, upd)
    for i, (got, w) in enumerate(zip(p1, want)):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))
