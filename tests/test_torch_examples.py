"""The port's CIFAR and ImageNet examples (configs #3 and #2) on the CPU:
``train_cifar`` in a 2-rank gloo world against one rank fed both ranks'
batches (cross-replica batch norm against batch norm over the
concatenated batch); ``train_imagenet``'s optimizer against optax's SGD
with Nesterov momentum and ``warmup_cosine_decay_schedule``, its
on-device uint8 decode against the JAX example's, a ``--loader`` run, and
the options that wait for later slices.

Tolerances: the 2-rank run against the 1-rank run: losses at 1e-4
(rtol and atol; one framework, the statistics and gradient sums
all-reduced instead of summed in one pass; the first step's gradients
agree to 7e-6 relative), the final state within 1e-4 relative L2 over all
of it and 1e-3 per element (over SGD steps a few activations at a ReLU's
kink fall on the other side in one of the runs, and each such flip moves
a batch-norm bias by lr·|dy|, ~5e-5; after 8 steps of 256 samples the
worst element measured 3e-4 apart, the whole state 2.2e-5);
the optimizer against optax at 1e-6 (the same f32 arithmetic); the
decode exactly.
"""

import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu
from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import SubDataset, load_cifar, split_indices
from chainermn_torch.examples import train_imagenet
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.resnet import CifarResNet
from chainermn_torch.training import classifier_loss
from tests.test_torch_mp import assert_ranks_ok, run_world

_CIFAR_WORKER = r'''
import os, pickle, sys
from chainermn_torch.examples import train_cifar
from chainermn_torch.training import LogReport

out = sys.argv[1]
args = train_cifar.parse_args(
    ["--device", "cpu", "--communicator", "naive", "--epoch", "1",
     "--depth", "8", "--n-train", "128", "--batchsize", "16", "--out", out])
trainer, model = train_cifar.build_trainer(args)
comm = trainer.updater.comm
log = LogReport()
trainer.extend(log, trigger=(1, "iteration"))
trainer.run()
with open(os.path.join(out, f"rank{comm.rank}.pkl"), "wb") as f:
    pickle.dump({"losses": [e["main/loss"] for e in log.log],
                 "state": model.state_dict()}, f)
print(f"RANK{comm.rank} OK", flush=True)
comm.finalize()
'''


def test_cifar_two_ranks_match_one_rank_on_both_batches(tmp_path):
    """``chainermn_torch.examples.train_cifar`` in a 2-rank gloo world
    (128 synthetic CIFAR-100 samples in binary batches scattered as
    payloads, per-rank batch 16, CifarResNet depth 8 with cross-replica
    batch norm, one epoch = 4 steps): the parameters and running
    statistics are identical on both ranks, and each step's loss and the
    final state equal a 1-rank run with per-replica batch norm on the two
    ranks' batches concatenated (see the module docstring), with SGD 0.05
    and momentum 0.9."""
    results = run_world(_CIFAR_WORKER, 2, timeout=180,
                        args=[str(tmp_path)])
    assert_ranks_ok(results)
    assert "main/accuracy" in results[0][1]
    got = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    assert got[0]["losses"] == got[1]["losses"]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k

    train = load_cifar(str(tmp_path / "cifar-data"), n_classes=100)
    plans = split_indices(len(train), 2, shuffle=True, seed=0)
    its = [SerialIterator(SubDataset(train, p), 16, shuffle=True, seed=0)
           for p in plans]
    torch.manual_seed(0)
    model = CifarResNet(num_classes=100, depth=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    losses = []
    for _ in range(len(got[0]["losses"])):
        batch = next(its[0]) + next(its[1])
        x = torch.from_numpy(np.stack([b[0] for b in batch]))
        y = torch.from_numpy(np.stack([b[1] for b in batch]))
        opt.zero_grad()
        loss, _ = classifier_loss(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert len(losses) == 4 and its[0].epoch == 1
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4,
                               atol=1e-4)
    want = model.state_dict()
    assert set(want) == set(got[0]["state"])
    diff = torch.cat([(got[0]["state"][k] - v).reshape(-1)
                      for k, v in want.items()])
    whole = torch.cat([v.reshape(-1) for v in want.values()])
    assert (diff.norm() / whole.norm()).item() < 1e-4
    assert diff.abs().max().item() < 1e-3


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


@pytest.mark.parametrize("flags,item", [
    (["--optimizer", "lars"], "item 8"), (["--optimizer", "lamb"], "item 8"),
    (["--model", "vit"], "item 7"), (["--snapshot-every", "5"], "item 7"),
    (["--resume"], "item 7")])
def test_imagenet_refuses_what_waits_for_later_slices(flags, item):
    args = train_imagenet.parse_args(["--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match=item):
        train_imagenet.build_trainer(args)
