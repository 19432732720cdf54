"""The port's CIFAR and ImageNet examples (configs #3 and #2) on the CPU:
``train_cifar`` in a 2-rank gloo world against one rank fed both ranks'
batches (cross-replica batch norm against batch norm over the
concatenated batch); ``train_imagenet``'s optimizer against optax's SGD
with Nesterov momentum and ``warmup_cosine_decay_schedule``, its
on-device uint8 decode against the JAX example's, a ``--loader`` run, and
``--optimizer lars|lamb`` against optax's LARS and LAMB; the seq2seq
(config #4) and
model-parallel (config #5) examples against the JAX examples' first
steps, the eager send/recv example, and ``train_lm`` (data-parallel and
ZeRO-1/2) against the JAX example's steps and its refusals (tolerances
beside them).

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

import functools
import os
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


# -- train_imagenet --model vit ----------------------------------------------
# Its first losses against the JAX example's model (ViT(num_classes=1000),
# ViT-S/16 at full width, here at 32² images: 4 tokens) from the same
# converted parameters, on the batches the port's example drew: the loss
# averaged over ranks, the gradients averaged over ranks,
# optax.sgd(lr, momentum=0.9, nesterov=True). f32 on both sides, lr 0.01;
# tolerance 1e-4 relative (f32 products in other orders through 3 steps).

VIT_ARGS = ["--device", "cpu", "--model", "vit", "--image-size", "32",
            "--n-train", "16", "--batchsize", "4", "--dtype", "float32",
            "--lr", "0.01", "--iterations", "3"]


@functools.lru_cache(maxsize=None)
def _jax_vit():
    """The JAX example's ViT in f32, its parameters, and its jitted loss
    and gradient."""
    from chainermn_tpu.models.vit import ViT as JViT

    model = JViT(num_classes=1000)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), np.zeros((2, 32, 32, 3), np.float32))[
            "params"])

    def f(p, x, y):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    return params, jax.jit(jax.value_and_grad(f))


def _jax_vit_losses(batches, opt=None):
    """``batches[step][rank] = (x, y)`` → the JAX steps' mean losses
    (``opt``: the JAX example's SGD unless given)."""
    params, vg = _jax_vit()
    opt = opt or optax.sgd(0.01, momentum=0.9, nesterov=True)
    state = opt.init(params)
    losses = []
    for per_rank in batches:
        vals, grads = zip(*(vg(params, x, y) for x, y in per_rank))
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / len(gs), *grads)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(sum(vals) / len(vals)))
    return losses


def _run_vit_example(argv, params_sd):
    """``train_imagenet`` built from ``argv`` with the given parameters:
    its losses and the (x, y) batches its steps took."""
    trainer, model = train_imagenet.build_trainer(
        train_imagenet.parse_args(argv))
    model.load_state_dict(params_sd)
    up, seen = trainer.updater, []
    step = up.step_fn

    def recording(x, y):
        m = step(x, y)
        seen.append((x.numpy().copy(), y.numpy().copy(),
                     float(m["main/loss"])))
        return m

    up.step_fn = recording
    try:
        trainer.run()
    finally:
        up.comm.finalize()
    return seen


def test_imagenet_vit_one_rank_matches_the_jax_steps():
    from chainermn_torch.models.convert import vit_params_from_flax

    params, _ = _jax_vit()
    seen = _run_vit_example(VIT_ARGS, vit_params_from_flax(params))
    want = _jax_vit_losses([[(x, y)] for x, y, _ in seen])
    np.testing.assert_allclose([s[2] for s in seen], want, rtol=1e-4)


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_imagenet_vit_large_batch_optimizers_match_the_jax_steps(name):
    """``--model vit --optimizer lars|lamb``: the first 3 losses against
    the JAX steps with ``optax.lars(0.01, weight_decay=1e-4,
    momentum=0.9)`` / ``optax.lamb(0.01, weight_decay=1e-4)``, the JAX
    example's calls, on the batches the port took (1e-4, as the SGD
    case)."""
    from chainermn_torch.models.convert import vit_params_from_flax

    params, _ = _jax_vit()
    seen = _run_vit_example(VIT_ARGS + ["--optimizer", name],
                            vit_params_from_flax(params))
    tx = (optax.lars(0.01, weight_decay=1e-4, momentum=0.9)
          if name == "lars" else optax.lamb(0.01, weight_decay=1e-4))
    want = _jax_vit_losses([[(x, y)] for x, y, _ in seen], tx)
    np.testing.assert_allclose([s[2] for s in seen], want, rtol=1e-4)


_VIT_WORKER = r'''
import os, pickle, sys
from tests.test_torch_examples import _run_vit_example

out, argv = sys.argv[1], sys.argv[2:]
with open(os.path.join(out, "params.pkl"), "rb") as f:
    sd = pickle.load(f)
seen = _run_vit_example(argv, sd)
rank = int(os.environ["RANK"])
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(seen, f)
print(f"RANK{rank} OK", flush=True)
'''


def test_imagenet_vit_two_ranks_match_the_jax_steps(tmp_path):
    """Two gloo ranks, each its own shard and batches: the mean losses
    (equal on both ranks) against the JAX steps on both ranks' batches
    with the gradients averaged."""
    from chainermn_torch.models.convert import vit_params_from_flax

    params, _ = _jax_vit()
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(vit_params_from_flax(params), f)
    assert_ranks_ok(run_world(_VIT_WORKER, 2, timeout=240,
                              args=[str(tmp_path), *VIT_ARGS]))
    ranks = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    assert [s[2] for s in ranks[0]] == [s[2] for s in ranks[1]]
    assert not np.array_equal(ranks[0][0][0], ranks[1][0][0])
    want = _jax_vit_losses([[(r[i][0], r[i][1]) for r in ranks]
                            for i in range(3)])
    np.testing.assert_allclose([s[2] for s in ranks[0]], want, rtol=1e-4)


def test_imagenet_vit_snapshot_and_resume_reproduce_the_run(tmp_path,
                                                            capsys):
    """``--snapshot-every 2`` for 2 iterations, then ``--resume`` to 4,
    with dropout (keys from the iteration) and a warm-up schedule: the
    final parameters equal an uninterrupted 4-iteration run's bit for
    bit (momentum, schedule, iterator position and masks carried over);
    the resumed run says where it started and writes iteration 4's
    snapshot."""
    argv = ["--device", "cpu", "--model", "vit", "--image-size", "32",
            "--n-train", "16", "--batchsize", "4", "--dtype", "float32",
            "--lr", "0.01", "--warmup-epochs", "0.5", "--epoch", "2",
            "--dropout", "0.1"]
    ref = train_imagenet.main(argv + ["--iterations", "4", "--out",
                                      str(tmp_path / "ref")])
    d = str(tmp_path / "cut")
    train_imagenet.main(argv + ["--iterations", "2", "--snapshot-every",
                                "2", "--out", d])
    capsys.readouterr()
    resumed = train_imagenet.main(argv + ["--iterations", "4",
                                          "--snapshot-every", "2",
                                          "--resume", "--out", d])
    out = capsys.readouterr().out
    assert "resumed from iteration 2" in out and "throughput:" in out
    assert resumed.updater.iteration == 4
    assert sorted(os.listdir(os.path.join(d, "imagenet")))[-2:] == [
        "snapshot_iter_4.0", "snapshot_iter_4.0.json"]
    sched = resumed.updater.optimizer.schedules[0]
    assert sched.last_epoch == 4
    for k, v in ref.updater.model.state_dict().items():
        assert torch.equal(resumed.updater.model.state_dict()[k], v), k


# -- config #4: the seq2seq example -----------------------------------------
# Its first losses against the JAX example's steps: the JAX Seq2Seq with
# the same parameters on each rank's batches (the JAX package's
# split_indices, SerialIterator and pad_batch), the gradients averaged over
# ranks, optax.adam(1e-3), the loss averaged over ranks: the JAX example's
# local_step (model.apply, seq2seq_loss, pmean, allreduce_grad "mean",
# adam). Tolerance 1e-4 relative: f32 LSTMs summed in other orders (4e-7
# relative a step), carried through 3 Adam steps.

S2S_ARGS = ["--device", "cpu", "--vocab", "30", "--unit", "16", "--layer",
            "2", "--n-train", "48", "--batchsize", "8", "--bucket", "8"]
S2S_STEPS = 3


def _jax_seq2seq(n_ranks):
    """The JAX model's parameters and the losses of the JAX example's
    first steps on ``n_ranks`` ranks."""
    from chainermn_tpu.datasets import SubDataset as JSub
    from chainermn_tpu.datasets import split_indices as jsplit
    from chainermn_tpu.datasets.toy import synthetic_translation
    from chainermn_tpu.iterators import SerialIterator as JIter
    from chainermn_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
    from chainermn_tpu.models.seq2seq import pad_batch, seq2seq_loss

    train = synthetic_translation(48, src_vocab=30, tgt_vocab=30, seed=0)
    its = [JIter(JSub(train, p), 8, shuffle=True, seed=0)
           for p in jsplit(len(train), n_ranks, shuffle=True, seed=0)]
    model = JSeq2Seq(n_layers=2, n_units=16, src_vocab=30, tgt_vocab=30)
    sample = pad_batch([train[i] for i in range(2)], 8)
    params = model.init(jax.random.PRNGKey(0), *sample[:3])["params"]
    start = jax.tree_util.tree_map(np.asarray, params)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    def f(p, src, src_len, tgt_in, tgt_out):
        logits = model.apply({"params": p}, src, src_len, tgt_in)
        return seq2seq_loss(logits, tgt_out)[0]

    vg = jax.jit(jax.value_and_grad(f))
    losses = []
    for _ in range(S2S_STEPS):
        vals, grads = zip(*(vg(params, *pad_batch(it.next(), 8))
                            for it in its))
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / n_ranks, *grads)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(sum(vals) / n_ranks))
    return start, losses


_S2S_WORKER = r'''
import os, pickle, sys
import torch
from chainermn_torch.examples import train_seq2seq

out, argv = sys.argv[1], sys.argv[2:]
args = train_seq2seq.parse_args(argv)
with open(os.path.join(out, "params.pkl"), "rb") as f:
    sd = pickle.load(f)
run = train_seq2seq.build(args)
run.model.load_state_dict(sd)
losses = []
for _ in range(3):
    arrays = train_seq2seq.pad_batch(run.iterator.next(), args.bucket)
    m = run.step(*(torch.from_numpy(a) for a in arrays))
    losses.append(float(m["main/loss"]))
hyp, bleu = train_seq2seq.translate_demo(run, args)
assert hyp.shape == (4, args.bucket) and 0.0 <= bleu <= 1.0
if run.comm.rank == 0:
    with open(os.path.join(out, "losses.pkl"), "wb") as f:
        pickle.dump(losses, f)
print(f"RANK{run.comm.rank} OK", flush=True)
run.comm.finalize()
'''


def test_seq2seq_one_rank_matches_the_jax_examples_steps():
    from chainermn_torch.examples import train_seq2seq
    from chainermn_torch.models.convert import seq2seq_params_from_flax

    start, want = _jax_seq2seq(1)
    args = train_seq2seq.parse_args(S2S_ARGS + ["--beam", "2"])
    run = train_seq2seq.build(args)
    try:
        run.model.load_state_dict(seq2seq_params_from_flax(start))
        got = []
        for _ in range(S2S_STEPS):
            arrays = train_seq2seq.pad_batch(run.iterator.next(), 8)
            got.append(float(run.step(*(torch.from_numpy(a)
                                        for a in arrays))["main/loss"]))
        hyp, bleu = train_seq2seq.translate_demo(run, args)
    finally:
        run.comm.finalize()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert hyp.shape == (4, 8) and 0.0 <= bleu <= 1.0


def test_seq2seq_two_ranks_match_the_jax_examples_steps(tmp_path):
    """Two gloo ranks: the root's pairs scattered as payloads, each rank
    its own batches, the multi-node optimizer's gradient mean."""
    from chainermn_torch.models.convert import seq2seq_params_from_flax

    start, want = _jax_seq2seq(2)
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(seq2seq_params_from_flax(start), f)
    assert_ranks_ok(run_world(_S2S_WORKER, 2, timeout=120,
                              args=[str(tmp_path), *S2S_ARGS]))
    got = pickle.loads((tmp_path / "losses.pkl").read_bytes())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_seq2seq_main_trains_from_a_bpe_corpus(tmp_path, capsys):
    """``--src-file``/``--tgt-file``: the root trains byte-BPE on the
    parallel text (cached beside it) and the example runs to its
    translate demo."""
    from chainermn_torch.examples import train_seq2seq

    rs = np.random.RandomState(0)
    words = ["ka", "mo", "tesu", "bilo", "dana", "remi"]
    src = [" ".join(rs.choice(words, rs.randint(2, 6))) for _ in range(24)]
    (tmp_path / "c.src").write_text("\n".join(src) + "\n")
    (tmp_path / "c.tgt").write_text(
        "\n".join(" ".join(s.split()[::-1]) for s in src) + "\n")
    final = train_seq2seq.main(
        ["--device", "cpu", "--src-file", str(tmp_path / "c.src"),
         "--tgt-file", str(tmp_path / "c.tgt"), "--bpe-vocab", "280",
         "--unit", "8", "--epoch", "1", "--batchsize", "8"])
    out = capsys.readouterr().out
    assert "BPE vocab" in out and "translate demo (greedy)" in out
    assert np.isfinite(final)
    assert (tmp_path / "c.src.bpe280.json").exists()


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


# -- train_lm ----------------------------------------------------------------
# The port's train_lm against the JAX example's steps at 2 layers, d 32,
# vocab 64, seq 16, per-rank batch 8, Adam 3e-3 with lm_loss_with_aux,
# from the same flax parameters on the batches the port's step took, one
# rank: the data-parallel step (jax.value_and_grad + optax.adam, as the
# JAX example's wrapper computes it on one device), and JAX's own
# make_zero1_train_step/make_zero2_train_step (flat, bucketed at 8 KiB,
# two micro-batches) on a 1-device mesh. The dense flags (--rope
# --n-kv-heads 2 --window 8) run the JAX flash kernels in interpret mode.
# Losses at 1e-5 relative over 3 steps (f32 sums in other orders; Adam's
# first step moves each weight by ~lr).

LM_ARGS = ["--device", "cpu", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "2", "--vocab", "64", "--seq-len", "16",
           "--n-train", "64", "--batchsize", "8", "--iterations", "3",
           "--lr", "3e-3"]
LM_MODES = {"dp": [], "zero1": ["--zero", "1"],
            "zero1-bucketed": ["--zero", "1", "--zero-bucket-kib", "8"],
            "zero2-bucketed": ["--zero", "2", "--zero-bucket-kib", "8"],
            "dense-flags": ["--rope", "--n-kv-heads", "2", "--window", "8"]}


def _jax_lm(dense: bool):
    from chainermn_tpu.models.transformer import TransformerLM as JLM

    kw = (dict(pos_emb="rope", n_kv_heads=2, attention_window=8,
               attention="flash") if dense else dict(attention="reference"))
    model = JLM(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128,
                max_len=16, **kw)
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, 16), np.int32))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def _run_lm_example(argv, params):
    """``train_lm`` built from ``argv`` with the flax ``params``
    converted: its (x, y, loss) per step."""
    from chainermn_torch.examples import train_lm
    from chainermn_torch.models.convert import params_from_flax

    trainer, model = train_lm.build_trainer(train_lm.parse_args(argv))
    model.load_state_dict(params_from_flax(model, params))
    up, seen = trainer.updater, []
    if hasattr(up.optimizer, "refresh"):     # a ZeRO state: re-shard
        up.optimizer.refresh()
    step = up.step_fn

    def recording(x, y):
        m = step(x, y)
        seen.append((x.numpy().copy(), y.numpy().copy(),
                     float(m["main/loss"])))
        return m

    up.step_fn = recording
    try:
        trainer.run()
    finally:
        up.comm.finalize()
    return seen


def _jax_lm_losses(mode, model, params, batches):
    from chainermn_tpu.models.transformer import lm_loss_with_aux as jloss
    from chainermn_tpu.optimizers import (make_zero1_train_step,
                                          make_zero2_train_step)

    tx = optax.adam(3e-3)
    losses = []
    if not mode.startswith("zero"):
        vg = jax.jit(jax.value_and_grad(
            lambda p, x, y: jloss(model, p, x, y)[0]))
        state = tx.init(params)
        for x, y in batches:
            loss, g = vg(params, x, y)
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return losses
    comm = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("r",)))
    bb = 8 * 1024 if "bucketed" in mode else None
    if mode.startswith("zero1"):
        step, state = make_zero1_train_step(model, tx, comm, params,
                                            loss_fn=jloss, bucket_bytes=bb,
                                            donate=False)
    else:
        step, state = make_zero2_train_step(model, tx, comm, params,
                                            n_microbatches=2, loss_fn=jloss,
                                            bucket_bytes=bb, donate=False)
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["main/loss"]))
    return losses


@pytest.mark.parametrize("mode", list(LM_MODES))
def test_train_lm_matches_the_jax_steps(tmp_path, mode):
    model, params = _jax_lm(mode == "dense-flags")
    seen = _run_lm_example(LM_ARGS + LM_MODES[mode] + ["--out",
                                                       str(tmp_path)],
                           params)
    assert len(seen) == 3
    want = _jax_lm_losses(mode, model, params,
                          [(x, y) for x, y, _ in seen])
    np.testing.assert_allclose([s[2] for s in seen], want, rtol=1e-5)


_LM_PARALLEL_WORKER = r"""
import os, sys
from chainermn_torch.examples import train_lm
train_lm.main(sys.argv[1:])
print(f"RANK{os.environ['RANK']} OK", flush=True)
"""

LM_PARALLEL_ARGS = ["--device", "cpu", "--n-train", "32", "--batchsize",
                    "4", "--iterations", "2", "--seq-len", "16", "--vocab",
                    "32", "--d-model", "32", "--n-heads", "4"]


@pytest.mark.parametrize("flags,error,match", [
    (["--zero", "3", "--moe", "2"], None, None),
    (["--fsdp-scan"], SystemExit, "vocab % 128"),
    (["--moe", "2", "--moe-top-k", "2"], None, None),
    (["--ring"], None, "ring-attention"),
    (["--ring", "--seq-impl", "ulysses"], None, "ulysses-attention"),
    (["--ring", "--seq-impl", "ring_flash"], None, "ring_flash-attention"),
    (["--autotune-blocks"], NotImplementedError, "item 6"),
    (["--zero", "3", "--zero-bucket-kib", "64"], SystemExit,
     "applies to --zero 1/2 only"),
    (["--fsdp-scan", "--zero", "1"], SystemExit, "exclusive"),
    (["--fsdp-scan", "--vocab", "128", "--moe", "2"], SystemExit,
     "does not compose with --moe")],
    ids=["zero3", "fsdp-scan", "moe", "ring", "seq-impl", "seq-impl-flash",
         "autotune", "zero3-bucket", "fsdp-scan-zero", "fsdp-scan-moe"])
def test_train_lm_refuses_what_waits_for_later_slices(tmp_path, flags,
                                                       error, match):
    """JAX's own refusals exit with its messages (``--fsdp-scan`` on a
    vocabulary that is not a multiple of 128, or with ``--zero`` or
    ``--moe``); ``--autotune-blocks`` does not apply (item 6). The
    parallel flags that waited for their slice now run, on 2 CPU ranks:
    ``--moe`` (with ``--zero 3`` too, which the MoE branch takes first,
    as in JAX) and ``--ring`` with each ``--seq-impl``, which prints the
    trained weights' next-token accuracy."""
    from chainermn_torch.examples import train_lm

    if error is not None:
        with pytest.raises(error, match=match):
            train_lm.build_trainer(train_lm.parse_args(
                ["--device", "cpu", *flags]))
        return
    results = run_world(_LM_PARALLEL_WORKER, 2, timeout=120, args=[
        *LM_PARALLEL_ARGS, *flags, "--out", str(tmp_path)])
    assert_ranks_ok(results)
    out = results[0][1]
    final = [ln for ln in out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1, out[-2000:]
    loss = float(final[0].split("loss=")[1].split()[0])
    assert np.isfinite(loss), final
    if match is not None:
        acc = [ln for ln in out.splitlines()
               if ln.startswith(match) and "next-token acc: " in ln]
        assert len(acc) == 1, out[-2000:]
        assert 0.0 <= float(acc[0].rsplit(" ", 1)[1]) <= 1.0


def test_train_lm_trains_from_a_bpe_text_file(tmp_path, capsys):
    """``--text-file`` with ``--bpe-vocab``: the file is tokenized, the
    vocabulary cached beside it, and 2 ZeRO-2 steps run to a finite
    loss."""
    from chainermn_torch.examples import train_lm

    text = tmp_path / "corpus.txt"
    text.write_text(" ".join(f"word{i % 37} tok{i % 11}."
                             for i in range(400)), encoding="utf-8")
    trainer = train_lm.main(
        ["--device", "cpu", "--text-file", str(text), "--bpe-vocab", "300",
         "--seq-len", "16", "--d-model", "32", "--n-heads", "4",
         "--batchsize", "4", "--iterations", "2", "--zero", "2",
         "--out", str(tmp_path / "out")])
    assert np.isfinite(trainer.observation["main/loss"])
    assert (tmp_path / "corpus.txt.bpe300.json").is_file()
    assert "BPE vocab" in capsys.readouterr().out
