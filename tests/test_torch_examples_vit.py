"""The port's ImageNet example with the ViT (``--model vit``) on the
CPU: its first steps against the JAX example's on one and two ranks, with
the large-batch optimizers, and a snapshot and resume that reproduce the
uninterrupted run (tolerances beside them).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax

import chainermn_tpu
from chainermn_torch.datasets import split_indices
from chainermn_torch.examples import train_imagenet
from chainermn_torch.iterators import SerialIterator
from tests.test_torch_mp import assert_ranks_ok, run_world


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
from tests.test_torch_examples_vit import _run_vit_example

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
