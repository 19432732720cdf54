"""Data-parallel ImageNet ResNet-50 or ViT: the port's
``examples/imagenet/train_imagenet.py`` (config #2, the throughput
configuration, and its ``--model vit``).

The reference's flow: one process per GPU, the ``pure_nccl``
communicator with bf16 gradients on the wire
(``allreduce_grad_dtype=torch.bfloat16``, the reference's fp16 analog),
``ResNet50`` in bf16 compute over f32 parameters and batch statistics,
``make_data_parallel_train_step(mutable=("batch_stats",))``, SGD with
Nesterov momentum 0.9 (optax's nesterov trace: the same updates), or with
``--optimizer lars|lamb`` the large-batch optimizers to optax's rules
(``LARS(lr, weight_decay=1e-4, momentum=0.9)``, ``LAMB(lr,
weight_decay=1e-4)``, :mod:`chainermn_torch.optimizers.large_batch`)
and, with ``--warmup-epochs``, optax's ``warmup_cosine_decay_schedule``
evaluated at each update's count. ``--batchsize`` is each rank's batch (the JAX
script's is global, 64 per device by default).

``--model vit`` trains the JAX example's ``ViT(num_classes=1000,
dtype=bf16)`` instead: ViT-S/16 (d_model 384, 12 layers, 6 heads, d_ff
1536, ``pool="gap"``) with no batch statistics (``mutable=None``); its
attention runs the non-causal flash kernels. ``--dropout RATE`` (the
port's; the JAX example's ViT has none) builds the model with that
dropout and the step with ``with_rng=True``, keyed by the iteration, so a
resumed run draws the masks the uninterrupted run would have.

``--snapshot-every N`` snapshots every N iterations through
``create_multi_node_checkpointer("imagenet", comm, path=--out,
async_write=True)`` (and in an emergency: preemption or an exception
leaving the loop); ``--resume`` restores the newest snapshot every rank
holds (model, optimizer with its momentum and learning-rate schedule,
iterator position, iteration) before training on to the stop trigger.
The throughput line counts only this run's iterations.

Inputs, one of:

* default: synthetic ImageNet-shaped float32 arrays in memory
  (:func:`synthetic_imagenet`, the JAX example's), through
  ``scatter_dataset`` and ``SerialIterator``;
* ``--data-dir DIR``: a folder of JPEG files (``DIR/<class>/*.jpg``),
  decoded per access by ``ImageFolderDataset`` on rank 0 and scattered;
* ``--loader``: a file-backed uint8 set (``<PREFIX>_x.npy`` uint8 [N, H,
  W, 3] and ``<PREFIX>_y.npy`` int32, from ``--data-file`` or written
  under ``--out``), memory-mapped; each rank takes its contiguous shard,
  the native ``PrefetchingLoader`` gathers batches off-thread into
  page-locked memory, they reach the GPU by asynchronous copies, and the
  uint8 → bf16 decode runs on the device inside the loss.

    python -m chainermn_torch.examples.train_imagenet --iterations 20
    python -m chainermn_torch.examples.train_imagenet --loader \\
        --iterations 8 --batchsize 256
    python -m chainermn_torch.examples.train_imagenet --device cpu \\
        --image-size 64 --n-train 64 --batchsize 8 --iterations 2
    python -m chainermn_torch.examples.train_imagenet --model vit \\
        --iterations 20 --snapshot-every 10
    python -m chainermn_torch.examples.train_imagenet --optimizer lars \\
        --warmup-epochs 1 --iterations 20
    python -m chainermn_torch.examples.train_imagenet --model vit \\
        --iterations 40 --snapshot-every 10 --resume
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_imagenet \\
        --device cpu --image-size 64 --n-train 64 --batchsize 4 \\
        --iterations 2
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import (ArrayDataset, ImageFolderDataset,
                                      scatter_dataset)
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.resnet import ResNet50
from chainermn_torch.models.vit import ViT
from chainermn_torch.ops.dropout import fold_in
from chainermn_torch.optimizers import (LAMB, LARS,
                                        create_multi_node_optimizer)
from chainermn_torch.resilience.supervisor import main_exit_code
from chainermn_torch.training import (LogReport, PrintReport,
                                      StandardUpdater, Trainer,
                                      classifier_loss,
                                      make_data_parallel_train_step)
from chainermn_torch.training.loader import PrefetchingLoader
from chainermn_torch.training.trainer import default_converter


def synthetic_imagenet(n: int, image_size: int, n_classes: int = 1000,
                       seed: int = 0) -> ArrayDataset:
    """The JAX example's synthetic set: 32 prototypes from
    ``RandomState(99)`` plus noise, float32 NHWC, int32 labels."""
    protos = np.random.RandomState(99).rand(
        32, image_size, image_size, 3).astype(np.float32)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, n_classes, size=n).astype(np.int32)
    xs = protos[ys % 32] + 0.25 * rng.randn(
        n, image_size, image_size, 3).astype(np.float32)
    return ArrayDataset(xs.astype(np.float32), ys)


def warmup_cosine_lr(peak: float, warmup_steps: int, decay_steps: int):
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps)`` as a function of the update count (0 for the first
    update): linear from 0 to ``peak`` over ``warmup_steps``, then a
    cosine to 0 over the remaining ``decay_steps - warmup_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        span = decay_steps - warmup_steps
        t = min(count - warmup_steps, span)
        return peak * 0.5 * (1 + math.cos(math.pi * t / span))

    return lr


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_torch example: "
                                            "ImageNet")
    p.add_argument("--batchsize", "-B", type=int, default=64,
                   help="batch size of each rank")
    p.add_argument("--epoch", "-E", type=int, default=1)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after N iterations instead of epochs")
    p.add_argument("--communicator", type=str, default="pure_nccl")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optimizer", choices=["sgd", "lars", "lamb"],
                   default="sgd",
                   help="lars/lamb: large-batch recipes (layerwise trust "
                        "ratios)")
    p.add_argument("--warmup-epochs", type=float, default=0.0,
                   help="linear LR warmup epochs (then cosine decay)")
    p.add_argument("--model", choices=["resnet50", "vit"],
                   default="resnet50",
                   help="vit: the patch-16 Vision Transformer (ViT-S/16) "
                        "on the flash-attention kernels")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="with --model vit: dropout rate (the step then "
                        "takes dropout keys)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--data-dir", default=None, metavar="DIR",
                   help="train from a folder-of-JPEG dataset "
                        "(DIR/<class>/*.jpg, decoded per access)")
    p.add_argument("--loader", action="store_true",
                   help="feed batches through the native prefetch loader "
                        "from a file-backed uint8 set, decoded on the "
                        "device")
    p.add_argument("--data-file", default=None, metavar="PREFIX",
                   help="with --loader: an existing <PREFIX>_x.npy (uint8 "
                        "N,H,W,3) + <PREFIX>_y.npy (int32 N) pair. "
                        "Default: a synthetic pair written under --out")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--snapshot-every", type=int, default=0,
                   metavar="ITERS",
                   help="checkpoint every N iterations (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest complete snapshot")
    p.add_argument("--out", "-o", default="result")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    return p.parse_args(argv)


def _refuse_later_slices(args) -> None:
    if args.dropout and args.model != "vit":
        raise ValueError("--dropout applies to --model vit")


def _uint8_shard(args, comm):
    """This rank's contiguous shard of the memory-mapped uint8 set,
    written by rank 0 first when no ``--data-file`` was given."""
    base = args.data_file or os.path.join(args.out, "synthetic_u8")
    xpath, ypath = base + "_x.npy", base + "_y.npy"
    if args.data_file and not (os.path.exists(xpath)
                               and os.path.exists(ypath)):
        raise FileNotFoundError(
            f"--data-file: {xpath} / {ypath} not found (expected an "
            "existing uint8/int32 .npy pair; omit --data-file to generate "
            "synthetic data)")
    if comm.rank == 0 and not os.path.exists(xpath):
        os.makedirs(os.path.dirname(xpath) or ".", exist_ok=True)
        rs = np.random.RandomState(0)
        np.save(xpath, rs.randint(
            0, 256, (args.n_train, args.image_size, args.image_size, 3),
            dtype=np.uint8))
        np.save(ypath, rs.randint(0, 1000, size=args.n_train)
                .astype(np.int32))
    comm.bcast_obj(None)   # every rank waits for rank 0's files
    xs = np.load(xpath, mmap_mode="r")
    ys = np.load(ypath, mmap_mode="r")
    shard = len(xs) // comm.size
    lo = comm.rank * shard
    return xs[lo:lo + shard], ys[lo:lo + shard], shard * comm.size


def make_optimizer(args, params, comm, steps_per_epoch: int):
    """``--optimizer sgd``: SGD with Nesterov momentum 0.9 behind the
    multi-node wrapper (``lars``: ``LARS(lr, weight_decay=1e-4,
    momentum=0.9)``; ``lamb``: ``LAMB(lr, weight_decay=1e-4)``, the JAX
    example's optax calls); with ``--warmup-epochs`` its learning rate follows
    :func:`warmup_cosine_lr` over ``--epoch`` epochs, one schedule step
    per update (inside the optimizer: an every-iteration trainer
    extension would read the metrics, a host synchronisation, every
    step)."""
    inner = {
        "sgd": lambda: torch.optim.SGD(params, lr=args.lr, momentum=0.9,
                                       nesterov=True),
        "lars": lambda: LARS(params, lr=args.lr, weight_decay=1e-4,
                             momentum=0.9),
        "lamb": lambda: LAMB(params, lr=args.lr, weight_decay=1e-4),
    }[args.optimizer]()
    opt = create_multi_node_optimizer(inner, comm)
    if args.warmup_epochs > 0:
        lr = warmup_cosine_lr(args.lr,
                              int(steps_per_epoch * args.warmup_epochs),
                              max(steps_per_epoch * args.epoch, 1))
        # attached to the multi-node optimizer: its state rides snapshots
        opt.add_schedule(torch.optim.lr_scheduler.LambdaLR(
            inner, lambda count: lr(count) / args.lr))
    return opt


def build_trainer(args):
    """Everything up to ``trainer.run()``: ``(trainer, model)``; the
    communicator is ``trainer.updater.comm``."""
    _refuse_later_slices(args)
    comm = create_communicator(args.communicator,
                               allreduce_grad_dtype=torch.bfloat16,
                               device=args.device)
    dtype = getattr(torch, args.dtype)
    if comm.device.type == "cuda":
        # fixed shapes: let cuDNN time its algorithms once; f32 in f32
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    global_batch = args.batchsize * comm.size
    if comm.is_master:
        print(f"ranks: {comm.size}  global batch: {global_batch}  dtype: "
              f"{args.dtype}  device: {comm.device}", flush=True)

    n_classes = 1000
    if args.loader:
        xs, ys, train_len = _uint8_shard(args, comm)
        it = PrefetchingLoader(xs, ys, args.batchsize, shuffle=True, seed=0,
                               device=comm.device)
    else:
        if args.data_dir:
            train = None
            if comm.rank == 0:   # root-only build; samples ship as payloads
                train = ImageFolderDataset(args.data_dir,
                                           image_size=args.image_size,
                                           train=True)
                n_classes = len(train.classes)
            n_classes = comm.bcast_obj(n_classes)
            train = scatter_dataset(train, comm, shuffle=True, seed=0,
                                    shared_storage=False)
        else:
            train = scatter_dataset(
                synthetic_imagenet(args.n_train, args.image_size), comm,
                shuffle=True, seed=0)
        train_len = len(train) * comm.size
        it = SerialIterator(train, args.batchsize, shuffle=True, seed=0)

    torch.manual_seed(0)
    if args.model == "vit":
        model = ViT(num_classes=n_classes, image_size=args.image_size,
                    dtype=dtype, dropout_rate=args.dropout,
                    device=comm.device)
        mutable = None
    else:
        model = ResNet50(num_classes=n_classes, dtype=dtype,
                         device=comm.device)
        mutable = ("batch_stats",)
    comm.bcast_data(model)
    optimizer = make_optimizer(args, model.parameters(), comm,
                               max(1, train_len // global_batch))

    loss_fn, converter = None, default_converter
    if args.loader:
        def loss_fn(model, x, y, train=True, mutable=None, rng=None):
            # on-device decode: the loader ships raw uint8 rows (255 is
            # exact in bf16; the quotient rounds to dtype, as JAX's does)
            return classifier_loss(model, x.to(dtype) / 255.0, y,
                                   train=train, mutable=mutable, rng=rng)

        def converter(batch):   # the loader's batch is already arrays
            return batch

    with_rng = args.dropout > 0
    step = make_data_parallel_train_step(model, optimizer, comm,
                                         loss_fn=loss_fn, mutable=mutable,
                                         with_rng=with_rng)
    if with_rng:
        keyed = step

        def step(x, y):
            # the iteration keys the masks: a resumed run draws the
            # uninterrupted run's
            return keyed(x, y, fold_in(0, updater.iteration))

    updater = StandardUpdater(it, step, comm, converter=converter,
                              model=model, optimizer=optimizer)
    checkpointer = None
    if args.snapshot_every or args.resume:
        checkpointer = create_multi_node_checkpointer(
            "imagenet", comm, path=args.out, async_write=True)
    if args.resume:
        restored = checkpointer.resume(updater)
        if comm.is_master and restored is not None:
            print(f"resumed from iteration {restored}", flush=True)
    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = Trainer(updater, stop_trigger=stop, out=args.out)
    if checkpointer is not None and args.snapshot_every:
        trainer.extend(checkpointer, trigger=(args.snapshot_every,
                                              "iteration"))
    if comm.is_master:
        trainer.extend(LogReport(os.path.join(args.out, "imagenet.jsonl")),
                       trigger=(10, "iteration"))
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "elapsed_time"]), trigger=(10, "iteration"))
    return trainer, model


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer, _ = build_trainer(args)
    comm = trainer.updater.comm
    start = trainer.updater.iteration   # the restored one after --resume
    try:
        trainer.run()
        if comm.is_master and not trainer.preempted:
            obs = trainer.observation
            # only this run's iterations count
            ips = ((obs["iteration"] - start) * args.batchsize * comm.size
                   / obs["elapsed_time"])
            print(f"throughput: {ips:.1f} images/sec "
                  f"({ips / comm.size:.1f} /chip)", flush=True)
    finally:
        if isinstance(trainer.updater.iterator, PrefetchingLoader):
            trainer.updater.iterator.close()
        comm.finalize()
    return trainer


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
