"""CIFAR-100 ResNet with MultiNodeBatchNormalization: the port's
``examples/cifar/train_cifar.py`` (config #3).

Every batch norm's statistics span all ranks (the reference's
MultiNodeBatchNormalization path) because the communicator goes into the
model; ``--no-multi-node-bn`` keeps them per rank. The flow: create the
communicator → rank 0 parses CIFAR-100 binary batches (``load_cifar``)
→ ``scatter_dataset`` → ``bcast_data`` of the model →
``create_multi_node_optimizer`` (SGD with momentum 0.9) →
``make_data_parallel_train_step(mutable=("batch_stats",))`` →
``SerialIterator`` → ``StandardUpdater`` → ``Trainer`` with
``LogReport`` / ``PrintReport`` on rank 0 → ``main_exit_code``. One
process per GPU; ``--batchsize`` is each rank's batch.

Without ``--data-dir`` rank 0 writes synthetic CIFAR-100 binary batches
(``--n-train`` samples, the CIFAR example's generator) under ``--out``
and parses those: the input path is always the binary-batch parser, and
nothing is downloaded.

The model computes in f32 and means it: on the GPU ``build_trainer``
turns TF32 off for cuDNN convolutions and cuBLAS products (torch lets
cuDNN use TF32 by default), as the JAX package computes f32 convolutions
in f32 on the CPU.

    python -m chainermn_torch.examples.train_cifar --epoch 3
    python -m chainermn_torch.examples.train_cifar --device cpu \\
        --depth 8 --n-train 512 --batchsize 32 --epoch 1
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_cifar \\
        --device cpu --depth 8 --n-train 512 --batchsize 32
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import (load_cifar, save_cifar,
                                      scatter_dataset, synth_cifar_uint8)
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.resnet import CifarResNet
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.resilience.supervisor import main_exit_code
from chainermn_torch.training import (LogReport, PrintReport,
                                      StandardUpdater, Trainer,
                                      make_data_parallel_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_torch example: "
                                            "CIFAR-100")
    p.add_argument("--batchsize", "-b", type=int, default=256,
                   help="batch size of each rank")
    p.add_argument("--epoch", "-e", type=int, default=3)
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--communicator", type=str, default="pure_nccl")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--no-multi-node-bn", action="store_true",
                   help="use per-replica batch-norm statistics instead")
    p.add_argument("--data-dir", default=None, metavar="DIR",
                   help="CIFAR binary-layout directory (train.bin for "
                        "CIFAR-100). Default: write synthetic binary "
                        "batches under --out and parse those")
    p.add_argument("--out", "-o", default="result")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    return p.parse_args(argv)


def _dataset(args, comm):
    """Rank 0 parses the binary batches (writing synthetic ones first when
    no directory was given); other ranks get None."""
    if comm.rank != 0:
        return None
    data_dir = args.data_dir
    if data_dir is None:
        data_dir = os.path.join(args.out, "cifar-data")
        if not os.path.exists(os.path.join(data_dir, "train.bin")):
            xs, ys = synth_cifar_uint8(args.n_train, 100, seed=0)
            save_cifar(data_dir, xs, ys, n_classes=100, train=True)
    return load_cifar(data_dir, n_classes=100, train=True)


def build_trainer(args):
    """Everything up to ``trainer.run()``: ``(trainer, model)``; the
    communicator is ``trainer.updater.comm``."""
    comm = create_communicator(args.communicator, device=args.device)
    if comm.device.type == "cuda":
        # f32 convolutions and products in f32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if comm.is_master:
        print(f"ranks: {comm.size}  device: {comm.device}  multi-node BN: "
              f"{not args.no_multi_node_bn}", flush=True)
    train = scatter_dataset(_dataset(args, comm), comm, shuffle=True,
                            seed=0, shared_storage=False)

    torch.manual_seed(0)
    model = CifarResNet(num_classes=100, depth=args.depth,
                        comm=None if args.no_multi_node_bn else comm,
                        device=comm.device)
    comm.bcast_data(model)
    # optax.sgd's trace starts at zero and torch's buffer at the first
    # gradient: the same updates
    optimizer = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9), comm)
    step = make_data_parallel_train_step(model, optimizer, comm,
                                         mutable=("batch_stats",))

    it = SerialIterator(train, args.batchsize, shuffle=True, seed=0)
    updater = StandardUpdater(it, step, comm)
    trainer = Trainer(updater, stop_trigger=(args.epoch, "epoch"),
                      out=args.out)
    if comm.is_master:  # reference convention: reporting on rank 0 only
        trainer.extend(LogReport(os.path.join(args.out, "cifar.jsonl")),
                       trigger=(1, "epoch"))
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "elapsed_time"]), trigger=(1, "epoch"))
    return trainer, model


def main(argv=None) -> Trainer:
    trainer, _ = build_trainer(parse_args(argv))
    comm = trainer.updater.comm
    try:
        trainer.run()
        # a preempted run has no final observation to print
        if comm.is_master and not trainer.preempted:
            obs = trainer.observation
            print(f"final: loss={obs['main/loss']:.4f} "
                  f"acc={obs['main/accuracy']:.4f}", flush=True)
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
