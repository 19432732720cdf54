"""Data-parallel MNIST MLP: the port's ``examples/mnist/train_mnist.py``.

The reference's flow (config #1): create the communicator → the root
parses MNIST IDX files → ``scatter_dataset`` → ``bcast_obj`` of the test
set → ``bcast_data`` of the parameters → ``create_multi_node_optimizer``
(Adam, with the ``--grad-reducer`` strategy and its ``--wire-format``)
→ ``make_data_parallel_train_step`` and ``make_eval_step`` →
``SerialIterator`` → ``StandardUpdater`` → ``Trainer`` with the multi-node
``Evaluator``, and ``ReductionReport`` / ``LogReport`` / ``PrintReport``
on rank 0 → ``main_exit_code``. One process per GPU; ``--batchsize`` is each rank's
batch.

Without ``--data-dir`` rank 0 writes synthetic MNIST-layout IDX files
(``--n-train`` train, 1024 test samples) under ``--out`` and parses those:
the input path is always the IDX parser, and nothing is downloaded.

    python -m chainermn_torch.examples.train_mnist --epoch 2
    python -m chainermn_torch.examples.train_mnist --device cpu
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_mnist \\
        --device cpu          # two ranks over gloo
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from chainermn_torch.collectives import make_grad_reducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import (load_mnist, save_mnist,
                                      scatter_dataset, synth_uint8)
from chainermn_torch.extensions import create_multi_node_evaluator
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.resilience.supervisor import main_exit_code
from chainermn_torch.training import (Evaluator, LogReport, PrintReport,
                                      ReductionReport, StandardUpdater,
                                      Trainer,
                                      make_data_parallel_train_step,
                                      make_eval_step)

#: samples of the synthetic test set written when no --data-dir is given
N_TEST = 1024


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_torch example: MNIST")
    p.add_argument("--batchsize", "-b", type=int, default=256,
                   help="batch size of each rank")
    p.add_argument("--epoch", "-e", type=int, default=3)
    p.add_argument("--unit", "-u", type=int, default=1000)
    p.add_argument("--communicator", type=str, default="pure_nccl")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--data-dir", default=None, metavar="DIR",
                   help="MNIST-layout directory (train-images-idx3-ubyte "
                        "etc., plain or .gz). Default: write synthetic IDX "
                        "files under --out and parse those")
    p.add_argument("--grad-reducer", default="flat",
                   choices=["flat", "hierarchical", "quantized", "auto"],
                   help="gradient-reduction strategy ('flat' is "
                        "allreduce_grad, bit for bit)")
    p.add_argument("--wire-format", default=None,
                   choices=["f32", "bf16", "int8", "int8-block",
                            "int4-block"],
                   help="wire format of the compressing reducers "
                        "('quantized', 'auto')")
    p.add_argument("--out", "-o", default="result")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    return p.parse_args(argv)


def _datasets(args, comm):
    """The root parses the IDX files (writing synthetic ones first when
    no directory was given); other ranks get None."""
    if comm.rank != 0:
        return None, None
    data_dir = args.data_dir
    if data_dir is None:
        data_dir = os.path.join(args.out, "mnist-data")
        if not os.path.exists(os.path.join(data_dir,
                                           "train-images-idx3-ubyte")):
            save_mnist(data_dir, *synth_uint8(args.n_train, seed=0),
                       train=True)
            save_mnist(data_dir, *synth_uint8(N_TEST, seed=1), train=False)
    return (load_mnist(data_dir, train=True),
            load_mnist(data_dir, train=False))


def build_trainer(args):
    """Everything up to ``trainer.run()``: ``(trainer, model)``; the
    communicator is ``trainer.updater.comm``."""
    comm = create_communicator(args.communicator, device=args.device)
    if comm.is_master:
        print(f"ranks: {comm.size}  device: {comm.device}", flush=True)
    train, test = _datasets(args, comm)
    train = scatter_dataset(train, comm, shuffle=True, seed=0,
                            shared_storage=False)
    test = comm.bcast_obj(test)

    torch.manual_seed(0)
    model = MLP(n_units=args.unit, n_out=10, device=comm.device)
    comm.bcast_data(model)
    wf = None if args.wire_format in (None, "f32") else args.wire_format
    reducer = make_grad_reducer(args.grad_reducer, comm, wire_format=wf)
    # optax.adam: eps added after the square root, eps_root 0
    optimizer = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8), comm,
        grad_reducer=reducer)
    step = make_data_parallel_train_step(model, optimizer, comm)
    eval_step = make_eval_step(model, comm)

    train_it = SerialIterator(train, args.batchsize, shuffle=True, seed=0)
    updater = StandardUpdater(train_it, step, comm)
    trainer = Trainer(updater, stop_trigger=(args.epoch, "epoch"),
                      out=args.out)
    evaluator = Evaluator(
        lambda: SerialIterator(test, args.batchsize, repeat=False,
                               shuffle=False),
        eval_step, updater)
    trainer.extend(create_multi_node_evaluator(evaluator, comm),
                   trigger=(1, "epoch"))
    if comm.is_master:  # reference convention: reporting on rank 0 only
        trainer.extend(ReductionReport(reducer, model), trigger=(1, "epoch"))
        trainer.extend(LogReport(os.path.join(args.out, "log.jsonl")),
                       trigger=(1, "epoch"))
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "validation/main/loss", "validation/main/accuracy",
             "elapsed_time"]), trigger=(1, "epoch"))
    return trainer, model


def main(argv=None) -> Trainer:
    trainer, _ = build_trainer(parse_args(argv))
    comm = trainer.updater.comm
    try:
        trainer.run()
        # a preempted run has no final observation to print
        if comm.is_master and not trainer.preempted:
            final = trainer.observation
            print(f"final: loss={final['main/loss']:.4f} "
                  f"val_acc={final['validation/main/accuracy']:.4f}",
                  flush=True)
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
