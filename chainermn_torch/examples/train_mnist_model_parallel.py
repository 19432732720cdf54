"""Model-parallel MNIST through ``MultiNodeChainList`` (config #5): the
port's ``examples/model_parallel/train_mnist_model_parallel.py``.

The MLP 784 → unit → ... → 10 is cut into ``min(--stages, ranks)``
stages, stage s on rank s; the activations go from rank to rank through
the chain list's differentiable send/recv, and the output reaches every
rank, which computes the same loss and runs backward on it. Each rank
updates only its own stage, with Adam 1e-3 (optax's defaults). Every rank
draws the same batches (``SerialIterator``, seed 0) from the synthetic
MNIST set. One process per rank:

    python -m chainermn_torch.examples.train_mnist_model_parallel \\
        --device cpu                       # one rank: one stage
    torchrun --nproc-per-node 4 -m \\
        chainermn_torch.examples.train_mnist_model_parallel --device cpu
    torchrun --nproc-per-node 4 -m \\
        chainermn_torch.examples.train_mnist_model_parallel \\
        --communicator non_cuda_aware      # four ranks on one GPU

Rank 0 prints the loss every 8 iterations and, with ``--out``, writes
``log.json``: the losses, ms/step (the steps after the first) and the
host-staged bytes per step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import synthetic_mnist
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.links import MultiNodeChainList
from chainermn_torch.models.mlp import flax_dense
from chainermn_torch.resilience.supervisor import main_exit_code


class Block(nn.Module):
    """Flatten → Dense (flax's init) → ReLU unless last: the JAX
    example's ``Block``."""

    def __init__(self, n_in: int, feat: int, act: bool = True):
        super().__init__()
        self.dense = flax_dense(n_in, feat)
        self.act = act

    def forward(self, x):
        x = self.dense(x.reshape(x.shape[0], -1))
        return F.relu(x) if self.act else x


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="chainermn_torch example: model-parallel MNIST")
    p.add_argument("--batchsize", "-b", type=int, default=256)
    p.add_argument("--epoch", "-e", type=int, default=2)
    p.add_argument("--unit", "-u", type=int, default=200)
    p.add_argument("--stages", type=int, default=4)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--communicator", default="pure_nccl")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (gloo)")
    p.add_argument("--out", default=None,
                   help="directory for rank 0's log.json")
    return p.parse_args(argv)


def adam(params):
    """The example's optimizer: optax.adam(1e-3) (eps added after the
    square root, as torch's)."""
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def stage_blocks(n_stages: int, unit: int):
    """The stages' modules, drawn from ``torch.manual_seed(0)`` on every
    rank (so a stage's parameters do not depend on the world size's
    placement); the unsplit model is these blocks in order."""
    torch.manual_seed(0)
    return [Block(784 if s == 0 else unit,
                  10 if s == n_stages - 1 else unit,
                  act=s != n_stages - 1) for s in range(n_stages)]


def build(args):
    """``(comm, chain, optimizer, iterator)``; the optimizer is None on a
    rank that owns no stage."""
    comm = create_communicator(args.communicator, device=args.device)
    n_stages = min(args.stages, comm.size)
    if comm.is_master:
        print(f"ranks: {comm.size}  pipeline stages: {n_stages}  device: "
              f"{comm.device}", flush=True)
    chain = MultiNodeChainList(comm)
    for s, block in enumerate(stage_blocks(n_stages, args.unit)):
        last = s == n_stages - 1
        chain.add_link(block, rank=s, rank_in=None if s == 0 else s - 1,
                       rank_out=None if last else s + 1)
    chain.to(comm.device)
    params = list(chain.parameters())
    opt = adam(params) if params else None
    it = SerialIterator(synthetic_mnist(args.n_train, seed=0),
                        args.batchsize, shuffle=True, seed=0)
    return comm, chain, opt, it


def batch_arrays(batch, device):
    x = torch.from_numpy(np.stack([b[0] for b in batch])).to(device)
    y = torch.from_numpy(np.stack([b[1] for b in batch]).astype(
        np.int64)).to(device)
    return x, y


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(comm, chain, opt, it, epochs: int):
    """The training loop; returns ``(losses, seconds)``: every rank holds
    the same losses, and the seconds are those of the steps after the
    first (which also sets up the links and the libraries)."""
    losses = []
    t0 = None
    while it.epoch < epochs:
        x, y = batch_arrays(it.next(), comm.device)
        loss = F.cross_entropy(chain(x), y)
        if opt is not None:
            opt.zero_grad()
        if loss.requires_grad:
            loss.backward()
        if opt is not None:
            opt.step()
        losses.append(loss.detach())
        if t0 is None:
            _sync(comm.device)
            t0 = time.perf_counter()
        if comm.is_master and len(losses) % 8 == 0:
            print(f"epoch {it.epoch} iter {len(losses)} loss "
                  f"{float(losses[-1]):.4f}", flush=True)
    _sync(comm.device)
    secs = time.perf_counter() - t0
    return [float(v) for v in losses], secs


def main(argv=None):
    args = parse_args(argv)
    comm, chain, opt, it = build(args)
    try:
        losses, secs = train(comm, chain, opt, it, args.epoch)
        staged = comm.staged_bytes
        comm.barrier()
        if comm.is_master:
            print(f"final loss: {losses[-1]:.4f}", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, "log.json"), "w") as f:
                    json.dump({"losses": losses,
                               "ms_per_step":
                                   secs / max(1, len(losses) - 1) * 1e3,
                               "staged_bytes_per_step":
                                   staged / len(losses),
                               "ranks": comm.size,
                               "stages": min(args.stages, comm.size)}, f)
    finally:
        comm.finalize()
    return losses


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
