"""Model-parallel MNIST with eager differentiable send/recv: the port's
``examples/model_parallel/train_mnist_eager_p2p.py``.

Two ranks, the reference's define-by-run pattern: rank 0 runs the first
half (flatten → hidden, tanh) and ``eager_send``s the activation; rank 1
``eager_recv``s it, finishes the model (hidden → logits), computes the
loss, and its backward sends the activation's gradient back, which rank
0's backward of the send token receives. Both ranks draw the same batch
indices (``RandomState(7)``) and update their half by SGD. The receive
declares its shape and is anchored to rank 1's weights, as the JAX
package's eager functions require.

    python -m chainermn_torch.examples.train_mnist_eager_p2p --device cpu
        # without RANK/WORLD_SIZE it starts both ranks itself
    torchrun --nproc-per-node 2 -m \\
        chainermn_torch.examples.train_mnist_eager_p2p --device cpu
    python -m chainermn_torch.examples.train_mnist_eager_p2p \\
        --communicator non_cuda_aware      # both ranks on one GPU
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import synthetic_mnist
from chainermn_torch.functions import eager_recv, eager_send
from chainermn_torch.resilience.supervisor import main_exit_code


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="chainermn_torch example: eager send/recv MNIST")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batchsize", "-b", type=int, default=128)
    p.add_argument("--unit", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--communicator", default="pure_nccl")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (gloo)")
    return p.parse_args(argv)


def spawn(argv) -> int:
    """Start the two ranks as child processes on a free localhost port;
    a rank's failure is the run's."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, *argv],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))) for r in range(2)]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"ranks exited {rcs}")
    return 0


def worker(args):
    """One rank's loop; returns rank 1's losses (rank 0: [])."""
    comm = create_communicator(args.communicator, device=args.device)
    if comm.size != 2:
        raise SystemExit(f"this example runs on 2 ranks, not {comm.size}")
    dev, u, b = comm.device, args.unit, args.batchsize
    rs = np.random.RandomState(0)
    ds = synthetic_mnist(b * 8, seed=0)
    idx_rs = np.random.RandomState(7)      # the same stream on both ranks
    losses = []
    try:
        if comm.rank == 0:
            w = torch.tensor(rs.randn(784, u) * 0.05, dtype=torch.float32,
                             device=dev, requires_grad=True)
            for _ in range(args.steps):
                idx = idx_rs.randint(0, len(ds), b)
                x = torch.from_numpy(np.stack([ds[i][0] for i in idx])).to(
                    dev)
                hid = torch.tanh(x.reshape(b, -1) @ w)
                eager_send(hid, comm, rank=1).backward()
                with torch.no_grad():
                    w -= args.lr * w.grad
                w.grad = None
            print("rank 0 done (first half trained via transported "
                  "grads)", flush=True)
        else:
            w = torch.tensor(rs.randn(u, 10) * 0.05, dtype=torch.float32,
                             device=dev, requires_grad=True)
            for step in range(args.steps):
                idx = idx_rs.randint(0, len(ds), b)
                y = torch.from_numpy(np.stack([ds[i][1] for i in idx]).astype(
                    np.int64)).to(dev)
                hid = eager_recv(comm, 0, shape=(b, u), dtype=torch.float32,
                                 anchor=w)
                loss = torch.nn.functional.cross_entropy(hid @ w, y)
                loss.backward()
                with torch.no_grad():
                    w -= args.lr * w.grad
                w.grad = None
                losses.append(loss.item())
                if step % 10 == 0 or step == args.steps - 1:
                    print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
            if not losses[-1] < 2.0:
                raise RuntimeError(f"did not learn: {losses[-1]}")
            print("rank 1 done", flush=True)
        comm.barrier()
    finally:
        comm.finalize()
    return losses


def main(argv=None):
    args = parse_args(argv)
    if "RANK" not in os.environ:
        return spawn(sys.argv[1:] if argv is None else list(argv))
    return worker(args)


if __name__ == "__main__":
    sys.exit(main_exit_code(main))
