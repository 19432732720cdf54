"""An f64 oracle for the LAMB-under-FSDP bound of the four-card test.

``tests/test_torch_nccl.py``'s ``fsdp-lamb`` case lets one element in a
thousand of a parameter differ from the one-rank reference (every batch
on one rank) by up to 2 lr a step, after a first four-card run left one
``ln_f.bias`` element 1.84e-6 off. This script checks the gradient that
bound rests on: at the reference's parameters before each of the case's
two LAMB steps, each rank's f32 gradient of ``ln_f.bias`` on its own
batch, their mean as the step reduces it (a NCCL f32 sum, times 1/N),
the same per-rank gradients summed in f64 (the oracle), and the
reference's own f32 gradient on all the batches at once. It prints, for
each step, the largest difference of the four-rank mean and of the
reference from the oracle, over the 64 elements and relative to the
largest gradient.

Run on four GPUs: ``python3 fsdp_lamb_oracle.py`` starts its four NCCL
ranks itself (a free localhost port) and prints rank 0's lines, the
card's name and power limit first (``WORLD_DEVICE=cpu`` runs it as a
gloo world on the CPU).
"""

import os
import socket
import subprocess
import sys

# the case's shapes (tests/test_torch_nccl.py): seeds, widths, LAMB
STEPS, B, L, V, N = 2, 2, 64, 256, 4
LR, WD = 1e-2, 1e-4


def _launch() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, WORLD_SIZE=str(N), LOCAL_WORLD_SIZE=str(N),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=here)
    if os.environ.get("WORLD_DEVICE") != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout
        print(f"cards: {card.strip()}", flush=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(N)]
    outs = []
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(outs[0], flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        print(f"rank {r} exited {procs[r].returncode}:\n{outs[r][-3000:]}",
              flush=True)
    return 1 if bad else 0


def _rank() -> None:
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models.transformer import (TransformerLM,
                                                    lm_loss_with_aux)
    from chainermn_torch.optimizers import LAMB

    torch.backends.cuda.matmul.allow_tf32 = False
    # WORLD_DEVICE=cpu: a gloo world on the CPU, to try the script
    comm = create_communicator("pure_nccl",
                               device=os.environ.get("WORLD_DEVICE"))
    r, dev, n = comm.rank, comm.device, comm.size
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, V, (STEPS, n, B, L + 1), generator=g).to(dev)

    def lm():
        torch.manual_seed(0)
        return TransformerLM(vocab=V, d_model=64, n_heads=4, n_layers=2,
                             d_ff=128, max_len=L, device=dev)

    ref, mine = lm(), lm()
    opt = LAMB(ref.parameters(), LR, weight_decay=WD)
    for s in range(STEPS):
        # this rank's gradient at the reference's parameters
        mine.load_state_dict(ref.state_dict())
        mine.zero_grad()
        lm_loss_with_aux(mine, toks[s, r, :, :-1], toks[s, r, :, 1:])[
            0].backward()
        gr = dict(mine.named_parameters())["ln_f.bias"].grad.detach()
        mean32 = comm.allreduce(gr.clone(), "sum") * (1.0 / n)
        every = comm.allgather(gr)                       # [n, 64] f32
        oracle = every.double().sum(0) / n
        # the reference: every batch on one rank, one f32 backward
        x = toks[s, ..., :-1].reshape(n * B, L)
        y = toks[s, ..., 1:].reshape(n * B, L)
        opt.zero_grad()
        lm_loss_with_aux(ref, x, y)[0].backward()
        ref32 = dict(ref.named_parameters())["ln_f.bias"].grad.detach()
        scale = oracle.abs().max().item()
        e_mean = (mean32.double() - oracle).abs()
        e_ref = (ref32.double() - oracle).abs()
        small = oracle.abs().argmin().item()
        if r == 0:
            print(f"step {s}: ln_f.bias gradient, largest |g| {scale:.4e}; "
                  f"4-rank f32 mean vs the f64 sum: max {e_mean.max():.3e} "
                  f"({e_mean.max() / scale:.2e} of the largest), reference "
                  f"(one rank, all batches) vs the f64 sum: max "
                  f"{e_ref.max():.3e} ({e_ref.max() / scale:.2e}); smallest "
                  f"|g| {oracle[small].abs():.3e} at element {small}: mean "
                  f"off by {e_mean[small]:.3e}, reference by "
                  f"{e_ref[small]:.3e}", flush=True)
        opt.step()
    comm.barrier()
    comm.finalize()


if __name__ == "__main__":
    if "RANK" not in os.environ:
        sys.exit(_launch())
    _rank()
