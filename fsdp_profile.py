#!/usr/bin/env python3
"""Where an FSDP step of the 135M LM spends its time, on one GPU.

    python3 fsdp_profile.py [--steps N]

Builds ``chip_smoke.py``'s 135M TransformerLM (bf16 over f32 parameters,
seq 2048, batch 4, the fused loss), shards it through
``make_fsdp_train_step`` on a one-rank NCCL communicator (AdamW 3e-4),
times 3 steps after 3 warm-up steps, then traces ``--steps`` steps with
``torch.profiler`` (CPU and CUDA) and prints the ops by self host time
and by self device time, each table with the host and device totals. Prints the card's
name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fsdp_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import make_fsdp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    toks = cs.train_tokens(0)
    x = torch.as_tensor(toks[:, :-1], device="cuda").long()
    y = torch.as_tensor(toks[:, 1:], device="cuda").long()
    comm = create_communicator("pure_nccl")
    try:
        model = cs.build_model(0, torch.bfloat16, "flash")
        step, _ = make_fsdp_train_step(
            model, lambda ps: torch.optim.AdamW(ps, lr=3e-4,
                                                weight_decay=1e-4),
            comm, loss_fn=fused_lm_loss)
        for _ in range(3):
            # dlint: disable=DL104 — warm-up, synced after it
            step(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            # dlint: disable=DL104 — timed loop, synced once after it
            step(x, y)
        torch.cuda.synchronize()
        print(f"fsdp step: {(time.perf_counter() - t0) / 3 * 1e3:.3f} "
              "ms/step over 3 steps", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                # dlint: disable=DL104 — profiled loop, synced once after it
                step(x, y)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        dev_key = ("self_device_time_total"
                   if hasattr(ka[0], "self_device_time_total")
                   else "self_cuda_time_total")
        print(ka.table(sort_by="self_cpu_time_total", row_limit=25),
              flush=True)
        print(ka.table(sort_by=dev_key, row_limit=15), flush=True)
    finally:
        comm.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
