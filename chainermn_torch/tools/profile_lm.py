#!/usr/bin/env python
"""profile_lm — the LM train step's device profile and roofline.

Counterpart of the JAX package's ``tools/profile_lm.py``. It builds that
script's program with the port's kernels: the TransformerLM at d 768, 12
layers, L 2048, rope, flash attention, bf16 compute, AdamW 3e-4, four
steps a dispatch (``scan_steps=4``), with ``PROFILE_BATCH`` (default 8),
``PROFILE_LOSS`` (``unfused`` by default; ``fused`` runs the fused LM
head and CE kernels) and ``PROFILE_QKV_LAYOUT`` as there (the port has
one layout: its kernels read q, k and v through strides, so ``bhld`` and
``blhd`` build the same program). Then:

1. the roofline from the FLOPs and bytes counted from the shapes
   (:func:`step_cost`: XLA's ``cost_analysis()`` has no counterpart), the
   way ``PERF.md`` counts its bounds, against the H100's published peaks
   (989 TFLOP/s bf16, 3.35 TB/s);
2. one warmed dispatch under ``torch.profiler``
   (:mod:`chainermn_torch.training.profiling`): device milliseconds by
   kernel family (``flash_fwd``, ``flash_bwd``, ``ce_fwd``, ``ce_dh``,
   ``ce_dw``, GEMM, elementwise, NCCL, other), the busy share of the
   dispatch's window, and the hand-written kernels' launch counts.

With ``PROFILE_LOSS=fused`` the dispatch launches ``flash_fwd``,
``flash_bwd``, ``ce_fwd``, ``ce_dh`` and ``ce_dw``. ``--device cpu`` and
the width flags run it small on the CPU (plain versions of the kernels,
no device numbers: the trace has no kernels there).

Usage: python -m chainermn_torch.tools.profile_lm [trace_dir]
           [--device cpu] [--d-model N] [--n-layers N] [--seq-len N]
           [--vocab N]

Prints one JSON object; with ``trace_dir`` the Chrome trace is written
there too.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

SCAN_K = 4
#: published peaks of one NVIDIA H100 SXM (dense bf16, HBM3) at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dir", nargs="?", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--vocab", type=int, default=32768)
    args = p.parse_args(argv)
    args.batch = int(os.environ.get("PROFILE_BATCH", "8"))
    args.loss = os.environ.get("PROFILE_LOSS", "unfused")
    args.qkv_layout = os.environ.get("PROFILE_QKV_LAYOUT", "blhd")
    if args.loss not in ("fused", "unfused"):
        raise SystemExit(f"PROFILE_LOSS must be fused or unfused, got "
                         f"{args.loss!r}")
    if args.qkv_layout not in ("blhd", "bhld"):
        raise SystemExit(f"PROFILE_QKV_LAYOUT must be blhd or bhld, got "
                         f"{args.qkv_layout!r}")
    return args


def step_cost(batch: int, seq: int, d: int, layers: int, vocab: int,
              n_params: int) -> dict:
    """FLOPs and HBM bytes of one train step, counted from the shapes.

    FLOPs: each matmul's forward ``2·m·n·k`` and its backward twice that
    (the blocks' q/k/v/o and FFN weights, 12·d² a layer, and the LM head),
    causal attention's two products over the visible half of the scores
    in the forward and its five in the backward (the flash kernels
    rebuild P). Bytes: the least the step must move, each input read once
    and each output written once: the f32 parameters and AdamW's two
    moments read and written, and the tokens."""
    tokens = batch * seq
    dense = 2.0 * tokens * (12 * d * d * layers + d * vocab)
    attn_fwd = 2 * 2.0 * batch * seq * seq * d / 2 * layers
    flops = 3 * dense + attn_fwd * (1 + 2.5)
    nbytes = 6 * 4.0 * n_params + 2 * 8.0 * tokens
    return {"flops": flops, "bytes": nbytes,
            "flops_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3}


def build_step(args):
    """The model, its data-parallel step and one dispatch's inputs."""
    import numpy as np
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models.transformer import (TransformerLM,
                                                    lm_loss_with_aux)
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    comm = create_communicator("pure_nccl", device=args.device)
    torch.manual_seed(0)
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model,
        n_heads=max(1, args.d_model // 64), n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=args.seq_len, pos_emb="rope",
        attention="flash", dtype=torch.bfloat16, device=comm.device)
    comm.bcast_data(model)
    # optax.adamw's defaults (decay 1e-4 on every leaf), not torch's
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        comm)
    lf = fused_lm_loss if args.loss == "fused" else lm_loss_with_aux
    step = make_data_parallel_train_step(model, opt, comm, loss_fn=lf,
                                         scan_steps=SCAN_K)
    toks = np.random.RandomState(0).randint(
        0, args.vocab, size=(args.batch, args.seq_len + 1))
    toks = torch.as_tensor(toks, device=comm.device)
    xs = toks[None, :, :-1].expand(SCAN_K, -1, -1).contiguous()
    ys = toks[None, :, 1:].expand(SCAN_K, -1, -1).contiguous()
    n_params = sum(p.numel() for p in model.parameters())
    return comm, step, xs, ys, n_params


def profile(args, warm: int = 3, timed: int = 6) -> dict:
    """Warm, time ``timed`` dispatches (one synchronise at the end), then
    trace one dispatch; returns the result dict (see the module doc)."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.training.profiling import (busy_share, capture,
                                                    family_ms,
                                                    kernel_events)

    comm, step, xs, ys, n_params = build_step(args)
    try:
        cuda = comm.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(comm.device)

        for _ in range(warm):
            # dlint: disable=DL104 — warm-up, synced after it
            step(xs, ys)
        sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            # dlint: disable=DL104 — timed loop, synced once after it
            m = step(xs, ys)
        sync()
        step_s = (time.perf_counter() - t0) / (timed * SCAN_K)
        before = _cuda.launches()
        with capture(comm.device) as rec:
            t0 = time.perf_counter()
            m = step(xs, ys)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v - before.get(k, 0)
                    for k, v in _cuda.launches().items()}
        loss = m["main/loss"][-1].item()
        events = kernel_events(rec["trace"])
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            with open(os.path.join(args.trace_dir, "profile_lm.json"),
                      "w") as f:
                json.dump(rec["trace"], f)
        cost = step_cost(args.batch, args.seq_len, args.d_model,
                         args.n_layers, args.vocab, n_params)
        fams = family_ms(events)
        device_ms = sum(fams.values())
        out = {
            "config": {"d_model": args.d_model, "n_layers": args.n_layers,
                       "seq_len": args.seq_len, "batch": args.batch,
                       "scan_k": SCAN_K, "loss": args.loss,
                       "qkv_layout": args.qkv_layout,
                       "n_params": n_params, "ranks": comm.size},
            "device": (torch.cuda.get_device_name(comm.device) if cuda
                       else "cpu"),
            "measured_step_s": step_s,
            "tokens_per_sec": args.batch * args.seq_len / step_s,
            "loss": loss,
            "flops_per_step": cost["flops"],
            "bytes_per_step": cost["bytes"],
            "roofline_flops_ms": cost["flops_ms"],
            "roofline_hbm_ms": cost["bytes_ms"],
            "dispatch_wall_ms": wall_ms,
            "device_ms_by_family": fams if cuda else None,
            "device_ms": device_ms if cuda else None,
            "busy_share": (busy_share(events, wall_ms * 1e3) if cuda
                           else None),
            # the traced device time over an unprofiled dispatch's wall
            # time (the profiler slows the host that feeds the card)
            "device_share_unprofiled": (
                device_ms / (step_s * SCAN_K * 1e3) if cuda else None),
            "launches": launches,
        }
        return out
    finally:
        comm.finalize()


def main(argv=None):
    print(json.dumps(profile(parse_args(argv)), indent=2), flush=True)


if __name__ == "__main__":
    main()
