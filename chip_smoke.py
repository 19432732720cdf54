#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Phases, each printed on its own line; any failure exits non-zero before
the final line:

1. card — ``nvidia-smi`` name and power limit;
2. build — every CUDA kernel of the port from ``chainermn_torch/csrc``,
   one ``nvcc`` per source, all started together; then the tensor-core
   instructions in the SASS of the two flash libraries and of the fused
   CE (``HMMA``, from mma.sync, none of which may be 0; ``HGMMA``, from
   wgmma, which the fused CE's forward must have), and ptxas's registers
   and spill bytes of the main path's tensor-core kernels (flash at d 64,
   the bf16 CE forward, the bf16 CE backward at D 768); the two flash
   sources are also built with those kernels' register caps lifted, and
   the fused CE with its backward's other row layout (``CE_LAYOUT``);
3. kernels — each kernel (flash_fwd, flash_bwd, and the fused CE's
   ce_fwd, ce_dh, ce_dw) against its plain PyTorch version on the card at
   the main path's shape and in the edge cases (bf16 and f32; for the CE
   forward one row, V under one tile, ties across its vocabulary ranges
   and D 1544; a second CE call must give the same bits), then timed
   beside the plain version, its bound and the PyTorch call that computes
   the same function (a yardstick only, the port never calls it; SDPA is
   first held against the plain versions): flash at the serving and
   training shapes and at the split backward's cases (a window; causal
   Lq != Lk); ce_fwd with its vocabulary ranges, grid and the bytes its
   TMA boxes move into shared memory; ce_dh + ce_dw together beside the
   one backward call of the yardstick (``pair`` line); then the two flash
   kernels with their register caps lifted, and the CE backward in its
   other row layout, each timed beside the shipped build;
4. slice — the port's ``Engine`` serves 16 greedy requests with the
   135M TransformerLM at full width (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, rope, bf16) and random weights from
   ``--seed``; launch counts are zeroed just before and read just after,
   and two streams are checked against an f32 full forward with plain
   attention on the card;
5. train — the same LM (f32 parameters, bf16 compute) trains through
   ``create_communicator("pure_nccl")`` (one rank, NCCL),
   ``create_multi_node_optimizer(AdamW(3e-4))`` and
   ``make_data_parallel_train_step(loss_fn=fused_lm_loss,
   scan_steps=4)`` at seq_len 2048, batch 4: one step's loss and
   gradients on the kernel path are first held against the f32 plain
   path (reference attention, unfused loss), then 3 warm-up and 3 timed
   calls run with launch counts zeroed just before and read just after
   (12 flash_fwd, 12 flash_bwd and one each of ce_fwd, ce_dh, ce_dw per
   step), the losses must be finite and fall;
6. mnist — the port's MNIST example (``chainermn_torch.examples.
   train_mnist``, config #1: communicator ``naive``, IDX files,
   ``scatter_dataset``, Adam, ``Trainer`` with the multi-node evaluator
   and rank-0 reports) trains the MLP at full width (784-1000-1000-10,
   batch 256) for 2 epochs of 60,000 synthetic samples, one NCCL rank:
   its first 8 losses must match the same steps on the CPU, validation
   accuracy must pass 0.9, the loss must fall, and the MLP path must
   launch no hand-written kernel (counts zeroed just before, read just
   after);
7. cifar — config #3 through the port's CIFAR example
   (``chainermn_torch.examples.train_cifar``: CifarResNet-20 with
   cross-replica batch norm over a one-rank NCCL group, CIFAR-100 binary
   batches, per-rank batch 256, f32 with TF32 off, SGD 0.05 momentum 0.9,
   ``Trainer``) for 3 epochs of 50,000 synthetic samples: its first 8
   losses must match the same steps on the CPU, the loss must fall, the
   final training accuracy must pass 0.9, and no hand-written kernel may
   launch;
8. resnet50 — config #2, ``bench.py``'s gated row through the port's
   step (ResNet-50 bf16 with the space-to-depth stem, batch 256 at 224²,
   SGD 0.1 momentum 0.9, ``mutable=("batch_stats",)``, ``scan_steps=8``,
   3 warm-up and 4 timed calls on one seeded batch): first 2 steps at
   batch 8 on the card held to the CPU, then images/s per chip, ms/step
   and peak memory; the loss must be finite, every running statistic
   finite and changed, and no hand-written kernel may launch; then
   ``train_imagenet --loader`` for 8 iterations at batch 256 from a
   file-backed uint8 set (images/s per chip, host batch assembly);
9. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one, or when run
from a directory that does not hold the ``chainermn_torch`` package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the peak rate of their type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# stated tolerances. f32 kernels vs their plain versions:
# |err| <= 1e-4 + 1e-4 |ref|.
TOL_F32 = 1e-4
# bf16 outputs (flash out; dq, dk, dv; dh, dW). The kernel and its plain
# version round an intermediate to bf16 (P, dS, the CE's dl) and then the
# output. The intermediate is rounded from f32 values that differ in
# their last bits (the forward's online softmax even rounds exp(s - m)
# against a running max m), so one rounding may fall the other way: up
# to 2^-8 of the largest term of an entry's sum, and the output rounding
# then puts the two up to 2^-7 of the entry apart. That term is a row of
# an input (v_j, k_j, q_i, h_n, W_v) scaled by P or dl, and it need not
# be small where the entry is: the error vector follows that input row,
# whose largest element is up to about 4 times its rms, so a rounding
# moves a whole output vector by up to ~1.6e-2 of its rms. Each entry is
# therefore held to its own value and to its own vector's scale, so that
# small vectors (late keys of a causal backward, vocab rows with no
# label) are checked as closely as large ones:
#   |err| <= 2e-2 |ref| + 3e-2 rms(ref vector) + 1e-3 rms(ref tensor)
# where a vector is the last axis (one head's D values of a row, one row
# of dh or dW^T). The last term only covers entries whose exact value is
# 0 and whose computed value is f32 cancellation noise (dq of a causal
# row that sees one key: dP - D).
TOL_BF16_REL = 2e-2
TOL_BF16_VEC = 3e-2
TOL_BF16_TENSOR = 1e-3
# bf16 lse (flash) and CE lse / target logit: f32 statistics of exact
# bf16 products, summed in another order
TOL_BF16_LSE = 2e-3
TOL_CE_BF16_STAT = 1e-3
# an argmax may differ from the plain version's only where the plain
# logits' top two are closer than this (f32 summation order decides)
TOL_ARGMAX_GAP = 1e-4
# one train step, kernel path (bf16 compute, fused loss) vs plain path
# (f32 compute, reference attention, unfused loss) from the same f32
# weights: loss within 0.02 of ~10.4, and each parameter's gradient
# within 0.1 relative (L2) error: bf16 rounding of activations over 12
# layers
TOL_TRAIN_LOSS = 0.02
TOL_TRAIN_GRAD = 0.1
# SDPA, the flash kernels' yardstick, vs their plain versions before it is
# timed: relative L2 error of out, dq, dk, dv. It is the same function in
# another rounding (bf16 P, its own summation order); a wrong mask
# alignment or head map is off by O(1)
TOL_YARDSTICK = 2e-2
# served greedy token vs the f32 plain-attention full forward: the
# token's logit must be within this of its row's max (bf16 drift over 12
# layers; the logits' spread is about 0.6)
TOL_LOGIT_GAP = 0.15
# the MNIST MLP's first steps on the card vs the same steps on the CPU
# (f32 everywhere, TF32 off): the two BLAS sum 784- and 1000-long dot
# products in other orders (relative error ~1e-6), and Adam turns the
# last bits of a gradient that cancels to ~1e-7 into part of a step for
# a handful of weights, which moves the loss far less than this:
#   |loss_card - loss_cpu| <= 1e-4 |loss_cpu|
TOL_MNIST_LOSS_REL = 1e-4
# the JAX package's own bar for the MNIST MLP
# (tests/training_tests/test_end_to_end.py)
MNIST_MIN_ACCURACY = 0.9


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 10,
                 runs: int = 5) -> float:
    """The median over ``runs`` runs of the mean CUDA-event time of
    ``iters`` calls, after ``warmup`` calls. Kernels, plain versions and
    yardsticks are all timed so; the warm-ups cover SDPA's default cuDNN
    backend, which builds its execution plans over its first calls (three
    warm-ups left one run's backward at 4x its usual time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[runs // 2]


def visible_pairs(b, lq, lk, hq, causal, window=None) -> int:
    """Visible (row, column) pairs over every batch row and query head:
    row i sees the columns j < lk with j <= i (top-left causal) and
    j > i - window (sliding window); without causal, all lk."""
    if not causal:
        return b * hq * lq * lk
    per_head = 0
    for i in range(lq):
        lo = 0 if window is None else max(0, i - window + 1)
        per_head += max(0, min(i, lk - 1) - lo + 1)
    return b * hq * per_head


def visible_cols(lq, lk, causal) -> int:
    """Key columns that some row sees: without causal, all lk; with it,
    the columns j < lq (row i < lk sees its own column i, and a sliding
    window keeps that column, so a window leaves the span whole)."""
    return min(lq, lk) if causal else lk


def _bound(ops, nbytes, dtype):
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b, lq, lk, hq, hkv, d, dtype, causal, window=None):
    """Least time for the attention forward on these inputs, and what
    bounds it: every visible (row, col) pair costs two length-D products
    (QK and PV, 2 ops per MAC); bytes are q and out (Hq heads), the k and
    v rows some row sees (Hkv heads) once each, plus the f32 lse."""
    ops = 4 * d * visible_pairs(b, lq, lk, hq, causal, window)
    item = 2 if dtype == "bfloat16" else 4
    cols = visible_cols(lq, lk, causal)
    nbytes = (2 * b * lq * hq * d + 2 * b * cols * hkv * d) * item \
        + 4 * b * hq * lq
    return _bound(ops, nbytes, dtype)


# bf16 cases of the tensor-core paths beyond the main shapes, forward and
# backward: name, b, lq, lk, hq, hkv, d, dtype, causal, window, segments
BF16_EDGE_CASES = [
    (name, b, lq, lk, hq, hkv, d, "bfloat16", causal, window, False)
    for name, b, lq, lk, hq, hkv, d, causal, window in (
        ("window37-d32", 1, 300, 300, 4, 2, 32, True, 37),
        ("mqa-d8", 1, 70, 70, 4, 1, 8, True, None),
        ("noncausal-65-150-d128", 1, 65, 150, 2, 2, 128, False, None),
        ("d40", 1, 200, 200, 4, 2, 40, True, None),
        ("d48", 1, 200, 200, 4, 2, 48, True, None),
        ("d96", 1, 200, 200, 4, 2, 96, True, None))]
# the cases the TPU package sends to the split backward (`_fa_bwd_dq_kernel`
# / `_fa_bwd_dkv_kernel`): a window, and causal with Lq != Lk
SPLIT_CASES = [
    ("window-4096", 1, 4096, 4096, 12, 12, 64, "bfloat16", True, 256, False),
    ("causal-lq-ne-lk", 1, 1024, 3000, 12, 4, 64, "bfloat16", True, None,
     False),
]


def _dtype(name):
    import torch

    return getattr(torch, name) if isinstance(name, str) else name


def check_kernels(gen):
    """Kernel vs plain version in every listed case; returns the max
    errors at the prefill shape."""
    import torch

    from chainermn_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_reference)

    def rand(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, lq, lk, hq, hkv, d, dtype, causal, window, segments
        ("prefill", 2, 2048, 2048, 12, 12, 64, bf16, True, None, False),
        ("gqa", 2, 512, 512, 12, 4, 64, bf16, True, None, False),
        ("window", 1, 1024, 1024, 12, 12, 64, bf16, True, 256, False),
        ("segments", 2, 300, 300, 4, 2, 64, bf16, True, None, True),
        ("ragged", 1, 1000, 1000, 12, 12, 64, bf16, True, None, False),
        ("f32", 2, 512, 512, 12, 12, 64, f32, True, None, False),
        ("f32-noncausal-d40", 1, 200, 333, 4, 1, 40, f32, False, None,
         False),
        *BF16_EDGE_CASES,
        # the shapes of the split backward's cases (rows 3-4), timed below
        *SPLIT_CASES,
    ]
    worst = {}
    for (name, b, lq, lk, hq, hkv, d, dtype, causal, window,
         segs) in cases:
        dtype = _dtype(dtype)
        q = rand(b, lq, hq, d, dtype=dtype)
        k = rand(b, lk, hkv, d, dtype=dtype)
        v = rand(b, lk, hkv, d, dtype=dtype)
        seg = None
        if segs:
            qs = torch.zeros(b, lq, dtype=torch.int32, device="cuda")
            qs[:, lq // 2:] = 1
            qs[0, 7] = -1                     # a row that matches no key
            ks = torch.zeros(b, lk, dtype=torch.int32, device="cuda")
            ks[:, lk // 2:] = 1
            seg = (qs, ks)
        out, lse = flash_attention_cuda(q, k, v, causal, None, seg, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None,
                                                     seg, window)
        res_o = _close(out, ref_out, dtype)
        ok_o = res_o[3]
        err_l = (lse - ref_lse).abs()
        if dtype == torch.float32:
            ok_l = bool((err_l <= TOL_F32 + TOL_F32 * ref_lse.abs()).all())
        else:
            ok_l = bool((err_l <= TOL_BF16_LSE).all())
        if segs:
            ok_o = ok_o and bool((out[0, 7] == 0).all())
        print(f"kernel flash_fwd case={name} shape=[{b},{lq}|{lk},{hq}|"
              f"{hkv},{d}] {str(dtype)[6:]} {_fmt('out', res_o)}"
              f" lse_err={err_l.max().item():.3g} "
              f"{'ok' if ok_o and ok_l else 'FAIL'}", flush=True)
        if not (ok_o and ok_l):
            raise PhaseError(f"flash_fwd disagrees with its plain version "
                             f"in case {name}")
        worst[name] = res_o[0]
    return worst


def _rel_l2(got, ref) -> float:
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-30)).item()


def time_flash_case(gen, b, lq, lk, hq, hkv, d, causal, window=None,
                    backward=True):
    """flash_fwd (and flash_bwd) at one bf16 shape beside their plain
    versions, their bounds and SDPA (its forward on inputs that need no
    gradient, and its backward through autograd): a yardstick the port
    never calls. SDPA gets ``is_causal`` (top-left aligned for Lq != Lk,
    as the kernels) or, for a window, a boolean band mask, and
    ``enable_gqa`` where Hq != Hkv.
    Before timing, its output and gradients are held against the plain
    versions (relative L2 error <= TOL_YARDSTICK), so that it computes the
    same function. Returns ``{kernel: row}``."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_bwd_cuda,
        flash_attention_cuda, flash_attention_reference)

    q, dout = (torch.randn(b, lq, hq, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, lk, hkv, d, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    kw = {"enable_gqa": True} if hq != hkv else {}
    if window is None:
        kw["is_causal"] = causal
    else:
        rows = torch.arange(lq, device="cuda")[:, None]
        cols = torch.arange(lk, device="cuda")[None, :]
        kw["attn_mask"] = (cols <= rows) & (rows - cols < window)
    qd, kd, vd = (x.transpose(1, 2) for x in (q, k, v))
    qt, kt, vt = (x.detach().requires_grad_() for x in (qd, kd, vd))

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, **kw)

    # the graph only for the backward yardstick
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    do_t = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                   retain_graph=True)

    ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None, None,
                                                 window)
    errs = [_rel_l2(sdpa().transpose(1, 2), ref_out)]
    if backward:
        ref_g = flash_attention_backward_reference(
            q, k, v, ref_out, ref_lse, dout, causal, None, None, window)
        errs += [_rel_l2(g.transpose(1, 2), r)
                 for g, r in zip(sdpa_bwd(), ref_g)]
        del ref_g
    if max(errs) > TOL_YARDSTICK:
        raise PhaseError(f"SDPA is not the kernels' function at [{b},{lq}|"
                         f"{lk},{hq}|{hkv},{d}] window={window}: relative "
                         f"errors {errs}")
    rows = {"flash_fwd": dict(
        ms=cuda_time_ms(lambda: flash_attention_cuda(q, k, v, causal, None,
                                                     None, window)),
        plain_ms=cuda_time_ms(lambda: flash_attention_reference(
            q, k, v, causal, None, None, window), iters=3, warmup=1),
        library_ms=cuda_time_ms(sdpa),
        **dict(zip(("bound_ms", "bound_by"), flash_bound_ms(
            b, lq, lk, hq, hkv, d, "bfloat16", causal, window))))}
    if backward:
        out, lse = flash_attention_cuda(q, k, v, causal, None, None, window)
        rows["flash_bwd"] = dict(
            ms=cuda_time_ms(lambda: flash_attention_bwd_cuda(
                q, k, v, out, lse, dout, causal, None, None, window)),
            plain_ms=cuda_time_ms(lambda: flash_attention_backward_reference(
                q, k, v, out, lse, dout, causal, None, None, window),
                iters=3, warmup=1),
            library_ms=cuda_time_ms(sdpa_bwd),
            **dict(zip(("bound_ms", "bound_by"), flash_bwd_bound_ms(
                b, lq, lk, hq, hkv, d, "bfloat16", causal, window))))
    print(f"yardstick SDPA [{b},{lq}|{lk},{hq}|{hkv},{d}] window={window} "
          f"({type(o_sdpa.grad_fn).__name__}): relative L2 error vs the "
          f"plain versions (out, dq, dk, dv) "
          + " ".join(f"{e:.3g}" for e in errs), flush=True)
    del q, k, v, dout, qd, kd, vd, qt, kt, vt, o_sdpa, do_t, ref_out, ref_lse
    torch.cuda.empty_cache()
    return rows


def count_tensor_core_ops(card: str) -> None:
    """Print the tensor-core instructions in the SASS of the two flash
    libraries and the fused CE, read with ``cuobjdump --dump-sass``:
    ``HMMA`` (mma.sync) and ``HGMMA`` (wgmma, which ``HMMA`` does not
    match). Raises if a library has no ``HMMA`` (its bf16 mma.sync
    products would not run on the tensor cores) or the fused CE no
    ``HGMMA`` (its bf16 forward)."""
    from chainermn_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    counts = {}
    for name in ("flash_fwd", "flash_bwd", "fused_ce"):
        sass = subprocess.run([tool, "--dump-sass", str(_cuda.build(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.splitlines()
        counts[name] = {op: sum(op in line for line in sass)
                        for op in ("HMMA", "HGMMA")}
    print(f"sass: tensor-core instructions {json.dumps(counts)} ({card})",
          flush=True)
    if not all(c["HMMA"] for c in counts.values()):
        raise PhaseError(f"a kernel library has no HMMA instruction: "
                         f"{counts}")
    if not counts["fused_ce"]["HGMMA"]:
        raise PhaseError(f"the fused CE has no HGMMA instruction: "
                         f"{counts}")


#: the flash builds with the register caps of their d <= 64 tensor-core
#: kernels lifted, timed beside the shipped builds
LIFTED_CAPS = {"flash_fwd": ("FLASH_FWD_MIN_CTAS=1",),
               "flash_bwd": ("FLASH_BWD_MIN_CTAS=1",)}


def mma64_usage(name: str, defines=()) -> dict:
    """ptxas's registers and spill bytes of the d-64 tensor-core kernel
    (``flash_fwd_mma<64>`` or ``flash_bwd_mma<64>``) of a flash build."""
    from chainermn_torch.ops import _cuda

    usage = _cuda.ptxas_usage(name, tuple(defines))
    found = [u for fn, u in usage.items() if f"{name}_mmaILi64E" in fn]
    if len(found) != 1:
        raise PhaseError(f"ptxas reports {len(found)} {name}_mma<64> "
                         f"kernels in {sorted(usage)}")
    return found[0]


#: the fused CE built with its bf16 backward's other row layout (32 rows,
#: 8 warps, 255 registers; shipped: 64 rows, 16 warps, 128 registers),
#: timed beside the shipped build
CE_LAYOUT = ("CE_BWD_ROWS=32",)


def ce_bwd_usage(defines=()) -> dict:
    """ptxas's registers and spill bytes of the bf16 CE backward kernels
    in the layout that runs D <= 768 (``ce_bwd_mma<dW?, Narrow>``, whose
    tiles are 32 streamed rows; the wider layout's are 16) of a fused_ce
    build: ``{"ce_dh": ..., "ce_dw": ...}``."""
    import re

    from chainermn_torch.ops import _cuda

    usage = _cuda.ptxas_usage("fused_ce", tuple(defines))
    out = {}
    for name, flag in (("ce_dh", "ILb0E"), ("ce_dw", "ILb1E")):
        found = [u for fn, u in usage.items()
                 if re.search(rf"ce_bwd_mma{flag}\w*BwdLayoutILi\d+ELi32E",
                              fn)]
        if len(found) != 1:
            raise PhaseError(f"ptxas reports {len(found)} {name} kernels "
                             f"for D <= 768 in {sorted(usage)}")
        out[name] = found[0]
    return out


def ce_fwd_usage() -> dict:
    """ptxas's registers and spill bytes of the bf16 CE forward
    (``ce_fwd_wgmma``; the registers at launch, before its warpgroups
    trade them with setmaxnreg)."""
    from chainermn_torch.ops import _cuda

    found = [u for fn, u in _cuda.ptxas_usage("fused_ce").items()
             if "ce_fwd_wgmma" in fn]
    if len(found) != 1:
        raise PhaseError(f"ptxas reports {len(found)} ce_fwd_wgmma kernels")
    return found[0]


def _usage(u: dict) -> str:
    return (f"{u['registers']} registers, spill stores "
            f"{u['spill_stores']} B, loads {u['spill_loads']} B")


def compare_launch_bounds(gen, card: str) -> None:
    """flash_fwd and flash_bwd at the training shape [4, 2048, 12, 64]
    bf16 causal, built as shipped (registers capped so that 4 forward / 3
    backward CTAs fit an SM at d <= 64) and with the cap lifted, timed in
    the order shipped, lifted, lifted, shipped, each beside ptxas's
    registers and spill bytes. The lifted build's outputs are first held
    against the shipped build's at the bf16 rule."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    q, k, v, dout = (torch.randn(4, 2048, 12, 64, device="cuda",
                                 generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    out, lse = flash_attention_cuda(q, k, v, True)
    calls = {"flash_fwd": lambda: flash_attention_cuda(q, k, v, True),
             "flash_bwd": lambda: flash_attention_bwd_cuda(
                 q, k, v, out, lse, dout, True)}
    for name, call in calls.items():
        lifted = LIFTED_CAPS[name]
        shipped = call()
        with _cuda.variant(name, lifted):
            got = call()
        res = [_close(g, r, torch.bfloat16) for g, r in zip(got, shipped)
               if g.dtype == torch.bfloat16]
        ms = {"shipped": [], "lifted": []}
        for which in ("shipped", "lifted", "lifted", "shipped"):
            if which == "lifted":
                with _cuda.variant(name, lifted):
                    ms[which].append(cuda_time_ms(call))
            else:
                ms[which].append(cuda_time_ms(call))
        print(f"launch bounds {name} [4,2048,12,64] bf16 causal: shipped "
              f"{_usage(mma64_usage(name))}, ms "
              + " ".join(f"{t:.4f}" for t in ms["shipped"])
              + f"; lifted ({' '.join(lifted)}) "
              f"{_usage(mma64_usage(name, lifted))}, ms "
              + " ".join(f"{t:.4f}" for t in ms["lifted"])
              + f"; lifted vs shipped share "
              f"{max(r[2] for r in res):.3f} ({card})", flush=True)
        if not all(r[3] for r in res):
            raise PhaseError(f"{name} with its register cap lifted "
                             "disagrees with the shipped build")
        del shipped, got
    del q, k, v, dout, out, lse


def compare_ce_layouts(gen, card: str) -> None:
    """ce_dh and ce_dw at the training shape [8192, 768] x [768, 32768]
    bf16 in the shipped row layout and in ``CE_LAYOUT``, timed in the
    order shipped, other, other, shipped, each beside ptxas's registers
    and spill bytes. The other layout's outputs are first held against
    the shipped build's at the bf16 rule."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import (ce_dh_cuda, ce_dw_cuda,
                                              ce_forward_cuda)

    h, wt, y = ce_inputs(gen, 8192, 768, 32768, torch.bfloat16)
    lse = ce_forward_cuda(h, wt, y)[0]
    shipped_use, other_use = ce_bwd_usage(), ce_bwd_usage(CE_LAYOUT)
    for name, fn in (("ce_dh", ce_dh_cuda), ("ce_dw", ce_dw_cuda)):
        shipped = fn(h, wt, y, lse)
        with _cuda.variant("fused_ce", CE_LAYOUT):
            other = fn(h, wt, y, lse)
        share = _close(other, shipped, torch.bfloat16)[2]
        ms = {"shipped": [], "other": []}
        for which in ("shipped", "other", "other", "shipped"):
            if which == "other":
                with _cuda.variant("fused_ce", CE_LAYOUT):
                    ms[which].append(cuda_time_ms(
                        lambda: fn(h, wt, y, lse), iters=5, warmup=2))
            else:
                ms[which].append(cuda_time_ms(lambda: fn(h, wt, y, lse),
                                              iters=5, warmup=2))
        print(f"ce layouts {name} [8192,768]x[768,32768] bf16: shipped (64 "
              f"rows, 16 warps) {_usage(shipped_use[name])}, ms "
              + " ".join(f"{t:.4f}" for t in ms["shipped"])
              + f"; {' '.join(CE_LAYOUT)} (32 rows, 8 warps) "
              f"{_usage(other_use[name])}, ms "
              + " ".join(f"{t:.4f}" for t in ms["other"])
              + f"; other vs shipped share {share:.3f} ({card})", flush=True)
        if share > 1.0:
            raise PhaseError(f"{name} in the layout {CE_LAYOUT} disagrees "
                             "with the shipped build")
        del shipped, other
    del h, wt, y, lse
    torch.cuda.empty_cache()


def flash_bwd_bound_ms(b, lq, lk, hq, hkv, d, dtype, causal, window=None):
    """Least time for the attention backward on these inputs: five
    length-D products per visible pair (S, dP, dV, dK, dQ: 10 D ops);
    bytes are q, out, dout read and dq written (Hq heads), the k and v
    rows some row sees read and all of dk, dv written (Hkv heads) once
    each, plus the f32 lse and D rows."""
    ops = 10 * d * visible_pairs(b, lq, lk, hq, causal, window)
    item = 2 if dtype == "bfloat16" else 4
    cols = visible_cols(lq, lk, causal)
    nbytes = (4 * b * lq * hq * d + 2 * b * (cols + lk) * hkv * d) * item \
        + 2 * 4 * b * hq * lq
    return _bound(ops, nbytes, dtype)


def ce_bound_ms(n, d, v, dtype, which: str):
    """Least time for one CE kernel: the forward's head product is
    2 N D V operations, dh and dW each recompute it and add a product of
    the same size (4 N D V); bytes are h, W, the labels (and lse) read
    and the kernel's outputs written once."""
    item = 2 if dtype == "bfloat16" else 4
    ops = (2 if which == "ce_fwd" else 4) * n * d * v
    nbytes = (n * d + d * v) * item + 4 * n
    nbytes += {"ce_fwd": 12 * n, "ce_dh": 4 * n + n * d * item,
               "ce_dw": 4 * n + d * v * item}[which]
    return _bound(ops, nbytes, dtype)


def _close(got, ref, dtype):
    """Hold a kernel's output against its plain version at the stated
    tolerance for ``dtype`` (TOL_F32, or the bf16 rule above). Returns
    (max abs error, rms of ref, worst error / tolerance, ok)."""
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    rms = r.pow(2).mean().sqrt()
    if dtype == torch.float32:
        tol = TOL_F32 + TOL_F32 * r.abs()
    else:
        tol = (TOL_BF16_REL * r.abs()
               + TOL_BF16_VEC * r.pow(2).mean(-1, keepdim=True).sqrt()
               + TOL_BF16_TENSOR * rms)
    share = (err / tol.clamp_min(1e-30)).max().item()
    return err.max().item(), rms.item(), share, share <= 1.0


def _fmt(name, res):
    """``name_err=… (rms …, share …)`` of a :func:`_close` result."""
    return f"{name}_err={res[0]:.3g} (rms {res[1]:.3g}, share {res[2]:.3f})"


def check_flash_bwd(gen):
    """flash_bwd against its plain version (dq, dk, dv) in every listed
    case, on the plain forward's out and lse; returns the max error at
    the training shape."""
    import torch

    from chainermn_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_bwd_cuda,
        flash_attention_reference)

    def rand(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, lq, lk, hq, hkv, d, dtype, causal, window, segments
        ("train", 4, 2048, 2048, 12, 12, 64, bf16, True, None, False),
        ("gqa", 2, 1024, 1024, 12, 4, 64, bf16, True, None, False),
        ("segments", 2, 300, 300, 4, 2, 64, bf16, True, None, True),
        ("ragged", 1, 1000, 1000, 12, 12, 64, bf16, True, None, False),
        ("f32", 2, 512, 512, 12, 12, 64, f32, True, None, False),
        ("f32-noncausal-lq-ne-lk", 1, 200, 333, 4, 1, 40, f32, False, None,
         False),
        *BF16_EDGE_CASES,
        # beyond the TPU fused kernel's envelope (the split dq / dkv pair)
        *SPLIT_CASES,
    ]
    worst = 0.0
    for (name, b, lq, lk, hq, hkv, d, dtype, causal, window,
         segs) in cases:
        dtype = _dtype(dtype)
        q = rand(b, lq, hq, d, dtype=dtype)
        k = rand(b, lk, hkv, d, dtype=dtype)
        v = rand(b, lk, hkv, d, dtype=dtype)
        dout = rand(b, lq, hq, d, dtype=dtype)
        seg = None
        if segs:
            qs = torch.zeros(b, lq, dtype=torch.int32, device="cuda")
            qs[:, lq // 2:] = 1
            qs[0, 7] = -1                     # a row that matches no key
            ks = torch.zeros(b, lk, dtype=torch.int32, device="cuda")
            ks[:, lk // 2:] = 1
            seg = (qs, ks)
        out, lse = flash_attention_reference(q, k, v, causal, None, seg,
                                             window)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, None,
                                       seg, window)
        torch.cuda.synchronize()
        ref = flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                 causal, None, seg, window)
        res = [_close(g, r, dtype) for g, r in zip(got, ref)]
        ok = all(r[3] for r in res)
        if segs:
            ok = ok and bool((got[0][0, 7] == 0).all())
        print(f"kernel flash_bwd case={name} shape=[{b},{lq}|{lk},{hq}|"
              f"{hkv},{d}] {str(dtype)[6:]} window={window} "
              + " ".join(_fmt(n, r) for n, r in zip(("dq", "dk", "dv"), res))
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise PhaseError(f"flash_bwd disagrees with its plain version "
                             f"in case {name}")
        if name == "train":
            worst = max(r[0] for r in res)
            # the check must see an error confined to late keys, whose dk
            # and dv are the smallest of a causal backward
            bad = got[1].clone()
            bad[:, 3 * lk // 4:] *= 1.3
            share = _close(bad, ref[1], dtype)[2]
            print(f"kernel flash_bwd check sees dk x1.3 on the last quarter "
                  f"of keys: share {share:.3f}", flush=True)
            if share <= 1.0:
                raise PhaseError("the flash_bwd check misses a 30% error "
                                 "on late keys")
            del bad
        del q, k, v, dout, out, lse, got, ref
    return worst


def ce_inputs(gen, n, d, v, dtype, ties=False):
    import torch

    if ties:
        # small integers make every logit exact; each head row v >= v/2
        # repeats row v - v/2, so every row's max is attained twice
        h = torch.randint(-2, 3, (n, d), device="cuda", generator=gen)
        half = torch.randint(-2, 3, (v // 2, d), device="cuda",
                             generator=gen)
        wt = torch.cat([half, half])
        h, wt = h.to(dtype), wt.to(dtype)
    else:
        # post-LayerNorm hidden states (std 1) and a head that gives the
        # logits a std of about 0.1 sqrt(D) (2.8 at D = 768): a peaked
        # softmax, so the softmax term of dh and dW is not swamped by the
        # one-hot term and a wrong p or lse shows
        h = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        wt = (torch.randn(v, d, device="cuda", generator=gen) * 0.1).to(
            dtype)
    y = torch.randint(0, v, (n,), device="cuda", generator=gen,
                      dtype=torch.int32)
    return h, wt, y


def check_fused_ce(gen):
    """ce_fwd, ce_dh and ce_dw against their plain versions in every
    listed case (the forward alone past the backward's widest D); a
    second call must give the same bits. Returns each kernel's max error
    at the training shape."""
    import torch

    from chainermn_torch.ops.fused_ce import (
        ce_dh_cuda, ce_dh_reference, ce_dw_cuda, ce_dw_reference,
        ce_forward_cuda, ce_forward_reference, ce_fwd_cuda_plan)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, n, d, v, dtype, ties, backward
        ("train", 8192, 768, 32768, bf16, False, True),
        ("ragged", 8000, 768, 30000, bf16, False, True),
        ("f32", 1000, 256, 5000, f32, False, True),
        ("ties", 512, 64, 1000, bf16, True, True),
        # the bf16 backward beyond the main width: two 768-column chunks of
        # its accumulator (D 1024), and D zero-padded to a whole slice
        ("d1024-chunked", 1000, 1024, 3001, bf16, False, True),
        ("d200-padded", 777, 200, 5003, bf16, False, True),
        # the bf16 forward's edges: one row (every tile its own vocabulary
        # range), V under one tile, ties whose two columns v and v + V/2
        # lie in different ranges, D past the backward's 1536
        ("n1", 1, 768, 32768, bf16, False, True),
        ("v-below-a-tile", 300, 768, 100, bf16, False, True),
        ("ties-across-ranges", 512, 64, 4096, bf16, True, True),
        ("d1544-forward", 70, 1544, 3000, bf16, False, False),
    ]
    worst = {}
    for name, n, d, v, dtype, ties, backward in cases:
        h, wt, y = ce_inputs(gen, n, d, v, dtype, ties)
        lse, tl, am = ce_forward_cuda(h, wt, y)
        if backward:
            dh = ce_dh_cuda(h, wt, y, lse)
            dwt = ce_dw_cuda(h, wt, y, lse)
        torch.cuda.synchronize()
        r_lse, r_tl, r_am = ce_forward_reference(h, wt, y)
        # no atomics: a second call gives the same bits
        same = all(torch.equal(a, b) for a, b in
                   zip((lse, tl, am), ce_forward_cuda(h, wt, y)))
        stat_rel = TOL_F32 if dtype == f32 else 0.0
        stat_abs = TOL_F32 if dtype == f32 else TOL_CE_BF16_STAT
        e_lse = (lse - r_lse).abs().max().item()
        e_tl = (tl - r_tl).abs().max().item()
        ok_lse = bool(((lse - r_lse).abs()
                       <= stat_abs + stat_rel * r_lse.abs()).all())
        ok_tl = bool(((tl - r_tl).abs()
                      <= stat_abs + stat_rel * r_tl.abs()).all())
        logits = h.float() @ wt.float().t()
        top2 = logits.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        del logits
        bad_am = int(((am != r_am) & (gap >= TOL_ARGMAX_GAP)).sum().item())
        ok = ok_lse and ok_tl and bad_am == 0
        if ties:
            # first index on ties: every row's argmax is in the first half
            ok = ok and bool((am < v // 2).all()) and bool(
                (am == r_am).all())
        ranges = (f" ranges={ce_fwd_cuda_plan(n, d, v)['splits']}"
                  if dtype == bf16 else "")
        line = (f"kernel fused_ce case={name} [{n},{d}]x[{d},{v}] "
                f"{str(dtype)[6:]}{ranges} lse_err={e_lse:.3g} "
                f"tl_err={e_tl:.3g} "
                f"argmax_mismatch={int((am != r_am).sum().item())} ")
        if backward:
            # the backward plain versions take the plain forward's lse
            r_dh = ce_dh_reference(h, wt, y, r_lse)
            r_dw = ce_dw_reference(h, wt, y, r_lse)
            res_dh = _close(dh, r_dh, dtype)
            res_dw = _close(dwt, r_dw, dtype)
            same = same and (torch.equal(dh, ce_dh_cuda(h, wt, y, lse))
                             and torch.equal(dwt, ce_dw_cuda(h, wt, y, lse)))
            # the softmax term alone at the rows with no label in this
            # batch (dW^T there is sum_n p h_n): its own share, printed
            nolabel = torch.ones(v, dtype=torch.bool, device="cuda")
            nolabel[y.long()] = False
            res_sw = (_close(dwt[nolabel], r_dw[nolabel], dtype)
                      if nolabel.any() else (0.0, 0.0, 0.0, True))
            ok = ok and res_dh[3] and res_dw[3] and res_sw[3]
            line += (f"{_fmt('dh', res_dh)} {_fmt('dw', res_dw)} "
                     f"{_fmt('dw_nolabel', res_sw)} ")
        ok = ok and same
        print(line + f"repeat_bitwise={same} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise PhaseError(f"fused CE kernels disagree with their plain "
                             f"versions in case {name}")
        if name == "train":
            worst = {"ce_fwd": max(e_lse, e_tl), "ce_dh": res_dh[0],
                     "ce_dw": res_dw[0]}
            # the check must see dh and dW built from the neighbouring
            # row's lse
            shares = [_close(fn(h, wt, y, r_lse.roll(1)), r, dtype)[2]
                      for fn, r in ((ce_dh_reference, r_dh),
                                    (ce_dw_reference, r_dw))]
            print(f"kernel fused_ce check sees the neighbouring row's lse: "
                  f"dh share {shares[0]:.3f}, dw share {shares[1]:.3f}",
                  flush=True)
            if min(shares) <= 1.0:
                raise PhaseError("the fused CE check misses a shifted lse")
        del h, wt, y, lse, tl, am, r_lse, r_tl, r_am
        if backward:
            del dh, dwt, r_dh, r_dw, nolabel
    return worst


def time_training_kernels(gen):
    """Each kernel at the training step's shape beside its plain version,
    its bound and a PyTorch yardstick the port never calls: SDPA forward
    and its autograd backward; for the CE, ``F.cross_entropy(h @ W, y)``
    forward and its backward (dh and dW in one call, so also timed
    against ce_dh + ce_dw together). Returns ``({kernel: row}, pair)``,
    pair the ms of ce_dh + ce_dw, of the backward call and their
    bound."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.ops.fused_ce import (
        ce_dh_cuda, ce_dh_reference, ce_dw_cuda, ce_dw_reference,
        ce_forward_cuda, ce_forward_reference)

    rows = time_flash_case(gen, 4, 2048, 2048, 12, 12, 64, True)

    n, dm, vocab = 8192, 768, 32768
    h, wt, y = ce_inputs(gen, n, dm, vocab, torch.bfloat16)
    lse = ce_forward_cuda(h, wt, y)[0]
    hl = h.detach().requires_grad_()
    wl = wt.detach().requires_grad_()

    def lib_fwd():
        return F.cross_entropy((h @ wt.t()).float(), y.long())

    # the graph only for the backward yardstick
    loss = F.cross_entropy((hl @ wl.t()).float(), y.long())
    lib_f = cuda_time_ms(lib_fwd, iters=5)
    lib_b = cuda_time_ms(lambda: torch.autograd.grad(
        loss, (hl, wl), retain_graph=True), iters=5)
    for name, kern, ref, lib in (
            ("ce_fwd", lambda: ce_forward_cuda(h, wt, y),
             lambda: ce_forward_reference(h, wt, y), lib_f),
            ("ce_dh", lambda: ce_dh_cuda(h, wt, y, lse),
             lambda: ce_dh_reference(h, wt, y, lse), lib_b),
            ("ce_dw", lambda: ce_dw_cuda(h, wt, y, lse),
             lambda: ce_dw_reference(h, wt, y, lse), lib_b)):
        bound, by = ce_bound_ms(n, dm, vocab, "bfloat16", name)
        rows[name] = dict(ms=cuda_time_ms(kern, iters=5, warmup=2),
                          plain_ms=cuda_time_ms(ref, iters=3, warmup=1),
                          library_ms=lib, bound_ms=bound, bound_by=by)
    pair = dict(ms=cuda_time_ms(lambda: (ce_dh_cuda(h, wt, y, lse),
                                         ce_dw_cuda(h, wt, y, lse)),
                                iters=5, warmup=2),
                library_ms=lib_b,
                bound_ms=rows["ce_dh"]["bound_ms"] + rows["ce_dw"]["bound_ms"])
    del h, wt, y, lse, hl, wl, loss
    torch.cuda.empty_cache()
    return rows, pair


def build_model(seed: int, dtype, attention: str):
    import torch

    from chainermn_torch.models.transformer import TransformerLM

    torch.manual_seed(seed)
    return TransformerLM(vocab=32768, d_model=768, n_heads=12, n_layers=12,
                         d_ff=3072, max_len=2048, pos_emb="rope",
                         attention=attention, dtype=dtype, device="cuda")


def engine_config():
    from chainermn_torch.serving.engine import EngineConfig

    return EngineConfig(n_slots=8, capacity=2048,
                        buckets=(128, 256, 512, 1024, 2048),
                        prefill_cohort=2, decode_k=4, max_new_tokens=32)


def prompts_for(seed: int, vocab: int):
    """16 prompts with seeded lengths in [64, 2000]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = rng.randint(64, 2001, size=16)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


def warm_up(model):
    """Two requests per prefill bucket, so first-call costs (cuBLAS
    handles and heuristics per shape, allocator growth) stay out of the
    measured runs."""
    import numpy as np

    from chainermn_torch.serving.engine import Engine

    cfg = engine_config()
    warm = Engine(model, cfg)
    rng = np.random.RandomState(12345)
    for bucket in cfg.buckets:
        for _ in range(2):
            warm.submit(rng.randint(0, model.vocab, size=bucket - 7),
                        max_new_tokens=5)
    warm.run_until_drained()


def serve(model, prompts):
    """The port's main path: one Engine serves every prompt. Launch
    counts are zeroed just before and read just after."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine

    torch.cuda.synchronize()
    eng = Engine(model, engine_config())
    _cuda.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, steps, wall, _cuda.launches()


def profile_serving(model, prompts, out_dir: str, card: str) -> None:
    """One more served run of the same prompts under torch.profiler:
    host time per dispatch kind (each dispatch synchronised at its end,
    where the engine pulls its token ids anyway), the device's busy share
    and the kernels that take the device time. Writes
    ``serve_trace.json`` and ``serve_kernels.txt`` into ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_torch.serving import kv_cache

    spent = {}
    originals = {}

    def timed(name):
        fn = originals[name] = getattr(kv_cache.ServingStep, name)

        def wrapper(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            n, total = spent.get(name, (0, 0.0))
            spent[name] = (n + 1, total + time.perf_counter() - t0)
            return out
        setattr(kv_cache.ServingStep, name, wrapper)

    for name in ("prefill_sampled", "decode_k"):
        timed(name)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, _, wall, _ = serve(model, prompts)
    finally:
        for name, fn in originals.items():
            setattr(kv_cache.ServingStep, name, fn)
    busy_us = write_kernel_table(prof, out_dir, "serve", card, wall)
    print(f"profile: wall {wall:.4f} s (profiler on), device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.4f} of wall; "
          + ", ".join(f"{k} {n}x {t * 1e3:.2f} ms"
                      for k, (n, t) in spent.items())
          + f" ({card})", flush=True)


def write_kernel_table(prof, out_dir: str, stem: str, card: str,
                       wall: float) -> float:
    """Write ``{stem}_trace.json`` and ``{stem}_kernels.txt`` (device time
    by kernel) into ``out_dir``, print the top rows; returns the device
    busy time in microseconds."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{stem}_trace.json"))
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # a record_function range (the optimizer's "Optimizer.step#...") also
    # shows on the device timeline under its host name; it spans kernels
    # already counted, so only names with no host event are kernels
    host = {e.key for e in events if e.device_type != cuda}
    kernels = [e for e in events
               if e.device_type == cuda and e.key not in host]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
             f"{e.key[:110]}" for e in kernels]
    with open(os.path.join(out_dir, f"{stem}_kernels.txt"), "w") as fh:
        fh.write(f"# {card}; profiled wall {wall:.4f} s; device busy "
                 f"{busy_us / 1e3:.3f} ms\n" + "\n".join(lines) + "\n")
    for line in lines[:12]:
        print(f"profile {stem} kernel: {line}", flush=True)
    return busy_us


def profile_training(seed: int, out_dir: str, card: str) -> None:
    """One more train call (4 steps) after a warm-up, under
    torch.profiler: the device's busy share and the kernels that take
    the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    comm = create_communicator("pure_nccl")
    model = build_model(seed, torch.bfloat16, "flash")
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm)
    k = TRAIN["scan_steps"]
    step = make_data_parallel_train_step(model, opt, comm,
                                         loss_fn=fused_lm_loss, scan_steps=k)
    toks = train_tokens(seed)
    xs = torch.as_tensor(toks[:, :-1], device="cuda")[None].expand(
        k, -1, -1).contiguous()
    ys = torch.as_tensor(toks[:, 1:], device="cuda")[None].expand(
        k, -1, -1).contiguous()
    step(xs, ys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(xs, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = write_kernel_table(prof, out_dir, "train", card, wall)
    print(f"profile train: wall {wall:.4f} s for {k} steps (profiler on), "
          f"device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e6 / wall:.4f} of wall ({card})", flush=True)
    comm.finalize()
    del model, opt
    torch.cuda.empty_cache()


def check_streams(model, reqs, prompts, seed: int) -> float:
    """Every request emitted 32 in-range tokens; two of them agree with
    an f32 full forward using plain attention."""
    import torch

    for r in reqs:
        if r.state != "done" or len(r.tokens) != 32:
            raise PhaseError(f"request {r.request_id} ended {r.state} with "
                             f"{len(r.tokens)} tokens")
        if not all(0 <= t < model.vocab for t in r.tokens):
            raise PhaseError(f"request {r.request_id} emitted an "
                             "out-of-range token")
    ref = build_model(seed, torch.float32, "reference")
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    worst = 0.0
    with torch.no_grad():
        for i in (0, len(reqs) - 1):
            p, toks = prompts[i], reqs[i].tokens
            seq = torch.tensor(list(p) + toks[:-1], device="cuda")[None]
            logits = ref(seq)[0, len(p) - 1:]             # [32, vocab]
            picked = logits.gather(1, torch.tensor(toks, device="cuda")
                                   [:, None])[:, 0]
            gap = (logits.max(-1).values - picked).max().item()
            worst = max(worst, gap)
            if not torch.isfinite(logits).all() or gap > TOL_LOGIT_GAP:
                raise PhaseError(
                    f"request {i}: served token's logit is {gap:.4f} below "
                    f"its row max in the f32 forward (tolerance "
                    f"{TOL_LOGIT_GAP})")
    del ref
    return worst


TRAIN = dict(batch=4, seq_len=2048, scan_steps=4, warmup_calls=3,
             timed_calls=3)


def train_tokens(seed: int):
    """One seeded token batch [batch, seq_len + 1], as tools/bench_lm.py
    makes it."""
    import numpy as np

    return np.random.RandomState(seed).randint(
        0, 32768, size=(TRAIN["batch"], TRAIN["seq_len"] + 1)).astype(
            np.int32)


def check_train_grads(model, toks):
    """One step's loss and gradients on the kernel path (bf16 compute,
    flash kernels, fused CE kernels) against the f32 plain path
    (reference attention, unfused loss) from the same weights, on the
    training batch. Returns (loss gap, worst relative gradient error, the
    kernels launched by the kernel path's forward and backward)."""
    import torch

    from chainermn_torch.models.transformer import lm_loss_with_aux
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import fused_lm_loss

    x = torch.as_tensor(toks[:, :-1], device="cuda").long()
    y = torch.as_tensor(toks[:, 1:], device="cuda").long()
    model.zero_grad(set_to_none=True)
    _cuda.reset_launches()
    loss, _ = fused_lm_loss(model, x, y)
    loss.backward()
    launched = _cuda.launches()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ref = build_model(0, torch.float32, "reference")
    ref.load_state_dict(model.state_dict())
    # the plain path keeps f32 [rows, 12, 2048, 2048] scores per layer for
    # its backward, so it takes the batch in two halves of equal token
    # count, each loss weighted 1/2: its gradients are the whole batch's
    half = x.shape[0] // 2
    ref_loss = 0.0
    for rows in (slice(0, half), slice(half, None)):
        part, _ = lm_loss_with_aux(ref, x[rows], y[rows])
        (part / 2).backward()
        ref_loss += part.item() / 2
    worst, worst_name = 0.0, ""
    for n, p in ref.named_parameters():
        g = grads[n].float()
        if not torch.isfinite(g).all():
            raise PhaseError(f"non-finite gradient for {n} on the kernel "
                             "path")
        rel = ((g - p.grad).norm() / p.grad.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, n
    gap = abs(loss.item() - ref_loss)
    del ref, grads
    torch.cuda.empty_cache()
    print(f"train check [{x.shape[0]}, {x.shape[1]}]: loss kernel path "
          f"{loss.item():.6f}, plain f32 path {ref_loss:.6f} (gap "
          f"{gap:.6f}, tolerance {TOL_TRAIN_LOSS}); worst relative gradient "
          f"error {worst:.5f} ({worst_name}, tolerance {TOL_TRAIN_GRAD}); "
          f"forward and backward launches {launched}", flush=True)
    if gap > TOL_TRAIN_LOSS or worst > TOL_TRAIN_GRAD:
        raise PhaseError("the kernel path's train step disagrees with the "
                         "plain path")
    want = {"flash_fwd": 12, "flash_bwd": 12, "ce_fwd": 1, "ce_dh": 1,
            "ce_dw": 1}
    if any(launched[name] != n for name, n in want.items()):
        raise PhaseError(f"the kernel path's step launched {launched}, "
                         f"expected {want}")
    return gap, worst, launched


def train(seed: int, card: str):
    """The port's training path through its normal entry points. Launch
    counts are zeroed just before the timed calls and read just after."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    comm = create_communicator("pure_nccl")
    model = build_model(seed, torch.bfloat16, "flash")
    comm.bcast_data(model)
    toks = train_tokens(seed)
    check = check_train_grads(model, toks)
    # optax.adamw's defaults (decay 1e-4 on every leaf), not torch's
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), comm)
    k = TRAIN["scan_steps"]
    step = make_data_parallel_train_step(model, opt, comm,
                                         loss_fn=fused_lm_loss, scan_steps=k)
    xs = torch.as_tensor(toks[:, :-1], device="cuda")[None].expand(
        k, -1, -1).contiguous()
    ys = torch.as_tensor(toks[:, 1:], device="cuda")[None].expand(
        k, -1, -1).contiguous()
    losses = []
    for _ in range(TRAIN["warmup_calls"]):
        losses.append(step(xs, ys)["main/loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN["timed_calls"]):
        m = step(xs, ys)
        losses.append(m["main/loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _cuda.launches()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).tolist()
    n_steps = TRAIN["timed_calls"] * k
    want = {"flash_fwd": 12 * n_steps, "flash_bwd": 12 * n_steps,
            "ce_fwd": n_steps, "ce_dh": n_steps, "ce_dw": n_steps}
    tokens_per_s = n_steps * TRAIN["batch"] * comm.size * TRAIN[
        "seq_len"] / dt
    print(f"train: {n_steps} timed steps in {dt:.4f} s, "
          f"{dt / n_steps * 1e3:.3f} ms/step, tokens/s per chip "
          f"{tokens_per_s:.1f}, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, losses {[round(x, 4) for x in losses]}"
          f", launches {counts} ({card})", flush=True)
    comm.finalize()
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise PhaseError("a training loss is not finite")
    if not losses[-1] < losses[0]:
        raise PhaseError(f"the loss did not fall: {losses[0]} -> "
                         f"{losses[-1]}")
    if any(counts[name] != n for name, n in want.items()):
        raise PhaseError(f"launch counts {counts}, expected {want}")
    return counts, check


def run_example(example, argv, k: int, card: str, profile_dir, stem: str):
    """Drive a port example through its entry points:
    ``example.build_trainer(example.parse_args(argv))`` and
    ``Trainer.run``. Its first ``k`` steps are first run on the CPU from
    the same parameters (each example seeds ``torch.manual_seed(0)``) and
    batches; launch counts are zeroed just before the card's run and read
    just after. Then the host's batch assembly (iterator and converter)
    is timed alone, and with ``profile_dir`` 20 more steps run under
    torch.profiler. Returns the run's numbers in a dict."""
    import torch

    from chainermn_torch.ops import _cuda

    trainer, _ = example.build_trainer(
        example.parse_args(argv + ["--device", "cpu"]))
    cpu = []
    for _ in range(k):
        trainer.updater.update()
        cpu.append(float(trainer.updater.last_metrics["main/loss"]))
    trainer.updater.comm.finalize()

    trainer, _ = example.build_trainer(example.parse_args(argv))
    comm = trainer.updater.comm
    step, first = trainer.updater.step_fn, []

    def recording_step(*arrays):
        m = step(*arrays)
        if len(first) < k:
            first.append(m["main/loss"])   # stays on the device
        return m

    trainer.updater.step_fn = recording_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launches()
    peak = torch.cuda.max_memory_allocated()
    upd = trainer.updater
    steps = upd.iteration
    t0 = time.perf_counter()
    for _ in range(50):
        upd.converter(next(upd.iterator))
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                upd.update()
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy_us = write_kernel_table(prof, profile_dir, stem, card, pwall)
        extra = ""
        if stem != "mnist":
            write_host_table(prof, profile_dir, stem, card, 20)
            extra = "; device ms by kind " + ", ".join(
                f"{g} {t:.3f}" for g, t in kernel_groups(prof).items())
        print(f"profile {stem}: wall {pwall:.4f} s for 20 steps "
              f"(profiler on), device busy {busy_us / 1e3:.3f} ms = "
              f"{busy_us / 1e6 / pwall:.4f} of wall{extra} ({card})",
              flush=True)
    comm.finalize()
    card_first = torch.stack(first).tolist()
    return dict(obs=trainer.observation, cpu=cpu, card=card_first,
                err=max(abs(a - b) / abs(b) for a, b in zip(card_first, cpu)),
                wall=wall, steps=steps, counts=counts, peak=peak,
                host_ms=host_ms, ranks=comm.size)


MNIST = dict(n_train=60000, n_test=10000, epochs=2, batch=256, units=1000,
             check_steps=8)


def mnist(card: str, profile_dir=None):
    """The port's MNIST example (config #1) through :func:`run_example`:
    ``train_mnist`` (communicator ``naive``, IDX files parsed by
    ``load_mnist``, ``scatter_dataset``, Adam 1e-3, the multi-node
    evaluator, rank-0 reports) at full width (784-1000-1000-10, per-rank
    batch 256) for 2 epochs of 60,000 synthetic samples."""
    import tempfile

    from chainermn_torch.datasets import save_mnist, synth_uint8
    from chainermn_torch.examples import train_mnist

    k = MNIST["check_steps"]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        data = os.path.join(d, "mnist-data")
        save_mnist(data, *synth_uint8(MNIST["n_train"], seed=0), train=True)
        save_mnist(data, *synth_uint8(MNIST["n_test"], seed=1), train=False)
        argv = ["--communicator", "naive", "--epoch", str(MNIST["epochs"]),
                "--unit", str(MNIST["units"]), "--batchsize",
                str(MNIST["batch"]), "--data-dir", data, "--out", d]
        r = run_example(train_mnist, argv, k, card, profile_dir, "mnist")
    obs, card_first, counts, steps, wall = (r["obs"], r["card"],
                                            r["counts"], r["steps"],
                                            r["wall"])
    print(f"mnist: {steps} steps ({MNIST['epochs']} epochs of "
          f"{MNIST['n_train']}) in {wall:.4f} s, "
          f"{wall / steps * 1e3:.3f} ms/step, samples/s per chip "
          f"{steps * MNIST['batch'] * r['ranks'] / wall:.1f}, peak memory "
          f"{r['peak'] / 2 ** 30:.4f} GiB, host batch assembly "
          f"{r['host_ms']:.3f} ms/batch, final loss {obs['main/loss']:.6g}, "
          f"validation accuracy {obs['validation/main/accuracy']:.4f}, "
          f"first {k} losses card {[round(x, 6) for x in card_first]} cpu "
          f"{[round(x, 6) for x in r['cpu']]} worst relative difference "
          f"{r['err']:.2e}, launches {counts} ({card})", flush=True)
    if r["err"] > TOL_MNIST_LOSS_REL:
        raise PhaseError(f"the card's first {k} losses are {r['err']:.2e} "
                         f"(relative) from the CPU's, above "
                         f"{TOL_MNIST_LOSS_REL}")
    if not obs["validation/main/accuracy"] > MNIST_MIN_ACCURACY:
        raise PhaseError(f"validation accuracy "
                         f"{obs['validation/main/accuracy']} is not above "
                         f"{MNIST_MIN_ACCURACY}")
    if not obs["main/loss"] < card_first[0]:
        raise PhaseError(f"the loss did not fall: {card_first[0]} -> "
                         f"{obs['main/loss']}")
    if any(counts.values()):
        raise PhaseError(f"the MLP path launched hand-written kernels: "
                         f"{counts}")
    return counts


CIFAR = dict(n_train=50000, epochs=3, batch=256, depth=20, check_steps=8)
# config #3's first 8 steps on the card vs the same steps on the CPU from
# the same parameters and batches, f32 in f32 on both (TF32 off, the
# example's choice): cuDNN may run a f32 3x3 convolution as Winograd or
# FFT (~1e-5 relative error against oneDNN's direct sums), and 8 SGD
# steps through 19 batch norms carry that 10-100x; a wrong gradient moves
# the loss by more than 1e-2 within those steps:
#   |loss_card - loss_cpu| <= 1e-3 |loss_cpu|
TOL_CIFAR_LOSS_REL = 1e-3
# the synthetic CIFAR-100 classes separate: the same configuration run on
# the CPU ends its third epoch at training accuracy 1.0; the MNIST bar
CIFAR_MIN_ACCURACY = 0.9
# ResNet-50 bf16, 2 steps at batch 8 on the card vs the CPU from the same
# parameters and batches: each device rounds every activation to bf16
# after its own sums. On the CPU the bf16 model drifts from the f32 one
# by 1.9e-4 in the loss and 6.4e-2 in the update (relative L2 over all
# parameters) after 2 steps, and a single tensor's update by up to 0.85;
# two bf16 runs differ by rounding in other places, within the same
# bounds. A wrong convolution, padding or gradient on one device is off
# by O(1):
#   |loss_card - loss_cpu| <= 2e-3 |loss_cpu|
#   |update_card - update_cpu| <= 0.2 |update_cpu| (all parameters)
#   |stats_card - stats_cpu| <= 2e-2 |stats_cpu| (every running buffer)
TOL_R50_LOSS_REL = 2e-3
TOL_R50_UPDATE_REL = 0.2
TOL_R50_STATS_REL = 2e-2
RESNET50 = dict(batch=256, image=224, scan_steps=8, warmup_calls=3,
                timed_calls=4, check_batch=8, check_steps=2,
                loader_iterations=8, loader_n_train=2048)


def write_host_table(prof, out_dir: str, stem: str, card: str,
                     steps: int) -> None:
    """Write ``{stem}_host.txt`` (host time by op, self CPU, per step)
    into ``out_dir`` and print the top rows: where the host spends the
    time the device waits for."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.key_averages() if e.device_type != cuda]
    ops.sort(key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in ops)
    lines = [f"{e.self_cpu_time_total / 1e3 / steps:9.3f} ms/step "
             f"{e.count / steps:8.1f}x/step  {e.key[:90]}" for e in ops]
    with open(os.path.join(out_dir, f"{stem}_host.txt"), "w") as fh:
        fh.write(f"# {card}; host self time {total / 1e3 / steps:.3f} "
                 f"ms/step over {steps} steps (profiler on)\n"
                 + "\n".join(lines) + "\n")
    for line in lines[:8]:
        print(f"profile {stem} host: {line}", flush=True)


def kernel_groups(prof) -> dict:
    """Device ms of a profile by kind, from the kernel names: cuDNN/cuBLAS
    convolutions and products, torch reductions (batch-norm statistics
    and gradient sums), torch elementwise kernels (batch norm's casts and
    arithmetic, ReLU, residual adds, pads), the optimizer's fused
    multi-tensor kernels, NCCL, and the rest."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != cuda}
    groups = {"conv/gemm": 0.0, "reduce": 0.0, "elementwise": 0.0,
              "optimizer": 0.0, "nccl": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != cuda or e.key in host:
            continue
        name = e.key.lower()
        if "nccl" in name:
            kind = "nccl"
        elif "multi_tensor_apply" in name:
            kind = "optimizer"
        elif any(t in name for t in ("xmma", "cudnn", "conv", "gemm",
                                     "cutlass", "fprop", "dgrad", "wgrad",
                                     "sm80_", "sm90_")):
            kind = "conv/gemm"
        elif "reduce" in name:
            kind = "reduce"
        elif "elementwise" in name:
            kind = "elementwise"
        else:
            kind = "other"
        groups[kind] += e.self_device_time_total / 1e3
    return groups


def cifar(card: str, profile_dir=None):
    """Config #3 through :func:`run_example`: ``train_cifar``
    (CifarResNet-20, CIFAR-100 layout, cross-replica batch norm over a
    one-rank NCCL group, per-rank batch 256, f32, SGD 0.05 with momentum
    0.9, binary batches parsed by ``load_cifar``) for 3 epochs of 50,000
    synthetic samples (the CIFAR example's generator)."""
    import tempfile

    from chainermn_torch.datasets import save_cifar, synth_cifar_uint8
    from chainermn_torch.examples import train_cifar

    k = CIFAR["check_steps"]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        data = os.path.join(d, "cifar-data")
        save_cifar(data, *synth_cifar_uint8(CIFAR["n_train"], 100, seed=0),
                   n_classes=100, train=True)
        argv = ["--communicator", "pure_nccl", "--epoch",
                str(CIFAR["epochs"]), "--depth", str(CIFAR["depth"]),
                "--batchsize", str(CIFAR["batch"]), "--data-dir", data,
                "--out", d]
        r = run_example(train_cifar, argv, k, card, profile_dir, "cifar")
    obs, card_first, counts, steps, wall = (r["obs"], r["card"],
                                            r["counts"], r["steps"],
                                            r["wall"])
    print(f"cifar: CifarResNet-{CIFAR['depth']} with cross-replica batch "
          f"norm, {steps} steps ({CIFAR['epochs']} epochs of "
          f"{CIFAR['n_train']}, per-rank batch {CIFAR['batch']}, f32) in "
          f"{wall:.4f} s, {wall / steps * 1e3:.3f} ms/step, samples/s per "
          f"chip {steps * CIFAR['batch'] * r['ranks'] / wall:.1f}, peak "
          f"memory {r['peak'] / 2 ** 30:.4f} GiB, host batch assembly "
          f"{r['host_ms']:.3f} ms/batch, first loss {card_first[0]:.6g}, "
          f"final loss {obs['main/loss']:.6g}, final training accuracy "
          f"{obs['main/accuracy']:.4f}, first {k} losses card "
          f"{[round(x, 6) for x in card_first]} cpu "
          f"{[round(x, 6) for x in r['cpu']]} worst relative difference "
          f"{r['err']:.2e} (tolerance {TOL_CIFAR_LOSS_REL}), launches "
          f"{counts} ({card})", flush=True)
    if r["err"] > TOL_CIFAR_LOSS_REL:
        raise PhaseError(f"the card's first {k} CIFAR losses are "
                         f"{r['err']:.2e} (relative) from the CPU's, above "
                         f"{TOL_CIFAR_LOSS_REL}")
    if not obs["main/loss"] < card_first[0]:
        raise PhaseError(f"the CIFAR loss did not fall: {card_first[0]} -> "
                         f"{obs['main/loss']}")
    if not obs["main/accuracy"] > CIFAR_MIN_ACCURACY:
        raise PhaseError(f"final CIFAR training accuracy "
                         f"{obs['main/accuracy']} is not above "
                         f"{CIFAR_MIN_ACCURACY}")
    if any(counts.values()):
        raise PhaseError(f"the ResNet path launched hand-written kernels: "
                         f"{counts}")
    return counts


def _r50_check(seed: int):
    """Two steps of ResNet-50 (bf16, space-to-depth, batch 8, 224²,
    ``mutable``, SGD 0.1 momentum 0.9) through the port's step on the CPU
    (a gloo world of one) and then on the card (NCCL), from the same
    parameters (``torch.manual_seed(seed)``, drawn on the CPU) and
    batches. Returns (worst relative loss difference, relative update
    difference over all parameters, worst tensor and its difference,
    worst relative running-statistic difference)."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models.resnet import ResNet50
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    r = RESNET50
    gen = torch.Generator().manual_seed(seed + 1)
    shape = (r["check_steps"], r["check_batch"], r["image"], r["image"], 3)
    xs = torch.rand(shape, generator=gen).to(torch.bfloat16)
    ys = torch.randint(0, 1000, shape[:2], generator=gen)
    out = {}
    for device in ("cpu", "cuda"):
        comm = create_communicator("pure_nccl", device=device)
        torch.manual_seed(seed)
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         space_to_depth=True, device=device)
        init = {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
        step = make_data_parallel_train_step(
            model, opt, comm, mutable=("batch_stats",),
            scan_steps=r["check_steps"])
        losses = step(xs, ys)["main/loss"].tolist()
        out[device] = (losses, {k: v.detach().cpu() for k, v in
                                model.state_dict().items()})
        names = [n for n, _ in model.named_parameters()]
        comm.finalize()
        del model, opt, step
    (lc, sc), (lg, sg) = out["cpu"], out["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for n in names:
        dc, dg = sc[n] - init[n], sg[n] - init[n]
        num += ((dg - dc) ** 2).sum().item()
        den += (dc ** 2).sum().item()
        rel = ((dg - dc).norm() / dc.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, n
    stats = max(((sg[n] - sc[n]).norm() / sc[n].norm()).item()
                for n in sc if "running" in n)
    torch.cuda.empty_cache()
    return lc, lg, loss_err, (num / den) ** 0.5, worst_name, worst, stats


def resnet50(seed: int, card: str, profile_dir=None):
    """Config #2, bench.py's gated row, through the port's step:
    ``ResNet50(num_classes=1000, dtype=bf16, space_to_depth=True)``,
    batch 256 at 224², SGD 0.1 with momentum 0.9 through
    ``create_multi_node_optimizer``, ``mutable=("batch_stats",)``,
    ``scan_steps=8``, one seeded uniform batch of 1000-class labels reused
    (bench.py ``_bench_default``); 3 warm-up and 4 timed calls, each
    ending in a pull of its last loss. Before it, :func:`_r50_check`
    holds 2 steps on the card to the CPU; after it,
    ``train_imagenet --loader`` runs 8 iterations at batch 256 from a
    file-backed uint8 set under ``build/``. Launch counts are zeroed just
    before the warm-ups and read after the timed calls."""
    import tempfile

    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.examples import train_imagenet
    from chainermn_torch.links import batch_norm_layers
    from chainermn_torch.models.resnet import ResNet50
    from chainermn_torch.ops import _cuda
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    r = RESNET50
    lc, lg, loss_err, upd_err, worst_name, worst, stats_err = _r50_check(
        seed)
    print(f"resnet50 check: 2 steps at batch {r['check_batch']}, "
          f"{r['image']}², bf16: losses card {[round(x, 6) for x in lg]} "
          f"cpu {[round(x, 6) for x in lc]}, worst relative loss "
          f"difference {loss_err:.2e} (tolerance {TOL_R50_LOSS_REL}), "
          f"relative update difference over all parameters {upd_err:.4f} "
          f"(tolerance {TOL_R50_UPDATE_REL}; worst tensor {worst_name} "
          f"{worst:.4f}), worst relative running-statistic difference "
          f"{stats_err:.2e} (tolerance {TOL_R50_STATS_REL}) ({card})",
          flush=True)
    if (loss_err > TOL_R50_LOSS_REL or upd_err > TOL_R50_UPDATE_REL
            or stats_err > TOL_R50_STATS_REL):
        raise PhaseError("ResNet-50's steps on the card disagree with the "
                         "CPU's")

    # fixed shapes, as train_imagenet sets it: cuDNN times its algorithms
    # once per shape
    torch.backends.cudnn.benchmark = True
    comm = create_communicator("pure_nccl")
    torch.manual_seed(seed)
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
    k = r["scan_steps"]
    step = make_data_parallel_train_step(model, opt, comm,
                                         mutable=("batch_stats",),
                                         scan_steps=k)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (k, r["batch"], r["image"], r["image"], 3)
    xs = torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)
    ys = torch.randint(0, 1000, shape[:2], generator=gen, device="cuda")
    bns = batch_norm_layers(model)
    stats0 = [t.clone() for m in bns for t in (m.running_mean,
                                               m.running_var)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(r["warmup_calls"]):
        float(step(xs, ys)["main/loss"][-1])
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(r["timed_calls"]):
        m = step(xs, ys)
        last = float(m["main/loss"][-1])
    dt = time.perf_counter() - t0
    counts = _cuda.launches()
    peak = torch.cuda.max_memory_allocated()
    n_steps = r["timed_calls"] * k
    ips = n_steps * r["batch"] * comm.size / dt
    stats1 = [t for m_ in bns for t in (m_.running_mean, m_.running_var)]
    stats_finite = all(torch.isfinite(t).all().item() for t in stats1)
    stats_moved = sum(not torch.equal(a, b) for a, b in zip(stats0, stats1))
    print(f"resnet50: ResNet50 bf16 space-to-depth, batch {r['batch']} at "
          f"{r['image']}², scan_steps {k}: {n_steps} timed steps in "
          f"{dt:.4f} s, {dt / n_steps * 1e3:.3f} ms/step, images/s per "
          f"chip {ips / comm.size:.1f}, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, warm-up {warm:.2f} s, last loss "
          f"{last:.6f} (finite {last == last and abs(last) < float('inf')}"
          f"), running statistics finite {stats_finite} and "
          f"{stats_moved} of {len(stats1)} buffers changed, launches "
          f"{counts} ({card})", flush=True)
    if not (last == last and abs(last) < float("inf")):
        raise PhaseError("ResNet-50's loss is not finite")
    if not stats_finite or stats_moved != len(stats1):
        raise PhaseError(f"ResNet-50's running statistics: finite "
                         f"{stats_finite}, {stats_moved} of {len(stats1)} "
                         "changed")
    if any(counts.values()):
        raise PhaseError(f"the ResNet path launched hand-written kernels: "
                         f"{counts}")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(xs, ys)["main/loss"][-1])
            pwall = time.perf_counter() - t0
        busy_us = write_kernel_table(prof, profile_dir, "resnet50", card,
                                     pwall)
        write_host_table(prof, profile_dir, "resnet50", card, k)
        groups = kernel_groups(prof)
        print(f"profile resnet50: wall {pwall:.4f} s for {k} steps "
              f"(profiler on), device busy {busy_us / 1e3:.3f} ms = "
              f"{busy_us / 1e6 / pwall:.4f} of wall; device ms by kind "
              + ", ".join(f"{g} {t:.3f} ({t * 1e3 / busy_us:.4f})"
                          for g, t in groups.items()) + f" ({card})",
              flush=True)
    comm.finalize()
    del model, opt, step, xs, ys, bns, stats0, stats1
    torch.cuda.empty_cache()

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        args = train_imagenet.parse_args(
            ["--loader", "--iterations", str(r["loader_iterations"]),
             "--batchsize", str(r["batch"]), "--image-size",
             str(r["image"]), "--n-train", str(r["loader_n_train"]),
             "--out", d])
        trainer, _ = train_imagenet.build_trainer(args)
        comm = trainer.updater.comm
        lstep, first_done = trainer.updater.step_fn, []

        def timed_first(*arrays):
            # one synchronise, after the first step only: the rest of the
            # run is timed from there
            m = lstep(*arrays)
            if not first_done:
                torch.cuda.synchronize()
                first_done.append(time.perf_counter())
            return m

        trainer.updater.step_fn = timed_first
        _cuda.reset_launches()
        trainer.run()
        torch.cuda.synchronize()
        rest = time.perf_counter() - first_done[0]
        loader_counts = _cuda.launches()
        obs = trainer.observation
        it = trainer.updater.iterator
        t0 = time.perf_counter()
        for _ in range(r["loader_iterations"]):
            next(it)
        host_ms = (time.perf_counter() - t0) / r["loader_iterations"] * 1e3
        it.close()
        comm.finalize()
    lips = obs["iteration"] * r["batch"] * comm.size / obs["elapsed_time"]
    steady = (obs["iteration"] - 1) * r["batch"] * comm.size / rest
    print(f"resnet50 loader: train_imagenet --loader, {obs['iteration']} "
          f"iterations at batch {r['batch']} from a file-backed uint8 set "
          f"of {r['loader_n_train']} in {obs['elapsed_time']:.4f} s, "
          f"images/s per chip {lips / comm.size:.1f} (the first iteration "
          f"included), {steady / comm.size:.1f} over the last "
          f"{obs['iteration'] - 1}, host batch assembly {host_ms:.3f} "
          f"ms/batch (native gather and pinned copy), last loss "
          f"{obs['main/loss']:.6f}, launches {loader_counts} ({card})",
          flush=True)
    if not obs["main/loss"] == obs["main/loss"]:
        raise PhaseError("train_imagenet --loader's loss is not finite")
    if any(loader_counts.values()):
        raise PhaseError(f"the ResNet path launched hand-written kernels: "
                         f"{loader_counts}")
    return {name: counts[name] + loader_counts[name] for name in counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one more served run, one more "
                         "train call, 20 more MNIST and CIFAR steps and "
                         "one more ResNet-50 call into DIR (chrome traces "
                         "and kernel tables)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "chainermn_torch")):
        print("chip_smoke: chainermn_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import ce_fwd_cuda_plan

    # f32 products in full f32 (the reference forward's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    took = _cuda.build_all(variants=[*LIFTED_CAPS.items(),
                                     ("fused_ce", CE_LAYOUT)])
    print(f"build: {json.dumps(took)} total "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    count_tensor_core_ops(card)
    print("ptxas: " + "; ".join(
        [f"{name}_mma<64> {_usage(mma64_usage(name))}"
         for name in ("flash_fwd", "flash_bwd")]
        + [f"ce_fwd bf16 (wgmma) {_usage(ce_fwd_usage())}"]
        + [f"{name} bf16 D <= 768 {_usage(u)}"
           for name, u in ce_bwd_usage().items()]) + f" ({card})",
        flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = check_kernels(gen)
    worst["flash_bwd"] = check_flash_bwd(gen)
    worst.update(check_fused_ce(gen))
    def show(name, where, row, extra=""):
        print(f"time {name} ({where}): kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms,"
              f" bound by {row['bound_by']}{extra} ({card})", flush=True)

    row = time_flash_case(gen, 2, 2048, 2048, 12, 12, 64, True,
                          backward=False)["flash_fwd"]
    show("flash_fwd", "serving shape [2,2048,12,64] bf16 causal", row)
    # rows 3-4 of the kernel table: the split backward's cases, which
    # flash_bwd computes
    for (case, b, lq, lk, hq, hkv, d, _, causal, window,
         _) in SPLIT_CASES:
        for name, row in time_flash_case(gen, b, lq, lk, hq, hkv, d, causal,
                                         window).items():
            show(name, f"case={case} [{b},{lq}|{lk},{hq}|{hkv},{d}] bf16 "
                       f"window={window}", row)
    times, pair = time_training_kernels(gen)
    plan = ce_fwd_cuda_plan(8192, 768, 32768)
    for name, row in times.items():
        show(name, "training shape", row, "" if name != "ce_fwd" else (
            f", tile {'x'.join(map(str, _cuda.ce_fwd_tile()))} (rows x "
            f"columns x depth), vocabulary ranges S={plan['splits']} of "
            f"{plan['per']} "
            f"tiles, grid {plan['grid'][0]}x{plan['grid'][1]}, "
            f"{plan['smem_bytes'] / 1e9:.3f} GB into shared memory "
            f"({plan['smem_bytes'] / row['ms'] / 1e9:.1f} TB/s)"))
    print(f"pair ce_dh + ce_dw (training shape): kernels {pair['ms']:.4f} "
          f"ms, F.cross_entropy backward (dh and dW in one call) "
          f"{pair['library_ms']:.4f} ms, ratio "
          f"{pair['ms'] / pair['library_ms']:.3f}, bound "
          f"{pair['bound_ms']:.4f} ms ({card})", flush=True)
    compare_launch_bounds(gen, card)
    compare_ce_layouts(gen, card)

    model = build_model(args.seed, torch.bfloat16, "flash")
    prompts = prompts_for(args.seed, model.vocab)
    warm_up(model)
    eng, reqs, steps, wall, counts = serve(model, prompts)
    if counts["flash_fwd"] < 1:
        raise PhaseError("the served prefill never launched flash_fwd")
    gap = check_streams(model, reqs, prompts, args.seed)
    summ = eng.report.summary()
    decode_tokens = summ["tokens_emitted"] - len(reqs)
    print(f"slice: {len(reqs)} requests, {summ['tokens_emitted']} tokens, "
          f"{steps} steps, wall {wall:.3f} s (report {summ['wall_s']:.3f} "
          f"s), ttft p50 "
          f"{summ['ttft_ms']['p50']:.2f} ms, itl p50 "
          f"{summ['itl_ms']['p50']:.2f} ms, decode tokens/s "
          f"{decode_tokens / summ['wall_s']:.1f}, launches {counts}, "
          f"worst logit gap {gap:.4f}, kv cache "
          f"{eng.steps.cache_bytes() / 1e6:.1f} MB ({card})", flush=True)
    del eng
    if args.profile:
        profile_serving(model, prompts, args.profile, card)
    del model
    torch.cuda.empty_cache()

    train_counts, _ = train(args.seed, card)
    if args.profile:
        profile_training(args.seed, args.profile, card)
    torch.cuda.empty_cache()
    mnist_counts = mnist(card, args.profile)
    cifar_counts = cifar(card, args.profile)
    torch.cuda.empty_cache()
    r50_counts = resnet50(args.seed, card, args.profile)

    sources = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:168"),
               "flash_bwd": ("flash_bwd.cu", "flash_attention.py:399"),
               "ce_fwd": ("fused_ce.cu", "fused_ce.py:58"),
               "ce_dh": ("fused_ce.cu", "fused_ce.py:103"),
               "ce_dw": ("fused_ce.cu", "fused_ce.py:126")}
    errs = {"flash_fwd": worst["prefill"], **{
        name: worst[name] for name in sources if name != "flash_fwd"}}
    kernels = []
    for name, (src, tpu) in sources.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"chainermn_torch/csrc/{src}",
            "replaces": f"chainermn_tpu/ops/{tpu}",
            # serving and training both drive flash_fwd: its count is
            # the sum of the main-path runs (the MNIST, CIFAR and ResNet-50
            # runs add none)
            "launches": train_counts[name] + mnist_counts[name]
            + cifar_counts[name] + r50_counts[name] + (
                counts["flash_fwd"] if name == "flash_fwd" else 0),
            "max_abs_err": errs[name], **times[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
