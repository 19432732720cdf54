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
   wgmma, which the fused CE's forward must have; dumped on the host
   beside phase 3's checks), and ptxas's registers
   and spill bytes of the main path's tensor-core kernels (flash at d 64,
   the bf16 CE forward, the bf16 CE backward at D 768) and of the f32
   kernels (``flash_fwd_fma<64>``, ``flash_bwd_fma<64>``, ``ce_fwd_fma``,
   and dh's and dW's
   ``ce_bwd_fma<false>`` and ``<true>``), and the f32 CE forward's and
   dh's grids and vocabulary ranges and dW's grid and ranges of h's rows
   (``f32 grids``); the two flash
   sources are also built with those kernels' register caps lifted, and
   the fused CE with its backward's other row layout (``CE_LAYOUT``);
3. kernels — each kernel (flash_fwd, flash_bwd, and the fused CE's
   ce_fwd, ce_dh, ce_dw) against its plain PyTorch version on the card at
   the main path's shape and in the edge cases (bf16 and f32; for the CE
   forward one row, V under one tile, ties across its vocabulary ranges
   and D 1544; for the f32 forward, dh and dW one row, V under one tile,
   ties across ranges, D 36, 772, 1152 and 1544, and a vocabulary small
   enough to split dW into ranges of h's rows; for the f32 flash forward a
   ragged 129-row query and a fully masked row; for the f32 flash
   backward ragged key tiles (Lk 129 and 200), GQA 12 | 4, a window
   across key tiles, a fully masked row, d 8 and 128, causal Lq > Lk; the
   parallel phase's shapes in bf16 and f32: a ring-flash block of 512
   tokens, full and causal, Ulysses' and TP's 3 heads over 2048 tokens,
   the MoE LM's one sequence (the f32 pipelines' (a), (b) and (d) too),
   the pipeline TP x PP's 6 heads over 2048 tokens, and the backward of each block a ring's last
   rank sees on the output and lse merged over all four, as ring-flash
   passes them; a second CE call must give the same bits), then timed
   beside the plain version, its bound and the PyTorch call that computes
   the same function (a yardstick only, the port never calls it; SDPA is
   first held against the plain versions): flash at the serving and
   training shapes, at the split backward's cases (a window; causal
   Lq != Lk) and at the ViT's (non-causal, 196 and 197 tokens), the
   flash_bwd kernel's launch alone beside each whole call; the f32
   bodies (``flash_*_fma``, the f32 CE kernels) also at the ZeRO phase's
   f32 shapes, held and timed there, and the f32 CE at N 8192 (the f32 LM
   loss of batch 4 x 2048); ce_fwd with its vocabulary ranges,
   grid and the bytes its
   TMA boxes move into shared memory; ce_dh + ce_dw together beside the
   one backward call of the yardstick (``pair`` line), and the f32 ce_dw
   beside a library backward that computes dW alone; then the two flash
   kernels with their register caps lifted and the CE backward in its
   other row layout, each timed beside the shipped build;
4. slice — the port's ``Engine`` serves 16 greedy requests with the
   135M TransformerLM at full width (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, rope, bf16) and random weights from
   ``--seed``; launch counts are zeroed just before and read just after,
   and two streams are checked against an f32 full forward with plain
   attention on the card; then the rest of serving on that model and
   config, each with its own launch counts (flash_fwd > 0 in each): (a)
   the 16 prompts on int8-block pages (resident bytes at most 0.52x the
   bf16 pages', TTFT, tokens/s), and one greedy stream driving a bf16-page
   and an int8-page step, whose decode logits must agree within 10 x half
   the coarsest resident scale; (b) 4 requests held after prefill on one
   engine, handed off (``export_handoff``/``import_handoff``) to another,
   one of them frozen mid-decode (``export_session``) and adopted back
   (``import_session``): every stream equal to the uninterrupted engine's;
   (c) ``SpeculativeEngine`` with a 2-layer full-width draft and with the
   target as its own draft: streams equal to the plain engine's except at
   a divergence whose top-2 margin is below the measured chunk-versus-
   decode logit gap (counted), the self-draft pair's acceptance at least
   0.9 with more than one token a dispatch; (d) weights published
   int8-block, loaded and swapped into a drained engine (a busy one must
   refuse): its streams equal a fresh engine's on the loaded weights; (e)
   the 16 prompts through a ``Frontend`` from 4 threads, every future
   the Engine's stream; then the serving fleet on that model and config
   (``fleet`` lines, each with its own launch counts, flash_fwd > 0 in
   each; every stream held to the plain engine's, a divergence allowed
   only at a top-2 margin under (c)'s gap): (a) the ``Router`` over 2
   replicas with one killed by chaos (``kill_replica``: replicas_dead 1,
   streams requeued and complete), then a replica drained mid-decode
   (sessions migrated, ``DRAINED``, tokens emitted once), TTFT and
   tokens/s beside the plain engine's; (b) a prefill engine feeding a
   decode engine over ``InProcessTransport``: the f32 wire's bytes equal
   to the fills' bf16 page bytes plus the key rows, ms a handoff,
   int8-block's bytes and ratio and its logit error after a handoff
   within 10 x half the coarsest block scale, the async conveyor's
   overlap and stall against sync's; (c) ``RolloutController`` walks the
   live router from the served weights to a seeded perturbation of
   them: the canary passes, every replica ends on v2, every stream is
   one version's, the relay's bytes beside the snapshot's; (d) two
   ``fleet_lm`` processes (``--hosts 2 --transport socket --streamed``)
   on the served model published once, started after (b) and run
   beside (c): the merged JSONL against an in-process Engine, and a
   second run with ``reset_conn`` on the prefill host heals to the same
   JSONL;
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
9. seq2seq — config #4 through the port's seq2seq example
   (``chainermn_torch.examples.train_seq2seq``) at the JAX module's full
   width (2 LSTM layers x 256 units, vocabulary 40,000 on both sides), one
   NCCL rank, per-rank batch 64, bucket 32, synthetic pairs, f32 with TF32
   off: its first 8 losses must match the same steps on the CPU, the loss
   must fall, greedy and beam-4 decoding must run on the card, and no
   hand-written kernel may launch (ms/step, target tokens/s, peak memory,
   BLEU);
10. model_parallel — config #5: ``train_mnist_model_parallel`` as a
   world of 4 processes on this one card through
   ``create_communicator("non_cuda_aware")`` (the example's widths, 4
   stages); its first losses must equal the unsplit MLP's on the card,
   the loss must fall, and no rank may launch a hand-written kernel
   (ms/step, host-staged bytes per step); then one activation's round
   trip between two host-staged ranks beside raw gloo and the copies
   alone; ``train_mnist_eager_p2p`` on 2 ranks, and two ranks that ask
   for NCCL on one card must refuse and name ``non_cuda_aware`` (these
   two worlds time nothing and run beside the build); a failed rank
   fails the run;
11. vit — ``train_imagenet --model vit``: ViT-S/16 (d_model 384, 12
   layers, 6 heads, d_ff 1536, 1000 classes) in bf16 over f32 parameters
   at 224², batch 64, SGD 0.1 Nesterov, one NCCL rank, over the synthetic
   set: first 2 steps at batch 4 on the card held to the CPU; then the
   example's run with launch counts zeroed just before and read just
   after (exactly 12 flash_fwd and 12 flash_bwd a step, no CE kernel),
   ms/step, images/s per chip and peak memory, finite losses and whether
   they fall; the step alone on a fixed batch on the card; 3 iterations
   with ``--dropout 0.1`` (the step's dropout keys on the card);
12. checkpoint — the same ViT in one process, uninterrupted, with
   ``--snapshot-every k``: snapshot bytes, the async save's stall on the
   training thread and synchronous saves in ms, and the losses; the
   restore of snapshot k in a new process is resilience (a)'s second
   incarnation (the restored state must equal the saved npz bit for bit
   and the resumed losses this run's within a bf16 tolerance; resume
   ms);
13. reducers — the gradient reducers (``chainermn_torch.collectives``):
   (a) ResNet-50's gradient tree at full width (25.6M f32 parameters,
   random gradients from ``--seed``) through ``flat``, ``hierarchical``,
   ``quantized`` in ``bf16``, ``int8``, ``int8-block`` and
   ``int4-block`` with error feedback, and ``auto``, on one NCCL rank:
   each output held to the unquantized result within half a quantization
   step an element (bit for bit where nothing is quantized), each residual
   to input − local dequantization, the bytes handed to NCCL to the
   plan's wire bytes, then ms a reduction; (b) ``train_mnist
   --grad-reducer flat|hierarchical|quantized --wire-format
   int8-block|auto`` at ``--unit 1000`` for one epoch of 8,192: losses
   finite and falling, hierarchical's and auto's equal to flat's bit for
   bit, the ``ReductionReport`` rows printed; (c) 4 ranks on this card
   through ``non_cuda_aware`` with ``LOCAL_WORLD_SIZE=2`` (two "nodes"):
   ``hierarchical`` bit for bit ``flat`` on integer-valued gradients and
   ``int8-block`` within half a step of it, each rank on ``cuda:0``; no
   hand-written kernel may launch;
14. zero — ZeRO-1/2 and the large-batch optimizers: (a) the 135M LM of
   ``train`` (bf16 over f32 parameters, seq 2048, batch 4,
   ``fused_lm_loss``) on one NCCL rank through ZeRO-1 flat, ZeRO-1
   bucketed (25 MiB) and ZeRO-2 (2 micro-batches, bucketed), each 4 steps
   from the seed's weights held to the data-parallel step
   (``create_multi_node_optimizer(AdamW)``) on the same batch: ms/step,
   tokens/s per chip, peak GiB, the hooks' peak of live gradient bytes,
   optimizer-state bytes, and each kernel's launches (zeroed just before
   and read just after the ZeRO runs); (b) 4 host-staged ranks of this
   card (``non_cuda_aware``), the LM at full width but 2 layers, f32, seq
   512, two sequences a rank (ZeRO-2: two micro-batches), SGD with
   momentum: ZeRO-1 and ZeRO-2 flat and bucketed and ZeRO-1 with
   int8-block error feedback, and ZeRO-1 with Adam, each held to one rank
   (a ``split`` of its own) running the data-parallel step on all eight
   sequences; these runs share the FSDP phase's 4-rank world (after its
   FSDP runs, with their own launch counts) and print there; (c)
   ``train_imagenet --optimizer lars|lamb``: the first 2 steps of
   ResNet-50 (64², f32) and the ViT (32², f32) held to the CPU's, then
   ResNet-50 ``--loader`` at batch 256, 224² and the ViT at batch 64,
   224², 8 iterations each between two SGD runs; (d) ``train_lm --zero 1
   --zero-bucket-kib 4096`` at full width (f32, seq 2048, batch 4);
15. fsdp — FSDP (ZeRO-3), the scanned-stack LM loss, sharded
   checkpoints and the snapshot plane: (a) the 135M LM of ``train``
   (bf16 over f32 parameters, seq 2048, batch 4, fused loss) on one NCCL
   rank through ``make_fsdp_train_step`` plain, with ``remat``, and over
   the stacked tree (``stack_lm_blocks`` + ``make_lm_fsdp_scan_loss``),
   each 4 steps from the seed's weights held to the data-parallel step on
   the same batch: ms/step, tokens/s per chip, peak GiB, the peak of live
   gathered bytes (the scan's stacked layers within one layer's bytes),
   and each kernel's launches (zeroed just before each run and read just
   after: the scan launches flash_fwd 24, flash_bwd 12 and each CE kernel
   once a step); then that scan state through ``AsyncSnapshotPlane``
   (stall ms against the synchronous save's ms, bytes, the same file);
   (b) 4 host-staged ranks of this card, the LM at full width but 2
   layers, f32, seq 512, two sequences a rank: FSDP with SGD-momentum,
   FSDP-scan, ``param_wire="int8-block"``, ``QuantizedReducer(ef=False)``
   and LAMB, each held to one rank running the data-parallel step on all
   eight sequences (the quantized runs within half a quantization step of
   their exact values); (c) that world's FSDP-scan state and a ZeRO-1
   int8-block state with error feedback, saved on 4 ranks, restored bit
   for bit onto 4 and onto 2 (the residual frame regrouped, its mean
   kept); (d) ``train_lm --zero 3`` and ``--fsdp-scan`` at full width
   (f32, seq 2048, batch 4): ms/step, peak GiB, losses finite and falling;
16. resilience — fault tolerance, every run a subprocess with a timeout:
   (a) the checkpoint phase's ViT under the port's supervisor
   (``python -m chainermn_torch.tools.supervise`` around
   ``train_imagenet --snapshot-every k --resume``) with a chaos SIGKILL
   at step k+2 in the first incarnation: the second elects snapshot k,
   restores it bit for bit (the resume timed: the checkpoint phase's
   restore check) and finishes, its losses within a bf16 tolerance of
   the checkpoint phase's uninterrupted run, 12 flash_fwd and 12
   flash_bwd a step in each incarnation, and the time from the kill to
   the first resumed step; (b) in that second incarnation a chaos ``corrupt`` of
   snapshot 2k, after which the election falls back to k; (c) a chaos
   SIGTERM: the emergency snapshot written within the grace window, exit
   143 (save ms against the grace); (d) 4 host-staged ranks of this card
   on the FSDP phase's 2-layer f32 LM (``train_lm --fsdp-scan``) with the
   watchdog (heartbeat 200 ms, timeout 1000 ms) and an
   ``AsyncSnapshotPlane`` with a ``PeerReplicator``: rank 3 killed, every
   survivor exits 75 (the seconds each took), then 2 ranks resume
   through ``elastic_resume`` with rank 3's files gone, its shard from
   its ring replica, the state bit for bit the saved files', the next
   losses finite and falling;
17. parallel — the TransformerLM's intra-layer parallelism
   (``chainermn_torch.parallel``) on 4 host-staged ranks of this card
   (``non_cuda_aware``), the 135M LM at full width and depth (bf16 over
   f32 parameters, rope, weights from ``--seed``): (a) one sequence of
   2048 split over the ranks through ``ring``, ``ring_flash`` and
   ``ulysses`` attention: logits, loss and the gradients summed over the
   ranks held to the one-rank flash model's, launches per rank (ring_flash
   12·(r+1) of each flash kernel, Ulysses 12, the plain ring none), the
   attention alone at [1, 2048, 12, 64] beside one-rank flash; (b) tensor
   parallelism over the 4 (3 heads, d_ff 768, a vocabulary slice of 8192
   a rank, ``lm_head_tp``, ``tp_lm_loss``): the loss and every gradient,
   gathered into the dense layout, held to the dense model's, then 4 Adam
   steps with falling losses and the replicated leaves bitwise equal on
   every rank; (c) ``train_lm --moe 2``'s configuration (8 experts over
   the 4, capacity factor 2.0) with top-1 and top-2, a sequence of 2048 a
   rank: one f32 step (TF32 off) held to the one-process oracle (every
   expert on one rank, each rank's tokens run apart), then 4 bf16 steps
   (ms/step, falling losses, shared leaves bitwise equal and expert
   leaves differing across ranks, 12 launches of each flash kernel a step
   and no CE kernel), then the share of tokens dropped in one no-grad
   forward of the trained weights, outside the timed steps; (d)
   ``train_lm --ring --seq-impl ring|ring_flash|ulysses`` and ``--moe 2
   --moe-top-k 1|2`` at full width but 2 layers (f32, seq 2048), 2
   iterations each, the ring runs printing the trained weights' next-token
   accuracy (a check: its ms/step is not a per-step metric of the LM); a
   failed rank fails the run;
18. pipeline — the micro-batched pipelines (``chainermn_torch.parallel``
   and ``chainermn_torch.examples.train_pipeline_lm``), in the parallel
   phase's world of 4 host-staged ranks, the 135M LM's block at full
   width (d_model 768, 12 heads, d_ff 3072, vocab 32768, seq 2048, f32
   parameters and compute with TF32 off, weights from ``--seed``): (a)
   the interleaved 1F1B, S 4 x V 3 = 12 blocks, 8 micro-batches of
   [1, 2048], the embedding outside and the head in the loss hook: one
   step's loss and every gradient (the embedding, each block, the head)
   held to the one-rank sequential oracle (the same blocks in one
   process, the mean over micro-batches, plain autograd), each rank's
   flash_fwd and flash_bwd launches (2·V·M and V·M: the forward, its
   remat and the backward, nothing on bubble ticks), the schedule's T and
   idle share of tick slots, then 4 Adam steps: ms/step, peak GiB per
   rank, host-staged exchange ms per tick (the communicator's
   ``exchange_seconds``), losses finite and falling, and one step's stage
   work timed on the card with CUDA events, each rank alone in turn; (b)
   ``--hetero`` (embed + 2 blocks + head, a rank each): the wire 1 x 2048
   x 768 elements, one step held to the oracle, then 4 steps, losses
   falling in each; (c) TP x PP,
   S 2 x T 2, one block a stage: the loss and every gradient gathered
   into the dense layout held to the dense pipeline's, then 3 Adam steps
   with the ``model``-replicated leaves bitwise equal along ``model``;
   (d) ``MultiNodeChainList.to_branching_pipeline`` on a diamond over the
   4 ranks: the loss and gradients held to the chain list's own run; a
   failed check or rank fails the run, and the phase's wall seconds are
   printed;
19. a line of each phase's wall seconds, a ``{"kernels": [...]}`` line
   (a row for each kernel's bf16 body and
   one for its f32 body, which only the ZeRO, FSDP, resilience,
   parallel and pipeline phases' f32 runs launch), the card line, and
   last ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one, or when run
from a directory that does not hold the ``chainermn_torch`` package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
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


# the ViT-S/16 training path at 224²: non-causal, 196 tokens (a ragged
# last tile: 3 x 64 + 4), 197 with the class token (pool="cls")
VIT_CASES = [
    ("vit", 64, 196, 196, 6, 6, 64, "bfloat16", False, None, False),
    ("vit-cls", 64, 197, 197, 6, 6, 64, "bfloat16", False, None, False),
]
# the f32 bodies (flash_fwd_fma, flash_bwd_fma) at the ZeRO phase's f32
# shapes: train_lm's [4,2048,12,64] causal, (b)'s ZeRO-2 micro-batch of
# one 512-token sequence (ZeRO-1's two are the "f32" case), and the
# large-batch check's ViT at 32² (4 tokens, non-causal)
F32_PATH_CASES = [
    ("f32-lm", 4, 2048, 2048, 12, 12, 64, "float32", True, None, False),
    ("f32-world-micro", 1, 512, 512, 12, 12, 64, "float32", True, None,
     False),
    ("f32-vit-32", 4, 4, 4, 6, 6, 64, "float32", False, None, False),
]

# the parallel phase's shapes: a ring-flash block of 512 tokens a rank
# (non-causal below the diagonal, causal on it), Ulysses' and TP's 3
# local heads over the whole 2048, the MoE LM's one sequence; in bf16
# ((a)-(c)) and f32 ((c)'s oracle step, (d)'s train_lm runs). The
# pipeline phase's (a), (b) and (d) run the MoE LM's shape in f32; its
# (c), TP x PP, splits the 12 heads over T 2: 6 local heads
PARALLEL_CASES = [
    (name, b, lq, lk, hq, hkv, d, dtype, causal, None, False)
    for dtype in ("bfloat16", "float32")
    for name, b, lq, lk, hq, hkv, d, causal in (
        (f"ring-block-{dtype}", 1, 512, 512, 12, 12, 64, False),
        (f"ring-diagonal-{dtype}", 1, 512, 512, 12, 12, 64, True),
        (f"ulysses-tp-{dtype}", 1, 2048, 2048, 3, 3, 64, True),
        (f"moe-{dtype}", 1, 2048, 2048, 12, 12, 64, True),
        (f"pipeline-tp-{dtype}", 1, 2048, 2048, 6, 6, 64, True))]
# ring-flash's backward gets the merged output and lse of every block a
# rank saw, not its block's own: rank 3 of 4 merges three full blocks and
# the causal diagonal
RING_MERGE = dict(ranks=4, rank=3, block=512, heads=12, d=64)


# the f32 backward's key tiles (128 keys at d <= 64, 64 above): a ragged
# last tile (Lk 129: one key; 200), GQA summed in the CTA, a window
# crossing tile edges, a fully masked row (segments), d 8 and d 128 (64-key
# tiles, swizzled rows), causal Lq > Lk
F32_BWD_EDGE_CASES = [
    (name, b, lq, lk, hq, hkv, d, "float32", causal, window, segs)
    for name, b, lq, lk, hq, hkv, d, causal, window, segs in (
        ("f32-lk-129", 1, 100, 129, 4, 2, 64, False, None, False),
        ("f32-lk-200", 2, 150, 200, 4, 2, 64, False, None, False),
        ("f32-gqa-12-4", 1, 256, 256, 12, 4, 64, True, None, False),
        ("f32-window-100", 1, 400, 400, 2, 2, 64, True, 100, False),
        ("f32-segments", 2, 200, 200, 4, 2, 64, True, None, True),
        ("f32-d8", 1, 150, 150, 4, 1, 8, True, None, False),
        ("f32-d128", 1, 200, 200, 4, 2, 128, True, None, False),
        ("f32-lq-gt-lk", 1, 300, 129, 4, 2, 64, True, None, False))]


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
        # the f32 body's 128-row tile: a ragged last row, a fully masked
        # row (segments)
        ("f32-ragged-129", 1, 129, 129, 12, 12, 64, f32, True, None, False),
        ("f32-segments", 2, 300, 300, 4, 2, 64, f32, True, None, True),
        *BF16_EDGE_CASES,
        # the shapes of the split backward's cases (rows 3-4), timed below
        *SPLIT_CASES,
        # the ViT's shapes, timed below
        *VIT_CASES,
        *F32_PATH_CASES,
        *PARALLEL_CASES,
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
                    backward=True, dtype="bfloat16"):
    """flash_fwd (and flash_bwd) at one shape (bf16 unless ``dtype``
    says otherwise) beside their plain
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

    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_bwd_cuda,
        flash_attention_cuda, flash_attention_reference)

    q, dout = (torch.randn(b, lq, hq, d, device="cuda", generator=gen)
               .to(_dtype(dtype)) for _ in range(2))
    k, v = (torch.randn(b, lk, hkv, d, device="cuda", generator=gen)
            .to(_dtype(dtype)) for _ in range(2))
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
            b, lq, lk, hq, hkv, d, dtype, causal, window))))}
    if backward:
        out, lse = flash_attention_cuda(q, k, v, causal, None, None, window)
        # the kernel's launch alone, without the wrapper's Dr = rowsum(dO
        # o O), the zeroing of the f32 dq buffer and its cast
        dr = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq_acc = torch.zeros(b, lq, hq, d, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        launch_ms = cuda_time_ms(lambda: _cuda.launch_flash_bwd(
            q, k, v, dout, lse, dr, None, None, dq_acc, dk, dv, d ** -0.5,
            causal, 0 if window is None else window))
        del dr, dq_acc, dk, dv
        rows["flash_bwd"] = dict(
            launch_ms=launch_ms,
            ms=cuda_time_ms(lambda: flash_attention_bwd_cuda(
                q, k, v, out, lse, dout, causal, None, None, window)),
            plain_ms=cuda_time_ms(lambda: flash_attention_backward_reference(
                q, k, v, out, lse, dout, causal, None, None, window),
                iters=3, warmup=1),
            library_ms=cuda_time_ms(sdpa_bwd),
            **dict(zip(("bound_ms", "bound_by"), flash_bwd_bound_ms(
                b, lq, lk, hq, hkv, d, dtype, causal, window))))
    print(f"yardstick SDPA [{b},{lq}|{lk},{hq}|{hkv},{d}] {dtype} "
          f"window={window} "
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


def f32_usage() -> dict:
    """ptxas's registers and spill bytes of the f32 kernels of the main
    path: ``{name: (kernel, usage)}`` for the flash forward and backward
    at d 64 and the CE forward, dh and dW (dh's mirror image: one
    template)."""
    from chainermn_torch.ops import _cuda

    out = {}
    for name, lib, kernel, key in (
            ("flash_fwd", "flash_fwd", "flash_fwd_fma<64>",
             "flash_fwd_fmaILi64E"),
            ("flash_bwd", "flash_bwd", "flash_bwd_fma<64>",
             "flash_bwd_fmaILi64E"),
            ("ce_fwd", "fused_ce", "ce_fwd_fma", "ce_fwd_fma"),
            ("ce_dh", "fused_ce", "ce_bwd_fma<false>", "ce_bwd_fmaILb0E"),
            ("ce_dw", "fused_ce", "ce_bwd_fma<true>", "ce_bwd_fmaILb1E")):
        found = [u for fn, u in _cuda.ptxas_usage(lib).items() if key in fn]
        if len(found) != 1:
            raise PhaseError(f"ptxas reports {len(found)} {key} kernels")
        out[name] = (kernel, found[0])
    return out


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
    case, on the plain forward's out and lse; returns the max error of
    each case."""
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
        *VIT_CASES,
        *F32_PATH_CASES,
        *F32_BWD_EDGE_CASES,
        *PARALLEL_CASES,
    ]
    worst = {}
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
        worst[name] = max(r[0] for r in res)
        if name == "train":
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
    worst.update(check_ring_merge_bwd(gen))
    return worst


def check_ring_merge_bwd(gen):
    """flash_bwd against its plain version on ring-flash's inputs: each
    visible block's backward with the output and lse merged over all the
    blocks (``merge_block``, as the ring's forward merges them), for the
    last rank of a causal ring. Returns the max error of each dtype."""
    import torch

    from chainermn_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_bwd_cuda,
        flash_attention_reference)
    from chainermn_torch.parallel.ring_attention import merge_block

    m = RING_MERGE
    shape = (1, m["block"], m["heads"], m["d"])
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        def rand():
            return torch.randn(*shape, device="cuda",
                               generator=gen).to(dtype)

        q, dout = rand(), rand()
        blocks = [(rand(), rand(), src == m["rank"])
                  for src in range(m["rank"] + 1)]
        o = torch.zeros(shape, dtype=torch.float32, device="cuda")
        lse = torch.full((1, m["heads"], m["block"]), float("-inf"),
                         device="cuda")
        for k, v, causal in blocks:
            o, lse = merge_block(o, lse, *flash_attention_reference(
                q, k, v, causal))
        out = o.to(dtype)
        errs = []
        for src, (k, v, causal) in enumerate(blocks):
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
            torch.cuda.synchronize()
            ref = flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                     causal)
            res = [_close(g, r, dtype) for g, r in zip(got, ref)]
            ok = all(r[3] for r in res)
            print(f"kernel flash_bwd case=ring-merged block {src} of rank "
                  f"{m['rank']} ({'causal diagonal' if causal else 'full'})"
                  f" shape=[1,{m['block']},{m['heads']},{m['d']}] "
                  f"{str(dtype)[6:]} on the merged out and lse "
                  + " ".join(_fmt(n, r) for n, r in zip(("dq", "dk", "dv"),
                                                        res))
                  + f" {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise PhaseError(f"flash_bwd disagrees with its plain "
                                 f"version on ring-flash's merged out and "
                                 f"lse (block {src}, {dtype})")
            errs.append(max(r[0] for r in res))
        worst[f"ring-merged-{str(dtype)[6:]}"] = max(errs)
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
    at the training shape, and (``*_f32``) the worst of the f32 cases on
    the ZeRO phase's path."""
    import torch

    from chainermn_torch.ops.fused_ce import (
        ce_dh_cuda, ce_dh_cuda_plan, ce_dh_reference, ce_dw_cuda,
        ce_dw_cuda_plan, ce_dw_reference, ce_forward_cuda,
        ce_forward_reference, ce_fwd_cuda_plan)

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
        # the f32 bodies at the ZeRO phase's (b): two 512-token sequences
        # a rank (ZeRO-1), one (ZeRO-2's micro-batch)
        ("f32-world", 1024, 768, 32768, f32, False, True),
        ("f32-world-micro", 512, 768, 32768, f32, False, True),
        # the f32 forward's and dh's edges: one row (one row block, 128
        # vocabulary ranges), V under one tile, ties whose two columns lie
        # in different ranges, D not a whole slab, D past one 768-column
        # chunk of dh's accumulator (772: the second chunk 4 wide; 1152)
        ("f32-n1", 1, 768, 32768, f32, False, True),
        ("f32-v-below-a-tile", 300, 768, 100, f32, False, True),
        ("f32-ties-across-ranges", 512, 64, 4096, f32, True, True),
        ("f32-d36", 333, 36, 2000, f32, False, True),
        ("f32-d772", 200, 772, 3000, f32, False, True),
        ("f32-d1152", 150, 1152, 2500, f32, False, True),
        # dW on dh's mirror image: D 1544 (the old f32 dW's shared memory
        # refused it), and a small vocabulary that splits h's rows into
        # ranges summed from a workspace
        ("f32-d1544", 70, 1544, 3000, f32, False, True),
        ("f32-dw-ranges", 600, 768, 2000, f32, False, True),
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
        plan = ce_fwd_cuda_plan(n, d, v, "cuda", dtype)
        ranges = f" ranges={plan['splits']}"
        if dtype == f32:
            ranges += (f" dh_ranges={ce_dh_cuda_plan(n, d, v)['splits']}"
                       f" dw_ranges={ce_dw_cuda_plan(n, d, v)['splits']}")
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
        if name.startswith("f32-world"):
            for k, e in (("ce_fwd_f32", max(e_lse, e_tl)),
                         ("ce_dh_f32", res_dh[0]), ("ce_dw_f32", res_dw[0])):
                worst[k] = max(worst.get(k, 0.0), e)
        if name == "train":
            worst.update(ce_fwd=max(e_lse, e_tl), ce_dh=res_dh[0],
                         ce_dw=res_dw[0])
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


def time_f32_kernels(gen):
    """The f32 bodies that the ZeRO phase's f32 runs launch, at their
    shapes there, as :func:`time_training_kernels` times the bf16 ones:
    flash at ``train_lm``'s [4,2048,12,64] causal, the CE kernels at
    (b)'s ZeRO-1 batch (N 1024, D 768, V 32768) and at the f32 LM loss of
    batch 4 x 2048 (N 8192), the yardsticks in f32 (TF32 off). Returns
    ``({kernel_f32: row}, {kernel_f32: row at N 8192})``."""
    rows = {f"{k}_f32": row for k, row in time_flash_case(
        gen, 4, 2048, 2048, 12, 12, 64, True, dtype="float32").items()}
    return rows | time_f32_ce(gen, 1024), time_f32_ce(gen, 8192)


def time_f32_ce(gen, n, dm=768, vocab=32768):
    """ce_fwd, ce_dh and ce_dw on f32 inputs [n, dm] x [dm, vocab] beside
    their plain versions, their bounds and ``F.cross_entropy(h @ W, y)``
    in f32: its forward for ce_fwd, its backward (dh and dW in one call)
    for ce_dh and, as ``pair_library_ms``, beside ce_dw; its backward
    with respect to W alone is ce_dw's own yardstick."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.ops.fused_ce import (
        ce_dh_cuda, ce_dh_reference, ce_dw_cuda, ce_dw_reference,
        ce_forward_cuda, ce_forward_reference)

    h, wt, y = ce_inputs(gen, n, dm, vocab, torch.float32)
    lse = ce_forward_cuda(h, wt, y)[0]
    hl = h.detach().requires_grad_()
    wl = wt.detach().requires_grad_()
    loss = F.cross_entropy(hl @ wl.t(), y.long())
    wo = wt.detach().requires_grad_()     # dW alone: h takes no gradient
    loss_w = F.cross_entropy(h @ wo.t(), y.long())
    lib_f = cuda_time_ms(lambda: F.cross_entropy(h @ wt.t(), y.long()),
                         iters=5)
    lib_b = cuda_time_ms(lambda: torch.autograd.grad(
        loss, (hl, wl), retain_graph=True), iters=5)
    lib_w = cuda_time_ms(lambda: torch.autograd.grad(
        loss_w, (wo,), retain_graph=True), iters=5)
    rows = {}
    for name, kern, ref, lib in (
            ("ce_fwd", lambda: ce_forward_cuda(h, wt, y),
             lambda: ce_forward_reference(h, wt, y), lib_f),
            ("ce_dh", lambda: ce_dh_cuda(h, wt, y, lse),
             lambda: ce_dh_reference(h, wt, y, lse), lib_b),
            ("ce_dw", lambda: ce_dw_cuda(h, wt, y, lse),
             lambda: ce_dw_reference(h, wt, y, lse), lib_w)):
        bound, by = ce_bound_ms(n, dm, vocab, "float32", name)
        rows[f"{name}_f32"] = dict(
            ms=cuda_time_ms(kern, iters=5, warmup=2),
            plain_ms=cuda_time_ms(ref, iters=3, warmup=1),
            library_ms=lib, bound_ms=bound, bound_by=by)
    rows["ce_dw_f32"]["pair_library_ms"] = lib_b
    del h, wt, y, lse, hl, wl, wo, loss, loss_w
    torch.cuda.empty_cache()
    return rows


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


# the rest of serving at full width: the slice phase's (a)-(e)
SERVE_REST = dict(control_prompts=2, control_new=8, migrate=4,
                  session_min_tokens=6, spec_k=2, draft_layers=2,
                  swap_prompts=4, frontend_threads=4, gap_tokens=5)
# int8-block pages against a bf16-page control driven by the same token
# stream: JAX's calibrated bound, 10 x half the coarsest per-block scale
# the resident pages hold (its test_int8_pages_logit_error_calibrated_
# with_f32_control): each code is within half a step of its value, and a
# layer's products and softmax can amplify that a few times
TOL_INT8_STEPS = 10.0
# acceptance of a self-draft pair (draft = target): the draft proposes
# off its decode logits, the target verifies off its chunk logits, so
# only a top-2 near-tie below their gap can reject a proposal
MIN_SELF_ACCEPT = 0.9


def _serve_engine(eng, prompts, **submit):
    """Every prompt through ``eng`` (a fresh engine), counts zeroed just
    before and read just after → (requests, wall s, launches, rate)."""
    import torch

    from chainermn_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, **submit) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.report.summary()
    rate = (f"ttft p50 {s['ttft_ms']['p50']:.2f} ms, decode tokens/s "
            f"{(s['tokens_emitted'] - len(reqs)) / s['wall_s']:.1f}")
    return reqs, wall, _cuda.launches(), rate


def _need_flash(counts, what: str) -> None:
    if counts["flash_fwd"] < 1:
        raise PhaseError(f"{what}: the prefill never launched flash_fwd")


def _serve_int8(model, prompts, streams, card: str):
    """(a): the 16 prompts on int8-block pages (resident bytes against
    bf16 pages), then the calibrated logit-error check."""
    import dataclasses

    import numpy as np
    import torch

    from chainermn_torch.serving.engine import Engine
    from chainermn_torch.serving.kv_cache import ServingStep, cache_bytes

    cfg = dataclasses.replace(engine_config(), kv_dtype="int8-block")
    eng = Engine(model, cfg)
    q8 = eng.steps.cache_bytes()
    raw = cache_bytes(model, cfg.n_slots, cfg.capacity)
    reqs, wall, counts, rate = _serve_engine(eng, prompts)
    same = sum(r.tokens == s for r, s in zip(reqs, streams))
    del eng
    torch.cuda.empty_cache()
    # one greedy token stream (off the control's logits) drives both
    b, n_new = SERVE_REST["control_prompts"], SERVE_REST["control_new"]
    ps = prompts[:b]
    width = max(len(p) for p in ps)
    tokens = np.zeros((b, width), np.int64)
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = p
    lengths, slots = [len(p) for p in ps], list(range(b))
    ctl = ServingStep(model, b, width + n_new)
    q = ServingStep(model, b, width + n_new, kv_dtype="int8-block")
    rows_c = [ctl.prefill(tokens, lengths, slots)]
    rows_q = [q.prefill(tokens, lengths, slots)]
    for _ in range(n_new):
        nxt = rows_c[-1].argmax(-1)
        rows_c.append(ctl.decode(nxt))
        rows_q.append(q.decode(nxt))
    worst = max(float((a.float() - z.float()).abs().max())
                for a, z in zip(rows_c, rows_q))
    step = 0.0
    for slot in slots:
        for page in q.export_slot(slot, int(q.cursors()[slot])).values():
            for leaf in ("k_s", "v_s"):
                step = max(step, float(np.abs(page[leaf]).max()) / 2)
    del ctl, q
    ratio = q8 / raw
    print(f"slice (a) int8-block pages: resident {q8 / 1e6:.1f} MB against "
          f"bf16 pages' {raw / 1e6:.1f} MB ({ratio:.4f}x; against f32 "
          f"pages {q8 / (2 * raw):.4f}x); 16 requests, wall {wall:.3f} s, "
          f"{rate}, streams equal to bf16 pages' {same}/16 (not a check), "
          f"launches {counts}; {b} prompts x {n_new} decode steps off a "
          f"bf16-page control: worst logit error {worst:.4f}, bound "
          f"{TOL_INT8_STEPS:g} x half the coarsest resident scale "
          f"{step:.5f} = {TOL_INT8_STEPS * step:.4f} ({card})", flush=True)
    _need_flash(counts, "slice (a)")
    if not ratio <= 0.52:
        raise PhaseError(f"slice (a): int8 pages hold {ratio:.4f}x the bf16 "
                         "pages' bytes")
    if not 0 < worst <= TOL_INT8_STEPS * step:
        raise PhaseError(f"slice (a): int8 logit error {worst} past "
                         f"{TOL_INT8_STEPS} x {step}")
    return counts


def _serve_migration(model, prompts, streams, card: str):
    """(b): 4 requests held after prefill on engine A, handed off to
    engine B (same config, raw pages); one of them frozen mid-decode on B
    with export_session and adopted back on A. Every migrated stream
    equals the uninterrupted engine's."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine

    m = SERVE_REST["migrate"]
    a, b = Engine(model, engine_config()), Engine(model, engine_config())
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    held = [a.submit(p, max_new_tokens=1, hold=True) for p in prompts[:m]]
    a.run_until_drained()
    if len(a.held) != m:
        raise PhaseError(f"slice (b): {len(a.held)} of {m} requests held")
    t1 = time.perf_counter()
    adopted = []
    for req, p in zip(held, prompts[:m]):
        adopted.append(b.import_handoff(a.export_handoff(req), p,
                                        max_new_tokens=32))
        a.release_held(req)
    t2 = time.perf_counter()
    moved = adopted[0]
    while len(moved.tokens) < SERVE_REST["session_min_tokens"]:
        b.step()
    session = b.export_session(moved)
    t3 = time.perf_counter()
    back = a.import_session(session, prompts[0])
    b.release_held(moved)
    t4 = time.perf_counter()
    a.run_until_drained()
    b.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launches()
    got = [back.tokens] + [r.tokens for r in adopted[1:]]
    same = [g == s for g, s in zip(got, streams[:m])]
    print(f"slice (b) migration: {m} requests held after prefill on A, "
          f"export_handoff + import_handoff onto B in "
          f"{(t2 - t1) * 1e3:.1f} ms ({(t2 - t1) / m * 1e3:.1f} a request), "
          f"request 0 frozen by export_session at {len(session['tokens'])} "
          f"tokens and adopted back on A in {(t4 - t3) * 1e3:.1f} ms; "
          f"streams equal to the uninterrupted engine's {same}, wall "
          f"{wall:.3f} s, launches {counts} ({card})", flush=True)
    _need_flash(counts, "slice (b)")
    if not all(same):
        raise PhaseError("slice (b): a migrated stream differs from the "
                         "uninterrupted one")
    return counts


def _chunk_decode_gap(model, prompts, w: int) -> float:
    """The worst |logit| difference between the verify chunk's forward of
    ``w`` tokens and ``w`` decode steps over the same tokens, both after
    the same prefill (one slot a prompt)."""
    import torch

    from chainermn_torch.serving.kv_cache import ServingStep

    worst = 0.0
    for p in prompts:
        steps = [ServingStep(model, 1, len(p) + w) for _ in range(2)]
        toks = [steps[0].prefill(p[None], [len(p)], [0]).argmax(-1)]
        steps[1].prefill(p[None], [len(p)], [0])
        dec = []
        for _ in range(w):
            dec.append(steps[0].decode(toks[-1]))
            toks.append(dec[-1].argmax(-1))
        chunk = torch.stack(toks[:w], dim=1)
        with torch.no_grad():
            ver = steps[1].model.forward_cached(chunk, steps[1].cache,
                                                chunked=True)
        worst = max(worst, float((ver[0] - torch.cat(dec)).abs().max()))
    return worst


def _divergences(model, prompts, want, got, gap: float):
    """Compare streams; at each stream's first divergence, the top-2
    margin of the plain stream's logits there (full forward). Returns
    (number of divergences, the worst margin among them)."""
    import torch

    n, worst = 0, 0.0
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        j = next(i for i, (x, y) in enumerate(zip(w, g)) if x != y)
        seq = torch.tensor(list(p) + w[:j], device=model.device)[None]
        with torch.no_grad():
            top = model(seq)[0, -1].float().topk(2).values
        n += 1
        worst = max(worst, float(top[0] - top[1]))
    return n, worst


def _serve_speculative(model, prompts, streams, seed: int, plain_rate,
                       card: str):
    """(c): a 2-layer full-width draft (``--seed + 1``) and the self-draft
    pair against the plain engine's greedy streams."""
    import torch

    from chainermn_torch.models.transformer import TransformerLM
    from chainermn_torch.serving.speculative import SpeculativeEngine

    c = SERVE_REST
    k = c["spec_k"]
    gap = _chunk_decode_gap(model, prompts[:2], c["gap_tokens"])
    # the target's widths, 2 layers, its own weights
    torch.manual_seed(seed + 1)
    draft = TransformerLM(vocab=model.vocab, d_model=model.d_model,
                          n_heads=model.n_heads, n_layers=c["draft_layers"],
                          d_ff=model.d_ff, max_len=model.max_len,
                          pos_emb=model.pos_emb, attention=model.attention,
                          dtype=model.dtype, device=model.device)
    # the self-draft pair ends every stream on a full round (1 + m
    # (spec_k + 1) tokens), so no budget cut counts as a rejection
    full = 1 + (len(streams[0]) - 1) // (k + 1) * (k + 1)
    total = {}
    rows = {}
    for name, dm, n_new in (("draft", draft, len(streams[0])),
                            ("self", model, full)):
        eng = SpeculativeEngine(model, dm, engine_config(), spec_k=k)
        reqs, wall, counts, rate = _serve_engine(eng, prompts,
                                                 max_new_tokens=n_new)
        s = eng.report.summary()
        n, margin = _divergences(model, prompts,
                                 [st[:n_new] for st in streams],
                                 [r.tokens for r in reqs], gap)
        rows[name] = (s["acceptance_rate"], s["tokens_per_dispatch"], n,
                      margin, wall, rate, counts)
        for kk, v in counts.items():
            total[kk] = total.get(kk, 0) + v
        del eng
        torch.cuda.empty_cache()
    del draft
    for name, (acc, tpd, n, margin, wall, rate, counts) in rows.items():
        layers = c["draft_layers"] if name == "draft" else model.n_layers
        print(f"slice (c) speculative, {name} ({layers}-layer draft, "
              f"spec_k {k}, {full if name == 'self' else len(streams[0])} "
              f"tokens a request): acceptance {acc:.4f}, tokens per "
              f"dispatch {tpd:.4f}, 16 requests wall {wall:.3f} s, {rate} "
              f"(plain engine: {plain_rate}); streams against the plain "
              f"engine's: {n} divergences, worst top-2 margin at one "
              f"{margin:.4f} against the chunk-versus-decode logit gap "
              f"{gap:.4f} ({c['gap_tokens']} tokens after 2 prompts); "
              f"launches {counts} ({card})", flush=True)
        _need_flash(counts, f"slice (c) {name}")
        if n and margin >= gap:
            raise PhaseError(f"slice (c) {name}: a stream diverges where "
                             f"the top-2 margin {margin} is above the gap "
                             f"{gap}")
    acc, tpd = rows["self"][:2]
    if not (acc >= MIN_SELF_ACCEPT and tpd > 1):
        raise PhaseError(f"slice (c): the self-draft pair accepted {acc} "
                         f"at {tpd} tokens a dispatch")
    return total, gap


def _serve_swap(model, prompts, seed: int, card: str):
    """(d): new weights published int8-block, loaded and swapped into a
    drained engine; its streams equal a fresh engine's on the loaded
    weights, and a busy engine refuses the swap."""
    import tempfile

    import torch

    from chainermn_torch.serving.engine import Engine
    from chainermn_torch.serving.weights import load_weights, publish_weights

    ps = prompts[:SERVE_REST["swap_prompts"]]
    new = build_model(seed + 2, model.dtype, model.attention)
    eng = Engine(model, engine_config(), weights_version="v1")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        path = os.path.join(d, "weights.npz")
        t0 = time.perf_counter()
        manifest = publish_weights(new.state_dict(), path,
                                   wire_format="int8-block",
                                   weights_version="v2")
        t1 = time.perf_counter()
        loaded, _ = load_weights(path, like=new.state_dict())
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    busy = eng.submit(ps[0], max_new_tokens=2)
    try:
        eng.swap_weights(loaded, "v2")
        refused = False
    except RuntimeError:
        refused = True
    eng.run_until_drained()
    t3 = time.perf_counter()
    old, old_version = eng.swap_weights(loaded, "v2")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    del old
    got, _, counts, _ = _serve_engine(eng, ps)
    new.load_state_dict(loaded)
    del loaded
    fresh, _, _, _ = _serve_engine(Engine(new, engine_config()), ps)
    same = [a.tokens == b.tokens for a, b in zip(got, fresh)]
    print(f"slice (d) swap_weights: publish_weights int8-block "
          f"{size / 1e6:.1f} MB in {(t1 - t0) * 1e3:.1f} ms (manifest "
          f"format {manifest['format']}), load_weights "
          f"{(t2 - t1) * 1e3:.1f} ms, a busy engine refused: {refused}, "
          f"the drained engine swapped {old_version} -> "
          f"{eng.weights_version} in {(t4 - t3) * 1e3:.1f} ms; {len(ps)} "
          f"streams equal a fresh engine's on the loaded weights {same}, "
          f"launches {counts} ({card})", flush=True)
    del eng, new
    torch.cuda.empty_cache()
    _need_flash(counts, "slice (d)")
    if busy.state != "done" or not refused or not all(same):
        raise PhaseError("slice (d): the swap was not refused while busy, "
                         "or the swapped streams differ")
    return counts


def _serve_frontend(model, prompts, streams, card: str):
    """(e): the 16 prompts submitted through a Frontend from 4 threads;
    every future resolves to the Engine's stream."""
    import threading

    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine
    from chainermn_torch.serving.frontend import Frontend

    n = SERVE_REST["frontend_threads"]
    eng = Engine(model, engine_config())
    got = {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with Frontend(eng) as fe:
        def client(t):
            futs = [(i, fe.submit(prompts[i]))
                    for i in range(t, len(prompts), n)]
            for i, f in futs:
                got[i] = fe.result(f, timeout_ms=300_000).tokens

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launches()
    same = sum(got.get(i) == s for i, s in enumerate(streams))
    print(f"slice (e) Frontend: {len(prompts)} requests from {n} threads, "
          f"{same}/{len(prompts)} futures resolved to the Engine's streams, "
          f"wall {wall:.3f} s, {eng.report.summary()['tokens_emitted']} "
          f"tokens, launches {counts} ({card})", flush=True)
    _need_flash(counts, "slice (e)")
    if same != len(prompts) or fe.error is not None:
        raise PhaseError(f"slice (e): {same} of {len(prompts)} futures "
                         f"resolved to the Engine's streams ({fe.error!r})")
    return counts


def serving_rest(model, prompts, streams, seed: int, plain_rate: str,
                 card: str, mark):
    """The slice phase's (a)-(e) on the served model; ``streams`` are the
    plain engine's greedy streams of ``prompts``. Returns the flash_fwd
    launches of all five (each counted from 0 around its own runs) and
    the chunk-versus-decode logit gap (c) measured."""
    import torch

    total, gap = 0, None
    for name, run in (
            ("int8", lambda: _serve_int8(model, prompts, streams, card)),
            ("migration", lambda: _serve_migration(model, prompts, streams,
                                                   card)),
            ("speculative", lambda: _serve_speculative(
                model, prompts, streams, seed, plain_rate, card)),
            ("swap", lambda: _serve_swap(model, prompts, seed, card)),
            ("frontend", lambda: _serve_frontend(model, prompts, streams,
                                                 card))):
        got = run()
        if name == "speculative":
            got, gap = got
        total += got["flash_fwd"]
        torch.cuda.empty_cache()
        mark(f"slice {name}")
    return total, gap


# the serving fleet on the served model: the fleet phase's (a)-(d)
FLEET = dict(kill_step=3, drain_min_tokens=2, replicas=2, perturb=0.1,
             relay_chunk_mib=8, walk_gap_s=0.5, disagg_prompts=8,
             drain_prompts=8,
             host_requests=4, host_prompt_len=512, host_new=32,
             host_timeout=300, health_timeout_ms=300_000)

# one fleet_lm host: its own entry point (its log lines stamped with
# the seconds since the process started), then the launches it made
_FLEET_HOST_SCRIPT = r"""
import json, sys, time
t0 = time.perf_counter()
from chainermn_torch.ops import _cuda
from chainermn_torch.tools import fleet_lm
fleet_lm._log = lambda msg: print(
    f'[{time.perf_counter() - t0:.2f}s] fleet_lm: {msg}', file=sys.stderr,
    flush=True)
rc = fleet_lm.main(sys.argv[1:])
print('launches ' + json.dumps(_cuda.launches()), flush=True)
print(f'host seconds {time.perf_counter() - t0:.2f}', flush=True)
sys.exit(rc)
"""


def _host_times(text: str) -> str:
    """A host log's start-up and total seconds: the stamp of its
    ``queued`` line (the model built and its weights loaded) and the
    process's own count."""
    import re

    loaded = re.search(r"\[([0-9.]+)s\] fleet_lm: warm weights", text)
    up = re.search(r"\[([0-9.]+)s\] fleet_lm: queued", text)
    total = re.search(r"host seconds ([0-9.]+)", text)
    return (f"weights at {loaded.group(1) if loaded else '?'} s, up "
            f"{up.group(1) if up else '?'} s, done "
            f"{total.group(1) if total else '?'} s")


def _fleet_host_argv(model, seed: int, rank: int, endpoints: str,
                     weights: str, out: str, report: str):
    """``fleet_lm``'s flags for one of two hosts serving the served
    model at full width with ``engine_config()``'s slots and capacity."""
    cfg, f = engine_config(), FLEET
    return ["--hosts", "2", "--host-rank", str(rank), "--prefill-hosts",
            "1", "--transport", "socket", "--endpoints", endpoints,
            "--streamed", "--weights", weights, "--out", out, "--report",
            report, "--vocab", str(model.vocab), "--d-model",
            str(model.d_model), "--n-heads", str(model.n_heads),
            "--n-layers", str(model.n_layers), "--d-ff", str(model.d_ff),
            "--dtype", "bfloat16", "--attention", "flash", "--slots",
            str(cfg.n_slots), "--capacity", str(cfg.capacity),
            "--decode-k", str(cfg.decode_k), "--requests",
            str(f["host_requests"]), "--prompt-len",
            str(f["host_prompt_len"]), "--max-new-tokens",
            str(f["host_new"]), "--seed", str(seed),
            "--handoff-deadline-s", str(f["host_timeout"] - 60)]


def _fleet_hosts_start(model, seed: int, work: str):
    """(d)'s two runs of two ``fleet_lm`` hosts (the second with a
    ``reset_conn`` fault on the prefill host), started in the background
    on the served model published once; (a)-(c) run meanwhile."""
    from chainermn_torch.comm.socket_plane import pick_free_endpoints
    from chainermn_torch.serving.weights import publish_weights

    weights = os.path.join(work, "weights.npz")
    t0 = time.perf_counter()
    publish_weights(model.state_dict(), weights)
    publish_s = time.perf_counter() - t0
    runs = {}
    for name, fault in (("clean", None), ("reset_conn", "reset_conn@times=1")):
        d = os.path.join(work, name)
        os.makedirs(d)
        eps = ",".join(pick_free_endpoints(2))
        procs = []
        for rank in (1, 0):
            env = dict(os.environ, PYTHONPATH=HERE,
                       CHAINERMN_TPU_RPC_PROBE_MS="30000")
            env.pop("CHAINERMN_TPU_CHAOS", None)
            if fault and rank == 0:
                env["CHAINERMN_TPU_CHAOS"] = fault
            log = open(os.path.join(d, f"h{rank}.log"), "w")
            procs.append((rank, log, subprocess.Popen(
                [sys.executable, "-c", _FLEET_HOST_SCRIPT,
                 *_fleet_host_argv(model, seed, rank, eps, weights,
                                   os.path.join(d, "s.jsonl"),
                                   os.path.join(d, "report.json"))],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)))
        runs[name] = (d, procs, time.perf_counter())
    return runs, publish_s, os.path.getsize(weights)


def _fleet_hosts_finish(model, runs, seed: int, gap: float, card: str,
                        publish):
    """(d): wait for both runs; each merged JSONL against an in-process
    Engine on the same config and prompts (divergences under the gap),
    the faulted run's JSONL equal to the clean one's, the transport
    counters of the merged reports. Returns the hosts' launches."""
    import glob

    import numpy as np

    from chainermn_torch.fleet import FleetReport
    from chainermn_torch.serving.engine import Engine, EngineConfig

    f, cfg = FLEET, engine_config()
    rows, total, times = {}, {}, {}
    for name, (d, procs, t0) in runs.items():
        deadline = t0 + f["host_timeout"]
        launched = {}
        for rank, log, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                for _r, _l, q in procs:
                    q.kill()
                raise PhaseError(f"fleet (d) {name}: host {rank} outlived "
                                 f"{f['host_timeout']} s")
            finally:
                log.close()
            text = open(os.path.join(d, f"h{rank}.log")).read()
            if p.returncode != 0:
                raise PhaseError(f"fleet (d) {name}: host {rank} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
            got = json.loads([ln for ln in text.splitlines()
                              if ln.startswith("launches ")][-1][9:])
            launched[rank] = got
            times[(name, rank)] = _host_times(text)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        wall = time.perf_counter() - t0
        merged = {}
        for path in sorted(glob.glob(os.path.join(d, "s.jsonl*"))):
            with open(path) as fh:
                for line in fh:
                    if line.strip():
                        r = json.loads(line)
                        merged[r["request_id"]] = r
        rep = FleetReport()
        for rank in (0, 1):
            with open(os.path.join(d, f"report.json.h{rank}")) as fh:
                rep.absorb(FleetReport.from_wire(json.load(fh)["fleet"]))
        rows[name] = (merged, rep.summary([])["fleet"]["transport"],
                      launched, wall, rep)
    merged, counters, launched, wall, rep = rows["clean"]
    # the oracle: one in-process engine, the hosts' config and prompts
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, model.vocab, (f["host_prompt_len"],)).astype(
        np.int32) for _ in range(f["host_requests"])]
    eng = Engine(model, EngineConfig(
        n_slots=cfg.n_slots, capacity=cfg.capacity,
        max_new_tokens=f["host_new"], prefill_cohort=1,
        buckets=[f["host_prompt_len"], cfg.capacity],
        decode_k=cfg.decode_k))
    reqs = [eng.submit(p, seed=seed + i) for i, p in enumerate(prompts)]
    eng.run_until_drained()
    want = [r.tokens for r in reqs]
    complete = sorted(merged) == list(range(f["host_requests"]))
    got = [merged.get(i, {}).get("tokens", []) for i in range(len(want))]
    n, margin = _divergences(model, prompts, want, got, gap)
    fmerged, fcounters, flaunched, fwall, frep = rows["reset_conn"]
    healed = fmerged == merged
    print(f"fleet (d) two hosts: python -m chainermn_torch.tools.fleet_lm "
          f"--hosts 2 --transport socket --streamed on the served model "
          f"(published once, {publish[1] / 1e6:.1f} MB in "
          f"{publish[0] * 1e3:.1f} ms), {f['host_requests']} requests of "
          f"{f['host_prompt_len']} tokens x {f['host_new']}, slots "
          f"{cfg.n_slots}, capacity {cfg.capacity}: {len(merged)} streams "
          f"in {wall:.1f} s (two runs of two processes on this card, "
          f"started beside (c)), {n} divergences from an in-process "
          f"Engine, worst "
          f"top-2 margin at one {margin:.4f} against the gap {gap:.4f}; "
          f"{rep.handoffs} handoffs, {rep.handoff_wire_bytes} wire bytes, "
          f"transport {counters}, launches {launched}; under reset_conn on "
          f"the prefill host: the same JSONL {healed}, transport "
          f"{fcounters}, launches {flaunched}; hosts (prefill, decode) "
          f"{ {n_: (times[(n_, 0)], times[(n_, 1)]) for n_ in rows} } "
          f"({card})", flush=True)
    for name, (_m, _c, lc, _w, _r) in rows.items():
        # the prefill host prefills; the decode host adopts and decodes
        _need_flash(lc[0], f"fleet (d) {name} prefill host")
    if not complete or (n and margin >= gap) or not healed:
        raise PhaseError(f"fleet (d): complete {complete}, {n} "
                         f"divergences at margin {margin} (gap {gap}), "
                         f"healed {healed}")
    if fcounters["reconnects"] < 1:
        raise PhaseError(f"fleet (d): reset_conn never reconnected "
                         f"({fcounters})")
    return total


def _fleet_rate(summ) -> str:
    done = summ["requests"]["completed"]
    return (f"ttft p50 {summ['ttft_ms']['p50']:.2f} ms, decode tokens/s "
            f"{(summ['tokens_emitted'] - done) / summ['wall_s']:.1f}")


def _fleet_router(model, prompts, streams, gap: float, plain_rate: str,
                  card: str):
    """(a): 2 replicas behind the Router with one killed by chaos, then a
    clean fleet with a replica drained mid-decode (live migration)."""
    import torch

    from chainermn_torch.fleet import Router
    from chainermn_torch.ops import _cuda
    from chainermn_torch.resilience import chaos
    from chainermn_torch.serving.engine import Engine

    f, total = FLEET, {}

    def run(spec, drain, prompts, streams):
        engines = [Engine(model, engine_config())
                   for _ in range(f["replicas"])]
        os.environ.pop(chaos.ENV_VAR, None)
        if spec:
            os.environ[chaos.ENV_VAR] = spec
        chaos._plan, chaos._plan_spec = None, None
        out = None
        try:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            with Router(engines, health_timeout_ms=f["health_timeout_ms"]
                        ) as router:
                futs = [router.submit(p) for p in prompts]
                if drain:
                    deadline = time.monotonic() + 120
                    while not any(len(r.tokens) >= f["drain_min_tokens"]
                                  for r in list(engines[1].active.values())):
                        if time.monotonic() > deadline:
                            raise PhaseError("fleet (a): nothing reached "
                                             "decode on replica 1")
                        time.sleep(0.001)
                    out = router.drain(1, deadline_ms=120_000)
                reqs = [router.result(fu, timeout_ms=300_000) for fu in futs]
                summ = router.summary()
            torch.cuda.synchronize()
        finally:
            os.environ.pop(chaos.ENV_VAR, None)
            chaos._plan, chaos._plan_spec = None, None
        counts = _cuda.launches()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        got = [r.tokens for r in reqs]
        n, margin = _divergences(model, prompts, streams, got, gap)
        return (time.perf_counter() - t0, got, summ, counts, n, margin, out)

    spec = f"kill_replica@step={f['kill_step']},replica=1"
    wall, got, summ, counts, n, margin, _ = run(spec, False, prompts,
                                                streams)
    fl = summ["fleet"]
    print(f"fleet (a) router: {f['replicas']} replicas (engine_config()), "
          f"16 requests, chaos {spec}: {sum(len(g) == 32 for g in got)}/16 "
          f"streams of 32 tokens, replicas_dead {fl['replicas_dead']}, "
          f"requeued {fl['requeued']}, wall {wall:.3f} s, "
          f"{_fleet_rate(summ)} (plain engine: {plain_rate}); {n} "
          f"divergences from the plain engine, worst top-2 margin at one "
          f"{margin:.4f} against the gap {gap:.4f}; launches {counts} "
          f"({card})", flush=True)
    _need_flash(counts, "fleet (a) router")
    if (not all(len(g) == 32 for g in got) or fl["replicas_dead"] != 1
            or fl["requeued"] < 1 or (n and margin >= gap)):
        raise PhaseError(f"fleet (a) router: {fl}, {n} divergences at "
                         f"margin {margin} (gap {gap})")
    k = f["drain_prompts"]
    wall, got, summ, counts, n, margin, out = run(None, True, prompts[:k],
                                                  streams[:k])
    fl = summ["fleet"]
    conserved = summ["tokens_emitted"] == sum(len(g) for g in got)
    print(f"fleet (a) drain: {k} requests, replica 1 drained mid-decode: "
          f"{out}, state "
          f"{fl['replica_states']}, {fl['migrations']} sessions migrated "
          f"({fl['migration_wire_bytes']} wire bytes), "
          f"{fl['migration_fallbacks']} fallbacks, tokens emitted "
          f"{summ['tokens_emitted']} = stream tokens "
          f"{sum(len(g) for g in got)}: {conserved}; wall {wall:.3f} s, "
          f"{_fleet_rate(summ)} (plain engine: {plain_rate}); {n} "
          f"divergences, worst top-2 margin at one {margin:.4f} against "
          f"the gap {gap:.4f}; launches {counts} ({card})", flush=True)
    _need_flash(counts, "fleet (a) drain")
    if (out["state"] != "DRAINED" or out["migrated"] < 1 or not conserved
            or fl["replicas_drained"] != 1 or (n and margin >= gap)):
        raise PhaseError(f"fleet (a) drain: {out}, {fl}, conserved "
                         f"{conserved}, {n} divergences at {margin}")
    return total


def _fleet_disagg(model, prompts, streams, gap: float, card: str):
    """(b): a prefill engine feeding a decode engine over
    ``InProcessTransport``: the f32 wire (bf16 pages at 2 B an element),
    int8-block (bytes, ratio, the calibrated logit bound), and the async
    conveyor against sync."""
    import dataclasses

    import numpy as np
    import torch

    from chainermn_torch.collectives.quantized import block_quantize
    from chainermn_torch.fleet import (DisaggregatedFleet, FleetReport,
                                       InProcessTransport, decode_handoff,
                                       encode_handoff)
    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine
    from chainermn_torch.serving.kv_cache import cache_bytes

    cfg, total, res = engine_config(), {}, {}
    n = FLEET["disagg_prompts"]
    prompts, streams = prompts[:n], streams[:n]
    for name, wf, asy in (("f32", "f32", False),
                          ("int8-block", "int8-block", False),
                          ("f32 async", "f32", True)):
        report = FleetReport()
        fleet = DisaggregatedFleet(Engine(model, cfg), Engine(model, cfg),
                                   wire_format=wf, report=report,
                                   transport=InProcessTransport(),
                                   async_conveyor=asy)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        ss = [fleet.submit(p) for p in prompts]
        fleet.run_until_drained()
        fleet.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launches()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        got = [s.tokens for s in ss]
        ttft = fleet.prefill.engine.report.summary()["ttft_ms"]["p50"]
        div, margin = _divergences(model, prompts, streams, got, gap)
        res[name] = dict(bytes=report.handoff_wire_bytes[wf],
                         handoffs=report.handoffs,
                         fallbacks=report.handoff_fallbacks,
                         stall=fleet.stats["stall_ms_total"],
                         xfer=fleet.stats["transfer_ms_total"],
                         overlap=fleet.overlap_fraction, n=div,
                         margin=margin,
                         wall=wall, counts=counts,
                         done=all(len(g) == 32 for g in got),
                         rate=(f"ttft p50 {ttft:.2f} ms, decode tokens/s "
                               f"{(sum(map(len, got)) - len(got)) / wall:.1f}"
                               f" (over the wall)"))
        del fleet
        torch.cuda.empty_cache()
    # the f32 wire carries bf16 pages at their own width: each handoff
    # is the fill's cache bytes plus the 16-byte key row
    want = sum(cache_bytes(model, 1, len(p)) + 16 for p in prompts)
    # the int8 logit error after a handoff against JAX's calibrated
    # bound: 10 x half the coarsest per-block scale
    one = dataclasses.replace(cfg, decode_k=1)
    a = Engine(model, one)
    held = [a.submit(p, max_new_tokens=1, hold=True) for p in prompts[:2]]
    a.run_until_drained()
    worst = step = 0.0
    for req, p in zip(held, prompts[:2]):
        h = a.export_handoff(req)
        logits = {}
        for wf in ("f32", "int8-block"):
            d = Engine(model, one)
            r = d.import_handoff(decode_handoff(*encode_handoff(h, wf)), p,
                                 max_new_tokens=2)
            d.step()
            logits[wf] = d.last_logits[r.slot]
            del d
        worst = max(worst, float(np.abs(logits["int8-block"]
                                        - logits["f32"]).max()))
        for page in h["pages"].values():
            for leaf in ("k", "v"):
                _q, s = block_quantize(torch.from_numpy(
                    page[leaf].reshape(-1)).to(torch.bfloat16))
                step = max(step, float(s.float().max()) / 2)
        a.release_held(req)
    del a
    r32, r8, ra = res["f32"], res["int8-block"], res["f32 async"]
    print(f"fleet (b) disaggregated: prefill engine -> decode engine over "
          f"InProcessTransport, {n} requests: f32 wire {r32['bytes']:,} B "
          f"for {r32['handoffs']} handoffs (bf16 pages at 2 B an element "
          f"plus the key row: {want:,} B), "
          f"{r32['xfer'] / max(1, r32['handoffs']):.2f} ms a handoff "
          f"(encode and send), {r32['rate']}, {r32['n']} divergences "
          f"(worst margin {r32['margin']:.4f}); int8-block wire "
          f"{r8['bytes']:,} B ({r8['bytes'] / r32['bytes']:.4f}x), "
          f"{r8['rate']}, {r8['n']} divergences (worst margin "
          f"{r8['margin']:.4f}), logit error after a handoff {worst:.4f} "
          f"against {TOL_INT8_STEPS:g} x half the coarsest block scale "
          f"{step:.5f} = {TOL_INT8_STEPS * step:.4f}; async conveyor: "
          f"overlap {ra['overlap']:.4f}, stall {ra['stall']:.2f} ms "
          f"against sync's {r32['stall']:.2f} ms, {ra['n']} divergences; "
          f"gap {gap:.4f}; launches f32 {r32['counts']}, int8 "
          f"{r8['counts']}, async {ra['counts']} ({card})", flush=True)
    for name, r in res.items():
        _need_flash(r["counts"], f"fleet (b) {name}")
        if (not r["done"] or r["fallbacks"] or r["handoffs"] != n
                or (name != "int8-block" and r["n"] and r["margin"] >= gap)):
            raise PhaseError(f"fleet (b) {name}: {r}")
    if r32["bytes"] != want or not 0 < worst <= TOL_INT8_STEPS * step:
        raise PhaseError(f"fleet (b): f32 wire {r32['bytes']} B (want "
                         f"{want}), int8 logit error {worst} (bound "
                         f"{TOL_INT8_STEPS} x {step})")
    if not ra["stall"] < r32["stall"]:
        raise PhaseError(f"fleet (b): the async conveyor stalled "
                         f"{ra['stall']} ms, sync {r32['stall']} ms")
    return total


def _fleet_rollout(model, prompts, streams, gap: float, seed: int,
                   snapshot: int, card: str):
    """(c): ``RolloutController`` walks the live router from the served
    weights (v1) to a seeded perturbation of them (v2): the canary
    passes, every stream is one version's, the relay's bytes against
    ``snapshot``, the bytes of the served weights' published file (v2
    has its shapes and dtypes, so its snapshot has as many)."""
    import copy
    import threading

    import torch

    from chainermn_torch.fleet import RolloutController, Router
    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine

    f, cfg = FLEET, engine_config()
    g = torch.Generator().manual_seed(seed + 3)
    v1 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    # v2: the LM head moved by a seeded fraction of its spread
    head = v1["lm_head.weight"]
    v2 = dict(v1, **{"lm_head.weight": head + f["perturb"] * float(
        head.std()) * torch.randn(head.shape, generator=g)})

    def make(params, version):
        eng = Engine(model, cfg, weights_version=version)
        eng.steps.load_params(params)
        return eng

    # the v2 oracle: the canary's prompts alone (what the canary engine
    # runs, bitwise), and all 16 for the one-version check
    t_oracle = time.perf_counter()
    canary = [(prompts[i], 0, 32) for i in range(2)]
    ora = make(v2, "v2")
    creqs = [ora.submit(p, max_new_tokens=n, seed=s) for p, s, n in canary]
    ora.run_until_drained()
    oreqs = [ora.submit(p) for p in prompts]
    ora.run_until_drained()
    del ora
    streams2 = [r.tokens for r in oreqs]
    engines = [Engine(model, cfg, weights_version="v1")
               for _ in range(f["replicas"])]
    half = len(prompts) // 2
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    t_oracle = t0 - t_oracle
    with Router(engines, health_timeout_ms=f["health_timeout_ms"]) as router:
        rc = RolloutController(router, make, like=v1,
                               chunk_bytes=f["relay_chunk_mib"] << 20)
        # traffic: half the prompts before the walk, the other half from
        # a client thread during it, the first half again after it
        futs = [(i, router.submit(prompts[i])) for i in range(half)]
        walking = threading.Event()

        def client():
            # one prompt every walk_gap_s while the walk runs
            for i in range(half, len(prompts)):
                if not walking.is_set():
                    return
                futs.append((i, router.submit(prompts[i])))
                time.sleep(f["walk_gap_s"])

        walking.set()
        th = threading.Thread(target=client)
        th.start()
        t_walk = time.perf_counter()
        out = rc.rollout(v2, "v2", canary_prompts=canary,
                         canary_oracle=[r.tokens for r in creqs])
        t_walk = time.perf_counter() - t_walk
        walking.clear()
        th.join(timeout=600)
        for i in range(len(prompts)):
            if i not in dict(futs):
                futs.append((i, router.submit(prompts[i])))
        after = [(i, router.submit(prompts[i])) for i in range(half)]
        reqs = [(i, router.result(fu, timeout_ms=300_000))
                for i, fu in futs + after]
        summ = router.summary()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launches()
    idx = [i for i, _r in reqs]
    got = [r.tokens for _i, r in reqs]
    model2 = None
    versions = []
    for p, x, s1, s2 in zip([prompts[i] for i in idx], got,
                            [streams[i] for i in idx],
                            [streams2[i] for i in idx]):
        if x == s1 or x == s2:
            versions.append("both" if s1 == s2 else
                            "v1" if x == s1 else "v2")
            continue
        # the version whose stream it follows longer: a divergence from
        # it must sit at a near tie (under the gap)
        pre = [next((j for j, (a, b) in enumerate(zip(x, s)) if a != b),
                    len(s)) for s in (s1, s2)]
        if pre[1] > pre[0] and model2 is None:
            model2 = copy.deepcopy(model)
            model2.load_state_dict(v2)
        ver, m, s = (("v1", model, s1) if pre[0] >= pre[1]
                     else ("v2", model2, s2))
        n, margin = _divergences(m, [p], [s], [x], gap)
        versions.append(ver if margin < gap else "mixed")
    del model2
    torch.cuda.empty_cache()
    n_after = len(after)
    after_v2 = sum(v in ("v2", "both") for v in versions[-n_after:])
    print(f"fleet (c) rolling update: v1 (served) -> v2 (the LM head + "
          f"{f['perturb']} x its std x N(0, 1), seed {seed + 3}) over "
          f"{f['replicas']} live replicas under traffic: "
          f"{out['status']} (canary of 2 prompts passed: "
          f"{out['status'] != 'aborted'}), versions "
          f"{summ['fleet']['weights_versions']}, {len(versions)} streams "
          f"({half} before the walk, {len(prompts) - half} during it, "
          f"{n_after} after it) by version "
          f"{ {v: versions.count(v) for v in sorted(set(versions))} }, "
          f"after it v2 {after_v2}/{n_after} "
          f"(v1 and v2 streams differ on "
          f"{sum(a != b for a, b in zip(streams, streams2))}/16 prompts), "
          f"{summ['fleet']['migrations']} migrations, "
          f"{summ['fleet']['migration_fallbacks']} skew fallbacks; relay "
          f"publisher egress {out['publisher_egress_bytes']:,} B, all hops "
          f"{out['relay_wire_bytes']:,} B against the snapshot's "
          f"{snapshot:,} B (the served weights' published file; "
          f"{out['relay_wire_bytes'] / snapshot:.3f}x); "
          f"wall {wall:.3f} s (the walk {t_walk:.3f} s; the v2 oracles "
          f"before it {t_oracle:.3f} s), launches {counts} ({card})",
          flush=True)
    _need_flash(counts, "fleet (c)")
    if (out["status"] != "completed" or "mixed" in versions
            or after_v2 != n_after
            or set(summ["fleet"]["weights_versions"].values()) != {"v2"}
            or out["publisher_egress_bytes"] < snapshot
            or not all(len(x) == 32 for x in got)):
        raise PhaseError(f"fleet (c): {out}, versions {versions}, "
                         f"{summ['fleet']}")
    return counts


def fleet(model, prompts, streams, gap: float, seed: int, plain_rate: str,
          card: str, mark):
    """The fleet phase, (a)-(d) on the served model; ``streams`` are the
    plain engine's greedy streams and ``gap`` the chunk-versus-decode
    logit gap the slice phase measured. (a) and (b) run alone (their
    times are held beside the plain engine's); (d)'s hosts start after
    them and run beside (c), whose numbers are bytes and versions.
    Returns the flash_fwd launches of all four."""
    import tempfile

    import torch

    total = 0
    for name, run in (
            ("router", lambda: _fleet_router(model, prompts, streams, gap,
                                            plain_rate, card)),
            ("disaggregated", lambda: _fleet_disagg(model, prompts, streams,
                                                   gap, card))):
        total += run()["flash_fwd"]
        torch.cuda.empty_cache()
        mark(f"fleet {name}")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        runs, *publish = _fleet_hosts_start(model, seed, d)
        try:
            for name, run in (
                    ("rollout", lambda: _fleet_rollout(
                        model, prompts, streams, gap, seed, publish[1],
                        card)),
                    ("hosts", lambda: _fleet_hosts_finish(
                        model, runs, seed, gap, card, publish))):
                total += run()["flash_fwd"]
                torch.cuda.empty_cache()
                mark(f"fleet {name}")
        finally:
            for _d, procs, _t in runs.values():
                for _r, log, p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    log.close()
    return total


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
    counts_f32 = _cuda.launches(torch.float32)
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
                wall=wall, steps=steps, counts=counts,
                counts_f32=counts_f32, peak=peak,
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
    convolutions and products (cuBLAS's ``nvjet`` kernels among them), the
    port's flash kernels, LayerNorm (its ``GammaBeta`` weight gradients
    too) and GELU, forward and backward, torch reductions (batch-norm statistics
    and gradient sums), torch elementwise kernels (batch norm's casts and
    arithmetic, ReLU, residual adds, pads), the optimizer's fused
    multi-tensor kernels, NCCL, and the rest."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != cuda}
    groups = {"conv/gemm": 0.0, "flash": 0.0, "layer_norm/gelu": 0.0,
              "reduce": 0.0, "elementwise": 0.0, "optimizer": 0.0,
              "nccl": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != cuda or e.key in host:
            continue
        name = e.key.lower()
        if "nccl" in name:
            kind = "nccl"
        elif "flash_" in name:
            kind = "flash"
        elif any(t in name for t in ("layer_norm", "gammabeta", "gelu")):
            kind = "layer_norm/gelu"
        elif "multi_tensor_apply" in name:
            kind = "optimizer"
        elif any(t in name for t in ("xmma", "cudnn", "conv", "gemm",
                                     "cutlass", "fprop", "dgrad", "wgrad",
                                     "sm80_", "sm90_", "nvjet")):
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


SEQ2SEQ = dict(n_train=8192, epochs=2, batch=64, bucket=32, units=256,
               layers=2, vocab=40000, check_steps=8, beam=4)
# config #4's first 8 steps on the card vs the same steps on the CPU from
# the same parameters and batches, f32 on both (TF32 off): cuDNN's LSTM and
# the 40,000-wide projection sum in other orders than the CPU's (~1e-6
# relative a step), and 8 Adam steps (lr * g / |g| moves weights whose
# gradient is near zero by a visible part of lr) carry that 10-100x; a
# wrong gradient moves the loss by more than 1e-2 within those steps:
#   |loss_card - loss_cpu| <= 1e-3 |loss_cpu|
TOL_SEQ2SEQ_LOSS_REL = 1e-3


def seq2seq(card: str, profile_dir=None):
    """Config #4 through the port's seq2seq example
    (``chainermn_torch.examples.train_seq2seq``: ``build``, its training
    loop and its translate demo): the JAX module's full width
    (``Seq2Seq()`` defaults: 2 layers x 256 units, vocabulary 40,000 on
    both sides), one NCCL rank, per-rank batch 64, bucket 32, synthetic
    pairs, f32 with TF32 off. Its first 8 losses are first run on the CPU
    from the same parameters and batches. With ``profile_dir``, 20 more
    steps run under torch.profiler (kernel and host tables)."""
    import torch

    from chainermn_torch.examples import train_seq2seq
    from chainermn_torch.ops import _cuda

    c, k = SEQ2SEQ, SEQ2SEQ["check_steps"]
    argv = ["--communicator", "pure_nccl", "--epoch", str(c["epochs"]),
            "--unit", str(c["units"]), "--layer", str(c["layers"]),
            "--vocab", str(c["vocab"]), "--n-train", str(c["n_train"]),
            "--batchsize", str(c["batch"]), "--bucket", str(c["bucket"])]
    args = train_seq2seq.parse_args(argv + ["--device", "cpu"])
    run = train_seq2seq.build(args)
    cpu = [float(run.step(*(torch.from_numpy(a) for a in
                            train_seq2seq.pad_batch(run.iterator.next(),
                                                    args.bucket)))
                 ["main/loss"]) for _ in range(k)]
    run.comm.finalize()
    del run

    args = train_seq2seq.parse_args(argv)
    run = train_seq2seq.build(args)
    step, tokens = run.step, [0]

    def counting_step(src, src_len, tgt_in, tgt_out):
        tokens[0] += int((tgt_out != 0).sum())      # target tokens (host)
        return step(src, src_len, tgt_in, tgt_out)

    run.step = counting_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    history, _ = train_seq2seq.train_loop(run, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    greedy, bleu = train_seq2seq.translate_demo(run, args)
    args.beam = c["beam"]
    beam, beam_bleu = train_seq2seq.translate_demo(run, args)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    peak = torch.cuda.max_memory_allocated()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        batches = [train_seq2seq.pad_batch(run.iterator.next(), args.bucket)
                   for _ in range(20)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for arrays in batches:
                run.step(*(torch.from_numpy(a) for a in arrays))
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy_us = write_kernel_table(prof, profile_dir, "seq2seq", card,
                                     pwall)
        write_host_table(prof, profile_dir, "seq2seq", card, 20)
        print(f"profile seq2seq: wall {pwall:.4f} s for 20 steps (profiler "
              f"on, batches assembled before), device busy "
              f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / pwall:.4f} of "
              f"wall; device ms by kind " + ", ".join(
                  f"{g} {t:.3f}" for g, t in kernel_groups(prof).items())
              + f" ({card})", flush=True)
    run.comm.finalize()
    losses = [float(m["main/loss"]) for m in history]
    steps = len(losses)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[:k], cpu))
    print(f"seq2seq: Seq2Seq {c['layers']}x{c['units']} LSTM, vocabulary "
          f"{c['vocab']}, {steps} steps ({c['epochs']} epochs of "
          f"{c['n_train']} synthetic pairs, per-rank batch {c['batch']}, "
          f"bucket {c['bucket']}, f32) in {wall:.4f} s, "
          f"{wall / steps * 1e3:.3f} ms/step, target tokens/s per "
          f"chip {tokens[0] / wall:.1f}, peak memory "
          f"{peak / 2 ** 30:.4f} GiB, first loss {losses[0]:.6g}, final "
          f"loss {losses[-1]:.6g}, BLEU greedy {bleu:.4f} beam-{c['beam']} "
          f"{beam_bleu:.4f}, first {k} losses card "
          f"{[round(x, 6) for x in losses[:k]]} cpu "
          f"{[round(x, 6) for x in cpu]} worst relative difference "
          f"{err:.2e} (tolerance {TOL_SEQ2SEQ_LOSS_REL}), launches {counts} "
          f"({card})", flush=True)
    if err > TOL_SEQ2SEQ_LOSS_REL:
        raise PhaseError(f"the card's first {k} seq2seq losses are "
                         f"{err:.2e} (relative) from the CPU's, above "
                         f"{TOL_SEQ2SEQ_LOSS_REL}")
    if not losses[-1] < losses[0]:
        raise PhaseError(f"the seq2seq loss did not fall: {losses[0]} -> "
                         f"{losses[-1]}")
    for name, hyp in (("greedy", greedy), (f"beam-{c['beam']}", beam)):
        if hyp.shape != (4, c["bucket"]) or not (
                (hyp >= 0) & (hyp < c["vocab"])).all():
            raise PhaseError(f"{name} decoding gave {hyp.shape} tokens "
                             f"outside [0, {c['vocab']})")
    if any(counts.values()):
        raise PhaseError(f"the seq2seq path launched hand-written kernels: "
                         f"{counts}")
    return counts


MODEL_PARALLEL = dict(ranks=4, stages=4, unit=200, batch=256, epochs=2,
                      n_train=2048, check_steps=4)
# config #5 split over 4 ranks on one card vs the unsplit MLP on the card:
# the same Linear and ReLU products on the same device, shapes and
# parameters, and host staging copies bits exactly, so the losses are
# expected to agree to the bit; the bound leaves room for a library that
# picks another GEMM algorithm in another process:
#   |loss_split - loss_unsplit| <= 1e-5 |loss_unsplit|
TOL_MODEL_PARALLEL_REL = 1e-5

# one rank of the model-parallel world: the example's main, its launch
# counts (zeroed just before) on its last line
_RANK_SCRIPT = (
    "import json, sys\n"
    "from chainermn_torch.examples import train_mnist_model_parallel as m\n"
    "from chainermn_torch.ops import _cuda\n"
    "_cuda.reset_launches()\n"
    "m.main(sys.argv[1:])\n"
    "print('launches ' + json.dumps(_cuda.launches()), flush=True)\n")

# two host-staged ranks on one card: round trips of one activation (256 x
# 200 f32) through comm.send/recv (header, staging, gloo), beside raw gloo
# round trips of the same bytes from page-locked host memory and the
# device-host copies alone; rank 0 prints the ms of each
_PINGPONG_SCRIPT = (
    "import json, time, torch, torch.distributed as dist\n"
    "from chainermn_torch.comm import create_communicator\n"
    "comm = create_communicator('non_cuda_aware')\n"
    "r, n = comm.rank, 50\n"
    "x = torch.randn(256, 200, device=comm.device)\n"
    "h = torch.empty(256, 200, pin_memory=True)\n"
    "def comm_rt():\n"
    "    if r == 0:\n"
    "        comm.send(x, 1)\n"
    "        comm.recv(1)\n"
    "    else:\n"
    "        comm.send(comm.recv(0), 0)\n"
    "def gloo_rt():\n"
    "    if r == 0:\n"
    "        dist.send(h, 1)\n"
    "        dist.recv(h, 1)\n"
    "    else:\n"
    "        dist.recv(h, 0)\n"
    "        dist.send(h, 0)\n"
    "def copies():\n"
    "    h.copy_(x)\n"
    "    x.copy_(h)\n"
    "    torch.cuda.synchronize()\n"
    "out = {}\n"
    "for name, fn in (('comm', comm_rt), ('gloo', gloo_rt),\n"
    "                 ('copies', copies)):\n"
    "    for _ in range(5):\n"
    "        fn()\n"
    "    comm.barrier()\n"
    "    t0 = time.perf_counter()\n"
    "    for _ in range(n):\n"
    "        fn()\n"
    "    out[name] = (time.perf_counter() - t0) / n * 1e3\n"
    "comm.barrier()\n"
    "comm.finalize()\n"
    "if r == 0:\n"
    "    print('pingpong ' + json.dumps(out), flush=True)\n")

# two ranks that ask for NCCL on one card: each must refuse, naming the
# host-staged communicator
_NCCL_SCRIPT = (
    "from chainermn_torch.comm import create_communicator\n"
    "try:\n"
    "    create_communicator('pure_nccl')\n"
    "except RuntimeError as e:\n"
    "    print('refused: ' + str(e), flush=True)\n")


def run_ranks(argv, n: int, timeout: float, local=None):
    """Start ``argv`` as ranks 0..n-1 of one world on this card (a free
    localhost port; ``local`` ranks a node, default all ``n``); returns
    each rank's output. A rank that fails or outlives ``timeout`` fails
    the phase, and every rank is stopped."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    local = local or n
    env = dict(os.environ, PYTHONPATH=HERE, WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(local), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r),
                                       LOCAL_RANK=str(r % local)))
             for r in range(n)]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise PhaseError(f"{argv[:3]}: a rank outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise PhaseError(f"rank {r} of {argv[:3]} exited "
                             f"{p.returncode}:\n{out[-3000:]}")
    return outs


def model_parallel(card: str, beside_build):
    """Config #5: ``train_mnist_model_parallel`` as a world of 4 processes
    on this one card through ``create_communicator("non_cuda_aware")`` at
    the example's widths (784-200-200-200-10 in 4 stages, batch 256, 2
    epochs of 2,048, Adam 1e-3); its first losses are held to the unsplit
    MLP's on the card (the same parameters and batches). Then
    ``train_mnist_eager_p2p`` on 2 ranks, a point-to-point round trip
    between 2 host-staged ranks beside raw gloo and the copies alone, and
    2 ranks that ask for NCCL on this card must refuse and name
    ``non_cuda_aware`` (those two worlds ran beside the build:
    ``beside_build`` is :func:`model_parallel_beside_build`'s result)."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from chainermn_torch.examples import train_mnist_model_parallel as mp

    c, k = MODEL_PARALLEL, MODEL_PARALLEL["check_steps"]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        argv = ["--communicator", "non_cuda_aware", "--stages",
                str(c["stages"]), "--unit", str(c["unit"]), "--batchsize",
                str(c["batch"]), "--epoch", str(c["epochs"]), "--n-train",
                str(c["n_train"]), "--out", d]
        t0 = time.perf_counter()
        outs = run_ranks([sys.executable, "-c", _RANK_SCRIPT, *argv],
                         c["ranks"], timeout=300)
        world_s = time.perf_counter() - t0
        with open(os.path.join(d, "log.json")) as f:
            log = json.load(f)
    counts = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("launches ")]
        for name, n in json.loads(line[-1][len("launches "):]).items():
            counts[name] = counts.get(name, 0) + n

    # the unsplit MLP: the same blocks, batches and optimizer in one
    # process on the card
    model = torch.nn.Sequential(*mp.stage_blocks(c["stages"], c["unit"]))
    model.to("cuda")
    opt = mp.adam(model.parameters())
    it = mp.SerialIterator(mp.synthetic_mnist(c["n_train"], seed=0),
                           c["batch"], shuffle=True, seed=0)
    unsplit = []
    for _ in range(k):
        x, y = mp.batch_arrays(it.next(), "cuda")
        loss = F.cross_entropy(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        unsplit.append(loss.item())
    losses = log["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[:k], unsplit))
    print(f"model_parallel: MultiNodeChainList MLP 784-"
          f"{'-'.join([str(c['unit'])] * (c['stages'] - 1))}-10 in "
          f"{log['stages']} stages on {log['ranks']} ranks of one card "
          f"(non_cuda_aware), batch {c['batch']}, {len(losses)} steps, "
          f"{log['ms_per_step']:.3f} ms/step, host-staged bytes per step "
          f"(each rank's copies, rank 0) "
          f"{log['staged_bytes_per_step']:.0f}, world wall {world_s:.2f} s "
          f"(process start included), first loss {losses[0]:.6g}, final "
          f"loss {losses[-1]:.6g}, first {k} losses split "
          f"{[round(x, 6) for x in losses[:k]]} unsplit "
          f"{[round(x, 6) for x in unsplit]} worst relative difference "
          f"{err:.2e} (tolerance {TOL_MODEL_PARALLEL_REL}), launches "
          f"{counts} ({card})", flush=True)
    if err > TOL_MODEL_PARALLEL_REL:
        raise PhaseError(f"the split MLP's first {k} losses are {err:.2e} "
                         f"(relative) from the unsplit MLP's")
    if not losses[-1] < losses[0]:
        raise PhaseError(f"the model-parallel loss did not fall: "
                         f"{losses[0]} -> {losses[-1]}")
    if any(counts.values()):
        raise PhaseError(f"the model-parallel path launched hand-written "
                         f"kernels: {counts}")

    outs, eager_s, nccl = beside_build
    steps = [ln for ln in outs[1].splitlines() if ln.startswith("step")]
    print(f"model_parallel eager: train_mnist_eager_p2p on 2 ranks of one "
          f"card (non_cuda_aware), run beside the build: {eager_s:.2f} s "
          f"(process start included), {steps} ({card})", flush=True)
    if "rank 1 done" not in outs[1]:
        raise PhaseError(f"train_mnist_eager_p2p did not finish:\n"
                         f"{outs[1][-3000:]}")

    outs = run_ranks([sys.executable, "-c", _PINGPONG_SCRIPT], 2,
                     timeout=120)
    pp = json.loads([ln for ln in outs[0].splitlines()
                     if ln.startswith("pingpong ")][-1][len("pingpong "):])
    print(f"model_parallel p2p: one activation (204,800 bytes) there and "
          f"back between two host-staged ranks of one card: comm.send/recv "
          f"{pp['comm']:.4f} ms, raw gloo from page-locked memory "
          f"{pp['gloo']:.4f} ms, the device-host copies alone "
          f"{pp['copies']:.4f} ms ({card})", flush=True)

    if not all("refused" in o and "non_cuda_aware" in o for o in nccl):
        raise PhaseError(f"two NCCL ranks on one card were not refused:\n"
                         f"{nccl}")
    print(f"model_parallel nccl: two pure_nccl ranks on one card refused, "
          f"naming non_cuda_aware (run beside the build) ({card})",
          flush=True)
    return counts


def model_parallel_beside_build():
    """The model_parallel phase's two worlds that time nothing, run on a
    thread beside the kernels' build (nvcc keeps the host busy, the card
    idles): ``train_mnist_eager_p2p`` on 2 ranks, then 2 ranks that ask
    for NCCL on this card. Returns (the example's outputs, its wall s,
    the refusal world's outputs); the phase checks them."""
    t0 = time.perf_counter()
    outs = run_ranks([sys.executable, "-m", "chainermn_torch.examples."
                      "train_mnist_eager_p2p", "--communicator",
                      "non_cuda_aware"], 2, timeout=300)
    eager_s = time.perf_counter() - t0
    nccl = run_ranks([sys.executable, "-c", _NCCL_SCRIPT], 2, timeout=120)
    return outs, eager_s, nccl


VIT = dict(batch=64, image=224, n_train=640, iterations=24, fixed_calls=10,
           check_batch=4, check_steps=2, dropout=0.1,
           dropout_iterations=3, ckpt_n_train=512, ckpt_iterations=8,
           ckpt_every=4, ckpt_warmup_epochs=0.5)
# ViT-S/16 bf16, 2 steps at batch 4 on the card vs the CPU from the same
# parameters and batches (SGD 0.1, Nesterov momentum 0.9): each device
# rounds every activation to bf16 after its own sums (the card's flash
# kernel against the CPU's plain attention, cuBLAS against the CPU's
# GEMMs). On the CPU the bf16 model drifts from the f32 one by 1.4e-3
# in the loss and 7.4e-3 in the update (relative L2 over all parameters;
# the worst tensor, pos_emb, 1.0e-2) after these 2 steps; two bf16 runs
# that round in other places stay within the same bounds. A wrong
# projection, mask or gradient on one device is off by O(1):
#   |loss_card - loss_cpu| <= 1e-2 |loss_cpu|
#   |update_card - update_cpu| <= 0.1 |update_cpu| (all parameters)
TOL_VIT_LOSS_REL = 1e-2
TOL_VIT_UPDATE_REL = 0.1
# the resumed run's losses after the snapshot vs the uninterrupted run's
# (bf16 compute): the restored state is the saved one bit for bit, but
# the two runs' first steps may differ in their last bits, because
# flash_bwd sums dq with f32 atomics in no fixed order (ROADMAP.md queue
# 2 item 2) and a bf16 cast can round such a sum either way (the phase
# prints how far two runs of the same first steps are apart); a lost
# momentum buffer, LR schedule or iterator position moves a loss by far
# more:
#   |loss_resumed - loss_uninterrupted| <= 2e-2 |loss_uninterrupted|
TOL_CKPT_LOSS_REL = 2e-2


def _vit_check(seed: int):
    """Two steps of ViT-S/16 (bf16, batch 4, 224², SGD 0.1 with Nesterov
    momentum 0.9, as ``train_imagenet --model vit`` builds it) through
    the port's step on the CPU (a gloo world of one) and then on the
    card (NCCL), from the same parameters (``torch.manual_seed(seed)``,
    drawn on the CPU) and batches. Returns (cpu losses, card losses,
    worst relative loss difference, relative update difference over all
    parameters, worst tensor and its difference)."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models.vit import ViT
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training.step import make_data_parallel_train_step

    v = VIT
    gen = torch.Generator().manual_seed(seed + 1)
    shape = (v["check_steps"], v["check_batch"], v["image"], v["image"], 3)
    xs = torch.rand(shape, generator=gen)
    ys = torch.randint(0, 1000, shape[:2], generator=gen)
    out = {}
    for device in ("cpu", "cuda"):
        comm = create_communicator("pure_nccl", device=device)
        torch.manual_seed(seed)
        model = ViT(num_classes=1000, dtype=torch.bfloat16, device=device)
        init = {k: t.detach().cpu().clone()
                for k, t in model.state_dict().items()}
        opt = create_multi_node_optimizer(torch.optim.SGD(
            model.parameters(), lr=0.1, momentum=0.9, nesterov=True), comm)
        step = make_data_parallel_train_step(model, opt, comm,
                                             scan_steps=v["check_steps"])
        losses = step(xs, ys)["main/loss"].tolist()
        out[device] = (losses, {k: t.detach().cpu() for k, t in
                                model.state_dict().items()})
        comm.finalize()
        del model, opt, step
    (lc, sc), (lg, sg) = out["cpu"], out["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for n in sc:
        dc, dg = sc[n] - init[n], sg[n] - init[n]
        num += ((dg - dc) ** 2).sum().item()
        den += (dc ** 2).sum().item()
        rel = ((dg - dc).norm() / dc.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, n
    torch.cuda.empty_cache()
    return lc, lg, loss_err, (num / den) ** 0.5, worst_name, worst


def _vit_argv(out: str, iterations: int, n_train: int, *extra):
    v = VIT
    return ["--model", "vit", "--iterations", str(iterations),
            "--batchsize", str(v["batch"]), "--image-size", str(v["image"]),
            "--n-train", str(n_train), "--out", out, *extra]


def _expect_vit_launches(counts, steps: int, what: str) -> None:
    want = {"flash_fwd": 12 * steps, "flash_bwd": 12 * steps, "ce_fwd": 0,
            "ce_dh": 0, "ce_dw": 0}
    if counts != want:
        raise PhaseError(f"{what}: launches {counts}, expected {want} (12 "
                         f"flash_fwd and 12 flash_bwd a step, no CE kernel)")


def vit(seed: int, card: str, profile_dir=None):
    """``train_imagenet --model vit`` at full width: ViT-S/16 (d_model
    384, 12 layers, 6 heads, d_ff 1536, ``pool="gap"``, 1000 classes),
    bf16 compute over f32 parameters, 224² images, per-rank batch 64, SGD
    0.1 with Nesterov momentum 0.9, one NCCL rank, over the JAX example's
    synthetic set (``VIT["n_train"]`` images, epochs repeated). First
    :func:`_vit_check` holds 2 steps at batch 4 on the card to the CPU.
    Launch counts are zeroed just before the example's run and read just
    after: 12 ``flash_fwd`` and 12 ``flash_bwd`` a step, no CE kernel.
    Then the step alone on one fixed batch on the card (its device-bound
    rate), and ``--dropout 0.1`` for 3 iterations (dropout keys on the
    card). With ``profile_dir``, 5 fixed-batch steps and 5 example
    iterations run under torch.profiler. Returns the launch counts of
    the example runs and the fixed-batch calls."""
    import tempfile

    import torch

    from chainermn_torch.examples import train_imagenet
    from chainermn_torch.ops import _cuda

    v = VIT
    lc, lg, loss_err, upd_err, worst_name, worst = _vit_check(seed)
    print(f"vit check: 2 steps at batch {v['check_batch']}, {v['image']}², "
          f"bf16: losses card {[round(x, 6) for x in lg]} cpu "
          f"{[round(x, 6) for x in lc]}, worst relative loss difference "
          f"{loss_err:.2e} (tolerance {TOL_VIT_LOSS_REL}), relative update "
          f"difference over all parameters {upd_err:.4f} (tolerance "
          f"{TOL_VIT_UPDATE_REL}; worst tensor {worst_name} {worst:.4f}) "
          f"({card})", flush=True)
    if loss_err > TOL_VIT_LOSS_REL or upd_err > TOL_VIT_UPDATE_REL:
        raise PhaseError("the ViT's steps on the card disagree with the "
                         "CPU's")

    total = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        trainer, model = train_imagenet.build_trainer(
            train_imagenet.parse_args(_vit_argv(d, v["iterations"],
                                                v["n_train"])))
        comm, up = trainer.updater.comm, trainer.updater
        step, losses, first_done = up.step_fn, [], []

        def recording(*arrays):
            m = step(*arrays)
            losses.append(m["main/loss"])   # stays on the device
            if not first_done:
                # one synchronise, after the first step only: the rest of
                # the run is timed from there
                torch.cuda.synchronize()
                first_done.append(time.perf_counter())
            return m

        up.step_fn = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        trainer.run()
        torch.cuda.synchronize()
        rest = time.perf_counter() - first_done[0]
        counts = _cuda.launches()
        peak = torch.cuda.max_memory_allocated()
        steps = up.iteration
        _expect_vit_launches(counts, steps, "train_imagenet --model vit")
        total = dict(counts)
        loss = torch.stack(losses).float().tolist()
        ms = rest / (steps - 1) * 1e3
        ips = (steps - 1) * v["batch"] * comm.size / rest
        t0 = time.perf_counter()
        for _ in range(10):
            up.converter(next(up.iterator))
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        # the step alone on one batch already on the card
        x, y = up.shard_batch(up.converter(next(up.iterator)))
        step(x, y)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        for _ in range(v["fixed_calls"]):
            m = step(x, y)
        last = float(m["main/loss"])
        fixed = (time.perf_counter() - t0) / v["fixed_calls"]
        fixed_counts = _cuda.launches()
        _expect_vit_launches(fixed_counts, v["fixed_calls"],
                             "the ViT step on a fixed batch")
        total = {k: total[k] + fixed_counts[k] for k in total}
        finite = all(l == l and abs(l) < float("inf")
                     for l in loss + [last])
        head, tail = sum(loss[:3]) / 3, sum(loss[-3:]) / 3
        print(f"vit: train_imagenet --model vit, ViT-S/16 bf16, batch "
              f"{v['batch']} at {v['image']}², {steps} iterations over "
              f"{v['n_train']} synthetic images: {ms:.3f} ms/step over the "
              f"last {steps - 1}, images/s per chip {ips / comm.size:.1f}, "
              f"host batch assembly {host_ms:.3f} ms/batch; the step alone "
              f"on a fixed batch on the card {fixed * 1e3:.3f} ms/step, "
              f"images/s per chip {v['batch'] / fixed:.1f}; peak memory "
              f"{peak / 2 ** 30:.3f} GiB; losses {[round(l, 4) for l in loss]}"
              f" (finite {finite}; mean of the first 3 {head:.4f}, of the "
              f"last 3 {tail:.4f}: {'falls' if tail < head else 'does not fall'}"
              f"), launches {counts} ({card})", flush=True)
        if not finite:
            raise PhaseError("the ViT's loss is not finite")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            for stem, fn in (("vit", lambda: step(x, y)),
                             ("vit_example", up.update)):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                    pwall = time.perf_counter() - t0
                busy_us = write_kernel_table(prof, profile_dir, stem, card,
                                             pwall)
                write_host_table(prof, profile_dir, stem, card, 5)
                groups = kernel_groups(prof)
                print(f"profile {stem}: wall {pwall:.4f} s for 5 steps "
                      f"(profiler on), device busy {busy_us / 1e3:.3f} ms = "
                      f"{busy_us / 1e6 / pwall:.4f} of wall; device ms by "
                      f"kind " + ", ".join(
                          f"{g} {t:.3f}" for g, t in groups.items())
                      + f" ({card})", flush=True)
        comm.finalize()
        del trainer, model, step, up, x, y
        torch.cuda.empty_cache()

        trainer, _ = train_imagenet.build_trainer(train_imagenet.parse_args(
            _vit_argv(d, v["dropout_iterations"], 3 * v["batch"],
                      "--dropout", str(v["dropout"]))))
        _cuda.reset_launches()
        trainer.run()
        torch.cuda.synchronize()
        dcounts = _cuda.launches()
        dloss = trainer.observation["main/loss"]
        _expect_vit_launches(dcounts, v["dropout_iterations"],
                             "train_imagenet --model vit --dropout")
        trainer.updater.comm.finalize()
        print(f"vit dropout: train_imagenet --model vit --dropout "
              f"{v['dropout']} (with_rng: masks from generators on the card "
              f"keyed by iteration, rank and site), "
              f"{v['dropout_iterations']} iterations, last loss {dloss:.6f}, "
              f"launches {dcounts} ({card})", flush=True)
        if not dloss == dloss:
            raise PhaseError("the ViT's loss with dropout is not finite")
        total = {k: total[k] + dcounts[k] for k in total}
        del trainer
        torch.cuda.empty_cache()
    return total


_CKPT_SCRIPT = r"""
import json, os, sys, time
import torch
from chainermn_torch.examples import train_imagenet
from chainermn_torch.extensions import checkpoint as ck_mod

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
report, k = sys.argv[1], int(sys.argv[2])
argv = sys.argv[3:]
res = {}
Ck = ck_mod.MultiNodeCheckpointer
plain_call, stalls = Ck.__call__, []


def timed_call(self, trainer):
    torch.cuda.synchronize()   # the step's own work is not the stall
    t0 = time.perf_counter()
    plain_call(self, trainer)
    stalls.append((time.perf_counter() - t0) * 1e3)


Ck.__call__ = timed_call
trainer, model = train_imagenet.build_trainer(
    train_imagenet.parse_args(argv))
up = trainer.updater
losses, step = [], up.step_fn

def recording(*arrays):
    m = step(*arrays)
    losses.append(m["main/loss"])
    return m

up.step_fn = recording
from chainermn_torch.ops import _cuda
start = up.iteration
torch.cuda.synchronize()
_cuda.reset_launches()
trainer.run()
torch.cuda.synchronize()
res["launches"] = _cuda.launches()
res["steps"] = up.iteration - start
res["iterations"] = up.iteration
res["losses"] = [float(l) for l in losses]
res["async_stall_ms"] = stalls
fn = os.path.join(trainer.out, "imagenet", f"snapshot_iter_{k}.0")
res["bytes"] = os.path.getsize(fn)
sync = Ck("sync", up.comm, path=trainer.out)
times = []
for i in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync.save(up.state, 100 + i)
    times.append((time.perf_counter() - t0) * 1e3)
res["sync_save_ms"] = times
up.comm.finalize()
with open(report, "w") as f:
    json.dump(res, f)
print("checkpoint run OK", flush=True)
"""


def checkpoint(card: str):
    """The ViT through ``train_imagenet --model vit`` with a snapshot
    every ``k = VIT["ckpt_every"]`` iterations, uninterrupted for
    ``VIT["ckpt_iterations"]``, in one process on this card, with a
    warm-up schedule (so the state holds its ``LambdaLR``). Prints the
    snapshot bytes, the async save's stall on the training thread and
    three synchronous saves in ms. The restore of snapshot k in a new
    process (bit for bit the saved npz, the resumed losses within
    ``TOL_CKPT_LOSS_REL`` of this run's, resume ms) is resilience (a)'s
    second incarnation. Returns the run's launch counts (12 flash_fwd and
    12 flash_bwd a step) and its losses."""
    import tempfile

    v = VIT
    n, k = v["ckpt_iterations"], v["ckpt_every"]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        report = os.path.join(d, "full.json")
        argv = _vit_argv(os.path.join(d, "full"), n, v["ckpt_n_train"],
                         "--warmup-epochs", str(v["ckpt_warmup_epochs"]),
                         "--snapshot-every", str(k))
        proc = subprocess.run(
            [sys.executable, "-c", _CKPT_SCRIPT, report, str(k), *argv],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not os.path.exists(report):
            raise PhaseError(f"checkpoint run exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
        with open(report) as f:
            full = json.load(f)
    print(f"checkpoint: ViT-S/16 bf16, train_imagenet --model vit "
          f"--warmup-epochs {v['ckpt_warmup_epochs']}, batch {v['batch']}, "
          f"{n} iterations uninterrupted with --snapshot-every {k}: "
          f"snapshot {full['bytes']} bytes a rank, synchronous save ms "
          f"{[round(t, 3) for t in full['sync_save_ms']]}, async save's "
          f"stall on the training thread ms "
          f"{[round(t, 3) for t in full['async_stall_ms']]}; losses "
          f"{[round(l, 5) for l in full['losses']]}; the restore of "
          f"snapshot {k} in a new process is resilience (a)'s ({card})",
          flush=True)
    if len(full["losses"]) != n or len(full["async_stall_ms"]) != n // k:
        raise PhaseError("checkpoint: the run's steps or snapshots are off")
    _expect_vit_launches(full["launches"], full["steps"], "checkpoint")
    return full["launches"], full["losses"]


REDUCERS = dict(timed_calls=5, mnist_units=1000, mnist_n_train=8192,
                mnist_batch=256, world_ranks=4, world_local=2)
# a quantized reduction vs the unquantized one: each element within half
# a quantization step s (the block's or bucket's max |g| / qmax), plus the
# f32 rounding of code * s and of the check's own difference, each at
# most 2^-24 of a value up to qmax (127) steps:
#   |out - in| <= (0.5 + 2 * 127 * 2^-24) s
TOL_QUANT_STEP = 0.5 + 2 * 127 * 2 ** -24


def _reducer_cases(comm):
    """(name, reducer) for every strategy and wire format, built as a
    user builds them."""
    from chainermn_torch.collectives import make_grad_reducer

    cases = [("flat", make_grad_reducer("flat", comm)),
             ("hierarchical", make_grad_reducer("hierarchical", comm))]
    cases += [(f"quantized {wf}", make_grad_reducer(
        "quantized", comm, wire_format=wf))
        for wf in ("bf16", "int8", "int8-block", "int4-block")]
    return cases + [("auto", make_grad_reducer("auto", comm))]


def _quant_steps(red, leaves):
    """Per element of each bucket of ``red``'s plan: the quantization
    step of a fresh (zero-residual) reduction of ``leaves`` on one rank,
    as one flat tensor in plan order (0 for bf16: checked bitwise)."""
    import torch
    import torch.nn.functional as F

    qmax = 7.0 if red.mode == "int4-block" else 127.0
    out = []
    for _, _, bucket in red._plan(leaves):
        v = torch.cat([leaves[i].reshape(-1) for i in bucket]).abs()
        k = 256 if red.mode.endswith("-block") else v.numel()
        b = F.pad(v, (0, (-v.numel()) % k)).reshape(-1, k)
        out.append((b.amax(1, keepdim=True) / qmax).expand(-1, k).reshape(
            -1)[:v.numel()])
    return torch.cat(out)


def _reducers_resnet50(seed: int, card: str):
    """(a): ResNet-50's gradient tree through every reducer on one NCCL
    rank (module docstring). Returns ms a reduction by reducer."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models import ResNet50

    comm = create_communicator("pure_nccl")
    try:
        params = list(ResNet50(num_classes=1000).parameters())
        n = sum(p.numel() for p in params)
        g = torch.Generator(device="cuda").manual_seed(seed)
        # magnitudes over four decades, leaf by leaf
        grads0 = [torch.randn(p.shape, generator=g, device="cuda")
                  * 10.0 ** (i % 4 - 3) for i, p in enumerate(params)]
        flat_in = torch.cat([t.reshape(-1) for t in grads0])
        times = {}
        for name, red in _reducer_cases(comm):
            grads = [t.clone() for t in grads0]
            state = red.init(params)
            before = comm.collective_bytes
            grads, state = red.reduce(grads, state)
            torch.cuda.synchronize()
            counted = comm.collective_bytes - before
            plan = red.plan(params)
            wire = sum(r["wire_bytes"] for r in plan)
            flat_out = torch.cat([t.reshape(-1) for t in grads])
            if name.startswith("quantized"):
                if red.mode == "bf16":
                    ok = torch.equal(flat_out, flat_in.bfloat16().float())
                    worst = 0.0
                else:
                    steps = _quant_steps(red, grads0)
                    worst = ((flat_out - flat_in).abs() / steps).max().item()
                    ok = worst <= TOL_QUANT_STEP
                resid = torch.equal(torch.cat(list(state)),
                                    flat_in - flat_out)
            else:
                ok, worst, resid = torch.equal(flat_out, flat_in), 0.0, True
            # one rank: the hierarchical reducer's tiers are single ranks
            # and call no collective
            bytes_ok = counted == (0 if name == "hierarchical" else wire)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REDUCERS["timed_calls"]):
                grads, state = red.reduce(grads, state)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / REDUCERS["timed_calls"]
            times[name] = ms
            algos = sorted({r["algorithm"] for r in plan})
            print(f"reducers resnet50: {name}: {ms:.4f} ms a reduction of "
                  f"{n:,} f32 gradients ({4 * n:,} B) in {len(plan)} "
                  f"buckets {algos}, wire {wire:,} B a step by the plan, "
                  f"{counted:,} B handed to NCCL, worst |error| / step "
                  f"{worst:.4f}, residual = input - dequantized: {resid} "
                  f"({card})", flush=True)
            if not (ok and resid and bytes_ok):
                raise PhaseError(f"reducer {name}: output ok {ok} (worst "
                                 f"{worst}), residual ok {resid}, bytes "
                                 f"{counted} vs plan {wire}")
        return times
    finally:
        comm.finalize()


def _reducers_mnist(card: str):
    """(b): ``train_mnist`` with each gradient reducer; returns the
    strategies' losses."""
    import tempfile

    import torch

    from chainermn_torch.examples import train_mnist

    runs = {"flat": [], "hierarchical": [],
            "quantized int8-block": ["--wire-format", "int8-block"],
            "auto": []}
    losses = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        for name, extra in runs.items():
            argv = ["--epoch", "1", "--unit", str(REDUCERS["mnist_units"]),
                    "--n-train", str(REDUCERS["mnist_n_train"]),
                    "--batchsize", str(REDUCERS["mnist_batch"]),
                    "--out", d, "--grad-reducer", name.split()[0], *extra]
            trainer, _ = train_mnist.build_trainer(
                train_mnist.parse_args(argv))
            step, seen = trainer.updater.step_fn, []

            def recording(*arrays, step=step, seen=seen):
                m = step(*arrays)
                seen.append(m["main/loss"])
                return m

            trainer.updater.step_fn = recording
            t0 = time.perf_counter()
            try:
                trainer.run()
            finally:
                trainer.updater.comm.finalize()
            wall = time.perf_counter() - t0
            losses[name] = torch.stack(seen).tolist()
            ls = losses[name]
            print(f"reducers mnist: --grad-reducer {name}: {len(ls)} steps "
                  f"in {wall:.4f} s ({wall / len(ls) * 1e3:.3f} ms/step), "
                  f"loss {ls[0]:.6g} -> {ls[-1]:.6g} ({card})", flush=True)
            if not (all(map(math.isfinite, ls)) and ls[-1] < ls[0]):
                raise PhaseError(f"train_mnist --grad-reducer {name}: "
                                 f"losses not finite and falling: {ls}")
    for name in ("hierarchical", "auto"):
        if losses[name] != losses["flat"]:
            raise PhaseError(f"train_mnist --grad-reducer {name}: losses "
                             f"differ from flat's")
    return losses


# one rank of (c): 4 host-staged ranks on this card, two "nodes" of two;
# the MNIST MLP's gradient shapes with integer values in [-8, 8) (every
# rank makes every rank's from one seed); rank 0 prints the results
_REDUCER_WORLD_SCRIPT = (
    "import json, time, torch\n"
    "import torch.nn.functional as F\n"
    "from chainermn_torch.collectives import (FlatReducer,\n"
    "    HierarchicalReducer, QuantizedReducer)\n"
    "from chainermn_torch.comm import create_communicator\n"
    "from chainermn_torch.ops import _cuda\n"
    "_cuda.reset_launches()\n"
    "comm = create_communicator('non_cuda_aware')\n"
    "r, n = comm.rank, comm.size\n"
    "g = torch.Generator().manual_seed(0)\n"
    "shapes = [(1000, 784), (1000,), (1000, 1000), (1000,), (10, 1000),\n"
    "          (10,)]\n"
    "every = [torch.randint(-8, 8, (n, *s), generator=g).float()\n"
    "         for s in shapes]\n"
    "mine = [t[r].to(comm.device) for t in every]\n"
    "def run(red, state=()):\n"
    "    xs = [t.clone() for t in mine]\n"
    "    comm.barrier()\n"
    "    t0 = time.perf_counter()\n"
    "    xs, _ = red.reduce(xs, state)\n"
    "    torch.cuda.synchronize()\n"
    "    return xs, (time.perf_counter() - t0) * 1e3\n"
    "flat, hier = FlatReducer(comm), HierarchicalReducer(comm)\n"
    "q = QuantizedReducer(comm, wire_format='int8-block')\n"
    "ms = {}\n"
    "for _ in range(2):\n"
    "    f, ms['flat'] = run(flat)\n"
    "    h, ms['hierarchical'] = run(hier)\n"
    "    qq, ms['int8-block'] = run(q, q.init(mine))\n"
    "worst = 0.0\n"
    "for _, _, bucket in q._plan(mine):\n"
    "    v = torch.cat([every[i].reshape(n, -1) for i in bucket], 1)\n"
    "    k = v.shape[1]\n"
    "    step = F.pad(v.abs(), (0, (-k) % 256)).reshape(n, -1, 256).amax(\n"
    "        2).amax(0) / 127.0\n"
    "    step = step[:, None].expand(-1, 256).reshape(-1)[:k]\n"
    "    got = torch.cat([qq[i].reshape(-1).cpu() for i in bucket])\n"
    "    want = torch.cat([f[i].reshape(-1).cpu() for i in bucket])\n"
    "    worst = max(worst, ((got - want).abs() / step).max().item())\n"
    "out = {'device': str(comm.device), 'nodes': [comm.intra_size,\n"
    "       comm.inter_size], 'tiers': [hier.topology.intra,\n"
    "       hier.topology.inter], 'ms': ms,\n"
    "       'hier_equal': all(torch.equal(a, b) for a, b in zip(h, f)),\n"
    "       'flat_exact': all(torch.equal(a.cpu(), t.mean(0))\n"
    "                         for a, t in zip(f, every)),\n"
    "       'int8_worst_over_step': worst, 'launches': _cuda.launches(),\n"
    "       'staged_bytes': comm.staged_bytes}\n"
    "outs = comm.allgather_obj(out)\n"
    "comm.finalize()\n"
    "if r == 0:\n"
    "    print('world ' + json.dumps(outs), flush=True)\n")


def reducers(seed: int, card: str):
    """The gradient reducers: (a) ResNet-50's gradient tree on one NCCL
    rank, (b) ``train_mnist --grad-reducer``, (c) 4 host-staged ranks on
    this card as two nodes of two (module docstring). Launch counts are
    zeroed just before and read just after; returns them."""
    import torch

    from chainermn_torch.ops import _cuda

    _cuda.reset_launches()
    _reducers_resnet50(seed, card)
    torch.cuda.empty_cache()
    _reducers_mnist(card)
    torch.cuda.synchronize()
    counts = _cuda.launches()
    outs = run_ranks([sys.executable, "-c", _REDUCER_WORLD_SCRIPT],
                     REDUCERS["world_ranks"], timeout=300,
                     local=REDUCERS["world_local"])
    world = json.loads([ln for ln in outs[0].splitlines()
                        if ln.startswith("world ")][-1][len("world "):])
    w0 = world[0]
    print(f"reducers world: 4 host-staged ranks of one card as 2 nodes x 2 "
          f"(non_cuda_aware, LOCAL_WORLD_SIZE=2), devices "
          f"{sorted({w['device'] for w in world})}, hierarchical tiers "
          f"intra x inter {w0['tiers']}, MNIST MLP gradients (1,796,010 "
          f"f32), ms a reduction (rank 0) {w0['ms']}, hierarchical == flat "
          f"bitwise {all(w['hier_equal'] for w in world)}, int8-block worst "
          f"|error| / step {max(w['int8_worst_over_step'] for w in world):.4f}"
          f", host-staged bytes (rank 0) {w0['staged_bytes']:,} ({card})",
          flush=True)
    for w in world:
        for name, v in w["launches"].items():
            counts[name] = counts.get(name, 0) + v
        if not (w["device"] == "cuda:0" and w["nodes"] == [2, 2]
                and w["tiers"] == [2, 2] and w["hier_equal"]
                and w["flat_exact"]
                and w["int8_worst_over_step"] <= TOL_QUANT_STEP):
            raise PhaseError(f"reducers on 4 ranks of one card: {w}")
    if any(counts.values()):
        raise PhaseError(f"the reducers launched hand-written kernels: "
                         f"{counts}")
    return counts

# the ZeRO world runs inside the FSDP world (FSDP's world_* shape)
ZERO = dict(steps=4, bucket_mib=25, micro=2, world_bucket_mib=4,
            check_steps=2,
            r50_iterations=8, vit_iterations=8, lm_iterations=4, lm_batch=4,
            lm_bucket_kib=4096)
# ZeRO on one rank against the data-parallel step, bf16 compute: the same
# arithmetic, but the ZeRO parameters are views in flax's layout (a
# Linear's weight transposed), so cuBLAS takes other kernels and the bf16
# activations round in other places; AdamW moves every weight by about lr
# whatever its gradient's size, so those last bits move a weight whose
# gradient is near zero by up to 2 lr. Over 4 steps:
#   |loss_zero - loss_dp| <= 2e-3 |loss_dp|  (a wrong reduction or a lost
#   bucket moves the 4th loss by more than 1e-2)
#   ||p_zero - p_dp|| <= 0.1 ||p_dp - p_0||  (all parameters, L2)
TOL_ZERO_LOSS_REL = 2e-3
TOL_ZERO_UPDATE_REL = 0.1
# 4 host-staged ranks, f32 with TF32 off, two sequences a rank (ZeRO-2
# accumulates them as two micro-batches), against one rank fed all eight:
# the same products, the gradient summed over ranks and micro-batches in
# another order (~1e-6 relative), over 2 steps. SGD with momentum, whose
# update scales with the gradient, so a sum where the mean belongs (a
# lost 1/N moves the update by 3x its size, a lost 1/2 over the
# micro-batches by 1x) fails the update bound; one Adam run for its state
# bytes, held as the SGD runs are
TOL_ZERO_WORLD_LOSS_REL = 1e-4
TOL_ZERO_WORLD_UPDATE_REL = 0.05
# int8-block error feedback: the first loss precedes any update; the
# second follows one step on gradients within half a quantization step
# of the reference's an element
TOL_ZERO_QUANT_LOSS_REL = 5e-3
# train_imagenet --optimizer lars|lamb, the first 2 losses on the card vs
# the CPU from the same parameters and batches, f32 with TF32 off: the
# forward differs by f32 sums (~1e-6) that batch norm in train mode over
# a few values a channel amplifies (ResNet-50's bf16 check: 1.93e-4), and
# the second loss follows one trust-ratio step
TOL_LARGE_BATCH_LOSS_REL = 1e-3

# (b)'s ZeRO runs, inside the FSDP world script (its comm, one, toks, lm,
# OPTS and the references' named-parameter vectors zrefs): ZeRO-1/2 flat
# and bucketed, int8-block error feedback and Adam's state bytes
_ZERO_WORLD_RUNS = r"""
from chainermn_torch.optimizers import make_zero2_train_step
_cuda.reset_launches()
staged0 = comm.staged_bytes
zout = {'ref': {k: v[0] for k, v in zrefs.items()}, 'runs': {},
        'device': str(comm.device)}
for name, stage, bucket, wf, opt in (
        ('zero1-flat', 1, None, None, 'sgd'),
        ('zero1-bucketed', 1, zbb, None, 'sgd'),
        ('zero2-flat', 2, None, None, 'sgd'),
        ('zero2-bucketed', 2, zbb, None, 'sgd'),
        ('zero1-int8-block', 1, None, 'int8-block', 'sgd'),
        ('zero1-flat-adam', 1, None, None, 'adam')):
    zmodel = lm()
    kw = dict(loss_fn=fused_lm_loss, bucket_bytes=bucket, grad_reducer=(
        None if wf is None else QuantizedReducer(comm, wire_format=wf)))
    if stage == 1:
        step, st = make_zero1_train_step(zmodel, OPTS[opt], comm, **kw)
    else:
        step, st = make_zero2_train_step(zmodel, OPTS[opt], comm,
                                         n_microbatches=per, **kw)
    comm.barrier()
    t0 = time.perf_counter()
    losses = [step(toks[s, mine, :-1], toks[s, mine, 1:])[
        'main/loss'].item() for s in range(steps)]
    ms = (time.perf_counter() - t0) / steps * 1e3
    p = flatn(zero1_params(st, zmodel, bucket))
    _, p_ref, p0n = zrefs[opt]
    upd = ((p - p_ref).norm() / (p_ref - p0n).norm()).item()
    zout['runs'][name] = dict(
        opt=opt, stage=stage, losses=losses, ms=ms, update_rel=upd,
        state_bytes=st.optimizer_state_numel() * 4,
        padded=sum(st.layout.padded),
        fingerprint=[p.double().sum().item(), (p.double() ** 2).sum().item()])
    del zmodel, step, st, p
    torch.cuda.empty_cache()
zout['launches'] = _cuda.launches()
zout['launches_f32'] = _cuda.launches(torch.float32)
zout['staged_bytes'] = comm.staged_bytes - staged0
out['zero'] = zout
"""


def _zero_full_width(seed: int, card: str):
    """(a): the full-width LM on one NCCL rank through ZeRO-1/2 against
    the data-parallel step. Returns the ZeRO runs' launch counts (all on
    bf16 inputs)."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import (create_multi_node_optimizer,
                                            make_zero1_train_step,
                                            make_zero2_train_step,
                                            zero1_params)
    from chainermn_torch.training.step import make_data_parallel_train_step

    z = ZERO
    toks = train_tokens(seed)
    x = torch.as_tensor(toks[:, :-1], device="cuda").long()
    y = torch.as_tensor(toks[:, 1:], device="cuda").long()
    comm = create_communicator("pure_nccl")
    bb = z["bucket_mib"] << 20

    def adamw(params):
        # optax.adamw's defaults (decay 1e-4 on every leaf)
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    counts = {name: 0 for name in ("flash_fwd", "flash_bwd", "ce_fwd",
                                   "ce_dh", "ce_dw")}
    ref = start = None
    for name, stage, bucket in (("dp", 0, None), ("zero1-flat", 1, None),
                                ("zero1-bucketed", 1, bb),
                                ("zero2-bucketed", 2, bb)):
        model = build_model(seed, torch.bfloat16, "flash")
        if start is None:
            start = torch.cat([p.detach().reshape(-1).cpu() for _, p in
                               sorted(model.named_parameters())])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = opt = None
        if stage == 0:
            opt = create_multi_node_optimizer(adamw(model.parameters()), comm)
            step = make_data_parallel_train_step(model, opt, comm,
                                                 loss_fn=fused_lm_loss)
        elif stage == 1:
            step, state = make_zero1_train_step(
                model, adamw, comm, loss_fn=fused_lm_loss,
                bucket_bytes=bucket)
        else:
            step, state = make_zero2_train_step(
                model, adamw, comm, n_microbatches=z["micro"],
                loss_fn=fused_lm_loss, bucket_bytes=bucket)
        _cuda.reset_launches()
        losses = [step(x, y)["main/loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(z["steps"] - 1):
            losses.append(step(x, y)["main/loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (z["steps"] - 1)
        launched = _cuda.launches()
        launched_f32 = _cuda.launches(torch.float32)
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).tolist()
        if state is None:
            params = dict(model.named_parameters())
            sbytes = sum(t.numel() * t.element_size()
                         for s in opt.state.values() for t in s.values()
                         if torch.is_tensor(t) and t.ndim)
            grad_peak = None
        else:
            params = zero1_params(state, model, bucket)
            sbytes = state.optimizer_state_numel() * 4
            grad_peak = state.grad_bytes_peak
        flat = torch.cat([params[k].detach().reshape(-1).cpu()
                          for k in sorted(params)])
        del model, step, state, opt, params
        torch.cuda.empty_cache()
        extra = ""
        if ref is None:
            ref = (losses, flat)
        else:
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref[0]))
            upd = ((flat - ref[1]).norm() / (ref[1] - start).norm()).item()
            micro = z["micro"] if name.startswith("zero2") else 1
            want = {k: z["steps"] * micro * (12 if k.startswith("flash")
                                             else 1) for k in counts}
            extra = (f", vs dp: worst relative loss difference "
                     f"{loss_err:.3e} (tolerance {TOL_ZERO_LOSS_REL}), "
                     f"relative update difference {upd:.4f} (tolerance "
                     f"{TOL_ZERO_UPDATE_REL}), hook peak of live gradient "
                     f"bytes {grad_peak:,}")
            if loss_err > TOL_ZERO_LOSS_REL or upd > TOL_ZERO_UPDATE_REL:
                raise PhaseError(f"zero {name} disagrees with the "
                                 f"data-parallel step{extra}")
            if launched != want or any(launched_f32.values()):
                raise PhaseError(f"zero {name}: launches {launched} (f32 "
                                 f"{launched_f32}), expected {want}, none "
                                 f"f32")
            for k in counts:
                counts[k] += launched[k]
        if not all(math.isfinite(v) for v in losses):
            raise PhaseError(f"zero {name}: a loss is not finite")
        print(f"zero {name}: 135M LM bf16, seq {TRAIN['seq_len']}, batch "
              f"{TRAIN['batch']}, one NCCL rank, {z['steps']} steps: "
              f"{dt * 1e3:.3f} ms/step, tokens/s per chip "
              f"{TRAIN['batch'] * TRAIN['seq_len'] / dt:.1f}, peak "
              f"{peak / 2 ** 30:.3f} GiB, optimizer state {sbytes:,} B, "
              f"losses {[round(v, 5) for v in losses]}, launches "
              f"{launched}{extra} ({card})", flush=True)
    comm.finalize()
    return counts, {k: 0 for k in counts}


def _check_zero_world(world, card: str):
    """(b): the ZeRO runs of 4 host-staged ranks of this card, run inside
    the FSDP world (``_ZERO_WORLD_RUNS``); ``world`` is each rank's
    record. Returns their launches, and those of them on f32 inputs
    (all)."""
    z = dict(ZERO, **{k: v for k, v in FSDP.items()
                      if k.startswith("world_")})
    per = z["world_per_rank"]
    counts, f32 = {}, {}
    for w in world:
        for k, v in w["launches"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in w["launches_f32"].items():
            f32[k] = f32.get(k, 0) + v
    w0 = world[0]
    n = z["world_ranks"]
    steps = 0
    for name, run in w0["runs"].items():
        quant = "int8" in name
        ref = w0["ref"][run["opt"]]
        slots = 2 if run["opt"] == "adam" else 1
        micro = per if run["stage"] == 2 else 1
        steps += z["world_steps"] * micro * n
        errs = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref)]
        same = all(w["runs"][name]["fingerprint"] == run["fingerprint"]
                   and w["runs"][name]["losses"] == run["losses"]
                   for w in world)
        print(f"zero world {name}: 4 host-staged ranks of one card, LM "
              f"d 768 x {z['world_layers']} layers f32, seq "
              f"{z['world_seq']}, {per} sequences a rank"
              + (f" in {micro} micro-batches" if micro > 1 else "")
              + f", {'SGD momentum 0.9' if slots == 1 else 'Adam'}, "
              f"{z['world_steps']} steps: {run['ms']:.1f} ms/step (rank 0),"
              f" losses {[round(v, 6) for v in run['losses']]} vs one rank "
              f"fed every batch {[round(v, 6) for v in ref]} (relative "
              f"{[float(f'{e:.3e}') for e in errs]}), relative update "
              f"difference {run['update_rel']:.4f}, optimizer state "
              f"{run['state_bytes']:,} B a rank (padded {run['padded']:,} "
              f"/ {n} x {slots} x 4 B), gathered parameters equal on every "
              f"rank {same} ({card})", flush=True)
        ok = (same and run["state_bytes"] == run["padded"] // n * slots * 4
              and errs[0] <= TOL_ZERO_WORLD_LOSS_REL)
        if quant:
            ok = ok and max(errs) <= TOL_ZERO_QUANT_LOSS_REL
        else:
            ok = ok and (max(errs) <= TOL_ZERO_WORLD_LOSS_REL
                         and run["update_rel"] <= TOL_ZERO_WORLD_UPDATE_REL)
        if not ok:
            raise PhaseError(f"zero world {name} disagrees with one rank "
                             f"fed every batch: {run}")
    # steps: the forward-backward passes of every rank (a micro-batch
    # each)
    want = {"flash_fwd": z["world_layers"] * steps,
            "flash_bwd": z["world_layers"] * steps, "ce_fwd": steps,
            "ce_dh": steps, "ce_dw": steps}
    if counts != want or f32 != want:
        raise PhaseError(f"zero world: launches {counts} (f32 {f32}), "
                         f"expected {want}, all f32")
    print(f"zero world: devices {sorted({w['device'] for w in world})}, "
          f"launches of the 4 ranks {counts} (all f32), host-staged bytes "
          f"(rank 0) {w0['staged_bytes']:,} ({card})", flush=True)
    return counts, f32


def _timed_example(example, argv):
    """``example.build_trainer(example.parse_args(argv))`` run to its
    stop trigger on the card: (observation, ms a step after the first,
    launches, the launches on f32 inputs, peak bytes)."""
    import torch

    from chainermn_torch.ops import _cuda

    trainer, _ = example.build_trainer(example.parse_args(argv))
    step, first = trainer.updater.step_fn, []

    def timed(*arrays):
        m = step(*arrays)
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter())
        return m

    trainer.updater.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    try:
        trainer.run()
        torch.cuda.synchronize()
    finally:
        it = trainer.updater.iterator
        if hasattr(it, "close"):
            it.close()
        trainer.updater.comm.finalize()
    obs = trainer.observation
    ms = (time.perf_counter() - first[0]) / (obs["iteration"] - 1) * 1e3
    return (obs, ms, _cuda.launches(), _cuda.launches(torch.float32),
            torch.cuda.max_memory_allocated())


def _zero_large_batch(card: str):
    """(c): ``train_imagenet --optimizer lars|lamb``. Returns the card
    runs' launches, and those on f32 inputs (the checks')."""
    import tempfile

    import torch

    from chainermn_torch.examples import train_imagenet

    z, r, v = ZERO, RESNET50, VIT
    counts, f32 = {}, {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        for label, flags in (("resnet50", ["--image-size", "64"]),
                             ("vit", ["--model", "vit", "--image-size",
                                      "32"])):
            for name in ("lars", "lamb"):
                argv = flags + ["--optimizer", name, "--iterations",
                                str(z["check_steps"]), "--batchsize", "4",
                                "--n-train", "16", "--dtype", "float32",
                                "--out", d]
                res = run_example(train_imagenet, argv, z["check_steps"],
                                  card, None, "zero")
                print(f"zero {label} --optimizer {name} check: first "
                      f"{z['check_steps']} losses on the card "
                      f"{[round(x, 6) for x in res['card']]} vs the CPU "
                      f"{[round(x, 6) for x in res['cpu']]} (worst "
                      f"relative {res['err']:.3e}, tolerance "
                      f"{TOL_LARGE_BATCH_LOSS_REL}) ({card})", flush=True)
                if res["err"] > TOL_LARGE_BATCH_LOSS_REL:
                    raise PhaseError(f"train_imagenet --optimizer {name} "
                                     f"({label}) on the card disagrees "
                                     "with the CPU")
                for k, n in res["counts"].items():
                    counts[k] = counts.get(k, 0) + n
                for k, n in res["counts_f32"].items():
                    f32[k] = f32.get(k, 0) + n
        runs = {
            "resnet50": ["--loader", "--iterations",
                         str(z["r50_iterations"]), "--batchsize",
                         str(r["batch"]), "--image-size", str(r["image"]),
                         "--n-train", str(r["batch"] * z["r50_iterations"]),
                         "--out", d],
            "vit": _vit_argv(d, z["vit_iterations"], v["batch"]
                             * z["vit_iterations"])}
        for label, argv in runs.items():
            ms = []
            # SGD first and last: a process's first runs carry warm-ups
            # (cuDNN plans, the allocator) that a later run does not
            for name in ("sgd", "lars", "lamb", "sgd"):
                obs, t, launched, launched_f32, peak = _timed_example(
                    train_imagenet, argv + ["--optimizer", name])
                ms.append((name, t))
                if not math.isfinite(obs["main/loss"]):
                    raise PhaseError(f"train_imagenet {label} --optimizer "
                                     f"{name}: the loss is not finite")
                if label == "vit":
                    _expect_vit_launches(launched, z["vit_iterations"],
                                         f"vit --optimizer {name}")
                elif any(launched.values()):
                    raise PhaseError(f"the ResNet path launched "
                                     f"hand-written kernels: {launched}")
                if any(launched_f32.values()):
                    raise PhaseError(f"train_imagenet {label} bf16 launched "
                                     f"f32 kernels: {launched_f32}")
                for k, n in launched.items():
                    counts[k] = counts.get(k, 0) + n
            batch, iters = ((r["batch"], z["r50_iterations"])
                            if label == "resnet50"
                            else (v["batch"], z["vit_iterations"]))
            print(f"zero {label} train_imagenet --optimizer: ms/step after "
                  f"the first of {iters} at batch {batch}, 224², bf16, in "
                  f"this order: " + ", ".join(
                      f"{k} {t:.3f} ({batch / t * 1e3:.1f} images/s per "
                      f"chip)" for k, t in ms)
                  + f"; last peak {peak / 2 ** 30:.3f} GiB ({card})",
                  flush=True)
            torch.cuda.empty_cache()
    return counts, f32


def _zero_train_lm(card: str):
    """(d): ``train_lm --zero 1 --zero-bucket-kib 4096`` at full width.
    Returns its launches, and those on f32 inputs (all)."""
    import tempfile

    from chainermn_torch.examples import train_lm

    z = ZERO
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        argv = ["--zero", "1", "--zero-bucket-kib", str(z["lm_bucket_kib"]),
                "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
                "--vocab", "32768", "--seq-len", "2048", "--batchsize",
                str(z["lm_batch"]), "--n-train",
                str(z["lm_batch"] * z["lm_iterations"]), "--iterations",
                str(z["lm_iterations"]), "--out", d]
        obs, ms, launched, launched_f32, peak = _timed_example(train_lm,
                                                                argv)
    steps = z["lm_iterations"]
    want = {"flash_fwd": 12 * steps, "flash_bwd": 12 * steps, "ce_fwd": 0,
            "ce_dh": 0, "ce_dw": 0}
    print(f"zero train_lm --zero 1 --zero-bucket-kib {z['lm_bucket_kib']}: "
          f"d 768 x 12 layers, vocab 32768, seq 2048, batch "
          f"{z['lm_batch']}, f32: {ms:.3f} ms/step after the first of "
          f"{steps}, tokens/s per chip "
          f"{z['lm_batch'] * 2048 / ms * 1e3:.1f}, peak "
          f"{peak / 2 ** 30:.3f} GiB, last loss {obs['main/loss']:.5f}, "
          f"launches {launched} ({card})", flush=True)
    if not math.isfinite(obs["main/loss"]):
        raise PhaseError("train_lm --zero 1: the loss is not finite")
    if launched != want or launched_f32 != want:
        raise PhaseError(f"train_lm --zero 1: launches {launched} (f32 "
                         f"{launched_f32}), expected {want}, all f32")
    return launched, launched_f32


def zero(seed: int, card: str):
    """ZeRO-1/2 and LARS/LAMB, (a)-(d) of the module docstring. Returns
    the launches of the phase's main-path runs, and those of them on f32
    inputs."""
    import torch

    counts, f32 = {}, {}
    for part in (lambda: _zero_full_width(seed, card),
                 lambda: _zero_large_batch(card),
                 lambda: _zero_train_lm(card)):
        got, got_f32 = part()
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        for k, n in got_f32.items():
            f32[k] = f32.get(k, 0) + n
        torch.cuda.empty_cache()
    return counts, f32


FSDP = dict(steps=4, world_ranks=4, world_layers=2, world_seq=512,
            world_per_rank=2, world_steps=2,
            lm_iterations=4, lm_batch=4, lm_lr=3e-4)
# FSDP on one rank against the data-parallel step, bf16 compute: as ZeRO
# (a), the gathered parameters are views in flax's layout (a Linear's
# weight transposed), so cuBLAS takes other kernels and bf16 activations
# round in other places, and AdamW moves a weight whose gradient is near
# zero by up to 2 lr on those last bits: the ZeRO bounds.
TOL_FSDP_LOSS_REL = TOL_ZERO_LOSS_REL
TOL_FSDP_UPDATE_REL = TOL_ZERO_UPDATE_REL
# 4 host-staged ranks against one rank fed all eight sequences, f32: the
# ZeRO world's bounds (the same products, the reduction in another
# order); the quantized runs' losses as ZeRO's int8-block run's, and
# their quantized values within half a quantization step (below)
TOL_FSDP_WORLD_LOSS_REL = TOL_ZERO_WORLD_LOSS_REL
TOL_FSDP_WORLD_UPDATE_REL = TOL_ZERO_WORLD_UPDATE_REL
TOL_FSDP_QUANT_LOSS_REL = TOL_ZERO_QUANT_LOSS_REL
# mean of the error-feedback frame after regrouping 4 rows into 2: f32
# sums in another grouping, a few ulps of the largest residual
TOL_FSDP_EF_MEAN = 2 ** -20
# a quantized value against its exact one, in half quantization steps:
# round(x / s) is within 1/2 + |x / s| 2^-24 of x / s (the division
# rounds) and |x / s| <= 127, and the product q s rounds once more, so
# |x - q s| <= s/2 + 2 x 127 s 2^-24
TOL_FSDP_HALF_STEPS = 1 + 4 * 127 * 2 ** -24

_FSDP_COMMON = r"""
import hashlib, json, os, sys, time
import numpy as np
import torch
from chainermn_torch.checkpointing import reshard_state
from chainermn_torch.collectives import QuantizedReducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import (ShardedLeaf,
                                        create_multi_node_checkpointer)
from chainermn_torch.models.convert import flax_params
from chainermn_torch.models.transformer import (TransformerLM,
    make_lm_fsdp_scan_loss, stack_lm_blocks, unstack_lm_blocks)
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import (LAMB, create_multi_node_optimizer,
    fsdp_gather_params, fsdp_shardings, fsdp_stack_shardings,
    make_fsdp_train_step, make_zero1_train_step, zero1_params,
    zero_layout_manifest)
from chainermn_torch.training.step import make_data_parallel_train_step
torch.backends.cuda.matmul.allow_tf32 = False
layers, seq, per, steps = map(int, sys.argv[1:5])
ckdir = sys.argv[5]
comm = create_communicator('non_cuda_aware')
r, n = comm.rank, comm.size
OPTS = {'sgd': lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        'lamb': lambda ps: LAMB(ps, 1e-2, weight_decay=1e-4),
        'adam': lambda ps: torch.optim.Adam(ps, lr=3e-4, eps=1e-8)}
def lm():
    torch.manual_seed(0)
    return TransformerLM(vocab=32768, d_model=768, n_heads=12,
                         n_layers=layers, d_ff=3072, max_len=seq,
                         pos_emb='rope', device=comm.device)
def items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    else:
        yield path, tree
def flat(tree):
    return torch.cat([torch.as_tensor(v).detach().reshape(-1).float().cpu()
                      for _, v in items(tree)])
def scan_step(model, make):
    packed = stack_lm_blocks(flax_params(model))
    sh = dict(fsdp_shardings(packed, comm),
              blocks=fsdp_stack_shardings(packed, comm)['blocks'])
    return make_fsdp_train_step(None, make, comm, packed,
                                loss_fn=make_lm_fsdp_scan_loss(model),
                                param_shardings=sh)
def zero_ef_step(model):
    return make_zero1_train_step(
        model, OPTS['sgd'], comm, loss_fn=fused_lm_loss,
        grad_reducer=QuantizedReducer(comm, wire_format='int8-block'))
def sha(t):
    if torch.is_tensor(t):
        t = t.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()
def whole(v):
    # a sharded leaf whole on every rank (a collective)
    if not isinstance(v, ShardedLeaf):
        return v
    dims = [d for d, (a, b) in enumerate(v.index) if b - a != v.gshape[d]]
    if not dims:
        return v.local
    return torch.cat(comm.allgather(v.local).unbind(0), dim=dims[0])
def digest(state, params):
    # a hash of every parameter and optimizer tensor, whole
    h = [sha(v) for _, v in items(params)]
    for j, per_param in sorted(state.state_dict()['optimizer']['state']
                               .items()):
        for k, v in sorted(per_param.items()):
            h.append(sha(whole(v)) if torch.is_tensor(getattr(
                v, 'local', v)) else repr(v))
    return hashlib.sha256(''.join(h).encode()).hexdigest()
def fsdp_digest(state):
    return digest(state, fsdp_gather_params(state))
def zero_digest(state, model):
    return digest(state, {k: v for k, v in
                          zero1_params(state, model).items()})
def regrouped_row(state):
    # this rank's row of the frame regrouped onto half the ranks: the
    # pair mean (a + b) / 2, as ef_frame_regroup computes it
    pair = comm.split(('block', 2))
    row = pair.allreduce(state.residuals[0], 'sum') / 2
    pair.finalize()
    return row
def frame_mean(state):
    return (comm.allreduce(state.residuals[0], 'sum') / n).cpu()
"""

_FSDP_WORLD_SCRIPT = _FSDP_COMMON + r"""
zbb = int(sys.argv[6])               # the ZeRO runs' bucket bytes
one = comm.split(('block', 1))       # this rank alone: the reference
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, 32768, (steps, n * per, seq + 1), generator=g).to(
    comm.device)
def flatn(params):
    # the ZeRO runs' vector: named parameters in sorted-name order
    return torch.cat([params[k].detach().reshape(-1).float()
                      for k in sorted(params)])
refs, zrefs = {}, {}
for opt, make in OPTS.items():
    ref = lm()
    p0 = flat(flax_params(ref))
    p0n = flatn(dict(ref.named_parameters()))
    rstep = make_data_parallel_train_step(
        ref, create_multi_node_optimizer(make(ref.parameters()), one), one,
        loss_fn=fused_lm_loss)
    losses = [rstep(toks[s, :, :-1], toks[s, :, 1:])['main/loss'].item()
              for s in range(steps)]
    refs[opt] = (losses, flat(flax_params(ref)), p0)
    zrefs[opt] = (losses, flatn(dict(ref.named_parameters())), p0n)
    del ref, rstep
_cuda.reset_launches()
out = {'ref': {k: v[0] for k, v in refs.items()}, 'runs': {},
       'device': str(comm.device)}
mine = slice(r * per, (r + 1) * per)
keep = {}
for name, form, wire, red, opt in (
        ('fsdp', 'module', None, None, 'sgd'),
        ('fsdp-scan', 'scan', None, None, 'sgd'),
        ('fsdp-wire-int8-block', 'module', 'int8-block', None, 'sgd'),
        ('fsdp-reducer-int8-block', 'module', None, 'int8-block', 'sgd'),
        ('fsdp-lamb', 'module', None, None, 'lamb')):
    model = lm()
    if form == 'scan':
        step, st = scan_step(model, OPTS[opt])
        del model
    else:
        step, st = make_fsdp_train_step(
            model, OPTS[opt], comm, loss_fn=fused_lm_loss, param_wire=wire,
            grad_reducer=(None if red is None else QuantizedReducer(
                comm, wire_format=red, ef=False)))
    quant = {}
    if wire is not None:
        # each rank's shards through the wire's codec: within half a
        # step of each block's scale
        from chainermn_torch.collectives.quantized import block_dequantize
        from chainermn_torch.optimizers.zero import _jit_block_quantize
        worst = 0.0
        for s_ in st.shards:
            v = s_.detach().reshape(-1)
            blk = np.gcd(256, v.numel())
            q, sc = _jit_block_quantize(v, wire, blk)
            d = (block_dequantize(q, sc, v.numel(), wire, v.dtype, blk)
                 - v).abs().reshape(-1, blk)
            worst = max(worst, (d / (sc[:, None] / 2)).max().item())
        quant['wire_worst_half_steps'] = worst
    comm.barrier()
    t0 = time.perf_counter()
    if red is not None:
        # every reduced leaf's round trip through the wire format: within
        # half a quantization step of its input, block by block
        import chainermn_torch.optimizers.zero as zmod
        plain_rt = zmod._wire_roundtrip
        seen = []
        def checked(g, mode):
            o = plain_rt(g, mode)
            b = torch.nn.functional.pad(g.reshape(-1), (0, (-g.numel()) % 256))
            amax = b.view(-1, 256).abs().amax(1)
            sc = torch.where(amax > 0, amax * (1.0 / 127.0),
                             torch.ones_like(amax))
            e = torch.nn.functional.pad((o - g).reshape(-1), (
                0, (-g.numel()) % 256)).view(-1, 256).abs()
            seen.append((e / (sc[:, None] / 2)).max().item())
            return o
        zmod._wire_roundtrip = checked
    losses = []
    for s in range(steps):
        losses.append(step(toks[s, mine, :-1], toks[s, mine, 1:])[
            'main/loss'].item())
    if red is not None:
        zmod._wire_roundtrip = plain_rt
        quant['reduced_worst_half_steps'] = max(seen)
    ms = (time.perf_counter() - t0) / steps * 1e3
    tree = fsdp_gather_params(st)
    if form == 'scan':
        tree = unstack_lm_blocks(tree)
    p = flat(tree)
    ref_losses, p_ref, p0 = refs[opt]
    upd = ((p - p_ref).norm() / (p_ref - p0).norm()).item()
    out['runs'][name] = dict(
        opt=opt, form=form, quantized=bool(wire or red), losses=losses,
        ms=ms, update_rel=upd, state_bytes=st.optimizer_state_numel() * 4,
        gathered_peak=st.gathered_bytes_peak,
        layer_peak=st.layer_bytes_peak,
        fingerprint=[p.double().sum().item(), (p.double() ** 2).sum().item()],
        **quant)
    if name == 'fsdp-scan':
        keep['scan'] = st
    del step, st, p, tree
    torch.cuda.empty_cache()
# the ZeRO-1 int8-block state with error feedback, for the checkpoints
model = lm()
zstep, zst = zero_ef_step(model)
for s in range(steps):
    zstep(toks[s, mine, :-1], toks[s, mine, 1:])
out['launches'] = _cuda.launches()
out['launches_f32'] = _cuda.launches(torch.float32)
out['staged_bytes'] = comm.staged_bytes
""" + _ZERO_WORLD_RUNS + r"""
# (c): save both states on this world, restore them onto it
saved, ck_ms = {}, {}
scan = keep['scan']
for kind, st, layout in (
        ('fsdp-scan', scan, scan.manifest()),
        ('zero-ef', zst, zero_layout_manifest(model, comm))):
    ck = create_multi_node_checkpointer(kind, comm, path=ckdir)
    ck.set_layout(layout)
    comm.barrier()
    t0 = time.perf_counter()
    ck.save(st.state_dict(), steps)
    comm.barrier()
    ck_ms[kind] = (time.perf_counter() - t0) * 1e3
saved['fsdp-scan'] = fsdp_digest(scan)
saved['zero-ef'] = zero_digest(zst, model)
saved['zero-ef-row2'] = sha(regrouped_row(zst))
mean4 = frame_mean(zst)
saved['ef_max'] = zst.residuals[0].abs().max().item()
if r == 0:
    np.save(os.path.join(ckdir, 'ef_mean4.npy'), mean4.numpy())
rows2 = comm.allgather_obj(saved['zero-ef-row2'])
saved['zero-ef-rows2'] = [rows2[0], rows2[2]]
del keep, scan
torch.cuda.empty_cache()
restored = {}
t0 = time.perf_counter()
model2 = lm()
_, st2 = scan_step(model2, OPTS['sgd'])
del model2
ck = create_multi_node_checkpointer('fsdp-scan', comm, path=ckdir)
sd, it = reshard_state(ck, st2.state_dict(template=True))
st2.load_state_dict(sd)
restored['fsdp-scan'] = fsdp_digest(st2)
del st2, sd
model3 = lm()
_, zst3 = zero_ef_step(model3)
ck = create_multi_node_checkpointer('zero-ef', comm, path=ckdir)
sd, it = reshard_state(ck, zst3.state_dict(template=True))
zst3.load_state_dict(sd)
restored['zero-ef'] = zero_digest(zst3, model3)
restored['ms'] = (time.perf_counter() - t0) * 1e3
out['ckpt'] = dict(saved=saved, restored=restored, save_ms=ck_ms,
                   file_bytes={k: os.path.getsize(os.path.join(
                       ckdir, k, f'snapshot_iter_{steps}.{r}'))
                       for k in ('fsdp-scan', 'zero-ef')})
# (c) onto 2: this world's ranks 0 and 1, a communicator of their own,
# restore both states (ranks 2 and 3 wait); the helpers read the global
# comm and n, so they are the pair's while it restores
world = comm
pair = comm.split(('block', 2))
if r < 2:
    comm, n = pair, pair.size
    t0 = time.perf_counter()
    model = lm()
    _, st = scan_step(model, OPTS['sgd'])
    del model
    ck = create_multi_node_checkpointer('fsdp-scan', comm, path=ckdir)
    sd, it = reshard_state(ck, st.state_dict(template=True))
    st.load_state_dict(sd)
    got = {'fsdp-scan': fsdp_digest(st), 'iteration': it}
    del st, sd
    model = lm()
    _, zst2 = zero_ef_step(model)
    ck = create_multi_node_checkpointer('zero-ef', comm, path=ckdir)
    sd, it = reshard_state(ck, zst2.state_dict(template=True))
    zst2.load_state_dict(sd)
    got['zero-ef'] = zero_digest(zst2, model)
    got['row'] = sha(zst2.residuals[0])
    mean2 = frame_mean(zst2)
    got['ms'] = (time.perf_counter() - t0) * 1e3
    if r == 0:
        got['mean_err'] = (mean2 - mean4).abs().max().item()
    back_rows = comm.allgather_obj(got['row'])
    backs = comm.allgather_obj(got)
    if r == 0:
        backs[0]['rows'] = back_rows
        print('fsdp restore ' + json.dumps(backs[0]), flush=True)
    del zst2, sd
    comm, n = world, world.size
pair.finalize()
outs = comm.allgather_obj(out)
if r == 0:
    with open(os.path.join(ckdir, 'saved.json'), 'w') as f:
        json.dump(saved, f)
one.finalize()
comm.finalize()
if r == 0:
    print('fsdp world ' + json.dumps(outs), flush=True)
"""

def _flax_flat(tree):
    """A flax-layout tree (tensors or arrays) as one f32 CPU vector, its
    leaves in sorted-path order."""
    import torch

    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(torch.as_tensor(t).detach().reshape(-1).float().cpu())

    walk(tree)
    return torch.cat(out)


def _fsdp_full_width(seed: int, card: str):
    """(a): the full-width LM on one NCCL rank through FSDP, FSDP with
    remat and FSDP over the scanned stack, against the data-parallel
    step. Returns the FSDP runs' launch counts (all on bf16 inputs) and
    the scan's state (for (c))."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.models.convert import flax_params
    from chainermn_torch.models.transformer import (make_lm_fsdp_scan_loss,
                                                    stack_lm_blocks,
                                                    unstack_lm_blocks)
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import fused_lm_loss
    from chainermn_torch.optimizers import (create_multi_node_optimizer,
                                            fsdp_gather_params,
                                            fsdp_shardings,
                                            fsdp_stack_shardings,
                                            make_fsdp_train_step)
    from chainermn_torch.training.step import make_data_parallel_train_step

    f = FSDP
    toks = train_tokens(seed)
    x = torch.as_tensor(toks[:, :-1], device="cuda").long()
    y = torch.as_tensor(toks[:, 1:], device="cuda").long()
    comm = create_communicator("pure_nccl")

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    counts = {name: 0 for name in ("flash_fwd", "flash_bwd", "ce_fwd",
                                   "ce_dh", "ce_dw")}
    per_step = {
        "fsdp": dict(flash_fwd=12, flash_bwd=12, ce_fwd=1, ce_dh=1,
                     ce_dw=1),
        # remat recomputes the whole loss: every forward kernel twice
        "fsdp-remat": dict(flash_fwd=24, flash_bwd=12, ce_fwd=2, ce_dh=1,
                           ce_dw=1),
        # the scan recomputes each block: flash_fwd twice a layer
        "fsdp-scan": dict(flash_fwd=24, flash_bwd=12, ce_fwd=1, ce_dh=1,
                          ce_dw=1)}
    ref = start = scan_state = None
    for name in ("dp", "fsdp", "fsdp-remat", "fsdp-scan"):
        model = build_model(seed, torch.bfloat16, "flash")
        if start is None:
            start = _flax_flat(flax_params(model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = opt = None
        layer = rest = 0
        if name == "dp":
            opt = create_multi_node_optimizer(adamw(model.parameters()),
                                              comm)
            step = make_data_parallel_train_step(model, opt, comm,
                                                 loss_fn=fused_lm_loss)
        elif name == "fsdp-scan":
            packed = stack_lm_blocks(flax_params(model))
            layer = sum(leaf[0].numel() * 4
                        for leaf in _leaves_of(packed["blocks"]))
            rest = sum(leaf.numel() * 4 for k, v in packed.items()
                       if k != "blocks" for leaf in _leaves_of(v))
            sh = dict(fsdp_shardings(packed, comm),
                      blocks=fsdp_stack_shardings(packed, comm)["blocks"])
            step, state = make_fsdp_train_step(
                None, adamw, comm, packed,
                loss_fn=make_lm_fsdp_scan_loss(model), param_shardings=sh)
            del packed
            model = None
        else:
            step, state = make_fsdp_train_step(
                model, adamw, comm, loss_fn=fused_lm_loss,
                remat=name == "fsdp-remat")
        _cuda.reset_launches()
        losses = [step(x, y)["main/loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(f["steps"] - 1):
            losses.append(step(x, y)["main/loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (f["steps"] - 1)
        launched = _cuda.launches()
        launched_f32 = _cuda.launches(torch.float32)
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).tolist()
        if state is None:
            flat = _flax_flat(flax_params(model))
            sbytes = sum(t.numel() * t.element_size()
                         for s in opt.state.values() for t in s.values()
                         if torch.is_tensor(t) and t.ndim)
        else:
            tree = fsdp_gather_params(state)
            if name == "fsdp-scan":
                tree = unstack_lm_blocks(tree)
            flat = _flax_flat(tree)
            sbytes = state.optimizer_state_numel() * 4
        extra = ""
        if ref is None:
            ref = (losses, flat)
        else:
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref[0]))
            upd = ((flat - ref[1]).norm() / (ref[1] - start).norm()).item()
            want = {k: v * f["steps"] for k, v in per_step[name].items()}
            extra = (f", vs dp: worst relative loss difference "
                     f"{loss_err:.3e} (tolerance {TOL_FSDP_LOSS_REL}), "
                     f"relative update difference {upd:.4f} (tolerance "
                     f"{TOL_FSDP_UPDATE_REL}), peak of live gathered bytes "
                     f"{state.gathered_bytes_peak:,}")
            if name == "fsdp-scan":
                extra += (f" (stacked layers {state.layer_bytes_peak:,}; "
                          f"one layer {layer:,}, the unstacked leaves "
                          f"{rest:,})")
                if not 0 < state.layer_bytes_peak <= layer:
                    raise PhaseError(
                        f"fsdp-scan: the layers' gathered peak "
                        f"{state.layer_bytes_peak:,} B is not within one "
                        f"layer's {layer:,} B")
            if loss_err > TOL_FSDP_LOSS_REL or upd > TOL_FSDP_UPDATE_REL:
                raise PhaseError(f"fsdp {name} disagrees with the "
                                 f"data-parallel step{extra}")
            if launched != want or any(launched_f32.values()):
                raise PhaseError(f"fsdp {name}: launches {launched} (f32 "
                                 f"{launched_f32}), expected {want}, none "
                                 f"f32")
            for k in counts:
                counts[k] += launched[k]
        if not all(math.isfinite(v) for v in losses):
            raise PhaseError(f"fsdp {name}: a loss is not finite")
        print(f"fsdp {name}: 135M LM bf16, seq {TRAIN['seq_len']}, batch "
              f"{TRAIN['batch']}, one NCCL rank, {f['steps']} steps: "
              f"{dt * 1e3:.3f} ms/step, tokens/s per chip "
              f"{TRAIN['batch'] * TRAIN['seq_len'] / dt:.1f}, peak "
              f"{peak / 2 ** 30:.3f} GiB, optimizer state {sbytes:,} B, "
              f"losses {[round(v, 5) for v in losses]}, launches "
              f"{launched}{extra} ({card})", flush=True)
        if name == "fsdp-scan":
            scan_state = state
        del model, step, state, opt, flat
        torch.cuda.empty_cache()
    comm.finalize()
    return counts, scan_state


def _leaves_of(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of(tree[k])
    else:
        yield tree


def _fsdp_world(card: str):
    """(b) and (c)'s resharding: 4 host-staged ranks of this card, then 2
    of them, a communicator of their own, restoring the 4 ranks'
    snapshots. Returns the 4 ranks' launches, and those of them on f32
    inputs (all)."""
    import tempfile

    f = FSDP
    per = f["world_per_rank"]
    n = f["world_ranks"]
    argv = [str(f["world_layers"]), str(f["world_seq"]), str(per),
            str(f["world_steps"])]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        outs = run_ranks([sys.executable, "-c", _FSDP_WORLD_SCRIPT, *argv,
                          d, str(ZERO["world_bucket_mib"] << 20)], n,
                         timeout=600)
        world = json.loads([ln for ln in outs[0].splitlines()
                            if ln.startswith("fsdp world ")][-1][
                                len("fsdp world "):])
        back = json.loads([ln for ln in outs[0].splitlines()
                           if ln.startswith("fsdp restore ")][-1][
                               len("fsdp restore "):])
    counts, f32 = {}, {}
    for w in world:
        for k, v in w["launches"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in w["launches_f32"].items():
            f32[k] = f32.get(k, 0) + v
    w0 = world[0]
    steps = f["world_steps"] * n
    for name, run in w0["runs"].items():
        ref = w0["ref"][run["opt"]]
        errs = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref)]
        same = all(w["runs"][name]["fingerprint"] == run["fingerprint"]
                   and w["runs"][name]["losses"] == run["losses"]
                   for w in world)
        quant = ""
        if "wire_worst_half_steps" in run:
            quant = (f", dequantized shards within "
                     f"{run['wire_worst_half_steps']:.6f} half steps "
                     f"(worst rank 0; tolerance {TOL_FSDP_HALF_STEPS:.6f})")
        if "reduced_worst_half_steps" in run:
            quant = (f", each reduced leaf's round trip within "
                     f"{run['reduced_worst_half_steps']:.6f} half "
                     f"quantization steps of its input (rank 0; tolerance "
                     f"{TOL_FSDP_HALF_STEPS:.6f})")
        print(f"fsdp world {name}: 4 host-staged ranks of one card, LM "
              f"d 768 x {f['world_layers']} layers f32, seq "
              f"{f['world_seq']}, {per} sequences a rank, "
              f"{'SGD momentum 0.9' if run['opt'] == 'sgd' else 'LAMB'}, "
              f"{f['world_steps']} steps: {run['ms']:.1f} ms/step (rank "
              f"0), losses {[round(v, 6) for v in run['losses']]} vs one "
              f"rank fed every batch {[round(v, 6) for v in ref]} "
              f"(relative {[float(f'{e:.3e}') for e in errs]}), relative "
              f"update difference {run['update_rel']:.4f}, optimizer "
              f"state {run['state_bytes']:,} B a rank, peak of live "
              f"gathered bytes {run['gathered_peak']:,} (stacked layers "
              f"{run['layer_peak']:,}){quant}, gathered parameters equal "
              f"on every rank {same} ({card})", flush=True)
        # the first loss precedes any update: exact parameters, except
        # that the int8 wire's forward already reads quantized ones
        wire = "wire_worst_half_steps" in run
        ok = same and errs[0] <= (TOL_FSDP_QUANT_LOSS_REL if wire
                                  else TOL_FSDP_WORLD_LOSS_REL)
        if run["quantized"]:
            ok = ok and max(errs) <= TOL_FSDP_QUANT_LOSS_REL and all(
                w["runs"][name].get(k, 0.0) <= TOL_FSDP_HALF_STEPS
                for w in world for k in ("wire_worst_half_steps",
                                         "reduced_worst_half_steps"))
        else:
            ok = ok and (max(errs) <= TOL_FSDP_WORLD_LOSS_REL
                         and run["update_rel"] <= TOL_FSDP_WORLD_UPDATE_REL)
        if not ok:
            raise PhaseError(f"fsdp world {name} disagrees with one rank "
                             f"fed every batch: {run}")
    ck = w0["ckpt"]
    saved = ck["saved"]
    same4 = all(w["ckpt"]["restored"][k] == saved[k]
                for w in world for k in ("fsdp-scan", "zero-ef"))
    same2 = (back["fsdp-scan"] == saved["fsdp-scan"]
             and back["zero-ef"] == saved["zero-ef"]
             and back["rows"] == saved["zero-ef-rows2"])
    mean_ok = back["mean_err"] <= TOL_FSDP_EF_MEAN * saved["ef_max"]
    print(f"fsdp checkpoint: FSDP-scan (SGD) and ZeRO-1 int8-block with "
          f"error feedback saved on 4 ranks, rank 0's files "
          f"{ck['file_bytes']['fsdp-scan']:,} and "
          f"{ck['file_bytes']['zero-ef']:,} B, save ms "
          f"{ck['save_ms']['fsdp-scan']:.1f} and "
          f"{ck['save_ms']['zero-ef']:.1f}: restored bit for bit onto 4 "
          f"{same4} (rank 0 {ck['restored']['ms']:.1f} ms), onto 2 "
          f"{same2} ({back['ms']:.1f} ms, every parameter, momentum and "
          f"regrouped residual row hashed whole); the residuals' mean "
          f"after regrouping within {back['mean_err']:.3e} of the saved "
          f"one (tolerance {TOL_FSDP_EF_MEAN} x max |e| "
          f"{saved['ef_max']:.3e}) ({card})", flush=True)
    if not (same4 and same2 and mean_ok):
        raise PhaseError(f"fsdp checkpoint: a restore differs: {ck} "
                         f"{back}")
    # each rank's forward-backward passes (steps: of all 4 ranks): five
    # FSDP runs, the scan's flash_fwd twice a layer, and the ZeRO-1 run
    # whose state (c) saves: 7 flash_fwd a layer, 6 flash_bwd, 6 of each
    # CE kernel
    layers = f["world_layers"]
    want = {"flash_fwd": 7 * layers * steps, "flash_bwd": 6 * layers * steps,
            "ce_fwd": 6 * steps, "ce_dh": 6 * steps, "ce_dw": 6 * steps}
    if counts != want or f32 != want:
        raise PhaseError(f"fsdp world: launches {counts} (f32 {f32}), "
                         f"expected {want}, all f32")
    print(f"fsdp world: devices {sorted({w['device'] for w in world})}, "
          f"launches of the 4 ranks {counts} (all f32), host-staged bytes "
          f"(rank 0) {w0['staged_bytes']:,} ({card})", flush=True)
    # ZeRO's (b) ran in this world after FSDP's count: its own checks
    zc, zf = _check_zero_world([w["zero"] for w in world], card)
    return ({k: counts.get(k, 0) + zc.get(k, 0) for k in {*counts, *zc}},
            {k: f32.get(k, 0) + zf.get(k, 0) for k in {*f32, *zf}})


def _fsdp_plane(state, card: str):
    """(c)'s snapshot plane: the 135M FSDP-scan state (bf16 run's f32
    parameters and AdamW state) saved synchronously, then through
    ``AsyncSnapshotPlane`` twice; the snapshots must agree."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from chainermn_torch.checkpointing import AsyncSnapshotPlane
    from chainermn_torch.comm import create_communicator
    from chainermn_torch.extensions import create_multi_node_checkpointer

    comm = create_communicator("pure_nccl")
    d = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        sd = state.state_dict()
        sync = create_multi_node_checkpointer("sync", comm, path=d,
                                              cp_interval=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(sd, 1)
        sync_ms = (time.perf_counter() - t0) * 1e3
        ck = create_multi_node_checkpointer("plane", comm, path=d,
                                            cp_interval=1)
        plane = AsyncSnapshotPlane(ck)
        stalls, flushes = [], []
        for it in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane.save(state.state_dict(), it)
            stalls.append(plane.stall_ms_last)
            plane.flush()
            flushes.append((time.perf_counter() - t0) * 1e3)
        plane.close()
        with np.load(os.path.join(sync.path, "snapshot_iter_1.0")) as a, \
                np.load(os.path.join(ck.path, "snapshot_iter_2.0")) as b:
            same = set(a.files) == set(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
        print(f"fsdp plane: the 135M FSDP-scan state (f32 parameters and "
              f"AdamW moments, {plane.bytes_last:,} B): synchronous save "
              f"{sync_ms:.1f} ms; AsyncSnapshotPlane stall "
              f"{stalls[0]:.1f} ms (first save, pinned buffers allocated) "
              f"and {stalls[1]:.1f} ms (second), save to published "
              f"{flushes[0]:.1f} and {flushes[1]:.1f} ms; files equal to "
              f"the synchronous one {same} ({card})", flush=True)
        if not same:
            raise PhaseError("fsdp plane: the plane's snapshot differs "
                             "from the synchronous save's")
    finally:
        comm.finalize()
        shutil.rmtree(d, ignore_errors=True)


def _fsdp_train_lm(card: str):
    """(d): ``train_lm --zero 3`` and ``--fsdp-scan`` at full width, f32.
    Returns their launches, and those on f32 inputs (all)."""
    import tempfile

    import torch

    from chainermn_torch.examples import train_lm
    from chainermn_torch.ops import _cuda

    f = FSDP
    steps = f["lm_iterations"]
    counts, f32 = {}, {}
    for flags, want in (
            (["--zero", "3"], {"flash_fwd": 12 * steps,
                               "flash_bwd": 12 * steps, "ce_fwd": 0,
                               "ce_dh": 0, "ce_dw": 0}),
            (["--fsdp-scan"], {"flash_fwd": 24 * steps,
                               "flash_bwd": 12 * steps, "ce_fwd": steps,
                               "ce_dh": steps, "ce_dw": steps})):
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE,
                                                          "build")) as d:
            argv = flags + [
                "--lr", str(f["lm_lr"]),
                "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
                "--vocab", "32768", "--seq-len", "2048", "--batchsize",
                str(f["lm_batch"]), "--n-train",
                str(f["lm_batch"] * steps), "--iterations", str(steps),
                "--out", d]
            trainer, _ = train_lm.build_trainer(train_lm.parse_args(argv))
            step, losses, marks = trainer.updater.step_fn, [], []

            def timed(*arrays):
                m = step(*arrays)
                losses.append(m["main/loss"])
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                return m

            trainer.updater.step_fn = timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launches()
            try:
                trainer.run()
                torch.cuda.synchronize()
            finally:
                trainer.updater.comm.finalize()
            launched = _cuda.launches()
            launched_f32 = _cuda.launches(torch.float32)
            peak = torch.cuda.max_memory_allocated()
            state = trainer.updater.optimizer
            ms = (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3
            losses = [float(v) for v in losses]
        label = " ".join(flags)
        print(f"fsdp train_lm {label}: d 768 x 12 layers, vocab 32768, seq "
              f"2048, batch {f['lm_batch']}, f32, Adam {f['lm_lr']}: "
              f"{ms:.3f} ms/step after "
              f"the first of {steps}, tokens/s per chip "
              f"{f['lm_batch'] * 2048 / ms * 1e3:.1f}, peak "
              f"{peak / 2 ** 30:.3f} GiB, peak of live gathered bytes "
              f"{state.gathered_bytes_peak:,} (stacked layers "
              f"{state.layer_bytes_peak:,}), losses "
              f"{[round(v, 5) for v in losses]}, launches {launched} "
              f"({card})", flush=True)
        if not all(math.isfinite(v) for v in losses) or not (
                losses[-1] < losses[0]):
            raise PhaseError(f"train_lm {label}: the losses are not finite "
                             f"and falling: {losses}")
        if launched != want or launched_f32 != want:
            raise PhaseError(f"train_lm {label}: launches {launched} (f32 "
                             f"{launched_f32}), expected {want}, all f32")
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
            f32[k] = f32.get(k, 0) + v
        del trainer, state
        torch.cuda.empty_cache()
    return counts, f32


def fsdp(seed: int, card: str):
    """FSDP, the scanned stack, sharded checkpoints and the snapshot
    plane, (a)-(d) of the module docstring. Returns the launches of the
    phase's main-path runs, and those of them on f32 inputs."""
    import torch

    counts, scan_state = _fsdp_full_width(seed, card)
    _fsdp_plane(scan_state, card)
    del scan_state
    torch.cuda.empty_cache()
    f32 = {k: 0 for k in counts}
    for part in (lambda: _fsdp_world(card), lambda: _fsdp_train_lm(card)):
        got, got_f32 = part()
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        for k, n in got_f32.items():
            f32[k] = f32.get(k, 0) + n
        torch.cuda.empty_cache()
    return counts, f32


RESIL = dict(kill_step=6, corrupt_iteration=8, sigterm_step=3,
             sigterm_iterations=5, grace_s=30, heartbeat_ms=200,
             heartbeat_timeout_ms=1000, probe_ms=500, world_ranks=4,
             world_kill_rank=3, world_kill_step=5, world_every=2,
             world_per_rank=2, world_seq=512, world_layers=2,
             shrink_ranks=2, shrink_steps=3, world_lr=1e-3)
# a survivor of a killed rank, from the kill to its exit: the heartbeat
# timeout, two beats of the watchdog's cadence, one probe slice, and the
# way out (the emergency snapshot of its ~50 MB shard and the writer's
# last replica round, each bounded by a probe slice, plus the process's
# exit): 5 s on top of the detection
RESIL_EXIT_SLACK_S = 5.0

_RESIL_VIT_SCRIPT = r"""
import json, os, sys, time
import numpy as np
import torch
from chainermn_torch.examples import train_imagenet
from chainermn_torch.extensions import checkpoint as ck_mod
from chainermn_torch.ops import _cuda
from chainermn_torch.resilience import chaos, main_exit_code
from chainermn_torch.resilience.preemption import grace_seconds
from chainermn_torch.resilience.supervisor import restart_count

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
log, k = sys.argv[1], int(sys.argv[2])
argv = sys.argv[3:]
inc = restart_count()
out = open(f"{log}.{inc}", "a")


def note(**kv):
    out.write(json.dumps(kv) + "\n")
    out.flush()
    os.fsync(out.fileno())


real_on_step = chaos.on_step


def on_step(it):
    # the moment before the chaos hook: a kill there is the kill's time
    note(event="pre", iteration=it, t=time.time())
    real_on_step(it)


chaos.on_step = on_step
Ck = ck_mod.MultiNodeCheckpointer
plain_resume, resume_ms = Ck.resume, []


def timed_resume(self, updater):
    # the election and the load into the live model and optimizer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = plain_resume(self, updater)
    torch.cuda.synchronize()
    resume_ms.append((time.perf_counter() - t0) * 1e3)
    return it


Ck.resume = timed_resume
trainer, model = train_imagenet.build_trainer(
    train_imagenet.parse_args(argv))
up = trainer.updater
ck = next(e.ext for e in trainer._extensions
          if isinstance(e.ext, ck_mod.MultiNodeCheckpointer))
built = {"event": "built", "iteration": up.iteration, "t": time.time(),
         "resume_ms": resume_ms[-1] if resume_ms else None}
if up.iteration == k:
    path = os.path.join(trainer.out, "imagenet", f"snapshot_iter_{k}.0")
    now, _ = ck_mod._host_arrays(up.state)
    with np.load(path) as z:
        saved = {n: z[n] for n in z.files if n.startswith("leaf_")}
    built["leaves"] = len(now)
    built["bitwise"] = set(now) == set(saved) and all(
        now[n].dtype == saved[n].dtype and now[n].shape == saved[n].shape
        and now[n].tobytes() == saved[n].tobytes() for n in saved)
note(**built)
# the snapshot is published before training goes on, so that the kill
# two steps later finds it
trainer.extend(lambda t: ck.flush(), trigger=(k, "iteration"))
step = up.step_fn


def recording(*arrays):
    c0 = _cuda.launches()
    m = step(*arrays)
    loss = float(m["main/loss"])
    c1 = _cuda.launches()
    note(event="step", iteration=up.iteration + 1, loss=loss, t=time.time(),
         launches={n: c1[n] - c0.get(n, 0) for n in c1})
    return m


up.step_fn = recording
plain_emergency = ck.emergency_save


def timed_emergency(trainer, deadline_s=None):
    t0 = time.monotonic()
    fn = plain_emergency(trainer, deadline_s=deadline_s)
    t1 = time.monotonic()
    note(event="emergency", ms=(t1 - t0) * 1e3, grace_s=grace_seconds(),
         left_s=None if deadline_s is None else deadline_s - t1,
         file=fn, valid=fn is not None and ck._verify_snapshot_file(fn))
    return fn


ck.emergency_save = timed_emergency
code = main_exit_code(lambda: (trainer.run(), trainer)[1])
if code == 0:
    # the chaos corrupt of the last snapshot: the election falls back
    last = os.path.join(ck.path, f"snapshot_iter_{up.iteration}.0")
    note(event="election", last_valid=ck._verify_snapshot_file(last),
         elected=ck.latest_common_iteration())
up.comm.finalize()
note(event="exit", code=code, t=time.time())
out.close()
sys.stdout.flush()
os._exit(code)
"""


_RESIL_WORLD_SCRIPT = r"""
import hashlib, json, math, os, sys, time
import numpy as np
import torch
from chainermn_torch.checkpointing import AsyncSnapshotPlane
from chainermn_torch.examples import train_lm
from chainermn_torch.examples.train_lm import synthetic_text
from chainermn_torch.extensions import ShardedLeaf
from chainermn_torch.extensions import checkpoint as ck_mod
from chainermn_torch.ops import _cuda
from chainermn_torch.resilience import (PeerReplicator, chaos,
                                        elastic_resume, main_exit_code)

torch.backends.cuda.matmul.allow_tf32 = False
mode, d, layers, seq, per, iters, every, lr = sys.argv[1:9]
layers, seq, per, iters, every = map(int, (layers, seq, per, iters, every))
argv = ["--fsdp-scan", "--communicator", "non_cuda_aware", "--rope",
        "--d-model", "768", "--n-heads", "12", "--n-layers", str(layers),
        "--vocab", "32768", "--seq-len", str(seq), "--batchsize", str(per),
        "--n-train", "256", "--iterations", str(iters), "--lr", lr,
        "--out", os.path.join(d, "out")]
rank = int(os.environ["RANK"])
report = {"rank": rank}


def write():
    with open(os.path.join(d, f"{mode}.{rank}.json"), "w") as f:
        json.dump(report, f)


real_on_step = chaos.on_step


def on_step(it):
    report["pre"] = [it, time.time()]
    write()                 # the killed rank's last record is the kill
    real_on_step(it)


chaos.on_step = on_step
trainer, _ = train_lm.build_trainer(train_lm.parse_args(argv))
up = trainer.updater
comm = up.comm
ck = ck_mod.MultiNodeCheckpointer("lm", comm, path=d, cp_interval=10)
losses = []
step = up.step_fn


def recording(*arrays):
    m = step(*arrays)
    losses.append(float(m["main/loss"]))
    return m


up.step_fn = recording


def whole(v):
    # a sharded leaf whole on every rank (a collective)
    if not isinstance(v, ShardedLeaf):
        return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
    dims = [i for i, (a, b) in enumerate(v.index) if b - a != v.gshape[i]]
    if not dims:
        return v.local.detach().cpu().numpy()
    parts = comm.allgather_obj(v.local.detach().cpu().numpy())
    return np.concatenate(parts, axis=dims[0])


def saved_leaves(it, world):
    # each leaf of iteration it whole, from the files by their indices
    files = []
    for r in range(world):
        for sub in ("", ck_mod.REPLICA_DIRNAME):
            fn = os.path.join(ck.path, sub, f"snapshot_iter_{it}.{r}")
            if os.path.exists(fn) and ck._verify_snapshot_file(fn):
                files.append((sub, fn))
                break
    out, z = {}, [np.load(fn) for _, fn in files]
    n = max(int(k.split("_")[1]) for f in z for k in f.files
            if k.startswith("leaf_")) + 1
    for i in range(n):
        whole_key = f"leaf_{i}"
        f0 = next((f for f in z if whole_key in f.files), None)
        if f0 is not None:
            out[i] = np.asarray(f0[whole_key])
            continue
        gshape = tuple(int(x) for x in next(
            f for f in z if f"leaf_{i}_gshape" in f.files)[f"leaf_{i}_gshape"])
        buf = None
        for f in z:
            idx = np.asarray(f[f"leaf_{i}_idx0"])
            piece = np.asarray(f[f"leaf_{i}_s0"])
            if buf is None:
                buf = np.empty(gshape, piece.dtype)
            buf[tuple(slice(int(a), int(b) if b != -1 else g)
                      for (a, b), g in zip(idx, gshape))] = piece
        out[i] = buf
    for f in z:
        f.close()
    return out, [sub for sub, _ in files]


if mode == "kill":
    plane = AsyncSnapshotPlane(ck, replicator=PeerReplicator(ck))
    trainer.extend(plane, trigger=(every, "iteration"))
    # each snapshot and its ring round are done before training goes on,
    # so the kill finds the last snapshot's replicas written
    trainer.extend(lambda t: plane.flush(), trigger=(every, "iteration"))
    plain_emergency = plane.emergency_save

    def timed_emergency(trainer, deadline_s=None):
        t0 = time.monotonic()
        try:
            return plain_emergency(trainer, deadline_s=deadline_s)
        finally:
            report["emergency_ms"] = (time.monotonic() - t0) * 1e3

    plane.emergency_save = timed_emergency
    _cuda.reset_launches()
    t_run = time.time()
    code = main_exit_code(lambda: (trainer.run(), trainer)[1])
    report.update(code=code, losses=losses, launches=_cuda.launches(),
                  launches_f32=_cuda.launches(torch.float32))
    write()
    sys.stdout.flush()
    os._exit(code)

# mode "shrink": resume on fewer ranks from the files left; the restored
# tree (the saved structure, this world's pieces) against the files
got = {}
plain_load = ck.maybe_load


def capture(*a, **kw):
    got["out"] = plain_load(*a, **kw)
    return got["out"]


ck.maybe_load = capture
gdata = synthetic_text(256, seq, 32768, seed=0)
plan = elastic_resume(ck, up, global_dataset=gdata, shuffle=True, seed=0)
restored, it = got["out"]
saved, sources = saved_leaves(it, plan.saved_world)
leaves = []
ck_mod._flatten(restored, leaves)
same = len(leaves) == len(saved) and all(
    np.array_equal(whole(v).reshape(np.shape(saved[i])), saved[i])
    and whole(v).dtype == saved[i].dtype
    for i, v in enumerate(leaves))
trainer.stop_n = it + int(sys.argv[9])
_cuda.reset_launches()
trainer.run()
report.update(action=plan.action, iteration=it, saved_world=plan.saved_world,
              new_world=plan.new_world, sources=sources, bitwise=bool(same),
              leaves=len(leaves), losses=losses, launches=_cuda.launches(),
              launches_f32=_cuda.launches(torch.float32))
write()
comm.host_barrier()
sys.stdout.flush()
os._exit(0)
"""


def _world_ranks(argv, n: int, timeout: float, env: dict, d: str):
    """``argv`` as ranks 0..n-1 of one world on this card (a free
    localhost port, output to files under ``d``); returns each rank's exit
    code, output and the wall time it exited, killing any rank past
    ``timeout``."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = dict(os.environ, PYTHONPATH=HERE, WORLD_SIZE=str(n),
                LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), **env)
    logs = [open(os.path.join(d, f"rank{r}.{port}.log"), "w+")
            for r in range(n)]
    procs = [subprocess.Popen(argv, cwd=HERE, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    ended = [None] * n
    try:
        deadline = time.monotonic() + timeout
        while None in ended:
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.time()
            if time.monotonic() > deadline:
                raise PhaseError(f"{argv[:3]}: a rank outlived {timeout} s")
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return [(p.returncode, out, t) for p, out, t in zip(procs, outs, ended)]


def _read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _resil_supervised(card: str, d: str, full_losses):
    """(a) and (b): the supervised ViT, killed at k+2 in its first
    incarnation, resumed from k in its second (whose snapshot 2k chaos
    corrupts). Returns the launches of both incarnations."""
    v, r = VIT, RESIL
    k, n = v["ckpt_every"], v["ckpt_iterations"]
    log = os.path.join(d, "vit")
    argv = _vit_argv(os.path.join(d, "vit_out"), n, v["ckpt_n_train"],
                     "--warmup-epochs", str(v["ckpt_warmup_epochs"]),
                     "--snapshot-every", str(k), "--resume")
    spec = (f"kill@step={r['kill_step']},signal=SIGKILL,run=0;"
            f"corrupt@match=snapshot_iter_{r['corrupt_iteration']},run=1")
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.supervise",
         "--max-restarts", "2", "--", sys.executable, "-c",
         _RESIL_VIT_SCRIPT, log, str(k), *argv],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE,
                           CHAINERMN_TPU_CHAOS=spec),
        capture_output=True, text=True, timeout=600)
    inc0, inc1 = _read_jsonl(log + ".0"), _read_jsonl(log + ".1")
    text = (proc.stdout + proc.stderr)[-3000:]
    if proc.returncode != 0 or not inc1:
        raise PhaseError(f"resilience (a): the supervisor exited "
                         f"{proc.returncode}:\n{text}")
    if "(crash)" not in proc.stderr or "(clean)" not in proc.stderr:
        raise PhaseError(f"resilience (a): the supervisor saw no crash and "
                         f"clean finish:\n{text}")
    kill_t = [e["t"] for e in inc0 if e["event"] == "pre"][-1]
    steps0 = [e for e in inc0 if e["event"] == "step"]
    steps1 = [e for e in inc1 if e["event"] == "step"]
    built1 = next(e for e in inc1 if e["event"] == "built")
    election = next(e for e in inc1 if e["event"] == "election")
    ttr_ms = (steps1[0]["t"] - kill_t) * 1e3
    up_ms = (built1["t"] - kill_t) * 1e3        # restart, model, restore
    resumed = [e["loss"] for e in steps1]
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, full_losses[k:]))
    # two runs of the same first k steps (incarnation 0 and the checkpoint
    # phase's uninterrupted run) apart: flash_bwd's f32 atomics
    floor = max(abs(e["loss"] - b) / abs(b)
                for e, b in zip(steps0[:k], full_losses[:k]))
    want = {"flash_fwd": 12, "flash_bwd": 12, "ce_fwd": 0, "ce_dh": 0,
            "ce_dw": 0}
    bad = [e for e in steps0 + steps1 if e["launches"] != want]
    print(f"resilience (a): supervised train_imagenet --model vit "
          f"--snapshot-every {k} --resume, chaos SIGKILL at step "
          f"{r['kill_step']} of incarnation 0 (after {len(steps0)} steps): "
          f"incarnation 1 resumed at iteration {built1['iteration']} in "
          f"{built1['resume_ms']:.3f} ms (election and load into the live "
          f"model and optimizer), {built1.get('leaves')} leaves bitwise the "
          f"saved npz: {built1.get('bitwise')}; time to recover "
          f"{ttr_ms:.1f} ms (kill "
          f"to the first resumed step; {up_ms:.1f} ms of it to the restored "
          f"trainer: the supervisor's backoff, a new process, the model and "
          f"the restore; the rest the first step); losses "
          f"uninterrupted {[round(l, 5) for l in full_losses]}, resumed "
          f"{[round(l, 5) for l in resumed]}, worst relative difference "
          f"{err:.2e} (tolerance {TOL_CKPT_LOSS_REL}; incarnation 0's first "
          f"{k} steps differ from the uninterrupted run's by {floor:.2e}: "
          f"flash_bwd's f32 atomics); launches a step "
          f"{want} in all {len(steps0) + len(steps1)} steps: {not bad} "
          f"({card})", flush=True)
    print(f"resilience (b): chaos corrupt of snapshot_iter_"
          f"{r['corrupt_iteration']}.0 after its publish: verifies "
          f"{election['last_valid']}, the election falls back to "
          f"{election['elected']} ({card})", flush=True)
    if built1["iteration"] != k or not built1.get("bitwise"):
        raise PhaseError("resilience (a): the resumed state is not "
                         "snapshot k")
    if (len(steps0) != r["kill_step"] or len(resumed) != n - k
            or err > TOL_CKPT_LOSS_REL or bad):
        raise PhaseError("resilience (a): steps, losses or launches are off")
    if election["last_valid"] or election["elected"] != k:
        raise PhaseError("resilience (b): the torn snapshot was elected")
    total = {}
    for e in steps0 + steps1:
        for name, c in e["launches"].items():
            total[name] = total.get(name, 0) + c
    return total


def _resil_preemption(card: str, d: str):
    """(c): a chaos SIGTERM; the emergency snapshot within the grace
    window, exit 143. Returns the run's launches."""
    v, r = VIT, RESIL
    log = os.path.join(d, "sigterm")
    argv = _vit_argv(os.path.join(d, "sigterm_out"),
                     r["sigterm_iterations"], v["ckpt_n_train"],
                     "--snapshot-every", "1000", "--resume")
    proc = subprocess.run(
        [sys.executable, "-c", _RESIL_VIT_SCRIPT, log, "1000", *argv],
        cwd=HERE, env=dict(
            os.environ, PYTHONPATH=HERE, CHAINERMN_TPU_PREEMPTION_GRACE_S=str(
                r["grace_s"]),
            CHAINERMN_TPU_CHAOS=f"kill@step={r['sigterm_step']},"
                                "signal=SIGTERM"),
        capture_output=True, text=True, timeout=300)
    ev = _read_jsonl(log + ".0")
    em = [e for e in ev if e["event"] == "emergency"]
    steps = [e for e in ev if e["event"] == "step"]
    if proc.returncode != 143 or not em:
        raise PhaseError(f"resilience (c): exit {proc.returncode}, "
                         f"emergency saves {em}:\n"
                         f"{(proc.stdout + proc.stderr)[-3000:]}")
    e = em[0]
    print(f"resilience (c): chaos SIGTERM at step {r['sigterm_step']}: "
          f"emergency snapshot {os.path.basename(e['file'] or '-')} in "
          f"{e['ms']:.1f} ms against the {e['grace_s']:.0f} s grace "
          f"(CHAINERMN_TPU_PREEMPTION_GRACE_S; {e['left_s']:.3f} s left), "
          f"valid {e['valid']}, exit {proc.returncode} after "
          f"{len(steps)} steps ({card})", flush=True)
    if not e["valid"] or e["left_s"] is None or e["left_s"] < 0:
        raise PhaseError("resilience (c): no valid emergency snapshot "
                         "within the grace window")
    total = {}
    for s_ in steps:
        for name, c in s_["launches"].items():
            total[name] = total.get(name, 0) + c
    return total


def _resil_world(card: str, d: str):
    """(d): 4 host-staged ranks with the watchdog and ring replicas, rank
    3 killed; then 2 ranks resume through ``elastic_resume``. Returns the
    launches of both worlds (all on f32 inputs)."""
    from chainermn_torch.extensions.checkpoint import REPLICA_DIRNAME

    r = RESIL
    n, dead = r["world_ranks"], r["world_kill_rank"]
    iters = r["world_kill_step"] + 3
    common = [str(r["world_layers"]), str(r["world_seq"]),
              str(r["world_per_rank"]), str(iters), str(r["world_every"]),
              str(r["world_lr"])]
    env = {"CHAINERMN_TPU_WATCHDOG": "1",
           "CHAINERMN_TPU_HEARTBEAT_MS": str(r["heartbeat_ms"]),
           "CHAINERMN_TPU_HEARTBEAT_TIMEOUT_MS": str(
               r["heartbeat_timeout_ms"]),
           "CHAINERMN_TPU_RPC_PROBE_MS": str(r["probe_ms"]),
           "CHAINERMN_TPU_CHAOS": f"kill@step={r['world_kill_step']},"
                                  f"rank={dead},signal=SIGKILL"}
    res = _world_ranks([sys.executable, "-c", _RESIL_WORLD_SCRIPT, "kill", d,
                        *common], n, 600, env, d)
    reps = []
    for i in range(n):
        path = os.path.join(d, f"kill.{i}.json")
        reps.append(json.load(open(path)) if os.path.exists(path) else {})
    codes = [rc for rc, _, _ in res]
    want = [75] * n
    want[dead] = -9
    if codes != want or "pre" not in reps[dead]:
        raise PhaseError(f"resilience (d): exit codes {codes}, expected "
                         f"{want}:\n" + "\n".join(
                             f"rank {i}: {out[-1500:]}"
                             for i, (_, out, _) in enumerate(res)))
    kill_t = reps[dead]["pre"][1]
    survivors = [i for i in range(n) if i != dead]
    # a survivor stuck in a collective no error reaches is ended by its
    # watchdog (no report); the others leave through JobAbortedError
    took = [round(res[i][2] - kill_t, 3) for i in survivors]
    how = ["JobAbortedError" if "code" in reps[i] else "watchdog exit"
           for i in survivors]
    saves = [round(reps[i].get("emergency_ms", 0.0), 1) for i in survivors]
    before = next((reps[i]["losses"] for i in survivors
                   if reps[i].get("losses")), [])
    bound = (r["heartbeat_timeout_ms"] + 2 * r["heartbeat_ms"]
             + r["probe_ms"]) / 1e3 + RESIL_EXIT_SLACK_S
    job = os.path.join(d, "lm")
    def held(sub):
        # {rank: iterations} of the snapshot files under job/sub
        out = {}
        path = os.path.join(job, sub)
        for f in sorted(os.listdir(path)) if os.path.isdir(path) else ():
            if f.startswith("snapshot_iter_") and not f.endswith(".json"):
                it, rank = f[len("snapshot_iter_"):].split(".")
                out.setdefault(int(rank), []).append(int(it))
        return {k: sorted(v) for k, v in sorted(out.items())}

    print(f"resilience (d) kill: snapshot files by rank {held('')}, ring "
          f"replicas by source rank {held(REPLICA_DIRNAME)} ({card})",
          flush=True)
    warned = [ln for _, out, _ in res for ln in out.splitlines()
              if "replica" in ln and ("fail" in ln or "could not" in ln)]
    if warned:
        print("resilience (d) kill: " + "; ".join(warned[:4]), flush=True)
    # rank 3's disk is gone with it: only its ring replicas remain
    for f in os.listdir(job):
        if f.startswith("snapshot_iter_") and f.split(".")[1] == str(dead):
            os.remove(os.path.join(job, f))
    outs = _world_ranks([sys.executable, "-c", _RESIL_WORLD_SCRIPT, "shrink",
                         d, *common, str(r["shrink_steps"])],
                        r["shrink_ranks"], 600, {}, d)
    if any(rc != 0 for rc, _, _ in outs):
        raise PhaseError("resilience (d): the shrunken world failed:\n"
                         + "\n".join(f"rank {i} exited {rc}: {out[-2000:]}"
                                     for i, (rc, out, _) in enumerate(outs))
                         + "\nthe killed world's ranks:\n" + "\n".join(
                             f"rank {i}: {out[-1500:]}"
                             for i, (_, out, _) in enumerate(res)))
    back = [json.load(open(os.path.join(d, f"shrink.{i}.json")))
            for i in range(r["shrink_ranks"])]
    b0 = back[0]
    losses = b0["losses"]
    print(f"resilience (d): train_lm --fsdp-scan (d 768, {r['world_layers']}"
          f" layers, vocab 32768, seq {r['world_seq']}, f32, Adam "
          f"{r['world_lr']}) on {n} host-staged ranks of this card with the "
          f"watchdog (heartbeat {r['heartbeat_ms']} ms, timeout "
          f"{r['heartbeat_timeout_ms']} ms, probe {r['probe_ms']} ms) and "
          f"an AsyncSnapshotPlane with a PeerReplicator every "
          f"{r['world_every']} iterations: rank {dead} SIGKILLed at step "
          f"{r['world_kill_step']}, survivors exited "
          f"{[codes[i] for i in survivors]} ({how}) {took} s after the kill "
          f"(bound {bound:.1f} s; their emergency saves ms {saves}); losses "
          f"before the kill {[round(l, 5) for l in before]}; then {r['shrink_ranks']} ranks: plan "
          f"{b0['action']} at iteration {b0['iteration']} (saved world "
          f"{b0['saved_world']}, new {b0['new_world']}), files read "
          f"{['replica' if s_ else 'primary' for s_ in b0['sources']]}, "
          f"{b0['leaves']} leaves bitwise the saved files: "
          f"{all(b['bitwise'] for b in back)}; next losses "
          f"{[round(l, 5) for l in losses]} ({card})", flush=True)
    if any(t > bound for t in took):
        raise PhaseError("resilience (d): a survivor outlived the bound")
    if (b0["action"] not in ("shrink", "reshard")
            or not all(b["bitwise"] for b in back)
            or b0["sources"][dead] != REPLICA_DIRNAME):
        raise PhaseError("resilience (d): the shrunken restore is off")
    if not all(math.isfinite(l) for l in losses) or not (
            losses[-1] < losses[0]):
        raise PhaseError(f"resilience (d): the resumed losses are not "
                         f"finite and falling: {losses}")
    counts, f32 = {}, {}
    for rep in reps[:dead] + reps[dead + 1:] + back:
        for name, c in rep.get("launches", {}).items():
            counts[name] = counts.get(name, 0) + c
        for name, c in rep.get("launches_f32", {}).items():
            f32[name] = f32.get(name, 0) + c
    return counts, f32


def resilience(card: str, full_losses):
    """(a)-(d) of the module docstring, each a subprocess with a timeout.
    Returns the launches of their runs, and those on f32 inputs."""
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        counts = _resil_supervised(card, d, full_losses)
        for name, c in _resil_preemption(card, d).items():
            counts[name] = counts.get(name, 0) + c
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        world, f32 = _resil_world(card, d)
    for name, c in world.items():
        counts[name] = counts.get(name, 0) + c
    return counts, f32


PARALLEL = dict(ranks=4, seq=2048, layers=12, moe_experts=2, moe_steps=4,
                tp_steps=4, lr=3e-4, attn_iters=5, lm_layers=2,
                lm_iterations=2)
# the expert-parallel step in f32 (TF32 off) against the one-process
# oracle (all 8 experts on one rank, each rank's tokens run apart, so the
# capacities are the same): the same f32 products in other batch shapes
# and orders over 12 layers; a routing flip would be off by O(1)
TOL_MOE_ORACLE_LOSS_REL = 1e-4
TOL_MOE_ORACLE_GRAD = 1e-3
# the pipeline phase: (a) and (b) against the one-rank sequential oracle
# (the same blocks and kernels on the same inputs, f32 with TF32 off: the
# schedule changes only the order in which the micro-batches' gradients
# are summed), (c) against the dense pipeline (each TP sum split over two
# ranks), (d) against the chain list's own run; relative L2 error a leaf.
# A message paired with another's payload, a chunk on the wrong rank or a
# doubled cotangent is off by O(1)
TOL_PIPE_LOSS_REL = 1e-5
TOL_PIPE_GRAD = 1e-4
PIPE_STEPS = 4

_PARALLEL_WORLD_SCRIPT = r"""
import hashlib, json, os, sys, time, torch
import torch.nn.functional as F
from chainermn_torch.comm import create_communicator
from chainermn_torch.examples import train_lm
from chainermn_torch.models.convert import (dense_params_from_ranks,
                                            rank_params_from_dense)
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux, tp_lm_loss)
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.flash_attention import flash_attention
from chainermn_torch.parallel import (ring_attention, ring_flash_attention,
                                      ulysses_attention)
from chainermn_torch.training import (init_expert_parallel_state,
                                      make_expert_parallel_train_step)
seed, seq, layers, experts, moe_steps, tp_steps, iters = map(
    int, sys.argv[1:8])
lr = float(sys.argv[8])
lm_layers, lm_iterations = map(int, sys.argv[9:11])
workdir = sys.argv[11]
torch.backends.cuda.matmul.allow_tf32 = False
comm = create_communicator('non_cuda_aware')
r, n = comm.rank, comm.size
solo = comm.split(('block', 1))     # this rank alone: the MoE oracle
dev = comm.device
ll = seq // n
mine = slice(r * ll, (r + 1) * ll)
CFG = dict(vocab=32768, d_model=768, n_heads=12, n_layers=layers,
           d_ff=3072, max_len=seq, pos_emb='rope', device=dev)
out = {'device': str(dev), 'staged_bytes': 0}
totals = {'all': {}, 'f32': {}}


def segment():
    # the main path's launches since the last reset, added to the totals
    got = _cuda.launches()
    for key, counts in (('all', got), ('f32', _cuda.launches(torch.float32))):
        for k, v in counts.items():
            totals[key][k] = totals[key].get(k, 0) + v
    _cuda.reset_launches()
    return got


def lm(dtype=torch.bfloat16, **kw):
    torch.manual_seed(seed)
    return TransformerLM(**CFG, dtype=dtype, **kw)


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def worst(grads, ref):
    w, name = 0.0, ''
    for k, g in ref.items():
        e = rel(grads[k], g) if torch.isfinite(grads[k]).all() else 1e30
        if e > w:
            w, name = e, k
    return w, name


def sha(t):
    return hashlib.sha256(t.detach().float().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


def gather_to_root(tensors):
    # rank 0: for each rank, its tensors (in order); the others: None
    got = [comm.gather(t.detach(), 0) for t in tensors]
    return None if r else [[g[i] for g in got] for i in range(n)]


g = torch.Generator().manual_seed(seed + 1)
toks = torch.randint(0, 32768, (1, seq + 1), generator=g).to(dev)
x, y = toks[:, :-1], toks[:, 1:]
# the one-rank flash model on the whole sequence: the oracle of (a), (b)
ref = lm()
base = {k: v.clone() for k, v in ref.state_dict().items()}
logits = ref(x)
ref_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
ref_loss.backward()
ref_logits = logits.detach()[:, mine].float()
ref_grads = {k: p.grad.float() for k, p in ref.named_parameters()}
del ref, logits
_cuda.reset_launches()

# (a) sequence parallelism: the sequence split over the ranks
out['seq'] = {}
for impl in ('ring', 'ring_flash', 'ulysses'):
    model = lm(attention=impl, seq_axis='sp', comms={'sp': comm})
    model.load_state_dict(base)
    times = []
    for rep in range(2):
        model.zero_grad(set_to_none=True)
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(x[:, mine], pos_offset=r * ll)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y[:, mine].reshape(-1))
        (loss / n).backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if rep == 0:
            launched = segment()
    segment()
    comm.allreduce_grad([p.grad for p in model.parameters()], 'sum')
    gw, gname = worst({k: p.grad for k, p in model.named_parameters()},
                      ref_grads)
    # the attention alone at [1, L, 12, 64], forward and backward, every
    # rank at once (the ranks share the card and a host-staged gloo ring)
    fn = {'ring': ring_attention, 'ring_flash': ring_flash_attention,
          'ulysses': ulysses_attention}[impl]
    qkv = [torch.randn(1, ll, 12, 64, device=dev, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(3)]
    do = torch.randn(1, ll, 12, 64, device=dev, dtype=torch.bfloat16)
    fn(*qkv, comm, causal=True).backward(do)
    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*qkv, comm, causal=True).backward(do)
    torch.cuda.synchronize()
    attn_ms = (time.perf_counter() - t0) / iters * 1e3
    _cuda.reset_launches()
    out['seq'][impl] = dict(
        loss=comm.allreduce(loss.detach(), 'mean').item(),
        ref_loss=ref_loss.item(), logits_rel=rel(logits.detach(),
                                                 ref_logits),
        grad_rel=gw, grad_name=gname, launches=launched, ms=times[1],
        attn_ms=attn_ms)
    del model, logits, loss
    torch.cuda.empty_cache()
if r == 0:
    # one-rank flash at [1, L, 12, 64] while the others wait
    qkv = [torch.randn(1, seq, 12, 64, device=dev, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(3)]
    do = torch.randn(1, seq, 12, 64, device=dev, dtype=torch.bfloat16)
    flash_attention(*qkv, causal=True).backward(do)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flash_attention(*qkv, causal=True).backward(do)
    torch.cuda.synchronize()
    out['flash_one_rank_ms'] = (time.perf_counter() - t0) / iters * 1e3
    _cuda.reset_launches()
comm.barrier()

# (b) tensor parallelism over the ranks: the oracle's weights cut
tp = lm(tp_axis='tp', lm_head_tp=True, comms={'tp': comm})
tp.load_state_dict(rank_params_from_dense(tp, base, r, n))
loss, (acc, _) = tp_lm_loss(tp, x, y)
loss.backward()
out['tp'] = dict(loss=loss.item(), ref_loss=ref_loss.item(),
                 launches=segment())
names = [k for k, _ in tp.named_parameters()]
pieces = gather_to_root([p.grad for _, p in tp.named_parameters()])
if r == 0:
    dense = lm()
    gd = dense_params_from_ranks(dense, [dict(zip(names, pr))
                                         for pr in pieces])
    out['tp']['grad_rel'], out['tp']['grad_name'] = worst(gd, ref_grads)
    del dense, gd
del pieces
opt = torch.optim.Adam(tp.parameters(), lr=lr, eps=1e-8)
losses, marks = [], []
comm.barrier()
marks.append(time.perf_counter())
for _ in range(tp_steps):
    opt.zero_grad(set_to_none=True)
    loss, _ = tp_lm_loss(tp, x, y)
    loss.backward()
    opt.step()
    losses.append(loss.item())
    marks.append(time.perf_counter())
out['tp'].update(
    losses=losses, ms=(marks[-1] - marks[1]) / (tp_steps - 1) * 1e3,
    step_launches=segment(),
    shared={k: sha(p) for k, p in tp.named_parameters()
            if '.dense.' not in k})
del tp, opt
torch.cuda.empty_cache()

# (c) expert parallelism: experts split over the ranks, a sequence each
gm = torch.Generator().manual_seed(seed + 100 + r)
mt = torch.randint(0, 32768, (1, seq + 1), generator=gm).to(dev)
mx, my = mt[:, :-1], mt[:, 1:]
allx = comm.allgather(mt)                 # [n, 1, seq + 1]: the oracle's
out['moe'] = {}
for k in (1, 2):
    moe_kw = dict(moe_experts_per_device=experts, expert_axis='e',
                  capacity_factor=2.0, moe_top_k=k)
    # one step in f32 against the one-process oracle
    model = lm(torch.float32, comms={'e': comm}, **moe_kw)
    specs = init_expert_parallel_state(model, comm, seed=seed)
    own = [q for q, e in specs.items() if e]
    tables = gather_to_root([dict(model.named_parameters())[q]
                             for q in own])
    sd0 = {q: v.clone() for q, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    step = make_expert_parallel_train_step(model, opt, comm, specs,
                                           loss_fn=lm_loss_with_aux)
    res = dict(loss=step(mx, my)['main/loss'].item(), launches=segment())
    grads = gather_to_root([dict(model.named_parameters())[q].grad
                            for q in own])
    if r == 0:
        oracle = lm(torch.float32, comms={'e': solo},
                    **dict(moe_kw, moe_experts_per_device=experts * n))
        oracle.load_state_dict(dense_params_from_ranks(
            oracle, [dict(sd0, **dict(zip(own, t))) for t in tables]))
        total = 0.0
        for i in range(n):
            part, _ = lm_loss_with_aux(oracle, allx[i][:, :-1],
                                       allx[i][:, 1:])
            (part / n).backward()
            total += part.item() / n
        shared = {q: p.grad for q, p in model.named_parameters()}
        got = dense_params_from_ranks(
            oracle, [dict(shared, **dict(zip(own, gr))) for gr in grads])
        res['oracle_loss'] = total
        res['grad_rel'], res['grad_name'] = worst(
            got, {q: p.grad for q, p in oracle.named_parameters()})
        del oracle, got, shared
        _cuda.reset_launches()
    del model, opt, step, tables, grads
    torch.cuda.empty_cache()
    comm.barrier()
    # steps in bf16: shared leaves the same on every rank, experts not
    model = lm(comms={'e': comm}, **moe_kw)
    specs = init_expert_parallel_state(model, comm, seed=seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    step = make_expert_parallel_train_step(model, opt, comm, specs,
                                           loss_fn=lm_loss_with_aux)
    losses, marks = [], []
    comm.barrier()
    marks.append(time.perf_counter())
    for _ in range(moe_steps):
        losses.append(step(mx, my)['main/loss'].item())
        marks.append(time.perf_counter())
    res.update(losses=losses, step_launches=segment(),
               ms=(marks[-1] - marks[1]) / (moe_steps - 1) * 1e3)
    # the share of tokens dropped, outside the timed steps: one no-grad
    # forward of the trained weights on the same tokens, each MoE layer's
    # routing read from its input
    routed = []

    def count(mod, args, _out):
        routed.append((mod.route(args[0])[0].sum(),
                       args[0].shape[0] * mod.top_k))

    hooks = [mod.register_forward_hook(count) for name, mod in
             model.named_modules() if name.endswith('.moe')]
    with torch.no_grad():
        model.forward_with_aux(mx)
    for h in hooks:
        h.remove()
    segment()
    res.update(
        dropped=1 - sum(a.item() for a, _ in routed)
        / sum(b for _, b in routed),
        shared={q: sha(p) for q, p in model.named_parameters()
                if not specs[q]},
        experts={q: sha(p) for q, p in model.named_parameters()
                 if specs[q]})
    out['moe'][k] = res
    del model, opt, step
    torch.cuda.empty_cache()
out['launches'], out['launches_f32'] = totals['all'], totals['f32']
out['staged_bytes'] = comm.staged_bytes
outs = comm.allgather_obj(out)
solo.finalize()
if r == 0:
    print('parallel world ' + json.dumps(outs), flush=True)

# (d) train_lm's flags in the same world: the example's communicator is
# this one
comm.barrier()
t_lm = time.perf_counter()
finalize, comm.finalize = comm.finalize, lambda: None
train_lm.create_communicator = lambda *a, **kw: comm
layers, iterations = lm_layers, lm_iterations
runs = {}
for name, flags in (('ring', ['--ring', '--seq-impl', 'ring']),
                    ('ring_flash', ['--ring', '--seq-impl', 'ring_flash']),
                    ('ulysses', ['--ring', '--seq-impl', 'ulysses']),
                    ('moe2-top1', ['--moe', '2', '--moe-top-k', '1']),
                    ('moe2-top2', ['--moe', '2', '--moe-top-k', '2'])):
    args = train_lm.parse_args(flags + [
        '--communicator', 'non_cuda_aware', '--d-model', '768',
        '--n-heads', '12', '--n-layers', str(layers), '--vocab', '32768',
        '--seq-len', '2048', '--batchsize', '1', '--n-train',
        str(n * iterations), '--iterations', str(iterations), '--rope',
        '--out', os.path.join(workdir, name)])
    trainer, model = train_lm.build_trainer(args)
    step, losses, marks = trainer.updater.step_fn, [], []

    def timed(*arrays):
        m = step(*arrays)
        losses.append(float(m['main/loss']))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return m

    trainer.updater.step_fn = timed
    comm.barrier()
    _cuda.reset_launches()
    marks.append(time.perf_counter())
    trainer.run()
    train_launches = _cuda.launches()
    acc = train_lm.ring_demo(args, trainer, model) if args.ring else None
    runs[name] = dict(losses=losses, acc=acc, train=train_launches,
                      launches=_cuda.launches(),
                      launches_f32=_cuda.launches(torch.float32),
                      ms=(marks[-1] - marks[1]) / max(1, len(marks) - 2)
                      * 1e3)
    del trainer, model
    torch.cuda.empty_cache()
lm_s = time.perf_counter() - t_lm
staged = comm.staged_bytes
outs = comm.allgather_obj(runs)
if r == 0:
    print('parallel train_lm ' + json.dumps(
        dict(runs=outs, wall_s=lm_s, staged_bytes=staged)), flush=True)
""" + r"""
# the pipeline phase (item 10b) in the same world: the 135M LM's block at
# full width, f32 parameters and compute (TF32 off), weights from the seed
from torch import nn
from chainermn_torch.examples import train_pipeline_lm as tpl
from chainermn_torch.links import MultiNodeChainList
from chainermn_torch.models.convert import (dense_params_from_ranks,
                                            module_params_from_flax)
from chainermn_torch.models.transformer import TransformerBlock
from chainermn_torch.parallel import (branching_pipeline_value_and_grad,
                                      build_interleaved_schedule)
from chainermn_torch.parallel.pipeline import (schedule_idle_share,
                                               tree_leaves, tree_map,
                                               tree_unflatten)
for name in ('base', 'ref_grads', 'ref_logits', 'allx', 'qkv', 'do'):
    globals().pop(name, None)   # the earlier phases' tensors
torch.cuda.empty_cache()
comm.barrier()
t_pipe = time.perf_counter()
_cuda.reset_launches()
totals = {'all': {}, 'f32': {}}
PIPE = ['--vocab', '32768', '--d-model', '768', '--n-heads', '12',
        '--d-ff', '3072', '-L', str(seq), '--mb-size', '1', '--lr', str(lr),
        '--communicator', 'non_cuda_aware', '--seed', str(seed)]
pipe_steps = int(sys.argv[12])


def on(tree):
    return tree_map(lambda x: x.to(dev), tree)


def worst_pair(pairs):
    # (relative L2 error, name) of the worst (got, want, name) pair
    w, name = -1.0, ''
    for g_, w_, nm in pairs:
        e = rel(g_, w_) if torch.isfinite(g_).all() else 1e30
        if e > w:
            w, name = e, nm
    return w, name


def timed_steps(model, data, steps, mem0, stage):
    # losses, ms/step, the stage communicator's exchange ms a step and
    # this rank's peak GiB over `steps`: the peak above mem0, what the rank
    # held before it built the model
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    comm.barrier()
    torch.cuda.synchronize()
    t0, x0 = time.perf_counter(), stage.exchange_seconds
    for _ in range(steps):
        toks_, tgts_ = next(data)
        losses.append(model.step(toks_, tgts_))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    exchange_ms = (stage.exchange_seconds - x0) / steps * 1e3
    return dict(losses=losses, ms=ms, exchange_ms=exchange_ms,
                peak_gib=peak / 2 ** 30, step_launches=segment())


def stage_card_ms(model, toks, tgts):
    # the card time (CUDA events) of this rank's stage work in one step,
    # each rank alone on the card in turn: every chunk's forward, its
    # re-run and backward on each micro-batch, and on the last rank the
    # head's loss and gradients, the calls the 1F1B engine makes
    x = model._embed(model.embed_tree, toks).detach()
    chunks = [tree_map(lambda t_: t_[v], model.stage_tree)
              for v in range(model.V)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = 0.0
    for q in range(n):
        comm.barrier()
        if q != r:
            continue
        torch.cuda.synchronize()
        ev[0].record()
        for ch in chunks:
            lv = [t_.detach().requires_grad_(True) for t_ in
                  tree_leaves(ch)]
            live = tree_unflatten(ch, lv)
            for j in range(x.shape[0]):
                with torch.no_grad():
                    y = model._stage(ch, x[j])
                with torch.enable_grad():
                    hv = x[j].detach().requires_grad_(True)
                    out = model._stage(live, hv)
                    torch.autograd.grad(out, lv + [hv],
                                        torch.ones_like(out))
                if r == n - 1 and ch is chunks[-1]:
                    hl = [t_.detach().requires_grad_(True) for t_ in
                          tree_leaves(model.head_tree)]
                    with torch.enable_grad():
                        yv = y.detach().requires_grad_(True)
                        lj = model.head_loss(
                            tree_unflatten(model.head_tree, hl), yv,
                            tgts[j])
                        torch.autograd.grad(lj, [yv] + hl)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
    comm.barrier()
    _cuda.reset_launches()      # not the main path's
    return ms


pout = {}
# (a) the interleaved 1F1B at full depth: S 4 x V 3 = 12 blocks, M 8
args = tpl.parse_args(PIPE + ['-V', '3', '-M', '8'])
mem0 = torch.cuda.memory_allocated(dev)
model = tpl.PipelineLM(args, comm, seed=seed)
data = tpl.batches(args, 8, dev)
toks, tgts = next(data)
loss, (ge, gs, gh) = model.value_and_grad(toks, tgts)
torch.cuda.synchronize()
sched = build_interleaved_schedule(4, 3, 8)
a = dict(loss=loss.item(), launches=segment(), T=sched.T,
         idle=schedule_idle_share(sched),
         depths=[sched.depth_act, sched.depth_fin, sched.depth_bin])
chunks = gather_to_root(tree_leaves(gs))
if r == 0:
    e, blocks, h = tpl.init_trees(args, seed, range(12))
    oloss, (oe, ob, oh) = tpl.sequential_value_and_grad(
        args, on(e), [on(b) for b in blocks], on(h), toks, tgts)
    pairs = ([(g_, w_, 'embedding') for g_, w_ in
              zip(tree_leaves(ge), tree_leaves(oe))]
             + [(g_, w_, 'head') for g_, w_ in
                zip(tree_leaves(gh), tree_leaves(oh))])
    for d in range(n):
        for v in range(3):
            pairs += [(g_[v], w_, f'block {v * n + d}') for g_, w_ in
                      zip(chunks[d], tree_leaves(ob[v * n + d]))]
    a['oracle_loss'] = oloss
    a['grad_rel'], a['grad_name'] = worst_pair(pairs)
    del blocks, ob, oe, oh, pairs
_cuda.reset_launches()      # the oracle's launches are not the main path's
del chunks
torch.cuda.empty_cache()
a.update(timed_steps(model, data, pipe_steps, mem0, model.stage))
a['exchange_ms_per_tick'] = a.pop('exchange_ms') / sched.T
a['stage_card_ms'] = stage_card_ms(model, toks, tgts)
pout['a'] = a
del model
torch.cuda.empty_cache()

# (b) --hetero: embed + 2 blocks + head, a rank each, M 8
hargs = tpl.parse_args(PIPE + ['--hetero', '-M', '8'])
mem0 = torch.cuda.memory_allocated(dev)
hm = tpl.HeteroPipelineLM(hargs, comm, seed=seed)
data = tpl.batches(hargs, 8, dev)
toks, tgts = next(data)
loss, g = hm.value_and_grad(toks, tgts)
torch.cuda.synchronize()
b = dict(loss=loss.item(), launches=segment(), wire=hm.pipe.wire_elems,
         param_elems=hm.pipe.param_elems)
rows = comm.gather(g.detach(), 0)
if r == 0:
    e, blocks, h = tpl.init_trees(hargs, seed, [1, 2])
    oloss, (oe, ob, oh) = tpl.sequential_value_and_grad(
        hargs, on(e), [on(x) for x in blocks], on(h), toks, tgts)
    pairs = []
    for s_, tree in enumerate([oe, *ob, oh]):
        flat = torch.cat([x.reshape(-1) for x in tree_leaves(tree)])
        pairs.append((rows[s_][:flat.numel()], flat, f'stage {s_}'))
    b['oracle_loss'] = oloss
    b['grad_rel'], b['grad_name'] = worst_pair(pairs)
    del blocks, ob, pairs
_cuda.reset_launches()
del rows
torch.cuda.empty_cache()
b.update(timed_steps(hm, data, pipe_steps, mem0, hm.pipe.comm))
# the classic schedule's ticks: 2 (S - 1) + M
b['exchange_ms_per_tick'] = b.pop('exchange_ms') / (2 * 3 + 8)
pout['b'] = b
del hm
torch.cuda.empty_cache()

# (c) TP x PP: S 2 x T 2, one block a stage, M 4, against the dense
# pipeline (S 2) on ranks {0, 2} and {1, 3} from the same seed
targs = tpl.parse_args(PIPE + ['--tp', '2', '-V', '1', '-M', '4'])
mem0 = torch.cuda.memory_allocated(dev)
tp = tpl.PipelineLM(targs, comm, seed=seed)
data = tpl.batches(targs, 4, dev)
toks, tgts = next(data)
tl, (te, ts, th) = tp.value_and_grad(toks, tgts)
torch.cuda.synchronize()
c = dict(loss=tl.item(), launches=segment())
pair = comm.split(('stride', 2))
dense = tpl.PipelineLM(tpl.parse_args(PIPE + ['-V', '1', '-M', '4']), pair,
                       seed=seed)
dl, (de, ds, dh) = dense.value_and_grad(toks, tgts)
_cuda.reset_launches()      # the reference's launches
s_, t_ = divmod(r, 2)
vl = 32768 // 2
tblock = TransformerBlock(768, 12, 3072, tp_axis='model',
                          comms={'model': tp.model}, device='meta')
dblock = TransformerBlock(768, 12, 3072, device='meta')
own = {k: v.detach().cpu() for k, v in module_params_from_flax(
    tblock, tree_map(lambda x: x[0], ts)).items()}
got = dense_params_from_ranks(dblock, tp.model.allgather_obj(own))
want = module_params_from_flax(dblock, tree_map(lambda x: x[0], ds))
pairs = ([(got[k].to(dev), want[k], f'block {s_} {k}') for k in want]
         + [(g_, w_, 'embedding') for g_, w_ in
            zip(tree_leaves(te), tree_leaves(de))]
         + [(g_, w_, 'head LayerNorm') for g_, w_ in
            zip(tree_leaves(th['LayerNorm_0']),
                tree_leaves(dh['LayerNorm_0']))]
         + [(th['out']['kernel'], dh['out']['kernel'][:, t_ * vl:
                                                      (t_ + 1) * vl],
             'head kernel slice')])
c['dense_loss'] = dl.item()
c['grad_rel'], c['grad_name'] = worst_pair(pairs)
del dense, got, want, pairs, own, de, ds, dh
pair.finalize()
torch.cuda.empty_cache()
c.update(timed_steps(tp, data, 3, mem0, tp.stage))
c['shared'] = {
    'embed': [sha(x) for x in tree_leaves(tp.embed_tree)],
    'head_ln': [sha(x) for x in tree_leaves(tp.head_tree['LayerNorm_0'])],
    'ln': [sha(x) for k_ in ('LayerNorm_0', 'LayerNorm_1')
           for x in tree_leaves(tp.stage_tree[k_])],
    'row_bias': sha(tp.stage_tree['tp_ffn']['RowParallelDense_0']['bias'])}
c['own'] = sha(tp.stage_tree['tp_ffn']['ColumnParallelDense_0']['Dense_0'][
    'kernel'])
c['coords'] = [s_, t_]
pout['c'] = c
del tp
torch.cuda.empty_cache()


# (d) MultiNodeChainList.to_branching_pipeline on a diamond over the ranks
class Part(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(768, 768)

    def forward(self, x):
        return torch.tanh(self.dense(x))


class Join(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(768, 768, bias=False)
        self.b = nn.Linear(768, 768, bias=False)

    def forward(self, x, y):
        return torch.tanh(self.a(x) + self.b(y))


torch.manual_seed(seed)
mods = [m.to(dev) for m in (Part(), Part(), Part(), Join())]
chain = MultiNodeChainList(comm)
chain.add_link(mods[0], rank=0, rank_in=None, rank_out=(1, 2))
chain.add_link(mods[1], rank=1, rank_in=0, rank_out=3)
chain.add_link(mods[2], rank=2, rank_in=0, rank_out=3)
chain.add_link(mods[3], rank=3, rank_in=(1, 2), rank_out=None)
gd = torch.Generator().manual_seed(seed + 7)
xs = torch.randn(4, seq, 768, generator=gd).to(dev)
ys = torch.randn(4, seq, 768, generator=gd).to(dev)


def mse(y_, t_):
    return ((y_ - t_) ** 2).mean()


total = 0.0
for j in range(4):
    part = mse(chain(xs[j]), ys[j]) / 4
    part.backward()
    total += part.item()
want = {k: p.grad for k, p in mods[r].named_parameters()}
bp = chain.to_branching_pipeline(None, ((seq, 768), torch.float32))
segment()
loss, g = branching_pipeline_value_and_grad(
    bp, mse, bp.pack_params(r), bp.encode_inputs(xs), ys)
torch.cuda.synchronize()
got = bp.unpack_grads(g, r)
d = dict(loss=loss.item(), chain_loss=total, launches=segment(),
         wire=bp.wire_elems, depth=bp.depth)
d['grad_rel'], d['grad_name'] = worst_pair(
    [(got[k], want[k], f'stage {r} {k}') for k in want])
pout['d'] = d
del chain, mods, bp
torch.cuda.empty_cache()
pout['launches'], pout['launches_f32'] = totals['all'], totals['f32']
pout['wall_s'] = time.perf_counter() - t_pipe
pout['staged_bytes'] = comm.staged_bytes - staged
outs = comm.allgather_obj(pout)
finalize()
if r == 0:
    print('pipeline world ' + json.dumps(outs), flush=True)
"""


def _check_parallel_world(world, card: str):
    """(a)-(c) of the ``parallel`` phase from each rank's results."""
    p = PARALLEL
    n, layers = p["ranks"], p["layers"]
    w0 = world[0]
    # (a) sequence parallelism
    for impl in ("ring", "ring_flash", "ulysses"):
        rows = [w["seq"][impl] for w in world]
        a = rows[0]
        want = [{"flash_fwd": f, "flash_bwd": f}
                for f in ([0] * n if impl == "ring" else
                          [layers] * n if impl == "ulysses" else
                          [layers * (r + 1) for r in range(n)])]
        got = [{k: row["launches"].get(k, 0) for k in ("flash_fwd",
                                                       "flash_bwd")}
               for row in rows]
        gap = abs(a["loss"] - a["ref_loss"])
        lw = max(row["logits_rel"] for row in rows)
        print(f"parallel (a) {impl}: the 135M LM (bf16 over f32, 12 "
              f"layers, rope), one sequence of {p['seq']} split over {n} "
              f"host-staged ranks of one card ({p['seq'] // n} a rank): "
              f"loss {a['loss']:.6f} vs the one-rank flash model's "
              f"{a['ref_loss']:.6f} (gap {gap:.6f}, tolerance "
              f"{TOL_TRAIN_LOSS}), worst relative logits error {lw:.5f} and "
              f"gradient error {a['grad_rel']:.5f} ({a['grad_name']}; "
              f"gradients summed over the ranks; tolerance "
              f"{TOL_TRAIN_GRAD}); launches per rank {got}; a forward and "
              f"backward {[round(row['ms'], 3) for row in rows]} ms per "
              f"rank; the attention alone at [1, {p['seq']}, 12, 64] "
              f"(forward and backward, host-staged ring) "
              f"{[round(row['attn_ms'], 3) for row in rows]} ms per rank "
              f"beside one-rank flash {w0['flash_one_rank_ms']:.3f} ms "
              f"({card})", flush=True)
        if gap > TOL_TRAIN_LOSS or lw > TOL_TRAIN_GRAD or (
                a["grad_rel"] > TOL_TRAIN_GRAD):
            raise PhaseError(f"parallel (a) {impl} disagrees with the "
                             "one-rank flash model")
        if got != want:
            raise PhaseError(f"parallel (a) {impl}: launches {got}, "
                             f"expected {want}")
    # (b) tensor parallelism
    t = w0["tp"]
    gap = abs(t["loss"] - t["ref_loss"])
    same = all(w["tp"]["shared"] == t["shared"] for w in world)
    losses = t["losses"]
    print(f"parallel (b) tensor parallelism over {n} ranks (3 heads, d_ff "
          f"768 and a vocabulary slice of {32768 // n} a rank, lm_head_tp, "
          f"tp_lm_loss): loss {t['loss']:.6f} vs the dense model's "
          f"{t['ref_loss']:.6f} (gap {gap:.6f}), worst relative gradient "
          f"error {t['grad_rel']:.5f} ({t['grad_name']}; the ranks' "
          f"gradients gathered into the dense layout), launches "
          f"{[w['tp']['launches'] for w in world]}; {p['tp_steps']} Adam "
          f"steps {[round(v, 5) for v in losses]}, {t['ms']:.3f} ms/step "
          f"(rank 0), {len(t['shared'])} replicated leaves bitwise equal on "
          f"every rank {same} ({card})", flush=True)
    if gap > TOL_TRAIN_LOSS or t["grad_rel"] > TOL_TRAIN_GRAD:
        raise PhaseError("parallel (b): the TP LM disagrees with the dense "
                         "model on its gathered weights")
    want = {"flash_fwd": layers, "flash_bwd": layers}
    steps_want = {k: v * p["tp_steps"] for k, v in want.items()}
    for w in world:
        got = {k: w["tp"]["launches"].get(k, 0) for k in want}
        got_steps = {k: w["tp"]["step_launches"].get(k, 0) for k in want}
        if got != want or got_steps != steps_want:
            raise PhaseError(f"parallel (b): launches {got}, {got_steps}, "
                             f"expected {want}, {steps_want}")
    if not same or not all(math.isfinite(v) for v in losses) or not (
            losses[-1] < losses[0]):
        raise PhaseError(f"parallel (b): losses {losses}, replicated "
                         f"leaves equal {same}")
    # (c) expert parallelism
    for k in ("1", "2"):
        m = w0["moe"][k]
        lgap = abs(m["loss"] - m["oracle_loss"]) / abs(m["oracle_loss"])
        same = all(w["moe"][k]["shared"] == m["shared"] for w in world)
        differ = len({json.dumps(w["moe"][k]["experts"],
                                 sort_keys=True) for w in world}) == n
        losses = m["losses"]
        print(f"parallel (c) expert parallelism, top-{k}: "
              f"{p['moe_experts'] * n} experts over {n} ranks, capacity "
              f"factor 2.0, one sequence of {p['seq']} a rank; one f32 step "
              f"(TF32 off): loss {m['loss']:.6f} vs the one-process oracle's "
              f"{m['oracle_loss']:.6f} (relative {lgap:.2e}, tolerance "
              f"{TOL_MOE_ORACLE_LOSS_REL}), worst relative gradient error "
              f"{m['grad_rel']:.2e} ({m['grad_name']}, tolerance "
              f"{TOL_MOE_ORACLE_GRAD}); {p['moe_steps']} bf16 steps: losses "
              f"{[round(v, 5) for v in losses]}, {m['ms']:.3f} ms/step "
              f"(rank 0), tokens dropped "
              f"{[round(w['moe'][k]['dropped'], 5) for w in world]} per "
              f"rank, launches a rank {m['step_launches']}, shared leaves "
              f"bitwise equal on every rank {same}, expert leaves differ "
              f"{differ} ({card})", flush=True)
        if lgap > TOL_MOE_ORACLE_LOSS_REL or (
                m["grad_rel"] > TOL_MOE_ORACLE_GRAD):
            raise PhaseError(f"parallel (c) top-{k}: the expert-parallel "
                             "step disagrees with the one-process oracle")
        want = {"flash_fwd": layers * p["moe_steps"],
                "flash_bwd": layers * p["moe_steps"], "ce_fwd": 0,
                "ce_dh": 0, "ce_dw": 0}
        for w in world:
            got = {q: w["moe"][k]["step_launches"].get(q, 0) for q in want}
            if got != want:
                raise PhaseError(f"parallel (c) top-{k}: launches {got}, "
                                 f"expected {want}")
        if not (same and differ) or not all(
                math.isfinite(v) for v in losses) or not (
                    losses[-1] < losses[0]):
            raise PhaseError(f"parallel (c) top-{k}: losses {losses}, "
                             f"shared equal {same}, experts differ "
                             f"{differ}")


def _check_parallel_lm(runs, card: str):
    """(d): ``train_lm``'s parallel flags on the 4 ranks."""
    p = PARALLEL
    n, layers, it = p["ranks"], p["lm_layers"], p["lm_iterations"]
    for name in runs[0]:
        rows = [w[name] for w in runs]
        r0 = rows[0]
        demo = {"ring": [0] * n, "ulysses": [layers] * n,
                "ring_flash": [layers * (r + 1) for r in range(n)]}.get(
                    name, [0] * n)
        want = [{"flash_fwd": layers * it + demo[r],
                 "flash_bwd": layers * it, "ce_fwd": 0, "ce_dh": 0,
                 "ce_dw": 0} for r in range(n)]
        got = [{k: row["launches"].get(k, 0) for k in want[0]}
               for row in rows]
        print(f"parallel (d) train_lm {name}: d 768 x {layers} layers, "
              f"vocab 32768, seq 2048, batch 1 a rank, f32, {n} host-staged "
              f"ranks, {it} iterations: losses "
              f"{[round(v, 5) for v in r0['losses']]}, {r0['ms']:.3f} "
              f"ms/step (rank 0; a check-only figure at 2 layers, not a "
              f"per-step metric of the LM)"
              + (f", next-token accuracy of the trained weights "
                 f"{r0['acc']:.4f}" if r0["acc"] is not None else "")
              + f", launches per rank {got} ({card})", flush=True)
        if not all(math.isfinite(v) for v in r0["losses"]) or (
                len(r0["losses"]) != it):
            raise PhaseError(f"train_lm {name}: losses {r0['losses']}")
        if name in ("ring", "ring_flash", "ulysses") and r0["acc"] is None:
            raise PhaseError(f"train_lm {name}: no accuracy line")
        if got != want or any(row["launches"] != row["launches_f32"]
                              for row in rows):
            raise PhaseError(f"train_lm {name}: launches {got}, expected "
                             f"{want}, all f32")


def _check_pipeline(world, card: str):
    """(a)-(d) of the ``pipeline`` phase from each rank's results."""
    n, steps = PARALLEL["ranks"], PIPE_STEPS
    a0 = world[0]["a"]

    def oracle(tag, row, ref_key):
        gap = abs(row["loss"] - row[ref_key]) / abs(row[ref_key])
        if gap > TOL_PIPE_LOSS_REL or row["grad_rel"] > TOL_PIPE_GRAD:
            raise PhaseError(f"pipeline {tag}: loss {row['loss']} vs "
                             f"{row[ref_key]} (relative {gap:.2e}), worst "
                             f"gradient {row['grad_rel']:.2e} "
                             f"({row['grad_name']})")
        return gap

    def falling(tag, losses, must_fall):
        if not all(math.isfinite(v) for v in losses) or (
                must_fall and not losses[-1] < losses[0]):
            raise PhaseError(f"pipeline {tag}: losses {losses}")

    def launches(tag, rows, want):
        got = [{k: row.get(k, 0) for k in want[0]} for row in rows]
        if got != want:
            raise PhaseError(f"pipeline {tag}: launches {got}, expected "
                             f"{want}")
        return got

    # (a) interleaved 1F1B, S 4 x V 3, M 8: every rank 2·V·M flash_fwd
    # (the forward and its remat) and V·M flash_bwd a step, no CE kernel
    V, M = 3, 8
    want = [{"flash_fwd": 2 * V * M, "flash_bwd": V * M, "ce_fwd": 0,
             "ce_dh": 0, "ce_dw": 0}] * n
    got = launches("(a)", [w["a"]["launches"] for w in world], want)
    launches("(a) timed", [w["a"]["step_launches"] for w in world],
             [{k: v * steps for k, v in row.items()} for row in want])
    gap = oracle("(a)", a0, "oracle_loss")
    falling("(a)", a0["losses"], True)
    print(f"pipeline (a) interleaved 1F1B: the 135M LM's block at full "
          f"width (d 768, 12 heads, d_ff 3072, vocab 32768, seq "
          f"{PARALLEL['seq']}, f32, TF32 off), S {n} x V {V} = {n * V} "
          f"blocks, M {M} micro-batches of [1, {PARALLEL['seq']}], the "
          f"embedding outside and the head in the loss hook, {n} host-staged "
          f"ranks: loss {a0['loss']:.6f} vs the one-rank sequential oracle's "
          f"{a0['oracle_loss']:.6f} (relative {gap:.2e}, tolerance "
          f"{TOL_PIPE_LOSS_REL}), worst relative gradient error "
          f"{a0['grad_rel']:.2e} ({a0['grad_name']}, tolerance "
          f"{TOL_PIPE_GRAD}); launches per rank {got}; schedule T "
          f"{a0['T']} ticks, idle share of tick slots {a0['idle']:.4f}, "
          f"depths (act, fwd inbox, bwd inbox) {a0['depths']}; {steps} Adam "
          f"steps {[round(v, 5) for v in a0['losses']]}, "
          f"{[round(w['a']['ms'], 3) for w in world]} ms/step per rank, "
          f"peak {[round(w['a']['peak_gib'], 3) for w in world]} GiB per "
          f"rank (its model, optimizer and steps), host-staged exchange "
          f"{[round(w['a']['exchange_ms_per_tick'], 3) for w in world]} "
          f"ms per tick per rank; a step's stage work alone on the card "
          f"(CUDA events, each rank in turn) "
          f"{[round(w['a']['stage_card_ms'], 3) for w in world]} ms per "
          f"rank, {sum(w['a']['stage_card_ms'] for w in world):.3f} ms in "
          f"all ({card})", flush=True)
    # (b) --hetero: embed, 2 blocks, head; the blocks' ranks launch flash
    b0 = world[0]["b"]
    if b0["wire"] != PARALLEL["seq"] * 768:
        raise PhaseError(f"pipeline (b): wire {b0['wire']} elements, not "
                         f"1 x {PARALLEL['seq']} x 768")
    want = [{"flash_fwd": 2 * M if 0 < r < n - 1 else 0,
             "flash_bwd": M if 0 < r < n - 1 else 0} for r in range(n)]
    got = launches("(b)", [w["b"]["launches"] for w in world], want)
    gap = oracle("(b)", b0, "oracle_loss")
    falling("(b)", b0["losses"], True)
    print(f"pipeline (b) --hetero: embed + 2 blocks + head, one stage a "
          f"rank, M {M}, wire {b0['wire']} elements (1 x {PARALLEL['seq']} "
          f"x 768, not vocabulary-wide), rows of {b0['param_elems']} f32: "
          f"loss {b0['loss']:.6f} vs the oracle's {b0['oracle_loss']:.6f} "
          f"(relative {gap:.2e}), worst relative gradient error "
          f"{b0['grad_rel']:.2e} ({b0['grad_name']}); launches per rank "
          f"{got}; {steps} Adam steps {[round(v, 5) for v in b0['losses']]}, "
          f"{[round(w['b']['ms'], 3) for w in world]} ms/step per rank, peak "
          f"{[round(w['b']['peak_gib'], 3) for w in world]} GiB per rank, "
          f"host-staged exchange "
          f"{[round(w['b']['exchange_ms_per_tick'], 3) for w in world]} ms "
          f"per tick per rank ({card})", flush=True)
    # (c) TP x PP, S 2 x T 2, M 4: one TP block a rank
    c0 = world[0]["c"]
    gap = oracle("(c)", c0, "dense_loss")
    for w in world:
        oracle("(c)", w["c"], "dense_loss")
    M = 4
    launches("(c)", [w["c"]["launches"] for w in world],
             [{"flash_fwd": 2 * M, "flash_bwd": M}] * n)
    cells = {tuple(w["c"]["coords"]): w["c"] for w in world}
    same = all(cells[(s, 0)]["shared"] == cells[(s, 1)]["shared"]
               and cells[(s, 0)]["own"] != cells[(s, 1)]["own"]
               and cells[(s, 0)]["losses"] == cells[(s, 1)]["losses"]
               for s in range(2))
    falling("(c)", c0["losses"], True)
    print(f"pipeline (c) TP x PP: S 2 x T 2 (6 heads, d_ff 1536 and a "
          f"vocabulary slice of 16384 a rank), M {M}: loss "
          f"{c0['loss']:.6f} vs the dense pipeline's {c0['dense_loss']:.6f} "
          f"(relative {gap:.2e}), worst relative gradient error "
          f"{max(w['c']['grad_rel'] for w in world):.2e} (the ranks' "
          f"gradients gathered into the dense layout); 3 Adam steps "
          f"{[round(v, 5) for v in c0['losses']]}, "
          f"{[round(w['c']['ms'], 3) for w in world]} ms/step per rank, "
          f"peak {[round(w['c']['peak_gib'], 3) for w in world]} GiB per "
          f"rank, model-replicated leaves bitwise equal along model {same} "
          f"({card})", flush=True)
    if not same:
        raise PhaseError("pipeline (c): model-replicated leaves differ "
                         "along model")
    # (d) the chain list's diamond
    for w in world:
        oracle("(d)", w["d"], "chain_loss")
    d0 = world[0]["d"]
    print(f"pipeline (d) MultiNodeChainList.to_branching_pipeline on a "
          f"diamond over {n} ranks (Linear 768 + tanh stages, a join of two "
          f"768-wide inputs, 4 micro-batches of [{PARALLEL['seq']}, 768]): "
          f"loss {d0['loss']:.6f} vs the chain's own run "
          f"{d0['chain_loss']:.6f}, worst relative gradient error "
          f"{max(w['d']['grad_rel'] for w in world):.2e}, depths "
          f"{d0['depth']} ({card})", flush=True)


def parallel(seed: int, card: str):
    """The ``parallel`` phase: (a)-(d) in one world of 4 host-staged
    ranks. Returns the main path's launches summed over the ranks, and
    those on f32 inputs."""
    import tempfile

    p = PARALLEL
    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        outs = run_ranks([sys.executable, "-c", _PARALLEL_WORLD_SCRIPT,
                          str(seed), str(p["seq"]), str(p["layers"]),
                          str(p["moe_experts"]), str(p["moe_steps"]),
                          str(p["tp_steps"]), str(p["attn_iters"]),
                          str(p["lr"]), str(p["lm_layers"]),
                          str(p["lm_iterations"]), d, str(PIPE_STEPS)],
                         p["ranks"], timeout=900)
    world_s = time.perf_counter() - t0
    world = json.loads([ln for ln in outs[0].splitlines()
                        if ln.startswith("parallel world ")][-1][
                            len("parallel world "):])
    _check_parallel_world(world, card)
    lm = json.loads([ln for ln in outs[0].splitlines()
                     if ln.startswith("parallel train_lm ")][-1][
                         len("parallel train_lm "):])
    runs = lm["runs"]
    for line in outs[0].splitlines():
        if "next-token acc" in line:
            print(f"parallel (d) {line} ({card})", flush=True)
    _check_parallel_lm(runs, card)
    pipe = json.loads([ln for ln in outs[0].splitlines()
                       if ln.startswith("pipeline world ")][-1][
                           len("pipeline world "):])
    _check_pipeline(pipe, card)
    counts, f32 = {}, {}
    for w in world:
        for k, v in w["launches"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in w["launches_f32"].items():
            f32[k] = f32.get(k, 0) + v
    for w in runs:
        for row in w.values():
            for k, v in row["launches"].items():
                counts[k] = counts.get(k, 0) + v
                f32[k] = f32.get(k, 0) + v
    # the pipeline phase runs f32 models only
    for w in pipe:
        for k, v in w["launches"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in w["launches_f32"].items():
            f32[k] = f32.get(k, 0) + v
    print(f"pipeline: {pipe[0]['wall_s']:.1f} s of wall in the parallel "
          f"phase's world, host-staged bytes (rank 0) "
          f"{pipe[0]['staged_bytes']:,}, main-path launches of every rank "
          f"{[w['launches'] for w in pipe]} ({card})", flush=True)
    print(f"parallel: one world of {p['ranks']} ranks, {world_s:.1f} s of "
          f"wall (process start included; (d) {lm['wall_s']:.1f} s and the "
          f"pipeline phase {pipe[0]['wall_s']:.1f} s of it), "
          f"host-staged bytes (rank 0) {lm['staged_bytes']:,}, "
          f"main-path launches of every rank {counts} (f32 {f32}) "
          f"({card})", flush=True)
    return counts, f32, pipe[0]["wall_s"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one more served run, one more "
                         "train call, 20 more MNIST, CIFAR and seq2seq "
                         "steps, one more ResNet-50 call and 5 ViT steps "
                         "(fixed batch, then through the example) into DIR "
                         "(chrome traces and kernel tables)")
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
    from chainermn_torch.ops.fused_ce import (ce_dh_cuda_plan,
                                              ce_dw_cuda_plan,
                                              ce_fwd_cuda_plan)

    # f32 products in full f32 (the reference forward's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    # each phase's wall seconds, printed before the kernels line
    marks = [("start", time.perf_counter())]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))

    # two worlds of the model_parallel phase time nothing: they run
    # beside the build, and end before the kernels are timed
    beside_pool = concurrent.futures.ThreadPoolExecutor(1)
    beside = beside_pool.submit(model_parallel_beside_build)
    t0 = time.perf_counter()
    took = _cuda.build_all(variants=[
        *LIFTED_CAPS.items(), ("fused_ce", CE_LAYOUT)])
    print(f"build: {json.dumps(took)} total "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    # the SASS dumps run on the host beside the (untimed) kernel checks
    sass_pool = concurrent.futures.ThreadPoolExecutor(1)
    sass = sass_pool.submit(count_tensor_core_ops, card)
    print("ptxas: " + "; ".join(
        [f"{name}_mma<64> {_usage(mma64_usage(name))}"
         for name in ("flash_fwd", "flash_bwd")]
        + [f"ce_fwd bf16 (wgmma) {_usage(ce_fwd_usage())}"]
        + [f"{name} bf16 D <= 768 {_usage(u)}"
           for name, u in ce_bwd_usage().items()]
        + [f"{name} f32 ({kernel}) {_usage(u)}"
           for name, (kernel, u) in f32_usage().items()])
        + f" ({card})", flush=True)
    print("f32 grids: " + "; ".join(
        f"ce_fwd N {n}: S={p['splits']} of {p['per']} tiles, grid "
        f"{p['grid'][0]}x{p['grid'][1]} ({p['grid'][0] * p['grid'][1]} CTAs, "
        f"{_cuda.ce_fwd_tile(torch.float32)[3]} an SM)"
        for n, p in ((n, ce_fwd_cuda_plan(n, 768, 32768, "cuda",
                                          torch.float32))
                     for n in (1024, 8192))) + "; " + "; ".join(
        f"{name} N {n}: S={p['splits']} of {p['per']} tiles, grid "
        f"{'x'.join(map(str, p['grid']))} ({math.prod(p['grid'])} CTAs), "
        f"workspace {p['workspace_bytes']} B"
        for name, plan in (("ce_dh", ce_dh_cuda_plan),
                           ("ce_dw", ce_dw_cuda_plan))
        for n, p in ((n, plan(n, 768, 32768)) for n in (1024, 8192)))
        + f" (D 768, V 32768; {card})", flush=True)

    beside_build = beside.result()
    beside_pool.shutdown()
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = check_kernels(gen)
    bwd_worst = check_flash_bwd(gen)
    worst["flash_bwd"] = bwd_worst["train"]
    # the f32 bodies: the worst of their cases on the f32 phases' paths
    f32_cases = [c[0] for c in F32_PATH_CASES + PARALLEL_CASES
                 if c[7] == "float32"] + ["f32"]
    worst["flash_fwd_f32"] = max(worst[c] for c in f32_cases)
    worst["flash_bwd_f32"] = max(bwd_worst[c] for c in
                                 f32_cases + ["ring-merged-float32"])
    worst.update(check_fused_ce(gen))
    sass.result()
    sass_pool.shutdown()
    def show(name, where, row, extra=""):
        if "launch_ms" in row:
            extra += (f", the launch alone {row.pop('launch_ms'):.4f} ms "
                      f"(the call adds Dr, zeroing dq and its cast)")
        if "pair_library_ms" in row:
            extra += (f", library dh and dW in one call "
                      f"{row.pop('pair_library_ms'):.4f} ms")
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
    # the ViT's path: non-causal, ragged 196 (197 with the class token)
    for (case, b, lq, lk, hq, hkv, d, _, causal, window,
         _) in VIT_CASES:
        for name, row in time_flash_case(gen, b, lq, lk, hq, hkv, d, causal,
                                         window).items():
            show(name, f"case={case} [{b},{lq}|{lk},{hq}|{hkv},{d}] bf16 "
                       f"non-causal", row)
    times, pair = time_training_kernels(gen)
    plan = ce_fwd_cuda_plan(8192, 768, 32768)
    for name, row in times.items():
        show(name, "training shape", row, "" if name != "ce_fwd" else (
            f", tile {'x'.join(map(str, _cuda.ce_fwd_tile()[:3]))} (rows x "
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
    f32_times, f32_lm = time_f32_kernels(gen)
    for name, row in f32_times.items():
        show(name, "the ZeRO phase's f32 shape: flash [4,2048,12,64] "
             "causal, CE [1024,768]x[768,32768]", row)
    for name, row in f32_lm.items():
        show(name, "the f32 LM loss of batch 4 x 2048: CE "
             "[8192,768]x[768,32768]", row)
    times.update(f32_times)
    compare_launch_bounds(gen, card)
    compare_ce_layouts(gen, card)
    mark("kernels")

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
    plain_rate = (f"ttft p50 {summ['ttft_ms']['p50']:.2f} ms, decode "
                  f"tokens/s {decode_tokens / summ['wall_s']:.1f}")
    del eng
    mark("slice")
    streams = [r.tokens for r in reqs]
    serve_flash, gap = serving_rest(model, prompts, streams, args.seed,
                                    plain_rate, card, mark)
    serve_flash += fleet(model, prompts, streams, gap, args.seed,
                         plain_rate, card, mark)
    if args.profile:
        profile_serving(model, prompts, args.profile, card)
    del model
    torch.cuda.empty_cache()

    train_counts, _ = train(args.seed, card)
    if args.profile:
        profile_training(args.seed, args.profile, card)
    torch.cuda.empty_cache()
    mark("train")
    mnist_counts = mnist(card, args.profile)
    mark("mnist")
    cifar_counts = cifar(card, args.profile)
    mark("cifar")
    torch.cuda.empty_cache()
    r50_counts = resnet50(args.seed, card, args.profile)
    mark("resnet50")
    torch.cuda.empty_cache()
    s2s_counts = seq2seq(card, args.profile)
    mark("seq2seq")
    mp_counts = model_parallel(card, beside_build)
    mark("model_parallel")
    torch.cuda.empty_cache()
    vit_counts = vit(args.seed, card, args.profile)
    mark("vit")
    ckpt_counts, full_losses = checkpoint(card)
    mark("checkpoint")
    red_counts = reducers(args.seed, card)
    mark("reducers")
    zero_counts, zero_f32 = zero(args.seed, card)
    mark("zero")
    fsdp_counts, fsdp_f32 = fsdp(args.seed, card)
    mark("fsdp")
    torch.cuda.empty_cache()
    res_counts, res_f32 = resilience(card, full_losses)
    mark("resilience")
    torch.cuda.empty_cache()
    par_counts, par_f32, pipe_s = parallel(args.seed, card)
    mark("parallel")
    print("phases (s of wall): " + json.dumps(
        {**{name: round(t - marks[i][1], 1)
            for i, (name, t) in enumerate(marks[1:])},
         "pipeline (in parallel)": round(pipe_s, 1)})
        + f", total {marks[-1][1] - marks[0][1]:.1f} ({card})", flush=True)

    sources = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:168"),
               "flash_bwd": ("flash_bwd.cu", "flash_attention.py:399"),
               "ce_fwd": ("fused_ce.cu", "fused_ce.py:58"),
               "ce_dh": ("fused_ce.cu", "fused_ce.py:103"),
               "ce_dw": ("fused_ce.cu", "fused_ce.py:126")}
    errs = {"flash_fwd": worst["prefill"], **{
        name: worst[name] for name in sources if name != "flash_fwd"}}
    kernels = []
    for name, (src, tpu) in sources.items():
        # serving, training, the ViT, its checkpoint runs, the ZeRO,
        # FSDP, resilience, parallel and pipeline phases drive flash (and
        # the ZeRO, FSDP and resilience phases the CE kernels): a count is
        # the sum
        # of the main-path runs (the MNIST, CIFAR, ResNet-50, seq2seq,
        # model-parallel and reducer runs add none). The phases before the
        # ZeRO phase run bf16 models; the f32 runs' launches of the ZeRO,
        # FSDP, resilience and parallel phases go to the f32 bodies' own
        # rows
        bf16 = (train_counts[name] + mnist_counts[name]
                + cifar_counts[name] + r50_counts[name] + s2s_counts[name]
                + mp_counts.get(name, 0) + vit_counts[name]
                + ckpt_counts[name] + red_counts.get(name, 0)
                + zero_counts.get(name, 0) - zero_f32.get(name, 0)
                + fsdp_counts.get(name, 0) - fsdp_f32.get(name, 0)
                + res_counts.get(name, 0) - res_f32.get(name, 0)
                + par_counts.get(name, 0) - par_f32.get(name, 0) + (
                    counts["flash_fwd"] + serve_flash
                    if name == "flash_fwd" else 0))
        f32 = (zero_f32.get(name, 0) + fsdp_f32.get(name, 0)
               + res_f32.get(name, 0) + par_f32.get(name, 0))
        for row, n in ((name, bf16), (f"{name}_f32", f32)):
            kernels.append({
                "name": row, "route": "cuda",
                "source": f"chainermn_torch/csrc/{src}",
                "replaces": f"chainermn_tpu/ops/{tpu}",
                "launches": n, "max_abs_err": worst[row] if row != name
                else errs[name], **times[row]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
