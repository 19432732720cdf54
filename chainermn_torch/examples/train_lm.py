"""Data-parallel Transformer LM on synthetic text, and its ZeRO-1/2
sharded forms: the port's ``examples/transformer_lm/train_lm.py``.

The JAX example's flow: a causal LM (``TransformerLM``: flash attention,
``d_ff = 4·d_model``, ``max_len = --seq-len``) over the synthetic cyclic
sequences (:func:`synthetic_text`, the JAX example's) or a real text file
tokenized by byte-level BPE (``--text-file``, ``--bpe-vocab``: the
port's ``datasets/bpe.py``, the vocabulary cached beside the file),
``scatter_dataset`` → ``SerialIterator`` → ``StandardUpdater`` →
``Trainer`` with rank-0 reports, and Adam (optax's: eps 1e-8 after the
square root) with ``lm_loss_with_aux``:

* default: ``create_multi_node_optimizer(Adam)`` behind
  ``make_data_parallel_train_step``;
* ``--zero 1``: ``make_zero1_train_step`` (Adam's moments sharded 1/N
  per rank); ``--zero 2``: ``make_zero2_train_step`` with 2
  micro-batches (the gradient accumulator sharded too);
  ``--zero-bucket-kib K`` reduce-scatters each K KiB bucket of
  gradients as the backward produces it;
* ``--zero 3``: ``make_fsdp_train_step`` on the model (every parameter
  sharded, gathered on each use);
* ``--fsdp-scan``: the model's flax-layout tree stacked
  (``stack_lm_blocks``), its blocks split within each layer
  (``fsdp_stack_shardings``), trained through ``make_fsdp_train_step``
  with ``make_lm_fsdp_scan_loss``: one layer gathered at a time and
  again in the backward, the fused head + CE loss.

The dense flags: ``--n-kv-heads`` (GQA/MQA), ``--window`` (sliding
window), ``--rope``; ``--qkv-layout bhld`` trains the same model (JAX's
head-major layout exists for the TPU's tiles; the port's kernels read
q, k and v through strides, so it has one layout). On the card the
attention runs the flash kernels in f32 (JAX's example has no dtype
flag, and the port adds none). ``--batchsize`` is each rank's batch
(the JAX script's is global); ``--iterations`` stops after N iterations
instead of epochs.

The intra-layer parallel flags (``chainermn_torch.parallel``):

* ``--moe N``: the FFN becomes a Switch MoE (``--moe-top-k 2``: GShard
  top-2) with N experts on each rank, the experts split over the ranks
  (capacity factor 2.0), initialised by ``init_expert_parallel_state``
  and trained by ``make_expert_parallel_train_step`` with plain Adam and
  ``lm_loss_with_aux`` (the load-balancing term added); it takes
  precedence over ``--zero``, as in JAX;
* ``--ring``: after training, sequence-parallel inference of the trained
  weights on the first training sequence (rank 0's), split over the
  ranks (``--seq-impl ring|ring_flash|ulysses``, default ``ring``), with
  the next-token accuracy printed; skipped, with JAX's messages, after a
  MoE, GQA, ZeRO, FSDP-scan or ``bhld`` run, and for Ulysses when the
  ranks do not divide ``--n-heads``.

JAX's own refusals are kept: ``--zero 3`` with ``--zero-bucket-kib``,
``--fsdp-scan`` with ``--zero``, with ``--moe``, or with a vocabulary
that is not a multiple of 128. ``--autotune-blocks`` does not apply while
the CUDA kernels fix their own tiles (ROADMAP.md queue 1 item 6).

    python -m chainermn_torch.examples.train_lm --epoch 2
    python -m chainermn_torch.examples.train_lm --zero 1 \\
        --zero-bucket-kib 4096 --iterations 20
    python -m chainermn_torch.examples.train_lm --device cpu \\
        --n-train 256 --batchsize 16 --epoch 1 --zero 2
    python -m chainermn_torch.examples.train_lm --device cpu \\
        --vocab 128 --n-train 256 --batchsize 16 --epoch 1 --fsdp-scan
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_lm \\
        --device cpu --zero 1 --n-train 256 --batchsize 8 --epoch 1
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_lm \\
        --device cpu --moe 2 --moe-top-k 2 --n-train 64 --iterations 2
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_lm \\
        --device cpu --ring --seq-impl ulysses --n-train 64 --iterations 2
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import scatter_dataset
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.convert import flax_params
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux,
                                                make_lm_fsdp_scan_loss,
                                                stack_lm_blocks)
from chainermn_torch.optimizers import (create_multi_node_optimizer,
                                        fsdp_shardings,
                                        fsdp_stack_shardings,
                                        make_fsdp_train_step,
                                        make_zero1_train_step,
                                        make_zero2_train_step)
from chainermn_torch.resilience.supervisor import main_exit_code
from chainermn_torch.training import (LogReport, PrintReport,
                                      StandardUpdater, Trainer,
                                      init_expert_parallel_state,
                                      make_data_parallel_train_step,
                                      make_expert_parallel_train_step)


def synthetic_text(n: int, length: int, vocab: int, seed: int = 0):
    """Cyclic sequences with a per-sample stride (the JAX example's)."""
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, vocab, size=n)
    strides = rng.randint(1, 4, size=n)
    pos = np.arange(length + 1)
    seq = (starts[:, None] + strides[:, None] * pos[None]) % vocab
    return [(seq[i, :-1].astype(np.int32), seq[i, 1:].astype(np.int32))
            for i in range(n)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="chainermn_torch example: Transformer LM")
    p.add_argument("--batchsize", "-b", type=int, default=64,
                   help="batch size of each rank")
    p.add_argument("--epoch", "-e", type=int, default=3)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after N iterations instead of epochs")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--communicator", type=str, default="pure_nccl")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--moe", type=int, default=0, metavar="N",
                   help="experts per device (0 = dense FFN)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token (1 = Switch, 2 = GShard)")
    p.add_argument("--ring", action="store_true",
                   help="sequence-parallel attention demo after training "
                        "(implementation: --seq-impl)")
    p.add_argument("--seq-impl", choices=["ring", "ring_flash", "ulysses"],
                   default="ring",
                   help="sequence-parallel attention used by --ring")
    p.add_argument("--fsdp-scan", action="store_true",
                   help="FSDP over a scanned layer stack (one layer "
                        "gathered at a time), fused head + CE loss")
    p.add_argument("--zero", type=int, default=0, choices=[0, 1, 2, 3],
                   help="ZeRO stage: 1 = sharded optimizer state, 2 = + "
                        "sharded grad accumulator (2 microbatches), 3 = "
                        "FSDP")
    p.add_argument("--zero-bucket-kib", type=int, default=0,
                   help="with --zero 1/2: reduce-scatter per KiB-sized "
                        "gradient bucket")
    p.add_argument("--qkv-layout", choices=["blhd", "bhld"],
                   default="blhd",
                   help="accepted for the JAX script's sake: the port has "
                        "one layout")
    p.add_argument("--n-kv-heads", type=int, default=0, metavar="K",
                   help="KV heads < query heads = GQA/MQA (0 = all)")
    p.add_argument("--window", type=int, default=0, metavar="W",
                   help="sliding-window attention span (0 = full)")
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings instead of a learned "
                        "table")
    p.add_argument("--autotune-blocks", action="store_true",
                   help="not applicable: the CUDA kernels fix their tiles")
    p.add_argument("--text-file", default=None,
                   help="train from a text file: byte-BPE tokenize, "
                        "concatenate, chop into --seq-len windows")
    p.add_argument("--bpe-vocab", type=int, default=512,
                   help="BPE vocabulary size for --text-file")
    p.add_argument("--out", "-o", default="result_lm")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    return p.parse_args(argv)


def _refuse(args) -> None:
    """JAX's own refusals, then what does not apply to the port."""
    if args.fsdp_scan and args.zero:
        raise SystemExit("--fsdp-scan and --zero are exclusive")
    if args.zero == 3 and args.zero_bucket_kib:
        raise SystemExit(
            "--zero-bucket-kib applies to --zero 1/2 only: FSDP gradient "
            "liveness follows XLA's per-leaf schedule, not the bucket "
            "plan")
    if args.fsdp_scan and args.moe > 0:
        raise SystemExit("--fsdp-scan does not compose with --moe (the "
                         "load-balancing aux cannot thread through the "
                         "scan)")
    if args.autotune_blocks:
        raise NotImplementedError(
            "--autotune-blocks does not apply: the port's CUDA flash "
            "kernels fix their own tiles (ROADMAP.md queue 1 item 6)")


def _text_windows(args, comm):
    """Rank 0 tokenizes ``--text-file`` (the vocabulary cached beside
    it) into ``--seq-len`` next-token windows; the vocabulary size goes
    to every rank."""
    from chainermn_torch.datasets.bpe import train_bpe_file

    train = None
    if comm.rank == 0:
        cache = args.text_file + f".bpe{args.bpe_vocab}.json"
        tok = train_bpe_file(args.text_file, args.bpe_vocab,
                             cache_path=cache)
        with open(args.text_file, encoding="utf-8") as f:
            ids = np.asarray(tok.encode(f.read(), eos=True), np.int32)
        L = args.seq_len
        if len(ids) < L + 1:
            raise SystemExit(
                f"--text-file encodes to only {len(ids)} tokens — need "
                f"at least seq_len+1 = {L + 1} for one training window; "
                "use a longer file or a smaller --seq-len")
        n_win = (len(ids) - 1) // L
        train = [(ids[i * L:i * L + L], ids[i * L + 1:i * L + L + 1])
                 for i in range(n_win)]
        print(f"text: {len(ids)} tokens, BPE vocab {tok.vocab_size}, "
              f"{len(train)} windows of {L} ({cache})", flush=True)
        args.vocab = tok.vocab_size
    args.vocab = comm.bcast_obj(args.vocab)
    return train


class _NoModel:
    """The updater's model under FSDP: the step's state holds the
    parameters, so the model adds nothing to :attr:`StandardUpdater.
    state`."""

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        del state


def build_trainer(args):
    """Everything up to ``trainer.run()``: ``(trainer, model)``; the
    communicator is ``trainer.updater.comm``, and with ``--zero`` or
    ``--fsdp-scan`` the step's state
    (:class:`~chainermn_torch.optimizers.zero.ZeroState` or
    :class:`~chainermn_torch.optimizers.zero.FsdpState`) is
    ``trainer.updater.optimizer``. Under FSDP the model's sharded
    parameters read their gathered values (``--zero 3``), or the model
    is not trained at all (``--fsdp-scan`` trains the stacked tree)."""
    _refuse(args)
    comm = create_communicator(args.communicator, device=args.device)
    if comm.is_master:
        print(f"ranks: {comm.size}  device: {comm.device}  zero: "
              f"{args.zero}", flush=True)
    if args.text_file:
        train = scatter_dataset(_text_windows(args, comm), comm,
                                shuffle=True, seed=0, shared_storage=False)
    else:
        train = scatter_dataset(
            synthetic_text(args.n_train, args.seq_len, args.vocab, seed=0),
            comm, shuffle=True, seed=0)

    torch.manual_seed(0)
    moe = {}
    if args.moe > 0:
        moe = dict(moe_experts_per_device=args.moe,
                   expert_axis=comm.axis_name, capacity_factor=2.0,
                   moe_top_k=args.moe_top_k, comms={comm.axis_name: comm})
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads or None, n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=args.seq_len,
        pos_emb="rope" if args.rope else "learned",
        attention_window=args.window or None, device=comm.device, **moe)
    if args.moe > 0:
        specs = init_expert_parallel_state(model, comm, seed=0)
    else:
        comm.bcast_data(model)
    if args.fsdp_scan and args.vocab % 128:
        comm.finalize()
        raise SystemExit("--fsdp-scan needs vocab % 128 == 0 (fused "
                         "head+CE vocab tile)")

    def adam(params):
        return torch.optim.Adam(params, lr=args.lr, eps=1e-8)

    state_model = model
    if args.moe > 0:
        # plain Adam: the expert gradients stay on their ranks, the
        # shared ones are summed inside the step
        optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                     eps=1e-8)
        step = make_expert_parallel_train_step(model, optimizer, comm,
                                               specs,
                                               loss_fn=lm_loss_with_aux)
    elif args.fsdp_scan:
        packed = stack_lm_blocks(flax_params(model))
        shardings = dict(
            fsdp_shardings(packed, comm),
            blocks=fsdp_stack_shardings(packed, comm)["blocks"])
        step, optimizer = make_fsdp_train_step(
            None, adam, comm, packed,
            loss_fn=make_lm_fsdp_scan_loss(model),
            param_shardings=shardings)
        state_model = _NoModel()
    elif args.zero == 3:
        step, optimizer = make_fsdp_train_step(model, adam, comm,
                                               loss_fn=lm_loss_with_aux)
        state_model = _NoModel()
    elif args.zero:
        bb = args.zero_bucket_kib * 1024 if args.zero_bucket_kib else None
        if args.zero == 1:
            step, optimizer = make_zero1_train_step(
                model, adam, comm, loss_fn=lm_loss_with_aux,
                bucket_bytes=bb)
        else:
            step, optimizer = make_zero2_train_step(
                model, adam, comm, n_microbatches=2,
                loss_fn=lm_loss_with_aux, bucket_bytes=bb)
    else:
        optimizer = create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8),
            comm)
        step = make_data_parallel_train_step(model, optimizer, comm,
                                             loss_fn=lm_loss_with_aux)

    it = SerialIterator(train, args.batchsize, shuffle=True, seed=0)
    updater = StandardUpdater(it, step, comm, model=state_model,
                              optimizer=optimizer)
    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = Trainer(updater, stop_trigger=stop, out=args.out)
    if comm.is_master:
        trainer.extend(LogReport(os.path.join(args.out, "log.jsonl")),
                       trigger=(1, "epoch"))
        trainer.extend(PrintReport(
            ["epoch", "iteration", "main/loss", "main/accuracy",
             "elapsed_time"]), trigger=(1, "epoch"))
    return trainer, model


def ring_demo(args, trainer, model) -> Optional[float]:
    """``--ring``: sequence-parallel inference of the trained weights.
    Rank 0's first training sequence is split over the ranks (rank r
    holds positions ``[r·L/n, (r+1)·L/n)``, ``pos_offset`` keeps them
    global), the model runs with ``attention=--seq-impl``, and the
    next-token accuracy over the whole sequence is returned (None where
    JAX's skip rules apply, with its messages)."""
    comm = trainer.updater.comm
    if (args.moe > 0 or args.n_kv_heads or args.zero or args.fsdp_scan
            or args.qkv_layout != "blhd"):
        if comm.is_master:
            print("--ring demo skipped: it reuses the trained params, and "
                  "a MoE/GQA/ZeRO/fsdp-scan/bhld run produces a different "
                  "param structure/layout than the sequence-parallel "
                  "model expects", flush=True)
        return None
    if args.seq_impl == "ulysses" and args.n_heads % comm.size:
        if comm.is_master:
            print(f"--ring demo skipped: ulysses needs --n-heads "
                  f"divisible by the {comm.size}-device axis", flush=True)
        return None
    ax = comm.axis_name
    ring = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=4 * args.d_model,
        max_len=args.seq_len, attention=args.seq_impl, seq_axis=ax,
        pos_emb="rope" if args.rope else "learned", comms={ax: comm},
        device=comm.device)
    ring.load_state_dict(model.state_dict())
    x, y = comm.bcast_obj(trainer.updater.iterator.dataset[0])
    l_local = args.seq_len // comm.size
    lo = comm.rank * l_local
    toks = torch.as_tensor(np.asarray(x)[None, lo:lo + l_local],
                           device=comm.device)
    with torch.no_grad():
        pred = ring(toks, pos_offset=lo).argmax(-1)[0]
    hits = (pred == torch.as_tensor(np.asarray(y)[lo:lo + l_local],
                                    device=comm.device)).float().mean()
    acc = float(comm.allreduce(hits, "mean"))
    if comm.is_master:
        print(f"{args.seq_impl}-attention (seq sharded over {comm.size} "
              f"devices) next-token acc: {acc:.4f}", flush=True)
    return acc


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer, model = build_trainer(args)
    comm = trainer.updater.comm
    try:
        trainer.run()
        # a preempted run has no final observation to print
        if comm.is_master and not trainer.preempted:
            obs = trainer.observation
            tokens = (obs["iteration"] * args.batchsize * comm.size
                      * args.seq_len)
            print(f"final: loss={obs['main/loss']:.4f} "
                  f"acc={obs['main/accuracy']:.4f}  "
                  f"{tokens / obs['elapsed_time']:.1f} tokens/sec "
                  f"({tokens / obs['elapsed_time'] / comm.size:.1f} "
                  "/chip)", flush=True)
        if args.ring and not trainer.preempted:
            ring_demo(args, trainer, model)
    finally:
        comm.finalize()
    return trainer


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
