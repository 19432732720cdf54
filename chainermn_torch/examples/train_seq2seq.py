"""Data-parallel seq2seq (config #4): the port's
``examples/seq2seq/train_seq2seq.py``.

The reference's flow (WMT En-De, LSTM encoder-decoder, variable-length
samples scattered per rank): the root builds the dataset,
``scatter_dataset(..., shared_storage=False)`` ships each rank its
variable-length pairs, ``pad_batch`` pads each rank's batch into length
buckets, ``bcast_data`` makes the parameters equal, and each step runs
the masked loss, backward, the gradient all-reduce of
``create_multi_node_optimizer(Adam 1e-3)`` and the update; ``main/loss``
and ``main/perp`` are averaged over ranks. Afterwards the first four
training pairs are translated back (greedy, or ``--beam K``) and scored
with corpus BLEU. One process per GPU; ``--batchsize`` is each rank's
batch.

Data: ``--src-file``/``--tgt-file`` read a parallel text (one sentence a
line) and byte-BPE-tokenize it (``chainermn_torch.datasets.bpe``, the
vocabulary cached beside the source file); without them the synthetic
reversal-translation pairs of ``synthetic_translation`` stand in.

    python -m chainermn_torch.examples.train_seq2seq --device cpu
    torchrun --nproc-per-node 2 -m chainermn_torch.examples.train_seq2seq \\
        --device cpu          # two ranks over gloo
"""

from __future__ import annotations

import argparse
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import (scatter_dataset, synthetic_translation,
                                      train_bpe)
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.seq2seq import (Seq2Seq, beam_translate,
                                            corpus_bleu, greedy_translate,
                                            pad_batch, seq2seq_loss,
                                            strip_special)
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.resilience.supervisor import main_exit_code


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_torch example: "
                                            "seq2seq")
    p.add_argument("--batchsize", "-b", type=int, default=64,
                   help="batch size of each rank")
    p.add_argument("--epoch", "-e", type=int, default=2)
    p.add_argument("--unit", "-u", type=int, default=128)
    p.add_argument("--layer", "-l", type=int, default=2)
    p.add_argument("--communicator", type=str, default="pure_nccl")
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--n-train", type=int, default=1024)
    p.add_argument("--beam", type=int, default=0, metavar="K",
                   help="post-training translate demo: beam width "
                        "(0 = greedy)")
    p.add_argument("--bucket", type=int, default=32,
                   help="pad lengths to multiples of this")
    p.add_argument("--src-file", default=None,
                   help="source-side text file (one sentence per line); "
                        "tokenized with byte-BPE trained on the corpus")
    p.add_argument("--tgt-file", default=None,
                   help="target-side text file (parallel to --src-file)")
    p.add_argument("--bpe-vocab", type=int, default=512,
                   help="BPE vocabulary size for --src-file/--tgt-file "
                        "(specials + bytes + merges)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; NCCL) or 'cpu' (gloo)")
    return p.parse_args(argv)


def _corpus(args, comm):
    """The root's (src_ids, tgt_ids) pairs and the vocabulary size."""
    if not (args.src_file or args.tgt_file):
        train = (synthetic_translation(args.n_train, src_vocab=args.vocab,
                                       tgt_vocab=args.vocab, seed=0)
                 if comm.rank == 0 else None)
        return train, args.vocab
    if not (args.src_file and args.tgt_file):
        raise SystemExit("--src-file and --tgt-file go together")
    train = vocab = None
    if comm.rank == 0:
        with open(args.src_file, encoding="utf-8") as f:
            src_lines = f.read().splitlines()
        with open(args.tgt_file, encoding="utf-8") as f:
            tgt_lines = f.read().splitlines()
        if len(src_lines) != len(tgt_lines):
            raise SystemExit(f"parallel corpus length mismatch: "
                             f"{len(src_lines)} vs {len(tgt_lines)} lines")
        cache = args.src_file + f".bpe{args.bpe_vocab}.json"
        tok = train_bpe(src_lines + tgt_lines, args.bpe_vocab,
                        cache_path=cache)
        train = [(np.asarray(tok.encode(s), np.int32),
                  np.asarray(tok.encode(t), np.int32))
                 for s, t in zip(src_lines, tgt_lines)]
        vocab = tok.vocab_size
        print(f"corpus: {len(train)} pairs, BPE vocab {vocab} ({cache})",
              flush=True)
    return train, comm.bcast_obj(vocab)


def build(args):
    """Everything before the loop: a namespace with ``comm``, ``model``,
    ``optimizer``, ``iterator``, ``train`` (this rank's pairs) and
    ``step`` (one update of a padded batch → metrics on the device)."""
    comm = create_communicator(args.communicator, device=args.device)
    if comm.is_master:
        print(f"ranks: {comm.size}  device: {comm.device}", flush=True)
    train, vocab = _corpus(args, comm)
    train = scatter_dataset(train, comm, shuffle=True, seed=0,
                            shared_storage=False)
    torch.manual_seed(0)
    model = Seq2Seq(n_layers=args.layer, n_units=args.unit, src_vocab=vocab,
                    tgt_vocab=vocab, device=comm.device)
    comm.bcast_data(model)
    # optax.adam: eps added after the square root
    optimizer = create_multi_node_optimizer(torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad], lr=1e-3,
        eps=1e-8), comm)

    def step(src, src_len, tgt_in, tgt_out):
        logits = model(src, src_len, tgt_in)
        loss, _ = seq2seq_loss(logits, tgt_out)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        mean = comm.allreduce(loss.detach(), "mean")
        return {"main/loss": mean, "main/perp": torch.exp(mean)}

    return SimpleNamespace(
        comm=comm, model=model, optimizer=optimizer, train=train, step=step,
        iterator=SerialIterator(train, args.batchsize, shuffle=True, seed=0))


def train_loop(run, args):
    """Train for ``--epoch`` epochs; returns the metrics of every step
    (device tensors) and the seconds taken."""
    history = []
    t0 = time.perf_counter()
    while run.iterator.epoch < args.epoch:
        arrays = pad_batch(run.iterator.next(), args.bucket)
        history.append(run.step(*(torch.from_numpy(a) for a in arrays)))
        if run.comm.is_master and len(history) % 8 == 0:
            m = history[-1]
            print(f"epoch {run.iterator.epoch} iter {len(history)} loss "
                  f"{float(m['main/loss']):.4f} perp "
                  f"{float(m['main/perp']):.1f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return history, time.perf_counter() - t0


def translate_demo(run, args):
    """Translate this rank's first four training pairs back; returns
    ``(hypotheses [4, bucket], BLEU against the references)``."""
    srcs, src_len, _, tgt_out = pad_batch(
        [run.train[i] for i in range(min(4, len(run.train)))], args.bucket)
    if args.beam > 0:
        hyp = beam_translate(run.model, srcs, src_len, beam=args.beam,
                             max_len=args.bucket)
    else:
        hyp = greedy_translate(run.model, srcs, src_len,
                               max_len=args.bucket)
    hyp = hyp.cpu().numpy()
    bleu = corpus_bleu([strip_special(r) for r in tgt_out],
                       [strip_special(h) for h in hyp])
    return hyp, bleu


def main(argv=None):
    args = parse_args(argv)
    run = build(args)
    try:
        history, _ = train_loop(run, args)
        final = float(history[-1]["main/loss"])
        hyp, bleu = translate_demo(run, args)
        if run.comm.is_master:
            print(f"final loss: {final:.4f}", flush=True)
            mode = f"beam={args.beam}" if args.beam else "greedy"
            print(f"translate demo ({mode}): BLEU {bleu:.4f}", flush=True)
            for i in range(min(2, len(hyp))):
                print(f"  src {run.train[i][0][:8]}... -> hyp "
                      f"{hyp[i][:8]}...", flush=True)
    finally:
        run.comm.finalize()
    return final


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted
    sys.exit(main_exit_code(main))
