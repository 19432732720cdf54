"""Pipeline-parallel Transformer LM — two schedules on a real model: the
port's ``examples/pipeline_lm/train_pipeline_lm.py``.

Default: the interleaved 1F1B schedule with its composition hooks
(``chainermn_torch.parallel.pipeline``): the embedding runs outside the
pipeline (its gradient returns through ``input_grads``), TransformerBlocks
are the homogeneous stages — logical stage v*S+d on stage rank d
(virtual chunks) — and the LM head trains inside ``loss_fn`` through
``head_params``. One Adam update covers all three parameter groups.

``--hetero``: embedding and head are ORDINARY stages
(``chainermn_torch.parallel.hetero_pipeline``) — the int→[mb,L,D] shape
changes ride the flat activation wire sized by the widest TRAVELING edge
(the [mb,L,vocab] logits die in the local loss), each rank's stage is one
f32 row, and a single Adam on that row is the whole-model optimizer.

``--tp T``: Megatron tensor parallelism inside each stage, on a
``(stage, model)`` mesh of the ranks (rank ``s·T + t``): the
port's ``TransformerBlock(tp_axis="model")`` on the ``model``
communicator, the vocabulary-parallel head (LayerNorm, then *f*, then the
column slice of the kernel) and its cross-entropy inside the loss hook;
loss, LayerNorm head gradients and input gradients are averaged over
``model`` as JAX's ``pmean`` makes them, the column-sliced kernel's
gradient stays each rank's own.

Every stage's parameters are a flax-layout tree (``models.convert``'s
:func:`~chainermn_torch.models.convert.module_flax_tree`), the trees the
JAX example trains: each rank holds only its own stage's (or chunks'),
initialised from ``--seed`` by logical stage, so every rank draws the
same numbers for the same stage whatever the layout. Attention is
``flash`` by default: the CUDA kernels on the card, their plain versions
on the CPU.

    torchrun --nproc-per-node 4 -m chainermn_torch.examples.\\
train_pipeline_lm --device cpu --steps 20
    torchrun --nproc-per-node 4 -m chainermn_torch.examples.\\
train_pipeline_lm --device cpu --hetero --steps 20
    torchrun --nproc-per-node 4 -m chainermn_torch.examples.\\
train_pipeline_lm --device cpu --tp 2 -V 1 --steps 20

On one card, several ranks share it through ``--communicator
non_cuda_aware``; on several cards the default ``pure_nccl`` runs one
rank a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import (flax_tree_apply,
                                            module_flax_tree,
                                            module_params_from_flax,
                                            rank_params_from_dense)
from chainermn_torch.models.transformer import TransformerBlock
from chainermn_torch.parallel import (HeteroPipeline,
                                      hetero_pipeline_1f1b_value_and_grad,
                                      pipeline_interleaved_1f1b_value_and_grad,
                                      stack_stage_params)
from chainermn_torch.parallel.pipeline import tree_leaves, tree_unflatten
from chainermn_torch.parallel.tensor_parallel import (
    copy_to_tp_region, vocab_parallel_cross_entropy)

__all__ = ["EmbedIn", "HeadOut", "PipelineLM", "HeteroPipelineLM",
           "parse_args", "build", "main"]

#: the seed offsets of the embedding and the head (the blocks' logical
#: stage k draws from seed + k)
EMBED_SEED, HEAD_SEED = 100_000, 100_999


class EmbedIn(nn.Module):
    """Token table plus learned positions (JAX's ``EmbedIn``)."""

    def __init__(self, vocab: int, d_model: int, max_len: int, device=None):
        super().__init__()
        self.tok = nn.Embedding(vocab, d_model, device=device)
        self.pos = nn.Parameter(
            torch.randn(max_len, d_model, device=device) * 0.02)

    def forward(self, toks):
        return self.tok(toks.long()) + self.pos[None, :toks.shape[-1]]


class HeadOut(nn.Module):
    """LM head: LayerNorm, then a bias-free Dense (JAX's ``HeadOut``).
    Under tensor parallelism ``vocab`` is this rank's slice and ``comm``
    the ``model`` communicator: the Megatron *f* at the column-parallel
    entry makes the LayerNorm's gradient and the input's full on every
    rank."""

    def __init__(self, vocab: int, d_model: int, comm=None, device=None):
        super().__init__()
        self.ln_f = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.out = nn.Linear(d_model, vocab, bias=False, device=device)
        self.comm = comm

    def forward(self, h):
        h = self.ln_f(h)
        if self.comm is not None:
            h = copy_to_tp_region(h, self.comm)
        return self.out(h)


def _modules(args, device="meta", tp_comm=None, T: int = 1):
    """The example's three modules (``device="meta"``: templates for
    :func:`~chainermn_torch.models.convert.flax_tree_apply`): EmbedIn,
    the block (tensor-parallel over ``tp_comm`` when given) and HeadOut
    (this rank's vocabulary slice of T)."""
    tp = (dict(tp_axis="model", comms={"model": tp_comm})
          if tp_comm is not None else {})
    return (EmbedIn(args.vocab, args.d_model, args.seq_len, device=device),
            TransformerBlock(args.d_model, args.n_heads, args.d_ff,
                             attention=args.attention, device=device, **tp),
            HeadOut(args.vocab // T, args.d_model, tp_comm, device=device))


def init_trees(args, seed: int, blocks):
    """The dense flax-layout trees of the embedding, of the blocks of
    logical stages ``blocks`` and of the head, drawn from ``seed`` on the
    CPU (so every rank draws the same numbers for a stage): ``(embed,
    [block trees], head)``."""
    def draw(offset, make):
        torch.manual_seed(seed + offset)
        return module_flax_tree(make())

    embed = draw(EMBED_SEED, lambda: EmbedIn(args.vocab, args.d_model,
                                             args.seq_len, device="cpu"))
    head = draw(HEAD_SEED, lambda: HeadOut(args.vocab, args.d_model,
                                           device="cpu"))
    return embed, [draw(k, lambda: TransformerBlock(
        args.d_model, args.n_heads, args.d_ff, device="cpu"))
        for k in blocks], head


def sequential_value_and_grad(args, embed, blocks, head, toks, tgts):
    """The one-rank oracle of a pipeline step: the embedding, the blocks
    in logical order and the head in one process on dense flax-layout
    trees, the mean loss over micro-batches, plain autograd (one
    micro-batch's graph at a time). Returns ``(loss, (embed, [blocks],
    head) gradient trees)``."""
    e_mod, b_mod, h_mod = (flax_tree_apply(m) for m in _modules(args))
    trees = [embed] + list(blocks) + [head]
    leaves = [[t.detach().clone().requires_grad_(True)
               for t in tree_leaves(tr)] for tr in trees]
    live = [tree_unflatten(tr, ls) for tr, ls in zip(trees, leaves)]
    m, total = toks.shape[0], 0.0
    for j in range(m):
        h = e_mod(live[0], toks[j])
        for b in live[1:-1]:
            h = b_mod(b, h)
        loss = _cross_entropy(h_mod(live[-1], h), tgts[j]) / m
        loss.backward()
        total += loss.item()
    grads = [tree_unflatten(tr, [x.grad for x in ls])
             for tr, ls in zip(trees, leaves)]
    return total, (grads[0], grads[1:-1], grads[-1])


def _params(tree, device):
    """A tree of trainable leaves on ``device``."""
    return tree_unflatten(tree, [nn.Parameter(t.detach().to(device).clone())
                                 for t in tree_leaves(tree)])


def _cross_entropy(logits, tgt):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           tgt.reshape(-1).long())


class PipelineLM:
    """The interleaved default (and its ``--tp`` form) on this rank.

    ``comm`` spans the pipeline's S·T ranks. ``params``, when given, is
    ``(embed, stages, head)``: flax-layout trees (tensors) of the
    embedding, of this rank's ``[V, ...]`` chunks and of its head (its
    column slice under TP); otherwise they are drawn from ``seed``."""

    def __init__(self, args, comm, params=None, seed: int = 0):
        T = max(args.tp, 1)
        self.T, self.V = T, args.stages_per_device
        self.S = comm.size // T
        self.M = args.microbatches or 2 * self.S
        # the (stage, model) mesh of the ranks, rank s·T + t: the stage
        # communicator runs along a column, the model one along a row
        s, t = divmod(comm.rank, T)
        self.stage = comm.split(t, key=s) if T > 1 else comm
        self.model = comm.split(s, key=t) if T > 1 else None
        dev = comm.device
        embed, block, head = _modules(args, tp_comm=self.model, T=T)
        if params is None:
            e, chunks, h = init_trees(
                args, seed, [v * self.S + s for v in range(self.V)])
            if T > 1:
                dense = _modules(args)[1]
                chunks = [module_flax_tree(block, rank_params_from_dense(
                    block, module_params_from_flax(dense, c), t, T))
                          for c in chunks]
                vl = args.vocab // T
                h = dict(h, out={"kernel": h["out"]["kernel"][
                    :, t * vl:(t + 1) * vl].contiguous()})
            params = (e, stack_stage_params(chunks), h)
        self.embed_tree, self.stage_tree, self.head_tree = (
            _params(p, dev) for p in params)
        self._embed = flax_tree_apply(embed)
        self._stage = flax_tree_apply(block)
        self._head = flax_tree_apply(head)
        self.leaves = [p for tree in (self.embed_tree, self.stage_tree,
                                      self.head_tree)
                       for p in tree_leaves(tree)]
        self.opt = torch.optim.Adam(self.leaves, lr=args.lr, eps=1e-8)

    def head_loss(self, hp, out, tgt):
        logits = self._head(hp, out)
        if self.T > 1:
            return vocab_parallel_cross_entropy(logits, tgt,
                                                self.model).mean()
        return _cross_entropy(logits, tgt)

    def value_and_grad(self, toks, tgts):
        """``(loss, (embed, stages, head) gradient trees)`` of one step."""
        emb = tree_leaves(self.embed_tree)
        with torch.enable_grad():
            x_mb = self._embed(self.embed_tree, toks)
        loss, g, aux = pipeline_interleaved_1f1b_value_and_grad(
            self._stage, self.head_loss, self.stage_tree, x_mb.detach(),
            tgts, self.stage, self.V, head_params=self.head_tree,
            return_input_grads=True)
        hg, dxs = aux["head_grads"], aux["input_grads"]
        if self.T > 1:
            # equal along 'model' already (the f-operator sums the
            # cotangents, the vocabulary-parallel CE the loss terms): the
            # mean is JAX's pmean; the kernel's gradient is this rank's
            m = self.model
            loss = m.allreduce(loss, "mean")
            hg = dict(hg, LayerNorm_0={k: m.allreduce(v, "mean")
                                       for k, v in hg["LayerNorm_0"].items()})
            dxs = m.allreduce(dxs, "mean")
        demb = torch.autograd.grad(x_mb, emb, dxs)
        return loss, (tree_unflatten(self.embed_tree, list(demb)), g, hg)

    def step(self, toks, tgts) -> float:
        loss, grads = self.value_and_grad(toks, tgts)
        for p, g in zip(self.leaves, [x for tree in grads
                                      for x in tree_leaves(tree)]):
            p.grad = g
        self.opt.step()
        return loss.item()


class HeteroPipelineLM:
    """``--hetero``: embed → S−2 blocks → head, each an ordinary stage of
    a :class:`~chainermn_torch.parallel.HeteroPipeline`; this rank trains
    its own ``[P]`` row with one Adam. ``trees``, when given, is every
    stage's flax-layout tree (another rank's may be meta tensors);
    otherwise they are drawn from ``seed``."""

    def __init__(self, args, comm, trees=None, seed: int = 0):
        self.S = comm.size
        self.M = args.microbatches or 2 * self.S
        self.comm = comm
        dev = comm.device
        r = comm.rank
        embed, block, head = _modules(args)
        mods = [embed] + [block] * (self.S - 2) + [head]
        if trees is None:
            # this rank's stage drawn from the seed, the others' shapes only
            e, blocks, h = init_trees(args, seed, [r] if 0 < r < self.S - 1
                                      else [])
            trees = [module_flax_tree(m) for m in mods]
            trees[r] = e if r == 0 else h if r == self.S - 1 else blocks[0]
        self.pipe = HeteroPipeline(
            [(flax_tree_apply(m), tr) for m, tr in zip(mods, trees)],
            ((args.mb_size, args.seq_len), torch.int64), comm)
        self.row = nn.Parameter(self.pipe.pack_params(r).to(dev))
        self.opt = torch.optim.Adam([self.row], lr=args.lr, eps=1e-8)

    def value_and_grad(self, toks, tgts):
        """``(loss, this rank's [P] gradient row)`` of one step."""
        return hetero_pipeline_1f1b_value_and_grad(
            self.pipe, _cross_entropy, self.row,
            self.pipe.encode_inputs(toks), tgts)

    def step(self, toks, tgts) -> float:
        loss, g = self.value_and_grad(toks, tgts)
        self.row.grad = g
        self.opt.step()
        return loss.item()


def batches(args, M: int, device):
    """The JAX example's synthetic data: cyclic-vocab next-token
    sequences with learnable structure, from ``RandomState(0)``."""
    data_rng = np.random.RandomState(0)
    while True:
        start = data_rng.randint(0, args.vocab, size=(M, args.mb_size, 1))
        seq = (start + np.arange(args.seq_len + 1)) % args.vocab
        yield (torch.as_tensor(seq[..., :-1], dtype=torch.long,
                               device=device),
               torch.as_tensor(seq[..., 1:], dtype=torch.long,
                               device=device))


def _train_loop(model, args, M, device, talk: bool) -> List[float]:
    """The timed loop of both modes; returns the losses. Each step ends
    on the loss's host copy, so the host clock times whole steps; the
    mean is over the steps after the first (which builds the kernels'
    state and the communicator's channels)."""
    data = batches(args, M, device)
    losses = []
    t0 = t1 = time.perf_counter()
    for step in range(args.steps):
        toks, tgts = next(data)
        losses.append(model.step(toks, tgts))
        if step == 0:
            t1 = time.perf_counter()
        if talk and (step == 0 or (step + 1) % 10 == 0):
            print(f"step {step + 1:4d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if talk and losses:
        rest = len(losses) - 1
        ms = ((time.perf_counter() - t1) / rest * 1e3 if rest
              else float("nan"))
        print(f"final loss: {losses[-1]:.4f}  ({ms:.3f} ms/step after "
              f"the first)", flush=True)
    return losses


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ChainerMN-PyTorch example: pipeline-parallel LM")
    p.add_argument("--stages-per-device", "-V", type=int, default=2)
    p.add_argument("--tp", type=int, default=1, metavar="T",
                   help="Megatron tensor parallelism INSIDE each "
                        "pipeline stage on a (stage, model) mesh of the "
                        "ranks: column/row-parallel attention + MLP per "
                        "block, their all-reduces over 'model' inside the "
                        "1F1B schedule")
    p.add_argument("--n-pipeline", "-S", type=int, default=None,
                   help="pipeline depth in ranks (default: all)")
    p.add_argument("--microbatches", "-M", type=int, default=None,
                   help="micro-batches per step (default: 2*S)")
    p.add_argument("--mb-size", type=int, default=4)
    p.add_argument("--seq-len", "-L", type=int, default=32)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--attention", default="flash",
                   choices=["flash", "reference"])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--hetero", action="store_true",
                   help="run embedding and head as ORDINARY pipeline "
                        "stages (HeteroPipeline: flat activation/param "
                        "wires, classic 1F1B) instead of the "
                        "head_params/input_grads composition hooks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--communicator", default="pure_nccl",
                   help="'pure_nccl' (one rank a card) or "
                        "'non_cuda_aware' (ranks sharing a card)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (gloo)")
    return p.parse_args(argv)


def build(args, comm):
    """The model of ``args`` over ``comm``'s ranks: a
    :class:`PipelineLM` or :class:`HeteroPipelineLM` on the first S·T
    ranks (the JAX example's sub-mesh), None on the others. Raises
    ``SystemExit`` with JAX's texts for a shape that does not fit."""
    if args.hetero:
        S = args.n_pipeline or comm.size
        if S - 2 < 1:
            raise SystemExit("--hetero needs S >= 3 (embed + blocks + head)")
        T = 1
    else:
        T = max(args.tp, 1)
        S = args.n_pipeline or (comm.size // T)
        if S < 1 or S * T > comm.size:
            raise SystemExit(f"need SxT = {S}x{T} devices, have "
                             f"{comm.size}")
        if T > 1 and args.n_heads % T:
            raise SystemExit(f"--tp {T} must divide --n-heads "
                             f"{args.n_heads}")
        if T > 1 and args.vocab % T:
            raise SystemExit(f"--tp {T} must divide --vocab {args.vocab}")
    if S * T < comm.size:
        active = comm.rank < S * T
        comm = comm.split(0 if active else 1)
        if not active:
            return None
    if args.hetero:
        return HeteroPipelineLM(args, comm, seed=args.seed)
    return PipelineLM(args, comm, seed=args.seed)


def main(argv=None) -> Optional[List[float]]:
    args = parse_args(argv)
    comm = create_communicator(args.communicator, device=args.device)
    try:
        model = build(args, comm)
        if model is None:
            return None
        talk = comm.rank == 0
        M = model.M
        if talk:
            if args.hetero:
                print(f"hetero pipeline: {model.S} stages = embed + "
                      f"{model.S - 2} blocks + head, {M} micro-batches of "
                      f"{args.mb_size}x{args.seq_len}", flush=True)
            else:
                print(f"pipeline: {model.S} stage ranks x {model.V} chunks "
                      f"= {model.S * model.V} blocks"
                      + (f", TP {model.T} (mesh stage x model)"
                         if model.T > 1 else "")
                      + f", {M} micro-batches of "
                        f"{args.mb_size}x{args.seq_len}", flush=True)
        return _train_loop(model, args, M, comm.device, talk)
    finally:
        comm.finalize()


if __name__ == "__main__":
    # supervisor exit-status contract: 0 clean, 143 preempted, 75 aborted
    from chainermn_torch.resilience.supervisor import main_exit_code

    sys.exit(main_exit_code(main))
