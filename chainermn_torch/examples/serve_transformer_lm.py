"""Continuous-batching serving example — train briefly, then serve.

Counterpart of the JAX package's ``examples/serving/
serve_transformer_lm.py``: trains a small Transformer LM on the
synthetic cyclic corpus (each sample a start plus a stride, mod the
vocabulary), publishes the weights through the manifest-verified
warm-weight plane, then stands up the continuous-batching engine behind
the thread-safe frontend and serves a burst of concurrent completions,
printing the ServingReport (TTFT, per-token latency percentiles, queue
depth, occupancy, tokens/s) at the end. A trained model visibly
continues each prompt's stride.

Run (the card by default)::

    python -m chainermn_torch.examples.serve_transformer_lm
    python -m chainermn_torch.examples.serve_transformer_lm --device cpu

For the supervised-replica form (restart loop, chaos drills, idempotent
output), see ``chainermn_torch/tools/serve_lm.py``.
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving import (Engine, EngineConfig, Frontend,
                                     publish_weights)


def train(model, steps, batch, length, vocab, lr=1e-2, seed=0):
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.RandomState(seed)
    loss = None
    for i in range(steps):
        starts = rng.randint(0, vocab, size=batch)
        strides = rng.randint(1, 4, size=batch)
        pos = np.arange(length + 1)
        seq = torch.as_tensor(
            (starts[:, None] + strides[:, None] * pos[None]) % vocab,
            device=model.device)
        logits = model(seq[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, vocab),
                               seq[:, 1:].reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f"train step {i}: loss {loss.item():.3f}")
    print(f"trained {steps} steps, final loss {loss.item():.3f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="chainermn_torch example: continuous-batching serving")
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--publish", default=None,
                   help="also publish weights here (the warm-reload "
                        "path supervised replicas boot from)")
    p.add_argument("--device", default="cuda",
                   help="device to train and serve on (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    torch.manual_seed(0)
    model = TransformerLM(vocab=args.vocab, d_model=64, n_heads=4,
                          n_layers=2, d_ff=128, max_len=128,
                          attention="reference", pos_emb="rope",
                          device=args.device)
    train(model, args.train_steps, batch=32, length=32, vocab=args.vocab)
    if args.publish:
        publish_weights(model.state_dict(), args.publish)
        print(f"published weights to {args.publish}")

    eng = Engine(model, EngineConfig(n_slots=args.slots, capacity=128,
                                     max_new_tokens=args.max_new_tokens,
                                     prefill_cohort=2),
                 device=args.device)
    rng = np.random.RandomState(1)
    hits_total = 0
    with Frontend(eng) as fe:
        prompts, futs = [], []
        for _ in range(args.requests):
            start, stride = rng.randint(0, args.vocab), rng.randint(1, 4)
            prompt = ((start + stride * np.arange(args.prompt_len))
                      % args.vocab).astype(np.int32)
            prompts.append((prompt, stride))
            futs.append(fe.submit(prompt))
        for (prompt, stride), fut in zip(prompts, futs):
            req = fe.result(fut, timeout_ms=120_000)
            want = ((prompt[-1] + stride * np.arange(
                1, len(req.tokens) + 1)) % args.vocab)
            hits = int(np.sum(np.asarray(req.tokens) == want))
            hits_total += hits
            print(f"prompt(stride={stride}) {prompt.tolist()} -> "
                  f"{req.tokens}  [{hits}/{len(req.tokens)} on-pattern]")
    print(eng.report.json())
    return hits_total


if __name__ == "__main__":
    from chainermn_torch.resilience.supervisor import main_exit_code
    sys.exit(main_exit_code(main))
