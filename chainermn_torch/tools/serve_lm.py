#!/usr/bin/env python
"""serve_lm — one supervised serving replica over the continuous-
batching engine.

Counterpart of the JAX package's ``tools/serve_lm.py``, with its flags
plus ``--device`` (``cuda`` unless the caller asks for ``cpu``). Builds
a seeded TransformerLM, warm-loads weights from a published
snapshot when one exists (publishing on first boot so restarts never
re-initialise), queues a deterministic batch of prompts, and drains the
engine while exposed to ``$CHAINERMN_TPU_CHAOS``. Completed streams are
appended to a JSONL file *idempotently*: a restarted incarnation skips
request ids already on disk, so a chaos kill mid-decode heals to the
same final output the unkilled run would have produced. That replay
guarantee survives sampling too: each request's PRNG seed is derived
from its id (``--seed + request_id``), so ``--temperature``/``--top-k``
streams are as replayable as greedy ones (serving/sampling.py's
one-draw-per-token contract). ``--draft N`` swaps in the speculative
engine (``serving/speculative.py``) with an N-layer draft model and
``--kv-dtype int8-block`` selects quantized resident pages; both keep
the replay guarantee, because a restarted incarnation runs the same
engine on the same weights.

Wrap it in the per-host restart loop for the fleet drill::

    CHAINERMN_TPU_CHAOS='kill@step=6,run=0' \\
        python -m chainermn_torch.tools.supervise --max-restarts 2 -- \\
        python -m chainermn_torch.tools.serve_lm --device cpu \\
        --out /tmp/streams.jsonl

Exit status follows the supervisor contract
(``chainermn_torch/resilience/supervisor.py``):
0 clean, 75 on a watchdog abort, anything else is a crash.

Signal contract: **SIGUSR1 requests a graceful drain.** The replica
stops admitting (queued requests are shed — the next incarnation's
idempotent JSONL replay re-submits exactly the ids not yet on disk),
finishes every in-flight stream, flushes its report, and exits 0 —
which ``classify_exit`` counts as ``clean``, so a supervisor never
bills the crash budget for a requested retirement.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _log(msg):
    print(f"serve_lm: {msg}", file=sys.stderr, flush=True)


def _done_ids(path):
    """Request ids already drained to the JSONL (prior incarnations)."""
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    done.add(json.loads(line)["request_id"])
    return done


def _model(args, n_layers, seed):
    import torch

    from chainermn_torch.models.transformer import TransformerLM

    torch.manual_seed(seed)
    return TransformerLM(vocab=args.vocab, d_model=args.d_model,
                         n_heads=args.n_heads, n_layers=n_layers,
                         d_ff=2 * args.d_model, max_len=args.capacity,
                         attention="reference", pos_emb="rope",
                         device=args.device)


def serve(args):
    import numpy as np

    from chainermn_torch.serving import (Engine, EngineConfig,
                                         ServingReport, SpeculativeEngine,
                                         load_weights, publish_weights)
    from chainermn_torch.serving.weights import WeightsError

    model = _model(args, args.n_layers, args.seed)
    if args.weights:
        try:
            params, src = load_weights(args.weights,
                                       like=model.state_dict())
            model.load_state_dict(params)
            _log(f"warm weights loaded from {src}")
        except WeightsError:
            publish_weights(model.state_dict(), args.weights)
            _log(f"cold boot: published weights to {args.weights}")

    cfg = EngineConfig(n_slots=args.slots, capacity=args.capacity,
                       max_new_tokens=args.max_new_tokens,
                       prefill_cohort=1,
                       buckets=[args.prompt_len, args.capacity],
                       decode_k=args.decode_k,
                       prefill_chunk=args.prefill_chunk,
                       token_budget=args.token_budget,
                       kv_dtype=args.kv_dtype)
    if args.draft:
        # the draft model is derived from the seed, never warm-loaded:
        # it only decides how far a round advances
        draft = _model(args, args.draft, args.seed + 1)
        eng = SpeculativeEngine(model, draft, cfg, spec_k=args.spec_k,
                                device=args.device, report=ServingReport())
        _log(f"speculative: {args.draft}-layer draft, spec_k={args.spec_k}")
    else:
        eng = Engine(model, cfg, device=args.device, report=ServingReport())

    done = _done_ids(args.out)
    rng = np.random.RandomState(args.seed)
    reqs = {}
    for i in range(args.requests):
        prompt = rng.randint(0, args.vocab,
                             (args.prompt_len,)).astype(np.int32)
        if i in done:
            continue                   # drained by a prior incarnation
        reqs[i] = (eng.submit(prompt, temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed + i),
                   prompt)
    _log(f"queued {len(reqs)} of {args.requests} requests "
         f"({len(done)} already drained)")

    # SIGUSR1 = graceful drain (see module docstring). The handler only
    # flips a flag; the scheduler loop does the actual shedding at its
    # next iteration boundary, so a signal mid-step never tears state.
    import signal
    drain = {"requested": False}

    def _on_drain(signum, frame):
        drain["requested"] = True

    try:
        signal.signal(signal.SIGUSR1, _on_drain)
    except ValueError:
        pass                           # not the main thread (tests)

    emitted = {}
    shed = False
    with open(args.out, "a") as out:
        while not eng.idle():
            if drain["requested"] and not shed:
                shed = True
                dropped = 0
                while eng.queue:
                    req = eng.queue.popleft()
                    req.state = "aborted"
                    eng.report.record_retire(req.request_id, aborted=True)
                    dropped += 1
                _log(f"SIGUSR1: drain — shed {dropped} queued, finishing "
                     f"{len(eng.active) + len(eng.prefilling)} in flight")
            eng.step()                 # chaos.on_step fires in here
            for i, (req, prompt) in reqs.items():
                if req.state == "done" and i not in emitted:
                    emitted[i] = True
                    out.write(json.dumps(
                        {"request_id": i,
                         "prompt": prompt.tolist(),
                         "tokens": req.tokens}) + "\n")
                    out.flush()
                    os.fsync(out.fileno())
    _log(("drained (SIGUSR1 retirement); " if shed else "drained; ")
         + f"report: {eng.report.json()}")
    if args.report:
        with open(args.report, "w") as f:
            f.write(eng.report.json())
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="serve_lm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True,
                    help="JSONL of completed streams (append, idempotent)")
    ap.add_argument("--weights", default=None,
                    help="published-weights path: warm-load when present, "
                         "publish on cold boot")
    ap.add_argument("--report", default=None,
                    help="write the ServingReport JSON here on drain")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=32)
    # decode-k defaults to 1: the chaos drill's kill@step=N timing
    # counts scheduler iterations, and one token per iteration keeps a
    # mid-decode kill meaning what the drill scripts expect
    ap.add_argument("--decode-k", type=int, default=1,
                    help="tokens committed per decode dispatch")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill width (default: monolithic "
                         "per-bucket prefill)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-iteration token budget shared by decode "
                         "and prefill (default: unbounded)")
    ap.add_argument("--draft", type=int, default=0, metavar="N_LAYERS",
                    help="speculative decode with an N_LAYERS draft "
                         "model (seeded from --seed + 1); the target "
                         "samples every emitted token (default: off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["f32", "int8-block"],
                    help="paged-KV storage mode (int8-block trades a "
                         "calibrated logit-error bound for ~4x slots)")
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampling temperature (default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-k truncation for sampled decode")
    ap.add_argument("--vocab", type=int, default=43)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu only "
                         "when asked)")
    args = ap.parse_args(argv)

    from chainermn_torch.resilience.supervisor import main_exit_code

    return main_exit_code(lambda: serve(args))


if __name__ == "__main__":
    sys.exit(main())
