#!/usr/bin/env python3
"""Greedy serving rate of ``chip_smoke.py``'s slice, for several trees.

    python3 serve_greedy_probe.py [ROOT ...]

For each ROOT (a checkout of this repo; default: this one), in the order
given, one process imports that tree's ``chip_smoke`` and
``chainermn_torch`` and serves the slice's 16 greedy requests (lengths
in [64, 2000], 32 new tokens each) with the 135M LM at full width
(random weights from seed 0, bf16, flash attention) under
``EngineConfig(n_slots=8, capacity=2048, decode_k=4)``, after the
smoke's warm-up, :data:`REPEATS` times on fresh engines. It prints one
line a serve::

    probe-serve ROOT ttft p50 <ms> ms, decode tokens/s <rate>, wall <s> s

Give two trees in the order A B B A to compare them on one card. It
needs one CUDA device.
"""

import os
import subprocess
import sys

_CHILD = r"""
import sys
import torch
import chip_smoke as s
from chainermn_torch.serving.engine import Engine

model = s.build_model(0, torch.bfloat16, "flash")
s.warm_up(model)
for _ in range(int(sys.argv[1])):
    reqs, wall, counts, rate = s._serve_engine(
        Engine(model, s.engine_config()), s.prompts_for(0, model.vocab))
    if counts["flash_fwd"] < 1 or any(len(r.tokens) != 32 for r in reqs):
        sys.exit("the serve launched no flash_fwd or cut a stream")
    print(f"{rate}, wall {wall:.3f} s", flush=True)
"""

#: serves a process makes, each on a fresh engine after one warm-up
REPEATS = 3


def main(argv=None) -> int:
    roots = list(argv if argv is not None else sys.argv[1:]) or [
        os.path.dirname(os.path.abspath(__file__))]
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(REPEATS)], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        for line in proc.stdout.strip().splitlines()[-REPEATS:]:
            print(f"probe-serve {root} {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
