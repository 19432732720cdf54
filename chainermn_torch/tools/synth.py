#!/usr/bin/env python
"""synth — enumerate, price, and emit synthesized collective programs.

Counterpart of the JAX package's ``tools/synth.py``, with its flags and
its output. The offline companion to :mod:`chainermn_torch.synthesis`:
describe what the enumerator would propose for a machine shape, and run
the canned tuner to persist a winning synthesized schedule into the
profile DB — the same DB ``create_multi_node_optimizer(tune=...)``
consumes.

Usage::

    python -m chainermn_torch.tools.synth --describe --intra 4 --inter 2 \\
        [--bytes N] [--lossy]
    python -m chainermn_torch.tools.synth --describe \\
        --tiers nvlink:4:55.31:368.22,net:2:100:25 [--lossy]
    python -m chainermn_torch.tools.synth --emit DB_PATH --intra 4 \\
        --inter 2 [--bytes N] [--lossy] [--model-key KEY]

``--describe`` lists every program the deterministic enumerator emits
for the topology — its step sequence, validity verdict, modeled cost at
``--bytes``, and exact per-tier wire bytes — next to the fixed-strategy
prices, so you can see what the program search adds before trusting it.

``--emit`` runs the full canned tune (fixed strategies AND programs)
and stores the winning plan under the topology's fingerprint in the
profile DB at ``DB_PATH`` — but only when the winner is a synthesized
program with strictly higher DL201 overlap than the best fixed
candidate; otherwise nothing is written and the findings are reported.
Re-running with the same arguments rewrites the identical plan (the
tune is deterministic), so ``--emit`` is idempotent.

Topology: ``--intra/--inter`` builds the two-tier shape (GPUs of a node
over NVLink × nodes over the network) with the port's default parameters
(``tuning.topology``: the NVLink tier fitted on four NVIDIA H100 80GB
HBM3 at 700.00 W, the network tier not measured);
``--tiers name:size:latency_us:bw_gbps,...`` (innermost first) describes
arbitrary hierarchies.

Exit status: 0 clean, 1 findings (invalid program, or no synthesized
improvement to emit), 2 usage error.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

DEFAULT_BYTES = 51 << 20


def _parse_tiers(spec):
    from chainermn_torch.tuning.topology import Tier
    tiers = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 4:
            raise ValueError(
                f"bad --tiers entry {part!r} "
                "(expected name:size:latency_us:bw_gbps)")
        name, size, lat, bw = fields
        tiers.append(Tier(name, int(size), float(lat), float(bw)))
    if not tiers:
        raise ValueError("--tiers parsed to no tiers")
    return tuple(tiers)


def _topology(args):
    from chainermn_torch.tuning.topology import Topology, two_tier
    if args.tiers:
        return Topology(_parse_tiers(args.tiers))
    if args.intra is None or args.inter is None:
        raise ValueError("need --tiers, or both --intra and --inter")
    if args.intra < 1 or args.inter < 1:
        raise ValueError("--intra/--inter must be >= 1")
    return two_tier(args.intra, args.inter)


def cmd_describe(args, topology):
    from chainermn_torch.synthesis import (
        check_program,
        enumerate_programs,
        program_cost_us,
        program_wire_bytes,
    )
    nbytes = args.bytes
    print(f"topology: {topology.describe()}")
    print(f"fingerprint: {topology.fingerprint()}")
    print(f"payload: {nbytes:,} bytes")
    for strategy in ("flat", "hierarchical"):
        print(f"  fixed {strategy}: "
              f"{topology.estimate_us(strategy, nbytes):,.1f} us")
    programs = enumerate_programs(topology, lossy=args.lossy)
    if not programs:
        print("no programs (single-tier topology: the enumerator only "
              "helps when there are tiers to compose across)")
        return 0
    findings = 0
    for prog in programs:
        errs = check_program(prog)
        if errs:
            findings += 1
            print(f"  {prog.name}: INVALID — {'; '.join(errs)}")
            continue
        cost = program_cost_us(prog, topology, nbytes)
        per_tier = program_wire_bytes(prog, nbytes)
        wire = " ".join(
            f"{topology.tiers[i].name}={int(b):,}B"
            for i, b in sorted(per_tier.items()))
        print(f"  {prog.name}: {cost:,.1f} us  wire[{wire}]")
        print(f"    {prog.describe()}")
    print(f"{len(programs)} program(s), {findings} invalid")
    return 1 if findings else 0


def cmd_emit(args, topology):
    from chainermn_torch.tuning import ProfileDB
    from chainermn_torch.tuning.tuner import tune_canned
    result = tune_canned(topology, args.bytes, lossy=args.lossy,
                         model_key=args.model_key)
    plan = result.plan
    fixed = [r for r in result.rows
             if r["candidate"]["strategy"] != "synth"]
    best_fixed = max(r["overlap_fraction"] for r in fixed)
    print(f"winner: {plan.strategy} "
          f"(overlap {plan.overlap_fraction} vs best fixed "
          f"{best_fixed})")
    if plan.strategy != "synth" or plan.overlap_fraction <= best_fixed:
        print("no synthesized improvement — nothing emitted")
        return 1
    print(f"  program: {plan.program['name']} "
          f"steps={len(plan.program['steps'])} "
          f"wire={plan.wire_format}")
    db = ProfileDB(args.emit)
    prior = db.plan_for(plan.fingerprint, args.model_key)
    if prior == plan:
        print(f"unchanged: identical plan already stored in {db.path}")
        return 0
    db.put_plan(plan)
    db.save()
    print(f"emitted plan for {plan.fingerprint!r} "
          f"(model_key={args.model_key!r}) -> {db.path}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="synth", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--describe", action="store_true",
                      help="list enumerated programs with costs")
    mode.add_argument("--emit", metavar="DB_PATH",
                      help="tune and store a winning synth plan")
    ap.add_argument("--intra", type=int, default=None,
                    help="fast-tier size (with --inter)")
    ap.add_argument("--inter", type=int, default=None,
                    help="slow-tier size (with --intra)")
    ap.add_argument("--tiers", default=None,
                    help="name:size:latency_us:bw_gbps,... "
                         "(innermost first; overrides --intra/--inter)")
    ap.add_argument("--bytes", type=int, default=DEFAULT_BYTES,
                    help=f"payload bytes to price (default "
                         f"{DEFAULT_BYTES})")
    ap.add_argument("--lossy", action="store_true",
                    help="include quantized-wire programs")
    ap.add_argument("--model-key", default="default",
                    help="profile-DB model key for --emit")
    args = ap.parse_args(argv)
    if args.bytes < 1:
        print("--bytes must be >= 1", file=sys.stderr)
        return 2
    try:
        topology = _topology(args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.describe:
        return cmd_describe(args, topology)
    return cmd_emit(args, topology)


if __name__ == "__main__":
    sys.exit(main())
