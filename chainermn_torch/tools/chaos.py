"""chaos — launch (or validate) fault-injected training runs.

Counterpart of the JAX package's ``tools/chaos.py``. The chaos harness
(:mod:`chainermn_torch.resilience.chaos`) activates when
``$CHAINERMN_TPU_CHAOS`` holds a fault spec; workers read it at hook
sites inside the trainer loop, the object plane's store RPCs, the
checkpoint publish path and the snapshot plane — so the SAME binary runs clean or faulted,
deterministically per (spec, seed, rank). This tool is the front door:
validate a spec, print the fault catalogue, or exec a training command
with the spec injected into its environment.

Usage::

    python -m chainermn_torch.tools.chaos --dry-run --spec 'kill@step=3,rank=1'
    python -m chainermn_torch.tools.chaos --list-faults
    python -m chainermn_torch.tools.chaos --spec 'kill@step=3' -- \\
        python -m chainermn_torch.examples.train_mnist --device cpu

Spec grammar: ``;``-separated clauses, each ``kind@key=value,...``.
Exit status: 0 valid/clean, 2 usage or spec error.
"""

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec", default=None,
                    help="fault spec to validate/inject "
                         "(grammar: 'kind@k=v,...;kind@k=v,...')")
    ap.add_argument("--dry-run", action="store_true",
                    help="parse and print the faults, run nothing")
    ap.add_argument("--list-faults", action="store_true",
                    help="print the fault-kind catalogue and exit")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed appended to probabilistic faults that "
                         "carry none (deterministic replay)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="training command to exec with the spec in "
                         "$CHAINERMN_TPU_CHAOS (prefix with --)")
    args = ap.parse_args(argv)

    from chainermn_torch.resilience import chaos

    if args.list_faults:
        for kind, usage in sorted(chaos.FAULT_KINDS.items()):
            print(f"{kind:15s} {usage}")
        return 0

    if args.spec is None:
        ap.print_usage(sys.stderr)
        print("chaos: give --spec (or --list-faults)", file=sys.stderr)
        return 2

    try:
        faults = chaos.parse_spec(args.spec)
    except ValueError as e:
        print(f"chaos: bad spec: {e}", file=sys.stderr)
        return 2

    if args.seed is not None:
        for f in faults:
            if f.seed is None:
                f.seed = args.seed

    if args.dry_run or not args.command:
        print(f"chaos: spec ok — {len(faults)} fault(s):")
        for f in faults:
            rank = "*" if f.rank is None else f.rank
            print(f"  {f.kind}@rank={rank} {f.describe()}")
        if not args.dry_run and not args.command:
            print("chaos: no command given (append '-- CMD...' to run)",
                  file=sys.stderr)
        return 0

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("chaos: empty command after '--'", file=sys.stderr)
        return 2
    env = dict(os.environ)
    env[chaos.ENV_VAR] = args.spec
    os.execvpe(cmd[0], cmd, env)  # no return


if __name__ == "__main__":
    sys.exit(main())
