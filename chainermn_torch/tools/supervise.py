"""supervise — wrap a training command in the per-host restart loop.

Counterpart of the JAX package's ``tools/supervise.py``. Launches the
command, classifies each exit (clean / preempted / aborted / crash —
see ``chainermn_torch/resilience/supervisor.py``), and
relaunches with jittered backoff until the run finishes cleanly or the
crash budget (N counted restarts per rolling window) trips. Each
incarnation gets ``$CHAINERMN_TPU_RESTART_COUNT`` in its environment.

Run ONE supervisor per host, wrapping that host's training process::

    python -m chainermn_torch.tools.supervise --max-restarts 5 \\
        --window-s 3600 -- \\
        python -m chainermn_torch.examples.train_mnist --device cpu

Exit status: the child's own code for terminal outcomes (0 clean,
143 preempted with --no-restart-on-preempt), 112 when the restart
budget is exhausted (crash loop — human needed), 2 usage error.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="supervise", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="counted restarts allowed per rolling window "
                         "(default 5; preemptions are free)")
    ap.add_argument("--window-s", type=float, default=3600.0,
                    help="rolling budget window in seconds (default 3600)")
    ap.add_argument("--no-restart-on-preempt", action="store_true",
                    help="exit 143 on preemption instead of relaunching "
                         "(for platforms that reschedule the job "
                         "themselves)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="training command to supervise (prefix with --)")
    args = ap.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.print_usage(sys.stderr)
        print("supervise: give a command to wrap (after '--')",
              file=sys.stderr)
        return 2

    from chainermn_torch.resilience.supervisor import Supervisor

    sup = Supervisor(cmd, max_restarts=args.max_restarts,
                     window_s=args.window_s,
                     restart_on_preempt=not args.no_restart_on_preempt)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
