"""The exit-status contract between a train script and its supervisor.

Counterpart of the child side of ``chainermn_tpu/resilience/supervisor.py``:
:func:`main_exit_code` and the exit codes a per-host supervisor reads.
The supervisor's restart loop, ``JobAbortedError`` (raised by the
peer-death watchdog) and the rest of ``resilience/`` wait for ROADMAP.md
queue 1 item 9.
"""

from __future__ import annotations

from typing import Callable

from chainermn_torch.resilience.preemption import PREEMPTED_EXIT_CODE

__all__ = ["main_exit_code", "PREEMPTED_EXIT_CODE", "ABORTED_EXIT_CODE",
           "BUDGET_EXHAUSTED_EXIT_CODE"]

#: exit code a training process uses for "watchdog aborted the job —
#: a peer died; restart me once the peer is back" (EX_TEMPFAIL: the
#: sysexits.h code for "transient failure, retry later")
ABORTED_EXIT_CODE = 75

#: the SUPERVISOR's own exit code when the restart budget trips — the
#: wrapped job is crash-looping and needs a human (distinct from every
#: child code so orchestrators can tell "gave up" from "crashed")
BUDGET_EXHAUSTED_EXIT_CODE = 112


def main_exit_code(main: Callable[..., object], *args, **kwargs) -> int:
    """Run a train script's ``main()`` and translate its outcome into
    the supervisor's exit-status contract:

    * returns normally, no preemption → 0 (clean);
    * the returned object (a ``Trainer``, or anything with a truthy
      ``preempted`` attribute) was preempted →
      :data:`PREEMPTED_EXIT_CODE`;
    * an exception propagates (the interpreter's exit 1 reads as a
      crash — which it is).

    Usage in an example script::

        if __name__ == '__main__':
            sys.exit(main_exit_code(main))
    """
    result = main(*args, **kwargs)
    if getattr(result, "preempted", False):
        return PREEMPTED_EXIT_CODE
    return 0
