"""Per-host supervisor: crashes heal by restart, not by a human.

Counterpart of ``chainermn_tpu/resilience/supervisor.py``, a copy: a tiny
per-host parent process that wraps the training command, classifies each
exit, and relaunches:

* **clean** (exit 0) — the run finished; the supervisor exits 0.
* **preempted** (exit :data:`PREEMPTED_EXIT_CODE`, 143) — the child
  checkpointed inside its grace window and left voluntarily; restart is
  free (it does NOT count against the crash budget).
* **aborted** (exit :data:`ABORTED_EXIT_CODE`, 75 = EX_TEMPFAIL) — the
  child's watchdog detected a dead peer and bounded the hang
  (``JobAbortedError``); restart, and count it: if the peer never
  returns, every incarnation re-aborts and the budget must trip.
* **crash** (anything else: nonzero exit, death by signal) — restart
  and count it against the budget.

The budget is N restarts per rolling window (:class:`RestartBudget`);
when it trips, the supervisor exits :data:`BUDGET_EXHAUSTED_EXIT_CODE`
with a diagnostic listing the exit history. Between counted restarts
the supervisor sleeps the jittered exponential ladder of the shared
:class:`~chainermn_torch.resilience.policy.RpcPolicy`.

Each incarnation gets ``$CHAINERMN_TPU_RESTART_COUNT`` in its
environment — the chaos harness's ``run=`` fault key reads it, so a
spec like ``kill@step=7,run=0`` kills only the first incarnation. A
``torch.distributed`` world's store lives in rank 0's process, so a
relaunched world needs a store of its own: give each incarnation its own
``MASTER_PORT`` (for example the base port plus the restart count).

The child side is :func:`main_exit_code` / ``Trainer.exit_code()``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from chainermn_torch.resilience.policy import RpcPolicy
from chainermn_torch.resilience.preemption import PREEMPTED_EXIT_CODE

#: exit code a training process uses for "watchdog aborted the job —
#: a peer died; restart me once the peer is back" (EX_TEMPFAIL: the
#: sysexits.h code for "transient failure, retry later")
ABORTED_EXIT_CODE = 75

#: the SUPERVISOR's own exit code when the restart budget trips — the
#: wrapped job is crash-looping and needs a human (distinct from every
#: child code so orchestrators can tell "gave up" from "crashed")
BUDGET_EXHAUSTED_EXIT_CODE = 112

#: environment variable carrying the incarnation number (0 for the
#: first launch) into the child — read by the chaos harness's ``run=``
#: fault key and available to training code for logging
RESTART_COUNT_ENV = "CHAINERMN_TPU_RESTART_COUNT"


def restart_count() -> int:
    """This process's supervised-incarnation number: 0 on the first
    launch (or when unsupervised). Scripts key per-incarnation
    artifacts off this (a log file, the world's ``MASTER_PORT``), so a
    restart never appends to a file a SIGKILL may have left with a torn
    trailing line."""
    raw = os.environ.get(RESTART_COUNT_ENV)
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            pass
    return 0


def classify_exit(returncode: int) -> str:
    """One of ``clean`` / ``preempted`` / ``aborted`` / ``crash``.

    Negative returncodes are deaths by signal (subprocess convention).
    A death by unhandled SIGTERM (-15) still counts as ``preempted``:
    the platform sent the signal but the child had no handler installed
    — restarting it is right, billing the crash budget for the
    platform's preemption is not. A death by unhandled SIGUSR1 (-10)
    counts as ``clean``: SIGUSR1 is the serving fleet's drain request
    (a server catches it, finishes or migrates its sessions, and exits
    0) — a binary without the handler must not bill the crash budget
    for being asked to retire."""
    if returncode == 0 or returncode == -signal.SIGUSR1:
        return "clean"
    if returncode == PREEMPTED_EXIT_CODE or returncode == -signal.SIGTERM:
        return "preempted"
    if returncode == ABORTED_EXIT_CODE:
        return "aborted"
    return "crash"


class RestartBudget:
    """N counted restarts per rolling window of ``window_s`` seconds.

    ``try_spend`` prunes events older than the window, then either
    records the restart and returns True, or returns False — the
    supervisor must stop. A long-healthy job earns its budget back as
    old crashes age out of the window."""

    def __init__(self, max_restarts: int = 5, window_s: float = 3600.0):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0: {max_restarts}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive: {window_s}")
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._events: List[float] = []

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        self._events = [t for t in self._events if t > cutoff]

    def remaining(self, now: Optional[float] = None) -> int:
        if now is None:
            now = time.monotonic()
        self._prune(now)
        return max(0, self.max_restarts - len(self._events))

    def try_spend(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.monotonic()
        self._prune(now)
        if len(self._events) >= self.max_restarts:
            return False
        self._events.append(now)
        return True


@dataclass
class ExitRecord:
    """One child incarnation's outcome, for the give-up diagnostic."""

    incarnation: int
    returncode: int
    kind: str
    runtime_s: float


@dataclass
class Supervisor:
    """Wrap ``cmd`` in a restart loop with a bounded crash budget.

    ``run()`` returns the supervisor's own exit status: the child's
    code on a terminal outcome (clean finish, preemption with
    ``restart_on_preempt=False``), or
    :data:`BUDGET_EXHAUSTED_EXIT_CODE` when the budget trips.

    ``sleep`` / ``spawn`` are injection points for tests (the chaos
    crash-loop test runs a real child but fakes no time)."""

    cmd: Sequence[str]
    max_restarts: int = 5
    window_s: float = 3600.0
    restart_on_preempt: bool = True
    policy: Optional[RpcPolicy] = None
    env: Optional[Dict[str, str]] = None
    sleep: Callable[[float], None] = time.sleep
    spawn: Optional[Callable[..., subprocess.Popen]] = None
    history: List[ExitRecord] = field(default_factory=list)

    def __post_init__(self):
        self.cmd = list(self.cmd)
        if not self.cmd:
            raise ValueError("supervisor needs a non-empty command")
        if self.policy is None:
            self.policy = RpcPolicy.from_env()
        self.budget = RestartBudget(self.max_restarts, self.window_s)

    def _log(self, msg: str) -> None:
        print(f"[supervise] {msg}", file=sys.stderr, flush=True)

    def _launch(self, incarnation: int) -> subprocess.Popen:
        env = dict(os.environ if self.env is None else self.env)
        env[RESTART_COUNT_ENV] = str(incarnation)
        spawn = self.spawn or subprocess.Popen
        return spawn(self.cmd, env=env)

    def run(self) -> int:
        incarnation = 0
        attempt = 0  # consecutive counted failures, drives the backoff
        while True:
            t0 = time.monotonic()
            self._log(f"launch #{incarnation}: {' '.join(self.cmd)}")
            proc = self._launch(incarnation)
            try:
                rc = proc.wait()
            except KeyboardInterrupt:
                # the operator killed the SUPERVISOR: forward, reap, stop
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                raise
            runtime = time.monotonic() - t0
            kind = classify_exit(rc)
            self.history.append(ExitRecord(incarnation, rc, kind, runtime))
            self._log(f"#{incarnation} exited {rc} ({kind}) "
                      f"after {runtime:.1f}s")

            if kind == "clean":
                return 0
            if kind == "preempted":
                if not self.restart_on_preempt:
                    return PREEMPTED_EXIT_CODE
                # free restart: preemptions are the platform's doing —
                # reset the failure streak, brief fixed pause (the
                # resource usually needs a moment to come back)
                attempt = 0
                self.sleep(self.policy.backoff_ms(0) / 1000.0)
            else:  # aborted or crash: counted
                if not self.budget.try_spend():
                    self._log(self._give_up_diagnostic())
                    return BUDGET_EXHAUSTED_EXIT_CODE
                delay = self.policy.backoff_ms(attempt) / 1000.0
                self._log(f"restarting in {delay:.2f}s "
                          f"(budget: {self.budget.remaining()} of "
                          f"{self.max_restarts} left in "
                          f"{self.window_s:.0f}s window)")
                attempt += 1
                self.sleep(delay)
            incarnation += 1

    def _give_up_diagnostic(self) -> str:
        lines = [
            f"restart budget exhausted: {self.max_restarts} counted "
            f"restart(s) within {self.window_s:.0f}s — the job is "
            "crash-looping; NOT restarting again.",
            "exit history (newest last):",
        ]
        for r in self.history[-(self.max_restarts + 2):]:
            lines.append(f"  #{r.incarnation}: exit {r.returncode} "
                         f"({r.kind}) after {r.runtime_s:.1f}s")
        lines.append(
            "next steps: inspect the newest incarnation's logs; if a "
            "peer host is permanently gone, resume on a smaller world "
            "(shrink-to-fit: chainermn_torch.resilience.elastic_resume).")
        return "\n".join(lines)


def _is_job_aborted(exc: BaseException) -> bool:
    # lazy import: JobAbortedError lives in the comm package, which
    # imports this package
    try:
        from chainermn_torch.comm.object_plane import JobAbortedError
    except Exception:
        return False
    return isinstance(exc, JobAbortedError)


def main_exit_code(main: Callable[..., object], *args, **kwargs) -> int:
    """Run a train script's ``main()`` and translate its outcome into
    the supervisor's exit-status contract:

    * returns normally, no preemption → 0 (clean);
    * the returned object (a ``Trainer``, or anything with a truthy
      ``preempted`` attribute) was preempted →
      :data:`PREEMPTED_EXIT_CODE`;
    * raises ``JobAbortedError`` (watchdog: a peer died) →
      :data:`ABORTED_EXIT_CODE`;
    * any other exception propagates (the interpreter's exit 1 reads as
      a crash — which it is).

    Usage in an example script::

        if __name__ == '__main__':
            sys.exit(main_exit_code(main))
    """
    try:
        result = main(*args, **kwargs)
    except BaseException as e:
        if _is_job_aborted(e):
            import traceback

            traceback.print_exc()
            return ABORTED_EXIT_CODE
        raise
    if getattr(result, "preempted", False):
        return PREEMPTED_EXIT_CODE
    return 0
