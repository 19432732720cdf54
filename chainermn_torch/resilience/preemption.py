"""Preemption survival: turn SIGTERM into a clean exit, not a loss.

Counterpart of ``chainermn_tpu/resilience/preemption.py``. Clusters
preempt a job with a SIGTERM and a grace window; the default disposition
kills the process mid-step. This module installs a handler that only sets
a flag; the Trainer loop polls it once per step and, when set, leaves the
run loop cleanly with ``trainer.preempted`` set, and the process exits
with :data:`PREEMPTED_EXIT_CODE`. The JAX package also spends the grace
window (``CHAINERMN_TPU_PREEMPTION_GRACE_S``) on an emergency
checkpoint; that comes with the port's checkpointer (ROADMAP.md queue 1
item 7).

The handler is deliberately minimal (async-signal-safe: set a flag,
remember the signal, chain nothing): all real work happens on the
training thread. Install/uninstall is idempotent and restores the
previous handlers, so library users and tests can scope it to a run.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Optional, Tuple

__all__ = ["PREEMPTED_EXIT_CODE", "PreemptionGuard", "guard",
           "install_preemption_handler"]

#: conventional exit code for a run that stopped on preemption (distinct
#: from 0 so orchestrators can tell "finished" from "preempted but
#: resumable"; 128+SIGTERM is what an unhandled SIGTERM would have
#: produced)
PREEMPTED_EXIT_CODE = 143


class PreemptionGuard:
    """Flag state shared between the signal handler and the training
    loop. The flag is a simple attribute write from the handler; reads are
    racy-but-monotonic (once True, stays True until :meth:`reset`)."""

    def __init__(self) -> None:
        self._requested = False
        self._signum: Optional[int] = None
        self._prev: Dict[int, object] = {}
        self._installed: Tuple[int, ...] = ()

    def _handle(self, signum, frame) -> None:  # noqa: ARG002 (signature)
        self._requested = True
        self._signum = signum

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def reset(self) -> None:
        self._requested = False
        self._signum = None

    def install(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                  signal.SIGINT)) -> bool:
        """Install the flag-setting handler; returns False when not on the
        main thread (signal.signal would raise) — callers treat that as
        "preemption handling unavailable", not an error."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        prev = {}
        try:
            for s in signals:
                prev[s] = signal.signal(s, self._handle)
        except ValueError:
            for s, h in prev.items():
                signal.signal(s, h)
            return False
        self._prev = prev
        self._installed = tuple(signals)
        return True

    def uninstall(self) -> None:
        """Restore the handlers :meth:`install` replaced."""
        for s in self._installed:
            prev = self._prev.get(s)
            if prev is not None:
                try:
                    signal.signal(s, prev)
                except (ValueError, TypeError):
                    pass
        self._prev = {}
        self._installed = ()


_guard: Optional[PreemptionGuard] = None


def guard() -> PreemptionGuard:
    """The process-wide guard (created on first use, not installed)."""
    global _guard
    if _guard is None:
        _guard = PreemptionGuard()
    return _guard


def install_preemption_handler(
        signals: Tuple[int, ...] = (signal.SIGTERM,
                                    signal.SIGINT)) -> PreemptionGuard:
    """Install the process-wide guard's handler (idempotent) and return
    the guard. Safe to call off the main thread (it just won't install)."""
    g = guard()
    g.install(signals)
    return g
