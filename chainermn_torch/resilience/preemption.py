"""Preemption survival: turn SIGTERM into a clean exit, not a loss.

Counterpart of ``chainermn_tpu/resilience/preemption.py``. Clusters
preempt a job with a SIGTERM and a grace window; the default disposition
kills the process mid-step. This module installs a handler that only sets
a flag; the Trainer loop polls it once per step and, when set, leaves the
run loop cleanly with ``trainer.preempted`` set, and the process exits
with :data:`PREEMPTED_EXIT_CODE`. On the way out the Trainer writes its
checkpointer's emergency snapshot, bounded by :meth:`PreemptionGuard.
grace_deadline`: ``CHAINERMN_TPU_PREEMPTION_GRACE_S`` (default 30 s)
after the signal. :func:`reserve_grace` splits that one window between
the async snapshot plane's drain and the final synchronous write.

The handler is deliberately minimal (async-signal-safe: set a flag,
remember the signal, chain nothing): all real work happens on the
training thread. Install/uninstall is idempotent and restores the
previous handlers, so library users and tests can scope it to a run.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["PREEMPTED_EXIT_CODE", "PreemptionGuard", "guard",
           "install_preemption_handler", "preemption_requested",
           "reserve_grace", "grace_seconds"]

_ENV_GRACE = "CHAINERMN_TPU_PREEMPTION_GRACE_S"
_DEFAULT_GRACE_S = 30.0

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
        self._at: Optional[float] = None
        self._prev: Dict[int, object] = {}
        self._installed: Tuple[int, ...] = ()

    def _handle(self, signum, frame) -> None:  # noqa: ARG002 (signature)
        self._requested = True
        self._signum = signum
        if self._at is None:
            self._at = time.monotonic()

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def grace_deadline(self) -> Optional[float]:
        """Monotonic deadline the emergency checkpoint must beat (None
        until a signal arrived)."""
        if self._at is None:
            return None
        return self._at + grace_seconds()

    def remaining(self) -> Optional[float]:
        dl = self.grace_deadline()
        return None if dl is None else max(0.0, dl - time.monotonic())

    def reset(self) -> None:
        self._requested = False
        self._signum = None
        self._at = None

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


def reserve_grace(deadline_s: Optional[float], fraction: float = 0.5,
                  floor_s: float = 0.0) -> Optional[float]:
    """Split one absolute (monotonic) emergency deadline between a drain
    phase and the final synchronous write.

    The async snapshot plane must drain its in-flight publish before the
    last-chance ``emergency_save`` runs — but both phases share ONE grace
    window (``CHAINERMN_TPU_PREEMPTION_GRACE_S``): the drain budget is
    SUBTRACTED from the window, never added on top. Returns the earlier
    deadline the drain phase must beat, reserving ``fraction`` of the
    remaining window (at least ``floor_s`` seconds) for the write; the
    caller keeps using the ORIGINAL ``deadline_s`` for the write itself.
    None passes through (no deadline → unbounded drain, the crash-path
    semantics)."""
    if deadline_s is None:
        return None
    now = time.monotonic()
    remaining = max(0.0, deadline_s - now)
    reserve = max(floor_s, remaining * fraction)
    return max(now, deadline_s - reserve)


def grace_seconds() -> float:
    """The preemption grace window, ``$CHAINERMN_TPU_PREEMPTION_GRACE_S``
    (default 30 s; a malformed or non-positive value reads as the
    default)."""
    raw = os.environ.get(_ENV_GRACE)
    if not raw:
        return _DEFAULT_GRACE_S
    try:
        v = float(raw)
    except ValueError:
        return _DEFAULT_GRACE_S
    return v if v > 0 else _DEFAULT_GRACE_S


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


def preemption_requested() -> bool:
    """Has a preemption signal arrived? (False when no guard installed.)"""
    return _guard is not None and _guard.requested
