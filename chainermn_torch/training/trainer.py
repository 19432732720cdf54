"""Minimal trainer/updater loop.

Counterpart of ``chainermn_tpu/training/trainer.py`` (reference: Chainer's
``Trainer``/``StandardUpdater``, which ChainerMN's examples drive): an
updater that feeds each rank's batch into the train step, and a trainer
with interval-triggered extensions (log/print/eval at triggers, rank-0-only
reporting by the caller's choice).

The JAX updater places a global batch on the mesh; here one process
drives one GPU, so the updater moves this rank's arrays to
``comm.device`` and the step all-reduces across ranks. The step's metrics
stay on the device: the trainer reads them (a host synchronisation) only
when an extension is due.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from chainermn_torch.resilience.preemption import (PREEMPTED_EXIT_CODE,
                                                   install_preemption_handler)

__all__ = ["default_converter", "StandardUpdater", "Trainer"]

# the JAX package's chaos and watchdog switches, whose hooks the port's
# loop does not have yet
_CHAOS_ENV = "CHAINERMN_TPU_CHAOS"
_WATCHDOG_ENV = "CHAINERMN_TPU_WATCHDOG"


def default_converter(batch):
    """List of (x, y) pairs → stacked arrays (the reference's
    concat_examples)."""
    xs = np.stack([b[0] for b in batch])
    ys = np.stack([b[1] for b in batch])
    return xs, ys


class StandardUpdater:
    """Pulls a batch, moves it to the rank's device, runs the step.

    ``step_fn(*batch_arrays) -> metrics_dict`` updates the model and its
    optimizer in place (:func:`make_data_parallel_train_step`).
    """

    def __init__(self, iterator, step_fn: Callable, comm,
                 converter: Callable = default_converter):
        self.iterator = iterator
        self.step_fn = step_fn
        self.comm = comm
        self.converter = converter
        self.iteration = 0
        self.last_metrics: Dict[str, Any] = {}

    @property
    def epoch(self):
        return getattr(self.iterator, "epoch", 0)

    @property
    def is_new_epoch(self):
        return getattr(self.iterator, "is_new_epoch", False)

    def shard_batch(self, arrays):
        """This rank's arrays on ``comm.device``."""
        return tuple(torch.as_tensor(a).to(self.comm.device,
                                           non_blocking=True)
                     for a in arrays)

    def update(self):
        batch = next(self.iterator)
        arrays = self.shard_batch(self.converter(batch))
        self.last_metrics = self.step_fn(*arrays)
        self.iteration += 1

    # -- host-side resume state -----------------------------------------

    def host_state_dict(self) -> Dict[str, Any]:
        """Host-side training position for checkpoints: iteration count,
        iterator position/epoch/RNG, and the global NumPy RNG (augment
        pipelines draw from it). The model and optimizer state dicts are
        saved separately."""
        it_state = getattr(self.iterator, "state_dict", None)
        return {
            "iteration": self.iteration,
            "iterator": it_state() if callable(it_state) else None,
            "np_random": np.random.get_state(),
        }

    def load_host_state(self, host: Dict[str, Any]) -> None:
        """Restore :meth:`host_state_dict` output — the resumed run draws
        the exact next batch the interrupted run would have."""
        self.iteration = int(host.get("iteration", self.iteration))
        it_state = host.get("iterator")
        restore = getattr(self.iterator, "load_state_dict", None)
        if it_state is not None and callable(restore):
            restore(it_state)
        if host.get("np_random") is not None:
            np.random.set_state(host["np_random"])


class _Entry:
    def __init__(self, ext, trigger, name):
        self.ext = ext
        self.n, self.unit = trigger
        self.name = name
        self.closed = False

    def due(self, updater) -> bool:
        if self.unit == "iteration":
            return updater.iteration % self.n == 0
        if self.unit == "epoch":
            return updater.is_new_epoch and updater.epoch % self.n == 0
        raise ValueError(f"unknown trigger unit {self.unit!r}")


class Trainer:
    """Runs the updater until the stop trigger, firing extensions.

    Reference convention preserved: attach reporting extensions only on
    the master (``if comm.rank == 0: trainer.extend(...)``) — metrics are
    reduced in the step or by the multi-node evaluator, not here.

    With ``handle_preemption=True`` (default) the run installs a
    SIGTERM/SIGINT flag handler and polls it every step: a preemption
    ends the loop cleanly with ``trainer.preempted`` set, and
    :meth:`exit_code` gives :data:`PREEMPTED_EXIT_CODE`. Extensions with
    a ``close`` method are closed when the run ends, however it ends.
    The JAX package's chaos hook and peer-death watchdog wait for
    ROADMAP.md queue 1 item 9: :meth:`run` refuses their environment
    variables rather than ignore them.
    """

    def __init__(self, updater: StandardUpdater,
                 stop_trigger: Tuple[int, str] = (1, "epoch"),
                 out: str = "result", handle_preemption: bool = True):
        self.updater = updater
        self.stop_n, self.stop_unit = stop_trigger
        self.out = out
        self.handle_preemption = handle_preemption
        self.preempted = False
        self._extensions = []
        self.observation: Dict[str, Any] = {}

    def extend(self, extension, trigger: Tuple[int, str] = (1, "epoch"),
               name: Optional[str] = None):
        self._extensions.append(_Entry(extension, trigger, name))

    def _stopped(self) -> bool:
        if self.stop_unit == "epoch":
            return self.updater.epoch >= self.stop_n
        return self.updater.iteration >= self.stop_n

    def _materialize_observation(self, start):
        # float() waits for the device: only when someone reads the
        # numbers. update (not replace): extension-published keys
        # (validation/...) stay visible until their next refresh
        self.observation.update(
            {k: float(v) for k, v in self.updater.last_metrics.items()})
        self.observation["iteration"] = self.updater.iteration
        self.observation["epoch"] = self.updater.epoch
        self.observation["elapsed_time"] = time.time() - start

    def exit_code(self) -> int:
        """Process exit status under the supervisor contract:
        :data:`PREEMPTED_EXIT_CODE` (143) after a preempted run, else 0.
        Train scripts: ``sys.exit(trainer.exit_code())``, or wrap the
        whole main in
        :func:`chainermn_torch.resilience.supervisor.main_exit_code`."""
        return PREEMPTED_EXIT_CODE if self.preempted else 0

    def run(self):
        if any(e.closed for e in self._extensions):
            # closed extensions may hold released resources; resuming
            # needs a fresh Trainer
            raise RuntimeError(
                "this Trainer already ran and finalized its extensions; "
                "construct a new Trainer (re-attaching extensions) to "
                "resume")
        if (os.environ.get(_CHAOS_ENV) or os.environ.get(
                _WATCHDOG_ENV, "").lower() not in ("", "0", "false")):
            raise NotImplementedError(
                f"${_CHAOS_ENV} / ${_WATCHDOG_ENV} are set, but the chaos "
                "hook and the watchdog wait for a later slice of the port "
                "(ROADMAP.md queue 1 item 9)")
        guard = (install_preemption_handler() if self.handle_preemption
                 else None)
        start = time.time()
        try:
            while not self._stopped():
                if guard is not None and guard.requested:
                    self.preempted = True
                    break
                try:
                    self.updater.update()
                except StopIteration:
                    break  # non-repeating iterator exhausted
                due = [e for e in self._extensions if e.due(self.updater)]
                if due:
                    self._materialize_observation(start)
                    for e in due:
                        e.ext(self)
            self._materialize_observation(start)
        finally:
            if guard is not None:
                guard.uninstall()
            for e in self._extensions:
                close = getattr(e.ext, "close", None)
                if e.closed or not callable(close):
                    continue
                e.closed = True
                try:
                    close()
                except Exception:
                    # a failing close must not mask how the run ended
                    traceback.print_exc()
