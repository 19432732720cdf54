"""Log/print reporting extensions (reference: Chainer's LogReport /
PrintReport, attached rank-0-only in every ChainerMN example).

Counterpart of ``LogReport``, ``PrintReport``, ``ReductionReport``,
``TuningReport`` and ``CheckpointReport`` in
``chainermn_tpu/training/reports.py``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

__all__ = ["LogReport", "PrintReport", "ReductionReport", "TuningReport",
           "CheckpointReport"]


class LogReport:
    """Accumulates trainer observations; optionally writes JSON lines."""

    def __init__(self, path: Optional[str] = None):
        self.log: List[dict] = []
        self.path = path

    def __call__(self, trainer):
        obs = dict(trainer.observation)
        self.log.append(obs)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(obs) + "\n")


class ReductionReport:
    """Surfaces the gradient-reduction plan.

    Attach like LogReport. On its first call it prints the reducer's plan
    once, a line a bucket (algorithm, payload bytes, wire bytes), and on
    every call it puts the totals in ``trainer.observation``
    (``comm/bytes``, ``comm/wire_bytes``, ``comm/wire_compression``,
    ``comm/strategy``). ``wire_bytes`` counts what the reducer hands its
    collectives a step: for the integer formats the int32 codes and the
    scales' all-reduce, so ``comm/wire_compression`` is about 1.004 for
    ``int8-block``, and 0.5 for ``bf16``.

    ``reducer`` is a :class:`~chainermn_torch.collectives.GradReducer` (or
    None: a no-op); ``grads_template`` the model, or any tree of tensors
    shaped like its gradients. No device work happens here.
    """

    def __init__(self, reducer, grads_template, quiet: bool = False):
        self.reducer = reducer
        self.rows = [] if reducer is None else reducer.plan(grads_template)
        self.quiet = quiet
        self._printed = False

    @property
    def total_bytes(self) -> int:
        return sum(r["bytes"] for r in self.rows)

    @property
    def total_wire_bytes(self) -> int:
        return sum(r["wire_bytes"] for r in self.rows)

    @property
    def wire_compression(self) -> float:
        """``wire_bytes / payload_bytes`` (1.0 uncompressed)."""
        total = self.total_bytes
        return self.total_wire_bytes / total if total else 1.0

    def __call__(self, trainer):
        if self.reducer is None:
            return
        if not self._printed and not self.quiet:
            for line in self.reducer.describe_rows(self.rows):
                print(line, flush=True)
            self._printed = True
        trainer.observation["comm/bytes"] = self.total_bytes
        trainer.observation["comm/wire_bytes"] = self.total_wire_bytes
        trainer.observation["comm/wire_compression"] = round(
            self.wire_compression, 6)
        trainer.observation["comm/strategy"] = self.reducer.name


class TuningReport:
    """Surfaces the schedtune-chosen collective schedule beside
    :class:`ReductionReport`.

    ``plan`` is a :class:`~chainermn_torch.tuning.profile_db.SchedulePlan`
    or anything carrying one as ``.plan`` (a tuned
    ``create_multi_node_optimizer`` result works directly). On the first
    call it prints the chosen schedule once; on every call it folds
    ``tuning/overlap_frac``, ``tuning/bucket_bytes`` and
    ``tuning/strategy`` into ``trainer.observation``. Nothing without a
    plan (untuned runs keep their logs as they were).
    """

    def __init__(self, plan, quiet: bool = False):
        self.plan = getattr(plan, "plan", plan)
        self.quiet = quiet
        self._printed = False

    def __call__(self, trainer):
        plan = self.plan
        if plan is None:
            return
        if not self._printed and not self.quiet:
            db = " +double_buffering" if plan.double_buffering else ""
            wf = getattr(plan, "wire_format", "f32")
            db = (f" wire={wf}" if wf != "f32" else "") + db
            print(
                f"schedtune: {plan.strategy} "
                f"bucket_bytes={plan.bucket_bytes:,} "
                f"order={plan.bucket_order}{db} "
                f"overlap_frac={plan.overlap_fraction:.4f} "
                f"[{plan.source}] ({plan.fingerprint})", flush=True)
            self._printed = True
        trainer.observation["tuning/overlap_frac"] = plan.overlap_fraction
        trainer.observation["tuning/bucket_bytes"] = plan.bucket_bytes
        trainer.observation["tuning/strategy"] = plan.strategy


class PrintReport:
    """Prints the observation's ``keys`` as a table row, with a header
    before the first row."""

    def __init__(self, keys: List[str]):
        self.keys = keys
        self._header_done = False

    def __call__(self, trainer):
        if not self._header_done:
            print("  ".join(f"{k:>14}" for k in self.keys), flush=True)
            self._header_done = True
        row = []
        for k in self.keys:
            v = trainer.observation.get(k, float("nan"))
            row.append(f"{v:>14.6g}" if isinstance(v, float) else f"{v:>14}")
        print("  ".join(row), flush=True)


class CheckpointReport:
    """The asynchronous snapshot plane's stats beside LogReport (JAX's
    ``training/reports.py:120``).

    ``plane`` is a :class:`~chainermn_torch.checkpointing.
    AsyncSnapshotPlane`. The first call prints the plane's configuration
    once; every call puts ``ckpt/stall_ms`` (the step thread's time in
    the last save), ``ckpt/bytes``, ``ckpt/cadence`` (iterations between
    saves), ``ckpt/pending``, ``ckpt/published`` and ``ckpt/skipped``
    (backpressure drops) into ``trainer.observation``. Host counters
    only."""

    def __init__(self, plane, quiet: bool = False):
        self.plane = plane
        self.quiet = quiet
        self._printed = False

    def __call__(self, trainer):
        p = self.plane
        if not self._printed and not self.quiet:
            print(f"ckpt plane: backpressure="
                  f"{getattr(p, 'backpressure', 'sync')} "
                  f"max_pending={getattr(p, 'max_pending', 0)} "
                  f"replicator="
                  f"{'on' if getattr(p, 'replicator', None) else 'off'}",
                  flush=True)
            self._printed = True
        obs = trainer.observation
        obs["ckpt/stall_ms"] = round(
            float(getattr(p, "stall_ms_last", 0.0)), 3)
        obs["ckpt/bytes"] = int(getattr(p, "bytes_last", 0))
        obs["ckpt/cadence"] = int(getattr(p, "cadence_last", 0))
        obs["ckpt/pending"] = int(getattr(p, "pending", 0))
        obs["ckpt/published"] = int(getattr(p, "published", 0))
        obs["ckpt/skipped"] = int(getattr(p, "skipped", 0))
