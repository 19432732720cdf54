"""Log/print reporting extensions (reference: Chainer's LogReport /
PrintReport, attached rank-0-only in every ChainerMN example).

Counterpart of ``LogReport``, ``PrintReport`` and ``ReductionReport`` in
``chainermn_tpu/training/reports.py``; its ``TuningReport`` and
``CheckpointReport`` wait for ROADMAP.md queue 1 items 13 and 8.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

__all__ = ["LogReport", "PrintReport", "ReductionReport"]


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
