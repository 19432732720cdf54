"""Log/print reporting extensions (reference: Chainer's LogReport /
PrintReport, attached rank-0-only in every ChainerMN example).

Counterpart of ``LogReport`` and ``PrintReport`` in
``chainermn_tpu/training/reports.py``; its ``ReductionReport``,
``TuningReport`` and ``CheckpointReport`` wait for ROADMAP.md queue 1
items 8 and 13.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

__all__ = ["LogReport", "PrintReport"]


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
