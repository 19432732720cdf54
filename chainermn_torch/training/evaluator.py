"""Evaluator: run an eval step over a validation iterator.

Counterpart of ``chainermn_tpu/training/evaluator.py``. Wrap with
:func:`chainermn_torch.extensions.create_multi_node_evaluator` for the
reference's cross-rank averaging of the result.
"""

from __future__ import annotations

from typing import Callable, Dict

from chainermn_torch.training.trainer import default_converter

__all__ = ["Evaluator"]


class Evaluator:
    """``iterator_factory()`` gives a fresh non-repeating iterator;
    ``eval_step(*arrays)`` a dict of scalar metrics for one batch
    (:func:`make_eval_step`). The result is each metric's mean over the
    batches."""

    def __init__(self, iterator_factory: Callable, eval_step: Callable,
                 updater, converter=None):
        self._make_it = iterator_factory
        self._eval_step = eval_step
        self._updater = updater
        self._converter = converter or default_converter

    def __call__(self, trainer=None) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        for batch in self._make_it():
            arrays = self._updater.shard_batch(self._converter(batch))
            for k, v in self._eval_step(*arrays).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        out = {k: v / max(1, n) for k, v in sums.items()}
        if trainer is not None:
            trainer.observation.update(out)
        return out
