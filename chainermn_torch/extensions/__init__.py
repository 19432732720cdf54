"""Training-loop extensions of the port.

Counterpart of ``create_multi_node_evaluator`` in
``chainermn_tpu/extensions/__init__.py`` (reference:
chainermn/extensions/). ``AllreducePersistent`` waits for ROADMAP.md
queue 1 item 5, the checkpointer and ``install_global_except_hook`` for
item 7.
"""

from __future__ import annotations

from chainermn_torch.comm.base import CommunicatorBase

__all__ = ["create_multi_node_evaluator"]


def create_multi_node_evaluator(actual_evaluator,
                                communicator: CommunicatorBase):
    """Each rank evaluates its shard; the scalar results are averaged
    across ranks (reference: ``allreduce_obj`` mean of the result dict).

    ``actual_evaluator`` is any callable returning a dict of scalar
    metrics; the wrapper keeps its attributes (the reference delegates
    the same way).
    """

    class _MultiNodeEvaluator:
        def __init__(self, ev, comm):
            self._ev = ev
            self._comm = comm

        def __call__(self, trainer=None, *args, **kwargs):
            # the inner evaluator runs WITHOUT the trainer, so it cannot
            # publish un-reduced local metrics; only the job-wide means
            # reach the observation
            local = self._ev(*args, **kwargs)
            scalars = {k: float(v) for k, v in local.items()}
            reduced = self._comm.allreduce_obj(scalars, "mean")
            if trainer is not None:
                trainer.observation.update(reduced)
            return reduced

        def __getattr__(self, name):
            return getattr(self._ev, name)

    return _MultiNodeEvaluator(actual_evaluator, communicator)
