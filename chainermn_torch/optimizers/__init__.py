"""Multi-node optimizer wrapper.

Counterpart of ``chainermn_tpu/optimizers/__init__.py``
``create_multi_node_optimizer`` (the reference ChainerMN wrapper): it
wraps a ``torch.optim.Optimizer`` so that ``step()`` all-reduces the
gradients through ``communicator.allreduce_grad`` before the inner
update. ``double_buffering=True`` keeps the reference's one-step lag:
the first step applies zero gradients, step t applies step t−1's reduced
gradients.

Every parameter takes part in every step, as every leaf of an optax
update does: a parameter that received no gradient gets a zero one, so
decoupled weight decay reaches it too (``torch.optim.AdamW`` alone skips
parameters whose ``.grad`` is None).

``state_dict``/``load_state_dict`` cover everything a resumed run needs:
the inner optimizer's, the double buffer's held gradients, and the
learning-rate schedules attached with :meth:`MultiNodeOptimizer.
add_schedule` (a ``LambdaLR`` whose ``last_epoch`` did not survive a
resume would restart its warm-up). ``load_state_dict`` loads in place,
into the objects the train step holds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from chainermn_torch.comm.base import CommunicatorBase

__all__ = ["MultiNodeOptimizer", "create_multi_node_optimizer"]


class MultiNodeOptimizer:
    """A ``torch.optim.Optimizer`` wrapped with the gradient all-reduce;
    use it as the inner optimizer (``zero_grad``, ``step``,
    ``param_groups``, ``state``)."""

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase,
                 double_buffering: bool = False, op: str = "mean"):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        self.op = op
        self._prev: Optional[List[torch.Tensor]] = None
        self.schedules: List[Any] = []

    @property
    def param_groups(self):
        return self.actual_optimizer.param_groups

    @property
    def state(self):
        return self.actual_optimizer.state

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def add_schedule(self, scheduler) -> None:
        """Step ``scheduler`` (a ``torch.optim.lr_scheduler`` of the inner
        optimizer) after each inner update, and keep its state in
        :meth:`state_dict`."""
        self.actual_optimizer.register_step_post_hook(
            lambda *_: scheduler.step())
        self.schedules.append(scheduler)

    def state_dict(self) -> Dict[str, Any]:
        """The inner optimizer's state, the double buffer's gradients
        (None before the first step or without double buffering) and each
        schedule's state."""
        return {"optimizer": self.actual_optimizer.state_dict(),
                "prev": None if self._prev is None else list(self._prev),
                "schedules": [s.state_dict() for s in self.schedules]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load :meth:`state_dict` output in place."""
        if len(state["schedules"]) != len(self.schedules):
            raise ValueError(f"the state has {len(state['schedules'])} "
                             f"schedules, this optimizer "
                             f"{len(self.schedules)}")
        self.actual_optimizer.load_state_dict(state["optimizer"])
        prev = state["prev"]
        self._prev = None if prev is None else [
            torch.as_tensor(g).to(device=p.device, dtype=p.dtype, copy=True)
            for g, p in zip(prev, self._params())]
        for sched, s in zip(self.schedules, state["schedules"]):
            sched.load_state_dict(s)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.actual_optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        """All-reduce every gradient, then the inner update. A closure
        would re-run the forward after the reduction and is refused."""
        if closure is not None:
            raise ValueError("MultiNodeOptimizer.step takes no closure")
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        self.communicator.allreduce_grad(grads, self.op)
        if self.double_buffering:
            # apply step t-1's reduced gradients; keep this step's for t+1
            prev = self._prev or [torch.zeros_like(g) for g in grads]
            self._prev = grads
            for p, g in zip(params, prev):
                p.grad = g
        return self.actual_optimizer.step()


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase,
                                double_buffering: bool = False,
                                op: str = "mean", grad_reducer: Any = None,
                                tune: Any = None,
                                model_key: Optional[str] = None,
                                wire_format: Optional[str] = None,
                                topology: Any = None) -> MultiNodeOptimizer:
    """Wrap ``actual_optimizer`` with the gradient all-reduce (see the
    module docstring). ``grad_reducer``, ``tune``/``model_key``,
    ``wire_format`` and ``topology`` (the reducer zoo and the schedule
    tuner) wait for later slices (ROADMAP.md queues 8 and 13)."""
    if (grad_reducer is not None or tune is not None
            or wire_format not in (None, "f32") or topology is not None
            or model_key is not None):
        raise NotImplementedError(
            "grad_reducer, tune, model_key, wire_format and topology wait "
            "for later slices of the port (ROADMAP.md queues 8 and 13)")
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering, op)
