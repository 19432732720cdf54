"""Multi-node optimizer wrapper.

Counterpart of ``chainermn_tpu/optimizers/__init__.py``
``create_multi_node_optimizer`` (the reference ChainerMN wrapper): it
wraps a ``torch.optim.Optimizer`` so that ``step()`` all-reduces the
gradients through ``communicator.allreduce_grad`` (or the
``grad_reducer``'s ``reduce``, ``chainermn_torch.collectives``) before
the inner update. ``double_buffering=True`` keeps the reference's
one-step lag: the first step applies zero gradients, step t applies step
t−1's reduced gradients (the reduction comes first, the lag after it).

Every parameter takes part in every step, as every leaf of an optax
update does: a parameter that received no gradient gets a zero one, so
decoupled weight decay reaches it too (``torch.optim.AdamW`` alone skips
parameters whose ``.grad`` is None).

``state_dict``/``load_state_dict`` cover everything a resumed run needs:
the inner optimizer's, the double buffer's held gradients, a stateful
reducer's error-feedback residuals (this rank's own, so each rank's
checkpoint file keeps its own: the JAX package's
``_ReducerWrappedState``), and the learning-rate schedules attached with
:meth:`MultiNodeOptimizer.add_schedule` (a ``LambdaLR`` whose
``last_epoch`` did not survive a resume would restart its warm-up).
``load_state_dict`` loads in place, into the objects the train step
holds.

The ZeRO-1/2 step factories (:mod:`chainermn_torch.optimizers.zero`) and
the large-batch optimizers LARS and LAMB
(:mod:`chainermn_torch.optimizers.large_batch`) are exported here too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from chainermn_torch.collectives import make_grad_reducer
from chainermn_torch.collectives.base import _ITEM13
from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.optimizers.large_batch import LAMB, LARS
from chainermn_torch.optimizers.zero import (fsdp_gather_params,
                                             fsdp_layout_manifest,
                                             fsdp_scan_apply, fsdp_shardings,
                                             fsdp_stack_shardings,
                                             make_fsdp_train_step,
                                             make_zero1_train_step,
                                             make_zero2_train_step,
                                             zero1_params,
                                             zero_layout_manifest)

__all__ = ["MultiNodeOptimizer", "create_multi_node_optimizer", "LARS",
           "LAMB", "make_zero1_train_step", "make_zero2_train_step",
           "zero1_params", "zero_layout_manifest", "make_fsdp_train_step",
           "fsdp_shardings", "fsdp_stack_shardings", "fsdp_scan_apply",
           "fsdp_gather_params", "fsdp_layout_manifest"]


class MultiNodeOptimizer:
    """A ``torch.optim.Optimizer`` wrapped with the gradient all-reduce;
    use it as the inner optimizer (``zero_grad``, ``step``,
    ``param_groups``, ``state``). ``grad_reducer`` (a
    :class:`~chainermn_torch.collectives.GradReducer` or None) reduces in
    place of ``allreduce_grad``; ``plan`` (a tuned schedule) is None until
    the tuner is ported."""

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase,
                 double_buffering: bool = False, op: str = "mean",
                 grad_reducer=None):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        self.op = op
        self.grad_reducer = grad_reducer
        self.plan = None
        self._prev: Optional[List[torch.Tensor]] = None
        self.schedules: List[Any] = []
        self.reducer_state = (() if grad_reducer is None else
                              grad_reducer.init(self._params()))

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

    @property
    def _stateful(self) -> bool:
        return bool(getattr(self.grad_reducer, "stateful", False))

    def state_dict(self) -> Dict[str, Any]:
        """The inner optimizer's state, the double buffer's gradients
        (None before the first step or without double buffering), each
        schedule's state and, for a stateful reducer only, its residuals
        (``reducer``; the other layouts stay as they were)."""
        out = {"optimizer": self.actual_optimizer.state_dict(),
               "prev": None if self._prev is None else list(self._prev),
               "schedules": [s.state_dict() for s in self.schedules]}
        if self._stateful:
            out["reducer"] = list(self.reducer_state)
        return out

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
        if self._stateful:
            if "reducer" not in state:
                raise ValueError("the state has no reducer residuals; this "
                                 "optimizer's reducer is stateful")
            if len(state["reducer"]) != len(self.reducer_state):
                raise ValueError(
                    f"the state has {len(state['reducer'])} residual "
                    f"buckets, this reducer {len(self.reducer_state)}")
            self.reducer_state = tuple(
                torch.as_tensor(r).to(device=e.device, dtype=e.dtype,
                                      copy=True)
                for r, e in zip(state["reducer"], self.reducer_state))

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
        if self.grad_reducer is None:
            self.communicator.allreduce_grad(grads, self.op)
        else:
            _, self.reducer_state = self.grad_reducer.reduce(
                grads, self.reducer_state)
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
    module docstring).

    ``grad_reducer`` selects the reduction strategy: None (default) and
    ``'flat'`` are ``allreduce_grad``, bit for bit; ``'hierarchical'``,
    ``'quantized'``, ``'auto'`` or a constructed
    :class:`~chainermn_torch.collectives.GradReducer`. A stateful reducer
    (quantized with error feedback) keeps its residuals in this
    optimizer's ``state_dict``. ``wire_format`` (``'bf16' | 'int8' |
    'int8-block' | 'int4-block'``) goes to a reducer built from a name;
    ``'f32'``/None keep the strategy's default; a narrow format with no
    reducer, or with one that cannot compress, raises ``ValueError``.
    ``tune``/``model_key``/``topology`` (the schedule tuner) wait for
    ROADMAP.md queue 1 item 13."""
    if tune is not None or model_key is not None or topology is not None:
        raise NotImplementedError(f"tune, model_key and topology {_ITEM13}")
    if isinstance(grad_reducer, str):
        reducer = make_grad_reducer(grad_reducer, communicator, op=op,
                                    wire_format=wire_format)
    else:
        if wire_format not in (None, "f32") and grad_reducer is None:
            raise ValueError(
                f"wire_format={wire_format!r} needs a compressing "
                "grad_reducer ('quantized' or 'auto'); the default flat "
                "all-reduce carries f32")
        reducer = make_grad_reducer(grad_reducer, communicator, op=op)
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering, op, grad_reducer=reducer)
