"""Training-loop extensions of the port: evaluator, persistent-state
sync, checkpointer, abort hook.

Counterpart of ``chainermn_tpu/extensions/__init__.py`` (reference:
chainermn/extensions/ and chainermn/global_except_hook.py):
``create_multi_node_evaluator``, ``allreduce_persistent``,
``AllreducePersistent``, ``MultiNodeCheckpointer`` /
``create_multi_node_checkpointer`` (:mod:`.checkpoint`) and
``install_global_except_hook``.
"""

from __future__ import annotations

import os
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.extensions.checkpoint import (
    MultiNodeCheckpointer, ShardedLeaf, create_multi_node_checkpointer,
    read_manifest)

__all__ = ["create_multi_node_evaluator", "allreduce_persistent",
           "AllreducePersistent", "MultiNodeCheckpointer",
           "create_multi_node_checkpointer", "install_global_except_hook",
           "ShardedLeaf", "read_manifest"]


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


def _persistent_tensors(state) -> List[torch.Tensor]:
    """A module's batch-norm running statistics, or the tensors of a
    tensor, dict, list or tuple."""
    if isinstance(state, nn.Module):
        from chainermn_torch.links import batch_norm_layers

        return [t for m in batch_norm_layers(state)
                for t in (m.running_mean, m.running_var)]
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _persistent_tensors(v)]
    return [t for v in state for t in _persistent_tensors(v)]


@torch.no_grad()
def allreduce_persistent(state, communicator: CommunicatorBase,
                         op: str = "mean"):
    """Average persistent (non-gradient) tensors, the batch-norm running
    statistics, over the ranks so that snapshots and evaluation see one
    value (reference: the AllreducePersistent extension).

    ``state`` is a module (its batch norms' running statistics) or a
    tensor, dict, list or tuple of tensors; they are reduced in place, one
    flat buffer per dtype and one all-reduce each, in their own dtype
    (never the communicator's ``allreduce_grad_dtype``), and ``state`` is
    returned."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in _persistent_tensors(state):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for tensors in groups.values():
        flat = communicator.allreduce(
            torch.cat([t.reshape(-1) for t in tensors]), op)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return state


class AllreducePersistent:
    """Extension-object form of :func:`allreduce_persistent` for the
    trainer (the reference's API shape): ``model_state_getter()`` gives
    the state, the reduced state goes to ``model_state_setter`` (None: the
    reduction in place is enough, as it is for a module)."""

    def __init__(self, model_state_getter: Callable[[], Any],
                 communicator: CommunicatorBase,
                 model_state_setter: Optional[Callable[[Any], None]] = None):
        self._get = model_state_getter
        self._set = model_state_setter
        self._comm = communicator

    def __call__(self, trainer=None):
        state = allreduce_persistent(self._get(), self._comm)
        if self._set is not None:
            self._set(state)


#: the exit status of a job torn down by the hook
ABORT_EXIT_CODE = 13


def install_global_except_hook(communicator: CommunicatorBase = None):
    """Fail-fast job abort: any uncaught exception tears the process
    down instead of leaving its peers waiting inside a collective
    (reference: chainermn/global_except_hook.py, which prints the
    traceback and calls ``MPI_Abort``). The hook prints the traceback,
    posts the abort poison key in a world of more than one rank (the
    store-backed object plane: peers' guarded waits and watchdogs raise
    ``JobAbortedError`` within one probe slice), and hard-exits with
    status 13 (``os._exit``: no interpreter shutdown that could block on
    a collective). ``communicator`` is accepted for the reference's
    signature. Returns the hook it replaced."""
    del communicator
    prev_hook = sys.excepthook

    def _hook(exc_type, exc_value, exc_tb):
        try:
            sys.stderr.write(
                "chainermn_torch: uncaught exception — aborting job\n")
            traceback.print_exception(exc_type, exc_value, exc_tb)
            sys.stderr.flush()
        finally:
            try:
                import torch.distributed as dist

                if dist.is_initialized() and dist.get_world_size() > 1:
                    from chainermn_torch.comm.object_plane import post_abort

                    post_abort(f"{exc_type.__name__}: {exc_value} "
                               f"(rank {dist.get_rank()})")
            except Exception:
                pass
            os._exit(ABORT_EXIT_CODE)

    sys.excepthook = _hook
    return prev_hook
