"""The data-parallel train step of the port.

Counterpart of ``chainermn_tpu/training/step.py``
``make_data_parallel_train_step``. The JAX step is one compiled program
over the mesh; here each rank runs the step eagerly on its own GPU:
loss and gradients of the local batch, the gradient all-reduce inside
the multi-node optimizer's ``step()``, the update, and the loss and
accuracy averaged over ranks. It runs no host synchronisation: metrics
stay on the device.

The model and the optimizer are updated in place, so the step takes the
batch alone: ``metrics = step(x, y)``. ``scan_steps=K`` runs K steps per
call on inputs with a leading K axis and returns metrics with a leading
K axis (the JAX package's ``lax.scan``, here a Python loop).
``grad_accum=N`` splits the batch into N micro-batches and averages
their gradients, loss and accuracy; ``remat`` recomputes the loss's
forward in the backward (``torch.utils.checkpoint``, non-reentrant).

``mutable=("batch_stats",)`` trains a model with batch norm
(:class:`~chainermn_torch.links.MultiNodeBatchNormalization`): its
train-mode forwards update the running statistics in place, through the
micro-batches in order under ``grad_accum`` (as the JAX step's scan
carries them) and once per micro-batch under ``remat`` (the recomputed
forward leaves them alone). After the optimizer step the statistics of
every per-replica batch norm are all-reduced to their mean over the ranks
in one flat f32 buffer: the JAX step's ``pmean`` of the varying
``batch_stats``. A cross-replica batch norm's statistics already agree on
every rank, and the JAX step leaves them alone too.

``make_eval_step`` is the counterpart of the JAX ``make_eval_step``: the
loss and accuracy of each rank's batch under ``torch.no_grad()`` and
with ``train=False`` (running statistics), averaged over ranks (the JAX
step's ``pmean`` over the mesh).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chainermn_torch.extensions import allreduce_persistent
from chainermn_torch.links import batch_norm_layers, frozen_batch_stats

__all__ = ["classifier_loss", "make_data_parallel_train_step",
           "make_eval_step"]


def _accepts_train(model) -> bool:
    """Whether ``model``'s ``forward`` declares ``train`` (batch norm and
    dropout models), as the JAX ``_accepts_train`` asks of ``__call__``."""
    try:
        sig = inspect.signature(type(model).forward)
    except (TypeError, ValueError):
        return False
    return "train" in sig.parameters


def classifier_loss(model, x, y, train: bool = True, mutable=None):
    """Softmax cross-entropy and accuracy of an ``(x, y)`` classifier, in
    the step-factory loss signature ``loss_fn(model, x, y, train,
    mutable) -> (loss, (acc, new_vars))``. ``train`` reaches every model
    whose ``forward`` takes it; the batch statistics a train-mode forward
    updates live in the model, so ``new_vars`` is empty."""
    del mutable
    logits = model(x, train=train) if _accepts_train(model) else model(x)
    loss = F.cross_entropy(logits.float(), y.long())
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, (acc, {})


def make_data_parallel_train_step(model, optimizer, comm,
                                  loss_fn: Optional[Callable] = None,
                                  mutable=None, grad_accum: int = 1,
                                  remat: bool = False,
                                  with_rng: bool = False,
                                  scan_steps: int = 1):
    """Build ``step(x, y) -> {"main/loss", "main/accuracy"}``.

    ``optimizer`` should wrap the communicator
    (:func:`chainermn_torch.optimizers.create_multi_node_optimizer`);
    each rank passes its own batch. ``mutable`` is ``("batch_stats",)``
    for a model with batch norm (see the module docstring) and None
    otherwise; ``with_rng`` (dropout) waits for the dropout slice
    (ROADMAP.md queue 1 item 7)."""
    bns = batch_norm_layers(model)
    if mutable:
        if tuple(mutable) != ("batch_stats",):
            raise ValueError(f"the port's one mutable collection is "
                             f"'batch_stats', got {tuple(mutable)}")
    elif bns:
        raise ValueError("the model has batch statistics: pass "
                         "mutable=('batch_stats',), as the JAX step needs")
    if with_rng:
        raise NotImplementedError(
            "with_rng waits for the dropout slice of the port (ROADMAP.md "
            "queue 1)")
    if grad_accum < 1 or scan_steps < 1:
        raise ValueError("grad_accum and scan_steps must be >= 1")
    lf = loss_fn or classifier_loss
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    # the per-replica statistics the JAX step pmeans
    varying = [t for m in bns if m.comm is None
               for t in (m.running_mean, m.running_var)]

    def recompute_contexts():
        return contextlib.nullcontext(), frozen_batch_stats(model)

    def loss_of(x, y):
        if remat:
            return checkpoint(
                lambda a, b: lf(model, a, b, train=True, mutable=mutable),
                x, y, use_reentrant=False, context_fn=recompute_contexts)
        return lf(model, x, y, train=True, mutable=mutable)

    def one_step(x, y):
        optimizer.zero_grad(set_to_none=True)
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        loss_sum = acc_sum = 0.0
        for xi, yi in zip(x.chunk(grad_accum), y.chunk(grad_accum)):
            loss, (acc, _) = loss_of(xi, yi)
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
            acc_sum = acc_sum + acc.detach().float()
        if grad_accum > 1:
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        optimizer.step()
        if varying:
            allreduce_persistent(varying, comm)
        return comm.allreduce(torch.stack([loss_sum, acc_sum]) / grad_accum,
                              "mean")

    def step(x, y) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device)
        if scan_steps > 1:
            if x.shape[0] != scan_steps or y.shape[0] != scan_steps:
                raise ValueError(f"scan_steps={scan_steps} needs inputs "
                                 f"with a leading axis of {scan_steps}")
            m = torch.stack([one_step(x[i], y[i])
                             for i in range(scan_steps)])
            return {"main/loss": m[:, 0], "main/accuracy": m[:, 1]}
        m = one_step(x, y)
        return {"main/loss": m[0], "main/accuracy": m[1]}

    return step


def make_eval_step(model, comm, loss_fn: Optional[Callable] = None):
    """Build ``eval_step(x, y) -> {"validation/main/loss",
    "validation/main/accuracy"}``: ``loss_fn`` (default
    :func:`classifier_loss`) with ``train=False`` (a batch-norm model
    normalises with its running statistics) on this rank's batch,
    without gradients, each metric the mean over ranks. The metrics stay
    on the device."""
    lf = loss_fn or classifier_loss
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(x, y) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device)
        loss, (acc, _) = lf(model, x, y, train=False)
        m = comm.allreduce(torch.stack([loss.float(), acc.float()]), "mean")
        return {"validation/main/loss": m[0],
                "validation/main/accuracy": m[1]}

    return eval_step
