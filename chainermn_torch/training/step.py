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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["classifier_loss", "make_data_parallel_train_step"]


def classifier_loss(model, x, y, train: bool = True, mutable=None):
    """Softmax cross-entropy and accuracy of an ``(x, y)`` classifier, in
    the step-factory loss signature ``loss_fn(model, x, y, train,
    mutable) -> (loss, (acc, new_vars))``."""
    del train, mutable
    logits = model(x)
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
    each rank passes its own batch. ``mutable`` (batch-norm state) and
    ``with_rng`` (dropout) wait for the ResNet and dropout slices
    (ROADMAP.md queue 1)."""
    if mutable:
        raise NotImplementedError(
            "mutable collections wait for the ResNet-50 slice of the port "
            "(ROADMAP.md queue 1)")
    if with_rng:
        raise NotImplementedError(
            "with_rng waits for the dropout slice of the port (ROADMAP.md "
            "queue 1)")
    if grad_accum < 1 or scan_steps < 1:
        raise ValueError("grad_accum and scan_steps must be >= 1")
    lf = loss_fn or classifier_loss
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device

    def loss_of(x, y):
        if remat:
            return checkpoint(lambda a, b: lf(model, a, b, train=True), x,
                              y, use_reentrant=False)
        return lf(model, x, y, train=True)

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
