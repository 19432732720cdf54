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

``with_rng=True`` (dropout) makes the signature ``step(x, y, rng)``
with ``rng`` an int key, as the JAX step's ``step(state, x, y, rng)``
takes a PRNGKey. Each rank folds its rank into the key, and each
micro-step its index (``grad_accum``; under ``scan_steps`` the inner
step's index first), with :func:`chainermn_torch.ops.dropout.fold_in`, so
masks differ across ranks and micro-steps and repeat for the same
``rng``. The loss gets the key as ``rng=`` and passes it to the model;
the model's dropout seeds a generator on its device from it per site, so
a ``remat`` recomputation draws the same masks.

``init_expert_parallel_state`` and ``make_expert_parallel_train_step``
are the counterparts of JAX's for models with expert-parallel (MoE)
layers: each rank draws its own experts and takes rank 0's shared
leaves; the step backpropagates ``loss / n`` on every rank, sums the
shared leaves' gradients over the ranks (shard_map's replication typing
in JAX: the router among them), leaves the experts' alone (the
all-to-all's backward already brought every rank's tokens home) and runs
a plain optimizer.

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
from chainermn_torch.ops.dropout import fold_in

__all__ = ["classifier_loss", "make_data_parallel_train_step",
           "make_eval_step", "init_expert_parallel_state",
           "make_expert_parallel_train_step"]


def _accepts(model, name: str) -> bool:
    """Whether ``model``'s ``forward`` declares ``name`` (``train``: batch
    norm and dropout models; ``rng``: dropout models), as the JAX
    ``_accepts_train`` asks of ``__call__``."""
    try:
        sig = inspect.signature(type(model).forward)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters


def classifier_loss(model, x, y, train: bool = True, mutable=None,
                    rng=None):
    """Softmax cross-entropy and accuracy of an ``(x, y)`` classifier, in
    the step-factory loss signature ``loss_fn(model, x, y, train,
    mutable) -> (loss, (acc, new_vars))``. ``train`` reaches every model
    whose ``forward`` takes it, and the dropout key ``rng`` every model
    whose ``forward`` takes ``rng`` (flax ignores rngs a model does not
    use); the batch statistics a train-mode forward updates live in the
    model, so ``new_vars`` is empty."""
    del mutable
    kw = {"train": train} if _accepts(model, "train") else {}
    if rng is not None and _accepts(model, "rng"):
        kw["rng"] = rng
    logits = model(x, **kw)
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
    otherwise; ``with_rng=True`` makes it ``step(x, y, rng)`` (dropout,
    see the module docstring)."""
    bns = batch_norm_layers(model)
    if mutable:
        if tuple(mutable) != ("batch_stats",):
            raise ValueError(f"the port's one mutable collection is "
                             f"'batch_stats', got {tuple(mutable)}")
    elif bns:
        raise ValueError("the model has batch statistics: pass "
                         "mutable=('batch_stats',), as the JAX step needs")
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

    def loss_of(x, y, key):
        kw = {} if key is None else {"rng": key}
        if remat:
            return checkpoint(
                lambda a, b: lf(model, a, b, train=True, mutable=mutable,
                                **kw),
                x, y, use_reentrant=False, context_fn=recompute_contexts)
        return lf(model, x, y, train=True, mutable=mutable, **kw)

    def one_step(x, y, key):
        optimizer.zero_grad(set_to_none=True)
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        if key is not None:
            key = fold_in(key, comm.rank)   # the JAX step's axis_index
        loss_sum = acc_sum = 0.0
        for i, (xi, yi) in enumerate(zip(x.chunk(grad_accum),
                                         y.chunk(grad_accum))):
            ki = key if key is None or grad_accum == 1 else fold_in(key, i)
            loss, (acc, _) = loss_of(xi, yi, ki)
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

    def step(x, y, *rng) -> Dict[str, torch.Tensor]:
        if len(rng) != int(with_rng):
            raise TypeError("step(x, y, rng) with with_rng=True, step(x, y) "
                            "without")
        key = int(rng[0]) if with_rng else None
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device)
        if scan_steps > 1:
            if x.shape[0] != scan_steps or y.shape[0] != scan_steps:
                raise ValueError(f"scan_steps={scan_steps} needs inputs "
                                 f"with a leading axis of {scan_steps}")
            m = torch.stack([
                one_step(x[i], y[i], None if key is None
                         else fold_in(key, i))
                for i in range(scan_steps)])
            return {"main/loss": m[:, 0], "main/accuracy": m[:, 1]}
        m = one_step(x, y, key)
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


def _is_expert_path(name: str, expert_key: str = "moe") -> bool:
    """True for a rank's own expert tables: a parameter under
    ``expert_key`` that is not the router (the router is replicated, a
    data-parallel parameter)."""
    parts = name.split(".")
    return (any(expert_key in p for p in parts)
            and not any("router" in p for p in parts))


def init_expert_parallel_state(model, comm, seed: int = 0,
                               expert_key: str = "moe") -> Dict[str, bool]:
    """Initialise a model with expert-parallel layers in place: each rank
    draws its own expert tables from a generator seeded with ``seed``
    folded with its rank (on the parameters' device), and every other
    leaf, the router among them, takes rank 0's values (``bcast_data``).
    Returns ``{parameter name: is a per-rank expert table}``, the
    counterpart of JAX's ``param_specs``."""
    from chainermn_torch.parallel import ExpertParallelMLP

    specs = {name: _is_expert_path(name, expert_key)
             for name, _ in model.named_parameters()}
    comm.bcast_data([p for name, p in model.named_parameters()
                     if not specs[name]])
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(
        fold_in(seed, comm.rank))
    for mod in model.modules():
        if isinstance(mod, ExpertParallelMLP):
            mod.reset_experts(gen)
    return specs


def make_expert_parallel_train_step(model, optimizer, comm,
                                    param_specs: Optional[Dict] = None,
                                    loss_fn: Optional[Callable] = None,
                                    expert_key: str = "moe"):
    """Build ``step(x, y) -> {"main/loss", "main/accuracy"}`` for a model
    with expert-parallel layers, each rank on its own batch.

    The objective is the mean of the ranks' losses: every rank
    backpropagates ``loss / n``; the shared parameters' gradients are
    summed over the ranks; the expert tables' gradients already hold
    every rank's tokens (the all-to-all's backward), so no collective
    touches them. ``optimizer`` is a PLAIN torch optimizer over the
    model's parameters (not ``create_multi_node_optimizer``, which would
    reduce again). ``param_specs`` is what
    :func:`init_expert_parallel_state` returns (None: from
    ``expert_key``). The metrics are the means over the ranks."""
    lf = loss_fn or classifier_loss
    specs = param_specs or {name: _is_expert_path(name, expert_key)
                            for name, _ in model.named_parameters()}
    shared = [p for name, p in model.named_parameters()
              if p.requires_grad and not specs[name]]
    device = next(model.parameters()).device
    n = comm.size

    def step(x, y) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device)
        optimizer.zero_grad(set_to_none=True)
        loss, (acc, _) = lf(model, x, y, train=True)
        (loss / n).backward()
        for p in shared:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        comm.allreduce_grad([p.grad for p in shared], "sum")
        optimizer.step()
        m = comm.allreduce(torch.stack([loss.detach().float(),
                                        acc.detach().float()]), "mean")
        return {"main/loss": m[0], "main/accuracy": m[1]}

    return step
