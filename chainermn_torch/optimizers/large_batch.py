"""LARS and LAMB, the large-batch optimizers, to optax's update rules.

The JAX package's ImageNet example calls ``optax.lars(lr,
weight_decay=1e-4, momentum=0.9)`` and ``optax.lamb(lr,
weight_decay=1e-4)`` (``examples/imagenet/train_imagenet.py:188-191``);
torch ships neither, so both are written here as ``torch.optim``
optimizers that follow optax's chains (``optax/_src/alias.py`` ``lars``,
``lamb``) with optax's defaults, each parameter one optax leaf:

* :class:`LARS`: ``add_decayed_weights(wd)`` → ``scale_by_trust_ratio(
  trust_coefficient, eps)`` → ``scale_by_learning_rate`` → ``trace(
  momentum, nesterov)``. The learning rate enters BEFORE the momentum
  trace, which is not where ``torch.optim.SGD`` puts it: under a schedule
  the two differ from the second step on.
* :class:`LAMB`: ``scale_by_adam(b1, b2, eps, eps_root)`` (bias-corrected
  as optax corrects, in f32: ``1 − f32(b)^count``) → ``+ wd·p`` →
  ``scale_by_trust_ratio()`` (coefficient 1) → ``−lr``.

The trust ratio of a leaf is ``coef·‖p‖ / (‖u‖ + eps)``, and 1 where
either norm is 0. Norms do not depend on a leaf's layout, so a
convolution's OIHW kernel gives the ratio of flax's HWIO one. ``lr`` is a
float (a ``torch.optim.lr_scheduler`` may drive it, as for SGD) or, as in
optax, a callable of the update count, evaluated before the count is
incremented (0 for the first update). The count is each parameter's
``step`` in :attr:`state`, which is the optax count when every parameter
takes part in every update (the multi-node wrapper gives each a gradient;
a parameter whose ``.grad`` is None is skipped, as torch's optimizers
skip it).

Both couple the elements of a leaf through its norms, so the ZeRO steps'
probe refuses them (``chainermn_torch/optimizers/zero.py``), as JAX's
refuses optax's.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

__all__ = ["LARS", "LAMB"]

LR = Union[float, Callable[[int], float]]


def _lr(group, count: int) -> float:
    lr = group["lr"]
    return float(lr(count)) if callable(lr) else lr


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, computed as it computes it: in f32,
    from ``decay`` rounded to f32 (0.999 is 0.99900001 there, which moves
    the first step's second moment by 1.3e-5 of itself)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _norms(ts) -> torch.Tensor:
    """Each tensor's L2 norm, stacked (no host synchronisation). On the
    card one ``_foreach_norm`` (f32, summed in a tree); on the CPU each
    norm accumulates in f64, since torch's f32 norm there drifts over a
    leaf of millions of elements (the ResNet-50 head misses optax's ratio
    by more than 1e-6), where XLA sums in pairs."""
    if ts[0].device.type == "cpu":
        return torch.stack([torch.linalg.vector_norm(
            t, dtype=torch.float64).to(t.dtype) for t in ts])
    return torch.stack(torch._foreach_norm(ts))


def _trust_ratios(ps, us, coef: float, eps: float):
    """optax ``scale_by_trust_ratio``'s factor for each leaf, as 0-d
    tensors: ``coef·‖p‖/(‖u‖+eps)``, 1 where either norm is 0."""
    pn, un = _norms(ps), _norms(us)
    ratio = coef * pn / (un + eps)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio),
                       ratio).unbind()


def _with_grads(group, state, init):
    """A group's parameters that have a gradient, their gradients and
    states (made by ``init`` on a parameter's first update)."""
    ps = [p for p in group["params"] if p.grad is not None]
    for p in ps:
        if not state[p]:
            state[p].update(init(p))
    return ps, [p.grad for p in ps], [state[p] for p in ps]


class LARS(torch.optim.Optimizer):
    """optax's ``lars`` (module docstring): ``weight_decay`` 0,
    ``trust_coefficient`` 0.001, ``eps`` 0, ``momentum`` 0.9, ``nesterov``
    False by default, and every leaf decayed and trust-scaled (optax's
    masks default to all)."""

    def __init__(self, params, lr: LR, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001, eps: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay,
            trust_coefficient=trust_coefficient, eps=eps,
            momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps, gs, sts = _with_grads(group, self.state, lambda p: dict(
                step=0, trace=torch.zeros_like(p)))
            if not ps:
                continue
            us = torch._foreach_add(gs, ps, alpha=group["weight_decay"])
            torch._foreach_mul_(us, _trust_ratios(
                ps, us, group["trust_coefficient"], group["eps"]))
            torch._foreach_mul_(us, [-_lr(group, st["step"]) for st in sts])
            traces = [st["trace"] for st in sts]
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, us)
            if group["nesterov"]:
                torch._foreach_add_(us, traces, alpha=group["momentum"])
                torch._foreach_add_(ps, us)
            else:
                torch._foreach_add_(ps, traces)
            for st in sts:
                st["step"] += 1
        return loss


class LAMB(torch.optim.Optimizer):
    """optax's ``lamb`` (module docstring): ``b1`` 0.9, ``b2`` 0.999,
    ``eps`` 1e-6, ``eps_root`` 0, ``weight_decay`` 0 by default."""

    def __init__(self, params, lr: LR, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            ps, gs, sts = _with_grads(group, self.state, lambda p: dict(
                step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p)))
            if not ps:
                continue
            mus = [st["mu"] for st in sts]
            nus = [st["nu"] for st in sts]
            # optax update_moment: (1 - decay) * g + decay * m
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            counts = [st["step"] + 1 for st in sts]
            mu_hat = torch._foreach_div(
                mus, [_bias_correction(b1, c) for c in counts])
            nu_hat = torch._foreach_div(
                nus, [_bias_correction(b2, c) for c in counts])
            torch._foreach_add_(nu_hat, group["eps_root"])
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, group["eps"])
            us = torch._foreach_div(mu_hat, nu_hat)
            torch._foreach_add_(us, torch._foreach_mul(
                ps, group["weight_decay"]))
            torch._foreach_mul_(us, _trust_ratios(ps, us, 1.0, 0.0))
            torch._foreach_mul_(us, [-_lr(group, st["step"]) for st in sts])
            torch._foreach_add_(ps, us)
            for st, c in zip(sts, counts):
                st["step"] = c
        return loss
