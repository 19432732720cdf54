"""The port's LARS and LAMB (``chainermn_torch/optimizers/large_batch.py``)
against ``optax.lars`` and ``optax.lamb`` step by step.

A tree of four leaves (a matrix, a vector, a 4-D kernel and an all-zero
vector, whose trust ratio is 1) takes 5 updates from seeded gradients,
with a constant learning rate and with optax's warm-up cosine schedule
(``lr`` a callable of the count, and a float driven by ``LambdaLR`` as
the ImageNet example drives it), with and without weight decay, and
Nesterov LARS. Tolerance: rtol and atol 1e-6 on every parameter after
every step (the same f32 arithmetic, LAMB's bias correction rounded as
optax rounds it; the norms sum in another order).
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from chainermn_torch.optimizers import LAMB, LARS

SHAPES = [(5, 3), (7,), (2, 3, 3, 2), (4,)]
STEPS = 5


def _tree():
    rs = np.random.RandomState(0)
    leaves = [rs.randn(*s).astype(np.float32) for s in SHAPES[:-1]]
    return leaves + [np.zeros(SHAPES[-1], np.float32)]


def _grads():
    rs = np.random.RandomState(1)
    return [[(rs.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
            for _ in range(STEPS)]


def _schedule(kind):
    if kind == "constant":
        return 0.1
    return optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, STEPS)


def _port_lr(kind, how):
    """The port's ``lr``: a float (constant, or the peak that ``LambdaLR``
    scales), or the schedule as a callable of the count."""
    if how != "callable":
        return 0.1
    sched = _schedule(kind)
    return lambda count: float(sched(count))


CASES = [
    ("lars", dict(weight_decay=1e-4, momentum=0.9)),
    ("lars", dict(weight_decay=0.0, momentum=0.9, nesterov=True)),
    ("lamb", dict(weight_decay=1e-4)),
    ("lamb", dict()),
]


@pytest.mark.parametrize("kind,how", [
    ("constant", "float"), ("warmup_cosine", "callable"),
    ("warmup_cosine", "lambda_lr")])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=["lars", "lars-nesterov", "lamb", "lamb-no-wd"])
def test_matches_optax_step_by_step(name, kw, kind, how):
    tx = (optax.lars if name == "lars" else optax.lamb)(_schedule(kind),
                                                         **kw)
    params = [jnp.asarray(x) for x in _tree()]
    state = tx.init(params)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in _tree()]
    opt = (LARS if name == "lars" else LAMB)(ps, _port_lr(kind, how), **kw)
    sched = None
    if how == "lambda_lr":
        f = _schedule(kind)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: float(f(count)) / 0.1)
    for i, gs in enumerate(_grads()):
        updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                   params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        if sched is not None:
            sched.step()
        for j, (p, want) in enumerate(zip(ps, params)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i} leaf {j}")


def test_lars_puts_the_learning_rate_before_the_momentum_trace():
    """Under a schedule, LARS's trace sums lr-scaled updates (optax's
    order): step 2 moves by lr_2·u_2 + 0.9·lr_1·u_1, where torch SGD's
    order (the trace of raw updates, scaled by the current lr) would move
    by lr_2·(u_2 + 0.9·u_1)."""
    lrs = [1.0, 0.5]
    p = torch.nn.Parameter(torch.ones(3))
    opt = LARS([p], lambda count: lrs[count], trust_coefficient=1.0)
    g = torch.tensor([1.0, 2.0, 2.0])
    steps = []
    for _ in range(2):
        before = p.detach().clone()
        u = g * (before.norm() / g.norm()).item()   # the trust ratio
        steps.append(u)
        p.grad = g.clone()
        opt.step()
    moved = p.detach() - before
    torch.testing.assert_close(moved, -lrs[1] * steps[1]
                               - 0.9 * lrs[0] * steps[0])
    assert not torch.allclose(moved, -lrs[1] * (steps[1] + 0.9 * steps[0]))


@pytest.mark.parametrize("cls", [LARS, LAMB])
def test_state_dict_round_trip_continues_the_run(cls):
    """A fresh optimizer loaded from ``state_dict`` after 2 steps takes
    steps 3-5 bit for bit as the uninterrupted one."""
    gs = _grads()
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in _tree()]
    opt = cls(ps, 0.1, weight_decay=1e-4)
    saved = None
    for i, g in enumerate(gs):
        if i == 2:
            saved = ([p.detach().clone() for p in ps],
                     copy.deepcopy(opt.state_dict()))
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        assert all(torch.isfinite(p).all().item() for p in ps)
    qs = [torch.nn.Parameter(t.clone()) for t in saved[0]]
    opt2 = cls(qs, 0.1, weight_decay=1e-4)
    opt2.load_state_dict(saved[1])
    for g in gs[2:]:
        for q, x in zip(qs, g):
            q.grad = torch.from_numpy(x.copy())
        opt2.step()
        assert all(torch.isfinite(q).all().item() for q in qs)
    for p, q in zip(ps, qs):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
