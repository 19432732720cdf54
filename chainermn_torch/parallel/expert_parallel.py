"""Expert parallelism: a Switch / GShard mixture-of-experts FFN with its
experts split over the ranks of a communicator.

Counterpart of ``chainermn_tpu/parallel/expert_parallel.py``: dispatch
with a static per-expert ``capacity`` (tokens past it are dropped, the
Switch discipline), one all-to-all each way over the expert axis, and the
experts' FFN as a batched product over ``[experts_local, n·capacity, d]``.
The dispatch and combine tensors are JAX's bit for bit on the same router
probabilities: first-index argmax, exact int32 queue positions, and
one-hot rows that are zero for an index out of range (``jax.nn.one_hot``).

Both token shuffles are the port's differentiable ``alltoall``
(:func:`chainermn_torch.functions.alltoall`), which splits the leading
axis as ``lax.all_to_all(split_axis=0, concat_axis=0)`` does; its
backward is the reverse exchange, so an expert's gradient gathers every
rank's tokens. The router is replicated (give it the same values on every
rank and sum its gradient over the ranks:
``training.make_expert_parallel_train_step``); the expert tables
``w1``/``b1``/``w2``/``b2`` are this rank's, in flax's layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.functions import alltoall
from chainermn_torch.models.mlp import lecun_normal_
from chainermn_torch.parallel.tensor_parallel import _gelu

__all__ = ["switch_dispatch", "topk_dispatch", "ExpertParallelMLP"]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _aux(onehot: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch's load-balancing loss: experts · Σ fraction · mean prob."""
    e = probs.shape[-1]
    return e * torch.sum(onehot.mean(0) * probs.mean(0))


def switch_dispatch(router_probs: torch.Tensor, capacity: int):
    """Top-1 dispatch and combine with a static per-expert capacity.

    ``router_probs``: ``[tokens, experts]``. Returns ``(dispatch,
    combine, aux_loss)``: ``dispatch`` a 0/1 ``[tokens, experts,
    capacity]`` routing tensor, ``combine`` it scaled by each token's
    gate, ``aux_loss`` the load-balancing term."""
    t, e = router_probs.shape
    dtype = router_probs.dtype
    expert_idx = router_probs.argmax(-1)        # first index on ties
    gate = router_probs.gather(-1, expert_idx[:, None])[:, 0]
    onehot = _one_hot(expert_idx, e, dtype)
    # 1-based arrival position in the expert's queue, exact in int32
    onehot_i = _one_hot(expert_idx, e, torch.int32)
    pos = torch.cumsum(onehot_i, 0, dtype=torch.int32) * onehot_i
    keep = (pos > 0) & (pos <= capacity)
    slot = _one_hot(pos.sum(-1) - 1, capacity, dtype)
    dispatch = (onehot * keep.to(dtype))[:, :, None] * slot[:, None, :]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, _aux(onehot, router_probs)


def topk_dispatch(router_probs: torch.Tensor, capacity: int, k: int = 2):
    """GShard top-k dispatch and combine with a static capacity. ``k=1``
    is :func:`switch_dispatch`. For ``k >= 2`` each token goes to its k
    best experts; every token's rank-0 booking fills the queues before
    any rank-1 booking (GShard priority); combine weights are the chosen
    probabilities over their sum (+1e-9); aux is Switch's loss on the
    rank-0 assignments."""
    if k == 1:
        return switch_dispatch(router_probs, capacity)
    t, e = router_probs.shape
    dtype = router_probs.dtype
    probs_left = router_probs
    masks, gates = [], []
    for _ in range(k):
        idx = probs_left.argmax(-1)
        m = _one_hot(idx, e, torch.int32)
        gates.append(router_probs.gather(-1, idx[:, None])[:, 0])
        masks.append(m)
        probs_left = probs_left * (1 - m.to(dtype))
    dispatch = torch.zeros((t, e, capacity), dtype=dtype,
                           device=router_probs.device)
    combine = torch.zeros_like(dispatch)
    denom = sum(gates) + 1e-9
    offset = torch.zeros(e, dtype=torch.int32, device=router_probs.device)
    for r in range(k):
        m = masks[r]
        pos = (torch.cumsum(m, 0, dtype=torch.int32) + offset[None]) * m
        offset = offset + m.sum(0, dtype=torch.int32)
        keep = ((pos > 0) & (pos <= capacity)).to(dtype)
        slot = _one_hot(pos.sum(-1) - 1, capacity, dtype)
        d_r = (m.to(dtype) * keep)[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d_r
        combine = combine + d_r * (gates[r] / denom)[:, None, None]
    return dispatch, combine, _aux(masks[0].to(dtype), router_probs)


class ExpertParallelMLP(nn.Module):
    """Mixture-of-experts FFN with ``experts_per_device`` experts on each
    rank of ``comm`` (``comm.size · experts_per_device`` in all).

    Takes ``x`` ``[tokens, d]`` (this rank's tokens) and returns ``(y,
    aux_loss)``: each token's combined expert outputs (zero for a token
    every chosen expert dropped, the Switch convention: pair it with a
    residual) and the load-balancing term in f32. ``router`` is an
    ``nn.Linear`` without bias (flax's ``router`` Dense); ``w1 [e, d, h]``,
    ``b1 [e, h]``, ``w2 [e, h, d]``, ``b2 [e, d]`` are this rank's
    experts."""

    def __init__(self, d_model: int, hidden: int, comm,
                 experts_per_device: int = 1, capacity_factor: float = 1.25,
                 top_k: int = 1, act: Callable = _gelu,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.comm = comm
        self.experts_per_device = experts_per_device
        self.capacity_factor, self.top_k = capacity_factor, top_k
        self.act, self.dtype = act, dtype
        e_tot = comm.size * experts_per_device
        el = experts_per_device
        self.router = nn.Linear(d_model, e_tot, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(el, d_model, hidden,
                                           device=device))
        self.b1 = nn.Parameter(torch.zeros(el, hidden, device=device))
        self.w2 = nn.Parameter(torch.empty(el, hidden, d_model,
                                           device=device))
        self.b2 = nn.Parameter(torch.zeros(el, d_model, device=device))
        self.reset_experts()

    def reset_experts(self, generator: Optional[torch.Generator] = None):
        """Draw this rank's expert tables (lecun-normal kernels, zero
        biases), from ``generator`` where given."""
        # flax's fan-in of a [e, in, out] kernel counts e as a receptive
        # field: e · in
        for w in (self.w1, self.w2):
            lecun_normal_(w, w.shape[0] * w.shape[1], generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def capacity(self, tokens: int) -> int:
        """The static per-expert capacity for ``tokens`` tokens a rank
        (JAX's expression, in Python floats)."""
        e_tot = self.comm.size * self.experts_per_device
        return max(1, int(tokens * self.capacity_factor * self.top_k
                          / e_tot))

    def route(self, x: torch.Tensor):
        """``(dispatch, combine, aux)`` of this rank's tokens ``x``."""
        w = self.router.weight
        cdt = (self.dtype if self.dtype is not None
               else torch.promote_types(x.dtype, w.dtype))
        logits = F.linear(x.to(cdt), w.to(cdt))
        probs = torch.softmax(logits.float(), dim=-1)
        return topk_dispatch(probs, self.capacity(x.shape[0]), self.top_k)

    def forward(self, x):
        n, el = self.comm.size, self.experts_per_device
        t, d = x.shape
        dispatch, combine, aux = self.route(x)
        c = dispatch.shape[-1]
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        # [t, e_tot, c] x [t, d] -> [e_tot, c, d]; then every rank holds
        # all ranks' tokens for its own experts
        exp_in = torch.einsum("tec,td->ecd", dispatch, x)
        exp_in = alltoall(self.comm, exp_in.reshape(n, el, c, d))
        exp_in = exp_in.transpose(0, 1).reshape(el, n * c, d)
        cdt = self.dtype or exp_in.dtype
        h = self.act(torch.einsum("end,edh->enh", exp_in.to(cdt),
                                  self.w1.to(cdt))
                     + self.b1[:, None, :].to(cdt))
        exp_out = (torch.einsum("enh,ehd->end", h, self.w2.to(cdt))
                   + self.b2[:, None, :].to(cdt))
        # back to the ranks that own the tokens
        exp_out = exp_out.reshape(el, n, c, d).transpose(0, 1).contiguous()
        exp_out = alltoall(self.comm, exp_out).reshape(n * el, c, d)
        y = torch.einsum("tec,ecd->td", combine, exp_out.to(x.dtype))
        return y, aux.float()
