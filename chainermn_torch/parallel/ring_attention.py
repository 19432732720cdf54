"""Ring attention: sequence parallelism over the ranks of a communicator.

Counterpart of ``chainermn_tpu/parallel/ring_attention.py``. The sequence
is split over the ranks (``[B, L_local, H, D]`` each, rank r holding
positions ``[r·L_local, (r+1)·L_local)``); each rank keeps its query
block and the K/V blocks travel round the ring, rank i sending to i+1 and
receiving from i−1 (JAX's ``ppermute``), through
``DistributedCommunicator.exchange``, so NCCL and host-staged groups both
carry them. Causal masking works on global positions: a visiting block
from a later rank is skipped, the rank's own block is causal, an earlier
one fully visible.

* :func:`ring_attention`: the plain ring, online softmax over each
  visiting block in f32, differentiable through the ring shifts.
* :func:`ring_flash_attention`: the hand-written flash kernels as the
  per-block compute. One ``torch.autograd.Function`` spans the whole
  ring, as JAX's ``custom_vjp`` does (the merge weights depend on each
  block's log-sum-exp, which the block's own backward does not
  differentiate through). The forward runs ``flash_attention_cuda`` per
  visible block and merges ``(o, lse)`` in f32; the backward runs
  ``flash_attention_bwd_cuda`` per visible block with the GLOBAL output
  and lse (so D = rowsum(dO∘O) is the global one), and dk/dv accumulate
  in f32 and ride the ring home with their block. On CPU tensors the
  plain versions run instead.
* :func:`local_attention_reference`: single-device full attention, the
  oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_torch.comm.p2p import MAX_TAG
from chainermn_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_bwd_cuda,
    flash_attention_cuda, flash_attention_reference)

__all__ = ["ring_attention", "ring_flash_attention",
           "local_attention_reference"]

#: the ring's channels: blocks forward, their gradients back (the top of
#: the tag space, apart from user tags and the functions' channels)
RING_TAG = 2 * MAX_TAG - 2
RING_GRAD_TAG = 2 * MAX_TAG - 1


def _shift(comm, tensors, reverse: bool = False, tag: int = RING_TAG):
    """Send ``tensors`` one step round the ring (to rank+1, from rank−1;
    ``reverse``: the other way) and return what arrives."""
    n, r = comm.size, comm.rank
    if n == 1:
        return list(tensors)
    step = -1 if reverse else 1
    return comm.exchange(sends=[((r + step) % n, tag, list(tensors))],
                         recvs=[((r - step) % n, tag)])[0]


class _RingShift(torch.autograd.Function):
    """The tensors of rank−1, differentiably: the backward sends the
    gradients back the other way."""

    @staticmethod
    def forward(ctx, comm, *tensors):
        ctx.comm = comm
        return tuple(_shift(comm, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(ctx.comm, grads, reverse=True,
                              tag=RING_GRAD_TAG))


def _block_attend(q, k, v, scale, mask):
    """One (query block, KV block) pair in f32: the unnormalised numerator
    ``[B, Lq, H, D]``, the row max and row sum ``[B, Lq, H]`` (the max is
    -inf on a fully masked row, whose terms are zero)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m.transpose(1, 2), p.sum(-1).transpose(1, 2)


def _finite_exp(a, b):
    """exp(a − b) where a is finite, else 0 (JAX's ``jnp.where(
    jnp.isfinite(...))`` guards: a skipped block's -inf gives 0, not
    NaN)."""
    return torch.where(torch.isfinite(a), torch.exp(a - b),
                       torch.zeros_like(a))


def merge_block(o, lse, o_t, lse_t):
    """The streaming ``(o, lse)`` merge of ring-flash's forward: the f32
    running output ``o`` ``[B, L, H, D]`` and its lse ``[B, H, L]`` with
    one block's ``(o_t, lse_t)``, with JAX's weights exp(lse_* − lse_new).
    Returns the merged pair."""
    lse_new = torch.logaddexp(lse, lse_t)
    safe = torch.where(torch.isfinite(lse_new), lse_new,
                       torch.zeros_like(lse_new))
    w_old = _finite_exp(lse, safe).transpose(1, 2)[..., None]
    w_new = _finite_exp(lse_t, safe).transpose(1, 2)[..., None]
    return o * w_old + o_t.float() * w_new, lse_new


def ring_attention(q, k, v, comm, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence split on ``comm``'s ranks (the plain
    ring): q, k, v ``[B, L_local, H, D]`` on each rank → ``[B, L_local,
    H, D]`` in q's dtype."""
    n, my = comm.size, comm.rank
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    lq, lk = q.shape[1], k.shape[1]
    acc = q.new_zeros(q.shape, dtype=torch.float32)
    lsum = q.new_zeros(q.shape[:3], dtype=torch.float32)
    mrun = torch.full(q.shape[:3], float("-inf"), device=q.device)
    qf = q.float()
    k_cur, v_cur = k, v
    for t in range(n):
        src = (my - t) % n
        mask = None
        if causal:
            iq = my * lq + torch.arange(lq, device=q.device)[:, None]
            ik = src * lk + torch.arange(lk, device=q.device)[None, :]
            mask = ik <= iq
        # every block enters the graph, masked or not: each rank's
        # backward then runs every ring shift, as its peers' do
        o_t, m_t, l_t = _block_attend(qf, k_cur.float(), v_cur.float(),
                                      scale, mask)
        m_new = torch.maximum(mrun, m_t)
        alpha = _finite_exp(mrun, m_new)
        beta = _finite_exp(m_t, m_new)
        acc = acc * alpha[..., None] + o_t * beta[..., None]
        lsum = lsum * alpha + l_t * beta
        mrun = m_new
        if t < n - 1:
            k_cur, v_cur = _RingShift.apply(comm, k_cur, v_cur)
    return (acc / lsum[..., None].clamp_min(1e-30)).to(q.dtype)


def _visible(causal: bool, src: int, my: int):
    """The ring step's block: ``None`` (above the diagonal, skipped), or
    whether it runs causal (the diagonal)."""
    if not causal or src < my:
        return False
    return True if src == my else None


def _fwd(q, k, v, causal, scale):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, scale)
    return flash_attention_reference(q, k, v, causal, scale)


def _bwd(q, k, v, out, lse, g, causal, scale):
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, scale)
    return flash_attention_backward_reference(q, k, v, out, lse, g, causal,
                                              scale)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, causal, scale, q, k, v):
        n, my = comm.size, comm.rank
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((q.shape[0], q.shape[2], q.shape[1]),
                         float("-inf"), device=q.device)      # [B, H, L]
        k_cur, v_cur = k, v
        for t in range(n):
            vis = _visible(causal, (my - t) % n, my)
            if vis is not None:
                o, lse = merge_block(o, lse, *_fwd(q, k_cur, v_cur, vis,
                                                   scale))
            if t < n - 1:
                k_cur, v_cur = _shift(comm, (k_cur, v_cur))
        out = o.to(q.dtype)
        ctx.comm, ctx.causal, ctx.scale = comm, causal, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        comm, causal, scale = ctx.comm, ctx.causal, ctx.scale
        q, k, v, out, lse = ctx.saved_tensors
        n, my = comm.size, comm.rank
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for t in range(n):
            vis = _visible(causal, (my - t) % n, my)
            if vis is not None:
                dqt, dkt, dvt = _bwd(q, k_cur, v_cur, out, lse, g, vis,
                                     scale)
                dq += dqt.float()
                dk += dkt.float()
                dv += dvt.float()
            # the accumulators ride with their block; after n steps each
            # is home with its whole gradient
            if t < n - 1:
                k_cur, v_cur, dk, dv = _shift(comm, (k_cur, v_cur, dk, dv))
            else:
                dk, dv = _shift(comm, (dk, dv))
        return (None, None, None, dq.to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))


def ring_flash_attention(q, k, v, comm, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """:func:`ring_attention` with the flash kernels as the per-block
    compute (their plain versions on CPU tensors): q, k, v ``[B, L_local,
    H, D]`` on each rank, shards of equal size, ``k.shape == q.shape`` →
    ``[B, L_local, H, D]`` in q's dtype."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring shards must be equal-sized: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    return _RingFlash.apply(comm, causal, scale, q, k, v)


def local_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Single-device full attention in f32, out in q's dtype (the
    correctness oracle)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lk, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
