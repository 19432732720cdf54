"""Flash attention: the hand-written Hopper kernels and their plain
PyTorch versions, forward and backward.

Counterpart of ``chainermn_tpu/ops/flash_attention.py``
(``flash_attention`` with ``_flash_fwd`` / ``_fa_kernel`` forward and
``_flash_bwd`` / ``_flash_bwd_3d`` backward), in the ``blhd`` layout:
q ``[B, Lq, Hq, D]``, k/v ``[B, Lk, Hkv, D]`` → out ``[B, Lq, Hq, D]``
in q's dtype and lse ``[B, Hq, Lq]`` f32. The backward returns dq, dk and
dv in the inputs' dtypes, dk/dv summed over each GQA group.

Semantics carried over from the TPU kernel:

* causal masking with top-left aligned indices (row i sees columns
  <= i, whatever Lq and Lk are);
* a sliding ``window`` (requires causal): row i sees columns
  ``i - window < j <= i``;
* GQA/MQA: query head h reads KV head ``h // (Hq // Hkv)``
  (repeat-interleave), K/V never repeated in memory by the kernel;
* ``segment_ids``: an int tensor ``[B, L]`` (self-attention) or a
  ``(q_seg [B, Lq], kv_seg [B, Lk])`` pair; a row that matches no key
  gives exactly zero output and lse -1e30;
* Q·Kᵀ from native-dtype operands with f32 accumulation, P cast to V's
  dtype before P·V, softmax state in f32;
* backward: P rebuilt from lse, dS = P∘(dP − D)·scale with
  D = rowsum(dO∘O) in f32, P cast to dO's dtype before Pᵀ·dO and dS to
  the inputs' dtype before dSᵀ·Q and dS·K; a row that matches no key
  gets exactly zero gradient.

TPU tiling rules (``_fit_block``, ``_padded_len``, the 128-lane scratch)
have no counterpart: the CUDA kernels mask ragged lengths themselves.
Both kernels take every head dim that is a multiple of 8 up to 128, in
float32 (CUDA-core FMAs, exact to f32 rounding) and bfloat16 (tensor
cores: ``mma.sync`` fed by ``ldmatrix`` and a ``cp.async`` ring, the head
dim padded to a multiple of 16 in shared memory).

:func:`flash_attention` returns through a ``torch.autograd.Function``
that dispatches on the tensors' device: CUDA tensors go to the kernels
(``csrc/flash_fwd.cu`` forward, ``csrc/flash_bwd.cu`` backward), CPU
tensors to :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`. A CUDA launch that fails
raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chainermn_torch.ops import _cuda

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_cuda", "flash_attention_backward_reference",
           "flash_attention_bwd_cuda"]

NEG_INF = -1e30  # finite stand-in for -inf, as in the TPU kernel


def _norm_segments(segment_ids, lq: int, lk: int):
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        qs, ks = segment_ids
    else:
        if lq != lk:
            raise ValueError(
                "a single segment_ids tensor needs Lq == Lk; pass a "
                "(q_seg, kv_seg) pair for cross-attention")
        qs = ks = segment_ids
    return qs, ks


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not share batch and head dim")
    if hq % k.shape[2]:
        raise ValueError(f"query heads ({hq}) must be a multiple of kv "
                         f"heads ({k.shape[2]})")
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")


def _scores(q, k, causal, scale, segment_ids, window):
    """Scaled f32 scores ``[B, Hq, Lq, Lk]`` (masked entries at the finite
    -1e30) and the keep mask that both plain versions share."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, lq, hkv, hq // hkv, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float()) * scale
    s = s.reshape(b, hq, lq, lk)
    rows = torch.arange(lq, device=q.device)[:, None]
    cols = torch.arange(lk, device=q.device)[None, :]
    keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        keep = cols <= rows
        if window is not None:
            keep = keep & (rows - cols < window)
    keep = keep[None, None]
    qs, ks = _norm_segments(segment_ids, lq, lk)
    if qs is not None:
        keep = keep & (qs.to(q.device)[:, None, :, None]
                       == ks.to(q.device)[:, None, None, :])
    return torch.where(keep, s, torch.full_like(s, NEG_INF)), keep


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              segment_ids=None,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward with the kernel's arithmetic: one dense
    softmax pass instead of the tiled online one (equal up to f32
    rounding). Returns ``(out, lse)``."""
    _check(q, k, v, causal, window)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s, keep = _scores(q, k, causal, scale, segment_ids, window)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = p.to(v.dtype).float().reshape(b, hkv, g, lq, lk)
    o = torch.einsum("bkgqc,bckd->bqkgd", pv, v.float())
    out = (o.reshape(b, lq, hq, d)
           / denom.reshape(b, hq, lq).transpose(1, 2)[..., None])
    lse = (m + torch.log(denom)).reshape(b, hq, lq)
    return out.to(q.dtype), lse


def _aligned(x: torch.Tensor) -> bool:
    """The kernels copy rows 16 bytes at a time (``cp.async`` for bf16,
    float4 loads for f32), so they read a tensor in place only if its last
    dim is contiguous, its base is 16-byte aligned and every other stride
    is a multiple of 16 bytes: 8 bf16 or 4 f32 elements."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s * x.element_size() % 16 == 0
                    for s in x.stride()[:-1]))


def flash_attention_cuda(q, k, v, causal: bool = False,
                         scale: Optional[float] = None, segment_ids=None,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream. Returns
    ``(out, lse)``; raises on tensors or shapes the kernel does not
    take and on a failed launch."""
    _check(q, k, v, causal, window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if (q.dtype not in _cuda.DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if d % 8 or d > 128:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 128")
    scale = d ** -0.5 if scale is None else float(scale)
    if scale < 0:
        # the kernel folds the scale into its exponent and needs it >= 0:
        # (-q)·kᵀ·|scale| gives the same logits, exactly
        q, scale = -q, -scale
    # an unaligned view (rare: an odd slice) is copied; the model's q/k/v
    # are read in place
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    qs, ks = _segments_i32(segment_ids, b, lq, lk, q.device)
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    _cuda.launch_flash_fwd(q, k, v, out, lse, qs, ks, scale, causal,
                           0 if window is None else int(window))
    return out, lse


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal: bool = False,
                                       scale: Optional[float] = None,
                                       segment_ids=None,
                                       window: Optional[int] = None):
    """Plain PyTorch backward with the kernel's arithmetic (the TPU
    ``_flash_bwd``): P rebuilt from ``lse``, D = rowsum(dO∘O) in f32,
    dS = P∘(dP − D)·scale, GQA groups summed into ``[B, Lk, Hkv, D]``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    _check(q, k, v, causal, window)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    s, keep = _scores(q, k, causal, scale, segment_ids, window)
    p = torch.where(keep, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))                  # [b, hq, lq, lk]
    p5 = p.reshape(b, hkv, g, lq, lk)
    do5 = dout.float().reshape(b, lq, hkv, g, d)
    dp = torch.einsum("bqkgd,bckd->bkgqc", do5, v.float())
    dr = (dout.float() * out.float()).sum(-1)             # [b, lq, hq]
    dr5 = dr.transpose(1, 2).reshape(b, hkv, g, lq, 1)
    ds = p5 * (dp - dr5) * scale
    pv = p5.to(dout.dtype).float()
    dsq = ds.to(q.dtype).float()
    dv = torch.einsum("bkgqc,bqkgd->bckd", pv, do5)
    dk = torch.einsum("bkgqc,bqkgd->bckd", dsq,
                      q.float().reshape(b, lq, hkv, g, d))
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds.to(k.dtype).float(), k.float())
    return (dq.reshape(b, lq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _segments_i32(segment_ids, b, lq, lk, device):
    qs, ks = _norm_segments(segment_ids, lq, lk)
    if qs is None:
        return None, None
    qs = qs.to(device=device, dtype=torch.int32).contiguous()
    ks = ks.to(device=device, dtype=torch.int32).contiguous()
    if qs.shape != (b, lq) or ks.shape != (b, lk):
        raise ValueError("segment ids must be [B, Lq] and [B, Lk]")
    return qs, ks


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = False,
                             scale: Optional[float] = None,
                             segment_ids=None,
                             window: Optional[int] = None):
    """Launch ``csrc/flash_bwd.cu`` on the current stream. Returns
    ``(dq, dk, dv)``; raises on tensors the kernel does not take and on a
    failed launch. D = rowsum(dO∘O) is computed here in f32, as the TPU
    path computes it outside its kernel; dq is summed in an f32 buffer
    and cast once."""
    _check(q, k, v, causal, window)
    tensors = (q, k, v, out, dout)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("flash_attention_bwd_cuda needs CUDA tensors")
    if q.dtype not in _cuda.DTYPES or any(
            x.dtype != q.dtype for x in tensors):
        raise TypeError(f"flash backward takes float32 or bfloat16 tensors "
                        f"of one dtype, got {[x.dtype for x in tensors]}")
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if d % 8 or d > 128:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 128")
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    q, k, v, dout = (x if _aligned(x) else x.contiguous()
                     for x in (q, k, v, dout))
    qs, ks = _segments_i32(segment_ids, b, lq, lk, q.device)
    dr = ((dout.float() * out.float()).sum(-1).transpose(1, 2)
          .contiguous())                                  # [b, hq, lq]
    lse = lse.float().contiguous()
    dq_acc = torch.zeros((b, lq, hq, d), dtype=torch.float32,
                         device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, hkv, d), dtype=v.dtype, device=q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    _cuda.launch_flash_bwd(q, k, v, dout, lse, dr, qs, ks, dq_acc, dk, dv,
                           scale, causal,
                           0 if window is None else int(window))
    return dq_acc.to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward of flash attention, each a kernel on CUDA
    tensors and the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, segment_ids, window):
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, causal, scale,
                                            segment_ids, window)
        elif q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, causal, scale,
                                                 segment_ids, window)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, segment_ids, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  *ctx.args)
        else:
            dq, dk, dv = flash_attention_backward_reference(
                q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention → out, differentiable in q, k and v. CUDA
    tensors run the hand-written kernels, CPU tensors the plain
    versions."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check(q, k, v, causal, window)
    return _FlashAttention.apply(q, k, v, causal, scale, segment_ids,
                                 window)
