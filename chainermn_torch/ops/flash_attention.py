"""Flash-attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``chainermn_tpu/ops/flash_attention.py``'s forward
(``flash_attention`` / ``_flash_fwd`` / ``_fa_kernel``), in the serving
``blhd`` layout: q ``[B, Lq, Hq, D]``, k/v ``[B, Lk, Hkv, D]`` → out
``[B, Lq, Hq, D]`` in q's dtype and lse ``[B, Hq, Lq]`` f32.

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
  dtype before P·V, softmax state in f32.

TPU tiling rules (``_fit_block``, ``_padded_len``, the 128-lane scratch)
have no counterpart: the CUDA kernel masks ragged lengths itself.

:func:`flash_attention` dispatches on the tensors' device: CUDA tensors
go to the kernel (``csrc/flash_fwd.cu``), CPU tensors to
:func:`flash_attention_reference`. A CUDA launch that fails raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chainermn_torch.ops import _cuda

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_cuda"]

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
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, lq, hkv, g, d)
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
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
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
    """The kernel's vector loads need 16-byte aligned rows: a contiguous
    last dim and every other stride a multiple of 4 elements."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in x.stride()[:-1]))


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
    if (q.dtype not in _cuda.FLASH_DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if d % 8 or d > 128:
        raise ValueError(f"head dim {d} must be a multiple of 8, <= 128")
    # an unaligned view (rare: an odd slice) is copied; the model's q/k/v
    # are read in place
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    qs, ks = _norm_segments(segment_ids, lq, lk)
    if qs is not None:
        qs = qs.to(device=q.device, dtype=torch.int32).contiguous()
        ks = ks.to(device=q.device, dtype=torch.int32).contiguous()
        if qs.shape != (b, lq) or ks.shape != (b, lk):
            raise ValueError("segment ids must be [B, Lq] and [B, Lk]")
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    _cuda.launch_flash_fwd(q, k, v, out, lse, qs, ks, scale, causal,
                           0 if window is None else int(window))
    return out, lse


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention forward → out. CUDA tensors run the
    hand-written kernel, CPU tensors the plain version."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, scale, segment_ids,
                                    window)[0]
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale,
                                         segment_ids, window)[0]
    raise ValueError(f"no flash attention for device {q.device}")
