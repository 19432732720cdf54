"""Fused LM head + softmax cross-entropy: the logits never reach device
memory on the kernel path.

Counterpart of ``chainermn_tpu/ops/fused_ce.py`` (``fused_ce_head`` with
``_fwd_kernel``, ``_dh_kernel`` and ``_dw_kernel``; ``fused_lm_loss``).
``fused_ce_head(h, w, y)``: h ``[N, D]`` hidden states, w ``[D, V]`` head
kernel, y ``[N]`` labels → ``(loss, acc)`` scalars:

* loss = mean over the N rows of (lse − target logit), softmax math in
  f32 on logits accumulated in f32 from native-dtype operands;
* acc = share of rows whose first-index argmax (``jnp.argmax``'s tie
  rule) equals the label; it carries no gradient;
* backward: dl = softmax − onehot rebuilt per tile from the forward's
  lse, cast to the head's dtype; dh = dl·Wᵀ and dW = hᵀ·dl, each scaled
  by dloss / N after the kernel, as ``_bwd_rule`` scales them.

The TPU tile rules (rows padded to ``block_rows``, ``v % block_v == 0``,
the ``bv_dw <= 1024`` halving) do not carry over: the CUDA kernels
(``csrc/fused_ce.cu``) mask ragged N and V themselves; D is a multiple of
16 bytes of the dtype and, for the bf16 dh and dW, no wider than the
shared memory their tiles take allows (checked through ``ce_smem_bytes``:
1536); the f32 kernels' shared memory is fixed whatever D is, so every f32
D runs; h and the head start on 16-byte boundaries (the kernels read them
16 bytes at a time or by TMA). ``block_rows`` and ``block_v`` stay in the
signature for parity and are not used.

The forward splits the vocabulary into ranges of whole tiles so that its
CTAs fill the card (:func:`ce_fwd_splits`, with each dtype's tile); each
range leaves a partial (max, sum of exp, target logit, argmax) per row,
which a second kernel combines in range order (plain versions
:func:`ce_fwd_partial_reference` and :func:`ce_fwd_combine_reference`).
The f32 dh splits it too (:func:`ce_dh_splits`), and the f32 dW, dh's
mirror image, splits the rows of h (:func:`ce_dw_splits`): each range
leaves a partial dh or dWᵀ in an f32 workspace, summed in range order by
a second kernel (:func:`ce_dh_partial_reference`,
:func:`ce_dw_partial_reference`, :func:`ce_sum_ranges_reference`).

CUDA tensors run the kernels; CPU tensors run the plain versions
(:func:`ce_forward_reference`, :func:`ce_dh_reference`,
:func:`ce_dw_reference`), which materialize the logits. Nothing falls
back.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from chainermn_torch.ops import _cuda

__all__ = ["fused_ce_head", "fused_lm_loss", "ce_forward_reference",
           "ce_dh_reference", "ce_dw_reference", "ce_forward_cuda",
           "ce_dh_cuda", "ce_dw_cuda", "ce_fwd_splits", "ce_fwd_plan",
           "ce_fwd_cuda_plan", "ce_dh_splits", "ce_dh_plan",
           "ce_dh_cuda_plan", "ce_dw_splits", "ce_dw_plan",
           "ce_dw_cuda_plan", "ce_fwd_partial_reference",
           "ce_fwd_combine_reference", "ce_dh_partial_reference",
           "ce_dw_partial_reference", "ce_sum_ranges_reference"]

# smem the kernels may use per block on an H100 (227 KB)
_MAX_SMEM = 232448


def _logits(h, wt):
    """f32 logits from native-dtype operands (bf16 products are exact in
    f32, so only the summation order differs from the kernel)."""
    return h.float() @ wt.float().t()


def ce_forward_reference(h, wt, y) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``_fwd_kernel``: h ``[N, D]``, wt ``[V, D]`` (the
    head transposed), y ``[N]`` → (lse f32, target logit f32, first-index
    argmax int32), each ``[N]``."""
    logits = _logits(h, wt)
    lse = torch.logsumexp(logits, -1)
    yl = y.long()
    hit = (yl >= 0) & (yl < wt.shape[0])
    tl = torch.where(hit, logits.gather(1, yl.clamp(0, wt.shape[0] - 1)
                                        [:, None])[:, 0],
                     torch.zeros_like(lse))
    return lse, tl, logits.argmax(-1).to(torch.int32)


def ce_fwd_partial_reference(h, wt, y, lo: int, hi: int
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of one vocabulary range [lo, hi) of the forward: per
    row (max logit m, sum of exp(logit - m), target logit or 0 when the
    label is outside the range, first index attaining m), each ``[N]``
    (f32, f32, f32, int32)."""
    logits = _logits(h, wt[lo:hi])
    m = logits.max(-1).values
    s = torch.exp(logits - m[:, None]).sum(-1)
    yl = y.long() - lo
    hit = (yl >= 0) & (yl < hi - lo)
    t = torch.where(hit, logits.gather(1, yl.clamp(0, hi - lo - 1)
                                       [:, None])[:, 0], torch.zeros_like(m))
    return m, s, t, (lo + logits.argmax(-1)).to(torch.int32)


def ce_fwd_combine_reference(m, s, t, a) -> Tuple[torch.Tensor, ...]:
    """Plain version of the combine: the ranges' partials ``[S, N]`` in
    vocabulary order → (lse, target logit, argmax) ``[N]``. The argmax
    comes from the lowest range whose max is the row's, so the first index
    still wins ties."""
    mx = m.max(0).values
    lse = mx + torch.log((s * torch.exp(m - mx)).sum(0))
    first = (m == mx).int().argmax(0)            # lowest such range
    return lse, t.sum(0), a.gather(0, first[None])[0]


def ce_fwd_splits(n: int, v: int, sms: int, block_rows: int = 128,
                  block_v: int = 256, ctas_per_sm: int = 1
                  ) -> Tuple[int, int]:
    """Vocabulary ranges of the forward: (S, tiles per range). One CTA
    runs per (block of ``block_rows`` rows, range) and ``ctas_per_sm`` of
    them share an SM (the defaults are the bf16 tile); a CTA takes about
    one tile's time per tile of its range plus one to fill its pipeline,
    so S minimises ceil(blocks S / slots) (ceil(tiles / S) + 1), slots =
    sms x ctas_per_sm, the smallest S on a tie. S is then shrunk so that
    ranges of whole tiles leave none empty."""
    return _splits(-(-n // block_rows), -(-v // block_v), sms * ctas_per_sm)


@functools.lru_cache(maxsize=256)
def _splits(blocks: int, tiles: int, slots: int) -> Tuple[int, int]:
    best = min(range(1, tiles + 1),
               key=lambda s: (-(-blocks * s // slots) * (-(-tiles // s) + 1),
                              s))
    per = -(-tiles // best)
    return -(-tiles // per), per


def ce_fwd_plan(n: int, d: int, v: int, sms: int, block_rows: int = 128,
                block_v: int = 256, block_d: int = 64, ctas_per_sm: int = 1,
                itemsize: int = 2) -> dict:
    """The forward's launch at these shapes (defaults: the bf16 tile):
    vocabulary ranges, tiles per range, the grid (row blocks, ranges), and
    the bytes its slabs (bf16: TMA boxes) move into shared memory (every
    slab whole, zero-fill included: each CTA loads its h block again for
    every vocabulary tile)."""
    splits, per = ce_fwd_splits(n, v, sms, block_rows, block_v, ctas_per_sm)
    blocks = -(-n // block_rows)
    steps = -(-v // block_v) * -(-d // block_d)
    return dict(splits=splits, per=per, grid=(blocks, splits),
                smem_bytes=blocks * steps * (block_rows + block_v)
                * block_d * itemsize)


def ce_dh_splits(n: int, d: int, v: int, sms: int, block_rows: int = 32,
                 block_v: int = 256, d_chunk: int = 768,
                 ctas_per_sm: int = 1) -> Tuple[int, int]:
    """Vocabulary ranges of the f32 dh: (S, tiles per range), chosen as
    :func:`ce_fwd_splits` chooses them, a block being ``block_rows`` rows
    by one ``d_chunk`` of D's columns (the defaults are the kernel's
    tile)."""
    blocks = -(-n // block_rows) * -(-d // d_chunk)
    return _splits(blocks, -(-v // block_v), sms * ctas_per_sm)


def ce_dh_plan(n: int, d: int, v: int, sms: int, block_rows: int = 32,
               block_v: int = 256, d_chunk: int = 768,
               ctas_per_sm: int = 1) -> dict:
    """The f32 dh's launch at these shapes: vocabulary ranges, tiles per
    range, the grid (row blocks, ranges, D chunks) and the bytes of its
    f32 workspace (0 with one range: the kernel writes dh)."""
    splits, per = ce_dh_splits(n, d, v, sms, block_rows, block_v, d_chunk,
                               ctas_per_sm)
    return dict(splits=splits, per=per,
                grid=(-(-n // block_rows), splits, -(-d // d_chunk)),
                workspace_bytes=4 * splits * n * d if splits > 1 else 0)


def ce_dw_splits(n: int, d: int, v: int, sms: int, block_rows: int = 32,
                 block_n: int = 256, d_chunk: int = 768,
                 ctas_per_sm: int = 1) -> Tuple[int, int]:
    """Ranges of h's rows of the f32 dW: (S, tiles per range). dW is dh's
    mirror image (``block_rows`` vocabulary rows a block, ``block_n`` rows
    of h a tile), so these are :func:`ce_dh_splits` with N and V
    swapped."""
    return ce_dh_splits(v, d, n, sms, block_rows, block_n, d_chunk,
                        ctas_per_sm)


def ce_dw_plan(n: int, d: int, v: int, sms: int, block_rows: int = 32,
               block_n: int = 256, d_chunk: int = 768,
               ctas_per_sm: int = 1) -> dict:
    """The f32 dW's launch at these shapes, :func:`ce_dh_plan` with N and
    V swapped: ranges of h's rows, tiles per range, the grid (vocabulary
    row blocks, ranges, D chunks) and the bytes of its f32 workspace (0
    with one range: the kernel writes dWᵀ)."""
    return ce_dh_plan(v, d, n, sms, block_rows, block_n, d_chunk,
                      ctas_per_sm)


def _dl(h, wt, y, lse):
    logits = _logits(h, wt)
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(wt.shape[0], device=h.device)
    return p - (cols[None, :] == y.long()[:, None]).float()


def ce_dh_reference(h, wt, y, lse) -> torch.Tensor:
    """Plain version of ``_dh_kernel``: unscaled dh = dl·W in h's dtype,
    dl cast to the head's dtype first."""
    dl = _dl(h, wt, y, lse).to(wt.dtype).float()
    return (dl @ wt.float()).to(h.dtype)


def ce_dh_partial_reference(h, wt, y, lse, lo: int, hi: int
                            ) -> torch.Tensor:
    """Plain version of one vocabulary range [lo, hi) of the f32 dh: the
    f32 sum over v in [lo, hi) of dl[:, v] W[v], dl cast to the head's
    dtype first (labels outside the range add no one-hot term)."""
    logits = _logits(h, wt[lo:hi])
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(lo, hi, device=h.device)
    dl = p - (cols[None, :] == y.long()[:, None]).float()
    return dl.to(wt.dtype).float() @ wt[lo:hi].float()


def ce_sum_ranges_reference(parts, dtype=torch.float32) -> torch.Tensor:
    """Plain version of the f32 backward's combine: the ranges' partials
    (dh ``[S, N, D]`` or dWᵀ ``[S, V, D]``) summed in range order, cast to
    ``dtype``."""
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out.to(dtype)


def ce_dw_reference(h, wt, y, lse) -> torch.Tensor:
    """Plain version of ``_dw_kernel``: unscaled dWᵀ = dlᵀ·h ``[V, D]`` in
    the head's dtype, dl cast to h's dtype first."""
    dl = _dl(h, wt, y, lse).to(h.dtype).float()
    return (dl.t() @ h.float()).to(wt.dtype)


def ce_dw_partial_reference(h, wt, y, lse, lo: int, hi: int
                            ) -> torch.Tensor:
    """Plain version of one range [lo, hi) of h's rows of the f32 dW: the
    f32 sum over n in [lo, hi) of dl[n]ᵀ h[n] ``[V, D]``, dl cast to h's
    dtype first."""
    dl = _dl(h[lo:hi], wt, y[lo:hi], lse[lo:hi]).to(h.dtype).float()
    return dl.t() @ h[lo:hi].float()


def _check_cuda(h, wt, y, which: int):
    if not (h.is_cuda and wt.is_cuda and y.is_cuda):
        raise ValueError("the fused CE kernels need CUDA tensors")
    if h.dtype not in _cuda.DTYPES or wt.dtype != h.dtype:
        raise TypeError(f"fused CE kernels take float32 or bfloat16 h and "
                        f"head of one dtype, got {h.dtype}/{wt.dtype}")
    if h.dim() != 2 or wt.dim() != 2 or wt.shape[1] != h.shape[1]:
        raise ValueError(f"h [N, D] and wt [V, D] expected, got "
                         f"{tuple(h.shape)} and {tuple(wt.shape)}")
    if y.shape != (h.shape[0],):
        raise ValueError(f"labels must be [N], got {tuple(y.shape)}")
    d = h.shape[1]
    if d % (16 // h.element_size()):
        raise ValueError(f"D = {d} must be a multiple of "
                         f"{16 // h.element_size()} (16-byte rows)")
    smem = _cuda.ce_smem_bytes(which, h.dtype, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"D = {d} needs {smem} bytes of shared memory, "
                         f"more than a block has ({_MAX_SMEM})")
    h, wt = h.contiguous(), wt.contiguous()
    for name, x in (("h", h), ("the head", wt)):
        # the kernels read rows 16 bytes at a time or by TMA; a copy of
        # the head would cost 50 MB per call, so refuse instead
        if x.data_ptr() % 16:
            raise ValueError(
                f"{name} starts {x.data_ptr() % 16} bytes past a 16-byte "
                f"boundary (storage offset {x.storage_offset()} elements); "
                f"the fused CE kernels need 16-byte aligned operands")
    return h, wt, y.to(torch.int32).contiguous()


def ce_forward_cuda(h, wt, y):
    """``csrc/fused_ce.cu`` forward → (lse, target logit, argmax)."""
    h, wt, y = _check_cuda(h, wt, y, 0)
    (n, d), v = h.shape, wt.shape[0]
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    tl = torch.empty_like(lse)
    am = torch.empty(n, dtype=torch.int32, device=h.device)
    splits = ce_fwd_cuda_plan(n, d, v, h.device, h.dtype)["splits"]
    part = torch.empty(4, splits, n, dtype=torch.float32, device=h.device)
    _cuda.launch_ce_fwd(h, wt, y, lse, tl, am, part, splits)
    return lse, tl, am


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ce_fwd_cuda_plan(n: int, d: int, v: int, device="cuda",
                     dtype=torch.bfloat16) -> dict:
    """:func:`ce_fwd_plan` with the card's SM count and the kernel's tile
    for ``dtype``: the launch ``ce_forward_cuda`` makes at these
    shapes."""
    bm, bn, bk, ctas = _cuda.ce_fwd_tile(dtype)
    return ce_fwd_plan(n, d, v, _sms(device), bm, bn, bk, ctas,
                       torch.empty((), dtype=dtype).element_size())


def ce_dh_cuda_plan(n: int, d: int, v: int, device="cuda") -> dict:
    """:func:`ce_dh_plan` with the card's SM count and the f32 kernel's
    tile: the launch ``ce_dh_cuda`` makes for f32 inputs."""
    return ce_dh_plan(n, d, v, _sms(device), *_cuda.ce_dh_tile())


def ce_dw_cuda_plan(n: int, d: int, v: int, device="cuda") -> dict:
    """:func:`ce_dw_plan` with the card's SM count and the f32 kernel's
    tile: the launch ``ce_dw_cuda`` makes for f32 inputs."""
    return ce_dw_plan(n, d, v, _sms(device), *_cuda.ce_dw_tile())


def ce_dh_cuda(h, wt, y, lse):
    """``csrc/fused_ce.cu`` dh kernel → unscaled dh ``[N, D]``."""
    h, wt, y = _check_cuda(h, wt, y, 1)
    dh = torch.empty_like(h)
    lse = lse.float().contiguous()
    if h.dtype == torch.float32:
        (n, d), v = h.shape, wt.shape[0]
        splits = ce_dh_cuda_plan(n, d, v, h.device)["splits"]
        part = (torch.empty(splits, n, d, dtype=torch.float32,
                            device=h.device) if splits > 1 else None)
        _cuda.launch_ce_dh(h, wt, y, lse, dh, part, splits)
    else:
        _cuda.launch_ce_dh(h, wt, y, lse, dh)
    return dh


def ce_dw_cuda(h, wt, y, lse):
    """``csrc/fused_ce.cu`` dW kernel → unscaled dWᵀ ``[V, D]``."""
    h, wt, y = _check_cuda(h, wt, y, 2)
    dwt = torch.empty_like(wt)
    lse = lse.float().contiguous()
    if h.dtype == torch.float32:
        (n, d), v = h.shape, wt.shape[0]
        splits = ce_dw_cuda_plan(n, d, v, h.device)["splits"]
        part = (torch.empty(splits, v, d, dtype=torch.float32,
                            device=h.device) if splits > 1 else None)
        _cuda.launch_ce_dw(h, wt, y, lse, dwt, part, splits)
    else:
        _cuda.launch_ce_dw(h, wt, y, lse, dwt)
    return dwt


def _dispatch(h, cuda_fn, plain_fn, *args):
    if h.is_cuda:
        return cuda_fn(*args)
    if h.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"no fused CE for device {h.device}")


class _FusedCE(torch.autograd.Function):
    """(loss, acc) of h ``[N, D]`` against the transposed head wt ``[V,
    D]``; gradients for h and wt only."""

    @staticmethod
    def forward(ctx, h, wt, y):
        lse, tl, am = _dispatch(h, ce_forward_cuda, ce_forward_reference,
                                h, wt, y)
        n0 = h.shape[0]
        loss = (lse - tl).sum() / n0
        acc = (am.long() == y.long()).float().sum() / n0
        ctx.save_for_backward(h, wt, y, lse)
        ctx.mark_non_differentiable(acc)
        return loss, acc

    @staticmethod
    def backward(ctx, dloss, _dacc):
        h, wt, y, lse = ctx.saved_tensors
        c = dloss / h.shape[0]   # d(acc) is discarded: a metric
        dh = dwt = None
        if ctx.needs_input_grad[0]:
            dh = _dispatch(h, ce_dh_cuda, ce_dh_reference, h, wt, y, lse)
            dh = (dh.float() * c).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dwt = _dispatch(h, ce_dw_cuda, ce_dw_reference, h, wt, y, lse)
            dwt = (dwt.float() * c).to(wt.dtype)
        return dh, dwt, None


def fused_ce_head(h, w, y, block_rows: int = 256, block_v: int = 2048):
    """``mean CE(h @ w, y)`` and argmax accuracy with the logits kept on
    chip. h ``[N, D]``; w ``[D, V]`` (pass ``lm_head.weight.t()``: the
    kernels read the head as ``[V, D]`` rows, so that view is not
    copied); y ``[N]`` labels. Returns ``(loss, acc)``, differentiable in
    h and w. ``block_rows``/``block_v`` are the TPU tiles, kept for
    parity and unused."""
    del block_rows, block_v
    return _FusedCE.apply(h, w.t().contiguous(), y.reshape(-1))


def fused_lm_loss(model, x, y, train: bool = True, mutable=None,
                  block_rows: int = 256, block_v: int = 2048):
    """Drop-in for ``lm_loss_with_aux`` on a plain (non-MoE)
    TransformerLM, in the step-factory signature: the ``[B, L, vocab]``
    logits never materialize. The head runs in the hidden states' dtype
    (bf16 in a bf16 model), as the JAX ``fused_lm_loss`` casts it."""
    if getattr(model, "moe_experts_per_device", 0):
        raise ValueError(
            "fused_lm_loss drops the MoE load-balancing aux; use "
            "lm_loss_with_aux for MoE models")
    if getattr(model, "lm_head_tp", False):
        raise ValueError(
            "fused_lm_loss needs the replicated lm_head; use tp_lm_loss "
            "for lm_head_tp models")
    if mutable:
        raise ValueError(
            "fused_lm_loss does not thread mutable collections "
            f"(mutable={mutable!r} would be silently dropped); use "
            "lm_loss_with_aux for models with mutable state")
    del train  # TransformerLM has no train-dependent state
    hidden = model.forward_hidden(x)                      # [B, L, D]
    b, l, d = hidden.shape
    w = model.lm_head.weight.to(hidden.dtype).t()         # [D, V] view
    loss, acc = fused_ce_head(hidden.reshape(b * l, d), w,
                              torch.as_tensor(y, device=hidden.device)
                              .reshape(-1), block_rows, block_v)
    return loss, (acc, {})
