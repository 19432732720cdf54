"""Vision Transformer image classifier.

Counterpart of ``chainermn_tpu/models/vit.py`` (``ViTEncoderBlock`` and
``ViT``): a patch-``patch`` stride-``patch`` projection, a learned class
token (``pool="cls"``) or global average pooling (``pool="gap"``),
learned positions, pre-LN encoder blocks with bidirectional attention
and a GELU MLP, a final LayerNorm and an f32 head.

Attention is the port's :func:`~chainermn_torch.ops.flash_attention.
flash_attention` with ``causal=False``: the hand-written kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) on CUDA tensors, their
plain versions on CPU tensors. ViT-S/16 at 224² gives 196 tokens (197
with the class token), a ragged last tile that the kernels mask. The
fused ``qkv`` output is split into three strided views, as
``jnp.split`` does. When ``d_model`` and the head dim are multiples of 8
elements (bf16; 4 in f32), as ViT-S/16's 384 and 64 are, each view's
offset and strides are multiples of 16 bytes, so the kernels read the
views in place (``flash_attention._aligned``) and nothing is copied; any
other width is copied once by the wrapper.
``attention_blocks`` is accepted and not applicable: the CUDA kernels fix
their own tiles.

Numerics kept from flax: LayerNorm epsilon 1e-6 (torch's default is
1e-5) with f32 statistics; ``nn.gelu`` is the tanh approximation; every
Dense layer and the projection cast their f32 weights and their input to
``dtype``; the head is f32 and so are the logits. The projection takes
NHWC images, and its weight is ``[d_model, C, patch, patch]`` (OIHW, as
``convert_layer("conv")`` gives flax's ``[kh, kw, cin, cout]`` kernel),
applied as one product over each patch's ``(kh, kw, cin)`` elements.

Dropout (``dropout_rate > 0``) follows flax's three sites, after the
positions and after each block's attention and MLP, with masks from
:mod:`chainermn_torch.ops.dropout`: ``forward(x, train=True, rng=key)``
folds each block's index into ``key``, and the block folds in its site.
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant, as ``nn.remat``); the
recomputed block draws the same masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_torch.device import resolve_device
from chainermn_torch.models.mlp import lecun_normal_
from chainermn_torch.models.transformer import _LN_EPS, _dense, _layer_norm
from chainermn_torch.ops.dropout import dropout, fold_in
from chainermn_torch.ops.flash_attention import flash_attention

__all__ = ["ViT", "ViTEncoderBlock"]


def _flax_linear(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, bias=bias)
    lecun_normal_(layer.weight, n_in)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


class ViTEncoderBlock(nn.Module):
    """Pre-LN encoder block: bidirectional attention + GELU MLP."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.d_model, self.n_heads = d_model, n_heads
        self.d_head = d_model // n_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.ln_attn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.qkv = _flax_linear(d_model, 3 * d_model, bias=False)
        self.attn_out = _flax_linear(d_model, d_model, bias=False)
        self.ln_ffn = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.ffn_in = _flax_linear(d_model, d_ff)
        self.ffn_out = _flax_linear(d_ff, d_model)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        b, l, d = x.shape
        site = (lambda i: None) if rng is None else (
            lambda i: fold_in(rng, i))
        h = _layer_norm(self.ln_attn, x, self.dtype)
        q, k, v = (t.reshape(b, l, self.n_heads, self.d_head) for t in
                   _dense(self.qkv, h, self.dtype).chunk(3, dim=-1))
        att = flash_attention(q, k, v, causal=False)
        att = _dense(self.attn_out, att.reshape(b, l, d).to(self.dtype),
                     self.dtype)
        x = x + dropout(att, self.dropout_rate, site(0), train)
        h = _layer_norm(self.ln_ffn, x, self.dtype)
        y = F.gelu(_dense(self.ffn_in, h, self.dtype), approximate="tanh")
        y = _dense(self.ffn_out, y, self.dtype)
        return x + dropout(y, self.dropout_rate, site(1), train)


class ViT(nn.Module):
    """Images ``[B, H, W, C]`` → logits ``[B, num_classes]`` (f32).

    The JAX module sizes its positions from the first input; here
    ``image_size`` (square, divisible by ``patch``) fixes them at
    construction. Parameters are f32 and start as flax's do (LeCun-normal
    kernels, zero biases, positions normal(0.02), a zero class token),
    drawn on the CPU from torch's global generator, then moved to
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``)."""

    def __init__(self, num_classes: int, image_size: int = 224,
                 patch: int = 16, d_model: int = 384, n_layers: int = 12,
                 n_heads: int = 6, d_ff: int = 1536, pool: str = "gap",
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 attention_blocks: Optional[tuple] = None,
                 remat: bool = False, in_channels: int = 3, device=None):
        super().__init__()
        if pool not in ("gap", "cls"):
            raise ValueError(f"pool must be 'gap' or 'cls', got {pool!r}")
        if image_size % patch:
            raise ValueError(f"image {image_size}x{image_size} not "
                             f"divisible by patch {patch}")
        dev = resolve_device(device)
        self.num_classes, self.image_size, self.patch = (num_classes,
                                                         image_size, patch)
        self.d_model, self.n_layers = d_model, n_layers
        self.pool, self.dtype = pool, dtype
        self.dropout_rate, self.remat = dropout_rate, remat
        # recorded, not applicable: the CUDA kernels fix their own tiles
        self.attention_blocks = attention_blocks
        self.patchify = nn.Conv2d(in_channels, d_model, patch, stride=patch)
        lecun_normal_(self.patchify.weight, in_channels * patch * patch)
        with torch.no_grad():
            self.patchify.bias.zero_()
        self.n_tokens = (image_size // patch) ** 2 + (pool == "cls")
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_emb = nn.Parameter(
            torch.randn(self.n_tokens, d_model) * 0.02)
        self.blocks = nn.ModuleList(
            ViTEncoderBlock(d_model, n_heads, d_ff, dtype, dropout_rate)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.head = _flax_linear(d_model, num_classes)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def _patches(self, x):
        """``[B, H, W, C]`` → ``[B, tokens, d_model]``: the stride-patch
        projection as one product over each patch's (kh, kw, cin)."""
        b, hh, ww, c = x.shape
        p = self.patch
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch {p}")
        x = (x.to(self.dtype).reshape(b, hh // p, p, ww // p, p, c)
             .permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c))
        w = self.patchify.weight.permute(0, 2, 3, 1).reshape(
            self.d_model, -1)
        return F.linear(x, w.to(self.dtype),
                        self.patchify.bias.to(self.dtype))

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        x = self._patches(torch.as_tensor(x, device=self.device))
        b = x.shape[0]
        if self.pool == "cls":
            cls = self.cls_token.expand(b, 1, self.d_model).to(self.dtype)
            x = torch.cat([cls, x], dim=1)
        if x.shape[1] != self.n_tokens:
            raise ValueError(f"{x.shape[1]} tokens, but the positions were "
                             f"made for {self.n_tokens} (image_size "
                             f"{self.image_size})")
        x = x + self.pos_emb.to(self.dtype)[None]
        key = (lambda i: None) if rng is None else (
            lambda i: fold_in(rng, i))
        x = dropout(x, self.dropout_rate, key(0), train)
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x = checkpoint(blk, x, train, key(i + 1),
                               use_reentrant=False)
            else:
                x = blk(x, train, key(i + 1))
        x = _layer_norm(self.ln_f, x, self.dtype)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(x.float())
