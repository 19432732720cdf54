"""Decoder-only Transformer LM, restricted to what serving runs.

Counterpart of ``chainermn_tpu/models/transformer.py``'s
``TransformerBlock`` / ``TransformerLM`` / ``generate`` in the ``blhd``
layout with the dense FFN: MHA (fused ``qkv``) or GQA/MQA (``q_proj`` +
``kv_proj``), learned or rope positions, ``attention_window``,
``attention="flash"`` (the CUDA kernel on the card, its plain version on
the CPU) or ``"reference"``.

The JAX model's ``decode=True`` twin is :meth:`TransformerLM.forward_cached`
here: it takes the KV cache as an explicit dict ``{"block_i": {"k", "v",
"idx"}}`` and UPDATES IT IN PLACE (pages are hundreds of MB at serving
size; the JAX version returns a new tree). Its three cases follow the
reference branch for branch:

* a slab of l > 1 tokens on an empty cache (prefill): causal attention
  within the slab through flash attention;
* ``chunked=True``: the slab is written at its absolute positions and
  attends the whole cache under an absolute-position causal mask;
* one token (decode): attention over the ring-buffered page with the
  ring-inverted position mask.

Numerics kept from the reference: LayerNorm epsilon 1e-6, GELU with the
tanh approximation, the LM head in f32 even in a bf16 model, learned
positions beyond ``max_len`` read as NaN (``jnp.take``'s fill mode), f32
softmax in the cached paths.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_torch.device import resolve_device
from chainermn_torch.ops.flash_attention import flash_attention
from chainermn_torch.ops.rotary import apply_rope

__all__ = ["TransformerBlock", "TransformerLM", "generate",
           "dense_attention"]

_LN_EPS = 1e-6   # flax LayerNorm's default (torch's is 1e-5)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Statistics in f32, result in x's dtype (flax LayerNorm(dtype=...))."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def dense_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-device full attention in f32 (the reference's
    ``local_attention_reference``); k/v carry as many heads as q."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lk, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: causal attention + dense GELU FFN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 n_kv_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 attention: str = "flash",
                 attention_window: Optional[int] = None,
                 pos_emb: str = "learned", rope_theta: float = 10000.0,
                 device=None):
        super().__init__()
        if attention not in ("flash", "reference"):
            raise ValueError(f"attention must be 'flash' or 'reference', "
                             f"got {attention!r}")
        if attention_window is not None and attention != "flash":
            raise ValueError(
                "attention_window is supported on the 'flash' path")
        self.d_model, self.n_heads, self.d_ff = d_model, n_heads, d_ff
        self.n_kv_heads = n_kv_heads or n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads ({n_heads}) must be a multiple of "
                             f"n_kv_heads ({self.n_kv_heads})")
        self.d_head = d_model // n_heads
        self.dtype = dtype
        self.attention = attention
        self.attention_window = attention_window
        self.pos_emb = pos_emb
        self.rope_theta = rope_theta
        lin = dict(dtype=dtype, device=device)
        self.ln_attn = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        if self.n_kv_heads == n_heads:
            self.qkv = nn.Linear(d_model, 3 * d_model, bias=False, **lin)
        else:
            self.q_proj = nn.Linear(d_model, d_model, bias=False, **lin)
            self.kv_proj = nn.Linear(
                d_model, 2 * self.n_kv_heads * self.d_head, bias=False, **lin)
        self.attn_out = nn.Linear(d_model, d_model, bias=False, **lin)
        self.ln_ffn = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.ffn_in = nn.Linear(d_model, d_ff, **lin)
        self.ffn_out = nn.Linear(d_ff, d_model, **lin)

    def _project(self, x):
        """h = LN(x) → q [b, l, H, dh], k/v [b, l, Hkv, dh]; the fused
        outputs split into equal chunks as ``jnp.split`` does."""
        b, l, _ = x.shape
        h = _layer_norm(self.ln_attn, x)
        if self.n_kv_heads == self.n_heads:
            q, k, v = self.qkv(h).chunk(3, dim=-1)
        else:
            q = self.q_proj(h)
            k, v = self.kv_proj(h).chunk(2, dim=-1)
        return (q.reshape(b, l, self.n_heads, self.d_head),
                k.reshape(b, l, self.n_kv_heads, self.d_head),
                v.reshape(b, l, self.n_kv_heads, self.d_head))

    def _repeat_kv(self, t):
        g = self.n_heads // self.n_kv_heads
        return t if g == 1 else t.repeat_interleave(g, dim=2)

    def _slab_attention(self, q, k, v):
        """Causal self-attention over the slab (training-path kernels)."""
        if self.attention == "flash":
            return flash_attention(q, k, v, causal=True,
                                   window=self.attention_window)
        return dense_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                               causal=True)

    def _tail(self, x, att):
        b, l, _ = x.shape
        x = x + self.attn_out(att.reshape(b, l, -1).to(self.dtype))
        h = _layer_norm(self.ln_ffn, x)
        y = F.gelu(self.ffn_in(h), approximate="tanh")
        return x + self.ffn_out(y)

    def forward(self, x, pos_offset=0):
        """Full forward. ``pos_offset``: scalar or per-row ``[b]``."""
        q, k, v = self._project(x)
        if self.pos_emb == "rope":
            pos = _positions(pos_offset, x.shape[1], x.device)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        return self._tail(x, self._slab_attention(q, k, v))

    def forward_cached(self, x, page: Dict[str, torch.Tensor],
                       chunked: bool = False):
        """KV-cache forward of a slab of l new tokens starting at the
        page cursor ``page["idx"]`` (scalar, or ``[b]`` per slot). Writes
        K/V into ``page`` and advances its cursor, in place."""
        b, l, _ = x.shape
        q, k, v = self._project(x)
        pos = page["idx"]
        per_slot = pos.dim() == 1
        ar = torch.arange(l, device=x.device)
        rows = (pos[:, None] if per_slot else pos) + ar   # [b, l] or [l]
        if self.pos_emb == "rope":
            q = apply_rope(q, rows, self.rope_theta)
            k = apply_rope(k, rows, self.rope_theta)
        kc, vc = page["k"], page["v"]
        cap = kc.shape[1]
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, l)
        if chunked:
            # per-position scatter; rows past the page end (final-chunk
            # padding, no wrap during prefill) drop
            wrows = rows if per_slot else rows[None].expand(b, l)
            keep = wrows < cap
            kc[bidx[keep], wrows[keep]] = k[keep].to(kc.dtype)
            vc[bidx[keep], wrows[keep]] = v[keep].to(vc.dtype)
        else:
            # dynamic_update_slice semantics: the start clamps so the slab
            # fits the page
            start = torch.clamp(torch.remainder(pos, cap), max=cap - l)
            cols = (start[:, None] + ar if per_slot
                    else (start + ar)[None].expand(b, l))
            kc[bidx, cols] = k.to(kc.dtype)
            vc[bidx, cols] = v.to(vc.dtype)
        page["idx"] = pos + l
        if l > 1 and chunked:
            att = self._chunk_attention(q, kc, vc, rows, per_slot)
        elif l > 1:
            att = self._slab_attention(q, k, v)
        else:
            att = self._decode_attention(q, kc, vc, rows, per_slot)
        return self._tail(x, att)

    def _grouped_scores(self, q, kc):
        """f32 scores of q ``[b, l, H, dh]`` against a whole page ``[b,
        cap, Hkv, dh]`` → ``[b, Hkv, g, l, cap]``; query head h reads KV
        head h // g, as ``jnp.repeat`` over the head axis does."""
        b, l = q.shape[:2]
        g = self.n_heads // self.n_kv_heads
        qf = q.float().reshape(b, l, self.n_kv_heads, g, self.d_head)
        return (torch.einsum("bqkgd,bckd->bkgqc", qf, kc.float())
                * self.d_head ** -0.5)

    def _grouped_values(self, p, vc, b, l):
        o = torch.einsum("bkgqc,bckd->bqkgd", p, vc.float())
        return o.reshape(b, l, self.n_heads, self.d_head)

    def _chunk_attention(self, q, kc, vc, rows, per_slot):
        b, l = q.shape[:2]
        cap = kc.shape[1]
        s = self._grouped_scores(q, kc)
        keys = torch.arange(cap, device=q.device)
        # no-wrap contract: cache slot j holds absolute position j
        visible = keys <= rows[..., None]
        if self.attention_window is not None:
            visible &= keys > rows[..., None] - self.attention_window
        vis = visible[:, None, None] if per_slot else visible[None, None,
                                                              None]
        s = s.masked_fill(~vis, float("-inf"))
        att = self._grouped_values(torch.softmax(s, dim=-1), vc, b, l)
        return att.to(q.dtype)

    def _decode_attention(self, q, kc, vc, rows, per_slot):
        b = q.shape[0]
        cap = kc.shape[1]
        s = self._grouped_scores(q, kc)                  # [b, Hkv, g, 1, cap]
        row = rows[..., -1]                              # [b] or ()
        keys = torch.arange(cap, device=q.device)
        # ring inversion: slot j holds the newest position ≡ j (mod cap)
        # not beyond row; unwritten slots land negative
        kpos = row[..., None] - torch.remainder(row[..., None] - keys, cap)
        visible = kpos >= 0
        if self.attention_window is not None:
            visible &= kpos > row[..., None] - self.attention_window
        vis = (visible[:, None, None, None] if per_slot
               else visible[None, None, None, None])
        s = s.masked_fill(~vis, float("-inf"))
        return self._grouped_values(torch.softmax(s, dim=-1), vc, b, 1)


def _positions(pos_offset, l: int, device) -> torch.Tensor:
    """Global positions: ``[l]`` for a scalar offset, ``[b, l]`` for a
    per-row ``[b]`` offset."""
    po = torch.as_tensor(pos_offset, device=device)
    ar = torch.arange(l, device=device)
    return (po[:, None] if po.dim() else po) + ar


class TransformerLM(nn.Module):
    """Causal LM: tokens ``[B, L]`` → logits ``[B, L, vocab]`` (f32).

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Linear and embedding weights are kept in ``dtype``,
    LayerNorms, learned positions and the LM head in f32 — the dtypes
    the JAX model computes them in.
    """

    def __init__(self, vocab: int, d_model: int = 256, n_heads: int = 8,
                 n_kv_heads: Optional[int] = None, n_layers: int = 4,
                 d_ff: int = 1024, max_len: int = 2048,
                 pos_emb: str = "learned", rope_theta: float = 10000.0,
                 attention_window: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 attention: str = "flash", device=None):
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"pos_emb must be 'learned' or 'rope', got "
                             f"{pos_emb!r}")
        dev = resolve_device(device)
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.n_layers, self.d_ff, self.max_len = n_layers, d_ff, max_len
        self.pos_emb, self.rope_theta = pos_emb, rope_theta
        self.attention_window = attention_window
        self.dtype, self.attention = dtype, attention
        self.tok_emb = nn.Embedding(vocab, d_model, dtype=dtype, device=dev)
        if pos_emb == "learned":
            self.pos_embedding = nn.Parameter(
                torch.randn(max_len, d_model, device=dev) * 0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, d_ff, n_kv_heads, dtype,
                             attention, attention_window, pos_emb,
                             rope_theta, device=dev)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=dev)
        self.lm_head = nn.Linear(d_model, vocab, bias=False, device=dev)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def _embed(self, tokens, pos_offset):
        x = self.tok_emb(tokens.long())
        if self.pos_emb == "learned":
            idx = _positions(pos_offset, tokens.shape[1], tokens.device)
            # jnp.take's default fill mode: out-of-range rows read NaN
            # (only retired or idle slots ever index past max_len)
            ok = (idx >= -self.max_len) & (idx < self.max_len)
            pe = self.pos_embedding[torch.remainder(idx, self.max_len)]
            pe = pe.masked_fill(~ok[..., None], float("nan")).to(self.dtype)
            x = x + (pe if pe.dim() == 3 else pe[None])
        return x

    def _head(self, x):
        x = _layer_norm(self.ln_f, x)
        return self.lm_head(x.float())

    def forward(self, tokens, pos_offset=0):
        x = self._embed(tokens, pos_offset)
        for blk in self.blocks:
            x = blk(x, pos_offset=pos_offset)
        return self._head(x)

    def forward_cached(self, tokens, cache, chunked: bool = False):
        """The decode twin: tokens ``[B, l]`` at each row's cache cursor;
        ``cache`` is updated in place (see the module docstring)."""
        x = self._embed(tokens, cache["block_0"]["idx"])
        for i, blk in enumerate(self.blocks):
            x = blk.forward_cached(x, cache[f"block_{i}"], chunked=chunked)
        return self._head(x)


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int,
             eos_id: Optional[int] = None, pad_id: int = 0,
             use_cache: bool = True) -> torch.Tensor:
    """Greedy autoregressive generation: prompt int ``[B, Lp]`` → int64
    ``[B, Lp + max_new_tokens]`` (argmax, first index on ties, as
    ``jnp.argmax``). The prompt prefills once into a page sized to the
    stream, then decodes one token at a time; ``use_cache=False``
    recomputes the whole prefix each step (the audit path). ``eos_id``:
    once a row emits it, later positions emit ``pad_id``. Sampled
    generation waits for the port of ``jax.random``'s stream."""
    from chainermn_torch.serving.kv_cache import (decode_apply, init_cache,
                                                  prefill_apply)

    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, lp = prompt.shape
    total = lp + max_new_tokens
    if total > model.max_len:
        raise ValueError(f"prompt + max_new_tokens ({total}) exceeds "
                         f"max_len ({model.max_len})")
    if max_new_tokens == 0:
        return prompt
    if use_cache:
        cache = init_cache(model, b, total)
        logits, cache = prefill_apply(
            model, cache, prompt, torch.full((b,), lp, device=prompt.device),
            torch.arange(b, device=prompt.device))
    else:
        logits = model(prompt)[:, -1]
    tok = logits.argmax(-1)
    done = tok == eos_id if eos_id is not None else None
    out = [prompt, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        if use_cache:
            logits, cache = decode_apply(model, cache, tok)
        else:
            logits = model(torch.cat(out, dim=1))[:, -1]
        tok = logits.argmax(-1)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            done = done | (tok == eos_id)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
