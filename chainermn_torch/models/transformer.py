"""Decoder-only Transformer LM: training and serving.

Counterpart of ``chainermn_tpu/models/transformer.py``'s
``TransformerBlock`` / ``TransformerLM`` / ``generate`` /
``lm_loss_with_aux`` / ``tp_lm_loss`` in the ``blhd`` layout: MHA
(fused ``qkv``) or GQA/MQA (``q_proj`` + ``kv_proj``), learned or rope
positions, ``attention_window``, ``attention="flash"`` (the CUDA kernels
on the card, their plain versions on the CPU; differentiable) or
``"reference"``, ``remat`` and ``return_hidden``; and the intra-layer
parallel forms of ``chainermn_torch.parallel``: Megatron tensor
parallelism (``tp_axis``, with ``lm_head_tp``), sequence parallelism
(``attention`` in ``ring``/``ring_flash``/``ulysses`` with
``seq_axis``) and the expert-parallel MoE FFN
(``moe_experts_per_device``), each over the communicator its axis
names in ``comms``.

Parameters are f32 and the computation runs in ``dtype``, as flax's
``param_dtype`` / ``dtype`` split does: every Dense layer, the embedding
lookup and the attention projections cast their weights and inputs to
``dtype``; LayerNorms compute in f32 with output in ``dtype``; the LM
head stays f32. Training therefore keeps f32 weights, gradients and
optimizer state. The serving engine runs on a snapshot with those
weights stored in ``dtype`` once (:func:`compute_copy`), so a decode step
does not cast them again; ``generate`` runs on the model itself.

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

The FSDP scan form (JAX's ``stack_lm_blocks``, ``unstack_lm_blocks``
and ``make_lm_fsdp_scan_loss``) works on the flax-layout parameter tree
(``models.convert.flax_params``): the blocks stacked on a layer
dimension, run one layer at a time by ``optimizers.fsdp_scan_apply``
through this module's :class:`TransformerBlock`.

Numerics kept from the reference: LayerNorm epsilon 1e-6, GELU with the
tanh approximation, the LM head in f32 even in a bf16 model, learned
positions beyond ``max_len`` read as NaN (``jnp.take``'s fill mode), f32
softmax in the cached paths.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_torch.device import resolve_device
from chainermn_torch.ops.flash_attention import flash_attention
from chainermn_torch.ops.rotary import apply_rope
from chainermn_torch.parallel.expert_parallel import ExpertParallelMLP
from chainermn_torch.parallel.ring_attention import (
    local_attention_reference as dense_attention, ring_attention,
    ring_flash_attention)
from chainermn_torch.parallel.tensor_parallel import (
    ColumnParallelDense, RowParallelDense, TensorParallelMLP,
    pmax_stop_gradient, vocab_parallel_cross_entropy)
from chainermn_torch.parallel.ulysses import ulysses_attention

__all__ = ["TransformerBlock", "TransformerLM", "KVHeadShard", "generate",
           "dense_attention", "compute_copy", "lm_loss_with_aux",
           "tp_lm_loss",
           "stack_lm_blocks", "unstack_lm_blocks",
           "make_lm_fsdp_scan_loss"]

_LN_EPS = 1e-6   # flax LayerNorm's default (torch's is 1e-5)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Statistics in f32, result in ``dtype`` (flax LayerNorm(dtype=...))."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to
    ``dtype`` (a no-op on weights a serving copy already holds in it)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


_SEQ_ATTENTION = ("ring", "ring_flash", "ulysses")


def _axis_comm(comms: Dict, name: str):
    """The communicator over mesh axis ``name`` (the model's ``comms``)."""
    if name not in comms:
        raise ValueError(f"no communicator for the mesh axis {name!r}: pass "
                         f"comms={{{name!r}: comm.over_mesh(mesh, "
                         f"axes=({name!r},))}}")
    return comms[name]


class TransformerBlock(nn.Module):
    """Pre-LN block: causal attention + (dense | tensor-parallel | MoE)
    GELU FFN.

    The sharded forms keep JAX's field names for their mesh axes, and
    ``comms`` maps each axis name to the communicator over it:

    * ``tp_axis``: Megatron attention (column-parallel ``q_proj`` and
      ``kv_proj``, each rank's ``kv`` its own k heads then its own v
      heads; attention on the local heads; the row-parallel ``attn_out``)
      and the ``tp_ffn`` column/row pair;
    * ``attention`` in ``ring``/``ring_flash``/``ulysses`` with
      ``seq_axis``: the sequence split over that axis, causal attention
      on global positions (``pos_offset`` is this rank's first position);
    * ``moe_experts_per_device > 0``: the FFN is an
      :class:`~chainermn_torch.parallel.ExpertParallelMLP` over
      ``expert_axis``; :meth:`forward_with_aux` returns its load-balancing
      term.
    """

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 n_kv_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 attention: str = "flash",
                 attention_window: Optional[int] = None,
                 pos_emb: str = "learned", rope_theta: float = 10000.0,
                 seq_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None,
                 moe_experts_per_device: int = 0,
                 expert_axis: str = "expert",
                 capacity_factor: float = 1.25, moe_top_k: int = 1,
                 comms: Optional[Dict] = None, device=None):
        super().__init__()
        if attention not in ("flash", "reference", *_SEQ_ATTENTION):
            raise ValueError(f"attention must be one of 'flash', "
                             f"'reference', 'ring', 'ring_flash', "
                             f"'ulysses', got {attention!r}")
        if attention_window is not None and attention != "flash":
            raise ValueError(
                "attention_window is supported on the 'flash' path")
        self.d_model, self.n_heads, self.d_ff = d_model, n_heads, d_ff
        self.n_kv_heads = n_kv_heads or n_heads
        if n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads ({n_heads}) must be a multiple of "
                             f"n_kv_heads ({self.n_kv_heads})")
        hkv = self.n_kv_heads
        comms = dict(comms or {})
        tp, ntp = None, 1      # this rank holds n_heads / ntp heads
        if tp_axis is not None:
            if moe_experts_per_device > 0:
                raise ValueError(
                    "tp_axis does not compose with decode or the MoE FFN")
            if attention not in ("flash", "reference"):
                raise ValueError(
                    "tp_axis supports the 'flash'/'reference' attention "
                    "paths")
            tp = _axis_comm(comms, tp_axis)
            ntp = tp.size
            if n_heads % ntp or hkv % ntp:
                raise ValueError(
                    f"heads ({n_heads}/{hkv}) must divide by the "
                    f"'{tp_axis}' axis size ({ntp})")
        elif hkv != n_heads and attention not in ("flash", "reference"):
            raise ValueError(
                "n_kv_heads < n_heads is supported on the 'flash' and "
                "'reference' attention paths")
        if attention in _SEQ_ATTENTION and seq_axis is None:
            raise ValueError(f"attention={attention!r} requires seq_axis")
        self.d_head = d_model // n_heads
        self.dtype = dtype
        self.attention = attention
        self.attention_window = attention_window
        self.pos_emb = pos_emb
        self.rope_theta = rope_theta
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        self.moe_experts_per_device = moe_experts_per_device
        self.expert_axis = expert_axis
        self.seq_comm = (_axis_comm(comms, seq_axis)
                         if attention in _SEQ_ATTENTION else None)
        lin = dict(device=device)      # f32 parameters; compute in dtype
        self.ln_attn = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.local_heads, self.local_kv_heads = n_heads // ntp, hkv // ntp
        if tp_axis is not None:
            self.q_proj = ColumnParallelDense(d_model, d_model, tp,
                                              use_bias=False, dtype=dtype,
                                              **lin)
            self.kv_proj = ColumnParallelDense(d_model, 2 * hkv * self.d_head,
                                               tp, use_bias=False,
                                               dtype=dtype, **lin)
            self.attn_out = RowParallelDense(d_model // ntp, d_model, tp,
                                             use_bias=False, dtype=dtype,
                                             **lin)
        else:
            if hkv == n_heads:
                self.qkv = nn.Linear(d_model, 3 * d_model, bias=False, **lin)
            else:
                self.q_proj = nn.Linear(d_model, d_model, bias=False, **lin)
                self.kv_proj = nn.Linear(d_model, 2 * hkv * self.d_head,
                                         bias=False, **lin)
            self.attn_out = nn.Linear(d_model, d_model, bias=False, **lin)
        self.ln_ffn = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        if tp_axis is not None:
            self.tp_ffn = TensorParallelMLP(d_model, d_ff, d_model, tp,
                                            dtype=dtype, **lin)
        elif moe_experts_per_device > 0:
            self.moe = ExpertParallelMLP(
                d_model, d_ff, _axis_comm(comms, expert_axis),
                experts_per_device=moe_experts_per_device,
                capacity_factor=capacity_factor, top_k=moe_top_k,
                dtype=dtype, **lin)
        else:
            self.ffn_in = nn.Linear(d_model, d_ff, **lin)
            self.ffn_out = nn.Linear(d_ff, d_model, **lin)

    def _project(self, x):
        """h = LN(x) → q [b, l, H, dh], k/v [b, l, Hkv, dh] (this rank's
        heads under ``tp_axis``); the fused outputs split into equal
        chunks as ``jnp.split`` does."""
        b, l, _ = x.shape
        h = _layer_norm(self.ln_attn, x, self.dtype)
        if self.tp_axis is not None:
            q = self.q_proj(h)
            k, v = self.kv_proj(h).chunk(2, dim=-1)
        elif self.n_kv_heads == self.n_heads:
            q, k, v = _dense(self.qkv, h, self.dtype).chunk(3, dim=-1)
        else:
            q = _dense(self.q_proj, h, self.dtype)
            k, v = _dense(self.kv_proj, h, self.dtype).chunk(2, dim=-1)
        return (q.reshape(b, l, self.local_heads, self.d_head),
                k.reshape(b, l, self.local_kv_heads, self.d_head),
                v.reshape(b, l, self.local_kv_heads, self.d_head))

    def _repeat_kv(self, t):
        g = self.n_heads // self.n_kv_heads
        return t if g == 1 else t.repeat_interleave(g, dim=2)

    def _slab_attention(self, q, k, v):
        """Causal self-attention over the slab (training-path kernels);
        the sequence-parallel forms over the whole split sequence."""
        if self.attention in _SEQ_ATTENTION:
            fn = {"ring": ring_attention, "ring_flash": ring_flash_attention,
                  "ulysses": ulysses_attention}[self.attention]
            return fn(q, k, v, self.seq_comm, causal=True)
        if self.attention == "flash":
            return flash_attention(q, k, v, causal=True,
                                   window=self.attention_window)
        return dense_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                               causal=True)

    def _tail(self, x, att):
        """The output projection and the FFN: ``(x, aux)``, aux the MoE
        load-balancing term (None without MoE)."""
        b, l, _ = x.shape
        att = att.reshape(b, l, -1)
        if self.tp_axis is not None:
            x = x + self.attn_out(att.to(self.dtype))
        else:
            x = x + _dense(self.attn_out, att, self.dtype)
        h = _layer_norm(self.ln_ffn, x, self.dtype)
        if self.tp_axis is not None:
            return x + self.tp_ffn(h), None
        if self.moe_experts_per_device > 0:
            y, aux = self.moe(h.reshape(b * l, -1))
            return x + y.reshape(b, l, -1), aux
        y = F.gelu(_dense(self.ffn_in, h, self.dtype), approximate="tanh")
        return x + _dense(self.ffn_out, y, self.dtype), None

    def forward_with_aux(self, x, pos_offset=0):
        """Full forward → ``(x, aux)``; ``pos_offset``: scalar or per-row
        ``[b]`` (the sequence-parallel forms: this rank's first global
        position)."""
        q, k, v = self._project(x)
        if self.pos_emb == "rope":
            pos = _positions(pos_offset, x.shape[1], x.device)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        return self._tail(x, self._slab_attention(q, k, v))

    def forward(self, x, pos_offset=0):
        """Full forward. ``pos_offset``: scalar or per-row ``[b]``."""
        return self.forward_with_aux(x, pos_offset)[0]

    def forward_cached(self, x, page: Dict[str, torch.Tensor],
                       chunked: bool = False,
                       heads: Optional["KVHeadShard"] = None):
        """KV-cache forward of a slab of l new tokens starting at the
        page cursor ``page["idx"]`` (scalar, or ``[b]`` per slot). Writes
        K/V into ``page`` and advances its cursor, in place. With
        ``heads``, the page holds only this rank's KV heads: q, k and v
        are projected whole and sliced to them, attention runs on them,
        and the heads' outputs are all-gathered before the output
        projection (which, with the FFN, runs replicated)."""
        b, l, _ = x.shape
        q, k, v = self._project(x)
        if heads is not None:
            q, k, v = heads.local(q, k, v, self.n_heads // self.n_kv_heads)
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
        if heads is not None:
            att = heads.gather(att)
        return self._tail(x, att)[0]

    def _grouped_scores(self, q, kc):
        """f32 scores of q ``[b, l, H, dh]`` against a whole page ``[b,
        cap, Hkv, dh]`` → ``[b, Hkv, g, l, cap]``; query head h reads KV
        head h // g, as ``jnp.repeat`` over the head axis does."""
        b, l = q.shape[:2]
        g = self.n_heads // self.n_kv_heads
        qf = q.float().reshape(b, l, kc.shape[2], g, self.d_head)
        return (torch.einsum("bqkgd,bckd->bkgqc", qf, kc.float())
                * self.d_head ** -0.5)

    def _grouped_values(self, p, vc, b, l):
        o = torch.einsum("bkgqc,bckd->bqkgd", p, vc.float())
        return o.reshape(b, l, -1, self.d_head)

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


class KVHeadShard:
    """This rank's share of the KV heads of a head-sharded serving cache
    over ``comm`` (``n_kv_heads`` split in ``comm.size`` equal, contiguous
    parts, rank ``r`` the ``r``-th): JAX's pages at ``P(None, None, axis,
    None)``. :meth:`local` slices projected q, k, v to this rank's KV
    heads (query head ``h`` reads KV head ``h // g``); :meth:`gather`
    all-gathers the heads' attention outputs in head order."""

    def __init__(self, comm, n_kv_heads: int):
        if n_kv_heads % comm.size:
            raise ValueError(f"n_kv_heads ({n_kv_heads}) must divide by "
                             f"the axis size ({comm.size})")
        self.comm = comm
        self.kv_heads = n_kv_heads // comm.size
        self.start = comm.rank * self.kv_heads

    def local(self, q, k, v, g: int):
        a, b = self.start, self.start + self.kv_heads
        return (q[:, :, a * g:b * g].contiguous(),
                k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous())

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[..., local heads, d]`` of every rank → ``[..., heads, d]``."""
        parts = self.comm.allgather(t.contiguous())
        return torch.cat(parts.unbind(0), dim=-2)


def _positions(pos_offset, l: int, device) -> torch.Tensor:
    """Global positions: ``[l]`` for a scalar offset, ``[b, l]`` for a
    per-row ``[b]`` offset."""
    po = torch.as_tensor(pos_offset, device=device)
    ar = torch.arange(l, device=device)
    return (po[:, None] if po.dim() else po) + ar


class TransformerLM(nn.Module):
    """Causal LM: tokens ``[B, L]`` → logits ``[B, L, vocab]`` (f32), or
    the final post-LN hidden states ``[B, L, d_model]`` in ``dtype`` with
    ``return_hidden`` (the fused head+CE loss applies ``lm_head`` itself).

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Every parameter is f32; the forward computes in
    ``dtype`` where the JAX model does (see the module docstring).
    ``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant) while grad is enabled.

    The sharded forms take JAX's fields (``seq_axis``, ``tp_axis``,
    ``moe_experts_per_device``, ``expert_axis``, ``capacity_factor``,
    ``moe_top_k``; see :class:`TransformerBlock`) and ``comms``, the
    communicator over each named axis. ``lm_head_tp`` makes the head
    column-parallel over ``tp_axis`` (this rank's contiguous vocabulary
    slice of the logits; pair it with :func:`tp_lm_loss`). With
    ``seq_axis``, ``pos_offset`` is this rank's first global position.
    """

    def __init__(self, vocab: int, d_model: int = 256, n_heads: int = 8,
                 n_kv_heads: Optional[int] = None, n_layers: int = 4,
                 d_ff: int = 1024, max_len: int = 2048,
                 pos_emb: str = "learned", rope_theta: float = 10000.0,
                 attention_window: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 attention: str = "flash", remat: bool = False,
                 return_hidden: bool = False,
                 seq_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None, lm_head_tp: bool = False,
                 moe_experts_per_device: int = 0,
                 expert_axis: str = "expert",
                 capacity_factor: float = 1.25, moe_top_k: int = 1,
                 comms: Optional[Dict] = None, device=None):
        super().__init__()
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"pos_emb must be 'learned' or 'rope', got "
                             f"{pos_emb!r}")
        if lm_head_tp and tp_axis is None:
            raise ValueError("lm_head_tp requires tp_axis")
        dev = resolve_device(device)
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.n_layers, self.d_ff, self.max_len = n_layers, d_ff, max_len
        self.pos_emb, self.rope_theta = pos_emb, rope_theta
        self.attention_window = attention_window
        self.dtype, self.attention = dtype, attention
        self.remat, self.return_hidden = remat, return_hidden
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        self.lm_head_tp = lm_head_tp
        self.moe_experts_per_device = moe_experts_per_device
        self.expert_axis = expert_axis
        self.capacity_factor, self.moe_top_k = capacity_factor, moe_top_k
        self.comms = dict(comms or {})
        #: this rank's KV heads in a head-sharded serving cache (None:
        #: every head; set on a ServingStep's served copy)
        self.kv_head_shard: Optional[KVHeadShard] = None
        self.tok_emb = nn.Embedding(vocab, d_model, device=dev)
        if pos_emb == "learned":
            self.pos_embedding = nn.Parameter(
                torch.randn(max_len, d_model, device=dev) * 0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, d_ff, n_kv_heads, dtype,
                             attention, attention_window, pos_emb,
                             rope_theta, seq_axis=seq_axis, tp_axis=tp_axis,
                             moe_experts_per_device=moe_experts_per_device,
                             expert_axis=expert_axis,
                             capacity_factor=capacity_factor,
                             moe_top_k=moe_top_k, comms=self.comms,
                             device=dev)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=dev)
        if lm_head_tp:
            self.lm_head = ColumnParallelDense(
                d_model, vocab, _axis_comm(self.comms, tp_axis),
                use_bias=False, dtype=torch.float32, device=dev)
        else:
            self.lm_head = nn.Linear(d_model, vocab, bias=False, device=dev)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    def _embed(self, tokens, pos_offset):
        # flax nn.Embed(dtype=...): the table is cast, then gathered
        x = F.embedding(tokens.long(), self.tok_emb.weight.to(self.dtype))
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
        return self.lm_head(_layer_norm(self.ln_f, x, self.dtype).float())

    def _hidden_with_aux(self, tokens, pos_offset):
        x = self._embed(tokens, pos_offset)
        remat = self.remat and torch.is_grad_enabled()
        aux = None
        for blk in self.blocks:
            if remat:
                x, a = checkpoint(blk.forward_with_aux, x, pos_offset,
                                  use_reentrant=False)
            else:
                x, a = blk.forward_with_aux(x, pos_offset=pos_offset)
            if a is not None:     # flax's sow into "losses", summed
                aux = a if aux is None else aux + a
        return _layer_norm(self.ln_f, x, self.dtype), aux

    def forward_hidden(self, tokens, pos_offset=0):
        """Final post-LN hidden states ``[B, L, d_model]`` in ``dtype``."""
        return self._hidden_with_aux(tokens, pos_offset)[0]

    def forward_with_aux(self, tokens, pos_offset=0):
        """``(logits, aux)``: aux is the sum of the MoE layers'
        load-balancing terms (JAX's ``losses`` collection), None for a
        model without MoE."""
        h, aux = self._hidden_with_aux(tokens, pos_offset)
        return (h if self.return_hidden else self.lm_head(h.float())), aux

    def forward(self, tokens, pos_offset=0):
        return self.forward_with_aux(tokens, pos_offset)[0]

    def forward_cached(self, tokens, cache, chunked: bool = False):
        """The decode twin: tokens ``[B, l]`` at each row's cache cursor;
        ``cache`` is updated in place (see the module docstring). A model
        whose :attr:`kv_head_shard` is set (a head-sharded
        ``ServingStep``'s served copy) holds only this rank's KV heads in
        ``cache``."""
        x = self._embed(tokens, cache["block_0"]["idx"])
        for i, blk in enumerate(self.blocks):
            x = blk.forward_cached(x, cache[f"block_{i}"], chunked=chunked,
                                   heads=self.kv_head_shard)
        return self._head(x)


def compute_copy(model: TransformerLM) -> TransformerLM:
    """A snapshot of ``model`` to serve from, whatever its dtype: Dense
    and embedding weights stored in ``model.dtype`` (the cast the forward
    would make on every call, made once); LayerNorms, learned positions
    and the LM head in f32. It shares no storage with ``model`` and takes
    no ``.grad``, so later updates of ``model`` do not reach it: push them
    with ``load_state_dict``, which casts."""
    cast = {id(p) for mod in model.modules()
            if isinstance(mod, (nn.Linear, nn.Embedding))
            and mod is not model.lm_head
            for p in mod.parameters(recurse=False)}
    memo = {id(p): nn.Parameter(
        p.detach().to(model.dtype if id(p) in cast else p.dtype, copy=True),
        requires_grad=False) for p in model.parameters()}
    return copy.deepcopy(model, memo)


def lm_loss_with_aux(model, x, y, train: bool = True, mutable=None,
                     aux_weight: float = 0.01):
    """Next-token cross-entropy on the f32 logits plus ``aux_weight`` ·
    the MoE layers' load-balancing terms (none in a dense model), and
    argmax accuracy, in the step-factory loss signature
    (``training/step.py``)."""
    del train, mutable  # no dropout, no mutable state
    logits, aux = model.forward_with_aux(x)
    y = torch.as_tensor(y, device=logits.device).long()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    if aux is not None:
        loss = loss + aux_weight * aux
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, (acc, {})


def tp_lm_loss(model, x, y, train: bool = True, mutable=None):
    """Loss of an ``lm_head_tp`` model, in the step-factory signature:
    the vocabulary-parallel cross-entropy of this rank's logit slice (one
    max and two sums of ``[B, L]`` over ``tp_axis``; the full vocabulary
    never gathers), the same on every rank. Accuracy is the global argmax:
    the rank holding the largest logit contributes its index (ties: the
    highest rank wins)."""
    del train, mutable
    if not getattr(model, "lm_head_tp", False):
        raise ValueError(
            "tp_lm_loss expects an lm_head_tp model (sharded logits); a "
            "replicated head would inflate the psum'd normalizer by the "
            "axis size and desynchronize gradients")
    comm = _axis_comm(model.comms, model.tp_axis)
    logits = model(x)
    y = torch.as_tensor(y, device=logits.device).long()
    loss = vocab_parallel_cross_entropy(logits, y, comm).mean()
    vl = logits.shape[-1]
    local_max = logits.detach().amax(-1)
    local_arg = (comm.rank * vl + logits.detach().argmax(-1)).float()
    mine = local_max == pmax_stop_gradient(local_max, comm)
    pred = pmax_stop_gradient(
        torch.where(mine, local_arg, torch.full_like(local_arg, -1.0)),
        comm)
    acc = (pred == y.float()).float().mean()
    return loss, (acc, {})


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int,
             rng=None, temperature: float = 1.0,
             top_k: Optional[int] = None, eos_id: Optional[int] = None,
             pad_id: int = 0, use_cache: bool = True) -> torch.Tensor:
    """Autoregressive generation: prompt int ``[B, Lp]`` → int64 ``[B,
    Lp + max_new_tokens]``. The prompt prefills once into a page sized to
    the stream, then decodes one token at a time; ``use_cache=False``
    recomputes the whole prefix each step (the audit path, same draws).

    ``rng=None`` → greedy argmax (first index on ties, as
    ``jnp.argmax``); else an integer seed (``jax.random.PRNGKey(seed)``)
    or a raw key ``[2]``, threaded as JAX's ``generate`` threads it: one
    ``split`` before each token and one ``categorical`` over the whole
    ``[B, vocab]`` (``serving/sampling.py``, ``jax.random``'s stream),
    sampling at ``temperature``, truncated to the ``top_k`` highest
    logits when given. ``eos_id``: once a row emits it, later positions
    emit ``pad_id``."""
    from chainermn_torch.serving.kv_cache import (decode_apply, init_cache,
                                                  prefill_apply)
    from chainermn_torch.serving.sampling import (categorical,
                                                  request_key, split)

    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, lp = prompt.shape
    total = lp + max_new_tokens
    if total > model.max_len:
        raise ValueError(f"prompt + max_new_tokens ({total}) exceeds "
                         f"max_len ({model.max_len})")
    if max_new_tokens == 0:
        return prompt
    if rng is None:
        key = None
    elif np.ndim(rng) == 0:
        key = request_key(int(rng), prompt.device)
    else:
        key = torch.as_tensor(np.asarray(rng, np.int64),
                              device=prompt.device)
    scale = torch.tensor(max(float(temperature), 1e-6),
                         dtype=torch.float32, device=prompt.device)

    def sample(logits):
        nonlocal key
        if key is None:
            return logits.argmax(-1)
        key, sub = split(key, 2)
        scaled = logits.float() / scale
        if top_k is not None:
            kth = scaled.topk(top_k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        return categorical(sub, scaled)

    if use_cache:
        cache = init_cache(model, b, total)
        logits, cache = prefill_apply(
            model, cache, prompt, torch.full((b,), lp, device=prompt.device),
            torch.arange(b, device=prompt.device))
    else:
        logits = model(prompt)[:, -1]
    tok = sample(logits)
    done = tok == eos_id if eos_id is not None else None
    out = [prompt, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        if use_cache:
            logits, cache = decode_apply(model, cache, tok)
        else:
            logits = model(torch.cat(out, dim=1))[:, -1]
        tok = sample(logits)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            done = done | (tok == eos_id)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_lm_blocks(params):
    """A TransformerLM's flax-layout tree (tensors or arrays:
    :func:`~chainermn_torch.models.convert.flax_params`, or the JAX
    model's converted) → the scanned-stack layout: the ``block_i``
    subtrees stacked leaf by leaf on a leading layer dimension under
    ``"blocks"``, everything else as it is (JAX's
    ``models/transformer.py:508``). The layout
    :func:`make_lm_fsdp_scan_loss` consumes; :func:`unstack_lm_blocks`
    inverts it."""
    names = sorted((k for k in params if k.startswith("block_")),
                   key=lambda k: int(k.split("_")[1]))
    if not names:
        raise ValueError("no block_i subtrees found — not TransformerLM "
                         "params?")
    rest = {k: v for k, v in params.items() if not k.startswith("block_")}
    stacked = _tree_map(lambda *ls: _stack(list(ls)),
                        *[params[k] for k in names])
    return {"blocks": stacked, **rest}


def unstack_lm_blocks(packed):
    """Inverse of :func:`stack_lm_blocks`: ``{"blocks": [L, ...], ...}``
    → the ``block_i`` per-layer tree."""
    blocks = packed["blocks"]
    first = blocks
    while isinstance(first, dict):
        first = next(iter(first.values()))
    out = {k: v for k, v in packed.items() if k != "blocks"}
    for i in range(first.shape[0]):
        out[f"block_{i}"] = _tree_map(lambda leaf, i=i: leaf[i], blocks)
    return out


def make_lm_fsdp_scan_loss(model: TransformerLM):
    """A tree-form FSDP ``loss_fn`` (``optimizers.make_fsdp_train_step``
    with ``params=stack_lm_blocks(...)``) for ``model``'s configuration
    (JAX's ``models/transformer.py:539``): the embedding and learned
    positions, the layer stack through ``optimizers.fsdp_scan_apply``
    (one layer gathered at a time, re-gathered in the backward) over the
    port's own :class:`TransformerBlock` (so attention runs
    ``flash_attention``), the final LayerNorm, then the fused head + CE
    loss (``ops.fused_ce.fused_ce_head``: the logits never exist). The
    numerics are :func:`~chainermn_torch.ops.fused_ce.fused_lm_loss`'s
    on the same model. ``model`` gives the configuration only: its
    parameters are neither read nor kept.

    Refused as JAX refuses: MoE, ``tp_axis``/``seq_axis``, decode and
    ``lm_head_tp``, and a vocabulary with no multiple-of-128 tile <=
    2048 dividing it."""
    from chainermn_torch.models.convert import flax_tree_apply
    from chainermn_torch.ops.fused_ce import fused_ce_head
    from chainermn_torch.optimizers.zero import fsdp_scan_apply, full

    if getattr(model, "moe_experts_per_device", 0):
        raise ValueError("MoE models: the load-balancing aux cannot "
                         "thread through the scan; use the per-layer "
                         "model with lm_loss_with_aux")
    if (getattr(model, "tp_axis", None) is not None
            or getattr(model, "seq_axis", None) is not None):
        raise ValueError("tp_axis/seq_axis need shard_map axis context; "
                         "the FSDP scan step runs under plain jit")
    if getattr(model, "decode", False) or getattr(model, "lm_head_tp",
                                                   False):
        raise ValueError("decode/lm_head_tp unsupported in the FSDP "
                         "scan loss")
    # the JAX kernel's vocabulary tile (the port's kernels fix their own
    # tiles; the rule and its refusal are kept)
    if next((t for t in (2048, 1024, 512, 256, 128)
             if model.vocab % t == 0), None) is None:
        raise ValueError(
            f"vocab {model.vocab} has no 128-multiple tile divisor "
            "<= 2048; pad the vocabulary to a multiple of 128 for the "
            "fused-CE head")
    # the configuration, not the model: its parameters are not kept
    dtype, d, learned = model.dtype, model.d_model, model.pos_emb == "learned"
    max_len = model.max_len
    block_fn = flax_tree_apply(TransformerBlock(
        d, model.n_heads, model.d_ff, model.n_kv_heads, dtype,
        model.attention, model.attention_window, model.pos_emb,
        model.rope_theta, device="meta"))

    def loss_fn(_model, p, x, y, train=True, **kw):
        del train, kw
        x = torch.as_tensor(x).long()
        h = F.embedding(x, full(p["tok_emb"]["embedding"]).to(dtype))
        if learned:
            idx = torch.arange(x.shape[1], device=x.device)
            ok = idx < max_len
            pe = full(p["pos_emb"])[torch.remainder(idx, max_len)]
            h = h + pe.masked_fill(~ok[:, None], float("nan")).to(
                dtype)[None]
        h = fsdp_scan_apply(block_fn, p["blocks"], h)
        ln = p["LayerNorm_0"]
        h = F.layer_norm(h.float(), (d,), full(ln["scale"]),
                         full(ln["bias"]), _LN_EPS).to(dtype)
        b, l, _ = h.shape
        w = full(p["lm_head"]["kernel"]).to(h.dtype)      # [D, V]
        loss, acc = fused_ce_head(
            h.reshape(b * l, d), w,
            torch.as_tensor(y, device=h.device).reshape(-1))
        return loss, (acc, {})

    return loss_fn
