"""Seq2seq encoder-decoder (config #4's model family).

Counterpart of ``chainermn_tpu/models/seq2seq.py`` (reference:
examples/seq2seq/seq2seq.py, an LSTM encoder-decoder for WMT En-De with
variable-length batches). The JAX package runs each layer's recurrence
with flax's ``OptimizedLSTMCell`` under ``nn.RNN``; the port runs it with
``torch.nn.LSTM`` (cuDNN on the GPU), the same cell: gates i, f, g, o,
``c' = f c + i g``, ``h' = o tanh(c')``.

* The encoder packs each batch by its source lengths, so each row's
  carry is the one at its last valid step, as ``nn.RNN(seq_lengths=)``
  returns it. flax reads that carry at index ``seq_lengths - 1``, so a
  row of length 0 gets the carry after its whole padded row (index -1);
  the port packs such a row at the full padded length, which gives the
  same carry (and packing refuses length 0 anyway).
* :func:`beam_translate` keeps the lower index first among equal scores,
  as ``jax.lax.top_k`` does (a stable sort; ``torch.topk`` promises no
  order on ties).
* :func:`pad_batch`, :func:`corpus_bleu` and :func:`strip_special` are
  copies of the JAX module's numpy and Python code.

Parameters start as flax starts the JAX model's: embeddings normal with
variance 1/n_units, input kernels LeCun-normal, recurrent kernels
orthogonal (per gate), biases zero, the projection as flax's ``Dense``.
flax's cell has one bias per gate, torch's LSTM two: ``bias_hh`` plays
flax's, and ``bias_ih`` stays zero and frozen (``requires_grad=False``).
``seq2seq_params_from_flax`` (``models/convert.py``) loads a JAX tree.
"""

from __future__ import annotations

import collections
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from chainermn_torch.device import resolve_device
from chainermn_torch.models.mlp import flax_dense, lecun_normal_

__all__ = ["PAD", "BOS", "EOS", "Seq2Seq", "greedy_translate",
           "beam_translate", "seq2seq_loss", "pad_batch", "corpus_bleu",
           "strip_special"]

PAD, BOS, EOS = 0, 1, 2


def _flax_lstm(n_in: int, n_units: int, n_layers: int) -> nn.LSTM:
    """An ``nn.LSTM`` started as flax's ``OptimizedLSTMCell`` layers are
    (drawn on the CPU from torch's global generator)."""
    lstm = nn.LSTM(n_in, n_units, num_layers=n_layers, batch_first=True)
    with torch.no_grad():
        for k in range(n_layers):
            w_ih = getattr(lstm, f"weight_ih_l{k}")
            w_hh = getattr(lstm, f"weight_hh_l{k}")
            for gate in range(4):
                rows = slice(gate * n_units, (gate + 1) * n_units)
                lecun_normal_(w_ih[rows], w_ih.shape[1])
                # flax's kernel is [in, out]: orthogonal columns there are
                # orthogonal rows of torch's [out, in]
                nn.init.orthogonal_(w_hh[rows])
            getattr(lstm, f"bias_ih_l{k}").zero_()
            getattr(lstm, f"bias_hh_l{k}").zero_()
            # flax's cell has one bias per gate: torch's input-side bias
            # stays zero and out of training, or an optimizer would move
            # the gates' bias twice (Adam: by twice the learning rate)
            getattr(lstm, f"bias_ih_l{k}").requires_grad_(False)
    return lstm


class Seq2Seq(nn.Module):
    """LSTM encoder-decoder with teacher forcing:
    ``forward(src, src_len, tgt_in)`` → logits ``[B, T_tgt, tgt_vocab]``.
    Carries are ``(h, c)``, each ``[n_layers, B, n_units]``."""

    def __init__(self, n_layers: int = 2, n_units: int = 256,
                 src_vocab: int = 40000, tgt_vocab: int = 40000,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_layers, self.n_units = n_layers, n_units
        self.src_embed = nn.Embedding(src_vocab, n_units)
        self.tgt_embed = nn.Embedding(tgt_vocab, n_units)
        with torch.no_grad():
            for emb in (self.src_embed, self.tgt_embed):
                emb.weight.normal_(0.0, 1.0 / math.sqrt(n_units))
        self.encoder = _flax_lstm(n_units, n_units, n_layers)
        self.decoder = _flax_lstm(n_units, n_units, n_layers)
        self.proj = flax_dense(n_units, tgt_vocab)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    def encode(self, src, src_len):
        """Source ids ``[B, T]`` and lengths ``[B]`` → carries at each
        row's last valid step."""
        src = torch.as_tensor(src, device=self.device).long()
        lengths = torch.as_tensor(src_len).long().cpu()
        lengths = torch.where(lengths == 0, src.shape[1], lengths)
        packed = pack_padded_sequence(self.src_embed(src), lengths,
                                      batch_first=True, enforce_sorted=False)
        return self.encoder(packed)[1]

    def decode(self, carries, tgt_in):
        """Teacher-forced decoder over ``tgt_in [B, T]`` → (carries,
        logits ``[B, T, V]``)."""
        tgt_in = torch.as_tensor(tgt_in, device=self.device).long()
        h, carries = self.decoder(self.tgt_embed(tgt_in), carries)
        return carries, self.proj(h)

    def decode_step(self, carries, token):
        """One decode step: token ``[B]`` → (carries, logits ``[B, V]``)."""
        carries, logits = self.decode(carries, token[:, None])
        return carries, logits[:, 0]

    def forward(self, src, src_len, tgt_in):
        return self.decode(self.encode(src, src_len), tgt_in)[1]


@torch.no_grad()
def greedy_translate(model: Seq2Seq, src, src_len, max_len: int = 64):
    """Greedy decode for ``max_len`` steps; positions after EOS are PAD.
    Returns ``[B, max_len]`` token ids (int64)."""
    carries = model.encode(src, src_len)
    b = carries[0].shape[1]
    token = torch.full((b,), BOS, dtype=torch.long, device=model.device)
    done = torch.zeros(b, dtype=torch.bool, device=model.device)
    out = []
    for _ in range(max_len):
        # dlint: disable=DL104 — one card's decode: no collective waits on it
        carries, logits = model.decode_step(carries, token)
        token = torch.where(done, PAD, logits.argmax(-1))
        done = done | (token == EOS)
        out.append(token)
    return torch.stack(out, 1)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_translate(model: Seq2Seq, src, src_len, beam: int = 4,
                   max_len: int = 64, length_penalty: float = 0.6):
    """Beam-search decode, the JAX module's algorithm: K beams ride a
    folded ``[B*K]`` batch, each step keeps the global top K of the
    ``[B, K*V]`` continuations by accumulated log-probability, finished
    beams extend only with PAD at no cost, and the best beam per row is
    chosen by the GNMT score ``score / ((5 + len) / 6) ** length_penalty``.
    Returns ``[B, max_len]`` token ids (int64)."""
    k = beam
    h, c = model.encode(src, src_len)
    b = h.shape[1]
    dev = model.device
    carries = (h.repeat_interleave(k, 1), c.repeat_interleave(k, 1))
    neg = -1e9
    scores = torch.tensor([0.0] + [neg] * (k - 1), device=dev).repeat(b, 1)
    out = torch.full((b * k, max_len), PAD, dtype=torch.long, device=dev)
    tokens = torch.full((b * k,), BOS, dtype=torch.long, device=dev)
    done = torch.zeros(b * k, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None] * k
    for t in range(max_len):
        carries, logits = model.decode_step(carries, tokens)
        v = logits.shape[-1]
        logp = F.log_softmax(logits.float(), -1).reshape(b, k, v)
        pad_only = torch.full((v,), neg, device=dev)
        pad_only[PAD] = 0.0
        logp = torch.where(done.reshape(b, k)[..., None], pad_only, logp)
        scores, idx = _top_k((scores[..., None] + logp).reshape(b, k * v), k)
        gidx = (rows + idx // v).reshape(-1)
        tokens = (idx % v).reshape(-1)
        carries = (carries[0][:, gidx], carries[1][:, gidx])
        out = out[gidx]
        out[:, t] = tokens
        done = done[gidx] | (tokens == EOS)
    out = out.reshape(b, k, max_len)
    lengths = (out != PAD).sum(-1).float()
    norm = ((5.0 + lengths) / 6.0) ** length_penalty
    best = (scores / norm).argmax(-1)
    return out[torch.arange(b, device=dev), best]


def seq2seq_loss(logits, tgt_out, pad: int = PAD):
    """Token-level masked cross entropy (mean over non-pad tokens);
    returns ``(loss, mask)``."""
    tgt_out = torch.as_tensor(tgt_out, device=logits.device).long()
    mask = (tgt_out != pad).float()
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         tgt_out.reshape(-1), reduction="none")
    total = (ce.reshape(tgt_out.shape) * mask).sum()
    return total / mask.sum().clamp(min=1.0), mask


def pad_batch(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
              length_multiple: int = 16, max_len: int = 512):
    """Variable-length (src, tgt) pairs → fixed-bucket padded arrays:
    ``(src [B,Ts], src_len [B], tgt_in [B,Tt], tgt_out [B,Tt])``, int32.
    ``tgt_in`` is BOS-shifted, ``tgt_out`` EOS-terminated, both
    PAD-filled; lengths round up to ``length_multiple``."""
    def bucket(n):
        return min(max_len, -(-n // length_multiple) * length_multiple)

    srcs = [np.asarray(s) for s, _ in pairs]
    tgts = [np.asarray(t) for _, t in pairs]
    ts = bucket(max(len(s) for s in srcs))
    tt = bucket(max(len(t) for t in tgts) + 1)  # +1 for BOS/EOS shift
    b = len(pairs)
    src = np.full((b, ts), PAD, np.int32)
    src_len = np.zeros((b,), np.int32)
    tgt_in = np.full((b, tt), PAD, np.int32)
    tgt_out = np.full((b, tt), PAD, np.int32)
    for i, (s, t) in enumerate(zip(srcs, tgts)):
        s = s[:ts]
        t = t[:tt - 1]
        src[i, :len(s)] = s
        src_len[i] = len(s)
        tgt_in[i, 0] = BOS
        tgt_in[i, 1:len(t) + 1] = t
        tgt_out[i, :len(t)] = t
        tgt_out[i, len(t)] = EOS
    return src, src_len, tgt_in, tgt_out


def corpus_bleu(references, hypotheses, max_n: int = 4) -> float:
    """Corpus-level BLEU-4 with brevity penalty and no smoothing (0 when
    an n-gram order has no match); token lists with PAD/BOS/EOS already
    stripped (:func:`strip_special`)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(references, hypotheses):
        ref = [int(t) for t in ref]
        hyp = [int(t) for t in hyp]
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            rc = collections.Counter(
                tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
            hc = collections.Counter(
                tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1))
            totals[n - 1] += max(sum(hc.values()), 0)
            clipped[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
    if hyp_len == 0 or any(t == 0 for t in totals) \
            or any(c == 0 for c in clipped):
        return 0.0
    log_p = sum(math.log(c / t) for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / hyp_len)
    return bp * math.exp(log_p)


def strip_special(tokens, specials=(PAD, BOS, EOS)):
    """Cut a decoded row at EOS and drop PAD/BOS (BLEU pre-processing)."""
    out = []
    for t in np.asarray(tokens).tolist():
        if t == EOS:
            break
        if t not in specials:
            out.append(int(t))
    return out
