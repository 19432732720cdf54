"""Quantized all-reduce / reduce-scatter with error feedback.

Counterpart of ``chainermn_tpu/collectives/quantized.py`` (the
reference's ``allreduce_grad_dtype``, the lossy end of the communicator
zoo). Formats:

* ``bf16`` — cast the (error-compensated) gradient to bfloat16 and
  all-reduce in bf16;
* ``int8`` — one scale for the bucket, ``max|g|/127`` shared across ranks
  by a MAX all-reduce, symmetric round half to even (``torch.round``, as
  ``jnp.round``), the codes summed in int32, dequantized with the shared
  scale;
* ``int8-block`` / ``int4-block`` — one scale per ``QUANT_BLOCK`` (256)
  elements, shared by a MAX all-reduce of the block maxima, codes in
  [-127, 127] / [-7, 7] summed in int32.

The codecs (:func:`block_quantize`, :func:`pack_int4`, :func:`wire_ratio`,
:func:`quantized_wire_bytes`) give the JAX results: the storage wire, two
int4 codes a byte. The collective is another matter: a sum of int8 codes
needs int32 to hold it, and a sum of packed nibbles is not the packed
sum, so the integer formats put **4 bytes an element** on the wire (the
JAX module sums int32 codes too, yet counts 1 or 0.5 B). The port counts
what its collectives carry (:func:`collective_wire_bytes`): the reducer's
``wire_bytes``, its plan rows and ``ReductionReport`` say int32 codes plus
the scales' MAX all-reduce, and ``auto`` prices the quantized candidate
on those bytes.

**Error feedback** (``ef=True``, the default): the residual ``e = g' −
dequant(quant(g'))`` is carried per bucket and added to the next step's
gradient (``g' = g + e``), so the compression error reaches a later
update instead of being lost. The residuals are this rank's own state:
``create_multi_node_optimizer`` keeps them in the optimizer, where they
ride ``state_dict`` and the checkpointer. The ZeRO flat hook
:meth:`QuantizedReducer.reduce_scatter_flat_ef` keeps its residual in the
flat-bucket frame (the rank's whole vector), whichever tile it receives.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from chainermn_torch.collectives.base import (GradReducer, grad_tensors,
                                              named_leaves,
                                              register_reducer)
from chainermn_torch.comm.distributed import plan_buckets

__all__ = ["QuantizedReducer", "quantize_allreduce", "QUANT_BLOCK",
           "QUANT_MODES", "WIRE_ITEMSIZE", "wire_ratio",
           "quantized_wire_bytes", "collective_wire_ratio",
           "collective_wire_bytes", "pack_int4", "unpack_int4",
           "block_quantize", "block_dequantize"]

#: storage-wire bytes per element by format, as in JAX (int4-block is 0.5
#: on a packed wire, :func:`pack_int4`)
WIRE_ITEMSIZE = {"f32": 4.0, "bf16": 2.0, "int8": 1.0,
                 "int8-block": 1.0, "int4-block": 0.5}

#: bytes per element the port's all-reduce carries by format: the integer
#: formats sum int32 codes
COLLECTIVE_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 4, "int8-block": 4,
                       "int4-block": 4}

#: formats QuantizedReducer compresses to (f32 is 'use flat')
QUANT_MODES = ("bf16", "int8", "int8-block", "int4-block")

#: elements per scale block for the blockwise formats
QUANT_BLOCK = 256

_QMAX = {"int8": 127.0, "int8-block": 127.0, "int4-block": 7.0}


def wire_ratio(fmt: str) -> float:
    """Storage-wire bytes per f32 payload byte for ``fmt``, with the f32
    scale of each block (JAX's figure)."""
    r = WIRE_ITEMSIZE[fmt] / 4.0
    if fmt.endswith("-block"):
        r += 1.0 / QUANT_BLOCK
    return r


def quantized_wire_bytes(payload_bytes: int, fmt: str) -> int:
    """Storage-wire bytes of ``payload_bytes`` of f32 payload in ``fmt``
    (values and scales), as JAX counts them."""
    if fmt == "f32":
        return int(payload_bytes)
    elems = payload_bytes / 4.0
    val = int(math.ceil(elems * WIRE_ITEMSIZE[fmt]))
    if fmt.endswith("-block"):
        return val + 4 * int(math.ceil(elems / QUANT_BLOCK))
    if fmt == "int8":
        return val + 4  # one global f32 scale
    return val  # bf16: the scale is in the exponent


def collective_wire_ratio(fmt: str) -> float:
    """Bytes the port's collectives carry per f32 payload byte: int32
    codes (4 B) for the integer formats, plus one f32 block maximum per
    block."""
    r = COLLECTIVE_ITEMSIZE[fmt] / 4.0
    if fmt.endswith("-block"):
        r += 1.0 / QUANT_BLOCK
    return r


def collective_wire_bytes(elems: int, fmt: str,
                          itemsize: int = 4) -> int:
    """Bytes this rank hands the collectives to reduce ``elems``
    elements in ``fmt``: the codes' all-reduce (padded to whole blocks
    for the block formats) and the scales' MAX all-reduce (one f32 for
    int8, one per block for the block formats; ``itemsize`` is the
    payload's for f32, whose wire is the payload)."""
    if fmt == "f32":
        return elems * itemsize
    if fmt == "bf16":
        return 2 * elems
    if fmt == "int8":
        return 4 * elems + 4
    blocks = -(-elems // QUANT_BLOCK)
    return 4 * blocks * QUANT_BLOCK + 4 * blocks


# -- int4 packing (storage wire) ------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int values in [-8, 7] two per byte (low nibble first; an odd
    length pads a zero nibble); :func:`unpack_int4` inverts it."""
    q = torch.as_tensor(q).to(torch.int32).reshape(-1)
    if q.numel() % 2:
        q = F.pad(q, (0, 1))
    lo = q[0::2] & 0xF
    hi = q[1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` sign-extended int32 values from :func:`pack_int4`'s bytes."""
    p = torch.as_tensor(packed).to(torch.int32).reshape(-1)
    both = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(-1)
    both = torch.where(both >= 8, both - 16, both)
    return both[:n]


# -- blockwise codec --------------------------------------------------------

def _scale(amax: torch.Tensor, qmax: float, shared: bool) -> torch.Tensor:
    """``amax / qmax`` (1 where ``amax`` is 0). The reducers' shared scales
    are ``amax`` times qmax's f32 reciprocal: JAX compiles its reducers,
    and XLA turns the division by the constant into that product, so the
    scales and codes are JAX's bit for bit; the codec divides, as JAX's
    eager codec does."""
    s = amax * (1.0 / qmax) if shared else amax / qmax
    return torch.where(amax > 0, s, torch.ones_like(amax))


def _block_scale(b: torch.Tensor, qmax: float, comm=None) -> torch.Tensor:
    """Per-block symmetric scale of a ``(nblocks, block)`` array; with
    ``comm`` the block maxima are MAX-shared so every rank quantizes onto
    one grid (the precondition for summing codes)."""
    amax = b.abs().amax(dim=1)
    if comm is not None:
        amax = comm.reduce_flat(amax, "max")
    return _scale(amax, qmax, comm is not None).to(b.dtype)


def _codes(b: torch.Tensor, scale: torch.Tensor, qmax: float
           ) -> torch.Tensor:
    return torch.clamp(torch.round(b / scale[:, None]), -qmax,
                       qmax).to(torch.int32)


def block_quantize(v, mode: str = "int8-block", block: int = QUANT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantize a flat float vector → ``(q, scale)``: int8
    codes (``int8-block``) or packed uint8 two a byte (``int4-block``),
    and one scale per block in the input's dtype."""
    if mode not in ("int8-block", "int4-block"):
        raise ValueError(f"block_quantize: unknown mode {mode!r}")
    qmax = _QMAX[mode]
    v = torch.as_tensor(v).reshape(-1)
    b = F.pad(v, (0, (-v.numel()) % block)).reshape(-1, block)
    scale = _block_scale(b, qmax)
    q = _codes(b, scale, qmax).reshape(-1).to(torch.int8)
    if mode == "int4-block":
        return pack_int4(q), scale
    return q, scale


def block_dequantize(q, scale, size: int, mode: str = "int8-block",
                     dtype=torch.float32, block: int = QUANT_BLOCK
                     ) -> torch.Tensor:
    """Inverse of :func:`block_quantize` (``size``: the original
    length)."""
    if mode == "int4-block":
        codes = unpack_int4(q, size + ((-size) % block))
    else:
        codes = torch.as_tensor(q).to(torch.int32).reshape(-1)
    scale = torch.as_tensor(scale)
    out = (codes.reshape(-1, block).to(dtype)
           * scale[:, None].to(dtype)).reshape(-1)
    return out[:size]


def quantize_allreduce(v: torch.Tensor, comm, mode: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized sum of a flat float vector over ``comm`` →
    ``(reduced_sum, local_dequant)``: the second is this rank's
    dequantized contribution, which error feedback subtracts from the
    value it quantized."""
    dt = v.dtype
    if mode == "bf16":
        red = comm.reduce_flat(v.to(torch.bfloat16, copy=True))
        return red.to(dt), v.to(torch.bfloat16).to(dt)
    if mode == "int8":
        amax = comm.reduce_flat(v.abs().amax().reshape(1), "max")
        scale = _scale(amax, 127.0, True).to(dt)
        q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int32)
        loc = q.to(dt) * scale
        return comm.reduce_flat(q).to(dt) * scale, loc
    if mode in ("int8-block", "int4-block"):
        qmax = _QMAX[mode]
        size = v.numel()
        b = F.pad(v, (0, (-size) % QUANT_BLOCK)).reshape(-1, QUANT_BLOCK)
        scale = _block_scale(b, qmax, comm)
        q = _codes(b, scale, qmax)
        loc = (q.to(dt) * scale[:, None]).reshape(-1)[:size]
        red = comm.reduce_flat(q.reshape(-1)).view(-1, QUANT_BLOCK)
        deq = (red.to(dt) * scale[:, None]).reshape(-1)
        return deq[:size], loc
    raise ValueError(f"unknown quantization mode {mode!r}")


class QuantizedReducer(GradReducer):
    """Scaled quantized all-reduce / reduce-scatter with error feedback.

    Args (beyond the base): ``mode`` (alias ``wire_format``), one of
    :data:`QUANT_MODES` (``'bf16'`` by default); ``ef``: carry
    error-feedback residuals (default True; ``ef=False`` is stateless).
    ``bucket_order`` is accepted and validated, but the buckets stay in
    order: the residuals' layout is the dtype-grouped in-order plan.
    """

    name = "quantized"
    wire_formats = QUANT_MODES

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 mode: str = "bf16", ef: bool = True,
                 bucket_order: str = "emission",
                 wire_format: Optional[str] = None):
        super().__init__(comm, op, bucket_bytes, bucket_order)
        if wire_format is not None:
            if wire_format == "f32":
                raise ValueError(
                    "wire_format='f32' is the uncompressed wire — use the "
                    "'flat' strategy instead of QuantizedReducer")
            mode = wire_format
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quantization mode {mode!r}; "
                             f"expected one of {QUANT_MODES}")
        self.mode = mode
        self.ef = ef
        self.stateful = bool(ef)

    # -- the static bucket plan -----------------------------------------

    def _plan(self, leaves) -> List[Tuple[torch.dtype, bool, List[int]]]:
        """``[(dtype, quantize?, [leaf indices])]``: leaves grouped by
        dtype in order; non-float leaves take an exact all-reduce and
        carry no residual."""
        by_dt = defaultdict(list)
        for i, leaf in enumerate(leaves):
            by_dt[leaf.dtype].append(i)
        plan = []
        for dt, idxs in by_dt.items():
            item = torch.empty((), dtype=dt).element_size()
            for bucket in plan_buckets(
                    [(i, leaves[i].numel() * item) for i in idxs],
                    self.bucket_bytes):
                plan.append((dt, dt.is_floating_point, bucket))
        return plan

    def init(self, params):
        """Zero residuals, one per quantized bucket of ``params``' plan
        (on the parameters' device)."""
        if not self.ef:
            return ()
        leaves = [t for _, t in named_leaves(params)]
        return tuple(
            torch.zeros(sum(leaves[i].numel() for i in b), dtype=dt,
                        device=leaves[b[0]].device)
            for dt, quant, b in self._plan(leaves) if quant)

    # -- the hot path ---------------------------------------------------

    @torch.no_grad()
    def reduce(self, grads, state=()):
        leaves = grad_tensors(grads)
        plan = self._plan(leaves)
        if self.ef:
            n_q = sum(1 for _, q, _ in plan if q)
            if len(state) != n_q:
                raise ValueError(
                    f"quantized reducer state has {len(state)} residual "
                    f"buckets but the gradient tree plans {n_q}; was the "
                    "state initialized against a different model?")
        new_state, si = [], 0
        for dt, quant, bucket in plan:
            flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
            if quant:
                if self.ef:
                    flat = flat + state[si]
                red, local = quantize_allreduce(flat, self.comm, self.mode)
                if self.ef:
                    new_state.append(flat - local)
                    si += 1
            else:
                red = self.comm.reduce_flat(flat)
            self._write_back(red, leaves, bucket)
        return grads, (tuple(new_state) if self.ef else state)

    # -- ZeRO flat-vector hooks -----------------------------------------

    def _quantize_scatter(self, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantized sum-reduce-scatter of a flat vector (length a
        multiple of the size) → ``(tile_sum, local_dequant)``, the second
        full length (the error-feedback subtrahend). A block never
        straddles a tile: the block is gcd(256, tile)."""
        comm, dt = self.comm, v.dtype
        if self.mode == "bf16":
            q = v.to(torch.bfloat16)
            return comm.reduce_scatter_flat(q).to(dt), q.to(dt)
        if self.mode == "int8":
            amax = comm.reduce_flat(v.abs().amax().reshape(1), "max")
            scale = _scale(amax, 127.0, True).to(dt)
            q = torch.clamp(torch.round(v / scale), -127,
                            127).to(torch.int32)
            return comm.reduce_scatter_flat(q).to(dt) * scale, \
                q.to(dt) * scale
        qmax = _QMAX[self.mode]
        tile = v.numel() // comm.size
        blk = math.gcd(QUANT_BLOCK, tile) or 1
        b = v.reshape(-1, blk)
        scale = _block_scale(b, qmax, comm)
        q = _codes(b, scale, qmax)
        s = comm.reduce_scatter_flat(q.reshape(-1))
        tb = tile // blk
        ts = scale[comm.rank * tb:(comm.rank + 1) * tb]
        tile_sum = (s.view(tb, blk).to(dt) * ts[:, None]).reshape(-1)
        return tile_sum, (q.to(dt) * scale[:, None]).reshape(-1)

    def reduce_scatter_flat(self, g: torch.Tensor, n: Optional[int] = None
                            ) -> torch.Tensor:
        if self.ef:
            raise RuntimeError(
                "QuantizedReducer(ef=True) threads per-rank residual state "
                "through reduce_scatter_flat_ef; call reduce_scatter_flat "
                "only on stateless (ef=False) reducers")
        n = self.comm.size if n is None else n
        return self._quantize_scatter(g)[0] / n

    def reduce_scatter_flat_ef(self, g: torch.Tensor, e: torch.Tensor,
                               n: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Error-feedback mean-reduce-scatter: ``e`` is this rank's
        residual in the flat-bucket frame (its whole vector). Returns
        ``(tile_mean, new_residual)``."""
        n = self.comm.size if n is None else n
        v = g + e
        tile_sum, local = self._quantize_scatter(v)
        return tile_sum / n, v - local

    # -- introspection --------------------------------------------------

    def plan(self, tree):
        """The buckets :meth:`reduce` reduces (dtype-grouped, in order),
        with the bytes their collectives carry."""
        named = named_leaves(tree)
        leaves = [t for _, t in named]
        rows = []
        for i, (dt, quant, bucket) in enumerate(self._plan(leaves)):
            elems = sum(leaves[j].numel() for j in bucket)
            item = leaves[bucket[0]].element_size()
            rows.append({
                "bucket": i, "keys": [named[j][0] for j in bucket],
                "bytes": elems * item,
                "wire_bytes": collective_wire_bytes(
                    elems, self.mode if quant else "f32", item),
                "algorithm": self.name})
        return rows

    def wire_bytes(self, payload_bytes: int, itemsize: int = 4) -> int:
        """Bytes handed to the collectives for one bucket of
        ``payload_bytes`` of float payload (``itemsize`` bytes an
        element)."""
        return collective_wire_bytes(payload_bytes // itemsize, self.mode,
                                     itemsize)


register_reducer("quantized", QuantizedReducer)
