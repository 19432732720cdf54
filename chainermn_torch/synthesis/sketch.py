"""The communication-sketch IR: per-tier collective programs.

Counterpart of ``chainermn_tpu/synthesis/sketch.py``: the same IR, the
same enumerator and the same cost walker, over the port's
:class:`~chainermn_torch.tuning.topology.Topology`.

TACCL (arxiv 2111.04867) synthesizes collective algorithms from
"communication sketches" — a human-scale description of how chunks move
through the topology hierarchy — and GC3 (arxiv 2201.11840) compiles
chunk-routing programs to executable collectives. This module is the
small, deterministic middle of that pipeline for the multi-tier
:class:`~chainermn_torch.tuning.topology.Topology`:

* :class:`Step` / :class:`Program` — a linear IR of per-tier primitive
  steps (``reduce_scatter`` / ``all_reduce`` / ``all_gather``) plus
  paired ``quantize`` / ``dequantize`` wire steps that put a compressed
  format on the tiers they bracket;
* :func:`check_program` — the validity rules (every tier reduced
  exactly once, scatter/gather properly nested, wire regions paired);
* :func:`enumerate_programs` — the deterministic enumerator: every
  HiCCL-style partial cascade over the topology's tiers, plus (with
  ``lossy=True``) tier-aware quantized placements — the slow-tier-only
  placement the EQuARX analysis motivates and the quantize-everywhere
  variant;
* :func:`program_cost_us` / :func:`program_wire_bytes` — the alpha-beta
  cost walker and the exact per-tier wire-byte accounting the tests pin.

Deliberately stdlib-only (like :mod:`chainermn_torch.tuning.topology`,
the only intra-repo import): the enumerator and cost model run in CLIs
and tuners without torch. Lowering a validated program to a reducer over
per-tier sub-communicators is :mod:`chainermn_torch.synthesis.compiler`'s
job.

Wire accounting: :func:`program_wire_bytes` counts JAX's storage wire by
default (``wire="storage"``: 1 B an int8 code, two int4 codes a byte, one
4 B scale a block), and with ``wire="collective"`` the bytes the port's
collectives carry: int32 codes padded to whole blocks, plus the block
maxima's MAX all-reduce. :func:`program_cost_us` prices the topology's
own ``wire``.

Numerics contract (pinned by tests/test_torch_synthesis.py): every
program the default (lossless) enumeration emits is bitwise-equal to one
flat all-reduce on integer-valued floats — the per-tier decomposition
only re-orders exactly-representable additions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from chainermn_torch.tuning.topology import (Topology, _xfer_us,
                                             wire_ratio_table)

#: ops a step may carry. The three collectives are tier-local
#: (``tier`` indexes Topology.tiers, innermost first); the two wire
#: steps open/close a compressed-wire region and carry ``tier = -1``.
STEP_OPS = ("reduce_scatter", "all_reduce", "all_gather",
            "quantize", "dequantize")

#: wire formats a quantize step may name (the compressing subset of
#: topology.WIRE_RATIO — 'f32' is the absence of a quantize step, and
#: plain 'int8' is dominated by 'int8-block', same width better scales)
QUANT_WIRES = ("bf16", "int8-block", "int4-block")

#: elements per scale block for the blockwise formats: equal to
#: collectives.quantized.QUANT_BLOCK (this module is stdlib-only; pinned
#: by tests/test_torch_synthesis.py)
_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Step:
    """One primitive: a collective on one tier, or a wire bracket.

    ``wire`` is only meaningful on ``quantize`` steps (the format the
    bracketed collectives carry); collective and ``dequantize`` steps
    leave it ``'f32'``.
    """

    op: str
    tier: int = -1
    wire: str = "f32"

    def describe(self) -> str:
        if self.op == "quantize":
            return f"q[{self.wire}]"
        if self.op == "dequantize":
            return "dq"
        short = {"reduce_scatter": "rs", "all_reduce": "ar",
                 "all_gather": "ag"}.get(self.op, self.op)
        return f"{short}({self.tier})"


@dataclasses.dataclass(frozen=True)
class Program:
    """A validated-or-not sequence of steps bound to tier sizes.

    ``tier_sizes`` (innermost first, same order as ``Topology.tiers``)
    travels with the program so a plan persisted in the profile DB can
    rebuild the exact rank decomposition on another process — the
    compiler refuses a communicator whose size doesn't factor this way.
    """

    steps: Tuple[Step, ...]
    tier_sizes: Tuple[int, ...]
    name: str = ""

    def describe(self) -> str:
        sizes = "x".join(str(s) for s in self.tier_sizes)
        body = " ".join(s.describe() for s in self.steps)
        return f"{self.name or 'program'}[{sizes}]: {body}"

    @property
    def wire_format(self) -> str:
        """The (single) quantized wire the program carries, or 'f32'."""
        for s in self.steps:
            if s.op == "quantize":
                return s.wire
        return "f32"

    @property
    def has_scatter(self) -> bool:
        return any(s.op == "reduce_scatter" for s in self.steps)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "tier_sizes": list(self.tier_sizes),
            "steps": [[s.op, s.tier, s.wire] for s in self.steps],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Program":
        return cls(
            steps=tuple(Step(str(op), int(tier), str(wire))
                        for op, tier, wire in d["steps"]),
            tier_sizes=tuple(int(s) for s in d["tier_sizes"]),
            name=str(d.get("name", "")),
        )


# ---------------------------------------------------------------------------
# validity
# ---------------------------------------------------------------------------


def check_program(program: Program) -> List[str]:
    """The validity rules; returns a list of violations (empty = valid).

    1. every step op is known and every collective's tier index is in
       range — tier-local steps stay on their (existing) tier;
    2. every tier is REDUCED exactly once: it appears in exactly one
       ``reduce_scatter`` or ``all_reduce`` step (the "every chunk
       reduced exactly once per tier" rule — zero means the program
       computes a partial sum, twice means it double-counts);
    3. scatter/gather nesting is LIFO: each ``all_gather`` closes the
       most recent still-open ``reduce_scatter`` (any other order
       permutes the chunk layout), and every scatter is closed by the
       end (otherwise the output isn't grads-shaped);
    4. wire regions are paired and flat: ``quantize`` opens (never
       nested), ``dequantize`` closes, every region closes by the end,
       names a known format, and brackets at least one ``all_reduce``
       — and ONLY ``all_reduce`` steps: the quantized group
       reduce-scatter belongs to the flat ZeRO path
       (``reduce_scatter_flat_ef``), not the sketch IR.
    """
    errs: List[str] = []
    m = len(program.tier_sizes)
    reduced: Dict[int, int] = {}
    scatter_stack: List[int] = []
    q_open: Optional[str] = None
    q_reduces = 0
    for idx, s in enumerate(program.steps):
        where = f"step {idx} ({s.describe()})"
        if s.op not in STEP_OPS:
            errs.append(f"{where}: unknown op {s.op!r}")
            continue
        if s.op == "quantize":
            if s.wire not in QUANT_WIRES:
                errs.append(f"{where}: unknown wire {s.wire!r}; "
                            f"expected one of {QUANT_WIRES}")
            if q_open is not None:
                errs.append(f"{where}: nested quantize region")
            q_open, q_reduces = s.wire, 0
            continue
        if s.op == "dequantize":
            if q_open is None:
                errs.append(f"{where}: dequantize without open quantize")
            elif q_reduces == 0:
                errs.append(f"{where}: empty quantize region (no "
                            "all_reduce inside)")
            q_open = None
            continue
        if not (0 <= s.tier < m):
            errs.append(f"{where}: tier {s.tier} out of range for "
                        f"{m} tiers")
            continue
        if s.op in ("reduce_scatter", "all_reduce"):
            reduced[s.tier] = reduced.get(s.tier, 0) + 1
        if q_open is not None:
            if s.op != "all_reduce":
                errs.append(f"{where}: only all_reduce may sit inside "
                            "a quantize region")
            else:
                q_reduces += 1
        if s.op == "reduce_scatter":
            scatter_stack.append(s.tier)
        elif s.op == "all_gather":
            if not scatter_stack:
                errs.append(f"{where}: all_gather with no open "
                            "reduce_scatter")
            elif scatter_stack[-1] != s.tier:
                errs.append(f"{where}: all_gather(tier {s.tier}) but "
                            f"the innermost open scatter is tier "
                            f"{scatter_stack[-1]} (gathers must close "
                            "LIFO or the chunk layout permutes)")
            else:
                scatter_stack.pop()
    if q_open is not None:
        errs.append("quantize region never closed")
    if scatter_stack:
        errs.append(f"reduce_scatter on tiers {scatter_stack} never "
                    "gathered — output would not be grads-shaped")
    for t in range(m):
        c = reduced.get(t, 0)
        if c != 1:
            errs.append(f"tier {t} reduced {c} times (must be exactly "
                        "once)")
    return errs


# ---------------------------------------------------------------------------
# the deterministic enumerator
# ---------------------------------------------------------------------------


def _cascade(m: int, depth: int) -> Tuple[Step, ...]:
    """Partial cascade: scatter the ``depth`` innermost tiers, allreduce
    the rest innermost-out, gather back LIFO."""
    steps = [Step("reduce_scatter", t) for t in range(depth)]
    steps += [Step("all_reduce", t) for t in range(depth, m)]
    steps += [Step("all_gather", t) for t in reversed(range(depth))]
    return tuple(steps)


def _scatter_through(m: int) -> Tuple[Step, ...]:
    """Scatter every tier, gather every tier — the two_dimensional
    communicator's rs/ag ladder generalized to m tiers."""
    steps = [Step("reduce_scatter", t) for t in range(m)]
    steps += [Step("all_gather", t) for t in reversed(range(m))]
    return tuple(steps)


def enumerate_programs(topology: Topology, lossy: bool = False,
                       wires: Sequence[str] = ("int8-block",
                                               "int4-block"),
                       ) -> List[Program]:
    """Every candidate program for ``topology``, in declaration order —
    no RNG, ties broken by position, same topology → same list.

    Lossless families (always emitted, all bitwise-equal to ``flat`` on
    integer-valued floats):

    * ``cascade-k`` for k = 0..m-1 — scatter the k innermost tiers,
      allreduce the rest (k = 0 is the per-tier allreduce ladder; k =
      m-1 is the canonical HiCCL cascade, the ``hierarchical`` reducer
      generalized);
    * ``scatter-through`` — rs/ag on every tier (m ≥ 2 only; for m = 1
      it duplicates ``cascade-0``'s byte/launch profile).

    ``lossy=True`` adds, per wire format in ``wires``, the two
    tier-aware placements the tentpole names:

    * ``@inter`` (m ≥ 2): the canonical cascade with ONLY the slowest
      tier's allreduce quantized — ICI-local stages stay exact, the
      narrow wire goes where bandwidth is scarce;
    * ``@all``: the allreduce ladder with every tier's wire quantized.
    """
    m = len(topology.tiers)
    sizes = tuple(t.size for t in topology.tiers)
    out: List[Program] = []
    for depth in range(m):
        out.append(Program(_cascade(m, depth), sizes,
                           name=f"cascade-{depth}"))
    if m >= 2:
        out.append(Program(_scatter_through(m), sizes,
                           name="scatter-through"))
    if lossy:
        for wire in wires:
            if m >= 2:
                steps = ([Step("reduce_scatter", t) for t in range(m - 1)]
                         + [Step("quantize", wire=wire),
                            Step("all_reduce", m - 1),
                            Step("dequantize")]
                         + [Step("all_gather", t)
                            for t in reversed(range(m - 1))])
                out.append(Program(tuple(steps), sizes,
                                   name=f"cascade-q@inter-{wire}"))
            steps = ([Step("quantize", wire=wire)]
                     + [Step("all_reduce", t) for t in range(m)]
                     + [Step("dequantize")])
            out.append(Program(tuple(steps), sizes,
                               name=f"ladder-q@all-{wire}"))
    return out


# ---------------------------------------------------------------------------
# cost + wire accounting
# ---------------------------------------------------------------------------


def _pad_to(nbytes: float, quantum: int) -> float:
    if quantum <= 1:
        return nbytes
    return math.ceil(nbytes / quantum) * quantum


def _scatter_quantum(program: Program) -> int:
    """Bytes-granularity the compiler pads a bucket to: the product of
    every scattered tier size × 4 (f32) so each rs stage divides
    evenly (compiler.py applies the same padding)."""
    q = 1
    for s in program.steps:
        if s.op == "reduce_scatter":
            q *= program.tier_sizes[s.tier]
    return q * 4


def program_wire_bytes(program: Program, nbytes: int,
                       exact: bool = True,
                       wire: str = "storage") -> Dict[int, float]:
    """Per-rank wire bytes each TIER carries for one reduction of
    ``nbytes`` of f32 payload: ``{tier index: bytes}``.

    Ring byte counts (the same convention the Topology cost model
    prices): a k-ring reduce-scatter or all-gather of a chunk ``c``
    moves ``c·(k-1)/k`` per rank; an allreduce moves both. Quantized
    regions multiply the bracketed tiers' bytes by the format's wire
    ratio (``wire``'s table); with ``exact=True`` the blockwise formats
    count whole bytes. ``wire="storage"`` (JAX's accounting): 1 B an
    int8 code or two int4 codes a byte, plus one 4 B scale per
    256-element block. ``wire="collective"`` (what the port's
    collectives carry): 4 B an int32 code, the chunk padded to whole
    blocks, plus the block maxima's MAX all-reduce (4 B a block); bf16 is
    2 B an element either way.
    """
    sizes = program.tier_sizes
    chunk = float(_pad_to(nbytes, _scatter_quantum(program)))
    q: Optional[str] = None
    out: Dict[int, float] = {t: 0.0 for t in range(len(sizes))}
    ratio = wire_ratio_table(wire)

    def _on_wire(c: float) -> float:
        if q is None:
            return c
        if not exact:
            return c * ratio[q]
        elems = c / 4.0
        if q == "bf16":
            return elems * 2.0
        nblocks = math.ceil(elems / _BLOCK)
        if wire == "collective":
            return 4.0 * _BLOCK * nblocks + 4.0 * nblocks
        if q == "int8-block":
            return math.ceil(elems) + 4.0 * nblocks
        return math.ceil(elems / 2.0) + 4.0 * nblocks  # int4-block

    for s in program.steps:
        if s.op == "quantize":
            q = s.wire
            continue
        if s.op == "dequantize":
            q = None
            continue
        k = sizes[s.tier]
        if s.op == "reduce_scatter":
            out[s.tier] += _on_wire(chunk) * (k - 1) / k
            chunk /= k
        elif s.op == "all_reduce":
            out[s.tier] += 2.0 * _on_wire(chunk) * (k - 1) / k
        elif s.op == "all_gather":
            out[s.tier] += _on_wire(chunk) * (k - 1)  # chunk·k output
            chunk *= k
    return out


def program_cost_us(program: Program, topology: Topology,
                    nbytes: int) -> float:
    """Alpha-beta price of one reduction: each step pays its tier's
    launch latency plus its wire bytes over its tier's bandwidth; each
    quantize step pays the topology's (de)quantize kernel overhead
    once. The quantized regions are priced on the topology's ``wire``.
    For the canonical cascade (``cascade-(m-1)``) this reproduces
    ``Topology.estimate_us('hierarchical', nbytes)`` exactly (pinned by
    tests/test_torch_synthesis.py)."""
    if tuple(t.size for t in topology.tiers) != program.tier_sizes:
        raise ValueError(
            f"program {program.name!r} is bound to tier sizes "
            f"{program.tier_sizes} but the topology has "
            f"{tuple(t.size for t in topology.tiers)}")
    per_tier = program_wire_bytes(program, nbytes, exact=False,
                                  wire=topology.wire)
    t = 0.0
    for s in program.steps:
        if s.op == "quantize":
            t += topology.quant_overhead_us
        elif s.op in ("reduce_scatter", "all_reduce", "all_gather"):
            t += topology.tiers[s.tier].latency_us
    for tier_idx, nb in per_tier.items():
        tier = topology.tiers[tier_idx]
        t += _xfer_us(nb, tier.bw_gbps)
    return t
