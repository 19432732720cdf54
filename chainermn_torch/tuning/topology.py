"""Explicit multi-tier machine topology for schedule tuning.

Counterpart of ``chainermn_tpu/tuning/topology.py``. A schedule search
needs the machine described as an explicit hierarchy of tiers, each with
its own size, launch latency (alpha) and per-rank bandwidth (beta), as
TACCL (arxiv 2111.04867) and HiCCL (arxiv 2408.05962) describe it. A
:class:`Topology` is an ordered tuple of :class:`Tier` objects, fastest
(innermost) first, slowest last, plus a deterministic
:meth:`~Topology.fingerprint` that keys the persistent profile DB
(:mod:`.profile_db`).

The tiers of this machine: NVLink between the GPUs of one node, the
network between nodes. The default intra tier is the fit that
``python -m chainermn_torch.collectives.auto --ranks 4 --repeats 3``
printed over NCCL on four NVIDIA H100 80GB HBM3 of one host (NVLink),
700.00 W power limit each: 55.31 µs, 368.22 GB/s and a quantize overhead
of 138.77 µs (the latency includes ~50 µs of the port's host dispatch).
The inter tier is NOT measured (no second node was available): it keeps
the JAX package's 100 µs and 25 GB/s. The keyword names stay JAX's
(``ici_*`` for the intra tier, ``dcn_*`` for the inter tier), so one call
site serves both packages.

Stdlib only: ``collectives/``, ``synthesis/`` and the CLIs import it
without cycles.

Cost model: alpha-beta with ring all-reduce byte counts (``2·b·(k-1)/k``
a rank over a ring of ``k``). For two tiers :meth:`Topology.estimate_us`
equals :meth:`chainermn_torch.collectives.CostModel.estimate_us`
(``CostModel.as_topology`` gives the one estimator). The quantized
strategy is priced on the bytes the port's collectives carry
(``wire="collective"``: int32 codes for the integer formats); a topology
built with ``wire="storage"`` prices JAX's storage wire
(:data:`WIRE_RATIO`) and gives JAX's estimates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: intra tier (NVLink; JAX's ``ici`` keywords): the port's fit on four
#: NVIDIA H100 80GB HBM3, 700.00 W (module docstring)
ICI_LATENCY_US = 55.31
ICI_BW_GBPS = 368.22
#: inter tier (the network between nodes; JAX's ``dcn`` keywords): not
#: measured, the JAX package's figures
DCN_LATENCY_US = 100.0
DCN_BW_GBPS = 25.0
#: quantize/dequantize overhead of the quantized strategy (the same fit)
QUANT_OVERHEAD_US = 138.77

#: storage-wire bytes per f32 payload byte, by wire format: the values
#: plus the f32 scale of each 256-element block. JAX's table; equal to
#: ``collectives.quantized.wire_ratio`` (pinned by the tests)
WIRE_RATIO = {
    "f32": 1.0,
    "bf16": 0.5,
    "int8": 0.25,
    "int8-block": 0.25 + 1.0 / 256,
    "int4-block": 0.125 + 1.0 / 256,
}

#: bytes the port's all-reduce carries per f32 payload byte: the integer
#: formats sum int32 codes. Equal to
#: ``collectives.quantized.collective_wire_ratio`` (pinned by the tests)
COLLECTIVE_WIRE_RATIO = {
    "f32": 1.0,
    "bf16": 0.5,
    "int8": 1.0,
    "int8-block": 1.0 + 1.0 / 256,
    "int4-block": 1.0 + 1.0 / 256,
}

_WIRES = {"collective": COLLECTIVE_WIRE_RATIO, "storage": WIRE_RATIO}


@dataclasses.dataclass(frozen=True)
class Tier:
    """One level of the machine hierarchy: ``size`` ranks connected at
    ``bw_gbps`` per rank with ``latency_us`` launch latency."""

    name: str
    size: int
    latency_us: float
    bw_gbps: float


def _ring_bytes(nbytes: float, k: int) -> float:
    return 2.0 * nbytes * (k - 1) / max(k, 1)


def _xfer_us(nbytes: float, bw_gbps: float) -> float:
    return nbytes / (bw_gbps * 1e3)  # 1 GB/s == 1e3 bytes/us


def wire_ratio_table(wire: str) -> dict:
    """The wire-ratio table a topology's ``wire`` names."""
    try:
        return _WIRES[wire]
    except KeyError:
        raise ValueError(f"unknown wire accounting {wire!r}; expected one "
                         f"of {tuple(_WIRES)}") from None


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ordered multi-tier topology, innermost/fastest tier first.

    ``platform``/``device_kind`` only feed :meth:`fingerprint`: a profile
    measured on one device kind must not tune another. ``wire`` says
    which bytes the quantized strategy is priced on (module docstring).
    """

    tiers: Tuple[Tier, ...]
    platform: str = "cpu"
    device_kind: str = ""
    quant_overhead_us: float = QUANT_OVERHEAD_US
    wire: str = "collective"

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("Topology needs at least one tier")
        wire_ratio_table(self.wire)

    # -- shape ----------------------------------------------------------
    @property
    def n(self) -> int:
        out = 1
        for t in self.tiers:
            out *= t.size
        return out

    @property
    def intra(self) -> int:
        return self.tiers[0].size

    @property
    def inter(self) -> int:
        return self.n // self.intra

    def fingerprint(self) -> str:
        """Deterministic key for the profile DB: platform, device kind,
        and the per-tier sizes (no hostnames, no PIDs, no timestamps)."""
        kind = (self.device_kind or "generic").lower().replace(" ", "-")
        dims = "+".join(f"{t.name}:{t.size}" for t in self.tiers)
        return f"{self.platform}:{kind}/{dims}"

    # -- construction ---------------------------------------------------
    @classmethod
    def from_comm(cls, comm, intra: Optional[int] = None,
                  ici_latency_us: float = ICI_LATENCY_US,
                  ici_bw_gbps: float = ICI_BW_GBPS,
                  dcn_latency_us: float = DCN_LATENCY_US,
                  dcn_bw_gbps: float = DCN_BW_GBPS,
                  quant_overhead_us: Optional[float] = None) -> "Topology":
        """Describe a communicator as tiers, with the rules of
        ``collectives.hierarchical.HierTopology``: a communicator over two
        or more mesh axes takes its LAST axis as the intra tier and every
        preceding axis as an inter tier (named after the axes); a
        single-axis one is factored into ``inter × intra`` (tiers
        ``nvlink`` and ``net``), ``intra`` defaulting to
        ``comm.intra_size`` (one tier when that does not divide the size).
        Size-1 outer tiers are dropped. ``platform`` is ``gpu`` with the
        card's name as ``device_kind`` on a CUDA communicator, else the
        device type."""
        import torch

        if quant_overhead_us is None:
            quant_overhead_us = QUANT_OVERHEAD_US
        dev = comm.device
        if dev.type == "cuda":
            platform, kind = "gpu", torch.cuda.get_device_name(dev)
        else:
            platform, kind = dev.type, dev.type
        axes = comm.axis_names
        if len(axes) >= 2 and intra is None:
            sizes = comm.mesh_shape
            tiers = [Tier(axes[-1], sizes[axes[-1]],
                          ici_latency_us, ici_bw_gbps)]
            for ax in reversed(axes[:-1]):  # innermost-out
                if sizes[ax] > 1:
                    tiers.append(Tier(ax, sizes[ax],
                                      dcn_latency_us, dcn_bw_gbps))
            return cls(tuple(tiers), platform, kind, quant_overhead_us)
        n = comm.size
        if intra is None:
            intra = comm.intra_size
            if not (1 <= intra <= n and n % intra == 0):
                intra = n  # degenerate: one tier
        if not (1 <= intra <= n and n % intra == 0):
            raise ValueError(
                f"intra {intra} must divide communicator size {n}")
        tiers = [Tier("nvlink", intra, ici_latency_us, ici_bw_gbps)]
        if n // intra > 1:
            tiers.append(Tier("net", n // intra,
                              dcn_latency_us, dcn_bw_gbps))
        return cls(tuple(tiers), platform, kind, quant_overhead_us)

    # -- the cost model -------------------------------------------------
    def wire_ratio(self, wire_format: str) -> float:
        """Wire bytes per f32 payload byte of ``wire_format`` under this
        topology's accounting."""
        try:
            return wire_ratio_table(self.wire)[wire_format]
        except KeyError:
            raise ValueError(
                f"unknown wire_format {wire_format!r}; expected one "
                f"of {tuple(WIRE_RATIO)}") from None

    def estimate_us(self, strategy: str, nbytes: int,
                    wire_format: str = "bf16") -> float:
        """Modeled time for ONE reduction of ``nbytes`` payload.

        ``flat``: one all-reduce whose ring crosses the slowest tier.
        ``hierarchical``: reduce-scatter + all-gather on every tier but
        the last and an all-reduce on the last, each stage carrying
        ``1/prod(inner sizes)`` of the bytes (one tier: rs + ag).
        ``quantized``: flat at ``wire_format``'s wire width
        (:meth:`wire_ratio`) plus the (de)quantize overhead."""
        slow = self.tiers[-1]
        if strategy == "flat":
            return slow.latency_us + _xfer_us(
                _ring_bytes(nbytes, self.n), slow.bw_gbps)
        if strategy == "hierarchical":
            if len(self.tiers) == 1:
                t0 = self.tiers[0]
                return 2 * t0.latency_us + _xfer_us(
                    _ring_bytes(nbytes, t0.size), t0.bw_gbps)  # rs + ag
            t, carried = 0.0, float(nbytes)
            for tier in self.tiers[:-1]:
                # rs + ag: two launches; _ring_bytes' 2x covers both
                t += 2 * tier.latency_us + _xfer_us(
                    _ring_bytes(carried, tier.size), tier.bw_gbps)
                carried /= tier.size
            t += slow.latency_us + _xfer_us(
                _ring_bytes(carried, slow.size), slow.bw_gbps)
            return t
        if strategy == "quantized":
            wire = nbytes * self.wire_ratio(wire_format)
            return (slow.latency_us + self.quant_overhead_us
                    + _xfer_us(_ring_bytes(wire, self.n), slow.bw_gbps))
        raise ValueError(f"unknown strategy {strategy!r}")

    def describe(self) -> str:
        return " → ".join(
            f"{t.name}[{t.size}] {t.bw_gbps}GB/s/{t.latency_us}us"
            for t in self.tiers)


def single_tier(n: int, name: str = "nvlink",
                latency_us: float = ICI_LATENCY_US,
                bw_gbps: float = ICI_BW_GBPS) -> Topology:
    """A one-tier test/CLI convenience topology."""
    return Topology((Tier(name, n, latency_us, bw_gbps),))


def two_tier(intra: int, inter: int) -> Topology:
    """GPUs of a node over NVLink × nodes over the network, with the
    default parameters, on platform ``gpu``."""
    tiers = [Tier("nvlink", intra, ICI_LATENCY_US, ICI_BW_GBPS)]
    if inter > 1:
        tiers.append(Tier("net", inter, DCN_LATENCY_US, DCN_BW_GBPS))
    return Topology(tuple(tiers), platform="gpu")
