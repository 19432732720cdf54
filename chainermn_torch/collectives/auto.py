"""The ``auto`` strategy: a latency/bandwidth cost model picks flat,
hierarchical or quantized per bucket.

Counterpart of ``chainermn_tpu/collectives/auto.py``. The model is the
alpha-beta form per tier (latency + bytes over bandwidth) with ring
all-reduce byte counts (``2·b·(k−1)/k`` a rank over a ring of ``k``):

* small buckets are latency bound → ``flat`` (one collective);
* large buckets with an inter tier → ``hierarchical`` (the inter tier
  carries ``1/intra`` of the bytes);
* with ``lossy=True``, ``quantized`` in ``wire_format`` (off by default:
  a strategy named "auto" must not change numerics on its own).

The quantized candidate is priced on the bytes the port's collectives
carry (:func:`~chainermn_torch.collectives.quantized.
collective_wire_ratio`: int32 codes for the integer formats), so with
``lossy=True`` and an integer format the port may choose otherwise than
JAX, which prices those formats at 1 or 0.5 B an element. For two tiers
JAX's ``Topology`` estimates equal :meth:`CostModel.estimate_us` (its
docstring says so), so :meth:`AutoReducer.choose` uses the latter.

:func:`measure_strategies` times real reductions with CUDA events on the
card; on the CPU it returns ``{}`` untimed (gloo "collectives" there are
memcpys, and any number would mislead the picker). The tuning profile
database and explicit multi-tier topologies (``topology=``, ``profile=``,
``db=``) wait for ROADMAP.md queue 1 item 13.

Run ``python -m chainermn_torch.collectives.auto --ranks 4`` on a host
with four GPUs to time the strategies over NCCL and fit the intra tier's
latency and bandwidth (it starts its ranks itself).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from chainermn_torch.collectives.base import (_ITEM13, GradReducer,
                                              register_reducer)
from chainermn_torch.collectives.hierarchical import HierTopology
from chainermn_torch.collectives.quantized import (collective_wire_bytes,
                                                   collective_wire_ratio,
                                                   quantize_allreduce)

__all__ = ["CostModel", "AutoReducer", "measure_strategies"]


@dataclasses.dataclass
class CostModel:
    """Per-tier alpha-beta parameters, microseconds and GB/s.

    The intra tier (JAX's ``ici_*`` field names) and the quantize
    overhead are the fit that ``python -m chainermn_torch.collectives.auto
    --ranks 4 --repeats 3`` printed over NCCL on four NVIDIA H100 80GB
    HBM3 of one host (NVLink), 700.00 W power limit each: three sweeps of
    64 KiB to 64 MiB, each time a reduction through the port's Python
    path, so the latency includes ~50 µs of host dispatch. The inter tier
    is NOT measured (no second node was available): ``dcn_*`` keep the
    JAX package's figures for a TPU's data-centre network; they enter only
    when ``inter > 1``."""

    ici_latency_us: float = 55.31
    ici_bw_gbps: float = 368.22
    dcn_latency_us: float = 100.0
    dcn_bw_gbps: float = 25.0
    quant_overhead_us: float = 138.77

    @staticmethod
    def _xfer_us(nbytes: float, bw_gbps: float) -> float:
        return nbytes / (bw_gbps * 1e3)  # 1 GB/s == 1e3 bytes/us

    def estimate_us(self, strategy: str, nbytes: int, topo,
                    wire_format: str = "bf16") -> float:
        """Modeled time for ONE reduction of ``nbytes`` payload over
        ``topo`` (anything with ``n``, ``intra``, ``inter``)."""
        n, intra, inter = topo.n, topo.intra, topo.inter

        def ring(b, k):
            return 2.0 * b * (k - 1) / max(k, 1)

        slow_lat = self.dcn_latency_us if inter > 1 else self.ici_latency_us
        slow_bw = self.dcn_bw_gbps if inter > 1 else self.ici_bw_gbps
        if strategy == "flat":
            return slow_lat + self._xfer_us(ring(nbytes, n), slow_bw)
        if strategy == "hierarchical":
            t = 2 * self.ici_latency_us + self._xfer_us(
                ring(nbytes, intra), self.ici_bw_gbps)
            if inter > 1:
                t += self.dcn_latency_us + self._xfer_us(
                    ring(nbytes / intra, inter), self.dcn_bw_gbps)
            return t
        if strategy == "quantized":
            wire = nbytes * collective_wire_ratio(wire_format)
            return (slow_lat + self.quant_overhead_us
                    + self._xfer_us(ring(wire, n), slow_bw))
        raise ValueError(f"unknown strategy {strategy!r}")


_CACHE: Dict[tuple, Dict[Tuple[str, int], float]] = {}


def measure_strategies(
        comm,
        sizes: Sequence[int] = (1 << 16, 1 << 20, 1 << 22, 1 << 24),
        strategies: Sequence[str] = ("flat", "hierarchical", "quantized"),
        steps: int = 10, intra: Optional[int] = None, db=None,
        ) -> Dict[Tuple[str, int], float]:
    """Measured sweep ``{(strategy, payload_bytes): microseconds}``: real
    reductions of an f32 vector over ``comm``, timed with CUDA events
    (``steps`` calls after two warm-up calls; the quantized strategy in
    bf16), the slowest rank's time for each entry, so every rank holds
    the same table. Memoized per (ranks, axes, sizes, strategies,
    intra). Every rank calls it. On the CPU it returns ``{}`` untimed.
    Feed the result to ``AutoReducer(measured=...)``."""
    if db is not None:
        raise NotImplementedError(f"measure_strategies(db=...) {_ITEM13}")
    key = (comm.members, tuple(comm.axis_names), tuple(sizes),
           tuple(strategies), intra)
    if key in _CACHE:
        return _CACHE[key]
    if comm.device.type != "cuda":
        _CACHE[key] = {}
        return {}
    topo = HierTopology(comm, intra=intra)
    kernels = {
        "flat": comm.reduce_flat,
        "hierarchical": topo.allreduce,
        "quantized": lambda v: quantize_allreduce(v, comm, "bf16")[0],
    }
    out: Dict[Tuple[str, int], float] = {}
    for nbytes in sizes:
        x = torch.zeros(max(1, nbytes // 4), device=comm.device)
        for s in strategies:
            for _ in range(2):
                kernels[s](x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(comm.device)
            start.record()
            for _ in range(steps):
                kernels[s](x)
            end.record()
            end.synchronize()
            out[(s, nbytes)] = start.elapsed_time(end) / steps * 1e3
    out = comm.allreduce_obj(out, "max")
    _CACHE[key] = out
    return out


class AutoReducer(GradReducer):
    """Cost-model-driven strategy per bucket (module docstring).

    Args (beyond the base): ``cost`` (a :class:`CostModel`); ``measured``
    (a :func:`measure_strategies` table, the nearest measured size
    winning over the model); ``lossy`` (allow the quantized candidate,
    without error feedback: this strategy is stateless); ``intra`` (as
    in the hierarchical reducer); ``wire_format`` (the quantized
    candidate's wire, ``'bf16'`` by default; ``'f32'`` turns the lossy
    candidate off). Every rank must see the same ``cost``/``measured``,
    so that all choose alike. ``topology``/``profile`` wait for queue 1
    item 13."""

    name = "auto"
    wire_formats = ("f32", "bf16", "int8", "int8-block", "int4-block")

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 intra: Optional[int] = None,
                 cost: Optional[CostModel] = None,
                 measured: Optional[Dict[Tuple[str, int], float]] = None,
                 lossy: bool = False, bucket_order: str = "emission",
                 topology=None, profile=None,
                 wire_format: Optional[str] = None):
        if topology is not None or profile is not None:
            raise NotImplementedError(
                f"AutoReducer(topology=..., profile=...) {_ITEM13}")
        super().__init__(comm, op, bucket_bytes, bucket_order)
        if wire_format is not None and wire_format not in self.wire_formats:
            raise ValueError(f"unknown wire_format {wire_format!r}; "
                             f"expected one of {self.wire_formats}")
        if wire_format == "f32":
            lossy = False
        self.wire_format = (wire_format if wire_format not in (None, "f32")
                            else "bf16")
        self.topology = HierTopology(comm, intra=intra)
        self.cost = cost or CostModel()
        self.measured = dict(measured or {})
        self.lossy = lossy

    def _estimate(self, strategy: str, nbytes: int) -> float:
        pts = [(abs(sz - nbytes), us) for (s, sz), us
               in self.measured.items() if s == strategy]
        if pts:  # the nearest measured size wins over the model
            return min(pts)[1]
        return self.cost.estimate_us(strategy, nbytes, self.topology,
                                     wire_format=self.wire_format)

    def choose(self, nbytes: int) -> str:
        cands = ["flat", "hierarchical"] + (
            ["quantized"] if self.lossy else [])
        # stable tie-break: flat first (fewest launches, exact)
        return min(cands, key=lambda s: (self._estimate(s, nbytes),
                                         cands.index(s)))

    def _reduce_one(self, flat: torch.Tensor) -> torch.Tensor:
        algo = self.choose(flat.numel() * flat.element_size())
        if algo == "hierarchical":
            return self.topology.allreduce(flat)
        if algo == "quantized" and flat.dtype.is_floating_point:
            return quantize_allreduce(flat, self.comm, self.wire_format)[0]
        return self.comm.reduce_flat(flat)

    @torch.no_grad()
    def reduce(self, grads, state=()):
        return self._reduce_buckets(grads, self._reduce_one,
                                    cast=False), state

    def reduce_scatter_flat(self, g: torch.Tensor, n: Optional[int] = None
                            ) -> torch.Tensor:
        n = self.comm.size if n is None else n
        if self.choose(g.numel() * g.element_size()) == "hierarchical":
            return self.topology.reduce_scatter(g).div_(n)
        return self.comm.reduce_scatter_flat(g).div_(n)

    def plan(self, tree):
        rows = super().plan(tree)
        for b in rows:
            algo = self.choose(b["bytes"])
            b["algorithm"] = f"auto:{algo}"
            b["wire_bytes"] = (
                collective_wire_bytes(b["bytes"] // 4, self.wire_format)
                if algo == "quantized" else b["bytes"])
            b["est_us"] = round(self._estimate(algo, b["bytes"]), 2)
        return rows


register_reducer("auto", AutoReducer)


def fit_cost_model(tables: Sequence[Dict[Tuple[str, int], float]], n: int
                   ) -> Dict[str, float]:
    """The intra tier's latency (µs) and bandwidth (GB/s) that fit the
    ``flat`` times of one-tier sweeps (:func:`measure_strategies` tables)
    by least squares on the ring bytes (``2·b·(n−1)/n``), and the
    quantize overhead (µs): the mean of the bf16 ``quantized`` times less
    the fitted model's bf16 transfer."""
    def ring(b):
        return 2.0 * b * (n - 1) / n

    pts = [(ring(b), us) for t in tables for (s, b), us in t.items()
           if s == "flat"]
    mx = sum(x for x, _ in pts) / len(pts)
    my = sum(y for _, y in pts) / len(pts)
    slope = (sum((x - mx) * (y - my) for x, y in pts)
             / sum((x - mx) ** 2 for x, _ in pts))
    lat = my - slope * mx
    quant = [us - lat - 0.5 * ring(b) * slope for t in tables
             for (s, b), us in t.items() if s == "quantized"]
    return {"ici_latency_us": lat, "ici_bw_gbps": 1.0 / (slope * 1e3),
            "quant_overhead_us": sum(quant) / len(quant)}


def _main(argv=None) -> int:
    """Time the strategies over NCCL on this host's GPUs, ``--repeats``
    sweeps, and print each table and the fit over all of them (rank 0),
    one JSON object a line."""
    import argparse
    import json
    import os
    import socket
    import subprocess
    import sys

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sizes", default="65536,1048576,4194304,16777216,"
                                       "67108864")
    args = ap.parse_args(argv)
    if "RANK" not in os.environ:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, *(argv or sys.argv[1:])],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.ranks),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(args.ranks),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
            for r in range(args.ranks)]
        return max(p.wait() for p in procs)
    from chainermn_torch.comm import create_communicator

    comm = create_communicator("pure_nccl")
    try:
        sizes = [int(x) for x in args.sizes.split(",")]
        tables = []
        for _ in range(args.repeats):
            _CACHE.clear()
            tables.append(measure_strategies(comm, sizes, steps=args.steps))
            if comm.rank == 0:
                print(json.dumps({"ranks": comm.size, "measured_us": {
                    f"{s}@{b}": us
                    for (s, b), us in sorted(tables[-1].items())}}))
        if comm.rank == 0:
            print(json.dumps({"fit": fit_cost_model(tables, comm.size)}),
                  flush=True)
    finally:
        comm.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
