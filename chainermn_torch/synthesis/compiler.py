"""Compile a validated sketch program to a GradReducer.

Counterpart of ``chainermn_tpu/synthesis/compiler.py``. A
:class:`~.sketch.Program` is a linear sequence of per-tier collectives,
so the compiled form walks the steps over one flat bucket vector. JAX
addresses a tier with ``lax.psum(axis_index_groups=)``; the port gives
each tier a family of sub-communicators, as
``collectives.hierarchical.HierTopology`` does for its two tiers:

* :class:`_TierMap` resolves the program's ``tier_sizes`` onto the
  communicator: one mesh axis per tier (the ``("dcn", "ici")`` mesh of
  ``create_communicator("hierarchical")``, innermost tier = LAST axis),
  or a single axis factored into mixed-radix coordinates (rank ``r =
  Σ cᵢ·strideᵢ``, ``stride₀ = 1``: tier 0 is the fastest-varying
  coordinate, HierTopology's ``r = g·intra + j`` for any number of
  tiers), each tier a ``comm.split`` whose groups vary that coordinate
  alone. Group creation is collective over the world, so every rank
  makes every tier's family, in tier order, at construction;
* scatter stages divide evenly because each bucket is padded to the
  product of every scattered tier size (``sketch._scatter_quantum``);
* quantized wire regions use the block codec of
  ``collectives.quantized`` with the scale MAX and the integer sum both
  restricted to the region's tier group (int32 codes on the wire, as
  every quantized collective of the port);
* error feedback follows the ``QuantizedReducer`` discipline: the
  residual lives in the frame the region QUANTIZES in (the scattered
  chunk for slow-tier-only placement), is this rank's own state, and
  rides the optimizer's ``state_dict``.

Registered as strategy ``'synth'``; ``make_grad_reducer('synth', comm,
program=...)`` accepts a :class:`~.sketch.Program` or its ``to_dict``
form (what a tuned :class:`~chainermn_torch.tuning.profile_db.
SchedulePlan` carries), validates it with :func:`~.sketch.check_program`
and refuses a communicator whose size does not factor as the program's
``tier_sizes``.

Numerics: programs without wire steps are bitwise-equal to ``flat`` on
integer-valued floats (tests/test_torch_synthesis.py runs every
enumerated program of three decompositions against the flat sum).
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
from chainermn_torch.collectives.quantized import (_QMAX, QUANT_BLOCK,
                                                   _codes, _scale)
from chainermn_torch.comm.distributed import plan_buckets
from chainermn_torch.synthesis.sketch import (Program, _scatter_quantum,
                                              check_program,
                                              program_wire_bytes)


class _TierMap:
    """The program's tiers resolved onto the communicator: ``comms[i]``
    is this rank's tier-``i`` sub-communicator (None for a tier of one
    rank, whose collectives are the identity)."""

    def __init__(self, comm, tier_sizes: Tuple[int, ...]):
        axes = comm.axis_names
        self.sizes = tuple(int(s) for s in tier_sizes)
        n = math.prod(self.sizes)
        if n != comm.size:
            raise ValueError(
                f"program tier sizes {self.sizes} multiply to {n} but "
                f"the communicator has {comm.size} ranks — a plan "
                "synthesized for one decomposition must not silently "
                "run another")
        if len(axes) == 1:
            self.mode = "groups"
            self.comms = []
            for i, k in enumerate(self.sizes):
                if k == 1:
                    self.comms.append(None)
                    continue
                colors, keys = self._tier_colors(i)
                self.comms.append(comm.split(colors, keys))
            return
        if len(axes) == len(self.sizes):
            self.mode = "axes"
            mesh_sizes = comm.mesh_shape
            # innermost/fastest tier is the LAST mesh axis
            self.axis_of = tuple(reversed(axes))
            for i, ax in enumerate(self.axis_of):
                if mesh_sizes[ax] != self.sizes[i]:
                    raise ValueError(
                        f"tier {i} has size {self.sizes[i]} but mesh "
                        f"axis {ax!r} has {mesh_sizes[ax]}")
            mesh = (comm._grid, comm._dims)
            self.comms = [comm.over_mesh(mesh, (ax,)) if k > 1 else None
                          for ax, k in zip(self.axis_of, self.sizes)]
            return
        raise ValueError(
            f"cannot map {len(self.sizes)} tiers onto mesh axes "
            f"{axes}: need a single axis (factored into tier groups) or "
            "exactly one axis per tier")

    def _tier_colors(self, i: int) -> Tuple[List[int], List[int]]:
        """Every rank's (colour, key) for tier ``i``'s family: the groups
        vary tier ``i``'s coordinate and fix every other (mixed-radix,
        tier 0 fastest-varying), ordered by that coordinate."""
        strides, st = [], 1
        for s in self.sizes:
            strides.append(st)
            st *= s
        colors, keys = [], []
        for r in range(st):
            c = (r // strides[i]) % self.sizes[i]
            colors.append(r - c * strides[i])
            keys.append(c)
        return colors, keys

    # -- per-tier collectives of flat vectors ---------------------------
    def psum(self, v: torch.Tensor, i: int) -> torch.Tensor:
        c = self.comms[i]
        return v if c is None else c.reduce_flat(v)

    def psum_scatter(self, v: torch.Tensor, i: int) -> torch.Tensor:
        c = self.comms[i]
        return v if c is None else c.reduce_scatter_flat(v)

    def all_gather(self, v: torch.Tensor, i: int) -> torch.Tensor:
        c = self.comms[i]
        return v if c is None else c.all_gather_flat(v)

    def pmax(self, x: torch.Tensor, i: int) -> torch.Tensor:
        c = self.comms[i]
        return x if c is None else c.reduce_flat(x, "max")


def _q_allreduce_tier(tm: _TierMap, v: torch.Tensor, i: int, mode: str):
    """Quantized sum restricted to tier ``i``'s group: the scale MAX and
    the integer sum both stay inside the group, so every member
    quantizes onto one grid. Returns ``(reduced_sum, local_dequant)``."""
    dt = v.dtype
    if mode == "bf16":
        q = v.to(torch.bfloat16, copy=True)
        loc = q.to(dt)
        return tm.psum(q, i).to(dt), loc
    qmax = _QMAX[mode]
    size = v.numel()
    b = F.pad(v, (0, (-size) % QUANT_BLOCK)).reshape(-1, QUANT_BLOCK)
    amax = tm.pmax(b.abs().amax(dim=1), i)
    scale = _scale(amax, qmax, shared=True).to(dt)
    q = _codes(b, scale, qmax)
    loc = (q.to(dt) * scale[:, None]).reshape(-1)[:size]
    red = tm.psum(q.reshape(-1), i).view(-1, QUANT_BLOCK)
    deq = (red.to(dt) * scale[:, None]).reshape(-1)
    return deq[:size], loc


class SynthesizedReducer(GradReducer):
    """A sketch program lowered to the GradReducer contract.

    Args (beyond the base): ``program`` (required), a
    :class:`~.sketch.Program` or its ``to_dict`` form, validated with
    :func:`~.sketch.check_program`; ``ef``: carry error-feedback
    residuals for quantized programs (default True; lossless programs are
    stateless regardless); ``wire_format``: accepted for registry parity
    and checked against the program's own wire. The buckets are JAX's:
    dtype-grouped, in order (``bucket_order`` is accepted and
    validated), so the residuals' layout is stable.
    """

    name = "synth"
    wire_formats = ("f32", "bf16", "int8-block", "int4-block")

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 bucket_order: str = "emission",
                 program=None, ef: bool = True,
                 wire_format: Optional[str] = None):
        super().__init__(comm, op, bucket_bytes, bucket_order)
        if program is None:
            raise ValueError(
                "SynthesizedReducer needs program= (a synthesis.Program "
                "or its to_dict form — enumerate with "
                "synthesis.enumerate_programs or "
                "python -m chainermn_torch.tools.synth)")
        if isinstance(program, dict):
            program = Program.from_dict(program)
        errs = check_program(program)
        if errs:
            raise ValueError(
                f"invalid program {program.name!r}: " + "; ".join(errs))
        if wire_format is not None and wire_format != program.wire_format:
            raise ValueError(
                f"wire_format={wire_format!r} but program "
                f"{program.name!r} carries {program.wire_format!r} — "
                "the format is part of the program, not a separate knob")
        self.program = program
        self.tiers = _TierMap(comm, program.tier_sizes)
        self.ef = bool(ef)
        self._n_regions = sum(1 for s in program.steps
                              if s.op == "quantize")
        self.stateful = bool(self.ef and self._n_regions)

    # -- the static bucket plan -----------------------------------------
    def _plan(self, leaves):
        """``[(dtype, run_program?, [leaf indices])]``: float buckets run
        the program; integer gradients take one exact all-reduce."""
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

    def _residual_lens(self, bucket_elems: int) -> List[int]:
        """Vector length at each quantize step's entry: the frame the
        region's residual lives in."""
        quantum = _scatter_quantum(self.program) // 4
        ln = bucket_elems + ((-bucket_elems) % quantum)
        out = []
        for s in self.program.steps:
            if s.op == "quantize":
                out.append(ln)
            elif s.op == "reduce_scatter":
                ln //= self.program.tier_sizes[s.tier]
            elif s.op == "all_gather":
                ln *= self.program.tier_sizes[s.tier]
        return out

    def init(self, params):
        """Zero residuals, one per quantize region of each float bucket
        of ``params``' plan, on the parameters' device."""
        if not self.stateful:
            return ()
        leaves = [t for _, t in named_leaves(params)]
        out = []
        for dt, run, bucket in self._plan(leaves):
            if not run:
                continue
            elems = sum(leaves[i].numel() for i in bucket)
            out.extend(torch.zeros(ln, dtype=dt,
                                   device=leaves[bucket[0]].device)
                       for ln in self._residual_lens(elems))
        return tuple(out)

    # -- program execution ----------------------------------------------
    def _run_program(self, flat: torch.Tensor, residuals):
        """Walk the steps over one flat bucket vector; returns
        ``(reduced_sum, new_residuals)``."""
        prog, tm = self.program, self.tiers
        size = flat.numel()
        quantum = _scatter_quantum(prog) // 4
        pad = (-size) % quantum
        v = F.pad(flat, (0, pad)) if pad else flat
        new_res: List[torch.Tensor] = []
        ri, qmode, err = 0, None, None
        for s in prog.steps:
            if s.op == "quantize":
                qmode = s.wire
                if residuals:
                    v = v + residuals[ri]
                err = torch.zeros_like(v)
            elif s.op == "dequantize":
                if residuals:
                    new_res.append(err)
                    ri += 1
                qmode, err = None, None
            elif s.op == "reduce_scatter":
                v = tm.psum_scatter(v, s.tier)
            elif s.op == "all_gather":
                v = tm.all_gather(v, s.tier)
            elif qmode is None:  # all_reduce
                v = tm.psum(v, s.tier)
            else:
                deq, loc = _q_allreduce_tier(tm, v, s.tier, qmode)
                err = err + (v - loc)
                v = deq
        return (v[:size] if pad else v), new_res

    # -- the hot path ----------------------------------------------------
    @torch.no_grad()
    def reduce(self, grads, state=()):
        leaves = grad_tensors(grads)
        plan = self._plan(leaves)
        if self.stateful:
            n_res = (sum(1 for _, run, _ in plan if run)
                     * self._n_regions)
            if len(state) != n_res:
                raise ValueError(
                    f"synthesized reducer state has {len(state)} "
                    f"residuals but the gradient tree plans {n_res}; "
                    "was the state initialized against a different "
                    "model?")
        new_state, si = [], 0
        for _, run, bucket in plan:
            flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
            if run:
                res = (list(state[si:si + self._n_regions])
                       if self.stateful else [])
                red, nres = self._run_program(flat, res)
                if self.stateful:
                    new_state.extend(nres)
                    si += self._n_regions
            else:
                red = self.comm.reduce_flat(flat)
            self._write_back(red, leaves, bucket)
        return grads, (tuple(new_state) if self.stateful else state)

    # -- introspection ----------------------------------------------------
    def tier_wire_bytes(self, payload_bytes: int):
        """Per-rank ring bytes by tier (``tier0``, ``tier1``, ...) for one
        reduction: what the port's collectives carry (int32 codes and the
        block maxima on quantized tiers; ``program_wire_bytes(...,
        wire="collective")``)."""
        per = program_wire_bytes(self.program, payload_bytes,
                                 wire="collective")
        return {f"tier{i}": int(math.ceil(b)) for i, b in per.items()}

    def wire_bytes(self, payload_bytes: int) -> int:
        """Total per-rank ring bytes across every tier (a program's point
        is how its bytes split across tiers, so the sum is the honest
        scalar)."""
        per = program_wire_bytes(self.program, payload_bytes,
                                 wire="collective")
        return int(math.ceil(sum(per.values())))

    def plan(self, tree):
        rows = super().plan(tree)
        for b in rows:
            b["algorithm"] = f"synth:{self.program.name}"
            b["tier_wire_bytes"] = self.tier_wire_bytes(b["bytes"])
        return rows


register_reducer("synth", SynthesizedReducer)
