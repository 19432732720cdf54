"""Hierarchical two-level reduction: intra-tier reduce-scatter →
inter-tier all-reduce → intra-tier all-gather.

Counterpart of ``chainermn_tpu/collectives/hierarchical.py`` (the
reference's ``hierarchical_communicator.py`` and
``two_dimensional_communicator.py``): shrink the payload on the fast tier
before it crosses the slow one, so each inter link carries ``1/intra`` of
the gradient.

Two topology sources, as in JAX:

* the communicator spans two or more mesh axes (the ``("dcn", "ici")``
  mesh of ``create_communicator("hierarchical"|"two_dimensional")``): the
  last axis is the intra (fast) tier, the rest the inter tier;
* a single-axis communicator: its ranks are factored into ``inter ×
  intra`` blocks, rank ``g*intra + j`` in intra group ``g`` and inter
  group ``j`` (``intra`` defaults to ``comm.intra_size`` when that divides
  the size, else the size; ``intra=`` overrides it).

The tiers are sub-communicators made at construction on every rank (the
groups are collective over the world): over NCCL each phase is one
``reduce_scatter_tensor`` / ``all_reduce`` / ``all_gather_into_tensor``
on its subgroup. Numerics: the three phases add in another order than
one all-reduce, so float results may differ in the last bit; on
integer-valued floats they equal ``flat`` bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from chainermn_torch.collectives.base import GradReducer, register_reducer


class HierTopology:
    """The two tiers of a communicator: ``mode`` (``'axes'`` or
    ``'groups'``), ``n``, ``intra``, ``inter`` and the tier communicators
    ``intra_comm``/``inter_comm`` (size ``intra`` and ``inter``)."""

    def __init__(self, comm, intra: Optional[int] = None):
        axes = comm.axis_names
        self.comm = comm
        self.n = n = comm.size
        if len(axes) >= 2 and intra is None:
            # ("dcn", "ici")-style mesh: the last axis is the fast tier
            self.mode = "axes"
            self.intra_ax = axes[-1]
            self.inter_axes = tuple(axes[:-1])
            self.intra = comm.mesh_shape[self.intra_ax]
            self.inter = n // self.intra
            mesh = (comm._grid, comm._dims)
            self.intra_comm = comm.over_mesh(mesh, (self.intra_ax,))
            self.inter_comm = comm.over_mesh(mesh, self.inter_axes)
            return
        if len(axes) != 1:
            raise ValueError(f"explicit intra= factoring needs a single-axis "
                             f"communicator, got axes {axes}")
        self.mode = "groups"
        if intra is None:
            intra = comm.intra_size
            if not (1 <= intra <= n and n % intra == 0):
                intra = n  # degenerate: one tier (still rs → ag)
        if not (1 <= intra <= n and n % intra == 0):
            raise ValueError(f"intra {intra} must divide communicator "
                             f"size {n}")
        self.intra = intra
        self.inter = n // intra
        # rank r = g * intra + j: intra group g walks j, inter group j
        # walks g
        self.intra_comm = comm.split(("block", intra))
        self.inter_comm = comm.split(("stride", self.inter))

    def allreduce(self, v: torch.Tensor) -> torch.Tensor:
        """reduce-scatter (intra) → all-reduce (inter) → all-gather
        (intra) of a flat vector, padded to a multiple of ``intra``."""
        size = v.numel()
        pad = (-size) % self.intra
        if pad:
            v = F.pad(v, (0, pad))
        s = (self.intra_comm.reduce_scatter_flat(v) if self.intra > 1
             else v)
        if self.inter > 1:
            s = self.inter_comm.reduce_flat(s)
        out = self.intra_comm.all_gather_flat(s) if self.intra > 1 else s
        return out[:size] if pad else out

    def reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """Two-stage sum-reduce-scatter of a flat vector whose length the
        size divides; rank ``r`` ends with tile ``r``, the layout of one
        flat reduce-scatter (ZeRO state depends on it). Inter first: the
        only order whose composed tiles match the flat layout without a
        permutation, so the inter stage still carries the whole vector
        (the hierarchy buys schedule granularity here, not bytes)."""
        if self.mode != "groups" or self.inter == 1:
            return self.comm.reduce_scatter_flat(g)
        s = self.inter_comm.reduce_scatter_flat(g)
        return self.intra_comm.reduce_scatter_flat(s) if self.intra > 1 \
            else s


class HierarchicalReducer(GradReducer):
    """Bucket-fused two-level all-reduce (module docstring). ``intra``
    is the fast tier's width on a single-axis communicator."""

    name = "hierarchical"

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 intra: Optional[int] = None,
                 bucket_order: str = "emission"):
        super().__init__(comm, op, bucket_bytes, bucket_order)
        self.topology = HierTopology(comm, intra=intra)

    @torch.no_grad()
    def reduce(self, grads, state=()):
        return self._reduce_buckets(grads, self.topology.allreduce), state

    def reduce_scatter_flat(self, g: torch.Tensor, n: Optional[int] = None
                            ) -> torch.Tensor:
        n = self.comm.size if n is None else n
        return self.topology.reduce_scatter(g).div_(n)


register_reducer("hierarchical", HierarchicalReducer)
