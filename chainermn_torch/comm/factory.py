"""create_communicator — name → communicator.

Counterpart of ``chainermn_tpu/comm/factory.py``: the reference
ChainerMN's communicator names all map to one
:class:`~chainermn_torch.comm.distributed.DistributedCommunicator` (NCCL
collectives through ``torch.distributed`` choose their own algorithm for
the topology), so reference scripts run unchanged. ``non_cuda_aware`` is
the one name with a path of its own: a gloo world whose array operations
stage through host memory (``host_staged=True``), the way several ranks
share one GPU. Only that name selects it; a NCCL communicator whose ranks
share a GPU raises and names it.
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_torch.comm.distributed import DistributedCommunicator

__all__ = ["create_communicator"]

_COMM_NAMES = (
    "xla",              # the JAX package's native name
    "naive",            # reference: per-param MPI allreduce
    "flat",             # reference: one fused buffer, flat allreduce
    "hierarchical",     # reference: NCCL intra-node + MPI inter-node
    "two_dimensional",  # reference: reduce-scatter / allreduce / gather
    "single_node",      # reference: NCCL within one node only
    "non_cuda_aware",   # reference: host-staged MPI
    "pure_nccl",        # reference: flat NCCL ring, the perf path
)


def create_communicator(communicator_name: str = "pure_nccl",
                        allreduce_grad_dtype: Optional[torch.dtype] = None,
                        device=None, mesh=None,
                        axes=None) -> DistributedCommunicator:
    """Create a communicator by name (any of the reference's names).

    ``device`` is ``cuda`` by default (NCCL) and ``cpu`` only when asked
    (gloo). ``non_cuda_aware`` stages every array operation through host
    memory over gloo. ``mesh``/``axes`` (multi-axis meshes) wait for a
    later slice (ROADMAP.md queue 1 item 2)."""
    name = communicator_name
    if name not in _COMM_NAMES:
        raise ValueError(f"unknown communicator {name!r}; expected one of "
                         f"{_COMM_NAMES}")
    if mesh is not None or axes is not None:
        raise NotImplementedError(
            "mesh/axes communicators wait for a later slice of the port "
            "(ROADMAP.md queue 1 item 2)")
    comm = DistributedCommunicator(device=device,
                                   allreduce_grad_dtype=allreduce_grad_dtype,
                                   host_staged=name == "non_cuda_aware")
    if name == "single_node" and comm.inter_size > 1:
        raise ValueError("'single_node' requires every rank on one node")
    comm.name = name
    return comm
