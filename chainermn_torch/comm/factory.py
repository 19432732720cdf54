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

``hierarchical`` and ``two_dimensional`` shape the mesh as the JAX
factory does (``chainermn_tpu/comm/factory.py``): a 2-D ``("dcn", "ici")``
grid of nodes × ``LOCAL_WORLD_SIZE`` ranks, whose last axis the
hierarchical reducer takes as the fast tier, and a 4 MiB gradient bucket
(``DEFAULT_DCN_BUCKET_BYTES``). ``mesh``/``axes`` give any mesh (a
``DeviceMesh`` with ``mesh_dim_names``) and the axes to reduce over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chainermn_torch.comm.distributed import DistributedCommunicator

__all__ = ["create_communicator", "DEFAULT_DCN_BUCKET_BYTES"]

#: the gradient bucket of the hierarchical/two_dimensional names (and the
#: gradient reducers' default), as in the JAX package: large enough that a
#: collective's launch is a small part of its transfer, small enough that
#: a model's gradients make several buckets
DEFAULT_DCN_BUCKET_BYTES = 4 * 2 ** 20

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
                        device=None, mesh=None, axes=None,
                        dcn_bucket_bytes: Optional[int] = None
                        ) -> DistributedCommunicator:
    """Create a communicator by name (any of the reference's names).

    ``device`` is ``cuda`` by default (NCCL) and ``cpu`` only when asked
    (gloo). ``non_cuda_aware`` stages every array operation through host
    memory over gloo. ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``,
    over every rank of the world) and ``axes`` (default: all of its axes)
    give the communicator over those axes; ``hierarchical`` and
    ``two_dimensional`` without a mesh build the ``("dcn", "ici")`` one.
    ``dcn_bucket_bytes`` bounds ``allreduce_grad``'s buckets and is the
    reducers' default bucket; those two names default it to 4 MiB."""
    name = communicator_name
    if name not in _COMM_NAMES:
        raise ValueError(f"unknown communicator {name!r}; expected one of "
                         f"{_COMM_NAMES}")
    if dcn_bucket_bytes is None and name in ("hierarchical",
                                             "two_dimensional"):
        dcn_bucket_bytes = DEFAULT_DCN_BUCKET_BYTES
    comm = DistributedCommunicator(device=device,
                                   allreduce_grad_dtype=allreduce_grad_dtype,
                                   host_staged=name == "non_cuda_aware",
                                   dcn_bucket_bytes=dcn_bucket_bytes)
    if name == "single_node" and comm.inter_size > 1:
        comm.finalize()
        raise ValueError("'single_node' requires every rank on one node")
    if mesh is None and axes is not None:
        mesh = (comm._grid, comm._dims)
    if mesh is None and name in ("hierarchical", "two_dimensional"):
        local = comm.intra_size
        if comm.size % local:
            comm.finalize()
            raise ValueError(f"{comm.size} ranks do not make whole nodes "
                             f"of LOCAL_WORLD_SIZE={local}")
        mesh = (np.arange(comm.size).reshape(-1, local), ("dcn", "ici"))
    if mesh is not None:
        world = comm
        comm = world.over_mesh(mesh, axes)
        comm._finalize_with = world
    comm.name = name
    return comm
