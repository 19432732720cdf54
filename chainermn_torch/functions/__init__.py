"""Differentiable communication functions: counterpart of
``chainermn_tpu/functions/`` (reference: chainermn/functions/)."""

from chainermn_torch.functions.collective import (allgather, allreduce,
                                                  alltoall, bcast, gather,
                                                  scatter)
from chainermn_torch.functions.eager_p2p import eager_recv, eager_send
from chainermn_torch.functions.point_to_point import (DelegateVariable,
                                                      pseudo_connect, recv,
                                                      send, transfer)

__all__ = [
    "allgather",
    "allreduce",
    "alltoall",
    "bcast",
    "gather",
    "scatter",
    "send",
    "recv",
    "transfer",
    "pseudo_connect",
    "DelegateVariable",
    "eager_send",
    "eager_recv",
]
