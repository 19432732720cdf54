"""Communicators of the port (``torch.distributed``)."""

from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.comm.distributed import (DistributedCommunicator,
                                              plan_buckets)
from chainermn_torch.comm.factory import create_communicator

__all__ = ["CommunicatorBase", "DistributedCommunicator", "plan_buckets",
           "create_communicator"]
