"""Abstract communicator contract of the port.

Counterpart of ``chainermn_tpu/comm/base.py`` ``CommunicatorBase`` (the
reference ChainerMN ``CommunicatorBase`` surface), kept as the port's own
copy: ``rank/size/intra_rank/intra_size/inter_rank/inter_size``, array
collectives, object collectives and the model-level ``bcast_data`` /
``allreduce_grad``.

The JAX package maps ranks onto a device mesh driven by one controller.
The port is multi-controller, as the reference was: one process per GPU,
each process one rank of a ``torch.distributed`` process group, and
every collective is called by every rank with its own tensor.
"""

from __future__ import annotations

import abc
from typing import Any


class CommunicatorBase(abc.ABC):
    """Abstract base of the port's communicators."""

    # -- topology -------------------------------------------------------

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of ranks (processes, one GPU each)."""

    @property
    @abc.abstractmethod
    def rank(self) -> int:
        """This process's rank, dense in ``[0, size)``."""

    @property
    @abc.abstractmethod
    def intra_rank(self) -> int:
        """Rank within this node (picks the local GPU)."""

    @property
    @abc.abstractmethod
    def intra_size(self) -> int:
        """Ranks on this node."""

    @property
    @abc.abstractmethod
    def inter_rank(self) -> int:
        """Node index."""

    @property
    @abc.abstractmethod
    def inter_size(self) -> int:
        """Number of nodes."""

    # -- sub-communicators ----------------------------------------------

    @abc.abstractmethod
    def split(self, color: int, key: int) -> "CommunicatorBase":
        """Sub-communicator (``MPI_Comm_split`` semantics)."""

    # -- array collectives ----------------------------------------------

    @abc.abstractmethod
    def allreduce(self, x, op: str = "sum"):
        """All-reduce this rank's tensor with every other rank's."""

    @abc.abstractmethod
    def bcast(self, x, root: int = 0):
        """Broadcast ``root``'s tensor."""

    @abc.abstractmethod
    def allgather(self, x):
        """Every rank's tensor, stacked on a new leading axis."""

    @abc.abstractmethod
    def send(self, x, dest: int, tag: int = 0):
        """Point-to-point send."""

    @abc.abstractmethod
    def recv(self, src: int, tag: int = 0):
        """Point-to-point receive."""

    # -- object collectives ---------------------------------------------

    @abc.abstractmethod
    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        ...

    @abc.abstractmethod
    def allreduce_obj(self, obj: Any, op: str = "sum") -> Any:
        ...

    # -- model-level ops ------------------------------------------------

    @abc.abstractmethod
    def bcast_data(self, params, root: int = 0):
        """Make every rank's parameters equal to ``root``'s."""

    @abc.abstractmethod
    def allreduce_grad(self, grads, op: str = "mean"):
        """All-reduce gradients (the reference's hot path), optionally
        in the communication dtype ``allreduce_grad_dtype``."""

    # -- misc -----------------------------------------------------------

    def barrier(self) -> None:
        """Wait for every rank."""

    def finalize(self) -> None:
        """Release the communicator's resources."""

    @property
    def is_master(self) -> bool:
        """True on rank 0 (the reference's ``if comm.rank == 0:``)."""
        return self.rank == 0
