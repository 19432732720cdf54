"""The flat strategy — ``allreduce_grad``, the numerical reference.

Counterpart of ``chainermn_tpu/collectives/flat.py``: by default it
delegates to ``comm.allreduce_grad``, so ``grad_reducer='flat'`` is bit
for bit the optimizer without a reducer. Constructed with an explicit
``bucket_bytes`` or ``bucket_order='size'`` it packs its own buckets and
all-reduces each; every element is still summed by one all-reduce over
the same ranks, so only the packing changes.
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_torch.collectives.base import GradReducer, register_reducer


class FlatReducer(GradReducer):
    """One all-reduce per bucket: ``comm.allreduce_grad``, unless explicit
    knobs pin a bucket plan of its own. Without them its plan shows
    ``allreduce_grad``'s buckets (the communicator's
    ``grad_bucket_bytes``), the ones it actually reduces."""

    name = "flat"

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 bucket_order: str = "emission"):
        super().__init__(comm, op, bucket_bytes, bucket_order)
        self._explicit = (bucket_bytes is not None
                          or bucket_order != "emission")
        if not self._explicit:
            self.bucket_bytes = comm.grad_bucket_bytes

    @torch.no_grad()
    def reduce(self, grads, state=()):
        if not self._explicit:
            return self.comm.allreduce_grad(grads, self.op), state
        return self._reduce_buckets(grads, self.comm.reduce_flat), state


register_reducer("flat", FlatReducer)
