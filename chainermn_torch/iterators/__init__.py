"""Iterators: serial base + multi-node wrappers.

Counterpart of ``chainermn_tpu/iterators/__init__.py`` (reference:
chainermn/iterators/): ``create_multi_node_iterator`` has the master rank
iterate and broadcast each batch (for data that cannot be scattered);
``create_synchronized_iterator`` seeds every rank's RNG identically so
ranks draw the same batches. :class:`SerialIterator` draws its order from
``np.random.RandomState(seed)`` exactly as the JAX package's does, so one
seed gives the same batches in both packages.

The JAX package keys the multi-node iterator on processes
(``inter_size``/``inter_rank``); the port keys it on ranks
(``size``/``rank``), one process per GPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chainermn_torch.comm.base import CommunicatorBase

__all__ = ["SerialIterator", "create_multi_node_iterator",
           "create_synchronized_iterator"]


class SerialIterator:
    """Epoch-aware batch iterator (local rebuild of the Chainer contract:
    ``next()``, ``epoch``, ``is_new_epoch``, ``reset()``)."""

    def __init__(self, dataset, batch_size: int, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.epoch = 0
        self.is_new_epoch = False
        self._at = 0
        self._order = self._new_order()

    def _new_order(self):
        order = np.arange(len(self.dataset))
        if self._shuffle:
            self._rng.shuffle(order)
        return order

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if self._at >= n:
            if not self._repeat and self.epoch >= 1:
                raise StopIteration
        batch_idx = self._order[self._at:self._at + self.batch_size]
        self._at += self.batch_size
        self.is_new_epoch = self._at >= n
        if self.is_new_epoch:
            self.epoch += 1
            if self._repeat:
                short = self.batch_size - len(batch_idx)
                self._order = self._new_order()
                self._at = 0
                if short:
                    batch_idx = np.concatenate(
                        [batch_idx, self._order[:short]])
                    self._at = short
            elif len(batch_idx) == 0:
                raise StopIteration
        return [self.dataset[int(i)] for i in batch_idx]

    next = __next__

    @property
    def epoch_detail(self):
        return self.epoch + self._at / max(1, len(self.dataset))

    # -- full-state resume -----------------------------------------------

    def state_dict(self) -> dict:
        """Position + shuffling-RNG snapshot: restoring it continues the
        epoch on the exact next batch, with the same future shuffles —
        unlike the reference's restart semantics, which replayed the
        epoch from its beginning with a fresh shuffle."""
        return {
            "epoch": self.epoch,
            "is_new_epoch": self.is_new_epoch,
            "at": self._at,
            "order": np.asarray(self._order).copy(),
            "rng": self._rng.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        order = np.asarray(state["order"])
        if len(order) != len(self.dataset):
            raise ValueError(
                f"iterator state is for a dataset of {len(order)} samples, "
                f"this iterator holds {len(self.dataset)} — resuming would "
                "index out of range or silently skip data")
        self.epoch = int(state["epoch"])
        self.is_new_epoch = bool(state["is_new_epoch"])
        self._at = int(state["at"])
        self._order = order
        self._rng.set_state(state["rng"])

    def set_position(self, at: int, epoch: int = 0) -> None:
        """Jump to sample offset ``at`` within ``epoch``, with a freshly
        shuffled order — the elastic shrink-to-fit rebalance: after
        resharding onto a different world size the saved per-shard
        position no longer maps 1:1, so the resumed run continues
        APPROXIMATELY (epoch counters and overall progress preserved; the
        exact next batch is not — unlike :meth:`load_state_dict`, which
        is exact but shape-preserving)."""
        n = len(self.dataset)
        self.epoch = int(epoch)
        self.is_new_epoch = False
        self._at = int(at) % n if n else 0
        self._order = self._new_order()


def create_multi_node_iterator(actual_iterator,
                               communicator: CommunicatorBase,
                               rank_master: int = 0):
    """Master process iterates; every process receives the master's batch.

    Reference: chainermn/iterators/multi_node_iterator.py. Here the batch
    rides the communicator's ``bcast_obj``; with one rank it is a
    passthrough.
    """
    if communicator.size == 1:
        return actual_iterator
    return _MultiNodeIterator(actual_iterator, communicator, rank_master)


class _MultiNodeIterator:
    """Every rank's view of the master's iterator: ``epoch``,
    ``is_new_epoch`` and ``epoch_detail`` ride the broadcast payload, so
    trigger logic (LogReport intervals, epoch-end hooks) agrees across
    ranks by construction."""

    def __init__(self, iterator, comm, rank_master):
        self._it = iterator
        self._comm = comm
        self._master = rank_master
        self.epoch = getattr(iterator, "epoch", 0)
        self.is_new_epoch = getattr(iterator, "is_new_epoch", False)
        self.epoch_detail = getattr(iterator, "epoch_detail", 0.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._comm.rank == self._master:
            try:
                batch = self._it.next()
                payload = (batch, self._it.epoch, self._it.is_new_epoch,
                           getattr(self._it, "epoch_detail", None), False)
            except StopIteration:
                payload = (None, None, None, None, True)
            payload = self._comm.bcast_obj(payload, root=self._master)
        else:
            payload = self._comm.bcast_obj(None, root=self._master)
        batch, epoch, is_new_epoch, epoch_detail, stop = payload
        if stop:
            # keep the last valid epoch counters; callers may read them
            raise StopIteration
        self.epoch, self.is_new_epoch = epoch, is_new_epoch
        self.epoch_detail = epoch_detail
        return batch

    next = __next__

    def state_dict(self) -> dict:
        """Per-rank resume state: the master saves its inner iterator's
        full position; every rank saves the shared epoch counters (the
        broadcast keeps them in agreement, so any rank's copy is the
        job's)."""
        inner = getattr(self._it, "state_dict", None)
        return {
            "epoch": self.epoch,
            "is_new_epoch": self.is_new_epoch,
            "epoch_detail": self.epoch_detail,
            "inner": inner() if (callable(inner)
                                 and self._comm.rank == self._master)
            else None,
        }

    def load_state_dict(self, state: dict) -> None:
        inner = state.get("inner")
        restore = getattr(self._it, "load_state_dict", None)
        if inner is not None and callable(restore):
            restore(inner)
        self.epoch = state["epoch"]
        self.is_new_epoch = state["is_new_epoch"]
        self.epoch_detail = state["epoch_detail"]


def create_synchronized_iterator(actual_iterator,
                                 communicator: CommunicatorBase):
    """Synchronize shuffling RNGs so every rank draws identical batches.

    Reference: chainermn/iterators/_synchronized_iterator.py — the root's
    seed is broadcast and every rank reseeds its iterator with it.
    """
    seed = communicator.bcast_obj(
        int(np.random.RandomState().randint(0, 2**31 - 1)), root=0
    )
    if isinstance(actual_iterator, SerialIterator):
        actual_iterator._rng = np.random.RandomState(seed)
        actual_iterator.reset()
    return actual_iterator
