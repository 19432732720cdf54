"""Prefetching data loader backed by the port's native runtime.

Counterpart of ``chainermn_tpu/training/loader.py``: a C++ worker thread
(``csrc/chainermn_native.cpp``, built and bound by
``chainermn_torch/ops/native.py``) gathers the next batch's rows into a
reusable buffer while the current step runs, and the Python side only
copies the finished buffer out. The batch order for a seed is the JAX
loader's. There is no numpy fallback: if the native library cannot be
built, construction raises.

The batches are for ``device``, ``cuda`` unless the caller asks for the
CPU. For the GPU each batch is copied out of the native buffer straight
into page-locked host memory and returned as torch tensors, so
``tensor.to("cuda", non_blocking=True)`` is an asynchronous copy (torch's
pinned-memory cache keeps a block until the copies that read it are
done). For the CPU the batch is a pair of numpy arrays, as the JAX loader
gives.
"""

from __future__ import annotations

import ctypes
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from chainermn_torch.device import resolve_device
from chainermn_torch.ops import native

__all__ = ["PrefetchingLoader"]


class PrefetchingLoader:
    """Iterate ``(x_batch, y_batch)`` over array data with native prefetch.

    Args:
      xs, ys: the full data arrays (first axis indexes samples).
      batch_size: rows per batch.
      shuffle/seed/epochs: epoch order control (epochs=None → infinite).
      depth: prefetch depth (buffers in flight).
      n_threads: gather threads of the worker.
      device: where the batches go: ``cuda`` (default; page-locked torch
        tensors) or ``"cpu"`` (numpy arrays).
    """

    def __init__(self, xs: np.ndarray, ys: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: Optional[int] = None,
                 epochs: Optional[int] = None, depth: int = 2,
                 n_threads: int = 4, device=None):
        self.xs = np.ascontiguousarray(xs)
        self.ys = np.ascontiguousarray(ys)
        if batch_size > len(self.xs):
            # _indices would otherwise yield nothing and, with
            # epochs=None, spin forever re-shuffling an empty schedule
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{len(self.xs)}")
        self.device = resolve_device(device)
        self.pin_memory = self.device.type == "cuda"
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._epochs = epochs
        self._depth = depth
        self.epoch = 0
        self.is_new_epoch = False
        self._handle = None
        self._native = native.get_lib()
        self._xrow = self.xs.dtype.itemsize * int(
            np.prod(self.xs.shape[1:], initial=1))
        self._yrow = self.ys.dtype.itemsize * int(
            np.prod(self.ys.shape[1:], initial=1))
        self._handle = self._native.cmn_loader_create(
            self.xs.ctypes.data, self.ys.ctypes.data, self._xrow,
            self._yrow, batch_size, depth, n_threads)
        self._outstanding = 0
        self._index_iter = self._indices()
        # epochs-completed value for each submitted-but-not-yet-returned
        # batch, FIFO: ``self.epoch`` tracks the batch the caller
        # receives, not how far ahead the prefetcher has drained the
        # index generator
        self._pending_epochs: deque = deque()

    def _indices(self) -> Iterator[tuple]:
        """Yields (epochs_completed_after_this_batch, index_array)."""
        n = len(self.xs)
        ep = 0
        while self._epochs is None or ep < self._epochs:
            order = np.arange(n, dtype=np.int64)
            if self._shuffle:
                self._rng.shuffle(order)
            starts = list(range(0, n - self.batch_size + 1, self.batch_size))
            for j, at in enumerate(starts):
                done = ep + 1 if j == len(starts) - 1 else ep
                yield done, order[at:at + self.batch_size]
            ep += 1

    def _submit_one(self) -> bool:
        try:
            ep, idx = next(self._index_iter)
        except StopIteration:
            return False
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        self._native.cmn_loader_submit(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx))
        self._pending_epochs.append(ep)
        self._outstanding += 1
        return True

    def _copy_out(self, ptr, arr: np.ndarray, row_bytes: int):
        """The batch of ``arr``'s layout at ``ptr``, copied out of the
        native buffer (into page-locked memory for the GPU)."""
        raw = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(self.batch_size * row_bytes,))
        view = raw.view(arr.dtype).reshape((self.batch_size,)
                                           + arr.shape[1:])
        if self.pin_memory:
            return torch.from_numpy(view).pin_memory()
        return view.copy()

    def __iter__(self):
        return self

    def __next__(self):
        while self._outstanding < self._depth:
            if not self._submit_one():
                break
        if self._outstanding == 0:
            raise StopIteration
        xptr = ctypes.c_void_p()
        yptr = ctypes.c_void_p()
        buf = self._native.cmn_loader_next(
            self._handle, ctypes.byref(xptr), ctypes.byref(yptr))
        self._outstanding -= 1
        # copy out so the buffer can be recycled at once; the gather
        # itself (the expensive part) already happened off-thread
        x = self._copy_out(xptr, self.xs, self._xrow)
        y = self._copy_out(yptr, self.ys, self._yrow)
        self._native.cmn_loader_release(self._handle, buf)
        ep = self._pending_epochs.popleft()
        self.is_new_epoch = ep > self.epoch
        self.epoch = ep
        return x, y

    next = __next__

    def close(self):
        if self._handle is not None:
            self._native.cmn_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
