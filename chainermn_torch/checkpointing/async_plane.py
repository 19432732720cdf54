"""Double-buffered asynchronous snapshots.

Counterpart of ``chainermn_tpu/checkpointing/async_plane.py``. The
synchronous ``MultiNodeCheckpointer.save`` spends the device → host copy,
the serialization, fsync, SHA-256 and rename on the step thread. This
plane splits the save at the step boundary:

1. **Step thread** (:meth:`AsyncSnapshotPlane.save`): a device-side copy
   of every leaf (the next step updates the state in place, so the
   snapshot must not alias it), then an asynchronous copy of each into
   page-locked host memory on a side stream, whose event is recorded,
   then enqueue. That is the whole per-step stall, kept as
   :attr:`~AsyncSnapshotPlane.stall_ms_last` (``ckpt/stall_ms``).
2. **Writer thread**: wait for the event, then the checkpointer's own
   atomic publish (tmp name, fsync, SHA-256, rename, manifest with the
   coverage map), off the critical path.

Backpressure is explicit: the queue holds ``max_pending`` snapshots
(default 1: double buffering); ``backpressure='block'`` stalls
:meth:`~AsyncSnapshotPlane.save` while it is full (every snapshot
published), ``'skip'`` drops the new snapshot and counts it (the stall
stays bounded, the cadence thins under a slow disk).
``drain(deadline_s=)`` waits for the queue until an absolute monotonic
deadline; :meth:`~AsyncSnapshotPlane.emergency_save` drains within the
deadline it is given, then writes the synchronous last-chance snapshot.

A crash between the copy and the publish loses only the snapshot in
flight: nothing partial becomes visible (the publish is a rename), and
the election falls back to the newest verified iteration.

Waiting for ROADMAP.md queue 1 item 9: the ring replicator
(``replicator=``), the chaos harness's ``on_offload`` hooks, and
``reserve_grace`` (the slice of the preemption window that the JAX
plane's emergency drain reserves).
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from chainermn_torch.extensions.checkpoint import (MultiNodeCheckpointer,
                                                   ShardedLeaf, _flatten,
                                                   _host_copies,
                                                   _leaf_arrays)

__all__ = ["AsyncSnapshotPlane"]

_ITEM9 = ("waits for the resilience slice of the port (ROADMAP.md queue 1 "
          "item 9)")


def _device_copy(leaf):
    """A copy of a leaf that the next in-place step cannot reach."""
    if isinstance(leaf, ShardedLeaf):
        return ShardedLeaf(_device_copy(leaf.local), leaf.gshape,
                           leaf.index)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return leaf


class AsyncSnapshotPlane:
    """Asynchronous snapshots over a synchronous checkpointer.

    ``plane = AsyncSnapshotPlane(ck)``, then use the plane where the
    checkpointer was used on the hot path: as a trainer extension
    (``trainer.extend(plane, trigger=...)``) or through :meth:`save` in
    a step loop. The read side (:meth:`maybe_load`, :meth:`resume`,
    :meth:`latest_common_iteration`) drains the queue first, so it sees
    only published files.

    Stats (host counters, read by ``training.CheckpointReport``):
    ``stall_ms_last``/``stall_ms_total`` (the step thread's time in
    :meth:`save`), ``bytes_last``/``bytes_total`` (the arrays
    published), ``cadence_last`` (iterations since the previous save),
    ``published``, ``skipped`` and :attr:`pending`.
    """

    def __init__(self, checkpointer: MultiNodeCheckpointer,
                 max_pending: int = 1, backpressure: str = "block",
                 replicator: Optional[Any] = None):
        if backpressure not in ("block", "skip"):
            raise ValueError(
                f"backpressure={backpressure!r}: 'block' (stall save "
                "until the writer catches up) or 'skip' (drop the new "
                "snapshot, count it)")
        if getattr(checkpointer, "async_write", False):
            raise ValueError(
                "AsyncSnapshotPlane owns the write pipeline — build the "
                "checkpointer with async_write=False (double-queueing "
                "through both would reorder publishes)")
        if getattr(checkpointer, "backend", "npz") != "npz":
            raise ValueError("AsyncSnapshotPlane writes the npz backend")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1: {max_pending}")
        if replicator is not None:
            raise NotImplementedError(f"the ring replicator {_ITEM9}")
        self.ck = checkpointer
        self.backpressure = backpressure
        self.max_pending = max_pending
        self.replicator = None
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = None
        self.published = 0
        self.skipped = 0
        self.stall_ms_last = 0.0
        self.stall_ms_total = 0.0
        self.bytes_last = 0
        self.bytes_total = 0
        self.cadence_last = 0
        self._last_iter: Optional[int] = None

    # -- step-thread half -------------------------------------------------

    def _offload(self, leaves):
        """Host copies of the device copies, on a side stream that waits
        for the current one; the event marks their completion (None on
        the CPU, where the copies are done)."""
        cuda = [l for l in leaves if isinstance(
            getattr(l, "local", l), torch.Tensor)
            and getattr(l, "local", l).is_cuda]
        if not cuda:
            return _host_copies(leaves), None
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        cur = torch.cuda.current_stream()
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            host = _host_copies(leaves)
            for leaf in cuda:       # the copies are read on this stream
                getattr(leaf, "local", leaf).record_stream(self._stream)
            event = torch.cuda.Event()
            event.record(self._stream)
        return host, event

    def save(self, state: Any, iteration: int,
             host_state: Any = None) -> bool:
        """Enqueue a snapshot of ``state`` for ``iteration``; False when
        ``backpressure='skip'`` dropped it. The step thread's work is the
        device-side copies and the launch of their host copies; its time
        is :attr:`stall_ms_last`."""
        self._raise_pending()
        self._ensure_writer()
        t0 = time.monotonic()
        leaves: list = []
        tree = _flatten(state, leaves)
        leaves = [_device_copy(l) for l in leaves]
        host, event = self._offload(leaves)
        item = (tree, leaves, host, event, int(iteration), host_state)
        accepted = True
        if self.backpressure == "skip":
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                accepted = False
                self.skipped += 1
        else:
            self._queue.put(item)
        if self._last_iter is not None:
            self.cadence_last = int(iteration) - self._last_iter
        self._last_iter = int(iteration)
        self.stall_ms_last = (time.monotonic() - t0) * 1000.0
        self.stall_ms_total += self.stall_ms_last
        return accepted

    # -- writer-thread half -----------------------------------------------

    def _ensure_writer(self):
        if self._writer is not None and self._writer.is_alive():
            return
        self._writer = threading.Thread(
            target=self._writer_loop, name=f"ckpt-plane-{self.ck.name}",
            daemon=True)
        self._writer.start()
        self._register_atexit()

    def _register_atexit(self):
        if getattr(self, "_atexit_done", False):
            return
        self._atexit_done = True
        import atexit

        def _close_at_exit():
            try:
                self.close()
            except Exception as e:
                warnings.warn(f"async snapshot plane at exit: {e}")

        atexit.register(_close_at_exit)

    def _publish(self, item) -> None:
        tree, leaves, host, event, iteration, host_state = item
        if event is not None:
            event.synchronize()
        arrays = _leaf_arrays(leaves, host)
        del leaves
        ck = self.ck
        arrays["__world__"] = np.int64(ck.comm.size)
        arrays["__tree__"] = np.frombuffer(
            pickle.dumps(tree, pickle.HIGHEST_PROTOCOL), np.uint8).copy()
        if host_state is not None:
            arrays["__host_state__"] = np.frombuffer(
                pickle.dumps(host_state, pickle.HIGHEST_PROTOCOL),
                np.uint8).copy()
        ck._publish(arrays, ck._file(iteration),
                    meta=ck._coverage_meta(arrays, iteration))
        self.bytes_last = int(sum(getattr(a, "nbytes", 0)
                                  for a in arrays.values()))
        self.bytes_total += self.bytes_last
        self.published += 1

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._publish(item)
            except BaseException as e:  # surfaced on the next save/flush
                self._error = e
            finally:
                # the snapshot's buffers go back to the allocators now,
                # not when the next one arrives
                item = None
                self._queue.task_done()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(
                f"async snapshot publish failed: {e!r}") from e

    # -- barriers ----------------------------------------------------------

    @property
    def pending(self) -> int:
        """Snapshots accepted but not yet published."""
        return int(self._queue.unfinished_tasks)

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Wait until every accepted snapshot is published (or failed).
        ``deadline_s`` is an absolute ``time.monotonic`` deadline; False
        when it passed with work pending. Never raises: the emergency
        path must reach its own write."""
        if deadline_s is None:
            self._queue.join()
            return True
        with self._queue.all_tasks_done:
            while self._queue.unfinished_tasks:
                remaining = deadline_s - time.monotonic()
                if remaining <= 0:
                    return False
                self._queue.all_tasks_done.wait(timeout=remaining)
        return True

    def flush(self):
        """Drain fully and raise any deferred publish error."""
        self.drain()
        self._raise_pending()

    def close(self):
        """Drain and stop the writer (the Trainer's finally block calls
        it on every extension)."""
        if self._writer is not None and self._writer.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._writer.join()
        self._writer = None
        self._raise_pending()

    # -- trainer integration ----------------------------------------------

    def __call__(self, trainer):
        """Trainer-extension protocol: the checkpointer's, with the save
        moved off the step path."""
        host_fn = getattr(trainer.updater, "host_state_dict", None)
        self.save(trainer.updater.state, trainer.updater.iteration,
                  host_state=host_fn() if callable(host_fn) else None)

    def emergency_save(self, trainer, deadline_s: Optional[float] = None):
        """Preemption or crash: drain the snapshots in flight until
        ``deadline_s``, then the checkpointer's synchronous last-chance
        save against the same deadline (JAX's plane first reserves a
        slice of the grace window for the drain: ``reserve_grace``, item
        9)."""
        self.drain(deadline_s)
        return self.ck.emergency_save(trainer, deadline_s=deadline_s)

    # -- read side (drain first) ------------------------------------------

    def latest_common_iteration(self) -> Optional[int]:
        self.drain()
        return self.ck.latest_common_iteration()

    def maybe_load(self, state: Any, iteration: Optional[int] = None,
                   **kwargs):
        self.drain()
        return self.ck.maybe_load(state, iteration=iteration, **kwargs)

    def resume(self, updater) -> Optional[int]:
        self.drain()
        return self.ck.resume(updater)

    def load_host_state(self, iteration: int) -> Any:
        self.drain()
        return self.ck.load_host_state(iteration)

    def protect(self, iteration: int) -> None:
        self.ck.protect(iteration)
