"""Thread-safe serving front end: ``submit(prompt) -> Future``.

Counterpart of ``chainermn_tpu/serving/frontend.py``. One background
thread owns the :class:`~chainermn_torch.serving.engine.Engine` (the
engine itself is single-threaded by design) and runs on the engine's
device (``torch.cuda``'s current device is per thread); callers from
any thread enqueue work through a mailbox and block on standard
``concurrent.futures.Future`` objects. Two resilience hooks, both
reused from the training fleet:

* **Deadline-bounded waits** — ``result()`` slices its wait into
  ``RpcPolicy.probe_ms`` probes (the same fail-fast shape as the
  host-plane RPCs in ``comm/object_plane.py``), so a wedged replica is
  noticed in O(probe), not O(timeout). The total budget defaults to
  ``RpcPolicy.timeout_ms``.
* **Watchdog-bounded abortion** — every scheduler iteration polls the
  process watchdog (``resilience/watchdog.py``); on a declared-dead
  peer the engine aborts all in-flight requests and their futures fail
  with ``JobAbortedError`` within one iteration + one probe slice,
  instead of hanging until the client gives up.

An error the engine raises inside ``step()`` is not swallowed: every
pending future fails with it, the scheduler thread stops, and later
submissions raise.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

from chainermn_torch.comm.object_plane import JobAbortedError
from chainermn_torch.device import bind_thread_device, cuda_index_of
from chainermn_torch.resilience.policy import RpcPolicy, policy
from chainermn_torch.resilience.watchdog import current_watchdog

__all__ = ["Frontend", "DeadlineExceeded", "AdmissionRejected"]


class DeadlineExceeded(TimeoutError):
    """The deadline-bounded wait ran out of budget (the replica may
    still be alive — the request is NOT cancelled)."""


class AdmissionRejected(RuntimeError):
    """Queue-depth backpressure: the submission was REFUSED before any
    engine state changed. ``retry_after_ms`` is the server's hint —
    re-submit after that long (the ``RpcPolicy`` backoff base, so a
    polite client and the RPC retry ladder pace identically). Raised by
    ``Frontend.submit`` (one engine, ``max_queue_depth``)."""

    def __init__(self, msg: str, retry_after_ms: int):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class Frontend:
    """Wraps an Engine in a mailbox + scheduler thread.

    Use as a context manager; ``close()`` drains the mailbox, stops the
    thread, and aborts whatever is still in flight. ``error`` holds the
    exception that stopped the engine, if one did.
    """

    _IDLE_WAIT_S = 0.005     # mailbox poll while the engine is idle

    def __init__(self, engine, *, rpc_policy: Optional[RpcPolicy] = None,
                 watchdog=None, max_queue_depth: Optional[int] = None):
        self.engine = engine
        self._policy = rpc_policy
        self._watchdog = watchdog
        self.max_queue_depth = max_queue_depth
        self._mail: _queue.Queue = _queue.Queue()
        self._futures = {}           # request_id → Future
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        # the engine's card for the scheduler thread (torch.cuda's current
        # device is per thread): its index, or this thread's current one
        self._cuda_index = cuda_index_of(engine)
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-frontend",
                                        daemon=True)
        self._thread.start()

    # ----------------------------------------------------------------
    # client face (any thread)
    # ----------------------------------------------------------------

    def submit(self, prompt, **kw) -> Future:
        """Queue one generation request; the Future resolves to the
        engine's Request (``.tokens`` holds the emitted ids). Keyword
        arguments pass straight through to ``Engine.submit`` — per-
        request ``max_new_tokens``, ``eos_id``, and the on-device
        sampling knobs ``temperature``/``top_k``/``seed``
        (serving/sampling.py).

        With ``max_queue_depth`` set, a submission that would push the
        backlog (mailbox + engine queue) past the bound raises
        :class:`AdmissionRejected` with a ``retry_after_ms`` hint
        instead of growing an unbounded queue — load sheds at the door,
        not as a timeout ten layers later."""
        if self.error is not None:
            raise RuntimeError(
                f"the serving engine failed: {self.error!r}") from self.error
        if self._stop.is_set():
            raise RuntimeError("frontend is closed")
        if self.max_queue_depth is not None:
            depth = self._mail.qsize() + len(self.engine.queue)
            if depth >= self.max_queue_depth:
                pol = self._policy or policy()
                raise AdmissionRejected(
                    f"queue depth {depth} at the bound "
                    f"({self.max_queue_depth}); retry after "
                    f"{pol.backoff_base_ms} ms",
                    retry_after_ms=pol.backoff_base_ms)
        fut: Future = Future()
        self._mail.put((prompt, kw, fut))
        return fut

    def result(self, future: Future, timeout_ms: Optional[int] = None):
        """Deadline-bounded wait, sliced at ``probe_ms`` for fail-fast:
        a dead scheduler thread or tripped watchdog surfaces on the next
        probe instead of after the full budget."""
        pol = self._policy or policy()
        budget_ms = timeout_ms if timeout_ms is not None else pol.timeout_ms
        deadline = time.monotonic() + budget_ms / 1e3
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise DeadlineExceeded(
                    f"no result within {budget_ms} ms "
                    f"(probe={pol.probe_ms} ms)")
            try:
                return future.result(
                    timeout=min(pol.probe_ms / 1e3, left))
            except FutureTimeout:
                if not self._thread.is_alive() and not future.done():
                    raise RuntimeError(
                        "serving scheduler thread died with the request "
                        "in flight")

    def drain(self, timeout_ms: Optional[int] = None) -> None:
        """Block until the engine has no queued or active work."""
        pol = self._policy or policy()
        budget_ms = timeout_ms if timeout_ms is not None else pol.timeout_ms
        deadline = time.monotonic() + budget_ms / 1e3
        while time.monotonic() < deadline:
            with self._lock:
                if self._mail.empty() and self.engine.idle():
                    return
            time.sleep(self._IDLE_WAIT_S)
        raise DeadlineExceeded(f"engine not drained within {budget_ms} ms")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------------
    # scheduler thread
    # ----------------------------------------------------------------

    def _poll_watchdog(self):
        wd = self._watchdog or current_watchdog()
        if wd is None:
            return
        try:
            wd.check()
        except JobAbortedError as e:
            # bounded abortion: fail EVERYTHING in flight now — clients
            # see the peer loss within one probe slice, never a hang
            with self._lock:
                hit = {r.request_id for r in self.engine.abort_all()}
                for rid in list(self._futures):
                    if rid in hit:
                        fut, _req = self._futures.pop(rid)
                        if not fut.done():
                            fut.set_exception(JobAbortedError(str(e)))

    def _fail_all(self, exc: BaseException) -> None:
        """The engine raised: every pending future (admitted or still in
        the mailbox) fails with that exception."""
        with self._lock:
            for rid, (fut, _req) in list(self._futures.items()):
                self._futures.pop(rid)
                if not fut.done():
                    fut.set_exception(exc)
            try:
                while True:
                    _prompt, _kw, fut = self._mail.get_nowait()
                    if not fut.done():
                        fut.set_exception(exc)
            except _queue.Empty:
                pass

    def _loop(self) -> None:
        try:
            bind_thread_device(self._cuda_index)
            self._serve()
        except Exception as e:  # noqa: BLE001 — the thread's boundary
            # not swallowed: every pending future fails with it, and
            # submit() raises from it from now on
            self.error = e
            self._stop.set()
            self._fail_all(e)

    def _serve(self) -> None:
        while not self._stop.is_set():
            self._poll_watchdog()
            worked = False
            try:
                while True:
                    prompt, kw, fut = self._mail.get_nowait()
                    with self._lock:
                        try:
                            req = self.engine.submit(prompt, **kw)
                            self._futures[req.request_id] = (fut, req)
                        except Exception as e:  # bad request, not fatal
                            fut.set_exception(e)
                    worked = True
            except _queue.Empty:
                pass
            with self._lock:
                if not self.engine.idle():
                    # Engine.step() syncs internally (one [n_slots, k]
                    # token pull — sampling stays on device)
                    self.engine.step()
                    worked = True
                    for rid, (fut, req) in list(self._futures.items()):
                        if req.finished:
                            self._futures.pop(rid)
                            if not fut.done():
                                fut.set_result(req)
            if not worked:
                time.sleep(self._IDLE_WAIT_S)
        # teardown: nothing new is accepted; in-flight work aborts and
        # never-admitted mailbox entries fail too (close() may beat the
        # drain loop to a freshly submitted request)
        with self._lock:
            self.engine.abort_all()
            for rid, (fut, req) in list(self._futures.items()):
                self._futures.pop(rid)
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("frontend closed mid-request"))
            try:
                while True:
                    _prompt, _kw, fut = self._mail.get_nowait()
                    if not fut.done():
                        fut.set_exception(
                            RuntimeError("frontend closed mid-request"))
            except _queue.Empty:
                pass
