"""Heartbeat/watchdog: convert a dead peer into a bounded error.

Counterpart of ``chainermn_tpu/resilience/watchdog.py``. A single wedged
or killed rank is the nastiest failure of a job: every symmetric
collective blocks on the missing rank, the survivors sit in a rendezvous
with no deadline, and nobody notices until a human does. A crash runs
the global except hook (it posts the abort key); a SIGKILL leaves no
hook to run.

Every process runs a daemon thread that (1) bumps its own heartbeat key
``og/hb/<rank>`` in the world's ``torch.distributed`` store every
``interval_ms`` and (2) watches every peer's key; a peer whose heartbeat
stops advancing for ``timeout_ms`` is declared dead, the abort poison key
is posted (``comm.object_plane.post_abort``), and every process blocked
in a guarded host-plane wait raises
:class:`~chainermn_torch.comm.object_plane.JobAbortedError` within one
probe slice. A store that stays unreachable for ``timeout_ms`` declares
its host, rank 0, dead.

A survivor inside a collective of the array route is where the two
packages differ. The JAX package leaves a wedged device collective to
the coordination service, which reaps the process. Here the watchdog's
default ``on_dead`` (:func:`start_watchdog`) aborts the process groups
(``torch.distributed``'s ``_abort_process_group``): a NCCL collective
then raises, and the Trainer turns the error into ``JobAbortedError``
(exit 75 under ``main_exit_code``). gloo does not honour the abort: a
gloo collective raises only when a peer's connection closes, which a
killed peer's does at once. For a peer that is alive but silent (a
wedged host), the watchdog ends its own process with exit 75 once the
step loop has not acknowledged the abort (:meth:`Watchdog.check` raising)
within ``exit_grace_ms``: a survivor stuck where no error can reach it
is bounded by the heartbeat timeout plus that grace.

Configuration (env, the JAX package's names):

* ``CHAINERMN_TPU_HEARTBEAT_MS`` — beat/check cadence (default 5000);
* ``CHAINERMN_TPU_HEARTBEAT_TIMEOUT_MS`` — staleness threshold before a
  peer is declared dead (default 6 × the cadence);
* ``CHAINERMN_TPU_WATCHDOG=1`` — lets :func:`maybe_start_watchdog`
  (called by the Trainer) start it without code changes.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["Watchdog", "start_watchdog", "maybe_start_watchdog",
           "stop_watchdog", "current_watchdog", "abort_process_groups"]

_ENV_INTERVAL = "CHAINERMN_TPU_HEARTBEAT_MS"
_ENV_TIMEOUT = "CHAINERMN_TPU_HEARTBEAT_TIMEOUT_MS"
_ENV_ENABLE = "CHAINERMN_TPU_WATCHDOG"

_HB_PREFIX = "og/hb"


def _env_ms(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def abort_process_groups() -> None:
    """Abort every ``torch.distributed`` process group of this process
    (best-effort): a NCCL collective blocked on a dead peer raises. gloo
    ignores the abort."""
    try:
        import torch.distributed as dist
        from torch.distributed import distributed_c10d

        if dist.is_available() and dist.is_initialized():
            distributed_c10d._abort_process_group()
    except Exception:
        pass


class Watchdog:
    """One process's heartbeat publisher + peer monitor.

    ``store`` duck-types a ``torch.distributed`` store (``set``,
    ``check``, ``get``), so tests can drive it with a fake; None uses the
    world's store, through a connection of the watchdog's own (a
    heartbeat never queues behind another thread's key wait).
    ``on_dead(peer, reason)`` runs once, on the watchdog's thread, after
    the abort key is posted. ``exit_grace_ms`` (None: never) ends the
    process with ``ABORTED_EXIT_CODE`` when the abort was declared and
    :meth:`check` has not raised within that long.
    """

    def __init__(self, rank: int, world: int, store=None,
                 interval_ms: Optional[int] = None,
                 timeout_ms: Optional[int] = None,
                 on_dead: Optional[Callable[[int, str], None]] = None,
                 exit_grace_ms: Optional[int] = None,
                 exit_fn: Callable[[int], None] = os._exit):
        self.rank = rank
        self.world = world
        self._store = store
        self.interval_ms = interval_ms if interval_ms is not None else (
            _env_ms(_ENV_INTERVAL, 5_000))
        self.timeout_ms = timeout_ms if timeout_ms is not None else (
            _env_ms(_ENV_TIMEOUT, 6 * self.interval_ms))
        self._on_dead = on_dead
        self.exit_grace_ms = exit_grace_ms
        self._exit = exit_fn
        self._beat = 0
        # peer -> (last seen value, monotonic time it last advanced)
        self._seen: Dict[int, tuple] = {}
        self._store_lost_at: Optional[float] = None
        self.dead_peer: Optional[int] = None
        self.dead_reason: Optional[str] = None
        #: monotonic time of the declaration, and of the step loop's
        #: acknowledgement (check() raising)
        self.declared_at: Optional[float] = None
        self.acknowledged_at: Optional[float] = None
        self._declared = threading.Event()
        self._declare_lock = threading.Lock()
        self._declaring = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- store access ----------------------------------------------------

    def _client(self):
        from chainermn_torch.comm import object_plane

        return object_plane._client(self._store)

    def _publish(self, client) -> None:
        self._beat += 1
        client.set(f"{_HB_PREFIX}/{self.rank}", str(self._beat))

    @staticmethod
    def _read_peer(client, peer: int) -> Optional[str]:
        key = f"{_HB_PREFIX}/{peer}"
        if not client.check([key]):
            return None
        v = client.get(key)
        return v.decode() if isinstance(v, bytes) else str(v)

    # -- monitoring ------------------------------------------------------

    def _check_peers(self, client) -> None:
        now = time.monotonic()
        for peer in range(self.world):
            if peer == self.rank:
                continue
            val = self._read_peer(client, peer)
            if val is None:
                # never seen: startup grace — start the staleness clock
                self._seen.setdefault(peer, (None, now))
                val, since = self._seen[peer]
                if val is None and (now - since) * 1000 > 2 * self.timeout_ms:
                    self._declare_dead(peer, "never published a heartbeat")
                continue
            prev = self._seen.get(peer)
            if prev is None or prev[0] != val:
                self._seen[peer] = (val, now)
            elif (now - prev[1]) * 1000 > self.timeout_ms:
                self._declare_dead(
                    peer, f"heartbeat stalled at beat {val} for "
                          f"{int((now - prev[1]) * 1000)} ms")

    def _declare_dead(self, peer: int, why: str) -> None:
        """Post the abort key, run ``on_dead``, then publish the verdict
        to :meth:`check` (once, whichever thread gets here first)."""
        with self._declare_lock:
            if self._declaring:
                return
            self._declaring = True
        who = f"peer {peer} " if peer >= 0 else ""
        reason = f"watchdog(rank {self.rank}): {who}{why}"
        try:
            from chainermn_torch.comm.object_plane import post_abort

            post_abort(reason, store=self._store)
        except Exception:
            pass
        if self._on_dead is not None:
            try:
                self._on_dead(peer, reason)
            except Exception:
                pass
        self.dead_reason = reason
        self.declared_at = time.monotonic()
        self.dead_peer = peer
        self._declared.set()

    def check(self) -> None:
        """Raise JobAbortedError if this watchdog declared a peer dead —
        the step loop's cheap per-iteration poll. Raising acknowledges
        the abort (the exit grace no longer applies)."""
        if self.dead_peer is not None:
            from chainermn_torch.comm.object_plane import JobAbortedError

            if self.acknowledged_at is None:
                self.acknowledged_at = time.monotonic()
            raise JobAbortedError(self.dead_reason)

    def confirm(self, timeout_ms: Optional[int] = None) -> bool:
        """After an error inside a collective: is the job dead? Waits up
        to ``timeout_ms`` (default: the heartbeat timeout plus two beats)
        for this watchdog's declaration or a peer's abort key. True means
        :meth:`check` now raises."""
        if timeout_ms is None:
            timeout_ms = self.timeout_ms + 2 * self.interval_ms
        deadline = time.monotonic() + timeout_ms / 1000.0
        from chainermn_torch.comm import object_plane

        while self.dead_peer is None:
            reason = object_plane._read_abort(self._client())
            if reason is not None:
                self._declare_dead(-1, f"saw the abort key: {reason}")
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            self._declared.wait(min(left, self.interval_ms / 1000.0))
        return True

    # -- thread lifecycle ------------------------------------------------

    def _beat_once(self) -> None:
        client = self._client()
        if client is None:
            return
        try:
            self._publish(client)
            self._check_peers(client)
            self._store_lost_at = None
        except Exception:
            # the store's host is rank 0: unreachable for the whole
            # timeout means it is gone
            now = time.monotonic()
            if self._store_lost_at is None:
                self._store_lost_at = now
            elif (now - self._store_lost_at) * 1000 > self.timeout_ms:
                self._declare_dead(0, "(the store's host) unreachable for "
                                      f"{int((now - self._store_lost_at) * 1000)}"
                                      " ms")

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._beat_once()
            if self.dead_peer is not None:
                self._reap()
                return
            self._stop.wait(self.interval_ms / 1000.0)

    def _reap(self) -> None:
        """The exit grace: end the process if the step loop never sees
        the abort (stuck where no error reaches it)."""
        if self.exit_grace_ms is None:
            return
        end = self.declared_at + self.exit_grace_ms / 1000.0
        while not self._stop.is_set() and self.acknowledged_at is None:
            left = end - time.monotonic()
            if left <= 0:
                from chainermn_torch.resilience.supervisor import \
                    ABORTED_EXIT_CODE

                sys.stderr.write(
                    f"{self.dead_reason}; the step loop did not leave its "
                    f"collective within {self.exit_grace_ms} ms — exiting "
                    f"{ABORTED_EXIT_CODE}\n")
                sys.stderr.flush()
                self._exit(ABORTED_EXIT_CODE)
                return
            self._stop.wait(min(left, 0.05))

    def start(self) -> "Watchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"chainermn-watchdog-{self.rank}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


_watchdog: Optional[Watchdog] = None


def _default_on_dead(peer: int, reason: str) -> None:
    del peer, reason
    abort_process_groups()


def start_watchdog(interval_ms: Optional[int] = None,
                   timeout_ms: Optional[int] = None) -> Optional[Watchdog]:
    """Start the process-wide watchdog (idempotent) over the world's
    store, rank and size. Returns None in a world of one — there is no
    peer to watch. Its ``on_dead`` aborts the process groups, and its
    exit grace is the heartbeat timeout."""
    global _watchdog
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or (
            dist.get_world_size() <= 1):
        return None
    if _watchdog is None:
        _watchdog = Watchdog(dist.get_rank(), dist.get_world_size(),
                             interval_ms=interval_ms, timeout_ms=timeout_ms,
                             on_dead=_default_on_dead)
        _watchdog.exit_grace_ms = _watchdog.timeout_ms
    return _watchdog.start()


def maybe_start_watchdog() -> Optional[Watchdog]:
    """Start the watchdog iff $CHAINERMN_TPU_WATCHDOG is truthy — the
    Trainer's opt-in hook."""
    if os.environ.get(_ENV_ENABLE, "").lower() in ("", "0", "false"):
        return None
    return start_watchdog()


def stop_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def current_watchdog() -> Optional[Watchdog]:
    return _watchdog
