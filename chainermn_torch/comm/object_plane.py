"""Host-side object plane over the world's ``torch.distributed`` store.

Counterpart of ``chainermn_tpu/comm/object_plane.py``. The JAX plane
rides the ``jax.distributed`` coordinator's key-value client; this one
rides the store every ``torch.distributed`` world already has: the
default group's (a ``TCPStore`` hosted by rank 0 under ``env://``), or
any store-like object given as ``store=`` (tests give a fake), with the JAX package's keys (``og/abort/flag``,
``og/liveness/seed``, ``og/hb/<rank>``, ...). The store gives what the
plane needs: ``set``/``get``, ``check`` (the non-blocking probe the abort
key and every wait poll with), ``add`` (barrier arrivals) and ``wait``
(the liveness ladder's short deadline).

What rides it, and why not the communicator's gloo group: the abort
poison key (:func:`post_abort`, read by every guarded wait, so a crashed
rank's peers raise :class:`JobAbortedError` within one probe slice), the
watchdog's heartbeats (``resilience/watchdog.py``), ``host_barrier``
(a barrier whose every wait is guarded: a dead peer raises instead of
hanging), and the ring replicas' point-to-point messages (a put returns
without waiting for the receiver, so a send-then-receive around a ring
cannot deadlock, where gloo's ``send`` waits for its receive).

A ``TCPStore`` client serialises its operations: a thread blocked in a
``wait`` holds the connection until it returns. So each thread talks to
the store through its own clone (:func:`_client`), and waits poll
``check`` instead of blocking in the store: a heartbeat never queues
behind a key wait. The store's host is rank 0: when it dies, every
operation raises at once, and the liveness ladder turns that into an
error within the ladder's few hundred milliseconds.

:class:`FsObjectPlane` is the JAX package's file-backed point-to-point
plane, a copy: a shared directory instead of a store, for processes that
restart and must keep their channel positions.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import threading
import time
from typing import Any, List, Optional

from chainermn_torch.resilience import chaos as _chaos
from chainermn_torch.resilience.policy import policy as _rpc_policy

__all__ = ["ObjectPlane", "FsObjectPlane", "JobAbortedError", "post_abort"]

# chunk bound of one stored value
_KV_CHUNK = 4 * 1024 * 1024

# every deadline below derives from ONE policy (resilience/policy.py):
# the total per-operation budget (CHAINERMN_TPU_RPC_TIMEOUT_MS), the
# fail-fast probe slice (CHAINERMN_TPU_RPC_PROBE_MS) that bounds how long a
# dead store or an aborted job goes unnoticed, and the retry ladder

# seeded by every ObjectPlane at construction; read by the liveness probes
_ALIVE_KEY = "og/liveness/seed"

# set by post_abort (the global except hook's MPI_Abort analog, and the
# watchdog); checked by every liveness probe, so peers of a crashed rank
# raise within one probe interval instead of waiting out their budgets
_ABORT_KEY = "og/abort"
_ABORT_FLAG = _ABORT_KEY + "/flag"

# polling of a key wait: the first polls are quick (a peer's put is
# usually a moment away), later ones back off to this
_POLL_MAX_S = 0.02


class JobAbortedError(RuntimeError):
    """Another process declared the job dead (global except hook or
    watchdog)."""


_local = threading.local()


def _world_store() -> Optional[Any]:
    """The default group's store, or None without a group."""
    try:
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            return None
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    except Exception:
        return None


def _client(store: Optional[Any] = None) -> Optional[Any]:
    """This thread's connection to ``store`` (default: the world's): a
    clone of it made on the thread's first use, or the store itself when
    it cannot be cloned (a ``FileStore``, a fake)."""
    base = store if store is not None else _world_store()
    if base is None:
        return None
    cache = getattr(_local, "clones", None)
    if cache is None:
        cache = _local.clones = {}
    hit = cache.get(id(base))
    if hit is not None and hit[0] is base:
        return hit[1]
    try:
        clone = base.clone()
    except Exception:
        clone = base
    cache[id(base)] = (base, clone)
    return clone


def _as_str(v) -> str:
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)


def post_abort(reason: str, store: Optional[Any] = None) -> None:
    """Mark the job aborted for every peer (best-effort, bounded).

    The crashing process may host the store (rank 0), whose peers then
    fail fast through the liveness probe instead; so this posts the
    poison key with a short thread-guarded budget and swallows every
    failure."""
    client = _client(store)
    if client is None:
        return
    try:
        _guard_rpc(lambda: client.set(_ABORT_FLAG, reason[:512]),
                   budget_ms=5_000, store=store)
    except Exception:
        pass


def _read_abort(client) -> Optional[str]:
    """The posted abort reason, or None, without ever blocking: ``check``
    first (a ``get`` of a missing key would wait for the store's whole
    timeout). Errors read as None; the liveness ladder owns a dead
    store."""
    if client is None:
        return None
    try:
        if client.check([_ABORT_FLAG]):
            return _as_str(client.get(_ABORT_FLAG))
    except Exception:
        pass
    return None


def _coordinator_alive(store: Optional[Any] = None) -> None:
    """Raise if the job is aborted or the store is unreachable.

    Two checks: (1) the poison key posted by a crashing rank's except
    hook or the watchdog (non-blocking; missing key = healthy); (2) a
    short wait on the liveness key every ObjectPlane seeds at
    construction: it returns at once while the store lives, so any error
    means the store's host is gone."""
    client = _client(store)
    reason = _read_abort(client)
    if reason is not None:
        raise JobAbortedError(f"job aborted by a crashed peer: {reason}")
    last = None
    pol = _rpc_policy()
    ladder = pol.liveness_ladder_ms()
    for attempt, attempt_ms in enumerate(ladder):
        # retry ladder: a loaded store may miss one short deadline; back
        # off (jittered) between attempts so N stuck ranks do not hammer
        # a struggling store in lockstep
        try:
            client.wait([_ALIVE_KEY],
                        datetime.timedelta(milliseconds=attempt_ms))
            return
        except Exception as e:  # noqa: BLE001
            last = e
            if attempt + 1 < len(ladder):
                time.sleep(pol.backoff_ms(attempt) / 1000.0)
    raise RuntimeError(
        "torch.distributed store unreachable (its host, rank 0, is gone?) "
        f"— aborting instead of waiting out the full timeout: {last}"
    ) from last


def _guard_rpc(fn, budget_ms: Optional[int] = None,
               store: Optional[Any] = None):
    """Run a store RPC that has no deadline of its own on a worker
    thread; while it blocks, probe the job's liveness every policy probe
    slice and raise promptly if it is aborted or the store is gone (the
    abandoned daemon thread is moot: the caller is about to tear the
    process down)."""
    pol = _rpc_policy()
    if budget_ms is None:
        budget_ms = pol.timeout_ms
    result: dict = {}

    def run():
        try:
            result["v"] = fn()
        except BaseException as e:  # noqa: BLE001 — surfaced to caller
            result["e"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    waited = 0
    while True:
        slice_ms = min(pol.probe_ms, budget_ms - waited)
        th.join(max(slice_ms, 1) / 1000)
        waited += slice_ms
        if not th.is_alive():
            break
        if waited >= budget_ms:
            raise TimeoutError(f"store RPC exceeded its {budget_ms} ms budget")
        _coordinator_alive(store)
    if "e" in result:
        raise result["e"]
    return result.get("v")


def _store_call(fn, store: Optional[Any] = None):
    """Run one store RPC (``add``, ``set``) that returns or raises at
    once; on an error, the liveness check decides what the caller sees:
    a job abort or a lost store raise the plane's own errors
    (:class:`JobAbortedError`, "store unreachable"), never the raw
    transport error, and any other error is raised as it was."""
    try:
        return fn()
    except Exception:  # noqa: BLE001 — converted or re-raised below
        _coordinator_alive(store)
        raise


def _wait_key(key: str, timeout_ms: int, store: Optional[Any] = None) -> None:
    """Poll until ``key`` exists, probing the job's liveness every probe
    slice (fail-fast); ``TimeoutError`` after ``timeout_ms``."""
    client = _client(store)
    pol = _rpc_policy()
    t0 = time.monotonic()
    next_probe = t0 + pol.probe_ms / 1000.0
    sleep = 0.0005
    while True:
        try:
            if client.check([key]):
                return
        except Exception:  # noqa: BLE001 — the ladder decides
            _coordinator_alive(store)
        now = time.monotonic()
        if (now - t0) * 1000.0 >= timeout_ms:
            raise TimeoutError(
                f"key {key!r} not published within {timeout_ms} ms")
        if now >= next_probe:
            _coordinator_alive(store)
            next_probe = now + pol.probe_ms / 1000.0
        time.sleep(sleep)
        sleep = min(sleep * 2, _POLL_MAX_S)


def _sliced_get(key: str, timeout_ms: int,
                store: Optional[Any] = None) -> bytes:
    """The value of ``key`` once published (bytes), waiting as
    :func:`_wait_key` does."""
    _chaos.on_rpc("kv_get")
    _wait_key(key, timeout_ms, store)
    return _client(store).get(key)


class ObjectPlane:
    """Object collectives and point-to-point over the store.

    ``rank``/``size`` default to the world's; ``namespace`` separates a
    sub-communicator's keys from the world's. Sequence counters are
    CLASS-level: every instance in a process shares them, because all
    instances share the store's one key namespace; SPMD discipline (every
    rank runs the same program, hence the same call order) keeps them
    aligned across ranks, as MPI's collectives do. They belong to one
    store: a new world (a new default group) restarts them at 0.
    """

    _seq: dict = {}
    _seq_store: Any = None

    def __init__(self, rank: Optional[int] = None, size: Optional[int] = None,
                 store: Optional[Any] = None, namespace: str = "") -> None:
        if rank is None or size is None:
            import torch.distributed as dist

            up = dist.is_available() and dist.is_initialized()
            rank = dist.get_rank() if up else 0
            size = dist.get_world_size() if up else 1
        self.process_index = int(rank)
        self.process_count = int(size)
        self._store = store
        self._prefix = f"og/{namespace}/" if namespace else "og/"
        base = store if store is not None else _world_store()
        if base is not ObjectPlane._seq_store:
            ObjectPlane._seq_store = base
            ObjectPlane._seq.clear()
        self._p2p_seq = ObjectPlane._seq
        client = _client(store)
        if client is not None and self.process_count > 1:
            # the liveness key the fail-fast probes wait on: it answers at
            # once while the store lives
            try:
                client.set(_ALIVE_KEY, "1")
            except Exception:
                pass

    # -- collectives ----------------------------------------------------

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        if self.process_count == 1:
            return obj
        key = f"{self._prefix}bc/{root}/{self._next_seq(f'bcast/{root}')}"
        if self.process_index == root:
            self._kv_put(key, pickle.dumps(obj))
            return obj
        return pickle.loads(self._kv_get(key))

    def allgather_obj(self, obj: Any) -> List[Any]:
        if self.process_count == 1:
            return [obj]
        key = f"{self._prefix}ag/{self._next_seq('allgather')}"
        self._kv_put(f"{key}/{self.process_index}", pickle.dumps(obj))
        return [pickle.loads(self._kv_get(f"{key}/{i}"))
                for i in range(self.process_count)]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        if self.process_count == 1:
            return [obj]
        key = f"{self._prefix}g/{self._next_seq('gather')}"
        self._kv_put(f"{key}/{self.process_index}", pickle.dumps(obj))
        if self.process_index != root:
            return None
        return [pickle.loads(self._kv_get(f"{key}/{i}"))
                for i in range(self.process_count)]

    def scatter_obj(self, objs: Optional[List[Any]], root: int = 0) -> Any:
        if self.process_count == 1:
            assert objs is not None
            return objs[0]
        key = f"{self._prefix}sc/{self._next_seq('scatter')}"
        if self.process_index == root:
            assert objs is not None and len(objs) == self.process_count
            for i, o in enumerate(objs):
                if i != root:
                    self._kv_put(f"{key}/{i}", pickle.dumps(o))
            return objs[root]
        return pickle.loads(self._kv_get(f"{key}/{self.process_index}",
                                         consume=True))

    # -- point-to-point -------------------------------------------------

    def _chan(self, src: int, dst: int, tag: int) -> str:
        return f"p2p/{src}/{dst}/{tag}"

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        """Returns once the object is in the store, without waiting for
        the receiver."""
        if self.process_count == 1:
            raise RuntimeError("send_obj with a single process has no peer")
        chan = self._chan(self.process_index, dest, tag)
        self._kv_put(f"{self._prefix}{chan}/{self._next_seq(chan)}",
                     pickle.dumps(obj))

    def recv_obj(self, src: int, tag: int = 0) -> Any:
        if self.process_count == 1:
            raise RuntimeError("recv_obj with a single process has no peer")
        chan = self._chan(src, self.process_index, tag)
        return pickle.loads(self._kv_get(
            f"{self._prefix}{chan}/{self._next_seq(chan)}", consume=True))

    def try_recv_obj(self, src: int, tag: int = 0,
                     timeout_ms: Optional[int] = None) -> Any:
        """Bounded receive that leaves the channel position intact on
        timeout: the sequence is committed only when the get succeeds; a
        miss raises ``TimeoutError`` and the next call retries the SAME
        slot."""
        if self.process_count == 1:
            raise RuntimeError(
                "try_recv_obj with a single process has no peer")
        chan = self._chan(src, self.process_index, tag)
        seq = self._p2p_seq.get(chan, 0)
        data = self._kv_get(f"{self._prefix}{chan}/{seq}",
                            timeout_ms=timeout_ms, consume=True)
        self._p2p_seq[chan] = seq + 1
        return pickle.loads(data)

    # -- host barrier ----------------------------------------------------

    def barrier(self, timeout_ms: Optional[int] = None) -> None:
        """Store-backed host barrier across ranks.

        Unlike a process-group barrier it needs no collective of the
        array route, and every wait is guarded: a dead peer or store
        turns into a bounded ``JobAbortedError``/``TimeoutError``
        instead of an infinite rendezvous (the watchdog contract)."""
        if self.process_count == 1:
            return
        seq = self._next_seq("host_barrier")
        self._barrier(f"{self._prefix}hb_barrier/{seq}",
                      timeout_ms if timeout_ms is not None
                      else _rpc_policy().barrier_ms())

    # -- store helpers (chunked) -----------------------------------------

    def _next_seq(self, channel: str) -> int:
        key = self._prefix + channel
        n = self._p2p_seq.get(key, 0)
        self._p2p_seq[key] = n + 1
        return n

    def _kv_put(self, key: str, data: bytes) -> None:
        _chaos.on_rpc("kv_put")
        nchunks = max(1, (len(data) + _KV_CHUNK - 1) // _KV_CHUNK)

        def put_all():
            # on the guard thread's own connection, so the caller's
            # liveness probes never queue behind a long put; the chunks
            # first, their count last: a reader that sees the count finds
            # every chunk
            client = _client(self._store)
            for c in range(nchunks):
                client.set(f"{key}/{c}",
                           data[c * _KV_CHUNK:(c + 1) * _KV_CHUNK])
            client.set(f"{key}/n", str(nchunks))

        # one guard thread for the whole put; its budget scales with the
        # payload so a large put is not cut off
        _guard_rpc(put_all, budget_ms=_rpc_policy().put_budget_ms(nchunks),
                   store=self._store)

    def _kv_get(self, key: str, timeout_ms: Optional[int] = None,
                consume: bool = False) -> bytes:
        """The value put under ``key``; ``consume`` deletes it after the
        read (a point-to-point message has one reader, so a large one
        does not stay in the store's memory)."""
        if timeout_ms is None:
            timeout_ms = _rpc_policy().timeout_ms
        nchunks = int(_as_str(_sliced_get(f"{key}/n", timeout_ms,
                                          self._store)))
        client = _client(self._store)
        parts = [client.get(f"{key}/{c}") for c in range(nchunks)]
        if consume:
            for k in [f"{key}/n"] + [f"{key}/{c}" for c in range(nchunks)]:
                try:
                    client.delete_key(k)
                except Exception:
                    pass
        return b"".join(parts)

    def _barrier(self, name: str, timeout_ms: int) -> None:
        _chaos.on_rpc("barrier")
        client = _client(self._store)
        # arrivals are counted by the store's add; the last arrival posts
        # the done key every rank waits for
        # the done key every rank waits for; every store call goes
        # through the liveness conversion, as every wait does
        store = self._store
        if int(_store_call(lambda: client.add(f"{name}/arrived", 1),
                           store)) >= self.process_count:
            _store_call(lambda: client.set(f"{name}/done", "1"), store)
        _wait_key(f"{name}/done", timeout_ms, store)
        # rank 0 leaves last: under env:// its process hosts the store,
        # and a peer still polling for the done key must find it there
        if int(_store_call(lambda: client.add(f"{name}/left", 1),
                           store)) >= self.process_count:
            _store_call(lambda: client.set(f"{name}/all_left", "1"), store)
        if self.process_index == 0:
            _wait_key(f"{name}/all_left", timeout_ms, self._store)


class FsObjectPlane:
    """File-backed point-to-point object plane for supervised fleets.

    Counterpart of the JAX package's ``FsObjectPlane``, a copy. A store
    cannot re-admit a rank after SIGKILL (its host may be the dead
    process, and a new world is a new store), which rules it out as the
    wire for the supervised-restart drill. This plane keeps the exact
    ``send_obj`` / ``recv_obj`` / ``try_recv_obj`` surface but rides a
    shared directory instead:

    * one subdirectory per directed channel ``(src, dst, tag)``, one
      file per message, named by sequence number;
    * writes are atomic (tmp + ``os.replace``) so a reader can never
      observe a torn message — a SIGKILL mid-write leaves only a tmp
      file the reader ignores;
    * the sender derives its next sequence from the files already on
      disk, so a restarted incarnation continues the channel instead of
      overwriting it; when :meth:`gc` has pruned every consumed file,
      the per-channel ``HWM`` high-water mark supplies the floor, so a
      reborn sender still never reuses a sequence number;
    * the receiver may :meth:`gc` a channel after resolving frames:
      the high-water mark is committed atomically BEFORE any file is
      unlinked, and a reborn receiver seeds its position from it — a
      crash between the two steps at worst re-deletes, never re-reads;
    * every receive is deadline-bounded (``TimeoutError`` on a miss;
      ``try_recv_obj`` commits the reader position only on success).

    Single-host scope: this is the test/drill wire for processes sharing
    a filesystem, not a datacenter transport.
    """

    def __init__(self, root: str, index: int, count: int) -> None:
        self.root = root
        self.process_index = int(index)
        self.process_count = int(count)
        self._recv_pos: dict = {}
        os.makedirs(root, exist_ok=True)

    def _chan_dir(self, src: int, dst: int, tag: int) -> str:
        return os.path.join(self.root, f"p2p_{src}_{dst}_{tag}")

    @staticmethod
    def _read_hwm(chan_dir: str) -> int:
        """The channel's GC high-water mark: every seq below it has
        been consumed and pruned (0 when the channel was never GCed)."""
        try:
            with open(os.path.join(chan_dir, "HWM")) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    @classmethod
    def _next_seq(cls, chan_dir: str) -> int:
        """Next unused sequence on a channel (restart-safe): one past
        the highest frame still on disk, falling back to the GC
        high-water mark when every consumed frame has been pruned."""
        try:
            names = os.listdir(chan_dir)
        except FileNotFoundError:
            return 0
        seqs = [int(n[:-4]) for n in names if n.endswith(".obj")]
        if seqs:
            return max(seqs) + 1
        return cls._read_hwm(chan_dir)

    @staticmethod
    def _atomic_write(dir_: str, name: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(dir_, name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        chan = self._chan_dir(self.process_index, dest, tag)
        os.makedirs(chan, exist_ok=True)
        self._atomic_write(chan, f"{self._next_seq(chan):08d}.obj",
                           pickle.dumps(obj))

    def _read_at(self, src: int, tag: int, seq: int,
                 timeout_ms: Optional[int]) -> bytes:
        if timeout_ms is None:
            timeout_ms = _rpc_policy().timeout_ms
        path = os.path.join(self._chan_dir(src, self.process_index, tag),
                            f"{seq:08d}.obj")
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                pass
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"object {path!r} not published within {timeout_ms} ms")
            # poll fast: the drill ships small frames on one host
            time.sleep(min(left, 0.005))

    def _pos(self, src: int, tag: int) -> int:
        """Current reader position, seeded from the channel's GC
        high-water mark on first access — a reborn receiver must not
        wait on frames :meth:`gc` already unlinked."""
        chan = (src, tag)
        if chan not in self._recv_pos:
            self._recv_pos[chan] = self._read_hwm(
                self._chan_dir(src, self.process_index, tag))
        return self._recv_pos[chan]

    def recv_obj(self, src: int, tag: int = 0) -> Any:
        seq = self._pos(src, tag)
        self._recv_pos[(src, tag)] = seq + 1
        return pickle.loads(self._read_at(src, tag, seq, None))

    def try_recv_obj(self, src: int, tag: int = 0,
                     timeout_ms: Optional[int] = None) -> Any:
        """Bounded receive; the reader position advances only on
        success, so a timed-out poll retries the same slot later."""
        seq = self._pos(src, tag)
        data = self._read_at(src, tag, seq, timeout_ms)
        self._recv_pos[(src, tag)] = seq + 1
        return pickle.loads(data)

    def gc(self, src: int, tag: int = 0) -> int:
        """Prune this receiver's consumed frames on channel
        ``src → self``. Commits ``HWM = position`` atomically FIRST,
        then unlinks every ``.obj`` below it; returns the number
        pruned. Unconsumed frames (seq >= position) are never touched,
        so a sender mid-flight loses nothing."""
        chan_dir = self._chan_dir(src, self.process_index, tag)
        pos = self._pos(src, tag)
        os.makedirs(chan_dir, exist_ok=True)
        self._atomic_write(chan_dir, "HWM", str(pos).encode())
        pruned = 0
        for name in os.listdir(chan_dir):
            if name.endswith(".obj") and int(name[:-4]) < pos:
                try:
                    os.unlink(os.path.join(chan_dir, name))
                    pruned += 1
                except OSError:
                    pass                # concurrent GC: already gone
        return pruned
