"""Replica router: one front door over N serving engines.

Counterpart of ``chainermn_tpu/fleet/router.py``.

Each :class:`EngineReplica` owns a single-threaded ``serving.Engine``
behind its own worker thread and inbox (the same ownership discipline
as ``serving.Frontend``, multiplied). The :class:`Router` fronts them
with:

* **load-aware + session-affine placement** — least queue depth
  (inbox + engine queue + occupied slots) among live replicas, except
  that a ``session=`` tag STICKS to the replica already serving it
  (in-flight conversational streams keep their locality; the sticky
  mapping survives only while its replica does);
* **queue-depth backpressure** — with ``max_queue_depth`` set, a
  submission finding EVERY live replica at its bound raises
  ``serving.AdmissionRejected`` with the ``RpcPolicy`` backoff base as
  its retry-after hint, exactly like a single ``Frontend``;
* **health-driven re-queue** — replica workers heartbeat
  :class:`~chainermn_torch.fleet.health.FleetHealth` every iteration; a
  silent or dead-threaded replica (chaos ``kill_replica``, a raise, a
  real SIGKILL in the supervised drill) is declared dead and its
  unfinished work re-queues onto survivors WITHOUT dropping client
  futures. A re-queued request re-runs from its seed, and the
  one-key-split-per-token contract (serving/sampling.py) makes the
  replayed stream identical — zero dropped, zero duplicated tokens,
  which the chaos drill asserts literally;
* **replica lifecycle + live migration** — ``UP → DRAINING →
  DRAINED/DEAD``. :meth:`Router.drain` takes one replica out of
  service WITHOUT replaying its work from scratch: placement stops,
  the never-admitted backlog re-queues untouched, and every actively
  decoding session is frozen at a token boundary
  (``Engine.export_session``), shipped over the handoff transport
  (SHA-verified frames, NACK/re-send under the RpcPolicy budget), and
  adopted by the least-depth survivor (``Engine.import_session``) —
  the continued stream is BITWISE the never-migrated one. Any failure
  along the way (transport budget exhausted, corrupt frame, no
  destination, a death mid-migration) falls back to the SAME
  replay-from-seed re-queue a death uses, so a failed migration is
  never worse than a death. The drained replica then decommissions
  cleanly; ``_sweep_dead`` skips it. :meth:`Router.readmit` closes the
  loop — a DRAINED replica (weights swapped by ``fleet/rollout.py``)
  re-registers with a fresh worker thread and rejoins placement, the
  READMIT leg of the rolling-update lifecycle CANARY → DRAIN → SWAP →
  READMIT.

The router's dispatch loop and ``result()`` keep every wait BOUNDED
(``get_nowait`` + idle sleep, probe-sliced future waits) — dlint DL111
polices exactly this loop shape, because one ``inbox.get()`` with no
timeout here turns a replica death into a frozen fleet.
"""

from __future__ import annotations

import contextlib
import itertools
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional

from chainermn_torch.device import bind_thread_device, cuda_index_of
from chainermn_torch.fleet.handoff import (HandoffError, decode_handoff,
                                         encode_handoff)
from chainermn_torch.fleet.health import FleetHealth
from chainermn_torch.fleet.reports import FleetReport
from chainermn_torch.fleet.transport import InProcessTransport
from chainermn_torch.resilience import chaos
from chainermn_torch.resilience.policy import RpcPolicy, policy
from chainermn_torch.resilience.watchdog import current_watchdog
from chainermn_torch.serving.frontend import (AdmissionRejected,
                                            DeadlineExceeded)

__all__ = ["EngineReplica", "Router"]

_IDLE_WAIT_S = 0.002


class _FleetItem:
    """One routed request: prompt + kwargs + the client future the
    router owns end-to-end (a replica death re-queues the item; the
    future only ever resolves once, on whichever replica finishes)."""

    __slots__ = ("item_id", "prompt", "kw", "future", "session")

    def __init__(self, item_id: int, prompt, kw: dict,
                 session: Optional[str]):
        self.item_id = item_id
        self.prompt = prompt
        self.kw = kw
        self.future: Future = Future()
        self.session = session


class EngineReplica:
    """One engine + worker thread + inbox. The worker: admit from the
    inbox, step the engine when it has work, resolve finished futures,
    heartbeat. The chaos ``kill_replica`` fault is checked per WORKING
    iteration (idle polls don't advance the counter, so
    ``kill_replica@step=N,replica=R`` is deterministic at any poll
    rate) and kills the thread mid-state — inflight slots and queued
    items stay exactly where they were, which is the point."""

    def __init__(self, replica_id: int, engine,
                 health: Optional[FleetHealth] = None):
        self.replica_id = int(replica_id)
        self.engine = engine
        self.inbox: _queue.Queue = _queue.Queue()
        self.inflight: Dict[int, tuple] = {}      # item_id → (item, req)
        self.lock = threading.Lock()
        # callers other than the worker waiting for ``lock`` (claim())
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self.draining = False         # excluded from placement; sessions
        #                               migrating off (Router.drain)
        self.drained = False          # decommissioned cleanly
        self._health = health
        self._stop = threading.Event()
        self._killed = False
        self._clean_exit = False
        self._work_iter = 0
        # torch.cuda's current device is per thread: the worker binds
        # the engine's card before its first dispatch
        self._cuda_index = cuda_index_of(engine)
        self.thread = threading.Thread(
            target=self._run, name=f"fleet-replica-{replica_id}",
            daemon=True)

    def start(self) -> None:
        self.thread.start()

    @contextlib.contextmanager
    def claim(self):
        """``lock``, for a caller other than the worker (a drain, a
        migration, a shed). A plain lock is not fair: the worker takes
        it back the instant it lets go, so on a busy host a drain could
        wait out every stream it came to migrate. While a claim waits,
        the worker pauses between iterations and lets it in."""
        with self._waiters_lock:
            self._waiters += 1
        with self.lock:
            with self._waiters_lock:
                self._waiters -= 1
            yield

    def state(self) -> str:
        """Lifecycle state: ``UP → DRAINING → DRAINED`` (clean
        decommission via ``Router.drain``) or ``DEAD`` (dirty exit —
        the health sweep replays its sessions)."""
        if self.dead():
            return "DEAD"
        if self.drained:
            return "DRAINED"
        if self.draining:
            return "DRAINING"
        return "UP"

    def depth(self) -> int:
        """Placement load: inbox + engine queue + occupied slots."""
        return (self.inbox.qsize() + len(self.engine.queue)
                + len(self.engine.active) + len(self.engine.prefilling))

    def kill(self) -> None:
        """Die DIRTY (test hook, same observable as the chaos fault):
        the worker exits without the clean flag, abandoning its state
        for the router's health sweep to re-queue."""
        self._killed = True

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=30)

    def dead(self) -> bool:
        return not self.thread.is_alive() and not self._clean_exit

    def drain_unfinished(self) -> List[_FleetItem]:
        """After death: every item whose future is still open, in
        submission order (inflight first — they were admitted first —
        then the never-admitted inbox backlog).

        The join makes the common deaths (chaos kill, ``kill()``, a
        raise) fully race-free — the worker is gone before we touch its
        state. A wedged-but-alive worker (heartbeat death) is blocked
        INSIDE a dispatch, past admission, so it holds no item in hand;
        snapshotting under the replica lock (bounded acquire — a wedged
        dispatch may hold it forever) and clearing ``inflight`` fences
        it off these futures, and the ``done()`` guard on resolution
        makes any residual overlap harmless."""
        self.thread.join(timeout=5.0)
        got = self.lock.acquire(timeout=1.0)
        try:
            items = [item for _iid, (item, _req)
                     in sorted(self.inflight.items())]
            if got:
                self.inflight.clear()
            try:
                while True:
                    items.append(self.inbox.get_nowait())
            except _queue.Empty:
                pass
        finally:
            if got:
                self.lock.release()
        return [it for it in items if not it.future.done()]

    def _run(self) -> None:
        bind_thread_device(self._cuda_index)
        while not self._stop.is_set():
            if self._killed:
                return                       # dirty exit: state abandoned
            if self._health is not None:
                self._health.beat(self.replica_id)
            worked = False
            try:
                while True:
                    item = self.inbox.get_nowait()
                    with self.lock:
                        try:
                            req = self.engine.submit(item.prompt,
                                                     **item.kw)
                            self.inflight[item.item_id] = (item, req)
                        except Exception as e:   # bad request, not fatal
                            item.future.set_exception(e)
                    worked = True
            except _queue.Empty:
                pass
            with self.lock:
                if not self.engine.idle():
                    if chaos.on_replica_step(self.replica_id,
                                             self._work_iter):
                        self._killed = True
                        return               # chaos kill: dirty exit
                    self._work_iter += 1
                    # one [n_slots, k] int32 pull per dispatch
                    self.engine.step()  # dlint: disable=DL104
                    worked = True
                    for iid, (item, req) in list(self.inflight.items()):
                        if req.finished:
                            del self.inflight[iid]
                            if not item.future.done():
                                item.future.set_result(req)
            if not worked or self._waiters:
                time.sleep(_IDLE_WAIT_S)
        self._clean_exit = True


class Router:
    """The fleet front door. Construct with engines, submit from any
    thread, ``result()`` with deadline-bounded waits, ``close()`` when
    done (context manager supported)."""

    def __init__(self, engines, *, rpc_policy: Optional[RpcPolicy] = None,
                 watchdog=None, max_queue_depth: Optional[int] = None,
                 health_timeout_ms: Optional[int] = None,
                 report: Optional[FleetReport] = None,
                 migration_transport=None,
                 migration_wire_format: str = "f32"):
        if not engines:
            raise ValueError("Router needs at least one engine")
        self._policy = rpc_policy
        self._watchdog = watchdog
        self.max_queue_depth = max_queue_depth
        self.report = report or FleetReport()
        # session-migration wire (Router.drain): any transport with the
        # send/poll faces; the in-process one rides the same chaos
        # on_wire + NACK/re-send protocol as the cross-host plane
        self._mig_transport = (migration_transport
                               or InProcessTransport(pol=rpc_policy))
        self._mig_format = migration_wire_format
        self._mig_arrivals: Dict[int, object] = {}   # stream_id → Arrival
        self.health = FleetHealth(range(len(engines)),
                                  timeout_ms=health_timeout_ms)
        self.replicas: Dict[int, EngineReplica] = {
            i: EngineReplica(i, eng, self.health)
            for i, eng in enumerate(engines)}
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._sessions: Dict[str, int] = {}       # session → replica_id
        self._handled_dead: set = set()
        self._ids = itertools.count()
        self._stop = threading.Event()
        for rep in self.replicas.values():
            rep.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-router", daemon=True)
        self._thread.start()

    # ----------------------------------------------------------------
    # client face (any thread)
    # ----------------------------------------------------------------

    def _alive(self) -> List[EngineReplica]:
        return [self.replicas[r] for r in self.health.alive()
                if not self.replicas[r].dead()]

    def _placeable(self) -> List[EngineReplica]:
        """Replicas new work may land on: alive and not on their way
        out of service (a DRAINING replica still finishes or migrates
        what it has, but takes nothing new)."""
        return [r for r in self._alive()
                if not r.draining and not r.drained]

    def submit(self, prompt, *, session: Optional[str] = None,
               **kw) -> Future:
        """Route one request; kwargs pass through to ``Engine.submit``.
        ``session`` opts into sticky placement. Raises
        :class:`~chainermn_torch.serving.frontend.AdmissionRejected` when
        every placeable replica sits at ``max_queue_depth`` — shed at
        the door with a retry-after hint that SCALES with how far past
        the bound the fleet is (a client seeing 4× the base backoff
        knows the fleet is deeply backed up, not momentarily full)."""
        if self._stop.is_set():
            raise RuntimeError("router is closed")
        if self.max_queue_depth is not None:
            live = self._placeable()
            with self._lock:
                backlog = len(self._pending)
            # the not-yet-placed router backlog counts against the
            # fleet's headroom too — otherwise a burst outruns the
            # dispatch loop and sails past the bound unrejected
            total = sum(r.depth() for r in live) + backlog
            bound = self.max_queue_depth * len(live)
            if live and total >= bound:
                pol = self._policy or policy()
                self.report.record_rejected()
                retry = self._retry_after_ms(pol, total, bound,
                                             len(live))
                raise AdmissionRejected(
                    f"fleet backlog {total} at the bound "
                    f"({self.max_queue_depth} × {len(live)} placeable "
                    f"replicas); retry after {retry} ms",
                    retry_after_ms=retry)
        item = _FleetItem(next(self._ids), prompt, kw, session)
        with self._lock:
            self._pending.append(item)
        return item.future

    def _retry_after_ms(self, pol: RpcPolicy, total: int, bound: int,
                        n_live: int) -> int:
        """Aggregate-depth-scaled retry hint: exactly at the bound the
        base backoff (the single-Frontend behaviour), then linear in
        the excess backlog per configured replica-slot of headroom,
        capped at 16× so a pathological burst can't push clients into
        hour-long retries."""
        per = max(1, n_live * max(1, self.max_queue_depth or 1))
        scale = min(16.0, 1.0 + max(0, total - bound) / per)
        return int(pol.backoff_base_ms * scale)

    def result(self, future: Future, timeout_ms: Optional[int] = None):
        """Deadline-bounded wait sliced at ``probe_ms`` (the DL111-clean
        shape: every slice is a bounded wait, and a dead router thread
        surfaces on the next probe, not after the full budget)."""
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
                return future.result(timeout=min(pol.probe_ms / 1e3, left))
            except FutureTimeout:
                if not self._thread.is_alive() and not future.done():
                    raise RuntimeError(
                        "router thread died with the request in flight")

    def quiesce(self, timeout_ms: Optional[int] = None) -> None:
        """Block until no routed work remains anywhere in the fleet
        (pending, inboxes, engines, inflight) — replica deaths along
        the way re-queue through the health sweep and still drain."""
        pol = self._policy or policy()
        budget_ms = timeout_ms if timeout_ms is not None else pol.timeout_ms
        deadline = time.monotonic() + budget_ms / 1e3
        while time.monotonic() < deadline:
            with self._lock:
                quiet = not self._pending
            if quiet and all(
                    rep.dead() or (rep.inbox.qsize() == 0
                                   and not rep.inflight
                                   and rep.engine.idle())
                    for rep in self.replicas.values()):
                return
            time.sleep(_IDLE_WAIT_S)
        raise DeadlineExceeded(f"fleet not quiet within {budget_ms} ms")

    def shed_pending(self) -> int:
        """Cancel every request that has not STARTED decoding — the
        graceful-retirement shed (``tools/fleet_lm.py`` calls this on
        SIGUSR1, finishes what is in flight, and exits 0; the shed ids
        are simply absent from the output JSONL, so the next
        incarnation's idempotent replay re-submits exactly them).
        Sheds three never-started tiers: the router backlog, replica
        inbox backlogs, and requests still sitting in an engine queue.
        Actively decoding streams are untouched. Returns the number
        shed.

        Race-free by construction: a router-backlog item is either
        still in ``_pending`` (we pop + cancel it; the dispatch loop's
        ``future.done()`` re-check skips it) or already popped (the
        loop owns it; we never see it). Engine-queued requests are
        removed under ``rep.lock`` — the same lock the worker steps
        under — so a request observed ``queued`` cannot be admitted
        out from under the removal."""
        with self._lock:
            items = list(self._pending)
            self._pending.clear()
        n = sum(1 for item in items if item.future.cancel())
        for rep in self.replicas.values():
            if rep.dead():
                continue               # the death sweep owns its items
            n += sum(1 for item in self._pull_inbox(rep)
                     if item.future.cancel())
            with rep.claim():
                for iid, (item, req) in list(rep.inflight.items()):
                    if req.state != "queued":
                        continue       # decoding/prefilling: finishes
                    try:
                        rep.engine.queue.remove(req)
                    except ValueError:
                        continue
                    rep.inflight.pop(iid)
                    req.state = "aborted"
                    rep.engine.report.record_retire(req.request_id,
                                                    aborted=True)
                    if item.future.cancel():
                        n += 1
        return n

    # ----------------------------------------------------------------
    # replica lifecycle: UP → DRAINING → DRAINED/DEAD
    # ----------------------------------------------------------------

    def drain(self, replica_id: int,
              deadline_ms: Optional[int] = None) -> dict:
        """Take one replica out of service WITHOUT losing a token:
        placement stops immediately, the never-admitted backlog
        re-queues untouched, every actively decoding session migrates
        to the least-depth survivor over the handoff transport
        (``export_session`` → encode → SHA-verified frames under the
        NACK/re-send budget → ``import_session``), and the replica then
        decommissions cleanly (state ``DRAINED``; the health sweep
        skips it). Work that cannot migrate yet (engine-queued,
        mid-prefill) gets time to ripen until ``deadline_ms``
        (``RpcPolicy.timeout_ms`` by default); at the deadline the
        remainder is evacuated onto the replay-from-seed path — the
        exact machinery a replica DEATH uses, so the failure mode of a
        drain is never worse than the failure it prevents. Runs on the
        caller's thread; returns ``{"migrated", "requeued", "state"}``.
        """
        rep = self.replicas.get(int(replica_id))
        if rep is None:
            raise ValueError(f"unknown replica {replica_id}")
        if rep.drained or rep.draining:
            return {"migrated": 0, "requeued": 0, "state": rep.state()}
        if rep.dead() or not self.health.is_alive(rep.replica_id):
            raise ValueError(
                f"replica {replica_id} is dead — the health sweep "
                "already owns its sessions")
        if not [r for r in self._placeable() if r is not rep]:
            raise ValueError(
                "cannot drain the last placeable replica — its "
                "sessions would have nowhere to go")
        rep.draining = True
        # sticky sessions re-place on survivors from here on
        for session, mapped in list(self._sessions.items()):
            if mapped == rep.replica_id:
                del self._sessions[session]
        pol = self._policy or policy()
        budget_ms = (deadline_ms if deadline_ms is not None
                     else pol.timeout_ms)
        deadline = time.monotonic() + budget_ms / 1e3
        migrated = 0
        requeued = self._requeue_items(self._pull_inbox(rep))
        while not rep.dead():
            with rep.claim():
                pairs = [(iid, item, req) for iid, (item, req)
                         in sorted(rep.inflight.items())]
            if not pairs:
                with rep.claim():
                    busy = bool(rep.inflight) or not rep.engine.idle()
                if not busy and rep.inbox.qsize() == 0:
                    break
            if time.monotonic() >= deadline:
                requeued += self._requeue_items(self._evacuate(rep))
                break
            progress = False
            for iid, item, req in pairs:
                outcome = self._migrate_one(rep, iid, item, req)
                if outcome == "migrated":
                    migrated += 1
                    progress = True
                elif outcome == "requeued":
                    requeued += 1
                    progress = True
            # a burst may have raced into the inbox before the worker
            # observed the draining flag — pull it back out
            requeued += self._requeue_items(self._pull_inbox(rep))
            if not progress:
                time.sleep(_IDLE_WAIT_S)
        if not rep.dead():
            # decommission: a CLEAN exit — pre-register with the sweep
            # so the stopped heartbeat is not mistaken for a death
            self._handled_dead.add(rep.replica_id)
            rep.stop()
            rep.drained = True
            rep.draining = False
            self.health.mark_dead(rep.replica_id,
                                  "drained and decommissioned")
            self.report.record_drained()
        return {"migrated": migrated, "requeued": requeued,
                "state": rep.state()}

    def readmit(self, replica_id: int) -> None:
        """Bring a cleanly DRAINED replica back into service — the
        READMIT leg of a rolling weight update (``fleet/rollout.py``
        drains, swaps the verified snapshot in, then readmits). The
        engine keeps its identity (and its freshly swapped weights); a
        NEW worker thread wraps it, the health verdict is withdrawn,
        and placement sees the replica again on the next dispatch pass.
        A DEAD replica does not readmit — the supervisor restart path
        owns dirty exits."""
        rep = self.replicas.get(int(replica_id))
        if rep is None:
            raise ValueError(f"unknown replica {replica_id}")
        if not rep.drained:
            raise ValueError(
                f"replica {replica_id} is {rep.state()} — only a "
                "cleanly DRAINED replica readmits (a DEAD one restarts "
                "under the supervisor instead)")
        new = EngineReplica(rep.replica_id, rep.engine, self.health)
        # start BEFORE publishing: an unstarted worker reads as dead()
        # to the sweep, and the _handled_dead fence comes off LAST so
        # no intermediate state can be mistaken for a fresh death
        new.start()
        self.replicas[rep.replica_id] = new
        self.health.revive(rep.replica_id)
        self._handled_dead.discard(rep.replica_id)

    def _pull_inbox(self, rep: EngineReplica) -> List[_FleetItem]:
        """Drain a replica's never-admitted inbox backlog (these items
        have no engine state — re-queueing them is trivially lossless)."""
        items: List[_FleetItem] = []
        try:
            while True:
                items.append(rep.inbox.get_nowait())
        except _queue.Empty:
            pass
        return [it for it in items if not it.future.done()]

    def _requeue_items(self, items: List[_FleetItem]) -> int:
        """Back to the FRONT of pending, futures intact — the shared
        tail of both the death path and every failed migration."""
        if not items:
            return 0
        self.report.record_requeue(len(items))
        with self._lock:
            for item in reversed(items):
                self._pending.appendleft(item)
        return len(items)

    def _evacuate(self, rep: EngineReplica) -> List[_FleetItem]:
        """Deadline-forced fallback: pop every in-flight item (fencing
        the worker off their futures), abort the engine-side requests,
        and hand the items back for a replay from seed."""
        with rep.claim():
            items = [item for _iid, (item, _req)
                     in sorted(rep.inflight.items())]
            rep.inflight.clear()
            rep.engine.abort_all()
        items.extend(self._pull_inbox(rep))
        return [it for it in items if not it.future.done()]

    def _pick_dest(self, src: EngineReplica) -> Optional[EngineReplica]:
        """Least-depth survivor with a free slot to adopt into (the
        peek is racy — the authoritative check is ``import_session``
        under the destination lock; a miss keeps the session frozen
        and retries the adoption)."""
        cands = [r for r in self._placeable()
                 if r is not src and r.engine.free_slots]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.depth(), r.replica_id))

    def _take_arrival(self, stream_id: int):
        arr = self._mig_arrivals.pop(stream_id, None)
        if arr is not None:
            return arr
        for a in self._mig_transport.poll():
            if a.stream_id == stream_id:
                arr = a
            else:
                self._mig_arrivals[a.stream_id] = a
        return arr

    def _migrate_one(self, rep: EngineReplica, iid: int,
                     item: _FleetItem, req) -> str:
        """Move one in-flight session off a draining replica. Returns
        ``migrated`` (adopted bitwise by a survivor), ``requeued``
        (fallback to replay from seed), ``pending`` (not migratable
        yet — engine-queued, mid-prefill, or every survivor's slots
        are full; let it ripen), or ``done`` (resolved while we
        looked)."""
        if self._pick_dest(rep) is None:
            # a saturated survivor is TRANSIENT — shipping bytes now
            # would leave them with nowhere to adopt and burn the
            # replay fallback on a non-failure; retry once a slot
            # frees (the deadline bounds the wait)
            return "pending"
        arrival = self._mig_arrivals.pop(item.item_id, None)
        if arrival is None:
            with rep.claim():
                if rep.inflight.get(iid, (None, None))[0] is not item:
                    return "done"
                if item.future.done() or req.finished:
                    rep.inflight.pop(iid, None)
                    return "done"
                try:
                    session = rep.engine.export_session(req)
                except ValueError:
                    return "pending"
                # fenced: the source worker can no longer resolve this
                # future, and the death sweep can no longer re-queue it
                rep.inflight.pop(iid, None)
            manifest, blob = encode_handoff(session, self._mig_format)
            status = self._mig_transport.send(item.item_id, manifest, blob)
            arrival = self._take_arrival(item.item_id)
            if (status not in ("adopted", "duplicate") or arrival is None
                    or arrival.failed):
                arrival = None
        else:
            # a prior attempt already shipped and the wire verified the
            # frame; the session stayed FROZEN on the source, so those
            # bytes are still current — retry adoption only
            with rep.claim():
                if rep.inflight.get(iid, (None, None))[0] is not item:
                    return "done"
                rep.inflight.pop(iid, None)
                if item.future.done() or req.finished:
                    try:
                        rep.engine.release_held(req)
                    except ValueError:
                        pass
                    return "done"
        dest = None
        newreq = None
        handoff = None
        if arrival is not None:
            try:
                handoff = decode_handoff(arrival.manifest, arrival.blob)
            except HandoffError:
                handoff = None
            if handoff is not None:
                dest = self._pick_dest(rep)
                if dest is not None:
                    with dest.claim():
                        try:
                            newreq = dest.engine.import_session(
                                handoff, item.prompt)
                            dest.inflight[iid] = (item, newreq)
                        except RuntimeError:
                            newreq = None  # slot raced away — transient
                        except Exception:
                            newreq = None
                            handoff = None  # structural — real failure
        if newreq is None:
            if handoff is not None:
                # the wire delivered a verified frame but the survivor
                # slot raced away at adoption time (the _pick_dest peek
                # is advisory) — abandon the ATTEMPT, not the stream:
                # keep the session frozen on the source (resuming would
                # decode tokens the adopter re-emits from the snapshot,
                # double-counting them), cache the arrival for the
                # retry, and let it ripen until a slot frees
                self._mig_arrivals[item.item_id] = arrival
                with rep.claim():
                    rep.inflight[iid] = (item, req)
                return "pending"
            # transport budget exhausted / torn frame: free the source
            # slot and replay from seed — the failure mode IS the death
            # path, never worse
            with rep.claim():
                try:
                    rep.engine.abort_held(req)
                except ValueError:
                    pass
            self.report.record_migration_fallback()
            self._requeue_items(
                [item] if not item.future.done() else [])
            return "requeued"
        self.report.record_migration(self._mig_format, len(arrival.blob))
        if item.session is not None:
            self._sessions[item.session] = dest.replica_id
        # adopt-before-ack chaos window: the destination owns the
        # stream now; killing it here must land in replay-from-seed
        if chaos.on_migration(item.item_id):
            dest.kill()
        with rep.claim():
            try:
                rep.engine.release_held(req)
            except ValueError:
                pass
        return "migrated"

    def close(self) -> None:
        self._stop.set()
        for rep in self.replicas.values():
            rep.stop()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def reports(self):
        return [rep.engine.report for rep in self.replicas.values()]

    def summary(self) -> dict:
        """Fleet summary plus live lifecycle visibility: per-replica
        states and the ``draining`` set, so a caller watching capacity
        can see reduced headroom BEFORE rejections start."""
        out = self.report.summary(self.reports())
        states = {rid: rep.state()
                  for rid, rep in sorted(self.replicas.items())}
        out["fleet"]["replica_states"] = states
        out["fleet"]["draining"] = sorted(
            rid for rid, s in states.items() if s == "DRAINING")
        out["fleet"]["weights_versions"] = {
            rid: getattr(rep.engine, "weights_version", None)
            for rid, rep in sorted(self.replicas.items())}
        # live wire-health counters off the migration transport (the
        # FleetReport block carries the fold of FINISHED transports;
        # this one is the router's own, still-running wire)
        mig = self._mig_transport
        sender = getattr(mig, "stats", {})
        recv = mig.receiver_stats
        plane_stats = getattr(getattr(mig, "plane", None), "stats", {})
        live = out["fleet"]["transport"]
        live["retransmits"] += max(0, int(sender.get("attempts", 0))
                                   - int(sender.get("sent", 0)))
        live["reconnects"] += int((plane_stats or {}).get(
            "reconnects", 0))
        live["dup_fenced"] += int(recv.get("duplicates", 0))
        live["chunk_nacks"] += int(recv.get("chunk_nacked", 0))
        return out

    # ----------------------------------------------------------------
    # dispatch loop (router thread)
    # ----------------------------------------------------------------

    def _place(self, item: _FleetItem) -> Optional[EngineReplica]:
        """Session-affine, else least-depth, among placeable replicas
        with headroom. Returns None when nothing can take the item yet.
        A DRAINING replica is never a target — not even for its own
        sticky sessions (drain already unstuck them; a straggler
        mapping re-places like any other item)."""
        live = self._placeable()
        if not live:
            return None
        if item.session is not None:
            rid = self._sessions.get(item.session)
            if rid is not None and self.health.is_alive(rid) \
                    and not self.replicas[rid].dead() \
                    and not self.replicas[rid].draining \
                    and not self.replicas[rid].drained:
                return self.replicas[rid]
        candidates = live
        if self.max_queue_depth is not None:
            candidates = [r for r in live
                          if r.depth() < self.max_queue_depth]
            if not candidates:
                return None
        return min(candidates, key=lambda r: (r.depth(), r.replica_id))

    def _handle_dead(self, rid: int) -> None:
        """Re-queue a dead replica's unfinished work at the FRONT of
        pending, futures intact — the replay-from-seed contract makes
        the survivor's stream identical to the one that died."""
        rep = self.replicas[rid]
        # FENCE first: a heartbeat-declared death may be a wedged-but-
        # running worker (e.g. a stalled dispatch) — shoot it in the
        # head so it cannot race the survivor for these futures
        rep.kill()
        items = rep.drain_unfinished()
        self.report.record_replica_dead()
        for session, mapped in list(self._sessions.items()):
            if mapped == rid:
                del self._sessions[session]
        self._requeue_items(items)

    def _sweep_dead(self) -> bool:
        """Two death signals, one verdict: heartbeat silence past the
        probe deadline (FleetHealth) and worker-thread death observed
        directly (a chaos kill or a raise stops beats AND the thread —
        the thread check notices within one loop pass instead of one
        probe period). A DRAINED replica pre-registers in
        ``_handled_dead`` before its heartbeat stops, so a clean
        decommission never reads as a death."""
        worked = False
        for rid, rep in self.replicas.items():
            if rep.dead() and self.health.is_alive(rid):
                self.health.mark_dead(rid, "worker thread died")
        newly = {rid for rid
                 in set(self.health.check()) | set(self.health.dead)
                 if rid not in self._handled_dead}
        for rid in sorted(newly):
            self._handled_dead.add(rid)
            self._handle_dead(rid)
            worked = True
        return worked

    def _poll_watchdog(self) -> None:
        from chainermn_torch.comm.object_plane import JobAbortedError

        wd = self._watchdog or current_watchdog()
        if wd is None:
            return
        try:
            wd.check()
        except JobAbortedError as e:
            # bounded abortion, fleet-wide: fail every open future now
            items = []
            with self._lock:
                items.extend(self._pending)
                self._pending.clear()
            for rep in self.replicas.values():
                with rep.claim():
                    rep.engine.abort_all()
                items.extend(it for it, _r in rep.inflight.values())
                rep.inflight.clear()
                items.extend(rep.drain_unfinished())
            for item in items:
                if not item.future.done():
                    item.future.set_exception(JobAbortedError(str(e)))

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._poll_watchdog()
            worked = self._sweep_dead()
            if not self._alive():
                # no survivor can ever take these — fail fast rather
                # than letting clients ride out the full deadline
                stranded = []
                with self._lock:
                    stranded.extend(self._pending)
                    self._pending.clear()
                for item in stranded:
                    if not item.future.done():
                        item.future.set_exception(RuntimeError(
                            "no live replicas left in the fleet"))
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    item = self._pending[0]
                if item.future.done():       # resolved while re-queued
                    with self._lock:
                        if self._pending and self._pending[0] is item:
                            self._pending.popleft()
                    continue
                rep = self._place(item)
                if rep is None:
                    break                    # no headroom/survivor yet
                with self._lock:
                    if not self._pending or self._pending[0] is not item:
                        continue
                    self._pending.popleft()
                if item.session is not None:
                    self._sessions[item.session] = rep.replica_id
                rep.inbox.put(item)
                worked = True
            if not worked:
                time.sleep(_IDLE_WAIT_S)
        # teardown: replicas were stopped by close(); fail what's left
        leftovers = []
        with self._lock:
            leftovers.extend(self._pending)
            self._pending.clear()
        for rep in self.replicas.values():
            leftovers.extend(it for it, _r in rep.inflight.values())
            leftovers.extend(rep.drain_unfinished())
        for item in leftovers:
            if not item.future.done():
                item.future.set_exception(
                    RuntimeError("router closed mid-request"))
