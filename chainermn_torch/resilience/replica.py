"""Ring replication of snapshot shards: a dead host's NEWEST state
survives on its neighbor.

Counterpart of ``chainermn_tpu/resilience/replica.py``. The consensus
election (``extensions/checkpoint.py``) can only elect an iteration
every rank still holds; when a rank dies AND its disk goes with it, the
election falls back to an older common iteration — or, if the window
slid, to nothing. After each checkpoint trigger, every rank pushes its
newest *verified* snapshot file (plus its SHA-256 manifest) to its ring
neighbor ``(rank+1) % world``, and persists the copy it receives from
``(rank-1) % world`` under
``<ckpt>/replicas/snapshot_iter_<N>.<source-rank>``. A port snapshot's
file index is the communicator's ``rank`` (one process per GPU), where
the JAX package's is ``inter_rank``.

The checkpointer already reads them: its election inventory counts
valid replicas of its own shard, the completeness check counts replicas
of ANY rank, restore falls back to the replica when the primary is
missing or corrupt, and the splice reads the replica directory. So a
rank whose files are gone restores its shard from its neighbor's copy
(shared filesystem), or shrink-to-fit (``resilience/elastic.py``)
splices the surviving primaries and replicas onto a smaller world.

The messages ride the communicator's store-backed object plane
(``comm/object_plane.py``): a put returns without waiting for the
receiver, so send-then-receive around the ring cannot deadlock (gloo's
``send_obj`` would wait for its receive), and the receive is guarded (a
dead neighbor raises ``JobAbortedError`` once the abort key is posted).

Costs: one extra copy of each rank's shard crosses the store (rank 0's
process) per replication trigger and lands on the neighbor's disk; fire
it sparser than the checkpoint trigger when shards are large. The
exchange is collective (every rank sends one message and receives one,
even when it has nothing new), so attach it on ALL ranks with the SAME
trigger.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

from chainermn_torch.resilience import chaos as _chaos

#: object-plane p2p tag reserved for the replication ring (keeps its
#: sequence counters separate from other send_obj/recv_obj traffic)
REPLICA_TAG = 7


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        try:
            os.fsync(fh.fileno())
        except OSError:
            pass  # fsync unsupported (some tmpfs) — rename still atomic
    os.replace(tmp, path)


class PeerReplicator:
    """Trainer extension: ring-replicate the newest verified snapshot.

    ``trainer.extend(PeerReplicator(ck), trigger=...)`` AFTER extending
    the checkpointer ``ck`` itself (extensions fire in attach order, so
    the snapshot of the current iteration is published before the
    exchange). With one process the extension is a no-op.

    ``keep`` bounds the replicas retained per source rank (default: the
    checkpointer's ``cp_interval``); pruning never touches an iteration
    the checkpointer protects (the consensus winner / explicit pins).
    """

    def __init__(self, checkpointer, keep: Optional[int] = None):
        self.ck = checkpointer
        self.comm = checkpointer.comm
        self.keep = keep if keep is not None else checkpointer.cp_interval
        self._last_sent: Optional[int] = None

    # -- payload assembly ------------------------------------------------

    def _newest_verified_own(self) -> Optional[int]:
        """Newest iteration whose PRIMARY own file verifies (replicas of
        our shard are already copies — resending them is pure waste)."""
        for it in reversed(self.ck._iters_on_disk()):
            fn = os.path.join(
                self.ck.path,
                f"snapshot_iter_{it}.{self.comm.rank}")
            if not os.path.isdir(fn) and self.ck._verify_snapshot_file(fn):
                return it
        return None

    def _build_payload(self) -> Dict[str, Any]:
        it = self._newest_verified_own()
        if it is None or it == self._last_sent:
            # nothing new — the exchange still happens (peers' recv
            # counts must match sends), just with an empty payload
            return {"iteration": None}
        fn = os.path.join(
            self.ck.path, f"snapshot_iter_{it}.{self.comm.rank}")
        try:
            with open(fn, "rb") as fh:
                data = fh.read()
            manifest = None
            if os.path.exists(fn + ".json"):
                with open(fn + ".json", "rb") as fh:
                    manifest = fh.read()
        except OSError as e:
            warnings.warn(f"replica: could not read {fn} ({e}); "
                          "skipping this round")
            return {"iteration": None}
        self._last_sent = it
        return {"iteration": it, "rank": self.comm.rank,
                "data": data, "manifest": manifest}

    # -- receive side ----------------------------------------------------

    def _store(self, payload: Dict[str, Any]) -> Optional[str]:
        it = payload.get("iteration")
        if it is None:
            return None
        src = int(payload["rank"])
        dst = os.path.join(self.ck.replica_path,
                           f"snapshot_iter_{it}.{src}")
        try:
            os.makedirs(self.ck.replica_path, exist_ok=True)
            # same chaos injection point as the primary publish: a full
            # disk breaks the replica too (and the test can prove the
            # election still works off the primaries)
            _chaos.on_publish(dst)
            _atomic_write(dst, payload["data"])
            if payload.get("manifest") is not None:
                _atomic_write(dst + ".json", payload["manifest"])
        except OSError as e:
            # best-effort by design: losing a replica copy must never
            # kill the training step that triggered the exchange
            warnings.warn(f"replica: could not store {dst} ({e})")
            return None
        self._prune(src)
        return dst

    def _prune(self, src: int) -> None:
        """Bound the replicas held for ``src`` to the ``keep`` newest,
        never dropping an iteration the checkpointer protects."""
        import re

        pat = re.compile(rf"snapshot_iter_(\d+)\.{src}$")
        if not os.path.isdir(self.ck.replica_path):
            return
        its = sorted(
            int(m.group(1)) for f in os.listdir(self.ck.replica_path)
            if (m := pat.match(f)))
        protected = set(getattr(self.ck, "_protected", ()))
        elected = getattr(self.ck, "_elected", None)
        if elected is not None:
            protected.add(elected)
        for it in its[:-self.keep] if self.keep else its:
            if it in protected:
                continue
            fn = os.path.join(self.ck.replica_path,
                              f"snapshot_iter_{it}.{src}")
            for victim in (fn, fn + ".json"):
                try:
                    os.remove(victim)
                except OSError:
                    pass

    # -- trainer-extension protocol --------------------------------------

    def replicate(self, drain: bool = True) -> Optional[str]:
        """One ring exchange; returns the stored replica path (None when
        the neighbor had nothing new). Collective: every rank must call
        with the same cadence.

        ``drain=False`` skips the checkpointer-queue join — the async
        snapshot plane (``checkpointing/async_plane.py``) calls from its OWN
        writer thread right after publishing, where a drain would
        self-deadlock on the item being processed."""
        world = self.comm.size
        if world < 2:
            return None
        # published files only — an in-flight async write is invisible
        # and a FAILED one must not block the exchange (peers are
        # already waiting in recv)
        if drain:
            self.ck._drain()
        right = (self.comm.rank + 1) % world
        left = (self.comm.rank - 1) % world
        # store p2p: the put returns without waiting on the peer, so
        # send-then-recv around the ring cannot deadlock
        plane = self.comm.object_plane
        plane.send_obj(self._build_payload(), right, tag=REPLICA_TAG)
        payload = plane.recv_obj(left, tag=REPLICA_TAG)
        return self._store(payload)

    def __call__(self, trainer) -> None:  # noqa: ARG002 (protocol)
        self.replicate()
