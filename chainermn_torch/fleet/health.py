"""Per-replica health for the fleet router.

Counterpart of ``chainermn_tpu/fleet/health.py``.

The training fleet already has a liveness organ — the heartbeat
watchdog (``resilience/watchdog.py``) declares a PROCESS dead when its
beats stop. The router needs the same verdict per REPLICA: each
``EngineReplica`` worker beats once per scheduler iteration, and the
router's dispatch loop asks :class:`FleetHealth` who has gone silent
longer than the probe deadline (``RpcPolicy.probe_ms`` by default — the
same constant that slices ``Frontend.result`` waits, so "how long until
we notice" is one number fleet-wide).

A death verdict here is a ROUTING decision, not a teardown: the router
answers by re-queueing the dead replica's in-flight requests onto
survivors with their client futures intact (``router.Router.
_handle_dead``). Explicit ``mark_dead`` exists for deaths detected out
of band (a worker thread that raised, a chaos ``kill_replica``) — it
wins immediately instead of waiting out the silence deadline.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from chainermn_torch.resilience.policy import policy

__all__ = ["FleetHealth"]


class FleetHealth:
    """Deadline-based replica liveness (injectable clock for tests)."""

    def __init__(self, replica_ids, timeout_ms: Optional[int] = None,
                 time_fn=time.monotonic):
        self._time = time_fn
        self.timeout_ms = (timeout_ms if timeout_ms is not None
                           else policy().probe_ms)
        now = self._time()
        self._last_beat: Dict[int, float] = {int(r): now
                                             for r in replica_ids}
        self._dead: Dict[int, str] = {}

    def beat(self, replica: int) -> None:
        """One heartbeat — replica workers call this every iteration."""
        if replica not in self._dead:
            self._last_beat[replica] = self._time()

    def mark_dead(self, replica: int, reason: str = "marked dead") -> None:
        """Out-of-band death (worker raised / chaos kill): immediate."""
        if replica in self._last_beat and replica not in self._dead:
            self._dead[replica] = reason

    def revive(self, replica: int, reason: str = "readmitted") -> None:
        """Readmit a decommissioned replica (the READMIT leg of a
        rolling weight update — ``Router.readmit``): the death verdict
        is withdrawn and the beat clock restarts NOW, so the deadline
        sweep gives the fresh worker a full ``timeout_ms`` before it can
        be declared dead again. Only a replica this tracker knows may
        come back; reviving a live one is a no-op."""
        if replica not in self._last_beat:
            raise ValueError(f"unknown replica {replica} ({reason})")
        self._last_beat[replica] = self._time()
        self._dead.pop(replica, None)

    def check(self) -> List[int]:
        """Deadline sweep: returns replicas NEWLY declared dead (silent
        past ``timeout_ms``). Idempotent per death — a replica is
        reported exactly once, then stays in ``dead``."""
        now = self._time()
        newly = []
        for r, t in self._last_beat.items():
            if r in self._dead:
                continue
            if (now - t) * 1e3 > self.timeout_ms:
                self._dead[r] = (
                    f"no heartbeat for {self.timeout_ms} ms")
                newly.append(r)
        return newly

    def alive(self) -> List[int]:
        return sorted(r for r in self._last_beat if r not in self._dead)

    def is_alive(self, replica: int) -> bool:
        return replica in self._last_beat and replica not in self._dead

    @property
    def dead(self) -> Dict[int, str]:
        """replica → reason, for every declared death so far."""
        return dict(self._dead)
