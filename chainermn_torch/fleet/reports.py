"""FleetReport — honest cross-replica aggregation + fleet counters.

Counterpart of ``chainermn_tpu/fleet/reports.py``.

Aggregating per-replica ``ServingReport`` summaries the lazy way is
WRONG in two specific, quantifiable ways:

* **percentiles do not average.** The mean of per-replica p99s is not
  the fleet p99 — a single slow replica's tail disappears into the
  average. ``merge`` therefore pools the RAW samples (``ServingReport.
  raw()``) and takes nearest-rank percentiles over the pooled list, so
  every token gap and TTFT sample carries exactly its own weight.
* **ratios do not average.** ``host_bytes_per_token`` is a quotient;
  the mean of per-replica quotients weights a replica that served 10
  tokens the same as one that served 10k. ``merge`` computes
  ``sum(host_bytes) / sum(tokens_emitted)`` — token-weighted by
  construction — and the pooled ``itl_ms`` distribution is likewise
  token-weighted because each gap sample IS one token.

The fleet-level counters (admission rejections, re-queues after a
replica death, handoffs by wire format and their exact wire bytes,
handoff fallbacks) live here because no single engine can see them —
they are properties of the routing layer. ``summary()`` emits the JSON
block ``tools/fleet_lm.py`` and the ``bench.py`` fleet gate read.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

from chainermn_torch.serving.reports import ServingReport, percentile

__all__ = ["FleetReport"]


def _dist_ms(samples: List[float]) -> Dict[str, float]:
    out = {f"p{q}": percentile(samples, q) * 1e3
           for q in ServingReport.PERCENTILES}
    out["mean"] = (sum(samples) / len(samples) * 1e3 if samples
                   else float("nan"))
    out["n"] = len(samples)
    return out


class FleetReport:
    """Routing-layer counters + pooled-sample replica aggregation."""

    def __init__(self):
        self.rejected = 0             # AdmissionRejected at the router
        self.requeued = 0             # requests moved off a dead replica
        self.replicas_dead = 0
        self.replicas_drained = 0     # Router.drain decommissions
        self.handoffs = 0
        self.handoff_fallbacks = 0    # HandoffError → clean re-prefill
        self.handoff_wire_bytes: Dict[str, int] = {}   # wire_format → B
        self.migrations = 0           # decode sessions adopted by a peer
        self.migration_fallbacks = 0  # migrate failed → replay from seed
        self.migration_wire_bytes: Dict[str, int] = {}  # wire_format → B
        # transport wire health (socket plane + streamed chunks)
        self.transport_retransmits = 0   # delivery attempts beyond 1st
        self.transport_reconnects = 0    # socket-plane redials
        self.transport_dup_fenced = 0    # frames answered `duplicate`
        self.streamed_chunk_nacks = 0    # format-5 chunk-only re-sends
        # rolling weight updates (fleet/rollout.py)
        self.rollouts_completed = 0      # fleet fully on the new version
        self.rollouts_rolled_back = 0    # failed mid-walk → back to v1
        self.canary_failures = 0         # canary miscompare → abort
        self.rollout_wire_bytes = 0      # relay bytes shipped (all hops)
        # speculative decoding (serving/speculative.py) — fleet-level
        # tallies a host folds out of its engines' ServingReports so
        # acceptance travels with the routing counters
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        self.spec_dispatches = 0
        self.spec_tokens_emitted = 0

    # ----------------------------------------------------------------
    # router / pool hooks
    # ----------------------------------------------------------------

    def record_rejected(self) -> None:
        self.rejected += 1

    def record_requeue(self, n: int = 1) -> None:
        self.requeued += int(n)

    def record_replica_dead(self) -> None:
        self.replicas_dead += 1

    def record_handoff(self, wire_format: str, nbytes: int) -> None:
        self.handoffs += 1
        self.handoff_wire_bytes[wire_format] = (
            self.handoff_wire_bytes.get(wire_format, 0) + int(nbytes))

    def record_fallback(self) -> None:
        self.handoff_fallbacks += 1

    def record_drained(self) -> None:
        self.replicas_drained += 1

    def record_migration(self, wire_format: str, nbytes: int) -> None:
        """One decode session adopted by a peer; ``nbytes`` is the
        exact encoded blob length that crossed the wire."""
        self.migrations += 1
        self.migration_wire_bytes[wire_format] = (
            self.migration_wire_bytes.get(wire_format, 0) + int(nbytes))

    def record_migration_fallback(self) -> None:
        """A migration that could not complete (transport budget, no
        free destination slot, undecodable frame) — the session fell
        back to the replay-from-seed path."""
        self.migration_fallbacks += 1

    def record_rollout_completed(self) -> None:
        """Every replica serves the new version (rollout SUCCEEDED)."""
        self.rollouts_completed += 1

    def record_rollout_rolled_back(self) -> None:
        """A rollout failed mid-walk (persistent relay corruption, a
        mid-swap death, ...) and every already-swapped replica walked
        back to v1 through the same drain path."""
        self.rollouts_rolled_back += 1

    def record_canary_failure(self) -> None:
        """The canary's bitwise prompt replay miscompared against the
        v2 oracle — the rollout aborted with zero traffic moved."""
        self.canary_failures += 1

    def record_rollout_wire(self, nbytes: int) -> None:
        """Relay bytes shipped for a rollout (chunk payloads, every
        hop) — the bench gate prices publisher egress against this."""
        self.rollout_wire_bytes += int(nbytes)

    def record_transport(self, sender_stats: dict = (),
                         receiver_stats: dict = (),
                         plane_stats: dict = ()) -> None:
        """Fold one transport's lifetime counters into the fleet
        tallies: retransmits (attempts beyond each frame's first),
        reconnects (socket plane redials), duplicate-fenced frames,
        and streamed-chunk NACKs. Call once per transport at the end
        of its run (the stats are lifetime totals, not deltas)."""
        s = dict(sender_stats or {})
        r = dict(receiver_stats or {})
        p = dict(plane_stats or {})
        self.transport_retransmits += max(
            0, int(s.get("attempts", 0)) - int(s.get("sent", 0)))
        self.transport_reconnects += int(p.get("reconnects", 0))
        self.transport_dup_fenced += int(r.get("duplicates", 0))
        self.streamed_chunk_nacks += int(r.get("chunk_nacked", 0))

    def record_spec(self, proposed: int, accepted: int,
                    emitted: int, dispatches: int = 1) -> None:
        """Fold a replica's speculative-round tallies into the fleet
        counters (a host typically calls this once per engine with the
        ``ServingReport`` totals, ``dispatches=spec_dispatches``)."""
        self.draft_tokens_proposed += int(proposed)
        self.draft_tokens_accepted += int(accepted)
        self.spec_dispatches += int(dispatches)
        self.spec_tokens_emitted += int(emitted)

    # ----------------------------------------------------------------
    # wire serialization (cross-process fleet merge)
    # ----------------------------------------------------------------

    #: bump on any change to the counter schema below
    #: (2: migration/drain counters — session migration;
    #:  3: transport wire-health counters — socket plane;
    #:  4: rolling-update counters — versioned rollout;
    #:  5: speculative-decoding counters — draft/verify rounds)
    WIRE_VERSION = 5

    def to_wire(self) -> dict:
        """Version-tagged JSON-safe envelope of the fleet counters —
        a cross-process host ships this home next to its
        ``ServingReport.to_wire()`` blocks; the merging side rebuilds
        with :meth:`from_wire` and folds hosts together with
        :meth:`absorb`. Round-trip is exact (ints only)."""
        return {"version": self.WIRE_VERSION, "kind": "fleet_report",
                "counters": {
                    "rejected": self.rejected,
                    "requeued": self.requeued,
                    "replicas_dead": self.replicas_dead,
                    "replicas_drained": self.replicas_drained,
                    "handoffs": self.handoffs,
                    "handoff_fallbacks": self.handoff_fallbacks,
                    "handoff_wire_bytes": dict(self.handoff_wire_bytes),
                    "migrations": self.migrations,
                    "migration_fallbacks": self.migration_fallbacks,
                    "migration_wire_bytes": dict(
                        self.migration_wire_bytes),
                    "transport_retransmits": self.transport_retransmits,
                    "transport_reconnects": self.transport_reconnects,
                    "transport_dup_fenced": self.transport_dup_fenced,
                    "streamed_chunk_nacks": self.streamed_chunk_nacks,
                    "rollouts_completed": self.rollouts_completed,
                    "rollouts_rolled_back": self.rollouts_rolled_back,
                    "canary_failures": self.canary_failures,
                    "rollout_wire_bytes": self.rollout_wire_bytes,
                    "draft_tokens_proposed": self.draft_tokens_proposed,
                    "draft_tokens_accepted": self.draft_tokens_accepted,
                    "spec_dispatches": self.spec_dispatches,
                    "spec_tokens_emitted": self.spec_tokens_emitted,
                }}

    @classmethod
    def from_wire(cls, wire: dict) -> "FleetReport":
        if not isinstance(wire, dict) or wire.get("kind") != "fleet_report":
            raise ValueError(
                f"not a fleet_report envelope: {type(wire).__name__}")
        if wire.get("version") != cls.WIRE_VERSION:
            raise ValueError(
                f"fleet_report wire version {wire.get('version')!r} "
                f"!= {cls.WIRE_VERSION} (mixed-version fleet?)")
        c = wire["counters"]
        out = cls()
        out.rejected = int(c["rejected"])
        out.requeued = int(c["requeued"])
        out.replicas_dead = int(c["replicas_dead"])
        out.replicas_drained = int(c["replicas_drained"])
        out.handoffs = int(c["handoffs"])
        out.handoff_fallbacks = int(c["handoff_fallbacks"])
        out.handoff_wire_bytes = {str(k): int(v) for k, v
                                  in c["handoff_wire_bytes"].items()}
        out.migrations = int(c["migrations"])
        out.migration_fallbacks = int(c["migration_fallbacks"])
        out.migration_wire_bytes = {str(k): int(v) for k, v
                                    in c["migration_wire_bytes"].items()}
        out.transport_retransmits = int(c["transport_retransmits"])
        out.transport_reconnects = int(c["transport_reconnects"])
        out.transport_dup_fenced = int(c["transport_dup_fenced"])
        out.streamed_chunk_nacks = int(c["streamed_chunk_nacks"])
        out.rollouts_completed = int(c["rollouts_completed"])
        out.rollouts_rolled_back = int(c["rollouts_rolled_back"])
        out.canary_failures = int(c["canary_failures"])
        out.rollout_wire_bytes = int(c["rollout_wire_bytes"])
        out.draft_tokens_proposed = int(c["draft_tokens_proposed"])
        out.draft_tokens_accepted = int(c["draft_tokens_accepted"])
        out.spec_dispatches = int(c["spec_dispatches"])
        out.spec_tokens_emitted = int(c["spec_tokens_emitted"])
        return out

    def absorb(self, other: "FleetReport") -> None:
        """Fold another host's counters into this report (merge of the
        routing-layer tallies; the sample-level merge stays in
        :meth:`merge`, fed by each host's serving reports)."""
        self.rejected += other.rejected
        self.requeued += other.requeued
        self.replicas_dead += other.replicas_dead
        self.replicas_drained += other.replicas_drained
        self.handoffs += other.handoffs
        self.handoff_fallbacks += other.handoff_fallbacks
        for fmt, nbytes in other.handoff_wire_bytes.items():
            self.handoff_wire_bytes[fmt] = (
                self.handoff_wire_bytes.get(fmt, 0) + int(nbytes))
        self.migrations += other.migrations
        self.migration_fallbacks += other.migration_fallbacks
        for fmt, nbytes in other.migration_wire_bytes.items():
            self.migration_wire_bytes[fmt] = (
                self.migration_wire_bytes.get(fmt, 0) + int(nbytes))
        self.transport_retransmits += other.transport_retransmits
        self.transport_reconnects += other.transport_reconnects
        self.transport_dup_fenced += other.transport_dup_fenced
        self.streamed_chunk_nacks += other.streamed_chunk_nacks
        self.rollouts_completed += other.rollouts_completed
        self.rollouts_rolled_back += other.rollouts_rolled_back
        self.canary_failures += other.canary_failures
        self.rollout_wire_bytes += other.rollout_wire_bytes
        self.draft_tokens_proposed += other.draft_tokens_proposed
        self.draft_tokens_accepted += other.draft_tokens_accepted
        self.spec_dispatches += other.spec_dispatches
        self.spec_tokens_emitted += other.spec_tokens_emitted

    # ----------------------------------------------------------------
    # aggregation
    # ----------------------------------------------------------------

    @staticmethod
    def merge(reports: Iterable[ServingReport]) -> dict:
        """Fold N replicas' raw telemetry into one fleet summary.

        Pools raw samples for every distribution (so percentiles are
        exact over the fleet, not averaged-of-averages) and computes
        ratio metrics from summed numerators/denominators (so
        ``host_bytes_per_token`` and ``itl_ms`` are weighted by actual
        token counts). The fleet wall span is the max replica span —
        replicas run concurrently, so spans overlap rather than add."""
        raws = [r.raw() for r in reports]
        ttft: List[float] = []
        gaps: List[float] = []
        qd: List[int] = []
        occ: List[float] = []
        submitted = completed = aborted = tokens = host_bytes = 0
        proposed = accepted = dispatches = spec_tokens = 0
        span = 0.0
        for raw in raws:
            ttft.extend(raw["ttft_s"])
            gaps.extend(raw["token_gap_s"])
            qd.extend(raw["queue_depth_samples"])
            occ.extend(raw["occupancy_samples"])
            submitted += raw["submitted"]
            completed += raw["completed"]
            aborted += raw["aborted"]
            tokens += raw["tokens_emitted"]
            host_bytes += raw["host_bytes"]
            # speculative ratios, like host_bytes_per_token, only merge
            # honestly from summed numerators/denominators
            proposed += raw.get("draft_tokens_proposed", 0)
            accepted += raw.get("draft_tokens_accepted", 0)
            dispatches += raw.get("spec_dispatches", 0)
            spec_tokens += raw.get("spec_tokens_emitted", 0)
            span = max(span, raw["wall_s"])
        return {
            "replicas": len(raws),
            "requests": {"submitted": submitted, "completed": completed,
                         "aborted": aborted},
            "tokens_emitted": tokens,
            "tokens_per_s": tokens / span if span > 0 else float("nan"),
            "host_bytes_per_token": (host_bytes / tokens if tokens
                                     else float("nan")),
            "acceptance_rate": (accepted / proposed if proposed
                                else float("nan")),
            "tokens_per_dispatch": (spec_tokens / dispatches if dispatches
                                    else float("nan")),
            "draft_tokens_proposed": proposed,
            "draft_tokens_accepted": accepted,
            "ttft_ms": _dist_ms(ttft),
            "itl_ms": _dist_ms(gaps),
            "queue_depth": {"mean": (sum(qd) / len(qd) if qd
                                     else float("nan")),
                            "max": max(qd) if qd else 0},
            "slot_occupancy": {"mean": (sum(occ) / len(occ) if occ
                                        else float("nan")),
                               "max": max(occ) if occ else 0.0},
            "wall_s": span,
        }

    def summary(self, reports: Iterable[ServingReport] = ()) -> dict:
        out = self.merge(reports)
        out["fleet"] = {
            "rejected": self.rejected,
            "requeued": self.requeued,
            "replicas_dead": self.replicas_dead,
            "replicas_drained": self.replicas_drained,
            "handoffs": self.handoffs,
            "handoff_fallbacks": self.handoff_fallbacks,
            "handoff_wire_bytes": dict(self.handoff_wire_bytes),
            "migrations": self.migrations,
            "migration_fallbacks": self.migration_fallbacks,
            "migration_wire_bytes": dict(self.migration_wire_bytes),
            "transport": {
                "retransmits": self.transport_retransmits,
                "reconnects": self.transport_reconnects,
                "dup_fenced": self.transport_dup_fenced,
                "chunk_nacks": self.streamed_chunk_nacks,
            },
            "rollouts": {
                "completed": self.rollouts_completed,
                "rolled_back": self.rollouts_rolled_back,
                "canary_failures": self.canary_failures,
                "wire_bytes": self.rollout_wire_bytes,
            },
            "speculative": {
                "draft_tokens_proposed": self.draft_tokens_proposed,
                "draft_tokens_accepted": self.draft_tokens_accepted,
                "spec_dispatches": self.spec_dispatches,
                "spec_tokens_emitted": self.spec_tokens_emitted,
                "acceptance_rate": (
                    self.draft_tokens_accepted
                    / self.draft_tokens_proposed
                    if self.draft_tokens_proposed else float("nan")),
                "tokens_per_dispatch": (
                    self.spec_tokens_emitted / self.spec_dispatches
                    if self.spec_dispatches else float("nan")),
            },
        }
        return out

    def json(self, reports: Iterable[ServingReport] = ()) -> str:
        return json.dumps(self.summary(reports), sort_keys=True)
