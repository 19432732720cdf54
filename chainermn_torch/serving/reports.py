"""ServingReport — request-lifecycle telemetry of the serving engine.

A copy of ``chainermn_tpu/serving/reports.py``'s ``ServingReport`` (the
port imports nothing of the JAX package): admission → first token
(TTFT) → per-token cadence → retirement, plus queue depth and slot
occupancy, recorded as plain floats against an injectable clock
(``time_fn``), and the version-tagged wire envelope a cross-process
replica ships its telemetry home in.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

__all__ = ["ServingReport", "ReceivedServingReport", "percentile",
           "REPORT_WIRE_VERSION"]

#: version tag on every serialized report envelope — bump on any change
#: to the ``raw()`` schema so a mixed-version fleet fails loudly instead
#: of merging mis-shaped telemetry
#: (1 → 2: speculative-decoding counters — draft_tokens_proposed/
#: accepted, spec_dispatches, spec_tokens_emitted)
REPORT_WIRE_VERSION = 2


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy dependency at import time; the
    sample counts here never justify interpolation)."""
    if not samples:
        return float("nan")
    xs = sorted(samples)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


class ServingReport:
    """Aggregates one serving process's request/scheduler telemetry.

    Engine calls the ``record_*`` hooks; ``summary()`` is cheap enough
    to call per scrape. All latencies are reported in milliseconds,
    throughput in tokens/s over the observed wall span.
    """

    PERCENTILES = (50, 90, 95, 99)

    def __init__(self, time_fn=time.monotonic):
        self._time = time_fn
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.submitted = 0
        self.completed = 0
        self.aborted = 0
        self.tokens_emitted = 0
        self.host_bytes = 0           # device→host bytes on the emit path
        # speculative decoding (serving/speculative.py): per-slot round
        # counters — acceptance_rate and tokens_per_dispatch in summary()
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        self.spec_dispatches = 0      # one per (slot, round) pair
        self.spec_tokens_emitted = 0
        self.ttft_s: List[float] = []
        self.token_gap_s: List[float] = []
        self.queue_depth_samples: List[int] = []
        self.occupancy_samples: List[float] = []
        self._last_token_t: Dict[int, float] = {}
        self._submit_t: Dict[int, float] = {}

    # ----------------------------------------------------------------
    # engine hooks
    # ----------------------------------------------------------------

    def record_submit(self, request_id: int) -> None:
        now = self._time()
        if self._t0 is None:
            self._t0 = now
        self._t_last = now
        self.submitted += 1
        self._submit_t[request_id] = now

    def record_token(self, request_id: int) -> None:
        now = self._time()
        self._t_last = now
        self.tokens_emitted += 1
        prev = self._last_token_t.get(request_id)
        if prev is None:
            sub = self._submit_t.get(request_id)
            if sub is not None:
                self.ttft_s.append(now - sub)
        else:
            self.token_gap_s.append(now - prev)
        self._last_token_t[request_id] = now

    def record_retire(self, request_id: int, aborted: bool = False) -> None:
        self._t_last = self._time()
        if aborted:
            self.aborted += 1
        else:
            self.completed += 1
        self._last_token_t.pop(request_id, None)
        self._submit_t.pop(request_id, None)

    def record_step(self, queue_depth: int, occupancy: float) -> None:
        self.queue_depth_samples.append(int(queue_depth))
        self.occupancy_samples.append(float(occupancy))

    def record_host_bytes(self, nbytes: int) -> None:
        """Device→host transfer on the token-emit path (the engine calls
        this per dispatch with the pulled array's ``nbytes``). With
        on-device sampling this is integer token ids only, never
        ``[n_slots, vocab]`` logits."""
        self.host_bytes += int(nbytes)

    def record_spec_round(self, proposed: int, accepted: int,
                          emitted: int) -> None:
        """One speculative round for ONE slot (the engine calls this per
        live slot per propose+verify round): ``proposed`` draft tokens
        went into the verify chunk, ``accepted`` matched the target's
        own samples, and ``emitted`` tokens entered the stream
        (``accepted + 1`` normally — the round's last token is always
        target-sampled: correction, bonus, or terminal). The ratios an
        operator sizes the draft model by — ``acceptance_rate`` and
        ``tokens_per_dispatch`` — fold out of these in ``summary()``."""
        self.draft_tokens_proposed += int(proposed)
        self.draft_tokens_accepted += int(accepted)
        self.spec_dispatches += 1
        self.spec_tokens_emitted += int(emitted)

    # ----------------------------------------------------------------
    # output
    # ----------------------------------------------------------------

    def raw(self) -> dict:
        """The UNREDUCED telemetry: raw sample lists + counters + the
        observed wall span. This is the only honest input to cross-
        replica aggregation — ``fleet.FleetReport.merge`` pools these
        and takes percentiles over the pooled samples, because a mean of
        per-replica p99s is not a fleet p99 (and a mean of per-replica
        ``host_bytes_per_token`` ratios mis-weights unequal replicas)."""
        span = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        return {
            "ttft_s": list(self.ttft_s),
            "token_gap_s": list(self.token_gap_s),
            "queue_depth_samples": list(self.queue_depth_samples),
            "occupancy_samples": list(self.occupancy_samples),
            "submitted": self.submitted,
            "completed": self.completed,
            "aborted": self.aborted,
            "tokens_emitted": self.tokens_emitted,
            "host_bytes": self.host_bytes,
            "draft_tokens_proposed": self.draft_tokens_proposed,
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "spec_dispatches": self.spec_dispatches,
            "spec_tokens_emitted": self.spec_tokens_emitted,
            "wall_s": span,
        }

    def _dist_ms(self, samples: List[float]) -> Dict[str, float]:
        out = {f"p{q}": percentile(samples, q) * 1e3
               for q in self.PERCENTILES}
        out["mean"] = (sum(samples) / len(samples) * 1e3 if samples
                       else float("nan"))
        out["n"] = len(samples)
        return out

    def summary(self) -> dict:
        span = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        occ = self.occupancy_samples
        qd = self.queue_depth_samples
        return {
            "requests": {"submitted": self.submitted,
                         "completed": self.completed,
                         "aborted": self.aborted},
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_s": (self.tokens_emitted / span if span > 0
                             else float("nan")),
            "host_bytes_per_token": (self.host_bytes / self.tokens_emitted
                                     if self.tokens_emitted
                                     else float("nan")),
            # speculative decoding: fraction of draft proposals the
            # target's own samples confirmed, and how many tokens a
            # (slot, round) pair advances — > 1 is the whole point
            "acceptance_rate": (self.draft_tokens_accepted
                                / self.draft_tokens_proposed
                                if self.draft_tokens_proposed
                                else float("nan")),
            "tokens_per_dispatch": (self.spec_tokens_emitted
                                    / self.spec_dispatches
                                    if self.spec_dispatches
                                    else float("nan")),
            "draft_tokens_proposed": self.draft_tokens_proposed,
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "ttft_ms": self._dist_ms(self.ttft_s),
            # inter-token latency — the standard serving-benchmark name
            # for the same per-request token-gap distribution
            "itl_ms": self._dist_ms(self.token_gap_s),
            "token_latency_ms": self._dist_ms(self.token_gap_s),
            "queue_depth": {"mean": (sum(qd) / len(qd) if qd
                                     else float("nan")),
                            "max": max(qd) if qd else 0},
            "slot_occupancy": {"mean": (sum(occ) / len(occ) if occ
                                        else float("nan")),
                               "max": max(occ) if occ else 0.0},
            "wall_s": span,
        }

    def json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)

    # ----------------------------------------------------------------
    # wire serialization (cross-process fleet merge)
    # ----------------------------------------------------------------

    def to_wire(self) -> dict:
        """Version-tagged, JSON-safe envelope of :meth:`raw` — the form
        a cross-process replica ships its telemetry home in (fleet_lm
        ``--hosts`` report files). Everything in ``raw()`` is ints and
        floats, and Python's float repr round-trips exactly through
        ``json.dumps``/``loads``, so the pooled-percentile merge on the
        far side sees bit-identical samples."""
        return {"version": REPORT_WIRE_VERSION, "kind": "serving_report",
                "raw": self.raw()}

    @staticmethod
    def from_wire(wire: dict) -> "ReceivedServingReport":
        """Rehydrate a :meth:`to_wire` envelope (version-checked) into
        an object ``FleetReport.merge`` accepts alongside live ones."""
        if not isinstance(wire, dict) or wire.get("kind") != "serving_report":
            raise ValueError(
                f"not a serving_report envelope: {type(wire).__name__}")
        if wire.get("version") != REPORT_WIRE_VERSION:
            raise ValueError(
                f"serving_report wire version {wire.get('version')!r} "
                f"!= {REPORT_WIRE_VERSION} (mixed-version fleet?)")
        return ReceivedServingReport(wire["raw"])


class ReceivedServingReport:
    """A peer replica's telemetry, deserialized from the wire: exposes
    the same :meth:`raw` surface ``FleetReport.merge`` pools, nothing
    else (a received report cannot record new events)."""

    def __init__(self, raw: dict):
        missing = [k for k in ("ttft_s", "token_gap_s",
                               "queue_depth_samples", "occupancy_samples",
                               "submitted", "completed", "aborted",
                               "tokens_emitted", "host_bytes",
                               "draft_tokens_proposed",
                               "draft_tokens_accepted",
                               "spec_dispatches", "spec_tokens_emitted",
                               "wall_s")
                   if k not in raw]
        if missing:
            raise ValueError(
                f"serving_report raw block missing keys: {missing}")
        self._raw = {k: (list(v) if isinstance(v, list) else v)
                     for k, v in raw.items()}

    def raw(self) -> dict:
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in self._raw.items()}
