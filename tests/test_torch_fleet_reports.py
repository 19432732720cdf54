"""FleetReport aggregation: percentiles come from POOLED raw samples
(a mean of per-replica p99s hides the slow replica's tail) and ratio
metrics are weighted by actual token counts (a mean of per-replica
quotients weights a 10-token replica like a 10k-token one).

The port's copy of ``tests/fleet_tests/test_reports.py``:
the same drills, run against ``chainermn_torch``'s modules and the
port's fake engine.
"""

import json

import numpy as np
import pytest

from chainermn_torch.fleet import FleetReport
from chainermn_torch.serving.reports import ServingReport, percentile


def _report(gaps_s, tokens, host_bytes, span_s, ttft_s=()):
    """Hand-build a ServingReport with controlled raw telemetry."""
    clock = [0.0]
    r = ServingReport(time_fn=lambda: clock[0])
    r.record_submit(0)
    clock[0] = span_s
    r.record_token(0)                  # pins _t_last == span_s
    r.tokens_emitted = 0               # reset the synthetic token
    r.ttft_s = list(ttft_s)
    r.token_gap_s = list(gaps_s)
    r.tokens_emitted = tokens
    r.host_bytes = host_bytes
    r.completed = 1
    return r


def test_raw_exposes_unreduced_samples():
    r = _report([0.01, 0.02], tokens=3, host_bytes=12, span_s=1.0,
                ttft_s=[0.5])
    raw = r.raw()
    assert raw["token_gap_s"] == [0.01, 0.02]
    assert raw["ttft_s"] == [0.5]
    assert raw["tokens_emitted"] == 3
    assert raw["host_bytes"] == 12
    assert raw["wall_s"] == 1.0
    raw["token_gap_s"].append(9.9)     # copies, not views
    assert r.token_gap_s == [0.01, 0.02]


def test_pooled_percentile_beats_averaged_of_averages():
    """The counterexample: replica A is uniformly fast, replica B is
    uniformly 100× slower but served only a few tokens. Averaging the
    two per-replica p90s reports a number that is NOT any fleet-level
    percentile; pooling the samples puts B's tail where it belongs."""
    fast = [0.001] * 90
    slow = [0.1] * 10
    ra = _report(fast, tokens=90, host_bytes=360, span_s=1.0)
    rb = _report(slow, tokens=10, host_bytes=40, span_s=1.0)
    merged = FleetReport.merge([ra, rb])

    pooled = fast + slow
    assert merged["itl_ms"]["n"] == len(pooled)
    for q in ServingReport.PERCENTILES:
        assert merged["itl_ms"][f"p{q}"] == percentile(pooled, q) * 1e3
    # the wrong aggregation, for contrast: mean of per-replica p90s
    wrong_p90 = (percentile(fast, 90) + percentile(slow, 90)) / 2 * 1e3
    assert merged["itl_ms"]["p90"] != wrong_p90
    # pooled p90 sits at the fast cohort's edge; the naive average
    # invents a latency in between that no request ever saw
    assert merged["itl_ms"]["p90"] == 1.0
    assert abs(wrong_p90 - 50.5) < 1e-9


def test_host_bytes_per_token_is_token_weighted():
    """4 B/token on the big replica, 8 B/token on a tiny one: the
    fleet number must sit near 4, not at the unweighted mean 6."""
    big = _report([0.001] * 10, tokens=1000, host_bytes=4000, span_s=2.0)
    tiny = _report([0.001] * 10, tokens=10, host_bytes=80, span_s=2.0)
    merged = FleetReport.merge([big, tiny])
    expect = (4000 + 80) / (1000 + 10)
    assert abs(merged["host_bytes_per_token"] - expect) < 1e-12
    assert merged["host_bytes_per_token"] < 4.1      # nowhere near 6


def test_wall_span_is_max_not_sum():
    """Replicas run CONCURRENTLY: fleet throughput divides by the
    longest span, not the sum (summing would halve reported tok/s for
    every replica you add)."""
    ra = _report([0.001], tokens=100, host_bytes=400, span_s=2.0)
    rb = _report([0.001], tokens=100, host_bytes=400, span_s=1.0)
    merged = FleetReport.merge([ra, rb])
    assert merged["wall_s"] == 2.0
    assert abs(merged["tokens_per_s"] - 200 / 2.0) < 1e-9


def test_counters_and_summary_shape():
    fr = FleetReport()
    fr.record_rejected()
    fr.record_requeue(3)
    fr.record_replica_dead()
    fr.record_handoff("f32", 1000)
    fr.record_handoff("int8-block", 260)
    fr.record_handoff("int8-block", 260)
    fr.record_fallback()
    fr.record_drained()
    fr.record_migration("f32", 800)
    fr.record_migration("f32", 800)
    fr.record_migration_fallback()
    fr.record_transport(sender_stats={"sent": 3, "attempts": 5},
                        receiver_stats={"duplicates": 2,
                                        "chunk_nacked": 1},
                        plane_stats={"reconnects": 4})
    fr.record_spec(8, 6, 7)
    fr.record_spec(4, 1, 2)
    ra = _report([0.001], tokens=5, host_bytes=20, span_s=1.0)
    out = fr.summary([ra])
    assert out["fleet"] == {
        "rejected": 1, "requeued": 3, "replicas_dead": 1,
        "replicas_drained": 1,
        "handoffs": 3, "handoff_fallbacks": 1,
        "handoff_wire_bytes": {"f32": 1000, "int8-block": 520},
        "migrations": 2, "migration_fallbacks": 1,
        "migration_wire_bytes": {"f32": 1600},
        "transport": {"retransmits": 2, "reconnects": 4,
                      "dup_fenced": 2, "chunk_nacks": 1},
        "rollouts": {"completed": 0, "rolled_back": 0,
                     "canary_failures": 0, "wire_bytes": 0},
        "speculative": {"draft_tokens_proposed": 12,
                        "draft_tokens_accepted": 7,
                        "spec_dispatches": 2,
                        "spec_tokens_emitted": 9,
                        "acceptance_rate": 7 / 12,
                        "tokens_per_dispatch": 4.5},
    }
    assert out["replicas"] == 1
    assert np.isfinite(out["tokens_per_s"])


def test_merge_of_nothing_is_well_formed():
    out = FleetReport.merge([])
    assert out["replicas"] == 0
    assert out["tokens_emitted"] == 0
    assert np.isnan(out["host_bytes_per_token"])
    assert np.isnan(out["itl_ms"]["p50"])


# ---------------------------------------------------------------------------
# wire serialization (cross-process fleet merge)
# ---------------------------------------------------------------------------


def test_serving_report_wire_round_trip_is_exact():
    r = _report([0.01, 0.0213718237], tokens=3, host_bytes=12,
                span_s=1.5, ttft_s=[0.5071])
    wire = json.loads(json.dumps(r.to_wire()))     # a real JSON hop
    back = ServingReport.from_wire(wire)
    assert back.raw() == r.raw()                   # bit-identical floats
    # a received report merges next to live ones
    merged = FleetReport.merge([r, back])
    assert merged["replicas"] == 2
    assert merged["tokens_emitted"] == 6


def test_serving_report_wire_rejects_skew():
    r = _report([0.01], tokens=1, host_bytes=4, span_s=1.0)
    wire = r.to_wire()
    with pytest.raises(ValueError, match="version"):
        ServingReport.from_wire(dict(wire, version=99))
    with pytest.raises(ValueError, match="envelope"):
        ServingReport.from_wire({"kind": "nonsense"})
    bad = json.loads(json.dumps(wire))
    del bad["raw"]["tokens_emitted"]
    with pytest.raises(ValueError, match="missing"):
        ServingReport.from_wire(bad)


def test_received_report_is_read_only_telemetry():
    r = _report([0.01], tokens=1, host_bytes=4, span_s=1.0)
    back = ServingReport.from_wire(r.to_wire())
    got = back.raw()
    got["ttft_s"].append(123.0)        # mutating a copy, not the report
    assert back.raw()["ttft_s"] == r.raw()["ttft_s"]
    assert not hasattr(back, "record_token")


def test_fleet_report_wire_round_trip_and_absorb():
    a = FleetReport()
    a.record_rejected()
    a.record_handoff("f32", 500)
    a.record_fallback()
    wire = json.loads(json.dumps(a.to_wire()))
    b = FleetReport.from_wire(wire)
    assert b.to_wire() == a.to_wire()
    host2 = FleetReport()
    host2.record_requeue(2)
    host2.record_handoff("f32", 100)
    host2.record_handoff("int8-block", 60)
    b.absorb(host2)
    assert b.rejected == 1 and b.requeued == 2
    assert b.handoffs == 3 and b.handoff_fallbacks == 1
    assert b.handoff_wire_bytes == {"f32": 600, "int8-block": 60}


def test_fleet_spec_counters_round_trip_and_absorb():
    a = FleetReport()
    a.record_spec(8, 6, 7)
    wire = json.loads(json.dumps(a.to_wire()))
    b = FleetReport.from_wire(wire)
    assert b.to_wire() == a.to_wire()
    host2 = FleetReport()
    host2.record_spec(4, 1, 2)
    b.absorb(host2)
    assert b.draft_tokens_proposed == 12
    assert b.draft_tokens_accepted == 7
    assert b.spec_dispatches == 2
    assert b.spec_tokens_emitted == 9


def test_merge_pools_spec_counters_from_replica_raws():
    """Acceptance rate must come from SUMMED proposals/accepts, not a
    mean of per-replica rates (a 1-round replica would weigh as much
    as a 1000-round one)."""
    ra = _report([0.001], tokens=5, host_bytes=20, span_s=1.0)
    ra.record_spec_round(4, 4, 5)
    rb = _report([0.001], tokens=5, host_bytes=20, span_s=1.0)
    rb.record_spec_round(4, 0, 1)
    rb.record_spec_round(4, 2, 3)
    merged = FleetReport.merge([ra, rb])
    assert merged["draft_tokens_proposed"] == 12
    assert merged["draft_tokens_accepted"] == 6
    assert merged["acceptance_rate"] == 0.5
    assert merged["tokens_per_dispatch"] == 3.0


def test_fleet_report_wire_rejects_skew():
    wire = FleetReport().to_wire()
    with pytest.raises(ValueError, match="version"):
        FleetReport.from_wire(dict(wire, version=0))
    with pytest.raises(ValueError, match="envelope"):
        FleetReport.from_wire([])
