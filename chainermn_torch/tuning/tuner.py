"""schedtune: the overlap-driven collective-schedule search.

Counterpart of ``chainermn_tpu/tuning/tuner.py``. For each candidate
knob setting — ``bucket_bytes``, bucket emission order,
``double_buffering``, reducer strategy, or a synthesized program — a
caller-supplied ``compile_fn`` gives the schedule's evidence, and the
per-tier :class:`~chainermn_torch.tuning.topology.Topology` cost model
prices the collectives. The evidence is either scheduled HLO text (the
:mod:`.canned` emulator; the DL201 overlap fraction and the DL203
permute verdict of :mod:`.hlo` score it) or a measured
:class:`TraceEvidence` (``schedtune --trace``: the share of NCCL kernel
time that ran beside compute kernels in a ``torch.profiler`` trace, and
the NCCL time itself, which replaces the modeled communication time).
The objective is the EXPOSED communication time::

    score = comm_us · (1 − overlap_fraction) + ε · n_buckets

— collectives hidden behind backward compute are free; the ε·buckets
term is a deterministic tie-break toward fewer launches (the flat-first
instinct of ``AutoReducer.choose``). DL203 failures (a pipeline hop
serializing) add the full comm cost as a penalty. On canned HLO there is
no wall clock and no RNG: the same fixtures always produce the same
schedule, which is what makes the winner storable in the profile DB.

The search is small and exhaustive by design (dozens of candidates,
each canned one scored in microseconds) — TACCL-style synthesis over an
explicit topology beats hand-tuned constants without needing a solver.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Callable, Dict, List, Optional, Sequence

from chainermn_torch.tuning.profile_db import SchedulePlan
from chainermn_torch.tuning.topology import Topology

# NOTE: chainermn_torch.synthesis is imported lazily inside the functions
# that need it: importing it at module level closes an import cycle
# (synthesis/__init__ pulls the compiler, which pulls collectives,
# which registers the 'synth' strategy).

#: default bucket_bytes sweep (1/4/16/64 MiB: brackets the 4 MiB
#: DEFAULT_DCN_BUCKET_BYTES from both sides, plus the one-bucket regime)
DEFAULT_BUCKET_SWEEP = (1 << 20, 4 << 20, 16 << 20, 64 << 20)
#: the untuned reference configuration (the reducers' default bucket)
DEFAULT_BUCKET_BYTES = 4 << 20
#: tie-break weight: microseconds charged per collective launch beyond
#: the modeled latency, purely to make equal-exposure choices stable
LAUNCH_EPSILON_US = 1e-3


#: wire formats the lossy sweep tries for the quantized strategy —
#: plain 'int8' is omitted (blockwise strictly dominates it: same wire
#: width, per-256-element scales)
QUANT_WIRE_SWEEP = ("bf16", "int8-block", "int4-block")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the search space — a knob setting, or (strategy
    ``'synth'``) a whole synthesized program."""

    strategy: str = "flat"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    bucket_order: str = "emission"
    double_buffering: bool = False
    #: quantized-wire format; 'f32' (the non-compressing strategies'
    #: only wire) is priced as bf16 when the strategy is 'quantized'.
    #: For 'synth' this mirrors the program's own wire (informational)
    wire_format: str = "f32"
    #: a :class:`chainermn_torch.synthesis.Program` when strategy is
    #: 'synth' (frozen, so the candidate stays hashable); None for the
    #: fixed-reducer strategies
    program: Any = None


def default_flat_candidate() -> Candidate:
    """What you get today with no tuning: flat psum, 4 MiB buckets,
    pytree-emission order, no staleness."""
    return Candidate()


def default_candidates(topology: Topology,
                       bucket_sweep: Sequence[int] = DEFAULT_BUCKET_SWEEP,
                       lossy: bool = False,
                       allow_stale: bool = False) -> List[Candidate]:
    """The standard grid. ``hierarchical``/``auto`` only enter when the
    topology has an outer tier to exploit; ``quantized`` needs the
    explicit ``lossy`` opt-in and ``double_buffering`` the explicit
    ``allow_stale`` opt-in (both change numerics — a tuner must not)."""
    strategies = ["flat"]
    if topology.inter > 1:
        strategies += ["hierarchical", "auto"]
    if lossy:
        strategies.append("quantized")
    out = []
    for strategy in strategies:
        wires = (QUANT_WIRE_SWEEP if strategy == "quantized"
                 else ("f32",))
        for wf in wires:
            for bb in bucket_sweep:
                for order in ("emission", "size"):
                    out.append(Candidate(strategy, int(bb), order,
                                         False, wf))
                    if allow_stale:
                        out.append(Candidate(strategy, int(bb), order,
                                             True, wf))
    if len(topology.tiers) > 1:
        # program candidates: every enumerator emission, swept over the
        # same buckets/orders (lazy import — see the module-level note)
        from chainermn_torch.synthesis.sketch import enumerate_programs
        for prog in enumerate_programs(topology, lossy=lossy):
            for bb in bucket_sweep:
                for order in ("emission", "size"):
                    out.append(Candidate("synth", int(bb), order, False,
                                         prog.wire_format, prog))
    return out


def _bucket_payloads(total_bytes: int, bucket_bytes: int) -> List[int]:
    k = max(1, math.ceil(total_bytes / bucket_bytes))
    per, rem = divmod(total_bytes, k)
    return [per + (1 if i < rem else 0) for i in range(k)]


def estimate_comm_us(topology: Topology, candidate: Candidate,
                     total_bytes: int,
                     measured: Optional[Dict] = None) -> float:
    """Per-tier cost-model price of the candidate's collectives (sum
    over buckets). ``auto`` prices each bucket at its best strategy.
    A ``measured`` table ({(strategy, bytes): us}, nearest size wins)
    overrides the model where it has data: the on-card sweep path."""

    def one(strategy: str, nbytes: int) -> float:
        if measured:
            pts = [(abs(sz - nbytes), us) for (s, sz), us
                   in measured.items() if s == strategy]
            if pts:
                return min(pts)[1]
        if strategy == "synth":
            from chainermn_torch.synthesis.sketch import program_cost_us
            return program_cost_us(candidate.program, topology, nbytes)
        if strategy == "quantized":
            wf = (candidate.wire_format
                  if candidate.wire_format != "f32" else "bf16")
            return topology.estimate_us(strategy, nbytes, wire_format=wf)
        return topology.estimate_us(strategy, nbytes)

    total = 0.0
    for nbytes in _bucket_payloads(total_bytes, candidate.bucket_bytes):
        if candidate.strategy == "auto":
            total += min(one("flat", nbytes), one("hierarchical", nbytes))
        else:
            total += one(candidate.strategy, nbytes)
    return total


def bucket_algorithms(topology: Topology, candidate: Candidate,
                      total_bytes: int,
                      measured: Optional[Dict] = None):
    """Per-bucket ``(algorithm, payload_bytes)`` assignment for the
    plan record (``auto`` resolves per bucket, like AutoReducer)."""
    out = []
    for nbytes in _bucket_payloads(total_bytes, candidate.bucket_bytes):
        algo = candidate.strategy
        if algo == "synth" and candidate.program is not None:
            algo = "synth:" + (candidate.program.name or "unnamed")
        if algo == "auto":
            flat = estimate_comm_us(
                topology, Candidate("flat", nbytes), nbytes, measured)
            hier = estimate_comm_us(
                topology, Candidate("hierarchical", nbytes), nbytes,
                measured)
            algo = "flat" if flat <= hier else "hierarchical"
        out.append((algo, int(nbytes)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TraceEvidence:
    """A candidate's schedule as a device trace measured it (the
    ``--trace`` source): ``overlap_fraction`` is the share of NCCL kernel
    time that ran concurrently with compute kernels, ``comm_us`` the NCCL
    kernel time of one step (microseconds). ``samples``: the NCCL time a
    step of each repeated measurement, when there were several;
    ``comm_us`` is then their median, and the score's spread (their
    interquartile range) decides which candidates tie (:func:`tune`)."""

    overlap_fraction: float
    comm_us: float
    samples: tuple = ()


def score_candidate(topology: Topology, candidate: Candidate,
                    hlo_text, total_bytes: int,
                    measured: Optional[Dict] = None) -> dict:
    """Score one candidate's evidence (lower is better): scheduled HLO
    text, or a :class:`TraceEvidence` whose measured NCCL time replaces
    the modeled one."""
    from chainermn_torch.tuning.hlo import (check_pipeline_permute_overlap,
                                            dp_overlap_fraction)

    n_buckets = max(1, math.ceil(total_bytes / candidate.bucket_bytes))
    if isinstance(hlo_text, TraceEvidence):
        frac, d203 = hlo_text.overlap_fraction, {}
        comm_us = hlo_text.comm_us
    else:
        frac = dp_overlap_fraction(hlo_text)
        d203 = check_pipeline_permute_overlap(hlo_text)
        comm_us = estimate_comm_us(topology, candidate, total_bytes,
                                   measured)
    exposed_us = comm_us * (1.0 - frac)
    permute_penalty_us = (
        comm_us if (d203.get("n_permute_pairs") or d203.get(
            "sync_permutes")) and not d203.get("ok") else 0.0)
    fixed = permute_penalty_us + LAUNCH_EPSILON_US * n_buckets
    row = {
        "candidate": dataclasses.asdict(candidate),
        "overlap_fraction": round(frac, 6),
        "comm_us": round(comm_us, 3),
        "exposed_us": round(exposed_us, 3),
        "permute_penalty_us": round(permute_penalty_us, 3),
        "n_buckets": n_buckets,
        "score": exposed_us + fixed,
    }
    samples = getattr(hlo_text, "samples", ())
    if len(samples) > 1:
        # the interquartile range: one stray sample moves neither end
        q1, _, q3 = statistics.quantiles(samples, n=4, method="inclusive")
        row["samples_us"] = [round(x, 3) for x in samples]
        row["score_spread"] = [q1 * (1.0 - frac) + fixed,
                               q3 * (1.0 - frac) + fixed]
    return row


def _pick(topology: Topology, scored, total_bytes: int,
          measured: Optional[Dict]):
    """The winner of ``scored`` (``(score, index, candidate, row)``) and
    the leader's tie set. The leader is the least ``(score, index)``;
    without spreads it wins and the tie set is None. With spreads
    (``score_spread``) the candidates whose spread overlaps the leader's
    tie with it, and the first of them in the canned search's ranking
    (its ``(score, index)``) wins. Every row gets its ``tie_set``: the
    indices, among the scored rows, of the rows whose spread overlaps
    its own."""
    lead = min(scored, key=lambda t: (t[0], t[1]))
    if not all("score_spread" in t[3] for t in scored):
        return lead, None
    spreads = [t[3]["score_spread"] for t in scored]
    for (_, _, _, row), (lo, hi) in zip(scored, spreads):
        row["tie_set"] = [j for j, (lo_j, hi_j) in enumerate(spreads)
                          if lo_j <= hi and lo <= hi_j]
    tie_set = lead[3]["tie_set"]
    from chainermn_torch.tuning.canned import canned_compile_fn

    canned = canned_compile_fn(total_bytes)
    best = min((scored[j] for j in tie_set), key=lambda t: (
        score_candidate(topology, t[2], canned(t[2]), total_bytes,
                        measured)["score"], t[1]))
    return best, tie_set


@dataclasses.dataclass
class TuningResult:
    """The winner plus the full evidence table."""

    plan: SchedulePlan
    rows: List[dict]
    default: dict  # the untuned flat configuration's score row
    #: measured spreads only: the indices, among ``rows``, of the
    #: candidates that tie with the least median
    tie_set: Optional[List[int]] = None

    @property
    def decided(self) -> bool:
        """False when the least median ties with every candidate: the
        measurement ordered none of them, and the plan is the canned
        search's pick (its ``source`` says ``canned``)."""
        return self.tie_set is None or len(self.tie_set) < len(self.rows)

    @property
    def improves_overlap(self) -> bool:
        """Strictly higher DL201 overlap fraction than untuned flat —
        the acceptance bar for recording a plan as a win."""
        return (self.plan.overlap_fraction
                > self.default["overlap_fraction"])


def tune(topology: Topology, total_bytes: int,
         compile_fn: Callable[[Candidate], Optional[str]],
         candidates: Optional[Sequence[Candidate]] = None,
         model_key: str = "default",
         measured: Optional[Dict] = None,
         lossy: bool = False,
         allow_stale: bool = False,
         source: str = "canned") -> TuningResult:
    """Run the search: compile + score every candidate, pick the
    minimum (score, declaration order) — deterministic on canned HLO.
    Evidence measured several times (:class:`TraceEvidence` ``samples``)
    orders a candidate before the least median only where their spreads
    (interquartile ranges) do not overlap: the candidates whose spread
    overlaps the leader's tie with it and go by the canned search's
    ranking, so the choice does not follow the noise inside the spreads.
    When every candidate ties, the plan is the canned pick and its
    ``source`` is ``"canned"``.

    ``compile_fn(candidate)`` returns scheduled-HLO text or a
    :class:`TraceEvidence`, or ``None`` to skip a candidate the builder
    can't express. The untuned default
    flat configuration is always scored too (appended if absent) so
    every :class:`TuningResult` carries the tuned-vs-default delta.
    """
    cands = list(candidates if candidates is not None
                 else default_candidates(topology, lossy=lossy,
                                         allow_stale=allow_stale))
    base = default_flat_candidate()
    if base not in cands:
        cands.append(base)
    rows, scored = [], []
    for idx, cand in enumerate(cands):
        hlo = compile_fn(cand)
        if hlo is None:
            continue
        row = score_candidate(topology, cand, hlo, total_bytes, measured)
        rows.append(row)
        scored.append((row["score"], idx, cand, row))
    if not scored:
        raise ValueError("no candidate compiled — nothing to tune")
    (_, _, best, best_row), tie_set = _pick(topology, scored,
                                            total_bytes, measured)
    if tie_set is not None and len(tie_set) == len(scored):
        source = "canned"
    default_row = next(r for r in rows
                       if r["candidate"] == dataclasses.asdict(base))
    plan = SchedulePlan(
        fingerprint=topology.fingerprint(),
        model_key=model_key,
        strategy=best.strategy,
        bucket_bytes=best.bucket_bytes,
        bucket_order=best.bucket_order,
        double_buffering=best.double_buffering,
        wire_format=best.wire_format,
        overlap_fraction=best_row["overlap_fraction"],
        est_exposed_us=round(best_row["score"], 3),
        source=source,
        buckets=bucket_algorithms(topology, best, total_bytes, measured),
        program=(best.program.to_dict()
                 if best.program is not None else None),
    )
    return TuningResult(plan=plan, rows=rows, default=default_row,
                        tie_set=tie_set)


def tune_canned(topology: Topology, total_bytes: int,
                **kwargs) -> TuningResult:
    """The device-free entry point: :func:`tune` over the canned
    scheduled-HLO emulator (:mod:`.canned`)."""
    from chainermn_torch.tuning.canned import canned_compile_fn

    return tune(topology, total_bytes, canned_compile_fn(total_bytes),
                **kwargs)
