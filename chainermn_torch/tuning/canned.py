"""Canned scheduled-HLO generator: a deterministic emulation of XLA's
latency-hiding schedule for a bucketed data-parallel gradient reduction.

Counterpart of ``chainermn_tpu/tuning/canned.py``, emitting the same
text. The tuner scores candidates with the DL201/DL203 parsers
(:mod:`chainermn_torch.tuning.hlo`) over scheduled HLO text. The port
compiles no HLO, so this emulator is its canned source: structurally
honest scheduled HLO whose op sequence encodes the schedule consequences
of the knobs —

* **bucket count** ``k = ceil(total_bytes / bucket_bytes)``: the first
  all-reduce can only issue once its bucket's gradients exist, i.e.
  after ``~B/k`` of the ``B`` backward ops (fewer, larger buckets →
  the first collective issues later → less backward left to hide in);
  a single bucket issues after the LAST backward — fully serialized,
  the exact DL201 failure mode.
* **bucket order** ``'size'``: size-sorted emission fills the first
  bucket with the largest (earliest-completing, in the tail-heavy
  transformer/ResNet backward) leaves, issuing the first collective
  one backward op earlier than pytree-emission order.
* **double_buffering**: step t reduces step t-1's grads, so every
  all-reduce issues BEFORE the backward — overlap fraction 1.0 (with
  one-step-stale numerics; the tuner only proposes it when asked).

The emission positions are a model, not a compilation; the device-side
source is ``schedtune --trace``, which measures the overlap in a
``torch.profiler`` trace instead. Everything here is deterministic: same
knobs → same text → same score (no wall clock, no RNG).
"""

from __future__ import annotations

import math
import textwrap

#: backward ops in the emulated module — enough resolution that one
#: bucket of slack moves the overlap fraction by ~1.6%
DEFAULT_N_BACKWARD = 64


def canned_schedule_hlo(n_buckets: int, bucket_order: str = "emission",
                        double_buffering: bool = False,
                        n_backward: int = DEFAULT_N_BACKWARD,
                        staged: bool = False) -> str:
    """Scheduled-HLO text for ``n_buckets`` gradient all-reduces
    interleaved with ``n_backward`` backward fusions (see module doc
    for the placement model).

    ``staged`` models a reduce-scatter-first program (synthesized
    schedules with ``has_scatter``): the first wire step moves only a
    ``1/k``-rank shard instead of the whole bucket, so the scheduler
    can issue it one backward fusion earlier than a monolithic
    all-reduce — the latency floor drops from 3 to 2 emission-order
    ops (2 to 1 size-order)."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if bucket_order not in ("emission", "size"):
        raise ValueError(f"unknown bucket_order {bucket_order!r}")
    b, k = n_backward, min(n_buckets, n_backward)
    if double_buffering:
        ar_after = [0] * k  # prev-step grads: all issue before backward
    else:
        floor = 2 if staged else 3
        first = max(math.ceil(b / k), floor)
        if bucket_order == "size":
            first = max(first - 1, floor - 1)
        span = max(b - first, 0)
        ar_after = [min(first + (j * span) // k, b) for j in range(k)]

    lines = ["  %p0 = f32[1024]{0} parameter(0)"]
    emitted = 0

    def emit_ars(up_to):
        nonlocal emitted
        while emitted < k and ar_after[emitted] <= up_to:
            j = emitted
            src = f"%bwd{up_to - 1}" if up_to else "%p0"
            lines.append(
                f"  %ar{j} = f32[1024]{{0}} all-reduce-start({src}), "
                "replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%sum, "
                f"metadata={{op_name=\"jit(step)/psum(bucket{j})\"}}")
            emitted += 1

    emit_ars(0)
    for i in range(b):
        src = f"%bwd{i - 1}" if i else "%p0"
        lines.append(
            f"  %bwd{i} = f32[1024]{{0}} fusion({src}), kind=kLoop, "
            "metadata={op_name=\"jit(step)/transpose(jvp(loss))/"
            f"dot_general.{i}\"}}")
        emit_ars(i + 1)
    for j in range(k):
        lines.append(f"  %ard{j} = f32[1024]{{0}} all-reduce-done(%ar{j})")
    lines.append("  ROOT %out = f32[1024]{0} add(%bwd"
                 f"{b - 1}, %ard{k - 1})")
    body = "\n".join(lines)
    return textwrap.dedent("""\
        HloModule canned_step, is_scheduled=true

        %sum (a: f32[], b: f32[]) -> f32[] {
          %a = f32[] parameter(0)
          %b = f32[] parameter(1)
          ROOT %add = f32[] add(%a, %b)
        }

        ENTRY %main (p0: f32[1024]) -> f32[1024] {
        """) + body + "\n}\n"


def canned_compile_fn(total_bytes: int,
                      n_backward: int = DEFAULT_N_BACKWARD):
    """A ``compile_fn`` for :func:`chainermn_torch.tuning.tuner.tune`
    backed by the emulator: maps a candidate's knobs to scheduled-HLO
    text."""

    def compile_fn(candidate) -> str:
        k = max(1, math.ceil(total_bytes / candidate.bucket_bytes))
        program = getattr(candidate, "program", None)
        staged = bool(program is not None
                      and getattr(program, "has_scatter", False))
        return canned_schedule_hlo(k, candidate.bucket_order,
                                   candidate.double_buffering,
                                   n_backward, staged=staged)

    return compile_fn
