"""dlint trace passes: schedule checks on a ``torch.profiler`` trace.

Counterpart of ``chainermn_tpu/analysis/hlo_passes.py``. The JAX package
proves what XLA *scheduled* by reading compiled HLO; the port compiles
nothing, so its schedule is what the card *ran*: a Chrome trace that
``torch.profiler`` took with CUDA activity (``training/profiling.py``
``capture``/``Profile``, ``tools/profile_lm.py``). The passes read it
through the port's own readers (:func:`~chainermn_torch.training.
profiling.kernel_events`, ``backward_events``, ``nccl_overlap``,
``kernel_family``), imported inside each checker so that a lint of
sources never imports torch.

* ``DL201`` :func:`check_dp_overlap` — gradient collectives must run
  while backward compute remains: some kernel a backward function
  launched starts while a gradient reduction kernel (NCCL AllReduce or
  ReduceScatter) runs. (JAX's form — the first all-reduce scheduled
  before the last backward op — reads one step's schedule; a trace holds
  several steps, where one step's reduction always precedes the next
  step's backward.) Its score is :func:`~chainermn_torch.training.
  profiling.nccl_overlap`'s fraction, the number ``schedtune --trace``
  scores.
* ``DL202`` :func:`check_collective_budget` — NCCL collective kernels
  per step (the trace's ``ProfilerStep#`` spans, or the caller's count)
  must not exceed a budget: a bucketing regression multiplies the count
  long before it shows in step time.

DL203-DL205 are still to port (``core.NOT_YET_PORTED``).

Every checker returns a dict with at least ``{"rule", "ok", ...}``
evidence fields, in the shape of the JAX passes; ``ok=None`` with a
``skip`` key means the trace had nothing to check (one card runs no
NCCL kernel). A trace with no device event at all is ``ok=False``: it
was not taken on the card with CUDA activity, and a pass that reads
nothing must not pass.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Optional, Union

from chainermn_torch.analysis.core import Rule, register

_DOC = "docs/static_analysis_torch.md"

for _rid, _name in (("DL201", "dp-allreduce-overlap"),
                    ("DL202", "collective-budget")):
    register(Rule(_rid, _name, f"{_DOC}#{_rid.lower()}",
                  check=None, kind="trace"))

#: the collective in an NCCL kernel's name: ``ncclDevKernel_AllReduce_
#: Sum_f32_RING_LL`` and ``ncclKernel_AllReduce_RING_LL_Sum_float`` alike
_NCCL_KIND = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")

#: NCCL kernels that reduce gradients (DL201)
GRAD_REDUCTIONS = ("AllReduce", "ReduceScatter")


def nccl_kind(name: str) -> str:
    """The collective an NCCL kernel runs (``AllReduce``, ``SendRecv``,
    ...), or ``"other"``."""
    m = _NCCL_KIND.search(name)
    return m.group(1) if m else "other"


def _no_device_events(rule: str) -> dict:
    return {"rule": rule, "ok": False, "n_device_events": 0,
            "fix": ("the trace holds no device event: take it on the card "
                    "with CUDA activity (training.profiling.capture, "
                    f"Profile, profile_lm) ({_DOC}#{rule.lower()})")}


def check_dp_overlap(trace: Union[str, dict]) -> dict:
    """Does backward compute run while gradient reductions are in
    flight?"""
    from chainermn_torch.training.profiling import (backward_events,
                                                    kernel_events,
                                                    kernel_family,
                                                    nccl_overlap)

    events = kernel_events(trace)
    if not events:
        return _no_device_events("DL201")
    reduces = [e for e in events if kernel_family(e[0]) == "NCCL"
               and nccl_kind(e[0]) in GRAD_REDUCTIONS]
    backward = [e for e in backward_events(trace)
                if kernel_family(e[0]) != "NCCL"]
    out = {"rule": "DL201", "n_device_events": len(events),
           "n_allreduce": len(reduces), "n_backward": len(backward)}
    if not reduces:
        out.update(ok=None, skip="no NCCL gradient reduction in the "
                   "trace (one rank)")
        return out
    if not backward:
        out.update(ok=None, skip="no kernel launched by a backward "
                   "function in the trace")
        return out
    # the time some reduction is in flight, as disjoint intervals
    flight: list = []
    for a, b in sorted((s, s + d) for _, s, d in reduces):
        if flight and a <= flight[-1][1]:
            flight[-1][1] = max(flight[-1][1], b)
        else:
            flight.append([a, b])
    starts = [a for a, _ in flight]
    during = 0
    for _, s, _ in backward:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < flight[i][1]:
            during += 1
    frac, nccl_us = nccl_overlap(events)
    out.update(backward_kernels_during_reduction=during,
               overlap_fraction=frac, nccl_us=nccl_us, ok=during > 0)
    if not out["ok"]:
        out["fix"] = ("no backward kernel runs while a gradient reduction "
                      "is in flight: the reductions wait for the whole "
                      "backward. Reduce each bucket from a gradient hook "
                      "as its gradients land, so NCCL hides in the "
                      f"backward window ({_DOC}#dl201)")
    return out


def dp_overlap_fraction(trace: Union[str, dict]) -> float:
    """DL201 as a score: the share of NCCL kernel time that ran beside
    compute kernels (0.0 when the check skipped or read no device
    event)."""
    return check_dp_overlap(trace).get("overlap_fraction", 0.0)


def check_collective_budget(trace: Union[str, dict], budget: int,
                            steps: Optional[int] = None) -> dict:
    """At most ``budget`` NCCL collective kernels per step. ``steps``:
    how many steps the trace holds (default: its ``ProfilerStep#``
    spans, or one)."""
    from chainermn_torch.training.profiling import (kernel_events,
                                                    kernel_family,
                                                    profiler_steps)

    events = kernel_events(trace)
    if not events:
        return _no_device_events("DL202")
    if steps is None:
        steps = profiler_steps(trace) or 1
    by_kind: Dict[str, int] = {}
    for name, _, _ in events:
        if kernel_family(name) == "NCCL":
            kind = nccl_kind(name)
            by_kind[kind] = by_kind.get(kind, 0) + 1
    total = sum(by_kind.values())
    per_step = total / steps
    out = {"rule": "DL202", "n_device_events": len(events),
           "n_collectives": total, "steps": steps,
           "per_step": per_step, "budget": budget, "by_kind": by_kind,
           "ok": per_step <= budget}
    if not out["ok"]:
        out["fix"] = (f"{per_step:g} NCCL collectives a step exceed the "
                      f"budget of {budget}; check the reducer's "
                      "bucket_bytes (plan_buckets) before profiling "
                      f"({_DOC}#dl202)")
    return out
