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
* ``DL203`` :func:`check_pipeline_permute_overlap` — every pipeline hop
  (an NCCL ``SendRecv``/``Send``/``Recv`` kernel) must run on a stream
  of its own, with at least one compute kernel running inside its own
  interval on the same card; a hop on the compute stream is the
  synchronous fallback JAX calls a sync ``collective-permute``.
* ``DL204`` :func:`check_fsdp_gather_liveness` — the peak number of
  co-live gathered FSDP buffers, from the profiler's memory events
  (``profile_memory=True``): each ``fsdp::gather`` span's allocations
  that outlive the span are the gathered buffer, live until freed.
  Layer gathers (``fsdp::gather/layer=i``, :func:`~chainermn_torch.
  optimizers.zero.fsdp_scan_apply`) count a layer once however many
  leaves it gathers, as XLA's combiner merges them; the group with the
  most gathers is judged, as JAX judges the computation with the most.
* ``DL205`` :func:`check_quantized_wire_dtype` — the dominant collective
  by bytes, per family (reduce, gather), must carry a narrow dtype once
  any collective of that family does; read from the profiler's
  ``record_param_comms`` events (``dtype``, ``Out msg nelems``) or, where
  a backend records no such event (gloo), its ``gloo:<op>`` spans
  (``Input type``, ``Input Dims``; ``record_shapes=True``).

Every checker returns a dict with at least ``{"rule", "ok", ...}``
evidence fields, in the shape of the JAX passes; ``ok=None`` with a
``skip`` key means the trace had nothing to check (one card runs no
NCCL kernel). A pass that cannot see what it reads fails (``ok=False``):
DL201-DL203 on a trace with no device event (it was not taken on the
card with CUDA activity), DL204 on gather spans without memory events,
DL205 on collectives without a dtype. A pass that reads nothing must not
pass.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Optional, Union

from chainermn_torch.analysis.core import Rule, register

_DOC = "docs/static_analysis_torch.md"

for _rid, _name in (("DL201", "dp-allreduce-overlap"),
                    ("DL202", "collective-budget"),
                    ("DL203", "pipeline-permute-overlap"),
                    ("DL204", "fsdp-gather-liveness"),
                    ("DL205", "quantized-wire-dtype")):
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


def _trace_events_of(trace):
    from chainermn_torch.training.profiling import _trace_events

    return _trace_events(trace)


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


#: NCCL kernels of a pipeline hop (DL203)
P2P_KINDS = ("SendRecv", "Send", "Recv")


def check_pipeline_permute_overlap(trace: Union[str, dict]) -> dict:
    """Does every pipeline hop hide compute? Per card (a trace's device
    ``pid``), each NCCL p2p kernel's interval is matched against the
    compute kernels (every other kernel) that run inside it; a hop on a
    stream that also runs compute kernels is synchronous."""
    from chainermn_torch.training.profiling import kernel_family

    kernels = [e for e in _trace_events_of(trace)
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernels:
        return _no_device_events("DL203")
    hops, compute, compute_streams = [], {}, set()
    for e in kernels:
        name = e.get("name", "")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        where = (e.get("pid"), e.get("tid"))
        if kernel_family(name) == "NCCL":
            if nccl_kind(name) in P2P_KINDS:
                hops.append((where, s, s + d))
        else:
            compute.setdefault(where[0], []).append((s, s + d))
            compute_streams.add(where)
    out = {"rule": "DL203", "n_device_events": len(kernels),
           "n_permute_pairs": len(hops)}
    if not hops:
        out.update(ok=None, skip="no pipeline p2p kernel (NCCL SendRecv/"
                   "Send/Recv) in the trace")
        return out
    inside = [sum(1 for s, e in compute.get(card, ()) if s < b and e > a)
              for (card, _), a, b in hops]
    sync = sum(1 for where, _, _ in hops if where in compute_streams)
    out.update(pairs=[{"start": a, "done": b, "compute_inside": c}
                      for (_, a, b), c in zip(hops, inside)],
               min_compute_inside_any_pair=min(inside),
               n_compute=sum(len(v) for v in compute.values()),
               sync_permutes=sync)
    out["ok"] = (len(hops) >= 2 and out["min_compute_inside_any_pair"] >= 1
                 and sync == 0)
    if not out["ok"]:
        out["fix"] = ("a pipeline hop is serialized with the tick's "
                      "compute: post the exchange asynchronously "
                      "(isend/irecv on NCCL's stream) and run the tick's "
                      "compute while it is in flight "
                      f"({_DOC}#dl203)")
    return out


#: the span the FSDP gather records around each all-gathered leaf
#: (``fsdp::gather``) or layer of a stack (``fsdp::gather/layer=i``)
GATHER_SPAN = "fsdp::gather"
_GATHER_RE = re.compile(r"^fsdp::gather(?:/layer=(\d+))?$")


def _gather_units(events) -> Dict[str, list]:
    """The FSDP gathers of a trace by group: ``"leaf"`` (every
    ``fsdp::gather`` span its own unit) and ``"layer"`` (a run of
    consecutive ``fsdp::gather/layer=i`` spans of one ``i`` is one
    unit) → each unit's list of ``(start, end)`` spans."""
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        m = _GATHER_RE.match(str(e.get("name", "")))
        if m:
            t0 = float(e["ts"])
            spans.append((t0, t0 + float(e.get("dur", 0.0)), m.group(1)))
    spans.sort()
    groups: Dict[str, list] = {"leaf": [], "layer": []}
    last = None
    for a, b, layer in spans:
        if layer is None:
            groups["leaf"].append([(a, b)])
            last = None
        elif layer == last:
            groups["layer"][-1].append((a, b))
        else:
            groups["layer"].append([(a, b)])
            last = layer
    return groups


def check_fsdp_gather_liveness(trace: Union[str, dict], max_live: int = 2,
                               computation: Optional[str] = None) -> dict:
    """Peak number of co-live gathered FSDP units. A unit's buffers are
    the allocations inside its spans that no free inside the span
    returns; the unit is live from its first span until the last of them
    is freed (the trace's end if never). The profiler records no free
    made on a thread it does not follow (a backend's worker that drops
    the last reference after this thread let go): a block whose address
    is allocated again with no free between, or that is never freed, is
    taken to die with the unit's recorded buffers, and bounds the unit
    (by its address's next allocation, or the trace's end) only when
    none of them was recorded. ``computation``: ``"leaf"`` or
    ``"layer"`` to judge that group (default: the one with the most
    gather spans)."""
    events = _trace_events_of(trace)
    groups = _gather_units(events)
    if computation is not None:
        if computation not in groups:
            return {"rule": "DL204", "ok": None,
                    "skip": f"no gather group named {computation!r}"}
        selected = {computation: groups[computation]}
    else:
        selected = groups
    name, units = max(selected.items(),
                      key=lambda kv: sum(len(u) for u in kv[1]))
    if not units:
        return {"rule": "DL204", "ok": None,
                "skip": "no FSDP gather span (fsdp::gather) in the trace"}
    allocs, frees, again = [], {}, {}
    for e in events:
        if e.get("ph") != "i" or e.get("name") != "[memory]":
            continue
        args = e.get("args") or {}
        key = (args.get("Device Type"), args.get("Device Id"),
               args.get("Addr"))
        t = float(e["ts"])
        if args.get("Bytes", 0) > 0:
            allocs.append((t, key))
            again.setdefault(key, []).append(t)
        elif args.get("Bytes", 0) < 0:
            frees.setdefault(key, []).append(t)
    if not allocs:
        return {"rule": "DL204", "ok": False, "n_gathers": len(units),
                "n_memory_events": 0,
                "fix": ("the trace holds FSDP gathers but no memory event: "
                        "take it with profile_memory=True "
                        "(training.profiling.capture(memory=True)) "
                        f"({_DOC}#dl204)")}
    allocs.sort(key=lambda x: x[0])
    for ts in (*frees.values(), *again.values()):
        ts.sort()
    alloc_ts = [t for t, _ in allocs]
    end_of_trace = max([alloc_ts[-1]] + [ts[-1] for ts in frees.values()])
    intervals = []
    for unit in units:
        seen, unseen = [], []
        for a, b in unit:
            lo = bisect.bisect_left(alloc_ts, a)
            hi = bisect.bisect_right(alloc_ts, b)
            for t, key in allocs[lo:hi]:
                ts, re_ts = frees.get(key, []), again[key]
                i = bisect.bisect_left(ts, t)
                k = bisect.bisect_right(re_ts, t)
                freed = ts[i] if i < len(ts) else None
                realloc = re_ts[k] if k < len(re_ts) else None
                if freed is not None and (realloc is None
                                          or freed <= realloc):
                    if freed > b:       # outlives the span: the gather
                        seen.append(freed)
                else:                   # its free went unrecorded
                    bound = end_of_trace if realloc is None else realloc
                    if bound > b:
                        unseen.append(bound)
        ends = seen or unseen
        if ends:
            intervals.append((unit[0][0], max(ends)))
    points = sorted({s for s, _ in intervals})
    peak = max((sum(1 for s, e in intervals if s <= p < e or s == p)
                for p in points), default=0)
    out = {"rule": "DL204", "computation": name,
           "n_gathers": len(units), "n_gathered_units": len(intervals),
           "peak_live_gathers": peak, "max_live": max_live,
           "ok": peak <= max_live}
    if not out["ok"]:
        out["fix"] = (
            f"{peak} of {len(intervals)} gathered parameter buffers are "
            "live at once — every gathered layer stays alive and peak "
            "memory is back at the unsharded model. Stack the layers and "
            "use fsdp_scan_apply (its remat frees each layer's gather "
            f"with its iteration) ({_DOC}#dl204)")
    return out


#: dtypes that count as a quantized wire (JAX's names): integer codes and
#: sub-f32 floats; f32/f64 payloads are the wide wire
NARROW_WIRE_DTYPES = frozenset(
    ("s4", "u4", "s8", "u8", "s16", "u16", "s32", "u32", "bf16", "f16"))

_DTYPE_BYTES = {"pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
                "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
                "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8}

#: torch's scalar-type names (``record_param_comms``' ``dtype``) and the
#: C++ names of a backend span's ``Input type`` → JAX's short names
_TORCH_DTYPES = {
    "Float": "f32", "float": "f32", "Double": "f64", "double": "f64",
    "Half": "f16", "c10::Half": "f16", "BFloat16": "bf16",
    "c10::BFloat16": "bf16", "Int": "s32", "int": "s32",
    "Long": "s64", "long int": "s64", "Short": "s16", "short int": "s16",
    "Char": "s8", "signed char": "s8", "Byte": "u8",
    "unsigned char": "u8", "Bool": "pred", "bool": "pred",
    "UInt32": "u32", "unsigned int": "u32"}

#: the dtype in an NCCL kernel's name (``..._Sum_f32_RING_LL``)
_NCCL_DTYPE = re.compile(
    r"_(i8|u8|i32|u32|i64|u64|f16|bf16|f32|f64|int8_t|uint8_t|int32_t|"
    r"uint32_t|int64_t|uint64_t|half|float|double|__nv_bfloat16)(?:_|$)")
_NCCL_DTYPES = {"i8": "s8", "int8_t": "s8", "u8": "u8", "uint8_t": "u8",
                "i32": "s32", "int32_t": "s32", "u32": "u32",
                "uint32_t": "u32", "i64": "s64", "int64_t": "s64",
                "u64": "u64", "uint64_t": "u64", "f16": "f16",
                "half": "f16", "bf16": "bf16", "__nv_bfloat16": "bf16",
                "f32": "f32", "float": "f32", "f64": "f64",
                "double": "f64"}


def nccl_dtype(name: str) -> Optional[str]:
    """The dtype (JAX's short name) an NCCL kernel's name carries, or
    None. NCCL runs an int32 sum with its ``u32`` kernels (the same
    bits), so a record's s32 shows as u32 there."""
    m = _NCCL_DTYPE.search(name)
    return _NCCL_DTYPES[m.group(1)] if m else None


def _collective_family(op: str) -> Optional[str]:
    low = op.lower()
    if "reduce" in low and "scatter" in low or "allreduce" in low \
            or "all_reduce" in low:
        return "reduce"
    if "gather" in low and "all" in low:
        return "gather"
    return None


def collective_records(trace: Union[str, dict]) -> list:
    """``{"op", "family", "dtype", "elements"}`` of every reduce or
    gather collective the trace records: ``record_param_comms`` events
    where there are any, else the backend's ``gloo:``/``nccl:`` spans.
    ``dtype`` is None where the event carries none."""
    events = [e for e in _trace_events_of(trace) if e.get("ph") == "X"]
    rec = [e for e in events if e.get("name") == "record_param_comms"]
    found = []
    if rec:
        for e in rec:
            a = e.get("args") or {}
            op = str(a.get("Collective name", ""))
            fam = _collective_family(op)
            if fam is None:
                continue
            n = a.get("Out msg nelems", a.get("In msg nelems"))
            found.append({"op": op, "family": fam,
                          "dtype": _TORCH_DTYPES.get(str(a.get("dtype"))),
                          "elements": int(n or 0)})
        return found
    for e in events:
        name = str(e.get("name", ""))
        if not name.startswith(("gloo:", "nccl:")):
            continue
        op = name.split(":", 1)[1]
        fam = _collective_family(op)
        if fam is None:
            continue
        a = e.get("args") or {}
        types, dims = a.get("Input type") or [], a.get("Input Dims") or []
        dt = _TORCH_DTYPES.get(types[0]) if types else None
        elems = 1
        for d in (dims[0] if dims else []):
            elems *= int(d)
        found.append({"op": op, "family": fam, "dtype": dt,
                      "elements": elems if dims else 0})
    return found


def check_quantized_wire_dtype(trace: Union[str, dict],
                               expect_quantized: bool = False) -> dict:
    """DL205: within each family (reduce, gather) that carries a narrow
    collective of 256 elements or more, the largest collective by bytes
    is narrow. s32/u32 count as narrow only on reducing collectives (the
    quantized reducers sum int32 codes); an integer gather is wide data.
    Without narrow evidence the pass skips, or fails under
    ``expect_quantized``."""
    from chainermn_torch.training.profiling import kernel_events

    found = collective_records(trace)
    if not found:
        return {"rule": "DL205", "ok": None, "skip": "no collectives"}
    blind = [f for f in found if f["dtype"] is None]
    if blind:
        return {"rule": "DL205", "ok": False, "n_collectives": len(found),
                "n_without_dtype": len(blind),
                "fix": ("collectives without a dtype: take the trace with "
                        "record_shapes=True (training.profiling.capture("
                        f"shapes=True)) ({_DOC}#dl205)")}
    for f in found:
        f["bytes"] = f["elements"] * _DTYPE_BYTES.get(f["dtype"], 4)
    kernel_dtypes: Dict[str, Dict[str, int]] = {}
    for name, _, _ in kernel_events(trace):
        dt = nccl_dtype(name) if "nccl" in name.lower() else None
        if dt is not None:
            by = kernel_dtypes.setdefault(nccl_kind(name), {})
            by[dt] = by.get(dt, 0) + 1

    def _is_narrow(f):
        if f["dtype"] in ("s32", "u32"):
            return f["family"] == "reduce"
        return f["dtype"] in NARROW_WIRE_DTYPES

    evidence, failed, dominants = 0, [], {}
    for fam in ("reduce", "gather"):
        ops = [f for f in found if f["family"] == fam]
        narrow = [f for f in ops if _is_narrow(f) and f["elements"] >= 256]
        if not narrow:
            continue
        evidence += 1
        dominant = max(ops, key=lambda f: f["bytes"])
        dominants[fam] = dominant
        if dominant not in narrow:
            failed.append((fam, dominant, len(narrow)))
    if not evidence:
        if expect_quantized:
            return {
                "rule": "DL205", "ok": False, "n_collectives": len(found),
                "kernel_dtypes": kernel_dtypes,
                "fix": ("the step was built with a quantized wire but no "
                        "collective carries a narrow dtype: the full f32 "
                        f"payload crosses the wire ({_DOC}#dl205)")}
        return {"rule": "DL205", "ok": None,
                "skip": "no quantized-wire evidence",
                "n_collectives": len(found), "kernel_dtypes": kernel_dtypes}
    out = {"rule": "DL205", "n_collectives": len(found),
           "dominant": dominants, "kernel_dtypes": kernel_dtypes,
           "ok": not failed}
    if failed:
        fam, dominant, n_narrow = failed[0]
        out["fix"] = (
            f"the largest {fam} collective ({dominant['op']} "
            f"{dominant['dtype']}[{dominant['elements']}], "
            f"{dominant['bytes']:,} B) is still wide while {n_narrow} "
            "smaller one(s) are narrow — the main payload's quantize did "
            "not reach the wire; check the reducer wraps this tensor "
            f"({_DOC}#dl205)")
    return out
