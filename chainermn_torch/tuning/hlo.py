"""The two scheduled-HLO parsers the tuner's score reads.

Copies of ``check_dp_overlap``/``dp_overlap_fraction`` (DL201) and
``check_pipeline_permute_overlap`` (DL203) from
``chainermn_tpu/analysis/hlo_passes.py``; they use only ``re``, so the
port keeps its own. The port compiles no HLO: these score the canned
emulator's text (:mod:`.canned`), and any scheduled module a JAX build
saved. The device-side counterpart of DL201's overlap fraction is
:func:`chainermn_torch.training.profiling.nccl_overlap`, which
``schedtune --trace`` reads from a ``torch.profiler`` trace.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_DOC = "docs/static_analysis.md"


def scheduled_entry_ops(hlo_text: str) -> List[Tuple[str, str]]:
    """(op_kind, full_line) per instruction of the ENTRY computation, in
    schedule order (meaningful when the module is ``is_scheduled=true``)."""
    ops = []
    in_entry = False
    for ln in hlo_text.splitlines():
        if ln.startswith("ENTRY"):
            in_entry = True
            continue
        if in_entry:
            if ln.startswith("}"):
                break
            s = ln.strip()
            if s.startswith("ROOT "):
                s = s[len("ROOT "):]
            if not re.match(r"%?[\w.-]+ = ", s):
                continue
            # the opcode is the token right before the operand list:
            # the leftmost space-preceded lowercase token directly
            # followed by "(". Result types can't shadow it — tuple
            # types open with "= (", and the tile/memory annotations
            # inside them ("T(8,128)", "S(1)") are uppercase. Operands
            # may carry full types ("all-reduce(f32[...] %x, ...)"),
            # so nothing stricter than the bare paren can be anchored.
            m = re.search(r" ([a-z][\w-]*)\(", s)
            if m:
                ops.append((m.group(1), s))
    return ops


def parse_computations(
        hlo_text: str) -> Dict[str, List[Tuple[str, str, List[str]]]]:
    """name -> [(op_kind, result_name, [operand_names])] per HLO
    computation, in textual (= schedule, when scheduled) order."""
    comps: Dict[str, List[Tuple[str, str, List[str]]]] = {}
    cur: Optional[str] = None
    for ln in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.-]+) \(.*\{\s*$", ln)
        if m:
            cur = m.group(1)
            comps[cur] = []
            continue
        if cur is not None:
            if ln.startswith("}"):
                cur = None
                continue
            s = ln.strip()
            if s.startswith("ROOT "):
                s = s[len("ROOT "):]
            mm = re.match(r"%?([\w.-]+) = .*? ([a-z][\w-]*)\((.*)", s)
            if mm:
                operands = re.findall(r"%([\w.-]+)", mm.group(3))
                comps[cur].append((mm.group(2), mm.group(1), operands))
    return comps


def check_dp_overlap(hlo_text: str) -> dict:
    """Does the scheduled entry start gradient all-reduces before
    backward compute ends?"""
    ops = scheduled_entry_ops(hlo_text)
    ar = [i for i, (k, _) in enumerate(ops)
          if k in ("all-reduce", "all-reduce-start")]
    bwd = [i for i, (_, s) in enumerate(ops) if "transpose(jvp" in s]
    out = {
        "rule": "DL201",
        "is_scheduled": "is_scheduled=true" in hlo_text,
        "n_sched_ops": len(ops),
        "n_allreduce": len(ar),
        "first_allreduce": min(ar) if ar else None,
        "last_backward": max(bwd) if bwd else None,
        "backward_ops_after_first_allreduce": (
            sum(1 for i in bwd if i > min(ar)) if ar else 0),
        "async_pairs": bool(re.search(r"all-reduce-start", hlo_text)),
    }
    out["overlap_fraction"] = (
        out["backward_ops_after_first_allreduce"] / len(bwd)
        if out["is_scheduled"] and ar and bwd else 0.0)
    out["ok"] = bool(
        out["is_scheduled"] and ar and bwd and min(ar) < max(bwd))
    if not out["ok"]:
        out["fix"] = (
            "compile with xla_tpu_enable_latency_hiding_scheduler=true "
            "and xla_enable_async_all_reduce=true so gradient "
            f"all-reduces hide in the backward window ({_DOC}#dl201)")
    return out


def dp_overlap_fraction(hlo_text: str) -> float:
    """DL201 as a scalar SCORE, not just a verdict: the fraction of
    backward ops scheduled after the first gradient all-reduce issues —
    i.e. the share of the backward window available to hide gradient
    collectives in. 0.0 for an unscheduled module, no all-reduce, or no
    backward ops; 1.0 when every backward op follows the first issue
    (the double-buffered/prev-step-grads shape). This is the objective
    the schedule autotuner (:mod:`chainermn_torch.tuning`) maximizes."""
    return check_dp_overlap(hlo_text)["overlap_fraction"]


def check_pipeline_permute_overlap(hlo_text: str) -> dict:
    """Every collective-permute must be an async start/done pair with
    ≥1 real compute op (fusion/dot/custom-call) scheduled inside ITS OWN
    window, and no op may fall back to a synchronous collective-permute.

    Scans every computation and reports the one with the most permute
    pairs (the pipeline while-body); compute counted inside an unrelated
    pair's gap must not certify an individually-serialized hop, so each
    start is matched to the done consuming its result.
    """
    best = None
    for name, ops in parse_computations(hlo_text).items():
        starts = [(i, res) for i, (k, res, _) in enumerate(ops)
                  if k == "collective-permute-start"]
        if not starts:
            continue
        fusions = [i for i, (k, _, _) in enumerate(ops)
                   if k in ("fusion", "dot", "custom-call")]
        pairs = []
        for si, res in starts:
            done = next((i for i, (k, _, opr) in enumerate(ops)
                         if i > si and k == "collective-permute-done"
                         and res in opr), None)
            if done is not None:
                pairs.append(
                    (si, done, sum(1 for f in fusions if si < f < done)))
        if not pairs:
            continue
        cand = {
            "body": name,
            "n_body_ops": len(ops),
            "n_permute_pairs": len(pairs),
            "pairs": [{"start": s, "done": d, "compute_inside": c}
                      for s, d, c in pairs],
            "min_compute_inside_any_pair": min(c for _, _, c in pairs),
            "n_compute": len(fusions),
        }
        if best is None or cand["n_permute_pairs"] > best["n_permute_pairs"]:
            best = cand

    out = best or {"n_permute_pairs": 0}
    out["rule"] = "DL203"
    out["sync_permutes"] = len(
        re.findall(r"= *\S* *collective-permute\(", hlo_text))
    # ok = both rings async, EVERY hop hides >=1 real compute op inside
    # its own start->done window, and nothing fell back to a synchronous
    # collective-permute
    out["ok"] = bool(best and best["n_permute_pairs"] >= 2
                     and best["min_compute_inside_any_pair"] >= 1
                     and out["sync_permutes"] == 0)
    if not out["ok"]:
        out["fix"] = (
            "the wire hop is serialized with tick compute; enable the "
            "latency-hiding scheduler and keep per-tick compute large "
            f"enough to hide the permute ({_DOC}#dl203)")
    return out
