"""Profiler integration: a trace window for the Trainer, and the reading
of such traces.

Counterpart of ``chainermn_tpu/training/profiling.py``. Where the JAX
package captures a ``jax.profiler`` trace, the port captures a
``torch.profiler`` one (CPU activity, and CUDA activity on the card) and
writes it as a Chrome trace, viewable in Perfetto or
``chrome://tracing``.

The readers below take such a trace (a path or its loaded dict) and are
shared by ``python -m chainermn_torch.tools.profile_lm`` (device time by
kernel family and the busy share) and ``python -m
chainermn_torch.tools.schedtune --trace`` (:func:`nccl_overlap`: the share
of NCCL kernel time that ran concurrently with compute kernels, the
device-side counterpart of the JAX tuner's DL201 overlap fraction), and
by the port's dlint trace passes (``chainermn_torch/analysis/
trace_passes.py``: DL201 reads :func:`backward_events` beside the NCCL
kernels, DL202 counts NCCL kernels per :func:`profiler_steps`).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Profile", "capture", "kernel_events", "kernel_family",
           "family_ms", "busy_share", "nccl_overlap", "backward_events",
           "profiler_steps", "FAMILIES"]

#: the kernel families :func:`kernel_family` sorts device time into
FAMILIES = ("flash_fwd", "flash_bwd", "ce_fwd", "ce_dh", "ce_dw", "GEMM",
            "elementwise", "NCCL", "other")

#: trace categories of device work (kernels, copies, fills)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _activities(device) -> List:
    acts = [torch.profiler.ProfilerActivity.CPU]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profile:
    """Trainer extension: capture a ``torch.profiler`` trace for
    iterations [start, stop). Attach with trigger=(1, 'iteration')::

        trainer.extend(Profile('prof_dir', start=3, stop=8),
                       trigger=(1, 'iteration'))

    Skips the first iterations so warm-up (the kernels' build, the
    allocator's growth) stays out of the trace. The window opens at the
    first call whose iteration is in [start, stop) and closes at the first
    call at ``stop`` or past it, writing one Chrome trace,
    ``logdir/trace_iter<first>-<last>.json`` (the iteration counts at
    the two calls); :attr:`path` names it. ``close()`` (the Trainer calls
    it when the run ends) ends a window still open. ``device``: None
    records CUDA activity too when CUDA is available; ``'cpu'`` records
    the host only.
    """

    def __init__(self, logdir: str, start: int = 3, stop: int = 8,
                 device=None):
        if stop <= start:
            raise ValueError(f"Profile needs stop > start, got [{start}, "
                             f"{stop})")
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self.device = device
        self.path: Optional[str] = None
        self._prof = None
        self._first = self._last = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def __call__(self, trainer=None):
        it = self._last = trainer.updater.iteration
        if not self._active and self.start <= it < self.stop:
            self._prof = torch.profiler.profile(
                activities=_activities(self.device))
            self._prof.start()
            self._first = it
        elif self._active and it >= self.stop:
            self._end(it)

    def _end(self, it: int) -> None:
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir,
                                 f"trace_iter{self._first}-{it}.json")
        prof.export_chrome_trace(self.path)

    def close(self):
        if self._active:
            self._end(self._last)


@contextlib.contextmanager
def capture(device=None, memory: bool = False, shapes: bool = False):
    """Record the body under ``torch.profiler`` (CUDA activity when
    ``device`` is a CUDA device, or None with CUDA available); yields a
    dict that holds the Chrome trace (``"trace"``) once the body ends.
    ``memory`` records allocations and frees (``profile_memory``, for
    dlint's DL204), ``shapes`` the operands' shapes and dtypes
    (``record_shapes``, for DL205 on a gloo trace). A gloo send still
    unwaited when the window ends (the communicator keeps some, e.g. a
    pipeline exchange's headers) corrupts the heap when it completes:
    end the body with ``comm.barrier()``, which drains them."""
    out: Dict = {}
    prof = torch.profiler.profile(activities=_activities(device),
                                  profile_memory=memory,
                                  record_shapes=shapes)
    prof.start()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["trace"] = json.load(f)
    finally:
        os.unlink(path)


def _trace_events(trace: Union[str, dict, list]) -> List[dict]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    return trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace


def kernel_events(trace: Union[str, dict]) -> List[Tuple[str, float, float]]:
    """``(name, start_us, duration_us)`` of every device event (kernels,
    copies, fills) of a Chrome trace (a path or its dict)."""
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in _trace_events(trace)
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


#: the host span the autograd engine records around each backward function
_BACKWARD_SPAN = "autograd::engine::evaluate_function"


def backward_events(trace: Union[str, dict]
                    ) -> List[Tuple[str, float, float]]:
    """The device events of :func:`kernel_events` that a backward function
    launched: those whose launch (the runtime call of the same
    ``correlation``) lies inside an ``autograd::engine::evaluate_function``
    span of the launching thread."""
    events = _trace_events(trace)
    spans: Dict[Tuple, List[Tuple[float, float]]] = {}
    launches: Dict[int, Tuple[Tuple, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        where = (e.get("pid"), e.get("tid"))
        if e.get("name", "").startswith(_BACKWARD_SPAN):
            t0 = float(e["ts"])
            spans.setdefault(where, []).append(
                (t0, t0 + float(e.get("dur", 0.0))))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (where, float(e["ts"]))
    merged = {where: _union(iv) for where, iv in spans.items()}
    starts = {where: [a for a, _ in iv] for where, iv in merged.items()}
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None or launch[0] not in merged:
            continue
        where, t = launch
        i = bisect.bisect_right(starts[where], t) - 1
        if i >= 0 and t <= merged[where][i][1]:
            out.append((e.get("name", ""), float(e["ts"]),
                        float(e.get("dur", 0.0))))
    return out


def profiler_steps(trace: Union[str, dict]) -> int:
    """How many ``ProfilerStep#N`` spans the trace holds (a
    ``torch.profiler`` schedule marks each step so)."""
    return len({e.get("name") for e in _trace_events(trace)
                if e.get("ph") == "X"
                and str(e.get("name", "")).startswith("ProfilerStep#")})


def kernel_family(name: str) -> str:
    """The :data:`FAMILIES` entry of a device event's name: the port's
    hand-written kernels by name (``ce_bwd_mma<false>``/``ce_bwd_fma<false>``
    is dh, ``<true>`` dW), cuBLAS/CUTLASS products, torch's elementwise
    and reduction kernels and copies, NCCL's kernels."""
    low = name.lower()
    if "nccl" in low:
        return "NCCL"
    for fam in ("flash_fwd", "flash_bwd", "ce_fwd"):
        if fam in name:
            return fam
    if "ce_bwd" in name:
        return "ce_dw" if "<true" in name else "ce_dh"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass",
                              "cublas", "gemv")):
        return "GEMM"
    if any(k in low for k in ("elementwise", "reduce_kernel", "memcpy",
                              "memset", "vectorized", "softmax",
                              "layer_norm", "embedding", "index",
                              "cat", "fill", "copy", "multi_tensor")):
        return "elementwise"
    return "other"


def family_ms(events: Sequence[Tuple[str, float, float]]
              ) -> Dict[str, float]:
    """Device milliseconds by :func:`kernel_family`, every family
    present (0.0 where none ran)."""
    out = {f: 0.0 for f in FAMILIES}
    for name, _, dur in events:
        out[kernel_family(name)] += dur / 1e3
    return out


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def busy_share(events: Sequence[Tuple[str, float, float]],
               window_us: Optional[float] = None) -> float:
    """The share of the window in which the device ran at least one event
    (the window: from the first event's start to the last one's end, or
    ``window_us``)."""
    if not events:
        return 0.0
    spans = _union((s, s + d) for _, s, d in events)
    if window_us is None:
        window_us = spans[-1][1] - spans[0][0]
    return _length(spans) / window_us if window_us > 0 else 0.0


def nccl_overlap(events: Sequence[Tuple[str, float, float]]
                 ) -> Tuple[float, float]:
    """``(overlap_fraction, nccl_us)``: the share of NCCL kernel time
    (the union of their intervals) during which a compute kernel (any
    other device event) ran too, and that NCCL time. ``(0.0, 0.0)`` when
    no NCCL kernel ran."""
    nccl = _union((s, s + d) for n, s, d in events
                  if kernel_family(n) == "NCCL")
    if not nccl:
        return 0.0, 0.0
    comp = _union((s, s + d) for n, s, d in events
                  if kernel_family(n) != "NCCL")
    both, j = 0.0, 0
    for a, b in nccl:
        while j < len(comp) and comp[j][1] <= a:
            j += 1
        k = j
        while k < len(comp) and comp[k][0] < b:
            both += min(b, comp[k][1]) - max(a, comp[k][0])
            k += 1
    total = _length(nccl)
    return both / total, total
