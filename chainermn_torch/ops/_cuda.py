"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``chainermn_torch/csrc/`` exposes a plain
``extern "C"`` launcher. It is compiled at first use with ``nvcc`` into a
shared library under ``build/chainermn_torch/`` beside the package (a
directory ``.gitignore`` lists), named by a hash of its source, the
``csrc/`` headers it includes and the flags, so an edit rebuilds, and
loaded with ``ctypes``. ptxas's report of each build (registers and
spill bytes per kernel) is kept beside the library. Nothing here runs at
import time: the CPU tests import every module of the port on a machine
with no ``nvcc`` and no card.

There is no fallback. A missing compiler, a failed build or a launch
that returns an error raises; a caller that wants the plain PyTorch
version passes CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["SOURCES", "KERNELS", "build", "build_all", "library", "variant",
           "ptxas_usage", "launches", "reset_launches", "launch_flash_fwd",
           "launch_flash_bwd", "flash_bwd_f32_tile", "ce_fwd_tile",
           "ce_dh_tile", "ce_dw_tile", "launch_ce_fwd", "launch_ce_dh",
           "launch_ce_dw"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "chainermn_torch"

#: library name → source file under csrc/ (one nvcc, one .so each)
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "fused_ce": "fused_ce.cu"}
#: the kernels, each with its own launch count (fused_ce.cu holds the
#: three ce_* kernels)
KERNELS = ("flash_fwd", "flash_bwd", "ce_fwd", "ce_dh", "ce_dw")

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: a build: library name and extra ``-D`` defines (empty: as shipped)
Build = Tuple[str, Tuple[str, ...]]

_libs: Dict[Build, ctypes.CDLL] = {}
_variants: Dict[str, Tuple[str, ...]] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
#: the same counts by input dtype: f32 inputs run other kernel bodies
#: (``flash_fwd_fma``, ``flash_bwd_fma``, ``ce_fwd_fma``, ``ce_bwd_fma``)
#: than bf16 ones
_launches_by_dtype: Dict[torch.dtype, Dict[str, int]] = {
    dt: {name: 0 for name in KERNELS} for dt in (torch.float32,
                                                 torch.bfloat16)}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            "chainermn_torch/csrc at first use")
    return found


def _headers(src: Path) -> List[Path]:
    """The ``csrc/`` headers ``src`` includes with ``#include "..."``,
    and theirs, each once."""
    found: List[Path] = []
    todo = [src]
    while todo:
        text = todo.pop().read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            path = _CSRC / inc
            if path.is_file() and path not in found:
                found.append(path)
                todo.append(path)
    return sorted(found)


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library's path, named by a hash of its source, the headers it
    includes, the flags and the defines, so that an edit to any
    rebuilds."""
    src = _CSRC / SOURCES[name]
    parts = [src.read_bytes()] + [h.read_bytes() for h in _headers(src)]
    parts.append(" ".join(_NVCC_FLAGS + defines).encode())
    digest = hashlib.sha1(b"".join(parts)).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def _start(name: str, defines: Tuple[str, ...] = ()):
    """Start one nvcc for a build; returns (process or None, target)."""
    out = _target(name, defines)
    if out.is_file():
        return None, out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
           str(tmp), str(_CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(SOURCES),
              variants: Iterable[Build] = ()) -> Dict[str, float]:
    """Compile every named library as shipped and every (name, defines)
    variant, one ``nvcc`` per build, all started together. Returns the
    seconds each build took (0 when cached), keyed by name, with a
    variant's defines appended."""
    t0 = time.perf_counter()
    builds = [(name, ()) for name in names] + [
        (name, tuple(defines)) for name, defines in variants]
    jobs = {b: _start(*b) for b in builds}
    took = {}
    for (name, defines), (started, out) in jobs.items():
        _finish(name, started, out)
        key = " ".join((name,) + tuple(f"-D{d}" for d in defines))
        took[key] = 0.0 if started is None else time.perf_counter() - t0
    return took


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    started, out = _start(name, defines)
    _finish(name, started, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` (built if needed): as shipped,
    or the build that an enclosing :func:`variant` selects."""
    key = (name, _variants.get(name, ()))
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(*key)))
        _libs[key] = lib
    return lib


@contextlib.contextmanager
def variant(name: str, defines: Iterable[str]):
    """Inside the block, the launchers of library ``name`` call its build
    with the extra ``-D`` ``defines``: a variant timed beside the shipped
    build (as ``chip_smoke.py`` times the flash kernels' register
    caps)."""
    _variants[name] = tuple(defines)
    try:
        yield
    finally:
        del _variants[name]


def parse_ptxas(report: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``
    output: ``{mangled name: {"registers", "spill_stores",
    "spill_loads"}}``."""
    usage: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            usage.setdefault(props, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    return {k: v for k, v in usage.items() if "registers" in v}


def ptxas_usage(name: str, defines: Tuple[str, ...] = ()
                ) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of a build's kept report (built if needed)."""
    out = build(name, defines)
    return parse_ptxas(out.with_suffix(".ptxas.txt").read_text())


def launches(dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`; with
    ``dtype`` (f32 or bf16), only those on inputs of that dtype."""
    return dict(_launches if dtype is None else _launches_by_dtype[dtype])


def reset_launches() -> None:
    for counts in (_launches, *_launches_by_dtype.values()):
        for name in counts:
            counts[name] = 0


def _launched(err: int, name: str, dtype: torch.dtype) -> None:
    """Raise if a launcher returned an error code (a cudaError_t, or a
    negated CUresult from building a TMA descriptor), else count the
    launch: the one place a kernel's count goes up."""
    if err > 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    if err < 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cuTensorMapEncodeTiled returned CUresult "
                           f"{-err}")
    _launches[name] += 1
    _launches_by_dtype[dtype][name] += 1


def _bind(lib: str, fn_name: str, argtypes):
    fn = getattr(library(lib), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


#: torch dtype → the launchers' dtype code (every csrc/*.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def launch_flash_fwd(q, k, v, out, lse, q_seg, kv_seg, scale: float,
                     causal: bool, window: int) -> None:
    """Launch ``chainermn_flash_fwd`` on the current stream. Tensors are
    validated and allocated by ``ops.flash_attention.flash_attention_cuda``;
    segment ids are int32 ``[B, L]`` or None, ``window`` <= 0 means
    none."""
    fn = _bind("flash_fwd", "chainermn_flash_fwd", _FLASH_ARGTYPES)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
             DTYPES[q.dtype], b, lq, lk, hq, hkv, d, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], scale, int(causal),
             int(window), _stream(q))
    _launched(err, "flash_fwd", q.dtype)


_FLASH_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])


def launch_flash_bwd(q, k, v, dout, lse, dr, q_seg, kv_seg, dq_acc, dk, dv,
                     scale: float, causal: bool, window: int) -> None:
    """Launch ``chainermn_flash_bwd`` on the current stream. Tensors are
    validated and allocated by
    ``ops.flash_attention.flash_attention_bwd_cuda``: ``dq_acc`` is a
    zeroed f32 ``[B, Lq, Hq, D]``, dk/dv contiguous in the input dtype,
    lse and dr f32 ``[B, Hq, Lq]``."""
    fn = _bind("flash_bwd", "chainermn_flash_bwd", _FLASH_BWD_ARGTYPES)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), dr.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
             dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             DTYPES[q.dtype], b, lq, lk, hq, hkv, d, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3], scale,
             int(causal), int(window), _stream(q))
    _launched(err, "flash_bwd", q.dtype)


def flash_bwd_f32_tile(d: int) -> Tuple[int, int, int, int]:
    """The f32 flash backward's tile at head dim ``d``: (keys a CTA, query
    rows a streamed tile, threads a CTA, CTAs an SM)."""
    fn = _bind("flash_bwd", "chainermn_flash_bwd_f32_tile",
               [ctypes.c_int, ctypes.c_int])
    return tuple(int(fn(i, d)) for i in range(4))


_CE_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
_CE_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def ce_smem_bytes(which: int, dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of CE kernel ``which`` (0 fwd, 1 dh, 2 dW)."""
    fn = _bind("fused_ce", "chainermn_ce_smem",
               [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    return int(fn(which, DTYPES[dtype], d))


def ce_fwd_tile(dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[int, int, int, int]:
    """The forward's tile for inputs of ``dtype``: (rows of h per CTA,
    vocabulary columns per tile, depth of one pipeline step, CTAs an SM
    holds)."""
    fn = _bind("fused_ce", "chainermn_ce_fwd_tile",
               [ctypes.c_int, ctypes.c_int])
    return tuple(int(fn(i, DTYPES[dtype])) for i in range(4))


def ce_dh_tile() -> Tuple[int, int, int, int]:
    """The f32 dh's tile: (rows of h per CTA, vocabulary rows per tile,
    columns of dh per D chunk, CTAs an SM holds)."""
    fn = _bind("fused_ce", "chainermn_ce_dh_tile", [ctypes.c_int])
    return tuple(int(fn(i)) for i in range(4))


def ce_dw_tile() -> Tuple[int, int, int, int]:
    """The f32 dW's tile: (vocabulary rows per CTA, rows of h per tile,
    columns of dW per D chunk, CTAs an SM holds)."""
    fn = _bind("fused_ce", "chainermn_ce_dw_tile", [ctypes.c_int])
    return tuple(int(fn(i)) for i in range(4))


def launch_ce_fwd(h, wt, y, lse, tl, am, part, splits: int) -> None:
    """``chainermn_ce_fwd``: h ``[N, D]``, wt ``[V, D]``, y int32 ``[N]``
    → lse, tl f32 ``[N]``, am int32 ``[N]`` (validated by
    ``ops.fused_ce``); ``part`` is an f32 workspace of ``4 x splits x N``
    entries and ``splits`` the number of vocabulary ranges. The forward
    and the combine of its ranges count as one launch."""
    fn = _bind("fused_ce", "chainermn_ce_fwd", _CE_FWD_ARGTYPES)
    n, d = h.shape
    err = fn(h.data_ptr(), wt.data_ptr(), y.data_ptr(), lse.data_ptr(),
             tl.data_ptr(), am.data_ptr(), part.data_ptr(), splits,
             DTYPES[h.dtype], n, d, wt.shape[0], _stream(h))
    _launched(err, "ce_fwd", h.dtype)


def launch_ce_dh(h, wt, y, lse, dh, part=None, splits: int = 1) -> None:
    """``chainermn_ce_dh``: unscaled dh ``[N, D]`` in h's dtype. f32 takes
    ``splits`` vocabulary ranges and, when there is more than one, ``part``,
    an f32 workspace of ``splits x N x D`` entries; the kernel and the sum
    of its ranges count as one launch. bf16 takes neither."""
    fn = _bind("fused_ce", "chainermn_ce_dh", _CE_BWD_ARGTYPES)
    n, d = h.shape
    err = fn(h.data_ptr(), wt.data_ptr(), y.data_ptr(), lse.data_ptr(),
             dh.data_ptr(), _ptr(part), splits, DTYPES[h.dtype], n, d,
             wt.shape[0], _stream(h))
    _launched(err, "ce_dh", h.dtype)


def launch_ce_dw(h, wt, y, lse, dwt, part=None, splits: int = 1) -> None:
    """``chainermn_ce_dw``: unscaled dW^T ``[V, D]`` in wt's dtype. f32
    takes ``splits`` ranges of h's rows and, when there is more than one,
    ``part``, an f32 workspace of ``splits x V x D`` entries; the kernel
    and the sum of its ranges count as one launch. bf16 takes neither."""
    fn = _bind("fused_ce", "chainermn_ce_dw", _CE_BWD_ARGTYPES)
    n, d = h.shape
    err = fn(h.data_ptr(), wt.data_ptr(), y.data_ptr(), lse.data_ptr(),
             dwt.data_ptr(), _ptr(part), splits, DTYPES[h.dtype], n, d,
             wt.shape[0], _stream(h))
    _launched(err, "ce_dw", h.dtype)
