"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``chainermn_torch/csrc/`` exposes a plain
``extern "C"`` launcher. It is compiled at first use with ``nvcc`` into a
shared library under ``build/chainermn_torch/`` beside the package (a
directory ``.gitignore`` lists), named by a hash of its source so an edit
rebuilds, and loaded with ``ctypes``. Nothing here runs at import time:
the CPU tests import every module of the port on a machine with no
``nvcc`` and no card.

There is no fallback. A missing compiler, a failed build or a launch
that returns an error raises; a caller that wants the plain PyTorch
version passes CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["SOURCES", "build", "build_all", "library", "launches",
           "reset_launches", "launch_flash_fwd"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "chainermn_torch"

#: kernel name → source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu"}

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in SOURCES}


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


def _target(name: str) -> Path:
    src = _CSRC / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``name``; returns (process or None, target)."""
    out = _target(name)
    if out.is_file():
        return None, out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
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
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named kernel, one ``nvcc`` per source, all started
    together. Returns the seconds each build took (0 when cached)."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    took = {}
    for name, (started, out) in jobs.items():
        _finish(name, started, out)
        took[name] = 0.0 if started is None else time.perf_counter() - t0
    return took


def build(name: str) -> Path:
    started, out = _start(name)
    _finish(name, started, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


def launches() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def _launched(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code, else count the
    launch: the one place a kernel's count goes up."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    _launches[name] += 1


#: torch dtype → the launcher's dtype code (csrc/flash_fwd.cu)
FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    fn = library("flash_fwd").chainermn_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _FLASH_ARGTYPES
        fn.restype = ctypes.c_int
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), None if q_seg is None else q_seg.data_ptr(),
             None if kv_seg is None else kv_seg.data_ptr(),
             FLASH_DTYPES[q.dtype], b, lq, lk, hq, hkv, d, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], scale, int(causal),
             int(window), torch.cuda.current_stream(q.device).cuda_stream)
    _launched(err, "flash_fwd")
