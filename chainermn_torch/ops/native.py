"""ctypes binding of the port's host runtime (``csrc/chainermn_native.cpp``).

Counterpart of ``chainermn_tpu/ops/native.py``, for the prefetching
loader (``chainermn_torch/training/loader.py``). At first use the source
is compiled with ``g++`` into ``build/chainermn_torch/`` beside the
package (a directory ``.gitignore`` lists), named by a hash of the source
and the flags so that an edit rebuilds, and loaded with ``ctypes``.
Nothing happens at import time.

There is no fallback: a missing compiler or a failed build raises, where
the JAX package quietly assembles batches in numpy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["get_lib"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "chainermn_native.cpp"
_BUILD = _PKG.parent / "build" / "chainermn_torch"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"libchainermn_native-{digest}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's prefetching "
                           "loader builds csrc/chainermn_native.cpp at "
                           "first use")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.cmn_loader_create.restype = ctypes.c_void_p
    lib.cmn_loader_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int]
    lib.cmn_loader_submit.restype = None
    lib.cmn_loader_submit.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
    lib.cmn_loader_next.restype = ctypes.c_int
    lib.cmn_loader_next.argtypes = [ctypes.c_void_p, vpp, vpp]
    lib.cmn_loader_release.restype = None
    lib.cmn_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cmn_loader_destroy.restype = None
    lib.cmn_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The built and bound library (built once per source hash)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = _target()
            if not out.is_file():
                _build(out)
            _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB
