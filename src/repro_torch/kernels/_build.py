"""Builds the port's CUDA kernels and binds them with ctypes.

Every source in ``src/repro_torch/csrc/*.cu`` is compiled by ONE ``nvcc``
call for ``sm_90a`` into a shared library under ``build/repro_torch/`` at
the repository root, on first use.  The library's name carries a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is.  The sources expose a plain C interface (no PyTorch
headers), which keeps the build to seconds.

Nothing here falls back: a missing ``nvcc``, a failed build or a failed
launch raises.  The CPU path of each wrapper never reaches this module.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream are c_void_p,
# so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    "repro_matmul_f32": [_P, _P, _P, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _LL, _P],
    "repro_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL, _P],
    "repro_rmsnorm_f32": [_P, _P, _P, _I, _I, _LL, ctypes.c_float, _P],
    "repro_rmsnorm_bf16": [_P, _P, _P, _I, _I, _LL, ctypes.c_float, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output of the build this process ran


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    global build_log
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, path)       # atomic: concurrent builds never clash


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
