"""Builds the port's CUDA kernels and binds them with ctypes.

Every source in ``src/repro_torch/csrc/*.cu`` is compiled for ``sm_90a``
by its own ``nvcc`` process, all started together, and the objects are
linked into one shared library under ``build/repro_torch/`` at the
repository root, on first use.  The library's name carries a hash of
the sources, the headers they include (``csrc/*.cuh``) and the flags, so
an edited kernel or header is rebuilt and an unchanged one is loaded as
it is.  The sources expose a plain C interface (no PyTorch headers),
which keeps the build to seconds.

Nothing here falls back: a missing ``nvcc``, a failed build or a failed
launch raises.  The CPU path of each wrapper never reaches this module.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream are c_void_p,
# so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    # a, b, c, workspace, batch, M, N, K, a's (batch, row, column)
    # strides, b's, route, tile (TM, TN), splits, chunk, SMs, stream
    "repro_matmul_f32": [_P, _P, _P, _P, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _LL,
                         _I, _I, _I, _I, _I, _I, _P],
    "repro_matmul_bf16": [_P, _P, _P, _P, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL,
                          _I, _I, _I, _I, _I, _I, _P],
    # x, g, y, rows, d, x's row stride, eps, route, SMs, stream
    "repro_rmsnorm_f32": [_P, _P, _P, _I, _I, _LL, ctypes.c_float, _I, _I,
                          _P],
    "repro_rmsnorm_bf16": [_P, _P, _P, _I, _I, _LL, ctypes.c_float, _I, _I,
                           _P],
    # x, g, dy, dx, workspace, rows, d, x's and dy's row strides,
    # blocks, eps, route, stream
    "repro_rmsnorm_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I,
                              ctypes.c_float, _I, _P],
    "repro_rmsnorm_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I,
                               ctypes.c_float, _I, _P],
    # workspace, dg, blocks, d, stream
    "repro_rmsnorm_bwd_dg_f32": [_P, _P, _I, _I, _P],
    "repro_rmsnorm_bwd_dg_bf16": [_P, _P, _I, _I, _P],
    # q, k, v, o, B, S, H, KV, Dh, 9 strides, causal, window, scale, stream
    "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  ctypes.POINTER(_LL), _I, _I,
                                  ctypes.c_float, _P],
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   ctypes.POINTER(_LL), _I, _I,
                                   ctypes.c_float, _P],
    # ... the same, then the key tile of a compiled (Dh, BK) instance
    "repro_flash_attention_bf16_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, ctypes.POINTER(_LL), _I, _I,
                                         ctypes.c_float, _I, _P],
    # stage, q, k, v, o, dO, lse, D, dq, dk, dv, B, S, H, KV, Dh, causal,
    # window, scale, stream
    "repro_flash_attention_bwd_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                      ctypes.c_float, _P],
    "repro_flash_attention_bwd_bf16": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                       ctypes.c_float, _P],
    "repro_flash_attention_bwd_bf16_wgmma": [_I, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _I, _I, ctypes.c_float, _P],
    # r, k, v, w, u (fp32), y, S, B, T, H, D, columns per block, blocks
    # a head, threads a block, 12 strides, 16-byte copies, stream
    "repro_wkv6_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, ctypes.POINTER(_LL), _I, _P],
    "repro_wkv6_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, ctypes.POINTER(_LL), _I, _P],
    # stage, r, k, v, w, dy, u, ds, checkpoints, dr, dk, dv, dw, dv's,
    # the bonus's and du's partials, du, B, T, H, D, blocks a head,
    # threads a block, stream
    "repro_wkv6_bwd_f32": [_I, *[_P] * 16, _I, _I, _I, _I, _I, _I, _P],
    "repro_wkv6_bwd_bf16": [_I, *[_P] * 16, _I, _I, _I, _I, _I, _I, _P],
    # a, b, h, h_T, B, T, D, strips, threads a block, a's (batch, time)
    # strides, b's, 16-byte copies, stream
    "repro_rglru_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                        _LL, _I, _P],
    "repro_rglru_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                         _LL, _I, _P],
    # a, b, dh, dh_T, the fp32 checkpoint tensor (or null), da, db, B, T,
    # D, strips, threads a block, (batch, time) strides of a, b, dh,
    # 16-byte copies, stream
    "repro_rglru_bwd_f32": [*[_P] * 7, _I, _I, _I, _I, _I, *[_LL] * 6, _I,
                            _P],
    "repro_rglru_bwd_bf16": [*[_P] * 7, _I, _I, _I, _I, _I, *[_LL] * 6, _I,
                             _P],
    # x, w, out, E, C, D, F, x's (expert, row, column) strides, w's, then
    # (SIMT) rows and threads a block, x's K contiguous and 16-byte
    # copies, w's, stream
    "repro_grouped_matmul_f32": [_P, _P, _P, _I, _I, _I, _I,
                                 _LL, _LL, _LL, _LL, _LL, _LL,
                                 _I, _I, _I, _I, _I, _I, _P],
    "repro_grouped_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I,
                                  _LL, _LL, _LL, _LL, _LL, _LL,
                                  _I, _I, _I, _I, _I, _I, _P],
    # ... then (wgmma) C rows a tile and persistent blocks, stream
    "repro_grouped_matmul_bf16_wgmma": [_P, _P, _P, _I, _I, _I, _I,
                                        _LL, _LL, _LL, _LL, _LL, _LL,
                                        _I, _I, _P],
    # which (0 dx, 1 dw), x, w, dy, out, E, C, D, F, rows a tile,
    # persistent blocks, stream
    "repro_grouped_matmul_bwd_bf16_wgmma": [_I, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output of the build this process ran


def sources():
    """The translation units: each ``csrc/*.cu`` is compiled on its own."""
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The headers the sources include; hashed, never compiled alone."""
    return sorted(CSRC.glob("*.cuh"))


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
    for src in sorted(sources() + headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    global build_log
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = path.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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


_CURRENT = contextlib.nullcontext()


def on_device(index: int):
    """A context in which CUDA device ``index`` is current, for a launch:
    a no-op where it already is (the common case, and ~3 us cheaper)."""
    import torch
    return (_CURRENT if index == torch.cuda.current_device()
            else torch.cuda.device(index))


def current_stream(index: int) -> int:
    """The address of device ``index``'s current CUDA stream, as the C
    entries take it (without building a ``torch.cuda.Stream``)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (132 on an H100
    SXM), which the kernels size their grids by."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def tma_readable(t) -> bool:
    """Innermost stride 1, the others positive and 16-byte multiples (8
    bf16), the base 16-byte aligned: what a TMA tensor map of bf16 over
    the tensor ``t`` takes (``csrc/hopper.cuh``)."""
    s = t.stride()
    return (s[-1] == 1 and all(x > 0 and x % 8 == 0 for x in s[:-1])
            and t.data_ptr() % 16 == 0)


def dense(t):
    """``t`` contiguous with a 16-byte aligned base: ``t`` itself, or a
    copy.  What the backward kernels read: plain row-major tensors, 16-byte
    vectors and TMA boxes anywhere in them."""
    import torch
    return (t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format))


def refuse_grad(what: str, *tensors) -> None:
    """Raise where grad is enabled and an operand requires grad: a kernel
    without a backward kernel would return an output that cuts the graph,
    and a step would look like training and be wrong."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward kernel on the card: "
                           f"call it under torch.no_grad(), or on CPU "
                           f"tensors (the plain version differentiates)")


def refuse_dtensor(what: str, t) -> None:
    """Raise for a DTensor (a tensor laid out on a device mesh): its
    ``data_ptr()`` is its local shard's, which a kernel would read with
    the global shape.  DTensors reach a kernel as local shards, through
    ``core/on_mesh.py``."""
    import torch
    if type(t) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            raise TypeError(f"{what} got a DTensor: call it through "
                            f"repro_torch.core.on_mesh, which hands the "
                            f"kernel each rank's local shards")


# a C entry point returns a driver error as this plus its CUresult, a
# runtime error as its cudaError_t (csrc/hopper.cuh)
DRIVER_ERROR = 100000


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        kind, code = (("CUDA driver error", rc - DRIVER_ERROR)
                      if rc >= DRIVER_ERROR else ("CUDA error", rc))
        raise RuntimeError(f"{what} launch failed: {kind} {code} ({msg})")
