"""Build and load the CUDA kernels of `rick_tpu_torch/csrc/`.

At first use, every `csrc/*.cu` is compiled by ONE `nvcc` call into a shared
library with a plain C interface under `build/rick_tpu_torch/` at the repo
root, and loaded with `ctypes`.  No PyTorch header is included, so the build
takes seconds.  The library's file name carries a hash of the sources and the
flags: an edited source builds anew, an unchanged one loads the existing file.

Every entry point takes its pointers and the CUDA stream as `void*`, launches
on the stream it is given, and returns `cudaGetLastError()`; `check()` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rick_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see the .cu files)
SIGNATURES = {
    # x, bias, y, n, C, inner, slope, scale, stream
    "rick_fused_bias_act": [_P, _P, _P, _L, _I, _L, _F, _F, _P],
    # out, demod, noise, noise_weight, bias, y, B, C, HW, noise_batched, slope, scale, stream
    "rick_modconv_epilogue": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _P],
    # xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched,
    # k0, k1, k2, k3, use_act, slope, gain, stream
    "rick_convt_blur_act": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _I, _F, _F, _P,
    ],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librick_kernels_{h.hexdigest()[:16]}.so"


def nvcc_command(out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    (BUILD_DIR / "build.log").write_text(build_log)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
