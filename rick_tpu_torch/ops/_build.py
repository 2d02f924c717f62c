"""Build and load the CUDA kernels of `rick_tpu_torch/csrc/`.

At first use, every `csrc/*.cu` is compiled into a shared library of its own
with a plain C interface, one `nvcc` process per source, all started
together, into one directory under `build/rick_tpu_torch/` at the repo root;
the libraries are loaded with `ctypes`.  No PyTorch header is included, so
the build takes seconds.  The directory's name carries a hash of the sources
and the flags: an edited source builds anew, an unchanged one loads the
existing files.

Every entry point takes its pointers and the CUDA stream as `void*`, launches
on the stream it is given, and returns `cudaGetLastError()`; `check()` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
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
    # g, y, bias (or null), out, n, C, inner, slope, scale, stream
    "rick_fused_bias_act_bwd": [_P, _P, _P, _P, _L, _I, _L, _F, _F, _P],
    # out, demod, noise, noise_weight, bias, y, B, C, HW, noise_batched, slope, scale, stream
    "rick_modconv_epilogue": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _P],
    # xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched,
    # k0, k1, k2, k3, use_act, slope, gain, stage (0 load, 1 conv, 2 blur,
    # 3 full), stream
    "rick_convt_blur_act_stage": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _I, _F, _F, _I, _P,
    ],
}

_lib: Optional[types.SimpleNamespace] = None
build_seconds: Optional[float] = None
build_log: str = ""


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_path() -> Path:
    """The directory of this build, named by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}"


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build() -> Path:
    """Compile one library per source, in parallel, unless a build of the
    same sources exists.  Returns the build's directory."""
    global build_seconds, build_log
    out = build_path()
    if out.exists():
        build_seconds = 0.0
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [
        (src, subprocess.Popen(nvcc_command(src, tmp / f"lib{src.stem}.so"), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for src in sources()
    ]
    logs, failed = [], []
    for src, proc in procs:
        logs.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        shutil.rmtree(tmp)
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    (tmp / "build.log").write_text(build_log)
    if out.exists():  # another process finished the same build first
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def lib() -> types.SimpleNamespace:
    """The kernels' entry points, by name, built at first call."""
    global _lib
    if _lib is None:
        handles = [ctypes.CDLL(str(p)) for p in sorted(build().glob("*.so"))]
        entries = {}
        for name, argtypes in SIGNATURES.items():
            fn = next(getattr(h, name) for h in handles if hasattr(h, name))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            entries[name] = fn
        _lib = types.SimpleNamespace(**entries)
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
