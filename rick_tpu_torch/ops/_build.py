"""Build and load the CUDA kernels of `rick_tpu_torch/csrc/`.

At first use, every `csrc/*.cu` is compiled into a shared library of its own
with a plain C interface, one `nvcc` process per source, all started
together, into one directory under `build/rick_tpu_torch/` at the repo root;
the libraries are loaded with `ctypes`.  No PyTorch header is included, so
the build takes seconds.  The directory's name carries a hash of the sources
and the flags: an edited source builds anew, an unchanged one loads the
existing files.  One process builds at a time (an `flock` on
`build/rick_tpu_torch/build.lock`, released when its holder exits): the
ranks of a torchrun launch wait for the first and load its build.

Every entry point takes its pointers and the CUDA stream as `void*`, launches
on the stream it is given, and returns `cudaGetLastError()`; `check()` raises
on a non-zero code.  `ptxas_report()` reads each kernel's registers and
spills from the build's log (`-Xptxas -v`).

`host_library()` builds a host C++ source of `csrc/` (`*.cpp`, no CUDA) with
g++ into a directory of its own beside the kernels', named by a hash of the
source and of every header it includes (`host_build_path`).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
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
    # the same, x bf16 (bias and y f32), and launch: null or int[3] that
    # receives (grid x, grid y, threads) of the launch
    "rick_fused_bias_act_bf16": [_P, _P, _P, _L, _I, _L, _F, _F, _P, _P],
    # x bf16 as rick_fused_bias_act_bf16, by the row-per-block design it
    # replaced (a yardstick for chip_smoke.py; no wrapper calls it)
    "rick_fused_bias_act_bf16_rows": [_P, _P, _P, _L, _I, _L, _F, _F, _P],
    # g, y, bias (or null), out, n, C, inner, slope, scale, stream
    "rick_fused_bias_act_bwd": [_P, _P, _P, _P, _L, _I, _L, _F, _F, _P],
    # out, demod, noise, noise_weight, bias, y, B, C, HW, noise_batched, slope, scale, stream
    "rick_modconv_epilogue": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _P],
    # the same, out, demod, noise and noise_weight bf16 (bias and y f32), and
    # launch as for rick_fused_bias_act_bf16
    "rick_modconv_epilogue_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _P, _P],
    # as rick_modconv_epilogue_bf16, by the row-per-block design it replaced
    "rick_modconv_epilogue_bf16_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _P],
    # grid x, grid y, threads, stream: an empty kernel (the launch floor)
    "rick_empty_launch": [_I, _I, _I, _P],
    # xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched,
    # k0, k1, k2, k3, use_act, slope, gain, stage (0 load, 1 conv, 2 blur,
    # 3 full), stream
    "rick_convt_blur_act_stage": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _I, _F, _F, _I, _P,
    ],
    # x, wt, s, demod, noise, noise_weight, bias, y, N, Cin, Cout, H, W,
    # noise_batched, slope, gain, stream
    "rick_modconv_act": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
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


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes while held."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build() -> Path:
    """Compile one library per source, in parallel, unless a build of the
    same sources exists.  Returns the build's directory."""
    global build_seconds, build_log
    out = build_path()
    with _build_lock():
        if out.exists():
            build_seconds = 0.0
            build_log = (out / "build.log").read_text()
            return out
        return _compile(out)


def _compile(out: Path) -> Path:
    global build_seconds, build_log
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
    os.replace(tmp, out)  # atomic: a reader without the lock sees all or nothing
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


def _demangle(names: List[str]) -> List[str]:
    """Readable kernel names (`kernel<3, 32>`), through c++filt where there is one."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, timeout=60).stdout
    readable = out.splitlines()
    if len(readable) != len(names):
        return names
    return [r.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0] for r in readable]


def ptxas_report(log: Optional[str] = None) -> List[dict]:
    """Per kernel of the build (`-Xptxas -v`): name, registers, spill stores
    and spill loads in bytes."""
    kernels: List[dict] = []
    for line in (build_log if log is None else log).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append(dict(name=m.group(1), registers=0, spill_stores=0, spill_loads=0))
        elif kernels and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
    for k, name in zip(kernels, _demangle([k["name"] for k in kernels])):
        k["name"] = name
    return kernels


def sass_counts(opcode: str) -> dict:
    """{kernel: number of SASS instructions starting with `opcode`} over the
    built libraries (`cuobjdump -sass`), e.g. "HGMMA" for the tensor cores'
    wgmma."""
    counts = {}
    tool = Path(nvcc_path()).with_name("cuobjdump")
    for so in sorted(build().glob("*.so")):
        out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True, check=True,
                             timeout=300).stdout
        name = None
        for line in out.splitlines():
            if m := re.search(r"Function : (\S+)", line):
                name = m.group(1)
                counts[name] = 0
            elif name and re.search(rf"\*/\s+(@!?U?P\w+\s+)?{opcode}\b", line):
                counts[name] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
# g++'s seconds per host source compiled by this process (a build found on
# disk adds nothing)
host_build_seconds: dict = {}


def included(src: Path) -> List[Path]:
    """The files that `src` includes with quotes, transitively, each found
    beside the file that includes it; `src` not among them."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop()
        for m in _INCLUDE.findall(cur.read_bytes()):
            p = (cur.parent / m.decode()).resolve()
            if p not in found:
                found.append(p)
                todo.append(p)
    return sorted(found)


def host_build_path(src: Path) -> Path:
    """The directory of `src`'s host build, named by a hash of the flags, the
    source and every header it includes, so that a header's edit builds
    anew."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    for p in included(src):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"host_{src.stem}_{h.hexdigest()[:16]}"


def host_build(src: Path) -> Optional[str]:
    """Build a host C++ source (no CUDA) with g++ into a directory of its own
    under `BUILD_DIR` (`host_build_path`), unless that build exists.
    Returns None, or why the build failed (g++'s output)."""
    out = host_build_path(src)
    with _build_lock():
        if out.exists():
            return None
        t0 = time.perf_counter()
        err = _compile_host(src, out, out / f"lib{src.stem}.so")
        if err is None:
            host_build_seconds[src.name] = time.perf_counter() - t0
        return err


def host_library(src: Path) -> ctypes.CDLL:
    """`src` built by `host_build` and loaded.  Apart from the nvcc build, so
    that it also runs where there is no CUDA toolkit; a failed build
    raises."""
    err = host_build(src)
    if err is not None:
        raise RuntimeError(err)
    return ctypes.CDLL(str(host_build_path(src) / f"lib{src.stem}.so"))


def _compile_host(src: Path, out: Path, so: Path) -> Optional[str]:
    gxx = shutil.which("g++")
    if gxx is None:
        return f"no g++ found: it is needed to build {src.name}"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    tmp.mkdir(parents=True)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp / so.name), str(src)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        shutil.rmtree(tmp)
        return f"g++ failed on {src.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
    os.replace(tmp, out)
    return None


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
