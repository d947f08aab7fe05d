"""Builds the CUDA kernels of csrc/ into one shared library and loads it.

The kernels have a plain C interface and are bound with ctypes: nvcc compiles
every csrc/*.cu for sm_90a into build/flip3d_kernels/libflip3d_<hash>.so at
the root of the checkout, the first time a CUDA tensor reaches a kernel. The
file name carries a hash of the sources and flags, so a stale library is
never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "flip3d_kernels"

# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions round them, so the kernels and their references differ
# only in summation order.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of flipviscosity3d_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libflip3d_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> dict:
    """Compile the library if it is not built yet. Returns
    {"path", "seconds", "log"}; `log` holds nvcc's -Xptxas -v report
    (registers and spills per kernel) when this call compiled."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": "(cached)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in SRC_DIR.glob("*.cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": log}


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(build()["path"])


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


@functools.cache
def function(name: str, argtypes: tuple):
    """The C function `name` of the library, with its argtypes declared.
    Every C entry point returns cudaGetLastError() after its launch."""
    fn = getattr(_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, *args) -> None:
    """Call one C entry point on the current stream (appended as the last
    argument) and raise if the launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    err = function(name, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (one dtype
    or a tuple of them) and, if given, `shape`."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the caller takes the plain PyTorch version),
    False for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
