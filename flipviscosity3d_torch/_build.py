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
import threading
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "flip3d_kernels"

# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions round them, so the kernels and their references differ
# only in summation order.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
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


def _run(cmds: list) -> str:
    """Run the commands all at once; return their joined output, or raise
    naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}):\n{' '.join(cmd)}\n{log}")
    return "".join(logs)


@functools.cache
def build() -> dict:
    """Compile the library if it is not built yet: one nvcc per source, all
    started together, then one link. Returns {"path", "seconds", "log"};
    `log` holds nvcc's -Xptxas -v report (registers and spills per kernel)
    when this call compiled."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": "(cached)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                    for p, o in zip(sources, objs)])
        log += _run([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    return {"path": str(out), "seconds": seconds, "log": log}


# the slab pipeline's rank-threads may reach their first kernel together
_LOCK = threading.Lock()


@functools.cache
def _loaded() -> ctypes.CDLL:
    return ctypes.CDLL(build()["path"])


def _library() -> ctypes.CDLL:
    with _LOCK:
        return _loaded()


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


def count(fn) -> None:
    """Add one to the launch count of wrapper `fn` (thread-safe: the slab
    pipeline launches from several threads)."""
    with _LOCK:
        fn.launches += 1


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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the card that holds the CUDA tensor `t`."""
    index = t.device.index
    return _sm_count(index if index is not None
                     else torch.cuda.current_device())


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the caller takes the plain PyTorch version),
    False for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
