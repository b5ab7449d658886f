"""Build and load the port's native libraries (``nice_slam_torch/csrc/``).

A CUDA source (``*.cu``) is compiled by ``nvcc`` for ``sm_90a``; a host
source (``*.cpp``, the mesh kernels) by ``g++``.  Each becomes a shared
library with a plain C interface, built on first use into
``build/nice_slam_torch/`` at the checkout root (a directory
``.gitignore`` lists), named by the hash of the source so an edited
source is rebuilt.  Libraries are loaded with ``ctypes``.  A failed build
raises.  Nothing here runs at import time.  Loading is serialised by a
lock, so threads that first call a kernel together build it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nice_slam_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_longlong)  # a per-grid descriptor table
# C signatures of the CUDA libraries' entries: name -> argtypes (all return
# int, the launch's cudaGetLastError()); a host library's caller binds its
# own (utils/meshlib.py)
SIGNATURES = {
    "trilinear": {
        "trilinear_fwd": [_D, _I, _P, _I, _I, _P],
        "trilinear_bwd_dgrid": [_D, _I, _P, _I, _I, _P],
        "trilinear_bwd_dp": [_D, _I, _P, _P, _I, _I, _P],
    },
    "decoder_stage": {
        "decoder_fwd": [_D, _I, _I, _P, _P, _I, _I, _I, _P],
        "decoder_bwd": [_D, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
        "decoder_wgrad_sum": [_P, _I, _I, _P, _P],
        "decoder_fwd_smem": [_I, _I],
        "decoder_bwd_smem": [_I, _I],
        "decoder_kernel_info": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def sources() -> List[str]:
    """Names of every source in ``csrc/`` (CUDA and host)."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cpp")))


def _source(name: str) -> str:
    for ext in (".cu", ".cpp"):
        path = os.path.join(CSRC, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no source {name}.cu or {name}.cpp in {CSRC}")


def _so_path(src: str, name: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile_cmd(src: str, out: str) -> List[str]:
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host mesh kernels need a C++ "
                           "compiler on PATH")
    return [gxx, *GXX_FLAGS, src, "-o", out]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, one compiler process each, all started
    together.  Returns name -> library path; raises with the compiler
    output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    out: Dict[str, str] = {}
    for name in names:
        src = _source(name)
        so = _so_path(src, name)
        out[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((name, src, so, tmp, subprocess.Popen(
            _compile_cmd(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, src, so, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"build failed for {os.path.basename(src)}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, argtypes in SIGNATURES.get(name, {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return lib


class LaunchCounter:
    """Launches per kernel, counted where each wrapper launches its kernel:
    ``counts`` per kernel, ``by_stream`` per (kernel, CUDA stream handle)
    and ``by_device`` per (kernel, device index, stream handle).  The
    threaded schedules launch from several threads, so a lock keeps the
    counts exact.  ``reset`` clears the dicts in place."""

    def __init__(self, names: Iterable[str]):
        self.counts: Dict[str, int] = dict.fromkeys(names, 0)
        self.by_stream: Dict[Tuple[str, int], int] = {}
        self.by_device: Dict[Tuple[str, int, int], int] = {}
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            for k in self.counts:
                self.counts[k] = 0
            self.by_stream.clear()
            self.by_device.clear()

    def count(self, name: str, stream: int, device: Optional[int] = None) -> None:
        with self._lock:
            self.counts[name] += 1
            key = (name, stream)
            self.by_stream[key] = self.by_stream.get(key, 0) + 1
            if device is not None:
                key = (name, device, stream)
                self.by_device[key] = self.by_device.get(key, 0) + 1


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
