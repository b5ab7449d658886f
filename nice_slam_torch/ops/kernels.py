"""Build and load the port's CUDA kernels (``nice_slam_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``build/nice_slam_torch/``
at the checkout root (a directory ``.gitignore`` lists), named by the
hash of the source so an edited kernel is rebuilt.  Libraries are loaded
with ``ctypes``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nice_slam_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_longlong)  # a per-grid descriptor table
# C signatures of every exported entry: name -> argtypes (all return int,
# the launch's cudaGetLastError())
SIGNATURES = {
    "trilinear": {
        "trilinear_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "trilinear_bwd_dgrid": [_D, _I, _P, _I, _I, _P],
        "trilinear_bwd_dp": [_D, _I, _P, _P, _I, _I, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
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


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, one ``nvcc`` each, all started together.
    Returns name -> library path; raises with the compiler output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    out: Dict[str, str] = {}
    for name in names:
        so = _so_path(name)
        out[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
