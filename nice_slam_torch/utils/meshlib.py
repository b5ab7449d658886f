"""Host mesh library: counterpart of the JAX package's ``utils/meshlib.py``.

Python surface over the port's own copy of the native mesh kernels
(``nice_slam_torch/csrc/mesh_kernels.cpp``: marching cubes and
tetrahedra, connected components, a BVH raycaster), built with ``g++``
on first use by ``ops/kernels.py``.  A failed build raises: there is no
numpy fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from nice_slam_torch.ops import kernels

_F = ctypes.POINTER(ctypes.c_float)
_L = ctypes.POINTER(ctypes.c_int64)
_bound: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The mesh-kernel library with its C signatures bound."""
    global _bound
    if _bound is not None:
        return _bound
    lib = kernels.library("mesh_kernels")
    mc = [_F, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
          _F, _F, ctypes.POINTER(_F), _L, ctypes.POINTER(_L), _L]
    for fn in (lib.marching_tetrahedra, lib.marching_cubes_classic):
        fn.restype = ctypes.c_int
        fn.argtypes = mc
    lib.mesh_components.restype = ctypes.c_int64
    lib.mesh_components.argtypes = [_F, ctypes.c_int64, _L, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int32), _F]
    lib.free_buffer.argtypes = [ctypes.c_void_p]
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [_F, ctypes.c_int64, _L, ctypes.c_int64]
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    lib.bvh_render_depth.argtypes = [
        ctypes.c_void_p, _F, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, _F]
    lib.bvh_cast_rays.argtypes = [ctypes.c_void_p, _F, _F, ctypes.c_int64, _F]
    _bound = lib
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


class MeshRaycaster:
    """BVH depth renderer over a triangle mesh.  CV pinhole convention:
    +z forward, x right, y down; depth = camera-space z."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        self._lib = _lib()
        # the BVH references these buffers: keep them alive
        self._verts = np.ascontiguousarray(verts, np.float32)
        self._tris = np.ascontiguousarray(tris, np.int64)
        self._handle = self._lib.bvh_build(
            _ptr(self._verts, _F), len(self._verts), _ptr(self._tris, _L),
            len(self._tris))

    def render_depth(self, c2w: np.ndarray, H: int, W: int, fx: float,
                     fy: float, cx: float, cy: float,
                     z_far: float = 20.0) -> np.ndarray:
        out = np.zeros((H, W), np.float32)
        c2w32 = np.ascontiguousarray(c2w, np.float32)
        self._lib.bvh_render_depth(self._handle, _ptr(c2w32, _F), H, W, fx, fy,
                                   cx, cy, z_far, _ptr(out, _F))
        return out

    def cast_rays(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        out = np.zeros((len(o),), np.float32)
        self._lib.bvh_cast_rays(self._handle, _ptr(o, _F), _ptr(d, _F), len(o),
                                _ptr(out, _F))
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bvh_free(self._handle)
            self._handle = None


def sample_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of ``n`` surface points."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        return verts[rng.integers(0, len(verts), n)]
    idx = rng.choice(len(tris), size=n, p=areas / total)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    a, b, c = v0[idx], v1[idx], v2[idx]
    return ((1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b
            + (r1 * r2)[:, None] * c)


def marching_cubes(field: np.ndarray, level: float, origin=(0.0, 0.0, 0.0),
                   spacing=(1.0, 1.0, 1.0), method: str = "mc",
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a (nx, ny, nz) scalar field at ``level``.

    ``method``: 'mc' = classic per-cube marching cubes with face-consistent
    ambiguity resolution; 'tets' = marching tetrahedra.  Returns
    (vertices (V, 3) float32 world coords, triangles (T, 3) int64); the
    triangles wind around the region where ``field < level``."""
    if method not in ("mc", "tets"):
        raise ValueError(f"method must be 'mc' or 'tets', got {method!r}")
    lib = _lib()
    field = np.ascontiguousarray(field, dtype=np.float32)
    origin_a = (ctypes.c_float * 3)(*[float(v) for v in origin])
    spacing_a = (ctypes.c_float * 3)(*[float(v) for v in spacing])
    verts_p, tris_p = _F(), _L()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    fn = lib.marching_cubes_classic if method == "mc" else lib.marching_tetrahedra
    rc = fn(_ptr(field, _F), field.shape[0], field.shape[1], field.shape[2],
            float(level), origin_a, spacing_a, ctypes.byref(verts_p),
            ctypes.byref(nv), ctypes.byref(tris_p), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("marching cubes failed")
    if nv.value == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
    tris = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy()
    lib.free_buffer(verts_p)
    lib.free_buffer(tris_p)
    return verts, tris


def components(verts: np.ndarray, tris: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Connected components by vertex connectivity: (per-triangle component
    ids (T,), per-component areas (C,))."""
    if len(tris) == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
    lib = _lib()
    verts32 = np.ascontiguousarray(verts, np.float32)
    tris64 = np.ascontiguousarray(tris, np.int64)
    comp = np.zeros((len(tris64),), np.int32)
    areas = np.zeros((len(tris64),), np.float32)
    n = lib.mesh_components(_ptr(verts32, _F), len(verts32), _ptr(tris64, _L),
                            len(tris64), _ptr(comp, ctypes.POINTER(ctypes.c_int32)),
                            _ptr(areas, _F))
    return comp, areas[:n].copy()


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with optional per-vertex uchar RGB."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    n_v, n_t = len(verts), len(tris)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {n_t}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n_v, dtype=[("v", np.float32, 3), ("c", np.uint8, 3)])
            rec["v"] = verts
            rec["c"] = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(verts.tobytes())
        face = np.zeros(n_t, dtype=[("n", np.uint8), ("i", np.int32, 3)])
        face["n"] = 3
        face["i"] = tris
        f.write(face.tobytes())


_PLY_TYPES = {"float": np.float32, "float32": np.float32, "double": np.float64,
              "uchar": np.uint8, "uint8": np.uint8, "int": np.int32}


def read_ply(path: str):
    """Read a PLY (binary little-endian or ascii) -> (verts, tris,
    colors or None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt, n_v, n_t, element, v_props = None, 0, 0, None, []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n_v, element = int(line.split()[-1]), "v"
            elif line.startswith(b"element face"):
                n_t, element = int(line.split()[-1]), "f"
            elif line.startswith(b"property") and element == "v":
                parts = line.split()
                v_props.append((parts[1].decode(), parts[2].decode()))
            elif line == b"end_header":
                break
        names = [n for _, n in v_props]
        if fmt == b"ascii":
            verts = np.zeros((n_v, 3), np.float32)
            colors = np.zeros((n_v, 3), np.uint8) if "red" in names else None
            for i in range(n_v):
                rec = dict(zip(names, f.readline().split()))
                verts[i] = [float(rec["x"]), float(rec["y"]), float(rec["z"])]
                if colors is not None:
                    colors[i] = [int(rec["red"]), int(rec["green"]), int(rec["blue"])]
            tris = np.zeros((n_t, 3), np.int64)
            for i in range(n_t):
                tris[i] = [int(v) for v in f.readline().split()[1:4]]
            return verts, tris, colors
        dt = np.dtype([(n, _PLY_TYPES[t]) for t, n in v_props])
        vdata = np.frombuffer(f.read(dt.itemsize * n_v), dtype=dt)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=-1).astype(np.float32)
        colors = None
        if "red" in names:
            colors = np.stack([vdata["red"], vdata["green"], vdata["blue"]], axis=-1)
        fdt = np.dtype([("n", np.uint8), ("i", np.int32, 3)])
        fdata = np.frombuffer(f.read(fdt.itemsize * n_t), dtype=fdt)
        return verts, fdata["i"].astype(np.int64), colors
