"""The port's native (C++) host library: the binned-SAH BVH builder and the
OBJ parser, bound with ``ctypes``.

The port's own copies of ``gi_raytracer_tpu/native/*.cpp``.  At first use
they are compiled with ``g++ -O3 -march=native -shared -fPIC`` (the JAX
package's flags, so the SAH cost sums round alike and both packages build
the same tree) into ``build/native/libgi_native.so`` at the repository
root, a git-ignored directory; nothing is written next to the sources.  The
library is rebuilt when a source is newer than it.  When it cannot be
built, :func:`lib` raises: callers never fall back quietly, because the
fallback (the numpy median split) orders the triangles differently.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "bvh_builder.cpp"),
           os.path.join(_DIR, "obj_loader.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
LIB_PATH = os.path.join(BUILD_DIR, "libgi_native.so")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_lib = None


def _needs_build() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in SOURCES)


def build() -> None:
    """Compile the sources into ``LIB_PATH`` (atomically: a temporary file
    renamed into place, so concurrent builders never see half a library)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's native BVH builder "
                           "needs a C++ compiler (or pass use_native=False "
                           "for the numpy median split)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [cxx] + CXX_FLAGS + ["-o", tmp] + SOURCES
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError("native build failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, LIB_PATH)


def lib():
    """The loaded native library (built first when missing or stale)."""
    global _lib
    with _LOCK:
        if _lib is None:
            if _needs_build():
                build()
            h = ctypes.CDLL(LIB_PATH)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            h.gi_build_bvh.restype = ctypes.c_int32
            h.gi_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32,
                                       ctypes.c_int32, f32p, f32p, i32p,
                                       i32p, i32p, i32p]
            h.gi_obj_parse.restype = ctypes.c_int32
            h.gi_obj_parse.argtypes = [ctypes.c_char_p] + \
                [ctypes.POINTER(ctypes.c_int32)] * 4
            h.gi_obj_fetch.argtypes = [f32p, f32p, f32p, i32p, i32p, i32p]
            h.gi_obj_free.argtypes = []
            _lib = h
        return _lib


def build_bvh_native(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int):
    """Binned-SAH BVH over per-primitive AABBs (P > 0); the same arrays as
    ``scene.bvh.build_bvh`` (node boxes from float32, as float64)."""
    from ..scene.bvh import BVHArrays

    n = len(pmin)
    if n == 0:
        raise ValueError("build_bvh_native needs at least one primitive")
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_idx = np.empty(n, np.int32)
    nn = lib().gi_build_bvh(np.ascontiguousarray(pmin, np.float32),
                            np.ascontiguousarray(pmax, np.float32),
                            n, leaf_size, node_min, node_max, skip, first,
                            count, prim_idx)
    if nn <= 0:
        raise RuntimeError(f"gi_build_bvh failed ({nn})")
    return BVHArrays(node_min[:nn].astype(np.float64),
                     node_max[:nn].astype(np.float64),
                     skip[:nn], first[:nn], count[:nn], prim_idx)


def load_obj_native(path: str):
    """Raw OBJ arrays (v, vt, vn, fv, ft, fn): float32 vertex, uv and normal
    tables and per-corner 1-based int32 indices (0 = absent; negative =
    relative), three corners per fan triangle."""
    h = lib()
    c = [ctypes.c_int32() for _ in range(4)]
    with _LOCK:
        if h.gi_obj_parse(os.fsencode(path),
                          *[ctypes.byref(x) for x in c]) != 0:
            raise OSError(f"cannot read OBJ file {path!r}")
        n_v, n_vt, n_vn, n_corners = (x.value for x in c)
        v = np.empty((max(n_v, 1), 3), np.float32)
        vt = np.empty((max(n_vt, 1), 2), np.float32)
        vn = np.empty((max(n_vn, 1), 3), np.float32)
        fv = np.empty(max(n_corners, 1), np.int32)
        ft = np.empty(max(n_corners, 1), np.int32)
        fn = np.empty(max(n_corners, 1), np.int32)
        h.gi_obj_fetch(v, vt, vn, fv, ft, fn)
        h.gi_obj_free()
    return (v[:n_v], vt[:n_vt], vn[:n_vn],
            fv[:n_corners], ft[:n_corners], fn[:n_corners])
