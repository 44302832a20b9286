"""Builds and loads the port's CUDA kernels.

All kernels live in ``gi_raytracer_tpu_torch/csrc/*.cu`` (with the
device headers ``*.cuh`` they include).  At first use
they are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` process per
source, all started together, and linked into one shared library with a
plain C interface, under ``build/kernels/`` at the repository root (a
git-ignored directory), and loaded with ``ctypes``.  The library is rebuilt
when any source or header is newer than it.  Nothing here runs at import time.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream, and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code.

``launches`` counts kernel launches per kernel name.  Each wrapper adds
one where it launches its kernel, and nowhere else, so a run can show
that its main path went through the kernels.  ``plain_calls`` counts the
calls of each kernel's plain version under the same name, so a run on the
card can show that its main path never took one.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libgi_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()
KERNELS = ("intersect", "megakernel", "knn", "stream", "photon_round",
           "wave_inputs", "fog_march")

_lib = None
_VP, _F, _I, _U = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_uint
_D, _LL = ctypes.c_double, ctypes.c_longlong

# argtypes of every C entry point (csrc/*.cu); pointers and the stream are
# c_void_p so ctypes never cuts them to 32 bits
_SIGNATURES = {
    "gi_trace_launch": [_VP] * 8 + [_I, _I, _U, _F, _I, _I] + [_VP] * 5,
    "gi_trace_info": [_I, _VP],
    "gi_mega_launch": [_VP] * 10 + [_I, _I, _I, _I, _U, _F, _F, _I, _F, _F,
                                    _F, _I, _I, _I] + [_VP] * 5,
    "gi_mega_info": [_I, _VP],
    "gi_knn_launch": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                      _F, _F, _F, _F, _F, _F, _I, _VP, _VP, _VP, _VP, _VP],
    "gi_knn_info": [_VP],
    "gi_stream_launch": [_VP] * 9 + [_I, _I, _I, _U, _F, _I, _I]
    + [_VP] * 5,
    "gi_stream_info": [_I, _VP],
    "gi_photon_round_launch": [_VP] * 3 + [_I, _I, _F] + [_VP] * 7
    + [_I] * 5 + [_U, _U, _I, _F, _F, _VP, _VP],
    "gi_photon_round_info": [_I, _VP],
    "gi_wave_inputs_launch": [_VP] * 4 + [_I, _VP, _I, _I, _U, _F, _F, _F,
                                          _F] + [_VP] * 5,
    "gi_fog_march_launch": [_VP, _LL, _VP, _LL] + [_VP] * 4 + [_I, _U]
    + [_VP] * 4 + [_I] * 3 + [_F] * 4 + [_D, _I, _I] + [_VP] * 5,
    "gi_fog_march_info": [_I, _VP],
}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names the card and there
    is none: the port's entry points default to the card and never carry
    on on the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain versions on the CPU")
    return dev


def reset_launches():
    launches.clear()
    plain_calls.clear()


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def needs_build() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def _run_all(cmds) -> str:
    """Run the commands at once; returns their output, or raises naming
    each that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [" ".join(c) + "\n" + out
              for c, out, p in zip(cmds, outs, procs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def build(verbose: bool = False) -> float:
    """Compile csrc/*.cu into the shared library; returns seconds taken.
    Every source compiles in its own ``nvcc`` process, all at once; one
    more links the objects.  ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory, spills per kernel) and prints the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = [_nvcc()] + NVCC_FLAGS
    cu = [s for s in sources() if s.endswith(".cu")]
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
        out = _run_all([nvcc + (["-Xptxas", "-v"] if verbose else [])
                        + ["-I", CSRC, "-c", "-o", o, s]
                        for s, o in zip(cu, objs)])
        so = os.path.join(tmp, "lib.so")
        _run_all([nvcc + ["-shared", "-o", so] + objs])
        os.replace(so, LIB_PATH)
    if verbose:
        print(out, flush=True)
    return time.time() - t0


def lib():
    """The loaded kernel library (built first when missing or stale)."""
    global _lib
    if _lib is None:
        if needs_build():
            build()
        handle = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor):
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def require_shape(name: str, t: torch.Tensor, shape: tuple):
    """Raise unless ``t`` has ``shape`` (the kernels index by it)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
