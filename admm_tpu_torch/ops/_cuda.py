"""Build and bind the port's CUDA C++ kernels (``admm_tpu_torch/csrc``).

At first use the ``.cu`` sources of the package are compiled with nvcc for
Hopper (``sm_90a``) into one shared library with a plain C interface,
under ``build/kernels/`` at the root of the checkout, named by a hash of
the sources and flags, so a changed source builds anew and an unchanged
one is loaded as it is.  The library is loaded with ``ctypes``.  nvcc is
looked for only when a build is needed, so this module imports where there
is none.

Kernels launch on PyTorch's current stream, allocate nothing and do not
synchronise; each C function returns ``cudaGetLastError()`` after its
launch, and a nonzero code raises here.  The callers (``ops/tridiag.py``)
check device, dtype, shape and contiguity before they get here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("cr_solve.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# name: (restype, argtypes) of each C function of the library.
_SIGNATURES = {
    "admm_cr_solve": (_I, (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I64, _I, _I, _P)),
    "admm_cuda_error_string": (ctypes.c_char_p, (_I,)),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "admm_tpu_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
        "it is needed to build the CUDA kernels")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    paths = [CSRC / name for name in SOURCES]
    digest = hashlib.sha256()
    for p in paths:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libadmm_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}: "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def cr_solve(b, work, xs, y, x, stacks, levels):
    """Launch K4 (``csrc/cr_solve.cu``) on the current stream.  ``b``,
    ``work`` and ``x`` are ``(B, N)``, ``xs`` and ``y`` ``(B, M)``, any of
    b/xs/y/x may be None to skip its phase; ``stacks`` is (alphas, betas,
    a_lv, c_lv, d_lv), each ``(levels, N)``.  All tensors are contiguous,
    of one float dtype, on one CUDA device."""
    lib = library()
    B, N = work.shape
    err = lib.admm_cr_solve(
        int(work.dtype == torch.float64), _ptr(b), _ptr(work), _ptr(xs),
        _ptr(y), _ptr(x), *(_ptr(t) for t in stacks), B, N, levels,
        torch.cuda.current_stream(work.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cr_solve kernel launch failed: CUDA error {err} "
                           f"({lib.admm_cuda_error_string(err).decode()})")
