"""Build and bind the port's CUDA C++ kernels (``admm_tpu_torch/csrc``).

At first use the ``.cu`` sources of the package are compiled with nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and linked into one shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so a changed source builds anew and an unchanged one
is loaded as it is.  The library is loaded with ``ctypes``.  nvcc is
looked for only when a build is needed, so this module imports where there
is none.

Kernels launch on PyTorch's current stream, allocate nothing and do not
synchronise; each C function returns ``cudaGetLastError()`` after its
launch, and a nonzero code raises here.  The callers (``ops/tridiag.py``,
``ops/gemv_pair.py``, ``ops/kernels.py``) check device, dtype, shape and
contiguity before they get here.
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
SOURCES = ("cr_solve.cu", "gemv_pair.cu", "zu_tail.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# name: (restype, argtypes) of each C function of the library.
_SIGNATURES = {
    "admm_cr_solve": (_I, (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P)),
    "admm_gemv_pair": (_I, (_I, _P, _I, _P, _I64, _P, _I64, _P, _P, _I, _I, _I, _P)),
    "admm_resident_lasso_blocks": (_I, (_I, _I, ctypes.POINTER(_I))),
    "admm_resident_lasso": (_I, (_P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P,
                                 ctypes.c_float, ctypes.c_float, _I, _I, _I, _P)),
    "admm_zu": (_I, (_I, _P, _P, _P, _P, _P, _I64, _I, _P)),
    "admm_zu_tail": (_I, (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _D, _D, _D, _I,
                          _P, _I64, _I, _I, _P)),
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


def _run_all(cmds):
    """Run the commands at once and wait for all of them; raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}: "
                               f"{' '.join(cmd)}\n{out}")


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
        stem = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{stem}.{p.stem}.o" for p in paths]
        nvcc = _nvcc()
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                      for p, o in zip(paths, objs)])
            tmp = so.with_name(f"{stem}.tmp")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
            os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def cr_solve(b, work, xs, y, x, stacks, n, levels, plan, scratch):
    """Launch K4 (``csrc/cr_solve.cu``) on the current stream, on the tiles
    of ``plan`` (``ops/tridiag.TilePlan``).  ``b``, ``work`` and ``x`` are
    ``(B, N)``, ``xs`` and ``y`` ``(B, M)``; b/xs/y/x/work are None where
    the phase does not use them.  ``stacks`` is ``compact_stacks``'s
    (alphas, betas, a_lv, c_lv, d_lv); ``n`` the unpadded size;
    ``scratch`` None (shared memory) or ``B * tiles * rows`` elements.
    All tensors are contiguous, of one float dtype, on one CUDA device."""
    lib = library()
    out = x if x is not None else work
    B, N = out.shape
    err = lib.admm_cr_solve(
        int(out.dtype == torch.float64), _ptr(b), _ptr(work), _ptr(xs),
        _ptr(y), _ptr(x), *(_ptr(t) for t in stacks), B, N, n, levels, plan.C,
        plan.R, plan.tiles, plan.threads, _ptr(scratch),
        torch.cuda.current_stream(out.device).cuda_stream)
    _check(lib, err, "cr_solve")


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({lib.admm_cuda_error_string(err).decode()})")


def gemv_pair(b, E, Dt, t, x, K):
    """Launch K2 (``csrc/gemv_pair.cu``) on the current stream: K steps of
    ``x = Dt (E b)``.  ``E`` ``(m, n)`` and ``Dt`` ``(n, m)`` are of one
    stream dtype (float32 or bfloat16) with unit column stride; ``b``
    ``(n,)`` is contiguous, in the stream dtype or float32; ``t`` ``(m,)``
    and ``x`` ``(n,)`` are contiguous float32.  All on one CUDA device."""
    lib = library()
    m, n = E.shape
    err = lib.admm_gemv_pair(
        int(E.dtype == torch.bfloat16), b.data_ptr(), int(b.dtype == torch.float32),
        E.data_ptr(), E.stride(0), Dt.data_ptr(), Dt.stride(0), t.data_ptr(),
        x.data_ptr(), m, n, K, torch.cuda.current_stream(b.device).cuda_stream)
    _check(lib, err, "gemv_pair")


def resident_lasso_blocks(m, n):
    """The number of blocks K3 launches for an (m, n) problem on the
    current device (its ``partial`` scratch holds two floats per block)."""
    lib = library()
    blocks = ctypes.c_int(0)
    _check(lib, lib.admm_resident_lasso_blocks(m, n, ctypes.byref(blocks)),
           "resident_lasso")
    return blocks.value


def resident_lasso(z, u, Dts, E, Dt, t, partial, hist, rho, kappa, K):
    """Launch K3 (``csrc/gemv_pair.cu``) on the current stream: K fat-LASSO
    steps, ``z`` and ``u`` updated in place, ``hist`` ``(K, 2)`` written.
    Every tensor is float32 on one CUDA device; ``E`` ``(m, n)`` and ``Dt``
    ``(n, m)`` have unit column stride, the rest is contiguous."""
    lib = library()
    m, n = E.shape
    err = lib.admm_resident_lasso(
        z.data_ptr(), u.data_ptr(), Dts.data_ptr(), E.data_ptr(), E.stride(0),
        Dt.data_ptr(), Dt.stride(0), t.data_ptr(), partial.data_ptr(),
        hist.data_ptr(), rho, kappa, m, n, K,
        torch.cuda.current_stream(z.device).cuda_stream)
    _check(lib, err, "resident_lasso")


def zu(x, u, t, z, unew, blocks):
    """Launch K1's z/u mode (``csrc/zu_tail.cu``) on the current stream:
    ``z`` and ``unew`` from ``x``, ``u`` and the 0-d ``t``, on ``blocks``
    blocks (``ops/kernels.zu_blocks``).  All contiguous, of one float
    dtype, on one CUDA device."""
    lib = library()
    err = lib.admm_zu(int(x.dtype == torch.float64), x.data_ptr(), u.data_ptr(),
                      t.data_ptr(), z.data_ptr(), unew.data_ptr(), x.numel(), blocks,
                      torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, err, "zu")


def zu_tail(x_new, x, z, u, lam, rho, state, hist, perr_abs, derr_abs, reltol, flags,
            scratch, blocks, cluster):
    """Launch K1b, the tail mode of ``csrc/zu_tail.cu``, on the current
    stream: one step's tail from ``x_new``, with ``x``, ``z``, ``u`` and
    ``state`` (3 int64) updated in place and one column of ``hist``
    ``(rows, N + 1)`` written, on ``blocks`` blocks that reduce in one
    cluster when ``cluster`` is set (``ops/kernels.zu_tail_plan``).
    ``scratch`` is ``ops/kernels.zu_tail_scratch``'s.  Float tensors of one
    dtype, all contiguous on one CUDA device."""
    lib = library()
    err = lib.admm_zu_tail(
        int(x.dtype == torch.float64), x_new.data_ptr(), x.data_ptr(), z.data_ptr(),
        u.data_ptr(), lam.data_ptr(), rho.data_ptr(), state.data_ptr(), hist.data_ptr(),
        hist.shape[1], hist.shape[1] - 1, perr_abs, derr_abs, reltol, flags,
        scratch.data_ptr(), x.numel(), blocks, int(cluster),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, err, "zu_tail")
