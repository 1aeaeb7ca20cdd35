"""Where a step of K2 spends its time: per-block timestamps.

Builds a copy of ``csrc/gemv_pair.cu`` that reads the card's global timer
(``%globaltimer``) on thread 0 of every block at the boundaries of each
product of a step (entering it, vector staged, first row landed, rows
done, next rows issued, past the grid barrier), runs K = 8 steps at
(1500, 5000) in f32 and bf16, and prints each interval's mean and max over
the blocks, for steps 2-7.  The copy is built under ``build/kernels/`` and
used by nothing else.  Needs a CUDA device and nvcc.

Run: ``python -m admm_tpu_torch.experiments.gemv_pair_stamps``.
"""

import ctypes
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops.gemv_pair import aligned_rows
from .gemv_pair_probe import make_operands

SHAPE = (1500, 5000)
K = 8
POINTS = ("enter", "stage", "first row", "rows", "drain", "issue next", "barrier")

_STAMP = r'''
__device__ unsigned long long g_stamps[1024 * 16 * 8];
__shared__ int s_slot;
__device__ __forceinline__ void stamp(int p) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[(blockIdx.x * 16 + s_slot) * 8 + p] = t;
  }
}
'''
_EXPORT = r'''
extern "C" int stamps_copy(void* host, int nbytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, nbytes));
}
'''
# (text in csrc/gemv_pair.cu, the same text with timestamps)
_EDITS = (
    ("    if (sp.r0 == sp.r1) return;  // block-uniform\n",
     "    if (sp.r0 == sp.r1) return;  // block-uniform\n    stamp(1);\n"),
    ("      __syncthreads();\n    }\n\n    for (int i = 0; i < sp.per_group; ++i) {",
     "      __syncthreads();\n    }\n    stamp(2);\n\n    for (int i = 0; i < sp.per_group; ++i) {"),
    ("        __pipeline_wait_prior(kDepth - 1);  // row i's copies have landed\n",
     "        __pipeline_wait_prior(kDepth - 1);  // row i's copies have landed\n"
     "        if (i == 0) stamp(3);\n"),
    ("    if (vec) __pipeline_wait_prior(0);  // the trailing empty groups\n  }\n};",
     "    stamp(4);\n    if (vec) __pipeline_wait_prior(0);  // the trailing empty groups\n  }\n};"),
    ("  pa.prefetch(ring);\n  for (int k = 0; k < K; ++k) {\n",
     "  pa.prefetch(ring);\n  for (int k = 0; k < K; ++k) {\n"
     "    if (threadIdx.x == 0) s_slot = 2 * (k & 7);\n    __syncthreads();\n    stamp(0);\n"),
    ("    pb.prefetch(ring);\n    grid.sync();\n    pb.run(",
     "    stamp(5);\n    pb.prefetch(ring);\n    stamp(6);\n    grid.sync();\n    stamp(7);\n"
     "    if (threadIdx.x == 0) s_slot = 2 * (k & 7) + 1;\n    __syncthreads();\n    stamp(0);\n"
     "    pb.run("),
    ("    if (k + 1 < K) {\n      pa.prefetch(ring);\n      grid.sync();\n    }\n",
     "    stamp(5);\n    if (k + 1 < K) {\n      pa.prefetch(ring);\n      stamp(6);\n"
     "      grid.sync();\n    }\n    stamp(7);\n"),
)


def build():
    """The instrumented library, built under build/kernels/."""
    src = (_cuda.CSRC / "gemv_pair.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + _STAMP, 1)
    for old, new in _EDITS:
        if old not in src:
            raise SystemExit(f"gemv_pair_stamps: csrc/gemv_pair.cu no longer has {old!r}")
        src = src.replace(old, new)
    out = _cuda.BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gemv_pair_stamps.cu").write_text(src + _EXPORT)
    so = out / "libgemv_pair_stamps.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(out / "gemv_pair_stamps.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.admm_gemv_pair.restype = ctypes.c_int
    lib.admm_gemv_pair.argtypes = _cuda._SIGNATURES["admm_gemv_pair"][1]
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gemv_pair_stamps: no CUDA device is visible")
    lib = build()
    dev = torch.device("cuda")
    m, n = SHAPE
    print(f"device: {torch.cuda.get_device_name(dev)}; ({m}, {n}), K={K}; ns per "
          "interval, mean / max over blocks, steps 2-6")
    for dtype in (torch.float32, torch.bfloat16):
        b, E, Dt = make_operands(m, n, dev, dtype)
        E, Dt = aligned_rows(E), aligned_rows(Dt)
        t = torch.empty(m, device=dev)
        x = torch.empty(n, device=dev)
        for _ in range(3):
            err = lib.admm_gemv_pair(int(dtype == torch.bfloat16), b.data_ptr(), 0,
                                     E.data_ptr(), E.stride(0), Dt.data_ptr(), Dt.stride(0),
                                     t.data_ptr(), x.data_ptr(), m, n, K,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"gemv_pair_stamps: launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        buf = np.zeros(1024 * 16 * 8, np.uint64)
        if lib.stamps_copy(ctypes.c_void_p(buf.ctypes.data), buf.nbytes):
            raise SystemExit("gemv_pair_stamps: reading the timestamps failed")
        blocks = int(np.count_nonzero(buf.reshape(1024, 16 * 8).any(axis=1)))
        st = buf[: blocks * 128].reshape(blocks, 16, 8).astype(np.int64)
        for phase, name in ((0, "E b"), (1, "D^T t")):
            a = st[:, [2 * k + phase for k in range(2, 7)], :]
            spans = [a[:, :, p + 1] - a[:, :, p] for p in range(7)]
            print(f"  {str(dtype):15s} {name:6s} ({blocks} blocks): " + "  ".join(
                f"{label} {v.mean():.0f}/{v.max():.0f}" for label, v in zip(POINTS, spans)))


if __name__ == "__main__":
    main()
