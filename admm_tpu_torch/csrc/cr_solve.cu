// K4 for Hopper: the b-phase of masked cyclic reduction for a batch of
// right-hand sides of one fixed tridiagonal system.
//
// Replaces experiments/pallas_cr_kernel.py::cr_solve_pallas (the Pallas TPU
// kernel _kernel, which runs every level of the solve in one call with the
// right-hand sides and all coefficient stacks resident in VMEM).
//
// What bounds it on this card: latency, not bytes or flops.  A solve is
// 2*L dependent levels (L = log2(N + 1)), each waiting on the one before.
// Level l updates only N / 2^(l+1) rows, so past the first few levels a
// level is a handful of L2 round trips and a barrier.  One lane of the
// batch is one system, so at B = 1 the solve runs on 1 of the 132 SMs, and
// each level moves few bytes from L2.
//
// What the design does about that:
//   * one CTA per lane (blockIdx.x = lane), so B = 128 fills 128 SMs and
//     the lanes never synchronise with each other;
//   * all levels inside the block, with one __syncthreads() between levels
//     in place of a kernel launch per level (the plain PyTorch version
//     launches about seven kernels per level);
//   * only the active rows are visited: at level l a strided loop over j
//     computes its row i directly, so level l does N / 2^(l+1) updates,
//     not N, and no mask stack is read;
//   * the update is in place.  Forward level l writes rows i = 2s-1 mod 2s
//     (s = 2^l) and reads rows i +- s = s-1 mod 2s, which that level does
//     not write; back substitution writes rows s-1 mod 2s and reads rows
//     2s-1 mod 2s, set at deeper levels or by the dense tail.  So no level
//     races with itself;
//   * the lane's working rows and solution live in global memory (L2 holds
//     them: about 1 MB a lane at n = 65536 in f32), so any n works.
//     Shared-memory staging and clusters are left for later.
//
// With a hybrid dense tail the call is split: the forward launch runs k
// levels and gathers the level-k stratum y into a contiguous (B, M)
// buffer; the caller applies the dense inverse with one torch.matmul; the
// back-substitution launch scatters that solution onto its stratum and
// runs the k levels back.
//
// Rounding is that of the plain version (ops/tridiag.py::_cr_solve_torch)
// bit for bit: b - alpha*up - beta*dn in that order and
// (b - a*x_{i-s} - c*x_{i+s}) / d with an IEEE division, every operation
// rounded on its own (the __*_rn intrinsics keep nvcc from contracting a
// multiply and a subtract into an FMA).  A neighbour past either end reads
// as +0 and still goes through the arithmetic, as the plain version's
// zero-filled shifts do, so even signed zeros agree.  Inactive rows are
// never touched, which is what the plain version's torch.where keeps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

// One block per lane.  Phases run as their pointers are given:
//   b != nullptr: copy the lane's b into work and run `levels` forward
//                 levels on it; then, if y != nullptr, gather the level-k
//                 stratum (rows st-1 :: st, st = 2^levels) into y;
//   x != nullptr: if xs != nullptr, scatter xs onto the stratum of x; then
//                 run `levels` back-substitution levels from work into x.
// The stacks are (levels, N) row-major; b, work, x are (B, N); y, xs (B, M)
// with M = (N + 1) / st - 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_kernel(const T* __restrict__ b, T* work, const T* __restrict__ xs,
          T* __restrict__ y, T* x,
          const T* __restrict__ alphas, const T* __restrict__ betas,
          const T* __restrict__ a_lv, const T* __restrict__ c_lv,
          const T* __restrict__ d_lv, int N, int levels) {
  const int64_t lane = blockIdx.x;
  const int st = 1 << levels;
  const int M = (N + 1) / st - 1;
  T* w = work + lane * N;

  if (b != nullptr) {
    const T* bl = b + lane * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) w[i] = bl[i];
    __syncthreads();
    for (int l = 0; l < levels; ++l) {
      const int s = 1 << l;
      const int active = ((N + 1) >> (l + 1)) - 1;
      const T* al = alphas + static_cast<int64_t>(l) * N;
      const T* be = betas + static_cast<int64_t>(l) * N;
      for (int j = threadIdx.x; j < active; j += blockDim.x) {
        const int i = (j + 1) * 2 * s - 1;
        const T up = w[i - s];
        const T dn = (i + s < N) ? w[i + s] : T(0);
        w[i] = sub(sub(w[i], mul(al[i], up)), mul(be[i], dn));
      }
      __syncthreads();
    }
    if (y != nullptr) {
      T* yl = y + lane * M;
      for (int j = threadIdx.x; j < M; j += blockDim.x) yl[j] = w[(j + 1) * st - 1];
    }
  }

  if (x != nullptr) {
    T* xl = x + lane * N;
    if (xs != nullptr) {
      const T* xsl = xs + lane * M;
      for (int j = threadIdx.x; j < M; j += blockDim.x) xl[(j + 1) * st - 1] = xsl[j];
      __syncthreads();
    }
    for (int l = levels - 1; l >= 0; --l) {
      const int s = 1 << l;
      const int active = (N + 1) >> (l + 1);
      const T* a = a_lv + static_cast<int64_t>(l) * N;
      const T* c = c_lv + static_cast<int64_t>(l) * N;
      const T* d = d_lv + static_cast<int64_t>(l) * N;
      for (int j = threadIdx.x; j < active; j += blockDim.x) {
        const int i = j * 2 * s + s - 1;
        const T xm = (i >= s) ? xl[i - s] : T(0);
        const T xp = (i + s < N) ? xl[i + s] : T(0);
        xl[i] = div(sub(sub(w[i], mul(a[i], xm)), mul(c[i], xp)), d[i]);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* b, void* work, const void* xs, void* y, void* x,
           const void* alphas, const void* betas, const void* a_lv,
           const void* c_lv, const void* d_lv, int64_t lanes, int N,
           int levels, cudaStream_t stream) {
  if (lanes > 0) {
    cr_kernel<T><<<static_cast<unsigned>(lanes), kThreads, 0, stream>>>(
        static_cast<const T*>(b), static_cast<T*>(work),
        static_cast<const T*>(xs), static_cast<T*>(y), static_cast<T*>(x),
        static_cast<const T*>(alphas), static_cast<const T*>(betas),
        static_cast<const T*>(a_lv), static_cast<const T*>(c_lv),
        static_cast<const T*>(d_lv), N, levels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes by admm_tpu_torch/ops/_cuda.py.
// f64 selects double (else float).  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int admm_cr_solve(int f64, const void* b, void* work,
                             const void* xs, void* y, void* x,
                             const void* alphas, const void* betas,
                             const void* a_lv, const void* c_lv,
                             const void* d_lv, int64_t lanes, int N,
                             int levels, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(b, work, xs, y, x, alphas, betas, a_lv, c_lv,
                              d_lv, lanes, N, levels, s)
             : launch<float>(b, work, xs, y, x, alphas, betas, a_lv, c_lv,
                             d_lv, lanes, N, levels, s);
}

extern "C" const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
