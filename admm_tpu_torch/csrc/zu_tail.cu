// K1 and K1b for Hopper: the fused z-prox + dual update of the ADMM step,
// alone (z/u mode) or with the whole engine tail of the step (tail mode).
// One kernel, zu_tail_kernel<T, kTail>, in f32 and f64.
//
// The z/u mode replaces admm_tpu/ops/kernels.py::_fused_pallas (the Pallas
// TPU kernel `_kernel` over (rows, 128) tiles):
//     v = x + u;   z = sign(v) max(|v| - t, 0);   u' = (u + x) - z
// out of place, with t read through a device pointer.
//
// The tail mode (K1b) has no Pallas counterpart.  It is the same pass plus
// the XLA ops that admm_tpu's engine runs after it for the splitting
// A = I, B = -I, c = 0 under alg 0, no relaxation, the standard stop
// (admm_tpu/engine.py:392-445, 606-711, 792-799), which XLA fused into a
// few ops on the TPU and which took ~50 launches a step in the port:
//     frozen = done | (k >= N)                  (the unroll freeze)
//     t = lam / rho;  z', u'' from x_new and u as above
//     pnorm = ||x_new - z'||        dnorm = ||rho (z' - z)||
//     perr = sqrt(n) abstol + reltol max(||x_new||, ||z'||)
//     derr = sqrt(n) abstol + reltol ||rho u''||
//     diverged_i = nanguard & !isfinite(pnorm)
//     stop = !domaxiters & pnorm < perr & dnorm < derr
//     hist[:4, frozen ? N : k] = (pnorm, dnorm, perr, derr)
//     unless frozen: x, z, u = x_new, z', u''; k += 1;
//                    done = stop | diverged_i; diverged |= diverged_i
// with dnorm = derr = NaN and no dual test under nodualerror.  ||c|| = 0
// drops out of perr: max(norm, 0) is the norm, and NaN stays NaN.  x, z
// and u are updated in place, each element read and written by one thread
// (the engine hands the kernel its own copies).  k, done and diverged live
// in one int64 device tensor and lam and rho in 0-d device tensors, so the
// launch takes no value from the host and a captured CUDA graph can replay
// it.
//
// What bounds it on this card: neither bytes nor operations.  At the
// headline's n = 5000 in f32 the tail moves 120 kB (x_new, z, u read;
// x, z, u written), 0.036 us at 3.35 TB/s, and a launch costs more than
// that on its own; the generic engine tail takes ~50 launches a step, each
// issued by the host (PERF.md).  What the design does about that:
//   * one launch for the whole tail: a few blocks of kThreads threads each
//     take 16 bytes of every vector per loop trip (a masked scalar loop
//     takes the ragged end, and vectors off 16-byte boundaries);
//   * each thread sums its five squares in order, then a block adds its
//     threads' sums in a fixed order (warp shuffles down to lane 0, then
//     one thread over the warps) and writes one partial per sum;
//   * a grid of at most kMaxCluster blocks (n <= 8192 in f32, the
//     headline's 5000 included) runs as one thread-block cluster: each
//     block leaves its partials in its shared memory, a cluster barrier,
//     then block 0 reads them in block order through distributed shared
//     memory and forms the four norms and the flags, writes the history and
//     the state; a second barrier keeps every block's shared memory alive
//     until block 0 has read it;
//   * a larger grid writes its partials to global scratch, and the last
//     block to finish, found by a ticket (__threadfence, then atomicAdd),
//     adds them in block order and does the same, then sets the ticket
//     back to 0 for the next launch;
//   * no grid-wide barrier and no second launch; every launch on the same
//     inputs gives the same bits;
//   * every block reads k and done before the barrier or its ticket, so
//     block 0's or the last block's update of the state never reaches a
//     block of the same launch.
//
// Rounding: the element-wise steps use the __*_rn intrinsics, which nvcc
// does not contract into FMA, in the plain versions' order
// (ops/kernels.py: _fused_torch, _fused_zu_tail_torch), so z, u (and x)
// equal theirs bit for bit.  The soft threshold is v - t for v > t, v + t
// for v < -t (which equals -(-v - t) bit for bit) and v * 0 otherwise (a
// zero, with NaN kept); no multiply feeds an add.  The sums of squares are
// taken in the working type in the kernel's own order, so the norms agree
// with the plain version's to summation rounding, not bit for bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // ops/kernels.py ZU_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 5;       // ||x-z'||^2, ||rho(z'-z)||^2, ||x||^2, ||z'||^2, ||rho u''||^2
constexpr int kMaxCluster = 8; // ops/kernels.py ZU_CLUSTER_BLOCKS: the portable cluster size

// Flags of the tail mode (ops/kernels.py).
constexpr int kDomaxiters = 1, kNodualerror = 2, kNanguard = 4;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ void set_nan(float& v) { v = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void set_nan(double& v) { v = __longlong_as_double(0x7ff8000000000000LL); }

template <typename T>
__device__ __forceinline__ T soft(T v, T t) {
  return v > t ? sub_rn(v, t) : (v < -t ? add_rn(v, t) : mul_rn(v, T(0)));
}

// torch.maximum: NaN if either is NaN.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
struct Args {
  const T* xn;     // x (z/u mode) or x_new, prox_f's result (tail mode)
  const T* u;      // u
  T* z;            // z' out (z/u mode); z, updated in place (tail mode)
  T* uo;           // u' out (z/u mode); u again, updated in place (tail mode)
  T* x;            // tail mode: x, updated in place
  const T* t;      // z/u mode: the threshold
  const T* lam;    // tail mode: lambda and rho, 0-d
  const T* rho;
  int64_t* state;  // tail mode: (k, done, diverged)
  T* hist;         // tail mode: rows pnorm, dnorm, perr, derr of length ld
  int64_t ld;      // N + 1: column N is the spare slot of frozen steps
  int64_t N;       // maxiters
  T perr_abs, derr_abs, reltol;
  int flags;
  int cluster;        // tail mode: the grid is one cluster (else the ticket)
  T* partial;         // tail mode, ticket: kSums x gridDim.x block partials
  unsigned* ticket;   // tail mode, ticket: blocks done; 0 between launches
  int64_t n;
  int vec;            // every vector starts on a 16-byte boundary
};

// Sums v over the block in a fixed order; thread 0 gets the result.
template <typename T>
__device__ __forceinline__ void block_sum(T (&v)[kSums], T (&red)[kSums][kWarps]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] = add_rn(v[q], __shfl_down_sync(0xffffffffu, v[q], off));
    if (lane == 0) red[q][warp] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      T s = T(0);
      for (int w = 0; w < kWarps; ++w) s = add_rn(s, red[q][w]);
      v[q] = s;
    }
  }
}

template <typename T, bool kTail>
__global__ void __launch_bounds__(kThreads) zu_tail_kernel(Args<T> a) {
  constexpr int W = 16 / sizeof(T);
  __shared__ T red[kSums][kWarps];
  __shared__ bool last;

  // Read before this block takes its ticket: the last block rewrites them.
  bool frozen = false;
  int64_t k = 0;
  T t, rho = T(0);
  if constexpr (kTail) {
    k = a.state[0];
    frozen = a.state[1] != 0 || k >= a.N;
    rho = *a.rho;
    t = div_rn(*a.lam, rho);
  } else {
    t = *a.t;
  }

  T acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = T(0);
  auto element = [&](T xn, T zo, T uo, T& zn, T& un) {
    zn = soft(add_rn(xn, uo), t);
    un = sub_rn(add_rn(uo, xn), zn);
    if constexpr (kTail) {
      const T p = sub_rn(xn, zn);
      const T d = mul_rn(rho, sub_rn(zn, zo));
      const T w = mul_rn(rho, un);
      acc[0] = add_rn(acc[0], mul_rn(p, p));
      acc[1] = add_rn(acc[1], mul_rn(d, d));
      acc[2] = add_rn(acc[2], mul_rn(xn, xn));
      acc[3] = add_rn(acc[3], mul_rn(zn, zn));
      acc[4] = add_rn(acc[4], mul_rn(w, w));
    }
  };

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nv = a.vec ? a.n / W : 0;  // 16-byte chunks
  for (int64_t c = g; c < nv; c += stride) {
    alignas(16) T xv[W], zv[W] = {}, uv[W], zn[W], un[W];
    *reinterpret_cast<uint4*>(xv) = reinterpret_cast<const uint4*>(a.xn)[c];
    *reinterpret_cast<uint4*>(uv) = reinterpret_cast<const uint4*>(a.u)[c];
    if constexpr (kTail) *reinterpret_cast<uint4*>(zv) = reinterpret_cast<const uint4*>(a.z)[c];
#pragma unroll
    for (int w = 0; w < W; ++w) element(xv[w], zv[w], uv[w], zn[w], un[w]);
    if (!frozen) {
      reinterpret_cast<uint4*>(a.z)[c] = *reinterpret_cast<const uint4*>(zn);
      reinterpret_cast<uint4*>(a.uo)[c] = *reinterpret_cast<const uint4*>(un);
      if constexpr (kTail) reinterpret_cast<uint4*>(a.x)[c] = *reinterpret_cast<const uint4*>(xv);
    }
  }
  for (int64_t i = nv * W + g; i < a.n; i += stride) {  // the ragged end, or all of it
    const T xn = a.xn[i];
    T zn, un;
    element(xn, kTail ? a.z[i] : T(0), a.u[i], zn, un);
    if (!frozen) {
      a.z[i] = zn;
      a.uo[i] = un;
      if constexpr (kTail) a.x[i] = xn;
    }
  }

  if constexpr (kTail) {
    __shared__ T mine[kSums];
    block_sum(acc, red);
    T tot[kSums];
    if (a.cluster) {
      // One cluster: block 0 adds the blocks' sums in block order.
      cg::cluster_group cl = cg::this_cluster();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) mine[q] = acc[q];
      }
      cl.sync();
      const bool lead = cl.block_rank() == 0 && threadIdx.x == 0;
      if (lead) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) tot[q] = T(0);
        for (unsigned b = 0; b < cl.num_blocks(); ++b) {
          const T* theirs = cl.map_shared_rank(mine, b);
#pragma unroll
          for (int q = 0; q < kSums; ++q) tot[q] = add_rn(tot[q], theirs[q]);
        }
      }
      cl.sync();  // every block's `mine` stays alive until block 0 has read it
      if (!lead) return;
    } else {
      if (threadIdx.x == 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) a.partial[q * gridDim.x + blockIdx.x] = acc[q];
        __threadfence();  // the partials are visible before the ticket counts them
        last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
      }
      __syncthreads();
      if (!last) return;

      // The last block: every block's partials are written.  Add them in
      // block order (each thread a strided share, then block_sum).
      __threadfence();
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        tot[q] = T(0);
        for (int b = threadIdx.x; b < gridDim.x; b += kThreads)
          tot[q] = add_rn(tot[q], __ldcg(a.partial + q * gridDim.x + b));
      }
      block_sum(tot, red);
      if (threadIdx.x != 0) return;
      *a.ticket = 0u;  // ready for the next launch, or a graph replay
    }

    const bool domaxiters = a.flags & kDomaxiters, nodual = a.flags & kNodualerror;
    const T pnorm = sqrt_rn(tot[0]);
    const T perr = add_rn(a.perr_abs,
                          mul_rn(a.reltol, nan_max(sqrt_rn(tot[2]), sqrt_rn(tot[3]))));
    T dnorm, derr;
    if (nodual) {
      set_nan(dnorm);
      set_nan(derr);
    } else {
      dnorm = sqrt_rn(tot[1]);
      derr = add_rn(a.derr_abs, mul_rn(a.reltol, sqrt_rn(tot[4])));
    }
    const bool diverged = (a.flags & kNanguard) && !isfinite(pnorm);
    const bool stop = !domaxiters && pnorm < perr && (nodual || dnorm < derr);
    const int64_t slot = frozen ? a.N : k;
    a.hist[slot] = pnorm;
    a.hist[a.ld + slot] = dnorm;
    a.hist[2 * a.ld + slot] = perr;
    a.hist[3 * a.ld + slot] = derr;
    if (!frozen) {
      a.state[0] = k + 1;
      a.state[1] = (stop || diverged) ? 1 : 0;
      a.state[2] = (a.state[2] != 0 || diverged) ? 1 : 0;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool kTail>
int launch(Args<T> a, int blocks, cudaStream_t stream) {
  if (!a.cluster) {
    zu_tail_kernel<T, kTail><<<blocks, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, zu_tail_kernel<T, kTail>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int zu(const void* x, const void* u, const void* t, void* z, void* unew, int64_t n,
       int blocks, cudaStream_t stream) {
  Args<T> a = {};
  a.xn = static_cast<const T*>(x);
  a.u = static_cast<const T*>(u);
  a.z = static_cast<T*>(z);
  a.uo = static_cast<T*>(unew);
  a.t = static_cast<const T*>(t);
  a.n = n;
  a.vec = aligned16(x) && aligned16(u) && aligned16(z) && aligned16(unew);
  return launch<T, false>(a, blocks, stream);
}

template <typename T>
int zu_tail(const void* x_new, void* x, void* z, void* u, const void* lam,
            const void* rho, void* state, void* hist, int64_t ld, int64_t N,
            double perr_abs, double derr_abs, double reltol, int flags, void* scratch,
            int64_t n, int blocks, int cluster, cudaStream_t stream) {
  Args<T> a = {};
  a.xn = static_cast<const T*>(x_new);
  a.u = static_cast<const T*>(u);
  a.z = static_cast<T*>(z);
  a.uo = static_cast<T*>(u);
  a.x = static_cast<T*>(x);
  a.lam = static_cast<const T*>(lam);
  a.rho = static_cast<const T*>(rho);
  a.state = static_cast<int64_t*>(state);
  a.hist = static_cast<T*>(hist);
  a.ld = ld;
  a.N = N;
  // Rounded to the working type, as torch rounds a Python scalar.
  a.perr_abs = static_cast<T>(perr_abs);
  a.derr_abs = static_cast<T>(derr_abs);
  a.reltol = static_cast<T>(reltol);
  a.flags = flags;
  a.cluster = cluster && blocks <= kMaxCluster;
  a.ticket = static_cast<unsigned*>(scratch);
  a.partial = reinterpret_cast<T*>(static_cast<char*>(scratch) + 16);
  a.n = n;
  a.vec = aligned16(x_new) && aligned16(x) && aligned16(z) && aligned16(u);
  return launch<T, true>(a, blocks, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes by admm_tpu_torch/ops/_cuda.py.
// f64 selects double (else float).  Each launch goes on `stream` with
// `blocks` blocks of 256 threads (ops/kernels.py::zu_blocks), allocates
// nothing and does not synchronise; it returns cudaGetLastError() after
// the launch (0 on success).  The callers (ops/kernels.py) check shapes,
// dtypes, devices and contiguity.

// K1, the z/u mode: z and unew (n) from x, u (n) and the 0-d t.
extern "C" int admm_zu(int f64, const void* x, const void* u, const void* t, void* z,
                       void* unew, int64_t n, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? zu<double>(x, u, t, z, unew, n, blocks, s)
             : zu<float>(x, u, t, z, unew, n, blocks, s);
}

// K1b, the tail mode: one step's tail from x_new (n); x, z, u (n) and
// state (3 int64) updated in place; hist (rows of ld = N + 1) written at
// one column; lam and rho 0-d; flags of kDomaxiters, kNodualerror,
// kNanguard; cluster: reduce in one cluster when blocks <= kMaxCluster
// (else through the ticket); scratch: a zeroed 4-byte ticket, then from
// byte 16 kSums x blocks partials of 8 bytes.
extern "C" int admm_zu_tail(int f64, const void* x_new, void* x, void* z, void* u,
                            const void* lam, const void* rho, void* state, void* hist,
                            int64_t ld, int64_t N, double perr_abs, double derr_abs,
                            double reltol, int flags, void* scratch, int64_t n,
                            int blocks, int cluster, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? zu_tail<double>(x_new, x, z, u, lam, rho, state, hist, ld, N, perr_abs,
                               derr_abs, reltol, flags, scratch, n, blocks, cluster, s)
             : zu_tail<float>(x_new, x, z, u, lam, rho, state, hist, ld, N, perr_abs,
                              derr_abs, reltol, flags, scratch, n, blocks, cluster, s);
}
