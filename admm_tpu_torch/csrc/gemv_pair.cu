// K2 and K3 for Hopper: the chained GEMV pair of the fat-LASSO x-update,
// and K whole fat-LASSO iterations, each in one cooperative launch.
//
// admm_gemv_pair (K2) replaces experiments/pallas_probe.py::make (the
// Pallas TPU kernel `kernel` run by `run`): K steps of t = E b,
// x = D^T t with E and D resident in VMEM, operands in a stream type (f32
// or bf16), f32 accumulation, t rounded back to the stream type between
// the two products.  At K = 1 in bf16 it is also the x-update of
// FatShiftSolver.solve with bf16 streams (admm_tpu/ops/solve.py:134-141),
// where torch.matmul on bf16 would round t and x to bf16.
//
// admm_resident_lasso (K3) replaces
// experiments/resident_iter_proto.py::make_kernel (the Pallas TPU kernel
// `kernel` run by `run`): K steps of
//     b  = D^T s + rho (z - u)
//     x  = b / rho - D^T (E b) / (rho rho)
//     z' = soft_threshold(x + u, kappa),   u' = (u + x) - z'
// in f32, with (||x - z'||^2, rho^2 ||z' - z||^2) written per step.
//
// What bounds them on this card: bytes.  A step streams E (m x n) and D^T
// (n x m) once each: 60 MB in f32 at the headline's 1500 x 5000, more
// than the 50 MB L2, so HBM at 3.35 TB/s sets a floor of ~18 us per step;
// 30 MB in bf16, which L2 can hold.  The arithmetic (2 flops per element
// read) is negligible.  The two products of a step depend on each other
// through all of t, so a step has two grid-wide barriers.
//
// What the design does about that:
//   * one persistent cooperative grid (cudaLaunchCooperativeKernel, at
//     most as many blocks as are resident at once), all K steps inside it,
//     with cooperative_groups' grid sync after each product: no launch per
//     step, and the matrices stream from HBM or L2 with no host in between;
//   * one warp per matrix row, so both products are coalesced row dots:
//     E is (m, n) row-major and the caller keeps a row-major copy of D^T;
//     16-byte loads (4 f32 or 8 bf16) whenever the rows start on 16-byte
//     boundaries (the wrapper pads the row stride of its own copies), with
//     a scalar loop for the ragged tail and for unaligned rows;
//   * the vector of a product (b or t) is staged in shared memory, rounded
//     to the stream type, in tiles of kTile floats, so any n and m work;
//     one tile (32 KB) covers the headline's 5000 and 1500;
//   * deterministic norms: each block writes its partial sums, and block 0
//     adds them in a fixed order after the step's last barrier; no atomics.
// TMA, splitting rows over a cluster and fewer barriers are left for later.
//
// Rounding: b and t are rounded to the stream type with
// __float2bfloat16_rn, round to nearest even like JAX's astype and
// torch's .to(torch.bfloat16).  The dots accumulate in f32 with FMA in an
// order of their own, so they agree with the plain versions
// (ops/gemv_pair.py) to summation rounding, not bit for bit.  K3's
// elementwise steps use the __*_rn intrinsics in the plain version's order
// (no contraction into FMA).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;  // floats of a staged vector tile: 32 KB
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// An f32 value rounded to the stream type T, as an f32.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc + the 16 bytes w (4 f32 or 8 bf16) times s[0..4) or s[0..8).
__device__ __forceinline__ float dot16(const uint4& w, const float* s, float acc,
                                       const float*) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  acc = fmaf(__uint_as_float(w.x), v.x, acc);
  acc = fmaf(__uint_as_float(w.y), v.y, acc);
  acc = fmaf(__uint_as_float(w.z), v.z, acc);
  return fmaf(__uint_as_float(w.w), v.w, acc);
}

__device__ __forceinline__ float dot16(const uint4& w, const float* s, float acc,
                                       const __nv_bfloat16*) {
  // A bf16 is the high half of an f32: element 2i is the low 16 bits.
  const float4 lo = *reinterpret_cast<const float4*>(s);
  const float4 hi = *reinterpret_cast<const float4*>(s + 4);
  acc = fmaf(__uint_as_float(w.x << 16), lo.x, acc);
  acc = fmaf(__uint_as_float(w.x & 0xffff0000u), lo.y, acc);
  acc = fmaf(__uint_as_float(w.y << 16), lo.z, acc);
  acc = fmaf(__uint_as_float(w.y & 0xffff0000u), lo.w, acc);
  acc = fmaf(__uint_as_float(w.z << 16), hi.x, acc);
  acc = fmaf(__uint_as_float(w.z & 0xffff0000u), hi.y, acc);
  acc = fmaf(__uint_as_float(w.w << 16), hi.z, acc);
  return fmaf(__uint_as_float(w.w & 0xffff0000u), hi.w, acc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's share of row[0..len) . s[0..len); `vec` says the row starts
// on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ row, const float* s,
                                         int len, bool vec, int lane) {
  constexpr int V = 16 / sizeof(T);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  if (vec) {
    const int nv = len / V;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    int i = lane;
    for (; i + 96 < nv; i += 128) {  // four 16-byte loads in flight per lane
      const uint4 w0 = __ldg(rv + i);
      const uint4 w1 = __ldg(rv + i + 32);
      const uint4 w2 = __ldg(rv + i + 64);
      const uint4 w3 = __ldg(rv + i + 96);
      a0 = dot16(w0, s + i * V, a0, row);
      a1 = dot16(w1, s + (i + 32) * V, a1, row);
      a2 = dot16(w2, s + (i + 64) * V, a2, row);
      a3 = dot16(w3, s + (i + 96) * V, a3, row);
    }
    for (; i < nv; i += 32) a0 = dot16(__ldg(rv + i), s + i * V, a0, row);
    j = nv * V;
  }
  for (j += lane; j < len; j += 32) a0 = fmaf(to_float(row[j]), s[j], a0);
  return (a0 + a1) + (a2 + a3);
}

// One matrix-vector product spread over the grid: for every row r of the
// (rows, cols) row-major A (row stride lda), epi(r, A[r, :] . v) runs on
// all lanes of the row's warp, where v[j] = load(j) is staged in shared
// memory tile by tile.  Warp w of block g takes rows g*kWarps + w plus
// multiples of gridDim.x*kWarps.
template <typename T, typename Load, typename Epi>
__device__ __forceinline__ void gemv_phase(const T* __restrict__ A, int64_t lda,
                                           int rows, int cols, bool vec, float* sv,
                                           Load load, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps;
  const bool one_tile = cols <= kTile;
  for (int base = first; base < rows; base += gridDim.x * kWarps) {
    const int r = base + warp;
    float acc = 0.f;
    for (int c0 = 0; c0 < cols; c0 += kTile) {
      const int len = min(kTile, cols - c0);
      if (!one_tile || base == first) {  // block-uniform
        __syncthreads();  // the tile's last readers are done
        for (int j = threadIdx.x; j < len; j += kThreads) sv[j] = load(c0 + j);
        __syncthreads();
      }
      if (r < rows) acc += row_dot(A + r * lda + c0, sv, len, vec, lane);
    }
    if (r < rows) epi(r, warp_sum(acc));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_pair_kernel(const T* __restrict__ b, const T* __restrict__ E, int64_t lde,
                 const T* __restrict__ Dt, int64_t ldd, float* t, float* x,
                 int m, int n, int K, int vec) {
  __shared__ __align__(16) float sv[kTile];
  cg::grid_group grid = cg::this_grid();
  const bool lane0 = (threadIdx.x & 31) == 0;
  for (int k = 0; k < K; ++k) {
    // t = E b, with b the input (already in the stream type) at step 0 and
    // the previous x rounded to it after that.
    gemv_phase(E, lde, m, n, vec & 1, sv,
               [&](int j) { return k == 0 ? to_float(b[j]) : round_to<T>(__ldcg(x + j)); },
               [&](int r, float v) { if (lane0) t[r] = v; });
    grid.sync();
    gemv_phase(Dt, ldd, n, m, vec & 2, sv,
               [&](int i) { return round_to<T>(__ldcg(t + i)); },
               [&](int r, float v) { if (lane0) x[r] = v; });
    if (k + 1 < K) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
resident_lasso_kernel(float* z, float* u, const float* __restrict__ Dts,
                      const float* __restrict__ E, int64_t lde,
                      const float* __restrict__ Dt, int64_t ldd, float* t,
                      float* partial, float* hist, float rho, float kappa,
                      int m, int n, int K, int vec) {
  __shared__ __align__(16) float sv[kTile];
  __shared__ float red[2][kWarps];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float rr = __fmul_rn(rho, rho);
  // b_j = Dts_j + rho (z_j - u_j), rounded as the plain version rounds it.
  auto bval = [&](int j) {
    return __fadd_rn(Dts[j], __fmul_rn(rho, __fsub_rn(__ldcg(z + j), __ldcg(u + j))));
  };
  for (int k = 0; k < K; ++k) {
    gemv_phase(E, lde, m, n, vec & 1, sv, bval,
               [&](int r, float v) { if (lane == 0) t[r] = v; });
    grid.sync();  // all of t is written; every z, u read for b
    float pn = 0.f, dn = 0.f;  // this warp's sums, on lane 0
    gemv_phase(Dt, ldd, n, m, vec & 2, sv, [&](int i) { return __ldcg(t + i); },
               [&](int j, float dtt) {
                 if (lane != 0) return;
                 const float zj = __ldcg(z + j), uj = __ldcg(u + j);
                 const float x = __fsub_rn(__fdiv_rn(bval(j), rho), __fdiv_rn(dtt, rr));
                 const float v = __fadd_rn(x, uj);
                 const float a = __fsub_rn(fabsf(v), kappa);
                 const float mag = a < 0.f ? 0.f : a;  // keeps a NaN
                 const float z2 = v == 0.f ? 0.f : copysignf(mag, v);
                 const float px = __fsub_rn(x, z2), dz = __fsub_rn(z2, zj);
                 pn = fmaf(px, px, pn);
                 dn = fmaf(dz, dz, dn);
                 z[j] = z2;
                 u[j] = __fsub_rn(__fadd_rn(uj, x), z2);
               });
    if (lane == 0) {
      red[0][warp] = pn;
      red[1][warp] = dn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float p = 0.f, d = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        p += red[0][w];
        d += red[1][w];
      }
      partial[2 * blockIdx.x] = p;
      partial[2 * blockIdx.x + 1] = d;
    }
    grid.sync();  // z, u and every block's partials are written
    if (blockIdx.x == 0) {
      // Block 0 adds the partials in a fixed order.  The next writes to
      // `partial` come after the next step's first barrier, which block 0
      // reaches only after this.
      float p = 0.f, d = 0.f;
      for (int g = threadIdx.x; g < gridDim.x; g += kThreads) {
        p += __ldcg(partial + 2 * g);
        d += __ldcg(partial + 2 * g + 1);
      }
      p = warp_sum(p);
      d = warp_sum(d);
      __syncthreads();  // red's last readers are done
      if (lane == 0) {
        red[0][warp] = p;
        red[1][warp] = d;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float P = 0.f, Dn = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          P += red[0][w];
          Dn += red[1][w];
        }
        hist[2 * k] = P;
        hist[2 * k + 1] = __fmul_rn(rr, Dn);
      }
    }
    __syncthreads();  // red is free for the next step
  }
}

// The cooperative grid for a kernel: as many blocks as the rows need (one
// warp per row of the larger product), at most as many as are resident
// at once on the current device.  The occupancy is cached per device.
template <typename Kernel>
int grid_blocks(Kernel kernel, int m, int n, int* blocks) {
  static int resident[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = per_sm * sms;
  }
  const int64_t rows = m > n ? m : n;
  const int64_t need = (rows + kWarps - 1) / kWarps;
  *blocks = static_cast<int>(need < resident[dev] ? (need > 0 ? need : 1) : resident[dev]);
  return 0;
}

// Bit 0: E's rows start on 16-byte boundaries; bit 1: D^T's do.
template <typename T>
int vec_flags(const void* E, int64_t lde, const void* Dt, int64_t ldd) {
  constexpr int V = 16 / sizeof(T);
  const bool e = reinterpret_cast<uintptr_t>(E) % 16 == 0 && lde % V == 0;
  const bool d = reinterpret_cast<uintptr_t>(Dt) % 16 == 0 && ldd % V == 0;
  return (e ? 1 : 0) | (d ? 2 : 0);
}

int finish(cudaError_t launch_err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launch_err != cudaSuccess ? launch_err : last);
}

template <typename T>
int launch_pair(const void* b, const void* E, int64_t lde, const void* Dt,
                int64_t ldd, void* t, void* x, int m, int n, int K,
                cudaStream_t stream) {
  auto kernel = gemv_pair_kernel<T>;
  int blocks = 0;
  const int err = grid_blocks(kernel, m, n, &blocks);
  if (err != 0) return err;
  const T* bp = static_cast<const T*>(b);
  const T* Ep = static_cast<const T*>(E);
  const T* Dp = static_cast<const T*>(Dt);
  float* tp = static_cast<float*>(t);
  float* xp = static_cast<float*>(x);
  int vec = vec_flags<T>(E, lde, Dt, ldd);
  void* args[] = {&bp, &Ep, &lde, &Dp, &ldd, &tp, &xp, &m, &n, &K, &vec};
  return finish(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                            dim3(blocks), dim3(kThreads), args,
                                            0, stream));
}

}  // namespace

// Plain C interface, loaded with ctypes by admm_tpu_torch/ops/_cuda.py.
// Each launch goes on `stream`, allocates nothing and does not
// synchronise; it returns cudaGetLastError() after the launch (0 on
// success).  The callers (ops/gemv_pair.py) check shapes, dtypes, devices
// and strides.

// K2.  bf16 selects __nv_bfloat16 streams (else float).  b (n) and the
// row-major E (m x n, row stride lde) and D^T (n x m, row stride ldd) are
// in the stream type; t (m) is f32 scratch; x (n) receives the f32 result
// of the K-th step.  b and x may not overlap.
extern "C" int admm_gemv_pair(int bf16, const void* b, const void* E, int64_t lde,
                              const void* Dt, int64_t ldd, void* t, void* x,
                              int m, int n, int K, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pair<__nv_bfloat16>(b, E, lde, Dt, ldd, t, x, m, n, K, s)
              : launch_pair<float>(b, E, lde, Dt, ldd, t, x, m, n, K, s);
}

// The number of blocks admm_resident_lasso launches for an (m, n) problem
// on the current device, written to *blocks; returns 0 or a CUDA error.
extern "C" int admm_resident_lasso_blocks(int m, int n, int* blocks) {
  return grid_blocks(resident_lasso_kernel, m, n, blocks);
}

// K3, f32.  z, u (n) are updated in place; Dts (n); E (m x n, row stride
// lde) and D^T (n x m, row stride ldd) row-major; t (m) and partial
// (2 * admm_resident_lasso_blocks) are f32 scratch; hist (K x 2) receives
// (||x - z'||^2, rho^2 ||z' - z||^2) of every step.
extern "C" int admm_resident_lasso(void* z, void* u, const void* Dts, const void* E,
                                   int64_t lde, const void* Dt, int64_t ldd, void* t,
                                   void* partial, void* hist, float rho, float kappa,
                                   int m, int n, int K, void* stream) {
  int blocks = 0;
  const int err = grid_blocks(resident_lasso_kernel, m, n, &blocks);
  if (err != 0) return err;
  float* zp = static_cast<float*>(z);
  float* up = static_cast<float*>(u);
  const float* sp = static_cast<const float*>(Dts);
  const float* Ep = static_cast<const float*>(E);
  const float* Dp = static_cast<const float*>(Dt);
  float* tp = static_cast<float*>(t);
  float* pp = static_cast<float*>(partial);
  float* hp = static_cast<float*>(hist);
  int vec = vec_flags<float>(E, lde, Dt, ldd);
  void* args[] = {&zp, &up, &sp, &Ep, &lde, &Dp, &ldd, &tp, &pp, &hp,
                  &rho, &kappa, &m, &n, &K, &vec};
  return finish(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(resident_lasso_kernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}
