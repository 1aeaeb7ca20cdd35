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
// What bounds them on this card: bytes, then the step's fixed costs.  A
// step streams E (m x n) and D^T (n x m) once each: 60 MB in f32 at the
// headline's 1500 x 5000, more than the 50 MB L2, so HBM at 3.35 TB/s sets
// a floor of ~18 us per step; 30 MB in bf16, which L2 can hold.  The
// arithmetic (2 flops per element read) is negligible.  The two products
// of a step depend on each other through all of t, so a step has two
// grid-wide barriers, and whatever a product does before its rows stream
// (staging its vector, filling its pipeline) adds to the step.  Per-block
// timestamps (experiments/gemv_pair_stamps.py) show the rows streaming
// near HBM speed and the two barriers and the staging making up the rest
// (PERF.md).
//
// What the design does about that:
//   * one persistent cooperative grid (cudaLaunchCooperativeKernel, at
//     most kMaxBlocksPerSm blocks per SM), all K steps inside it, with
//     cooperative_groups' grid sync after each product: no launch per
//     step, and the matrices stream from HBM or L2 with no host in between;
//   * every block gets an equal share of the rows of each product (the
//     row-major E, and a row-major copy of D^T), and the warps of a block
//     split each row's columns: a product with few columns (D^T's 1500)
//     gives each row fewer warps and more rows at once, so every warp
//     streams about the same bytes in both products (one warp per row, as
//     a first version had it, left E's product with 1500 warps for 30 MB);
//   * each lane streams its chunks of the rows through its own ring of
//     cp.async copies in shared memory, kDepth rows deep; a copy lands in
//     a slot only its own thread reads, so the ring needs no barrier.  The
//     rows do not depend on the vector, so a product's first kDepth - 1
//     rows are issued before the grid barrier that precedes it and stream
//     while the grid waits;
//   * the vector (b or t, rounded to the stream type) is staged once per
//     product by the whole block into shared memory with coalesced loads
//     (16-byte ones for bf16 streams from an aligned f32 x, t or b), all of
//     a thread's loads issued before it rounds or stores any (a load whose
//     value is used at once waits for the one before);
//   * the partial dots of a row are added in a fixed order (warp shuffles,
//     then one thread over the warps' partials in shared memory), so a
//     launch gives the same bits every time; K3's norms too: per-block
//     partials that block 0 adds in a fixed order after the step's last
//     barrier; no atomics;
//   * any m, n and row stride: rows off 16-byte boundaries take scalar
//     loads, the ragged end of a row an element-wise one, and a column
//     segment longer than the ring's slots, or a vector longer than
//     kVecMax, is read from L2 chunk by chunk.
// Not done, and where the rest of the time is: fewer or cheaper barriers
// (a step needs two), staging shared by a cluster over DSMEM, TMA bulk
// copies in place of per-thread cp.async.
//
// Rounding: b and t are rounded to the stream type with
// __float2bfloat16_rn, round to nearest even like JAX's astype and
// torch's .to(torch.bfloat16); an f32 b with bf16 streams is rounded the
// same way while it is loaded.  K2's backward runs the transposed pair
// x = E^T (D g) in bmode 2, where JAX's transpose of the same products
// rounds: g read in f32, D g rounded, the f32 result rounded as written.  The dots accumulate in f32 with FMA in an
// order of their own, so they agree with the plain versions
// (ops/gemv_pair.py) to summation rounding, not bit for bit.  K3's
// elementwise steps use the __*_rn intrinsics in the plain version's order
// (no contraction into FMA).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;       // rows of a group between two reductions
constexpr int kVecMax = 8192;    // floats of a staged vector (32 KB)
constexpr int kStage = 8;        // staging loads a thread has in flight
constexpr int kStage4 = kVecMax / 4 / kThreads;  // the same in 16-byte loads: one round
constexpr int kMaxBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

// The ring's depth in rows (on an H100 deeper rings were slower: the
// copies stall at issue while the memory pipeline is full).
constexpr int kDepth = 2;

// Elements V of one 16-byte chunk, and a lane's ring slots per row.
template <typename T> struct Stream;
template <> struct Stream<float> { static constexpr int V = 4, kChunks = 6; };
template <> struct Stream<__nv_bfloat16> { static constexpr int V = 8, kChunks = 3; };

// Dynamic shared memory of a kernel streaming T: the rings, then the
// staged vector.
template <typename T>
__host__ __device__ constexpr int ring_slots() { return kDepth * Stream<T>::kChunks * kThreads; }
template <typename T>
__host__ __device__ constexpr int smem_bytes() { return ring_slots<T>() * 16 + kVecMax * 4; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// An f32 value rounded to the stream type T, as an f32.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(const uint4& w, float (&e)[4]) {
  e[0] = __uint_as_float(w.x);
  e[1] = __uint_as_float(w.y);
  e[2] = __uint_as_float(w.z);
  e[3] = __uint_as_float(w.w);
}

// A bf16 is the high half of an f32: element 2i is the low 16 bits.
__device__ __forceinline__ void unpack(const uint4& w, float (&e)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[2 * k] = __uint_as_float(u[k] << 16);
    e[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// 16-byte chunk v of a row of `cols` elements that starts on a 16-byte
// boundary, with the elements past the end as 0.
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int v, int cols,
                                           float (&e)[V]) {
  const int base = v * V;
  if (base + V <= cols) {
    unpack(__ldg(reinterpret_cast<const uint4*>(row) + v), e);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = base + k < cols ? to_float(row[base + k]) : 0.f;
  }
}

// p if it starts on a 16-byte boundary, else null.
__device__ __forceinline__ const float* aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 ? p : nullptr;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Start of part i when `total` is cut into `parts` parts whose sizes
// differ by at most one (32-bit arithmetic only).
__device__ __forceinline__ int share_start(int i, int total, int parts) {
  const int q = total / parts, rem = total % parts;
  return i * q + min(i, rem);
}

// How a block splits a product with `nv` chunks per row: `wpr` warps per
// row (the most, up to kWarps, that leave each >= 64 chunks, 2 per lane),
// in kWarps / wpr row groups; warp `seg` of a group takes the seg-th of
// wpr equal column segments [v0, v1) of every row of its group.  Block g
// of G takes the g-th of G equal runs of rows, its groups equal runs of
// those.
struct Split {
  int wpr, groups, group, seg, v0, v1, r0, r1, per_group, gr0, gr1;
  __device__ __forceinline__ Split(int rows, int nv) {
    wpr = kWarps;
    while (wpr > 1 && nv < 64 * wpr) wpr >>= 1;
    groups = kWarps / wpr;
    const int warp = threadIdx.x >> 5;
    group = warp / wpr;
    seg = warp % wpr;
    v0 = share_start(seg, nv, wpr);
    v1 = share_start(seg + 1, nv, wpr);
    r0 = share_start(blockIdx.x, rows, gridDim.x);
    r1 = share_start(blockIdx.x + 1, rows, gridDim.x);
    per_group = (r1 - r0 + groups - 1) / groups;
    gr0 = r0 + group * per_group;
    gr1 = min(gr0 + per_group, r1);
  }
};

// epi(r, sum) for the rows of a block whose warps' partial dots lie in
// red[(group * kBatch + q) * kWarps + seg], q = 0..last: one thread per
// row adds the wpr partials in order.  Runs on threads below groups *
// kBatch (at most 4 warps); block-uniform, with a barrier on each side.
template <typename Epi>
__device__ __forceinline__ void finish_rows(const Split& sp, int first, int last,
                                            const float* red, Epi epi) {
  __syncthreads();
  const int g = threadIdx.x / kBatch, q = threadIdx.x % kBatch;
  if (g < sp.groups && q <= last) {
    const int r = sp.r0 + g * sp.per_group + first + q;
    if (r < min(sp.r0 + (g + 1) * sp.per_group, sp.r1)) {
      const float* p = red + (g * kBatch + q) * kWarps;
      float v = p[0];
      for (int w = 1; w < sp.wpr; ++w) v += p[w];
      epi(r, v);
    }
  }
  __syncthreads();  // red is free for the next batch
}

// One matrix-vector product spread over the grid: epi(r, A[r, :] . v) for
// every row r of the (rows, cols) row-major A (row stride lda), with
// v[j] = finish(load(j)): `load` only loads, `finish` (the rounding to the
// stream type) only computes, so staging can have all of a thread's loads
// in flight before it finishes any (a load whose value is used at once
// would wait for the one before).  `vec`: the rows start on 16-byte boundaries, so they
// stream through the cp.async rings in 16-byte chunks; else scalar loads.
template <typename T>
struct Product {
  static constexpr int V = Stream<T>::V, CH = Stream<T>::kChunks;
  const T* __restrict__ A;
  int64_t lda;
  int rows, cols;
  bool vec;
  Split sp;

  __device__ __forceinline__ Product(const T* A_, int64_t lda_, int rows_, int cols_,
                                     bool vec_)
      : A(A_), lda(lda_), rows(rows_), cols(cols_), vec(vec_),
        sp(rows_, vec_ ? (cols_ + V - 1) / V : cols_) {}

  // Row i of this thread's group into its ring slot i % kDepth, as one
  // commit group (empty past the group's last row).
  __device__ __forceinline__ void issue(uint4* ring, int i) const {
    const int r = sp.gr0 + i;
    if (i < sp.per_group && r < sp.gr1) {
      const T* row = A + static_cast<int64_t>(r) * lda;
      uint4* slot = ring + (i % kDepth) * CH * kThreads + threadIdx.x;
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int v = sp.v0 + c * 32 + lane;
        if (v < sp.v1) {
          const int bytes = min(V, cols - v * V) * static_cast<int>(sizeof(T));
          __pipeline_memcpy_async(slot + c * kThreads, row + v * V, 16, 16 - bytes);
        }
      }
    }
    __pipeline_commit();
  }

  // The product's first kDepth - 1 rows, issued before the barrier that
  // precedes it (the rows do not depend on the vector), so they stream
  // while the grid waits.  The ring must be drained: run() leaves it so.
  __device__ __forceinline__ void prefetch(uint4* ring) const {
    if (!vec || sp.r0 == sp.r1) return;
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d) issue(ring, d);
  }

  // Chunk v of the vector: from the staged copy, or from L2.
  template <typename Load, typename Finish>
  __device__ __forceinline__ void vec_chunk(const float* sv, bool staged, int v, Load load,
                                            Finish finish, float (&s)[V]) const {
    if (staged) {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sv + v * V + k);
        s[k] = q.x;
        s[k + 1] = q.y;
        s[k + 2] = q.z;
        s[k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = v * V + k < cols ? finish(load(v * V + k)) : 0.f;
    }
  }

  // `src4`, when not null, is the vector's f32 array on a 16-byte
  // boundary (load(j) reads src4[j]): staged with 16-byte loads.
  template <typename Load, typename Finish, typename Epi>
  __device__ __forceinline__ void run(uint4* ring, float* sv, float* red, Load load,
                                      Finish finish, const float* src4, Epi epi) const {
    if (sp.r0 == sp.r1) return;  // block-uniform
    const int lane = threadIdx.x & 31;
    // Stage the vector, zero up to a whole chunk past its end: each thread
    // makes up to kStage loads before it finishes or stores any.
    const bool staged = cols <= kVecMax;
    if (staged && src4 != nullptr) {
      const int n4 = cols / 4, padded = (cols + V - 1) / V * V;
      float4 val[kStage4];
#pragma unroll
      for (int q = 0; q < kStage4; ++q) {
        const int k4 = threadIdx.x + q * kThreads;
        val[q] = k4 < n4 ? __ldcg(reinterpret_cast<const float4*>(src4) + k4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      asm volatile("" ::: "memory");
#pragma unroll
      for (int q = 0; q < kStage4; ++q) {
        const int k4 = threadIdx.x + q * kThreads;
        if (k4 < n4) {
          const float4 v = val[q];
          reinterpret_cast<float4*>(sv)[k4] =
              make_float4(finish(v.x), finish(v.y), finish(v.z), finish(v.w));
        }
      }
      for (int j = n4 * 4 + threadIdx.x; j < padded; j += kThreads)
        sv[j] = j < cols ? finish(load(j)) : 0.f;
      __syncthreads();
    } else if (staged) {
      const int padded = (cols + V - 1) / V * V;
      for (int first = threadIdx.x; first < padded; first += kStage * kThreads) {
        float val[kStage];
#pragma unroll
        for (int q = 0; q < kStage; ++q) {
          const int j = first + q * kThreads;
          val[q] = j < cols ? load(j) : 0.f;
        }
        asm volatile("" ::: "memory");
#pragma unroll
        for (int q = 0; q < kStage; ++q) {
          const int j = first + q * kThreads;
          if (j < padded) sv[j] = j < cols ? finish(val[q]) : 0.f;
        }
      }
      __syncthreads();
    }

    for (int i = 0; i < sp.per_group; ++i) {
      const int r = sp.gr0 + i;
      float acc = 0.f;
      if (vec) {
        issue(ring, i + kDepth - 1);  // into the slot read at row i - 1
        __pipeline_wait_prior(kDepth - 1);  // row i's copies have landed
        const uint4* slot = ring + (i % kDepth) * CH * kThreads + threadIdx.x;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int v = sp.v0 + c * 32 + lane;
          if (v < sp.v1) {
            float e[V], s[V];
            unpack(slot[c * kThreads], e);
            vec_chunk(sv, staged, v, load, finish, s);
#pragma unroll
            for (int k = 0; k < V; ++k) acc = fmaf(e[k], s[k], acc);
          }
        }
        if (r < sp.gr1) {  // a segment longer than the ring's slots
          const T* row = A + static_cast<int64_t>(r) * lda;
          for (int v = sp.v0 + CH * 32 + lane; v < sp.v1; v += 32) {
            float e[V], s[V];
            load_chunk<T, V>(row, v, cols, e);
            vec_chunk(sv, staged, v, load, finish, s);
#pragma unroll
            for (int k = 0; k < V; ++k) acc = fmaf(e[k], s[k], acc);
          }
        }
      } else if (r < sp.gr1) {
        const T* row = A + static_cast<int64_t>(r) * lda;
        for (int j = sp.v0 + lane; j < sp.v1; j += 32)
          acc = fmaf(to_float(row[j]), staged ? sv[j] : finish(load(j)), acc);
      }
      acc = warp_sum(acc);
      const int q = i % kBatch;
      if (lane == 0) red[(sp.group * kBatch + q) * kWarps + sp.seg] = acc;
      if (q == kBatch - 1 || i + 1 == sp.per_group) finish_rows(sp, i - q, q, red, epi);
    }
    if (vec) __pipeline_wait_prior(0);  // the trailing empty groups
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
gemv_pair_kernel(const void* __restrict__ b, int bmode, const T* __restrict__ E,
                 int64_t lde, const T* __restrict__ Dt, int64_t ldd, float* t, float* x,
                 int m, int n, int K, int vec) {
  __shared__ float red[kWarps * kBatch * kWarps];
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float* sv = reinterpret_cast<float*>(smem + ring_slots<T>());
  cg::grid_group grid = cg::this_grid();
  const Product<T> pa(E, lde, m, n, vec & 1), pb(Dt, ldd, n, m, vec & 2);
  const float* bf = static_cast<const float*>(b);
  const T* bt = static_cast<const T*>(b);
  auto store_t = [&](int r, float v) { t[r] = v; };
  // 16-byte staging paid off for bf16 streams only: on an H100 it made
  // f32's staging slower (experiments/gemv_pair_stamps.py).
  auto wide = [](const float* p) { return sizeof(T) == 2 ? aligned16(p) : nullptr; };
  auto as_is = [](float v) { return v; };
  auto rounded = [](float v) { return round_to<T>(v); };
  // bmode 2 (the transposed pair of K2's backward): x rounded as written.
  auto store_x = [&](int r, float v) { x[r] = bmode == 2 ? round_to<T>(v) : v; };
  pa.prefetch(ring);
  for (int k = 0; k < K; ++k) {
    // t = E b, with b the input at step 0 (read as it is if it comes in
    // the stream type or in bmode 2, else rounded to the stream type) and
    // the previous x rounded to the stream type after that.
    if (k == 0 && bmode == 0) {
      pa.run(ring, sv, red, [&](int j) { return to_float(bt[j]); }, as_is, nullptr, store_t);
    } else if (k == 0 && bmode == 2) {
      pa.run(ring, sv, red, [&](int j) { return __ldcg(bf + j); }, as_is, wide(bf), store_t);
    } else {
      const float* src = k > 0 ? x : bf;
      pa.run(ring, sv, red, [&](int j) { return __ldcg(src + j); }, rounded, wide(src),
             store_t);
    }
    pb.prefetch(ring);
    grid.sync();
    pb.run(ring, sv, red, [&](int i) { return __ldcg(t + i); }, rounded, wide(t), store_x);
    if (k + 1 < K) {
      pa.prefetch(ring);
      grid.sync();
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
resident_lasso_kernel(float* z, float* u, const float* __restrict__ Dts,
                      const float* __restrict__ E, int64_t lde,
                      const float* __restrict__ Dt, int64_t ldd, float* t,
                      float* partial, float* hist, float rho, float kappa,
                      int m, int n, int K, int vec) {
  __shared__ float red[kWarps * kBatch * kWarps];
  __shared__ float sums[2][kWarps];
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float* sv = reinterpret_cast<float*>(smem + ring_slots<float>());
  cg::grid_group grid = cg::this_grid();
  const Product<float> pa(E, lde, m, n, vec & 1), pb(Dt, ldd, n, m, vec & 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float rr = __fmul_rn(rho, rho);
  auto as_is = [](float v) { return v; };
  // b_j = Dts_j + rho (z_j - u_j), rounded as the plain version rounds it.
  auto bval = [&](int j) {
    return __fadd_rn(Dts[j], __fmul_rn(rho, __fsub_rn(__ldcg(z + j), __ldcg(u + j))));
  };
  pa.prefetch(ring);
  for (int k = 0; k < K; ++k) {
    pa.run(ring, sv, red, bval, as_is, nullptr, [&](int r, float v) { t[r] = v; });
    pb.prefetch(ring);
    grid.sync();  // all of t is written; every z, u read for b
    float pn = 0.f, dn = 0.f;  // this thread's sums over the rows it finished
    pb.run(ring, sv, red, [&](int i) { return __ldcg(t + i); }, as_is, nullptr,
           [&](int j, float dtt) {
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
    // The block's sums, warp by warp in a fixed order.
    pn = warp_sum(pn);
    dn = warp_sum(dn);
    if (lane == 0) {
      sums[0][warp] = pn;
      sums[1][warp] = dn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float p = 0.f, d = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        p += sums[0][w];
        d += sums[1][w];
      }
      partial[2 * blockIdx.x] = p;
      partial[2 * blockIdx.x + 1] = d;
    }
    if (k + 1 < K) pa.prefetch(ring);
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
      if (lane == 0) {
        sums[0][warp] = p;
        sums[1][warp] = d;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float P = 0.f, Dn = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          P += sums[0][w];
          Dn += sums[1][w];
        }
        hist[2 * k] = P;
        hist[2 * k + 1] = __fmul_rn(rr, Dn);
      }
      __syncthreads();  // sums is free for the next step
    }
  }
}

// The cooperative grid for a kernel with `smem` bytes of dynamic shared
// memory: one block per row of the larger product, at most
// kMaxBlocksPerSm per SM and at most as many as are resident at once on
// the current device.  The occupancy is cached per device.
template <typename Kernel>
int grid_blocks(Kernel kernel, int smem, int m, int n, int* blocks) {
  static int resident[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
  }
  const int64_t need = m > n ? m : n;
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
int launch_pair(const void* b, int bmode, const void* E, int64_t lde, const void* Dt,
                       int64_t ldd, void* t, void* x, int m, int n, int K,
                       cudaStream_t stream) {
  auto kernel = gemv_pair_kernel<T>;
  constexpr int smem = smem_bytes<T>();
  int blocks = 0;
  const int err = grid_blocks(kernel, smem, m, n, &blocks);
  if (err != 0) return err;
  const T* Ep = static_cast<const T*>(E);
  const T* Dp = static_cast<const T*>(Dt);
  float* tp = static_cast<float*>(t);
  float* xp = static_cast<float*>(x);
  int vec = vec_flags<T>(E, lde, Dt, ldd);
  void* args[] = {&b, &bmode, &Ep, &lde, &Dp, &ldd, &tp, &xp, &m, &n, &K, &vec};
  return finish(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                            dim3(blocks), dim3(kThreads), args,
                                            smem, stream));
}

}  // namespace

// Plain C interface, loaded with ctypes by admm_tpu_torch/ops/_cuda.py.
// Each launch goes on `stream`, allocates nothing and does not
// synchronise; it returns cudaGetLastError() after the launch (0 on
// success).  The callers (ops/gemv_pair.py) check shapes, dtypes, devices
// and strides.

// K2.  bf16 selects __nv_bfloat16 streams (else float).  The row-major E
// (m x n, row stride lde) and D^T (n x m, row stride ldd) are in the
// stream type; b (n) is in the stream type (bmode 0) or in f32, then
// rounded to the stream type as it is read (bmode 1) or read as it is
// with x rounded to the stream type as it is written (bmode 2: the
// transposed pair of K2's backward, ops/gemv_pair.py); t (m) is f32
// scratch; x (n) receives the f32 result of the K-th step.  b and x may
// not overlap.
extern "C" int admm_gemv_pair(int bf16, const void* b, int bmode, const void* E,
                              int64_t lde, const void* Dt, int64_t ldd, void* t,
                              void* x, int m, int n, int K, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pair<__nv_bfloat16>(b, bmode, E, lde, Dt, ldd, t, x, m, n, K, s)
                     : launch_pair<float>(b, 1, E, lde, Dt, ldd, t, x, m, n, K, s);
}

// The number of blocks admm_resident_lasso launches for an (m, n) problem
// on the current device, written to *blocks; returns 0 or a CUDA error.
extern "C" int admm_resident_lasso_blocks(int m, int n, int* blocks) {
  return grid_blocks(resident_lasso_kernel, smem_bytes<float>(), m, n, blocks);
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
  const int err = grid_blocks(resident_lasso_kernel, smem_bytes<float>(), m, n, &blocks);
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
      args, smem_bytes<float>(), static_cast<cudaStream_t>(stream)));
}
