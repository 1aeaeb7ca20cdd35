// K4 for Hopper: the b-phase of masked cyclic reduction for a batch of
// right-hand sides of one fixed tridiagonal system.
//
// Replaces experiments/pallas_cr_kernel.py::cr_solve_pallas (the Pallas TPU
// kernel _kernel, which runs every level of the solve in one call with the
// right-hand sides and all coefficient stacks resident in VMEM).
//
// What bounds it on this card: latency.  A solve is 2k dependent levels,
// each waiting on the one before, and moves a few MB at most (b, x and the
// active coefficients: ~3.7 MB at n = 65536 in f32, ~1 us of HBM time).
// One CTA per lane, as a first version had it, leaves a single-lane solve
// on 1 of the 132 SMs.
//
// What the design does about that: tiles with a recomputed halo.  After
// forward levels 0..l-1, row i depends only on the rows within 2^l - 1 of
// it; back substitution from the level-k stratum down to level 0 has the
// same radius R = 2^k - 1.  So in the hybrid form (k levels, then a dense
// tail on the stratum rows st-1 :: st, st = 2^k) each launch is cut into
// tiles of C rows per lane, grid (tiles, lanes):
//   * a tile loads its rows plus R on each side into shared memory, runs
//     all k levels there with only __syncthreads() between them, and
//     writes back its own C rows; no grid barrier, no inter-CTA traffic.
//     Rows near the loaded edge go wrong (their neighbours past the edge
//     read as 0) but lie farther than R from the tile's own rows;
//   * one buffer per tile: a forward level writes rows 2s-1 mod 2s and
//     reads rows s-1 mod 2s, which it does not write; back substitution
//     turns row i from b into x at the one level where i is active, and
//     reads x at i +- s, which deeper levels or the stratum have set.  So
//     the back launch loads the stratum rows from the tail's solution and
//     every other row from the forward launch's result;
//   * coefficients are stored compacted (only the active rows of each
//     level, contiguous; ops/tridiag.py::compact_stacks), so a level reads
//     them coalesced instead of at stride 2s, and a thread loads the next
//     level's coefficients into registers before it runs the current
//     level, so the levels do not each wait on an L2 round trip; a lane
//     run as one tile also stages the coefficients of its deep levels
//     (those with at most one row a thread) in shared memory at the start;
//   * a tile whose loaded rows all lie in the padding (i >= n) and hold
//     exactly +0 writes +0 without running a level: the padding rows are
//     identity rows (a = c = alpha = beta = +-0, d = 1), and on +0 inputs
//     every level yields +0 in the plain version too.  That skips about
//     half of the tiles at n = 2^p, where N = 2n - 1.
// The pure masked form (no tail) has the whole lane as radius, so it runs
// as one tile per lane (C = N, R = 0), in shared memory when the lane
// fits and in the output row itself when it does not.  The caller
// (ops/tridiag.py::tile_plan) picks C, R, the block size and whether the
// rows fit in shared memory.
//
// Rounding is that of the plain version (ops/tridiag.py::_cr_solve_torch)
// bit for bit: b - alpha*up - beta*dn in that order and
// (b - a*x_{i-s} - c*x_{i+s}) / d with an IEEE division, every operation
// rounded on its own (the __*_rn intrinsics keep nvcc from contracting a
// multiply and a subtract into an FMA).  A neighbour past either end of
// the system reads as +0 and still goes through the arithmetic, as the
// plain version's zero-filled shifts do, so even signed zeros agree.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int kMaxSharedBytes = 227 * 1024;  // ops/tridiag.py::SHARED_BYTES

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ bool nonzero_bits(float v) { return __float_as_uint(v) != 0u; }
__device__ __forceinline__ bool nonzero_bits(double v) {
  return __double_as_longlong(v) != 0ll;
}

// The j of rows i = j*P + q (j >= 0) that lie in [lo, hi): [*j0, *j1).
__device__ __forceinline__ void rows_in(int lo, int hi, int P, int q, int* j0, int* j1) {
  *j0 = lo > q ? (lo - q + P - 1) / P : 0;
  *j1 = hi > q ? (hi - q + P - 1) / P : 0;
}

// The j of level l's forward-active rows i = (j+1)*2s - 1 in [lo, hi); the
// level has (N+1)/2s - 1 of them (ops/tridiag.py::level_offsets).
__device__ __forceinline__ void forward_rows(int l, int lo, int hi, int N, int* j0, int* j1) {
  const int s = 1 << l;
  rows_in(lo, hi, 2 * s, 2 * s - 1, j0, j1);
  *j1 = min(*j1, ((N + 1) >> (l + 1)) - 1);
}

// The same for back-substitution rows i = j*2s + s - 1, (N+1)/2s of them.
__device__ __forceinline__ void back_rows(int l, int lo, int hi, int N, int* j0, int* j1) {
  const int s = 1 << l;
  rows_in(lo, hi, 2 * s, s - 1, j0, j1);
  *j1 = min(*j1, (N + 1) >> (l + 1));
}

// A thread's first kU rows of a level, j = j0 + threadIdx.x + q * blockDim.x,
// take their coefficients from registers loaded one level ahead, so the
// loads overlap the level before; any further rows load theirs kU at a
// time, all kU loads in flight together.
constexpr int kU = 4;

template <typename T, int C>
struct Coefs {
  T v[C][kU];
  __device__ __forceinline__ void load(const T* const (&src)[C], int off, int j0, int j1) {
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int j = j0 + threadIdx.x + q * blockDim.x;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c][q] = j < j1 ? __ldg(src[c] + off + j) : T(0);
    }
  }
};

// The coefficients of the levels that have at most blockDim rows (forward
// levels l >= lf, back levels l >= lb), staged in shared memory at the
// start of a one-tile lane: a level then waits on no L2 round trip.  Those
// are the deep levels, 11 of the 14 at n = 8192, and hold ~2 blockDim rows
// in all.  lf = lb = levels: none staged.
template <typename T>
struct Small {
  const T *al, *be, *a, *c, *d;  // level lf's first forward row, lb's first back row
  int lf, lb, foff, boff;        // and their offsets in the compacted stacks
};

// The levels to stage for an N-row lane run by `threads` threads: the
// first small forward and back level, and the rows from there on.
__host__ __device__ inline void small_levels(int N, int levels, int threads, int* lf,
                                             int* lb, int* foff, int* boff, int* frows,
                                             int* brows) {
  *lf = *lb = levels;
  *foff = *boff = *frows = *brows = 0;
  int fo = 0, bo = 0;
  for (int l = 0; l < levels; ++l) {
    const int fc = ((N + 1) >> (l + 1)) - 1, bc = (N + 1) >> (l + 1);
    if (fc <= threads && *lf == levels) {
      *lf = l;
      *foff = fo;
    }
    if (bc <= threads && *lb == levels) {
      *lb = l;
      *boff = bo;
    }
    if (*lf < levels) *frows += fc;
    if (*lb < levels) *brows += bc;
    fo += fc;
    bo += bc;
  }
}

// Forward levels 0..levels-1 on rows [lo, hi) of one lane, held at
// w[i - lo].  al/be hold each level's active rows compacted, level after
// level.
template <typename T>
__device__ void forward_levels(T* w, int lo, int hi, int N, int levels,
                               const T* __restrict__ al, const T* __restrict__ be,
                               const Small<T>& sm) {
  const T* const src[2] = {al, be};
  Coefs<T, 2> cur, next;
  int off = 0, j0, j1;
  forward_rows(0, lo, hi, N, &j0, &j1);
  if (levels > 0 && 0 < sm.lf) cur.load(src, 0, j0, j1);
  for (int l = 0; l < levels; ++l) {
    const int s = 1 << l;
    int n0 = 0, n1 = 0;
    const int noff = off + ((N + 1) >> (l + 1)) - 1;
    if (l + 1 < levels) {
      forward_rows(l + 1, lo, hi, N, &n0, &n1);
      if (l + 1 < sm.lf) next.load(src, noff, n0, n1);
    }
    auto update = [&](int j, T a, T b) {
      const int i = (j + 1) * 2 * s - 1;
      const T up = (i - s >= lo) ? w[i - s - lo] : T(0);
      const T dn = (i + s < hi) ? w[i + s - lo] : T(0);
      w[i - lo] = sub(sub(w[i - lo], mul(a, up)), mul(b, dn));
    };
    if (l >= sm.lf) {  // a staged level
      for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x)
        update(j, sm.al[off - sm.foff + j], sm.be[off - sm.foff + j]);
      __syncthreads();
      off = noff;
      j0 = n0;
      j1 = n1;
      continue;
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int j = j0 + threadIdx.x + q * blockDim.x;
      if (j < j1) update(j, cur.v[0][q], cur.v[1][q]);
    }
    for (int base = j0 + kU * blockDim.x; base < j1; base += kU * blockDim.x) {
      Coefs<T, 2> more;  // further rows, kU at a time
      more.load(src, off, base, j1);
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int j = base + threadIdx.x + q * blockDim.x;
        if (j < j1) update(j, more.v[0][q], more.v[1][q]);
      }
    }
    __syncthreads();
    cur = next;
    off = noff;
    j0 = n0;
    j1 = n1;
  }
}

// Back substitution levels levels-1..0 on rows [lo, hi), in place: row i
// holds b until its level turns it into x.  a/c/d hold each level's active
// rows compacted, level after level from level 0.
template <typename T>
__device__ void back_levels(T* w, int lo, int hi, int N, int levels,
                            const T* __restrict__ a, const T* __restrict__ c,
                            const T* __restrict__ d, const Small<T>& sm) {
  const T* const src[3] = {a, c, d};
  Coefs<T, 3> cur, next;
  int off = 0, j0, j1;
  for (int l = 0; l + 1 < levels; ++l) off += (N + 1) >> (l + 1);
  if (levels > 0) {
    back_rows(levels - 1, lo, hi, N, &j0, &j1);
    if (levels - 1 < sm.lb) cur.load(src, off, j0, j1);
  }
  for (int l = levels - 1; l >= 0; --l) {
    const int s = 1 << l;
    int n0 = 0, n1 = 0;
    const int noff = l > 0 ? off - ((N + 1) >> l) : 0;
    if (l > 0) {
      back_rows(l - 1, lo, hi, N, &n0, &n1);
      if (l - 1 < sm.lb) next.load(src, noff, n0, n1);
    }
    auto update = [&](int j, T aj, T cj, T dj) {
      const int i = j * 2 * s + s - 1;
      const T xm = (i >= s && i - s >= lo) ? w[i - s - lo] : T(0);
      const T xp = (i + s < hi) ? w[i + s - lo] : T(0);
      w[i - lo] = div(sub(sub(w[i - lo], mul(aj, xm)), mul(cj, xp)), dj);
    };
    if (l >= sm.lb) {  // a staged level
      const int o = off - sm.boff;
      for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x)
        update(j, sm.a[o + j], sm.c[o + j], sm.d[o + j]);
      __syncthreads();
      cur = next;  // loaded above when level l - 1 is not staged
      off = noff;
      j0 = n0;
      j1 = n1;
      continue;
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int j = j0 + threadIdx.x + q * blockDim.x;
      if (j < j1) update(j, cur.v[0][q], cur.v[1][q], cur.v[2][q]);
    }
    for (int base = j0 + kU * blockDim.x; base < j1; base += kU * blockDim.x) {
      Coefs<T, 3> more;  // further rows, kU at a time
      more.load(src, off, base, j1);
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int j = base + threadIdx.x + q * blockDim.x;
        if (j < j1) update(j, more.v[0][q], more.v[1][q], more.v[2][q]);
      }
    }
    __syncthreads();
    cur = next;
    off = noff;
    j0 = n0;
    j1 = n1;
  }
}

// w[i - lo] = get(i) for the rows [lo, hi), kLoad rows a thread at a time
// with all their loads in flight together; *nz is set when a value's bits
// are not those of +0.
constexpr int kLoad = 8;

template <typename T, typename Get>
__device__ __forceinline__ void load_rows(T* w, int lo, int hi, Get get, bool* nz) {
  for (int base = lo + threadIdx.x; base < hi; base += kLoad * blockDim.x) {
    T v[kLoad];
#pragma unroll
    for (int q = 0; q < kLoad; ++q) {
      const int i = base + q * blockDim.x;
      v[q] = i < hi ? get(i) : T(0);
    }
#pragma unroll
    for (int q = 0; q < kLoad; ++q) {
      const int i = base + q * blockDim.x;
      if (i < hi) {
        *nz |= nonzero_bits(v[q]);
        w[i - lo] = v[q];
      }
    }
  }
}

// Grid (tiles, lanes).  Tile t of a lane writes rows [t*C, min(t*C + C, N))
// and loads R more on each side.  Phases run as their pointers are given:
//   b != nullptr, x == nullptr: forward levels on b; write the tile's rows
//                 to work and its stratum rows (st-1 :: st) to y;
//   b == nullptr, x != nullptr: load work, with the stratum rows from xs;
//                 back substitution; write the tile's rows to x;
//   b != nullptr, x != nullptr: forward then back in one buffer (the pure
//                 masked form: one tile per lane, C = N, R = 0).
// b, work, x are (B, N); y, xs (B, M) with M = (N + 1) / st - 1.  The
// tile's buffer is dynamic shared memory, or scratch + (lane * tiles + t)
// * rows when scratch != nullptr, rows = min(C + 2R, N).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cr_tile_kernel(const T* __restrict__ b, T* work, const T* __restrict__ xs,
               T* __restrict__ y, T* x, const T* __restrict__ al,
               const T* __restrict__ be, const T* __restrict__ a,
               const T* __restrict__ c, const T* __restrict__ d, int N, int n,
               int levels, int C, int R, T* scratch, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.x;
  const int64_t lane = blockIdx.y;
  const int st = 1 << levels;
  const int M = (N + 1) / st - 1;
  const int t0 = t * C, t1 = min(t0 + C, N);
  const int lo = max(t0 - R, 0), hi = min(t1 + R, N);
  const int rows = min(C + 2 * R, N);
  T* w = scratch != nullptr ? scratch + (lane * gridDim.x + t) * rows
                            : reinterpret_cast<T*>(smem_raw);
  Small<T> sm{nullptr, nullptr, nullptr, nullptr, nullptr, levels, levels, 0, 0};
  if (stage) {  // one tile per lane, its rows in shared memory: w, then these
    int frows, brows;
    small_levels(N, levels, blockDim.x, &sm.lf, &sm.lb, &sm.foff, &sm.boff, &frows, &brows);
    T* cs = w + rows;
    bool unused = false;
    load_rows(cs, 0, frows, [&](int i) { return al[sm.foff + i]; }, &unused);
    load_rows(cs + frows, 0, frows, [&](int i) { return be[sm.foff + i]; }, &unused);
    T* cb = cs + 2 * frows;
    load_rows(cb, 0, brows, [&](int i) { return a[sm.boff + i]; }, &unused);
    load_rows(cb + brows, 0, brows, [&](int i) { return c[sm.boff + i]; }, &unused);
    load_rows(cb + 2 * brows, 0, brows, [&](int i) { return d[sm.boff + i]; }, &unused);
    sm.al = cs;
    sm.be = cs + frows;
    sm.a = cb;
    sm.c = cb + brows;
    sm.d = cb + 2 * brows;
  }

  bool zero_tile = false;
  if (b != nullptr) {
    const T* bl = b + lane * N;
    bool nz = false;
    load_rows(w, lo, hi, [&](int i) { return bl[i]; }, &nz);
    zero_tile = !__syncthreads_or(nz) && lo >= n && x == nullptr;
    if (!zero_tile) forward_levels(w, lo, hi, N, levels, al, be, sm);
    if (x == nullptr) {
      T* wl = work + lane * N;
      for (int i = t0 + threadIdx.x; i < t1; i += blockDim.x)
        wl[i] = zero_tile ? T(0) : w[i - lo];
      int j0, j1;
      rows_in(t0, t1, st, st - 1, &j0, &j1);
      T* yl = y + lane * M;
      for (int j = j0 + threadIdx.x; j < min(j1, M); j += blockDim.x)
        yl[j] = zero_tile ? T(0) : w[(j + 1) * st - 1 - lo];
      return;
    }
  } else {
    const T* wl = work + lane * N;
    const T* xsl = xs + lane * M;
    bool nz = false;
    load_rows(w, lo, hi, [&](int i) {
      return (i & (st - 1)) == st - 1 ? xsl[(i + 1) / st - 1] : wl[i];
    }, &nz);
    zero_tile = !__syncthreads_or(nz) && lo >= n;
  }
  if (!zero_tile) back_levels(w, lo, hi, N, levels, a, c, d, sm);
  T* xl = x + lane * N;
  if (xl + lo != w) {  // the pure masked form may run in x itself
    for (int i = t0 + threadIdx.x; i < t1; i += blockDim.x)
      xl[i] = zero_tile ? T(0) : w[i - lo];
  }
}

template <typename T>
int launch(const void* b, void* work, const void* xs, void* y, void* x,
           const void* al, const void* be, const void* a, const void* c,
           const void* d, int64_t lanes, int N, int n,
           int levels, int C, int R, int tiles, int threads, void* scratch,
           cudaStream_t stream) {
  if (lanes <= 0 || tiles <= 0) return 0;
  if (lanes > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = C + 2 * R < N ? C + 2 * R : N;
  size_t smem = scratch != nullptr ? 0 : static_cast<size_t>(rows) * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  // One tile per lane in shared memory: stage the deep levels' coefficients
  // beside it when they fit.
  int stage = 0;
  if (scratch == nullptr && tiles == 1 && R == 0) {
    int lf, lb, foff, boff, frows, brows;
    small_levels(N, levels, threads, &lf, &lb, &foff, &boff, &frows, &brows);
    const size_t more = static_cast<size_t>(2 * frows + 3 * brows) * sizeof(T);
    if (smem + more <= static_cast<size_t>(kMaxSharedBytes)) {
      smem += more;
      stage = 1;
    }
  }
  auto kernel = cr_tile_kernel<T>;
  if (smem > 48 * 1024) {  // once per device: the most a block may use
    static bool raised[kMaxDevices] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSharedBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(lanes)), threads,
           smem, stream>>>(
      static_cast<const T*>(b), static_cast<T*>(work), static_cast<const T*>(xs),
      static_cast<T*>(y), static_cast<T*>(x), static_cast<const T*>(al),
      static_cast<const T*>(be), static_cast<const T*>(a), static_cast<const T*>(c),
      static_cast<const T*>(d), N, n, levels, C, R,
      static_cast<T*>(scratch), stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes by admm_tpu_torch/ops/_cuda.py.
// f64 selects double (else float).  al, be, a, c, d are the compacted
// coefficient stacks (ops/tridiag.py::compact_stacks); C, R, tiles,
// threads and scratch come from ops/tridiag.py::tile_plan.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int admm_cr_solve(int f64, const void* b, void* work, const void* xs,
                             void* y, void* x, const void* al, const void* be,
                             const void* a, const void* c, const void* d,
                             int64_t lanes, int N, int n,
                             int levels, int C, int R, int tiles, int threads,
                             void* scratch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(b, work, xs, y, x, al, be, a, c, d, lanes, N, n,
                              levels, C, R, tiles, threads, scratch, s)
             : launch<float>(b, work, xs, y, x, al, be, a, c, d, lanes, N, n,
                             levels, C, R, tiles, threads, scratch, s);
}

extern "C" const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
