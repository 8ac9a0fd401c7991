// Gradient-moment reduction for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes (repro_torch/kernels/gradstats/kernel.py).
//
// Replaces the two TPU kernels of src/repro/kernels/gradstats/kernel.py
// (driven there by `gradstats_padded`, wrapped by `ops.gradstats_reduce`):
//
//   `_colsum_kernel`  -> repro_gradstats_colsum:
//        gbar_j = (1/B) * sum_i G_ij
//     with an accumulate form for G streamed in row chunks:
//        acc_j = acc_j + sum_i G_ij   (divided by the whole B on the
//        last chunk), so a chunked sum adds the rows in the same order
//        as one pass and gives the same bits.
//   `_moments_kernel` -> repro_gradstats_moments:
//        s_i = sum_j G_ij^2,  d_i = sum_j G_ij * gbar_j,  n2 = sum_j gbar_j^2
//
// G is (B, D) row-major, float32 or bfloat16; every sum is in f32.  At
// the training main path G holds B = 8 rows of D = 304,636,928 (2.4e9
// elements, more than 2^31), so every index is 64-bit.
//
// Differences from the TPU kernels, by design:
//  * No padded copy of G.  The TPU wrapper zero-pads B and D to its
//    (8, 512) tiles and rescales afterwards.  Here rows are a plain loop
//    over the true B, columns beyond D are masked on load, and gbar is
//    divided by the true B, so nothing needs rescaling.
//  * The TPU grid's sequential axes carry accumulators between steps.
//    Blocks here run in no order, so the moments kernel writes one
//    partial (s, d) per (row, block) and a second pass sums the partials
//    in a fixed order.  n2 is summed the same way (the TPU path computes
//    it outside its kernel).  There are no float atomics: two calls on
//    the same G return bit-identical s, d, n2, which the batch decision
//    needs (every call must reach the same requested batch).
//
// Design:
//  * colsum: one thread per column; a warp reads 32 neighbouring
//    columns of a row (coalesced), and each thread adds its column over
//    the B rows in order, in an f32 register, starting from 0 or (the
//    accumulate form) from the column's running sum.
//  * moments: one block of 256 threads per chunk of 2048 columns; each
//    thread keeps its 8 gbar values in registers (columns tid + 256*c,
//    so each load of the warp is coalesced), reuses them for all B rows,
//    and the block reduces (s, d) per row with warp shuffles and one
//    fixed-order pass over the 8 warps.  The finish kernel has one block
//    per row (and one for n2) that sums that row's partials, strided
//    per thread and then across the block, in a fixed order.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 off the
// tensor cores): bytes.  Each pass reads G once (B*D*4 bytes in f32,
// 9.75 GB at the main path's (8, 304,636,928)) against about 2 FLOPs per
// element in colsum and 4 in moments, far below the ridge.  So the
// least time for the pair is two reads of G: the TPU's two-pass split
// is kept.  One read would need a one-pass design (the Gram matrix
// G G^T gives s, d and n2 at once), which ROADMAP lists for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int COLS = 8;                          // columns per thread
constexpr int64_t CHUNK = (int64_t)THREADS * COLS;  // per moments block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Fixed-order sum of two values over the block; the result is valid in
// thread 0.  `red` holds 2 * NWARPS floats.  Ends with a barrier, so
// `red` may be reused right away.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[NWARPS + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.f, tb = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      ta += red[w];
      tb += red[NWARPS + w];
    }
    a = ta;
    b = tb;
  }
  __syncthreads();
}

// divisor > 0 divides the sum by it; divisor == 0 stores the sum.
template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ G, float* __restrict__ gbar, int64_t B,
              int64_t D, int accumulate, float divisor) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= D) return;
  const T* col = G + j;
  float acc = accumulate ? gbar[j] : 0.f;
#pragma unroll 8
  for (int64_t i = 0; i < B; ++i) acc += to_f(col[i * D]);
  gbar[j] = divisor > 0.f ? acc / divisor : acc;
}

// Partials: ps, pd are (B, nblk) row-major, pn2 is (nblk,).
template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_kernel(const T* __restrict__ G, const float* __restrict__ gbar,
               float* __restrict__ ps, float* __restrict__ pd,
               float* __restrict__ pn2, int64_t B, int64_t D) {
  __shared__ float red[2 * NWARPS];
  const int64_t nblk = gridDim.x;
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * CHUNK + threadIdx.x;

  float gb[COLS];
  float n2 = 0.f, unused = 0.f;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int64_t j = base + (int64_t)c * THREADS;
    gb[c] = j < D ? gbar[j] : 0.f;
    n2 = fmaf(gb[c], gb[c], n2);
  }
  block_sum2(n2, unused, red);
  if (threadIdx.x == 0) pn2[blk] = n2;

  for (int64_t i = 0; i < B; ++i) {
    const T* row = G + i * D;
    float s = 0.f, d = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int64_t j = base + (int64_t)c * THREADS;
      const float g = j < D ? to_f(row[j]) : 0.f;
      s = fmaf(g, g, s);
      d = fmaf(g, gb[c], d);
    }
    block_sum2(s, d, red);
    if (threadIdx.x == 0) {
      ps[i * nblk + blk] = s;
      pd[i * nblk + blk] = d;
    }
  }
}

// Block r < B sums row r's partials into s[r], d[r]; block B sums the
// n2 partials.
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ ps, const float* __restrict__ pd,
              const float* __restrict__ pn2, int64_t nblk, int64_t B,
              float* __restrict__ s, float* __restrict__ d,
              float* __restrict__ n2) {
  __shared__ float red[2 * NWARPS];
  const int64_t r = blockIdx.x;
  const bool is_row = r < B;
  const float* a = is_row ? ps + r * nblk : pn2;
  const float* b = is_row ? pd + r * nblk : pn2;
  float x = 0.f, y = 0.f;
  for (int64_t k = threadIdx.x; k < nblk; k += THREADS) {
    x += a[k];
    y += b[k];
  }
  block_sum2(x, y, red);
  if (threadIdx.x != 0) return;
  if (is_row) {
    s[r] = x;
    d[r] = y;
  } else {
    *n2 = x;
  }
}

int64_t moments_blocks(int64_t D) { return (D + CHUNK - 1) / CHUNK; }

bool bad_shape(int64_t B, int64_t D) {
  return B <= 0 || D <= 0 ||
         (D + THREADS - 1) / THREADS > (int64_t)0x7fffffff ||
         B + 1 > (int64_t)0x7fffffff;
}

template <typename T>
int colsum(const void* G, void* gbar, int64_t B, int64_t D, int accumulate,
           float divisor, cudaStream_t st) {
  const unsigned grid = (unsigned)((D + THREADS - 1) / THREADS);
  colsum_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(G), static_cast<float*>(gbar), B, D, accumulate,
      divisor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int moments(const void* G, const void* gbar, void* s, void* d, void* n2,
            void* scratch, int64_t B, int64_t D, cudaStream_t st) {
  const int64_t nblk = moments_blocks(D);
  float* ps = static_cast<float*>(scratch);
  float* pd = ps + B * nblk;
  float* pn2 = pd + B * nblk;
  moments_kernel<T><<<(unsigned)nblk, THREADS, 0, st>>>(
      static_cast<const T*>(G), static_cast<const float*>(gbar), ps, pd,
      pn2, B, D);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  finish_kernel<<<(unsigned)(B + 1), THREADS, 0, st>>>(
      ps, pd, pn2, nblk, B, static_cast<float*>(s), static_cast<float*>(d),
      static_cast<float*>(n2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that repro_gradstats_moments needs for (B, D):
// (2 B + 1) partials per moments block.
extern "C" int64_t repro_gradstats_scratch_floats(int64_t B, int64_t D) {
  if (bad_shape(B, D)) return -1;
  return (2 * B + 1) * moments_blocks(D);
}

// G (B, D) contiguous, dtype 0 = float32, 1 = bfloat16 -> gbar (D,) f32:
// the column sums of G, added to gbar's values when `accumulate` is
// nonzero, divided by `divisor` when it is > 0.  One pass is
// (accumulate 0, divisor B).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int repro_gradstats_colsum(const void* G, void* gbar, int64_t B,
                                      int64_t D, int dtype, int accumulate,
                                      float divisor, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, D) || !(divisor >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return colsum<float>(G, gbar, B, D, accumulate, divisor, st);
  if (dtype == 1)
    return colsum<__nv_bfloat16>(G, gbar, B, D, accumulate, divisor, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// G (B, D) contiguous (dtype as above), gbar (D,) f32 -> s (B,), d (B,),
// n2 () f32, through `scratch` of repro_gradstats_scratch_floats(B, D)
// floats.  Two launches on `stream` (partials, then their fixed-order
// sum); allocates nothing; returns the first nonzero cudaGetLastError().
extern "C" int repro_gradstats_moments(const void* G, const void* gbar,
                                       void* s, void* d, void* n2,
                                       void* scratch, int64_t B, int64_t D,
                                       int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, D) || moments_blocks(D) > (int64_t)0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return moments<float>(G, gbar, s, d, n2, scratch, B, D, st);
  if (dtype == 1)
    return moments<__nv_bfloat16>(G, gbar, s, d, n2, scratch, B, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
