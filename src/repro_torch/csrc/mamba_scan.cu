// Mamba-1 selective scan for NVIDIA Hopper (sm_90a), forward only, with a
// plain C interface for ctypes (repro_torch/kernels/mamba_scan/kernel.py).
//
// Replaces the TPU kernel `_scan_kernel` of
// src/repro/kernels/mamba_scan/kernel.py (driven there by
// `mamba_scan_padded`, wrapped by `ops.mamba_scan`):
//
//   h_t = exp(dt_t * negA) . h_{t-1} + (dt_t * u_t) B_t      (per channel d)
//   y_t = sum_k h_t[k] * C_t[k]
//
// u, dt, y are (B, S, di); Bm, Cm are (B, S, n) with a row stride of their
// own (the wrapper passes the views split off the x_proj output, no copy);
// negA = -exp(A_log) is (di, n) f32; h_last is (B, di, n).  u, dt, Bm, Cm
// are float32 or bfloat16 (one template); y and h_last are stored in u's
// type; the state h is f32 for the whole sequence.
//
// Differences from the TPU kernel, by design:
//  * The TPU grid's sequential chunk axis carries h in VMEM scratch from
//    one grid step to the next.  Blocks here run in no order, so the
//    whole sequence is a loop inside one thread, with h in registers.
//  * No padded copies.  The TPU wrapper zero-pads S and di to its blocks
//    (padded steps have dt = 0, so they leave h unchanged).  Here the
//    time loop stops at S and channels beyond di are masked, which is the
//    same function.
//  * The TPU kernel rounds y to the output type at each step; here y is
//    rounded once, at its store: the same elementwise cast.
//
// Design: one thread per (b, d) channel holding h[0..n) (n <= 16) in f32
// registers.  A block covers 128 consecutive d at one b, so for a fixed
// (b, t) the loads of u and dt and the store of y are coalesced.  A tile
// of TT time steps of Bm and Cm, which every d of the block shares, is
// staged in shared memory once per block.  Each thread then loads U
// steps of u and dt into registers ahead of their use (independent
// loads in flight together), and runs the recurrence with expf (not
// __expf, for parity with the plain version) and y summed over k in a
// fixed order.  No atomics: a repeat is bit-identical.  Every offset is
// 64-bit (B*S*di passes 2^31 at serving shapes such as 32 x 32k x 8192).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 off the tensor
// cores): bytes, narrowly.  Per channel and step it reads u and dt and
// writes y (3 elements) against about 6n = 96 f32 operations, n of them
// exps on the special-function units.  At falcon-mamba-7b's prefill
// (B, S, di, n) = (4, 512, 8192, 16) bf16 the bytes (100.7 MB) take
// about 30 us and the f32 operations (1.61 GFLOP) about 24 us.  One
// thread per channel gives B*di threads: 32,768 at that shape, but only
// 6,400 (50 blocks on 132 SMs) at hymba-1.5b's B = 2, di = 3200, so
// this simple design leaves the card mostly idle there; splitting n over
// lanes with a shuffle reduction is its next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels d per block
constexpr int TT = 64;         // time steps of Bm, Cm staged per tile
constexpr int U = 8;           // steps of u, dt loaded ahead per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid = (ceil(di / THREADS), B); block = THREADS.
template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ negA, const T* __restrict__ Bm,
            const T* __restrict__ Cm, T* __restrict__ y,
            T* __restrict__ h_last, int64_t S, int64_t di, int n,
            int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  __shared__ float sB[TT * NMAX];
  __shared__ float sC[TT * NMAX];
  const int64_t b = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;

  float nA[NMAX], h[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    nA[k] = (live && k < n) ? negA[d * n + k] : 0.f;
    h[k] = 0.f;
  }
  const int64_t row0 = b * S * di + d;   // (b, t = 0, d)
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  for (int64_t t0 = 0; t0 < S; t0 += TT) {
    const int steps = (int)(S - t0 < TT ? S - t0 : TT);
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < steps * NMAX; i += THREADS) {
      const int s = i / NMAX, k = i % NMAX;
      float bv = 0.f, cv = 0.f;
      if (k < n) {
        bv = to_f(Bb[(t0 + s) * b_st + k]);
        cv = to_f(Cb[(t0 + s) * c_st + k]);
      }
      sB[i] = bv;
      sC[i] = cv;
    }
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < steps; s0 += U) {
      float uu[U], dd[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const bool ok = s0 + j < steps;
        const int64_t off = row0 + (t0 + s0 + j) * di;
        uu[j] = ok ? to_f(u[off]) : 0.f;
        dd[j] = ok ? to_f(dt[off]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (s0 + j >= steps) break;
        const float dtv = dd[j];
        const float du = dtv * uu[j];
        const float* bk = sB + (s0 + j) * NMAX;
        const float* ck = sC + (s0 + j) * NMAX;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NMAX; ++k) {
          if (k < n) {
            const float a = expf(dtv * nA[k]);
            h[k] = fmaf(a, h[k], du * bk[k]);
            acc = fmaf(h[k], ck[k], acc);
          }
        }
        y[row0 + (t0 + s0 + j) * di] = from_f<T>(acc);
      }
    }
  }
  if (!live) return;
  T* hl = h_last + (b * di + d) * n;
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k < n) hl[k] = from_f<T>(h[k]);
}

template <typename T, int NMAX>
int launch(const void* u, const void* dt, const void* negA, const void* Bm,
           const void* Cm, void* y, void* h_last, int64_t B, int64_t S,
           int64_t di, int n, int64_t b_sb, int64_t b_st, int64_t c_sb,
           int64_t c_st, cudaStream_t st) {
  const dim3 grid((unsigned)((di + THREADS - 1) / THREADS), (unsigned)B);
  scan_kernel<T, NMAX><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(negA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(h_last),
      S, di, n, b_sb, b_st, c_sb, c_st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* u, const void* dt, const void* negA,
               const void* Bm, const void* Cm, void* y, void* h_last,
               int64_t B, int64_t S, int64_t di, int n, int64_t b_sb,
               int64_t b_st, int64_t c_sb, int64_t c_st, cudaStream_t st) {
  if (n <= 8)
    return launch<T, 8>(u, dt, negA, Bm, Cm, y, h_last, B, S, di, n, b_sb,
                        b_st, c_sb, c_st, st);
  return launch<T, 16>(u, dt, negA, Bm, Cm, y, h_last, B, S, di, n, b_sb,
                       b_st, c_sb, c_st, st);
}

}  // namespace

// u, dt (B, S, di) contiguous; negA (di, n) f32 contiguous; Bm, Cm
// (B, S, n) with unit stride along n and strides (b_sb, b_st) /
// (c_sb, c_st) in elements along (B, S); y (B, S, di) and h_last
// (B, di, n) contiguous, in the input type.  dtype 0 = float32,
// 1 = bfloat16, for u, dt, Bm, Cm, y and h_last alike.  1 <= n <= 16,
// B <= 65535.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue on a shape it does not take).
extern "C" int repro_mamba_scan_fwd(const void* u, const void* dt,
                                    const void* negA, const void* Bm,
                                    const void* Cm, void* y, void* h_last,
                                    int64_t B, int64_t S, int64_t di, int n,
                                    int64_t b_sb, int64_t b_st, int64_t c_sb,
                                    int64_t c_st, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || n <= 0 || n > 16 ||
      (di + THREADS - 1) / THREADS > (int64_t)0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_n<float>(u, dt, negA, Bm, Cm, y, h_last, B, S, di, n,
                             b_sb, b_st, c_sb, c_st, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(u, dt, negA, Bm, Cm, y, h_last, B, S,
                                     di, n, b_sb, b_st, c_sb, c_st, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
