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
//    whole sequence is a loop inside one block, with h in registers.
//  * No padded copies.  The TPU wrapper zero-pads S and di to its blocks
//    (padded steps have dt = 0, so they leave h unchanged).  Here the
//    time loop stops at S and channels beyond di are masked, which is the
//    same function.
//  * The TPU kernel rounds y to the output type at each step; here y is
//    rounded once, at its store: the same elementwise cast.
//
// What bounds it on an H100 SXM: the exps.  Per channel, step and state
// it takes one exp on the special-function units (16 results per clock
// per SM) against about six f32 operations; per channel and step it
// reads u and dt and writes y.  At falcon-mamba-7b's prefill (B, S, di,
// n) = (4, 512, 8192, 16) bf16 the 268 M exps take 64 us at 1.98 GHz on
// 132 SMs, the 100.7 MB 30 us; at hymba-1.5b's (2, 1536, 3200, 16) 38
// and 18 us.  The exps are independent across channels and states, so
// reaching that bound is a matter of keeping enough of them in flight:
// the first port ran one thread per (b, d) channel, 6,400 threads at
// hymba's shape (1.5 warps per SM), and sat at 2.6% of the bound.
//
// Design: L lanes per channel (L = 4, 8 or 16, a template argument; the
// caller takes the fewest that still give the card a few warps per SM,
// since each lane's share of the per-step work (loading u and dt, the
// shuffles, storing y) is paid once for its n / L states), each lane
// holding n / L consecutive states of the channel in f32 registers.  A
// block of 256 threads covers 256 / L consecutive channels at one b and
// walks the sequence in tiles of TT = 2048 / (256 / L) steps:
//  * u and dt for the tile (TT steps x the block's channels) are loaded
//    with coalesced 16-byte loads into registers while the previous
//    tile is computed, then stored to shared memory as they came (one
//    16-byte store a thread, no bank conflicts); Bm and Cm (TT x n, shared
//    by every channel of the block) beside them as f32;
//  * each lane runs the recurrence on its states, four steps at a time
//    (their exps are independent; only the h update chains), and the L
//    parts of y_t meet in a fixed butterfly of __shfl_xor_sync;
//  * the exp is ex2.approx.ftz of dt * negA * log2(e), negA scaled once
//    per lane: one MUFU.EX2 per exp, as expf issues, without expf's
//    range reduction, whose f32 instructions (not the special-function
//    unit) limited a draft of this design that kept expf.  It agrees
//    with the plain version's expf within the f32 check's 2e-5;
//  * y_t is rounded to the output type into a shared tile, stored with
//    coalesced 16-byte stores.
// No atomics and fixed summation orders: a repeat is bit-identical.
// Every offset is 64-bit (B*S*di passes 2^31 at serving shapes such as
// 32 x 32k x 8192).  Unrolling eight steps, or tiles of twice the steps,
// measured no faster on the H100.  At hymba-1.5b's 6,400 channels the
// card holds only about 6 warps per SM: a chunked two-pass scan over S
// (for small B * di) is the next step, not here yet; see ROADMAP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // per block: 256 / L channels
constexpr int TILE_ELEMS = 2048; // TT steps x channels staged per tile
constexpr int UNROLL = 4;        // steps computed together
constexpr float LOG2E = 1.4426950408889634f;

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

// 2^x on the special-function unit, denormal results flushed to 0 (a
// decay factor below 2^-126 leaves h unchanged to f32 precision).
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// NPL consecutive floats of shared memory, as one vector load.
template <int NPL>
__device__ __forceinline__ void load_states(const float* p, float (&out)[NPL]) {
  if constexpr (NPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (NPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) out[i] = p[i];
  }
}

// grid = (ceil(di / (THREADS / L)), B); block = THREADS.  `vec` says
// whether u, dt and y rows take 16-byte accesses (di a multiple of the
// vector and aligned pointers); otherwise element by element.
template <typename T, int NMAX, int L>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ negA, const T* __restrict__ Bm,
            const T* __restrict__ Cm, T* __restrict__ y,
            T* __restrict__ h_last, int64_t S, int64_t di, int n,
            int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
            int vec) {
  constexpr int CH = THREADS / L;                 // channels per block
  constexpr int TT = TILE_ELEMS / CH;             // steps per tile
  constexpr int NPL = NMAX / L;                   // states per lane
  constexpr int VEC = 16 / sizeof(T);             // elements per 16 bytes
  constexpr int CV = CH / VEC;                    // vectors per step
  constexpr int USLOTS = TT * CV / THREADS;       // u/dt vectors / thread
  constexpr int BSLOTS = TT * NMAX / THREADS;     // Bm/Cm values / thread
  static_assert(NPL >= 1 && CH % VEC == 0 && USLOTS >= 1 && BSLOTS >= 1 &&
                    TT % UNROLL == 0,
                "lanes, states, vectors and tiles");
  // u, dt and y tiles (step-major, the block's channels contiguous) in
  // the input type, so a thread's 16-byte vector lands in one store
  __shared__ __align__(16) T su[TT * CH];
  __shared__ __align__(16) T sdt[TT * CH];
  __shared__ __align__(16) T sy[TT * CH];
  __shared__ __align__(16) float sB[TT * NMAX];
  __shared__ __align__(16) float sC[TT * NMAX];

  const int64_t b = blockIdx.y;
  const int64_t d0 = (int64_t)blockIdx.x * CH;
  const int c = threadIdx.x / L;       // channel in the block
  const int j = threadIdx.x % L;       // lane in the channel
  const int64_t d = d0 + c;
  const bool live = d < di;
  const int k0 = j * NPL;              // this lane's first state

  // exp(dt * negA) = exp2(dt * negA * log2(e)); states k >= n have
  // negA = 0 and Bm = Cm = 0, so they stay 0 and add 0 to y
  float nA[NPL], h[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    nA[i] = (live && k0 + i < n) ? negA[d * n + k0 + i] * LOG2E : 0.f;
    h[i] = 0.f;
  }
  const int64_t base = b * S * di;     // (b, t = 0, d = 0)
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  // the next tile, fetched into registers while this one is computed;
  // steps past S and channels past di are 0
  uint4 pu[USLOTS], pd[USLOTS];
  float pb[BSLOTS], pc[BSLOTS];
  auto fetch = [&](int64_t t0) {
    const int steps = (int)(S - t0 < TT ? S - t0 : TT);
#pragma unroll
    for (int q = 0; q < USLOTS; ++q) {
      const int slot = threadIdx.x + q * THREADS;
      const int s = slot / CV;
      const int64_t dc = d0 + (slot % CV) * VEC;
      const int64_t off = base + (t0 + s) * di + dc;
      if (s < steps && vec && dc + VEC <= di) {
        pu[q] = *reinterpret_cast<const uint4*>(u + off);
        pd[q] = *reinterpret_cast<const uint4*>(dt + off);
      } else {
        T* eu = reinterpret_cast<T*>(&pu[q]);
        T* ed = reinterpret_cast<T*>(&pd[q]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const bool ok = s < steps && dc + e < di;
          eu[e] = ok ? u[off + e] : from_f<T>(0.f);
          ed[e] = ok ? dt[off + e] : from_f<T>(0.f);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < BSLOTS; ++q) {
      const int i = threadIdx.x + q * THREADS;
      const int s = i / NMAX, k = i % NMAX;
      const bool ok = s < steps && k < n;
      pb[q] = ok ? to_f(Bb[(t0 + s) * b_st + k]) : 0.f;
      pc[q] = ok ? to_f(Cb[(t0 + s) * c_st + k]) : 0.f;
    }
  };

  fetch(0);
  for (int64_t t0 = 0; t0 < S; t0 += TT) {
    const int steps = (int)(S - t0 < TT ? S - t0 : TT);
    __syncthreads();   // the previous tile is consumed and stored
#pragma unroll
    for (int q = 0; q < USLOTS; ++q) {
      const int slot = threadIdx.x + q * THREADS;
      *reinterpret_cast<uint4*>(su + slot * VEC) = pu[q];
      *reinterpret_cast<uint4*>(sdt + slot * VEC) = pd[q];
    }
#pragma unroll
    for (int q = 0; q < BSLOTS; ++q) {
      sB[threadIdx.x + q * THREADS] = pb[q];
      sC[threadIdx.x + q * THREADS] = pc[q];
    }
    __syncthreads();
    if (t0 + TT < S) fetch(t0 + TT);

    // UNROLL steps at a time: their exps are independent, only the h
    // update chains.  Steps past `steps` hold dt = 0 and Bm = 0, which
    // leave h exactly unchanged; their y is not stored.
    for (int s0 = 0; s0 < steps; s0 += UNROLL) {
      float acc[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        const float dtv = to_f(sdt[(s0 + q) * CH + c]);
        const float du = dtv * to_f(su[(s0 + q) * CH + c]);
        float bk[NPL], ck[NPL], a[NPL];
        load_states<NPL>(sB + (s0 + q) * NMAX + k0, bk);
        load_states<NPL>(sC + (s0 + q) * NMAX + k0, ck);
#pragma unroll
        for (int i = 0; i < NPL; ++i) a[i] = exp2_ftz(dtv * nA[i]);
        acc[q] = 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          h[i] = fmaf(a[i], h[i], du * bk[i]);
          acc[q] = fmaf(h[i], ck[i], acc[q]);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) {
#pragma unroll
        for (int q = 0; q < UNROLL; ++q)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
      }
      if (j == 0) {
#pragma unroll
        for (int q = 0; q < UNROLL; ++q)
          sy[(s0 + q) * CH + c] = from_f<T>(acc[q]);
      }
    }
    __syncthreads();

    // y: the tile back out, one 16-byte vector per access
    for (int slot = threadIdx.x; slot < steps * CV; slot += THREADS) {
      const int s = slot / CV;
      const int64_t dc = d0 + (slot % CV) * VEC;
      const int64_t off = base + (t0 + s) * di + dc;
      if (vec && dc + VEC <= di) {
        *reinterpret_cast<uint4*>(y + off) =
            *reinterpret_cast<const uint4*>(sy + slot * VEC);
      } else {
        for (int e = 0; e < VEC; ++e)
          if (dc + e < di) y[off + e] = sy[slot * VEC + e];
      }
    }
  }
  if (!live) return;
  T* hl = h_last + (b * di + d) * n;
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    if (k0 + i < n) hl[k0 + i] = from_f<T>(h[i]);
}

template <typename T, int NMAX, int L>
int launch(const void* u, const void* dt, const void* negA, const void* Bm,
           const void* Cm, void* y, void* h_last, int64_t B, int64_t S,
           int64_t di, int n, int64_t b_sb, int64_t b_st, int64_t c_sb,
           int64_t c_st, cudaStream_t st) {
  constexpr int CH = THREADS / L;
  constexpr int VEC = 16 / sizeof(T);
  const int64_t blocks = (di + CH - 1) / CH;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = di % VEC == 0 &&
                  (reinterpret_cast<uintptr_t>(u) |
                   reinterpret_cast<uintptr_t>(dt) |
                   reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  scan_kernel<T, NMAX, L><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(negA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(h_last),
      S, di, n, b_sb, b_st, c_sb, c_st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const void* dt, const void* negA, const void* Bm,
             const void* Cm, void* y, void* h_last, int64_t B, int64_t S,
             int64_t di, int n, int64_t b_sb, int64_t b_st, int64_t c_sb,
             int64_t c_st, int lanes, cudaStream_t st) {
#define REPRO_SCAN_LAUNCH(NMAX, L)                                         \
  return launch<T, NMAX, L>(u, dt, negA, Bm, Cm, y, h_last, B, S, di, n,   \
                            b_sb, b_st, c_sb, c_st, st)
  if (n <= 8) {
    if (lanes == 4) REPRO_SCAN_LAUNCH(8, 4);
    if (lanes == 8) REPRO_SCAN_LAUNCH(8, 8);
  } else {
    if (lanes == 4) REPRO_SCAN_LAUNCH(16, 4);
    if (lanes == 8) REPRO_SCAN_LAUNCH(16, 8);
    if (lanes == 16) REPRO_SCAN_LAUNCH(16, 16);
  }
#undef REPRO_SCAN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// u, dt (B, S, di) contiguous; negA (di, n) f32 contiguous; Bm, Cm
// (B, S, n) with unit stride along n and strides (b_sb, b_st) /
// (c_sb, c_st) in elements along (B, S); y (B, S, di) and h_last
// (B, di, n) contiguous, in the input type.  dtype 0 = float32,
// 1 = bfloat16, for u, dt, Bm, Cm, y and h_last alike.  1 <= n <= 16,
// B <= 65535; `lanes` per channel is 4 or 8 (n <= 8) or 4, 8 or 16
// (n <= 16).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue on a shape it does not take).
extern "C" int repro_mamba_scan_fwd_lanes(
    const void* u, const void* dt, const void* negA, const void* Bm,
    const void* Cm, void* y, void* h_last, int64_t B, int64_t S, int64_t di,
    int n, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st, int lanes,
    int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || n <= 0 || n > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(u, dt, negA, Bm, Cm, y, h_last, B, S, di, n, b_sb,
                           b_st, c_sb, c_st, lanes, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(u, dt, negA, Bm, Cm, y, h_last, B, S, di,
                                   n, b_sb, b_st, c_sb, c_st, lanes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same, with the lanes per channel picked as kernel.py's
// `choose_lanes` picks them: the fewest of 4, 8, 16 (at most 8 for
// n <= 8) that give B * di * lanes >= 2^14 threads, else the most.
extern "C" int repro_mamba_scan_fwd(const void* u, const void* dt,
                                    const void* negA, const void* Bm,
                                    const void* Cm, void* y, void* h_last,
                                    int64_t B, int64_t S, int64_t di, int n,
                                    int64_t b_sb, int64_t b_st, int64_t c_sb,
                                    int64_t c_st, int dtype, void* stream) {
  const int most = n <= 8 ? 8 : 16;
  int lanes = most;
  for (int l = 4; l < most; l *= 2) {
    if (B * di * l >= (int64_t)1 << 14) {
      lanes = l;
      break;
    }
  }
  return repro_mamba_scan_fwd_lanes(u, dt, negA, Bm, Cm, y, h_last, B, S, di,
                                    n, b_sb, b_st, c_sb, c_st, lanes, dtype,
                                    stream);
}
