// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (driven there by
// `flash_attention_padded`, wrapped by `ops.flash_attention`), and
// computes the same function: blocked online-softmax attention with GQA
// (kv head = h / (H / Hk)), a causal mask and a sliding-window mask
// whose width is a runtime int, with m, l and acc in f32.  A row whose
// keys are all masked writes 0.
//
// Differences from the TPU kernel, by design:
//  * No padded copies of q/k/v.  The TPU wrapper zero-pads S to its
//    128 block and the kernel masks padded keys only through the causal
//    test, so bidirectional attention at a padded S is wrong there.
//    Here every key at or beyond the true S is masked (`kpos < S`), and
//    the ragged last query tile simply does not store its extra rows.
//  * The TPU grid's sequential k axis becomes a loop inside the block.
//
// Design: one thread block per (batch, q head, 64-query tile), 256
// threads, four threads per query row.  A thread holds a quarter of its
// query row and of its f32 accumulator in registers (dims
// 16*c + 4*lane + {0..3}), so the four partial dot products meet in two
// warp shuffles.  K/V tiles of 32 keys of the mapped kv head are staged
// in shared memory as f32 (bf16 inputs are widened on load); the online
// softmax runs in f32 registers; tiles wholly beyond the causal limit or
// wholly before the window are skipped.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
// at MicroLlama-300M's prefill (B=4, S=512, H=16, Hk=4, hd=64, causal,
// bf16) the call moves about 10.5 MB of q/k/v/o against about 2.1 GFLOP
// — bytes-bound (about 3.1 us against 2.2 us).  At B=1, S=2048 it is
// about 8.6 GFLOP against the same 10.5 MB — operations-bound (about
// 8.7 us).  This first version answers the bytes bound only: q is read
// once, o written once, K/V tiles are read once per query tile (the
// re-reads hit L2), and no intermediate (scores, probabilities) ever
// reaches device memory.  It does not answer the operations bound: the
// products run as f32 FMAs on the CUDA cores, not on the tensor cores,
// so the kernel stays well above both bounds.  wgmma and TMA are the
// next steps (see PERF.md for measured times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;                 // queries per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int LANES = 4;               // threads per query row
constexpr int THREADS = BQ * LANES;    // 256
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// HDP: head_dim padded up to 32, 64 or 128; dims in [hd, HDP) are zero.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hk, int hd, int causal, int window, float scale) {
  constexpr int NC = HDP / 16;         // float4 chunks per thread
  __shared__ __align__(16) float Ks[BK][HDP];
  __shared__ __align__(16) float Vs[BK][HDP];

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int qpos = q0 + row;
  const bool qvalid = qpos < S;

  float qr[4 * NC];
  float acc[4 * NC];
  const size_t qoff = (((size_t)b * S + (qvalid ? qpos : 0)) * H + h) * hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      qr[4 * c + e] = (qvalid && d < hd) ? to_f(q[qoff + d]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }

  // key range this query tile can see
  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = 0;
  const long long lo = (long long)q0 - (long long)window + 1;
  if (lo > 0) k_begin = (int)(lo / BK) * BK;

  const size_t kv_row = (size_t)Hk * hd;
  const T* kb = k + ((size_t)b * S * Hk + hk) * hd;
  const T* vb = v + ((size_t)b * S * Hk + hk) * hd;
  const long long qlim = (long long)qpos - (long long)window;

  float m_i = -INFINITY;
  float l_i = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BK * HDP; e += THREADS) {
      const int j = e / HDP;
      const int d = e % HDP;
      const int kpos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kpos < S && d < hd) {
        const size_t off = (size_t)kpos * kv_row + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      Ks[j][d] = kx;
      Vs[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[j][16 * c + 4 * lane]);
        part = fmaf(qr[4 * c + 0], kk.x, part);
        part = fmaf(qr[4 * c + 1], kk.y, part);
        part = fmaf(qr[4 * c + 2], kk.z, part);
        part = fmaf(qr[4 * c + 3], kk.w, part);
      }
      part += __shfl_xor_sync(FULL, part, 1);
      part += __shfl_xor_sync(FULL, part, 2);
      const int kpos = k0 + j;
      bool ok = kpos < S && (long long)kpos > qlim;
      if (causal) ok = ok && kpos <= qpos;
      s[j] = ok ? part * scale : -INFINITY;
    }

    float m_t = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) m_t = fmaxf(m_t, s[j]);
    const float m_new = fmaxf(m_i, m_t);
    if (m_new != -INFINITY) {          // else: no visible key yet
      const float alpha = expf(m_i - m_new);
      l_i *= alpha;
#pragma unroll
      for (int i = 0; i < 4 * NC; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s[j] - m_new);    // masked: exp(-inf) = 0
        l_i += p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[j][16 * c + 4 * lane]);
          acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m_i = m_new;
    }
    __syncthreads();
  }

  if (!qvalid) return;
  T* orow = o + (((size_t)b * S + qpos) * H + h) * hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      if (d < hd) {
        orow[d] = from_f<T>(l_i > 0.f ? acc[4 * c + e] / l_i : 0.f);
      }
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hk, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HDP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hk, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int Hk, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, S, H, Hk, hd, causal, window,
                         scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, Hk, hd, causal, window,
                         scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, Hk, hd, causal, window,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,Hk,hd), o (B,S,H,hd), all contiguous, one
// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`, allocates
// nothing, returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int H, int Hk, int hd,
                                         int causal, int window,
                                         float scale, int dtype,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || hd <= 0 ||
      hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, S, H, Hk, hd, causal, window,
                              scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Hk, hd, causal,
                                      window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
