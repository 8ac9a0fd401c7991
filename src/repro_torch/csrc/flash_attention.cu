// Flash-attention forward (and, for training, backward) for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes
// (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (driven there by
// `flash_attention_padded`, wrapped by `ops.flash_attention`), and
// computes the same function: blocked online-softmax attention with GQA
// (kv head = h / (H / Hk)), a causal mask and a sliding-window mask
// whose width is a runtime int (a key is masked when kpos <= qpos -
// window), with m, l and the accumulator in f32 and the output in q's
// type.  A row whose keys are all masked writes 0.
//
// Differences from the TPU kernel, by design:
//  * No padded copies of q/k/v.  The TPU wrapper zero-pads S to its
//    128 block and the kernel masks padded keys only through the causal
//    test, so bidirectional attention at a padded S is wrong there.
//    Here every key at or beyond the true S is masked (`kpos < S`), and
//    rows of the ragged last query tile are not stored.
//  * The TPU grid's sequential k axis becomes a loop inside the block.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), as
// chip_smoke.py's flash_bound counts it (q, k, v read once, o written
// once, 4 * hd FLOPs per visible (query, key) pair and head):
//  * MicroLlama-300M prefill (B, S, H, Hk, hd) = (4, 512, 16, 4, 64),
//    causal, bf16: 10.5 MB against 2.2 GFLOP, bytes-bound, 3.13 us;
//  * hymba-1.5b prefill (2, 1536, 25, 5, 64), bf16, global layers:
//    15.1 GFLOP, operations-bound, 15.3 us; its local layers (window
//    1024): 13.4 GFLOP, 13.6 us;
//  * gemma3-4b prefill (2, 2048, 8, 4, 256), bf16, global layers:
//    34.4 GFLOP against 50.3 MB, operations-bound, 34.8 us; its local
//    layers (window 1024): 25.8 GFLOP, 26.1 us.
// Both products are matrix products, so the tensor cores set the bound
// at the longer shapes, and f32 FMAs on the CUDA cores (67 TFLOP/s)
// cannot come near it.
//
// Two kernels:
//
// 1. bf16 with hd % 16 == 0 and hd <= 256 (every head dim of the
//    repository's attention configs, gemma3-4b's 256 included): both
//    products on the tensor cores with `wgmma`.  One CTA of one
//    warpgroup (128 threads) per (batch, q head, 64-query tile).
//    * Loads: TMA, issued by one elected thread, into 128-byte-swizzled
//      shared memory, the layout the wgmma descriptors read.  The tensor
//      maps are 4-d over (hd, heads, S, B) with boxes of (64, 1, 64, 1),
//      so the ragged last tile of S and the dims of hd past a multiple
//      of 64 are zero-filled by the hardware, never read from the next
//      row.  The Q tile (64 x hd) is loaded once; K and V tiles of 64
//      keys of the mapped kv head stream through two stages, each with
//      an mbarrier that the copy completes.  A stage is refilled (tile
//      i + 2) once every warp's products on tile i have finished.
//    * S = Q K^T: wgmma m64n64k16 from shared memory, K-major on both
//      sides (K is stored (key, hd) with hd contiguous), f32
//      accumulators in registers.
//    * Masks (causal, window, kpos < S) are applied to the accumulator
//      fragment only on tiles that straddle a boundary; tiles wholly
//      past the causal limit or before the window are never loaded.
//      The online softmax runs in f32 registers in base 2 (scores
//      pre-scaled by log2(e) / sqrt(hd)); a row's max and sum meet over
//      the four threads that hold it.
//    * O += P V: P is rounded to bf16 in registers and fed as the A
//      operand of wgmma m64n{64,128}k16 (the register form): the
//      accumulator layout of the first product is the A-fragment layout
//      of the second.  V, stored (key, hd) with hd contiguous, is
//      MN-major for operand B and is read through the transpose bit.
//      At hd 256 O's 256 columns are two m64n128 products on the two
//      halves of V's tile, into the two halves of one 128-register
//      accumulator array (the layout of one m64n256 product), so S's
//      32 registers and P's 16 fit beside it under 255 a thread.
//      Shared memory there: Q 32 KB and two stages of K + V at 64 KB
//      each, 160 KB, so one CTA per SM.
//    * Epilogue: divide by l, round to bf16, store rows < S.
//    Within the warpgroup the two products and the softmax run one after
//    another; the CTAs resident on an SM (four at hd 64) overlap each
//    other's.  Drafts with two consumer warpgroups per CTA, three or four
//    stages, or the next tile's S product issued before this tile's
//    softmax were no faster on the H100: ptxas serialized the
//    overlapped wgmmas (C7514/C7515).  See ROADMAP for the next step.
//    The tensor maps are encoded on the host for each call through
//    cuTensorMapEncodeTiled, found with the runtime's driver entry point
//    query, so the library links nothing beyond the runtime.
//
// 2. Everything else the wrapper takes (f32, and bf16 with hd % 8 == 0
//    but not % 16, hd <= 256): the first port's kernel, both products
//    as f32 FMAs on the CUDA cores.  One block of 256 threads per
//    (batch, q head, 64-query tile), four threads per query row (a
//    quarter of its dims each, partial dot products met in two warp
//    shuffles), K/V tiles of 32 keys (16 at hd > 128, so the two f32
//    tiles stay in 48 KB of static shared memory) staged as f32.  f32 stays off the tensor
//    cores on purpose: TF32 keeps about three digits, and the f32
//    serving paths are held to 1e-4 of their plain versions.
//
// The training route (causal bf16, hd 64 or 128, no window) adds the
// tensor-core forward's log-sum-exp store and three backward kernels,
// after the forward below.  They replace no TPU kernel: the JAX package
// has no flash backward and trains on its plain attention, whose f32
// (B, H, S, S) score passes held most of the port's training step.
//
// See PERF.md for the measured times.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace fma_path {


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

// HDP: head_dim padded up to 32, 64, 128 or 256; dims in [hd, HDP)
// are zero.  BKH keys per tile: 2 * BKH * HDP f32 fit 48 KB.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hk, int hd, int causal, int window, float scale) {
  constexpr int NC = HDP / 16;         // float4 chunks per thread
  constexpr int BKH = HDP > 128 ? BK / 2 : BK;
  __shared__ __align__(16) float Ks[BKH][HDP];
  __shared__ __align__(16) float Vs[BKH][HDP];

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
  if (lo > 0) k_begin = (int)(lo / BKH) * BKH;

  const size_t kv_row = (size_t)Hk * hd;
  const T* kb = k + ((size_t)b * S * Hk + hk) * hd;
  const T* vb = v + ((size_t)b * S * Hk + hk) * hd;
  const long long qlim = (long long)qpos - (long long)window;

  float m_i = -INFINITY;
  float l_i = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BKH) {
    for (int e = tid; e < BKH * HDP; e += THREADS) {
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

    float s[BKH];
#pragma unroll
    for (int j = 0; j < BKH; ++j) {
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
    for (int j = 0; j < BKH; ++j) m_t = fmaxf(m_t, s[j]);
    const float m_new = fmaxf(m_i, m_t);
    if (m_new != -INFINITY) {          // else: no visible key yet
      const float alpha = expf(m_i - m_new);
      l_i *= alpha;
#pragma unroll
      for (int i = 0; i < 4 * NC; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < BKH; ++j) {
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
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, B, S, H, Hk, hd, causal, window,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fma_path

namespace tc_path {

constexpr int BQ = 64;          // query rows per CTA: one warpgroup
constexpr int BK = 64;          // keys per K/V tile
constexpr int STAGES = 2;       // K/V tiles in flight
constexpr int THREADS = 128;    // one warpgroup
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16 of hd
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase `parity` has completed.  A copy that
// never lands (a bad tensor map) traps after about 2^26 tries instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from reading accumulators before wgmma_wait_all.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator constraints, eight registers at a time.
#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32) (+)= A (64 x 16, shared) * B (16 x 64, shared),
// both operands K-major (no transpose); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// shared, MN-major: the transpose bit is set).  D is the 64 registers
// d[OFF .. OFF + 63] of the caller's accumulator array.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(OFF), ACC8(OFF + 8), ACC8(OFF + 16), ACC8(OFF + 24),
        ACC8(OFF + 32), ACC8(OFF + 40), ACC8(OFF + 48), ACC8(OFF + 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

// K and V tile at keys k0.. of kv head hk into one stage (K at dst, V
// after it), completing on `bar`; one thread issues it.
template <int HDP>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t bar,
                                        uint32_t dst, int k0, int hk, int b) {
  constexpr int KV_BYTES = BK * HDP * 2;
  mbar_expect_tx(bar, 2 * KV_BYTES);
#pragma unroll
  for (int c = 0; c < HDP / 64; ++c) {
    tma_load(dst + c * BK * ROW_BYTES, kmap, bar, 64 * c, hk, k0, b);
    tma_load(dst + KV_BYTES + c * BK * ROW_BYTES, vmap, bar, 64 * c, hk, k0,
             b);
  }
}

// HDP: hd rounded up to 64, 128 or 256 (the swizzled column blocks of a
// row).
// Shared memory, 1024-byte aligned: Q (HDP/64 blocks of 64 rows x 128
// bytes), then per stage K and V (HDP/64 blocks of BK rows x 128 bytes
// each), then 1 + STAGES mbarriers (Q, then a stage's).
// WITH_LSE (training): also write each row's log-sum-exp of the scaled
// logits, natural log, into lse (B, H, Sp), Sp = S rounded up to BQ,
// the rows past S included (finite: their zero-filled queries see the
// keys before S).  The serving instantiation has no such store.
template <int HDP, bool WITH_LSE>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int H, int Hk, int hd, int causal, int window,
                float scale_log2) {
  constexpr int NCB = HDP / 64;                  // column blocks per row
  constexpr int Q_BYTES = BQ * HDP * 2;
  constexpr int KV_BYTES = BK * HDP * 2;         // one K or one V tile
  constexpr int NO = HDP / 2;                    // O accumulators / thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + Q_BYTES;             // stage s: K, then V
  const uint32_t bars = skv + STAGES * 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);

  // key range this query tile can see, in whole tiles
  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = 0;
  const long long lo = (long long)q0 - (long long)window + 1;
  if (lo > 0) k_begin = (int)(lo / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NCB; ++c)
      tma_load(sq + c * BQ * ROW_BYTES, &qmap, bars, 64 * c, h, q0, b);
    for (int i = 0; i < STAGES && i < ntiles; ++i)
      load_kv<HDP>(&kmap, &vmap, bars + 8 * (1 + i), skv + i * 2 * KV_BYTES,
                   k_begin + i * BK, hk, b);
  }

  // this thread's rows: r0 and r0 + 8 of the warp's 16
  const int r0 = q0 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);                 // its first column
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int k0 = k_begin + it * BK;
    const uint32_t sk = skv + s * 2 * KV_BYTES;
    const uint32_t sv = sk + KV_BYTES;
    mbar_wait(bars + 8 * (1 + s), (it / STAGES) & 1);

    // S = Q K^T: HDP / 16 steps of k16 along hd
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;     // 16 dims in the block
      wgmma_ss_n64(
          sacc, sw128_desc(sq + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024),
          sw128_desc(sk + (kk / 4) * BK * ROW_BYTES + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // masks, only where the tile straddles a boundary
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                      (long long)k0 <= (long long)q0 + BQ - 1 - window;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + cq + e;
          const bool in = kpos < S;
          const bool ok0 = in &&
                           (long long)kpos > (long long)r0 - window &&
                           (!causal || kpos <= r0);
          const bool ok1 = in &&
                           (long long)kpos > (long long)r1 - window &&
                           (!causal || kpos <= r1);
          if (!ok0) sacc[4 * j + e] = -INFINITY;
          if (!ok1) sacc[4 * j + 2 + e] = -INFINITY;
        }
      }
    }

    // online softmax in base 2; row max over the four threads of a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    // a row with no visible key yet keeps m = -inf, l = 0, O = 0
    const float a0 = mn0 == -INFINITY ? 1.f : exp2f(m0 - mn0);
    const float a1 = mn1 == -INFINITY ? 1.f : exp2f(m1 - mn1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      oacc[4 * j] *= a0;
      oacc[4 * j + 1] *= a0;
      oacc[4 * j + 2] *= a1;
      oacc[4 * j + 3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // masked: exp2(-inf) = 0
        const float p0 = exp2f(fmaf(sacc[4 * j + e], scale_log2, -mu0));
        const float p1 =
            exp2f(fmaf(sacc[4 * j + 2 + e], scale_log2, -mu1));
        sacc[4 * j + e] = p0;
        sacc[4 * j + 2 + e] = p1;
        l0 += p0;
        l1 += p1;
      }
    }
    // P as the A operand: keys 16 kk .. 16 kk + 15 of the tile
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }

    // O += P V: BK / 16 steps of k16 along the keys.  V's descriptor:
    // the next 8 keys 1024 bytes on (SBO), the next 64 dims of hd one
    // column block on (LBO); at hd 256 the second half of O's columns
    // starts two column blocks on.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv =
          sw128_desc(sv + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
      if constexpr (HDP == 64) {
        wgmma_rs_n64(oacc, pa[kk], dv);
      } else if constexpr (HDP == 128) {
        wgmma_rs_n128<0>(oacc, pa[kk], dv);
      } else {
        const uint64_t dv2 = sw128_desc(
            sv + 2 * BK * ROW_BYTES + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
            1024);
        wgmma_rs_n128<0>(oacc, pa[kk], dv);
        wgmma_rs_n128<64>(oacc, pa[kk], dv2);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);

    __syncthreads();   // every warp's products have read stage s
    if (tid == 0 && it + STAGES < ntiles)
      load_kv<HDP>(&kmap, &vmap, bars + 8 * (1 + s), sk, k0 + STAGES * BK,
                   hk, b);
  }

  // epilogue: the row sums meet over the four threads of a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if constexpr (WITH_LSE) {
    // m and l are in base 2 of the pre-scaled scores
    if (lane % 4 == 0) {
      float* lrow = lse + ((size_t)b * H + h) * (gridDim.x * BQ);
      lrow[r0] = (m0 + log2f(l0)) * LN2;
      lrow[r1] = (m1 + log2f(l1)) * LN2;
    }
  }
  __nv_bfloat16* o0 = o + (((size_t)b * S + r0) * H + h) * hd;
  __nv_bfloat16* o1 = o + (((size_t)b * S + r1) * H + h) * hd;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
}


// ---------------------------------------------------------------------
// Backward of causal attention (training), bf16, hd 64 or 128.  Three
// launches on one stream:
//   1. bwd_dot_kernel: D = rowsum(dO * O) in f32, (B, H, Sp), 0 past S.
//   2. flash_bwd_dkdv_kernel: one CTA of one warpgroup per (key tile of
//      64, kv head, batch).  K and V tiles are loaded once; the Q and dO
//      tiles of every query head of the kv head's group and every query
//      tile on or below the diagonal stream through two stages (tiles
//      wholly above it contribute exactly 0 and are never loaded).  Per
//      (head, query tile), with keys as the rows of every product:
//        S^T = K Q^T                          wgmma ss, f32
//        P^T = exp(S^T * scale - LSE)         f32 registers
//        dV += P^T dO                         wgmma rs, P^T in bf16
//        dP^T = V dO^T                        wgmma ss, f32
//        dS^T = P^T * (dP^T - D) * scale      f32, rounded to bf16
//        dK += dS^T Q                         wgmma rs
//      dK and dV stay in f32 registers across the whole group, so GQA
//      needs no atomics and no repeated k/v; one bf16 store at the end.
//   3. flash_bwd_dq_kernel: one CTA per (query tile, head, batch), the
//      heaviest (last) query tiles first.  Q, dO, LSE and D are loaded
//      once; K and V tiles up to the diagonal stream through two stages:
//        S = Q K^T, P = exp(S * scale - LSE), dP = dO V^T,
//        dS = P * (dP - D) * scale (bf16), dQ += dS K.
//      dQ stays in f32 registers, one bf16 store.  This separate sweep
//      recomputes S and dP (7 products per tile pair instead of 5) and
//      in exchange writes dQ once, with no atomics: the gradients are
//      the same bits on every run.
// Every product is one of the forward's two forms: both operands
// K-major from shared memory (A = the tile whose rows are the output's,
// B = the other tile, contracted over hd), or A from registers in the
// accumulator layout of the previous product and B a (rows, hd) tile
// read through the transpose bit.  Rounding follows the plain path's
// autograd: P and dS are bf16 at the products that take them, dP stays
// f32 (the plain path rounds it), scores stay f32 (the plain path
// rounds them to bf16 before its f32 softmax).
// Bound on an H100 SXM (989 TFLOP/s bf16 dense): 5 products of
// 2 * 64 * 64 * hd FLOPs per visible tile pair and head, half the
// square under causality; stablelm-1.6b's training shape (8, 2048, 32,
// 32, 64): 0.344 TFLOP, 0.35 ms; phi3-medium-14b's (4, 2048, 40, 10,
// 128): 0.430 TFLOP, 0.43 ms.  See PERF.md for the measured times.

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp per row
// (b, s, h) of the padded length Sp, rows past S write 0.
__global__ void __launch_bounds__(256)
bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout, float* __restrict__ D,
               int B, int S, int Sp, int H, int hd) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * Sp * H) return;
  const int h = (int)(row % H);
  const int s = (int)((row / H) % Sp);
  const int b = (int)(row / ((long long)H * Sp));
  float acc = 0.f;
  if (s < S) {
    const size_t off = (((size_t)b * S + s) * H + h) * hd;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + off + d));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) D[((size_t)b * H + h) * Sp + s] = acc;
}

// One 64-row tile (HDP / 64 column blocks) of one head at row r0.
template <int HDP>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t bar, uint32_t dst, int r0,
                                          int head, int b) {
#pragma unroll
  for (int c = 0; c < HDP / 64; ++c)
    tma_load(dst + c * BK * ROW_BYTES, map, bar, 64 * c, head, r0, b);
}

// The Q and dO tiles of head h at query q0 into one stage (Q at dst,
// dO after it), completing on `bar`; one thread issues it.
template <int HDP>
__device__ __forceinline__ void load_qdo(const CUtensorMap* qmap,
                                         const CUtensorMap* domap,
                                         uint32_t bar, uint32_t dst, int q0,
                                         int h, int b) {
  mbar_expect_tx(bar, 2 * BQ * HDP * 2);
  load_tile<HDP>(qmap, bar, dst, q0, h, b);
  load_tile<HDP>(domap, bar, dst + BQ * HDP * 2, q0, h, b);
}

// A (64 rows x HDP) tile at `sa` times the transpose of the tile at
// `sb`, contracted over hd: d = A B^T (64 x 64, f32).
template <int HDP>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t sa,
                                            uint32_t sb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(sa + off, 16, 1024),
                 sw128_desc(sb + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// acc (64 x HDP, f32) += A (64 x 64, the bf16 fragments `a`, contracted
// over its columns) times the (64 rows x HDP) tile at `sb`.
template <int HDP>
__device__ __forceinline__ void product_acc(float (&acc)[HDP / 2],
                                            const uint32_t (&a)[4][4],
                                            uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db =
        sw128_desc(sb + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
    if constexpr (HDP == 64) {
      wgmma_rs_n64(acc, a[kk], db);
    } else {
      wgmma_rs_n128<0>(acc, a[kk], db);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// The accumulator layout of a 64 x 64 product as the A fragments of the
// next: keys (or queries) 16 kk .. 16 kk + 15 of the tile.
__device__ __forceinline__ void pack_fragments(uint32_t (&a)[4][4],
                                               const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Rows r0 and r0 + 8 of a 64 x HDP f32 accumulator to bf16 rows of a
// (B, S, heads, HDP) tensor, rows < S only.
template <int HDP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[HDP / 2],
                                           int b, int S, int heads, int head,
                                           int r0, int cq) {
  __nv_bfloat16* o0 = out + (((size_t)b * S + r0) * heads + head) * HDP;
  __nv_bfloat16* o1 = o0 + (size_t)8 * heads * HDP;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Shared memory, 1024-byte aligned: K, V (one tile each), then per stage
// Q and dO, then 1 + STAGES mbarriers (K/V, then a stage's).
template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int Hk,
                      float scale, float scale_log2) {
  constexpr int TILE = BK * HDP * 2;
  constexpr int NO = HDP / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + TILE;
  const uint32_t ring = sv + TILE;               // stage s: Q, then dO
  const uint32_t bars = ring + STAGES * 2 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int Sp = gridDim.x * BK;
  const int first = k0 / BQ;                     // the diagonal query tile
  const int per_head = Sp / BQ - first;
  const int n = G * per_head;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it: head hk * G + it / per_head, query tile first + it %
  // per_head
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * TILE);
    load_tile<HDP>(&kmap, bars, sk, k0, hk, b);
    load_tile<HDP>(&vmap, bars, sv, k0, hk, b);
    for (int i = 0; i < STAGES && i < n; ++i)
      load_qdo<HDP>(&qmap, &domap, bars + 8 * (1 + i), ring + i * 2 * TILE,
                    (first + i % per_head) * BQ, hk * G + i / per_head, b);
  }

  // this thread's rows (keys) kr0 and kr0 + 8; columns (queries)
  // q0 + 8 j + cq + e
  const int kr0 = k0 + warp * 16 + lane / 4;
  const int kr1 = kr0 + 8;
  const int cq = 2 * (lane % 4);
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const int h = hk * G + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const uint32_t sq = ring + s * 2 * TILE;
    const uint32_t sdo = sq + TILE;
    const float* lrow = lse + ((size_t)b * H + h) * Sp + q0 + cq;
    const float* drow = dsum + ((size_t)b * H + h) * Sp + q0 + cq;
    mbar_wait(bars + 8 * (1 + s), (it / STAGES) & 1);

    float p[32];
    product_abt<HDP>(p, sk, sq);                 // S^T = K Q^T
    // the diagonal tile masks keys after the query; a ragged last tile
    // the queries at or past S (zero-filled; P = 0 keeps them out)
    const bool edge = q0 == k0 || q0 + BQ > S;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lc = (e ? l2.y : l2.x) * LOG2E;
        float p0 = exp2f(fmaf(p[4 * j + e], scale_log2, -lc));
        float p1 = exp2f(fmaf(p[4 * j + 2 + e], scale_log2, -lc));
        if (edge) {
          const int qpos = q0 + 8 * j + cq + e;
          if (qpos < kr0 || qpos >= S) p0 = 0.f;
          if (qpos < kr1 || qpos >= S) p1 = 0.f;
        }
        p[4 * j + e] = p0;
        p[4 * j + 2 + e] = p1;
      }
    }
    uint32_t a[4][4];
    pack_fragments(a, p);
    product_acc<HDP>(dva, a, sdo);               // dV += P^T dO

    float dp[32];
    product_abt<HDP>(dp, sv, sdo);               // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dc = e ? d2.y : d2.x;
        p[4 * j + e] *= (dp[4 * j + e] - dc) * scale;
        p[4 * j + 2 + e] *= (dp[4 * j + 2 + e] - dc) * scale;
      }
    }
    pack_fragments(a, p);
    product_acc<HDP>(dka, a, sq);                // dK += dS^T Q

    __syncthreads();   // every warp's products have read stage s
    if (tid == 0 && it + STAGES < n) {
      const int nx = it + STAGES;
      load_qdo<HDP>(&qmap, &domap, bars + 8 * (1 + s), sq,
                    (first + nx % per_head) * BQ, hk * G + nx / per_head, b);
    }
  }
  store_rows<HDP>(dk, dka, b, S, Hk, hk, kr0, cq);
  store_rows<HDP>(dv, dva, b, S, Hk, hk, kr0, cq);
}

// Shared memory, 1024-byte aligned: Q, dO (one tile each), then per
// stage K and V, then 1 + STAGES mbarriers (Q/dO, then a stage's).
template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int Hk,
                    float scale, float scale_log2) {
  constexpr int TILE = BK * HDP * 2;
  constexpr int NO = HDP / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + TILE;
  const uint32_t ring = sdo + TILE;              // stage s: K, then V
  const uint32_t bars = ring + STAGES * 2 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Sp = gridDim.x * BQ;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int n = (min(S, q0 + BQ) + BK - 1) / BK;     // key tiles to the diagonal

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * TILE);
    load_tile<HDP>(&qmap, bars, sq, q0, h, b);
    load_tile<HDP>(&domap, bars, sdo, q0, h, b);
    for (int i = 0; i < STAGES && i < n; ++i)
      load_kv<HDP>(&kmap, &vmap, bars + 8 * (1 + i), ring + i * 2 * TILE,
                   i * BK, hk, b);
  }

  // this thread's rows (queries) r0 and r0 + 8
  const int r0 = q0 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const float* lrow = lse + ((size_t)b * H + h) * Sp;
  const float* drow = dsum + ((size_t)b * H + h) * Sp;
  const float lc0 = lrow[r0] * LOG2E, lc1 = lrow[r1] * LOG2E;
  const float dc0 = drow[r0], dc1 = drow[r1];
  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    const uint32_t sk = ring + s * 2 * TILE;
    const uint32_t sv = sk + TILE;
    mbar_wait(bars + 8 * (1 + s), (it / STAGES) & 1);

    float p[32];
    product_abt<HDP>(p, sq, sk);                 // S = Q K^T
    float dp[32];
    product_abt<HDP>(dp, sdo, sv);               // dP = dO V^T
    const bool edge = k0 + BK - 1 > q0;          // the diagonal tile
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + cq + e;
        float p0 = exp2f(fmaf(p[4 * j + e], scale_log2, -lc0));
        float p1 = exp2f(fmaf(p[4 * j + 2 + e], scale_log2, -lc1));
        if (edge) {
          if (kpos > r0) p0 = 0.f;
          if (kpos > r1) p1 = 0.f;
        }
        p[4 * j + e] = p0 * (dp[4 * j + e] - dc0) * scale;
        p[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dc1) * scale;
      }
    }
    uint32_t a[4][4];
    pack_fragments(a, p);
    product_acc<HDP>(dqa, a, sk);                // dQ += dS K

    __syncthreads();   // every warp's products have read stage s
    if (tid == 0 && it + STAGES < n)
      load_kv<HDP>(&kmap, &vmap, bars + 8 * (1 + s), sk, k0 + STAGES * BK,
                   hk, b);
  }
  store_rows<HDP>(dq, dqa, b, S, H, h, r0, cq);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d map over a contiguous (B, S, heads, hd) bf16 tensor, innermost
// first: (hd, heads, S, B), with a box of (64, 1, 64, 1), 128-byte
// swizzle, zero fill outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd) {
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, bool WITH_LSE>
int launch_fwd(const CUtensorMap& qm, const CUtensorMap& km,
               const CUtensorMap& vm, void* o, float* lse, int B, int S,
               int H, int Hk, int hd, int causal, int window, float scale,
               cudaStream_t stream) {
  const int smem =
      BQ * HDP * 2 + STAGES * 2 * BK * HDP * 2 + (1 + STAGES) * 8 + 1024;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_tc_kernel<HDP, WITH_LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_tc_kernel<HDP, WITH_LSE><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, S, H, Hk, hd, causal,
      window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hk, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  static_assert(BQ == BK, "one box shape serves the Q and the K/V maps");
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, hd) || !make_map(&km, k, B, S, Hk, hd) ||
      !make_map(&vm, v, B, S, Hk, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lse != nullptr)
    return launch_fwd<HDP, true>(qm, km, vm, o, lse, B, S, H, Hk, hd, causal,
                                 window, scale, stream);
  return launch_fwd<HDP, false>(qm, km, vm, o, nullptr, B, S, H, Hk, hd,
                                causal, window, scale, stream);
}

template <int HDP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int B, int S, int H, int Hk, float scale,
               cudaStream_t stream) {
  const int Sp = (S + BQ - 1) / BQ * BQ;
  const long long rows = (long long)B * Sp * H;
  bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), dsum, B, S, Sp, H, HDP);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, B, S, H, HDP) || !make_map(&km, k, B, S, Hk, HDP) ||
      !make_map(&vm, v, B, S, Hk, HDP) || !make_map(&dom, dout, B, S, H, HDP))
    return static_cast<int>(cudaErrorInvalidValue);
  // two resident tiles and two per stage, 64 rows each
  const int smem = (2 + 2 * STAGES) * BK * HDP * 2 + (1 + STAGES) * 8 + 1024;
  const float scale_log2 = scale * LOG2E;
  rc = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HDP>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  flash_bwd_dkdv_kernel<HDP><<<dim3(Sp / BK, Hk, B), THREADS, smem, stream>>>(
      qm, km, vm, dom, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, Hk, scale, scale_log2);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(flash_bwd_dq_kernel<HDP>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  flash_bwd_dq_kernel<HDP><<<dim3(Sp / BQ, H, B), THREADS, smem, stream>>>(
      qm, km, vm, dom, lse, dsum, static_cast<__nv_bfloat16*>(dq), S, H, Hk,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_path

// q (B,S,H,hd), k/v (B,S,Hk,hd), o (B,S,H,hd), all contiguous, one
// dtype: 0 = float32, 1 = bfloat16; hd % 8 == 0 and hd <= 256.  bf16
// with hd % 16 == 0 runs the tensor-core kernel (16-byte aligned pointers);
// every other input the FMA kernel (the same rule as
// kernel.py's `choose_path`).  Launches on `stream`, allocates nothing
// on the device, returns cudaGetLastError() of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int B, int S, int H, int Hk, int hd,
                                         int causal, int window,
                                         float scale, int dtype,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && hd % 16 == 0) {
    if (hd <= 64)
      return tc_path::launch<64>(q, k, v, o, lse, B, S, H, Hk, hd, causal,
                                 window, scale, st);
    if (hd <= 128)
      return tc_path::launch<128>(q, k, v, o, lse, B, S, H, Hk, hd, causal,
                                  window, scale, st);
    return tc_path::launch<256>(q, k, v, o, lse, B, S, H, Hk, hd, causal,
                                window, scale, st);
  }
  if (lse != nullptr)   // the log-sum-exp is the tensor-core path's alone
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fma_path::dispatch_hd<float>(q, k, v, o, B, S, H, Hk, hd, causal,
                                        window, scale, st);
  if (dtype == 1)
    return fma_path::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Hk, hd,
                                                causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gradients of causal attention (no window) for the training forward
// above: q, o, dout, dq (B,S,H,hd), k, v, dk, dv (B,S,Hk,hd), bf16,
// contiguous, 16-byte aligned, hd 64 or 128; lse (B,H,Sp) the forward's,
// dsum (B,H,Sp) f32 scratch, Sp = S rounded up to 64.  Launches three
// kernels on `stream`, allocates nothing, returns the first launch
// error.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const float* lse,
                                         float* dsum, void* dq, void* dk,
                                         void* dv, int B, int S, int H,
                                         int Hk, int hd, float scale,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return tc_path::launch_bwd<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                   S, H, Hk, scale, st);
  if (hd == 128)
    return tc_path::launch_bwd<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                    B, S, H, Hk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
