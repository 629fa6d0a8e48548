// Flash attention on Hopper (sm_90a): o = softmax(mask(softcap(q * D^-1/2
// @ k^T))) @ v, one pass over the keys with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_kernel`): the same
// function, order of operations and masking rule.  q is scaled by
// D^-1/2 before the product; the softcap is tanh(s / cap) * cap on the
// scaled scores; the mask (causal: key <= query; window w: key > query -
// w; positions count from 0 for both) comes after the softcap and fills
// the finite -1e30, so a row with no valid key is the mean of v, as in
// both references.  Scores, the running max m, the running sum l and the
// accumulator are float32; inputs are float32 or bfloat16, and the output
// is in the input type.
//
// What bounds it on an H100: operations.  At Gemma 2's widths (D = 256,
// 8,192 positions) attention does ~2,000 flops per byte it must move, far
// above the ridge point.  Two routes, chosen by the wrapper from the type
// and the head dim:
//
// Tensor cores (`flash_attention_tc_launch`): bf16 at D = 64, 128, 256,
// the head dims of every full-width config.  Both products run as wgmma
// (bf16 in, float32 accumulate).
// * One block of 384 threads per (bh, 128 query rows): consumer
//   warpgroups 0 and 1 own 64 rows each, and one thread of warpgroup 2
//   issues TMA loads (setmaxnreg: 240 registers a consumer thread, 24 a
//   producer).  Q arrives once; K and V tiles of BN keys (64 at D = 256,
//   128 below) go through a ring of STAGES shared-memory stages, each K and
//   V tile with its own "full" mbarrier and each stage with an "empty" one
//   that the 8 consumer warps arrive on when their product has read it.
//   TMA writes 64-column boxes with the 128-byte swizzle that wgmma reads;
//   rows past the end of a head read as zeros.  At D = 256: Q 64 KB, two
//   stages of K and V 128 KB, one block per SM.
// * S = Q K^T: m64nBNk16 with both operands in shared memory (K-major).
//   bf16 products are exact in float32, so only the order of the sums
//   differs from the reference.  The scale goes on S in float32 (exact at
//   D = 64 and 256, one rounding at 128).
// * Softmax in registers on the accumulator fragment: a row lives in the
//   4 threads of a quad (max and sum are two shuffles), exp is ex2 with
//   log2 e folded in, and the mask runs only on tiles that cut the
//   diagonal, the window's edge or the end of the keys.
// * The softcap needs tanh to much better than tanh.approx.f32: at
//   Gemma's scores (std 40, cap 50) a relative error of 2^-11 in tanh
//   puts ~40% of the outputs outside the bf16 check (rtol 2e-2, atol
//   1e-3).  1 - 2 / (e^(2y) + 1) costs two MUFU ops and is good to ~1e-7.
// * O += P V with P from registers (the S fragment is already the A
//   fragment's layout) and V MN-major from shared memory.  P rounded to
//   bf16 also misses the check (a few hundred outputs in 2M at Gemma's
//   widths), so P is split: hi = bf16(p), lo = bf16(p - hi), two wgmma
//   on the same V tile.  Right for every finite input, at 1.5x the
//   tensor work of a bf16 P.
// * Query tiles launch last-first (under the causal mask the last ones see
//   the most keys).  Key tiles that every row of the block masks are
//   skipped, unless some row of the block has no valid key at all: that
//   row needs every key for its mean.
//
// CUDA cores (`flash_attention_launch`): float32 inputs (their check is
// 1e-5, which TF32 cannot meet) and bf16 at D = 8, 16, 32, in float32
// FMAs:
// * One block of 256 threads per (bh, 64 query rows); the 64-key blocks of
//   K and V are staged through shared memory as float32 rows padded to
//   D + 4 floats, so a thread's float4 loads along D hit distinct banks.
//   Q (scaled), K, V and the 64 x 64 probability tile take 220 KB at
//   D = 256, one block per SM.
// * Thread (ty, tx) owns query rows ty + 16 i and keys tx + 16 j (i, j <
//   4): 16 scores from 8 float4 loads per 4 steps of D.  A row's 16
//   owners are 16 lanes of one warp, so the row max and sum are shuffles.
// * The accumulator lives in registers: the same thread owns the same
//   rows of o, columns 4 tx + 64 c (c < D / 64), at most 64 floats, so the
//   rescale by exp(m_old - m_new) needs no exchange.
// * Key blocks that every row of the query block masks are skipped (above
//   the causal diagonal, before the window), unless some row of the block
//   has no valid key at all: that row needs every key for its mean.
//   Keys past the end (a key count that is not a multiple of 64) score
//   -inf and add nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBKV = 64;      // keys per step
constexpr int kThreads = 256; // 16 x 16
constexpr int kLdP = kBKV + 16;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return 3 * kBQ * (D + 4) + kBQ * kLdP;
}

// rows [row0, row0 + valid) of a [*, D] matrix into a [64][D + 4] float
// tile times `scale`; rows past `valid` are zero.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int row0, int valid,
                          float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kBQ * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float vals[kVec];
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * D + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = to_f(e[i]) * scale;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
    float* out = dst + r * (D + 4) + c;
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(out + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int n_qblocks,
             int sq, int skv, int causal, int window, float softcap,
             float scale) {
  constexpr int kLd = D + 4;
  constexpr int kNC = (D + 63) / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kLd;
  float* vs = ks + kBKV * kLd;
  float* ps = vs + kBKV * kLd;

  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long head = static_cast<long long>(bh);
  const T* kb = k + head * skv * D;
  const T* vb = v + head * skv * D;
  load_rows<T, D>(qs, q + head * sq * D, q0, min(kBQ, sq - q0), scale);

  // the keys this query block can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  int lo = 0, hi = skv - 1;
  const bool has_empty_row =
      window > 0 && static_cast<long long>(q_last) >=
                        static_cast<long long>(skv) + window - 1;
  if (!has_empty_row) {
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(q_last, skv - 1);
  }

  float m[4], l[4], acc[4][kNC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int kblk = lo / kBKV; kblk <= hi / kBKV; ++kblk) {
    const int k0 = kblk * kBKV;
    const int k_valid = min(kBKV, skv - k0);
    __syncthreads();  // the previous step is done with ks, vs and ps
    load_rows<T, D>(ks, kb, k0, k_valid, 1.f);
    load_rows<T, D>(vs, vb, k0, k_valid, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = (!causal || kp <= qp) &&
                          (window == 0 || kp > qp - window);
        x = keep ? x : kMasked;
        x = kp < skv ? x : -INFINITY;  // no such key
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + j);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < D) {
          const float4 v0 = *reinterpret_cast<const float4*>(vs + (j + 0) * kLd + col);
          const float4 v1 = *reinterpret_cast<const float4*>(vs + (j + 1) * kLd + col);
          const float4 v2 = *reinterpret_cast<const float4*>(vs + (j + 2) * kLd + col);
          const float4 v3 = *reinterpret_cast<const float4*>(vs + (j + 3) * kLd + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i][c];
            a[0] = fmaf(pa[i].w, v3.x, fmaf(pa[i].z, v2.x, fmaf(pa[i].y, v1.x, fmaf(pa[i].x, v0.x, a[0]))));
            a[1] = fmaf(pa[i].w, v3.y, fmaf(pa[i].z, v2.y, fmaf(pa[i].y, v1.y, fmaf(pa[i].x, v0.y, a[1]))));
            a[2] = fmaf(pa[i].w, v3.z, fmaf(pa[i].z, v2.z, fmaf(pa[i].y, v1.z, fmaf(pa[i].x, v0.z, a[2]))));
            a[3] = fmaf(pa[i].w, v3.w, fmaf(pa[i].z, v2.w, fmaf(pa[i].y, v1.w, fmaf(pa[i].x, v0.w, a[3]))));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + (head * sq + qp) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(row + col + e, acc[i][c][e] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch(int bh, int sq, int skv, int causal, int window, float softcap,
           float scale, const void* q, const void* k, const void* v, void* o,
           void* stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qblocks = (sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(n_qblocks) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T, D><<<static_cast<int>(blocks), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_qblocks, sq, skv,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D = 64, 128, 256 takes the tensor-core route instead
template <typename T>
int launch_d(int d, int bh, int sq, int skv, int causal, int window,
             float softcap, float scale, const void* q, const void* k,
             const void* v, void* o, void* stream) {
  constexpr bool kWide = std::is_same<T, float>::value;
#define REPRO_D(N)                                                          \
  case N:                                                                   \
    return launch<T, N>(bh, sq, skv, causal, window, softcap, scale, q, k, \
                        v, o, stream)
#define REPRO_WIDE_D(N)                                                     \
  case N:                                                                   \
    if constexpr (kWide) {                                                  \
      return launch<T, N>(bh, sq, skv, causal, window, softcap, scale, q,  \
                          k, v, o, stream);                                 \
    }                                                                       \
    return static_cast<int>(cudaErrorInvalidValue)
  switch (d) {
    REPRO_D(8);
    REPRO_D(16);
    REPRO_D(32);
    REPRO_WIDE_D(64);
    REPRO_WIDE_D(128);
    REPRO_WIDE_D(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_D
#undef REPRO_WIDE_D
}


// ---------------------------------------------------------------------------
// Tensor-core route: bf16 at D in {64, 128, 256}
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kRows = 128;      // query rows per block, 64 per consumer
constexpr int kBox = 64;        // bf16 columns per TMA box (128 bytes)
constexpr float kLog2e = 1.4426950408889634f;

// 128-byte rows of one [rows x 64] box, swizzled by TMA: the canonical
// SW128 layout, 8-row groups 1,024 bytes apart.
template <int D, int BN, int STAGES>
struct Layout {
  static constexpr int kQBox = kBox * 128;          // 64 query rows
  static constexpr int kKVBox = BN * 128;           // BN keys
  static constexpr int kTile = BN * D * 2;          // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * D * 2;
  static constexpr int kV = kK + STAGES * kTile;
  static constexpr int kBar = kV + STAGES * kTile;  // q, k[S], v[S], empty[S]
  static constexpr int kBytes = kBar + (1 + 3 * STAGES) * 8 + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 3-D tensor map {column, row, head} into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head) : "memory");
}

// wgmma shared-memory descriptors for the SW128 layout (layout type 1 in
// bits 62-63, addresses and strides in 16-byte units).  K-major (rows of
// the operand along N or M, the reduction dim contiguous): SBO = 1,024
// bytes between 8-row groups, LBO unused.  MN-major (V: keys are the
// reduction dim, head dims contiguous): SBO = 1,024 bytes between groups
// of 8 keys, LBO = the stride between 64-column boxes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(box_bytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
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
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B, m64nNk16, bf16 in, float32 out.  _ss: A and B from shared
// memory (both K-major); acc = 0 overwrites d.  _rs: A from registers in
// the accumulator's own fragment order, B MN-major from shared memory.
#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16_(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)
#define F32(d) F16_(d, 0), F16_(d, 16)
#define F64(d) F32(d), F16_(d, 32), F16_(d, 48)
#define F128(d) F64(d), F16_(d, 64), F16_(d, 80), F16_(d, 96), F16_(d, 112)

template <int N>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F4
#undef F16_
#undef F32
#undef F64
#undef F128

template <int D, int BN, int STAGES, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int bh, int n_qblocks, int sq,
                int skv, int causal, int window, float softcap, float scale) {
  using L = Layout<D, BN, STAGES>;
  constexpr int kBoxes = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // SW128 wants 1 KB
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_empty = bar_v + 8 * STAGES;

  // the last query tiles first: under the causal mask they see most keys
  const int head = blockIdx.x % bh;
  const int q0 = (n_qblocks - 1 - blockIdx.x / bh) * kRows;
  const int q_last = min(q0 + kRows, sq) - 1;
  int lo = 0, hi = skv - 1;
  // a row with no valid key (Sq > Skv with a window) averages every key
  const bool has_empty_row =
      window > 0 && static_cast<long long>(q_last) >=
                        static_cast<long long>(skv) + window - 1;
  if (!has_empty_row) {
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(q_last, skv - 1);
  }
  const int t_lo = lo / BN;
  const int n_tiles = hi / BN - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, kRows * D * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kQ + (w * kBoxes + c) * L::kQBox, &tm_q, bar_q,
                   c * kBox, q0 + w * kBox, head);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(bar_empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + i) * BN;
        mbar_expect_tx(bar_k + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kK + s * L::kTile + c * L::kKVBox, &tm_k,
                   bar_k + 8 * s, c * kBox, k0, head);
        mbar_expect_tx(bar_v + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kV + s * L::kTile + c * L::kKVBox, &tm_v,
                   bar_v + 8 * s, c * kBox, k0, head);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = q0 + wg * 64;                      // warpgroup's first row
    const int row[2] = {r0 + 16 * (t / 32) + lane / 4,
                        r0 + 16 * (t / 32) + lane / 4 + 8};
    const int col0 = 2 * (lane % 4);
    // this thread's accumulator element j sits at row row[(j >> 1) & 1],
    // column (j >> 2) * 8 + col0 + (j & 1)
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    const float cap_arg = CAP ? scale * 2.f * kLog2e / softcap : 0.f;
    const uint32_t q_smem = base + L::kQ + wg * kBoxes * L::kQBox;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = (t_lo + i) * BN;
      const uint32_t k_smem = base + L::kK + s * L::kTile;
      const uint32_t v_smem = base + L::kV + s * L::kTile;

      // S = Q K^T: D / 16 steps along the head dim, 32 bytes each inside a
      // 128-byte swizzle row, then on to the next box
      float sc[BN / 2];
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * L::kKVBox + (kk % 4) * 32;
        wgmma_ss<BN>(sc, desc_k_major(q_smem + off),
                     desc_k_major(k_smem + koff), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(sc);

      // scale, softcap, mask: the reference's order
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        if (CAP) {
          // tanh(y) = 1 - 2 / (e^(2y) + 1), y = s / cap: two MUFU ops,
          // absolute error ~1e-7 (tanh.approx.f32's 2^-11 would not pass)
          const float e = ex2(sc[j] * cap_arg);
          sc[j] = softcap * (1.f - 2.f * rcp(e + 1.f));
        } else {
          sc[j] *= scale;
        }
      }
      const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 63 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int kp = k0 + (j >> 2) * 8 + col0 + (j & 1);
          const int qp = row[(j >> 1) & 1];
          const bool keep = (!causal || kp <= qp) &&
                            (window == 0 || kp > qp - window);
          float x = keep ? sc[j] : kMasked;
          sc[j] = kp < skv ? x : -INFINITY;   // no such key
        }
      }

      // online softmax on the fragment: a row lives in the 4 threads of a
      // quad, so its max and sum are two shuffles
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = ex2((m[h] - mx[h]) * kLog2e);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      // P = hi + lo, both bf16, in the A fragment's order: P rounded to
      // bf16 alone misses the bf16 check (see the file's head)
      uint32_t p_hi[BN / 4], p_lo[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {
        const int h = (j >> 1) & 1;
        const float p0 = ex2((sc[j] - m[h]) * kLog2e);
        const float p1 = ex2((sc[j + 1] - m[h]) * kLog2e);
        l[h] += p0 + p1;
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(p0, p1);
        p_hi[j / 2] = *reinterpret_cast<const uint32_t*>(&hi2);
        p_lo[j / 2] = pack_bf16(p0 - __low2float(hi2),
                                p1 - __high2float(hi2));
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

      // O += P_hi V + P_lo V: BN / 16 steps of 16 keys (2 KB of V each)
      mbar_wait(bar_v + 8 * s, parity);
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc_mn_major(v_smem + kk * 2048, L::kKVBox);
        wgmma_rs<D>(acc, p_hi + 4 * kk, dv);
        wgmma_rs<D>(acc, p_lo + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= sq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* out =
          o + (static_cast<long long>(head) * sq + row[h]) * D + col0;
#pragma unroll
      for (int j = 2 * h; j < D / 2; j += 4) {
        *reinterpret_cast<__nv_bfloat162*>(out + (j >> 2) * 8) =
            __floats2bfloat162_rn(acc[j] * inv, acc[j + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against the driver
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// [bh, s, d] bf16 as boxes of `rows` x 64 columns, 128-byte swizzle; rows
// past s read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
              int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BN, int STAGES, bool CAP>
int launch(int bh, int sq, int skv, int causal, int window, float softcap,
           float scale, const void* q, const void* k, const void* v, void* o,
           void* stream) {
  using L = Layout<D, BN, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, bh, sq, D, kBox) ||
      !make_map(&tm_k, k, bh, skv, D, BN) ||
      !make_map(&tm_v, v, bh, skv, D, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_tc_kernel<D, BN, STAGES, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qblocks = (sq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(n_qblocks) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<int>(blocks), kThreads, L::kBytes,
           static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), bh, n_qblocks, sq,
      skv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BN, int STAGES>
int launch_cap(int bh, int sq, int skv, int causal, int window, float softcap,
               float scale, const void* q, const void* k, const void* v,
               void* o, void* stream) {
  return softcap != 0.f
             ? launch<D, BN, STAGES, true>(bh, sq, skv, causal, window,
                                           softcap, scale, q, k, v, o, stream)
             : launch<D, BN, STAGES, false>(bh, sq, skv, causal, window,
                                            softcap, scale, q, k, v, o,
                                            stream);
}

}  // namespace tc

}  // namespace

// Launches attention on `stream` and returns cudaGetLastError() (0 on
// success): the CUDA-core route.  dtype 0: float32, 1: bfloat16 (q, k, v
// and o alike).  q / o [bh, sq, d], k / v [bh, skv, d], contiguous and
// 16-byte aligned; d is 8, 16, 32, 64, 128 or 256 for float32 and 8, 16
// or 32 for bfloat16; sq, skv >= 1; window >= 0.  window 0 means none,
// softcap 0 none.
extern "C" int flash_attention_launch(int dtype, int d, int bh, int sq,
                                      int skv, int causal, int window,
                                      float softcap, float scale,
                                      const void* q, const void* k,
                                      const void* v, void* o, void* stream) {
  if (bh < 1 || sq < 1 || skv < 1 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_d<float>(d, bh, sq, skv, causal, window, softcap, scale, q,
                           k, v, o, stream);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(d, bh, sq, skv, causal, window, softcap,
                                   scale, q, k, v, o, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: bf16 q, k, v and o, d = 64, 128 or 256, the rest
// as flash_attention_launch; every pointer 16-byte aligned.
extern "C" int flash_attention_tc_launch(int d, int bh, int sq, int skv,
                                         int causal, int window,
                                         float softcap, float scale,
                                         const void* q, const void* k,
                                         const void* v, void* o,
                                         void* stream) {
  if (bh < 1 || sq < 1 || skv < 1 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64:
      return tc::launch_cap<64, 128, 3>(bh, sq, skv, causal, window, softcap,
                                        scale, q, k, v, o, stream);
    case 128:
      return tc::launch_cap<128, 128, 2>(bh, sq, skv, causal, window,
                                         softcap, scale, q, k, v, o, stream);
    case 256:
      return tc::launch_cap<256, 64, 2>(bh, sq, skv, causal, window, softcap,
                                        scale, q, k, v, o, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
