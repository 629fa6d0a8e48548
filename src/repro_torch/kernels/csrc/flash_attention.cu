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
// is in the input type.  Float32 inputs are multiplied in float32 (no
// TF32).
//
// What bounds it on an H100: operations.  At Gemma 2's widths (D = 256,
// 8,192 positions) attention does ~2,000 flops per byte it must move, far
// above the ridge point.  This first version runs on the CUDA cores in
// float32, so its ceiling is the float32 rate (67 TFLOP/s), not the
// tensor cores' bf16 rate its bound is taken at; moving the two products
// onto wgmma is later work.  What the design does within that:
//
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
int launch_d(int d, int bh, int sq, int skv, int causal, int window,
             float softcap, float scale, const void* q, const void* k,
             const void* v, void* o, void* stream) {
#define REPRO_D(N)                                                          \
  case N:                                                                   \
    return launch<T, N>(bh, sq, skv, causal, window, softcap, scale, q, k, \
                        v, o, stream)
  switch (d) {
    REPRO_D(8);
    REPRO_D(16);
    REPRO_D(32);
    REPRO_D(64);
    REPRO_D(128);
    REPRO_D(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_D
}

}  // namespace

// Launches attention on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 0: float32, 1: bfloat16 (q, k, v and o alike).  q / o
// [bh, sq, d], k / v [bh, skv, d], contiguous and 16-byte aligned; d is 8,
// 16, 32, 64, 128 or 256; sq, skv >= 1; window >= 0.  window 0 means
// none, softcap 0 none.
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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
