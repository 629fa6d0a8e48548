// Chunked gated linear attention on Hopper (sm_90a): the RWKV6 / Mamba2
// recurrence
//
//   S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
//   y_t = q_t S_t                             (include_current, Mamba2)
//   y_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t  (otherwise, RWKV6)
//
// computed a chunk of L steps at a time, as the Pallas TPU kernel
// `gla_chunked` of src/repro/kernels/gla_chunk.py (body `_kernel`) does:
// with lc the inclusive cumulative log decay of the chunk and lq = lc
// (include_current) or lc shifted down one step (lq_t = lc_{t-1}, 0 at
// the first step),
//
//   y  = (q * exp(lq)) S_in + A v,
//   A[t, s] = sum_d q_td k_sd exp(lq_td - lc_sd)  for s <= t (s < t when
//             not include_current), plus (q_t . (u * k_t)) on the diagonal
//             whenever u is given,
//   S  = exp(l_last) * S_in + (k * exp(l_last - lc))^T v.
//
// The difference lq - lc is formed before the exponential, never as
// exp(lq) * exp(-lc): RWKV6's decays reach several units per step, so
// -lc passes 88 within a chunk and exp(-lc) overflows float32.  lq is the
// shifted lc rather than the reference's lc - w: the same value, one
// rounding fewer, and exactly 0 for neighbouring steps.
//
// The TPU's sequential chunk axis becomes a loop inside one block per
// (batch, head): the state S [Dk, Dv] stays in shared memory across
// chunks and nothing carries over between blocks.  q, k, v are float32 or
// bfloat16 (y is written in that type), w and u float32, the state
// float32; all arithmetic is float32.
//
// What bounds it on an H100: operations.  The intra-chunk term takes
// L^2 / 2 * Dk exponentials of differences per chunk (0.53 M at L = 128,
// Dk = 64) against L * (Dk + Dv) inputs, hundreds of operations per byte,
// and the exponentials run on the CUDA cores, not the tensor cores.  The
// design keeps every operand of a chunk in shared memory, float32, rows
// padded by 4 floats so that float4 loads hit distinct banks: q, k, the
// cumulative decay, v, A and S, 220 KB at L = 128, Dk = Dv = 64 (one block
// per SM).  Thread (ty, tx) of 256 owns rows ty + 16 i and columns
// tx + 16 j of A, so the blocks of A above the diagonal are known at
// compile time and skipped; the masked entries on the diagonal blocks are
// computed and discarded.  Limits: L <= 128, Dk and Dv <= 64 and
// multiples of 4 (the wrapper pads them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxL = 128;
constexpr int kMaxD = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Layout {
  int ldk, ldv, la, lda;
  int q, k, lc, v, a, s, u, total;  // float offsets into shared memory
};

__host__ __device__ inline Layout layout(int L, int dk, int dv) {
  Layout y;
  y.ldk = dk + 4;
  y.ldv = dv + 4;
  y.la = (L + 3) / 4 * 4;
  y.lda = y.la + 4;
  y.q = 0;
  y.k = y.q + L * y.ldk;
  y.lc = y.k + L * y.ldk;         // row 0 zeros, row t + 1 holds lc_t
  y.v = y.lc + (L + 1) * y.ldk;
  y.a = y.v + y.la * y.ldv;
  y.s = y.a + L * y.lda;
  y.u = y.s + dk * y.ldv;
  y.total = y.u + dk;
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gla_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ y,
           float* __restrict__ state, int t_len, int L, int dk, int dv,
           int include_current) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout ly = layout(L, dk, dv);
  float* qs = sm + ly.q;
  float* ks = sm + ly.k;
  float* lcs = sm + ly.lc;
  float* vs = sm + ly.v;
  float* as = sm + ly.a;
  float* ss = sm + ly.s;
  float* us = sm + ly.u;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int inc = include_current ? 1 : 0;  // lq_t is lcs row t + inc
  const long long bh = blockIdx.x;
  const T* qb = q + bh * t_len * dk;
  const T* kb = k + bh * t_len * dk;
  const T* vb = v + bh * t_len * dv;
  const float* wb = w + bh * t_len * dk;
  T* yb = y + bh * t_len * dv;
  const int col = 4 * tx;            // this thread's 4 columns of y and S
  const bool has_col = col < dv;

  for (int i = tid; i < dk * ly.ldv; i += kThreads) ss[i] = 0.f;
  for (int i = tid; i < ly.ldk; i += kThreads) lcs[i] = 0.f;
  for (int i = tid; i < dk; i += kThreads) us[i] = u ? u[bh * dk + i] : 0.f;
  for (int i = tid; i < (ly.la - L) * ly.ldv; i += kThreads)
    vs[L * ly.ldv + i] = 0.f;

  float sn[4][4];  // S rows ty + 16 i, columns col..col+3, after the chunk
  for (int c0 = 0; c0 < t_len; c0 += L) {
    __syncthreads();  // the previous chunk is done with every buffer
    const long long off = static_cast<long long>(c0);
    for (int i = tid; i < L * dk; i += kThreads) {
      const int t = i / dk, d = i % dk;
      qs[t * ly.ldk + d] = to_f(qb[off * dk + i]);
      ks[t * ly.ldk + d] = to_f(kb[off * dk + i]);
    }
    for (int i = tid; i < L * dv; i += kThreads) {
      const int t = i / dv, d = i % dv;
      vs[t * ly.ldv + d] = to_f(vb[off * dv + i]);
    }
    if (tid < dk) {  // inclusive cumulative log decay, one column a thread
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += wb[(off + t) * dk + tid];
        lcs[(t + 1) * ly.ldk + tid] = acc;
      }
    }
    __syncthreads();

    // intra-chunk: A[t, s], rows ty + 16 i, columns tx + 16 j; j > i is
    // above the diagonal and stays 0
    {
      float a[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
      for (int d = 0; d < dk; d += 4) {
        float4 kk[8], ll[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = min(tx + 16 * j, L - 1);
          kk[j] = *reinterpret_cast<const float4*>(ks + s * ly.ldk + d);
          ll[j] = *reinterpret_cast<const float4*>(lcs + (s + 1) * ly.ldk + d);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = min(ty + 16 * i, L - 1);
          const float4 qq = *reinterpret_cast<const float4*>(qs + t * ly.ldk + d);
          const float4 lq =
              *reinterpret_cast<const float4*>(lcs + (t + inc) * ly.ldk + d);
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            float x = a[i][j];
            x = fmaf(qq.x * kk[j].x, expf(lq.x - ll[j].x), x);
            x = fmaf(qq.y * kk[j].y, expf(lq.y - ll[j].y), x);
            x = fmaf(qq.z * kk[j].z, expf(lq.z - ll[j].z), x);
            x = fmaf(qq.w * kk[j].w, expf(lq.w - ll[j].w), x);
            a[i][j] = x;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          if (s >= ly.la) continue;
          const bool keep = j <= i && s < L && (include_current ? s <= t : s < t);
          as[t * ly.lda + s] = keep ? a[i][j] : 0.f;
        }
      }
    }
    __syncthreads();
    if (u) {  // the bonus on the diagonal
      if (tid < L) {
        float diag = 0.f;
        for (int d = 0; d < dk; ++d)
          diag += qs[tid * ly.ldk + d] * us[d] * ks[tid * ly.ldk + d];
        as[tid * ly.lda + tid] += diag;
      }
      __syncthreads();
    }

    // y = (q * exp(lq)) S_in + A v, then store y
    float ya[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[i][e] = 0.f;
    if (has_col) {
      for (int d = 0; d < dk; ++d) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + d * ly.ldv + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = ty + 16 * i;
          if (t < L) {
            const float qe = qs[t * ly.ldk + d] *
                             expf(lcs[(t + inc) * ly.ldk + d]);
            ya[i][0] = fmaf(qe, sv.x, ya[i][0]);
            ya[i][1] = fmaf(qe, sv.y, ya[i][1]);
            ya[i][2] = fmaf(qe, sv.z, ya[i][2]);
            ya[i][3] = fmaf(qe, sv.w, ya[i][3]);
          }
        }
      }
    }

    if (has_col) {
      for (int s = 0; s < ly.la; s += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (s + 0) * ly.ldv + col);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (s + 1) * ly.ldv + col);
        const float4 v2 = *reinterpret_cast<const float4*>(vs + (s + 2) * ly.ldv + col);
        const float4 v3 = *reinterpret_cast<const float4*>(vs + (s + 3) * ly.ldv + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = min(ty + 16 * i, L - 1);
          const float4 aa = *reinterpret_cast<const float4*>(as + t * ly.lda + s);
          ya[i][0] = fmaf(aa.w, v3.x, fmaf(aa.z, v2.x, fmaf(aa.y, v1.x, fmaf(aa.x, v0.x, ya[i][0]))));
          ya[i][1] = fmaf(aa.w, v3.y, fmaf(aa.z, v2.y, fmaf(aa.y, v1.y, fmaf(aa.x, v0.y, ya[i][1]))));
          ya[i][2] = fmaf(aa.w, v3.z, fmaf(aa.z, v2.z, fmaf(aa.y, v1.z, fmaf(aa.x, v0.z, ya[i][2]))));
          ya[i][3] = fmaf(aa.w, v3.w, fmaf(aa.z, v2.w, fmaf(aa.y, v1.w, fmaf(aa.x, v0.w, ya[i][3]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        if (t < L) {
          T* row = yb + (off + t) * dv + col;
#pragma unroll
          for (int e = 0; e < 4; ++e) store(row + e, ya[i][e]);
        }
      }
    }

    // S = exp(l_last) * S_in + (k * exp(l_last - lc))^T v; each thread
    // updates its own entries once every thread has read S_in above
    if (has_col) {
      const float* l_last = lcs + L * ly.ldk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ty + 16 * i;
        const float decay = d < dk ? expf(l_last[d]) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sn[i][e] = d < dk ? decay * ss[d * ly.ldv + col + e] : 0.f;
      }
      for (int s = 0; s < L; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + s * ly.ldv + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = ty + 16 * i;
          if (d < dk) {
            const float ke = ks[s * ly.ldk + d] *
                             expf(l_last[d] - lcs[(s + 1) * ly.ldk + d]);
            sn[i][0] = fmaf(ke, vv.x, sn[i][0]);
            sn[i][1] = fmaf(ke, vv.y, sn[i][1]);
            sn[i][2] = fmaf(ke, vv.z, sn[i][2]);
            sn[i][3] = fmaf(ke, vv.w, sn[i][3]);
          }
        }
      }
    }
    __syncthreads();
    if (has_col) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ty + 16 * i;
        if (d < dk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ss[d * ly.ldv + col + e] = sn[i][e];
        }
      }
    }
  }
  __syncthreads();
  float* sb = state + bh * dk * dv;
  for (int i = tid; i < dk * dv; i += kThreads)
    sb[i] = ss[(i / dv) * ly.ldv + i % dv];
}

template <typename T>
int launch(int bh, int t_len, int L, int dk, int dv, int include_current,
           const void* q, const void* k, const void* v, const void* w,
           const void* u, void* y, void* state, void* stream) {
  const int bytes = layout(L, dk, dv).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gla_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_kernel<T><<<bh, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(state), t_len, L, dk, dv, include_current);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the chunked GLA on `stream` and returns cudaGetLastError() (0
// on success).  dtype 0: float32, 1: bfloat16 (q, k, v and y alike).
// q / k / w [bh, t_len, dk], v / y [bh, t_len, dv], u [bh, dk] or null, w
// and u float32, state [bh, dk, dv] float32 out; all contiguous.  t_len a
// multiple of L; 1 <= L <= 128; dk and dv multiples of 4 up to 64.
extern "C" int gla_chunked_launch(int dtype, int bh, int t_len, int L,
                                  int dk, int dv, int include_current,
                                  const void* q, const void* k, const void* v,
                                  const void* w, const void* u, void* y,
                                  void* state, void* stream) {
  if (bh < 1 || L < 1 || L > kMaxL || t_len < 0 || t_len % L || dk < 4 ||
      dk > kMaxD || dk % 4 || dv < 4 || dv > kMaxD || dv % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(bh, t_len, L, dk, dv, include_current, q, k, v, w,
                         u, y, state, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(bh, t_len, L, dk, dv, include_current, q, k,
                                 v, w, u, y, state, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gla_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
