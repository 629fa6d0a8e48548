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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 q, k, v): three kernels over sub-chunks of 16
// ---------------------------------------------------------------------------
//
// What bounds this route on an H100: bytes (0.24 ms for RWKV6-1.6B's call
// at batch 8 x 4,096) and, close behind, the exponentials (16 a clock on an
// SM).  The CUDA-core route above spends L^2 / 2 * Dk exponentials and as
// many float32 products per chunk, one block per (batch, head) walking 32
// chunks in turn.  Here the work is cut three ways:
//
//   1. `delta_kernel`, one block per (bh, chunk), all at once: the chunk's
//      state increment dS_c = (k * exp(l_last - lc))^T v and its total
//      log decay l_last, on the tensor cores;
//   2. `recur_kernel`, one thread per (bh, d, e): S_c = exp(l_last_c) S_{c-1}
//      + dS_c over the chunks, writing the state entering each chunk as
//      bf16 hi and lo (the form the products take), and the final state;
//   3. `output_kernel`, one block of 8 warps per (bh, chunk), a warp per
//      16 rows: y = (q * exp(lq)) S_{c-1}
//      + A v.  A is cut into 16 x 16 blocks.  The diagonal blocks take the
//      per-channel exponentials exp(lq_td - lc_sd) of differences, as the
//      CUDA-core route does, on the CUDA cores (only the kept entries).
//      Every block below them is the product of (q_t exp(lq_t - m)) and
//      (k_s exp(m - lc_s)) over d, with m the lq of the first row of t's
//      sub-chunk: lq is non-increasing (w <= 0) and every such s precedes
//      that row, so both factors are at most 1 and nothing overflows, even
//      where RWKV6's decays pass 88 within a chunk.
//
// Products run as mma.sync m16n8k16, bf16 in and float32 sums.  A float32
// operand is split into bf16 hi + lo (x - hi rounds to lo): the decayed
// factors and the state take hi.hi + hi.lo + lo.hi, A and the decayed k
// meet the exact bf16 v as hi + lo, so each product keeps ~16 bits.  A
// warp owns 16 rows of dS or of y.  Dk = Dv = 64 (the wrapper pads), L a multiple of 16 up
// to 128.  A chunk's operands come into shared memory by asynchronous
// 16-byte copies (cp.async), all in flight at once, in their device-memory
// layout with rows padded by 16 bytes; B operands are read with
// ldmatrix.trans, so nothing is transposed on the way in.

namespace tc {

constexpr int kD = 64;
constexpr int kThreads = 128;      // delta_kernel: a warp per 16 rows of dS
constexpr int kOutThreads = 256;   // output_kernel: a warp per row block
constexpr int kLdB = kD + 8;   // bf16 row stride: 144 B, so the 8 rows an
                               // ldmatrix reads fall in distinct banks
constexpr int kLdF = kD + 4;   // float row stride of lc: 272 B, so rows
                               // 1, 2 or 4 apart read distinct banks

using bf16 = __nv_bfloat16;

struct Smem {  // byte offsets
  int lc, k, v, q, s, bonus, total;
};

__host__ __device__ inline Smem smem_layout(int L, bool output) {
  Smem y;
  int off = 0;
  y.lc = off;     // row 0 zeros, row t + 1 holds lc_t
  off += (L + 1) * kLdF * 4;
  y.k = off;      // k, v, q: [t][d] as in device memory
  off += L * kLdB * 2;
  y.v = off;
  off += L * kLdB * 2;
  y.q = off;
  off += output ? L * kLdB * 2 : 0;
  y.s = off;      // S_{c-1} as bf16 hi rows [d][e], then lo rows
  off += output ? 2 * kD * kLdB * 2 : 0;
  y.bonus = off;
  off += output ? L * 4 : 0;
  y.total = off;
  return y;
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of n-tiles n0 and n0 + 8 at k rows k0 .. k0 + 15 of a
// row-major [k][n] bf16 tile in shared memory: r[0], r[1] for n0, r[2],
// r[3] for n0 + 8 (one ldmatrix of four transposed 8 x 8 matrices).
__device__ __forceinline__ void ldsm_b_pair(unsigned (&r)[4],
                                            const bf16* base, int k0, int n0,
                                            int lane) {
  const bf16* p = base + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdB +
                  n0 + 8 * (lane >> 4);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

// (x, y) as bf16x2 hi and the rounding left over, lo
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// 2^x on the special-function unit; the output kernel's decays are scaled
// by log2(e) once, so each exponential of a difference is one subtraction
// and this
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage one chunk with asynchronous 16-byte copies, all in flight at
// once: w into lc rows 1..L (row 0 zero), k, v (and q) rows, and S_{c-1}'s
// hi and lo rows when given.  The caller synchronises the block.
__device__ void load_chunk(const float* wb, const bf16* kb, const bf16* vb,
                           const bf16* qb, const bf16* sb, int L, char* sm,
                           const Smem& ly) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  float* lc = reinterpret_cast<float*>(sm + ly.lc);
  bf16* ks = reinterpret_cast<bf16*>(sm + ly.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + ly.v);
  bf16* qs = reinterpret_cast<bf16*>(sm + ly.q);
  bf16* ss = reinterpret_cast<bf16*>(sm + ly.s);
  for (int i = tid; i < L * 16; i += nthreads) {
    const int t = i >> 4, c = 4 * (i & 15);
    cp_async16(lc + (t + 1) * kLdF + c, wb + t * kD + c);
  }
  for (int i = tid; i < L * 8; i += nthreads) {
    const int t = i >> 3, c = 8 * (i & 7);
    cp_async16(ks + t * kLdB + c, kb + t * kD + c);
    cp_async16(vs + t * kLdB + c, vb + t * kD + c);
    if (qb) cp_async16(qs + t * kLdB + c, qb + t * kD + c);
  }
  if (sb) {
    for (int i = tid; i < 2 * kD * 8; i += nthreads) {
      const int r = i >> 3, c = 8 * (i & 7);
      cp_async16(ss + r * kLdB + c, sb + r * kD + c);
    }
  }
  for (int i = tid; i < kD; i += nthreads) lc[i] = 0.f;
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Inclusive cumulative sum of lc rows 1..L per channel, one thread a
// channel adding in step order as the plain version does: the differences
// of two cumulative sums near -1,000 (w down to -20 a step) keep only
// ~1e-4 of their value, so a different order of additions moves the
// decays by as much as the state's tolerance.  Eight rows are read ahead.
__device__ void cumsum(float* lc, int L) {
  if (threadIdx.x < kD) {
    float* col = lc + kLdF + threadIdx.x;
    float acc = 0.f;
    for (int t0 = 0; t0 < L; t0 += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = col[(t0 + j) * kLdF];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc += x[j];
        col[(t0 + j) * kLdF] = acc;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
delta_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ w, float* __restrict__ ds,
             float* __restrict__ llast, int t_len, int L) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Smem ly = smem_layout(L, false);
  const int n_chunks = t_len / L;
  const long long bh = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const long long row0 = bh * t_len + static_cast<long long>(c) * L;
  load_chunk(w + row0 * kD, k + row0 * kD, v + row0 * kD, nullptr, nullptr,
             L, sm, ly);
  __syncthreads();
  float* lc = reinterpret_cast<float*>(sm + ly.lc);
  cumsum(lc, L);
  const bf16* ks = reinterpret_cast<const bf16*>(sm + ly.k);
  const bf16* vs = reinterpret_cast<const bf16*>(sm + ly.v);
  const float* last = lc + L * kLdF;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int d0 = 16 * (threadIdx.x >> 5);  // this warp's rows of dS
  float acc[8][4] = {};
  for (int kk = 0; kk < L / 16; ++kk) {
    unsigned ahi[4], alo[4];  // (k * exp(l_last - lc))^T, rows d, cols s
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dm = d0 + g + 8 * (r & 1);
      const int s = 16 * kk + 2 * cq + 8 * (r >> 1);
      const float x0 = __bfloat162float(ks[s * kLdB + dm]) *
                       __expf(last[dm] - lc[(s + 1) * kLdF + dm]);
      const float x1 = __bfloat162float(ks[(s + 1) * kLdB + dm]) *
                       __expf(last[dm] - lc[(s + 2) * kLdF + dm]);
      split2(x0, x1, ahi[r], alo[r]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_b_pair(b, vs, 16 * kk, 16 * np, lane);
      mma(acc[2 * np], ahi, b[0], b[1]);
      mma(acc[2 * np], alo, b[0], b[1]);
      mma(acc[2 * np + 1], ahi, b[2], b[3]);
      mma(acc[2 * np + 1], alo, b[2], b[3]);
    }
  }
  float* out = ds + (bh * n_chunks + c) * kD * kD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int e = 8 * nt + 2 * cq;
    *reinterpret_cast<float2*>(out + (d0 + g) * kD + e) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (d0 + g + 8) * kD + e) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  if (threadIdx.x < kD) {
    llast[(bh * n_chunks + c) * kD + threadIdx.x] = last[threadIdx.x];
  }
}

// S_c = exp(l_last_c) S_{c-1} + dS_c per (bh, d, e).  The state entering
// chunk c is written as bf16 hi and lo (sprev [bh, C, 2, 64, 64]), the
// form the output kernel multiplies; the last S is the output state.
// Eight chunks' increments are read ahead of the chain.
__global__ void __launch_bounds__(256)
recur_kernel(const float* __restrict__ ds, const float* __restrict__ llast,
             bf16* __restrict__ sprev, float* __restrict__ state,
             int n_chunks, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / (kD * kD);
  const int de = static_cast<int>(i % (kD * kD));
  const int d = de / kD;
  float s = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += 8) {
    float x[8], decay[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long blk = bh * n_chunks + c0 + j;
      if (c0 + j < n_chunks) {
        x[j] = __ldg(ds + blk * kD * kD + de);
        decay[j] = __ldg(llast + blk * kD + d);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j >= n_chunks) break;
      const long long blk = bh * n_chunks + c0 + j;
      const bf16 h = __float2bfloat16(s);
      sprev[(2 * blk) * kD * kD + de] = h;
      sprev[(2 * blk + 1) * kD * kD + de] =
          __float2bfloat16(s - __bfloat162float(h));
      s = expf(decay[j]) * s + x[j];
    }
  }
  state[i] = s;
}

// y's rows += A_blk [16 x 16] (float32, in the accumulator layout of two
// n-tiles) times v rows s0 .. s0 + 15, A as bf16 hi + lo
__device__ __forceinline__ void add_av(float (&y)[8][4],
                                       const float (&a)[2][4],
                                       const bf16* vs, int s0, int lane) {
  unsigned ahi[4], alo[4];
  split2(a[0][0], a[0][1], ahi[0], alo[0]);
  split2(a[0][2], a[0][3], ahi[1], alo[1]);
  split2(a[1][0], a[1][1], ahi[2], alo[2]);
  split2(a[1][2], a[1][3], ahi[3], alo[3]);
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned b[4];
    ldsm_b_pair(b, vs, s0, 16 * np, lane);
    mma(y[2 * np], ahi, b[0], b[1]);
    mma(y[2 * np], alo, b[0], b[1]);
    mma(y[2 * np + 1], ahi, b[2], b[3]);
    mma(y[2 * np + 1], alo, b[2], b[3]);
  }
}

// One warp's row block i (rows 16 i .. 16 i + 15) of y: row block 7, the
// last, does the most (7 blocks below the diagonal against none for row
// block 0), but a warp per row block keeps 16 warps on an SM, which hides
// the latencies that bound this kernel better than balanced pairs on 8.
__device__ void row_block(int i, const char* sm, const Smem& ly, int inc,
                          bool has_prev, bool bonus, bf16* yb) {
  const float* lc = reinterpret_cast<const float*>(sm + ly.lc);
  const bf16* ks = reinterpret_cast<const bf16*>(sm + ly.k);
  const bf16* qs = reinterpret_cast<const bf16*>(sm + ly.q);
  const bf16* vs = reinterpret_cast<const bf16*>(sm + ly.v);
  const bf16* shi = reinterpret_cast<const bf16*>(sm + ly.s);
  const bf16* slo = shi + kD * kLdB;
  const float* bon = reinterpret_cast<const float*>(sm + ly.bonus);
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int r0 = 16 * i;
  float y[8][4] = {};

  // inter-chunk: (q * exp(lq)) S_{c-1}, three products of hi / lo parts
  if (has_prev) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = r0 + g + 8 * (r & 1);
        const int d = 16 * kk + 2 * cq + 8 * (r >> 1);
        const float2 qv = ld_bf2(qs + t * kLdB + d);
        const float2 lq = ld_f2(lc + (t + inc) * kLdF + d);
        split2(qv.x * ex2(lq.x), qv.y * ex2(lq.y), ahi[r], alo[r]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bh[4], bl[4];
        ldsm_b_pair(bh, shi, 16 * kk, 16 * np, lane);
        ldsm_b_pair(bl, slo, 16 * kk, 16 * np, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(y[2 * np + h], ahi, bh[2 * h], bh[2 * h + 1]);
          mma(y[2 * np + h], ahi, bl[2 * h], bl[2 * h + 1]);
          mma(y[2 * np + h], alo, bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
  }

  // the blocks below the diagonal: (q exp(lq - m)) (k exp(m - lc))^T
  const float* m = lc + (r0 + inc) * kLdF;
  unsigned qhi[4][4], qlo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = r0 + g + 8 * (r & 1);
      const int d = 16 * kk + 2 * cq + 8 * (r >> 1);
      const float2 qv = ld_bf2(qs + t * kLdB + d);
      const float2 lq = ld_f2(lc + (t + inc) * kLdF + d);
      const float2 mv = ld_f2(m + d);
      split2(qv.x * ex2(lq.x - mv.x), qv.y * ex2(lq.y - mv.y),
             qhi[kk][r], qlo[kk][r]);
    }
  }
  for (int j = 0; j < i; ++j) {
    float a[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int s = 16 * j + 8 * nt + g;
        unsigned bh[2], bl[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = 16 * kk + 2 * cq + 8 * half;
          const float2 kv = ld_bf2(ks + s * kLdB + d);
          const float2 ls = ld_f2(lc + (s + 1) * kLdF + d);
          const float2 mv = ld_f2(m + d);
          split2(kv.x * ex2(mv.x - ls.x), kv.y * ex2(mv.y - ls.y),
                 bh[half], bl[half]);
        }
        mma(a[nt], qhi[kk], bh[0], bh[1]);
        mma(a[nt], qhi[kk], bl[0], bl[1]);
        mma(a[nt], qlo[kk], bh[0], bh[1]);
      }
    }
    add_av(y, a, vs, 16 * j, lane);
  }

  // the diagonal block: exponentials of differences, kept entries only.
  // Entry (rh, nt, cb): row g + 8 rh, column 8 nt + 2 cq + cb.
  {
    float a[2][4] = {};
    const int t1 = r0 + g, t2 = r0 + g + 8;
#pragma unroll 8
    for (int d = 0; d < kD; d += 2) {
      const float2 lq1 = ld_f2(lc + (t1 + inc) * kLdF + d);
      const float2 lq2 = ld_f2(lc + (t2 + inc) * kLdF + d);
      const float2 q1 = ld_bf2(qs + t1 * kLdB + d);
      const float2 q2 = ld_bf2(qs + t2 * kLdB + d);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          const int col = 8 * nt + 2 * cq + cb;
          const int s = r0 + col;
          const float2 kv = ld_bf2(ks + s * kLdB + d);
          const float2 ls = ld_f2(lc + (s + 1) * kLdF + d);
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            if (rh == 0 && nt == 1) continue;  // above the diagonal
            const int row = g + 8 * rh;
            if (inc ? col > row : col >= row) continue;
            const float2 lq = rh ? lq2 : lq1;
            const float2 qv = rh ? q2 : q1;
            float x = a[nt][2 * rh + cb];
            x = fmaf(qv.x * kv.x, ex2(lq.x - ls.x), x);
            x = fmaf(qv.y * kv.y, ex2(lq.y - ls.y), x);
            a[nt][2 * rh + cb] = x;
          }
        }
      }
    }
    if (bonus) {  // (q_t . (u * k_t)) on the diagonal
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          if (g + 8 * rh == 8 * rh + 2 * cq + cb) {
            a[rh][2 * rh + cb] += bon[r0 + g + 8 * rh];
          }
        }
      }
    }
    add_av(y, a, vs, r0, lane);
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int e = 8 * nt + 2 * cq;
    *reinterpret_cast<__nv_bfloat162*>(yb + (r0 + g) * kD + e) =
        __floats2bfloat162_rn(y[nt][0], y[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(yb + (r0 + g + 8) * kD + e) =
        __floats2bfloat162_rn(y[nt][2], y[nt][3]);
  }
}

__global__ void __launch_bounds__(kOutThreads, 2)
output_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const bf16* __restrict__ sprev,
              bf16* __restrict__ y, int t_len, int L, int include_current) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Smem ly = smem_layout(L, true);
  const int n_chunks = t_len / L;
  const long long bh = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const long long row0 = bh * t_len + static_cast<long long>(c) * L;
  load_chunk(w + row0 * kD, k + row0 * kD, v + row0 * kD, q + row0 * kD,
             c > 0 ? sprev + (bh * n_chunks + c) * 2 * kD * kD : nullptr, L,
             sm, ly);
  __syncthreads();
  float* lc = reinterpret_cast<float*>(sm + ly.lc);
  cumsum(lc, L);
  for (int i = threadIdx.x; i < (L + 1) * kLdF; i += kOutThreads) {
    lc[i] *= 1.4426950408889634f;  // log2(e): exponentials as ex2
  }
  __syncthreads();
  if (u) {
    const bf16* qs = reinterpret_cast<const bf16*>(sm + ly.q);
    const bf16* ks = reinterpret_cast<const bf16*>(sm + ly.k);
    float* bon = reinterpret_cast<float*>(sm + ly.bonus);
    const float* ub = u + bh * kD;
    for (int t = threadIdx.x; t < L; t += kOutThreads) {
      float acc = 0.f;
      for (int d = 0; d < kD; d += 2) {
        const float2 qv = ld_bf2(qs + t * kLdB + d);
        const float2 kv = ld_bf2(ks + t * kLdB + d);
        acc += qv.x * __ldg(ub + d) * kv.x;
        acc += qv.y * __ldg(ub + d + 1) * kv.y;
      }
      bon[t] = acc;
    }
    __syncthreads();
  }
  const int wi = threadIdx.x >> 5;
  if (wi < L / 16) {
    row_block(wi, sm, ly, include_current ? 1 : 0, c > 0, u != nullptr,
              y + row0 * kD);
  }
}

}  // namespace tc

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

// The tensor-core route on `stream` (three kernels): bf16 q, k, v, y
// [bh, t_len, 64], float32 w [bh, t_len, 64], u [bh, 64] or null, state
// [bh, 64, 64] out; scratch ds [bh, t_len / L, 64, 64] and llast
// [bh, t_len / L, 64] float32, sprev [bh, t_len / L, 2, 64, 64] bf16; all
// 16-byte aligned.  L a multiple of 16 up to 128 dividing t_len.  Returns
// cudaGetLastError() (0 on success).
extern "C" int gla_chunked_tc_launch(int bh, int t_len, int L,
                                     int include_current, const void* q,
                                     const void* k, const void* v,
                                     const void* w, const void* u, void* y,
                                     void* state, void* ds, void* llast,
                                     void* sprev, void* stream) {
  using tc::bf16;
  if (bh < 1 || L < 16 || L > kMaxL || L % 16 || t_len < L || t_len % L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bh * (t_len / L);
  const int smem1 = tc::smem_layout(L, false).total;
  const int smem3 = tc::smem_layout(L, true).total;
  cudaError_t err = cudaFuncSetAttribute(
      tc::delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(tc::output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem3);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::delta_kernel<<<blocks, tc::kThreads, smem1, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<float*>(ds),
      static_cast<float*>(llast), t_len, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(bh) * tc::kD * tc::kD;
  tc::recur_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ds), static_cast<const float*>(llast),
      static_cast<bf16*>(sprev), static_cast<float*>(state), t_len / L, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::output_kernel<<<blocks, tc::kOutThreads, smem3, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const bf16*>(sprev),
      static_cast<bf16*>(y), t_len, L, include_current);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gla_chunked_tc_dim() { return tc::kD; }

extern "C" const char* gla_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
