// Selective monoid block-CSR combine: the engine's ProcessEdges phase 4 on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_csr_combine` of
// src/repro/kernels/csr_spmv.py (body `_make_combine_kernel`).  For every
// destination partition q and destination row block r it folds the live
// T x T tiles of the row (compacted to the front of the row's slot range,
// row_cnt[q, r] of them) against the source vector blocks their tile_col
// selects:
//
//   add    val += V @ xv              hascnt += C @ xc
//   add_b  val += V @ xv + B @ xc     hascnt += C @ xc
//   min    val = min(val, rowmin(B + xv))   hascnt += C @ xc   (max alike)
//
// val starts at the monoid identity and hascnt at 0.
//
// What bounds it on an H100: bytes.  Each live tile moves 2 or 3 tiles of
// 256 B (C, and V and/or B), 8 B of slot index, and 2 x 32 B of gathered
// vector; each row writes 2 x 32 B.  That is under 0.5 flop per byte, far
// below the card's ridge point, so the design only tries to move those
// bytes in as few, as wide transactions as it can:
//
// * The TPU grid (row block, live slot) ran mostly dead steps; here one
//   warp owns one (q, r) and loops j < row_cnt[q, r], so dead slots cost
//   nothing and one launch covers every destination partition.
// * Each lane holds two neighbouring cells of the 8 x 8 tile (row lane/4,
//   columns 2*(lane%4) and +1), so a tile is one coalesced 256 B float2
//   load per warp and the vector block a 32 B broadcast gather.
// * Partial results stay in registers for the whole row; the four lanes
//   of a tile row are reduced with __shfl_xor_sync at the end.
// * Sums accumulate in double (products of two floats are exact in
//   double), so the float result does not depend on the summation order;
//   the FP64 rate is no limit for a kernel this far below the ridge.
//   min/max are exact in any order, so they are bit-equal to any
//   correct implementation: B + xv is one float add (no contraction is
//   possible), and an overflow to +-inf in an empty cell still folds to
//   the identity.  Build without --use_fast_math.
//
// Hub rows (R-MAT's low ids) own thousands of live tiles, so warps are
// uneven; balancing them is left to a later version.
//
// The multi-query panel entry point (`block_csr_combine_mq_launch`)
// replaces the Pallas TPU kernel `block_csr_combine_mq` of the same file
// (body `_make_combine_kernel_mq`): the same tiles folded against NQ value
// and presence columns at once, xv / xc being row-major [C * 8, ld] panels
// of which the launch reads the NQ columns starting at col0.  The kernel
// body is one template over NQ; the solo entry point is its NQ = 1
// instance, so every column runs the solo kernel's lane mapping, loads,
// accumulation order and shuffle steps, and is bit-identical to a solo
// call on that column (in the add modes too).  A tile is read once for
// all NQ columns; the 8 x NQ vector block a tile selects is two rows of
// NQ contiguous floats per lane (float4 loads when NQ >= 4).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kCells = kTile * kTile;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode : int { kAdd = 0, kAddB = 1, kMin = 2, kMax = 3 };

// NaN-propagating extremum, as torch.minimum / torch.maximum.
template <int MODE>
__device__ __forceinline__ float extremum(float a, float b) {
  if (MODE == kMin) return (a != a || a < b) ? a : b;
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The two vector cells a lane multiplies, for NQ columns: x0 from panel
// row c, x1 from row c + 1 (row stride ld).  NQ = 1 is the solo layout,
// where the two cells are neighbours and load as one float2.
template <int NQ>
__device__ __forceinline__ void load_pair(const float* p, long long ld,
                                          float (&x0)[NQ], float (&x1)[NQ]) {
  if constexpr (NQ == 1) {
    const float2 v = load2(p);
    x0[0] = v.x;
    x1[0] = v.y;
  } else if constexpr (NQ % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NQ; i += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p + ld + i));
      x0[i] = a.x; x0[i + 1] = a.y; x0[i + 2] = a.z; x0[i + 3] = a.w;
      x1[i] = b.x; x1[i + 1] = b.y; x1[i + 2] = b.z; x1[i + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NQ; i += 2) {
      const float2 a = load2(p + i);
      const float2 b = load2(p + ld + i);
      x0[i] = a.x; x0[i + 1] = a.y;
      x1[i] = b.x; x1[i + 1] = b.y;
    }
  }
}

template <int MODE, int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_kernel(const int* __restrict__ row_ptr,
               const int* __restrict__ tile_idx,
               const int* __restrict__ tile_col,
               const int* __restrict__ row_cnt,
               const float* __restrict__ tiles_v,
               const float* __restrict__ tiles_b,
               const float* __restrict__ tiles_cnt,
               const float* __restrict__ xv,
               const float* __restrict__ xc,
               float* __restrict__ val,
               float* __restrict__ hascnt,
               int n_dest, int n_rows, int n_slots, int n_src, int ld,
               int col0, float identity) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(n_dest) * n_rows) return;  // whole warp
  const int lane = threadIdx.x & 31;
  const int q = static_cast<int>(warp / n_rows);
  const int r = static_cast<int>(warp - static_cast<long long>(q) * n_rows);
  const int cell = lane * 2;        // row lane / 4, columns j0 and j0 + 1
  const int j0 = (lane & 3) * 2;

  const int start = row_ptr[static_cast<long long>(q) * (n_rows + 1) + r];
  const int cnt = row_cnt[static_cast<long long>(q) * n_rows + r];
  const int* idx = tile_idx + static_cast<long long>(q) * n_slots + start;
  const int* col = tile_col + static_cast<long long>(q) * n_slots + start;
  const long long tile0 = static_cast<long long>(q) * n_slots;
  const float* xvq = xv + static_cast<long long>(q) * n_src * ld + col0;
  const float* xcq = xc + static_cast<long long>(q) * n_src * ld + col0;

  double acc[NQ];    // add / add_b
  float ext[NQ];     // min / max
  float hc[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    acc[i] = 0.0;
    ext[i] = identity;
    hc[i] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < cnt; ++k) {
    const long long off = (tile0 + idx[k]) * kCells + cell;
    const long long c = static_cast<long long>(col[k] * kTile + j0) * ld;
    const float2 tc = load2(tiles_cnt + off);
    float p0[NQ], p1[NQ];
    load_pair<NQ>(xcq + c, ld, p0, p1);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      hc[i] += tc.x * p0[i] + tc.y * p1[i];  // small integers: exact
    }
    if (MODE == kAdd || MODE == kAddB) {
      const float2 tv = load2(tiles_v + off);
      float v0[NQ], v1[NQ];
      load_pair<NQ>(xvq + c, ld, v0, v1);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        acc[i] += static_cast<double>(tv.x) * v0[i] +
                  static_cast<double>(tv.y) * v1[i];
      }
      if (MODE == kAddB) {
        const float2 tb = load2(tiles_b + off);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          acc[i] += static_cast<double>(tb.x) * p0[i] +
                    static_cast<double>(tb.y) * p1[i];
        }
      }
    } else {
      const float2 tb = load2(tiles_b + off);
      float v0[NQ], v1[NQ];
      load_pair<NQ>(xvq + c, ld, v0, v1);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        ext[i] = extremum<MODE>(ext[i],
                                extremum<MODE>(tb.x + v0[i], tb.y + v1[i]));
      }
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      hc[i] += __shfl_xor_sync(kFullMask, hc[i], m);
      if (MODE == kAdd || MODE == kAddB) {
        acc[i] += __shfl_xor_sync(kFullMask, acc[i], m);
      } else {
        ext[i] = extremum<MODE>(ext[i],
                                __shfl_xor_sync(kFullMask, ext[i], m));
      }
    }
  }
  if ((lane & 3) == 0) {
    const long long o =
        ((static_cast<long long>(q) * n_rows + r) * kTile + (lane >> 2)) * ld +
        col0;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      val[o + i] = (MODE == kAdd || MODE == kAddB)
                       ? static_cast<float>(static_cast<double>(identity) +
                                            acc[i])
                       : ext[i];
      hascnt[o + i] = hc[i];
    }
  }
}

template <int NQ>
int launch(int mode, int n_dest, int n_rows, int n_slots, int n_src, int ld,
           int col0, float identity, const void* row_ptr,
           const void* tile_idx, const void* tile_col, const void* row_cnt,
           const void* tiles_v, const void* tiles_b, const void* tiles_cnt,
           const void* xv, const void* xc, void* val, void* hascnt,
           void* stream) {
  const long long warps = static_cast<long long>(n_dest) * n_rows;
  if (warps == 0) return 0;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(M)                                                     \
  combine_kernel<M, NQ><<<grid, block, 0, s>>>(                             \
      static_cast<const int*>(row_ptr), static_cast<const int*>(tile_idx),  \
      static_cast<const int*>(tile_col), static_cast<const int*>(row_cnt),  \
      static_cast<const float*>(tiles_v), static_cast<const float*>(tiles_b), \
      static_cast<const float*>(tiles_cnt), static_cast<const float*>(xv),  \
      static_cast<const float*>(xc), static_cast<float*>(val),              \
      static_cast<float*>(hascnt), n_dest, n_rows, n_slots, n_src, ld, col0, \
      identity)
  switch (mode) {
    case kAdd: REPRO_LAUNCH(kAdd); break;
    case kAddB: REPRO_LAUNCH(kAddB); break;
    case kMin: REPRO_LAUNCH(kMin); break;
    case kMax: REPRO_LAUNCH(kMax); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the combine on `stream` and returns cudaGetLastError() (0 on
// success).  Shapes: row_ptr [n_dest, n_rows + 1], tile_idx / tile_col
// [n_dest, n_slots], row_cnt [n_dest, n_rows] (int32); tiles
// [n_dest, n_slots, 8, 8], xv / xc [n_dest, n_src], val / hascnt
// [n_dest, n_rows * 8] (float32), all contiguous.  Tiles a mode does not
// read may be null.
extern "C" int block_csr_combine_launch(
    int mode, int tile, int n_dest, int n_rows, int n_slots, int n_src,
    float identity, const void* row_ptr, const void* tile_idx,
    const void* tile_col, const void* row_cnt, const void* tiles_v,
    const void* tiles_b, const void* tiles_cnt, const void* xv,
    const void* xc, void* val, void* hascnt, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(mode, n_dest, n_rows, n_slots, n_src, 1, 0, identity,
                   row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,
                   tiles_cnt, xv, xc, val, hascnt, stream);
}

// The panel combine over columns [col0, col0 + nq) of the row-major panels
// xv / xc [n_dest, n_src, ld] into val / hascnt [n_dest, n_rows * 8, ld];
// nq is 1, 2, 4, 8 or 16, and ld and col0 are multiples of min(nq, 4)
// (the wrapper pads and groups columns to meet that).  Same structure
// arguments and return value as the solo entry point.
extern "C" int block_csr_combine_mq_launch(
    int mode, int tile, int nq, int n_dest, int n_rows, int n_slots,
    int n_src, int ld, int col0, float identity, const void* row_ptr,
    const void* tile_idx, const void* tile_col, const void* row_cnt,
    const void* tiles_v, const void* tiles_b, const void* tiles_cnt,
    const void* xv, const void* xc, void* val, void* hascnt, void* stream) {
  if (tile != kTile || col0 < 0 || col0 + nq > ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_NQ(N)                                                         \
  launch<N>(mode, n_dest, n_rows, n_slots, n_src, ld, col0, identity,       \
            row_ptr, tile_idx, tile_col, row_cnt, tiles_v, tiles_b,         \
            tiles_cnt, xv, xc, val, hascnt, stream)
  switch (nq) {
    case 1: return REPRO_NQ(1);
    case 2: return REPRO_NQ(2);
    case 4: return REPRO_NQ(4);
    case 8: return REPRO_NQ(8);
    case 16: return REPRO_NQ(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_NQ
}

extern "C" const char* block_csr_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
