// Block-CSR SpMV on Hopper (sm_90a) over the packed layout of
// csr_spmv.pack_block_csr: out[r*T:(r+1)*T] = sum over row block r's live
// tiles s of tile_s @ x[pcol[s]*T : (pcol[s]+1)*T].
//
// Replaces the Pallas TPU kernel `block_csr_spmv` of
// src/repro/kernels/csr_spmv.py (body `_kernel`).  The TPU grid is (row
// block, tile slot) over build_block_csr's padded layout: every row holds
// max_tiles_per_row dense T x T tiles, zero tiles included, and the sum is
// carried across the sequential slot axis in the output block.  At 2^21
// uniform vertices and T = 8 that layout is 47.4 M slots (12.15 GB), 29% of
// them padding, and its 33.5 M live tiles hold about one edge each in 64
// cells, so 98% of the bytes a dense-tile kernel streams are zeros.  This
// kernel reads the packed form instead, only the occupied cells of the live
// tiles:
//
//   prow  [R+1] int64   each row block's first live tile
//   pcol  [L]   int32   each live tile's source block
//   pmask [L,W] uint64  occupancy bits, W = ceil(T*T / 64); cell i*T + j is
//                       bit (i*T+j) % 64 of word (i*T+j) / 64
//   pvoff [R+1] int64   each row block's first value
//   pval  [nnz] float32 the occupied cells' values, in (tile, cell) order
//
// What bounds it on an H100: bytes, 12 B per live tile, 4 B per value, 16 B
// per row block and the vectors (~558 MB a call at 2^21 uniform vertices,
// a 0.167 ms bound); a product is one multiply-add per value.  Each value
// also gathers one 32 B sector of x (33.5 M sectors from L2 at that size),
// so the gathers, not the DRAM stream, set the practical limit.  Measured
// design choices (NVIDIA H100 80GB HBM3, 700 W): resident warps mattered,
// loads in flight per warp did not (more tiles per lane raised registers
// and time alike; a second cell per step in flight changed nothing).
//
// * One warp owns one row block (4 warps a block, so a block's slowest
//   row holds few warps idle); lane l takes live tile prow[r] + l, 32
//   tiles at a time, so pcol and pmask come in coalesced loads.  The next
//   32 tiles' pcol and pmask are loaded before the current ones are used.
// * A warp inclusive scan of the tiles' popcounts, started from pvoff[r],
//   gives each lane the offset of its first value; the lanes' values are
//   adjacent, so the value loads are near-coalesced.
// * Each set bit (cell i*T + j) gathers x[col*T + j], one sector per tile
//   at T = 8 (the 8.4 MB x stays in L2), and adds the double product to the
//   lane's sum of row i.  The T sums (T rounded up to a power of two, P)
//   live in shared memory as [row][lane], so every lane of a warp hits its
//   own bank whatever row it adds to, and the loop needs ~32 registers.
// * At the row's end a transposing butterfly sums the lanes in a fixed
//   order (each step halves the sums a lane holds: P + 4 - log2 P double
//   shuffles), then one rounding to float32: a call is deterministic, with
//   no atomics, and a product of two floats is exact in double, so the
//   result matches any other double-precision summation after rounding.
// * Offsets into pval and pmask are 64-bit; a row with no live tile writes
//   zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int T>
struct Tile {
  static constexpr int kCells = T * T;
  static constexpr int kWords = (kCells + 63) / 64;
  // accumulators per lane: T rounded up to a power of two, for the
  // transposing reduction
  static constexpr int kAcc = T <= 1 ? 1 : T <= 2 ? 2 : T <= 4 ? 4
                              : T <= 8 ? 8 : T <= 16 ? 16 : 32;
};

// The first occupied cell of a mask (-1 if none), cleared from the mask.
template <int W>
__device__ __forceinline__ int pop_cell(unsigned long long (&m)[W]) {
  int c = -1;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (c < 0 && m[w] != 0) {
      c = 64 * w + __ffsll(static_cast<long long>(m[w])) - 1;
      m[w] &= m[w] - 1;
    }
  }
  return c;
}

// The live tiles [i, i + 32) of a row, one per lane: source block and mask.
template <int W>
__device__ __forceinline__ void load_tiles(
    long long i, long long end, const int* __restrict__ pcol,
    const unsigned long long* __restrict__ pmask, int& col,
    unsigned long long (&m)[W]) {
  col = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) m[k] = 0;
  if (i < end) {
    col = __ldg(pcol + i);
#pragma unroll
    for (int k = 0; k < W; ++k) m[k] = __ldg(pmask + i * W + k);
  }
}

// Sums acc[P] over the warp's lanes in a fixed order, halving the values
// a lane holds at each step: lane l ends with the total of row
// row_of_lane<P>(l) (the same row on 32 / P lanes).  log2(P) exchanges of
// P/2, P/4, ..., 1 values, then plain butterflies: P - 1 + 5 - log2(P)
// shuffles of a double instead of 5 P.
template <int P>
__device__ __forceinline__ double reduce_rows(double (&acc)[P], int lane) {
#pragma unroll
  for (int half = P / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const double send = upper ? acc[j] : acc[j + half];
      const double keep = upper ? acc[j + half] : acc[j];
      acc[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  double s = acc[0];
#pragma unroll
  for (int off = 16 / P; off >= 1; off /= 2) {
    s += __shfl_xor_sync(kFull, s, off);
  }
  return s;
}

template <int P>
__device__ __forceinline__ int row_of_lane(int lane) {
  int row = 0;
#pragma unroll
  for (int half = P / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    if (lane & off) row += half;
  }
  return row;
}

template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_packed_kernel(int n_rows, const long long* __restrict__ prow,
                   const int* __restrict__ pcol,
                   const unsigned long long* __restrict__ pmask,
                   const long long* __restrict__ pvoff,
                   const float* __restrict__ pval,
                   const float* __restrict__ x, float* __restrict__ out) {
  constexpr int W = Tile<T>::kWords;
  constexpr int P = Tile<T>::kAcc;
  // each lane's T double sums live in shared memory, not registers, so the
  // loop keeps few registers and many warps stay resident; [row][lane]
  // puts a warp's 32 lanes on distinct banks whatever rows they add to
  __shared__ double sums[kWarpsPerBlock][P][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= n_rows) return;  // the whole warp leaves together
  double (*acc)[32] = sums[warp];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k][lane] = 0.0;
  const long long begin = prow[r];
  const long long end = prow[r + 1];
  long long voff = pvoff[r];
  int col;
  unsigned long long m[W];
  load_tiles<W>(begin + lane, end, pcol, pmask, col, m);
  for (long long base = begin; base < end; base += 32) {
    int next_col;
    unsigned long long next_m[W];
    load_tiles<W>(base + 32 + lane, end, pcol, pmask, next_col, next_m);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) cnt += __popcll(m[k]);
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += y;
    }
    const float* v = pval + voff + (inc - cnt);
    voff += __shfl_sync(kFull, inc, 31);
    const float* xb = x + static_cast<long long>(col) * T;
    for (int c = pop_cell<W>(m); c >= 0; c = pop_cell<W>(m)) {
      acc[c / T][lane] += static_cast<double>(__ldg(v)) *
                          static_cast<double>(__ldg(xb + c % T));
      ++v;
    }
    col = next_col;
#pragma unroll
    for (int k = 0; k < W; ++k) m[k] = next_m[k];
  }
  double mine[P];
#pragma unroll
  for (int k = 0; k < P; ++k) mine[k] = acc[k][lane];
  const double total = reduce_rows<P>(mine, lane);
  const int row = row_of_lane<P>(lane);
  if (row < T && (lane & (32 / P - 1)) == 0) {
    out[static_cast<long long>(r) * T + row] = static_cast<float>(total);
  }
}

template <int T>
int launch(int n_rows, const void* prow, const void* pcol, const void* pmask,
           const void* pvoff, const void* pval, const void* x, void* out,
           void* stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmv_packed_kernel<T><<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n_rows, static_cast<const long long*>(prow),
      static_cast<const int*>(pcol),
      static_cast<const unsigned long long*>(pmask),
      static_cast<const long long*>(pvoff), static_cast<const float*>(pval),
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the packed SpMV on `stream` and returns cudaGetLastError() (0 on
// success).  prow and pvoff [n_rows + 1] int64; pcol [L] int32; pmask [L,
// ceil(tile*tile / 64)] 64-bit words; pval [nnz] float32; x [>= (max pcol +
// 1) * tile] float32; out [n_rows * tile] float32; all contiguous.
// 1 <= tile <= 32, n_rows >= 1.
extern "C" int block_csr_spmv_launch(int tile, int n_rows, const void* prow,
                                     const void* pcol, const void* pmask,
                                     const void* pvoff, const void* pval,
                                     const void* x, void* out,
                                     void* stream) {
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_T(N)                                                        \
  case N:                                                                 \
    return launch<N>(n_rows, prow, pcol, pmask, pvoff, pval, x, out, stream);
  switch (tile) {
    REPRO_T(1) REPRO_T(2) REPRO_T(3) REPRO_T(4) REPRO_T(5) REPRO_T(6)
    REPRO_T(7) REPRO_T(8) REPRO_T(9) REPRO_T(10) REPRO_T(11) REPRO_T(12)
    REPRO_T(13) REPRO_T(14) REPRO_T(15) REPRO_T(16) REPRO_T(17) REPRO_T(18)
    REPRO_T(19) REPRO_T(20) REPRO_T(21) REPRO_T(22) REPRO_T(23) REPRO_T(24)
    REPRO_T(25) REPRO_T(26) REPRO_T(27) REPRO_T(28) REPRO_T(29) REPRO_T(30)
    REPRO_T(31) REPRO_T(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_T
}

extern "C" const char* block_csr_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
