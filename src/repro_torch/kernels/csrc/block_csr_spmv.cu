// Block-CSR SpMV on Hopper (sm_90a): out[r*T:(r+1)*T] = sum over the row's
// tile slots of tiles[s] @ x[tile_col[s]*T : (tile_col[s]+1)*T].
//
// Replaces the Pallas TPU kernel `block_csr_spmv` of
// src/repro/kernels/csr_spmv.py (body `_kernel`).  The TPU grid is (row
// block, tile slot) over build_block_csr's padded layout, every row holding
// max_tiles_per_row slots (zero tiles included) and the sum carried across
// the sequential slot axis in the output block.  Here one warp owns one row
// block and loops over its slots [row_ptr[r], row_ptr[r+1]); on that layout
// that is exactly the TPU grid's slots, padding included.
//
// What bounds it on an H100: bytes.  Each slot moves a T x T float32 tile
// (256 B at T = 8), a 4 B column index and a T-float vector block that is
// mostly served from cache; a tile is T*T multiply-adds, 0.5 flop per byte
// of tile.  So the design only moves the tiles in wide, coalesced loads:
//
// * Lane l holds cells l, l + 32, ... of the tile (row-major), so one slot
//   is K coalesced 128 B loads per warp, K = ceil(T*T / 32) rounded up to a
//   power of two (the template argument).  The vector value a cell needs is
//   x[col*T + cell % T], a broadcast gather of T floats.
// * Each lane keeps one double per cell position for the whole row and
//   adds tile * x in slot order (a product of two floats is exact in
//   double).  At the end the warp writes its partials to shared memory and
//   lane i < T sums row i's T cells in column order: the result is
//   deterministic and, in double, does not depend on how the row's terms
//   were grouped, so the float32 output matches any other double-precision
//   summation after rounding.
// * Offsets into the tiles are 64-bit: at 2^21 vertices and T = 8 the
//   padded layout holds 47 M slots, 3 G floats.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmv_kernel(int tile, int n_rows, const float* __restrict__ tiles,
            const int* __restrict__ tile_col,
            const int* __restrict__ row_ptr, const float* __restrict__ x,
            float* __restrict__ out) {
  __shared__ double partial[kWarpsPerBlock][K * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= n_rows) return;  // the whole warp leaves together
  const int cells = tile * tile;
  int xoff[K];
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    xoff[k] = (lane + 32 * k) % tile;
    acc[k] = 0.0;
  }
  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
#pragma unroll 4
  for (int s = begin; s < end; ++s) {
    const float* t = tiles + static_cast<long long>(s) * cells;
    const float* xb = x + static_cast<long long>(__ldg(tile_col + s)) * tile;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      if (c < cells) {
        acc[k] += static_cast<double>(__ldg(t + c)) *
                  static_cast<double>(__ldg(xb + xoff[k]));
      }
    }
  }
  double* mine = partial[warp];
#pragma unroll
  for (int k = 0; k < K; ++k) mine[lane + 32 * k] = acc[k];
  __syncwarp();
  if (lane < tile) {
    double sum = 0.0;
    for (int j = 0; j < tile; ++j) sum += mine[lane * tile + j];
    out[static_cast<long long>(r) * tile + lane] = static_cast<float>(sum);
  }
}

template <int K>
int launch(int tile, int n_rows, const void* tiles, const void* tile_col,
           const void* row_ptr, const void* x, void* out, void* stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmv_kernel<K><<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      tile, n_rows, static_cast<const float*>(tiles),
      static_cast<const int*>(tile_col), static_cast<const int*>(row_ptr),
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the SpMV on `stream` and returns cudaGetLastError() (0 on
// success).  tiles [n_slots, tile, tile] and x [>= (max tile_col + 1) *
// tile] float32; tile_col [n_slots] and row_ptr [n_rows + 1] int32; out
// [n_rows * tile] float32; all contiguous.  1 <= tile <= 32, n_rows >= 1.
extern "C" int block_csr_spmv_launch(int tile, int n_rows, const void* tiles,
                                     const void* tile_col,
                                     const void* row_ptr, const void* x,
                                     void* out, void* stream) {
  if (tile < 1 || tile > 32 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int need = (tile * tile + 31) / 32;
#define REPRO_K(N) launch<N>(tile, n_rows, tiles, tile_col, row_ptr, x, out, \
                             stream)
  if (need <= 1) return REPRO_K(1);
  if (need <= 2) return REPRO_K(2);
  if (need <= 4) return REPRO_K(4);
  if (need <= 8) return REPRO_K(8);
  if (need <= 16) return REPRO_K(16);
  return REPRO_K(32);
#undef REPRO_K
}

extern "C" const char* block_csr_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
