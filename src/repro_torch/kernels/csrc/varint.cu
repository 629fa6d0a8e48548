// Device half of the chunk decode: the LEB128 byte stencil and the int32
// inclusive scan, on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/varint.py:
//
// * `_byte_stencil` (body `_decode_kernel`): per byte j, the LEB128
//   terminator flag and the value of the varint that ends at j.  The value
//   is assembled from the bytes j-4..j: the distance to the varint's first
//   byte is the first d in 0..3 with byte j-1-d a terminator (4 when none
//   is), and byte j-d holds 7-bit group gpos-d.  A byte before the stream
//   start counts as a terminator.  The value is assembled in uint32, so a
//   five-group read wraps as the reference's does, and written as int32.
//   The TPU kernel read each block twice to get its 4-byte halo; here every
//   thread reads its neighbours straight from global memory (they sit in
//   the same or the previous 32-byte sector, so the halo costs no extra
//   DRAM traffic).
//
// * `blocked_scan` (body `_make_scan_kernel`): inclusive int32 scan, mode
//   add (wrapping, as int32 arithmetic on the TPU) or mode max seeded with
//   0.  The TPU threaded a carry through a sequential grid; blocks on this
//   card run in no order, so the scan is three passes: each block scans a
//   tile of 2048 elements (8 per thread in registers, warp shuffles across
//   a warp, shared memory across the 8 warps) and writes the tile's
//   aggregate; the aggregates are scanned the same way (recursively, so
//   any length works); a last pass folds each tile's carry into it.
//
// What bounds them on an H100: bytes.  The stencil reads 1 B and writes
// 8 B per byte with a few integer operations; the scan reads and writes
// 4 B per element (plus the aggregates, 1/1024 of that, and a second read
// and write in the carry pass).  Both are far below the ridge point, so the
// design only keeps accesses coalesced; a decoupled look-back scan (one
// pass) and fusing a chunk's whole decode into one or two launches are
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTileN = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode : int { kAdd = 0, kMax = 1 };

template <int MODE>
__device__ __forceinline__ int comb(int a, int b) {
  if (MODE == kAdd) {
    // wrapping add, without signed-overflow undefined behaviour
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  return a > b ? a : b;
}

// Inclusive scan of one tile; writes the tile's aggregate to agg[blockIdx]
// when agg is not null.  The identity (and the max mode's seed) is 0.  In
// place (in == out, as scan_rec calls it on the aggregates) is safe: a
// block reads its whole tile before writing, so `in` is not __restrict__.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const int* in, int* out, int* agg, long long n) {
  __shared__ int warp_tot[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTileN +
      static_cast<long long>(tid) * kItems;
  int v[kItems];
  int acc = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    acc = comb<MODE>(acc, idx < n ? in[idx] : 0);
    v[i] = acc;
  }
  // inclusive scan of the thread totals across the warp
  int t = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, t, off);
    if (lane >= off) t = comb<MODE>(t, y);
  }
  int ex = __shfl_up_sync(kFullMask, t, 1);
  if (lane == 0) ex = 0;
  if (lane == 31) warp_tot[w] = t;
  __syncthreads();
  if (w == 0) {
    int z = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, z, off);
      if (lane >= off) z = comb<MODE>(z, y);
    }
    if (lane < kWarps) warp_tot[lane] = z;
  }
  __syncthreads();
  const int prefix = comb<MODE>(w > 0 ? warp_tot[w - 1] : 0, ex);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    if (idx < n) out[idx] = comb<MODE>(prefix, v[i]);
  }
  if (agg != nullptr && tid == 0) agg[blockIdx.x] = warp_tot[kWarps - 1];
}

// Folds the inclusive scan of the tile aggregates into tiles 1, 2, ...
template <int MODE>
__global__ void __launch_bounds__(kThreads)
add_carry(int* out, const int* __restrict__ agg, long long n) {
  const long long tile = static_cast<long long>(blockIdx.x) + 1;
  const int c = agg[tile - 1];
  for (int i = threadIdx.x; i < kTileN; i += kThreads) {
    const long long idx = tile * kTileN + i;
    if (idx < n) out[idx] = comb<MODE>(c, out[idx]);
  }
}

template <int MODE>
int scan_rec(long long n, const int* in, int* out, int* scratch,
             cudaStream_t s) {
  const long long nb = (n + kTileN - 1) / kTileN;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 1) {
    scan_tiles<MODE><<<1, kThreads, 0, s>>>(in, out, nullptr, n);
    return static_cast<int>(cudaGetLastError());
  }
  int* agg = scratch;
  scan_tiles<MODE><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      in, out, agg, n);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  code = scan_rec<MODE>(nb, agg, agg, scratch + nb, s);
  if (code != 0) return code;
  add_carry<MODE><<<static_cast<unsigned>(nb - 1), kThreads, 0, s>>>(
      out, agg, n);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
byte_stencil_kernel(const unsigned char* __restrict__ buf,
                    int* __restrict__ term, int* __restrict__ val,
                    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < n; j += stride) {
    int gpos = 4;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const long long p = j - 1 - d;
      if (p < 0 || (buf[p] & 0x80) == 0) {
        gpos = d;
        break;
      }
    }
    unsigned v = 0;
    for (int d = 0; d <= gpos; ++d) {
      v += static_cast<unsigned>(buf[j - d] & 0x7F) << (7 * (gpos - d));
    }
    term[j] = (buf[j] & 0x80) == 0 ? 1 : 0;
    val[j] = static_cast<int>(v);
  }
}

}  // namespace

// Inclusive scan of x [n] int32 into out [n] (may alias x) on `stream`.
// scratch holds the tile aggregates of every level: sum over the levels
// of ceil(m / 2048) for m = n, ceil(n / 2048), ... while that exceeds 1.
// Returns cudaGetLastError() (0 on success).
extern "C" int blocked_scan_launch(int mode, long long n, const void* x,
                                   void* out, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  int* sc = static_cast<int*>(scratch);
  switch (mode) {
    case kAdd: return scan_rec<kAdd>(n, in, o, sc, s);
    case kMax: return scan_rec<kMax>(n, in, o, sc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Per byte of buf [n] uint8: term [n] int32 (1 where the byte ends a
// varint) and val [n] int32 (the value of the varint ending there).
extern "C" int byte_stencil_launch(long long n, const void* buf, void* term,
                                   void* val, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  byte_stencil_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(buf), static_cast<int*>(term),
      static_cast<int*>(val), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_tile_size() { return kTileN; }

extern "C" const char* varint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
