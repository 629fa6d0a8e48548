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
//   card run in no order, so the scan is one pass with decoupled look-back
//   (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
//   Look-back", NVIDIA 2016):
//   - each block takes its tile index from an atomic counter, so a tile
//     waits only on tiles whose blocks have already started (this holds
//     even when not every block is resident);
//   - the block scans its tile of kTileN = 4,096 elements (kItems = 16 per
//     thread in registers, warp shuffles across a warp, shared memory
//     across the warps; 16 was measured on an H100 against 4, 8 and 12: no
//     slower below 2^20 elements, where launch costs set the time, and the
//     fastest at 2^24).  A whole tile comes in and goes out through a
//     per-warp staging area in shared memory, so global loads and stores
//     are coalesced 16-byte accesses and each thread still holds
//     consecutive elements.  The block then publishes the tile's
//     aggregate and later its inclusive prefix in one 64-bit status word
//     (flag in bits 32-33, value in bits 0-31), stored with release and
//     loaded with acquire semantics;
//   - warp 0 looks back over 32 predecessors at a time, waits until none
//     of them is still unpublished, folds their values up to the nearest
//     one holding an inclusive prefix, and stops there;
//   - the status words and the counter are zeroed by one cudaMemsetAsync
//     on the call's stream before the launch.  A call that fits in one
//     tile is one launch with no scratch and no look-back.
//
// What bounds them on an H100: bytes.  The stencil reads 1 B and writes
// 8 B per byte with a few integer operations; the scan reads and writes
// 4 B per element (plus 8 B of status per tile).  Both are far below the
// ridge point, so the design keeps accesses coalesced and, at the decode's
// chunk sizes (a few thousand to a million elements), the launch count
// low: a scan is one memset and one kernel.  The OOC and serving paths no
// longer call these kernels: they decode a whole prefetch item in two
// launches of chunk_decode.cu.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTileN = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode : int { kAdd = 0, kMax = 1 };

// Index into a warp's staging area: one padding word after every 32.
__host__ __device__ constexpr int pad(int e) { return e + (e >> 5); }

// A tile's status word: 0 until published, then the flag in bits 32-33
// over the value in bits 0-31.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

template <int MODE>
__device__ __forceinline__ int comb(int a, int b) {
  if (MODE == kAdd) {
    // wrapping add, without signed-overflow undefined behaviour
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  return a > b ? a : b;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Warp 0's look-back for tile `tile` > 0: the fold of every earlier tile
// (the tile's exclusive prefix).  Each lane reads one predecessor's status
// word, 32 at a time, nearest first; the window is folded up to the
// nearest inclusive prefix.  Every predecessor has taken its index before
// this tile did, so each will publish: the spin ends.
template <int MODE>
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile, int lane) {
  int exclusive = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    unsigned long long s = idx >= 0 ? load_acquire(status + idx) : kPrefix;
    while (__any_sync(kFullMask, (s >> 32) == 0)) {
      if ((s >> 32) == 0) s = load_acquire(status + idx);
    }
    const unsigned prefixes = __ballot_sync(kFullMask, (s >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = comb<MODE>(v, __shfl_xor_sync(kFullMask, v, off));
    }
    exclusive = comb<MODE>(exclusive, v);
    if (prefixes) return exclusive;
  }
}

// Inclusive scan of x [n] into out [n].  LOOK_BACK: any number of tiles,
// `scratch` holding the tile counter (word 0) and one status word per tile,
// all zero at launch; otherwise a single tile (n <= kTileN) and no scratch.
// The identity (and the max mode's seed) is 0.  In place (in == out) is
// safe: a block reads its whole tile before writing it.
template <int MODE, bool LOOK_BACK>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* in, int* out, long long n,
            unsigned long long* scratch) {
  __shared__ int staged[kWarps][pad(32 * kItems)];
  __shared__ int warp_tot[kWarps];
  __shared__ int shared_tile;
  __shared__ int shared_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  int tile = 0;
  if (LOOK_BACK) {
    if (tid == 0) {
      shared_tile = static_cast<int>(
          atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
    }
    __syncthreads();
    tile = shared_tile;
  }
  const long long base = static_cast<long long>(tile) * kTileN +
                         static_cast<long long>(tid) * kItems;
  int v[kItems];
  // a whole, aligned tile moves through shared memory: coalesced 16-byte
  // loads across the warp, then each thread takes its kItems consecutive
  // elements (the index padded by one word in 32, so neither side of the
  // transpose meets a bank conflict)
  int* stage = staged[w];
  const long long warp_base = static_cast<long long>(tile) * kTileN +
                              static_cast<long long>(w) * 32 * kItems;
  const bool whole =
      static_cast<long long>(tile + 1) * kTileN <= n &&
      ((reinterpret_cast<unsigned long long>(in) |
        reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  if (whole) {
    const int4* p = reinterpret_cast<const int4*>(in + warp_base);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 t4 = p[q * 32 + lane];
      const int e = 4 * (q * 32 + lane);
      stage[pad(e)] = t4.x;
      stage[pad(e + 1)] = t4.y;
      stage[pad(e + 2)] = t4.z;
      stage[pad(e + 3)] = t4.w;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = stage[pad(kItems * lane + i)];
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      v[i] = base + i < n ? in[base + i] : 0;
    }
  }
  int acc = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    acc = comb<MODE>(acc, v[i]);
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
  int prefix = comb<MODE>(w > 0 ? warp_tot[w - 1] : 0, ex);
  if (LOOK_BACK) {
    unsigned long long* status = scratch + 1;
    if (w == 0) {
      const unsigned agg = static_cast<unsigned>(warp_tot[kWarps - 1]);
      if (tile == 0) {
        if (lane == 0) store_release(status, kPrefix | agg);
      } else {
        if (lane == 0) store_release(status + tile, kAggregate | agg);
        const int exclusive = look_back<MODE>(status, tile, lane);
        if (lane == 0) {
          store_release(status + tile,
                        kPrefix | static_cast<unsigned>(comb<MODE>(
                                      exclusive, static_cast<int>(agg))));
          shared_prefix = exclusive;
        }
      }
    }
    __syncthreads();
    if (tile > 0) prefix = comb<MODE>(shared_prefix, prefix);
  }
  if (whole) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      stage[pad(kItems * lane + i)] = comb<MODE>(prefix, v[i]);
    }
    __syncwarp();
    int4* p = reinterpret_cast<int4*>(out + warp_base);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int e = 4 * (q * 32 + lane);
      p[q * 32 + lane] = make_int4(stage[pad(e)], stage[pad(e + 1)],
                                   stage[pad(e + 2)], stage[pad(e + 3)]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i < n) out[base + i] = comb<MODE>(prefix, v[i]);
    }
  }
}

long long scratch_words(long long n) {
  const long long tiles = (n + kTileN - 1) / kTileN;
  return tiles <= 1 ? 0 : tiles + 1;
}

template <int MODE>
int scan(long long n, const int* in, int* out, unsigned long long* scratch,
         cudaStream_t s) {
  const long long tiles = (n + kTileN - 1) / kTileN;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles <= 1) {
    scan_kernel<MODE, false><<<1, kThreads, 0, s>>>(in, out, n, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, scratch_words(n) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<MODE, true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, out, n, scratch);
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

// Inclusive scan of x [n] int32 into out [n] (may alias x) on `stream`:
// one cudaMemsetAsync of the scratch and one kernel, or the kernel alone
// when n fits in one tile.  scratch holds scan_scratch_words(n) 64-bit
// words (none for one tile).  Returns cudaGetLastError() (0 on success).
extern "C" int blocked_scan_launch(int mode, long long n, const void* x,
                                   void* out, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  auto* sc = static_cast<unsigned long long*>(scratch);
  switch (mode) {
    case kAdd: return scan<kAdd>(n, in, o, sc, s);
    case kMax: return scan<kMax>(n, in, o, sc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 64-bit scratch words the scan of n elements needs: the tile counter and
// one status word per tile, or none when n fits in one tile.
extern "C" long long scan_scratch_words(long long n) {
  return scratch_words(n);
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
