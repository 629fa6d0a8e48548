// The fused OOC chunk decode on Hopper (sm_90a): one prefetch schedule
// item (the chunks of one destination partition and dst batch) from its
// staged bytes to the (src, part, dst, data) columns the combine reads, in
// at most two launches.  Bit-equal to the host codec.
//
// Replaces, on the OOC and serving paths, the per-chunk chain built on two
// Pallas TPU kernels of src/repro/kernels/varint.py: `_byte_stencil` (the
// LEB128 terminator flags and values) and `blocked_scan` (the add and max
// scans of pair_delta_restore, expand_dcsr_index / expand_csr_index and
// dst_delta_restore).  The layout of the staged item is set out in
// kernels/chunk_decode.py; the host copies it to the card in one copy from
// page-locked memory, its look-back status words already zero.
//
// Launch 1 (`sections_kernel`), one block per 4,096-byte tile of the
// item's varint sections (a chunk's delta-varint pair section and its dst
// residues), each tile inside one section:
//   - each thread takes 16 bytes and the 4 before them, and per byte the
//     stencil's 5-tap select (the distance to the varint's first byte is
//     the first d in 0..3 with byte j-1-d a terminator, 4 when none is;
//     bytes before the section count as terminators), so a varint that
//     straddles a tile is decoded by the tile holding its last byte;
//   - the tile's carry is scanned block-wide and then across the section
//     with decoupled look-back (Merrill and Garland, NVIDIA 2016), as in
//     varint.cu's scan, but *segmented*: a look-back stops at the
//     section's first tile.  The carry is (varints so far, sum of the
//     even-index values, sum of the odd-index values) on a pair section,
//     whose varints alternate src and start deltas, and (varints so far,
//     wrapping int32 sum) on a residue section.  The operator is
//     associative but not commutative (the count's parity decides where
//     the later sums land), so every fold keeps its order.  A carry is
//     three words, so a tile publishes it in an int4 slot (aggregate or
//     prefix, each written once) before a release store of its flag; a
//     reader loads the flag with acquire and then the slot from L2;
//   - each varint then writes srcs / starts (pairs) or csum (residues).
// Launch 2 (`edges_kernel`), one thread per edge of the item: its chunk
// and run by binary search (DCSR: the run starts; CSR: the row offsets,
// where rows of degree 0 share the next row's offset and the search skips
// them), giving src and the run head h; then dst = base + csum[j] -
// csum[h - 1] (nothing for h = 0) in wrapping int32, part and data.
//
// What bounds it on an H100: bytes, at the decode's sizes a few
// microseconds (the largest streamed item of R-MAT scale 21 moves ~5 MB
// in and ~40 MB out); what bounded the chain it replaces was its host
// path — ~10 launches and ~20 torch ops per chunk, each copy from pageable
// memory waiting for the stream.  The design therefore fixes the launch
// count per item (two, none for an empty one) and lets the host stage an
// item while the card combines the one before.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTileBytes = kThreads * kBytesPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// chunk table columns (kernels/chunk_decode.py CHUNK_FIELDS)
enum ChunkField {
  kRep, kPart, kNe, kNnz, kVsrc, kBase, kOutOff, kPairOff, kIndexOff,
  kIndexNb, kResOff, kResNb, kDataOff, kChunkFields
};
// section table columns (SEC_FIELDS)
enum SecField {
  kKind, kByteOff, kNbytes, kFirstTile, kCount, kOutBase, kSecFields
};
enum Rep : int { kDcsr = 0, kCsr = 1, kDcsrDelta = 2 };
enum SecKind : int { kResidue = 0, kPairs = 1 };
enum Flag : unsigned { kNone = 0, kAggregate = 1, kPrefix = 2 };

struct Carry {
  int c, e, o;  // varints, even-index sum, odd-index sum (wrapping)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

// a then b (a covers the earlier bytes)
__device__ __forceinline__ Carry comb(Carry a, Carry b, bool pairs) {
  const bool swap = pairs && (a.c & 1);
  return Carry{a.c + b.c, wadd(a.e, swap ? b.o : b.e),
               wadd(a.o, swap ? b.e : b.o)};
}

__device__ __forceinline__ Carry shfl_up(Carry v, int d) {
  return Carry{__shfl_up_sync(kFullMask, v.c, d),
               __shfl_up_sync(kFullMask, v.e, d),
               __shfl_up_sync(kFullMask, v.o, d)};
}

__device__ __forceinline__ Carry shfl_down(Carry v, int d) {
  return Carry{__shfl_down_sync(kFullMask, v.c, d),
               __shfl_down_sync(kFullMask, v.e, d),
               __shfl_down_sync(kFullMask, v.o, d)};
}

__device__ __forceinline__ Carry shfl(Carry v, int src) {
  return Carry{__shfl_sync(kFullMask, v.c, src),
               __shfl_sync(kFullMask, v.e, src),
               __shfl_sync(kFullMask, v.o, src)};
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 pack(Carry v) {
  return make_int4(v.c, v.e, v.o, 0);
}

// Warp 0's look-back for `tile` (not its section's first): the fold of
// the section's earlier tiles.  Lane l reads predecessor tile - 1 - l of
// each window of 32, nearest first; a predecessor before the section's
// first tile counts as an empty prefix.  The window is folded, older on
// the left, up to the nearest prefix.
__device__ Carry look_back(const int4* agg, const int4* pref,
                           const unsigned* flags, int tile, int first,
                           int lane, bool pairs) {
  Carry excl{0, 0, 0};
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    unsigned f = idx >= first ? load_acquire(flags + idx) : kPrefix;
    while (__any_sync(kFullMask, f == kNone)) {
      if (f == kNone) f = load_acquire(flags + idx);
    }
    const unsigned prefixes = __ballot_sync(kFullMask, f == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    Carry v{0, 0, 0};
    if (lane <= stop && idx >= first) {
      const int4 x = __ldcg(f == kPrefix ? pref + idx : agg + idx);
      v = Carry{x.x, x.y, x.z};
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Carry older = shfl_down(v, off);
      if ((lane & (2 * off - 1)) == 0) v = comb(older, v, pairs);
    }
    excl = comb(shfl(v, 0), excl, pairs);
    if (prefixes) return excl;
  }
}

__global__ void __launch_bounds__(kThreads)
sections_kernel(const unsigned char* __restrict__ staged,
                const long long* __restrict__ sec, int n_sec, int4* agg,
                int4* pref, unsigned* flags, unsigned* counter,
                int* __restrict__ csum, int* __restrict__ srcs,
                int* __restrict__ starts) {
  __shared__ int s_tile, s_sec;
  __shared__ Carry warp_tot[kWarps];
  __shared__ Carry s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  if (tid == 0) {
    // tiles in the order blocks start, so a tile waits only on started ones
    const int tile = static_cast<int>(atomicAdd(counter, 1u));
    int s = 0;
    while (s + 1 < n_sec && sec[(s + 1) * kSecFields + kFirstTile] <= tile) {
      ++s;
    }
    s_tile = tile;
    s_sec = s;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long* sd = sec + s_sec * kSecFields;
  const bool pairs = sd[kKind] == kPairs;
  const unsigned char* bytes = staged + sd[kByteOff];
  const long long nbytes = sd[kNbytes];
  const int first = static_cast<int>(sd[kFirstTile]);
  const long long count = sd[kCount];
  const long long out_base = sd[kOutBase];
  const long long b0 = static_cast<long long>(tile - first) * kTileBytes +
                       static_cast<long long>(tid) * kBytesPerThread;

  // bytes b0 - 4 .. b0 + 15 of the section; a byte before it reads as 0,
  // a terminator
  unsigned char win[4 + kBytesPerThread];
  if (b0 >= 4 && b0 + kBytesPerThread <= nbytes) {
    const unsigned h = *reinterpret_cast<const unsigned*>(bytes + b0 - 4);
    const uint4 q = *reinterpret_cast<const uint4*>(bytes + b0);
    const unsigned words[5] = {h, q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4 + kBytesPerThread; ++i) {
      win[i] = static_cast<unsigned char>(words[i >> 2] >> (8 * (i & 3)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 + kBytesPerThread; ++i) {
      const long long p = b0 - 4 + i;
      win[i] = p >= 0 && p < nbytes ? bytes[p] : 0;
    }
  }
  unsigned vals[kBytesPerThread];
  unsigned terms = 0;
  Carry loc{0, 0, 0};
#pragma unroll
  for (int j = 0; j < kBytesPerThread; ++j) {
    vals[j] = 0;
    if (b0 + j >= nbytes || (win[4 + j] & 0x80)) continue;
    int gpos = 4;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if ((win[4 + j - 1 - d] & 0x80) == 0) {
        gpos = d;
        break;
      }
    }
    unsigned v = 0;
#pragma unroll
    for (int d = 0; d <= 4; ++d) {
      if (d <= gpos) {
        v += static_cast<unsigned>(win[4 + j - d] & 0x7F) << (7 * (gpos - d));
      }
    }
    vals[j] = v;
    terms |= 1u << j;
    if (pairs && (loc.c & 1)) {
      loc.o = wadd(loc.o, static_cast<int>(v));
    } else {
      loc.e = wadd(loc.e, static_cast<int>(v));
    }
    ++loc.c;
  }

  // exclusive scan of the threads' carries, in order
  Carry inc = loc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Carry y = shfl_up(inc, off);
    if (lane >= off) inc = comb(y, inc, pairs);
  }
  Carry ex = shfl_up(inc, 1);
  if (lane == 0) ex = Carry{0, 0, 0};
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    Carry z = lane < kWarps ? warp_tot[lane] : Carry{0, 0, 0};
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const Carry y = shfl_up(z, off);
      if (lane >= off) z = comb(y, z, pairs);
    }
    if (lane < kWarps) warp_tot[lane] = z;
  }
  __syncthreads();
  const Carry thread_ex = w > 0 ? comb(warp_tot[w - 1], ex, pairs) : ex;
  if (w == 0) {
    const Carry tile_agg = warp_tot[kWarps - 1];
    Carry excl{0, 0, 0};
    if (tile > first) {
      if (lane == 0) {
        agg[tile] = pack(tile_agg);
        store_release(flags + tile, kAggregate);
      }
      excl = look_back(agg, pref, flags, tile, first, lane, pairs);
    }
    if (lane == 0) {
      pref[tile] = pack(comb(excl, tile_agg, pairs));
      store_release(flags + tile, kPrefix);
      s_excl = excl;
    }
  }
  __syncthreads();

  Carry run = comb(s_excl, thread_ex, pairs);
#pragma unroll
  for (int j = 0; j < kBytesPerThread; ++j) {
    if (!((terms >> j) & 1u)) continue;
    const long long idx = run.c;
    const int v = static_cast<int>(vals[j]);
    if (pairs) {
      if ((run.c & 1) == 0) {
        run.e = wadd(run.e, v);
        if (idx < count) srcs[out_base + idx / 2] = run.e;
      } else {
        run.o = wadd(run.o, v);
        if (idx < count) starts[out_base + idx / 2] = run.o;
      }
    } else {
      run.e = wadd(run.e, v);
      if (idx < count) csum[out_base + idx] = run.e;
    }
    ++run.c;
  }
}

// The last r in [0, n) with offs[r * stride] <= j (offs[0] <= j).
__device__ __forceinline__ int last_at_most(const int* offs, int stride,
                                            int n, int j) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offs + static_cast<long long>(mid) * stride) <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
edges_kernel(const unsigned char* __restrict__ staged,
             const long long* __restrict__ chunks, int n_chunks,
             long long n_edges, const int* __restrict__ csum,
             const int* __restrict__ srcs, const int* __restrict__ starts,
             int* __restrict__ src_out, int* __restrict__ part_out,
             int* __restrict__ dst_out, float* __restrict__ data_out) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  // the chunk: the last with out_off <= e (chunks without edges share
  // their offset with the next one)
  int lo = 0, hi = n_chunks;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunks[mid * kChunkFields + kOutOff] <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const long long* cd = chunks + lo * kChunkFields;
  const long long out_off = cd[kOutOff];
  const int j = static_cast<int>(e - out_off);
  const int rep = static_cast<int>(cd[kRep]);
  int src, h;
  if (rep == kCsr) {
    const int* idx = reinterpret_cast<const int*>(staged + cd[kIndexOff]);
    src = last_at_most(idx, 1, static_cast<int>(cd[kVsrc]), j);
    h = __ldg(idx + src);
  } else {
    const int nnz = static_cast<int>(cd[kNnz]);
    const int* sr;
    const int* st;
    int stride;
    if (rep == kDcsr) {  // raw (src, start) pairs
      sr = reinterpret_cast<const int*>(staged + cd[kIndexOff]);
      st = sr + 1;
      stride = 2;
    } else {
      sr = srcs + cd[kPairOff];
      st = starts + cd[kPairOff];
      stride = 1;
    }
    const int r = last_at_most(st, stride, nnz, j);
    src = __ldg(sr + static_cast<long long>(r) * stride);
    h = __ldg(st + static_cast<long long>(r) * stride);
  }
  const int* cs = csum + out_off;
  const unsigned before = h > 0 ? static_cast<unsigned>(__ldg(cs + h - 1)) : 0u;
  dst_out[e] = static_cast<int>(static_cast<unsigned>(cd[kBase]) +
                                static_cast<unsigned>(__ldg(cs + j)) - before);
  src_out[e] = src;
  part_out[e] = static_cast<int>(cd[kPart]);
  const long long data_off = cd[kDataOff];
  data_out[e] = data_off >= 0
      ? __ldg(reinterpret_cast<const float*>(staged + data_off) + j)
      : 1.0f;
}

}  // namespace

// Decodes one staged item on `stream`: launch 1 over its n_tiles section
// tiles (none when 0), launch 2 over its n_edges edges (none when 0).
// staged: the item's bytes on the card (tables at chunk_off / sec_off,
// zeroed status at status_off); outputs int32 [n_edges] src, part, dst,
// float32 [n_edges] data, and scratch int32 [n_edges] csum and
// [n_pairs] srcs / starts.  Returns cudaGetLastError() (0 on success).
extern "C" int chunk_decode_launch(void* staged, long long chunk_off,
                                   int n_chunks, long long sec_off,
                                   int n_sec, int n_tiles,
                                   long long status_off, long long n_edges,
                                   void* src, void* part, void* dst,
                                   void* data, void* csum, void* srcs,
                                   void* starts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<unsigned char*>(staged);
  const auto* chunks = reinterpret_cast<const long long*>(base + chunk_off);
  if (n_tiles > 0) {
    auto* agg = reinterpret_cast<int4*>(base + status_off);
    int4* pref = agg + n_tiles;
    auto* flags = reinterpret_cast<unsigned*>(pref + n_tiles);
    unsigned* counter = flags + n_tiles;
    sections_kernel<<<n_tiles, kThreads, 0, s>>>(
        base, reinterpret_cast<const long long*>(base + sec_off), n_sec, agg,
        pref, flags, counter, static_cast<int*>(csum),
        static_cast<int*>(srcs), static_cast<int*>(starts));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_edges > 0) {
    const long long blocks = (n_edges + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    edges_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        base, chunks, n_chunks, n_edges, static_cast<const int*>(csum),
        static_cast<const int*>(srcs), static_cast<const int*>(starts),
        static_cast<int*>(src), static_cast<int*>(part),
        static_cast<int*>(dst), static_cast<float*>(data));
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged item's format as this file reads it, for the wrapper to hold
// against its own (kernels/chunk_decode.py FORMAT): the tile's bytes, the
// chunk and section tables' column counts, the representation codes
// (DCSR, CSR, DCSR_DELTA) and the section kinds (residue, pairs).
extern "C" int chunk_decode_format(int* out, int n) {
  const int format[] = {kTileBytes, kChunkFields, kSecFields, kDcsr,
                        kCsr,       kDcsrDelta,   kResidue,   kPairs};
  const int len = static_cast<int>(sizeof(format) / sizeof(format[0]));
  for (int i = 0; i < len && i < n; ++i) out[i] = format[i];
  return len;
}

extern "C" const char* chunk_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
