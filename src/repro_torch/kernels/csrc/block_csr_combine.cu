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
// below the card's ridge point.  R-MAT rows are very uneven (hub rows of
// tens of thousands of live tiles beside rows of none), so the work is
// split by live slots, not by rows, and each split moves its bytes in as
// few, as wide and as independent transactions as it can:
//
// * Merge-path split (Merrill and Garland, SC'16).  The live slots of all
//   n_dest x n_rows rows, flattened in row order, and the rows' ends form
//   one merge path of n_dest * n_rows + (live slots) items; unit (warp) u
//   takes items [u * K, (u + 1) * K), so it holds at most K live slots and
//   runs of empty rows are shared out like slots.  The wrapper computes
//   each unit's first row and first slot (unit_row, unit_slot) from the
//   inclusive prefix of row_cnt (row_end) with one sorted search, for as
//   many units as the path would need with every slot live, so it never
//   waits on the device (units past the path return at once).  The split
//   depends on row_cnt alone, never on the column count NQ.
// * Rows that one unit covers whole are written straight to val / hascnt.
//   A row that spans units gets one partial per unit in scratch: the unit
//   where it starts or runs through writes its "tail" entry, the unit that
//   consumes the row's end its "head" entry.  The fixup kernel then folds,
//   for each such row, the tails of the units before in unit order, then
//   the head, and writes the row.  No atomics: the same inputs give the
//   same bits on every run.  Partials are double for add / add_b, float
//   for min / max and hascnt, so the fold is the same arithmetic as within
//   a unit.
// * A unit loads the tile_idx / tile_col of 32 slots at once (lane i,
//   slot i; one coalesced load each) and broadcasts them with
//   __shfl_sync, so the tile loads of consecutive slots do not wait on an
//   index load and a batch of them is in flight per warp.  Tiles are read
//   once, so they are loaded with the streaming hint (__ldcs) and do not
//   push the gathered vector blocks out of L2.
// * Each lane holds two neighbouring cells of the 8 x 8 tile (row lane/4,
//   columns 2*(lane%4) and +1), so a tile is one coalesced 256 B float2
//   load per warp and the vector block a 32 B broadcast gather.  The four
//   lanes of a tile row are reduced with __shfl_xor_sync at each row end.
// * Sums accumulate in double (products of two floats are exact in
//   double), so the float result depends on the summation order only in
//   the last bits of the double.  min/max are exact in any order, so they
//   are bit-equal to any correct implementation: B + xv is one float add
//   (no contraction is possible), and an overflow to +-inf in an empty
//   cell still folds to the identity.  Build without --use_fast_math.
//
// One call launches two kernels: the combine over every unit and the
// fixup (one warp per unit; units that finish no spanning row return at
// once).  What bounds it now is the bytes of the live tiles, plus the
// fixup's sequential fold of a hub row's partials: one per K of its
// tiles.  K (kUnit) = 128 was timed against 64, 256 and 512 on the
// card at 4M tiles; see PERF.md.
//
// The multi-query panel entry point (`block_csr_combine_mq_launch`)
// replaces the Pallas TPU kernel `block_csr_combine_mq` of the same file
// (body `_make_combine_kernel_mq`): the same tiles folded against NQ value
// and presence columns at once, xv / xc being row-major [C * 8, ld] panels
// of which the launch reads the NQ columns starting at col0.  Both kernel
// bodies are one template over NQ; the solo entry point is its NQ = 1
// instance, and since the split does not depend on NQ every column runs
// the solo kernel's units, lane mapping, accumulation order, shuffle steps
// and fixup order, and is bit-identical to a solo call on that column (in
// the add modes too).  A tile is read once for all NQ columns; the 8 x NQ
// vector block a tile selects is two rows of NQ contiguous floats per lane
// (float4 loads when NQ >= 4).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kCells = kTile * kTile;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnit = 128;                  // merge-path items per unit
constexpr int kFoldBatch = 8;               // partials loaded per fold step
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kUnit >= 2, "a unit must hold at least two merge-path items");

enum Mode : int { kAdd = 0, kAddB = 1, kMin = 2, kMax = 3 };

template <int MODE>
struct Partial {
  using T = float;            // min / max
};
template <>
struct Partial<kAdd> {
  using T = double;
};
template <>
struct Partial<kAddB> {
  using T = double;
};

// NaN-propagating extremum, as torch.minimum / torch.maximum.
template <int MODE>
__device__ __forceinline__ float extremum(float a, float b) {
  if (MODE == kMin) return (a != a || a < b) ? a : b;
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Tiles are read once: stream them past L1 and L2's working set.
__device__ __forceinline__ float2 stream2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
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

// Slots whose loads one lane issues before it folds any of them: enough
// to keep several tiles in flight, few enough for the NQ-wide registers.
template <int NQ>
__host__ __device__ constexpr int slot_batch() {
  return NQ >= 16 ? 1 : (16 / NQ > 8 ? 8 : 16 / NQ);
}

// Everything one slot contributes, loaded.
template <int NQ>
struct SlotLoad {
  float2 tc, tv, tb;
  float p0[NQ], p1[NQ], v0[NQ], v1[NQ];
};

struct Args {
  const int* row_ptr;
  const int* tile_idx;
  const int* tile_col;
  const int* row_end;
  const int* unit_row;
  const int* unit_slot;
  const float* tiles_v;
  const float* tiles_b;
  const float* tiles_cnt;
  const float* xv;
  const float* xc;
  float* val;
  float* hascnt;
  void* part_val;      // [2, n_units, 8, NQ] double (add) or float
  float* part_cnt;     // [2, n_units, 8, NQ]
  int n_dest, n_rows, n_slots, n_src, n_units, ld, col0;
  float identity;
};

template <int MODE, int NQ>
struct Acc {
  double acc[NQ];    // add / add_b
  float ext[NQ];     // min / max
  float hc[NQ];

  __device__ __forceinline__ void clear(float identity) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      acc[i] = 0.0;
      ext[i] = identity;
      hc[i] = 0.0f;
    }
  }

  __device__ __forceinline__ void fold(const SlotLoad<NQ>& s) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      hc[i] += s.tc.x * s.p0[i] + s.tc.y * s.p1[i];  // small integers: exact
      if (MODE == kAdd || MODE == kAddB) {
        acc[i] += static_cast<double>(s.tv.x) * s.v0[i] +
                  static_cast<double>(s.tv.y) * s.v1[i];
        if (MODE == kAddB) {
          acc[i] += static_cast<double>(s.tb.x) * s.p0[i] +
                    static_cast<double>(s.tb.y) * s.p1[i];
        }
      } else {
        ext[i] = extremum<MODE>(ext[i], extremum<MODE>(s.tb.x + s.v0[i],
                                                       s.tb.y + s.v1[i]));
      }
    }
  }

  // The four lanes of a tile row: lanes with lane % 4 == 0 end with the
  // row's sums.
  __device__ __forceinline__ void reduce_row() {
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
  }
};

// Folds `n` compacted slots starting at tile_idx / tile_col position `pos`
// (all of destination q) into `a`.
template <int MODE, int NQ>
__device__ __forceinline__ void fold_slots(const Args& g, long long pos,
                                           int n, long long tile0,
                                           const float* xvq,
                                           const float* xcq, int lane,
                                           Acc<MODE, NQ>& a) {
  constexpr int kBatch = slot_batch<NQ>();
  const int cell = lane * 2;
  const int j0 = (lane & 3) * 2;
  const long long ld = g.ld;
  for (int c = 0; c < n; c += 32) {
    const int m = min(32, n - c);
    int my_idx = 0, my_col = 0;
    if (lane < m) {
      my_idx = __ldcs(g.tile_idx + pos + c + lane);
      my_col = __ldcs(g.tile_col + pos + c + lane);
    }
    for (int k = 0; k < m; k += kBatch) {
      SlotLoad<NQ> s[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = __shfl_sync(kFullMask, my_idx, k + b);
        const int col = __shfl_sync(kFullMask, my_col, k + b);
        if (k + b < m) {
          const long long off = (tile0 + idx) * kCells + cell;
          const long long x = static_cast<long long>(col * kTile + j0) * ld;
          s[b].tc = stream2(g.tiles_cnt + off);
          load_pair<NQ>(xcq + x, ld, s[b].p0, s[b].p1);
          if (MODE == kAdd || MODE == kAddB) {
            s[b].tv = stream2(g.tiles_v + off);
            load_pair<NQ>(xvq + x, ld, s[b].v0, s[b].v1);
          }
          if (MODE != kAdd) s[b].tb = stream2(g.tiles_b + off);
          if (MODE == kMin || MODE == kMax) {
            load_pair<NQ>(xvq + x, ld, s[b].v0, s[b].v1);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k + b < m) a.fold(s[b]);
      }
    }
  }
}

template <int MODE, int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_kernel(const Args g) {
  using P = typename Partial<MODE>::T;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (u >= g.n_units) return;                     // whole warp
  const int lane = threadIdx.x & 31;
  const int n_flat = g.n_dest * g.n_rows;
  const int f0 = __ldg(g.unit_row + u), f1 = __ldg(g.unit_row + u + 1);
  const int s0 = __ldg(g.unit_slot + u), s1 = __ldg(g.unit_slot + u + 1);
  const int last = f1 < n_flat ? f1 : n_flat - 1;  // f1 unfinished: a tail
  Acc<MODE, NQ> a;
  for (int f = f0; f <= last; ++f) {
    const int rs = f == 0 ? 0 : __ldg(g.row_end + f - 1);
    const int re = __ldg(g.row_end + f);
    const int lo = rs > s0 ? rs : s0;
    const int hi = re < s1 ? re : s1;
    const int q = f / g.n_rows;
    const int r = f - q * g.n_rows;
    const long long tile0 = static_cast<long long>(q) * g.n_slots;
    const long long pos =
        tile0 + __ldg(g.row_ptr + static_cast<long long>(q) * (g.n_rows + 1) +
                      r) + (lo - rs);
    const long long xoff = static_cast<long long>(q) * g.n_src * g.ld + g.col0;
    a.clear(g.identity);
    fold_slots<MODE, NQ>(g, pos, hi - lo, tile0, g.xv + xoff, g.xc + xoff,
                         lane, a);
    a.reduce_row();
    if ((lane & 3) != 0) continue;   // no shuffle follows in this row
    const int row = lane >> 2;
    if (f < f1 && rs >= s0) {          // the whole row is this unit's
      const long long o =
          (static_cast<long long>(f) * kTile + row) * g.ld + g.col0;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        g.val[o + i] = (MODE == kAdd || MODE == kAddB)
                           ? static_cast<float>(
                                 static_cast<double>(g.identity) + a.acc[i])
                           : a.ext[i];
        g.hascnt[o + i] = a.hc[i];
      }
    } else {                           // head (f < f1) or tail (f == f1)
      const long long o =
          ((static_cast<long long>(f < f1 ? 0 : 1) * g.n_units + u) * kTile +
           row) * NQ;
      P* pv = static_cast<P*>(g.part_val);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if constexpr (MODE == kAdd || MODE == kAddB) {
          pv[o + i] = a.acc[i];
        } else {
          pv[o + i] = a.ext[i];
        }
        g.part_cnt[o + i] = a.hc[i];
      }
    }
  }
}

// One warp per unit u.  If u consumes the end of a row that began in an
// earlier unit (its first row f, with row start < the unit's first slot),
// fold the tails of the units u' < u that end inside row f, in unit
// order, then u's head, and write row f.  One lane per output cell.
template <int MODE, int NQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fixup_kernel(const Args g) {
  using P = typename Partial<MODE>::T;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (u >= g.n_units) return;
  const int lane = threadIdx.x & 31;
  const int f = __ldg(g.unit_row + u);
  if (f >= __ldg(g.unit_row + u + 1)) return;     // no row ends here
  const int rs = f == 0 ? 0 : __ldg(g.row_end + f - 1);
  if (rs >= __ldg(g.unit_slot + u)) return;        // written whole
  // first unit whose end lies in row f: unit_row[v + 1] == f for v in
  // [first, u); unit_row is nondecreasing and unit_row[u] == f
  int lo = 0, hi = u - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(g.unit_row + mid + 1) < f) lo = mid + 1; else hi = mid;
  }
  const P* pv = static_cast<const P*>(g.part_val);
  const long long tails = 1LL * g.n_units * kTile * NQ;
  for (int cell = lane; cell < kTile * NQ; cell += 32) {
    P v = (MODE == kAdd || MODE == kAddB) ? P(0) : P(g.identity);
    float h = 0.0f;
    for (int w = lo; w < u; w += kFoldBatch) {
      P bv[kFoldBatch];
      float bh[kFoldBatch];
#pragma unroll
      for (int b = 0; b < kFoldBatch; ++b) {
        if (w + b < u) {
          const long long o = tails + (static_cast<long long>(w + b) *
                                       kTile * NQ) + cell;
          bv[b] = pv[o];
          bh[b] = g.part_cnt[o];
        }
      }
#pragma unroll
      for (int b = 0; b < kFoldBatch; ++b) {
        if (w + b < u) {
          if constexpr (MODE == kAdd || MODE == kAddB) {
            v += bv[b];
          } else {
            v = extremum<MODE>(v, bv[b]);
          }
          h += bh[b];
        }
      }
    }
    const long long head = static_cast<long long>(u) * kTile * NQ + cell;
    float out;
    if constexpr (MODE == kAdd || MODE == kAddB) {
      v += pv[head];
      out = static_cast<float>(static_cast<double>(g.identity) + v);
    } else {
      out = extremum<MODE>(v, pv[head]);
    }
    h += g.part_cnt[head];
    const long long o =
        (static_cast<long long>(f) * kTile + cell / NQ) * g.ld + g.col0 +
        cell % NQ;
    g.val[o] = out;
    g.hascnt[o] = h;
  }
}

template <int NQ>
int launch(int mode, const Args& g, void* stream) {
  if (g.n_units == 0) return 0;
  const long long blocks =
      (static_cast<long long>(g.n_units) + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(M)                                   \
  combine_kernel<M, NQ><<<grid, block, 0, s>>>(g);        \
  if (cudaPeekAtLastError() == cudaSuccess) {             \
    fixup_kernel<M, NQ><<<grid, block, 0, s>>>(g);        \
  }
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

Args make_args(int n_dest, int n_rows, int n_slots, int n_src, int n_units,
               int ld, int col0, float identity, const void* row_ptr,
               const void* tile_idx, const void* tile_col,
               const void* row_end, const void* unit_row,
               const void* unit_slot, const void* tiles_v,
               const void* tiles_b, const void* tiles_cnt, const void* xv,
               const void* xc, void* val, void* hascnt, void* part_val,
               void* part_cnt) {
  Args g;
  g.row_ptr = static_cast<const int*>(row_ptr);
  g.tile_idx = static_cast<const int*>(tile_idx);
  g.tile_col = static_cast<const int*>(tile_col);
  g.row_end = static_cast<const int*>(row_end);
  g.unit_row = static_cast<const int*>(unit_row);
  g.unit_slot = static_cast<const int*>(unit_slot);
  g.tiles_v = static_cast<const float*>(tiles_v);
  g.tiles_b = static_cast<const float*>(tiles_b);
  g.tiles_cnt = static_cast<const float*>(tiles_cnt);
  g.xv = static_cast<const float*>(xv);
  g.xc = static_cast<const float*>(xc);
  g.val = static_cast<float*>(val);
  g.hascnt = static_cast<float*>(hascnt);
  g.part_val = part_val;
  g.part_cnt = static_cast<float*>(part_cnt);
  g.n_dest = n_dest;
  g.n_rows = n_rows;
  g.n_slots = n_slots;
  g.n_src = n_src;
  g.n_units = n_units;
  g.ld = ld;
  g.col0 = col0;
  g.identity = identity;
  return g;
}

}  // namespace

// Merge-path items per unit (K): the wrapper splits by it.
extern "C" int block_csr_combine_unit_slots() { return kUnit; }

// Launches the combine and its fixup on `stream` and returns
// cudaGetLastError() (0 on success).  Shapes: row_ptr [n_dest, n_rows + 1],
// tile_idx / tile_col [n_dest, n_slots], row_end [n_dest * n_rows] (the
// inclusive prefix of row_cnt), unit_row / unit_slot [n_units + 1] (int32);
// tiles [n_dest, n_slots, 8, 8], xv / xc [n_dest, n_src], val / hascnt
// [n_dest, n_rows * 8] (float32); part_val [2, n_units, 8] (double for
// add / add_b, float for min / max) and part_cnt [2, n_units, 8] (float)
// are scratch.  All contiguous.  Tiles a mode does not read may be null.
extern "C" int block_csr_combine_launch(
    int mode, int tile, int n_dest, int n_rows, int n_slots, int n_src,
    int n_units, float identity, const void* row_ptr, const void* tile_idx,
    const void* tile_col, const void* row_end, const void* unit_row,
    const void* unit_slot, const void* tiles_v, const void* tiles_b,
    const void* tiles_cnt, const void* xv, const void* xc, void* val,
    void* hascnt, void* part_val, void* part_cnt, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const Args g = make_args(n_dest, n_rows, n_slots, n_src, n_units, 1, 0,
                           identity, row_ptr, tile_idx, tile_col, row_end,
                           unit_row, unit_slot, tiles_v, tiles_b, tiles_cnt,
                           xv, xc, val, hascnt, part_val, part_cnt);
  return launch<1>(mode, g, stream);
}

// The panel combine over columns [col0, col0 + nq) of the row-major panels
// xv / xc [n_dest, n_src, ld] into val / hascnt [n_dest, n_rows * 8, ld];
// nq is 1, 2, 4, 8 or 16, and ld and col0 are multiples of min(nq, 4)
// (the wrapper pads and groups columns to meet that).  The scratch is
// [2, n_units, 8, nq].  Same structure arguments and return value as the
// solo entry point.
extern "C" int block_csr_combine_mq_launch(
    int mode, int tile, int nq, int n_dest, int n_rows, int n_slots,
    int n_src, int n_units, int ld, int col0, float identity,
    const void* row_ptr, const void* tile_idx, const void* tile_col,
    const void* row_end, const void* unit_row, const void* unit_slot,
    const void* tiles_v, const void* tiles_b, const void* tiles_cnt,
    const void* xv, const void* xc, void* val, void* hascnt, void* part_val,
    void* part_cnt, void* stream) {
  if (tile != kTile || col0 < 0 || col0 + nq > ld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g = make_args(n_dest, n_rows, n_slots, n_src, n_units, ld, col0,
                           identity, row_ptr, tile_idx, tile_col, row_end,
                           unit_row, unit_slot, tiles_v, tiles_b, tiles_cnt,
                           xv, xc, val, hascnt, part_val, part_cnt);
  switch (nq) {
    case 1: return launch<1>(mode, g, stream);
    case 2: return launch<2>(mode, g, stream);
    case 4: return launch<4>(mode, g, stream);
    case 8: return launch<8>(mode, g, stream);
    case 16: return launch<16>(mode, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* block_csr_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
