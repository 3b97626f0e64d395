// Deterministic segmented sum, the scatter of the normal-equation assembly:
//
//   out[s, c] = sum_{e in [offsets[s], offsets[s+1])} contrib[perm[e], c]
//
// contrib (E, C), perm (E,) int32, offsets (n_slots + 1,) int32 ascending
// from 0 to E, out (n_slots, C), any C, float or double.  The plan (perm,
// offsets) is built once on the host by a stable sort of every
// contribution's destination.  No value is added atomically: the bits
// depend on the plan, C and the body chosen, and are the same on every run.
//
// Replaces pyslam_tpu/solver/pallas_ops.py::scatter_matmul, which turned
// the scatter into a one-hot (T, W) matmul per tile of slots because Mosaic
// has neither a vector scatter nor an in-kernel gather.  Here the gather
// contrib[perm[e]] happens inside the kernel.
//
// What bounds it on an H100.  At bench config 6's pair plans (6,240,488 and
// 9,282,696 rows of 36 floats into 17,076 and 23,292 blocks of S) it is
// bytes: 926 MB and 1.38 GB, 276 and 411 us at 3.35 TB/s, against one
// addition a value (3.4 and 5.0 us at 67 TFLOP/s).  At sphere2500's
// assembly (19,792 x 36 into 22,500, 6.3 MB, 1.9 us) and every smaller
// plan everything sits in L2, and the launch and the dependent round trips
// of a segment (offsets, perm, rows) are the time.
//
// The plans are skewed: a block of S between two cameras sums one row per
// co-observed landmark pair, thousands for neighbouring cameras and a few
// for distant ones (config 6's pair plans: median 65 to 77 rows, longest
// 18,576).  A sub-warp or a block a destination leaves the longest
// destination's chain of rows to set the time, so such plans are cut by
// length, in one launch and with no read of the device (the unit kernel):
//
//  * A segment of at most kSeqRows = 64 rows is summed by a sub-warp of its
//    own, lanes across the row in 16-, 8- or 4-byte units (the widest the
//    row's bytes and base address allow, for any C; the wrapper picks it),
//    the rows one after the other in plan order, 8 units a lane in flight,
//    the next rows' perm loaded while the rows before them are: the bits of
//    the sequential sum, 0 + row lo + row lo+1 + ....  These are the blocks
//    past the tile blocks, kThreads / lanes segments a block.
//  * Longer segments belong to tiles of R = kTileRows = 256 plan positions,
//    grouped `group` tiles a block (about 128 KB of rows, while that leaves
//    two such blocks an SM).  A block finds the segments that hold its first
//    and last rows (a search by two half-blocks, 128 probes a round), reads
//    the bounds of those between, and lists the pieces that start in its
//    rows: a segment of 65 to R rows whole, and of a longer one each chunk
//    [lo + k R, lo + (k + 1) R).  It sums up to kRound pieces at once, their
//    perm staged in shared memory, thread (piece, j, unit) adding the
//    piece's rows j, j + 8, j + 16, ... one after the other, 8 or 16 loads
//    in flight; then the 8 partial sums of a column are added in order of
//    j.  A whole segment's sum goes to out; a chunk's to its row of
//    `partial` (two a tile: the chunk running in from before the tile, and
//    chunk 0 of the one long segment that can start in it).
//  * The chunks' sums are added in chunk order (0 + chunk 0 + chunk 1 + ...)
//    by whichever block writes the segment's last chunk to arrive: each
//    block counts its chunks in `arrivals[lo / R]` after a fence, and the
//    block that counts a segment's last chunk adds them and puts the
//    counter back to 0.  The counter orders the combine and never touches
//    a value.  The wrapper keeps `arrivals` zeroed, one buffer a stream, and
//    allocates `partial` (2 tiles, C).
//
// kSeqRows = 64: a sub-warp's chain of 64 rows is 8 to 16 round trips,
// about the time of a tile's search and staging.  R = 256 and the stride
// 8: a chunk of 256 rows is 32 rows a thread, one or two batches of loads;
// tiles of 128 rows were slower at both pair plans (0.445 and 0.651 ms
// against 0.413 and 0.602, PERF.md).  Hopper's bulk copy (cp.async.bulk)
// was not tried: the loads are gathers of rows of 12 to 324 bytes.
//
// Two more bodies stay, each where it was measured faster than the unit
// kernel (profile_port.py --cells slot_shapes, PERF.md); the caller picks
// one from the shape and the plan's longest segment, noted where the plan
// is built (cuda_ops.slot_reduce_body), so one plan always sums in one
// order:
//  * slot_rows_kernel, a sub-warp a segment with C a template parameter
//    (C = 3, 6, 7, 9, 36, 49 on an aligned row: nine float4 at C = 36, the
//    sums in registers; slot_row.cuh); at other widths and unaligned rows
//    the unit kernel's short body without tile blocks takes its place, with
//    the same bits.  Against that body, which reads C at run time, it saved
//    0.1 to 0.6 us a call at the small plans and 7 to 16% at config 6's
//    sums by landmark.
//  * slot_block_kernel, a block of 1024 threads a destination (Rb = 1024 /
//    C rows in flight, their partial sums added pairwise), for few
//    destinations of many rows (64 on average, more past 1024 destinations)
//    whose longest chain, ceil(longest / Rb), is at most 64 rows: config
//    4's sums by camera (49 destinations of about 526 rows), sphere2500's
//    two-level coarse sums, Venice-mini's by camera at widths 27 and 6.
//    There the unit kernel's tiles are few, and each is 6 to 8 dependent
//    round trips (search, bounds, perm, rows, partial, fence, arrival,
//    combine) to the block's 3.  A skewed plan of many short destinations
//    and a few long ones (BAL's sums by landmark: a million destinations of
//    2 or 3 rows, tracks up to thousands) takes the tiles: a block each
//    would be a million blocks of 1024 threads, scheduled 264 at a time.
//    Where such a plan is one wave of 264 blocks and its longest chain at
//    most 16 rows (the fixed-lag windows' sums: about 100 destinations,
//    one of 1,000 rows or more), the block takes it again: 0.56 to 0.90 of
//    the tiles' time in f32 and 0.39 to 0.63 in f64 on skewed plans of 32
//    to 264 destinations at widths 2 to 36; past one wave or such a chain
//    the block is slower on most.
// A plan whose segments all have at most R rows keeps the choice between
// these two that the rule before the unit kernel made (a block for few
// destinations of many rows on average, else sub-warps), and with it that
// rule's bits: the sequential sum under sub-warps.  In the unit kernel the
// sequential bits hold up to kSeqRows rows a segment, since a longer one
// on a sub-warp is a chain that a tile sums in an eighth of the steps.  A
// plan whose longest segment is not known takes the unit kernel with its
// tiles, which sums every plan.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;  // R: the plan positions of a tile
constexpr int kSeqRows = 64;    // the longest segment a sub-warp sums
constexpr int kMaxGroup = 64;   // tiles a block of the long segments' pieces
constexpr int kJ = 8;           // the row stride of a piece's partial sums
constexpr int kPieces = 6;      // piece starts a tile holds at most (R / kSeqRows + 2 for R = 256)
constexpr int kRound = 8;       // pieces a block sums at once
constexpr int kSlabUnits = 32;  // units of a row a piece's threads take at once
constexpr int kBatch = 8;       // partial sums loaded before they are added

// The dynamic shared memory of the chunk blocks (chunk_tiles' tables).
__host__ __device__ constexpr int chunk_smem() {
  return kThreads * 16 + 4 * (kRound * kTileRows + 4 * kPieces * kMaxGroup + 2 * kMaxGroup);
}

// errors the entry points return besides CUDA's (which are positive)
constexpr int kBadShape = -1;

// U bytes of a row: the unit of every load and store
template <typename T, int U>
struct alignas(U) Unit {
  static constexpr int kN = U / (int)sizeof(T);
  T v[kN];
};

template <typename T, int U>
__device__ __forceinline__ void add(Unit<T, U>& acc, const Unit<T, U>& x) {
#pragma unroll
  for (int q = 0; q < Unit<T, U>::kN; ++q) acc.v[q] += x.v[q];
}

template <typename T, int U>
__device__ __forceinline__ Unit<T, U> zero() {
  Unit<T, U> z;
#pragma unroll
  for (int q = 0; q < Unit<T, U>::kN; ++q) z.v[q] = T(0);
  return z;
}

// The first i in [0, n) with a[i] >= key (n if none), a ascending, for two
// keys at once: the first half of the block searches for key[0], the
// second for key[1], probing 128 entries a round (three rounds up to two
// million entries).  Called by every thread; returns the thread's half's.
__device__ int block_lower_bound2(const int* __restrict__ a, int n, int key0, int key1) {
  constexpr int kHalf = kThreads / 2;
  __shared__ int count[kThreads / 32];
  const int half = threadIdx.x / kHalf, me = threadIdx.x - half * kHalf;
  const int key = half ? key1 : key0;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  bool done = false;
  while (true) {
    const int len = hi - lo;
    const int step = len <= kHalf ? 1 : (len + kHalf - 1) / kHalf;
    const long long i = (long long)lo + (long long)me * step;
    const unsigned below = __ballot_sync(0xffffffffu, !done && i < hi && a[i] < key);
    if ((threadIdx.x & 31) == 0) count[threadIdx.x / 32] = __popc(below);
    __syncthreads();
    int c = 0;
    for (int w = half * (kHalf / 32); w < (half + 1) * (kHalf / 32); ++w) c += count[w];  // a prefix of probes
    __syncthreads();
    if (!done) {
      if (step == 1) {
        lo += c;
        done = true;
      } else if (c == 0) {
        done = true;
      } else {
        const long long next = (long long)lo + (long long)c * step;
        lo += (c - 1) * step + 1;
        if (c < kHalf && next < hi) hi = (int)next;
        done = hi <= lo;
      }
    }
    if (!__syncthreads_or(!done)) break;
  }
  return lo;
}

// ---- short segments: a sub-warp each, the rows one after the other --------
// With `tiles`, a segment longer than kSeqRows is left to the tile blocks;
// without, every segment is summed here.
template <typename T, int U, int UPL>
__device__ void short_segments(const T* __restrict__ contrib, const int* __restrict__ perm,
                               const int* __restrict__ offsets, T* __restrict__ out, int n_slots, int C,
                               int lanes, bool tiles, int block) {
  using V = Unit<T, U>;
  constexpr int kRows = 8 / UPL;  // rows in flight
  const int L = lanes;
  const long long seg = ((long long)block * kThreads + threadIdx.x) / L;
  if (seg >= n_slots) return;  // a whole sub-warp leaves together
  const int lane = threadIdx.x & (L - 1);
  const int lo = offsets[seg], hi = offsets[seg + 1];
  if (tiles && hi - lo > kSeqRows) return;  // a longer segment: the tiles sum it
  const int nu = C / V::kN;  // units a row
  for (int u0 = 0; u0 < nu; u0 += L * UPL) {
    V acc[UPL];
#pragma unroll
    for (int k = 0; k < UPL; ++k) acc[k] = zero<T, U>();
    int next[kRows];  // perm of the next rows, loaded while the rows before them are
#pragma unroll
    for (int i = 0; i < kRows; ++i) next[i] = lo + i < hi ? perm[lo + i] : 0;
    for (int base = lo; base < hi; base += kRows) {
      V v[kRows][UPL];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (base + i < hi) {
          const V* row = reinterpret_cast<const V*>(contrib + (long long)next[i] * C);
#pragma unroll
          for (int k = 0; k < UPL; ++k) {
            const int u = u0 + lane + k * L;
            if (u < nu) v[i][k] = row[u];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) next[i] = base + kRows + i < hi ? perm[base + kRows + i] : 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (base + i < hi) {
#pragma unroll
          for (int k = 0; k < UPL; ++k) {
            if (u0 + lane + k * L < nu) add(acc[k], v[i][k]);
          }
        }
      }
    }
    V* y = reinterpret_cast<V*>(out + seg * C);
#pragma unroll
    for (int k = 0; k < UPL; ++k) {
      const int u = u0 + lane + k * L;
      if (u < nu) y[u] = acc[k];
    }
  }
}

// Pieces [i0, i0 + n) of the block's list, summed together: thread
// (piece, j, unit u) adds the piece's rows j, j + kJ, j + 2 kJ, ... one after
// the other, kLoads in flight (their perm staged in shared memory first);
// then the kJ sums of each column are added in order of j into the piece's
// row of out (a whole segment) or of `partial` (a chunk).  Rows of more
// than kSlabUnits units go in slabs.
template <typename T, int U>
__device__ void chunk_round(const T* __restrict__ contrib, const int* __restrict__ perm, T* __restrict__ out,
                            T* __restrict__ partial,
                            const int* q_start, const int* q_end, const int* q_row, int i0, int n, int C,
                            int* s_perm, T* sp) {
  using V = Unit<T, U>;
  constexpr int kLoads = U == 8 ? 16 : 8;  // rows in flight: 128 bytes of 8-byte units, 8 of the others
  const int nu = C / V::kN;
  for (int i = 0; i < n; ++i) {
    const int p0 = q_start[i0 + i], rows = q_end[i0 + i] - p0;
    for (int r = threadIdx.x; r < rows; r += kThreads) s_perm[i * kTileRows + r] = perm[p0 + r];
  }
  __syncthreads();
  for (int u0 = 0; u0 < nu; u0 += kSlabUnits) {
    const int nus = nu - u0 < kSlabUnits ? nu - u0 : kSlabUnits;
    const int slab = nus * V::kN;  // values of the slab
    const int per_piece = kJ * nus;
    for (int task = threadIdx.x; task < n * per_piece; task += kThreads) {
      const int i = task / per_piece, rem = task - i * per_piece;
      const int j = rem / nus, u = u0 + rem - j * nus;
      const int rows = q_end[i0 + i] - q_start[i0 + i];
      const int* pp = s_perm + i * kTileRows;
      V acc = zero<T, U>();
      for (int r0 = j; r0 < rows; r0 += kLoads * kJ) {
        V v[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int r = r0 + k * kJ;
          if (r < rows) v[k] = reinterpret_cast<const V*>(contrib + (long long)pp[r] * C)[u];
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          if (r0 + k * kJ < rows) add(acc, v[k]);
        }
      }
      reinterpret_cast<V*>(sp + (i * kJ + j) * slab)[u - u0] = acc;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < n * slab; x += kThreads) {
      const int i = x / slab, c = x - i * slab;
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc += sp[(i * kJ + j) * slab + c];
      const int row = q_row[i0 + i];  // >= 0: a row of partial; < 0: -1 - a row of out
      (row >= 0 ? partial + (long long)row * C : out + (long long)(-1 - row) * C)[u0 * V::kN + c] = acc;
    }
    __syncthreads();
  }
}

// An exclusive prefix sum of v over the block, and the block's total.
__device__ __forceinline__ int block_scan(int v, int& total) {
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_sum[w];
    total += warp_sum[w];
  }
  __syncthreads();
  return before + x - v;
}

// ---- long segments: `group` tiles of R positions a block, their chunks ----
template <typename T, int U>
__device__ void chunk_tiles(const T* __restrict__ contrib, const int* __restrict__ perm,
                            const int* __restrict__ offsets, T* __restrict__ out, T* __restrict__ partial,
                            int* __restrict__ arrivals, int E, int n_slots, int C, int group, int block) {
  // dynamic shared memory (chunk_smem), launched only with these blocks: a
  // round's partial sums (at most kThreads x 16 bytes), the round's perm;
  // the pieces that start in the block's rows, in plan order, segments of
  // kSeqRows to R rows and chunks of longer ones (a tile holds at most
  // R / kSeqRows + 2 piece starts, two of them chunks): segment, first and
  // end row, row of partial (or -1 - row of out); the segments to combine
  extern __shared__ __align__(16) unsigned char dyn[];
  T* sp = reinterpret_cast<T*>(dyn);
  int* s_perm = reinterpret_cast<int*>(dyn + kThreads * 16);
  int* q_seg = s_perm + kRound * kTileRows;
  int* q_start = q_seg + kPieces * kMaxGroup;
  int* q_end = q_start + kPieces * kMaxGroup;
  int* q_row = q_end + kPieces * kMaxGroup;
  int* s_combine = q_row + kPieces * kMaxGroup;
  __shared__ int s_seg[2], s_n_combine;
  const long long first_row = (long long)block * group * kTileRows;
  const int rows_lo = (int)first_row;
  const int rows_hi = E - first_row < (long long)group * kTileRows ? E : (int)(first_row + (long long)group * kTileRows);
  // the segments that hold the block's first and last rows: the last s with
  // offsets[s] <= row, never an empty one
  const int found = block_lower_bound2(offsets, n_slots + 1, rows_lo + 1, rows_hi) - 1;
  if (threadIdx.x == 0) {
    s_seg[0] = found;
    s_n_combine = 0;
  }
  if (threadIdx.x == kThreads - 1) s_seg[1] = found;
  __syncthreads();
  const int first_seg = s_seg[0], last_seg = s_seg[1];
  int n = 0;
  for (int s0 = first_seg; s0 <= last_seg; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    int lo = 0, hi = 0, k_lo = 0, count = 0;
    if (s <= last_seg) {
      lo = offsets[s];
      hi = offsets[s + 1];
      if (hi - lo > kTileRows) {  // its chunks that start in [rows_lo, rows_hi)
        k_lo = lo >= rows_lo ? 0 : (int)(((long long)rows_lo - lo + kTileRows - 1) / kTileRows);
        const int end = hi < rows_hi ? hi : rows_hi;
        count = (end - 1 - lo) / kTileRows - k_lo + 1;
        if (count < 0) count = 0;
      } else if (hi - lo > kSeqRows && lo >= rows_lo) {  // a segment of one piece, if it starts here
        count = 1;
      }
    }
    if (!__syncthreads_or(count > 0)) continue;  // most windows of most plans: no long segment
    int total;
    const int at = n + block_scan(count, total);
    for (int k = 0; k < count; ++k) {
      const int p0 = lo + (k_lo + k) * kTileRows;
      q_seg[at + k] = s;
      q_start[at + k] = p0;
      q_end[at + k] = hi - p0 < kTileRows ? hi : p0 + kTileRows;
      // two rows of partial a tile: the chunk running in, a chunk 0
      q_row[at + k] = hi - lo > kTileRows ? 2 * (p0 / kTileRows) + (p0 == lo) : -1 - s;
    }
    n += total;
  }
  if (n == 0) return;  // every thread: n is the block's
  __syncthreads();
  {
    const int nus = C / Unit<T, U>::kN < kSlabUnits ? C / Unit<T, U>::kN : kSlabUnits;
    int per_round = kThreads / (kJ * nus);
    per_round = per_round < 1 ? 1 : per_round > kRound ? kRound : per_round;
    for (int i0 = 0; i0 < n; i0 += per_round) {
      chunk_round<T, U>(contrib, perm, out, partial, q_start, q_end, q_row, i0,
                           n - i0 < per_round ? n - i0 : per_round, C, s_perm, sp);
    }
  }
  // ---- the last chunk of a segment to arrive adds its chunks in order ---
  __threadfence();  // this block's partial rows, before their arrival is counted
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (q_row[i] < 0) continue;  // summed whole
    const int seg = q_seg[i];
    const int lo = offsets[seg], hi = offsets[seg + 1];
    const int chunks = (int)(((long long)hi - lo + kTileRows - 1) / kTileRows);
    if (atomicAdd(&arrivals[lo / kTileRows], 1) == chunks - 1) {
      arrivals[lo / kTileRows] = 0;
      s_combine[atomicAdd(&s_n_combine, 1)] = seg;
    }
  }
  __threadfence();
  __syncthreads();
  for (int k = 0; k < s_n_combine; ++k) {
    const int seg = s_combine[k];
    const int lo = offsets[seg], hi = offsets[seg + 1];
    const int chunks = (int)(((long long)hi - lo + kTileRows - 1) / kTileRows);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      T acc = T(0);
      for (int k0 = 0; k0 < chunks; k0 += kBatch) {  // chunk k's row: 2 tiles of its start, + 1 for chunk 0
        T x[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const long long p = lo + (long long)(k0 + i) * kTileRows;
          x[i] = k0 + i < chunks ? __ldcg(partial + (2 * (p / kTileRows) + (k0 + i == 0)) * C + c) : T(0);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (k0 + i < chunks) acc += x[i];
        }
      }
      out[(long long)seg * C + c] = acc;
    }
  }
}

// Blocks [0, chunk_blocks): `group` tiles each, the long segments' chunks;
// the rest: the short segments, kThreads / lanes a block.
template <typename T, int U, int UPL>
__global__ void __launch_bounds__(kThreads)
    slot_reduce_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                       const int* __restrict__ offsets, T* __restrict__ out, T* __restrict__ partial,
                       int* __restrict__ arrivals, int E, int n_slots, int C, int lanes, int group,
                       int chunk_blocks) {
  static_assert(kTileRows % kSeqRows == 0 && kTileRows / kSeqRows + 2 <= kPieces && chunk_smem() <= 48 * 1024,
                "the tiles' tables");
  if ((int)blockIdx.x < chunk_blocks) {
    chunk_tiles<T, U>(contrib, perm, offsets, out, partial, arrivals, E, n_slots, C, group, blockIdx.x);
  } else {
    short_segments<T, U, UPL>(contrib, perm, offsets, out, n_slots, C, lanes, chunk_blocks > 0,
                              blockIdx.x - chunk_blocks);
  }
}

// ---- the sub-warp body at the paths' widths (slot_row.cuh) ---------------
constexpr int kRowThreads = 128;
constexpr int kRowsInFlight = 4;

// lo and hi of destination `sub`, loaded by lanes 0 and 1 of its sub-warp.
template <int L>
__device__ __forceinline__ void segment_bounds(const int* __restrict__ offsets, long long sub, int lane,
                                               unsigned mask, int& lo, int& hi) {
  if (L >= 2) {
    const int b = lane < 2 ? offsets[sub + lane] : 0;
    lo = __shfl_sync(mask, b, 0, L);
    hi = __shfl_sync(mask, b, 1, L);
  } else {
    lo = offsets[sub];
    hi = offsets[sub + 1];
  }
}

template <typename T, int C>
__global__ void slot_rows_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                                 const int* __restrict__ offsets, T* __restrict__ out, int n_slots) {
  using S = pyslam::SlotRow<T, C>;
  using Vec = typename S::Vec;
  constexpr int L = S::kLanes;
  const long long sub = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  if (sub >= n_slots) return;  // a whole sub-warp leaves together
  const unsigned mask = pyslam::subwarp_mask<L>();
  int lo, hi;
  segment_bounds<L>(offsets, sub, lane, mask, lo, hi);
  Vec acc[S::kUnitsPerLane];
  pyslam::slot_segment_sum<S, kRowsInFlight>(
      perm, lo, hi, lane, mask,
      [contrib](int p, int u) { return *reinterpret_cast<const Vec*>(contrib + (long long)p * C + u * S::kVec); },
      acc);
#pragma unroll
  for (int u = 0; u < S::kUnitsPerLane; ++u) {
    const int unit = lane + u * L;
    if (unit < S::kUnits) *reinterpret_cast<Vec*>(out + sub * C + unit * S::kVec) = acc[u];
  }
}

template <typename T, int C>
bool launch_rows(const void* contrib, const void* perm, const void* offsets, void* out, int n_slots,
                 cudaStream_t s) {
  constexpr std::uintptr_t a = pyslam::SlotRow<T, C>::kAlign;
  if (reinterpret_cast<std::uintptr_t>(contrib) % a || reinterpret_cast<std::uintptr_t>(out) % a) return false;
  constexpr int L = pyslam::SlotRow<T, C>::kLanes;
  const unsigned blocks = (unsigned)(((long long)n_slots * L + kRowThreads - 1) / kRowThreads);
  slot_rows_kernel<T, C><<<blocks, kRowThreads, 0, s>>>(static_cast<const T*>(contrib),
                                                        static_cast<const int*>(perm),
                                                        static_cast<const int*>(offsets), static_cast<T*>(out),
                                                        n_slots);
  return true;
}

// The templated body at C = 3, 6, 7, 9, 36, 49 on an aligned row; false
// at any other C (the unit kernel's short body takes it).
template <typename T>
bool launch_rows_at(const void* contrib, const void* perm, const void* offsets, void* out, int n_slots, int C,
                    cudaStream_t s) {
  switch (C) {
    case 3: return launch_rows<T, 3>(contrib, perm, offsets, out, n_slots, s);
    case 6: return launch_rows<T, 6>(contrib, perm, offsets, out, n_slots, s);
    case 7: return launch_rows<T, 7>(contrib, perm, offsets, out, n_slots, s);
    case 9: return launch_rows<T, 9>(contrib, perm, offsets, out, n_slots, s);
    case 36: return launch_rows<T, 36>(contrib, perm, offsets, out, n_slots, s);
    case 49: return launch_rows<T, 49>(contrib, perm, offsets, out, n_slots, s);
    default: return false;
  }
}

// ---- a block of 1024 threads a destination --------------------------------
constexpr int kBlockThreads = 1024;

// Any C (wider than the block: kBlockThreads columns at a time, one row in
// flight).  Thread (r, c) adds the rows r, r + Rb, ... of column c (Rb =
// kBlockThreads / C rows in flight), then the Rb partial sums of a column
// are added pairwise in shared memory, the upper half onto the lower.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    slot_block_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                      const int* __restrict__ offsets, T* __restrict__ out, int C) {
  __shared__ T partial[kBlockThreads];
  const long long slot = blockIdx.x;
  const int lo = offsets[slot], hi = offsets[slot + 1];
  const int cols = C < kBlockThreads ? C : kBlockThreads;  // columns side by side
  const int Rb = kBlockThreads / cols;                     // rows in flight
  const int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  int half = 1;  // the power of two at or above Rb, halved
  while (2 * half < Rb) half *= 2;
  for (int c0 = 0; c0 < C; c0 += cols) {
    const bool live = r < Rb && c0 + c < C;
    T acc = T(0);
    if (live) {
#pragma unroll 4
      for (int e = lo + r; e < hi; e += Rb) acc += contrib[(long long)perm[e] * C + c0 + c];
    }
    partial[threadIdx.x] = acc;
    __syncthreads();
    for (int h = Rb > 1 ? half : 0; h >= 1; h /= 2) {
      if (live && r < h && r + h < Rb) partial[threadIdx.x] += partial[threadIdx.x + h * cols];
      __syncthreads();
    }
    if (live && r == 0) out[slot * C + c0 + c] = partial[c];
    __syncthreads();
  }
}

// ---- the unit kernel: tiles and short segments ----------------------------
template <typename T, int U>
void launch_upl(int upl, unsigned grid, int smem, cudaStream_t s, const T* c, const int* p, const int* o, T* y,
                T* part, int* arr, int E, int n_slots, int C, int lanes, int group, int chunk_blocks) {
  if (upl == 1) {
    slot_reduce_kernel<T, U, 1><<<grid, kThreads, smem, s>>>(c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                                                             chunk_blocks);
  } else if (upl == 2) {
    slot_reduce_kernel<T, U, 2><<<grid, kThreads, smem, s>>>(c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                                                             chunk_blocks);
  } else {
    slot_reduce_kernel<T, U, 4><<<grid, kThreads, smem, s>>>(c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                                                             chunk_blocks);
  }
}

// the bodies the caller chooses between (cuda_ops.slot_reduce_body)
constexpr int kBodyTiles = 0;     // the unit kernel with its tile blocks
constexpr int kBodySubwarps = 1;  // a sub-warp a segment: slot_rows_kernel at its widths, else the unit kernel
constexpr int kBodyBlock = 2;     // slot_block_kernel

template <typename T>
int launch(const void* contrib, const void* perm, const void* offsets, void* out, void* partial, void* arrivals,
           int E, int n_slots, int C, int body, int unit, int lanes, int upl, int group, void* stream) {
  if ((long long)n_slots * C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kBodyBlock) {
    slot_block_kernel<T><<<(unsigned)n_slots, kBlockThreads, 0, s>>>(
        static_cast<const T*>(contrib), static_cast<const int*>(perm), static_cast<const int*>(offsets),
        static_cast<T*>(out), C);
    return (int)cudaGetLastError();
  }
  if (body == kBodySubwarps && launch_rows_at<T>(contrib, perm, offsets, out, n_slots, C, s)) {
    return (int)cudaGetLastError();
  }
  // what the wrapper chose, checked: a unit is aligned in every row, the
  // lanes a power of two up to a warp, upl 1, 2 or 4
  const bool ok = (body == kBodyTiles || body == kBodySubwarps) && (unit == 4 || unit == 8 || unit == 16) &&
                  unit >= (int)sizeof(T) && reinterpret_cast<std::uintptr_t>(contrib) % unit == 0 &&
                  reinterpret_cast<std::uintptr_t>(out) % unit == 0 &&
                  reinterpret_cast<std::uintptr_t>(partial) % unit == 0 && C % (unit / (int)sizeof(T)) == 0 &&
                  lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && (upl == 1 || upl == 2 || upl == 4) &&
                  group >= 1 && group <= kMaxGroup && E >= 0;
  if (!ok) return kBadShape;
  const long long n_tiles = body == kBodyTiles ? ((long long)E + kTileRows - 1) / kTileRows : 0;
  const int chunk_blocks = (int)((n_tiles + group - 1) / group);
  const int smem = chunk_blocks ? chunk_smem() : 0;
  const long long grid = chunk_blocks + ((long long)n_slots * lanes + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return kBadShape;
  const T* c = static_cast<const T*>(contrib);
  const int* p = static_cast<const int*>(perm);
  const int* o = static_cast<const int*>(offsets);
  T* y = static_cast<T*>(out);
  T* part = static_cast<T*>(partial);
  int* arr = static_cast<int*>(arrivals);
  if (unit == 16) {
    launch_upl<T, 16>(upl, (unsigned)grid, smem, s, c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                      chunk_blocks);
  } else if (unit == 8) {
    launch_upl<T, 8>(upl, (unsigned)grid, smem, s, c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                     chunk_blocks);
  } else if constexpr (sizeof(T) == 4) {
    launch_upl<T, 4>(upl, (unsigned)grid, smem, s, c, p, o, y, part, arr, E, n_slots, C, lanes, group,
                     chunk_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pyslam_slot_reduce_f32(const void* contrib, const void* perm, const void* offsets, void* out,
                                      void* partial, void* arrivals, int E, int n_slots, int C, int body, int unit,
                                      int lanes, int upl, int group, void* stream) {
  return launch<float>(contrib, perm, offsets, out, partial, arrivals, E, n_slots, C, body, unit, lanes, upl, group,
                       stream);
}

extern "C" int pyslam_slot_reduce_f64(const void* contrib, const void* perm, const void* offsets, void* out,
                                      void* partial, void* arrivals, int E, int n_slots, int C, int body, int unit,
                                      int lanes, int upl, int group, void* stream) {
  return launch<double>(contrib, perm, offsets, out, partial, arrivals, E, n_slots, C, body, unit, lanes, upl,
                        group, stream);
}
