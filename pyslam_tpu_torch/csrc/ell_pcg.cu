// Block-Jacobi preconditioned conjugate gradients on the symmetric-ELL
// Hessian over a block of m right-hand sides, one launch per block:
//
//   for every column c:  x = 0, r = b_c, z = Minv r, p = z, rz = r.z
//   while some column runs:      (column c runs while norm(r_c) > rtol *
//                                 norm(b_c) and it_c < max_iters)
//     for every running column:
//       Ap = A p                 (A p)[r] = sum_k He[r, k] p[cols[r, k]]
//       alpha = rz / (p.Ap);  x += alpha p;  r -= alpha Ap
//       z = Minv r               (Minv r)[r] = Minv[r] r[r]
//       beta = (r.z) / rz;  p = z + beta p;  rz = r.z;  it_c += 1
//
// He (nb, K, d, d), cols (nb, K) int32, Minv (nb, d, d); b and x (nb*d,)
// for one column, (nb*d, mp) for a block of m columns, mp = m rounded up to
// the columns of 16 bytes (the wrapper pads b with zero columns; column c of
// row e at e * mp + c).  Each column has its own recurrences and its own
// stop test, run before each of its iterations; a column that has stopped
// is frozen (x and its count keep their values), as a vmapped
// lax.while_loop freezes the batch elements whose condition is false.  A
// NaN in r makes the test false and stops the column (NaN in, NaN out, no
// trap).  `iters` receives each column's iteration count and `counter` is
// increased by their sum, both on the device.  With m = 1 this is the
// linear solve of solve_ell.
//
// Replaces pyslam_tpu/solver/pallas_ops.py::ell_matvec_lane_major as it
// runs inside the lax.while_loop of pyslam_tpu/solver/linear.py::_pcg (and,
// for m > 1, inside the vmap of that loop over the columns of a covariance
// query, pyslam_tpu/solver/covariance.py::marginal_covariances): on the TPU
// the whole loop is one device program, so the counterpart of the kernel
// on this card is the loop, not one product.
//
// What bounds it on an H100.  By bytes, one read of He, cols, Minv and b
// and one write of x: at sphere2500 (nb = 2500, K = 9, d = 6, f32, m = 1)
// 3.81 MB, 1.14 us at 3.35 TB/s.  By operations, per iteration and column
// 2 nb (K + 1) d^2 + 12 nb d flop = 1.98 MFLOP, 0.03 us at 67 TFLOP/s, so
// 3.5 us for the 120 iterations of a sphere2500 solve: operations are the
// larger bound.  In truth neither: an iteration is two grid-wide barriers
// and the L2 round trips around them, against 0.03 us of arithmetic (5.1
// us an iteration measured on an H100 at 700 W, about half the gathers and
// products, half the barriers).  A block of columns shares those barriers:
// m columns cost one iteration's barriers, not m.
//
// What the design does about it:
//  * One persistent cooperative launch per block of columns, one block of
//    512 threads on each SM at most (registers allow no second one, and a
//    barrier costs more the more blocks take part).  The grid must be
//    co-resident (a block spins until every other arrives), so the launch
//    checks the occupancy for its shared memory.  Block g owns the block
//    rows [g R, (g + 1) R), R = ceil(nb / SMs), of every column.
//  * He, cols and Minv of the owned rows are loaded into shared memory once
//    and stay there for every iteration and column.  One column: rows that
//    do not fit (`res_rows` of R do) are read from device memory each
//    iteration by the same code through another pointer.  A block of
//    columns needs He resident: the plan gives a launch as many columns as
//    fit beside it (`max_columns`, at most kMaxColumns, a multiple of the
//    columns of 16 bytes); where fewer than two fit, one column a launch.
//  * Barriers that carry their partial sums.  Every block writes its
//    partial dot products into its own slot, tagged with an epoch (the
//    iteration), after a block barrier.  A warp polls the slots until every
//    epoch matches and sums them in a fixed order: lane i takes slots i,
//    i + 32, ..., then a shuffle tree, the order of the grid.sync() design
//    this replaced, so the one-column solve keeps its bits.  A value and its
//    epoch share each 64-bit word (single-copy atomic): a float in one
//    word, a double split into two halves, each under the epoch; a slot
//    counts only when every word has the epoch, and is written and read 16
//    bytes at a time.  Each slot is a 128-byte line of its own (packed
//    slots put the polls of every block on a few L2 lines, in the way of
//    the arrivals).  The barrier is the sum: no counter, no flag, no second
//    read.  A barrier needs fences only to publish other data: one column
//    publishes z and p tagged with their iteration, as the slots carry
//    values, and the gather checks the tags (a block that saw a value not
//    yet written gathers again), so its barriers have none; a block of
//    columns has a release fence at GPU scope before its second barrier's
//    arrival, which makes z and p visible, and an acquire fence after the
//    poll.  Nothing another block wrote is read between the first and the
//    second barrier, so the first never needs one.  Two slot arrays, one
//    for each barrier: a block rewrites a slot only after every block has
//    arrived at the next barrier, so after every read of the old value.
//    The prologue clears the block's slots (scratch comes from a caching
//    allocator and may hold an earlier launch's epochs) before the one
//    grid.sync() it keeps, which also orders the first sums.  A poll that
//    spins for tens of seconds traps: a launch fails, it never hangs.
//  * One column (the linear solve of solve_ell): block-wide loops over the
//    owned elements, reductions through the block's 16 warps, the row
//    product of ell_row.cuh (a sub-warp a row, shared with ell_matvec.cu)
//    gathering p of any row from the tagged z and p_prev in device memory;
//    warp 0 polls the G slots.
//    Templated over d = 6, 9 and 4 (the pose graphs and the chordal
//    rotation stages); any other d takes the generic body.
//  * A block of columns: the owned rows' r, z, p and Ap live in shared
//    memory as (row element, column), x in the output itself.  Z and P are
//    published as (nb*d, mp), so a neighbour's values for every column are
//    one contiguous d x mp panel.  A work item is (owned row, group of
//    columns of 16 bytes) over the groups with a running column: the
//    product walks the row's K slots, He[r, k] broadcast from shared
//    memory, the neighbour's panel a few rows at a time in 16-byte loads:
//    from the block's own shared p where the block owns the neighbour (slot
//    0, the padding slots, mostly the odometry neighbours), else z and
//    p_prev from device memory (L2).  The vector updates, the
//    preconditioner, the rows' shares of the dot products and x += alpha p
//    (x's loads issued first) are items of the same shape.  A column's
//    barrier takes two hops: one warp a running column adds the rows'
//    shares and arrives in the column's slot of its block; block c % G
//    sums column c's G slots into the column's total; every block polls
//    the totals of its running columns, a lane a column.  Every block
//    summing every column would read G^2 m slots at each barrier.  The list
//    of running columns and groups is rebuilt only when one has stopped.
//  * p is never waited for: p = z + beta p_prev is recomputed by whoever
//    gathers it, from z and the previous p (two buffers in turn) with the
//    same fused multiply-add as its owner, so a third barrier (after the
//    update of p) is not needed.
//  * Every sum is in a fixed order, no atomics on values: every block sees
//    the same bits, takes the same stop decisions, and two runs agree.
//    Values written by other blocks are read with ld.global.cg (L2), never
//    through the SM's L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ell_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVectors = 5;      // one-column layout: x, r, z, p, Ap of the owned rows
constexpr int kMaxColumns = 128;
constexpr int kBroadcast = 2;    // one-column layout: grid-wide sums handed from warp 0 to the block
constexpr int kSlotsPerLane = 5; // a polling lane holds slots lane, lane + 32, ...: grids up to 160

// Return codes of the entry points besides CUDA's own (positive) errors.
constexpr int kErrNoCooperativeLaunch = -1;
constexpr int kErrVectorsDoNotFit = -2;
constexpr int kErrNotResident = -3;
constexpr int kErrTooManyColumns = -4;
constexpr int kErrGridTooLarge = -5;

struct Plan {
  int grid;            // blocks, one per SM at most
  int rows_per_block;  // R
  int res_rows;        // rows per block whose He, cols, Minv stay in shared memory
  int lanes;           // one-column layout: sub-warp width of a row product
  int smem;            // dynamic shared memory, bytes
  int resident_total;  // rows of all blocks that are resident
  int max_columns;     // the most columns one launch carries
};

template <typename T>
struct PcgArgs {
  const T* He;
  const int* cols;
  const T* Minv;
  const T* b;   // (n, mp)
  T* x;         // (n, mp)
  T* P;         // (2, n, mp): p of the even and of the odd iterations (one column: tagged words)
  T* Z;         // (n, mp) (one column: tagged words)
  T* part0;     // (grid, mp, 2): the prologue's r.z and r.r
  unsigned long long* slots1;  // (mp, grid) lines of kSlotWords words: p.Ap
  unsigned long long* slots2;  // (mp, grid) lines: r.z, r.r
  unsigned long long* tot1;    // (mp) lines: the block layout's column totals of p.Ap
  unsigned long long* tot2;    // (mp) lines: of r.z, r.r
  int* iters;   // (m,)
  long long* counter;
  int nb, K, d, m, mp, rows_per_block, res_rows, lanes, max_iters;
  T rtol;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(pyslam::kFullWarp, v, off);
  return v;
}

// Sums of the `count` per-block partial sums part[i * kN + c], c < kN, by
// warp 0 in a fixed order (the same in every block), handed to the whole
// block through bc[0:kN).  After a grid.sync().
template <typename T, int kN>
__device__ __forceinline__ void grid_sums(const T* part, int count, T* bc, T (&out)[kN]) {
  if (threadIdx.x < 32) {
    T s[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) s[c] = T(0);
    for (int i = threadIdx.x; i < count; i += 32) {
#pragma unroll
      for (int c = 0; c < kN; ++c) s[c] += __ldcg(part + (long long)i * kN + c);
    }
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      s[c] = warp_sum(s[c]);
      if (threadIdx.x == 0) bc[c] = s[c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kN; ++c) out[c] = bc[c];
}

// s[k] = sum over the G blocks i of part[(i * m + c) * kN + k], by one warp
// in a fixed order (the same in every block); every lane gets the sums.
template <typename T, int kN>
__device__ __forceinline__ void column_grid_sum(const T* part, int G, int m, int c, int lane, T (&s)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = T(0);
  for (int i = lane; i < G; i += 32) {
#pragma unroll
    for (int k = 0; k < kN; ++k) s[k] += __ldcg(part + ((long long)i * m + c) * kN + k);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = warp_sum(s[k]);
}

// --------------------------------------------------------------------------
// The carrying barrier
// --------------------------------------------------------------------------

// 64-bit words of one value: the value's next 32 bits in the low half, the
// epoch in the high half.
template <typename T>
struct Slot {
  static constexpr int kWords = sizeof(T) / 4;
};

// A slot is a 128-byte line of its own: a barrier's slots lie on as many
// lines as blocks, so the polls spread over the L2's slices (on one line
// for every few blocks, the polls queued the arrivals behind them).
constexpr int kSlotWords = 16;

__device__ __forceinline__ void pack(float v, unsigned long long epoch, unsigned long long* w) {
  w[0] = epoch << 32 | __float_as_uint(v);
}
__device__ __forceinline__ void pack(double v, unsigned long long epoch, unsigned long long* w) {
  const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v));
  w[0] = epoch << 32 | (bits & 0xffffffffull);
  w[1] = epoch << 32 | (bits >> 32);
}
__device__ __forceinline__ void unpack(const unsigned long long* w, float& v) {
  v = __uint_as_float(static_cast<unsigned>(w[0]));
}
__device__ __forceinline__ void unpack(const unsigned long long* w, double& v) {
  v = __longlong_as_double(static_cast<long long>(w[1] << 32 | (w[0] & 0xffffffffull)));
}

__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void store_pair(unsigned long long* p, unsigned long long a, unsigned long long b) {
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void load_pair(const unsigned long long* p, unsigned long long& a, unsigned long long& b) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

// One thread's arrival: the kN values into the block's slot, 16 bytes a
// store.  With kRelease a release fence first: the caller orders the
// block's writes before it (a block barrier, or its own writes).
template <typename T, int kN, bool kRelease>
__device__ __forceinline__ void arrive(unsigned long long* slot, const T (&v)[kN], unsigned epoch) {
  constexpr int kW = kN * Slot<T>::kWords;
  unsigned long long w[kW];
#pragma unroll
  for (int k = 0; k < kN; ++k) pack(v[k], epoch, w + k * Slot<T>::kWords);
  if (kRelease) fence_gpu();
#pragma unroll
  for (int q = 0; q + 1 < kW; q += 2) store_pair(slot + q, w[q], w[q + 1]);
  if (kW & 1) store_word(slot + kW - 1, w[kW - 1]);
}

// One warp waits until all G slots (slot i at slots + i kSlotWords) hold
// `epoch`, then sums them in grid_sums' order; every lane gets the sums.
// With kAcquire an acquire fence after the poll: the block may then read
// what the other blocks wrote before their release.
template <typename T, int kN, bool kAcquire>
__device__ __forceinline__ void await_sums(const unsigned long long* slots, int G, unsigned epoch, int lane,
                                           T (&s)[kN]) {
  constexpr int kW = kN * Slot<T>::kWords;
  unsigned long long w[kSlotsPerLane][kW];
  bool ok;
  unsigned rounds = 0;
  do {
    // a grid that is not co-resident, or a fault elsewhere, would spin for
    // ever: after about 2^26 round trips (tens of seconds) trap instead
    if (++rounds > (1u << 26)) __trap();
    ok = true;
#pragma unroll
    for (int t = 0; t < kSlotsPerLane; ++t) {
      if (lane + 32 * t < G) {
        const unsigned long long* p = slots + (long long)(lane + 32 * t) * kSlotWords;
#pragma unroll
        for (int q = 0; q + 1 < kW; q += 2) load_pair(p + q, w[t][q], w[t][q + 1]);
        if (kW & 1) w[t][kW - 1] = load_word(p + kW - 1);
      }
    }
#pragma unroll
    for (int t = 0; t < kSlotsPerLane; ++t) {
      if (lane + 32 * t < G) {
#pragma unroll
        for (int q = 0; q < kW; ++q) ok = ok && static_cast<unsigned>(w[t][q] >> 32) == epoch;
      }
    }
  } while (!__all_sync(pyslam::kFullWarp, ok));
  if (kAcquire) fence_gpu();
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    s[k] = T(0);
#pragma unroll
    for (int t = 0; t < kSlotsPerLane; ++t) {
      if (lane + 32 * t < G) {
        T v;
        unpack(w[t] + k * Slot<T>::kWords, v);
        s[k] += v;
      }
    }
    s[k] = warp_sum(s[k]);
  }
}

// await_sums by warp 0, handed to the whole block through bc[0:kN), as
// grid_sums.
template <typename T, int kN, bool kAcquire>
__device__ __forceinline__ void barrier_sums(const unsigned long long* slots, int G, unsigned epoch, T* bc,
                                             T (&out)[kN]) {
  if (threadIdx.x < 32) {
    T s[kN];
    await_sums<T, kN, kAcquire>(slots, G, epoch, threadIdx.x, s);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kN; ++c) bc[c] = s[c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kN; ++c) out[c] = bc[c];
}

// The one-column layout publishes z and p each value under the iteration
// that wrote it, in 64-bit words as the slots carry values (one a float,
// two a double, 16 bytes a store and a load): a reader checks the tags, so
// publishing needs no fence.
template <typename T>
__device__ __forceinline__ void put_tagged(unsigned long long* p, long long e, T v, unsigned tag) {
  unsigned long long w[Slot<T>::kWords];
  pack(v, tag, w);
  if constexpr (sizeof(T) == 4) {
    p[e] = w[0];
  } else {
    *reinterpret_cast<longlong2*>(p + 2 * e) = make_longlong2((long long)w[0], (long long)w[1]);
  }
}

template <typename T>
__device__ __forceinline__ T get_tagged(const unsigned long long* p, long long e, unsigned want, bool& ok) {
  unsigned long long w[Slot<T>::kWords];
  if constexpr (sizeof(T) == 4) {
    w[0] = __ldcg(p + e);
  } else {
    const longlong2 v = __ldcg(reinterpret_cast<const longlong2*>(p + 2 * e));
    w[0] = (unsigned long long)v.x;
    w[1] = (unsigned long long)v.y;
  }
#pragma unroll
  for (int q = 0; q < Slot<T>::kWords; ++q) ok = ok && static_cast<unsigned>(w[q] >> 32) == want;
  T v;
  unpack(w, v);
  return v;
}

// p[e] = z[e] + beta * p_prev[e], from the values the owners published
// with the tag `want`, the fused multiply-add the owner computed its p
// with; a value under another tag (a write not yet seen) clears *ok.
template <typename T>
struct GatherTagged {
  const unsigned long long* Z;
  const unsigned long long* Pprev;
  T beta;
  unsigned want;
  bool* ok;
  __device__ __forceinline__ T operator()(long long e) const {
    bool good = true;
    const T p = get_tagged<T>(Pprev, e, want, good);
    const T z = get_tagged<T>(Z, e, want, good);
    if (!good) *ok = false;
    return fma_t(beta, p, z);
  }
};

// The first hop of a column barrier, the owner's part: block c % G sums
// column c's G partial slots (one warp a column, in grid_sums' order) into
// the column's total, which every block then polls (await_total).  Two
// hops, whose traffic grows with G m, where every block summing every
// column would read G^2 m slots.  With kFenced an acquire and release
// fence between the poll and the total.
template <typename T, int kN, bool kFenced>
__device__ __forceinline__ void own_totals(const unsigned long long* slots, unsigned long long* tot,
                                           const int* act_s, int m, unsigned epoch, int warp, int lane) {
  const int G = gridDim.x;
  for (int c = blockIdx.x + G * (kWarps - 1 - warp); c < m; c += G * kWarps) {
    if (!act_s[c]) continue;
    T s[kN];
    await_sums<T, kN, false>(slots + (long long)c * G * kSlotWords, G, epoch, lane, s);
    __syncwarp();
    if (lane == 0) {
      if (kFenced) fence_gpu();
      arrive<T, kN, false>(tot + (long long)c * kSlotWords, s, epoch);
    }
  }
}

// The second hop of a column barrier: lane k of warp w polls the total of
// running column clist[w + kWarps k] (one line a column, at tot + c
// kSlotWords) until it holds `epoch`; true, with the total in s, for the
// lanes that have a column.  Every lane of a warp with a column calls it.
template <typename T, int kN>
__device__ __forceinline__ bool await_total(const unsigned long long* tot, const int* clist, int n_run,
                                            unsigned epoch, int warp, int lane, T (&s)[kN]) {
  constexpr int kW = kN * Slot<T>::kWords;
  if (warp >= n_run) return false;
  const int j = warp + kWarps * lane;
  const bool mine = j < n_run;
  const unsigned long long* p = tot + (long long)(mine ? clist[j] : 0) * kSlotWords;
  unsigned long long w[kW];
  bool ok;
  unsigned rounds = 0;
  do {
    if (++rounds > (1u << 26)) __trap();
    ok = true;
    if (mine) {
#pragma unroll
      for (int q = 0; q + 1 < kW; q += 2) load_pair(p + q, w[q], w[q + 1]);
      if (kW & 1) w[kW - 1] = load_word(p + kW - 1);
#pragma unroll
      for (int q = 0; q < kW; ++q) ok = ok && static_cast<unsigned>(w[q] >> 32) == epoch;
    }
  } while (!__all_sync(pyslam::kFullWarp, ok));
  if (mine) {
#pragma unroll
    for (int k = 0; k < kN; ++k) unpack(w + k * Slot<T>::kWords, s[k]);
  }
  return mine;
}

// dst[0:n) = src[0:n) by the whole block, 16 bytes a thread where both
// addresses allow.
template <typename T>
__device__ __forceinline__ void block_copy(T* dst, const T* src, long long n) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const long long nv = n / kPer;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = __ldg(s4 + i);
    done = nv * kPer;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One right-hand side (m = 1): block-wide loops over the owned elements,
// reductions through the block's warps.
template <typename T, int D>
__device__ __forceinline__ void pcg_one_column(const PcgArgs<T>& a, unsigned char* smem_raw) {
  cg::grid_group grid = cg::this_grid();
  constexpr int kW = Slot<T>::kWords;

  const int d = D > 0 ? D : a.d;
  const int K = a.K;
  const int dd = d * d;
  const long long kdd = (long long)K * dd;
  const long long n = (long long)a.nb * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int R = a.rows_per_block;
  const long long row0 = (long long)blk * R;
  const long long left = a.nb - row0;
  const int rows = left < 0 ? 0 : (left < R ? (int)left : R);  // owned block rows
  const int res = rows < a.res_rows ? rows : a.res_rows;       // of them, resident
  const int n_own = rows * d;
  const long long e0 = row0 * d;  // first owned scalar

  // shared memory: He | Minv | x r z p Ap | reduction scratch | sums | cols
  T* he_s = reinterpret_cast<T*>(smem_raw);
  T* minv_s = he_s + (long long)a.res_rows * kdd;
  T* xs = minv_s + (long long)a.res_rows * dd;
  T* rs = xs + R * d;
  T* zs = rs + R * d;
  T* ps = zs + R * d;
  T* aps = ps + R * d;
  T* red = aps + R * d;
  T* bc = red + 2 * kWarps;
  int* cols_s = reinterpret_cast<int*>(bc + kBroadcast);

  // z and p of the two iterations in turn, tagged (put_tagged)
  unsigned long long* Zt = reinterpret_cast<unsigned long long*>(a.Z);
  unsigned long long* Pt = reinterpret_cast<unsigned long long*>(a.P);
  const long long p_words = n * Slot<T>::kWords;  // one iteration's p

  block_copy(he_s, a.He + row0 * kdd, res * kdd);
  block_copy(minv_s, a.Minv + row0 * dd, (long long)res * dd);
  block_copy(cols_s, a.cols + row0 * K, (long long)res * K);
  for (int e = tid; e < n_own; e += blockDim.x) {
    rs[e] = a.b[e0 + e];
    xs[e] = T(0);
    ps[e] = T(0);
    put_tagged(Pt + p_words, e0 + e, T(0), 0);  // "p before the first": any finite value, times beta = 0
  }
  if (tid < kW) a.slots1[(long long)blk * kSlotWords + tid] = 0;
  if (tid < 2 * kW) a.slots2[(long long)blk * kSlotWords + tid] = 0;
  __syncthreads();

  // z = Minv r on the owned rows, published to Z under `epoch`; this
  // block's r.z and r.r into part0 (epoch 0, the prologue) or its slot of
  // the second barrier.  Needs r complete in shared memory.
  auto precondition_and_dots = [&](unsigned epoch) {
    T v_rz = T(0), v_rr = T(0);
    for (int e = tid; e < n_own; e += blockDim.x) {
      const int lr = e / d;
      const int i = e - lr * d;
      const T* m = (lr < res ? minv_s + (long long)lr * dd : a.Minv + (row0 + lr) * dd) + i * d;
      const T* rrow = rs + lr * d;
      T z = T(0);
      for (int j = 0; j < d; ++j) z += m[j] * rrow[j];
      zs[e] = z;
      put_tagged(Zt, e0 + e, z, epoch);
      v_rz += rs[e] * z;
      v_rr += rs[e] * rs[e];
    }
    v_rz = warp_sum(v_rz);
    v_rr = warp_sum(v_rr);
    if ((tid & 31) == 0) {
      red[warp] = v_rz;
      red[kWarps + warp] = v_rr;
    }
    __syncthreads();
    if (tid == 0) {
      T s[2] = {T(0), T(0)};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s[0] += red[w];
        s[1] += red[kWarps + w];
      }
      if (epoch == 0) {
        a.part0[2 * blk] = s[0];
        a.part0[2 * blk + 1] = s[1];
      } else {
        arrive<T, 2, false>(a.slots2 + (long long)blk * kSlotWords, s, epoch);
      }
    }
  };

  precondition_and_dots(0);
  grid.sync();
  T sums[2];
  grid_sums<T, 2>(a.part0, G, bc, sums);
  T rz = sums[0];
  T rr = sums[1];
  const T tol = a.rtol * sqrt_t(rr);  // r0 = b
  T beta = T(0);
  int it = 0;

  const int L = a.lanes;
  const int sub = tid / L;
  const int lane = tid & (L - 1);
  const int n_sub = blockDim.x / L;

  while (sqrt_t(rr) > tol && it < a.max_iters) {
    const unsigned epoch = it + 1;
    unsigned long long* Pcur = Pt + (it & 1) * p_words;
    const unsigned long long* Pprev = Pt + ((it + 1) & 1) * p_words;

    // p = z + beta p on the owned rows, published for the next iteration
    for (int e = tid; e < n_own; e += blockDim.x) {
      const T pv = fma_t(beta, ps[e], zs[e]);
      ps[e] = pv;
      put_tagged(Pcur, e0 + e, pv, epoch);
    }
    // Ap on the owned rows; p of any row from the z and p_prev the previous
    // iteration published (tag it), again where a block saw one not yet
    // written
    bool ok;
    do {
      ok = true;
      const GatherTagged<T> gather{Zt, Pprev, beta, static_cast<unsigned>(it), &ok};
      for (int lr0 = 0; lr0 < rows; lr0 += n_sub) {
        const int lr = lr0 + sub;
        const bool valid = lr < rows;
        const int lrc = valid ? lr : 0;
        const bool in_smem = lrc < res;
        const T* he = in_smem ? he_s + lrc * kdd : a.He + (row0 + lrc) * kdd;
        const int* cl = in_smem ? cols_s + (long long)lrc * K : a.cols + (row0 + lrc) * K;
        pyslam::ell_row_product<T, D>(he, cl, K, d, valid, lane, L, gather, aps + lrc * d);
      }
    } while (__syncthreads_or(!ok));

    T v = T(0);
    for (int e = tid; e < n_own; e += blockDim.x) v += ps[e] * aps[e];
    v = warp_sum(v);
    if ((tid & 31) == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      T s[1] = {T(0)};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s[0] += red[w];
      arrive<T, 1, false>(a.slots1 + (long long)blk * kSlotWords, s, epoch);
    }
    T pap[1];
    barrier_sums<T, 1, false>(a.slots1, G, epoch, bc, pap);
    const T alpha = rz / pap[0];
    for (int e = tid; e < n_own; e += blockDim.x) {
      xs[e] += alpha * ps[e];
      rs[e] -= alpha * aps[e];
    }
    __syncthreads();
    precondition_and_dots(epoch);
    barrier_sums<T, 2, false>(a.slots2, G, epoch, bc, sums);

    rr = sums[1];
    beta = sums[0] / rz;
    rz = sums[0];
    ++it;
  }

  for (int e = tid; e < n_own; e += blockDim.x) a.x[e0 + e] = xs[e];
  if (blk == 0 && tid == 0) {
    *a.iters = it;
    *a.counter += it;
  }
}

// The largest divisor of n that is at most cap.
__host__ __device__ constexpr int divisor_at_most(int n, int cap) {
  int k = cap;
  while (k > 1 && n % k) --k;
  return k;
}

// 16 bytes of T: 4 floats or 2 doubles, the columns of a group.
template <typename T>
union Vec {
  int4 raw;
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Vec<T> ld_vec(const T* p) {
  Vec<T> r;
  r.raw = *reinterpret_cast<const int4*>(p);
  return r;
}
template <typename T>
__device__ __forceinline__ Vec<T> ldcg_vec(const T* p) {
  Vec<T> r;
  r.raw = __ldcg(reinterpret_cast<const int4*>(p));
  return r;
}
template <typename T>
__device__ __forceinline__ void st_vec(T* p, const Vec<T>& v) {
  *reinterpret_cast<int4*>(p) = v.raw;
}

// A block of right-hand sides (m >= 2): work items (owned row, group of V
// columns) over the groups with a running column; each running column's
// sums, arrivals and polls by one warp.
template <typename T, int D>
__device__ __forceinline__ void pcg_columns(const PcgArgs<T>& a, unsigned char* smem_raw) {
  cg::grid_group grid = cg::this_grid();
  constexpr int V = 16 / sizeof(T);       // columns of a group
  constexpr int kChunk = D > 0 ? D : 8;   // outputs of a row a pass
  // neighbour rows loaded together in the product, x's rows at the start
  // of a vector item: as many as the registers allow without spilling
  // (measured on an H100: 3 and 6 in f32, 2 and 3 in f64)
  constexpr int kJ = D > 0 ? divisor_at_most(D, sizeof(T) == 8 ? 2 : 3) : 1;
  constexpr int kX = D > 0 ? divisor_at_most(D, sizeof(T) == 8 ? 3 : D) : 1;
  constexpr int kW = Slot<T>::kWords;

  const int d = D > 0 ? D : a.d;
  const int K = a.K;
  const int m = a.mp;
  const int n_groups = m / V;
  const int dd = d * d;
  const long long kdd = (long long)K * dd;
  const long long n = (long long)a.nb * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int R = a.rows_per_block;
  const long long row0 = (long long)blk * R;
  const long long left = a.nb - row0;
  const int rows = left < 0 ? 0 : (left < R ? (int)left : R);  // owned block rows, all resident
  const int n_own = rows * d;
  const long long e0m = row0 * d * m;  // first owned value of Z, P, b and x
  const long long Rdm = (long long)R * d * m;

  // shared memory: r z p Ap (R d, m) each | the rows' shares of the dot
  // products (R, m, 2) | rz tol beta alpha (m each) | He | Minv | cols |
  // iterations, running flags, running columns (m each) | running groups
  // (m / V) | number of running columns, of running groups | "a column
  // stopped"
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* zs = rs + Rdm;
  T* ps = zs + Rdm;
  T* aps = ps + Rdm;
  T* red = aps + Rdm;
  T* rz_s = red + 2LL * R * m;
  T* tol_s = rz_s + m;
  T* beta_s = tol_s + m;
  T* alpha_s = beta_s + m;
  T* he_s = alpha_s + m;
  T* minv_s = he_s + R * kdd;
  int* cols_s = reinterpret_cast<int*>(minv_s + (long long)R * dd);
  int* it_s = cols_s + (long long)R * K;
  int* run_s = it_s + m;
  int* act_s = run_s + m;  // running in this iteration: run_s as the lists were built
  int* clist = act_s + m;
  int* glist = clist + m;
  int* n_run_s = glist + n_groups;
  int* n_grp_s = n_run_s + 1;
  int* stopped_s = n_grp_s + 1;

  block_copy(he_s, a.He + row0 * kdd, rows * kdd);
  block_copy(minv_s, a.Minv + row0 * dd, (long long)rows * dd);
  block_copy(cols_s, a.cols + row0 * K, (long long)rows * K);
  Vec<T> zero;
  zero.raw = make_int4(0, 0, 0, 0);
  T* P1 = a.P + n * m;  // "p before the first": any finite value, times beta = 0
  for (long long q = tid; q < (long long)n_own * n_groups; q += blockDim.x) {
    const long long e = q / n_groups;
    const long long off = e * m + (q - e * n_groups) * V;
    st_vec(rs + off, ld_vec(a.b + e0m + off));
    st_vec(ps + off, zero);
    st_vec(a.x + e0m + off, zero);
    st_vec(P1 + e0m + off, zero);
  }
  for (int q = tid; q < 3 * kW * m; q += blockDim.x) {
    const int c = q / (3 * kW);
    const int w = q - c * 3 * kW;
    if (w < kW) {
      a.slots1[((long long)c * G + blk) * kSlotWords + w] = 0;
    } else {
      a.slots2[((long long)c * G + blk) * kSlotWords + w - kW] = 0;
    }
  }
  for (int c = tid; c < m; c += blockDim.x) {
    it_s[c] = 0;
    run_s[c] = 0;
    act_s[c] = 0;
    beta_s[c] = T(0);
  }
  for (int c = blk; c < m; c += G) {  // the totals of the columns this block owns
    if (tid < kW) a.tot1[(long long)c * kSlotWords + tid] = 0;
    if (tid < 2 * kW) a.tot2[(long long)c * kSlotWords + tid] = 0;
  }
  if (tid == 0) *stopped_s = 1;  // the lists are built before the first iteration
  __syncthreads();

  // Items (row lr, group g) of the groups in glist, or of every group in
  // the prologue: r -= alpha Ap for the running columns, z = Minv r into zs
  // and Z, the row's shares of r.z and r.r into red, and x += alpha p (x's
  // loads issued first, their round trip under the rest).
  auto vector_items = [&](bool prologue) {
    const int ng = prologue ? n_groups : *n_grp_s;
    for (int q = tid; q < rows * ng; q += blockDim.x) {
      const int lr = q / ng;
      const int c0 = (prologue ? q - lr * ng : glist[q - lr * ng]) * V;
      const long long base = (long long)lr * d * m + c0;  // element i of the row at base + i m
      T al[V];
      bool act[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        act[v] = !prologue && act_s[c0 + v];
        al[v] = act[v] ? alpha_s[c0 + v] : T(0);
      }
      Vec<T> xr[kX];
      if (!prologue) {
#pragma unroll
        for (int t = 0; t < kX; ++t) xr[t] = ld_vec(a.x + e0m + base + (long long)t * m);
        for (int i = 0; i < d; ++i) {
          const long long off = base + (long long)i * m;
          Vec<T> r = ld_vec(rs + off);
          const Vec<T> ap = ld_vec(aps + off);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (act[v]) r.v[v] -= al[v] * ap.v[v];
          }
          st_vec(rs + off, r);
        }
      }
      const T* mn = minv_s + (long long)lr * dd;
      T s_rz[V], s_rr[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s_rz[v] = s_rr[v] = T(0);
      for (int i = 0; i < d; ++i) {
        T z[V];
#pragma unroll
        for (int v = 0; v < V; ++v) z[v] = T(0);
        for (int k = 0; k < d; ++k) {
          const T mv = mn[i * d + k];
          const Vec<T> r = ld_vec(rs + base + (long long)k * m);
#pragma unroll
          for (int v = 0; v < V; ++v) z[v] += mv * r.v[v];
        }
        Vec<T> zv;
#pragma unroll
        for (int v = 0; v < V; ++v) zv.v[v] = z[v];
        st_vec(zs + base + (long long)i * m, zv);
        st_vec(a.Z + e0m + base + (long long)i * m, zv);
        const Vec<T> r = ld_vec(rs + base + (long long)i * m);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s_rz[v] += r.v[v] * z[v];
          s_rr[v] += r.v[v] * r.v[v];
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[((long long)lr * m + c0 + v) * 2] = s_rz[v];
        red[((long long)lr * m + c0 + v) * 2 + 1] = s_rr[v];
      }
      for (int i0 = 0; i0 < d && !prologue; i0 += kX) {
        if (i0 > 0) {
#pragma unroll
          for (int t = 0; t < kX; ++t) xr[t] = ld_vec(a.x + e0m + base + (long long)(i0 + t) * m);
        }
#pragma unroll
        for (int t = 0; t < kX; ++t) {
          const long long off = base + (long long)(i0 + t) * m;
          const Vec<T> p = ld_vec(ps + off);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (act[v]) xr[t].v[v] += al[v] * p.v[v];
          }
          st_vec(a.x + e0m + off, xr[t]);
        }
      }
    }
  };

  // Column c's sum of the rows' shares red[(lr, c, k)], by one warp.
  auto row_sum = [&](int c, int k) {
    T s = T(0);
    for (int lr = lane; lr < rows; lr += 32) s += red[((long long)lr * m + c) * 2 + k];
    return warp_sum(s);
  };

  vector_items(true);
  __syncthreads();
  for (int c = warp; c < m; c += kWarps) {
    const T s0 = row_sum(c, 0);
    const T s1 = row_sum(c, 1);
    if (lane == 0) {
      a.part0[((long long)blk * m + c) * 2] = s0;
      a.part0[((long long)blk * m + c) * 2 + 1] = s1;
    }
  }
  grid.sync();
  for (int c = warp; c < m; c += kWarps) {
    T s[2];
    column_grid_sum<T, 2>(a.part0, G, m, c, lane, s);
    if (lane == 0) {
      rz_s[c] = s[0];
      tol_s[c] = a.rtol * sqrt_t(s[1]);  // r0 = b
      run_s[c] = c < a.m && (sqrt_t(s[1]) > tol_s[c]) && (0 < a.max_iters);
    }
  }

  int it = 0;  // iterations of the launch: the epoch and the parity of the p buffers
  for (;;) {
    // the lists of running columns and groups, rebuilt when one has stopped
    __syncthreads();
    if (*stopped_s) {
      __syncthreads();
      if (tid == 0) {
        int k = 0;
        for (int c = 0; c < m; ++c) {
          act_s[c] = run_s[c];
          if (run_s[c]) clist[k++] = c;
        }
        *n_run_s = k;
        k = 0;
        for (int g = 0; g < n_groups; ++g) {
          bool any = false;
          for (int v = 0; v < V; ++v) any = any || run_s[g * V + v];
          if (any) glist[k++] = g;
        }
        *n_grp_s = k;
        *stopped_s = 0;
      }
      __syncthreads();
    }
    const int n_run = *n_run_s;
    const int n_g = *n_grp_s;
    if (n_run == 0) break;
    const unsigned epoch = it + 1;
    T* Pcur = a.P + (long long)(it & 1) * n * m;
    const T* Pprev = a.P + (long long)((it + 1) & 1) * n * m;

    // p = z + beta p on the owned rows, published for the next iteration
    // (a stopped column of a running group is updated too and never read)
    for (long long q = tid; q < (long long)n_own * n_g; q += blockDim.x) {
      const long long e = q / n_g;
      const int c0 = glist[q - e * n_g] * V;
      const long long off = e * m + c0;
      const Vec<T> z = ld_vec(zs + off);
      Vec<T> p = ld_vec(ps + off);
#pragma unroll
      for (int v = 0; v < V; ++v) p.v[v] = fma_t(beta_s[c0 + v], p.v[v], z.v[v]);
      st_vec(ps + off, p);
      st_vec(Pcur + e0m + off, p);
    }
    __syncthreads();

    // Ap, and the row's share of p.Ap, of item (lr, group): slot by slot, a
    // neighbour's d rows of the group from shared memory where the block
    // owns it, else p = z + beta p_prev from the published values, kJ rows
    // at a time
    for (int q = tid; q < rows * n_g; q += blockDim.x) {
      const int lr = q / n_g;
      const int c0 = glist[q - lr * n_g] * V;
      T be[V];
#pragma unroll
      for (int v = 0; v < V; ++v) be[v] = beta_s[c0 + v];
      const int* cl = cols_s + (long long)lr * K;
      const T* he_row = he_s + (long long)lr * kdd;
      const long long base = (long long)lr * d * m + c0;
      T pap[V];
#pragma unroll
      for (int v = 0; v < V; ++v) pap[v] = T(0);
      for (int i0 = 0; i0 < d; i0 += kChunk) {
        T acc[kChunk][V];
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[ii][v] = T(0);
        }
        for (int k = 0; k < K; ++k) {
          const long long col = cl[k];
          const long long lc = col - row0;
          const bool own = lc >= 0 && lc < rows;
          const T* h = he_row + (long long)k * dd + (long long)i0 * d;
          for (int j0 = 0; j0 < d; j0 += kJ) {
            Vec<T> pv[kJ];
            if (own) {
#pragma unroll
              for (int t = 0; t < kJ; ++t) pv[t] = ld_vec(ps + (lc * d + j0 + t) * m + c0);
            } else {
              Vec<T> zv[kJ], pp[kJ];
#pragma unroll
              for (int t = 0; t < kJ; ++t) {
                const long long g = (col * d + j0 + t) * m + c0;
                zv[t] = ldcg_vec(a.Z + g);
                pp[t] = ldcg_vec(Pprev + g);
              }
#pragma unroll
              for (int t = 0; t < kJ; ++t) {
#pragma unroll
                for (int v = 0; v < V; ++v) pv[t].v[v] = fma_t(be[v], pp[t].v[v], zv[t].v[v]);
              }
            }
#pragma unroll
            for (int t = 0; t < kJ; ++t) {
#pragma unroll
              for (int ii = 0; ii < kChunk; ++ii) {
                if (D > 0 || i0 + ii < d) {
                  const T hv = h[ii * d + j0 + t];
#pragma unroll
                  for (int v = 0; v < V; ++v) acc[ii][v] = fma_t(hv, pv[t].v[v], acc[ii][v]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          if (D > 0 || i0 + ii < d) {
            const long long off = base + (long long)(i0 + ii) * m;
            Vec<T> out;
#pragma unroll
            for (int v = 0; v < V; ++v) out.v[v] = acc[ii][v];
            st_vec(aps + off, out);
            const Vec<T> p = ld_vec(ps + off);
#pragma unroll
            for (int v = 0; v < V; ++v) pap[v] += p.v[v] * acc[ii][v];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) red[((long long)lr * m + c0 + v) * 2] = pap[v];
    }
    __syncthreads();

    // first barrier: p.Ap of every running column, then alpha.  No fence:
    // until the second barrier the block reads nothing the others wrote,
    // and that barrier's release covers this iteration's p.
    for (int j = warp; j < n_run; j += kWarps) {
      const int c = clist[j];
      const T s[1] = {row_sum(c, 0)};
      if (lane == 0) arrive<T, 1, false>(a.slots1 + ((long long)c * G + blk) * kSlotWords, s, epoch);
    }
    own_totals<T, 1, false>(a.slots1, a.tot1, act_s, m, epoch, warp, lane);
    {
      T s[1];
      if (await_total<T, 1>(a.tot1, clist, n_run, epoch, warp, lane, s)) {
        const int c = clist[warp + kWarps * lane];
        alpha_s[c] = rz_s[c] / s[0];
      }
    }
    __syncthreads();
    vector_items(false);
    __syncthreads();

    // second barrier: r.z and r.r of every running column, one release
    // fence a warp before its arrivals (the block barrier above orders z
    // before it)
    if (warp < n_run && lane == 0) fence_gpu();
    for (int j = warp; j < n_run; j += kWarps) {
      const int c = clist[j];
      const T s[2] = {row_sum(c, 0), row_sum(c, 1)};
      if (lane == 0) arrive<T, 2, false>(a.slots2 + ((long long)c * G + blk) * kSlotWords, s, epoch);
    }
    own_totals<T, 2, true>(a.slots2, a.tot2, act_s, m, epoch, warp, lane);
    {
      T s[2];
      if (await_total<T, 2>(a.tot2, clist, n_run, epoch, warp, lane, s)) {
        const int c = clist[warp + kWarps * lane];
        beta_s[c] = s[0] / rz_s[c];
        rz_s[c] = s[0];
        const int done = ++it_s[c];
        run_s[c] = (sqrt_t(s[1]) > tol_s[c]) && (done < a.max_iters);
        if (!run_s[c]) *stopped_s = 1;
      }
    }
    if (warp < n_run) fence_gpu();  // acquire: the next product reads the others' z and p
    ++it;
  }

  if (blk == 0) {
    for (int c = tid; c < a.m; c += blockDim.x) a.iters[c] = it_s[c];
    if (tid == 0) {
      long long total = 0;
      for (int c = 0; c < a.m; ++c) total += it_s[c];
      *a.counter += total;
    }
  }
}

// The kernel, templated over the column count of its layout: the
// one-column solve of solve_ell keeps the block-wide loops (one item a
// column would leave most threads idle there), any other count the block
// layout.
template <typename T, int D, bool kOneColumn>
__global__ void __launch_bounds__(kThreads, 1) ell_pcg_kernel(const PcgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kOneColumn) {
    pcg_one_column<T, D>(a, smem_raw);
  } else {
    pcg_columns<T, D>(a, smem_raw);
  }
}

template <typename T, int D>
void (*kernel_of(int m))(PcgArgs<T>) {
  return m == 1 ? ell_pcg_kernel<T, D, true> : ell_pcg_kernel<T, D, false>;
}

// Columns of the layout for m columns: m rounded up to whole groups.
template <typename T>
int layout_columns(int m) {
  constexpr int V = 16 / sizeof(T);
  return m == 1 ? 1 : (m + V - 1) / V * V;
}

// The launch geometry for (nb, K, d) and m columns on the current device.
// `max_columns` is filled in before any check of m.
template <typename T, int D>
int make_plan(int nb, int K, int d, int m, Plan* plan) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return kErrNoCooperativeLaunch;

  constexpr int V = 16 / sizeof(T);
  const int R = (nb + sms - 1) / sms;
  const long long per_row = ((long long)K * d * d + d * d) * sizeof(T) + (long long)K * sizeof(int);
  // the one-column layout's vectors, reduction scratch and sums (16: the
  // size is rounded up below)
  const long long one = ((long long)kVectors * R * d + 2 * kWarps + kBroadcast) * sizeof(T);
  if ((long long)optin - 16 < one) {
    plan->max_columns = 0;
    return kErrVectorsDoNotFit;
  }
  // the block layout, a column: r z p Ap, the rows' shares of two dot
  // products, four scalars, and five ints (iterations, running flags of
  // the column and of the iteration, list entry, a share of the group
  // list); three ints a block
  const long long per_col = ((long long)4 * R * d + 2LL * R + 4) * sizeof(T) + 5 * (long long)sizeof(int);
  const long long avail = (long long)optin - 16 - 3 * (long long)sizeof(int) - R * per_row;
  long long cap = avail > 0 ? avail / per_col : 0;
  cap = cap < kMaxColumns ? cap : kMaxColumns;
  cap -= cap % V;
  plan->max_columns = cap >= 2 ? (int)cap : 1;
  if (m < 1 || m > plan->max_columns) return kErrTooManyColumns;
  plan->rows_per_block = R;
  plan->grid = (nb + R - 1) / R;
  if (plan->grid > 32 * kSlotsPerLane) return kErrGridTooLarge;
  long long fixed;
  if (m == 1) {
    fixed = one;
    const long long fit = ((long long)optin - 16 - fixed) / per_row;
    plan->res_rows = fit < R ? (int)fit : R;
    plan->lanes = pyslam::lanes_per_row(kThreads, R, K, d);
  } else {
    fixed = 3 * (long long)sizeof(int) + layout_columns<T>(m) * per_col;
    plan->res_rows = R;
    plan->lanes = 1;
  }
  plan->smem = (int)((fixed + plan->res_rows * per_row + 15) / 16 * 16);
  const int last = nb - (plan->grid - 1) * R;  // rows of the last block
  plan->resident_total =
      (plan->grid - 1) * plan->res_rows + (last < plan->res_rows ? last : plan->res_rows);

  // above 48 KB the kernel must be allowed its dynamic shared memory; the
  // occupancy for that size says whether the grid can be co-resident
  err = cudaFuncSetAttribute(kernel_of<T, D>(m), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<T, D>(m), kThreads,
                                                        plan->smem);
  }
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < plan->grid) return kErrNotResident;
  return 0;
}

// scratch, in values of T, for grid G, n = nb d and mp layout columns:
// the slots and totals of the two carrying barriers (2 mp (G + 1) lines of
// 128 bytes), part0 (G, mp, 2), P (2, n, mp) and Z (n, mp); one column's
// P and Z tagged, twice the room.
template <typename T, int D>
int launch_d(const PcgArgs<T>& in, void* scratch, void* stream) {
  Plan plan;
  const int perr = make_plan<T, D>(in.nb, in.K, in.d, in.m, &plan);
  if (perr != 0) return perr;
  PcgArgs<T> a = in;
  const long long n = (long long)a.nb * a.d;
  const long long G = plan.grid;
  a.mp = layout_columns<T>(a.m);
  a.rows_per_block = plan.rows_per_block;
  a.res_rows = plan.res_rows;
  a.lanes = plan.lanes;
  a.slots1 = static_cast<unsigned long long*>(scratch);
  a.slots2 = a.slots1 + a.mp * G * kSlotWords;
  a.tot1 = a.slots2 + a.mp * G * kSlotWords;
  a.tot2 = a.tot1 + a.mp * kSlotWords;
  a.part0 = static_cast<T*>(scratch) + 2 * kSlotWords * 8 / sizeof(T) * (G + 1) * a.mp;
  a.P = a.part0 + 2 * G * a.mp;
  a.Z = a.P + 2 * n * a.mp * (a.m == 1 ? 2 : 1);  // one column: tagged, two values' room a value
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel_of<T, D>(a.m)), dim3(plan.grid), dim3(kThreads), params,
      plan.smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch(const void* He, const void* cols, const void* Minv, const void* b, void* x,
           void* scratch, void* iters, void* counter, int nb, int K, int d, int m, double rtol,
           int max_iters, void* stream) {
  if (m <= 0) return 0;
  if ((long long)nb * d == 0) {
    return (int)cudaMemsetAsync(iters, 0, (size_t)m * sizeof(int),
                                static_cast<cudaStream_t>(stream));
  }
  PcgArgs<T> a{};
  a.He = static_cast<const T*>(He);
  a.cols = static_cast<const int*>(cols);
  a.Minv = static_cast<const T*>(Minv);
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.iters = static_cast<int*>(iters);
  a.counter = static_cast<long long*>(counter);
  a.nb = nb;
  a.K = K;
  a.d = d;
  a.m = m;
  a.max_iters = max_iters;
  a.rtol = static_cast<T>(rtol);
  switch (d) {
    case 6: return launch_d<T, 6>(a, scratch, stream);
    case 9: return launch_d<T, 9>(a, scratch, stream);
    case 4: return launch_d<T, 4>(a, scratch, stream);
    default: return launch_d<T, 0>(a, scratch, stream);
  }
}

template <typename T>
int plan_out(int nb, int K, int d, int m, int* out) {
  Plan plan{};
  plan.max_columns = kMaxColumns;
  if ((long long)nb * d != 0) {
    const int err = d == 6   ? make_plan<T, 6>(nb, K, d, m, &plan)
                    : d == 9 ? make_plan<T, 9>(nb, K, d, m, &plan)
                    : d == 4 ? make_plan<T, 4>(nb, K, d, m, &plan)
                             : make_plan<T, 0>(nb, K, d, m, &plan);
    out[5] = plan.max_columns;
    if (err != 0) return err;
  }
  out[0] = plan.grid;
  out[1] = plan.rows_per_block;
  out[2] = plan.resident_total;
  out[3] = plan.smem;
  out[4] = plan.lanes;
  out[5] = plan.max_columns;
  return 0;
}

// The barriers alone, `rounds` times, at a grid of one block of kThreads
// a SM, each carrying two values a block: kind 0 the grid.sync() design
// (every block writes its partials, grid.sync(), warp 0 of every block
// reads the G partials: grid_sums), kind 1 the carrying barrier with its
// release and acquire fences (the second barrier of an iteration), kind 2
// without them (the first).  Two arrays in turn, as the solve's two
// barriers alternate.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    barrier_probe_kernel(T* part, unsigned long long* slots, int kind, int rounds, T* out) {
  cg::grid_group grid = cg::this_grid();
  constexpr int kW = 2 * Slot<T>::kWords;
  __shared__ T bc[2];
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  if (threadIdx.x < 2 * kW) {
    slots[(long long)(threadIdx.x / kW) * G * kSlotWords + (long long)blk * kSlotWords + threadIdx.x % kW] = 0;
  }
  grid.sync();
  T acc = T(0);
  for (int r = 0; r < rounds; ++r) {
    const T v[2] = {T(blk + r), T(1)};
    T s[2];
    __syncthreads();
    if (kind == 0) {
      T* p = part + (long long)(r & 1) * 2 * G;
      if (threadIdx.x == 0) {
        p[2 * blk] = v[0];
        p[2 * blk + 1] = v[1];
      }
      grid.sync();
      grid_sums<T, 2>(p, G, bc, s);
    } else {
      unsigned long long* sl = slots + (long long)(r & 1) * G * kSlotWords;
      const unsigned epoch = r / 2 + 1;
      if (kind == 1) {
        if (threadIdx.x == 0) arrive<T, 2, true>(sl + (long long)blk * kSlotWords, v, epoch);
        barrier_sums<T, 2, true>(sl, G, epoch, bc, s);
      } else {
        if (threadIdx.x == 0) arrive<T, 2, false>(sl + (long long)blk * kSlotWords, v, epoch);
        barrier_sums<T, 2, false>(sl, G, epoch, bc, s);
      }
    }
    acc += s[0] + s[1];
  }
  if (blk == 0 && threadIdx.x == 0) *out = acc;
}

template <typename T>
int barrier_probe(int kind, int rounds, void* scratch, void* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (sms > 32 * kSlotsPerLane) return kErrGridTooLarge;
  T* part = static_cast<T*>(scratch);
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(part + 4LL * sms);  // 16-byte aligned
  T* res = static_cast<T*>(out);
  void* params[] = {&part, &slots, &kind, &rounds, &res};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_probe_kernel<T>), dim3(sms),
                                    dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// out[0:6] = grid, rows per block, resident rows (of nb), dynamic shared
// memory in bytes, lanes per row, for elements of `elem_size` bytes and m
// columns a launch, and the most columns a launch carries (written also
// when m is refused for being above it, with the error -4).
extern "C" int pyslam_ell_pcg_plan(int nb, int K, int d, int elem_size, int m, int* out) {
  return elem_size == 8 ? plan_out<double>(nb, K, d, m, out) : plan_out<float>(nb, K, d, m, out);
}

extern "C" int pyslam_ell_pcg_f32(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, int m, double rtol,
                                  int max_iters, void* stream) {
  return launch<float>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, m, rtol, max_iters,
                       stream);
}

extern "C" int pyslam_ell_pcg_f64(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, int m, double rtol,
                                  int max_iters, void* stream) {
  return launch<double>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, m, rtol, max_iters,
                        stream);
}

// A measurement, not part of the solve: `rounds` barriers of `kind` (0:
// grid.sync() and a read of the partials; 1: the carrying barrier with its
// fences; 2: without them) at one block a SM.  scratch: 4 SMs values of
// `elem_size` bytes, then 32 SMs 64-bit words; out: one value.
extern "C" int pyslam_ell_pcg_barrier_probe(int elem_size, int kind, int rounds, void* scratch,
                                            void* out, void* stream) {
  return elem_size == 8 ? barrier_probe<double>(kind, rounds, scratch, out, stream)
                        : barrier_probe<float>(kind, rounds, scratch, out, stream);
}
