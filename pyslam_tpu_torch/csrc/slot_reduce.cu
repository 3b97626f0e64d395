// Deterministic segmented sum, the scatter of the normal-equation assembly:
//
//   out[s, c] = sum_{e in [offsets[s], offsets[s+1])} contrib[perm[e], c]
//
// contrib (E, C), perm (E,) int32, offsets (n_slots + 1,) int32 ascending,
// out (n_slots, C).  The plan (perm, offsets) is built once on the host by
// a stable sort of every contribution's destination, so the sum runs in the
// same order on every call: no atomics, bit-identical results run to run.
// It carries the dense assembly (bench configs 1, 2, 7: C = 9 / 3 and
// 49 / 7) and the general route of the direct-to-ELL assembly (C = 36 / 6);
// SE(3) pose graphs reduce inside ell_assemble.cu, which shares the row sum
// (slot_row.cuh).
//
// Replaces pyslam_tpu/solver/pallas_ops.py::scatter_matmul, which turned
// the scatter into a one-hot (T, W) matmul per tile of slots because Mosaic
// has neither a vector scatter nor an in-kernel gather.  Here the gather
// contrib[perm[e]] happens inside the kernel.
//
// What bounds it on an H100: bytes, and below them latency.  At sphere2500
// the Hessian call reads contrib (19,792 x 36 x 4 = 2,850,048 B), perm
// (79,168 B) and offsets (90,004 B) and writes out (22,500 x 36 x 4 =
// 3,240,000 B): 6,259,220 B or 1.87 us at 3.35 TB/s, against 712,512
// additions (0.01 us at 67 TFLOP/s); the gradient call moves 347,092 B,
// 0.10 us.  Everything sits in L2, a segment holds one to a handful of
// rows, and a launch costs more than the bound: what is left to shorten is
// the dependent chain offsets -> perm -> contrib -> out of one destination.
//
// What the design does about it (the first version had one thread per
// output scalar: a runtime division by C per thread, offsets and every
// perm entry loaded C times over, 4-byte loads):
//  * a sub-warp per destination (slot_row.cuh): 8 lanes for C = 36 in f32,
//    180,000 threads in one wave instead of 810,000 in three;
//  * C is a template parameter for the widths the paths use (3, 6, 7, 9,
//    36, 49), so that a row is cut into 16-, 8- or 4-byte vector units at
//    compile time (C = 36 in f32: nine float4) and the sums are registers;
//    any other C, or a base address that is not aligned to the unit, takes
//    the generic body (one scalar column a lane);
//  * the bounds and the perm entries of a segment are loaded once by
//    neighbouring lanes and handed round by shuffle;
//  * four rows of a segment are in flight before the first is added.
//
// Few destinations with hundreds of rows each (the Schur path of bundle
// adjustment: 25,769 observations summed into 49 camera blocks) starve that
// design: 49 sub-warps walk 526 dependent steps each on a card of 132 SMs,
// 0.17 us a row.  pyslam_slot_reduce_long_* gives such a sum a block of
// 1024 threads per destination: thread (r, c) adds the rows r, r + R, ...
// of column c (R = 1024 / C rows of a segment in flight at once, their
// columns read side by side), then the R partial sums of a column are
// added pairwise in shared memory.  Which rows meet in which partial sum
// depends on the segment's bounds and on C alone: the same bits run to
// run, though not those of the sub-warp order.  The caller chooses between
// the two from the shape (cuda_ops.slot_reduce), so that one shape always
// takes one kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_row.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kInFlight = 4;
constexpr int kGenericLanes = 8;

// lo and hi of destination `sub`, loaded by lanes 0 and 1 of its sub-warp.
template <int L>
__device__ __forceinline__ void segment_bounds(const int* __restrict__ offsets, long long sub,
                                               int lane, unsigned mask, int& lo, int& hi) {
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
__global__ void slot_reduce_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                                   const int* __restrict__ offsets, T* __restrict__ out,
                                   int n_slots) {
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
  pyslam::slot_segment_sum<S, kInFlight>(
      perm, lo, hi, lane, mask,
      [contrib](int p, int u) {
        return *reinterpret_cast<const Vec*>(contrib + (long long)p * C + u * S::kVec);
      },
      acc);
#pragma unroll
  for (int u = 0; u < S::kUnitsPerLane; ++u) {
    const int unit = lane + u * L;
    if (unit < S::kUnits) *reinterpret_cast<Vec*>(out + sub * C + unit * S::kVec) = acc[u];
  }
}

// Any C: lane l of a sub-warp of 8 sums the columns l, l + 8, ... one
// after the other, walking the segment once for each.
template <typename T>
__global__ void slot_reduce_generic_kernel(const T* __restrict__ contrib,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ offsets, T* __restrict__ out,
                                           int n_slots, int C) {
  constexpr int L = kGenericLanes;
  const long long sub = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  if (sub >= n_slots) return;
  const unsigned mask = pyslam::subwarp_mask<L>();
  int lo, hi;
  segment_bounds<L>(offsets, sub, lane, mask, lo, hi);
  for (int c0 = 0; c0 < C; c0 += L) {
    const int c = c0 + lane;
    T acc = T(0);
    for (int base = lo; base < hi; base += L) {
      const int n = hi - base < L ? hi - base : L;
      const int mine = lane < n ? perm[base + lane] : 0;
      for (int e = 0; e < n; ++e) {
        const int p = __shfl_sync(mask, mine, e, L);
        if (c < C) acc += contrib[(long long)p * C + c];
      }
    }
    if (c < C) out[sub * C + c] = acc;
  }
}

constexpr int kLongThreads = 1024;

// A block per destination; any C (wider than the block: kLongThreads
// columns at a time, one row in flight).
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
    slot_reduce_long_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                            const int* __restrict__ offsets, T* __restrict__ out, int C) {
  __shared__ T partial[kLongThreads];
  const long long slot = blockIdx.x;
  const int lo = offsets[slot], hi = offsets[slot + 1];
  const int cols = C < kLongThreads ? C : kLongThreads;  // columns side by side
  const int R = kLongThreads / cols;                     // rows in flight
  const int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  int half = 1;  // the power of two at or above R, halved
  while (2 * half < R) half *= 2;
  for (int c0 = 0; c0 < C; c0 += cols) {
    const bool live = r < R && c0 + c < C;
    T acc = T(0);
    if (live) {
#pragma unroll 4
      for (int e = lo + r; e < hi; e += R) acc += contrib[(long long)perm[e] * C + c0 + c];
    }
    partial[threadIdx.x] = acc;
    __syncthreads();
    for (int h = R > 1 ? half : 0; h >= 1; h /= 2) {
      if (live && r < h && r + h < R) partial[threadIdx.x] += partial[threadIdx.x + h * cols];
      __syncthreads();
    }
    if (live && r == 0) out[slot * C + c0 + c] = partial[c];
    __syncthreads();
  }
}

template <typename T>
int launch_long(const void* contrib, const void* perm, const void* offsets, void* out, int n_slots,
                int C, void* stream) {
  if ((long long)n_slots * C == 0) return (int)cudaSuccess;
  slot_reduce_long_kernel<T><<<(unsigned)n_slots, kLongThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(contrib), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<T*>(out), C);
  return (int)cudaGetLastError();
}

template <typename T, int C>
bool aligned_for(const void* contrib, const void* out) {
  constexpr std::uintptr_t a = pyslam::SlotRow<T, C>::kAlign;
  return reinterpret_cast<std::uintptr_t>(contrib) % a == 0 &&
         reinterpret_cast<std::uintptr_t>(out) % a == 0;
}

template <typename T, int C>
void launch_fixed(const T* contrib, const int* perm, const int* offsets, T* out, int n_slots,
                  cudaStream_t s) {
  constexpr int L = pyslam::SlotRow<T, C>::kLanes;
  const unsigned blocks = (unsigned)(((long long)n_slots * L + kThreads - 1) / kThreads);
  slot_reduce_kernel<T, C><<<blocks, kThreads, 0, s>>>(contrib, perm, offsets, out, n_slots);
}

template <typename T>
int launch(const void* contrib_v, const void* perm_v, const void* offsets_v, void* out_v,
           int n_slots, int C, void* stream) {
  if ((long long)n_slots * C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* contrib = static_cast<const T*>(contrib_v);
  const int* perm = static_cast<const int*>(perm_v);
  const int* offsets = static_cast<const int*>(offsets_v);
  T* out = static_cast<T*>(out_v);
#define PYSLAM_SLOT_CASE(W)                                                \
  case W:                                                                  \
    if (aligned_for<T, W>(contrib_v, out_v)) {                             \
      launch_fixed<T, W>(contrib, perm, offsets, out, n_slots, s);         \
      return (int)cudaGetLastError();                                      \
    }                                                                      \
    break;
  switch (C) {
    PYSLAM_SLOT_CASE(3)
    PYSLAM_SLOT_CASE(6)
    PYSLAM_SLOT_CASE(7)
    PYSLAM_SLOT_CASE(9)
    PYSLAM_SLOT_CASE(36)
    PYSLAM_SLOT_CASE(49)
    default:
      break;
  }
#undef PYSLAM_SLOT_CASE
  const unsigned blocks =
      (unsigned)(((long long)n_slots * kGenericLanes + kThreads - 1) / kThreads);
  slot_reduce_generic_kernel<T><<<blocks, kThreads, 0, s>>>(contrib, perm, offsets, out, n_slots, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pyslam_slot_reduce_f32(const void* contrib, const void* perm, const void* offsets,
                                      void* out, int n_slots, int C, void* stream) {
  return launch<float>(contrib, perm, offsets, out, n_slots, C, stream);
}

extern "C" int pyslam_slot_reduce_f64(const void* contrib, const void* perm, const void* offsets,
                                      void* out, int n_slots, int C, void* stream) {
  return launch<double>(contrib, perm, offsets, out, n_slots, C, stream);
}

extern "C" int pyslam_slot_reduce_long_f32(const void* contrib, const void* perm,
                                           const void* offsets, void* out, int n_slots, int C,
                                           void* stream) {
  return launch_long<float>(contrib, perm, offsets, out, n_slots, C, stream);
}

extern "C" int pyslam_slot_reduce_long_f64(const void* contrib, const void* perm,
                                           const void* offsets, void* out, int n_slots, int C,
                                           void* stream) {
  return launch_long<double>(contrib, perm, offsets, out, n_slots, C, stream);
}
