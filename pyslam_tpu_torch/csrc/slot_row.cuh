// One destination row of the ordered segment sum of slot_reduce.cu:
//
//   acc[:] = sum_{e in [lo, hi)} row(plan[e])[:]         (C values a row)
//
// plan is the int32 table sorted by destination (perm, the contribution to
// add) and row(p, u) returns unit u of the row that plan value p names.
//
// A row of C values is cut into units of V values: 16, 8 or sizeof(T)
// bytes, the widest that divides the row, so that a unit is one vector
// load or store.
// A sub-warp of kLanes lanes (a power of two) works on one destination;
// lane l owns the units l, l + kLanes, ... and keeps their sums in
// registers.  The plan values of a segment are loaded once, kLanes at a
// time by neighbouring lanes, and handed round by shuffle; kInFlight rows
// are fetched before the first of them is added, so that their loads
// overlap.  The additions run in the plan's order whatever kInFlight is:
// no atomics, the same bits on every run.
//
// Every lane of a sub-warp must call slot_segment_sum with the same lo and
// hi and with the sub-warp's own shuffle mask (subwarp_mask); sub-warps of
// one warp may differ in their segments.

#pragma once

#include <cuda_runtime.h>

namespace pyslam {

// Lanes per destination for a row of `units` units: the power of two below
// it, or the one above when that would leave lanes with more than a
// quarter of extra work; 32 at most.
constexpr int slot_lanes(int units) {
  int p = 1;
  while (p < 32 && 2 * p <= units) p *= 2;
  if (p < 32 && 4 * units > 5 * p) p *= 2;
  return p;
}

// Bytes of the widest vector (16, 8 or one element) that divides a row.
constexpr int slot_vec_bytes(int row_bytes, int elem_bytes) {
  return row_bytes % 16 == 0 ? 16 : (row_bytes % 8 == 0 ? 8 : elem_bytes);
}

template <typename T, int C>
struct SlotRow {
  static constexpr int V = slot_vec_bytes(C * (int)sizeof(T), (int)sizeof(T)) / (int)sizeof(T);
  static_assert(C % V == 0, "a row is a whole number of units");
  static constexpr int kVec = V;  // values a unit
  static constexpr int kUnits = C / V;
  static constexpr int kLanes = slot_lanes(kUnits);
  static constexpr int kUnitsPerLane = (kUnits + kLanes - 1) / kLanes;
  // what the unit's address is always a multiple of, given an aligned base
  static constexpr int kAlign = slot_vec_bytes(V * (int)sizeof(T), (int)sizeof(T));
  using Scalar = T;
  struct alignas(kAlign) Vec {
    T v[V];
  };
};

// The shuffle mask of the sub-warp of L lanes that holds this thread.
template <int L>
__device__ __forceinline__ unsigned subwarp_mask() {
  if constexpr (L >= 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  }
}

template <typename S, int kInFlight, typename Row>
__device__ __forceinline__ void slot_segment_sum(const int* __restrict__ plan, int lo, int hi,
                                                 int lane, unsigned mask, Row row,
                                                 typename S::Vec (&acc)[S::kUnitsPerLane]) {
  using T = typename S::Scalar;
  using Vec = typename S::Vec;
  constexpr int L = S::kLanes;
  constexpr int U = S::kUnitsPerLane;
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int q = 0; q < S::kVec; ++q) acc[u].v[q] = T(0);
  }
  for (int base = lo; base < hi; base += L) {
    const int n = hi - base < L ? hi - base : L;
    const int mine = lane < n ? plan[base + lane] : 0;
    for (int e0 = 0; e0 < n; e0 += kInFlight) {
      Vec v[kInFlight][U];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int p = __shfl_sync(mask, mine, (e0 + i) & (L - 1), L);
        if (e0 + i < n) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (lane + u * L < S::kUnits) v[i][u] = row(p, lane + u * L);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        if (e0 + i < n) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (lane + u * L < S::kUnits) {
#pragma unroll
              for (int q = 0; q < S::kVec; ++q) acc[u].v[q] += v[i][u].v[q];
            }
          }
        }
      }
    }
  }
}

}  // namespace pyslam
