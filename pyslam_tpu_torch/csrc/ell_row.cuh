// One block row of the symmetric-ELL product, shared by the stand-alone
// SpMV (ell_matvec.cu) and the persistent PCG kernel (ell_pcg.cu):
//
//   y_row[i] = sum_k sum_j he[k, i, j] * gather(cols[k]*d + j)
//
// he points at the row's K x d x d values (row-major, in shared or device
// memory), cols at its K column indices; gather(e) returns element e of
// the vector being multiplied.
//
// A sub-warp of L lanes (L a power of two, 1..32) works on one row.  Lane
// l takes the (k, j) pairs q = l, l + L, ... of the row's K*d columns,
// fetches the vector element once and multiplies it into the d outputs it
// touches (register accumulators, statically indexed: D is the compile-time
// d, or 0 for a run-time d handled in chunks of 8 outputs).  The L partial
// sums of each output are then added by a shuffle tree.  Both orders are
// fixed, so the same inputs give the same bits on every run.
//
// Every lane of the warp must call the function (the shuffles name the
// full warp); a sub-warp without a row passes valid = false and costs no
// memory access.

#pragma once

#include <cuda_runtime.h>

namespace pyslam {

constexpr unsigned kFullWarp = 0xffffffffu;

// The largest power of two <= 32 that is <= max(n, 1).
inline int pow2_floor_32(long long n) {
  int p = 1;
  while (p < 32 && 2LL * p <= n) p *= 2;
  return p;
}

// Lanes per row for `threads` threads that share `rows` rows: as many as
// give every row a sub-warp in one pass, at least 8 so that a row's values
// are read by neighbouring lanes, and no more than its K*d columns can use.
inline int lanes_per_row(long long threads, long long rows, int K, int d) {
  int L = pow2_floor_32(threads / (rows > 0 ? rows : 1));
  if (L < 8) L = 8;
  int cap = 1;
  while (cap < 32 && cap < K * d) cap *= 2;
  return L < cap ? L : cap;
}

template <typename T, int D, typename Gather>
__device__ __forceinline__ void ell_row_product(const T* he, const int* cols, int K, int d_rt,
                                                bool valid, int lane, int L, Gather gather,
                                                T* y_row) {
  constexpr int kChunk = D > 0 ? D : 8;
  const int d = D > 0 ? D : d_rt;
  const int nq = valid ? K * d : 0;
  for (int i0 = 0; i0 < d; i0 += kChunk) {
    T acc[kChunk];
#pragma unroll
    for (int ii = 0; ii < kChunk; ++ii) acc[ii] = T(0);
#pragma unroll 4
    for (int q = lane; q < nq; q += L) {
      const int k = q / d;
      const int j = q - k * d;
      const T xv = gather((long long)cols[k] * d + j);
      const T* h = he + ((long long)k * d + i0) * d + j;
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        if (D > 0 || i0 + ii < d) acc[ii] += h[ii * d] * xv;
      }
    }
#pragma unroll
    for (int ii = 0; ii < kChunk; ++ii) {
      for (int off = L >> 1; off > 0; off >>= 1) {
        acc[ii] += __shfl_down_sync(kFullWarp, acc[ii], off, L);
      }
    }
    if (valid && lane == 0) {
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        if (D > 0 || i0 + ii < d) y_row[i0 + ii] = acc[ii];
      }
    }
  }
}

}  // namespace pyslam
