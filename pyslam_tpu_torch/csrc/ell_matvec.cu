// Symmetric-ELL block SpMV, the stand-alone product of solve_ell (dogleg's
// model products; the PCG loop has the same row product inside
// ell_pcg.cu):
//
//   y[r*d + i] = sum_k sum_j He[r, k, i, j] * x[cols[r, k]*d + j]
//
// He (nb, K, d, d) row-major, the store assemble_ell writes (diagonal block
// at slot k = 0, zero blocks in padding slots, whose cols name the row
// itself); cols (nb, K) int32 in [0, n_x); x (n_x*d,), y (nb*d,): n_x is nb
// for a whole matrix, and larger for the rows of one rank of a sharded
// solve against the x of every rank (dist/pose_sharded.py).
//
// Replaces pyslam_tpu/solver/pallas_ops.py::ell_matvec_lane_major (and
// its wrapper ell_matvec_pallas).  The TPU kernel took a pre-gathered,
// transposed, lane-major copy of x and He because Mosaic could not gather;
// here the gather x[cols[r, k]] happens inside the kernel, on the row-major
// store, so neither transpose nor the gathered copy of x exists.
//
// What bounds it on an H100: bytes.  One call reads He, cols and x once and
// writes y: at sphere2500 (nb = 2500, K = 9, d = 6, f32) 3,240,000 +
// 90,000 + 60,000 + 60,000 B = 3.45 MB, 1.03 us at 3.35 TB/s, against
// 1.62 MFLOP (0.02 us at 67 TFLOP/s).  The matrix fits in the 50 MB L2, so
// in a loop it is bound by launch and memory latency.  The design spreads
// each block row over a sub-warp (ell_row.cuh): at sphere2500 32 lanes a
// row, 80,000 threads instead of one per output scalar (15,000, a fraction
// of one wave), each with at most two independent loads of He in flight
// per output, neighbouring lanes on neighbouring addresses.  Sums run in a
// fixed order (per lane over its columns, then a shuffle tree): no atomics,
// the same bits on every run.

#include <cuda_runtime.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 128;
// About the threads one H100 keeps resident (132 SMs x 2,048): the lanes
// per row are chosen so that nb rows use up to that many.
constexpr long long kCardThreads = 1 << 18;

template <typename T>
struct LoadX {
  const T* __restrict__ x;
  __device__ __forceinline__ T operator()(long long e) const { return x[e]; }
};

template <typename T, int D>
__global__ void ell_matvec_kernel(const T* __restrict__ He, const int* __restrict__ cols,
                                  const T* __restrict__ x, T* __restrict__ y, int nb, int K,
                                  int d_rt, int L) {
  const int d = D > 0 ? D : d_rt;
  const long long sub = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  const bool valid = sub < nb;
  const long long r = valid ? sub : 0;
  pyslam::ell_row_product<T, D>(He + r * K * d * d, cols + r * K, K, d, valid, lane, L,
                                LoadX<T>{x}, y + r * d);
}

template <typename T>
int launch(const void* He, const void* cols, const void* x, void* y, int nb, int K, int d,
           void* stream) {
  if ((long long)nb * d == 0) return (int)cudaSuccess;
  const int L = pyslam::lanes_per_row(kCardThreads, nb, K, d);
  const unsigned blocks = (unsigned)(((long long)nb * L + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* h = static_cast<const T*>(He);
  const int* c = static_cast<const int*>(cols);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (d == 6) {
    ell_matvec_kernel<T, 6><<<blocks, kThreads, 0, s>>>(h, c, xv, yv, nb, K, d, L);
  } else {
    ell_matvec_kernel<T, 0><<<blocks, kThreads, 0, s>>>(h, c, xv, yv, nb, K, d, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pyslam_ell_matvec_f32(const void* He, const void* cols, const void* x, void* y,
                                     int nb, int K, int d, void* stream) {
  return launch<float>(He, cols, x, y, nb, K, d, stream);
}

extern "C" int pyslam_ell_matvec_f64(const void* He, const void* cols, const void* x, void* y,
                                     int nb, int K, int d, void* stream) {
  return launch<double>(He, cols, x, y, nb, K, d, stream);
}
