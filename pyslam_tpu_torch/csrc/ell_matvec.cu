// Symmetric-ELL block SpMV for the PCG loop of solve_ell:
//
//   y[r*d + i] = sum_k sum_j He[r, k, i, j] * x[cols[r, k]*d + j]
//
// He (nb, K, d, d) row-major, the store assemble_ell writes (diagonal block
// at slot k = 0, zero blocks in padding slots); cols (nb, K) int32;
// x, y (nb*d,).
//
// Replaces pyslam_tpu/solver/pallas_ops.py::ell_matvec_lane_major (and
// its wrapper ell_matvec_pallas).  The TPU kernel took a pre-gathered,
// transposed, lane-major copy of x and He because Mosaic could not gather;
// here the gather x[cols[r, k]] happens inside the kernel, on the row-major
// store, so neither transpose nor the gathered copy of x exists.
//
// What bounds it on an H100: at sphere2500 (nb = 2500, K = 9, d = 6) one
// call reads He once, 3.24 MB in f32, which fits in the 50 MB L2, and runs
// nb*d = 15,000 threads, less than one wave over 132 SMs.  So it is bound
// by launch and memory latency, not by bandwidth.  The design keeps each
// thread's reads of its He row contiguous (d consecutive values) and the d
// threads of one block row on neighbouring addresses; it makes no attempt
// to hide latency beyond that.  One thread per output scalar, summing k
// then j in order: deterministic, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T, int D>
__global__ void ell_matvec_fixed(const T* __restrict__ He, const int* __restrict__ cols,
                                 const T* __restrict__ x, T* __restrict__ y, int nb, int K) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nb * D) return;
  const long long r = t / D;
  const int i = (int)(t % D);
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const long long c = cols[r * K + k];
    const T* h = He + ((r * K + k) * D + i) * D;
    const T* xc = x + c * D;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += h[j] * xc[j];
  }
  y[t] = acc;
}

template <typename T>
__global__ void ell_matvec_any(const T* __restrict__ He, const int* __restrict__ cols,
                               const T* __restrict__ x, T* __restrict__ y, int nb, int K,
                               int d) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nb * d) return;
  const long long r = t / d;
  const int i = (int)(t % d);
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const long long c = cols[r * K + k];
    const T* h = He + ((r * K + k) * d + i) * d;
    const T* xc = x + c * d;
    for (int j = 0; j < d; ++j) acc += h[j] * xc[j];
  }
  y[t] = acc;
}

template <typename T>
int launch(const void* He, const void* cols, const void* x, void* y, int nb, int K, int d,
           void* stream) {
  const long long n = (long long)nb * d;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* h = static_cast<const T*>(He);
  const int* c = static_cast<const int*>(cols);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (d == 6) {
    ell_matvec_fixed<T, 6><<<blocks, kThreads, 0, s>>>(h, c, xv, yv, nb, K);
  } else {
    ell_matvec_any<T><<<blocks, kThreads, 0, s>>>(h, c, xv, yv, nb, K, d);
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
