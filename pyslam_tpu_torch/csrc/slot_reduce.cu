// Deterministic segmented sum for the direct-to-ELL assembly:
//
//   out[s, c] = sum_{e in [offsets[s], offsets[s+1])} contrib[perm[e], c]
//
// contrib (E, C), perm (E,) int32, offsets (n_slots + 1,) int32 ascending,
// out (n_slots, C).  The plan (perm, offsets) is built once on the host by
// a stable sort of every contribution's destination slot, so the sum runs
// in the same order on every call: no atomics, bit-identical results run
// to run.
//
// Replaces pyslam_tpu/solver/pallas_ops.py::scatter_matmul, which turned
// the scatter into a one-hot (T, W) matmul per tile of slots because Mosaic
// has neither a vector scatter nor an in-kernel gather.  Here the gather
// contrib[perm[e]] happens inside the kernel and each output is a plain
// loop over its segment.
//
// What bounds it on an H100: at sphere2500 the Hessian call reduces
// 19,792 contributions of C = 36 values (2.85 MB in f32) into 22,500
// slots with 810,000 threads (3,165 blocks of 256, about three waves at
// 2,048 resident threads per SM); the gradient call reduces 9,896 rows of
// C = 6 into 2,500 rows.  Both read their input once from L2 or
// device memory and are bound by memory latency and launch cost.  The
// design puts neighbouring threads on neighbouring columns c of one
// contribution row, so each segment step reads one contiguous row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void slot_reduce_kernel(const T* __restrict__ contrib, const int* __restrict__ perm,
                                   const int* __restrict__ offsets, T* __restrict__ out,
                                   int n_slots, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_slots * C) return;
  const long long s = t / C;
  const int c = (int)(t % C);
  const int lo = offsets[s];
  const int hi = offsets[s + 1];
  T acc = T(0);
  for (int e = lo; e < hi; ++e) acc += contrib[(long long)perm[e] * C + c];
  out[t] = acc;
}

template <typename T>
int launch(const void* contrib, const void* perm, const void* offsets, void* out, int n_slots,
           int C, void* stream) {
  const long long n = (long long)n_slots * C;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  slot_reduce_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(contrib), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<T*>(out), n_slots, C);
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
