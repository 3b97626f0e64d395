// Block-Jacobi preconditioned conjugate gradients on the symmetric-ELL
// Hessian, one launch per linear solve of solve_ell:
//
//   x = 0, r = b, z = Minv r, p = z, rz = r.z
//   while norm(r) > rtol * norm(b) and it < max_iters:
//     Ap = A p                 (A p)[r] = sum_k He[r, k] p[cols[r, k]]
//     alpha = rz / (p.Ap);  x += alpha p;  r -= alpha Ap
//     z = Minv r               (Minv r)[r] = Minv[r] r[r]
//     beta = (r.z) / rz;  p = z + beta p;  rz = r.z;  it += 1
//
// He (nb, K, d, d), cols (nb, K) int32, Minv (nb, d, d), b and x (nb*d,).
// The stop test runs before every iteration; a NaN in r makes it false
// and ends the loop (NaN in, NaN out, no trap).  `iters` receives the
// iteration count and `counter` is increased by it, both on the device.
//
// Replaces pyslam_tpu/solver/pallas_ops.py::ell_matvec_lane_major as it
// runs inside the lax.while_loop of pyslam_tpu/solver/linear.py::_pcg: on
// the TPU the whole loop is one device program, so the counterpart of the
// kernel on this card is the loop, not one product.
//
// What bounds it on an H100.  By bytes, one read of He, cols, Minv and b
// and one write of x: at sphere2500 (nb = 2500, K = 9, d = 6, f32) 3.81 MB,
// 1.14 us at 3.35 TB/s.  By operations, per iteration 2 nb (K + 1) d^2 +
// 12 nb d flop = 1.98 MFLOP, 0.03 us at 67 TFLOP/s, so 3.5 us for the 120
// iterations of a sphere2500 solve: operations are the larger bound.  In
// truth neither: an iteration is two grid-wide barriers and the L2 round
// trips between them, 6.5 us measured on an H100 (700 W) against 0.03.
//
// What the design does about it:
//  * One persistent cooperative launch per solve, one block of 512 threads
//    on each SM at most (registers allow no second one, and a barrier costs
//    more the more blocks take part).  A grid larger than what is
//    co-resident would hang at the first barrier, so the launch checks the
//    occupancy for its shared memory.  Block g owns the block rows
//    [g R, (g + 1) R), R = ceil(nb / SMs).
//  * He, cols and Minv of the owned rows are loaded into shared memory once
//    (16-byte loads where the addresses allow) and stay there for every
//    iteration.  Rows that do not fit (`res_rows` of R do) are read from
//    device memory each iteration by the same code through another pointer.
//  * A block row's product is spread over a sub-warp (ell_row.cuh, shared
//    with ell_matvec.cu).  x, r, z, p and Ap of the owned rows live in
//    shared memory; the preconditioner and the vector updates are local.
//  * Two barriers an iteration, no host.  Every block publishes z and its
//    p to device memory (L2).  The other blocks' p is never waited for:
//    p = z + beta p_prev is recomputed by whoever gathers it, from z and the
//    previous p (two buffers in turn) with the same fused multiply-add as
//    its owner, so the third barrier (after the update of p) is not needed.
//  * The dot products are two-stage and ordered: each block sums its terms
//    (per thread, then a shuffle tree, then the warps in order) into its
//    slot of a device array; after the barrier one warp of every block
//    sums all slots in the same order and hands the sum to its block.  No
//    atomics: every block sees the same bits, takes the same stop decision,
//    and two runs agree bitwise.
//  * Values written by other blocks are read with ld.global.cg (L2), never
//    through the SM's L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ell_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kVectors = 5;  // x, r, z, p, Ap of the owned rows
constexpr int kBroadcast = 2;  // grid-wide sums handed from warp 0 to the block

// Return codes of the entry points besides CUDA's own (positive) errors.
constexpr int kErrNoCooperativeLaunch = -1;
constexpr int kErrVectorsDoNotFit = -2;
constexpr int kErrNotResident = -3;

struct Plan {
  int grid;            // blocks, one per SM at most
  int rows_per_block;  // R
  int res_rows;        // rows per block whose He, cols, Minv stay in shared memory
  int lanes;           // sub-warp width of a row product
  int smem;            // dynamic shared memory, bytes
  int resident_total;  // rows of all blocks that are resident
};

template <typename T>
struct PcgArgs {
  const T* He;
  const int* cols;
  const T* Minv;
  const T* b;
  T* x;
  T* P;         // (2, n): p of the even and of the odd iterations
  T* Z;         // (n,)
  T* part_pap;  // (grid,)
  T* part_rz;   // (grid, 2): r.z and r.r
  int* iters;
  long long* counter;
  int nb, K, d, rows_per_block, res_rows, lanes, max_iters;
  T rtol;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

// p[e] = z[e] + beta * p_prev[e], from the values the owners published.
template <typename T>
struct GatherP {
  const T* Z;
  const T* Pprev;
  T beta;
  __device__ __forceinline__ T operator()(long long e) const {
    return fma_t(beta, __ldcg(Pprev + e), __ldcg(Z + e));
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(pyslam::kFullWarp, v, off);
  return v;
}

// Sums of the `count` per-block partial sums part[i * kN + c], c < kN, by
// warp 0 in a fixed order (the same in every block), handed to the whole
// block through bc[0:kN).  One warp a block reads the slots: all warps of
// all blocks reading the same few L2 lines would queue on one L2 slice.
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) ell_pcg_kernel(const PcgArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];

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
  T* bc = red + 2 * kMaxWarps;
  int* cols_s = reinterpret_cast<int*>(bc + kBroadcast);

  block_copy(he_s, a.He + row0 * kdd, res * kdd);
  block_copy(minv_s, a.Minv + row0 * dd, (long long)res * dd);
  block_copy(cols_s, a.cols + row0 * K, (long long)res * K);
  for (int e = tid; e < n_own; e += blockDim.x) {
    rs[e] = a.b[e0 + e];
    xs[e] = T(0);
    ps[e] = T(0);
    a.P[n + e0 + e] = T(0);  // "p before the first": any finite value, times beta = 0
  }
  __syncthreads();

  // z = Minv r on the owned rows, published to Z; this block's r.z and r.r
  // into its slots of part_rz.  Needs r complete in shared memory.
  auto precondition_and_dots = [&]() {
    T v_rz = T(0), v_rr = T(0);
    for (int e = tid; e < n_own; e += blockDim.x) {
      const int lr = e / d;
      const int i = e - lr * d;
      const T* m = (lr < res ? minv_s + (long long)lr * dd : a.Minv + (row0 + lr) * dd) + i * d;
      const T* rrow = rs + lr * d;
      T z = T(0);
      for (int j = 0; j < d; ++j) z += m[j] * rrow[j];
      zs[e] = z;
      a.Z[e0 + e] = z;
      v_rz += rs[e] * z;
      v_rr += rs[e] * rs[e];
    }
    v_rz = warp_sum(v_rz);
    v_rr = warp_sum(v_rr);
    if ((tid & 31) == 0) {
      red[warp] = v_rz;
      red[kMaxWarps + warp] = v_rr;
    }
    __syncthreads();
    if (tid == 0) {
      T s_rz = T(0), s_rr = T(0);
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w) {
        s_rz += red[w];
        s_rr += red[kMaxWarps + w];
      }
      a.part_rz[2 * blk] = s_rz;
      a.part_rz[2 * blk + 1] = s_rr;
    }
  };

  precondition_and_dots();
  grid.sync();
  T sums[2];
  grid_sums<T, 2>(a.part_rz, G, bc, sums);
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
    T* Pcur = a.P + (it & 1) * n;
    const T* Pprev = a.P + ((it + 1) & 1) * n;

    // p = z + beta p on the owned rows, published for the next iteration
    for (int e = tid; e < n_own; e += blockDim.x) {
      const T pv = fma_t(beta, ps[e], zs[e]);
      ps[e] = pv;
      Pcur[e0 + e] = pv;
    }
    // Ap on the owned rows; p of any row from the published z and p_prev
    const GatherP<T> gather{a.Z, Pprev, beta};
    for (int lr0 = 0; lr0 < rows; lr0 += n_sub) {
      const int lr = lr0 + sub;
      const bool valid = lr < rows;
      const int lrc = valid ? lr : 0;
      const bool in_smem = lrc < res;
      const T* he = in_smem ? he_s + lrc * kdd : a.He + (row0 + lrc) * kdd;
      const int* cl = in_smem ? cols_s + (long long)lrc * K : a.cols + (row0 + lrc) * K;
      pyslam::ell_row_product<T, D>(he, cl, K, d, valid, lane, L, gather, aps + lrc * d);
    }
    __syncthreads();

    T v = T(0);
    for (int e = tid; e < n_own; e += blockDim.x) v += ps[e] * aps[e];
    v = warp_sum(v);
    if ((tid & 31) == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w) s += red[w];
      a.part_pap[blk] = s;
    }
    grid.sync();

    T pap[1];
    grid_sums<T, 1>(a.part_pap, G, bc, pap);
    const T alpha = rz / pap[0];
    for (int e = tid; e < n_own; e += blockDim.x) {
      xs[e] += alpha * ps[e];
      rs[e] -= alpha * aps[e];
    }
    __syncthreads();
    precondition_and_dots();
    grid.sync();

    grid_sums<T, 2>(a.part_rz, G, bc, sums);
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

// The launch geometry for (nb, K, d) on the current device.
template <typename T, int D>
int make_plan(int nb, int K, int d, Plan* plan) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return kErrNoCooperativeLaunch;

  const int R = (nb + sms - 1) / sms;
  const long long fixed =
      ((long long)kVectors * R * d + 2 * kMaxWarps + kBroadcast) * sizeof(T);
  const long long per_row = ((long long)K * d * d + d * d) * sizeof(T) + (long long)K * sizeof(int);
  const long long room = (long long)optin - 16 - fixed;  // 16: the size is rounded up below
  if (room < 0) return kErrVectorsDoNotFit;
  const long long fit = room / per_row;
  plan->rows_per_block = R;
  plan->grid = (nb + R - 1) / R;
  plan->res_rows = fit < R ? (int)fit : R;
  plan->lanes = pyslam::lanes_per_row(kThreads, R, K, d);
  plan->smem = (int)((fixed + plan->res_rows * per_row + 15) / 16 * 16);
  const int last = nb - (plan->grid - 1) * R;  // rows of the last block
  plan->resident_total =
      (plan->grid - 1) * plan->res_rows + (last < plan->res_rows ? last : plan->res_rows);

  // above 48 KB the kernel must be allowed its dynamic shared memory; the
  // occupancy for that size says whether the grid can be co-resident
  err = cudaFuncSetAttribute(ell_pcg_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_pcg_kernel<T, D>, kThreads,
                                                        plan->smem);
  }
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < plan->grid) return kErrNotResident;
  return 0;
}

template <typename T, int D>
int launch_d(const PcgArgs<T>& in, void* stream) {
  Plan plan;
  const int perr = make_plan<T, D>(in.nb, in.K, in.d, &plan);
  if (perr != 0) return perr;
  PcgArgs<T> a = in;
  a.rows_per_block = plan.rows_per_block;
  a.res_rows = plan.res_rows;
  a.lanes = plan.lanes;
  a.part_pap = a.Z + (long long)a.nb * a.d;
  a.part_rz = a.part_pap + plan.grid;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ell_pcg_kernel<T, D>), dim3(plan.grid), dim3(kThreads), params,
      plan.smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// scratch: (3 n + 3 grid) values of T: P (2, n), Z (n,), part_pap, part_rz.
template <typename T>
int launch(const void* He, const void* cols, const void* Minv, const void* b, void* x,
           void* scratch, void* iters, void* counter, int nb, int K, int d, double rtol,
           int max_iters, void* stream) {
  if ((long long)nb * d == 0) {
    return (int)cudaMemsetAsync(iters, 0, sizeof(int), static_cast<cudaStream_t>(stream));
  }
  PcgArgs<T> a{};
  a.He = static_cast<const T*>(He);
  a.cols = static_cast<const int*>(cols);
  a.Minv = static_cast<const T*>(Minv);
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.P = static_cast<T*>(scratch);
  a.Z = a.P + 2LL * nb * d;
  a.iters = static_cast<int*>(iters);
  a.counter = static_cast<long long*>(counter);
  a.nb = nb;
  a.K = K;
  a.d = d;
  a.max_iters = max_iters;
  a.rtol = static_cast<T>(rtol);
  return d == 6 ? launch_d<T, 6>(a, stream) : launch_d<T, 0>(a, stream);
}

template <typename T>
int plan_out(int nb, int K, int d, int* out) {
  Plan plan{};
  if ((long long)nb * d != 0) {
    const int err = d == 6 ? make_plan<T, 6>(nb, K, d, &plan) : make_plan<T, 0>(nb, K, d, &plan);
    if (err != 0) return err;
  }
  out[0] = plan.grid;
  out[1] = plan.rows_per_block;
  out[2] = plan.resident_total;
  out[3] = plan.smem;
  out[4] = plan.lanes;
  return 0;
}

}  // namespace

// out[0:5] = grid, rows per block, resident rows (of nb), dynamic shared
// memory in bytes, lanes per row, for elements of `elem_size` bytes.
extern "C" int pyslam_ell_pcg_plan(int nb, int K, int d, int elem_size, int* out) {
  return elem_size == 8 ? plan_out<double>(nb, K, d, out) : plan_out<float>(nb, K, d, out);
}

extern "C" int pyslam_ell_pcg_f32(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, double rtol, int max_iters,
                                  void* stream) {
  return launch<float>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, rtol, max_iters,
                       stream);
}

extern "C" int pyslam_ell_pcg_f64(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, double rtol, int max_iters,
                                  void* stream) {
  return launch<double>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, rtol, max_iters,
                        stream);
}
