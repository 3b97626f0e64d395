// The rows of the Schur path's linearization of monocular BAL observations
// (schur_large._obs_rows on a reprojection_bal or reprojection_bal9 batch),
// one thread an observation:
//
//   cost (M,)      sum over the two residual elements of rho(r) * weight
//   rows (M, R)    with w = loss.weight(r) * weight and J = [J_cam | J_lm]
//                  (2 x (D + 3), D the camera's dof): J^T w r and the upper
//                  triangle of J^T diag(w) J in cuda_ops.rows_of(D)
//                  order: the camera gradient (D) and upper Hessian
//                  (D (D + 1) / 2), the landmark gradient (3) and upper
//                  Hessian (6), then W = J_cam^T diag(w) J_lm (3 D,
//                  row-major); R = 54 for D = 6, 90 for D = 9
//
// from the cameras, landmarks (L, 3), the observations' camera and landmark
// indices (M,) int64, obs (M, 2), sqrt_info (2, 2) for all or (M, 2, 2),
// weight (M,) and one elementwise loss (loss_eval.cuh).  Two cameras, one
// template each:
//
//   D = 6  se3 poses (C, 4, 4) and reprojection_bal: the intrinsics f, k1,
//          k2 (M,) each observation's, held;
//   D = 9  bal_cam9 cameras (C, 19) = [vec(T) (16), f, k1, k2] and
//          reprojection_bal9: the intrinsics read from the camera table and
//          estimated, their three Jacobian columns after the pose's six.
//
// The projection is graph/factor_defs.py's (Snavely: p = R X + t, pn =
// -p[:2] / p[2], pred = f (1 + k1 |pn|^2 + k2 |pn|^4) pn, r = sqrt_info (pred
// - obs)), its Jacobians lie/se3.py's left perturbation (J_pose = S odot(p),
// J_lm = S R with S = sqrt_info d pred / d p) and, at D = 9, sqrt_info times
// d pred / d [f, k1, k2] = [d pn, f r2 pn, f r2^2 pn].
//
// Replaces no Pallas kernel.  The reference (and the port before this
// kernel) linearizes the observations with the factor kernel's batched
// tensor ops over n_chunks chunks of the observation axis, the chunk
// bounding the memory of the Jacobians: at Venice's 5,001,946 observations
// and 128 chunks that is about 9,300 launches a linearization, issued by
// the host in about 1.3 s while the card waits.  Here the whole
// linearization is one launch, and the Jacobians never leave registers.
//
// What bounds it on an H100: bytes.  At D = 6 an observation reads 40 bytes
// (two int64 indices, obs, f, k1, k2, weight in f32) and writes 216 of rows
// and 4 of cost; the pose and landmark tables are read once: 1.313 GB at
// Venice's size in f32, 0.392 ms at 3.35 TB/s.  At D = 9 it reads 28 (the
// intrinsics come with the camera) and writes 360 of rows and 4 of cost:
// 11.42 GB at BAL Final's 28,987,644 observations, 3.41 ms.  A few hundred
// operations an observation is far under f32's 20 operations a byte.
//
// The design:
//  * One thread an observation, the observations in the plan's camera
//    order, so neighbouring threads read the same camera (L1) and the
//    landmark table stays in L2 (11.9 MB at Venice's size, 53.5 MB at
//    Final's, where it streams).
//  * Each thread forms its R rows in registers and puts them in shared
//    memory; the block then writes its rows, one contiguous run of rows
//    (M, R), as 16-byte stores by neighbouring threads.  A thread's own
//    4 R bytes at a 4 R-byte stride would not coalesce.
//  * Fixed arithmetic and no sums across threads: no atomics, and a repeat
//    gives the same bits.  Every entry is the two residual rows' terms added
//    in one order, J_0a (w_0 J_0b) + J_1a (w_1 J_1b).  Full precision (IEEE
//    division, no fast math): far under the operations a byte, it costs
//    nothing here.  The D = 6 instantiation is the arithmetic of the kernel
//    before the camera became a template, term for term.
//  * Without rows (the cost-only pass of host_lm_loop) the same kernel,
//    templated, forms the residual and cost alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "loss_eval.cuh"

using namespace pyslam;  // the losses of loss_eval.cuh

namespace {

// rows an observation for a camera of kDof dof: D + D (D + 1) / 2 + 3 + 6 + 3 D
// (54 at D = 6, 90 at D = 9)
template <int kDof>
constexpr int kRowsOf = kDof + kDof * (kDof + 1) / 2 + 9 + 3 * kDof;

// values a camera takes in its table: (4, 4) for se3, [vec(T), f, k1, k2] for
// bal_cam9
template <int kDof>
constexpr int kCameraStride = kDof == 6 ? 16 : 19;

// threads a block: their staged rows take 27,648 bytes of shared memory at
// D = 6 and 46,080 at D = 9 (under the 48 KB of a static allocation), in
// either precision
template <typename T>
constexpr int kThreadsOf = 512 / int(sizeof(T));

template <typename T, int kDof, bool kWithRows>
__global__ void __launch_bounds__(kThreadsOf<T>)
    bal_rows_kernel(const T* __restrict__ poses, const T* __restrict__ lms,
                    const long long* __restrict__ cam_idx, const long long* __restrict__ pt_idx,
                    const T* __restrict__ obs, const T* __restrict__ f, const T* __restrict__ k1,
                    const T* __restrict__ k2, const T* __restrict__ sqrt_info, int info_stride,
                    const T* __restrict__ weight, int loss, T c0, T c1, T c2, long long M,
                    T* __restrict__ cost, T* __restrict__ rows) {
  constexpr int kThreads = kThreadsOf<T>;
  constexpr int kRows = kRowsOf<kDof>;
  constexpr int kN = kDof + 3;  // the joint Jacobian's columns: the camera's, then the landmark's
  __shared__ __align__(16) T stage[kWithRows ? kThreads * kRows : 1];
  const long long m0 = (long long)blockIdx.x * kThreads;
  const long long m = m0 + threadIdx.x;
  if (m < M) {
    const T* __restrict__ P = poses + kCameraStride<kDof> * cam_idx[m];
    const T* __restrict__ X = lms + 3 * pt_idx[m];
    T R[9], p[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[3 * i + j] = __ldg(P + 4 * i + j);
    }
    const T X0 = __ldg(X), X1 = __ldg(X + 1), X2 = __ldg(X + 2);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = R[3 * i] * X0 + R[3 * i + 1] * X1 + R[3 * i + 2] * X2 + __ldg(P + 4 * i + 3);
    const T x = p[0], y = p[1], z = p[2];
    const T* __restrict__ S = sqrt_info + (long long)info_stride * m;
    const T S00 = S[0], S01 = S[1], S10 = S[2], S11 = S[3];
    T fm, k1m, k2m;
    if constexpr (kDof == 6) {
      fm = f[m], k1m = k1[m], k2m = k2[m];
    } else {
      fm = __ldg(P + 16), k1m = __ldg(P + 17), k2m = __ldg(P + 18);
    }
    const T wt = weight[m];

    // the projection and the residual
    const T inv_z = T(1) / z;
    const T pn0 = -x * inv_z, pn1 = -y * inv_z;
    const T r2 = pn0 * pn0 + pn1 * pn1;
    const T d = T(1) + r2 * (k1m + k2m * r2);
    const T fd = fm * d;
    const T e0 = fd * pn0 - obs[2 * m], e1 = fd * pn1 - obs[2 * m + 1];
    const T r[2] = {S00 * e0 + S01 * e1, S10 * e0 + S11 * e1};
    T w[2], rho[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      loss_eval(loss, c0, c1, c2, r[i], rho[i], w[i]);
      w[i] *= wt;
    }
    cost[m] = rho[0] * wt + rho[1] * wt;

    if constexpr (kWithRows) {
      // S d pred / d pn (2 x 2): d pred / d pn = f (d I + pn dd^T), dd = 2 (k1 + 2 k2 r2) pn
      const T ddk = T(2) * (k1m + T(2) * k2m * r2);
      const T dd0 = ddk * pn0, dd1 = ddk * pn1;
      const T A00 = fm * (d + pn0 * dd0), A01 = fm * (pn0 * dd1);
      const T A10 = fm * (pn1 * dd0), A11 = fm * (d + pn1 * dd1);
      const T B[2][2] = {{S00 * A00 + S01 * A10, S00 * A01 + S01 * A11},
                         {S10 * A00 + S11 * A10, S10 * A01 + S11 * A11}};
      // J (2 x kN): [Sm | -Sm p^ | (sqrt_info d pred / d [f, k1, k2]) | Sm R],
      // Sm = B d pn / d p (2 x 3)
      const T zz = inv_z * inv_z;
      T J[2][kN];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T s0 = B[i][0] * -inv_z, s1 = B[i][1] * -inv_z;
        const T s2 = B[i][0] * (x * zz) + B[i][1] * (y * zz);
        J[i][0] = s0, J[i][1] = s1, J[i][2] = s2;
        // -p^ = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
        J[i][3] = s1 * -z + s2 * y;
        J[i][4] = s0 * z + s2 * -x;
        J[i][5] = s0 * -y + s1 * x;
#pragma unroll
        for (int j = 0; j < 3; ++j) J[i][kDof + j] = s0 * R[j] + s1 * R[3 + j] + s2 * R[6 + j];
      }
      if constexpr (kDof == 9) {
        // d pred / d [f, k1, k2] = [d pn, f r2 pn, f r2^2 pn], then sqrt_info
        const T coef[3] = {d, fm * r2, fm * r2 * r2};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T q0 = coef[c] * pn0, q1 = coef[c] * pn1;
          J[0][6 + c] = S00 * q0 + S01 * q1;
          J[1][6 + c] = S10 * q0 + S11 * q1;
        }
      }
      const T wr0 = w[0] * r[0], wr1 = w[1] * r[1];
      T* __restrict__ out = stage + threadIdx.x * kRows;
      int o = 0;
      // H_ab = J_0a (w_0 J_0b) + J_1a (w_1 J_1b); g_a = J_0a w_0 r_0 + J_1a w_1 r_1
#pragma unroll
      for (int a = 0; a < kDof; ++a) out[o++] = J[0][a] * wr0 + J[1][a] * wr1;
#pragma unroll
      for (int a = 0; a < kDof; ++a) {
#pragma unroll
        for (int b = a; b < kDof; ++b) out[o++] = J[0][a] * (w[0] * J[0][b]) + J[1][a] * (w[1] * J[1][b]);
      }
#pragma unroll
      for (int a = kDof; a < kN; ++a) out[o++] = J[0][a] * wr0 + J[1][a] * wr1;
#pragma unroll
      for (int a = kDof; a < kN; ++a) {
#pragma unroll
        for (int b = a; b < kN; ++b) out[o++] = J[0][a] * (w[0] * J[0][b]) + J[1][a] * (w[1] * J[1][b]);
      }
#pragma unroll
      for (int a = 0; a < kDof; ++a) {
#pragma unroll
        for (int b = kDof; b < kN; ++b) out[o++] = J[0][a] * (w[0] * J[0][b]) + J[1][a] * (w[1] * J[1][b]);
      }
    }
  }
  if constexpr (kWithRows) {
    // the block's rows are rows[m0 * kRows, (m0 + n) * kRows): 16-byte
    // stores by neighbouring threads, then the odd tail value by value
    __syncthreads();
    constexpr int kVec = 16 / int(sizeof(T));
    const int n = (int)(M - m0 < kThreads ? M - m0 : kThreads);
    const int values = n * kRows;
    const int units = values / kVec;
    T* __restrict__ dst = rows + m0 * kRows;
    for (int u = threadIdx.x; u < units; u += kThreads)
      *reinterpret_cast<int4*>(dst + kVec * u) = *reinterpret_cast<const int4*>(stage + kVec * u);
    for (int v = units * kVec + threadIdx.x; v < values; v += kThreads) dst[v] = stage[v];
  }
}

template <typename T, int kDof>
int launch(const void* poses, const void* lms, const void* cam_idx, const void* pt_idx, const void* obs,
           const void* f, const void* k1, const void* k2, const void* sqrt_info, int info_per_obs,
           const void* weight, int loss, double c0, double c1, double c2, long long M, void* cost, void* rows,
           void* stream) {
  if (M <= 0) return 0;
  constexpr int kThreads = kThreadsOf<T>;
  const dim3 grid((unsigned)((M + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stride = info_per_obs ? 4 : 0;
  if (rows != nullptr) {
    bal_rows_kernel<T, kDof, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(poses), static_cast<const T*>(lms), static_cast<const long long*>(cam_idx),
        static_cast<const long long*>(pt_idx), static_cast<const T*>(obs), static_cast<const T*>(f),
        static_cast<const T*>(k1), static_cast<const T*>(k2), static_cast<const T*>(sqrt_info), stride,
        static_cast<const T*>(weight), loss, static_cast<T>(c0), static_cast<T>(c1), static_cast<T>(c2), M,
        static_cast<T*>(cost), static_cast<T*>(rows));
  } else {
    bal_rows_kernel<T, kDof, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(poses), static_cast<const T*>(lms), static_cast<const long long*>(cam_idx),
        static_cast<const long long*>(pt_idx), static_cast<const T*>(obs), static_cast<const T*>(f),
        static_cast<const T*>(k1), static_cast<const T*>(k2), static_cast<const T*>(sqrt_info), stride,
        static_cast<const T*>(weight), loss, static_cast<T>(c0), static_cast<T>(c1), static_cast<T>(c2), M,
        static_cast<T*>(cost), nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define PYSLAM_BAL_ROWS_ARGS                                                                                  \
  const void *poses, const void *lms, const void *cam_idx, const void *pt_idx, const void *obs, const void *f, \
      const void *k1, const void *k2, const void *sqrt_info, int info_per_obs, const void *weight, int loss,   \
      double c0, double c1, double c2, long long M, void *cost, void *rows, void *stream
#define PYSLAM_BAL_ROWS_PASS \
  poses, lms, cam_idx, pt_idx, obs, f, k1, k2, sqrt_info, info_per_obs, weight, loss, c0, c1, c2, M, cost, rows, stream

// Every pointer is device memory; rows may be null (the cost alone).
// sqrt_info holds one (2, 2) matrix, or one an observation where
// info_per_obs is 1.  loss and c0, c1, c2 are cuda_ops.kernel_loss's.
// rows is aligned to 16 bytes.  pyslam_bal_rows_*: se3 poses (C, 4, 4) and
// f, k1, k2 (M,); pyslam_bal_rows9_*: bal_cam9 cameras (C, 19), and f, k1,
// k2 unread (null).
extern "C" int pyslam_bal_rows_f32(PYSLAM_BAL_ROWS_ARGS) { return launch<float, 6>(PYSLAM_BAL_ROWS_PASS); }

extern "C" int pyslam_bal_rows_f64(PYSLAM_BAL_ROWS_ARGS) { return launch<double, 6>(PYSLAM_BAL_ROWS_PASS); }

extern "C" int pyslam_bal_rows9_f32(PYSLAM_BAL_ROWS_ARGS) { return launch<float, 9>(PYSLAM_BAL_ROWS_PASS); }

extern "C" int pyslam_bal_rows9_f64(PYSLAM_BAL_ROWS_ARGS) { return launch<double, 9>(PYSLAM_BAL_ROWS_PASS); }
