// The whole direct-to-ELL assembly of an SE(3) pose graph (between_se3 and
// prior_se3 factors on one block of poses), bcsr.assemble_ell in two
// launches:
//
//   He (nb, K, 6, 6)  the symmetric-ELL Hessian J^T W J, diagonal block at
//                     slot 0, rows and columns of constant poses zeroed and
//                     their unit diagonal added at slot 0
//   g  (nb * 6,)      -J^T W r, zero at constant poses
//   chi2 ()           sum of loss(r) * weight over all residual elements
//
// from poses (nb, 4, 4), each batch's T_obs (F, 4, 4), sqrt_info (F, 6, 6),
// weight (F,) and loss, const_mask (nb,) and the plan tables that
// bcsr.ell_device_plan builds: idx (Ftot, 2) the two poses of every factor
// (a prior names its pose twice), entries (E,) the packed (factor, role)
// contributions of every ELL slot, sorted by slot in the order of
// bcsr.build_slot_plans, offsets (nb * K + 1,) their segments, cols (nb, K).
//
// Replaces pyslam_tpu/solver/pallas_ops.py::scatter_matmul at the grain of
// its caller, pyslam_tpu/solver/bcsr.py::assemble_ell.  Mosaic has no
// in-kernel gather, so the reference materialises every factor's four
// 6 x 6 contributions and reduces them through a one-hot matmul; the first
// port kept that cut (batched 3 x 3 / 6 x 6 tensor ops for the Lie algebra,
// about 400 launches an assembly, a 2.85 MB contribution array, then
// slot_reduce twice and five masking passes).  On this card the gathers,
// the Lie algebra and the ordered sums fit in two kernels.
//
// What bounds it on an H100: by bytes (poses, measurements, indices and
// tables read once, He and g written once) about 4.8 MB at sphere2500 in
// f32, 1.4 us at 3.35 TB/s; by operations about 22 MFLOP, 0.3 us at
// 67 TFLOP/s.  In truth two launches and the dependent chains inside them
// (idx -> pose -> log -> Jacobians; offsets -> entries -> Jacobians -> He),
// all out of L2.
//
// The design:
//  * Stage 1, one thread a factor: gathers its poses, forms T_est = T2
//    T1^-1, r_local = log(T_est T_obs^-1), the inverse left Jacobian (its
//    3 x 3 blocks Jinv and U = -Jinv Q Jinv; the lower-left block is zero)
//    and the adjoint (R and t^ R), all in registers, then row by row of
//    sqrt_info the residual r = S r_local and the Jacobian rows J2 = S
//    Jinv6 and J1 = -J2 Ad(T_est), the IRLS weight w = loss.weight(r) *
//    weight and w r.  It stores J1, J2, w, w r (84 values a factor; a prior
//    stores its one Jacobian first) and its share of chi2.  The branches of
//    lie/so3.py and lie/se3.py are taken at the same thresholds (Taylor
//    forms below 1e-4, the axis from the symmetric part within 1e-3 of pi).
//    Every thread of a warp reads and writes records of its own, so a
//    memory instruction costs a warp 32 passes of the load-store unit:
//    poses, T_obs and sqrt_info are read 16 bytes at a time and the rows
//    stored in pairs, and a block is one warp, so that 4948 factors spread
//    over every SM instead of 39.
//  * Stage 2, a sub-warp an ELL slot (slot_row.cuh, shared with
//    slot_reduce.cu): walks the slot's (factor, role) entries in plan order,
//    forms each J_a^T diag(w) J_b (or its transpose) from the stored
//    Jacobians, lane i row i of the block (one scalar, w and one Jacobian
//    row read in pairs for each of the six residual rows), sums, applies
//    the masks and the unit diagonal and writes each row of He once.  The
//    lanes of a diagonal slot also sum the gradient rows of its pose.  One
//    more block adds up stage 1's chi2 partials in a fixed order.
//  * Two launches rather than one cooperative launch with a grid barrier: a
//    barrier costs what the second launch costs (one to two microseconds),
//    and two plain launches put no limit on the grid, so the same code runs
//    past the sizes that are co-resident.
//  * No atomics anywhere: two runs give the same bits.  Every element of
//    He, g and chi2 is written, so the outputs need no zeroing.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_row.cuh"

namespace {

constexpr int kMaxBatches = 8;
constexpr int kThreads1 = 32;   // stage 1: one factor a thread, one warp a block
constexpr int kThreads2 = 128;  // stage 2: sub-warps of slots
constexpr int kLin = 84;        // J1 (36), J2 (36), w (6), w r (6)
constexpr int kInFlight = 2;

constexpr int kErrTooManyBatches = -1;
constexpr int kErrScratchTooSmall = -2;

enum Loss { kL2 = 0, kL1 = 1, kCauchy = 2, kHuber = 3, kTukey = 4, kStudentT = 5 };

template <typename T>
struct Batches {
  const T* T_obs[kMaxBatches];
  const T* sqrt_info[kMaxBatches];
  const T* weight[kMaxBatches];
  int first[kMaxBatches + 1];  // global index of each batch's first factor
  int n_slots[kMaxBatches];    // 2: between_se3, 1: prior_se3
  int loss[kMaxBatches];
  // loss constants in T, rounded once on the host side of the launch:
  // Cauchy: k, k^2 / 2.  Huber: k.  Tukey: k, k^2 / 6.  Student-t: nu,
  // scale^2, (nu + 1) / 2.
  T c0[kMaxBatches], c1[kMaxBatches], c2[kMaxBatches];
  int n;
};

// ---- scalar helpers -------------------------------------------------------

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// 16- and 8-byte (f64: 32- and 16-byte) accesses; p is aligned to as much
__device__ __forceinline__ void load4(const float* __restrict__ p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* __restrict__ p, double* o) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}
__device__ __forceinline__ void load2(const float* __restrict__ p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void load2(const double* __restrict__ p, double* o) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void store2(float* __restrict__ p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* __restrict__ p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// clamps that hand a NaN on, as torch.clamp does
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) {
  return x > hi ? hi : x;
}

// ---- 3 x 3 algebra on row-major T[9] --------------------------------------

template <typename T>
__device__ __forceinline__ void wedge(const T* v, T* W) {
  W[0] = T(0);  W[1] = -v[2]; W[2] = v[1];
  W[3] = v[2];  W[4] = T(0);  W[5] = -v[0];
  W[6] = -v[1]; W[7] = v[0];  W[8] = T(0);
}

template <typename T>
__device__ __forceinline__ void mul33(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
    }
  }
}

// C = A B^T
template <typename T>
__device__ __forceinline__ void mul33_bt(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
    }
  }
}

template <typename T>
__device__ __forceinline__ void mulv3(const T* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// out = A^T v
template <typename T>
__device__ __forceinline__ void mulv3_t(const T* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = A[i] * v[0] + A[3 + i] * v[1] + A[6 + i] * v[2];
}

// Rows 0..2 of a (4, 4) transform: R (row-major 3 x 3) and t.
template <typename T>
__device__ __forceinline__ void load_pose(const T* __restrict__ M, T* R, T* t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T row[4];
    load4(M + 4 * i, row);
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = row[j];
    t[i] = row[3];
  }
}

// (Ra, ta) (Rb, tb)^-1 = (Ra Rb^T, ta - Ra Rb^T tb)
template <typename T>
__device__ __forceinline__ void mul_inverse(const T* Ra, const T* ta, const T* Rb, const T* tb,
                                            T* R, T* t) {
  mul33_bt(Ra, Rb, R);
  T u[3], Ru[3];
  mulv3_t(Rb, tb, u);  // Rb^T tb; the inverse's translation is its negative
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = -u[i];
  mulv3(Ra, u, Ru);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = Ru[i] + ta[i];
}

// ---- SO(3) / SE(3): the branches of lie/so3.py and lie/se3.py --------------

// so3.log
template <typename T>
__device__ __forceinline__ void so3_log(const T* R, T* phi) {
  const T trace = R[0] + R[4] + R[8];
  const T cos_theta = at_most(at_least((trace - T(1)) * T(0.5), T(-1)), T(1));
  const T skew[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};  // 2 sin(theta) * axis
  const T sin_theta =
      T(0.5) * sqrt_(at_least(skew[0] * skew[0] + skew[1] * skew[1] + skew[2] * skew[2], T(1e-24)));
  const T theta = atan2_(sin_theta, cos_theta);
  const T theta_sq = theta * theta;
  const bool small = theta < T(1e-4);
  const bool near_pi = theta > T(3.14159265358979323846 - 1e-3);
  if (!near_pi) {
    const T factor =
        small ? T(0.5) + theta_sq / T(12) : theta / (T(2) * (small ? T(1) : sin_theta));
#pragma unroll
    for (int i = 0; i < 3; ++i) phi[i] = factor * skew[i];
    return;
  }
  // axis from the symmetric part: B = (R + R^T) / 2 - cos I = (1 - cos) a a^T
  T B[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[3 * i + j] = T(0.5) * (R[3 * i + j] + R[3 * j + i]) - (i == j ? cos_theta : T(0));
    }
  }
  const T omc = T(1) - cos_theta;
  T axis[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) axis[i] = sqrt_(at_least(B[4 * i] / omc, T(1e-12)));
  // signs from the row of the largest component, the first on ties
  int k = 0;
  if (axis[1] > axis[k]) k = 1;
  if (axis[2] > axis[k]) k = 2;
  T dot = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T row_kj = k == 0 ? B[j] : (k == 1 ? B[3 + j] : B[6 + j]);
    axis[j] = row_kj >= T(0) ? axis[j] : -axis[j];
    dot += axis[j] * skew[j];
  }
  // overall sign from the skew part while it still carries one
  const T sign = dot < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int j = 0; j < 3; ++j) phi[j] = theta * (sign * axis[j]);
}

// so3.inv_left_jacobian: I - W / 2 + cot_term W^2
template <typename T>
__device__ __forceinline__ void so3_inv_left_jacobian(const T* phi, T* J) {
  const T theta_sq = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T theta = sqrt_(at_least(theta_sq, T(1e-24)));
  const bool small = theta_sq < T(1e-8);
  const T half = theta * T(0.5);
  const T inv_t = T(1) / (small ? T(1) : theta);
  const T inv_sin_half = T(1) / (small ? T(1) : sin_(half));
  const T cot_term = small ? T(1.0 / 12.0) + theta_sq / T(720)
                           : inv_t * inv_t - T(0.5) * cos_(half) * inv_sin_half * inv_t;
  T W[9], W2[9];
  wedge(phi, W);
  mul33(W, W, W2);
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = (i % 4 == 0 ? T(1) : T(0)) - T(0.5) * W[i] + cot_term * W2[i];
}

// se3._Q_matrix
template <typename T>
__device__ __forceinline__ void se3_Q(const T* rho, const T* phi, T* Q) {
  T rx[9], px[9];
  wedge(rho, rx);
  wedge(phi, px);
  const T th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T th = sqrt_(at_least(th2, T(1e-24)));
  const bool small = th2 < T(1e-8);
  const T inv_t = T(1) / (small ? T(1) : th);
  const T sth = sin_(th), cth = cos_(th);
  const T inv3 = inv_t * inv_t * inv_t;
  const T sh = sin_(T(0.5) * th);
  const T omc = T(2) * (sh * sh);
  const T m2 = small ? T(1.0 / 6.0) - th2 / T(120) : (th - sth) * inv3;
  const T m3 = small ? T(1.0 / 24.0) - th2 / T(720) : (T(0.5) * th2 - omc) * inv3 * inv_t;
  const T m4 = small ? T(1.0 / 120.0) - th2 / T(2520)
                     : (th - T(1.5) * sth + T(0.5) * th * cth) * inv3 * inv_t * inv_t;
  T pr[9], rp[9], pp[9], prp[9], tmp[9], prpx[9], pprx[9];
  mul33(px, rx, pr);
  mul33(rx, px, rp);
  mul33(px, rp, prp);
  mul33(px, px, pp);
  mul33(pr, px, prpx);
  mul33(pp, rx, pprx);
  // t2 = pr + rp + px rp
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] = T(0.5) * rx[i] + m2 * (pr[i] + rp[i] + prp[i]);
  // t3 = pp rx + rx pp - 3 (pr px)
  mul33(rx, pp, tmp);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] += m3 * (pprx[i] + tmp[i] - T(3) * prpx[i]);
  // t4 = (pr px) px + (pp rx) px
  mul33(prpx, px, tmp);
  mul33(pprx, px, pr);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q[i] += m4 * (tmp[i] + pr[i]);
}

// ---- losses: losses.py, elementwise ---------------------------------------

// rho(e) and the IRLS weight psi(e) / e
template <typename T>
__device__ __forceinline__ void loss_eval(int loss, T c0, T c1, T c2, T e, T& rho, T& w) {
  const T eps = T(1e-12);
  const T abs_e = abs_(e);
  switch (loss) {
    case kL1:
      rho = abs_e;
      w = T(1) / at_least(abs_e, eps);
      break;
    case kCauchy: {  // c0 = k, c1 = k^2 / 2
      const T q = (e / c0) * (e / c0);
      rho = c1 * log1p_(q);
      w = T(1) / (T(1) + q);
      break;
    }
    case kHuber:  // c0 = k
      rho = abs_e <= c0 ? T(0.5) * e * e : c0 * (abs_e - T(0.5) * c0);
      w = at_most(c0 / at_least(abs_e, eps), T(1));
      break;
    case kTukey: {  // c0 = k, c1 = k^2 / 6
      const T q = (e / c0) * (e / c0);
      const T one_minus = T(1) - q;
      const bool inside = abs_e <= c0;
      rho = inside ? c1 * (T(1) - one_minus * one_minus * one_minus) : c1;
      w = inside ? one_minus * one_minus : T(0);
      break;
    }
    case kStudentT:  // c0 = nu, c1 = scale^2, c2 = (nu + 1) / 2
      rho = c2 * log1p_(e * e / (c0 * c1));
      w = (c0 + T(1)) / (c0 + e * e / c1);
      break;
    default:  // kL2
      rho = T(0.5) * (e * e);
      w = T(1);
      break;
  }
}

// ---- stage 1: one factor a thread -----------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads1)
    linearize_kernel(const T* __restrict__ poses, const int* __restrict__ idx, Batches<T> bt,
                     int n_factors, T* __restrict__ lin, T* __restrict__ partials) {
  __shared__ T block_sum[kThreads1];
  const int f = blockIdx.x * kThreads1 + threadIdx.x;
  T chi2 = T(0);
  if (f < n_factors) {
    int b = 0;
    while (b + 1 < bt.n && f >= bt.first[b + 1]) ++b;
    const long long fl = f - bt.first[b];
    const bool between = bt.n_slots[b] == 2;

    // T_err = T_est T_obs^-1, T_est = T2 T1^-1 (a prior: T_est = T)
    T Re[9], te[3];
    {
      T Ra[9], ta[3];
      load_pose(poses + 16LL * idx[2 * f + 1], Ra, ta);
      if (between) {
        T Rb[9], tb[3];
        load_pose(poses + 16LL * idx[2 * f], Rb, tb);
        mul_inverse(Ra, ta, Rb, tb, Re, te);
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) Re[i] = Ra[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) te[i] = ta[i];
      }
    }
    T rl[6];  // r_local = [rho, phi]
    T Jinv[9], U[9];
    {
      T Ro[9], to[3], Rr[9], tr[3];
      load_pose(bt.T_obs[b] + 16 * fl, Ro, to);
      mul_inverse(Re, te, Ro, to, Rr, tr);
      so3_log(Rr, rl + 3);
      so3_inv_left_jacobian(rl + 3, Jinv);
      mulv3(Jinv, tr, rl);
      // upper-right block of the inverse left Jacobian: -Jinv Q Jinv
      T Q[9], JQ[9];
      se3_Q(rl, rl + 3, Q);
      mul33(Jinv, Q, JQ);
      mul33(JQ, Jinv, U);
#pragma unroll
      for (int i = 0; i < 9; ++i) U[i] = -U[i];
    }
    T tR[9];  // t^ R of the adjoint [[R, t^ R], [0, R]] of T_est
    if (between) {
      T tx[9];
      wedge(te, tx);
      mul33(tx, Re, tR);
    }

    T S[36];
#pragma unroll
    for (int i = 0; i < 9; ++i) load4(bt.sqrt_info[b] + 36 * fl + 4 * i, S + 4 * i);
    const T fw = bt.weight[b][fl];
    const int loss = bt.loss[b];
    const T c0 = bt.c0[b], c1 = bt.c1[b], c2 = bt.c2[b];
    T* __restrict__ out = lin + (long long)f * kLin;
    T* __restrict__ J2 = out + (between ? 36 : 0);
    T w[6], wr[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const T* s = S + 6 * m;
      T r = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) r += s[j] * rl[j];
      // row m of J2 = S [[Jinv, U], [0, Jinv]]
      T a[3], c[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a[j] = s[0] * Jinv[j] + s[1] * Jinv[3 + j] + s[2] * Jinv[6 + j];
        c[j] = s[0] * U[j] + s[1] * U[3 + j] + s[2] * U[6 + j] + s[3] * Jinv[j] +
               s[4] * Jinv[3 + j] + s[5] * Jinv[6 + j];
      }
      store2(J2 + 6 * m, a[0], a[1]);
      store2(J2 + 6 * m + 2, a[2], c[0]);
      store2(J2 + 6 * m + 4, c[1], c[2]);
      if (between) {  // row m of J1 = -J2 [[R, t^ R], [0, R]]
        T p[3], q[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          p[j] = -(a[0] * Re[j] + a[1] * Re[3 + j] + a[2] * Re[6 + j]);
          q[j] = -(a[0] * tR[j] + a[1] * tR[3 + j] + a[2] * tR[6 + j] + c[0] * Re[j] +
                   c[1] * Re[3 + j] + c[2] * Re[6 + j]);
        }
        store2(out + 6 * m, p[0], p[1]);
        store2(out + 6 * m + 2, p[2], q[0]);
        store2(out + 6 * m + 4, q[1], q[2]);
      }
      T rho;
      loss_eval(loss, c0, c1, c2, r, rho, w[m]);
      w[m] *= fw;
      wr[m] = w[m] * r;
      chi2 += rho * fw;
    }
#pragma unroll
    for (int m = 0; m < 6; m += 2) {
      store2(out + 72 + m, w[m], w[m + 1]);
      store2(out + 78 + m, wr[m], wr[m + 1]);
    }
  }
  // the block's share of chi2, summed in a fixed tree
  block_sum[threadIdx.x] = chi2;
  __syncthreads();
#pragma unroll
  for (int off = kThreads1 / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) block_sum[threadIdx.x] += block_sum[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = block_sum[0];
}

// ---- stage 2: a sub-warp an ELL slot --------------------------------------

// The 6 x 6 block as six units of one row each.
template <typename T>
using BlockRows = pyslam::SlotRow<T, 36, 6>;

// Row i of the 6 x 6 contribution that entry p = factor << 3 | a << 2 |
// b << 1 | transposed names: C = J_a^T diag(w) J_b, or its transpose.
//   C[i][j]   = sum_m J_a[m][i] * (w[m] * J_b[m][j])
//   C^T[i][j] = sum_m J_a[m][j] * (w[m] * J_b[m][i])
// Either way the row needs one scalar of one Jacobian (column i) and the
// whole row m of the other, for each m; the products are formed in the
// same order in both, so that the two halves of He are transposes bit for
// bit.
template <typename T>
struct Contribution {
  const T* __restrict__ lin;
  __device__ __forceinline__ typename BlockRows<T>::Vec operator()(int p, int i) const {
    const T* __restrict__ base = lin + (long long)(p >> 3) * kLin;
    const T* __restrict__ Ja = base + 36 * ((p >> 2) & 1);
    const T* __restrict__ Jb = base + 36 * ((p >> 1) & 1);
    const bool transposed = p & 1;
    const T* __restrict__ column = transposed ? Jb : Ja;
    const T* __restrict__ rows = transposed ? Ja : Jb;
    T w[6];
#pragma unroll
    for (int m = 0; m < 6; m += 2) load2(base + 72 + m, w + m);
    typename BlockRows<T>::Vec out;
#pragma unroll
    for (int j = 0; j < 6; ++j) out.v[j] = T(0);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const T x = column[6 * m + i];
      T y[6];
#pragma unroll
      for (int j = 0; j < 6; j += 2) load2(rows + 6 * m + j, y + j);
#pragma unroll
      for (int j = 0; j < 6; ++j) out.v[j] += transposed ? y[j] * (w[m] * x) : x * (w[m] * y[j]);
    }
    return out;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads2)
    reduce_kernel(const T* __restrict__ lin, const T* __restrict__ partials, int n_partials,
                  const int* __restrict__ entries, const int* __restrict__ offsets,
                  const int* __restrict__ cols, const unsigned char* __restrict__ const_mask,
                  T* __restrict__ He, T* __restrict__ g, T* __restrict__ chi2, int nb, int K) {
  using S = BlockRows<T>;
  using Vec = typename S::Vec;
  constexpr int L = S::kLanes;
  static_assert(S::kUnitsPerLane == 1 && L >= 6, "a lane a row of the block");
  if (blockIdx.x == gridDim.x - 1) {
    // chi2: warp 0 sums the partials, lane l those at l, l + 32, ..., then
    // a shuffle tree
    if (threadIdx.x < 32) {
      T acc = T(0);
      for (int i = threadIdx.x; i < n_partials; i += 32) acc += partials[i];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (threadIdx.x == 0) *chi2 = acc;
    }
    return;
  }
  const long long slot = ((long long)blockIdx.x * kThreads2 + threadIdx.x) / L;
  const int lane = threadIdx.x & (L - 1);
  if (slot >= (long long)nb * K) return;  // a whole sub-warp leaves together
  const unsigned mask = pyslam::subwarp_mask<L>();
  const int b = lane < 2 ? offsets[slot + lane] : 0;
  const int lo = __shfl_sync(mask, b, 0, L);
  const int hi = __shfl_sync(mask, b, 1, L);
  Vec acc[1];
  pyslam::slot_segment_sum<S, kInFlight>(entries, lo, hi, lane, mask, Contribution<T>{lin}, acc);
  const int r = (int)(slot / K);
  const int k = (int)(slot - (long long)r * K);
  // a padding slot's column is the row itself
  const T free_r = const_mask[r] ? T(0) : T(1);
  const T free_c = const_mask[cols[slot]] ? T(0) : T(1);
  if (lane < 6) {
    Vec v;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      v.v[j] = acc[0].v[j] * free_r * free_c;
      if (k == 0 && j == lane) v.v[j] += T(1) - free_r;  // the unit diagonal of a constant pose
    }
    *reinterpret_cast<Vec*>(He + slot * 36 + lane * 6) = v;
  }
  if (k == 0 && lane < 6) {
    // gradient row of pose r: the diagonal slot's entries with a == b, in
    // the same order, are the pose's rows J_a^T (w r)
    T s = T(0);
    for (int e = lo; e < hi; ++e) {
      const int p = entries[e];
      const int a = (p >> 2) & 1;
      if (a != ((p >> 1) & 1)) continue;
      const T* __restrict__ base = lin + (long long)(p >> 3) * kLin;
      const T* __restrict__ Ja = base + 36 * a;
      T t = T(0);
#pragma unroll
      for (int m = 0; m < 6; ++m) t += Ja[6 * m + lane] * base[78 + m];
      s += t;
    }
    g[6LL * r + lane] = -s * free_r;
  }
}

template <typename T>
int launch(const void* poses, const void* const_mask, const void* cols, const void* idx,
           const void* entries, const void* offsets, int n_batches, const void* const* T_obs,
           const void* const* sqrt_info, const void* const* weight, const int* first,
           const int* n_slots, const int* loss, const double* loss_params, void* scratch,
           long long scratch_len, void* He, void* g, void* chi2, int nb, int K, void* stream) {
  if (n_batches > kMaxBatches) return kErrTooManyBatches;
  Batches<T> bt;
  bt.n = n_batches;
  bt.first[0] = 0;
  for (int b = 0; b < n_batches; ++b) {
    bt.T_obs[b] = static_cast<const T*>(T_obs[b]);
    bt.sqrt_info[b] = static_cast<const T*>(sqrt_info[b]);
    bt.weight[b] = static_cast<const T*>(weight[b]);
    bt.first[b] = first[b];
    bt.first[b + 1] = first[b + 1];
    bt.n_slots[b] = n_slots[b];
    bt.loss[b] = loss[b];
    bt.c0[b] = static_cast<T>(loss_params[3 * b]);
    bt.c1[b] = static_cast<T>(loss_params[3 * b + 1]);
    bt.c2[b] = static_cast<T>(loss_params[3 * b + 2]);
  }
  const int n_factors = n_batches > 0 ? first[n_batches] : 0;
  const int blocks1 = (n_factors + kThreads1 - 1) / kThreads1;
  if (scratch_len < (long long)n_factors * kLin + blocks1) return kErrScratchTooSmall;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* lin = static_cast<T*>(scratch);
  T* partials = lin + (long long)n_factors * kLin;
  if (blocks1 > 0) {
    linearize_kernel<T><<<blocks1, kThreads1, 0, s>>>(static_cast<const T*>(poses),
                                                      static_cast<const int*>(idx), bt, n_factors,
                                                      lin, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int L = BlockRows<T>::kLanes;
  // one block more than the slots need: it sums chi2
  const unsigned blocks2 = (unsigned)(((long long)nb * K * L + kThreads2 - 1) / kThreads2) + 1u;
  reduce_kernel<T><<<blocks2, kThreads2, 0, s>>>(
      lin, partials, blocks1, static_cast<const int*>(entries), static_cast<const int*>(offsets),
      static_cast<const int*>(cols), static_cast<const unsigned char*>(const_mask),
      static_cast<T*>(He), static_cast<T*>(g), static_cast<T*>(chi2), nb, K);
  return (int)cudaGetLastError();
}

}  // namespace

#define PYSLAM_ELL_ASSEMBLE_ARGS                                                                  \
  const void *poses, const void *const_mask, const void *cols, const void *idx,                   \
      const void *entries, const void *offsets, int n_batches, const void *const *T_obs,          \
      const void *const *sqrt_info, const void *const *weight, const int *first,                  \
      const int *n_slots, const int *loss, const double *loss_params, void *scratch,              \
      long long scratch_len, void *He, void *g, void *chi2, int nb, int K, void *stream
#define PYSLAM_ELL_ASSEMBLE_PASS                                                                  \
  poses, const_mask, cols, idx, entries, offsets, n_batches, T_obs, sqrt_info, weight, first,     \
      n_slots, loss, loss_params, scratch, scratch_len, He, g, chi2, nb, K, stream

// The pointer tables (T_obs, sqrt_info, weight), first (n_batches + 1),
// n_slots, loss and loss_params (3 a batch) are host arrays, read before the
// launch returns; every other pointer is device memory.  scratch holds
// n_factors * 84 + ceil(n_factors / 32) values of T.  poses, the batches'
// T_obs and sqrt_info and scratch are aligned to 16 bytes.
extern "C" int pyslam_ell_assemble_f32(PYSLAM_ELL_ASSEMBLE_ARGS) {
  return launch<float>(PYSLAM_ELL_ASSEMBLE_PASS);
}

extern "C" int pyslam_ell_assemble_f64(PYSLAM_ELL_ASSEMBLE_ARGS) {
  return launch<double>(PYSLAM_ELL_ASSEMBLE_PASS);
}
