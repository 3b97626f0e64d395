// The whole direct-to-ELL assembly of an SE(3) pose graph (between_se3 and
// prior_se3 factors on one block of poses), bcsr.assemble_ell in two
// programmatic dependent launches:
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
// (a prior names its pose twice), cols (nb, K), and by pose row r the
// entries rows[r] .. rows[r + 1] (int2): each contribution to r's diagonal
// slot in the order of bcsr.build_slot_plans, packed as factor << 3 | a << 2
// | b << 1 | t (the block J_a^T W J_b of that factor, transposed where t =
// 1), beside the slot k of row r that the same factor's off-diagonal block
// goes to (0 where there is none).  An off-diagonal slot's contributions are
// its row's entries that name it, in the row's order, which is the order
// build_slot_plans gives that slot: every slot is summed as slot_reduce sums
// it.
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
// tables read once, He and g written once) about 4.7 MB at sphere2500 in
// f32, 1.4 us at 3.35 TB/s; by operations about 22 MFLOP, 0.3 us at
// 67 TFLOP/s.  In truth the dependent chains (idx -> pose -> log ->
// Jacobians; rows -> entries -> records -> He), the instructions a row
// issues, and the launches, all out of L2.
//
// The design:
//  * Stage 1 (assemble_linearize), kTeam1 lanes a factor, 32 factors a
//    block: every lane of a team issues the factor's loads first (the
//    measurement, its rows of sqrt_info, the weight, both poses), then forms
//    T_est = T2 T1^-1, r_local = log(T_est T_obs^-1), the inverse left
//    Jacobian (its 3 x 3 blocks Jinv and U = -Jinv Q Jinv; the lower-left
//    block is zero) and the adjoint (R and t^ R) in registers; lane s then
//    takes rows s, s + kTeam1, ... of sqrt_info: the residual r = S r_local,
//    the Jacobian rows J_1 = S Jinv6 and J_0 = -J_1 Ad(T_est), the IRLS
//    weight w = loss.weight(r) * weight and w r.  The branches of lie/so3.py
//    and lie/se3.py are taken at the same thresholds (Taylor forms below
//    1e-4, the axis from the symmetric part within 1e-3 of pi).  The block
//    gathers its factors' records (J_0, J_1, w, w r: 84 values; a prior's
//    one Jacobian first) in shared memory and writes them to the scratch as
//    one contiguous run of 16-byte stores, and its share of chi2: each
//    factor's six terms in row order, then the 32 factors in a fixed tree.
//    Its last instruction lets stage 2 launch.
//  * Stage 2 (assemble_rows), a warp a pose row: before it waits for stage 1
//    (griddepcontrol.wait) it reads its row's bounds, its first entries and
//    the masks; then it copies the records of up to kStaged entries at a
//    time to shared memory, once each, kLoads 16-byte loads a lane in
//    flight (a between factor's record is read by its two rows and no
//    more), and its lanes form every part of those entries at once, a row
//    of six values each: the entry's block in the diagonal slot, its
//    off-diagonal block J_0^T W J_1 (transposed where a = 1) and its
//    gradient row.  Then lane l sums units l and l + 32 of the row in entry
//    order (unit u < 6K row u % 6 of slot u / 6, u = 6K the gradient row),
//    and the masks, the unit diagonal and the stores follow; the row's K
//    blocks are written once, padding included.  A block's terms are
//    rounded products added in m order and a gradient row's fused
//    multiply-adds, so that a block and its transpose are formed from the
//    same products and He's two halves are transposes bit for bit wherever
//    the plan orders a pair's two slots alike.  One more block adds up stage
//    1's chi2 partials in a fixed order.
//  * Two launches, not one: stage 2 needs every record of its row, written
//    by other blocks, and a grid-wide barrier would need the grid resident
//    (nb = 30,000 is not).  Both are programmatic dependent launches: stage
//    1 waits (griddepcontrol.wait) for whatever ran before it on the stream
//    before its first read or write, stage 2's blocks start as stage 1's
//    finish, so each launch hides behind the tail of the grid before it.
//  * No atomics anywhere: two runs give the same bits.  Every element of
//    He, g and chi2 is written, so the outputs need no zeroing, and nothing
//    persists between calls.

#include <cuda_runtime.h>

#include <cstdint>

#include "loss_eval.cuh"

using namespace pyslam;  // the losses and the clamps of loss_eval.cuh

namespace {

constexpr int kMaxBatches = 8;
constexpr int kLin = 84;                        // a factor's record: J_0 (36), J_1 (36), w (6), w r (6)
constexpr int kTeam1 = 3;                       // stage 1: lanes a factor
constexpr int kRows1 = 6 / kTeam1;              // stage 1: rows of sqrt_info a lane
constexpr int kFactors1 = 32;                   // stage 1: factors a block (one chi2 partial)
constexpr int kThreads1 = kTeam1 * kFactors1;
constexpr int kRows2 = 4;                       // stage 2: rows a block, a warp each
constexpr int kThreads2 = 32 * kRows2;
constexpr int kStaged = 8;                      // stage 2: records in shared memory at a time
constexpr int kUnitsPerLane = 2;                // stage 2: units a lane in one pass over the entries
constexpr int kParts = 13;                      // stage 2: rows an entry gives (6 + 6 block rows, 1 gradient)

constexpr int kErrTooManyBatches = -1;
constexpr int kErrScratchTooSmall = -2;

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

// a product and a sum rounded apart, never fused into one multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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

// ---- programmatic dependent launch (sm_90) ---------------------------------

// Lets the grid launched next on the stream with programmatic stream
// serialization start before this one ends.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the grid before this one has ended and its writes are visible.
__device__ __forceinline__ void wait_for_previous_grid() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// ---- stage 1: kTeam1 lanes a factor ---------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads1)
    assemble_linearize(const T* __restrict__ poses, const int2* __restrict__ idx, Batches<T> bt,
                       int n_factors, T* __restrict__ lin, T* __restrict__ partials) {
  __shared__ __align__(16) T rec[kFactors1 * kLin];  // J_0, J_1, w, w r
  __shared__ T rho_s[kFactors1][6];
  __shared__ T chi2_s[kFactors1];
  // launched as a dependent of whatever ran before: nothing is read or
  // written before that grid has ended
  wait_for_previous_grid();
  const int q = threadIdx.x / kTeam1;
  const int sub = threadIdx.x % kTeam1;
  const int f0 = blockIdx.x * kFactors1;
  const int f = f0 + q;
  T fw = T(0);
  if (f < n_factors) {
    int b = 0;
    while (b + 1 < bt.n && f >= bt.first[b + 1]) ++b;
    const long long fl = f - bt.first[b];
    const bool between = bt.n_slots[b] == 2;
    // every load first, so that their round trips overlap: the measurement,
    // this lane's rows of sqrt_info, the weight, then the two poses (a
    // prior names its pose twice)
    T Ro[9], to[3];
    load_pose(bt.T_obs[b] + 16 * fl, Ro, to);
    T s[kRows1][6];
#pragma unroll
    for (int n = 0; n < kRows1; ++n) {
#pragma unroll
      for (int j = 0; j < 6; j += 2) load2(bt.sqrt_info[b] + 36 * fl + 6 * (sub + kTeam1 * n) + j, s[n] + j);
    }
    fw = bt.weight[b][fl];
    const int2 ab = idx[f];
    T Ra[9], ta[3], Rb[9], tb[3];
    load_pose(poses + 16LL * ab.y, Ra, ta);
    load_pose(poses + 16LL * ab.x, Rb, tb);

    // T_err = T_est T_obs^-1, T_est = T2 T1^-1 (a prior: T_est = T)
    T Re[9], te[3];
    if (between) {
      mul_inverse(Ra, ta, Rb, tb, Re, te);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) Re[i] = Ra[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) te[i] = ta[i];
    }
    T rl[6];  // r_local = [rho, phi]
    T Jinv[9], U[9];
    {
      T Rr[9], tr[3];
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

    const int loss = bt.loss[b];
    const T c0 = bt.c0[b], c1 = bt.c1[b], c2 = bt.c2[b];
    T* __restrict__ out = rec + q * kLin;
    T* __restrict__ J2 = out + (between ? 36 : 0);
#pragma unroll
    for (int n = 0; n < kRows1; ++n) {
      const int m = sub + kTeam1 * n;
      const T* sm = s[n];
      T r = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) r += sm[j] * rl[j];
      // row m of J2 = S [[Jinv, U], [0, Jinv]]
      T a[3], c[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a[j] = sm[0] * Jinv[j] + sm[1] * Jinv[3 + j] + sm[2] * Jinv[6 + j];
        c[j] = sm[0] * U[j] + sm[1] * U[3 + j] + sm[2] * U[6 + j] + sm[3] * Jinv[j] +
               sm[4] * Jinv[3 + j] + sm[5] * Jinv[6 + j];
      }
      T rho, w;
      loss_eval(loss, c0, c1, c2, r, rho, w);
      w *= fw;
      out[72 + m] = w;
      out[78 + m] = w * r;
      rho_s[q][m] = rho;
#pragma unroll
      for (int j = 0; j < 3; ++j) J2[6 * m + j] = a[j], J2[6 * m + 3 + j] = c[j];
      if (between) {  // row m of J_0 = -J_1 [[R, t^ R], [0, R]]
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          out[6 * m + j] = -(a[0] * Re[j] + a[1] * Re[3 + j] + a[2] * Re[6 + j]);
          out[6 * m + 3 + j] = -(a[0] * tR[j] + a[1] * tR[3 + j] + a[2] * tR[6 + j] + c[0] * Re[j] +
                                 c[1] * Re[3 + j] + c[2] * Re[6 + j]);
        }
      }
    }
  }
  __syncthreads();
  if (sub == 0) {  // the factor's chi2, its rows in order
    T chi2 = T(0);
    if (f < n_factors) {
#pragma unroll
      for (int m = 0; m < 6; ++m) chi2 += rho_s[q][m] * fw;
    }
    chi2_s[q] = chi2;
  }
  // the block's records, one contiguous run of the scratch
  const int nf = n_factors - f0 < kFactors1 ? n_factors - f0 : kFactors1;
  const int n16 = nf * kLin * (int)sizeof(T) / 16;
  const uint4* __restrict__ src = reinterpret_cast<const uint4*>(rec);
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(lin + (long long)f0 * kLin);
  for (int v = threadIdx.x; v < n16; v += kThreads1) dst[v] = src[v];
  __syncthreads();
  if (threadIdx.x < 32) {  // the block's share of chi2, summed in a fixed tree
    T v = chi2_s[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) partials[blockIdx.x] = v;
  }
  launch_dependents();
}

// ---- stage 2: a warp a pose row --------------------------------------------

// Row i of J_a^T diag(w) J_b from a factor's record at base: out[j] =
// sum_m x[m] (w[m] y[m][j]) with x = column i of J_a and y = J_b, the terms
// rounded products added in m order.  The transpose of a block is read as
// its columns, the same rounded values, so that the two halves of He are
// transposes bit for bit.
template <typename T>
__device__ __forceinline__ void block_row(const T* __restrict__ base, int a, int b, int i, T* out) {
  const T* __restrict__ column = base + 36 * a + i;
  const T* __restrict__ rows = base + 36 * b;
#pragma unroll
  for (int j = 0; j < 6; ++j) out[j] = T(0);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const T w = base[72 + m];
    const T x = column[6 * m];
    T y[6];
#pragma unroll
    for (int j = 0; j < 6; j += 2) load2(rows + 6 * m + j, y + j);
#pragma unroll
    for (int j = 0; j < 6; ++j) out[j] = add_rn(out[j], mul_rn(x, mul_rn(w, y[j])));
  }
}

// The gradient row J_a^T (w r) from a factor's record: out[i] = sum_m
// J_a[m][i] (w r)[m] in fused multiply-adds.
template <typename T>
__device__ __forceinline__ void gradient_row(const T* __restrict__ base, int a, T* out) {
  const T* __restrict__ Ja = base + 36 * a;
#pragma unroll
  for (int j = 0; j < 6; ++j) out[j] = T(0);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const T wr = base[78 + m];
    T y[6];
#pragma unroll
    for (int j = 0; j < 6; j += 2) load2(Ja + 6 * m + j, y + j);
#pragma unroll
    for (int j = 0; j < 6; ++j) out[j] += y[j] * wr;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads2)
    assemble_rows(const T* __restrict__ lin, const T* __restrict__ partials, int n_partials,
                  const int2* __restrict__ entries, const int* __restrict__ rows, const int* __restrict__ cols,
                  const unsigned char* __restrict__ const_mask, T* __restrict__ He, T* __restrict__ g,
                  T* __restrict__ chi2, int nb, int K) {
  constexpr int kVec = kLin * (int)sizeof(T) / 16;  // 16-byte pieces of a record
  constexpr int kLoads = 4;                         // pieces in flight, a lane
  __shared__ __align__(16) T rec[kRows2][kStaged * kLin];
  // an entry's parts: rows 0..5 of its block in the diagonal slot, rows
  // 0..5 of its off-diagonal block, its gradient row
  __shared__ __align__(16) T part[kRows2][kStaged * kParts * 6];
  __shared__ int2 ent[kRows2][kStaged];
  if (blockIdx.x == gridDim.x - 1) {
    // chi2: warp 0 sums the partials, lane l those at l, l + 32, ..., then
    // a shuffle tree
    wait_for_previous_grid();
    if (threadIdx.x < 32) {
      T acc = T(0);
      for (int i = threadIdx.x; i < n_partials; i += 32) acc += partials[i];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (threadIdx.x == 0) *chi2 = acc;
    }
    return;
  }
  const int team = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRows2 + team;
  if (r >= nb) return;  // a whole warp leaves together
  uint4* __restrict__ staged = reinterpret_cast<uint4*>(rec[team]);
  const uint4* __restrict__ records = reinterpret_cast<const uint4*>(lin);
  T* __restrict__ parts = part[team];
  // before the wait: only the plan's tables and the masks, which stage 1
  // does not write
  const int lo = rows[r], hi = rows[r + 1];
  const int n_first = hi - lo < kStaged ? hi - lo : kStaged;
  const int2 first = lane < n_first ? entries[lo + lane] : make_int2(0, 0);
  const T free_r = const_mask[r] ? T(0) : T(1);
  const int n_units = 6 * K + 1;
  T free_c[kUnitsPerLane];
#pragma unroll
  for (int j = 0; j < kUnitsPerLane; ++j) {
    const int u = lane + 32 * j;
    free_c[j] = u < 6 * K && !const_mask[cols[(long long)r * K + u / 6]] ? T(1) : T(0);
  }
  wait_for_previous_grid();

  for (int u0 = 0; u0 < n_units; u0 += 32 * kUnitsPerLane) {
    if (u0 > 0) {
#pragma unroll
      for (int j = 0; j < kUnitsPerLane; ++j) {
        const int u = u0 + lane + 32 * j;
        free_c[j] = u < 6 * K && !const_mask[cols[(long long)r * K + u / 6]] ? T(1) : T(0);
      }
    }
    T acc[kUnitsPerLane][6];
#pragma unroll
    for (int j = 0; j < kUnitsPerLane; ++j) {
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[j][i] = T(0);
    }
    for (int c0 = lo; c0 < hi; c0 += kStaged) {
      const int nq = hi - c0 < kStaged ? hi - c0 : kStaged;
      const int2 e = c0 == lo ? first : (lane < nq ? entries[c0 + lane] : make_int2(0, 0));
      // the chunk's records, kLoads 16-byte loads a lane in flight at a time
      if (lane < nq) ent[team][lane] = e;
      for (int v0 = 0; v0 < nq * kVec; v0 += 32 * kLoads) {
        uint4 piece[kLoads];
#pragma unroll
        for (int n = 0; n < kLoads; ++n) {
          const int v = v0 + lane + 32 * n;
          const int qq = v / kVec;
          const int f = __shfl_sync(0xffffffffu, e.x, qq < 32 ? qq : 0) >> 3;
          if (v < nq * kVec) piece[n] = records[(long long)f * kVec + (v - qq * kVec)];
        }
#pragma unroll
        for (int n = 0; n < kLoads; ++n) {
          const int v = v0 + lane + 32 * n;
          if (v < nq * kVec) staged[v] = piece[n];
        }
      }
      __syncwarp();
      // every part of the chunk's entries, a lane a row: rows 0..5 the block
      // D_a = J_a^T W J_a of an entry with a == b, else C = J_0^T W J_1;
      // rows 6..11 C where the entry names an off-diagonal slot; then the
      // gradient rows of the entries with a == b
      for (int t = lane; t < nq * 12; t += 32) {
        const int qq = t / 12;
        const int s = t - 12 * qq;
        const int2 en = ent[team][qq];
        const int a = (en.x >> 2) & 1;
        const bool own = s < 6 && a == ((en.x >> 1) & 1);
        if (s >= 6 && en.y == 0) continue;
        T row[6];
        block_row(rec[team] + qq * kLin, own ? a : 0, own ? a : 1, s % 6, row);
        T* __restrict__ out = parts + (qq * kParts + s) * 6;
#pragma unroll
        for (int t2 = 0; t2 < 6; t2 += 2) store2(out + t2, row[t2], row[t2 + 1]);
      }
      if (lane < nq) {
        const int a = (e.x >> 2) & 1;
        if (a == ((e.x >> 1) & 1)) {
          T row[6];
          gradient_row(rec[team] + lane * kLin, a, row);
          T* __restrict__ out = parts + (lane * kParts + 12) * 6;
#pragma unroll
          for (int t2 = 0; t2 < 6; t2 += 2) store2(out + t2, row[t2], row[t2 + 1]);
        }
      }
      __syncwarp();
      // then each unit's sum, in entry order: a row of the entry's part, or
      // its column where the plan asks for the transpose (slot 0: an entry
      // C^T; slot k: C where a = 1)
#pragma unroll
      for (int j = 0; j < kUnitsPerLane; ++j) {
        const int u = u0 + lane + 32 * j;
        const int k = u / 6;
        const int i = u - 6 * k;
        for (int qq = 0; qq < nq; ++qq) {
          const int2 en = ent[team][qq];
          const int a = (en.x >> 2) & 1;
          const bool own = a == ((en.x >> 1) & 1);
          if (u >= n_units || (k > 0 && (k < K ? en.y != k : !own))) continue;
          const bool column = k == 0 ? (en.x & 1) != 0 : k < K && a == 1;
          const T* __restrict__ in = parts + qq * kParts * 6 + (k == K ? 72 : 36 * (k > 0));
#pragma unroll
          for (int t2 = 0; t2 < 6; ++t2) acc[j][t2] += column ? in[6 * t2 + i] : in[6 * i + t2];
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < kUnitsPerLane; ++j) {
      const int u = u0 + lane + 32 * j;
      if (u >= n_units) continue;
      const int k = u / 6;
      const int i = u - 6 * k;
      if (k < K) {
        T v[6];
#pragma unroll
        for (int t = 0; t < 6; ++t) {
          v[t] = acc[j][t] * free_r * free_c[j];
          if (k == 0 && t == i) v[t] += T(1) - free_r;  // the unit diagonal of a constant pose
        }
        T* __restrict__ out = He + ((long long)r * K + k) * 36 + 6 * i;
#pragma unroll
        for (int t = 0; t < 6; t += 2) store2(out + t, v[t], v[t + 1]);
      } else {
#pragma unroll
        for (int t = 0; t < 6; ++t) g[6LL * r + t] = -acc[j][t] * free_r;
      }
    }
  }
}

template <typename T>
int launch(const void* poses, const void* const_mask, const void* cols, const void* idx,
           const void* entries, const void* rows, int n_batches, const void* const* T_obs,
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
  const int blocks1 = (n_factors + kFactors1 - 1) / kFactors1;
  if (scratch_len < (long long)n_factors * kLin + blocks1) return kErrScratchTooSmall;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* lin = static_cast<T*>(scratch);
  T* partials = lin + (long long)n_factors * kLin;
  // both programmatic dependent launches
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.stream = s;
  config.attrs = &dependent;
  config.numAttrs = 1;
  if (blocks1 > 0) {
    config.gridDim = dim3((unsigned)blocks1);
    config.blockDim = dim3(kThreads1);
    const cudaError_t err = cudaLaunchKernelEx(&config, assemble_linearize<T>, static_cast<const T*>(poses),
                                               static_cast<const int2*>(idx), bt, n_factors, lin, partials);
    if (err != cudaSuccess) return (int)err;
  }
  // one block more than the rows need: it sums chi2
  config.gridDim = dim3((unsigned)((nb + kRows2 - 1) / kRows2) + 1u);
  config.blockDim = dim3(kThreads2);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, assemble_rows<T>, static_cast<const T*>(lin), static_cast<const T*>(partials), blocks1,
      static_cast<const int2*>(entries), static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const unsigned char*>(const_mask), static_cast<T*>(He), static_cast<T*>(g),
      static_cast<T*>(chi2), nb, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#define PYSLAM_ELL_ASSEMBLE_ARGS                                                                  \
  const void *poses, const void *const_mask, const void *cols, const void *idx,                   \
      const void *entries, const void *rows, int n_batches, const void *const *T_obs,             \
      const void *const *sqrt_info, const void *const *weight, const int *first,                  \
      const int *n_slots, const int *loss, const double *loss_params, void *scratch,              \
      long long scratch_len, void *He, void *g, void *chi2, int nb, int K, void *stream
#define PYSLAM_ELL_ASSEMBLE_PASS                                                                  \
  poses, const_mask, cols, idx, entries, rows, n_batches, T_obs, sqrt_info, weight, first,        \
      n_slots, loss, loss_params, scratch, scratch_len, He, g, chi2, nb, K, stream

// The pointer tables (T_obs, sqrt_info, weight), first (n_batches + 1),
// n_slots, loss and loss_params (3 a batch) are host arrays, read before the
// launch returns; every other pointer is device memory.  entries holds
// (code, slot) pairs of int32, rows nb + 1 offsets into it.  scratch holds
// n_factors * 84 + ceil(n_factors / 32) values of T.  poses, the batches'
// T_obs and scratch are aligned to 16 bytes, entries and sqrt_info to 8.
extern "C" int pyslam_ell_assemble_f32(PYSLAM_ELL_ASSEMBLE_ARGS) {
  return launch<float>(PYSLAM_ELL_ASSEMBLE_PASS);
}

extern "C" int pyslam_ell_assemble_f64(PYSLAM_ELL_ASSEMBLE_ARGS) {
  return launch<double>(PYSLAM_ELL_ASSEMBLE_PASS);
}
