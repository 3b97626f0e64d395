// The elementwise robust losses of losses.py on the card: rho(e) and the
// IRLS weight, with the helpers they use.  Shared by the kernels that
// linearize factors (ell_assemble.cu, bal_rows.cu), so that a loss gives
// the same bits in both.  The ids are cuda_ops.kernel_loss's, and so are
// the constants c0, c1, c2 (rounded to T by the caller).

#pragma once

#include <cuda_runtime.h>

namespace pyslam {

__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// clamps that hand a NaN on, as torch.clamp does
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) {
  return x > hi ? hi : x;
}

enum Loss { kL2 = 0, kL1 = 1, kCauchy = 2, kHuber = 3, kTukey = 4, kStudentT = 5 };

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

}  // namespace pyslam
