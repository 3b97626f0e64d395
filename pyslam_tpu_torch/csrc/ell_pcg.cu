// Block-Jacobi preconditioned conjugate gradients on the symmetric-ELL
// Hessian over a block of m right-hand sides, one launch per block:
//
//   for every column c:  x = 0, r = b_c, z = Minv r, p = z, rz = r.z
//   while some column runs:      (column c runs while norm(r_c) > rtol *
//                                 norm(b_c) and it_c < max_iters)
//     for every running column:
//       Ap = A p                 (A p)[r] = sum_k He[r, k] p[cols[r, k]]
//       alpha = rz / (p.Ap);  x += alpha p;  r -= alpha Ap
//       z = Minv r               (Minv r)[r] = Minv[r] r[r]
//       beta = (r.z) / rz;  p = z + beta p;  rz = r.z;  it_c += 1
//
// He (nb, K, d, d), cols (nb, K) int32, Minv (nb, d, d); b and x (m, nb*d),
// column c at c * nb * d.  Each column has its own recurrences and its own
// stop test, run before each of its iterations; a column that has stopped
// is frozen (x, r, p and its count keep their values), as a vmapped
// lax.while_loop freezes the batch elements whose condition is false.  A
// NaN in r makes the test false and stops the column (NaN in, NaN out, no
// trap).  `iters` receives each column's iteration count and `counter` is
// increased by their sum, both on the device.  With m = 1 this is the
// linear solve of solve_ell.
//
// Replaces pyslam_tpu/solver/pallas_ops.py::ell_matvec_lane_major as it
// runs inside the lax.while_loop of pyslam_tpu/solver/linear.py::_pcg (and,
// for m > 1, inside the vmap of that loop over the columns of a covariance
// query, pyslam_tpu/solver/covariance.py::marginal_covariances): on the TPU
// the whole loop is one device program, so the counterpart of the kernel
// on this card is the loop, not one product.
//
// What bounds it on an H100.  By bytes, one read of He, cols, Minv and b
// and one write of x: at sphere2500 (nb = 2500, K = 9, d = 6, f32, m = 1)
// 3.81 MB, 1.14 us at 3.35 TB/s.  By operations, per iteration and column
// 2 nb (K + 1) d^2 + 12 nb d flop = 1.98 MFLOP, 0.03 us at 67 TFLOP/s, so
// 3.5 us for the 120 iterations of a sphere2500 solve: operations are the
// larger bound.  In truth neither: an iteration is two grid-wide barriers
// and the L2 round trips between them, 6.5 us measured on an H100 (700 W)
// against 0.03.  A block of columns shares those barriers: m columns cost
// one iteration's barriers, not m.
//
// What the design does about it:
//  * One persistent cooperative launch per block of columns, one block of
//    512 threads on each SM at most (registers allow no second one, and a
//    barrier costs more the more blocks take part).  A grid larger than
//    what is co-resident would hang at the first barrier, so the launch
//    checks the occupancy for its shared memory.  Block g owns the block
//    rows [g R, (g + 1) R), R = ceil(nb / SMs), of every column.
//  * He, cols and Minv of the owned rows are loaded into shared memory once
//    (16-byte loads where the addresses allow) and stay there for every
//    iteration and column.  Rows that do not fit (`res_rows` of R do) are
//    read from device memory each iteration by the same code through
//    another pointer.  The plan gives a launch as many columns as fit in
//    shared memory beside a fully resident He (`max_columns`, at most
//    kMaxColumns); where not even one column fits beside it, one column a
//    launch with He partly resident, as before.
//  * The kernel is a template over its column layout.  One column (the
//    linear solve of solve_ell) keeps the block-wide loops and the
//    reductions through the block's 16 warps it had before blocks of
//    columns were added.  A block of columns uses the layout below.
//  * The owned rows' x, r, z, p and Ap of every column live in shared
//    memory.  A work item of the product is one (running column, owned
//    row), spread over a sub-warp (ell_row.cuh, shared with ell_matvec.cu).
//    Everything else of a column between the two grid barriers (alpha, the
//    updates of x and r, the preconditioner, the partial dot products) is
//    the work of one warp, which holds all of the column's owned elements,
//    so it needs no block barrier; a block barrier per iteration publishes
//    the stop decisions, and the list of running columns is rebuilt only
//    when one has stopped.
//  * Two barriers an iteration, no host.  Every block publishes z and p of
//    its rows for every running column to device memory (L2).  The other
//    blocks' p is never waited for: p = z + beta p_prev is recomputed by
//    whoever gathers it, from z and the previous p (two buffers in turn)
//    with the same fused multiply-add as its owner, so a third barrier
//    (after the update of p) is not needed.
//  * The dot products are two-stage and ordered: for each running column
//    one warp of each block sums the block's terms (per lane, then a
//    shuffle tree) into the block's slot of a device array; after the
//    barrier one warp of every block sums a column's slots in the same
//    order.  No atomics: every block sees the same bits, takes the same
//    stop decisions, and two runs agree bitwise.  A stopped column costs
//    nothing: the work loops run over the list of running columns.
//  * Values written by other blocks are read with ld.global.cg (L2), never
//    through the SM's L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ell_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVectors = 5;      // x, r, z, p, Ap of the owned rows, per column
constexpr int kColScalars = 3;   // rz, tol, beta of each column
constexpr int kColInts = 3;      // iteration count, running flag, running list
constexpr int kMaxColumns = 128;
constexpr int kBroadcast = 2;    // one-column layout: grid-wide sums handed from warp 0 to the block

// Return codes of the entry points besides CUDA's own (positive) errors.
constexpr int kErrNoCooperativeLaunch = -1;
constexpr int kErrVectorsDoNotFit = -2;
constexpr int kErrNotResident = -3;
constexpr int kErrTooManyColumns = -4;

struct Plan {
  int grid;            // blocks, one per SM at most
  int rows_per_block;  // R
  int res_rows;        // rows per block whose He, cols, Minv stay in shared memory
  int lanes;           // sub-warp width of a row product
  int smem;            // dynamic shared memory, bytes
  int resident_total;  // rows of all blocks that are resident
  int max_columns;     // the most columns one launch carries
};

template <typename T>
struct PcgArgs {
  const T* He;
  const int* cols;
  const T* Minv;
  const T* b;   // (m, n)
  T* x;         // (m, n)
  T* P;         // (2, m, n): p of the even and of the odd iterations
  T* Z;         // (m, n)
  T* part_pap;  // (grid, m)
  T* part_rz;   // (grid, m, 2): r.z and r.r
  int* iters;   // (m,)
  long long* counter;
  int nb, K, d, m, rows_per_block, res_rows, lanes, max_iters;
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

// s[k] = sum over the G blocks i of part[(i * m + c) * kN + k], by one warp
// in a fixed order (the same in every block); every lane gets the sums.
template <typename T, int kN>
__device__ __forceinline__ void column_grid_sum(const T* part, int G, int m, int c, int lane, T (&s)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = T(0);
  for (int i = lane; i < G; i += 32) {
#pragma unroll
    for (int k = 0; k < kN; ++k) s[k] += __ldcg(part + ((long long)i * m + c) * kN + k);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = warp_sum(s[k]);
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

// One right-hand side (m = 1): block-wide loops over the owned elements,
// reductions through the block's warps.
template <typename T, int D>
__device__ __forceinline__ void pcg_one_column(const PcgArgs<T>& a, unsigned char* smem_raw) {
  cg::grid_group grid = cg::this_grid();

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
  T* bc = red + 2 * kWarps;
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
      red[kWarps + warp] = v_rr;
    }
    __syncthreads();
    if (tid == 0) {
      T s_rz = T(0), s_rr = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s_rz += red[w];
        s_rr += red[kWarps + w];
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
      for (int w = 0; w < kWarps; ++w) s += red[w];
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

// A block of right-hand sides (m >= 1): the work loops over the list of
// running columns, each column's vector work and partial sums by one warp.
template <typename T, int D>
__device__ __forceinline__ void pcg_columns(const PcgArgs<T>& a, unsigned char* smem_raw) {
  cg::grid_group grid = cg::this_grid();

  const int d = D > 0 ? D : a.d;
  const int K = a.K;
  const int m = a.m;
  const int dd = d * d;
  const long long kdd = (long long)K * dd;
  const long long n = (long long)a.nb * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane32 = tid & 31;
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int R = a.rows_per_block;
  const long long row0 = (long long)blk * R;
  const long long left = a.nb - row0;
  const int rows = left < 0 ? 0 : (left < R ? (int)left : R);  // owned block rows
  const int res = rows < a.res_rows ? rows : a.res_rows;       // of them, resident
  const int n_own = rows * d;
  const int Rd = R * d;            // one column's stride in shared memory
  const long long e0 = row0 * d;   // first owned scalar of a column

  // shared memory: He | Minv | x r z p Ap (m columns each) | rz tol beta
  // (m each) | cols | iterations, running flags, running list (m each) |
  // number running | "a column stopped"
  T* he_s = reinterpret_cast<T*>(smem_raw);
  T* minv_s = he_s + (long long)a.res_rows * kdd;
  T* xs = minv_s + (long long)a.res_rows * dd;
  T* rs = xs + (long long)m * Rd;
  T* zs = rs + (long long)m * Rd;
  T* ps = zs + (long long)m * Rd;
  T* aps = ps + (long long)m * Rd;
  T* rz_s = aps + (long long)m * Rd;
  T* tol_s = rz_s + m;
  T* beta_s = tol_s + m;
  int* cols_s = reinterpret_cast<int*>(beta_s + m);
  int* it_s = cols_s + (long long)a.res_rows * K;
  int* run_s = it_s + m;
  int* list_s = run_s + m;
  int* n_run_s = list_s + m;
  int* stopped_s = n_run_s + 1;

  block_copy(he_s, a.He + row0 * kdd, res * kdd);
  block_copy(minv_s, a.Minv + row0 * dd, (long long)res * dd);
  block_copy(cols_s, a.cols + row0 * K, (long long)res * K);
  for (int c = 0; c < m; ++c) {
    for (int e = tid; e < n_own; e += blockDim.x) {
      rs[c * Rd + e] = a.b[c * n + e0 + e];
      xs[c * Rd + e] = T(0);
      ps[c * Rd + e] = T(0);
      a.P[(m + c) * n + e0 + e] = T(0);  // "p before the first": any finite value, times beta = 0
    }
  }
  for (int c = tid; c < m; c += blockDim.x) {
    it_s[c] = 0;
    run_s[c] = 1;
    list_s[c] = c;
    beta_s[c] = T(0);
  }
  if (tid == 0) {
    *n_run_s = m;
    *stopped_s = 0;
  }
  __syncthreads();

  // Column c's z = Minv r on the owned rows, published to Z, and this
  // block's r.z and r.r into its slots of part_rz, by one warp: its lanes
  // take the column's elements in turn, so r is complete for the warp
  // after __syncwarp.
  auto precondition_and_dots = [&](int c) {
    __syncwarp();
    T v_rz = T(0), v_rr = T(0);
    for (int e = lane32; e < n_own; e += 32) {
      const int lr = e / d;
      const int i = e - lr * d;
      const T* mrow = (lr < res ? minv_s + (long long)lr * dd : a.Minv + (row0 + lr) * dd) + i * d;
      const T* rrow = rs + c * Rd + lr * d;
      T z = T(0);
      for (int k = 0; k < d; ++k) z += mrow[k] * rrow[k];
      zs[c * Rd + e] = z;
      a.Z[c * n + e0 + e] = z;
      const T r = rrow[i];
      v_rz += r * z;
      v_rr += r * r;
    }
    v_rz = warp_sum(v_rz);
    v_rr = warp_sum(v_rr);
    if (lane32 == 0) {
      a.part_rz[((long long)blk * m + c) * 2] = v_rz;
      a.part_rz[((long long)blk * m + c) * 2 + 1] = v_rr;
    }
  };

  for (int c = warp; c < m; c += kWarps) precondition_and_dots(c);
  grid.sync();
  for (int c = warp; c < m; c += kWarps) {
    T s[2];
    column_grid_sum<T, 2>(a.part_rz, G, m, c, lane32, s);
    if (lane32 == 0) {
      rz_s[c] = s[0];
      tol_s[c] = a.rtol * sqrt_t(s[1]);  // r0 = b
      run_s[c] = (sqrt_t(s[1]) > tol_s[c]) && (0 < a.max_iters);
      if (!run_s[c]) *stopped_s = 1;
    }
  }

  const int L = a.lanes;
  const int sub = tid / L;
  const int lane = tid & (L - 1);
  const int n_sub = blockDim.x / L;
  int n_run = m;
  int it = 0;  // iterations of the launch: the parity of the p buffers

  for (;;) {
    // the list of running columns, rebuilt when one has stopped
    __syncthreads();
    if (*stopped_s) {
      __syncthreads();
      if (tid == 0) {
        int k = 0;
        for (int c = 0; c < m; ++c) {
          if (run_s[c]) list_s[k++] = c;
        }
        *n_run_s = k;
        *stopped_s = 0;
      }
      __syncthreads();
      n_run = *n_run_s;
    }
    if (n_run == 0) break;
    T* Pcur = a.P + (long long)(it & 1) * m * n;
    const T* Pprev = a.P + (long long)((it + 1) & 1) * m * n;

    // p = z + beta p on the owned rows, published for the next iteration
    for (int q = tid; q < n_run * n_own; q += blockDim.x) {
      const int j = q / n_own;
      const int e = q - j * n_own;
      const int c = list_s[j];
      const T pv = fma_t(beta_s[c], ps[c * Rd + e], zs[c * Rd + e]);
      ps[c * Rd + e] = pv;
      Pcur[c * n + e0 + e] = pv;
    }
    // Ap on the owned rows of every running column; p of any row from the
    // published z and p_prev
    const int items = n_run * rows;
    for (int w0 = 0; w0 < items; w0 += n_sub) {
      const int wi = w0 + sub;
      const bool valid = wi < items;
      const int wic = valid ? wi : 0;
      const int j = wic / rows;
      const int lr = wic - j * rows;
      const int c = list_s[j];
      const bool in_smem = lr < res;
      const T* he = in_smem ? he_s + lr * kdd : a.He + (row0 + lr) * kdd;
      const int* cl = in_smem ? cols_s + (long long)lr * K : a.cols + (row0 + lr) * K;
      const GatherP<T> gather{a.Z + c * n, Pprev + c * n, beta_s[c]};
      pyslam::ell_row_product<T, D>(he, cl, K, d, valid, lane, L, gather, aps + c * Rd + lr * d);
    }
    __syncthreads();

    // this block's p.Ap of each running column, one warp a column
    for (int j = warp; j < n_run; j += kWarps) {
      const int c = list_s[j];
      const T* p = ps + c * Rd;
      const T* ap = aps + c * Rd;
      T v = T(0);
      for (int e = lane32; e < n_own; e += 32) v += p[e] * ap[e];
      v = warp_sum(v);
      if (lane32 == 0) a.part_pap[(long long)blk * m + c] = v;
    }
    grid.sync();

    // alpha, x += alpha p, r -= alpha Ap, z, and the new dots: the warp of
    // the column, without a block barrier
    for (int j = warp; j < n_run; j += kWarps) {
      const int c = list_s[j];
      T s[1];
      column_grid_sum<T, 1>(a.part_pap, G, m, c, lane32, s);
      const T alpha = rz_s[c] / s[0];
      for (int e = lane32; e < n_own; e += 32) {
        xs[c * Rd + e] += alpha * ps[c * Rd + e];
        rs[c * Rd + e] -= alpha * aps[c * Rd + e];
      }
      precondition_and_dots(c);
    }
    grid.sync();

    for (int j = warp; j < n_run; j += kWarps) {
      const int c = list_s[j];
      T s[2];
      column_grid_sum<T, 2>(a.part_rz, G, m, c, lane32, s);
      if (lane32 == 0) {
        beta_s[c] = s[0] / rz_s[c];
        rz_s[c] = s[0];
        const int done = ++it_s[c];
        run_s[c] = (sqrt_t(s[1]) > tol_s[c]) && (done < a.max_iters);
        if (!run_s[c]) *stopped_s = 1;
      }
    }
    ++it;
  }

  for (int c = 0; c < m; ++c) {
    for (int e = tid; e < n_own; e += blockDim.x) a.x[c * n + e0 + e] = xs[c * Rd + e];
  }
  if (blk == 0) {
    for (int c = tid; c < m; c += blockDim.x) a.iters[c] = it_s[c];
    if (tid == 0) {
      long long total = 0;
      for (int c = 0; c < m; ++c) total += it_s[c];
      *a.counter += total;
    }
  }
}

// The kernel, templated over the column count of its layout: the
// one-column solve of solve_ell keeps the block-wide loops it had before
// blocks of columns were added (one warp a column would leave 15 of 16 idle
// there), any other count the block layout.
template <typename T, int D, bool kOneColumn>
__global__ void __launch_bounds__(kThreads, 1) ell_pcg_kernel(const PcgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kOneColumn) {
    pcg_one_column<T, D>(a, smem_raw);
  } else {
    pcg_columns<T, D>(a, smem_raw);
  }
}

template <typename T, int D>
void (*kernel_of(int m))(PcgArgs<T>) {
  return m == 1 ? ell_pcg_kernel<T, D, true> : ell_pcg_kernel<T, D, false>;
}

// The launch geometry for (nb, K, d) and m columns on the current device.
// `max_columns` is filled in before any check of m.
template <typename T, int D>
int make_plan(int nb, int K, int d, int m, Plan* plan) {
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
  const long long per_row = ((long long)K * d * d + d * d) * sizeof(T) + (long long)K * sizeof(int);
  const long long per_col =
      ((long long)kVectors * R * d + kColScalars) * sizeof(T) + kColInts * (long long)sizeof(int);
  // 16: the size is rounded up below; two ints: the number of running
  // columns and the flag of a stopped one
  const long long avail = (long long)optin - 16 - 2 * (long long)sizeof(int);
  if (avail < per_col) {
    plan->max_columns = 0;
    return kErrVectorsDoNotFit;
  }
  const long long full = avail >= R * per_row ? (avail - R * per_row) / per_col : 0;
  plan->max_columns = full >= 1 ? (int)(full < kMaxColumns ? full : kMaxColumns) : 1;
  if (m < 1 || m > plan->max_columns) return kErrTooManyColumns;
  // shared memory besides the resident rows: the one-column layout's
  // vectors, reduction scratch and sums, or the block layout's columns
  const long long fixed = m == 1 ? ((long long)kVectors * R * d + 2 * kWarps + kBroadcast) * sizeof(T)
                                 : 2 * (long long)sizeof(int) + m * per_col;
  const long long room = (long long)optin - 16 - fixed;
  if (room < 0) return kErrVectorsDoNotFit;
  const long long fit = room / per_row;
  plan->rows_per_block = R;
  plan->grid = (nb + R - 1) / R;
  plan->res_rows = fit < R ? (int)fit : R;
  plan->lanes = pyslam::lanes_per_row(kThreads, (long long)m * R, K, d);
  plan->smem = (int)((fixed + plan->res_rows * per_row + 15) / 16 * 16);
  const int last = nb - (plan->grid - 1) * R;  // rows of the last block
  plan->resident_total =
      (plan->grid - 1) * plan->res_rows + (last < plan->res_rows ? last : plan->res_rows);

  // above 48 KB the kernel must be allowed its dynamic shared memory; the
  // occupancy for that size says whether the grid can be co-resident
  err = cudaFuncSetAttribute(kernel_of<T, D>(m), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan->smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<T, D>(m), kThreads,
                                                        plan->smem);
  }
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < plan->grid) return kErrNotResident;
  return 0;
}

template <typename T, int D>
int launch_d(const PcgArgs<T>& in, void* stream) {
  Plan plan;
  const int perr = make_plan<T, D>(in.nb, in.K, in.d, in.m, &plan);
  if (perr != 0) return perr;
  PcgArgs<T> a = in;
  a.rows_per_block = plan.rows_per_block;
  a.res_rows = plan.res_rows;
  a.lanes = plan.lanes;
  a.part_pap = a.Z + (long long)a.m * a.nb * a.d;
  a.part_rz = a.part_pap + (long long)plan.grid * a.m;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel_of<T, D>(a.m)), dim3(plan.grid), dim3(kThreads), params,
      plan.smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// scratch: (3 m n + 3 grid m) values of T: P (2, m, n), Z (m, n), part_pap
// (grid, m), part_rz (grid, m, 2).
template <typename T>
int launch(const void* He, const void* cols, const void* Minv, const void* b, void* x,
           void* scratch, void* iters, void* counter, int nb, int K, int d, int m, double rtol,
           int max_iters, void* stream) {
  if (m <= 0) return 0;
  if ((long long)nb * d == 0) {
    return (int)cudaMemsetAsync(iters, 0, (size_t)m * sizeof(int),
                                static_cast<cudaStream_t>(stream));
  }
  PcgArgs<T> a{};
  a.He = static_cast<const T*>(He);
  a.cols = static_cast<const int*>(cols);
  a.Minv = static_cast<const T*>(Minv);
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.P = static_cast<T*>(scratch);
  a.Z = a.P + 2LL * m * nb * d;
  a.iters = static_cast<int*>(iters);
  a.counter = static_cast<long long*>(counter);
  a.nb = nb;
  a.K = K;
  a.d = d;
  a.m = m;
  a.max_iters = max_iters;
  a.rtol = static_cast<T>(rtol);
  return d == 6 ? launch_d<T, 6>(a, stream) : launch_d<T, 0>(a, stream);
}

template <typename T>
int plan_out(int nb, int K, int d, int m, int* out) {
  Plan plan{};
  plan.max_columns = kMaxColumns;
  if ((long long)nb * d != 0) {
    const int err = d == 6 ? make_plan<T, 6>(nb, K, d, m, &plan) : make_plan<T, 0>(nb, K, d, m, &plan);
    out[5] = plan.max_columns;
    if (err != 0) return err;
  }
  out[0] = plan.grid;
  out[1] = plan.rows_per_block;
  out[2] = plan.resident_total;
  out[3] = plan.smem;
  out[4] = plan.lanes;
  out[5] = plan.max_columns;
  return 0;
}

}  // namespace

// out[0:6] = grid, rows per block, resident rows (of nb), dynamic shared
// memory in bytes, lanes per row, for elements of `elem_size` bytes and m
// columns a launch, and the most columns a launch carries (written also
// when m is refused for being above it, with the error -4).
extern "C" int pyslam_ell_pcg_plan(int nb, int K, int d, int elem_size, int m, int* out) {
  return elem_size == 8 ? plan_out<double>(nb, K, d, m, out) : plan_out<float>(nb, K, d, m, out);
}

extern "C" int pyslam_ell_pcg_f32(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, int m, double rtol,
                                  int max_iters, void* stream) {
  return launch<float>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, m, rtol, max_iters,
                       stream);
}

extern "C" int pyslam_ell_pcg_f64(const void* He, const void* cols, const void* Minv,
                                  const void* b, void* x, void* scratch, void* iters,
                                  void* counter, int nb, int K, int d, int m, double rtol,
                                  int max_iters, void* stream) {
  return launch<double>(He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, m, rtol, max_iters,
                        stream);
}
