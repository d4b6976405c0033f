// The fused U passes at k > 32 (the wide route) for Hopper (sm_90a), called
// through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/mu_fused.py:fused_mu_u_pass (TPU kernel
// K1) and pycmf_tpu/ops/pallas/newton_fused.py:fused_newton_linear_u_pass
// (TPU kernel K2) at n_components > 32; mu_fused.cu and newton_fused.cu
// take k <= 32. The TPU kernels read X once at any k.
//
// Bound (chip_smoke.py: bound): the bytes of X once and of the factors
// (bf16 X 30000 x 11314 at k = 40: 0.208 ms at 3.35 TB/s), or for f32 X the
// TF32 products where they take longer: six for X V and three for
// X^T U_new, 2 n m k flops each (at k = 100: 1.23 ms at 495 TFLOP/s). The
// route reads X twice, once a sweep. K2's step and line search add two
// k x k f64 products a row (g, d; phi(U) reuses g's U BtB) and one a
// trial, on the CUDA cores.
//
// Design (u_pass_wide.cuh): the two-sweep route of mu_fused.cu with one
// read of X per sweep at any k <= 128: the row sweep's CTA computes X V for
// every n8 tile of the factor dimension from each stage of X in shared
// memory, into an (n, k) scratch; this file's epilogue runs on tiles of
// four rows a warp, the k x k matrices in shared memory, each k x k product
// a register tile (f32 for the MU ratio; f64 for K2's step and line search,
// whose g = U BtB - DB cancels at k > m and whose Hinv amplifies it); the
// column sweep's CTA computes X^T U_new for every tile of its 128 columns.
// Above k = 128 the factor dimension goes in slices of 128 components, the
// slices of one block of X next to each other in the grid. Each output
// keeps the summation order of the former 32-component slices, so the
// outputs are theirs bit for bit, and an e4m3 call equals the bf16 call on
// X widened.
#include "u_pass_wide.cuh"

namespace pycmf {

// rows r0 ... r0 + nv - 1 of a k-column matrix at src into the tile t
// (row r at t + r * k), then __syncwarp.
__device__ __forceinline__ void stage_rows(const float* src, int nv, int k,
                                           float* t) {
#pragma unroll 4
  for (int e = threadIdx.x & 31; e < nv * k; e += 32) t[e] = src[e];
  __syncwarp();
}

// U_new = U * XV / (U VtV + l1 + l2 U + eps), zero for rows >= n_valid: the
// ratio of mu_fused.cu, each denominator summed over l in order.
struct MuWide {
  const float* U;
  const float* VtV;
  int k, n_valid;
  float l1, l2, eps;
  static constexpr int kMats = 1;

  __device__ const float* mat(int) const { return VtV; }

  __device__ __forceinline__ void group(int r0, int nv,
                                        const float* const* mats, float* t0,
                                        float*, const float* XV,
                                        float* Unew) const {
    const int lane = threadIdx.x & 31;
    int ar[kWGroup];
#pragma unroll
    for (int r = 0; r < kWGroup; ++r) ar[r] = min(r, nv - 1);
    const float* u0 = U + (size_t)r0 * k;
    stage_rows(u0, nv, k, t0);
    for (int c0 = 0; c0 < k; c0 += 32 * kWQ) {
      float den[kWGroup][kWQ];
      rows_times(t0, ar, mats[0], k, c0, den);
#pragma unroll
      for (int r = 0; r < kWGroup; ++r) {
        if (r >= nv) continue;
        const size_t o = (size_t)(r0 + r) * k;
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c >= k) continue;
          const float u = U[o + c];
          const float un = u * XV[o + c] / (den[r][q] + l1 + l2 * u + eps);
          Unew[o + c] = r0 + r < n_valid ? un : 0.f;
        }
      }
    }
  }
};

// The Newton step and backtracking line search of newton_fused.cu:
//   g = U BtB - DB + l1 sign(U) + l2 U, d = g Hinv (k-term sums in f64),
//   U_new = the first proj(U - 2^-j d), j < trials, whose phi is strictly
//   below phi(U) (slot 0 unprojected), U if none is.
// Per group of kWGroup rows: g into tile t1, d into tile t0, then each
// trial's candidates built once into t1 for the rows still searching, and
// phi of all rows' candidates from one product. phi's sums run per lane over
// its components in order and then the butterfly, in f64.
struct NewtonWide {
  const float* U;
  const float* BtB;
  const float* Hinv;
  const float* row_sq;
  int k;
  float l1, l2;
  int trials, non_negative;
  static constexpr int kMats = 2;

  __device__ const float* mat(int i) const { return i == 0 ? BtB : Hinv; }

  // phi of the group's candidates (row r's at A + ar[r] * k: U's rows, or a
  // trial's in the tile t1).
  __device__ __forceinline__ void phis(const float* A,
                                       const int (&ar)[kWGroup],
                                       const float* Bs, int r0,
                                       const float* XV,
                                       double (&phi)[kWGroup]) const {
    PhiSums ps;
    for (int c0 = 0; c0 < k; c0 += 32 * kWQ) {
      double bm[kWGroup][kWQ];
      rows_times(A, ar, Bs, k, c0, bm);
      ps.add(bm, A, ar, r0, XV, k, c0);
    }
    ps.phi(ar, r0, *this, phi);
  }

  // A lane's terms of phi for the group's rows, summed over its components
  // in order (c0 passes, then q), and phi after the butterfly sums: the
  // order of newton_fused.cu's wide form.
  struct PhiSums {
    double quad[kWGroup] = {}, lin[kWGroup] = {}, a1[kWGroup] = {},
           a2[kWGroup] = {};

    __device__ __forceinline__ void add(const double (&bm)[kWGroup][kWQ],
                                        const float* A,
                                        const int (&ar)[kWGroup], int r0,
                                        const float* XV, int k, int c0) {
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int r = 0; r < kWGroup; ++r)
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c >= k) continue;
          const double mc = A[ar[r] * k + c];
          quad[r] += bm[r][q] * mc;
          lin[r] += (double)XV[(size_t)(r0 + ar[r]) * k + c] * mc;
          a1[r] += fabs(mc);
          a2[r] += mc * mc;
        }
    }

    __device__ __forceinline__ void phi(const int (&ar)[kWGroup], int r0,
                                        const NewtonWide& e,
                                        double (&out)[kWGroup]) {
#pragma unroll
      for (int r = 0; r < kWGroup; ++r) {
        const float rs = e.row_sq[r0 + ar[r]];
        const float l1 = e.l1, l2 = e.l2;
        const double pen =
            l1 * warp_sum_d(a1[r]) + 0.5 * l2 * warp_sum_d(a2[r]);
        out[r] = pen + 0.5 * (rs - 2.0 * warp_sum_d(lin[r]) +
                              warp_sum_d(quad[r]));
      }
    }
  };

  __device__ __forceinline__ void group(int r0, int nv,
                                        const float* const* mats, float* t0,
                                        float* t1, const float* XV,
                                        float* Unew) const {
    const int lane = threadIdx.x & 31;
    int ar[kWGroup];
#pragma unroll
    for (int r = 0; r < kWGroup; ++r) ar[r] = min(r, nv - 1);
    const float* u0 = U + (size_t)r0 * k;
    const float* x0 = XV + (size_t)r0 * k;
    float* w0 = Unew + (size_t)r0 * k;
    // U's rows into t0; g into t1, and phi(U)'s terms from the same U BtB
    // (phi of the candidate U sums exactly these products)
    stage_rows(u0, nv, k, t0);
    PhiSums ps0;
    for (int c0 = 0; c0 < k; c0 += 32 * kWQ) {
      double ub[kWGroup][kWQ];
      rows_times(t0, ar, mats[0], k, c0, ub);
      if (trials > 0) ps0.add(ub, t0, ar, r0, XV, k, c0);
#pragma unroll
      for (int r = 0; r < kWGroup; ++r) {
        if (r >= nv) continue;
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c >= k) continue;
          const float uc = u0[r * k + c];
          const float sgn = uc > 0.f ? 1.f : (uc < 0.f ? -1.f : 0.f);
          t1[r * k + c] = (float)(ub[r][q] - x0[r * k + c] +
                                  (double)(l1 * sgn) + (double)(l2 * uc));
        }
      }
    }
    __syncwarp();  // every read of U's rows in t0 is done
    double phi0[kWGroup];
    if (trials > 0) ps0.phi(ar, r0, *this, phi0);
    // d = g Hinv into t0
    for (int c0 = 0; c0 < k; c0 += 32 * kWQ) {
      double dc[kWGroup][kWQ];
      rows_times(t1, ar, mats[1], k, c0, dc);
#pragma unroll
      for (int r = 0; r < kWGroup; ++r) {
        if (r >= nv) continue;
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c < k) t0[r * k + c] = (float)dc[r][q];
        }
      }
    }
    __syncwarp();  // every read of g is done, d is written
    if (trials <= 0) {
      for (int r = 0; r < nv; ++r)
        for (int c = lane; c < k; c += 32) {
          const float best = u0[r * k + c] - t0[r * k + c];
          w0[r * k + c] = non_negative ? fmaxf(best, 0.f) : best;
        }
      return;
    }
    unsigned open = (1u << nv) - 1;  // rows still searching
    for (int j = 0; j < trials && open; ++j) {  // warp-uniform
      __syncwarp();  // the last product's reads of t1 are done
      for (int r = 0; r < nv; ++r) {
        if (!(open >> r & 1)) continue;
        for (int c = lane; c < k; c += 32) {
          const float mc = u0[r * k + c] - ldexpf(1.f, -j) * t0[r * k + c];
          t1[r * k + c] = non_negative ? fmaxf(mc, 0.f) : mc;
        }
      }
      __syncwarp();
      double phi[kWGroup];
      phis(t1, ar, mats[0], r0, XV, phi);
#pragma unroll
      for (int r = 0; r < kWGroup; ++r) {
        if (!(open >> r & 1) || !(phi[r] < phi0[r])) continue;  // uniform
        for (int c = lane; c < k; c += 32) w0[r * k + c] = t1[r * k + c];
        open &= ~(1u << r);
      }
    }
    for (int r = 0; r < nv; ++r) {
      if (!(open >> r & 1)) continue;
      for (int c = lane; c < k; c += 32) w0[r * k + c] = u0[r * k + c];
    }
  }
};

}  // namespace pycmf

// The entry points take the arguments of pycmf_mu_fused_u_pass and
// pycmf_newton_fused_u_pass (mu_fused.cu, newton_fused.cu) at k > 32, with
// nt (the plan's n8 tiles a slice: its nt / k_slices) and k_slices in the
// place of the cluster route's clusters and slice_cols: x_dtype is X's
// dtype code (common.cuh: XDtype); U, V, the k x k matrices, row_sq and
// every output are f32, row-major and contiguous; vt, uxt, gram_part,
// numv_part and the four ints after them are the wrapper's plan
// (ops/kernels/mu_fused.py: u_pass_plan). Returns the CUDA error of the
// launches (0 on success).
extern "C" int pycmf_mu_fused_u_pass_wide(
    int x_dtype, const void* X, const float* U, const float* V,
    const float* VtV, int n, int m, int k, int n_valid, float l1, float l2,
    float eps, int nt, int k_slices, float* Unew, float* numV, float* gramU,
    void* vt, void* uxt, float* gram_part, float* numv_part, int ld_vt,
    int ld_ux, int seg_rows, int n_seg, int device, void* stream) {
  using namespace pycmf;
  const UPassWork w{vt,    uxt,      gram_part, numv_part, ld_vt,
                    ld_ux, seg_rows, n_seg,     0,         0};
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MuWide epi{U, VtV, k, n_valid, l1, l2, eps};
  return launch_u_pass_wide(x_dtype, X, V, n, m, k, nt, k_slices, epi, Unew,
                            numV, gramU, w, st);
}

extern "C" int pycmf_newton_fused_u_pass_wide(
    int x_dtype, const void* X, const float* U, const float* V,
    const float* BtB, const float* Hinv, const float* row_sq, int n, int m,
    int k, float l1, float l2, int trials, int non_negative, int nt,
    int k_slices, float* Unew, float* numV, float* gramU, void* vt,
    void* uxt, float* gram_part, float* numv_part, int ld_vt, int ld_ux,
    int seg_rows, int n_seg, int device, void* stream) {
  using namespace pycmf;
  const UPassWork w{vt,    uxt,      gram_part, numv_part, ld_vt,
                    ld_ux, seg_rows, n_seg,     0,         0};
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NewtonWide epi{U, BtB, Hinv, row_sq, k, l1, l2, trials, non_negative};
  return launch_u_pass_wide(x_dtype, X, V, n, m, k, nt, k_slices, epi, Unew,
                            numV, gramU, w, st);
}
