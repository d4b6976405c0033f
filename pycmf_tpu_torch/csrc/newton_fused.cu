// Fused Newton U-pass (linear link, shared Hessian) for Hopper (sm_90a),
// called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/newton_fused.py:fused_newton_linear_u_pass
// (TPU kernel K2).
//
// Per row i of X (n, m), with DB = X Vx:
//   g   = U_i BtB - DB_i + l1 sign(U_i) + l2 U_i
//   d   = g Hinv
//   phi(mc) = l1 |mc|_1 + l2/2 |mc|^2 + (row_sq_i - 2 <DB_i, mc> + mc BtB mc^T)/2
//   U_new_i = the first proj(U_i - 2^-j d), j = 0 .. trials-1, whose phi is
//             strictly below phi(U_i) (slot 0 unprojected); U_i if none is.
// then numV = X^T round_X(U_new) and gramU = U_new^T U_new, as in mu_fused.cu.
//
// Bound: bytes of X, as for the MU pass: 679 MB of bf16 X at the main-path
// shape (0.20 ms per pass; e4m3 X, contracted in bf16 as in mu_fused.cu:
// 339 MB, 0.10 ms) against a few MB of everything else; the per-row
// line search is k-wide work done once per row.
//
// Design: the sweeps of mu_fused.cu (u_pass_common.cuh: X V and X^T U_new on
// tensor cores, X through cp.async rings, read twice per call), with this
// file's row epilogue run by the row sweep on the X V still in its
// registers: one row per warp, one factor component per lane; the k x k
// products go through warp shuffles against BtB and Hinv in shared memory,
// and phi's sums through butterfly reductions that leave identical bits on
// every lane, so the accept test is warp-uniform. All per-row arithmetic is
// f32 FMA on the CUDA cores: no TF32, whose ~1e-3 relative error swamps the
// line search's small late decreases. Steps 2^-j are exact (ldexpf).
// k > 32 is the wide route's (u_pass_wide.cu): the same step and line
// search on tiles of rows in a kernel of its own, its k-term products
// summed in f64. f32 X at k <= 32
// takes the cluster route of mu_fused.cu (u_pass_cluster.cuh), this
// file's row() run by the CTA that owns each row.
#include "u_pass_cluster.cuh"

namespace pycmf {

template <int KP>
__device__ __forceinline__ float phi_row(float mc, float db, float rs,
                                         const float* Bs, int k, float l1,
                                         float l2) {
  const float quad = warp_sum(lane_matvec<KP>(mc, Bs, k) * mc);
  const float lin = warp_sum(db * mc);
  const float pen = l1 * warp_sum(fabsf(mc)) + 0.5f * l2 * warp_sum(mc * mc);
  return pen + 0.5f * (rs - 2.0f * lin + quad);
}

// The Newton step and backtracking line search of the header comment.
struct NewtonEpi {
  const float* U;
  const float* BtB;
  const float* Hinv;
  const float* row_sq;
  int k;
  float l1, l2;
  int trials, non_negative;
  static constexpr int kMats = 2;

  template <int NP>
  __device__ void stage(float* mats) const {
    stage_kxk<NP>(BtB, k, mats);
    stage_kxk<NP>(Hinv, k, mats + NP * NP);
  }

  template <int NP>
  __device__ float row(int row, float db, const float* mats) const {
    const float* Bs = mats;
    const float* Hs = mats + NP * NP;
    const int lane = threadIdx.x & 31;
    const float u = lane < k ? U[(size_t)row * k + lane] : 0.f;
    const float rs = row_sq[row];
    const float sgn = u > 0.f ? 1.f : (u < 0.f ? -1.f : 0.f);
    const float g = lane_matvec<NP>(u, Bs, k) - db + l1 * sgn + l2 * u;
    const float d = lane_matvec<NP>(g, Hs, k);
    if (trials <= 0) {
      const float best = u - d;
      return non_negative ? fmaxf(best, 0.f) : best;
    }
    const float phi0 = phi_row<NP>(u, db, rs, Bs, k, l1, l2);
    for (int j = 0; j < trials; ++j) {
      float mc = u - ldexpf(1.f, -j) * d;
      if (non_negative) mc = fmaxf(mc, 0.f);
      if (phi_row<NP>(mc, db, rs, Bs, k, l1, l2) < phi0) return mc;  // uniform
    }
    return u;
  }

  // Brings row's operands into L2 ahead of row() (u_pass_cluster.cuh).
  __device__ void prefetch(int row) const {
    const float* u = U + (size_t)row * k;
    prefetch_l2(u);
    prefetch_l2(u + k - 1);
    prefetch_l2(row_sq + row);
  }
};

}  // namespace pycmf

// x_dtype: X's dtype code (common.cuh: XDtype; 0 f32, 1 bf16, 2 e4m3).
// U, V, BtB, Hinv, row_sq and every
// output are f32, row-major and contiguous. clusters, slice_cols, vt, uxt,
// gram_part, numv_part and the four ints after them are the wrapper's plan
// (ops/kernels/mu_fused.py: u_pass_plan); the launches go to `stream` on
// `device`. Returns the CUDA error of the launches (0 on success).
extern "C" int pycmf_newton_fused_u_pass(
    int x_dtype, const void* X, const float* U, const float* V,
    const float* BtB, const float* Hinv, const float* row_sq, int n, int m,
    int k, float l1, float l2, int trials, int non_negative, int clusters,
    int slice_cols, float* Unew, float* numV, float* gramU, void* vt,
    void* uxt, float* gram_part, float* numv_part, int ld_vt, int ld_ux,
    int seg_rows, int n_seg, int device, void* stream) {
  using namespace pycmf;
  const UPassWork w{vt,    uxt,      gram_part, numv_part, ld_vt,
                    ld_ux, seg_rows, n_seg,     clusters,  slice_cols};
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NewtonEpi epi{U, BtB, Hinv, row_sq, k, l1, l2, trials, non_negative};
  return launch_u_pass_route(x_dtype, X, V, n, m, k, epi, Unew, numV, gramU,
                             w, st);
}
