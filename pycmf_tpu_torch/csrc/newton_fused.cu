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
// shape against a few MB of everything else; the per-row line search is
// k-wide work done once per row.
//
// Design: the same phases as mu_fused.cu (u_pass_common.cuh), with this
// file's row epilogue doing the Newton step and line search: one row per
// warp, one factor component per lane; the k x k products go through warp
// shuffles against BtB and Hinv in shared memory, and phi's sums through
// butterfly reductions that leave identical bits on every lane, so the
// accept test is warp-uniform. All per-row arithmetic is f32 FMA on the
// CUDA cores: no TF32, whose ~1e-3 relative error swamps the line search's
// small late decreases. Steps 2^-j are exact (ldexpf). Reads X twice per
// call.
#include "u_pass_common.cuh"

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

// One warp per row, one component per lane: the Newton step and the
// backtracking line search of the header comment.
template <typename XT, int KP>
__global__ void __launch_bounds__(kThreads)
    newton_epilogue_kernel(const float* __restrict__ xv_part, int n_seg,
                           const float* __restrict__ U,
                           const float* __restrict__ BtB,
                           const float* __restrict__ Hinv,
                           const float* __restrict__ row_sq, int n, int k,
                           float l1, float l2, int trials, int non_negative,
                           float* __restrict__ Unew, float* __restrict__ Ux,
                           float* __restrict__ gram_part) {
  __shared__ float Bs[KP * KP];
  __shared__ float Hs[KP * KP];
  __shared__ float Us[kRowsPerBlock * KP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  stage_kxk<KP>(BtB, k, Bs);
  stage_kxk<KP>(Hinv, k, Hs);
  __syncthreads();
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int row = row0 + t;
    const bool live = row < n && lane < k;
    const float db = row < n ? gather_xv(xv_part, n_seg, n, KP, row, k) : 0.f;
    const float u = live ? U[(size_t)row * k + lane] : 0.f;
    const float rs = row < n ? row_sq[row] : 0.f;
    const float sgn = u > 0.f ? 1.f : (u < 0.f ? -1.f : 0.f);
    const float g = lane_matvec<KP>(u, Bs, k) - db + l1 * sgn + l2 * u;
    const float d = lane_matvec<KP>(g, Hs, k);
    float best;
    if (trials <= 0) {
      best = u - d;
      if (non_negative) best = fmaxf(best, 0.f);
    } else {
      const float phi0 = phi_row<KP>(u, db, rs, Bs, k, l1, l2);
      best = u;
      for (int j = 0; j < trials; ++j) {
        float mc = u - ldexpf(1.f, -j) * d;
        if (non_negative) mc = fmaxf(mc, 0.f);
        if (phi_row<KP>(mc, db, rs, Bs, k, l1, l2) < phi0) {  // warp-uniform
          best = mc;
          break;
        }
      }
    }
    if (!live) best = 0.f;
    emit_row<XT, KP>(best, row, n, k, Unew, Ux,
                     Us + (warp * kRowsPerWarp + t) * KP);
  }
  __syncthreads();
  gram_partial<KP>(Us, k, gram_part + (size_t)blockIdx.x * k * k);
}

template <typename XT, int KP>
void launch_newton(const void* X, const float* U, const void* Vx,
                   const float* BtB, const float* Hinv, const float* row_sq,
                   int n, int m, int k, float l1, float l2, int trials,
                   int non_negative, float* Unew, float* numV, float* gramU,
                   float* work, cudaStream_t st) {
  const XT* x = static_cast<const XT*>(X);
  const Workspace w = carve(work, n, m, k);
  launch_xv<XT, KP>(x, static_cast<const XT*>(Vx), n, m, k, w, st);
  newton_epilogue_kernel<XT, KP><<<row_blocks(n), kThreads, 0, st>>>(
      w.xv_part, col_segments(m, k), U, BtB, Hinv, row_sq, n, k, l1, l2,
      trials, non_negative, Unew, w.ux, w.gram_part);
  launch_numv_and_gram<XT, KP>(x, n, m, k, numV, gramU, w, st);
}

template <typename XT>
void dispatch_newton(const void* X, const float* U, const void* Vx,
                     const float* BtB, const float* Hinv, const float* row_sq,
                     int n, int m, int k, float l1, float l2, int trials,
                     int non_negative, float* Unew, float* numV, float* gramU,
                     float* work, cudaStream_t st) {
  with_kp(k, [&](auto kp) {
    launch_newton<XT, decltype(kp)::value>(X, U, Vx, BtB, Hinv, row_sq, n, m, k, l1, l2, trials, non_negative, Unew, numV, gramU, work, st);
  });
}

}  // namespace pycmf

// x_is_bf16: 0 for f32 X and Vx, 1 for bf16. U, BtB, Hinv, row_sq and every
// output are f32, row-major and contiguous; work holds
// pycmf_workspace_floats(n, m, k) floats. Returns the CUDA error of the
// launches (0 on success).
extern "C" int pycmf_newton_fused_u_pass(
    int x_is_bf16, const void* X, const float* U, const void* Vx,
    const float* BtB, const float* Hinv, const float* row_sq, int n, int m,
    int k, float l1, float l2, int trials, int non_negative, float* Unew,
    float* numV, float* gramU, float* work, void* stream) {
  using namespace pycmf;
  if (n < 1 || m < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    dispatch_newton<__nv_bfloat16>(X, U, Vx, BtB, Hinv, row_sq, n, m, k, l1,
                                   l2, trials, non_negative, Unew, numV,
                                   gramU, work, st);
  else
    dispatch_newton<float>(X, U, Vx, BtB, Hinv, row_sq, n, m, k, l1, l2,
                           trials, non_negative, Unew, numV, gramU, work, st);
  return (int)cudaGetLastError();
}
