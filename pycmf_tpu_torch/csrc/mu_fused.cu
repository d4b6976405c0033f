// Fused MU U-pass for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/mu_fused.py:fused_mu_u_pass (TPU kernel K1).
//
//   U_new = U * (X Vx) / (U VtV + l1 + l2 U + eps), rows >= n_valid zeroed
//   numV  = X^T round_X(U_new)          (m, k)
//   gramU = U_new^T U_new               (k, k)
//
// Bound: bytes of X. At the main-path shape (X 30000 x 11314 bf16, k = 20)
// X is 679 MB and everything else is under 2 MB, so the call is a stream
// over X with about 2k flops per element.
//
// Design: the TPU kernel walks a sequential grid and carries the (k, m)
// X^T U_new accumulator in VMEM across it. Hopper blocks run in parallel and
// in no order, so the call is split into phases (u_pass_common.cuh): X V in
// column segments with V resident in shared memory, this file's row
// epilogue (the MU ratio), then X^T U_new in row segments, with every
// partial sum reduced in a fixed order. It reads X twice per call (1.36 GB
// at the main-path shape); a single-pass version is later work. Rows
// >= n_valid are zeroed, so a 0 * 0 / 0 = NaN padding row cannot reach the
// factors or the partial sums.
#include "u_pass_common.cuh"

namespace pycmf {

// One warp per row, one component per lane:
// U_new = U * XV / (U VtV + l1 + l2 U + eps), zero for rows >= n_valid.
template <typename XT, int KP>
__global__ void __launch_bounds__(kThreads)
    mu_epilogue_kernel(const float* __restrict__ xv_part, int n_seg,
                       const float* __restrict__ U,
                       const float* __restrict__ VtV, int n, int k,
                       int n_valid, float l1, float l2, float eps,
                       float* __restrict__ Unew, float* __restrict__ Ux,
                       float* __restrict__ gram_part) {
  __shared__ float Ss[KP * KP];
  __shared__ float Us[kRowsPerBlock * KP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  stage_kxk<KP>(VtV, k, Ss);
  __syncthreads();
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int row = row0 + t;
    const bool live = row < n && lane < k;
    const float num = row < n ? gather_xv(xv_part, n_seg, n, KP, row, k) : 0.f;
    const float u = live ? U[(size_t)row * k + lane] : 0.f;
    const float den = lane_matvec<KP>(u, Ss, k);
    float un = u * num / (den + l1 + l2 * u + eps);
    if (!live || row >= n_valid) un = 0.f;
    emit_row<XT, KP>(un, row, n, k, Unew, Ux,
                     Us + (warp * kRowsPerWarp + t) * KP);
  }
  __syncthreads();
  gram_partial<KP>(Us, k, gram_part + (size_t)blockIdx.x * k * k);
}

template <typename XT, int KP>
void launch_mu(const void* X, const float* U, const void* Vx, const float* VtV,
               int n, int m, int k, int n_valid, float l1, float l2, float eps,
               float* Unew, float* numV, float* gramU, float* work,
               cudaStream_t st) {
  const XT* x = static_cast<const XT*>(X);
  const Workspace w = carve(work, n, m, k);
  launch_xv<XT, KP>(x, static_cast<const XT*>(Vx), n, m, k, w, st);
  mu_epilogue_kernel<XT, KP><<<row_blocks(n), kThreads, 0, st>>>(
      w.xv_part, col_segments(m, k), U, VtV, n, k, n_valid, l1, l2, eps, Unew,
      w.ux, w.gram_part);
  launch_numv_and_gram<XT, KP>(x, n, m, k, numV, gramU, w, st);
}

template <typename XT>
void dispatch_mu(const void* X, const float* U, const void* Vx,
                 const float* VtV, int n, int m, int k, int n_valid, float l1,
                 float l2, float eps, float* Unew, float* numV, float* gramU,
                 float* work, cudaStream_t st) {
  with_kp(k, [&](auto kp) {
    launch_mu<XT, decltype(kp)::value>(X, U, Vx, VtV, n, m, k, n_valid, l1, l2, eps, Unew, numV, gramU, work, st);
  });
}

}  // namespace pycmf

// x_is_bf16: 0 for f32 X and Vx, 1 for bf16. U, VtV and every output are
// f32, row-major and contiguous; work holds pycmf_workspace_floats(n, m, k)
// floats. Returns the CUDA error of the launches (0 on success).
extern "C" int pycmf_mu_fused_u_pass(int x_is_bf16, const void* X,
                                     const float* U, const void* Vx,
                                     const float* VtV, int n, int m, int k,
                                     int n_valid, float l1, float l2,
                                     float eps, float* Unew, float* numV,
                                     float* gramU, float* work, void* stream) {
  using namespace pycmf;
  if (n < 1 || m < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    dispatch_mu<__nv_bfloat16>(X, U, Vx, VtV, n, m, k, n_valid, l1, l2, eps,
                               Unew, numV, gramU, work, st);
  else
    dispatch_mu<float>(X, U, Vx, VtV, n, m, k, n_valid, l1, l2, eps, Unew,
                       numV, gramU, work, st);
  return (int)cudaGetLastError();
}
