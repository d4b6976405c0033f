// Fused MU U-pass for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/mu_fused.py:fused_mu_u_pass (TPU kernel K1).
//
//   U_new = U * (X Vx) / (U VtV + l1 + l2 U + eps), rows >= n_valid zeroed
//   numV  = X^T round_X(U_new)          (m, k)
//   gramU = U_new^T U_new               (k, k)
//
// Bound: bytes of X. At the main-path shape (X 30000 x 11314 bf16, k = 20)
// X is 679 MB and everything else is under 2 MB: one pass over X is 0.20 ms
// at 3.35 TB/s, against 0.03 ms of bf16 tensor-core work (4 n m k flops).
// e4m3 X (fp8 storage) is 339 MB, 0.10 ms per pass, and converts each X
// value to bf16 in registers (u_pass_common.cuh: e4m3x2_to_bf16x2) before
// the same bf16 tensor-core products, in stages that hold the bf16 form's
// chains in its order (the row sweep's of the bf16 form's bytes, 128 rows
// a CTA): an e4m3 call equals the bf16 call on X widened to bf16 bit for
// bit.
//
// Design: the TPU kernel walks a sequential grid and carries the (k, m)
// X^T U_new accumulator in VMEM across it. Hopper blocks run in parallel and
// in no order, so the call is split (u_pass_common.cuh): a row sweep that
// computes X V on tensor cores for 64 rows per CTA and runs this file's
// epilogue (the MU ratio) on them, then a column sweep that computes
// X^T U_new on tensor cores in row segments, partial sums reduced in a fixed
// order. Both sweeps stream X through cp.async rings, so X is read twice per
// call (1.36 GB at the main-path shape); the two-pass bound is 0.41 ms.
// k > 32 is the wide route's (u_pass_wide.cu: X read once per sweep at any
// k <= 128, the ratio in a kernel of its own). f32 X (the estimator's default dtype: 1.358 GB at
// the main-path shape, 0.41 ms per pass) at k <= 32 and m up to the plan's
// crossover takes the cluster route instead (u_pass_cluster.cuh): X read
// once, the ratio run by the CTA that owns each row.
// Rows >= n_valid are zeroed, so a 0 * 0 / 0 = NaN padding row cannot reach
// the factors or the partial sums.
#include "u_pass_cluster.cuh"

namespace pycmf {

// U_new = U * XV / (U VtV + l1 + l2 U + eps), zero for rows >= n_valid.
struct MuEpi {
  const float* U;
  const float* VtV;
  int k, n_valid;
  float l1, l2, eps;
  static constexpr int kMats = 1;

  template <int NP>
  __device__ void stage(float* mats) const {
    stage_kxk<NP>(VtV, k, mats);
  }

  template <int NP>
  __device__ float row(int row, float xv, const float* mats) const {
    const int lane = threadIdx.x & 31;
    const float u = lane < k ? U[(size_t)row * k + lane] : 0.f;
    const float den = lane_matvec<NP>(u, mats, k);
    const float un = u * xv / (den + l1 + l2 * u + eps);
    return row < n_valid ? un : 0.f;
  }

  // Brings row's operands into L2 ahead of row() (u_pass_cluster.cuh).
  __device__ void prefetch(int row) const {
    const float* u = U + (size_t)row * k;
    prefetch_l2(u);
    prefetch_l2(u + k - 1);
  }

};

}  // namespace pycmf

// x_dtype: X's dtype code (common.cuh: XDtype; 0 f32, 1 bf16, 2 e4m3).
// U, V, VtV and every output are f32,
// row-major and contiguous. clusters and slice_cols (the cluster route of
// f32 X; 0 for the two-sweep routes), vt, uxt, gram_part, numv_part and the
// four ints after them are the wrapper's plan (ops/kernels/mu_fused.py:
// u_pass_plan); the launches go to `stream` on `device`.
// Returns the CUDA error of the launches (0 on success).
extern "C" int pycmf_mu_fused_u_pass(
    int x_dtype, const void* X, const float* U, const float* V,
    const float* VtV, int n, int m, int k, int n_valid, float l1, float l2,
    float eps, int clusters, int slice_cols, float* Unew, float* numV,
    float* gramU, void* vt, void* uxt, float* gram_part, float* numv_part,
    int ld_vt, int ld_ux, int seg_rows, int n_seg, int device, void* stream) {
  using namespace pycmf;
  const UPassWork w{vt,    uxt,      gram_part, numv_part, ld_vt,
                    ld_ux, seg_rows, n_seg,     clusters,  slice_cols};
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MuEpi epi{U, VtV, k, n_valid, l1, l2, eps};
  return launch_u_pass_route(x_dtype, X, V, n, m, k, epi, Unew, numV, gramU,
                             w, st);
}

// Clusters of the f32 cluster route at k, with slices of slice_cols
// columns, that `device` holds at once (written to *out); returns the CUDA
// error of the query.
extern "C" int pycmf_u_pass_cluster_occupancy(int k, int slice_cols,
                                              int device, int* out) {
  using namespace pycmf;
  DeviceGuard guard(device);
  return cluster_occupancy<MuEpi>(k, slice_cols, out);
}
