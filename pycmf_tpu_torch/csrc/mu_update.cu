// Fused MU factor update for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/mu_update.py:fused_mu_update (TPU kernel
// K6), the ratio tail of every MU factor update:
//
//   out = M * num / (M S + l1 + l2 * M + eps)      M, num (p, k), S (k, k)
//
// all f32, any k >= 1.
//
// Bound: bytes. Each element reads M and num and writes out (12 bytes) for
// k + 4 flops, far below the card's ~20 f32 FMAs per byte of DRAM. At the
// main path's shapes (11314 x 20, 804414 x 20 at the RCV1 shape) a call
// moves 2.7 MB or 193 MB: the small one is a launch, not a DRAM stream.
//
// Design: one thread per element (i, j), S (k^2 floats every block shares)
// and row i of M (shared by its k threads) read through L1; M S is never
// written to device memory. Its value is the launches it saves on launch-bound paths:
// the plain version is a GEMM and four elementwise kernels. Sums over c
// run in a fixed order, so a call repeats bit for bit.
#include "common.cuh"

namespace pycmf {

constexpr int kMuThreads = 256;

__global__ void __launch_bounds__(kMuThreads)
    mu_update_kernel(const float* __restrict__ M, const float* __restrict__ S,
                     const float* __restrict__ num, long long n, int k,
                     float l1, float l2, float eps, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kMuThreads + threadIdx.x;
  if (idx >= n) return;
  const long long i = idx / k;
  const int j = (int)(idx - i * k);
  const float* m = M + i * k;
  float ms = 0.f;
  for (int c = 0; c < k; ++c) ms = fmaf(m[c], __ldg(S + (size_t)c * k + j), ms);
  const float mij = m[j];
  out[idx] = mij * num[idx] / (ms + l1 + l2 * mij + eps);
}

}  // namespace pycmf

// M, num, out (p, k) and S (k, k): f32, row-major, contiguous; k >= 1.
// Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_mu_update(const float* M, const float* S, const float* num,
                               int p, int k, float l1, float l2, float eps,
                               float* out, void* stream) {
  using namespace pycmf;
  if (p < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)p * k;
  const int grid = (int)((n + kMuThreads - 1) / kMuThreads);
  mu_update_kernel<<<grid, kMuThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      M, S, num, n, k, l1, l2, eps, out);
  return (int)cudaGetLastError();
}
