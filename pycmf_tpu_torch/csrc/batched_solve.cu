// Batched k x k SPD solve for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/batched_solve.py:batched_spd_solve
// (TPU kernel K5).
//
// For every system i < p: H[i] d[i] = G[i], with H[i] (k x k, row-major,
// symmetric positive definite; only its lower triangle is read) factored by
// an unpivoted Cholesky L L^T, then a forward and a back substitution, all
// in f32. A matrix that is not positive definite yields NaN in its row of
// d (sqrt of a non-positive pivot), never an error or a host sync.
//
// Bound: bytes. Each system reads k*k + k floats and writes k; the work is
// ~k^3/6 FMAs, about 1.4 k FMAs per byte read at k = 20, far below the
// card's ~20 f32 FMAs per byte of DRAM bandwidth. At p = 11314 (the V
// update of the main path) H is 18 MB: ~6 us at 3.35 TB/s.
//
// Design: one warp per system, lane i holding row i of the lower triangle
// in registers (k <= 32). The warp stages its system in shared memory with
// coalesced loads, then runs a right-looking factorization: at step j lane
// i scales its L[i][j] by the pivot's reciprocal (broadcast by a shuffle)
// and updates its trailing entries with L[c][j] taken by shuffles from
// lane c. The forward substitution broadcasts y_j from lane j; the back
// substitution sums L[t][i] x_t over lanes t > i with a butterfly
// reduction. Lanes >= k hold zeros. Every sum has a fixed order, so a call
// repeats bit for bit. The TPU kernel's lane-transposed (k*k, p) layout and
// identity padding are not carried over: each warp reads its own system
// and the ragged edge is a bounds check.
#include "common.cuh"

namespace pycmf {

constexpr int kSolveWarps = 8;

template <int KP>
__global__ void __launch_bounds__(kSolveWarps * 32)
    chol_solve_kernel(const float* __restrict__ H, const float* __restrict__ G,
                      int p, int k, float* __restrict__ D) {
  constexpr int LD = KP + 1;  // odd stride: lane i's row reads hit distinct banks
  __shared__ float Hs[kSolveWarps][KP * LD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kSolveWarps + warp;
  if (sys >= p) return;  // the whole warp leaves together
  const float* h = H + (size_t)sys * k * k;
  float* hs = Hs[warp];
  for (int e = lane; e < k * k; e += 32) hs[(e / k) * LD + e % k] = h[e];
  __syncwarp();

  float a[KP];  // row `lane` of the lower triangle, then of L
#pragma unroll
  for (int c = 0; c < KP; ++c)
    a[c] = (lane < k && c <= lane) ? hs[lane * LD + c] : 0.f;
  float b = lane < k ? G[(size_t)sys * k + lane] : 0.f;

  float inv_diag = 0.f;  // 1 / L[lane][lane]
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < k) {  // warp-uniform
      const float ljj = sqrtf(__shfl_sync(kFull, a[j], j));
      const float inv = 1.f / ljj;
      if (lane == j) inv_diag = inv;
      const float lij = lane > j ? a[j] * inv : (lane == j ? ljj : 0.f);
      a[j] = lij;
      // A[i][c] -= L[i][j] * L[c][j] for j < c <= i
#pragma unroll
      for (int c = j + 1; c < KP; ++c) {
        const float lcj = __shfl_sync(kFull, lij, c);
        if (c <= lane) a[c] -= lij * lcj;
      }
    }
  }

  // L y = b: at step j, lane j's b has had every earlier term removed.
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < k) {
      const float yj = __shfl_sync(kFull, b * inv_diag, j);
      if (lane == j) y = yj;
      if (lane > j) b -= a[j] * yj;
    }
  }

  // L^T x = y, from the last row up: x_i = (y_i - sum_{t>i} L[t][i] x_t) / L[i][i]
  float x = 0.f;
#pragma unroll
  for (int i = KP - 1; i >= 0; --i) {
    if (i < k) {
      const float s = warp_sum(lane > i ? a[i] * x : 0.f);
      if (lane == i) x = (y - s) * inv_diag;
    }
  }
  if (lane < k) D[(size_t)sys * k + lane] = x;
}

}  // namespace pycmf

// H (p, k, k), G (p, k) and D (p, k): f32, row-major, contiguous, 1 <= k <= 32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_batched_spd_solve(const float* H, const float* G, int p,
                                       int k, float* D, void* stream) {
  using namespace pycmf;
  if (p < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    chol_solve_kernel<KP><<<ceil_div(p, kSolveWarps), kSolveWarps * 32, 0, st>>>(
        H, G, p, k, D);
  });
  return (int)cudaGetLastError();
}
