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
// 2k + 5 flops, far below the card's ~20 f32 FMAs per byte of DRAM. At the
// main path's shapes (11314 x 20, 804414 x 20 at the RCV1 shape) a call
// moves 2.7 MB or 193 MB: the small one is a launch, not a DRAM stream.
//
// Design (k <= 32): a persistent grid of about one wave walks tiles of
// `rows` whole rows (the wrapper's plan, a multiple of 4 rows, at most
// kTileFloats floats). A tile of M and one of num are each one contiguous
// block, copied to shared memory by 16-byte cp.async (4-byte copies where a
// pointer is not 16-byte aligned) into a second stage while the block works
// on the first, so the next tile's loads overlap this tile's math. S is
// staged once per block; each thread keeps two columns of it in registers
// (KP = k rounded up to 4 at compile time, so the c-loop unrolls) and
// computes those two outputs of a row from the row read out of shared
// memory in 16-byte pieces, with 32-bit indices inside the tile. The
// outputs overwrite num's tile in place and leave as 16-byte stores.
// k > 32 keeps one thread per element with S and row i of M read through
// L1. M S is never written to device memory, and each output is the same
// fmaf chain over c in ascending order from 0 in both routes, so a call
// repeats bit for bit and the two routes agree with PR 6's kernel bit for
// bit.
#include "common.cuh"

#include <algorithm>

namespace pycmf {

constexpr int kMuThreads = 256;
constexpr int kTileFloats = 2560;  // floats of M (and of num) per tile stage

__global__ void __launch_bounds__(kMuThreads)
    mu_update_wide_kernel(const float* __restrict__ M,
                          const float* __restrict__ S,
                          const float* __restrict__ num, long long n, int k,
                          float l1, float l2, float eps,
                          float* __restrict__ out) {
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

// n floats global -> shared, asynchronously: 16-byte chunks when vec (both
// addresses 16-byte aligned), 4-byte copies for the rest.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n, bool vec) {
  int done = 0;
  if (vec) {
    const int chunks = n >> 2;
    for (int c = threadIdx.x; c < chunks; c += kMuThreads)
      cp_async16(dst + 4 * c, src + 4 * c);
    done = chunks << 2;
  }
  for (int e = done + threadIdx.x; e < n; e += kMuThreads)
    cp_async4(dst + e, src + e);
}

template <int KP, bool EXACT>  // EXACT: k == KP (tile rows 16-byte aligned)
__global__ void __launch_bounds__(kMuThreads)
    mu_update_tile_kernel(const float* __restrict__ M,
                          const float* __restrict__ S,
                          const float* __restrict__ num, int p, int k,
                          int rows, int n_tiles, int vec, float l1, float l2,
                          float eps, float* __restrict__ out) {
  constexpr int G = KP / 2;            // threads per row, two columns each
  constexpr int RPP = kMuThreads / G;  // rows per pass of the block
  __shared__ __align__(16) float tile[2][2][kTileFloats];  // [stage][M, num]
  __shared__ float ss[KP * KP];
  const int tid = threadIdx.x;
  int t = blockIdx.x;  // the grid is at most n_tiles blocks
  auto stage = [&](int tt, int st) {
    const size_t off = (size_t)tt * rows * k;
    const int n = min(rows, p - tt * rows) * k;
    stage_async(tile[st][0], M + off, n, vec);
    stage_async(tile[st][1], num + off, n, vec);
  };
  stage(t, 0);
  cp_async_commit();
  for (int e = tid; e < k * k; e += kMuThreads) ss[e] = S[e];
  __syncthreads();
  const int g = tid % G, rl = tid / G, j0 = 2 * g;
  float s0[KP], s1[KP];  // columns j0 and j0 + 1 of S (0 past k)
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    s0[c] = (c < k && j0 < k) ? ss[c * k + j0] : 0.f;
    s1[c] = (c < k && j0 + 1 < k) ? ss[c * k + j0 + 1] : 0.f;
  }

  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const int st = it & 1, nx = t + gridDim.x;
    if (nx < n_tiles) stage(nx, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nrows = min(rows, p - t * rows);
    const float* tm = tile[st][0];
    float* tn = tile[st][1];
    if (rl < RPP) {  // 256 % G threads sit out
      for (int r = rl; r < nrows; r += RPP) {
        const float* m = tm + r * k;
        float ms0 = 0.f, ms1 = 0.f;
#pragma unroll
        for (int c = 0; c < KP; c += 4) {
          float v[4];
          if constexpr (EXACT) {
            const float4 q = *reinterpret_cast<const float4*>(m + c);
            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = c + u < k ? m[c + u] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (EXACT || c + u < k) {
              ms0 = fmaf(v[u], s0[c + u], ms0);
              ms1 = fmaf(v[u], s1[c + u], ms1);
            }
          }
        }
        float* o = tn + r * k;
        if (j0 < k) {
          const float mij = m[j0];
          o[j0] = mij * o[j0] / (ms0 + l1 + l2 * mij + eps);
        }
        if (j0 + 1 < k) {
          const float mij = m[j0 + 1];
          o[j0 + 1] = mij * o[j0 + 1] / (ms1 + l1 + l2 * mij + eps);
        }
      }
    }
    __syncthreads();
    const size_t off = (size_t)t * rows * k;
    const int n = nrows * k;
    int done = 0;
    if (vec) {
      const int chunks = n >> 2;
      for (int c = tid; c < chunks; c += kMuThreads)
        reinterpret_cast<float4*>(out + off)[c] =
            reinterpret_cast<const float4*>(tn)[c];
      done = chunks << 2;
    }
    for (int e = done + tid; e < n; e += kMuThreads) out[off + e] = tn[e];
    __syncthreads();  // the stage is refilled by the next tile but one
  }
}

template <int KP, bool EXACT>
int mu_tile_blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mu_update_tile_kernel<KP, EXACT>, kMuThreads, 0);
    if (n < 1) n = 1;
  }
  return n;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace pycmf

// M, num, out (p, k) and S (k, k): f32, row-major, contiguous; k >= 1.
// rows: rows per tile for k <= 32 (the wrapper's plan: a multiple of 4,
// rows * k <= 2560; ignored above 32). Makes `device` current for the
// launch. Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_mu_update(const float* M, const float* S, const float* num,
                               int p, int k, int rows, float l1, float l2,
                               float eps, float* out, int device,
                               void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (p < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    const long long n = (long long)p * k;
    const int grid = (int)((n + kMuThreads - 1) / kMuThreads);
    mu_update_wide_kernel<<<grid, kMuThreads, 0, st>>>(M, S, num, n, k, l1,
                                                       l2, eps, out);
    return (int)cudaGetLastError();
  }
  if (rows < 4 || rows % 4 != 0 || rows * k > kTileFloats)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = ceil_div(p, rows);
  const int vec = aligned16(M) && aligned16(num) && aligned16(out);
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    auto launch = [&](auto exact) {
      constexpr bool E = decltype(exact)::value;
      const int grid =
          std::min(n_tiles, sm_count() * mu_tile_blocks_per_sm<KP, E>());
      mu_update_tile_kernel<KP, E><<<grid, kMuThreads, 0, st>>>(
          M, S, num, p, k, rows, n_tiles, vec, l1, l2, eps, out);
    };
    if (k == KP) launch(std::true_type{});
    else launch(std::false_type{});
  });
  return (int)cudaGetLastError();
}
