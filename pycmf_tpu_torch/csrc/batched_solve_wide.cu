// Batched k x k SPD solve for 33 <= k <= 64 on Hopper (sm_90a), called
// through ctypes: the wide route of K5 (csrc/batched_solve.cu holds its
// narrow route, k <= 32, and the blocked routes above).
//
// Replaces: pycmf_tpu/ops/pallas/batched_solve.py:batched_spd_solve
// (TPU kernel K5) at 32 < k <= 64, where the TPU kernel takes
// jnp.linalg.solve: (H[i] + Hs) d[i] = G[i] for every i < p, Hs an
// optional k x k matrix shared by all systems, by an unpivoted Cholesky
// L L^T in f32; a matrix that is not positive definite yields NaN in its
// own row of d, never an error or a host sync. Every sum has a fixed
// order, so a call repeats bit for bit; no atomics, no allocation, no
// host sync: capturable in a CUDA graph. No TF32: every product is an
// f32 FMA on the CUDA cores.
//
// Bound: bytes (at k = 40, 11314 systems' lower triangles in 32-byte
// sectors, g and d: 47 MB, 0.014 ms at an H100's 3.35 TB/s; chip_smoke.py:
// spd_bytes); the work is bound by instruction throughput: k^3/6
// FMAs per system, k^3/192 a lane, executed as ~k^2/2 + 500 a lane (the
// static loops run each row's full width), plus each step's column reads
// and its serial chain (publish, read the pivot, rsqrt, scale).
//
// The port solves 32 < k <= 64 here (the TPU kernel unrolls up to 32,
// pycmf_tpu/ops/pallas/batched_solve.py:74) so that a fit at k <= 64 makes
// no library call a CUDA graph capture would refuse.
//
// Design: the narrow route's frame (csrc/batched_solve.cu), a warp per
// system in registers, KP = k rounded up to 4 at compile time (rows
// k..KP-1 an identity block). The triangle is folded across the lanes:
// lane l holds row l and, for l < KP - 32, row KP - 1 - l, so no lane
// holds more than KP + 1 entries of it; the registers are a 32-wide and a
// KP-wide row (96 floats at KP = 64: a register index must be known at
// compile time, so each row keeps its full width). Each step of the
// right-looking factorization on [H | g] publishes column j, reads it back
// as 16-byte broadcasts and updates each row only right of j: the row of
// the lane to column 31, the folded row to KP - 1; the pivot's reciprocal
// is one rsqrt.approx.ftz (NaN for a pivot below FLT_MIN: one that is not
// positive, or a subnormal one, which the ftz form would flush to 0 and
// take to inf). Each lane reads its
// rows straight from device memory into registers (16-byte loads where
// k % 4 == 0 and H is aligned) and adds H_shared from the block's copy in
// shared memory (the same f32 sum as H + Hs beforehand). A copy of each
// system into shared memory by coalesced cp.async was slower on an NVIDIA
// H100 80GB HBM3, 700.00 W, at every shape timed: the load is not what
// holds the kernel. L's packed triangle then goes to shared memory for
// the back substitution (the narrow route's). A persistent grid of one
// wave of kWideWarps-warp blocks. A library of its own, so that nvcc
// builds it beside csrc/batched_solve.cu. What is left of its speed:
// ROADMAP B5.
#include "common.cuh"

#include <algorithm>
#include <cfloat>

namespace pycmf {

constexpr int kWideMaxK = 64;
// Warps a block: 4 was the fastest of 1, 2, 3, 4 and 6, or within 2.9% of
// it, at every shape timed (k 33-64, 20 to 30000 systems) on an NVIDIA
// H100 80GB HBM3, 700.00 W. Blocks an SM the registers must allow: 3, for
// 168 registers a thread, where KP = 64 spills 500 bytes (at 128 registers
// the rows spill more, at 255 fewer warps share an SM; both slower there)
constexpr int kWideWarps = 4;
constexpr int kWideMinBlocks = 3;

// Row map (ops/kernels/batched_solve.py:wide_rows mirrors it): lane l holds
// row l and, for l < KP - 32, row KP - 1 - l, so each lane holds at most
// KP + 1 entries of the lower triangle.
__host__ __device__ constexpr int wide_pairs(int KP) { return KP - 32; }
// Per warp: two column buffers (column j's KP entries, g_j at KP) and L's
// lower triangle packed without its diagonal (row i at i (i - 1) / 2);
// per block, with H_shared, Hs's rows at stride wide_ld.
__host__ __device__ constexpr int wide_cb(int KP) { return KP + 4; }
__host__ __device__ constexpr int wide_warp_floats(int KP) {
  return 2 * wide_cb(KP) + ((KP * (KP - 1) / 2 + 3) & ~3);
}
// Hs's rows in shared memory: a stride whose quarter is odd with 16-byte
// reads (vec: a row's float4s land in distinct banks), else an odd one.
__host__ __device__ inline int wide_ld(int k, int vec) {
  return !vec ? k | 1 : (k / 4) & 1 ? k : k + 4;
}
inline size_t wide_smem_bytes(int KP, bool shared) {
  return sizeof(float) *
         ((shared ? KP * (KP + 4) : 0) + kWideWarps * wide_warp_floats(KP));
}

template <int KP>
__global__ void __launch_bounds__(kWideWarps * 32, kWideMinBlocks)
    chol_solve_wide_kernel(const float* __restrict__ H,
                           const float* __restrict__ Hshared,
                           const float* __restrict__ G, int p, int k, int vec,
                           float* __restrict__ D) {
  constexpr int CB = wide_cb(KP);
  extern __shared__ __align__(16) float wide_smem[];
  constexpr int warps = kWideWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int kk = k * k, ld = wide_ld(k, vec);
  const bool shared = Hshared != nullptr;
  float* hsh = wide_smem;  // Hs, rows at stride ld
  float* cbuf = wide_smem + (shared ? KP * (KP + 4) : 0) +
                warp * wide_warp_floats(KP);
  float* Lp = cbuf + 2 * CB;
  if (shared) {  // every copy in flight at once
    for (int i = warp; i < k; i += warps)
      for (int c = lane; c < k; c += 32)
        cp_async4(hsh + i * ld + c, Hshared + i * k + c);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const int stride = gridDim.x * warps;
  int sys = blockIdx.x * warps + warp;
  if (sys >= p) return;  // the whole warp leaves together
  const int R = KP - 1 - lane;  // the second row, where lane < KP - 32
  const bool has2 = lane < wide_pairs(KP), real2 = has2 && R < k;

  for (; sys < p; sys += stride) {
    // row `lane` (columns 0..31; those right of the diagonal are read and
    // updated, never used) and row R (columns 0..R, zero right of it; the
    // identity where R >= k, so the factorization runs KP steps with no
    // test of k), straight from device memory, then + Hs: the same f32
    // sum as the sum taken beforehand
    float r1[32], r2[KP];
    const float* h = H + (size_t)sys * kk;
    if (vec) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(h + lane * k) + q);
        r1[4 * q] = v.x, r1[4 * q + 1] = v.y, r1[4 * q + 2] = v.z,
               r1[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < KP / 4; ++q) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (real2 && 4 * q <= R)
          v = __ldg(reinterpret_cast<const float4*>(h + R * k) + q);
        r2[4 * q] = v.x, r2[4 * q + 1] = v.y, r2[4 * q + 2] = v.z,
               r2[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) r1[c] = __ldg(h + lane * k + c);
#pragma unroll
      for (int c = 0; c < KP; ++c)
        r2[c] = real2 && c <= R ? __ldg(h + R * k + c) : 0.f;
    }
    if (shared) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(hsh + lane * ld + 4 * q);
          r1[4 * q] += v.x, r1[4 * q + 1] += v.y, r1[4 * q + 2] += v.z,
              r1[4 * q + 3] += v.w;
        }
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          if (real2 && 4 * q <= R) {
            const float4 v =
                *reinterpret_cast<const float4*>(hsh + R * ld + 4 * q);
            r2[4 * q] += v.x, r2[4 * q + 1] += v.y, r2[4 * q + 2] += v.z,
                r2[4 * q + 3] += v.w;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 32; ++c) r1[c] += hsh[lane * ld + c];
#pragma unroll
        for (int c = 0; c < KP; ++c)
          if (real2 && c <= R) r2[c] += hsh[R * ld + c];
      }
    }
    if (has2 && !real2) {
#pragma unroll
      for (int c = 0; c < KP; ++c) r2[c] = c == R ? 1.f : 0.f;
    }
    float b1 = G[(size_t)sys * k + lane];  // g, then what steps j < i leave
    float b2 = real2 ? G[(size_t)sys * k + R] : 0.f;

    // Right-looking, on [H | g]. At step j each lane publishes its rows'
    // entries of column j (lanes above j publish entries right of the
    // diagonal, which nothing reads) and the owner of row j its g_j; every
    // lane reads the column back as 16-byte broadcasts, takes 1 / L[j][j]
    // by one rsqrt (NaN for a non-positive pivot), and for each of its
    // rows i > j with l = A[i][j] / L[j][j] updates A[i][c] -= (l /
    // L[j][j]) A[c][j] for j < c <= i and g_i -= l y_j. Row `lane` ends at
    // column 31, row R at KP - 1.
    float inv1 = 0.f, y1 = 0.f, inv2 = 0.f, y2 = 0.f;  // per row: 1/L_ii, y_i
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      float* cb = cbuf + (j & 1) * CB;
      if (j < 32) cb[lane] = r1[j & 31];
      if (has2) cb[R] = r2[j];
      if (j < 32 ? lane == j : lane == KP - 1 - j) cb[KP] = j < 32 ? b1 : b2;
      __syncwarp();
      const float ajj = cb[j], bj = cb[KP];
      float inv;  // NaN below FLT_MIN, where ftz would give inf
      asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(ajj));
      inv = ajj >= FLT_MIN ? inv : __int_as_float(0x7fc00000);
      const float yj = bj * inv;
      float w1 = 0.f;
      if (j < 32) {
        const float l1 = r1[j & 31] * inv;
        r1[j & 31] = l1;
        w1 = l1 * inv;
        b1 -= l1 * yj;
        if (lane == j) inv1 = inv, y1 = yj;
      }
      const float l2 = r2[j] * inv;
      r2[j] = l2;
      const float w2 = l2 * inv;
      b2 -= l2 * yj;
      if (j >= 32 && lane == KP - 1 - j) inv2 = inv, y2 = yj;
#pragma unroll
      for (int c0 = (j + 1) & ~3; c0 < KP; c0 += 4) {
        const float4 q = *reinterpret_cast<const float4*>(cb + c0);
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + u;
          if (c <= j) continue;
          if (c < 32) r1[c & 31] -= w1 * v[u];
          r2[c] -= w2 * v[u];
        }
      }
    }

    // L's rows below the diagonal to the packed triangle, then L^T x = y
    // from the last row up: x_t = acc_t / L[t][t] by a shuffle from the
    // owner of row t, and each row i < t removes L[t][i] x_t from its acc
#pragma unroll
    for (int c = 0; c < 31; ++c)
      if (c < lane) Lp[lane * (lane - 1) / 2 + c] = r1[c];
    if (has2) {
      float* row = Lp + R * (R - 1) / 2;
#pragma unroll
      for (int c = 0; c < KP - 1; ++c)
        if (c < R) row[c] = r2[c];
    }
    __syncwarp();
    float acc1 = y1, acc2 = y2, x1 = 0.f, x2 = 0.f;
#pragma unroll
    for (int t = KP - 1; t >= 0; --t) {
      const int owner = t < 32 ? t : KP - 1 - t;
      const float xt =
          __shfl_sync(kFull, t < 32 ? acc1 * inv1 : acc2 * inv2, owner);
      if (lane == owner) {
        if (t < 32) x1 = xt;
        else x2 = xt;
      }
      const float* row = Lp + t * (t - 1) / 2;
      if (lane < t) acc1 -= row[lane] * xt;
      if (t > 32 && has2 && R < t) acc2 -= row[R] * xt;
    }
    D[(size_t)sys * k + lane] = x1;
    if (real2) D[(size_t)sys * k + R] = x2;
    __syncwarp();  // the buffers just read are written for the next system
  }
}

namespace {
// cudaFuncSetAttribute done and blocks per SM, per device and instantiation
// of the wide route (internal linkage: this library's own)
bool wide_attr_done[16][8];
int wide_blocks[16][8][2];
}  // namespace

// One launch of chol_solve_wide_kernel<KP>: a persistent grid of one wave.
template <int KP>
int launch_wide(const float* H, const float* Hs, const float* G, int p, int k,
                int vec, float* D, int device, cudaStream_t st) {
  auto kern = chol_solve_wide_kernel<KP>;
  const int ki = (KP - 36) / 4;
  const size_t smem = wide_smem_bytes(KP, Hs != nullptr);
  if (smem > (size_t)smem_optin(device))
    return (int)cudaErrorInvalidValue;
  bool& done = wide_attr_done[device][ki];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin(device));
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  int& per_sm = wide_blocks[device][ki][Hs != nullptr];
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  kWideWarps * 32, smem);
    if (per_sm < 1) per_sm = 1;
  }
  const int grid = std::min(ceil_div(p, kWideWarps), sm_count() * per_sm);
  kern<<<grid, kWideWarps * 32, smem, st>>>(H, Hs, G, p, k, vec, D);
  return (int)cudaGetLastError();
}

// Call f(std::integral_constant<int, KP>) with KP = pad_k(k), 36 <= KP <= 64.
template <int KP = 36, typename F>
int with_wide_kp(int k, F&& f) {
  if constexpr (KP < kWideMaxK) {
    if (pad_k(k) != KP) return with_wide_kp<KP + 4>(k, f);
  }
  return f(std::integral_constant<int, KP>{});
}

}  // namespace pycmf

// H (p, k, k), G (p, k) and D (p, k): f32, row-major, contiguous,
// 33 <= k <= 64; H_shared (k, k) f32 contiguous, or null. Makes `device`
// current for the launch. Returns the CUDA error of the launch (0 on
// success), cudaErrorInvalidValue for arguments it refuses.
extern "C" int pycmf_batched_wide_solve(const float* H, const float* H_shared,
                                        const float* G, int p, int k,
                                        float* D, int device, void* stream) {
  using namespace pycmf;
  if (p < 1 || k <= kMaxK || k > kWideMaxK || device < 0 || device >= 16)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  return with_wide_kp(k, [&](auto kp) {
    return launch_wide<decltype(kp)::value>(H, H_shared, G, p, k, vec, D,
                                            device, st);
  });
}
