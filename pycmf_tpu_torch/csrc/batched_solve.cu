// Batched k x k SPD solve for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/batched_solve.py:batched_spd_solve
// (TPU kernel K5).
//
// For every system i < p: (H[i] + Hs) d[i] = G[i], with Hs an optional
// k x k matrix shared by all systems (the Gauss-Newton solve's H_shared;
// absent, the TPU kernel's H[i] d[i] = G[i]). The sum is symmetric positive
// definite; only its lower triangle decides the result. It is factored by
// an unpivoted Cholesky L L^T, with a forward and a back substitution, all
// in f32. A matrix that is not positive definite yields NaN in its own row
// of d (a non-positive pivot), never an error or a host sync.
//
// Bound: bytes. Each system reads k*k + k floats and writes k; the work is
// ~k^3/6 FMAs, about 1.4 k FMAs per byte read at k = 20, far below the
// card's ~20 f32 FMAs per byte of DRAM bandwidth. At p = 11314 (the V
// update of the main path) H is 18 MB: ~6 us at 3.35 TB/s.
//
// Design: a persistent grid of about one wave; each warp walks systems
// with a stride and holds one system at a time, lane i row i of the lower
// triangle in registers (k <= 32; KP = k rounded up to 4 at compile time,
// rows k..KP-1 an identity block, so every loop is unrolled with no test
// of k). The next system's k*k contiguous floats are copied into a second
// shared buffer of the warp by 16-byte cp.async (4-byte copies for odd k
// or an unaligned H) while the current one factors; Hs is staged once per
// block and added to each row as it leaves shared memory (the same f32 sum
// as H + Hs taken beforehand, so the same result bit for bit). The
// right-looking factorization runs on the augmented system [H | g], so
// y comes out of its own KP steps (no forward chain of its own): at step
// j each lane publishes its entry of column j (and lane j its g_j) to a
// shared buffer, every lane reads the column back as 16-byte broadcasts
// (no shuffle per entry) and takes 1 / L[j][j] by one rsqrtf. L's rows
// then go to shared memory, and the back substitution runs column by
// column: one shuffle of x_t, one read of L[t][i] and one FMA per step.
// A non-positive pivot gives NaN, which reaches every entry of its
// system's d and no other. Every sum has a fixed order, so a call repeats
// bit for bit. The TPU kernel's lane-transposed (k*k, p) layout and
// identity padding of p are not carried over: each warp reads its own
// system and the ragged edge is a bounds check.
//
// Wide route, 33 <= k <= 64 (the TPU kernel unrolls up to 32 and leaves
// wider k to jnp.linalg.solve, pycmf_tpu/ops/pallas/batched_solve.py:74;
// the port solves them here so that a fit at k <= 64 makes no library
// call a CUDA graph capture would refuse). Two rows per lane in registers
// would spill (128 floats of L at k = 64), so each warp holds its system in
// shared memory, rows at an odd stride (ld = k | 1: the 32 lanes' rows
// fall in 32 banks), lane i owning rows i and i + 32. The copy from
// device memory is coalesced (4-byte loads; H_shared, read through L1,
// added on the way, the same f32 sum as H + Hs beforehand). The same
// right-looking factorization on [H | g] then runs with loops over
// columns: at step j every lane scales its entries of column j by
// 1 / L[j][j] (one rsqrtf, NaN for a non-positive pivot) and updates its
// rows' trailing columns, row i only up to column i (row i < 32 stops at
// column 31: a loop bound the warp shares). The back substitution reads
// L[t][i] from shared memory as the narrow route does. One system per
// warp, two warps per block (33 KB of shared memory at k = 64, under the
// 48 KB a launch may take without an attribute), so 6 to 17 blocks share
// an SM and hide each other's loads. Bound: bytes (at k = 40, 11314
// systems read 72 MB, ~0.023 ms); the work is bound by instruction
// throughput, ~k^3/3 shared loads and stores per system.
//
// Block route, k > 64 (the reference's jnp.linalg.solve above its
// unrolled kernel, pycmf_tpu/ops/pallas/batched_solve.py:74-77), and LU
// route, any k (the full Hessian form's systems, which may be indefinite:
// the reference's jnp.linalg.solve at pycmf_tpu/solvers/newton.py:308).
// One CTA per system (block_solve_kernel; LU a template flag): the system,
// H + Hs as it is read, lies in shared memory at an odd row stride while
// it fits the block's opt-in limit (k <= ~240 in f32; `block_max_k`), and
// above that in a global scratch slot per CTA that the wrapper allocates
// (the CTAs then walk the systems with a stride). Cholesky: right-looking,
// unpivoted, on the lower triangle, with g carried along (forward
// substitution inside the factorization) and the back substitution on
// L^T; a non-positive pivot gives NaN. LU: partial pivoting as LAPACK's
// getrf (the pivot is the first row of largest |a| at or below the
// diagonal; whole rows swap, g with them), then back substitution on U; a
// zero or NaN pivot gives NaN. Either way NaN reaches every entry of its
// system's d and no other. The trailing update takes a row per warp and a
// column per lane. Each entry is updated by one thread in a fixed order,
// so a call repeats bit for bit; no host sync, no allocation.
// Bound: bytes (11314 systems at k = 100 read 462 MB, 0.138 ms); this
// simple route is bound by its ~3k barriers per system and, in global
// scratch, by the scratch's traffic (ROADMAP B5).
#include "common.cuh"

#include <algorithm>

namespace pycmf {

constexpr int kSolveWarps = 4;

template <int KP, bool SHARED>  // SHARED: Hs given
__global__ void __launch_bounds__(kSolveWarps * 32)
    chol_solve_kernel(const float* __restrict__ H,
                      const float* __restrict__ Hshared,
                      const float* __restrict__ G, int p, int k, int vec,
                      float* __restrict__ D) {
  constexpr int LDL = KP + 1;  // L's rows in shared memory: odd stride
  // per warp: two system buffers (the second takes the next system's copy;
  // the first then holds L, whose row KP - 1 lanes read 32 wide), and two
  // column buffers of 32 entries plus g_j
  __shared__ __align__(16) float hbuf[kSolveWarps][2][KP * LDL + 32];
  __shared__ __align__(16) float colbuf[kSolveWarps][2][36];
  __shared__ float hsh[SHARED ? KP * KP : 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int kk = k * k;
  if (SHARED)
    for (int e = threadIdx.x; e < kk; e += kSolveWarps * 32) hsh[e] = Hshared[e];
  __syncthreads();
  const int stride = gridDim.x * kSolveWarps;
  int sys = blockIdx.x * kSolveWarps + warp;
  if (sys >= p) return;  // the whole warp leaves together

  auto stage = [&](int s, float* dst) {
    const float* src = H + (size_t)s * kk;
    if (vec) {
      for (int c = lane; c < kk / 4; c += 32) cp_async16(dst + 4 * c, src + 4 * c);
    } else {
      for (int e = lane; e < kk; e += 32) cp_async4(dst + e, src + e);
    }
  };
  stage(sys, hbuf[warp][0]);
  cp_async_commit();
  float g_next = lane < k ? G[(size_t)sys * k + lane] : 0.f;

  for (int it = 0; sys < p; ++it, sys += stride) {
    const int nxt = sys + stride;
    if (nxt < p) stage(nxt, hbuf[warp][(it + 1) & 1]);
    cp_async_commit();
    float b = g_next;  // g, then what steps j < lane leave of it
    if (nxt < p && lane < k) g_next = G[(size_t)nxt * k + lane];
    cp_async_wait<1>();
    __syncwarp();
    float* cur = hbuf[warp][it & 1];

    // row `lane`, read whole (what lies above the diagonal, and past k in
    // the next row, only ever reaches entries above the diagonal, which
    // nothing reads); rows k..KP-1 of the identity, so the factorization
    // runs KP steps with no test of k
    float a[KP];
    if (lane < k) {
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        a[c] = cur[lane * k + c];
        if (SHARED) a[c] += hsh[lane * k + c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < KP; ++c) a[c] = c == lane ? 1.f : 0.f;
    }

    // Right-looking, on [H | g]. At step j lane i (>= j) publishes A[i][j]
    // and lane j its g_j; every lane reads the column as 16-byte
    // broadcasts, takes 1 / L[j][j] by one rsqrtf, and with
    // w = A[i][j] / L[j][j]^2 updates A[i][c] -= w A[c][j] for c > j and
    // g_i -= w g_j (= L[i][j] y_j). Entries above the diagonal take
    // updates that are never read; the lower triangle is L.
    float inv_diag = 0.f, y = 0.f;  // 1 / L[lane][lane], y[lane]
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      float* cb = colbuf[warp][j & 1];
      cb[lane] = a[j];
      if (lane == j) cb[32] = b;
      __syncwarp();
      const float ajj = cb[j], bj = cb[32];
      const float inv = ajj > 0.f ? rsqrtf(ajj) : __int_as_float(0x7fc00000);
      const float w = a[j] * (inv * inv), yj = bj * inv;
      if (lane == j) inv_diag = inv, y = yj;
      a[j] *= inv;  // L[lane][j] below the diagonal
      b -= w * bj;
#pragma unroll
      for (int c0 = (j + 1) & ~3; c0 < KP; c0 += 4) {
        const float4 q = *reinterpret_cast<const float4*>(cb + c0);
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c0 + u > j) a[c0 + u] -= w * v[u];
      }
    }

    // L's rows to shared memory (the buffer just factored), then
    // L^T x = y from the last row up: x_t = acc_t / L[t][t], and every
    // lane i < t removes L[t][i] x_t from its acc (lanes >= t, done, take
    // updates nothing reads)
    if (lane < KP) {
#pragma unroll
      for (int c = 0; c < KP; ++c) cur[lane * LDL + c] = a[c];
    }
    __syncwarp();
    float acc = y, x = 0.f;
#pragma unroll
    for (int t = KP - 1; t >= 0; --t) {
      const float xt = __shfl_sync(kFull, acc * inv_diag, t);
      if (lane == t) x = xt;
      acc -= cur[t * LDL + lane] * xt;
    }
    if (lane < k) D[(size_t)sys * k + lane] = x;
    __syncwarp();  // the buffer just read is refilled next iteration
  }
}

template <int KP, bool SHARED>
int solve_blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, chol_solve_kernel<KP, SHARED>, kSolveWarps * 32, 0);
    if (n < 1) n = 1;
  }
  return n;
}

constexpr int kWideMaxK = 64;
constexpr int kWideWarps = 2;

__host__ __device__ inline int wide_ld(int k) { return k | 1; }

template <bool SHARED>  // SHARED: Hs given
__global__ void __launch_bounds__(kWideWarps * 32)
    chol_solve_wide_kernel(const float* __restrict__ H,
                           const float* __restrict__ Hshared,
                           const float* __restrict__ G, int p, int k,
                           float* __restrict__ D) {
  extern __shared__ float wide_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWideWarps + warp;
  if (sys >= p) return;  // the whole warp leaves together
  const int ld = wide_ld(k), kk = k * k;
  float* S = wide_smem + warp * k * ld;
  const float* src = H + (size_t)sys * kk;
  // the system, row-major, into rows of stride ld: entry e = i * k + c;
  // k > 32, so a step of 32 entries wraps a row at most once
  for (int e = lane, i = 0, c = lane; e < kk; e += 32) {
    float v = src[e];
    if (SHARED) v += __ldg(Hshared + e);
    S[i * ld + c] = v;
    c += 32;
    if (c >= k) c -= k, ++i;
  }
  const int i1 = lane + 32;  // the lane's second row
  const bool has1 = i1 < k;
  float b0 = G[(size_t)sys * k + lane];  // g, then what steps j < i leave
  float b1 = has1 ? G[(size_t)sys * k + i1] : 0.f;
  float inv0 = 0.f, inv1 = 0.f, y0 = 0.f, y1 = 0.f;  // per row: 1/L_ii, y_i
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    const float ajj = S[j * ld + j];
    const float inv = ajj > 0.f ? rsqrtf(ajj) : __int_as_float(0x7fc00000);
    const float bj = __shfl_sync(kFull, j < 32 ? b0 : b1, j & 31);
    const float yj = bj * inv;
    float l0 = 0.f, l1 = 0.f;  // L[i][j] of the lane's rows below j
    if (lane > j) {
      l0 = S[lane * ld + j] * inv;
      S[lane * ld + j] = l0;
      b0 -= l0 * yj;
    }
    if (has1 && i1 > j) {
      l1 = S[i1 * ld + j] * inv;
      S[i1 * ld + j] = l1;
      b1 -= l1 * yj;
    }
    if (lane == j) inv0 = inv, y0 = yj;
    if (i1 == j) inv1 = inv, y1 = yj;
    __syncwarp();
    // A[i][c] -= L[i][j] L[c][j] for j < c <= i (rows at or above j take
    // l = 0, and entries above the diagonal take updates nothing reads)
    for (int c = j + 1; c < k; ++c) {
      const float lc = S[c * ld + j];
      if (c < 32) S[lane * ld + c] -= l0 * lc;
      if (has1) S[i1 * ld + c] -= l1 * lc;
    }
    __syncwarp();
  }
  // L^T x = y from the last row up, as the narrow route
  float acc0 = y0, acc1 = y1, x0 = 0.f, x1 = 0.f;
  for (int t = k - 1; t >= 0; --t) {
    const float xt =
        __shfl_sync(kFull, t < 32 ? acc0 * inv0 : acc1 * inv1, t & 31);
    if (lane == t) x0 = xt;
    if (i1 == t) x1 = xt;
    if (lane < t) acc0 -= S[t * ld + lane] * xt;
    if (has1 && i1 < t) acc1 -= S[t * ld + i1] * xt;
  }
  D[(size_t)sys * k + lane] = x0;
  if (has1) D[(size_t)sys * k + i1] = x1;
}


// ---- block and LU routes: one CTA per system -----------------------------

constexpr int kBlockThreads = 256;

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// Shared floats of one CTA besides the system: g, the pivots' reciprocals
// (or 1 / L_jj) and the pivot search's per-warp values and rows.
__host__ __device__ inline int block_aux_floats(int k) {
  return 2 * round4(k) + 64;
}
__host__ __device__ inline size_t block_system_floats(int k) {
  return (size_t)k * (k | 1);
}

// (value, row) with the larger value, the smaller row on a tie; NaN never
// wins (every comparison with it is false).
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) v = v2, i = i2;
}

template <bool LU, bool SHARED>  // SHARED: Hs given
__global__ void __launch_bounds__(kBlockThreads)
    block_solve_kernel(const float* __restrict__ H,
                       const float* __restrict__ Hshared,
                       const float* __restrict__ G, int p, int k,
                       float* __restrict__ D, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float block_smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const int ld = k | 1, kr = round4(k);
  float* b = block_smem;         // g, then y, then back substitution's rest
  float* inv = b + kr;           // 1 / pivot of each column
  float* red_v = inv + kr;       // pivot search: each warp's best
  int* red_i = reinterpret_cast<int*>(red_v + 32);
  float* S = scratch ? scratch + (size_t)blockIdx.x * block_system_floats(k)
                     : red_v + 64;
  const float qnan = __int_as_float(0x7fc00000);
  const size_t kk = (size_t)k * k;

  for (int sys = blockIdx.x; sys < p; sys += gridDim.x) {
    const float* src = H + (size_t)sys * kk;
    for (int i = warp; i < k; i += nwarps)  // a row per warp, coalesced
      for (int c = lane; c < k; c += 32) {
        float v = src[i * k + c];
        if (SHARED) v += __ldg(Hshared + i * k + c);
        S[i * ld + c] = v;
      }
    for (int i = tid; i < k; i += nt) b[i] = G[(size_t)sys * k + i];
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      if (LU) {
        // pivot: the first row of largest |a| in column j at or below j
        float bv = -1.f;
        int bi = k;
        for (int r = j + tid; r < k; r += nt)
          better(bv, bi, fabsf(S[r * ld + j]), r);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          better(bv, bi, __shfl_xor_sync(kFull, bv, o),
                 __shfl_xor_sync(kFull, bi, o));
        if (lane == 0) red_v[warp] = bv, red_i[warp] = bi;
        __syncthreads();
        float v = red_v[0];
        int piv = red_i[0];
        for (int w = 1; w < nwarps; ++w) better(v, piv, red_v[w], red_i[w]);
        if (piv >= k) piv = j;  // the column is all NaN: its pivot is NaN
        if (piv != j) {
          for (int c = tid; c < k; c += nt) {
            const float t = S[j * ld + c];
            S[j * ld + c] = S[piv * ld + c];
            S[piv * ld + c] = t;
          }
          if (tid == 0) {
            const float t = b[j];
            b[j] = b[piv];
            b[piv] = t;
          }
        }
        __syncthreads();
        const float pv = S[j * ld + j];
        const float r = pv != 0.f ? 1.f / pv : qnan;  // NaN stays NaN
        // L[i][j] = a[i][j] / pivot below the diagonal
        for (int i = j + 1 + tid; i < k; i += nt) S[i * ld + j] *= r;
        if (tid == 0) inv[j] = r;
        __syncthreads();
        // trailing block and g, a row per warp: a[i][c] -= L[i][j] u[j][c],
        // g_i -= L[i][j] g_j
        const float bj = b[j];
        for (int i = j + 1 + warp; i < k; i += nwarps) {
          const float l = S[i * ld + j];
          for (int c = j + 1 + lane; c < k; c += 32)
            S[i * ld + c] -= l * S[j * ld + c];
          if (lane == 0) b[i] -= l * bj;
        }
        __syncthreads();
      } else {
        // Cholesky: L[j][j] = sqrt(a[j][j]) (NaN unless positive),
        // L[i][j] = a[i][j] / L[j][j], y_j = g_j / L[j][j]
        const float ajj = S[j * ld + j];
        const float r = ajj > 0.f ? rsqrtf(ajj) : qnan;
        const float yj = b[j] * r;  // read by all before thread 0 stores it
        for (int i = j + 1 + tid; i < k; i += nt) S[i * ld + j] *= r;
        __syncthreads();
        if (tid == 0) inv[j] = r, b[j] = yj;
        // trailing lower triangle, a row per warp: a[i][c] -= L[i][j]
        // L[c][j] for j < c <= i (column j read at the odd stride: no
        // bank conflicts); g_i -= L[i][j] y_j
        for (int i = j + 1 + warp; i < k; i += nwarps) {
          const float l = S[i * ld + j];
          for (int c = j + 1 + lane; c <= i; c += 32)
            S[i * ld + c] -= l * S[c * ld + j];
          if (lane == 0) b[i] -= l * yj;
        }
        __syncthreads();
      }
    }
    // back substitution from the last row up: x_t = b_t / (its pivot),
    // then b_i -= a x_t for every i < t, with a = U[i][t] (LU) or
    // L[t][i] (Cholesky, L^T's entry)
    for (int t = k - 1; t >= 0; --t) {
      const float xt = b[t] * inv[t];
      for (int i = tid; i < t; i += nt)
        b[i] -= (LU ? S[i * ld + t] : S[t * ld + i]) * xt;
      if (tid == 0) D[(size_t)sys * k + t] = xt;
      __syncthreads();
    }
  }
}

// Largest k whose system fits one CTA's shared memory on this device.
inline int block_max_k(int device) {
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  int k = 1;
  while (sizeof(float) * (block_aux_floats(k + 1) +
                          block_system_floats(k + 1)) <= (size_t)optin)
    ++k;
  return k;
}

namespace {
// cudaFuncSetAttribute done, per device and instantiation (internal
// linkage: this library's own flags)
bool block_attr_done[16][4];
}  // namespace

template <bool LU, bool SH>
int launch_block_solve(const float* H, const float* Hs, const float* G, int p,
                       int k, float* D, float* scratch, int slots,
                       int device, cudaStream_t st) {
  const int nt = LU && k <= 64 ? 32 : kBlockThreads;
  size_t smem = sizeof(float) * block_aux_floats(k);
  int grid = p;
  if (scratch) {
    grid = std::min(p, slots);
  } else {
    smem += sizeof(float) * block_system_floats(k);
  }
  auto kern = block_solve_kernel<LU, SH>;
  const int slot = (LU ? 2 : 0) + (SH ? 1 : 0);
  if (smem > 48 * 1024 && !block_attr_done[device][slot]) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    block_attr_done[device][slot] = true;
  }
  kern<<<grid, nt, smem, st>>>(H, Hs, G, p, k, D, scratch);
  return (int)cudaGetLastError();
}

}  // namespace pycmf

// H (p, k, k), G (p, k) and D (p, k): f32, row-major, contiguous,
// 1 <= k <= 64 (k > 32 takes the wide route); H_shared (k, k) f32
// contiguous, or null. Makes `device` current for the launch. Returns the
// CUDA error of the launch (0 on success).
extern "C" int pycmf_batched_spd_solve(const float* H, const float* H_shared,
                                       const float* G, int p, int k, float* D,
                                       int device, void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (p < 1 || k < 1 || k > kWideMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    const int grid = ceil_div(p, kWideWarps);
    const size_t smem = sizeof(float) * kWideWarps * k * wide_ld(k);
    if (H_shared)
      chol_solve_wide_kernel<true><<<grid, kWideWarps * 32, smem, st>>>(
          H, H_shared, G, p, k, D);
    else
      chol_solve_wide_kernel<false><<<grid, kWideWarps * 32, smem, st>>>(
          H, H_shared, G, p, k, D);
    return (int)cudaGetLastError();
  }
  const int vec = k % 2 == 0 && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    auto launch = [&](auto shared) {
      constexpr bool SH = decltype(shared)::value;
      const int grid = std::min(ceil_div(p, kSolveWarps),
                                sm_count() * solve_blocks_per_sm<KP, SH>());
      chol_solve_kernel<KP, SH><<<grid, kSolveWarps * 32, 0, st>>>(
          H, H_shared, G, p, k, vec, D);
    };
    if (H_shared) launch(std::true_type{});
    else launch(std::false_type{});
  });
  return (int)cudaGetLastError();
}


// The block route (lu = 0: SPD, any k, meant for k > 64) or the LU route
// (lu = 1, any k) of (H[i] + H_shared) d[i] = G[i]: operands as for
// pycmf_batched_spd_solve. scratch: null when k <= pycmf_block_solve_max_k
// (the system in shared memory), else `slots` >= 1 global slots of
// k * (k | 1) floats (one per CTA). Returns the CUDA error of the launch.
extern "C" int pycmf_batched_block_solve(const float* H, const float* H_shared,
                                         const float* G, int p, int k, int lu,
                                         float* D, float* scratch, int slots,
                                         int device, void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (p < 1 || k < 1 || (!scratch && k > block_max_k(device)) ||
      (scratch && slots < 1) || (device < 0 || device >= 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lu) {
    return H_shared ? launch_block_solve<true, true>(H, H_shared, G, p, k, D,
                                                     scratch, slots, device, st)
                    : launch_block_solve<true, false>(
                          H, H_shared, G, p, k, D, scratch, slots, device, st);
  }
  return H_shared ? launch_block_solve<false, true>(H, H_shared, G, p, k, D,
                                                    scratch, slots, device, st)
                  : launch_block_solve<false, false>(H, H_shared, G, p, k, D,
                                                     scratch, slots, device, st);
}

// Largest k whose system the block and LU routes keep in shared memory.
extern "C" int pycmf_block_solve_max_k(int device) {
  using namespace pycmf;
  return block_max_k(device);
}
