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
// Bound: bytes. Each system reads its lower triangle (in 32-byte sectors)
// and g, and writes d; the work is ~k^3/6 FMAs, about one FMA per byte at
// k = 20, far below the card's ~20 f32 FMAs per byte of DRAM bandwidth. At
// p = 11314 (the V update of the main path) that is 15.6 MB: ~4.6 us at
// 3.35 TB/s (chip_smoke.py: spd_bytes).
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
// Wide route, 33 <= k <= 64: csrc/batched_solve_wide.cu (a library of its
// own, so that its build runs beside this one's).
//
// Block route, k > 64 (the reference's jnp.linalg.solve above its
// unrolled kernel, pycmf_tpu/ops/pallas/batched_solve.py:74-77), and LU
// route, any k (the full Hessian form's systems, which may be indefinite:
// the reference's jnp.linalg.solve at pycmf_tpu/solvers/newton.py:308).
// Bound: bytes at the main path's shapes (11314 SPD systems at k = 100
// read 262 MB of their lower triangles, 0.078 ms; the operations, k^3/3 at
// 67 TFLOP/s, take 0.06), and operations from k = 128 (LU, which reads
// whole rows, from k = 120). A factorization one column at a time would be
// held far above that by ~3k barriers and ~k^3/3 shared-memory round
// trips per system, so both routes work by panels of kNB = 16 columns;
// what holds them above the bound on an H100 is each panel's serial steps
// (a pivot at a time, then barriers), which several CTAs per SM overlap.
// LU at k <= 32 (lu_solve_warp_kernel): the narrow route's frame, a warp
// per system, lane i row i of [H | g] in registers, the next system's
// copy in flight by cp.async. Rows never move: each lane keeps its
// position in getrf's current order; per column a warp argmax of |a_j|
// over the lanes at or below j by shuffles (ties to the first position,
// NaN never wins), the pivot lane trades positions with the lane at j and
// publishes its row through the warp's buffer, the lanes below eliminate;
// the back substitution runs in pivot order by shuffles. No barrier but
// __syncwarp.
// Blocked (blocked_solve_kernel), H + Hs summed as each entry is read
// (register-staged loads, several rows of H and Hs in flight a warp), the
// rows at a stride whose quarter is odd (float4 reads by row land in
// distinct banks). Cholesky (right-looking, on the lower triangle): per
// panel (a) one warp factors the diagonal block on [A11 | g1] in registers
// (the narrow route's step loop, the column passed by shuffles: one
// rsqrtf per pivot, y falls out), (b) a thread per row below solves its
// panel row against L11 and updates its g, writing the row also to a
// transposed copy of the panel, (c) a SYRK updates the trailing lower
// triangle, each thread a 4 x 4 register tile summing the panel's 16
// rank-1 terms from float4 reads of the transposed panel, then one read
// and one write of each entry: one shared round trip per panel instead of
// one per column, three barriers per panel. LU (getrf's blocked form on
// [A | g]): the CTA factors the panel over its full height, a row per
// thread in registers (rows never move; each keeps its position in
// getrf's order; per column the warps' candidates reduce to the pivot,
// which publishes its row: two barriers a column), every other column
// takes the panel's row swaps in order and, right of it, U12 = L11^-1 A12
// (g included, so the forward substitution is one more column), then the
// same 4 x 4 tiles update A22 -= L21 U12. The back substitutions run by
// panels from the last: one warp solves the diagonal block by shuffles,
// then a thread per earlier row removes the panel's 16 terms. No TF32:
// every product is an f32 FMA on the CUDA cores. A non-positive Cholesky
// pivot, or a zero or NaN LU pivot, gives NaN, which reaches every entry
// of its system's d and no other. Where the system lies is the launch
// plan's (ops/kernels/batched_solve.py:solve_plan): one CTA per system in
// shared memory up to block_max_k (220 LU; 320 SPD, whose lower triangle
// is packed; at k = 100 seven CTAs share an SM and hide each other's
// loads, which on an H100 beat two buffers with the next system's copy in
// flight: these halve the CTAs an SM); above that a global scratch slot
// per CTA, two an SM whatever the slots' bytes (on an H100 faster than
// slots within the 50 MB L2, and than 2- or 4-CTA clusters splitting the
// rows, which share one system's serial steps and barriers), the rows
// swapped as one permutation, its reads in flight; the work area (panel,
// transposed panel, g, pivots) in shared memory while it fits, else in
// the slot too (k > 1652 LU, 3203 SPD), so any k runs. Every entry takes
// the same operations in the same order on every variant (any place, any
// thread count), each sum in a fixed order and no atomics, so a call
// repeats bit for bit and a system's d depends neither on p nor on its
// place in the batch; no host sync, no allocation, capturable in a CUDA
// graph.
// What is left of its speed: ROADMAP B5.
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

// ---- LU route, k <= 32: one system per warp --------------------------------

// (value, row) with the larger value, the smaller row on a tie; NaN never
// wins (every comparison with it is false).
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) v = v2, i = i2;
}

// The warp's `better` of each lane's (v, i), v >= 0 or -1 for none (never
// NaN): the largest v, the smallest i on a tie, `none` if every lane has
// none. Two warp reductions: |a|'s bits order as its values do, so the
// largest key (bits + 1, 0 for none) is the largest value.
__device__ __forceinline__ int warp_argmax(float v, int i, int none) {
  const unsigned key = v < 0.f ? 0u : __float_as_uint(v) + 1u;
  const unsigned top = __reduce_max_sync(kFull, key);
  if (top == 0u) return none;
  return (int)__reduce_min_sync(kFull, key == top ? (unsigned)i : ~0u);
}

template <int KP, bool SHARED>  // SHARED: Hs given
__global__ void __launch_bounds__(kSolveWarps * 32)
    lu_solve_warp_kernel(const float* __restrict__ H,
                         const float* __restrict__ Hshared,
                         const float* __restrict__ G, int p, int k, int vec,
                         float* __restrict__ D) {
  // per warp: two system buffers (the second takes the next system's copy)
  // and two pivot-row buffers of KP entries plus g
  __shared__ __align__(16) float hbuf[kSolveWarps][2][KP * KP + 32];
  __shared__ __align__(16) float rowbuf[kSolveWarps][2][KP + 4];
  __shared__ float hsh[SHARED ? KP * KP : 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int kk = k * k;
  const float qnan = __int_as_float(0x7fc00000);
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
  const bool real = lane < k;  // lanes k..31 hold no row
  float g_next = real ? G[(size_t)sys * k + lane] : 0.f;

  for (int it = 0; sys < p; ++it, sys += stride) {
    const int nxt = sys + stride;
    if (nxt < p) stage(nxt, hbuf[warp][(it + 1) & 1]);
    cp_async_commit();
    float b = g_next;  // g, then what the eliminations leave of it
    if (nxt < p && real) g_next = G[(size_t)nxt * k + lane];
    cp_async_wait<1>();
    __syncwarp();
    const float* cur = hbuf[warp][it & 1];

    // row `lane` of H + Hs (entries past k, read from the next row, only
    // ever reach columns past k, which nothing reads)
    float a[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      a[c] = real ? cur[lane * k + c] : 0.f;
      if (SHARED && real) a[c] += hsh[lane * k + c];
    }

    // Rows never move: `pos` is the lane's row in getrf's current order.
    // At step j the pivot is the first row in that order of largest |a_j|
    // at or below j (NaN never wins; an all-NaN column takes row j); it
    // trades positions with the row at j, publishes its row and g through
    // the warp's buffer, and every row below eliminates.
    int pos = lane;
    float inv_piv = 0.f;  // 1 / U[pos][pos]
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < k) {
        float bv = -1.f;
        int bi = 64;
        if (real && pos >= j) better(bv, bi, fabsf(a[j]), pos);
        const int ppos = warp_argmax(bv, bi, j);
        const int plane = __ffs(__ballot_sync(kFull, pos == ppos)) - 1;
        const int jlane = __ffs(__ballot_sync(kFull, pos == j)) - 1;
        float* rb = rowbuf[warp][j & 1];
        if (lane == plane) {
#pragma unroll
          for (int c = 0; c < KP; c += 4)
            *reinterpret_cast<float4*>(rb + c) =
                make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
          rb[KP] = b;
        }
        if (lane == jlane) pos = ppos;
        if (lane == plane) pos = j;
        __syncwarp();
        const float pv = rb[j];
        const float r = pv != 0.f ? __frcp_rn(pv) : qnan;  // NaN stays NaN
        if (lane == plane) inv_piv = r;
        if (real && pos > j) {
          const float l = a[j] * r;
#pragma unroll
          for (int c0 = (j + 1) & ~3; c0 < KP; c0 += 4) {
            const float4 q = *reinterpret_cast<const float4*>(rb + c0);
            const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c0 + u > j) a[c0 + u] -= l * v[u];
          }
          b -= l * rb[KP];
        }
      }
    }

    // U x = y in pivot order, from the last position up: the lane at
    // position t gives x_t = acc / U[t][t], and every lane above removes
    // U[pos][t] x_t (its own a[t]) from its acc
    float acc = b, x = 0.f;
#pragma unroll
    for (int t = KP - 1; t >= 0; --t) {
      if (t < k) {
        const int tl = __ffs(__ballot_sync(kFull, pos == t)) - 1;
        const float xt = __shfl_sync(kFull, acc * inv_piv, tl);
        if (pos == t) x = xt;
        if (pos < t) acc -= a[t] * xt;
      }
    }
    if (real) D[(size_t)sys * k + pos] = x;
    __syncwarp();  // the buffers just read are refilled next iteration
  }
}

template <int KP, bool SHARED>
int lu_warp_blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, lu_solve_warp_kernel<KP, SHARED>, kSolveWarps * 32, 0);
    if (n < 1) n = 1;
  }
  return n;
}


// ---- block and LU routes, blocked: one CTA per system ---------------------

constexpr int kNB = 16;             // panel width
constexpr int kLDP = kNB + 1;       // row stride of the panel buffers (odd)
constexpr int kBlockThreads = 256;  // the most threads a launch may give

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// Row stride of a system: room for [H | g] (k + 1 columns) rounded up to
// a multiple of 4 whose quarter is odd, so that rows read as 16-byte
// vectors, a row per thread, fall in distinct banks.
__host__ __device__ inline int block_ld(int k) {
  const int ld = round4(k + 1);
  return (ld & 7) ? ld : ld + 4;
}

// Offset of row i of a packed lower triangle whose rows are padded to a
// multiple of 4: the sum of round4(r + 1) over r < i.
__host__ __device__ inline size_t packed_row(int i) {
  const size_t q = i >> 2, s = i & 3;
  return 4 * (q + 1) * (2 * q + s);
}

// Where a system lies: in one CTA's shared memory; its rows in a global
// scratch slot, the work area below in shared memory; or rows and work
// area in the slot (shared memory then the same for every k).
enum Place : int { kShared = 0, kSlotRows = 1, kSlotAll = 2 };

// ops/kernels/batched_solve.py keeps the same four formulas.
// Floats of a system's rows: the packed lower triangle (SPD in shared
// memory), else whole rows [H | g] at stride block_ld(k).
__host__ __device__ inline size_t block_rows_floats(int k, int packed) {
  return packed ? packed_row(round4(k)) : (size_t)round4(k) * block_ld(k);
}

// Floats of the work area: the transposed panel PT; LU's panel PB, or
// SPD's diagonal block DB with its y and 1 / L_tt; g (SPD) and the
// pivots' reciprocals.
__host__ __device__ inline size_t block_work_floats(int k, int lu) {
  const size_t kr = round4(k);
  return (size_t)kNB * block_ld(k) +
         (lu ? kr * kLDP : (size_t)kNB * (kLDP + 2)) + 2 * kr;
}

// Shared floats of one CTA: a panel's x and its pivot rows, for LU the
// pivot search's two words per warp and a panel's row moves; then what of
// the rows and the work area `place` leaves in shared memory.
__host__ __device__ inline size_t block_smem_floats(int k, int lu, int place) {
  size_t f = 2 * kNB + (lu ? 16 + 4 * kNB + 4 : 0);
  if (place != kSlotAll) f += block_work_floats(k, lu);
  if (place == kShared) f += block_rows_floats(k, !lu);
  return f;
}

// Floats of one global scratch slot: a system's rows, and with kSlotAll
// the work area.
__host__ __device__ inline size_t block_slot_floats(int k, int lu, int place) {
  return block_rows_floats(k, 0) +
         (place == kSlotAll ? block_work_floats(k, lu) : 0);
}

// A[u][v] -= sum over t of R[t][u] C[t][v] for u < rows, v < 4, row u of
// A at A(u): a 4 x 4 register tile of the trailing update, kNB rank-1
// terms summed from zero in order, then one subtraction. R and C are rows
// of stride ld (the transposed panel, or U12's rows).
template <typename RowOf>
__device__ __forceinline__ void tile_update(RowOf A, int ld, const float* R,
                                            const float* C, int rows) {
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll
  for (int t = 0; t < kNB; ++t) {
    const float4 r = *reinterpret_cast<const float4*>(R + (size_t)t * ld);
    const float4 c = *reinterpret_cast<const float4*>(C + (size_t)t * ld);
    const float rv[4] = {r.x, r.y, r.z, r.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(rv[u], cv[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < rows) {
      float4* d = reinterpret_cast<float4*>(A(u));
      float4 q = *d;
      q.x -= acc[u][0], q.y -= acc[u][1], q.z -= acc[u][2], q.w -= acc[u][3];
      *d = q;
    }
  }
}
// getrf's unblocked step on one panel, by the whole CTA: P holds rows
// j..k-1 (m rows) of columns j..j+jb at stride kLDP, thread tid the rows
// at positions tid, tid + nt, ... Per column t the pivot is the first row
// (in current order) of largest |a| at or below t (NaN never wins; an
// all-NaN column takes row t): each warp reduces its rows' candidates,
// then every thread the warps' (red: two words per warp); rows t and the
// pivot's swap, the rows below take L = a / pivot and update the panel's
// later columns, finding the next column's candidates on the values just
// written. Two barriers per column. ipiv[t] gets the pivot's row of the
// system, inv[t] 1 / pivot (NaN for a zero or NaN pivot).
__device__ __forceinline__ void panel_getf2(float* P, int m, int jb, int tid,
                                            int nt, int j, int* ipiv,
                                            float* inv, unsigned* red) {
  const float qnan = __int_as_float(0x7fc00000);
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float bv = -1.f;  // the thread's best |a| in the next column, and its row
  int bi = m;
  for (int r = tid; r < m; r += nt) better(bv, bi, fabsf(P[r * kLDP]), r);
  for (int t = 0; t < jb; ++t) {
    const unsigned key = bv < 0.f ? 0u : __float_as_uint(bv) + 1u;
    const unsigned wtop = __reduce_max_sync(kFull, key);
    const unsigned wat =
        __reduce_min_sync(kFull, key == wtop ? (unsigned)bi : ~0u);
    if (lane == 0) red[2 * warp] = wtop, red[2 * warp + 1] = wat;
    __syncthreads();
    unsigned top = 0u, at = ~0u;
    for (int w = 0; w < nw; ++w) {
      const unsigned kw = red[2 * w], aw = red[2 * w + 1];
      if (kw > top || (kw == top && aw < at)) top = kw, at = aw;
    }
    const int piv = top ? (int)at : t;
    if (piv != t && tid < jb) {
      const float v = P[t * kLDP + tid];
      P[t * kLDP + tid] = P[piv * kLDP + tid];
      P[piv * kLDP + tid] = v;
    }
    if (tid == 0) ipiv[t] = j + piv;
    __syncthreads();
    const float pv = P[t * kLDP + t];
    const float rr = pv != 0.f ? __frcp_rn(pv) : qnan;  // NaN stays NaN
    if (tid == 0) inv[t] = rr;
    float u[kNB];  // the pivot row right of t, in registers
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      u[c] = c > t && c < jb ? P[t * kLDP + c] : 0.f;
    bv = -1.f, bi = m;
    for (int r = tid; r < m; r += nt) {
      if (r <= t) continue;
      float* Pr = P + r * kLDP;
      float x[kNB];
#pragma unroll
      for (int c = 0; c < kNB; ++c) x[c] = c > t && c < jb ? Pr[c] : 0.f;
      const float l = Pr[t] * rr;
      Pr[t] = l;
      float next = 0.f;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        if (c > t && c < jb) {
          x[c] -= l * u[c];
          Pr[c] = x[c];
        }
        if (c == t + 1) next = x[c];
      }
      better(bv, bi, fabsf(next), r);
    }
  }
  __syncthreads();
}

// The same step with the panel in registers, for m <= nt: thread tid holds
// the row that started at position tid and never moves; `pos` is its
// position in getrf's current order. Per column t the warps' candidates
// (|a_t| of the rows at or below t; NaN never wins) reduce to the pivot,
// the pivot's row is published through prow, the rows at t and at the
// pivot trade positions, and the rows below update in registers: the same
// operations on the same values as panel_getf2, so the same bits. The
// rows are written back at their final positions.
__device__ __forceinline__ void panel_getf2_rows(float* P, int m, int jb,
                                                 int tid, int nt, int j,
                                                 int* ipiv, float* inv,
                                                 unsigned* red, float* prow) {
  const float qnan = __int_as_float(0x7fc00000);
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const bool has = tid < m;
  int pos = tid;
  float a[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) a[c] = has && c < jb ? P[tid * kLDP + c] : 0.f;
#pragma unroll
  for (int t = 0; t < kNB; ++t) {
    if (t < jb) {
      const float v = fabsf(a[t]);
      const unsigned key =
          has && pos >= t && v >= 0.f ? __float_as_uint(v) + 1u : 0u;
      const unsigned wtop = __reduce_max_sync(kFull, key);
      const unsigned wat =
          __reduce_min_sync(kFull, key == wtop ? (unsigned)pos : ~0u);
      if (lane == 0) red[2 * warp] = wtop, red[2 * warp + 1] = wat;
      __syncthreads();
      unsigned top = 0u, at = ~0u;
      for (int w = 0; w < nw; ++w) {
        const unsigned kw = red[2 * w], aw = red[2 * w + 1];
        if (kw > top || (kw == top && aw < at)) top = kw, at = aw;
      }
      const int piv = top ? (int)at : t;
      if (has && pos == piv) {
#pragma unroll
        for (int c = 0; c < kNB; c += 4)
          *reinterpret_cast<float4*>(prow + c) =
              make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
      }
      if (has && piv != t) {
        if (pos == t) pos = piv;
        else if (pos == piv) pos = t;
      }
      if (tid == 0) ipiv[t] = j + piv;
      __syncthreads();
      const float pv = prow[t];
      const float rr = pv != 0.f ? __frcp_rn(pv) : qnan;  // NaN stays NaN
      if (tid == 0) inv[t] = rr;
      if (has && pos > t) {
        const float l = a[t] * rr;
        a[t] = l;
#pragma unroll
        for (int c = t + 1; c < kNB; ++c)
          if (c < jb) a[c] -= l * prow[c];
      }
    }
  }
  if (has) {
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (c < jb) P[pos * kLDP + c] = a[c];
  }
  __syncthreads();
}

// dst += src, elementwise.
__device__ __forceinline__ void add_to(float& d, float s) { d += s; }
__device__ __forceinline__ void add_to(float4& d, const float4& s) {
  d.x += s.x, d.y += s.y, d.z += s.z, d.w += s.w;
}

// Rows in flight a warp when the rows are read (on an H100 4 beat 8 at
// every shape of chip_smoke.py's phase 3).
constexpr int kLoadRows = 4;

// Row i of the rows held here (at at_row(i)) gets the first w(i) entries
// of row i of H plus, if given, Hs (w non-decreasing in i), read as T
// (float or float4). A warp takes kLoadRows rows at a time, so that each
// lane has that many loads of H and of Hs in flight; each sum is the f32
// H + Hs taken beforehand.
template <typename T, typename RowOf, typename Width>
__device__ __forceinline__ void load_rows(const float* __restrict__ H,
                                          const float* __restrict__ Hs, int k,
                                          RowOf at_row, Width w, int lane,
                                          int warp, int nw) {
  constexpr int E = sizeof(T) / sizeof(float);
  for (int i0 = kLoadRows * warp; i0 < k; i0 += kLoadRows * nw) {
    const int wide = w(min(i0 + kLoadRows - 1, k - 1));
    for (int c = E * lane; c < wide; c += 32 * E) {
      T v[kLoadRows], h[kLoadRows];
#pragma unroll
      for (int u = 0; u < kLoadRows; ++u) {
        const size_t off = (size_t)(i0 + u) * k + c;
        if (i0 + u < k && c < w(i0 + u)) {
          v[u] = __ldg(reinterpret_cast<const T*>(H + off));
          if (Hs) h[u] = __ldg(reinterpret_cast<const T*>(Hs + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadRows; ++u) {
        if (i0 + u < k && c < w(i0 + u)) {
          if (Hs) add_to(v[u], h[u]);
          *reinterpret_cast<T*>(at_row(i0 + u) + c) = v[u];
        }
      }
    }
  }
}

// For e < n: store(e, v) of v = the float4 at from(e), four loads in
// flight per thread (the panel's rows may lie in L2).
template <typename Store, typename From>
__device__ __forceinline__ void copy4(int n, Store store, From from, int tid,
                                      int nt) {
  for (int e0 = tid; e0 < n; e0 += 4 * nt) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nt < n)
        v[u] = *reinterpret_cast<const float4*>(from(e0 + u * nt));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nt < n) store(e0 + u * nt, v[u]);
  }
}

// One system per CTA in shared memory, SPD's rows as the packed lower
// triangle (PLACE = kShared); else the system in a global scratch slot per
// CTA (with kSlotAll the work area too), the CTAs walking the systems with
// a stride. Every entry takes the same operations in the same order
// wherever it lies, so every variant gives the same bits. At most 128
// registers a thread (two CTAs of 256 threads an SM): on an H100 faster
// than a cap of 64, which spills the LU route's panel step.
template <bool LU, int PLACE>  // Hshared: null, or Hs to add
__global__ void __launch_bounds__(kBlockThreads, 2)
    blocked_solve_kernel(const float* __restrict__ H,
                         const float* __restrict__ Hshared,
                         const float* __restrict__ G, int p, int k, int vec,
                         float* __restrict__ D, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float block_smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int kr = round4(k), ld = block_ld(k);
  const float qnan = __int_as_float(0x7fc00000);
  constexpr bool GS = PLACE != kShared;  // the rows in a scratch slot
  // SPD in shared memory holds the lower triangle, row i at packed_row(i)
  constexpr bool PACK = !LU && !GS;
  const size_t rows_f = block_rows_floats(k, PACK);
  float* const S =
      GS ? scratch + (size_t)blockIdx.x * block_slot_floats(k, LU, PLACE)
         : block_smem;
  // the work area: the transposed panel PT first
  float* const PT = PLACE == kSlotAll ? S + rows_f
                    : GS              ? block_smem
                                      : block_smem + rows_f;
  float* const PB = PT + (size_t)kNB * ld;  // LU: the panel (stride kLDP)
  float* const DB = PB;  // SPD: L11 (stride kLDP), then y and 1 / L_tt
  float* const b = PB + (LU ? (size_t)kr * kLDP : (size_t)kNB * (kLDP + 2));
  float* const inv = b + kr;
  float* const xb = PLACE == kSlotAll ? block_smem : inv + kr;
  int* const ipiv = reinterpret_cast<int*>(xb + kNB);
  unsigned* const red = reinterpret_cast<unsigned*>(ipiv + kNB);  // LU: 16
  int* const pdst = reinterpret_cast<int*>(red + 16);  // LU: a panel's moves
  int* const psrc = pdst + 2 * kNB;
  int* const pmoved = psrc + 2 * kNB;
  auto at_row = [&](int i) -> float* {
    if constexpr (PACK) return S + packed_row(i);
    else return S + (size_t)i * ld;
  };
  auto width = [&](int i) {  // the entries of a row read (SPD packed: to
    return PACK ? min(round4(i + 1), k) : k;  // its diagonal, rounded up)
  };

  for (int sys = blockIdx.x; sys < p; sys += gridDim.x) {
    // H + Hs, g in column k (LU) or in b (SPD)
    const float* src = H + (size_t)sys * k * k;
    if (vec)
      load_rows<float4>(src, Hshared, k, at_row, width, lane, warp, nw);
    else
      load_rows<float>(src, Hshared, k, at_row, width, lane, warp, nw);
    const float* g = G + (size_t)sys * k;
    if (LU) {
      for (int i = tid; i < k; i += nt) at_row(i)[k] = g[i];
    } else {
      for (int i = tid; i < k; i += nt) b[i] = g[i];
    }
    __syncthreads();

    if constexpr (!LU) {
      // Cholesky, right-looking by panels of kNB columns
      float* const Ly = DB + kNB * kLDP;  // the panel's y
      float* const Li = Ly + kNB;         // and 1 / L_tt
      for (int j = 0; j < k; j += kNB) {
        const int jb = min(kNB, k - j);
        // (a) the diagonal block on [A11 | g1] in one warp, lane i row
        // j + i in registers (the narrow route's step loop, the column
        // passed by shuffles)
        if (warp == 0) {
          float* Sj = at_row(j + min(lane, jb - 1)) + j;  // row j + lane
          float a[kNB];  // its entries in the block, at or left of the diagonal
#pragma unroll
          for (int c = 0; c < kNB; ++c)
            a[c] = (lane < jb && c <= lane) ? Sj[c] : 0.f;
          float gl = lane < jb ? b[j + lane] : 0.f;
          float iv_l = 0.f, y_l = 0.f;
#pragma unroll
          for (int t = 0; t < kNB; ++t) {
            if (t < jb) {
              // column t of every lane by shuffles: the pivot, g_t, and the
              // entries below the pivot
              const float ajj = __shfl_sync(kFull, a[t], t);
              const float bj = __shfl_sync(kFull, gl, t);
              float col[kNB];
#pragma unroll
              for (int c = t + 1; c < kNB; ++c)
                col[c] = __shfl_sync(kFull, a[t], c);
              const float iv = ajj > 0.f ? rsqrtf(ajj) : qnan;
              const float w = a[t] * (iv * iv), yj = bj * iv;
              if (lane == t) iv_l = iv, y_l = yj;
              a[t] *= iv;  // L[i][t]
              gl -= w * bj;
#pragma unroll
              for (int c = t + 1; c < kNB; ++c) a[c] -= w * col[c];
            }
          }
          if (lane < jb) {
#pragma unroll
            for (int c = 0; c < kNB; ++c) {
              if (c <= lane) Sj[c] = a[c];
              if (c < jb) DB[lane * kLDP + c] = a[c];
            }
            Ly[lane] = y_l, Li[lane] = iv_l;
            inv[j + lane] = iv_l, b[j + lane] = y_l;
          }
        }
        __syncthreads();
        // (b) the panel below it, a row per thread: x = a L11^-T, and
        // g_i -= x . y1
        const int lo = j + jb;
        for (int i = lo + tid; i < k; i += nt) {  // here jb == kNB
          float* Si = at_row(i) + j;
          float x[kNB];
#pragma unroll
          for (int t = 0; t < kNB; t += 4) {
            const float4 q = *reinterpret_cast<const float4*>(Si + t);
            x[t] = q.x, x[t + 1] = q.y, x[t + 2] = q.z, x[t + 3] = q.w;
          }
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < kNB; ++t) {
            float v = x[t];
#pragma unroll
            for (int s = 0; s < t; ++s) v -= x[s] * DB[t * kLDP + s];
            x[t] = v * Li[t];
            acc += x[t] * Ly[t];
          }
#pragma unroll
          for (int t = 0; t < kNB; t += 4)
            *reinterpret_cast<float4*>(Si + t) =
                make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
#pragma unroll
          for (int t = 0; t < kNB; ++t) PT[(size_t)t * ld + i] = x[t];
          b[i] -= acc;
        }
        __syncthreads();
        // (c) the trailing lower triangle, a 4 x 4 tile per thread (a SYRK
        // on the transposed panel): row tile ti holds ti + 1 column tiles
        if (lo < k) {
          const int ntr = (k - lo + 3) >> 2, total = ntr * (ntr + 1) / 2;
          for (int idx = tid; idx < total; idx += nt) {
            int ti = (int)((sqrtf((float)(8 * idx + 1)) - 1.f) * 0.5f);
            if (ti < 0) ti = 0;
            while (ti > 0 && ti * (ti + 1) / 2 > idx) --ti;
            while ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
            const int tj = idx - ti * (ti + 1) / 2;
            const int i0 = lo + 4 * ti, c0 = lo + 4 * tj;
            tile_update([&](int u) { return at_row(i0 + u) + c0; }, ld,
                        PT + i0, PT + c0, min(4, k - i0));
          }
        }
        __syncthreads();
      }
      // L^T x = y by panels from the last: one warp solves the diagonal
      // block (lane i row j + i), then every earlier g_s loses
      // sum_i L[j + i][s] x_i
      for (int j = (k - 1) / kNB * kNB; j >= 0; j -= kNB) {
        const int jb = min(kNB, k - j);
        if (warp == 0) {
          float r = lane < jb ? b[j + lane] : 0.f;
          const float iv = lane < jb ? inv[j + lane] : 0.f;
          float l[kNB], x = 0.f;  // l[t] = L[j + t][j + lane], t > lane
#pragma unroll
          for (int t = 0; t < kNB; ++t)
            l[t] = t < jb && lane < t ? at_row(j + t)[j + lane] : 0.f;
#pragma unroll
          for (int t = kNB - 1; t >= 0; --t) {
            if (t < jb) {
              const float xt = __shfl_sync(kFull, r * iv, t);
              if (lane == t) x = xt;
              if (lane < t) r -= l[t] * xt;
            }
          }
          if (lane < jb) D[(size_t)sys * k + j + lane] = x, xb[lane] = x;
        }
        __syncthreads();
        for (int s = tid; s < j; s += nt) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < kNB; ++i)
            if (i < jb) acc += at_row(j + i)[s] * xb[i];
          b[s] -= acc;
        }
        __syncthreads();
      }
    } else {
      // LU with partial pivoting in getrf's blocked form on [A | g]
      for (int j = 0; j < k; j += kNB) {
        const int jb = min(kNB, k - j), m = k - j;
        // the panel (rows j..k-1) into PB, factored by the CTA
        const int q4 = (jb + 3) >> 2;  // float4s of a panel row
        copy4(
            m * q4,
            [&](int e, float4 v) {
              float* to = PB + (e / q4) * kLDP + 4 * (e % q4);
              to[0] = v.x, to[1] = v.y, to[2] = v.z, to[3] = v.w;
            },
            [&](int e) { return at_row(j + e / q4) + j + 4 * (e % q4); }, tid,
            nt);
        __syncthreads();
        if (m <= nt)
          panel_getf2_rows(PB, m, jb, tid, nt, j, ipiv, inv + j, red, xb);
        else
          panel_getf2(PB, m, jb, tid, nt, j, ipiv, inv + j, red);
        // getrf's row swaps, in order: in shared memory one after another
        // by each column's thread; in a scratch slot (in L2) as one
        // permutation of the rows they touch (the row each value ends at,
        // and where it came from), its reads all in flight
        if (GS) {
          if (warp == 0) {
            // lane i takes row j + i (i < jb) or the pivot row ipiv[i -
            // jb]: the row whose value ends there, the swaps traced back
            const int x = lane < jb ? j + lane
                          : lane < 2 * jb ? ipiv[lane - jb] : -1;
            int f = x;
            for (int t = jb - 1; t >= 0; --t) {
              const int ra = j + t, rb = ipiv[t];
              f = f == ra ? rb : f == rb ? ra : f;
            }
            bool keep = x >= 0 && f != x;  // moved, and its first lane
            for (int i = 0; i < 32; ++i) {
              const int xi = __shfl_sync(kFull, x, i);
              if (i < lane && xi == x) keep = false;
            }
            const unsigned kept = __ballot_sync(kFull, keep);
            if (keep) {
              const int n = __popc(kept & ((1u << lane) - 1));
              pdst[n] = x, psrc[n] = f;
            }
            if (lane == 0) *pmoved = __popc(kept);
          }
          __syncthreads();
        }
        const int moved = GS ? *pmoved : 0;
        // each column outside the panel: the swaps, then right of the
        // panel (g included) U12 = L11^-1 A12
        for (int c = tid; c < k + 1 - jb; c += nt) {
          const int cc = c < j ? c : c + jb;
          if constexpr (GS) {
            float v[2 * kNB];  // every value read before any is written
#pragma unroll
            for (int i = 0; i < 2 * kNB; ++i)
              if (i < moved) v[i] = at_row(psrc[i])[cc];
#pragma unroll
            for (int i = 0; i < 2 * kNB; ++i)
              if (i < moved) at_row(pdst[i])[cc] = v[i];
          } else {
            for (int t = 0; t < jb; ++t) {
              const int pr = ipiv[t];
              if (pr != j + t) {
                float* x1 = at_row(j + t) + cc;
                float* x2 = at_row(pr) + cc;
                const float v = *x1;
                *x1 = *x2;
                *x2 = v;
              }
            }
          }
          if (cc >= j + jb) {
            float* U = at_row(j) + cc;
            float u[kNB];
#pragma unroll
            for (int t = 0; t < kNB; ++t) u[t] = t < jb ? U[(size_t)t * ld] : 0.f;
#pragma unroll
            for (int t = 0; t < kNB; ++t)
#pragma unroll
              for (int s = 0; s < t; ++s) u[t] -= PB[t * kLDP + s] * u[s];
#pragma unroll
            for (int t = 0; t < kNB; ++t)
              if (t < jb) U[(size_t)t * ld] = u[t];
          }
        }
        // the factored panel back into its rows, L21 also into the
        // transposed panel
        for (int e = tid; e < m * jb; e += nt) {
          const int r = e / jb, t = e - r * jb;
          const float v = PB[r * kLDP + t];
          at_row(j + r)[j + t] = v;
          if (r >= jb) PT[(size_t)t * ld + j + r] = v;
        }
        __syncthreads();
        // the trailing block A22 -= L21 U12 (g included), a 4 x 4 tile
        // per thread
        const int lo = j + jb;
        if (lo < k) {  // here jb == kNB
          const float* U = at_row(j);
          const int ntr = (k - lo + 3) >> 2, ntc = (k + 1 - lo + 3) >> 2;
          for (int idx = tid; idx < ntr * ntc; idx += nt) {
            const int ti = idx / ntc, tj = idx - ti * ntc;
            const int i0 = lo + 4 * ti, c0 = lo + 4 * tj;
            tile_update([&](int u) { return at_row(i0 + u) + c0; }, ld,
                        PT + i0, U + c0, min(4, k - i0));
          }
        }
        __syncthreads();
      }
      // U x = y by panels from the last, as for L^T (g in column k)
      for (int j = (k - 1) / kNB * kNB; j >= 0; j -= kNB) {
        const int jb = min(kNB, k - j);
        const float* Uj = at_row(j);
        if (warp == 0) {
          float r = lane < jb ? Uj[(size_t)lane * ld + k] : 0.f;
          const float iv = lane < jb ? inv[j + lane] : 0.f;
          float u[kNB], x = 0.f;  // u[t] = U[j + lane][j + t], t > lane
#pragma unroll
          for (int t = 0; t < kNB; ++t)
            u[t] = t < jb && lane < t ? Uj[(size_t)lane * ld + j + t] : 0.f;
#pragma unroll
          for (int t = kNB - 1; t >= 0; --t) {
            if (t < jb) {
              const float xt = __shfl_sync(kFull, r * iv, t);
              if (lane == t) x = xt;
              if (lane < t) r -= u[t] * xt;
            }
          }
          if (lane < jb) D[(size_t)sys * k + j + lane] = x, xb[lane] = x;
        }
        __syncthreads();
        for (int s = tid; s < j; s += nt) {
          float* Us = at_row(s);
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < kNB; ++i)
            if (i < jb) acc += Us[j + i] * xb[i];
          Us[k] -= acc;
        }
        __syncthreads();
      }
    }
  }
}

namespace {
// cudaFuncSetAttribute done, per device and instantiation (internal
// linkage: this library's own flags)
bool blocked_attr_done[16][2][3];
}  // namespace

// One launch of blocked_solve_kernel<LU, PLACE>: a CTA per system, or per
// scratch slot (`slots` CTAs).
template <bool LU, int PLACE>
int launch_blocked(const float* H, const float* Hs, const float* G, int p,
                   int k, int vec, float* D, float* scratch, int slots,
                   int nt, int smem, int device, cudaStream_t st) {
  auto kern = blocked_solve_kernel<LU, PLACE>;
  bool& done = blocked_attr_done[device][LU][PLACE];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin(device));
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  kern<<<PLACE == kShared ? p : slots, nt, smem, st>>>(H, Hs, G, p, k, vec, D,
                                                       scratch);
  return (int)cudaGetLastError();
}

}  // namespace pycmf

// H (p, k, k), G (p, k) and D (p, k): f32, row-major, contiguous,
// 1 <= k <= 32 (wider k: csrc/batched_solve_wide.cu and the block route);
// H_shared (k, k) f32 contiguous, or null. Makes `device` current for the
// launch. Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_batched_spd_solve(const float* H, const float* H_shared,
                                       const float* G, int p, int k, float* D,
                                       int device, void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (p < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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


// The block route (lu = 0: SPD, meant for k > 64) or the LU route (lu = 1)
// of (H[i] + H_shared) d[i] = G[i]: operands as for pycmf_batched_spd_solve.
// The plan is ops/kernels/batched_solve.py:solve_plan's, checked here: LU
// at k <= 32 takes a warp per system (no scratch, smem = 0); else
// `threads` (64, 128 or 256) a CTA with `smem` bytes of shared memory
// (within the device's opt-in limit): a CTA per system in shared memory
// (smem by block_smem_floats's kShared), or with `scratch` `slots` >= 1
// global slots, one per CTA, the work area in shared memory or (smem by
// kSlotAll) in the slot, of block_slot_floats(k, lu, place) floats each.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for a
// plan it refuses.
extern "C" int pycmf_batched_block_solve(const float* H, const float* H_shared,
                                         const float* G, int p, int k, int lu,
                                         float* D, float* scratch, int slots,
                                         int threads, int smem, int device,
                                         void* stream) {
  using namespace pycmf;
  if (p < 1 || k < 1 || device < 0 || device >= 16)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  if (lu && k <= kMaxK) {
    if (scratch || smem != 0) return (int)cudaErrorInvalidValue;
    const int vec = k % 2 == 0 && aligned(H);
    with_kp(k, [&](auto kp) {
      constexpr int KP = decltype(kp)::value;
      auto launch = [&](auto shared) {
        constexpr bool SH = decltype(shared)::value;
        const int grid = std::min(ceil_div(p, kSolveWarps),
                                  sm_count() * lu_warp_blocks_per_sm<KP, SH>());
        lu_solve_warp_kernel<KP, SH><<<grid, kSolveWarps * 32, 0, st>>>(
            H, H_shared, G, p, k, vec, D);
      };
      if (H_shared) launch(std::true_type{});
      else launch(std::false_type{});
    });
    return (int)cudaGetLastError();
  }
  const auto bytes = [&](int place) {
    return sizeof(float) * block_smem_floats(k, lu, place);
  };
  const int place = !scratch                    ? kShared
                    : (size_t)smem == bytes(kSlotRows) ? kSlotRows
                                                        : kSlotAll;
  if ((scratch && slots < 1) ||
      (threads != 64 && threads != 128 && threads != kBlockThreads) ||
      (size_t)smem != bytes(place) || smem > smem_optin(device))
    return (int)cudaErrorInvalidValue;
  const int vec = k % 4 == 0 && aligned(H) && (!H_shared || aligned(H_shared));
  auto launch = [&](auto lu_c) {
    constexpr bool L = decltype(lu_c)::value;
    const auto go = [&](auto place_c) {
      return launch_blocked<L, decltype(place_c)::value>(
          H, H_shared, G, p, k, vec, D, scratch, slots, threads, smem, device,
          st);
    };
    return place == kShared     ? go(std::integral_constant<int, kShared>{})
           : place == kSlotRows ? go(std::integral_constant<int, kSlotRows>{})
                                : go(std::integral_constant<int, kSlotAll>{});
  };
  return lu ? launch(std::true_type{}) : launch(std::false_type{});
}

// The opt-in shared memory of one CTA on `device`, in bytes (what
// solve_plan sizes the block and LU routes by).
extern "C" int pycmf_block_solve_optin(int device) {
  using namespace pycmf;
  if (device < 0 || device >= 16) return 0;
  DeviceGuard guard(device);
  return smem_optin(device);
}
