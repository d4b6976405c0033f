// The wide route of the fused U passes (K1, K2) at k > 32, on Hopper's
// tensor cores (sm_90a): X read once by the row sweep and once by the
// column sweep at any k <= 128, in every X dtype.
//
// A call runs five kernels on the caller's stream:
//
//   1. vt_kernel        Vt (NP x ld_vt) = V^T rounded to X's operand type,
//                       NP = 8 * nt * slices rows (nt n8 tiles a slice,
//                       from the plan: ops/kernels/mu_fused.py, wide_nt
//                       and wide_slices), zero past k and m; for f32 X
//                       vt_split_kernel, its TF32 parts hi, mid, lo in
//                       three planes.
//   2. xv_wide_kernel   the row sweep: one 256-thread CTA per 128 rows and
//                       component slice computes X V for all nt n8 tiles
//                       of its slice from each X stage in shared memory
//                       (Vt's fragments by ldmatrix), into an (n, k) f32
//                       scratch. At k <= 128 there is one slice of up to
//                       16 tiles, so X is read once; above, slices of 128
//                       components, the slices of one row block next to
//                       each other in the grid so that their reads of X
//                       meet in L2.
//   3. wide_epi_kernel  the caller's row epilogue (the MU ratio, or K2's
//                       step and line search) on tiles of rows: one
//                       256-thread CTA per 64 rows (one Gram partial), each
//                       warp four rows at a time, lane l the components
//                       l, l + 32, ...; the k x k matrices copied once per
//                       CTA into shared memory, each k x k product of a row
//                       tile a register tile (4 rows x 4 components a
//                       lane); then U_new^T (UxT: the operand type, or for
//                       f32 X its hi and lo TF32 planes) and the CTA's Gram
//                       partial, as the two-sweep route writes them.
//   4. xtu_wide_kernel  the column sweep: one 256-thread CTA per 128
//                       columns, row segment and component slice holds all
//                       NT tiles of its slice (xtu_wide_e4m3_kernel for
//                       e4m3 X), tile by tile from the stage's X
//                       fragments; numV directly when there is one segment,
//                       else per-segment partials.
//   5. wide_reduce_kernel sums the partials in u_pass_reduce_kernel's
//                       (u_pass_common.cuh) order, the Gram partials read
//                       coalesced.
//
// Each output element keeps the summation order of the 32-component slices
// this route had before: the row sweep's chains over 128 (bf16, e4m3) or 64
// (f32) columns of m, each from zero and promoted in order, f32 X in six
// TF32 products (xv_stage_mma_6x's); the column sweep's stages of 64 (32)
// rows over the plan's row segments; the epilogue's k-term sums in order
// of the inner index (f32 for K1, f64 for K2), K2's phi sums per lane over
// its components in order and then the same butterfly; the Gram partials
// over a 64-row block in row order. So the outputs equal that route's bit
// for bit, and an e4m3 call equals the bf16 call on X widened to bf16.
//
// Bound (chip_smoke.py: bound): the bytes of X once and of the factors
// (0.208 ms for bf16 X 30000 x 11314 at k = 40 on an H100), or, for f32 X,
// the six TF32 products of X V and three of X^T U_new (2 n m k flops each,
// at the card's TF32 rate: 1.23 ms at k = 100) where they take longer; the
// route itself reads X twice, once a sweep. The epilogue's f64 products
// (K2: two k x k products a row and one a trial) run on the CUDA cores.
// What holds each back (PERF.md §6): bf16 at k = 100 the sweeps'
// shared-memory fragment traffic (row sweep) and the column sweep's 178
// CTAs on 132 SMs (the plan's two row segments, which fix numV's bits);
// f32 the mma.sync TF32 rate.
#pragma once

#include "u_pass_common.cuh"

namespace pycmf {

// Call f(std::integral_constant<int, NT>) for the plan's NT, n8 tiles a
// slice (the instantiated counts: 5-8, then even counts to 16).
template <typename F>
int with_wide_nt(int nt, F&& f) {
  switch (nt) {
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1'. f32 X: Vt's TF32 parts, split once per call (split3_tf32, the split
// the six-product stage applies to each Vt value): planes hi, mid, lo of
// NP x ld u32 each, zero past k and m.
__global__ void vt_split_kernel(const float* __restrict__ V, int m, int k,
                                int np, int ld, uint32_t* __restrict__ Vt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)np * ld;
  if (idx >= plane) return;
  const int c = (int)(idx / ld), j = (int)(idx % ld);
  uint32_t hi, mid, lo;
  split3_tf32(c < k && j < m ? V[(size_t)j * k + c] : 0.f, hi, mid, lo);
  Vt[idx] = hi;
  Vt[plane + idx] = mid;
  Vt[2 * plane + idx] = lo;
}

// Four 8 x 8 matrices of 16-bit elements (or 8 x 4 of 32-bit ones) from
// shared memory: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&b)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// Row sweep geometry per X dtype: 128 rows (8 warps) a CTA; the columns of
// a stage (bf16: 128, one chain; f32: 32, half of a 64-column chain, which
// spans two stages; e4m3: 256, two chains), the ring's stages, and Vt's
// planes (f32: the hi, mid and lo TF32 parts of vt_split_kernel).
template <typename XT>
struct WRows {
  using OT = op_t<XT>;
  using VT = std::conditional_t<sizeof(XT) == 4, uint32_t, OT>;
  static constexpr int kRows = 128;
  static constexpr int kThreads = kRows / 16 * 32;
  static constexpr int kTC = sizeof(XT) == 4 ? 32 : UTile<XT>::kDepth;
  static constexpr int kStages = UTile<XT>::kWiden > 1 ? 2 : 3;
  static constexpr int kPlanes = sizeof(XT) == 4 ? 3 : 1;
  static constexpr int kEl = 16 / (int)sizeof(XT);
  static constexpr int kLd = kTC + kEl;
  static constexpr int kLdV = kTC + 16 / (int)sizeof(VT);
};

template <typename XT, int NT>
struct WRowSmem {
  using W = WRows<XT>;
  static constexpr int kXBytes = W::kRows * W::kLd * (int)sizeof(XT);
  static constexpr int kPlane =
      NT * 8 * W::kLdV * (int)sizeof(typename W::VT);
  static constexpr int kStage = kXBytes + W::kPlanes * kPlane;
  static constexpr int kBytes = W::kStages * kStage;
};

// One bf16 stage (one chain): xv_stage_mma's fragments and products, Vt's
// fragments by ldmatrix (load_b: the registers ld_pair would load).
template <bool kPairs, int NT>
__device__ __forceinline__ void xv_wide_stage(const __nv_bfloat16* alo,
                                              const __nv_bfloat16* ahi,
                                              const __nv_bfloat16* Bs,
                                              float (&part)[NT][4], int t) {
  constexpr int L = WRows<__nv_bfloat16>::kLdV;
  const int off = ldsm_offset(threadIdx.x & 31, L);
#pragma unroll
  for (int kk = 0; kk < WRows<__nv_bfloat16>::kTC; kk += 16) {
    const uint32_t a[4] = {ld_bf16x2<kPairs>(alo + kk + 2 * t),
                           ld_bf16x2<kPairs>(ahi + kk + 2 * t),
                           ld_bf16x2<kPairs>(alo + kk + 8 + 2 * t),
                           ld_bf16x2<kPairs>(ahi + kk + 8 + 2 * t)};
    uint32_t b[NT][2];
    load_b<NT>(b, Bs, L, off, kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(part[j], a, b[j][0], b[j][1]);
  }
}

// Two 8 x 8 matrices of 16-bit elements (8 x 4 of 32-bit ones), lanes 0-15
// giving the rows' addresses.
__device__ __forceinline__ void ldsm2(uint32_t (&b)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(a));
}

// One f32 stage (half a chain) in xv_stage_mma_6x's six TF32 products, in
// its order, Vt's parts read from their planes by ldmatrix.
template <bool kPairs, int NT>
__device__ __forceinline__ void xv_wide_stage(const float* alo,
                                              const float* ahi,
                                              const uint32_t* Bs,
                                              float (&part)[NT][4], int t) {
  using W = WRows<float>;
  constexpr int L = W::kLdV;
  constexpr int kPlane = NT * 8 * L;
  const int lane = threadIdx.x & 31;
  const uint32_t* bl = Bs + (lane & 7) * L + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int kk = 0; kk < W::kTC; kk += 8) {
    uint32_t ah[4], am[4], al[4];
    split3_tf32(alo[kk + t], ah[0], am[0], al[0]);
    split3_tf32(ahi[kk + t], ah[1], am[1], al[1]);
    split3_tf32(alo[kk + t + 4], ah[2], am[2], al[2]);
    split3_tf32(ahi[kk + t + 4], ah[3], am[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bm[2], bo[2];
      const uint32_t* b = bl + j * 8 * L + kk;
      ldsm2(bh, b);
      ldsm2(bm, b + kPlane);
      ldsm2(bo, b + 2 * kPlane);
      mma_tf32(part[j], am, bm[0], bm[1]);
      mma_tf32(part[j], ah, bo[0], bo[1]);
      mma_tf32(part[j], al, bh[0], bh[1]);
      mma_tf32(part[j], ah, bm[0], bm[1]);
      mma_tf32(part[j], am, bh[0], bh[1]);
      mma_tf32(part[j], ah, bh[0], bh[1]);
    }
  }
}

// 2. The row sweep: X V for all NT tiles of slice blockIdx.x % slices of
// the 128 rows of block blockIdx.x / slices, into the (n, k) scratch. Each
// output element is summed as xv_rows_kernel's (the two-sweep route's)
// stages sum it: chains of 128 (bf16, e4m3) or 64 (f32: two stages)
// columns, each from zero, promoted in order. Its registers hold NT x 4
// sums and as many chain partials: one CTA an SM at large NT.
template <typename XT, int NT, bool kPairs>
__global__ void __launch_bounds__(WRows<XT>::kThreads, 1)
    xv_wide_kernel(const XT* __restrict__ X, int n, int m, int k,
                   const void* __restrict__ Vt_, int ld_vt, int np,
                   int slices, float* __restrict__ XV) {
  using W = WRows<XT>;
  using VT = typename W::VT;
  using Sm = WRowSmem<XT, NT>;
  constexpr int NP = NT * 8;
  constexpr int L = W::kLd;
  constexpr int LV = W::kLdV;
  constexpr int TC = W::kTC;
  constexpr int kChunks = L / W::kEl;  // chunks per X tile row
  constexpr int S = W::kStages;
  constexpr int RA = W::kRows;
  constexpr int TA = W::kThreads;
  const int slice = (int)(blockIdx.x % (unsigned)slices);
  const int row0 = (int)(blockIdx.x / (unsigned)slices) * RA;
  const VT* Vt = static_cast<const VT*>(Vt_) + (size_t)slice * NP * ld_vt;
  const size_t vplane = (size_t)np * ld_vt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem_raw + (i % S) * Sm::kStage);
  };
  auto stage_v = [&](const XT* Xs) {
    return reinterpret_cast<VT*>(
        reinterpret_cast<unsigned char*>(const_cast<XT*>(Xs)) + Sm::kXBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (m + TC - 1) / TC;

  // Copy slots, as in xv_rows_kernel.
  constexpr int kXChunks = RA * kChunks;
  constexpr int kXSlots = (kXChunks + TA - 1) / TA;
  constexpr int kStep = TC * (int)sizeof(XT);
  const char* xsrc[kXSlots];
  int xleft[kXSlots], xdst[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int c = tid + s * TA, r = c / kChunks, q = c % kChunks;
    xdst[s] = c < kXChunks ? r * L + q * W::kEl : -1;
    xsrc[s] = reinterpret_cast<const char*>(X);
    xleft[s] = 0;
    if (c < kXChunks && row0 + r < n) {
      const char* rp =
          reinterpret_cast<const char*>(X + (size_t)(row0 + r) * m);
      xsrc[s] = reinterpret_cast<const char*>(
                    reinterpret_cast<uintptr_t>(rp) & ~uintptr_t(15)) +
                16 * q;
      xleft[s] = (int)(rp + (size_t)m * sizeof(XT) - xsrc[s]);
    }
  }
  auto load = [&](int i) {
    XT* Xs = stage_x(i);
    VT* Bs = stage_v(Xs);
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      if (xdst[s] < 0) continue;
      const bool ok = xleft[s] > i * kStep;
      cp_async16(Xs + xdst[s], ok ? xsrc[s] + (size_t)i * kStep : xsrc[s],
                 ok ? 16 : 0);
    }
    constexpr int kVEl = 16 / (int)sizeof(VT);
    constexpr int kVChunks = TC / kVEl;  // per Vt row
#pragma unroll
    for (int p = 0; p < W::kPlanes; ++p)
      for (int c = tid; c < NP * kVChunks; c += TA) {
        const int r = c / kVChunks, e = (c % kVChunks) * kVEl;
        if constexpr (UTile<XT>::kWiden > 1) {
          if (i * TC + e >= ld_vt) continue;  // a chain past m: skipped
        }
        cp_async16(Bs + p * NP * LV + r * LV + e,
                   Vt + p * vplane + (size_t)r * ld_vt + i * TC + e);
      }
  };

  const int rlo = warp * 16 + g, rhi = rlo + 8;
  const int olo = row0 + rlo < n ? row_offset(X, row0 + rlo, m) : 0;
  const int ohi = row0 + rhi < n ? row_offset(X, row0 + rhi, m) : 0;
  float acc[NT][4], part[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_tiles) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<S - 2>();  // tile i has landed
    __syncthreads();         // and every warp is done with tile i - 1
    if (i + S - 1 < n_tiles) load(i + S - 1);
    cp_async_commit();
    XT* Xs = stage_x(i);
    const int valid = m - i * TC;
    if (valid < TC) {  // last tile: zero the elements past m
      for (int e = tid; e < RA * TC; e += TA) {
        const int r = e / TC, j = e % TC;
        if (j >= valid && row0 + r < n)
          from_float(0.f, Xs[r * L + row_offset(X, row0 + r, m) + j]);
      }
      __syncthreads();
    }
    if constexpr (UTile<XT>::kWiden > 1) {
      // e4m3: the stage's chains are the bf16 form's tiles, each from zero,
      // promoted in order; a chain starting at or past m is none of them
      constexpr int CH = TC / UTile<XT>::kChain;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        if ((i * CH + h) * UTile<XT>::kChain >= m) break;
        float chain[NT][4] = {};
        xv_stage_mma<kPairs, NT>(Xs + rlo * L + olo + h * UTile<XT>::kChain,
                                 Xs + rhi * L + ohi + h * UTile<XT>::kChain,
                                 stage_v(Xs) + h * UTile<XT>::kChain, chain,
                                 g, t);
        promote(acc, chain);
      }
    } else {
      // a chain of UTile's kChain columns: one stage (bf16) or two (f32)
      constexpr int kPer = UTile<XT>::kChain / TC;
      xv_wide_stage<kPairs, NT>(Xs + rlo * L + olo, Xs + rhi * L + ohi,
                                stage_v(Xs), part, t);
      if (i % kPer == kPer - 1 || i == n_tiles - 1) {
        promote(acc, part);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  const int c0 = slice * NP;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + rlo + 8 * h, c = c0 + j * 8 + 2 * t + e;
        if (row < n && c < k) XV[(size_t)row * k + c] = acc[j][2 * h + e];
      }
}

// The column sweep's stages, two CTAs an SM: four stages at NT <= 8, three
// above (f32, U_new^T's hi and lo TF32 planes: three, and two above NT = 8).
template <typename XT, int NT>
struct WSmem {
  using Ti = UTile<XT>;
  static constexpr int kPlanes = sizeof(XT) == 4 ? 2 : 1;
  static constexpr int kStages = (NT <= 8 ? 4 : 3) - (kPlanes - 1);
  static constexpr int kXtBytes = Ti::kRows * Ti::kBLd * (int)sizeof(XT);
  static constexpr int kPlane = NT * 8 * Ti::kLdU * (int)sizeof(op_t<XT>);
  static constexpr int kStage = kXtBytes + kPlanes * kPlane;
  static constexpr int kBytes = kStages * kStage;
};

// b = tile j's B fragments of two k16 steps from a row-major [n][k] bf16
// tile (row stride ld elements, 16-byte aligned rows) by one ldmatrix.x4:
// (b[0], b[1]) at k offset kk, (b[2], b[3]) at kk + 16: the registers
// ld_pair would load.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4],
                                        const __nv_bfloat16* tile, int ld,
                                        int j, int kk) {
  const int lane = threadIdx.x & 31;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
      tile + (j * 8 + (lane & 7)) * ld + kk + (lane >> 3) * 8));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// One column-sweep stage for this warp's 16 columns, tile by tile: the
// stage's X^T fragments first (pos: this lane's rows of k-step 0, at their
// offsets; k-step s is s * 16 (f32: 8) rows on, whose offsets repeat),
// then each tile's chain over the stage from zero, promoted into acc. Each
// tile adds the products of xtu_stage_mma in its order.
template <int NT>
__device__ __forceinline__ void xtu_wide_stage(const __nv_bfloat16* Xs,
                                               const __nv_bfloat16* Us,
                                               const int (&pos)[4], int c,
                                               float (&acc)[NT][4]) {
  using Ti = UTile<__nv_bfloat16>;
  uint32_t a[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const __nv_bfloat16* x = Xs + s * 16 * Ti::kBLd + c;
    a[s][0] = pack_bf16(x + pos[0], x + pos[1]);
    a[s][1] = pack_bf16(x + pos[0] + 8, x + pos[1] + 8);
    a[s][2] = pack_bf16(x + pos[2], x + pos[3]);
    a[s][3] = pack_bf16(x + pos[2] + 8, x + pos[3] + 8);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 4; s += 2) {
      uint32_t b[4];
      load_b2(b, Us, Ti::kLdU, j, s * 16);
      mma_bf16(part, a[s], b[0], b[1]);
      mma_bf16(part, a[s + 1], b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
  }
}

// f32: U_new^T's hi and lo TF32 parts from their planes (split once by the
// epilogue, as split_tf32 splits each value in xtu_stage_mma), two k-steps
// of one tile a load.
template <int NT>
__device__ __forceinline__ void xtu_wide_stage(const float* Xs,
                                               const float* Us,
                                               const int (&pos)[4], int c,
                                               float (&acc)[NT][4]) {
  using Ti = UTile<float>;
  constexpr int L = Ti::kLdU;
  const int lane = threadIdx.x & 31;
  const float* ul = Us + (lane & 7) * L + (lane >> 3) * 4;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* x = Xs + s * 8 * Ti::kBLd + c;
    split_tf32(x[pos[0]], hi[s][0], lo[s][0]);
    split_tf32(x[pos[0] + 8], hi[s][1], lo[s][1]);
    split_tf32(x[pos[1]], hi[s][2], lo[s][2]);
    split_tf32(x[pos[1] + 8], hi[s][3], lo[s][3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 4; s += 2) {
      uint32_t bh[4], bl[4];
      const float* b = ul + j * 8 * L + s * 8;
      ldsm4(bh, b);
      ldsm4(bl, b + NT * 8 * L);
      mma_3xtf32(part, hi[s], lo[s], bh[0], bl[0], bh[1], bl[1]);
      mma_3xtf32(part, hi[s + 1], lo[s + 1], bh[2], bl[2], bh[3], bl[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
  }
}

// Block blockIdx.x of the column sweep: slice, column block and row
// segment, the slice fastest.
struct ColBlock {
  int slice, c0, seg;
  __device__ ColBlock(int slices, int col_blocks) {
    const int b = (int)blockIdx.x;
    slice = b % slices;
    c0 = (b / slices) % col_blocks * kBCols;
    seg = b / slices / col_blocks;
  }
};

// 4. numV (or its segment's partial) for 128 columns and one slice of NT
// tiles: xtu_cols_kernel's stages, copies and fragments, all the slice's
// tiles in one CTA.
template <typename XT, int NT>
__global__ void __launch_bounds__(kBThreads, 2)
    xtu_wide_kernel(const XT* __restrict__ X, int n, int m, int k,
                    const op_t<XT>* __restrict__ UxT, int ld_ux,
                    int seg_rows, int slices, int col_blocks,
                    float* __restrict__ out) {
  static_assert(UTile<XT>::kWiden == 1, "e4m3 X: xtu_wide_e4m3_kernel");
  using OT = op_t<XT>;
  using Sm = WSmem<XT, NT>;
  using Ti = UTile<XT>;
  constexpr int S = Sm::kStages;
  constexpr int RS = Ti::kRows;  // rows per stage
  constexpr int LU = Ti::kLdU;
  constexpr int BL = Ti::kBLd;
  constexpr int kChunks = (kBCols + Ti::kEl) / Ti::kEl;  // per X tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem_raw + (i % S) * Sm::kStage);
  };
  auto stage_u = [&](const XT* Xs) {
    return reinterpret_cast<OT*>(
        reinterpret_cast<unsigned char*>(const_cast<XT*>(Xs)) + Sm::kXtBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const ColBlock blk(slices, col_blocks);
  const int c0 = blk.c0;
  const int r_begin = blk.seg * seg_rows;
  const int seg_len = min(n, r_begin + seg_rows) - r_begin;
  const int n_stages = (seg_len + RS - 1) / RS;
  const int kc0 = blk.slice * NT * 8;  // this slice's first component
  const int kk = k - kc0;              // components past kc0 (masked below)
  UxT += (size_t)kc0 * ld_ux;
  // f32: the lo plane np_ux rows after the hi plane
  const size_t uplane = (size_t)slices * NT * 8 * ld_ux;

  // Copy slots, as in xtu_cols_kernel.
  constexpr int kXChunks = RS * kChunks;
  constexpr int kXSlots = (kXChunks + kBThreads - 1) / kBThreads;
  const size_t stage_bytes = (size_t)RS * m * sizeof(XT);
  const char* xsrc[kXSlots];
  int xrow[kXSlots], xdst[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int c = tid + s * kBThreads, r = c / kChunks, q = c % kChunks;
    const long long rel =
        (long long)(c0 - row_offset(X, r, m)) * (long long)sizeof(XT) + 16 * q;
    const bool cols =
        rel < (long long)min(c0 + kBCols, m) * (long long)sizeof(XT);
    xdst[s] = c < kXChunks ? r * BL + q * Ti::kEl : -1;
    xrow[s] = cols ? r : seg_rows;
    xsrc[s] = reinterpret_cast<const char*>(X + (size_t)r_begin * m) +
              (size_t)r * m * sizeof(XT) + rel;
  }

  auto load = [&](int i) {
    XT* Xs = stage_x(i);
    OT* Us = stage_u(Xs);
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      if (xdst[s] < 0) continue;
      const bool ok = xrow[s] + i * RS < seg_len;
      cp_async16(Xs + xdst[s], ok ? xsrc[s] + i * stage_bytes : xsrc[s],
                 ok ? 16 : 0);
    }
    constexpr int kUChunks = RS / Ti::kOEl;  // per UxT row
#pragma unroll
    for (int p = 0; p < Sm::kPlanes; ++p)
      for (int c = tid; c < NT * 8 * kUChunks; c += kBThreads) {
        const int r = c / kUChunks, e = (c % kUChunks) * Ti::kOEl;
        cp_async16(Us + p * NT * 8 * LU + r * LU + e,
                   UxT + p * uplane + (size_t)r * ld_ux + r_begin + i * RS +
                       e);
      }
  };

  // this lane's rows of k-step 0 (xtu_row); k-step s's are s * 16 (f32: 8)
  // rows on, at the same offsets within their 16-byte chunks
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = xtu_row<XT>(0, i, t);
    pos[i] = r * BL + row_offset(X, r, m);
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (i + S - 1 < n_stages) load(i + S - 1);
    cp_async_commit();
    const XT* Xs = stage_x(i);
    xtu_wide_stage<NT>(Xs, stage_u(Xs), pos, warp * 16 + g, acc);
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blk.seg * m * k + kc0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + warp * 16 + g + 8 * h, c = j * 8 + 2 * t;
      if (col < m) {
        if (c < kk) dst[(size_t)col * k + c] = acc[j][2 * h];
        if (c + 1 < kk) dst[(size_t)col * k + c + 1] = acc[j][2 * h + 1];
      }
    }
}

// 4, e4m3 X: xtu_cols_e4m3_kernel's stages and A pairs, all NT tiles in one
// CTA, tile by tile as xtu_wide_stage.
template <int NT, bool kPairs>
__global__ void __launch_bounds__(kBThreads, 2)
    xtu_wide_e4m3_kernel(const __nv_fp8_e4m3* __restrict__ X, int n, int m,
                         int k, const __nv_bfloat16* __restrict__ UxT,
                         int ld_ux, int seg_rows, int slices,
                         int col_blocks, float* __restrict__ out) {
  using Ti = UTile<__nv_fp8_e4m3>;
  using Sm = WSmem<__nv_fp8_e4m3, NT>;
  constexpr int S = Sm::kStages;
  constexpr int RS = Ti::kRows;  // rows per stage
  constexpr int LU = Ti::kLdU;
  constexpr int BL = Ti::kBLd;
  constexpr int kChunks = BL / 16;  // per X tile row
  static_assert(BL % 16 == 0, "X tile rows are whole chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto stage_x = [&](int i) { return smem_raw + (i % S) * Sm::kStage; };
  auto stage_u = [&](unsigned char* Xs) {
    return reinterpret_cast<__nv_bfloat16*>(Xs + Sm::kXtBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const ColBlock blk(slices, col_blocks);
  const int c0 = blk.c0;
  const int r_begin = blk.seg * seg_rows;
  const int seg_len = min(n, r_begin + seg_rows) - r_begin;
  const int n_stages = (seg_len + RS - 1) / RS;
  const int kc0 = blk.slice * NT * 8;
  const int kk = k - kc0;
  UxT += (size_t)kc0 * ld_ux;

  constexpr int kXChunks = RS * kChunks;
  constexpr int kXSlots = (kXChunks + kBThreads - 1) / kBThreads;
  const size_t stage_bytes = (size_t)RS * m;
  const char* xsrc[kXSlots];
  int xrow[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int c = tid + s * kBThreads, r = c / kChunks, q = c % kChunks;
    const long long rel = (long long)(c0 - row_offset(X, r, m)) + 16 * q;
    const bool cols = c < kXChunks && rel < (long long)min(c0 + kBCols, m);
    xrow[s] = cols ? r : seg_rows;
    xsrc[s] = reinterpret_cast<const char*>(X + (size_t)r_begin * m) +
              (size_t)r * m + rel;
  }

  auto load = [&](int i) {
    unsigned char* Xs = stage_x(i);
    __nv_bfloat16* Us = stage_u(Xs);
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      const int c = tid + s * kBThreads;
      if (c >= kXChunks) continue;
      const bool ok = xrow[s] + i * RS < seg_len;
      cp_async16(Xs + 16 * c, ok ? xsrc[s] + i * stage_bytes : xsrc[s],
                 ok ? 16 : 0);
    }
    constexpr int kUChunks = RS / Ti::kOEl;  // per UxT row
    for (int c = tid; c < NT * 8 * kUChunks; c += kBThreads) {
      const int r = c / kUChunks, e = (c % kUChunks) * Ti::kOEl;
      cp_async16(Us + r * LU + e,
                 UxT + (size_t)r * ld_ux + r_begin + i * RS + e);
    }
  };

  int v_at[4], sh[4];  // as in xtu_cols_e4m3_kernel
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * t + (i & 1) + 8 * (i >> 1);
    const int b = r * BL + row_offset(X, r, m) + warp * 16 + 2 * g;
    v_at[i] = kPairs ? b : b & ~3;
    sh[i] = 8 * (b & 3);
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (i + S - 1 < n_stages) load(i + S - 1);
    cp_async_commit();
    unsigned char* Xs = stage_x(i);
    const __nv_bfloat16* Us = stage_u(Xs);
    // the stage's A pairs (xtu_e4m3_chain's), then each tile's chain
    uint32_t a[Ti::kRows / 16][4];
#pragma unroll
    for (int s = 0; s < Ti::kRows / 16; ++s) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned char* p = Xs + s * 16 * BL + v_at[q];
        if constexpr (kPairs) {
          v[q] = *reinterpret_cast<const unsigned short*>(p);
        } else {
          v[q] = __funnelshift_r(*reinterpret_cast<const uint32_t*>(p),
                                 *reinterpret_cast<const uint32_t*>(p + 4),
                                 sh[q]);
        }
      }
      a[s][0] = e4m3x2_to_bf16x2(__byte_perm(v[0], v[1], 0x0040));
      a[s][1] = e4m3x2_to_bf16x2(__byte_perm(v[0], v[1], 0x0051));
      a[s][2] = e4m3x2_to_bf16x2(__byte_perm(v[2], v[3], 0x0040));
      a[s][3] = e4m3x2_to_bf16x2(__byte_perm(v[2], v[3], 0x0051));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < Ti::kRows / 16; s += 2) {
        uint32_t b[4];
        load_b2(b, Us, LU, j, s * 16);
        mma_bf16(part, a[s], b[0], b[1]);
        mma_bf16(part, a[s + 1], b[2], b[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[q];
    }
  }
  cp_async_wait<0>();

  // A rows g and g + 8 of the warp's tile are its columns 2g and 2g + 1
  float* dst = out + (size_t)blk.seg * m * k + kc0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + warp * 16 + 2 * g + h, c = j * 8 + 2 * t;
      if (col < m) {
        if (c < kk) dst[(size_t)col * k + c] = acc[j][2 * h];
        if (c + 1 < kk) dst[(size_t)col * k + c + 1] = acc[j][2 * h + 1];
      }
    }
}

// 3. The row epilogue on tiles of rows.
constexpr int kWRows = 64;     // rows per CTA: one Gram partial
constexpr int kWThreads = 256;
constexpr int kWWarps = kWThreads / 32;
constexpr int kWGroup = 4;     // rows a warp takes at a time
constexpr int kWQ = 4;         // components a lane takes per pass (32 apart)

// acc[r][q] = sum over l < k, in order, of A[ar[r] * k + l] * B[l, c0 +
// lane + 32 q] for B row-major k x k, q < QN (components past k give 0): a
// register tile of kWGroup rows by QN components, the rows' values
// broadcast to the warp.
template <typename Acc, int QN>
__device__ __forceinline__ void rows_times_q(const float* A,
                                             const int (&ar)[kWGroup],
                                             const float* B, int k, int c0,
                                             Acc (&acc)[kWGroup][kWQ]) {
  const int lane = threadIdx.x & 31;
  const float* bq = B + c0 + lane;
  bool ok[QN];
#pragma unroll
  for (int q = 0; q < QN; ++q) ok[q] = c0 + lane + 32 * q < k;
#pragma unroll
  for (int r = 0; r < kWGroup; ++r)
#pragma unroll
    for (int q = 0; q < kWQ; ++q) acc[r][q] = Acc(0);
#pragma unroll 2
  for (int l = 0; l < k; ++l) {
    float av[kWGroup], bv[QN];
#pragma unroll
    for (int r = 0; r < kWGroup; ++r) av[r] = A[ar[r] * k + l];
#pragma unroll
    for (int q = 0; q < QN; ++q)
      bv[q] = ok[q] ? bq[(size_t)l * k + 32 * q] : 0.f;
#pragma unroll
    for (int r = 0; r < kWGroup; ++r)
#pragma unroll
      for (int q = 0; q < QN; ++q) acc[r][q] += (Acc)av[r] * (Acc)bv[q];
  }
}

template <typename Acc>
__device__ __forceinline__ void rows_times(const float* A,
                                           const int (&ar)[kWGroup],
                                           const float* B, int k, int c0,
                                           Acc (&acc)[kWGroup][kWQ]) {
  switch (min(kWQ, (k - c0 + 31) / 32)) {  // warp-uniform
    case 1: rows_times_q<Acc, 1>(A, ar, B, k, c0, acc); break;
    case 2: rows_times_q<Acc, 2>(A, ar, B, k, c0, acc); break;
    case 3: rows_times_q<Acc, 3>(A, ar, B, k, c0, acc); break;
    default: rows_times_q<Acc, 4>(A, ar, B, k, c0, acc); break;
  }
}

// Where the epilogue keeps its operands (the host's choice, wide_epi_smem):
// the kMats k x k matrices and the warps' two row tiles in shared memory
// when they fit, else read from device memory (the inputs, and U_new's
// rows and the scratch's as the tiles); the CTA's U_new rows in shared
// memory for UxT and the Gram partial when they fit.
struct WideEpiSmem {
  int bytes;       // dynamic shared memory of the launch
  int mats_smem;   // the matrices at offset 0
  int tiles_smem;  // the warps' tiles after them
  int gram_smem;   // the U_new tile at offset 0, once the rows are done
};

// row stride of the U_new tile: odd, so that a warp's reads down a column
// meet no bank twice
__host__ __device__ inline int wide_tile_ld(int k) { return k | 1; }

inline WideEpiSmem wide_epi_smem(int k, int mats, int optin) {
  const long long mb = 4LL * mats * k * k;
  const long long tb = 4LL * kWWarps * 2 * kWGroup * k;
  const long long gb = 4LL * kWRows * wide_tile_ld(k);
  WideEpiSmem s{0, 0, 0, 0};
  s.tiles_smem = tb <= optin;
  s.mats_smem = s.tiles_smem && mb + tb <= optin;
  s.gram_smem = gb <= optin;
  const long long p1 = (s.mats_smem ? mb : 0) + (s.tiles_smem ? tb : 0);
  s.bytes = (int)max(p1, s.gram_smem ? gb : 0LL);
  return s;
}

// U_new^T's element (c, row): X's operand type, or for f32 X its hi and lo
// TF32 parts in two planes np_ld apart (split_tf32, the split the column
// sweep applies to each value).
__device__ __forceinline__ void write_ux(__nv_bfloat16* UxT, size_t at,
                                         size_t, float v) {
  from_float(v, UxT[at]);
}
__device__ __forceinline__ void write_ux(float* UxT, size_t at, size_t np_ld,
                                         float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  UxT[at] = __uint_as_float(hi);
  UxT[np_ld + at] = __uint_as_float(lo);
}

// Epi provides kMats, U, mat(i) (the i-th k x k matrix), and
// group(r0, nv, mats, t0, t1, XV, Unew): the epilogue of rows r0 ...
// r0 + nv - 1 (nv <= kWGroup; the group's rows past them read row
// r0 + nv - 1 and write nothing), U_new's rows written to Unew; t0 and t1
// the warp's two row tiles (row r at t + r * k), in shared memory or
// U_new's and the scratch's rows. kSmem: the matrices, the tiles and the
// U_new tile all in shared memory (every pointer into it derived from the
// shared array, so its loads compile as shared ones); else wherever sm
// says, through generic pointers.
template <typename OT, typename Epi, bool kSmem>
__global__ void __launch_bounds__(kWThreads, 2)
    wide_epi_kernel(int n, int k, int np, Epi epi, const float* XV,
                    float* scratch, float* Unew, OT* __restrict__ UxT,
                    int ld_ux, float* __restrict__ gram_part,
                    WideEpiSmem sm) {
  if constexpr (kSmem) sm.mats_smem = sm.tiles_smem = sm.gram_smem = 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sbase = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kWRows;
  const long long kk2 = (long long)k * k;
  // the block's rows of U and X V into L2 (one contiguous run each), while
  // the matrices come in by asynchronous copies, all in flight at once
  {
    const int rows = min(kWRows, n - row0);
    const char* ub = reinterpret_cast<const char*>(epi.U + (size_t)row0 * k);
    const char* xb = reinterpret_cast<const char*>(XV + (size_t)row0 * k);
    for (int b = tid * 128; b < rows * k * 4; b += kWThreads * 128) {
      prefetch_l2(ub + b);
      prefetch_l2(xb + b);
    }
  }
  const float* mats[Epi::kMats];
#pragma unroll
  for (int i = 0; i < Epi::kMats; ++i) {
    if (sm.mats_smem) {
      float* d = sbase + i * kk2;
      const float* src = epi.mat(i);
      for (int e = tid; e < kk2; e += kWThreads) cp_async4(d + e, src + e);
      mats[i] = d;
    } else {
      mats[i] = epi.mat(i);
    }
  }
  cp_async_commit();
  float* tiles = sbase + (sm.mats_smem ? Epi::kMats * kk2 : 0) +
                 (size_t)warp * 2 * kWGroup * k;
  cp_async_wait<0>();
  __syncthreads();
  for (int r0 = row0 + warp * (kWRows / kWWarps);
       r0 < row0 + (warp + 1) * (kWRows / kWWarps); r0 += kWGroup) {
    if (r0 >= n) break;  // warp-uniform
    float* t0 = sm.tiles_smem ? tiles : scratch + (size_t)r0 * k;
    float* t1 = sm.tiles_smem ? tiles + kWGroup * k : Unew + (size_t)r0 * k;
    epi.group(r0, min(kWGroup, n - r0), mats, t0, t1, XV, Unew);
  }
  __syncthreads();  // every row of the block is written
  const int rows = min(kWRows, n - row0);
  const int ld = sm.gram_smem ? wide_tile_ld(k) : k;
  const float* T = Unew + (size_t)row0 * k;
  if (sm.gram_smem) {
    float* Ts = sbase;
#pragma unroll 4
    for (int e = tid; e < rows * k; e += kWThreads) {
      const int r = e / k, c = e % k;
      Ts[r * ld + c] = T[(size_t)r * k + c];
    }
    T = Ts;
    __syncthreads();
  }
  const size_t np_ld = (size_t)np * ld_ux;
  for (int e = tid; e < np * kWRows; e += kWThreads) {
    const int c = e / kWRows, r = e % kWRows;
    write_ux(UxT, (size_t)c * ld_ux + row0 + r, np_ld,
             r < rows && c < k ? T[(size_t)r * ld + c] : 0.f);
  }
  // The Gram partial: warp units of 4 rows a (broadcast) by the lane's
  // columns b = b0 + lane + 32 j, each element summed over the rows in
  // order from zero.
  const int na = (k + 3) / 4, nb = (k + 32 * kWQ - 1) / (32 * kWQ);
  float* gp = gram_part + (size_t)blockIdx.x * kk2;
  for (int u = warp; u < na * nb; u += kWWarps) {
    const int a0 = u / nb * 4, b0 = u % nb * 32 * kWQ + lane;
    int ca[4], cb[kWQ];
#pragma unroll
    for (int i = 0; i < 4; ++i) ca[i] = min(a0 + i, k - 1);
#pragma unroll
    for (int j = 0; j < kWQ; ++j) cb[j] = min(b0 + 32 * j, k - 1);
    float s[4][kWQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kWQ; ++j) s[i][j] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float* u_r = T + (size_t)r * ld;
      float x[4], y[kWQ];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = u_r[ca[i]];
#pragma unroll
      for (int j = 0; j < kWQ; ++j) y[j] = u_r[cb[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kWQ; ++j) s[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kWQ; ++j)
        if (a0 + i < k && b0 + 32 * j < k)
          gp[(size_t)(a0 + i) * k + b0 + 32 * j] = s[i][j];
  }
}

// 5. Blocks below num_blocks: numV as u_pass_reduce_kernel sums it; the
// rest: gramU for 32 elements a block, in u_pass_reduce_kernel's order
// (lane class l sums the partials l, l + 32, ... in order; then the
// butterfly over the 32 classes, xor 16, 8, 4, 2, 1), its partials read
// with the elements along the lanes: warp w sums classes w, w + 8, ...
// for the block's 32 elements, and the butterfly runs in registers.
__global__ void __launch_bounds__(256)
    wide_reduce_kernel(const float* __restrict__ numv_part, int n_seg,
                       long long mk, int num_blocks, float* __restrict__ numV,
                       const float* __restrict__ gram_part, int n_gram,
                       int kk, float* __restrict__ gramU) {
  if ((int)blockIdx.x < num_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= mk) return;
    float s = 0.f;
    for (int p = 0; p < n_seg; ++p) s += numv_part[(long long)p * mk + e];
    numV[e] = s;
    return;
  }
  __shared__ float cls[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = ((int)blockIdx.x - num_blocks) * 32 + lane;
  for (int l = warp; l < 32; l += 8) {
    float s = 0.f;
    if (e < kk)
      for (int p = l; p < n_gram; p += 32)
        s += gram_part[(long long)p * kk + e];
    cls[l][lane] = s;
  }
  __syncthreads();
  if (warp != 0 || e >= kk) return;
  float v[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) v[l] = cls[l][lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float w[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) w[l] = v[l] + v[l ^ o];
#pragma unroll
    for (int l = 0; l < 32; ++l) v[l] = w[l];
  }
  gramU[e] = v[0];
}

// Launches. Each kernel's shared-memory limit is set once per library (the
// static flags of templates instantiated in this library alone).
template <typename XT, int NT, bool kPairs>
int launch_wide_rows(const XT* X, int n, int m, int k, const UPassWork& w,
                     int slices, float* xv, cudaStream_t st) {
  constexpr int smem = WRowSmem<XT, NT>::kBytes;
  static bool ready = false;
  if (int e = allow_smem(xv_wide_kernel<XT, NT, kPairs>, smem, ready))
    return e;
  const long long blocks = (long long)ceil_div(n, WRows<XT>::kRows) * slices;
  xv_wide_kernel<XT, NT, kPairs><<<(unsigned)blocks, WRows<XT>::kThreads,
                                   smem, st>>>(X, n, m, k, w.vt, w.ld_vt,
                                               8 * NT * slices, slices, xv);
  return 0;
}

template <typename XT, int NT>
int launch_wide_rows_aligned(const XT* X, int n, int m, int k,
                             const UPassWork& w, int slices, float* xv,
                             cudaStream_t st) {
  if constexpr (sizeof(XT) < 4) {
    if (reinterpret_cast<uintptr_t>(X) % (2 * sizeof(XT)) == 0 && m % 2 == 0)
      return launch_wide_rows<XT, NT, true>(X, n, m, k, w, slices, xv, st);
    return launch_wide_rows<XT, NT, false>(X, n, m, k, w, slices, xv, st);
  } else {
    return launch_wide_rows<XT, NT, true>(X, n, m, k, w, slices, xv, st);
  }
}

template <typename XT, int NT>
int launch_wide_cols(const XT* X, int n, int m, int k, float* numV,
                     const UPassWork& w, int slices, cudaStream_t st) {
  constexpr int smem = WSmem<XT, NT>::kBytes;
  const int col_blocks = ceil_div(m, kBCols);
  const long long blocks = (long long)slices * col_blocks * w.n_seg;
  float* out = w.n_seg == 1 ? numV : w.numv_part;
  if constexpr (UTile<XT>::kWiden > 1) {
    static bool ready_p = false, ready_u = false;
    const __nv_bfloat16* ux = static_cast<const __nv_bfloat16*>(w.uxt);
    if (reinterpret_cast<uintptr_t>(X) % 2 == 0 && m % 2 == 0) {
      if (int e = allow_smem(xtu_wide_e4m3_kernel<NT, true>, smem, ready_p))
        return e;
      xtu_wide_e4m3_kernel<NT, true><<<(unsigned)blocks, kBThreads, smem,
                                       st>>>(X, n, m, k, ux, w.ld_ux,
                                             w.seg_rows, slices, col_blocks,
                                             out);
    } else {
      if (int e = allow_smem(xtu_wide_e4m3_kernel<NT, false>, smem, ready_u))
        return e;
      xtu_wide_e4m3_kernel<NT, false><<<(unsigned)blocks, kBThreads, smem,
                                        st>>>(X, n, m, k, ux, w.ld_ux,
                                              w.seg_rows, slices, col_blocks,
                                              out);
    }
  } else {
    static bool ready = false;
    if (int e = allow_smem(xtu_wide_kernel<XT, NT>, smem, ready)) return e;
    xtu_wide_kernel<XT, NT><<<(unsigned)blocks, kBThreads, smem, st>>>(
        X, n, m, k, static_cast<const op_t<XT>*>(w.uxt), w.ld_ux, w.seg_rows,
        slices, col_blocks, out);
  }
  return 0;
}

template <typename OT, typename Epi>
int launch_wide_epi(int n, int k, int np, const Epi& epi, float* xv,
                    float* scratch, float* Unew, const UPassWork& w,
                    cudaStream_t st) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int optin = smem_optin(dev);
  static bool ready_s = false, ready_g = false;
  const WideEpiSmem sm = wide_epi_smem(k, Epi::kMats, optin);
  const dim3 grid(ceil_div(n, kWRows));
  if (sm.mats_smem && sm.tiles_smem && sm.gram_smem) {
    if (int e = allow_smem(wide_epi_kernel<OT, Epi, true>, optin, ready_s))
      return e;
    wide_epi_kernel<OT, Epi, true><<<grid, kWThreads, sm.bytes, st>>>(
        n, k, np, epi, xv, scratch, Unew, static_cast<OT*>(w.uxt), w.ld_ux,
        w.gram_part, sm);
  } else {
    if (int e = allow_smem(wide_epi_kernel<OT, Epi, false>, optin, ready_g))
      return e;
    wide_epi_kernel<OT, Epi, false><<<grid, kWThreads, sm.bytes, st>>>(
        n, k, np, epi, xv, scratch, Unew, static_cast<OT*>(w.uxt), w.ld_ux,
        w.gram_part, sm);
  }
  return 0;
}

// The whole call for X's dtype XT at k > 32.
template <typename XT, typename Epi>
int launch_u_pass_wide_xt(const XT* X, const float* V, int n, int m, int k,
                          int nt, int slices, const Epi& epi, float* Unew,
                          float* numV, float* gramU, const UPassWork& w,
                          cudaStream_t st) {
  const int np = 8 * nt * slices;
  float* xv = w.numv_part;
  float* scratch = w.numv_part + (size_t)n * k;
  const long long n_vt = (long long)np * w.ld_vt;
  if constexpr (sizeof(XT) == 4)
    vt_split_kernel<<<(int)((n_vt + 255) / 256), 256, 0, st>>>(
        V, m, k, np, w.ld_vt, static_cast<uint32_t*>(w.vt));
  else
    vt_kernel<op_t<XT>><<<(int)((n_vt + 255) / 256), 256, 0, st>>>(
        V, m, k, np, w.ld_vt, static_cast<op_t<XT>*>(w.vt));
  if (int e = with_wide_nt(nt, [&](auto NT) {
        return launch_wide_rows_aligned<XT, decltype(NT)::value>(
            X, n, m, k, w, slices, xv, st);
      }))
    return e;
  if (int e = launch_wide_epi<op_t<XT>>(n, k, np, epi, xv, scratch, Unew, w,
                                        st))
    return e;
  if (int e = with_wide_nt(nt, [&](auto NT) {
        return launch_wide_cols<XT, decltype(NT)::value>(X, n, m, k, numV, w,
                                                         slices, st);
      }))
    return e;
  const long long mk = (long long)m * k;
  const int num_blocks = w.n_seg > 1 ? (int)((mk + 255) / 256) : 0;
  wide_reduce_kernel<<<num_blocks + ceil_div(k * k, 32), 256, 0, st>>>(
      w.numv_part, w.n_seg, mk, num_blocks, numV, w.gram_part,
      ceil_div(n, kWRows), k * k, gramU);
  return (int)cudaGetLastError();
}

// The whole call for X's dtype code (common.cuh: XDtype); the plan must be
// a two-sweep plan (no clusters) at k > 32 whose `slices` slices of `nt` n8
// tiles each cover the k components, none of them empty.
template <typename Epi>
int launch_u_pass_wide(int x_dtype, const void* X, const float* V, int n,
                       int m, int k, int nt, int slices, const Epi& epi,
                       float* Unew, float* numV, float* gramU,
                       const UPassWork& w, cudaStream_t st) {
  if (k <= kMaxK || w.clusters != 0 || !plan_ok(n, m, k, w) || nt < 1 ||
      slices < 1 || 8LL * nt * slices < k || 8LL * nt * (slices - 1) >= k)
    return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case kXF32:
      return launch_u_pass_wide_xt(static_cast<const float*>(X), V, n, m, k,
                                   nt, slices, epi, Unew, numV, gramU, w,
                                   st);
    case kXBF16:
      return launch_u_pass_wide_xt(static_cast<const __nv_bfloat16*>(X), V,
                                   n, m, k, nt, slices, epi, Unew, numV,
                                   gramU, w, st);
    case kXE4M3:
      return launch_u_pass_wide_xt(static_cast<const __nv_fp8_e4m3*>(X), V,
                                   n, m, k, nt, slices, epi, Unew, numV,
                                   gramU, w, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pycmf
