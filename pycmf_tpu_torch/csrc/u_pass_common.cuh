// Shared skeleton of the two fused U-pass kernels (mu_fused.cu,
// newton_fused.cu), on Hopper's tensor cores.
//
// Both stream the data matrix X (n, m) row-major, stored as f32, bf16 or
// e4m3 (fp8), against thin f32 factors. X is contracted in its operand
// type OT (op_t): its own for f32 and bf16, bf16 for e4m3, whose values are
// converted to bf16 in registers as each mma fragment is built (exact for
// every finite e4m3 value), so V and U_new are never rounded below bf16.
// For k <= 32 a call runs four kernels on the caller's stream:
//
//   1. vt_kernel        Vt (NP x ld_vt) = V^T rounded to OT, zero past
//                       k and m (NP = k rounded up to 8: the n8 tiles).
//   2. xv_rows_kernel   one 128-thread CTA per 64 rows sweeps all m columns:
//                       X V on mma.sync tiles (bf16 m16n8k16, for e4m3 X
//                       too; f32 3xTF32 m16n8k8), X and Vt tiles of 128
//                       (bf16) or 64 (f32) columns per row fed by a
//                       3-stage ring of 16-byte cp.async copies. With
//                       the rows' X V in its registers the CTA runs the
//                       caller's row epilogue
//                       (the MU ratio, or the Newton step and line search):
//                       one warp per row, one factor component per lane. It
//                       writes U_new, UxT (U_new^T rounded to OT, zero
//                       for rows past n and for components past k) and the
//                       CTA's partial of U_new^T U_new.
//                       e4m3 X: 128 rows per 256-thread CTA (two blocks of
//                       64 rows for the epilogue's partials) and stages of
//                       256 columns in a 2-stage ring (below).
//   3. xtu_cols_kernel  one 256-thread CTA per 128 columns and row segment:
//                       X^T Ux on mma.sync tiles (A = the X tile read
//                       transposed from shared memory, B = UxT), rows fed by
//                       a 4-stage cp.async ring; numV directly when there is
//                       one row segment, else per-segment partials.
//                       e4m3 X: xtu_cols_e4m3_kernel, the same CTAs and
//                       stages with its own fragment reads (below).
//   4. u_pass_reduce_kernel sums the row segments' partials (numV) and the
//                       row sweep's Gram partials (gramU), each in order.
//
// For k > 32 the wide route of u_pass_wide.cuh (its own library,
// u_pass_wide.cu) runs these sweeps' stages with every n8 tile of the factor
// dimension in one CTA and the epilogue in a kernel of its own.
//
// Each stage's mma chain starts from zero and is added to the running f32
// sum in ordinary rounded adds (promote): a chain over all of m or n lost
// ~1e-4 of a positive sum to the tensor cores' truncated alignment.
//
// f32 X at k <= 32 takes the cluster route of u_pass_cluster.cuh where the
// plan gives it (m up to 9984-12288 by k): one read of X per call.
// Elsewhere X is read twice per call (kernels 2 and 3). No float atomics:
// every sum has a fixed order that does not depend on timing, so results
// repeat bit for bit. Products of two bf16 values are exact in f32, so bf16
// X is the reference's arithmetic (V and U_new rounded to bf16, f32
// accumulation) in another summation order; f32 X keeps HIGHEST-class
// products through the 3xTF32 split.
//
// e4m3 X: the row sweep's cp.async stages move as many bytes as the bf16
// form's, 256 columns, and hold two of its 128-column mma chains, each from
// zero and promoted in the bf16 form's order with its k index for every
// product (a chain past m is skipped, as the bf16 form has no such tile);
// its 128-row CTAs read each Vt tile once for twice the rows. The column
// sweep keeps the bf16 form's 64-row stages; its warps take columns 2g and
// 2g + 1 as the mma's rows g and g + 8, so a 16-bit read of a row serves
// both. Vt's and UxT's fragments come by ldmatrix. The plan is the bf16
// call's (u_pass_plan takes the operand's bytes), so an e4m3 call adds the
// same f32 products in the same order as the bf16 call on X widened to
// bf16: the two are equal bit for bit.
//
// Alignment: rows of X start on any element boundary (m = 11314 bf16 rows
// are 22628 bytes, 4-byte aligned; odd m leaves them 2-byte aligned, and
// e4m3 rows of odd m start on any byte), and cp.async moves aligned
// 16-byte chunks. Each tile row is copied as the aligned chunks covering
// it, so row r's first column lands at element offset o_r < 16 /
// sizeof(XT) of its shared-memory row; the fragment loads add o_r, and
// read element pairs whole only where every pair is aligned (kPairs).
// Chunks that hold no element of the tile are zero-filled without a read;
// the row sweep zeroes the elements past m in the last column tile
// (the next row's values, or bytes past the end of X). Each thread's chunk
// addresses are computed once per sweep and stepped per stage.
//
// Bound and what holds it back: bytes of X, twice (0.41 ms at the main-path
// shape on an H100; e4m3 0.20). Both bf16 sweeps run at about 2 TB/s, two
// thirds of the rate at which a plain reduction streams X; per-row bulk
// copies (the TMA engine) in place of cp.async, and 256-column slices in
// the column sweep, were measured and did not close that gap (PERF.md).
// The e4m3 sweeps run at about 1.7-1.8 TB/s: removing the conversion
// altogether (a bit move, wrong values) gained nothing; the copies alone
// and the mma work alone each take most of a sweep's time, and they
// overlap poorly at the column sweep's 178 CTAs, whose row segments are
// the bf16 plan's (which fixes its bits; PERF.md). One pass over X is
// later work.
//
// The plan (row segments, leading dimensions, workspace layout) is computed
// by the Python wrapper (ops/kernels/mu_fused.py: u_pass_plan) and passed
// in; the entry points check it.
#pragma once

#include "common.cuh"

namespace pycmf {

// Row sweep (kernel 2): rows per CTA, warps, stages.
constexpr int kARows = 64;
constexpr int kAWarps = kARows / 16;
constexpr int kAThreads = kAWarps * 32;
constexpr int kAStages = 3;
// e4m3 X: rows per CTA (two of the epilogue's 64-row blocks, so each Vt
// tile serves twice the rows of X), chains per stage, stages.
constexpr int kARowsE4M3 = 128;
constexpr int kAChainsE4M3 = 2;
constexpr int kAStagesE4M3 = 2;
// Column sweep (kernel 3): columns per CTA, warps, stages.
constexpr int kBCols = 128;
constexpr int kBWarps = kBCols / 16;
constexpr int kBThreads = kBWarps * 32;
constexpr int kBStages = 4;

// The type X is contracted in: its own, or bf16 for e4m3 X.
template <typename XT>
struct OpOf {
  using type = XT;
};
template <>
struct OpOf<__nv_fp8_e4m3> {
  using type = __nv_bfloat16;
};
template <typename XT>
using op_t = typename OpOf<XT>::type;

// Per X dtype: X and operand elements per 16-byte chunk; kWiden, the
// operand's bytes per byte of X (2 for e4m3 X, else 1); the row sweep's
// chain depth in elements (256 bytes of each operand row: long enough runs
// for DRAM), its stage depth (e4m3 X: kAChainsE4M3 chains, the bytes of
// bf16's stage) and the row strides of its X and Vt tiles; the column
// sweep's stage height, the row stride of its X tile (bank spread, 16-byte
// rows) and of its UxT tile.
template <typename XT>
struct UTile {
  using OT = op_t<XT>;
  static constexpr int kWiden = (int)(sizeof(OT) / sizeof(XT));
  static constexpr int kEl = 16 / (int)sizeof(XT);
  static constexpr int kOEl = 16 / (int)sizeof(OT);
  static constexpr int kChain = 256 / (int)sizeof(OT);  // 128; f32: 64
  static constexpr int kDepth =
      (kWiden > 1 ? kAChainsE4M3 : 1) * kChain;  // e4m3: 256
  static constexpr int kLd = kDepth + kEl;
  static constexpr int kLdV = kDepth + kOEl;
  static constexpr int kRows = 128 / (int)sizeof(OT);   // 64; f32: 32
  static constexpr int kBLd = kBCols + (kEl > 8 ? kEl : 8);
  static constexpr int kLdU = kRows + kOEl;
};

// Element offset of X[row, 0] within its 16-byte chunk.
template <typename XT>
__device__ __forceinline__ int row_offset(const XT* X, int row, int m) {
  return (int)((reinterpret_cast<uintptr_t>(X + (size_t)row * m) & 15) /
               sizeof(XT));
}

// 32 bits holding p[0] (low half) and p[1]; kPairs: p is 4-byte aligned.
template <bool kPairs>
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  if constexpr (kPairs) {
    return ld_pair(p);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    return (uint32_t)h[0] | ((uint32_t)h[1] << 16);
  }
}

// Two bf16 values from two shared-memory locations, a in the low half.
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* a,
                                              const __nv_bfloat16* b) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(a) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(b) << 16);
}

// Two e4m3 values (v: the first in the low byte; bits 16-31 ignored) as a
// bf16 pair, the first in the low half: cvt.rn.f16x2.e4m3x2, then f16 ->
// f32 -> bf16, each step exact for every finite e4m3 value, NaN to NaN.
// Integer operations and one bf16x2 multiply by 2^120 give the same bits
// off the conversion pipe, but ran slower in both sweeps (PERF.md §6).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3));
  const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(h));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// 16 bits holding p[0] (low byte) and p[1]; kPairs: p is 2-byte aligned.
template <bool kPairs>
__device__ __forceinline__ uint32_t ld_e4m3x2(const __nv_fp8_e4m3* p) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
  if constexpr (kPairs) {
    return *reinterpret_cast<const unsigned short*>(b);
  } else {
    return (uint32_t)b[0] | ((uint32_t)b[1] << 8);
  }
}

// B fragments from a row-major [n][k] bf16 tile in shared memory (row
// stride ld elements, 16-byte aligned rows), by ldmatrix: the registers
// ld_pair would load, with one instruction per two n8 tiles. Lane l gives
// the address of row l % 8 of matrix l / 8; matrix q holds tile q / 2's
// rows at k offset 8 (q % 2): ldsm_offset.
__device__ __forceinline__ int ldsm_offset(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// b[j] = tile j's (b0, b1) at k offset kk; off = ldsm_offset(lane, ld).
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2],
                                       const __nv_bfloat16* tile, int ld,
                                       int off, int kk) {
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) {
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(tile + j * 8 * ld + off + kk));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
        : "r"(a));
  }
  if constexpr (NT % 2 == 1) {
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(tile + (NT - 1) * 8 * ld + off + kk));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b[NT - 1][0]), "=r"(b[NT - 1][1])
                 : "r"(a));
  }
}

// acc += part, in f32 adds rounded to nearest. The tensor cores align the
// products to the accumulator's exponent and drop the bits below it, so a
// chain of thousands of mma steps into one register loses ~1e-4 of a
// positive sum; each stage's short chain starts from zero instead.
template <int NT>
__device__ __forceinline__ void promote(float (&acc)[NT][4],
                                        const float (&part)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
}

// y[lane] = sum_l x[l] * M[l, lane] with x spread one component per lane
// and M (KP x KP, zero-padded) in shared memory.
template <int KP>
__device__ __forceinline__ float lane_matvec(float x, const float* M, int k) {
  const int lane = threadIdx.x & 31;
  float y = 0.f;
  for (int l = 0; l < k; ++l) {
    const float xl = __shfl_sync(kFull, x, l);
    y += xl * (lane < k ? M[l * KP + lane] : 0.f);
  }
  return y;
}

// Copy a k x k row-major matrix into a zero-padded KP x KP shared buffer.
template <int KP>
__device__ __forceinline__ void stage_kxk(const float* __restrict__ A, int k,
                                          float* As) {
  for (int e = threadIdx.x; e < KP * KP; e += blockDim.x) {
    const int a = e / KP, b = e % KP;
    As[e] = (a < k && b < k) ? A[a * k + b] : 0.f;
  }
}

// 1. Vt[c, j] = round_OT(V[j, c]) for c < k and j < m, else 0.
template <typename OT>
__global__ void vt_kernel(const float* __restrict__ V, int m, int k, int np,
                          int ld, OT* __restrict__ Vt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)np * ld) return;
  const int c = (int)(idx / ld), j = (int)(idx % ld);
  from_float(c < k && j < m ? V[(size_t)j * k + c] : 0.f, Vt[idx]);
}

// The row sweep's rows and threads per CTA for X's dtype.
template <typename XT>
struct ARows {
  static constexpr int kRows = UTile<XT>::kWiden > 1 ? kARowsE4M3 : kARows;
  static constexpr int kThreads = kRows / 16 * 32;
  static constexpr int kMinBlocks = kRows > kARows ? 2 : 3;
};

// Shared memory of the row sweep: kStages x (X tile kRows x kLd of XT,
// Vt tile NP x kLdV of OT), in bytes, reused by the epilogue.
template <typename XT, int NT>
struct ASmem {
  using Ti = UTile<XT>;
  static constexpr int kStages = Ti::kWiden > 1 ? kAStagesE4M3 : kAStages;
  static constexpr int kXBytes =
      ARows<XT>::kRows * Ti::kLd * (int)sizeof(XT);
  static constexpr int kStage =
      kXBytes + NT * 8 * Ti::kLdV * (int)sizeof(op_t<XT>);
  static constexpr int kBytes = kStages * kStage;
};

// This warp's 16 rows (at their offsets) times the stage's Vt, into NT
// m16n8 accumulators.
template <bool kPairs, int NT>
__device__ __forceinline__ void xv_stage_mma(const __nv_bfloat16* alo,
                                             const __nv_bfloat16* ahi,
                                             const __nv_bfloat16* Bs,
                                             float (&acc)[NT][4], int g,
                                             int t) {
  constexpr int L = UTile<__nv_bfloat16>::kLdV;
#pragma unroll
  for (int kk = 0; kk < UTile<__nv_bfloat16>::kDepth; kk += 16) {
    const uint32_t a[4] = {ld_bf16x2<kPairs>(alo + kk + 2 * t),
                           ld_bf16x2<kPairs>(ahi + kk + 2 * t),
                           ld_bf16x2<kPairs>(alo + kk + 8 + 2 * t),
                           ld_bf16x2<kPairs>(ahi + kk + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* b = Bs + (j * 8 + g) * L + kk + 2 * t;
      mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

// One chain of the same stage for e4m3 X: the bf16 stage's fragments and
// k index, each X pair converted to bf16 as it is loaded, Vt's by
// ldmatrix. Bs: the chain's first column of the Vt tile.
template <bool kPairs, int NT>
__device__ __forceinline__ void xv_stage_mma(const __nv_fp8_e4m3* alo,
                                             const __nv_fp8_e4m3* ahi,
                                             const __nv_bfloat16* Bs,
                                             float (&acc)[NT][4], int g,
                                             int t) {
  constexpr int L = UTile<__nv_fp8_e4m3>::kLdV;
  const int off = ldsm_offset(threadIdx.x & 31, L);
#pragma unroll
  for (int kk = 0; kk < UTile<__nv_fp8_e4m3>::kChain; kk += 16) {
    const uint32_t a[4] = {
        e4m3x2_to_bf16x2(ld_e4m3x2<kPairs>(alo + kk + 2 * t)),
        e4m3x2_to_bf16x2(ld_e4m3x2<kPairs>(ahi + kk + 2 * t)),
        e4m3x2_to_bf16x2(ld_e4m3x2<kPairs>(alo + kk + 8 + 2 * t)),
        e4m3x2_to_bf16x2(ld_e4m3x2<kPairs>(ahi + kk + 8 + 2 * t))};
    uint32_t b[NT][2];
    load_b<NT>(b, Bs, L, off, kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
  }
}

template <bool kPairs, int NT>
__device__ __forceinline__ void xv_stage_mma(const float* alo, const float* ahi,
                                             const float* Bs,
                                             float (&acc)[NT][4], int g,
                                             int t) {
  constexpr int L = UTile<float>::kLdV;
#pragma unroll
  for (int kk = 0; kk < UTile<float>::kDepth; kk += 8) {
    uint32_t hi[4], lo[4];
    split_tf32(alo[kk + t], hi[0], lo[0]);
    split_tf32(ahi[kk + t], hi[1], lo[1]);
    split_tf32(alo[kk + t + 4], hi[2], lo[2]);
    split_tf32(ahi[kk + t + 4], hi[3], lo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = Bs + (j * 8 + g) * L + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[0], bh0, bl0);
      split_tf32(b[4], bh1, bl1);
      mma_3xtf32(acc[j], hi, lo, bh0, bl0, bh1, bl1);
    }
  }
}

// The same stage for f32 X in six TF32 products: x = hi + mid + lo (each
// TF32, ~2^-33 |x| left), hi*hi + hi*mid + mid*hi + mid*mid + hi*lo + lo*hi
// summed small terms first: ~2^-24 per product, IEEE f32's, where 3xTF32
// keeps ~2^-22. The wide route takes it: with k > m the rows' damped
// systems amplify X V's rounding past 3xTF32's accuracy.
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(mid) : "f"(r));
  const float r2 = r - __uint_as_float(mid);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r2));
}

template <bool kPairs, int NT>
__device__ __forceinline__ void xv_stage_mma_6x(const float* alo,
                                                const float* ahi,
                                                const float* Bs,
                                                float (&acc)[NT][4], int g,
                                                int t) {
  constexpr int L = UTile<float>::kLdV;
#pragma unroll
  for (int kk = 0; kk < UTile<float>::kDepth; kk += 8) {
    uint32_t hi[4], mid[4], lo[4];
    split3_tf32(alo[kk + t], hi[0], mid[0], lo[0]);
    split3_tf32(ahi[kk + t], hi[1], mid[1], lo[1]);
    split3_tf32(alo[kk + t + 4], hi[2], mid[2], lo[2]);
    split3_tf32(ahi[kk + t + 4], hi[3], mid[3], lo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = Bs + (j * 8 + g) * L + kk + t;
      uint32_t bh0, bm0, bl0, bh1, bm1, bl1;
      split3_tf32(b[0], bh0, bm0, bl0);
      split3_tf32(b[4], bh1, bm1, bl1);
      mma_tf32(acc[j], mid, bm0, bm1);
      mma_tf32(acc[j], hi, bl0, bl1);
      mma_tf32(acc[j], lo, bh0, bh1);
      mma_tf32(acc[j], hi, bm0, bm1);
      mma_tf32(acc[j], mid, bh0, bh1);
      mma_tf32(acc[j], hi, bh0, bh1);
    }
  }
}

// 2. The row sweep and the caller's epilogue (see the header comment).
// Epi provides kMats, stage<NP>(mats) and row<NP>(row, xv, mats): one warp,
// lane = component, returning U_new's component (masked by the caller).
template <typename XT, int NT, bool kPairs, typename Epi>
__global__ void __launch_bounds__(ARows<XT>::kThreads,
                                  ARows<XT>::kMinBlocks)
    xv_rows_kernel(const XT* __restrict__ X, int n, int m, int k,
                   const op_t<XT>* __restrict__ Vt, int ld_vt, Epi epi,
                   float* __restrict__ Unew, op_t<XT>* __restrict__ UxT,
                   int ld_ux, float* __restrict__ gram_part) {
  using OT = op_t<XT>;
  using Sm = ASmem<XT, NT>;
  using Ti = UTile<XT>;
  constexpr int NP = NT * 8;
  constexpr int L = Ti::kLd;
  constexpr int LV = Ti::kLdV;
  constexpr int TC = Ti::kDepth;
  constexpr int kChunks = L / Ti::kEl;  // chunks per X tile row
  constexpr int S = Sm::kStages;
  constexpr int RA = ARows<XT>::kRows;     // rows per CTA
  constexpr int TA = ARows<XT>::kThreads;  // threads per CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage i: the X tile, then the Vt tile
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem_raw + (i % S) * Sm::kStage);
  };
  auto stage_v = [&](const XT* Xs) {
    return reinterpret_cast<OT*>(
        reinterpret_cast<unsigned char*>(const_cast<XT*>(Xs)) + Sm::kXBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * RA;
  const int n_tiles = (m + TC - 1) / TC;

  // Copy slots: this thread's chunks of the X tile, fixed for the sweep.
  // xsrc: the chunk of tile 0 (tile i is i * kStep bytes on); xleft: bytes
  // from it to the end of the row (a chunk starting at or past the end is
  // zero-filled; rows past n have none).
  constexpr int kXChunks = RA * kChunks;
  constexpr int kXSlots = (kXChunks + TA - 1) / TA;
  constexpr int kStep = TC * (int)sizeof(XT);
  const char* xsrc[kXSlots];
  int xleft[kXSlots], xdst[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int c = tid + s * TA, r = c / kChunks, q = c % kChunks;
    xdst[s] = c < kXChunks ? r * L + q * Ti::kEl : -1;
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
    OT* Bs = stage_v(Xs);
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      if (xdst[s] < 0) continue;
      const bool ok = xleft[s] > i * kStep;
      cp_async16(Xs + xdst[s], ok ? xsrc[s] + (size_t)i * kStep : xsrc[s],
                 ok ? 16 : 0);
    }
    constexpr int kVChunks = TC / Ti::kOEl;  // per Vt row
    for (int c = tid; c < NP * kVChunks; c += TA) {
      const int r = c / kVChunks, e = (c % kVChunks) * Ti::kOEl;
      if constexpr (Ti::kWiden > 1) {
        if (i * TC + e >= ld_vt) continue;  // a chain past m: skipped
      }
      cp_async16(Bs + r * LV + e, Vt + (size_t)r * ld_vt + i * TC + e);
    }
  };

  const int rlo = warp * 16 + g, rhi = rlo + 8;
  const int olo = row0 + rlo < n ? row_offset(X, row0 + rlo, m) : 0;
  const int ohi = row0 + rhi < n ? row_offset(X, row0 + rhi, m) : 0;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
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
    if constexpr (Ti::kWiden > 1) {
      // e4m3: the stage's chains are the bf16 form's tiles, each from zero,
      // promoted in order; a chain starting at or past m is none of them
      constexpr int CH = TC / Ti::kChain;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        if ((i * CH + h) * Ti::kChain >= m) break;
        float part[NT][4] = {};
        xv_stage_mma<kPairs, NT>(Xs + rlo * L + olo + h * Ti::kChain,
                                 Xs + rhi * L + ohi + h * Ti::kChain,
                                 stage_v(Xs) + h * Ti::kChain, part, g, t);
        promote(acc, part);
      }
    } else {
      float part[NT][4] = {};
      xv_stage_mma<kPairs, NT>(Xs + rlo * L + olo, Xs + rhi * L + ohi,
                               stage_v(Xs), part, g, t);
      promote(acc, part);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue

  float* XVs = reinterpret_cast<float*>(smem_raw);  // RA x NP
  float* Us = XVs + RA * NP;                         // RA x NP
  float* mats = Us + RA * NP;                        // Epi::kMats x NP x NP
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rlo + 8 * h, c = j * 8 + 2 * t;
      XVs[r * NP + c] = acc[j][2 * h];
      XVs[r * NP + c + 1] = acc[j][2 * h + 1];
    }
  epi.template stage<NP>(mats);
  __syncthreads();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = row0 + r;
    float un = 0.f;
    if (row < n) {  // warp-uniform
      un = epi.template row<NP>(row, lane < k ? XVs[r * NP + lane] : 0.f,
                                 mats);
      if (lane >= k) un = 0.f;
      if (lane < k) Unew[(size_t)row * k + lane] = un;
    }
    if (lane < NP) {
      OT ux;
      from_float(un, ux);
      if constexpr (RA == kARows) {
        UxT[(size_t)lane * ld_ux + row] = ux;
      } else {
        if (row < ld_ux) UxT[(size_t)lane * ld_ux + row] = ux;
      }
      Us[r * NP + lane] = un;
    }
  }
  __syncthreads();
  if constexpr (RA == kARows) {
    for (int e = tid; e < k * k; e += kAThreads) {
      const int a = e / k, b = e % k;
      float s = 0.f;
      for (int r = 0; r < kARows; ++r) s += Us[r * NP + a] * Us[r * NP + b];
      gram_part[(size_t)blockIdx.x * k * k + e] = s;
    }
  } else {
    // the partials of the CTA's 64-row blocks, each as a 64-row CTA sums it
    const int kk2 = k * k, blocks = (n + kARows - 1) / kARows;
    for (int e = tid; e < RA / kARows * kk2; e += TA) {
      const int hb = e / kk2, ee = e % kk2, a = ee / k, b = ee % k;
      const int block = blockIdx.x * (RA / kARows) + hb;
      if (block >= blocks) continue;
      const float* u = Us + hb * kARows * NP;
      float s = 0.f;
      for (int r = 0; r < kARows; ++r) s += u[r * NP + a] * u[r * NP + b];
      gram_part[(size_t)block * kk2 + ee] = s;
    }
  }
}

// Shared memory of the column sweep: kBStages x (X tile kRows x kBLd of
// XT, UxT tile NP x kLdU of OT), in bytes.
template <typename XT, int NT>
struct BSmem {
  using Ti = UTile<XT>;
  static constexpr int kXtBytes = Ti::kRows * Ti::kBLd * (int)sizeof(XT);
  static constexpr int kStage =
      kXtBytes + NT * 8 * Ti::kLdU * (int)sizeof(op_t<XT>);
  static constexpr int kBytes = kBStages * kStage;
};

// One stage of X^T Ux for this warp's 16 columns: A[c][r] = X[r][c] read
// transposed (pos[s][i]: shared offset of the lane's i-th row of k-step s),
// B = the stage's UxT tile.
template <int NT>
__device__ __forceinline__ void xtu_stage_mma(const __nv_bfloat16* Xs,
                                              const __nv_bfloat16* Us,
                                              const int (&pos)[4][4], int c,
                                              float (&acc)[NT][4], int g,
                                              int t) {
  constexpr int L = UTile<__nv_bfloat16>::kLdU;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int kk = s * 16;
    const uint32_t a[4] = {pack_bf16(Xs + pos[s][0] + c, Xs + pos[s][1] + c),
                           pack_bf16(Xs + pos[s][0] + c + 8,
                                     Xs + pos[s][1] + c + 8),
                           pack_bf16(Xs + pos[s][2] + c, Xs + pos[s][3] + c),
                           pack_bf16(Xs + pos[s][2] + c + 8,
                                     Xs + pos[s][3] + c + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* b = Us + (j * 8 + g) * L + kk + 2 * t;
      mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

template <int NT>
__device__ __forceinline__ void xtu_stage_mma(const float* Xs, const float* Us,
                                              const int (&pos)[4][4], int c,
                                              float (&acc)[NT][4], int g,
                                              int t) {
  constexpr int L = UTile<float>::kLdU;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int kk = s * 8;
    uint32_t hi[4], lo[4];
    split_tf32(Xs[pos[s][0] + c], hi[0], lo[0]);
    split_tf32(Xs[pos[s][0] + c + 8], hi[1], lo[1]);
    split_tf32(Xs[pos[s][1] + c], hi[2], lo[2]);
    split_tf32(Xs[pos[s][1] + c + 8], hi[3], lo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = Us + (j * 8 + g) * L + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[0], bh0, bl0);
      split_tf32(b[4], bh1, bl1);
      mma_3xtf32(acc[j], hi, lo, bh0, bl0, bh1, bl1);
    }
  }
}

// Rows of k-step s read by this lane, relative to the stage: bf16
// (m16n8k16, A = X^T) rows 2t, 2t+1, 2t+8, 2t+9; f32 (m16n8k8) rows t, t+4.
template <typename XT>
__device__ __forceinline__ int xtu_row(int s, int i, int t) {
  if constexpr (sizeof(op_t<XT>) == 2) {
    return s * 16 + 2 * t + (i & 1) + 8 * (i >> 1);
  } else {
    return s * 8 + t + 4 * i;
  }
}

// 3. numV partial of row segment blockIdx.y for columns blockIdx.x * 128 ...
// and components slice blockIdx.z (of NT * 8: one slice, blockIdx.z = 0).
template <typename XT, int NT>
__global__ void __launch_bounds__(kBThreads, 2)
    xtu_cols_kernel(const XT* __restrict__ X, int n, int m, int k,
                    const op_t<XT>* __restrict__ UxT, int ld_ux, int seg_rows,
                    float* __restrict__ out) {
  static_assert(UTile<XT>::kWiden == 1, "e4m3 X: xtu_cols_e4m3_kernel");
  using OT = op_t<XT>;
  using Sm = BSmem<XT, NT>;
  using Ti = UTile<XT>;
  constexpr int RS = Ti::kRows;  // rows per stage
  constexpr int LU = Ti::kLdU;
  constexpr int BL = Ti::kBLd;
  constexpr int kChunks = (kBCols + Ti::kEl) / Ti::kEl;  // per X tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage i: the X tile, then the UxT tile
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem_raw + (i % kBStages) * Sm::kStage);
  };
  auto stage_u = [&](const XT* Xs) {
    return reinterpret_cast<OT*>(
        reinterpret_cast<unsigned char*>(const_cast<XT*>(Xs)) + Sm::kXtBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kBCols;
  const int r_begin = blockIdx.y * seg_rows;
  const int seg_len = min(n, r_begin + seg_rows) - r_begin;
  const int n_stages = (seg_len + RS - 1) / RS;
  const int kc0 = blockIdx.z * NT * 8;  // this slice's first component
  const int kk = k - kc0;               // components past kc0 (masked below)
  UxT += (size_t)kc0 * ld_ux;

  // Copy slots: this thread's chunks of the X tile, fixed for the sweep.
  // Stages start on rows that are multiples of RS, and RS rows of X span a
  // multiple of 16 bytes, so a row's offset (and with it which chunks hold
  // columns c0 ... c0 + 127 below m) depends on its place in the stage
  // only. xrow: the slot's row in the stage (past seg_len: zero fill; a
  // chunk holding no column of the tile never reads); xsrc: its chunk in
  // stage 0 (stage i is i * RS rows on).
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
    const bool cols = rel < (long long)min(c0 + kBCols, m) * (long long)sizeof(XT);
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
    for (int c = tid; c < NT * 8 * kUChunks; c += kBThreads) {
      const int r = c / kUChunks, e = (c % kUChunks) * Ti::kOEl;
      cp_async16(Us + r * LU + e,
                 UxT + (size_t)r * ld_ux + r_begin + i * RS + e);
    }
  };

  int pos[4][4];  // see xtu_stage_mma
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = xtu_row<XT>(s, i, t);
      pos[s][i] = r * BL + row_offset(X, r, m);
    }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kBStages - 1; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();
    if (i + kBStages - 1 < n_stages) load(i + kBStages - 1);
    cp_async_commit();
    const XT* Xs = stage_x(i);
    float part[NT][4] = {};
    xtu_stage_mma<NT>(Xs, stage_u(Xs), pos, warp * 16 + g, part, g, t);
    promote(acc, part);
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blockIdx.y * m * k + kc0;
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

// One stage of the e4m3 column sweep for this warp's 16 columns: the bf16
// stage's fragments and k index (rows 2t, 2t + 1, 2t + 8, 2t + 9 of each
// 16-row k step), with the tile's m index laid out so that A rows g and
// g + 8 are the lane's two adjacent columns 2g and 2g + 1: one 16-bit read
// of a row gives the lane both, and a byte permute of two rows' reads is
// an A pair. v_at: this lane's byte offsets of those four rows in the
// stage (kPairs: 2-byte aligned; else the aligned word below it, whose
// funnel shift by sh brings the two bytes down).
template <int NT, bool kPairs>
__device__ __forceinline__ void xtu_e4m3_chain(const unsigned char* Xs,
                                               const __nv_bfloat16* Us,
                                               const int (&v_at)[4],
                                               const int (&sh)[4], int off,
                                               float (&acc)[NT][4]) {
  using Ti = UTile<__nv_fp8_e4m3>;
#pragma unroll
  for (int s = 0; s < Ti::kRows / 16; ++s) {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned char* p = Xs + s * 16 * Ti::kBLd + v_at[i];
      if constexpr (kPairs) {
        v[i] = *reinterpret_cast<const unsigned short*>(p);
      } else {
        v[i] = __funnelshift_r(*reinterpret_cast<const uint32_t*>(p),
                               *reinterpret_cast<const uint32_t*>(p + 4),
                               sh[i]);
      }
    }
    // column 2g (A row g): byte 0 of each row's read; 2g + 1: byte 1
    const uint32_t a[4] = {e4m3x2_to_bf16x2(__byte_perm(v[0], v[1], 0x0040)),
                           e4m3x2_to_bf16x2(__byte_perm(v[0], v[1], 0x0051)),
                           e4m3x2_to_bf16x2(__byte_perm(v[2], v[3], 0x0040)),
                           e4m3x2_to_bf16x2(__byte_perm(v[2], v[3], 0x0051))};
    uint32_t b[NT][2];
    load_b<NT>(b, Us, Ti::kLdU, off, s * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
  }
}

// 3, e4m3 X: xtu_cols_kernel's grid, CTAs, warps (16 columns each) and
// stages (the bf16 form's 64 rows, each chain from zero and promoted in
// order), its A pairs read as xtu_e4m3_chain lays them out and its UxT
// fragments by ldmatrix. (Stages of 128 rows, the bytes of bf16's, as two
// chains were measured slower at k = 20.)
template <int NT, bool kPairs>
__global__ void __launch_bounds__(kBThreads, 2)
    xtu_cols_e4m3_kernel(const __nv_fp8_e4m3* __restrict__ X, int n, int m,
                         int k, const __nv_bfloat16* __restrict__ UxT,
                         int ld_ux, int seg_rows, float* __restrict__ out) {
  using Ti = UTile<__nv_fp8_e4m3>;
  using Sm = BSmem<__nv_fp8_e4m3, NT>;
  constexpr int RS = Ti::kRows;       // rows per stage
  constexpr int LU = Ti::kLdU;
  constexpr int BL = Ti::kBLd;
  constexpr int kChunks = BL / 16;    // per X tile row
  static_assert(BL % 16 == 0, "X tile rows are whole chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage i: the X tile, then the UxT tile
  auto stage_x = [&](int i) { return smem_raw + (i % kBStages) * Sm::kStage; };
  auto stage_u = [&](unsigned char* Xs) {
    return reinterpret_cast<__nv_bfloat16*>(Xs + Sm::kXtBytes);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kBCols;
  const int r_begin = blockIdx.y * seg_rows;
  const int seg_len = min(n, r_begin + seg_rows) - r_begin;
  const int n_stages = (seg_len + RS - 1) / RS;
  const int kc0 = blockIdx.z * NT * 8;  // this slice's first component
  const int kk = k - kc0;               // components past kc0 (masked below)
  UxT += (size_t)kc0 * ld_ux;

  // Copy slots as in xtu_cols_kernel; chunk c lands at byte 16 c of the
  // tile (row c / kChunks, chunk c % kChunks).
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

  // This lane's rows 2t, 2t + 1, 2t + 8, 2t + 9 of every 16-row k step
  // start at the same offsets within their 16-byte chunks (16 rows of X
  // span a multiple of 16 bytes), so four offsets serve the sweep.
  int v_at[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * t + (i & 1) + 8 * (i >> 1);
    const int b = r * BL + row_offset(X, r, m) + warp * 16 + 2 * g;
    v_at[i] = kPairs ? b : b & ~3;
    sh[i] = 8 * (b & 3);
  }
  const int off = ldsm_offset(lane, LU);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kBStages - 1; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();
    if (i + kBStages - 1 < n_stages) load(i + kBStages - 1);
    cp_async_commit();
    unsigned char* Xs = stage_x(i);
    float part[NT][4] = {};
    xtu_e4m3_chain<NT, kPairs>(Xs, stage_u(Xs), v_at, sh, off, part);
    promote(acc, part);
  }
  cp_async_wait<0>();

  // A rows g and g + 8 of the warp's tile are its columns 2g and 2g + 1
  float* dst = out + (size_t)blockIdx.y * m * k + kc0;
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

// 4. Blocks below num_blocks: numV[e] = sum of the n_seg partials (thread
// per element); the rest: gramU[e] = sum of the n_gram partials (warp per
// element, lanes striding the partials, then a butterfly). Fixed orders.
__global__ void u_pass_reduce_kernel(const float* __restrict__ numv_part,
                                     int n_seg, long long mk, int num_blocks,
                                     float* __restrict__ numV,
                                     const float* __restrict__ gram_part,
                                     int n_gram, int kk,
                                     float* __restrict__ gramU) {
  if ((int)blockIdx.x < num_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= mk) return;
    float s = 0.f;
    for (int p = 0; p < n_seg; ++p) s += numv_part[(long long)p * mk + e];
    numV[e] = s;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int e = ((int)blockIdx.x - num_blocks) * (blockDim.x / 32) +
                (int)threadIdx.x / 32;
  if (e >= kk) return;  // warp-uniform
  float s = 0.f;
  for (int p = lane; p < n_gram; p += 32) s += gram_part[(long long)p * kk + e];
  s = warp_sum(s);
  if (lane == 0) gramU[e] = s;
}

// Workspace and plan of one call (from the wrapper's u_pass_plan).
struct UPassWork {
  void* vt;          // NP x ld_vt, X's operand type (op_t)
  void* uxt;         // NP x ld_ux, X's operand type
  float* gram_part;  // ceil(n / kARows) x k x k
  float* numv_part;  // n_seg x m x k (unused when n_seg == 1); for k > 32
                     // at least 2 n k floats: before the column sweep
                     // writes it, the X V scratch, then the epilogue's
  int ld_vt, ld_ux, seg_rows, n_seg;
  // f32 X at k <= 32 and m <= 16 * kCMaxCols: the cluster route's clusters
  // and columns per CTA (u_pass_cluster.cuh); 0 on the two-sweep routes
  int clusters, slice_cols;
};

inline bool plan_ok(int n, int m, int k, const UPassWork& w) {
  const int row_blocks = ceil_div(n, kARows);
  return n >= 1 && m >= 1 && k >= 1 &&
         w.ld_vt >= ceil_div(m, 128) * 128 && w.ld_vt % 128 == 0 &&
         w.ld_ux >= row_blocks * kARows && w.ld_ux % kARows == 0 &&
         w.seg_rows >= 64 && w.seg_rows % 64 == 0 && w.n_seg >= 1 &&
         (long long)(w.n_seg - 1) * w.seg_rows < n &&
         (long long)w.n_seg * w.seg_rows >= n &&
         w.n_seg <= 65535;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <typename XT, int NT, bool kPairs, typename Epi>
int launch_rows(const XT* X, int n, int m, int k, const Epi& epi,
                float* Unew, const UPassWork& w, cudaStream_t st) {
  constexpr int smem = ASmem<XT, NT>::kBytes;
  static_assert(2 * ARows<XT>::kRows * NT * 8 * 4 +
                        Epi::kMats * NT * NT * 64 * 4 <=
                    smem,
                "epilogue buffers exceed the ring");
  static bool ready = false;
  if (int e = allow_smem(xv_rows_kernel<XT, NT, kPairs, Epi>, smem, ready))
    return e;
  xv_rows_kernel<XT, NT, kPairs, Epi>
      <<<ceil_div(n, ARows<XT>::kRows), ARows<XT>::kThreads, smem, st>>>(
          X, n, m, k, static_cast<const op_t<XT>*>(w.vt), w.ld_vt, epi, Unew,
          static_cast<op_t<XT>*>(w.uxt), w.ld_ux, w.gram_part);
  return 0;
}

// Kernel 2 for X's alignment: bf16 (e4m3) pairs are 4-byte (2-byte)
// aligned when X is and rows hold an even count.
template <typename XT, int NT, typename Epi>
int launch_rows_aligned(const XT* X, int n, int m, int k, const Epi& epi,
                        float* Unew, const UPassWork& w, cudaStream_t st) {
  if constexpr (sizeof(XT) < 4) {
    if (reinterpret_cast<uintptr_t>(X) % (2 * sizeof(XT)) == 0 && m % 2 == 0)
      return launch_rows<XT, NT, true, Epi>(X, n, m, k, epi, Unew, w, st);
    return launch_rows<XT, NT, false, Epi>(X, n, m, k, epi, Unew, w, st);
  } else {
    return launch_rows<XT, NT, true, Epi>(X, n, m, k, epi, Unew, w, st);
  }
}

// Kernels 3 and 4. Templated on Epi although it
// does not use it: a static local of a template function is one object
// across every loaded library that instantiates it (a GNU unique symbol),
// and each library must set the shared-memory limit of its own kernel.
template <typename XT, int NT, typename Epi>
int launch_cols_reduce(const XT* X, int n, int m, int k, float* numV,
                       float* gramU, const UPassWork& w, cudaStream_t st) {
  constexpr int smem_b = BSmem<XT, NT>::kBytes;
  const dim3 grid(ceil_div(m, kBCols), w.n_seg);
  float* out = w.n_seg == 1 ? numV : w.numv_part;
  if constexpr (UTile<XT>::kWiden > 1) {
    // e4m3: byte pairs of a row are 2-byte aligned when X is and rows hold
    // an even count
    static bool ready_p = false, ready_u = false;
    const __nv_bfloat16* ux = static_cast<const __nv_bfloat16*>(w.uxt);
    if (reinterpret_cast<uintptr_t>(X) % 2 == 0 && m % 2 == 0) {
      if (int e = allow_smem(xtu_cols_e4m3_kernel<NT, true>, smem_b, ready_p))
        return e;
      xtu_cols_e4m3_kernel<NT, true><<<grid, kBThreads, smem_b, st>>>(
          X, n, m, k, ux, w.ld_ux, w.seg_rows, out);
    } else {
      if (int e = allow_smem(xtu_cols_e4m3_kernel<NT, false>, smem_b,
                             ready_u))
        return e;
      xtu_cols_e4m3_kernel<NT, false><<<grid, kBThreads, smem_b, st>>>(
          X, n, m, k, ux, w.ld_ux, w.seg_rows, out);
    }
  } else {
    static bool ready_b = false;
    if (int e = allow_smem(xtu_cols_kernel<XT, NT>, smem_b, ready_b))
      return e;
    xtu_cols_kernel<XT, NT><<<grid, kBThreads, smem_b, st>>>(
        X, n, m, k, static_cast<const op_t<XT>*>(w.uxt), w.ld_ux, w.seg_rows,
        out);
  }
  const long long mk = (long long)m * k;
  const int num_blocks = w.n_seg > 1 ? (int)((mk + 255) / 256) : 0;
  u_pass_reduce_kernel<<<num_blocks + ceil_div(k * k, 8), 256, 0, st>>>(
      w.numv_part, w.n_seg, mk, num_blocks, numV, w.gram_part,
      ceil_div(n, kARows), k * k, gramU);
  return (int)cudaGetLastError();
}

template <typename XT, int NT, typename Epi>
int launch_u_pass_nt(const XT* X, const float* V, int n, int m, int k,
                     const Epi& epi, float* Unew, float* numV, float* gramU,
                     const UPassWork& w, cudaStream_t st) {
  constexpr int NP = NT * 8;
  const long long n_vt = (long long)NP * w.ld_vt;
  vt_kernel<op_t<XT>><<<(int)((n_vt + 255) / 256), 256, 0, st>>>(
      V, m, k, NP, w.ld_vt, static_cast<op_t<XT>*>(w.vt));
  if (int e = launch_rows_aligned<XT, NT>(X, n, m, k, epi, Unew, w, st))
    return e;
  return launch_cols_reduce<XT, NT, Epi>(X, n, m, k, numV, gramU, w, st);
}

// The whole call for X's dtype XT, with NT = ceil(k / 8) n8 tiles; k > 32
// is the wide route's (u_pass_wide.cu), refused here.
template <typename XT, typename Epi>
int launch_u_pass(const void* X, const float* V, int n, int m, int k,
                  const Epi& epi, float* Unew, float* numV, float* gramU,
                  const UPassWork& w, cudaStream_t st) {
  const XT* x = static_cast<const XT*>(X);
  switch ((k + 7) / 8) {
    case 1:
      return launch_u_pass_nt<XT, 1>(x, V, n, m, k, epi, Unew, numV, gramU, w,
                                     st);
    case 2:
      return launch_u_pass_nt<XT, 2>(x, V, n, m, k, epi, Unew, numV, gramU, w,
                                     st);
    case 3:
      return launch_u_pass_nt<XT, 3>(x, V, n, m, k, epi, Unew, numV, gramU, w,
                                     st);
    case 4:
      return launch_u_pass_nt<XT, 4>(x, V, n, m, k, epi, Unew, numV, gramU, w,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The whole call for X's dtype code (common.cuh: XDtype); an unknown code
// launches nothing.
template <typename Epi>
int launch_u_pass_dtype(int x_dtype, const void* X, const float* V, int n,
                        int m, int k, const Epi& epi, float* Unew,
                        float* numV, float* gramU, const UPassWork& w,
                        cudaStream_t st) {
  switch (x_dtype) {
    case kXF32:
      return launch_u_pass<float>(X, V, n, m, k, epi, Unew, numV, gramU, w,
                                  st);
    case kXBF16:
      return launch_u_pass<__nv_bfloat16>(X, V, n, m, k, epi, Unew, numV,
                                          gramU, w, st);
    case kXE4M3:
      return launch_u_pass<__nv_fp8_e4m3>(X, V, n, m, k, epi, Unew, numV,
                                          gramU, w, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pycmf
