// Shared pieces of the two fused U-pass kernels (mu_fused.cu, newton_fused.cu).
//
// Both stream the data matrix X (n, m) row-major, stored as f32 or bf16,
// against thin f32 factors (k <= 32, zero-padded to KP, the next multiple
// of 4: float4 access, and no more wasted products than that).
// A call runs four kernels on the caller's stream:
//
//   1. xv_part_kernel      DB = X Vx in column segments. A block keeps one
//                          segment of V (as f32) in shared memory for its
//                          whole life and walks row quads: each warp owns
//                          4 rows, its lanes stride over the segment's
//                          columns (coalesced reads of X), and a butterfly
//                          reduction finishes each row. The segment's
//                          partial X V goes to scratch.
//   2. the caller's epilogue, one warp per row, one factor component per
//                          lane: sums the segments' partials in order, forms
//                          U_new, writes it and a copy rounded to X's dtype
//                          (Ux, zero-padded to KP), and a per-block partial
//                          of U_new^T U_new.
//   3. xtu_part_kernel     X^T Ux in row segments: each thread owns one column
//                          and reads the Ux rows as broadcast loads.
//   4. reduce_parts_kernel sums the row segments' partials (numV) and the
//                          epilogue blocks' Gram partials (gramU).
//
// X is read twice per call (kernels 1 and 3). There are no float atomics:
// every sum has a fixed order that does not depend on the launch geometry,
// so results repeat bit for bit. bf16 values are widened to f32 before each
// product; the product of two bf16 values is exact in f32, so this is bf16
// inputs with f32 accumulation, as in the reference.
#pragma once

#include "common.cuh"

namespace pycmf {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;   // epilogue block
constexpr int kSmemBudget = 110 * 1024;        // V segment: 2 blocks per SM
constexpr int kColsPerBlock = kThreads;        // columns phase: 1 column/thread
constexpr int kRowUnroll = 8;                  // columns phase: rows per step
constexpr int kMaxSegments = 64;

// Round an f32 value to X's storage type and back (the reference casts
// U_new to X's dtype before U_new^T X).
template <typename XT> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row stride of the shared V segment, in floats: a multiple of 4 with an
// odd number of float4s, so eight lanes' float4 reads hit distinct banks.
__host__ __device__ constexpr int v_ld(int KP) {
  return 4 * ((KP / 4 + 1) % 2 ? KP / 4 + 1 : KP / 4 + 2);
}

// Columns of X per V segment: as many as fit the shared-memory budget,
// a multiple of 32.
inline int seg_cols(int KP) { return kSmemBudget / (v_ld(KP) * 4) / 32 * 32; }

inline int col_segments(int m, int k) { return ceil_div(m, seg_cols(pad_k(k))); }

inline int row_blocks(int n) { return ceil_div(n, kRowsPerBlock); }

// Row segments of the columns phase: one per 512 rows, at most 64 (45 column
// blocks x 59 segments at the main-path shape; 64 segments measured 3-4%
// faster than 16 on the H100), one segment for small n.
inline int row_segments(int n) {
  int s = ceil_div(n, 512);
  return s < 1 ? 1 : (s > kMaxSegments ? kMaxSegments : s);
}

// Scratch layout, in floats: X V partials (col_segments x n x KP), Ux
// (n x KP), Gram partials (row_blocks x k x k), X^T Ux partials
// (row_segments x m x k).
struct Workspace {
  float* xv_part;
  float* ux;
  float* gram_part;
  float* seg_part;
};

inline long long workspace_floats(int n, int m, int k) {
  const long long KP = pad_k(k);
  return (long long)col_segments(m, k) * n * KP + (long long)n * KP +
         (long long)row_blocks(n) * k * k + (long long)row_segments(n) * m * k;
}

inline Workspace carve(float* work, int n, int m, int k) {
  const size_t KP = pad_k(k);
  Workspace w;
  w.xv_part = work;
  w.ux = w.xv_part + (size_t)col_segments(m, k) * n * KP;
  w.gram_part = w.ux + (size_t)n * KP;
  w.seg_part = w.gram_part + (size_t)row_blocks(n) * k * k;
  return w;
}

// X[row0 + t, c0 + jb + h * 32 + lane] for the warp's rows (0 past the
// segment or past n).
template <typename XT>
__device__ __forceinline__ void load_xv_step(const XT* const (&xr)[kRowsPerWarp],
                                             int jb, int len, int row0, int n,
                                             float (&xs)[2][kRowsPerWarp]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = jb + h * 32 + lane;
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t)
      xs[h][t] = (jj < len && row0 + t < n) ? to_float(xr[t][jj]) : 0.f;
  }
}

// 1. part[seg, row, c] = sum_{j in segment seg} X[row, j] * Vx[j, c].
template <typename XT, int KP>
__global__ void __launch_bounds__(kThreads, KP <= 24 ? 2 : 1)
    xv_part_kernel(const XT* __restrict__ X, const XT* __restrict__ Vx, int n,
                   int m, int k, int seg_len, float* __restrict__ part) {
  extern __shared__ __align__(16) float Vs[];  // seg_len x v_ld(KP)
  constexpr int LD = v_ld(KP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int seg = blockIdx.y, c0 = seg * seg_len;
  const int len = min(seg_len, m - c0);
  for (int e = threadIdx.x; e < seg_len * KP; e += kThreads) {
    const int jj = e / KP, c = e % KP;
    Vs[jj * LD + c] =
        (jj < len && c < k) ? to_float(Vx[(size_t)(c0 + jj) * k + c]) : 0.f;
  }
  __syncthreads();

  const int n_quads = (n + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int q = blockIdx.x * kWarps + warp; q < n_quads;
       q += gridDim.x * kWarps) {
    const int row0 = q * kRowsPerWarp;
    const XT* xr[kRowsPerWarp];  // rows past n alias row n - 1, never read
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t)
      xr[t] = X + (size_t)min(row0 + t, n - 1) * m + c0;
    float acc[kRowsPerWarp][KP];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t)
#pragma unroll
      for (int c = 0; c < KP; ++c) acc[t][c] = 0.f;
    // Columns in steps of 64 per warp: 8 loads in flight per lane.
    for (int jb = 0; jb < len; jb += 64) {
      float xs[2][kRowsPerWarp];
      load_xv_step(xr, jb, len, row0, n, xs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = jb + h * 32 + lane;
        if (jj >= seg_len) break;  // zero-padded beyond len, unused beyond
        const float4* v4 = reinterpret_cast<const float4*>(Vs + jj * LD);
#pragma unroll
        for (int p = 0; p < KP / 4; ++p) {
          const float4 v = v4[p];
#pragma unroll
          for (int t = 0; t < kRowsPerWarp; ++t) {
            acc[t][4 * p + 0] += xs[h][t] * v.x;
            acc[t][4 * p + 1] += xs[h][t] * v.y;
            acc[t][4 * p + 2] += xs[h][t] * v.z;
            acc[t][4 * p + 3] += xs[h][t] * v.w;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      float mine = 0.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        const float s = warp_sum(acc[t][c]);
        if (c == lane) mine = s;
      }
      if (row0 + t < n && lane < KP)
        part[((size_t)seg * n + row0 + t) * KP + lane] = mine;
    }
  }
}

// Row `row`'s X V, component `lane` (0 for lanes >= k): the segments'
// partials summed in order.
__device__ __forceinline__ float gather_xv(const float* __restrict__ part,
                                           int n_seg, int n, int KP, int row,
                                           int k) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  if (lane < k)
    for (int g = 0; g < n_seg; ++g) s += part[((size_t)g * n + row) * KP + lane];
  return s;
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
  for (int e = threadIdx.x; e < KP * KP; e += kThreads) {
    const int a = e / KP, b = e % KP;
    As[e] = (a < k && b < k) ? A[a * k + b] : 0.f;
  }
}

// Epilogue output for one row: U_new to Unew (live lanes), its rounded
// copy to Ux (all KP lanes, zeros past k and for rows past the valid
// range), and the value to the block's staging tile for the Gram partial.
template <typename XT, int KP>
__device__ __forceinline__ void emit_row(float un, int row, int n, int k,
                                         float* __restrict__ Unew,
                                         float* __restrict__ Ux,
                                         float* Us_row) {
  const int lane = threadIdx.x & 31;
  if (row < n && lane < k) Unew[(size_t)row * k + lane] = un;
  if (row < n && lane < KP) Ux[(size_t)row * KP + lane] = round_to<XT>(un);
  if (lane < KP) Us_row[lane] = un;
}

// Per-block partial of U_new^T U_new from the block's staged rows
// (Us: kRowsPerBlock x KP, zero for rows past the valid range).
template <int KP>
__device__ __forceinline__ void gram_partial(const float* Us, int k,
                                             float* __restrict__ out) {
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int a = e / k, b = e % k;
    float s = 0.f;
    for (int r = 0; r < kRowsPerBlock; ++r) s += Us[r * KP + a] * Us[r * KP + b];
    out[e] = s;
  }
}

// X[r0 + i, j] for i < kRowUnroll (0 past r_end or past m; jc is j
// clamped into the matrix so no address is out of bounds).
template <typename XT>
__device__ __forceinline__ void load_xtu_step(const XT* __restrict__ X, int r0,
                                              int r_end, int m, int j, int jc,
                                              float (&xs)[kRowUnroll]) {
#pragma unroll
  for (int i = 0; i < kRowUnroll; ++i)
    xs[i] = (r0 + i < r_end && j < m) ? to_float(X[(size_t)(r0 + i) * m + jc])
                                      : 0.f;
}

// 3. part[seg, j, c] = sum_{i in row segment seg} X[i, j] * Ux[i, c].
template <typename XT, int KP>
__global__ void __launch_bounds__(kThreads)
    xtu_part_kernel(const XT* __restrict__ X, const float* __restrict__ Ux,
                    int n, int m, int k, int rows_per_seg,
                    float* __restrict__ part) {
  const int j = blockIdx.x * kColsPerBlock + threadIdx.x;
  const int r_begin = blockIdx.y * rows_per_seg;
  const int r_end = min(n, r_begin + rows_per_seg);
  const int jc = min(j, m - 1);
  float acc[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) acc[c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRowUnroll) {
    float xs[kRowUnroll];
    load_xtu_step(X, r0, r_end, m, j, jc, xs);
#pragma unroll
    for (int i = 0; i < kRowUnroll; ++i) {
      const float4* u4 = reinterpret_cast<const float4*>(
          Ux + (size_t)min(r0 + i, n - 1) * KP);
#pragma unroll
      for (int p = 0; p < KP / 4; ++p) {
        const float4 u = __ldg(u4 + p);
        acc[4 * p + 0] += xs[i] * u.x;
        acc[4 * p + 1] += xs[i] * u.y;
        acc[4 * p + 2] += xs[i] * u.z;
        acc[4 * p + 3] += xs[i] * u.w;
      }
    }
  }
  if (j < m) {  // an empty trailing segment writes zeros
    float* dst = part + ((size_t)blockIdx.y * m + j) * k;
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c < k) dst[c] = acc[c];
  }
}

// 4. out[e] = sum_p part[p, e], summed in order p = 0, 1, ...
__global__ void reduce_parts_kernel(const float* __restrict__ part, int n_parts,
                                    long long len, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(long long)p * len + e];
  out[e] = s;
}

// Kernel 1: X V partials into w.xv_part.
template <typename XT, int KP>
void launch_xv(const XT* X, const XT* Vx, int n, int m, int k,
               const Workspace& w, cudaStream_t st) {
  const int seg_len = seg_cols(KP);
  const int n_seg = ceil_div(m, seg_len);
  const int smem = seg_len * v_ld(KP) * (int)sizeof(float);
  cudaFuncSetAttribute(xv_part_kernel<XT, KP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // Two blocks per SM in all; each block walks its share of the row quads.
  const int quads = ceil_div(n, kRowsPerWarp);
  int gx = ceil_div(2 * sm_count(), n_seg);
  gx = gx < 1 ? 1 : (gx > ceil_div(quads, kWarps) ? ceil_div(quads, kWarps) : gx);
  xv_part_kernel<XT, KP><<<dim3(gx, n_seg), kThreads, smem, st>>>(
      X, Vx, n, m, k, seg_len, w.xv_part);
}

// Kernels 3 and 4, after the epilogue has written Ux and the Gram partials.
template <typename XT, int KP>
void launch_numv_and_gram(const XT* X, int n, int m, int k, float* numV,
                          float* gramU, const Workspace& w, cudaStream_t st) {
  const int nseg = row_segments(n);
  const int rows_per_seg = ceil_div(n, nseg);
  dim3 grid(ceil_div(m, kColsPerBlock), nseg);
  xtu_part_kernel<XT, KP><<<grid, kThreads, 0, st>>>(X, w.ux, n, m, k,
                                                     rows_per_seg, w.seg_part);
  const long long mk = (long long)m * k, kk = (long long)k * k;
  reduce_parts_kernel<<<(int)((mk + kThreads - 1) / kThreads), kThreads, 0,
                        st>>>(w.seg_part, nseg, mk, numV);
  reduce_parts_kernel<<<(int)((kk + kThreads - 1) / kThreads), kThreads, 0,
                        st>>>(w.gram_part, row_blocks(n), kk, gramU);
}

}  // namespace pycmf

extern "C" long long pycmf_workspace_floats(int n, int m, int k) {
  return pycmf::workspace_floats(n, m, k);
}
