// Block-sparse (BlockEll) product for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/bell.py:bell_spmm (TPU kernel K7), and
// through it bell_inner.
//
// out (p, k) f32 = A (p, q) @ B (q, k) for A stored as NB dense 128 x 128
// blocks (f32 or bf16) sorted by row block; every row block holds at least
// one block, so every output row is written. B is f32 and, as in the
// reference (B.astype(blocks dtype)), rounded to the blocks' dtype first.
//
// Bound: bytes. Each stored block is read once (32 KB in bf16, 64 KB in
// f32) for 2 * 128 * 128 * k flops, k ~ 20: on tensor cores the blocks'
// bytes over 3.35 TB/s bind (path F's X, 3166 bf16 blocks: 0.032 ms).
//
// Design:
// - Work split by stored blocks: the layout carries segments of at most
//   four consecutive blocks of one row block (ops/kernels/bell.py, built
//   once with the layout), and one 256-thread CTA takes one segment. Path
//   F's X (235 row blocks, 3166 blocks) and its X^T (89 row blocks) each
//   give several CTAs per SM (counts in PERF.md), where one CTA per row
//   block left 43 of 132 SMs idle on X^T.
// - A row block with one segment writes `out` directly; otherwise each
//   segment writes f32 partials (128 x KPN) and bell_combine_kernel sums
//   them in segment order. No float atomics: a call repeats bit for bit.
// - Asynchronous copies: 64-column slabs of a block (and the matching
//   KPN x 64 slab of B^T) go by 16-byte cp.async into a ring of stages in
//   dynamic shared memory (bf16: 3 stages, 64 KB, 3 CTAs per SM; f32: 2
//   stages, 81 KB, 2 CTAs per SM), so copies overlap the products. Rows are
//   padded (72 bf16, 68 f32) so the fragment reads hit 32 distinct banks.
// - B is rounded to the blocks' dtype and transposed into B^T (KPN x qpad,
//   KPN = k rounded up to 8, zero-padded) by bell_bt_kernel once per call.
// - Tensor cores, mma.sync (each of the 8 warps owns 16 rows, KPN / 8
//   accumulator tiles): bf16 blocks take m16n8k16 bf16 -> f32 (products of
//   bf16 values are exact in f32). f32 blocks take 3xTF32 m16n8k8: each
//   operand is split into a TF32 high part and a TF32 low part, and
//   lo*hi + hi*lo + hi*hi keeps about 2^-21 relative error per product, in
//   a fixed order. The reference asks HIGHEST for f32 blocks (a single TF32
//   pass is ~3e-3 off); 3xTF32 moves the f32 kernel onto the tensor cores
//   at three times the bf16 product count, still below the bytes of its
//   64 KB blocks.
// - k > 32: the grid's second dimension walks 32-column slices of B^T and
//   of the output (four mma tiles each, B^T zero-padded to whole slices),
//   each slice with its own partials; the combine pass sums each output
//   column's partials of its slice.
// - Registers and warps per SM (ptxas, k = 20): 48 registers, no spills;
//   bf16 64 KB of shared memory, 3 CTAs = 24 warps per SM; f32 81 KB, 2
//   CTAs = 16 warps per SM. On an H100 it runs at 2.0x its bytes bound on
//   the device in both dtypes (PERF.md).
#include "common.cuh"

namespace pycmf {

constexpr int kBlk = 128;         // BlockEll block rows and columns
constexpr int kSlab = 64;         // block columns per pipeline stage
constexpr int kBellWarps = 8;     // 16 block rows each
constexpr int kBellThreads = kBellWarps * 32;

template <typename T>
struct BellTile;
template <>
struct BellTile<__nv_bfloat16> {
  static constexpr int kStages = 3, kPad = 8;
};
template <>
struct BellTile<float> {
  static constexpr int kStages = 2, kPad = 4;
};

// Shared memory of one CTA: kStages x (A slab 128 x kLd, B^T slab KPN x kLd).
template <typename T, int NT>
struct BellSmem {
  static constexpr int kLd = kSlab + BellTile<T>::kPad;
  static constexpr int kA = kBlk * kLd;
  static constexpr int kStage = (kBlk + NT * 8) * kLd;
  static constexpr int kBytes =
      BellTile<T>::kStages * kStage * (int)sizeof(T);
};

// One slab: this warp's 16 rows of A (As at its first row) times the
// slab's B^T (KPN x 64), into NT m16n8 accumulators. Fragments follow
// the PTX layouts: g = lane / 4 picks the row (A) or column (B), t =
// lane % 4 the position along the product's inner dimension.
template <int NT>
__device__ __forceinline__ void slab_mma(const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs,
                                         float (&acc)[NT][4], int g, int t) {
  constexpr int L = BellSmem<__nv_bfloat16, NT>::kLd;
#pragma unroll
  for (int kk = 0; kk < kSlab; kk += 16) {
    const uint32_t a[4] = {ld_pair(As + g * L + kk + 2 * t),
                           ld_pair(As + (g + 8) * L + kk + 2 * t),
                           ld_pair(As + g * L + kk + 8 + 2 * t),
                           ld_pair(As + (g + 8) * L + kk + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* b = Bs + (j * 8 + g) * L + kk + 2 * t;
      mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

template <int NT>
__device__ __forceinline__ void slab_mma(const float* As, const float* Bs,
                                         float (&acc)[NT][4], int g, int t) {
  constexpr int L = BellSmem<float, NT>::kLd;
#pragma unroll 2
  for (int kk = 0; kk < kSlab; kk += 8) {
    uint32_t hi[4], lo[4];
    split_tf32(As[g * L + kk + t], hi[0], lo[0]);
    split_tf32(As[(g + 8) * L + kk + t], hi[1], lo[1]);
    split_tf32(As[g * L + kk + t + 4], hi[2], lo[2]);
    split_tf32(As[(g + 8) * L + kk + t + 4], hi[3], lo[3]);
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

// Output columns per slice (blockIdx.y) when k > 32.
constexpr int kBellSlice = 32;

// One CTA per segment s: blocks segs[s] .. segs[s+1] of row block rb, for
// the output columns of slice blockIdx.y (all of them when k <= 32).
template <typename T, int NT>
__global__ void __launch_bounds__(kBellThreads)
    bell_segment_kernel(const T* __restrict__ blocks,
                        const int* __restrict__ bcols,
                        const int* __restrict__ brows,
                        const int* __restrict__ segs,
                        const int* __restrict__ rb_segs,
                        const T* __restrict__ Bt, int qpad, int p, int k,
                        float* __restrict__ out, float* __restrict__ part) {
  using Sm = BellSmem<T, NT>;
  const int c0 = blockIdx.y * kBellSlice;
  const int kk = min(k, c0 + NT * 8) - c0;  // this slice's columns
  Bt += (size_t)c0 * qpad;
  part += (size_t)blockIdx.y * gridDim.x * kBlk * (NT * 8);
  constexpr int kStages = BellTile<T>::kStages;
  constexpr int L = Sm::kLd;
  constexpr int kEl = 16 / (int)sizeof(T);    // elements per 16-byte copy
  constexpr int kRowCopies = kSlab / kEl;     // copies per slab row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.x;
  const int b0 = segs[s];
  const int n_slabs = (segs[s + 1] - b0) * (kBlk / kSlab);
  const int rb = brows[b0];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;

  auto load = [&](int j) {
    T* As = sm + (j % kStages) * Sm::kStage;
    T* Bs = As + Sm::kA;
    const int b = b0 + j / 2, c0 = (j % 2) * kSlab;
    const T* a = blocks + (size_t)b * kBlk * kBlk + c0;
    for (int c = tid; c < kBlk * kRowCopies; c += kBellThreads) {
      const int r = c / kRowCopies, e = (c % kRowCopies) * kEl;
      cp_async16(As + r * L + e, a + (size_t)r * kBlk + e);
    }
    const T* bt = Bt + (size_t)bcols[b] * kBlk + c0;
    for (int c = tid; c < NT * 8 * kRowCopies; c += kBellThreads) {
      const int r = c / kRowCopies, e = (c % kRowCopies) * kEl;
      cp_async16(Bs + r * L + e, bt + (size_t)r * qpad + e);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_slabs) load(j);
    cp_async_commit();
  }
  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<kStages - 2>();  // slab i has landed
    __syncthreads();               // and every warp is done with slab i - 1
    if (i + kStages - 1 < n_slabs) load(i + kStages - 1);
    cp_async_commit();
    const T* As = sm + (i % kStages) * Sm::kStage;
    slab_mma<NT>(As + warp * 16 * L, As + Sm::kA, acc, g, t);
  }

  const bool direct = rb_segs[rb + 1] - rb_segs[rb] == 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;  // row within the block
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (direct) {
        const int row = rb * kBlk + r;
        if (row < p) {
          if (n < kk) out[(size_t)row * k + c0 + n] = v0;
          if (n + 1 < kk) out[(size_t)row * k + c0 + n + 1] = v1;
        }
      } else {
        *reinterpret_cast<float2*>(part + ((size_t)s * kBlk + r) * (NT * 8) +
                                   n) = make_float2(v0, v1);
      }
    }
  }
}

// Rows of row blocks with several segments: their partials in segment order
// (of column n's slice: kpn = NT * 8 partial columns per slice).
__global__ void bell_combine_kernel(const int* __restrict__ rb_segs,
                                    const float* __restrict__ part, int n_seg,
                                    int p, int k, int kpn,
                                    float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p * k) return;
  const int row = (int)(idx / k), col = (int)(idx % k);
  const int y = col / kBellSlice, n = col % kBellSlice;
  const int rb = row / kBlk, r = row % kBlk;
  const int s0 = rb_segs[rb], s1 = rb_segs[rb + 1];
  if (s1 - s0 == 1) return;  // written by its only segment
  part += (size_t)y * n_seg * kBlk * kpn;
  float v = part[((size_t)s0 * kBlk + r) * kpn + n];
  for (int s = s0 + 1; s < s1; ++s) v += part[((size_t)s * kBlk + r) * kpn + n];
  out[idx] = v;
}

// Bt (kpn, qpad) = B^T rounded to T, zero beyond k and q.
template <typename T>
__global__ void bell_bt_kernel(const float* __restrict__ B, int q, int k,
                               int kpn, int qpad, T* __restrict__ Bt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)kpn * qpad) return;
  const int n = (int)(idx / qpad), c = (int)(idx % qpad);
  from_float(n < k && c < q ? B[(size_t)c * k + n] : 0.f, Bt[idx]);
}

template <typename T, int NT>
int launch_bell(const T* blocks, const int* bcols, const int* brows,
                const int* segs, int n_seg, const int* rb_segs, const float* B,
                int p, int q, int k, T* Bt, float* part, float* out,
                cudaStream_t st) {
  using Sm = BellSmem<T, NT>;
  constexpr int kpn = NT * 8;
  static bool smem_set = false;  // once per instantiation and process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bell_segment_kernel<T, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int qpad = ceil_div(q, kBlk) * kBlk;
  const int n_slices = ceil_div(k, kpn);
  const long long n_bt = (long long)kpn * n_slices * qpad;
  bell_bt_kernel<T><<<(int)((n_bt + 255) / 256), 256, 0, st>>>(
      B, q, k, kpn * n_slices, qpad, Bt);
  bell_segment_kernel<T, NT>
      <<<dim3(n_seg, n_slices), kBellThreads, Sm::kBytes, st>>>(
          blocks, bcols, brows, segs, rb_segs, Bt, qpad, p, k, out, part);
  const long long n_out = (long long)p * k;
  bell_combine_kernel<<<(int)((n_out + 255) / 256), 256, 0, st>>>(
      rb_segs, part, n_seg, p, k, kpn, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bell(const T* blocks, const int* bcols, const int* brows,
                  const int* segs, int n_seg, const int* rb_segs,
                  const float* B, int p, int q, int k, void* Bt, float* part,
                  float* out, cudaStream_t st) {
  T* bt = static_cast<T*>(Bt);
  switch ((k + 7) / 8) {
    case 1:
      return launch_bell<T, 1>(blocks, bcols, brows, segs, n_seg, rb_segs, B,
                               p, q, k, bt, part, out, st);
    case 2:
      return launch_bell<T, 2>(blocks, bcols, brows, segs, n_seg, rb_segs, B,
                               p, q, k, bt, part, out, st);
    case 3:
      return launch_bell<T, 3>(blocks, bcols, brows, segs, n_seg, rb_segs, B,
                               p, q, k, bt, part, out, st);
    default:
      return launch_bell<T, 4>(blocks, bcols, brows, segs, n_seg, rb_segs, B,
                               p, q, k, bt, part, out, st);
  }
}

}  // namespace pycmf

// blocks (NB, 128, 128) f32 (bf16 == 0) or bf16; bcols, brows (NB,),
// segs (n_seg + 1,) and rb_segs (ceil(p / 128) + 1,) int32 (the layout's
// segments: segment s holds blocks segs[s] .. segs[s+1], row block r the
// segments rb_segs[r] .. rb_segs[r+1]); B (q, k) f32; out (p, k) f32.
// Scratch: Bt (KPN, ceil(q / 128) * 128) at the blocks' dtype and part
// (n_seg, 128, KPN) f32, KPN = k rounded up to 8 (k <= 32) or to 32
// (k > 32, in 32-column slices). k >= 1. Returns the CUDA error of the
// launches (0 on success).
extern "C" int pycmf_bell_spmm(int bf16, const void* blocks, const int* bcols,
                               const int* brows, const int* segs, int n_seg,
                               const int* rb_segs, const float* B, int p,
                               int q, int k, void* Bt, float* part,
                               float* out, void* stream) {
  using namespace pycmf;
  if (p < 1 || q < 1 || k < 1 || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_bell(static_cast<const __nv_bfloat16*>(blocks), bcols,
                         brows, segs, n_seg, rb_segs, B, p, q, k, Bt, part,
                         out, st);
  return dispatch_bell(static_cast<const float*>(blocks), bcols, brows, segs,
                       n_seg, rb_segs, B, p, q, k, Bt, part, out, st);
}
