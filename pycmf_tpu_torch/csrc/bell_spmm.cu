// Block-sparse (BlockEll) product for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/bell.py:bell_spmm (TPU kernel K7), and
// through it bell_inner.
//
// out (p, k) f32 = A (p, q) @ B (q, k) for A stored as NB dense 128 x 128
// blocks (f32 or bf16) sorted by row block, bptr[rb] .. bptr[rb+1] being the
// blocks of row block rb (every row block has at least one, so every output
// row is written). B is f32 and, as in the reference (B.astype(blocks
// dtype)), rounded to the blocks' dtype before the product; products and
// sums are f32 FMAs, bf16 x bf16 widening exactly.
//
// Bound: operations or bytes, by the blocks' fill. Each stored block is
// read once (32 KB in bf16) for 2 * 128 * 128 * k flops: at k = 20, 20
// f32 FMAs per bf16 byte, so on CUDA cores (67 TFLOP/s) the f32 rate binds
// before the 3.35 TB/s of DRAM. Tensor cores (mma.sync, then wgmma) are a
// later step.
//
// Design: one 128-thread block per row block; thread t owns row t and keeps
// its k sums in registers. The blocks of the row are walked in their stored
// order, in 32-column slabs: the slab of A (128 x 32, one row per thread,
// padded to 33 floats so a warp's row reads hit distinct banks) and the
// matching 32 rows of B (k padded to KP, read as float4 broadcasts) are
// staged in shared memory, then each thread does 32 * KP FMAs. Every sum
// has a fixed order: a call repeats bit for bit.
#include "common.cuh"

namespace pycmf {

constexpr int kBlk = 128;   // BlockEll block rows and columns
constexpr int kSlab = 32;   // columns of a block staged at a time

__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int KP>
__global__ void __launch_bounds__(kBlk)
    bell_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                     const int* __restrict__ bptr, const float* __restrict__ B,
                     int p, int q, int k, float* __restrict__ out) {
  __shared__ float As[kBlk][kSlab + 1];
  __shared__ __align__(16) float Bs[kSlab][KP];
  const int t = threadIdx.x;
  const int rb = blockIdx.x;
  float acc[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) acc[j] = 0.f;

  for (int b = bptr[rb]; b < bptr[rb + 1]; ++b) {
    const T* blk = blocks + (size_t)b * kBlk * kBlk;
    const int col0 = bcols[b] * kBlk;
    for (int s0 = 0; s0 < kBlk; s0 += kSlab) {
      __syncthreads();  // the previous slab is consumed
#pragma unroll 4
      for (int i = 0; i < kSlab; ++i) {
        const int idx = i * kBlk + t;
        const int r = idx / kSlab, c = idx % kSlab;
        As[r][c] = to_float(blk[r * kBlk + s0 + c]);
      }
      for (int idx = t; idx < kSlab * KP; idx += kBlk) {
        const int c = idx / KP, j = idx % KP;
        const int row = col0 + s0 + c;
        Bs[c][j] = (j < k && row < q)
                       ? round_like(B[(size_t)row * k + j], T{})
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kSlab; ++c) {
        const float a = As[t][c];
        const float4* b4 = reinterpret_cast<const float4*>(Bs[c]);
#pragma unroll
        for (int j = 0; j < KP / 4; ++j) {
          const float4 v = b4[j];
          acc[4 * j] = fmaf(a, v.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(a, v.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(a, v.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(a, v.w, acc[4 * j + 3]);
        }
      }
    }
  }
  const int row = rb * kBlk + t;
  if (row < p) {
#pragma unroll
    for (int j = 0; j < KP; ++j)
      if (j < k) out[(size_t)row * k + j] = acc[j];
  }
}

}  // namespace pycmf

// blocks (NB, 128, 128) f32 (bf16 == 0) or bf16; bcols (NB,) and
// bptr (ceil(p / 128) + 1,) int32; B (q, k) f32; out (p, k) f32.
// 1 <= k <= 32. Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_bell_spmm(int bf16, const void* blocks, const int* bcols,
                               const int* bptr, const float* B, int p, int q,
                               int k, float* out, void* stream) {
  using namespace pycmf;
  if (p < 1 || q < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rb = ceil_div(p, kBlk);
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    if (bf16)
      bell_spmm_kernel<__nv_bfloat16, KP><<<n_rb, kBlk, 0, st>>>(
          static_cast<const __nv_bfloat16*>(blocks), bcols, bptr, B, p, q, k,
          out);
    else
      bell_spmm_kernel<float, KP><<<n_rb, kBlk, 0, st>>>(
          static_cast<const float*>(blocks), bcols, bptr, B, p, q, k, out);
  });
  return (int)cudaGetLastError();
}
