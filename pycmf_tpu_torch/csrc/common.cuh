// Pieces shared by every kernel library of pycmf_tpu_torch (one .cu per
// library, each built by nvcc for sm_90a and loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pycmf {

// Widest k of the one-warp-per-row routes (K5, and K6's shared S tile);
// wider k goes in 32-column slices or tiles (each kernel's header).
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

// X's dtype as the entry points of the data-pass kernels (K1-K4) take it
// (ops/kernels/mu_fused.py: X_CODES); sizes in bytes.
enum XDtype : int { kXF32 = 0, kXBF16 = 1, kXE4M3 = 2 };
inline int x_dtype_bytes(int code) {
  return code == kXF32 ? 4 : code == kXBF16 ? 2 : code == kXE4M3 ? 1 : 0;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// e4m3 -> f16 -> f32, each step exact for every finite e4m3 value.
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Butterfly sum: every lane ends with the same bits (each step adds the
// same two operands on both partner lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void from_float(float x, float& y) { y = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16& y) {
  y = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_float(float x, __nv_fp8_e4m3& y) {
  y.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// Brings the 128-byte line holding p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// 16-byte asynchronous copy global -> shared. With bytes = 0 nothing is
// read and the 16 bytes of shared memory are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
// 4-byte asynchronous copy global -> shared (through L1), for data whose
// address is not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
// The same with bytes = 0: nothing read, the 4 bytes zero-filled.
__device__ __forceinline__ void cp_async4z(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Tensor-core tiles (mma.sync, f32 accumulators). Fragment layouts follow
// the PTX ISA: g = lane / 4 picks the row of A and the column of B, t =
// lane % 4 the position along the inner dimension.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// 3xTF32: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), in that order (about
// 2^-21 relative error per product: the reference's HIGHEST for f32).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

inline int pad_k(int k) { return (k + 3) / 4 * 4; }

// Call f(std::integral_constant<int, KP>) with KP = pad_k(k), 4 <= KP <= 32.
template <int KP = 4, typename F>
void with_kp(int k, F&& f) {
  if constexpr (KP < kMaxK) {
    if (pad_k(k) != KP) return with_kp<KP + 4>(k, f);
  }
  f(std::integral_constant<int, KP>{});
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count < 1) count = 1;
  }
  return count;
}

// The opt-in shared memory of one CTA on `device`, in bytes.
inline int smem_optin(int device) {
  static int optin[16] = {};
  if (optin[device] == 0)
    cudaDeviceGetAttribute(&optin[device],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return optin[device];
}

// Makes `device` current for the launches of one call and restores the
// caller's device after (the Python wrapper then needs no device switch).
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace pycmf

extern "C" const char* pycmf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
