// Pieces shared by every kernel library of pycmf_tpu_torch (one .cu per
// library, each built by nvcc for sm_90a and loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pycmf {

constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Butterfly sum: every lane ends with the same bits (each step adds the
// same two operands on both partner lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

}  // namespace pycmf

extern "C" const char* pycmf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
