// Threefry-2x32 random bits for Hopper (sm_90a), called through ctypes:
// the reference's counter-based generator, bit for bit.
//
// Replaces: no Pallas kernel. It is the counterpart of jax.random's
// threefry2x32 hash (jax/_src/prng.py: _threefry2x32_lowering), under the
// key schedule the reference's sampled Newton fit draws its columns with
// (pycmf_tpu/solvers/newton.py:115-143, 363-369, 636; the fit loops'
// fold_in of the iteration, pycmf_tpu/solvers/common.py:191-197). One
// kernel serves every operation of that schedule (ops/random.py):
//
//   out[j] = threefry2x32(K, (c >> 32, c & 0xffffffff)),  c = start + j,
//
// written in one of three forms: the pair (y0, y1) (split, fold_in);
// y0 ^ y1 (32-bit random_bits of JAX's partitionable scheme, the default of
// JAX 0.9); or y0 ^ y1 ^ 0x80000000 as an int32, the bits shifted into the
// signed range in their unsigned order (the sort keys of a shuffle round:
// a stable sort of them is jax's sort_key_val on the uint32 bits, at half
// the bytes and half the radix passes of int64 keys). K is
// the key, or with `base` the derived key fold_in(key, *base + offset) =
// threefry2x32(key, (0, uint32(*base + offset))), hashed by every thread:
// `base` is an int64 in device memory (the fit's iteration counter), so a
// graph replayed inside a conditional while node reads the live iteration.
//
// Keys and the first two forms are int64 tensors holding uint32 values, as
// the plain version (ops/kernels/threefry.py: threefry2x32_ref) carries
// them.
//
// Bound: bytes for every n the solver draws. One thread per counter pair
// does 20 rounds (an add, a funnel-shift rotate and a xor each) and five
// key injections, about 82 integer operations, and writes 4, 8 or 16 bytes:
// at 3.35 TB/s and the card's 67 T operations/s outside the tensor cores,
// the writes bound it. Small n (a key, a split of 2 or 3) is latency: one
// launch of one block.

#include "common.cuh"

namespace pycmf {

constexpr int kThreefryThreads = 256;
enum ThreefryForm : int { kBits = 0, kPairs = 1, kSortKeys = 2 };

__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1,
                                               int rot) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, rot);
  x1 ^= x0;
}

// Threefry-2x32, 20 rounds (Salmon et al., SC'11), as jax/_src/prng.py's
// unrolled lowering: rotations 13 15 26 6 and 17 29 16 24 in turn, the key
// schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after every 4 rounds
// with the injection's index added to the second word.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 1; g <= 5; ++g) {
    if (g & 1) {
      threefry_round(x0, x1, 13);
      threefry_round(x0, x1, 15);
      threefry_round(x0, x1, 26);
      threefry_round(x0, x1, 6);
    } else {
      threefry_round(x0, x1, 17);
      threefry_round(x0, x1, 29);
      threefry_round(x0, x1, 16);
      threefry_round(x0, x1, 24);
    }
    x0 += ks[g % 3];
    x1 += ks[(g + 1) % 3] + static_cast<uint32_t>(g);
  }
}

__global__ void threefry_kernel(const long long* key, const long long* base,
                                long long offset, unsigned long long start,
                                long long n, int form, void* out) {
  uint32_t k0 = static_cast<uint32_t>(key[0]);
  uint32_t k1 = static_cast<uint32_t>(key[1]);
  if (base != nullptr) {
    uint32_t d0 = 0, d1 = static_cast<uint32_t>(*base + offset);
    threefry2x32(k0, k1, d0, d1);
    k0 = d0;
    k1 = d1;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < n; j += stride) {
    const unsigned long long c = start + static_cast<unsigned long long>(j);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(k0, k1, x0, x1);
    if (form == kPairs) {
      long long* o = static_cast<long long*>(out);
      o[2 * j] = x0;
      o[2 * j + 1] = x1;
    } else if (form == kBits) {
      static_cast<long long*>(out)[j] = x0 ^ x1;
    } else {
      static_cast<int*>(out)[j] = static_cast<int>(x0 ^ x1 ^ 0x80000000u);
    }
  }
}

}  // namespace pycmf

// n outputs of the hash under `key` (int64 [2], uint32 values), or under
// fold_in(key, *base + offset) when `base` is not null, at counters start
// .. start + n - 1, in `form` (ThreefryForm): their xor ([n] int64), the
// pairs ([n, 2] int64) or the xor as order-preserving int32 sort keys
// ([n] int32). Returns a CUDA error (0 on success).
extern "C" int pycmf_threefry(const long long* key, const long long* base,
                              long long offset, unsigned long long start,
                              long long n, int form, void* out, int device,
                              void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (n < 1 || key == nullptr || out == nullptr || form < kBits ||
      form > kSortKeys)
    return (int)cudaErrorInvalidValue;
  const long long want = (n + kThreefryThreads - 1) / kThreefryThreads;
  const int blocks = static_cast<int>(
      want < 16LL * sm_count() ? want : 16LL * sm_count());
  threefry_kernel<<<blocks, kThreefryThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      key, base, offset, start, n, form, out);
  return (int)cudaGetLastError();
}
