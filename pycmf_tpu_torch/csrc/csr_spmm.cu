// CSR products for Hopper (sm_90a), called through ctypes.
//
// Replaces, one row gather serving four contracts:
//   pycmf_tpu/ops/pallas/onehot.py:onehot_spmm    (K8, A @ B)
//   pycmf_tpu/ops/pallas/onehot.py:onehot_spmm_t  (K9, A^T @ B: this kernel
//       on the CSR of A^T, which the fit builds once on the host)
//   pycmf_tpu/ops/pallas/spmm.py:spmm_tiled       (K10, A @ B)
//   pycmf_tpu/ops/pallas/spmm.py:sddmm_rowdots_tiled (K11, per row
//       sum_j a_ij (M_i . B_j))
// The TPU has no fast gather, so the reference packed nonzeros into one-hot
// strips or row-block-padded tiles; Hopper gathers rows of B from L2 and
// reads the CSR arrays as they are.
//
// csr_spmm:    out (p, k) = A (p, q) @ B (q, k)
// csr_rowdots: out (p,)   = sum_j a_ij (M_i . B_j) = M_i . (A B)_i
// A's values are f32 or bf16 (widened exactly), B and M f32, 1 <= k <= 32.
//
// Bound: bytes. Per nonzero the kernel reads its value, column and row id
// (10-12 bytes) and gathers a k-float row of B (80 bytes at k = 20) for k
// f32 FMAs: one FMA per 4 bytes gathered. The compulsory bytes (each input read once,
// the output written once) are the CSR arrays plus B; the gather reads B
// nnz/q times over, from L2 when B fits its 50 MB, else from DRAM.
//
// Design: the work is split by nonzeros, not rows, because row lengths are
// Zipfian (a term x document matrix has rows holding most documents). Warp
// w takes the fixed chunk [w*CH, (w+1)*CH) of the nonzeros; lane j < k owns
// column j of the output. A batch of 32 nonzeros is loaded coalesced (one
// per lane) and broadcast by shuffles; all 32 gathers of B are issued
// before the FMAs that consume them, so each warp keeps 32 loads in flight.
// A row wholly inside the chunk is written directly. A row that crosses a
// chunk boundary leaves one partial per chunk it touches (slot 0: the
// chunk's first row, continuing from the chunk before; slot 1: its last
// row, continuing into the next), and a second kernel sums those partials
// in chunk order. Rows with no nonzeros stay as the caller zeroed them. No
// float atomics: every sum has a fixed order, so a call repeats bit for
// bit. The chunk size adapts to nnz so that there are several warps per SM
// scheduler, and the partials stay small (at most 2 * ceil(nnz / CH) rows).
#include "common.cuh"

namespace pycmf {

constexpr int kCsrWarps = 8;

// Nonzeros per warp: a power of two in [32, 1024], about 64 warps per SM.
inline int csr_chunk(long long nnz) {
  long long want = nnz / (64LL * sm_count());
  int ch = 32;
  while (ch < 1024 && ch < want) ch <<= 1;
  return ch;
}

inline long long csr_chunks(long long nnz, int ch) { return (nnz + ch - 1) / ch; }

// One warp per chunk. kw = k (spmm) or 1 (rowdots): the width of one row of
// `out` and of one partial.
template <typename T, bool kRowdots>
__global__ void __launch_bounds__(kCsrWarps * 32)
    csr_chunk_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                     const int* __restrict__ row_ids, const float* __restrict__ B,
                     const float* __restrict__ M, long long nnz, int k, int ch,
                     long long n_chunks, float* __restrict__ out,
                     float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kCsrWarps + threadIdx.x / 32;
  if (c >= n_chunks) return;  // the whole warp leaves together
  const int kw = kRowdots ? 1 : k;
  const long long s = c * ch;
  const long long e = s + ch < nnz ? s + ch : nnz;
  const int prev_row = s > 0 ? row_ids[s - 1] : -1;
  const int next_row = e < nnz ? row_ids[e] : -1;
  const bool active = lane < k;

  auto flush = [&](int r, float acc) {
    float v = acc;
    if constexpr (kRowdots) {
      const float m = active ? M[(size_t)r * k + lane] : 0.f;
      v = warp_sum(m * acc);
    }
    float* dst;
    if (r == prev_row) {
      dst = part + (size_t)(2 * c) * kw;
    } else if (r == next_row) {
      dst = part + (size_t)(2 * c + 1) * kw;
    } else {
      dst = out + (size_t)r * kw;
    }
    if (kRowdots ? lane == 0 : active) dst[kRowdots ? 0 : lane] = v;
  };

  int cur = row_ids[s];
  float acc = 0.f;
  for (long long base = s; base < e; base += 32) {
    const long long i = base + lane;
    int col = 0, row = cur;
    float val = 0.f;
    if (i < e) {
      col = indices[i];
      row = row_ids[i];
      val = to_float(data[i]);
    }
    float bv[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int ct = __shfl_sync(kFull, col, t);
      bv[t] = (active && base + t < e) ? B[(size_t)ct * k + lane] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      if (base + t < e) {  // warp-uniform
        const int rt = __shfl_sync(kFull, row, t);
        const float vt = __shfl_sync(kFull, val, t);
        if (rt != cur) {
          flush(cur, acc);
          cur = rt;
          acc = 0.f;
        }
        acc = fmaf(vt, bv[t], acc);
      }
    }
  }
  flush(cur, acc);
}

// One warp per chunk c: if c is the last chunk of a row that began in an
// earlier chunk c0, sum the row's partials in chunk order: slot 1 of c0,
// then slot 0 of c0+1 .. c.
__global__ void __launch_bounds__(kCsrWarps * 32)
    csr_combine_kernel(const int* __restrict__ indptr,
                       const int* __restrict__ row_ids, long long nnz, int kw,
                       int ch, long long n_chunks,
                       const float* __restrict__ part, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kCsrWarps + threadIdx.x / 32;
  if (c < 1 || c >= n_chunks) return;
  const long long s = c * ch;
  const int r = row_ids[s];
  if (row_ids[s - 1] != r) return;                  // r starts in chunk c
  if (s + ch < nnz && row_ids[s + ch] == r) return;  // r goes on after c
  if (lane >= kw) return;
  const long long c0 = indptr[r] / ch;
  float acc = part[(size_t)(2 * c0 + 1) * kw + lane];
  for (long long cc = c0 + 1; cc <= c; ++cc)
    acc += part[(size_t)(2 * cc) * kw + lane];
  out[(size_t)r * kw + lane] = acc;
}

template <typename T, bool kRowdots>
int launch_csr(const T* data, const int* indices, const int* indptr,
               const int* row_ids, long long nnz, int k, const float* B,
               const float* M, float* out, float* part, cudaStream_t st) {
  const int ch = csr_chunk(nnz);
  const long long n_chunks = csr_chunks(nnz, ch);
  const int grid = (int)((n_chunks + kCsrWarps - 1) / kCsrWarps);
  csr_chunk_kernel<T, kRowdots><<<grid, kCsrWarps * 32, 0, st>>>(
      data, indices, row_ids, B, M, nnz, k, ch, n_chunks, out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  csr_combine_kernel<<<grid, kCsrWarps * 32, 0, st>>>(
      indptr, row_ids, nnz, kRowdots ? 1 : k, ch, n_chunks, part, out);
  return (int)cudaGetLastError();
}

}  // namespace pycmf

// Floats of scratch one call needs for nnz nonzeros and output width kw.
extern "C" long long pycmf_csr_workspace_floats(long long nnz, int kw) {
  using namespace pycmf;
  return 2 * csr_chunks(nnz, csr_chunk(nnz)) * (long long)kw;
}

// A: data (nnz, f32 if bf16 == 0 else bf16), indices, indptr (p + 1),
// row_ids: int32; B (q, k) f32; out (p, k) f32, zeroed by the caller;
// work: pycmf_csr_workspace_floats(nnz, k) floats. nnz >= 1, 1 <= k <= 32.
extern "C" int pycmf_csr_spmm(int bf16, const void* data, const int* indices,
                              const int* indptr, const int* row_ids,
                              long long nnz, int k, const float* B, float* out,
                              float* work, void* stream) {
  using namespace pycmf;
  if (nnz < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_csr<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(data), indices, indptr, row_ids, nnz,
        k, B, nullptr, out, work, st);
  return launch_csr<float, false>(static_cast<const float*>(data), indices,
                                  indptr, row_ids, nnz, k, B, nullptr, out,
                                  work, st);
}

// As pycmf_csr_spmm with M (p, k) f32; out (p,) f32, zeroed by the caller;
// work: pycmf_csr_workspace_floats(nnz, 1) floats.
extern "C" int pycmf_csr_rowdots(int bf16, const void* data, const int* indices,
                                 const int* indptr, const int* row_ids,
                                 long long nnz, int k, const float* M,
                                 const float* B, float* out, float* work,
                                 void* stream) {
  using namespace pycmf;
  if (nnz < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_csr<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(data), indices, indptr, row_ids, nnz,
        k, B, M, out, work, st);
  return launch_csr<float, true>(static_cast<const float*>(data), indices,
                                 indptr, row_ids, nnz, k, B, M, out, work, st);
}
