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
// A's values are f32 or bf16 (widened exactly), B and M f32, any k >= 1.
//
// Bound: bytes. The compulsory bytes (each input read once, the output
// written once) are the CSR arrays plus B; per nonzero the kernel also
// gathers a k-float row of B (80 bytes at k = 20) for k FMAs, from L2 when
// B fits its 50 MB, else from DRAM (20NG surrogate: 0.0026 ms; RCV1
// shape: 0.129 ms, 1.58 ms with the gathers from DRAM).
//
// Design:
// - Work split by nonzeros, not rows, because row lengths are Zipfian (a
//   term x document matrix has rows holding most documents): chunk c is
//   the fixed range [c*ch, (c+1)*ch) of the nonzeros. The chunk size ch (a
//   power of two) is chosen by the caller (ops/kernels/spmm.py), which
//   also sizes the scratch from it: the rule lives in one place.
// - Lane groups: G = ceil(k / 4) lanes walk one chunk together, lane j of
//   the group owning output columns 4j .. 4j+3 and gathering them with one
//   16-byte load (B's row stride `ld` is a multiple of 4). A warp holds
//   floor(32 / G) groups (6 at k = 20, 30 lanes busy), each on its own
//   chunk. Every lane reads its nonzero's column, value and row id itself
//   (a group's same-address reads are one broadcast): no shuffles per
//   nonzero. Eight nonzeros are loaded (as 16-byte vectors), then their
//   eight gathers issued, then their FMAs, so each lane keeps eight gathers
//   in flight without a per-lane array of 32 (the old design's 127
//   registers, 16 warps per SM).
// - Row ids: read per nonzero, in the same vector loads as the columns,
//   so a row change needs no dependent load. The other route (each chunk's
//   first row by a binary search over indptr, then a load of the next row
//   pointer at every row change) was not built: at the RCV1 shape the row
//   ids are 243 MB of the walk's reads, ~0.07 ms at the DRAM rate against
//   a ~2.4 ms call (an estimate, not a measurement).
// - Order: a group sums its chunk's nonzeros in order. A row wholly inside
//   a chunk is written directly. A row that crosses a chunk boundary leaves
//   one partial per chunk it touches (slot 0: the chunk's first row,
//   continuing from the chunk before; slot 1: its last row, continuing into
//   the next), and csr_combine_kernel sums them in chunk order. The combine
//   pass stays a second launch: folding it into the walk needs a grid-wide
//   wait for the other chunks of a row (a per-row counter, zeroed every
//   call, or a spin on chunks that may not be resident). No float atomics:
//   a call repeats bit for bit.
// - No memset: the walk writes every output row. A group that sees row r
//   followed by row r' > r + 1 zeroes rows r+1 .. r'-1; the gap before a
//   chunk's first row belongs to that chunk, and the last chunk zeroes the
//   rows after the last nonzero.
// - k > 32: the grid's second dimension walks 32-column slices of B (and
//   M) and of the output, each slice the k <= 32 walk on its columns with
//   its own partials. csr_rowdots writes each slice's per-row dots to
//   scratch and csr_rowdots_slices_kernel sums them per row in slice order
//   (a row crossing chunks: its partials in chunk order first).
// - Registers and warps per SM: __launch_bounds__(256, 3), 80 registers
//   (ptxas: 4-12 bytes of spills), 24 warps per SM. Four nonzeros per step
//   at 64 registers (32 warps per SM) measured 11% slower at the RCV1
//   shape in one A/B (PERF.md).
#include "common.cuh"

namespace pycmf {

constexpr int kCsrWarps = 8;
constexpr int kUnroll = 8;  // nonzeros loaded, then gathered, per step

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Four consecutive values from a 16-byte-aligned (f32) or 8-byte-aligned
// (bf16) address, widened to float.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a), v[1] = __high2float(a);
  v[2] = __low2float(b), v[3] = __high2float(b);
}

// Columns of one slice of the factors (blockIdx.y walks the slices).
constexpr int kCsrSlice = 32;

// Where slice y of a call reads and writes: B and M from column c0 on, its
// kk (<= 32) columns; spmm output columns c0 .. c0+kk-1 of rows of stride
// k, rowdots one float per row (the output when there is one slice, else
// row y of the (n_slices, p) scratch); partials of width kw from slice
// offset 2 * n_chunks * c0 (spmm) or 2 * n_chunks * y (rowdots).
struct CsrSlice {
  int c0, kk, kw, ldo;
  __device__ CsrSlice(int y, int k, bool rowdots) {
    c0 = y * kCsrSlice;
    kk = min(kCsrSlice, k - c0);
    kw = rowdots ? 1 : kk;
    ldo = rowdots ? 1 : k;
  }
};

// One group per chunk of slice blockIdx.y. B (and M) have row stride ld, a
// multiple of 4 with zeros past k. slice_out: the rowdots scratch of a
// call with several slices (unused otherwise).
template <typename T, bool kRowdots>
__global__ void __launch_bounds__(kCsrWarps * 32, 3)
    csr_chunk_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                     const int* __restrict__ row_ids, const float* __restrict__ B,
                     const float* __restrict__ M, long long nnz, int p, int k,
                     int ld, int ch, long long n_chunks, float* __restrict__ out,
                     float* __restrict__ part, float* __restrict__ slice_out) {
  const CsrSlice sc(blockIdx.y, k, kRowdots);
  B += sc.c0;
  if constexpr (kRowdots) {
    M += sc.c0;
    part += 2 * n_chunks * blockIdx.y;
    if (gridDim.y > 1) out = slice_out + (size_t)blockIdx.y * p;
  } else {
    part += 2 * n_chunks * sc.c0;
    out += sc.c0;
  }
  const int lane = threadIdx.x & 31;
  const int G = (sc.kk + 3) >> 2, P = 32 / G;
  const int gi = lane / G, sl = lane - gi * G;
  if (gi >= P) return;
  const long long c =
      ((long long)blockIdx.x * kCsrWarps + threadIdx.x / 32) * P + gi;
  if (c >= n_chunks) return;  // the whole group leaves together
  const unsigned gmask = ((1u << G) - 1u) << (gi * G);
  const int kw = sc.kw, kk = sc.kk;
  const int col0 = 4 * sl;
  const bool vec_out = (sc.ldo & 3) == 0 && (kk & 3) == 0;
  const long long s = c * ch;
  const long long e = s + ch < nnz ? s + ch : nnz;
  const int prev_row = s > 0 ? row_ids[s - 1] : -1;
  const int next_row = e < nnz ? row_ids[e] : -1;

  // columns col0 .. col0+3 of the slice's row, those < kk
  auto store_row = [&](float* row, float4 v) {
    if (vec_out) {
      *reinterpret_cast<float4*>(row + col0) = v;
    } else {
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + j < kk) row[col0 + j] = a[j];
    }
  };
  auto flush = [&](int r, float4 a) {
    float* dst = r == prev_row   ? part + (size_t)(2 * c) * kw
                 : r == next_row ? part + (size_t)(2 * c + 1) * kw
                                 : out + (size_t)r * sc.ldo;
    if constexpr (kRowdots) {
      const float4 m = ldg4(M + (size_t)r * ld + col0);
      const float v = fmaf(m.w, a.w, fmaf(m.z, a.z, fmaf(m.y, a.y, m.x * a.x)));
      float sum = 0.f;  // the group's lanes in a fixed order
      for (int j = 0; j < G; ++j) sum += __shfl_sync(gmask, v, gi * G + j);
      if (sl == 0) *dst = sum;
    } else {
      store_row(dst, a);
    }
  };
  auto zero_rows = [&](int r0, int r1) {  // empty rows r0 .. r1-1
    for (int r = r0; r < r1; ++r) {
      if constexpr (kRowdots) {
        if (sl == 0) out[r] = 0.f;
      } else {
        store_row(out + (size_t)r * sc.ldo, zero4());
      }
    }
  };

  int cur = row_ids[s];
  zero_rows(prev_row + 1, cur);
  float4 acc = zero4();
  for (long long base = s; base < e; base += kUnroll) {
    int col[kUnroll], row[kUnroll];
    float val[kUnroll];
    if (base + kUnroll <= e) {  // ch is a multiple of kUnroll: aligned
#pragma unroll
      for (int h = 0; h < kUnroll; h += 4) {
        const int4 ci = __ldg(reinterpret_cast<const int4*>(indices + base + h));
        const int4 ri = __ldg(reinterpret_cast<const int4*>(row_ids + base + h));
        col[h] = ci.x, col[h + 1] = ci.y, col[h + 2] = ci.z, col[h + 3] = ci.w;
        row[h] = ri.x, row[h + 1] = ri.y, row[h + 2] = ri.z, row[h + 3] = ri.w;
        float v[4];
        load4(data + base + h, v);
        val[h] = v[0], val[h + 1] = v[1], val[h + 2] = v[2], val[h + 3] = v[3];
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = base + u < e;
        col[u] = in ? indices[base + u] : 0;
        row[u] = in ? row_ids[base + u] : cur;
        val[u] = in ? to_float(data[base + u]) : 0.f;
      }
    }
    float4 bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      bv[u] = base + u < e ? ldg4(B + (size_t)col[u] * ld + col0) : zero4();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < e) {  // uniform across the group
        if (row[u] != cur) {
          flush(cur, acc);
          zero_rows(cur + 1, row[u]);
          cur = row[u];
          acc = zero4();
        }
        acc.x = fmaf(val[u], bv[u].x, acc.x);
        acc.y = fmaf(val[u], bv[u].y, acc.y);
        acc.z = fmaf(val[u], bv[u].z, acc.z);
        acc.w = fmaf(val[u], bv[u].w, acc.w);
      }
    }
  }
  flush(cur, acc);
  if (e == nnz) zero_rows(cur + 1, p);
}

// One warp per chunk c: if c is the last chunk of a row that began in an
// earlier chunk c0, sum the row's partials in chunk order: slot 1 of c0,
// then slot 0 of c0+1 .. c. (One lane per chunk, each warp then summing
// its rows in turn, measured 18 us per call on the 20NG surrogate against
// this version's 12: too few warps in flight.)
// Slice blockIdx.y, laid out as in csr_chunk_kernel.
template <bool kRowdots>
__global__ void __launch_bounds__(kCsrWarps * 32)
    csr_combine_kernel(const int* __restrict__ indptr,
                       const int* __restrict__ row_ids, long long nnz, int k,
                       int ch, long long n_chunks, const float* __restrict__ part,
                       float* __restrict__ out) {
  const CsrSlice sc(blockIdx.y, k, kRowdots);
  const int kw = sc.kw;
  if constexpr (kRowdots) {
    part += 2 * n_chunks * blockIdx.y;
  } else {
    part += 2 * n_chunks * sc.c0;
    out += sc.c0;
  }
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
#pragma unroll 8
  for (long long cc = c0 + 1; cc <= c; ++cc)
    acc += part[(size_t)(2 * cc) * kw + lane];
  out[(size_t)r * sc.ldo + lane] = acc;
}

// csr_rowdots with several slices: out[r] = the slices' dots of row r in
// slice order, each a row's partials in chunk order where it crosses
// chunks (slot 1 of its first chunk, then slot 0 of the next ones, as in
// csr_combine_kernel), else the slice's scratch row.
__global__ void __launch_bounds__(kCsrWarps * 32)
    csr_rowdots_slices_kernel(const int* __restrict__ indptr, int p, int ch,
                              int n_slices, long long n_chunks,
                              const float* __restrict__ part,
                              const float* __restrict__ slice_out,
                              float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p) return;
  const long long a = indptr[r], b = indptr[r + 1];
  const long long c0 = a / ch, c1 = b > a ? (b - 1) / ch : c0;
  float total = 0.f;
  for (int y = 0; y < n_slices; ++y) {
    const float* pt = part + 2 * n_chunks * y;
    float v;
    if (c1 > c0) {
      v = pt[2 * c0 + 1];
      for (long long cc = c0 + 1; cc <= c1; ++cc) v += pt[2 * cc];
    } else {
      v = slice_out[(size_t)y * p + r];
    }
    total += v;
  }
  out[r] = total;
}

// Scratch (floats): the partials, 2 * n_chunks per column of the output
// (spmm: k; rowdots: one per slice), then for rowdots with several slices
// their (n_slices, p) per-row dots.
template <typename T, bool kRowdots>
int launch_csr(const T* data, const int* indices, const int* indptr,
               const int* row_ids, long long nnz, int p, int k, int ld, int ch,
               const float* B, const float* M, float* out, float* work,
               cudaStream_t st) {
  const long long n_chunks = (nnz + ch - 1) / ch;
  const int n_slices = ceil_div(k, kCsrSlice);
  const int per_warp = 32 / ((min(k, kCsrSlice) + 3) / 4);
  const long long warps = (n_chunks + per_warp - 1) / per_warp;
  const bool sliced_dots = kRowdots && n_slices > 1;
  float* slice_out = work + 2 * n_chunks * (kRowdots ? n_slices : k);
  csr_chunk_kernel<T, kRowdots>
      <<<dim3((unsigned)((warps + kCsrWarps - 1) / kCsrWarps), n_slices),
         kCsrWarps * 32, 0, st>>>(data, indices, row_ids, B, M, nnz, p, k, ld,
                                  ch, n_chunks, out, work, slice_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sliced_dots) {
    csr_rowdots_slices_kernel<<<ceil_div(p, kCsrWarps * 32), kCsrWarps * 32, 0,
                                st>>>(indptr, p, ch, n_slices, n_chunks, work,
                                      slice_out, out);
  } else {
    csr_combine_kernel<kRowdots>
        <<<dim3((unsigned)((n_chunks + kCsrWarps - 1) / kCsrWarps), n_slices),
           kCsrWarps * 32, 0, st>>>(indptr, row_ids, nnz, k, ch, n_chunks,
                                    work, out);
  }
  return (int)cudaGetLastError();
}


// The walk's vector loads need 16-byte-aligned column and row-id arrays
// and factors, and 8-byte-aligned values.
inline bool csr_args_ok(long long nnz, int p, int k, int ld, int ch,
                        const void* data, const int* indices,
                        const int* row_ids, const float* B) {
  const uintptr_t a16 = (uintptr_t)indices | (uintptr_t)row_ids | (uintptr_t)B;
  return nnz >= 1 && p >= 1 && k >= 1 && ld >= k &&
         ld % 4 == 0 && ch >= kUnroll && ch % kUnroll == 0 &&
         (a16 & 15) == 0 && ((uintptr_t)data & 7) == 0;
}

}  // namespace pycmf

// A: data (nnz, f32 if bf16 == 0 else bf16), indices, indptr (p + 1),
// row_ids: int32; B (q, ld) f32 with zeros past column k (ld a multiple of
// 4); out (p, k) f32, every row written; ch: nonzeros per chunk, a
// multiple of 8; work: 2 * ceil(nnz / ch) * k floats; the launches go to
// `stream` on CUDA device `device`. nnz >= 1, k >= 1.
extern "C" int pycmf_csr_spmm(int bf16, const void* data, const int* indices,
                              const int* indptr, const int* row_ids,
                              long long nnz, int p, int k, int ld, int ch,
                              const float* B, float* out, float* work,
                              int device, void* stream) {
  using namespace pycmf;
  if (!csr_args_ok(nnz, p, k, ld, ch, data, indices, row_ids, B))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_csr<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(data), indices, indptr, row_ids, nnz,
        p, k, ld, ch, B, nullptr, out, work, st);
  return launch_csr<float, false>(static_cast<const float*>(data), indices,
                                  indptr, row_ids, nnz, p, k, ld, ch, B,
                                  nullptr, out, work, st);
}

// As pycmf_csr_spmm with M (p, ld) f32 laid out as B; out (p,) f32;
// work: 2 * ceil(nnz / ch) * S floats, S = ceil(k / 32), and S * p more
// when S > 1.
extern "C" int pycmf_csr_rowdots(int bf16, const void* data, const int* indices,
                                 const int* indptr, const int* row_ids,
                                 long long nnz, int p, int k, int ld, int ch,
                                 const float* M, const float* B, float* out,
                                 float* work, int device, void* stream) {
  using namespace pycmf;
  if (!csr_args_ok(nnz, p, k, ld, ch, data, indices, row_ids, B) ||
      ((uintptr_t)M & 15) != 0)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_csr<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(data), indices, indptr, row_ids, nnz,
        p, k, ld, ch, B, M, out, work, st);
  return launch_csr<float, true>(static_cast<const float*>(data), indices,
                                 indptr, row_ids, nnz, p, k, ld, ch, B, M, out,
                                 work, st);
}
