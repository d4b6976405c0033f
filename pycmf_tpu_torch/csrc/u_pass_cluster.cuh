// The f32 form of the fused U passes (K1, K2) at k <= 32: one read of X per
// call, on thread-block clusters (sm_90a).
//
// Bound: bytes of X, once (f32 X 30000 x 11314 is 1.358 GB: 0.41 ms at
// 3.35 TB/s), against 3 x 4 n m NP flops of 3xTF32 tensor-core work
// (~0.2 ms at 495 TFLOP/s; mma.sync reaches about half of that). The
// two-sweep route (u_pass_common.cuh) reads X twice and, at 64 rows a CTA,
// reads all of V^T (1.09 MB f32) for every 2.9 MB of X.
//
// Design: a persistent cluster of kCCtas = 16 CTAs (a non-portable size)
// splits m into slices of W columns (a multiple of 16, W <= kCMaxCols, and
// the CTA within 227 KB: mu_fused.py's plan). Each CTA loads its slice of
// V^T into shared memory once per call. The cluster walks bands of kCRows =
// 16 rows (band b on cluster b % clusters); each CTA holds its slice of
// three bands' X in shared memory (cp.async, 16-byte chunks) and, per band:
//   1. X V over its slice, warps 1-11: 3xTF32 mma.sync k-steps of 8
//      columns, each warp two chains from zero (alternate k-steps), V^T's
//      fragments by ldmatrix; the warps' partials summed in a fixed order;
//      band row r's sums pushed to the CTA of rank r (st.async into its
//      shared memory, completing bytes of its transaction barrier).
//   2. warp 0 of rank r, once the 16 ranks' sums of its band row have
//      arrived: X V summed in rank order, the caller's row epilogue (the MU
//      ratio, or K2's step and line search), U_new's row written and pushed
//      to every CTA of the cluster.
//   3. once the band's 16 U_new rows have arrived: X^T U_new over its slice
//      into numV's partial for its W columns, held in registers for the
//      whole call (warp w the 16-column tiles w, w + 12, ...; each band's
//      two k-steps a chain from zero, promoted).
// Band i + 1's X V (warps 1-11) runs beside band i's epilogue (warp 0), and
// band i + 2's load is issued once band i - 1's X^T U_new frees its buffer,
// so no CTA waits on the whole cluster: each waits on its own barriers for
// the 16 pushes it needs. At the end each cluster writes its numV partial
// (m x k) and each CTA its Gram partial (U_new^T U_new over the rows it
// owned, in band order, from U_new as written); u_pass_reduce_kernel sums
// both in a fixed order. No float atomics: two calls with one plan give
// the same bits. The plan's clusters are the card's resident ones (7 on an
// H100 SXM: its GPCs hold no eighth group of 16 SMs), so 112 of 132 SMs
// stream X.
//
// X rows are 4-byte aligned only (m = 11314 f32 rows are 45256 bytes): each
// tile row is copied as the aligned 16-byte chunks covering it, as the
// two-sweep route does (u_pass_common.cuh: Alignment), row r's first column
// at element offset o_r < 4, and the elements past m in the chunk that
// straddles a row's end are zeroed. TF32 splits take two operations
// (split_trunc): cvt.rna on the conversion pipe bound the first version,
// and a rounded hi costs ~4% of the call (PERF.md).
#pragma once

#include <cooperative_groups.h>

#include "u_pass_common.cuh"

namespace pycmf {

constexpr int kCCtas = 16;    // CTAs per cluster (column slices)
constexpr int kCRows = 16;    // rows per band: one m16 tile, one row a CTA
constexpr int kCWarps = 12;   // warp 0 runs the epilogue; 1-11 X V and loads
constexpr int kCThreads = kCWarps * 32;
constexpr int kCWork = kCThreads - 32;  // threads of warps 1-11
constexpr int kCSlots = 6;    // X V partial slots: warps 1-6, then 7-11 add
constexpr int kCBufs = 3;     // X bands in shared memory
constexpr int kCMTiles = 4;   // numV's 16-column tiles per warp, at most
constexpr int kCMaxCols = 16 * kCWarps * kCMTiles;  // W <= 768
constexpr int kCSmemMax = 232448;  // an H100 CTA's opt-in shared memory
static_assert(kCRows == kCCtas, "one band row per CTA of the cluster");
static_assert(kCMaxCols / 4 + 1 <= kCWork, "a thread per chunk of a row");

// Shared memory of one CTA, in floats from the start of the dynamic
// buffer: V^T (NP x ld), kCBufs X bands (kCRows x ld each), the epilogue's
// matrices, warps 1-11's X V partials (kCSlots slots), Pin (two bands: the
// 16 ranks' X V of this CTA's band row), Uin (two bands: the band's 16
// U_new rows), and the four transaction barriers (P_full, U_full; one per
// band parity). ld = W + 4 holds a row's offset within its first chunk;
// with W a multiple of 16 the 8 rows of an mma fragment fall on distinct
// banks.
struct CSmem {
  int ld, x, mats, pw, pin, uin, bars, floats;
  __host__ __device__ CSmem(int w, int np, int kmats) {
    ld = w + 4;
    x = np * ld;
    mats = x + kCBufs * kCRows * ld;
    pw = mats + kmats * np * np;
    pin = pw + kCSlots * kCRows * np;
    uin = pin + 2 * kCCtas * np;
    bars = uin + 2 * kCRows * np;  // 8-byte aligned: np is a multiple of 8
    floats = bars + 8;
  }
};

// Transaction barriers in shared memory (mbarrier): armed by one local
// arrival that expects `bytes`, completed when st.async stores of other
// CTAs have delivered them.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// v to the float at local shared address dst in CTA `rank` of the cluster,
// completing 4 bytes of that CTA's barrier at local address bar.
__device__ __forceinline__ void push_f32(uint32_t dst, uint32_t bar, int rank,
                                         float v) {
  uint32_t rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rdst)
               : "r"(dst), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(rdst),
      "r"(__float_as_uint(v)), "r"(rbar)
      : "memory");
}
// x = hi + lo for 3xTF32 with two operations: hi is x's own bits, which
// the tensor core reads as x truncated to TF32, and lo = x - that
// truncation, exact; the tensor core drops lo's own low bits (< 2^-20 |x|,
// against ~2^-21 for a hi rounded to nearest, sigmoid_newton.cu's
// split_fast, which takes a third operation on every split: the splits
// are the kernel's most frequent instructions).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// Warps 1-11 alone (named barrier 1).
__device__ __forceinline__ void work_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCWork) : "memory");
}

// The kernel's schedule, per band i of this cluster (its X in buffer
// i % 3, its exchanges in slot i % 2): warps 1-11 load band i + 2 once band
// i - 1's X^T U_new frees its buffer, and compute band i + 1's X V and push
// its rows to their owners while warp 0 runs band i's epilogue and pushes
// U_new's row to every CTA. No CTA waits on the whole cluster: each waits
// on its own barriers for the 16 pushes it needs.
template <int NT, typename Epi>
__global__ void __launch_bounds__(kCThreads, 1)
    u_pass_cluster_kernel(const float* __restrict__ X, int n, int m, int k,
                          const float* __restrict__ V, int W,
                          Epi epi, float* __restrict__ Unew,
                          float* __restrict__ numv_out,
                          float* __restrict__ gram_part) {
  namespace cg = cooperative_groups;
  constexpr int NP = NT * 8;
  constexpr uint32_t kSlotBytes = kCCtas * NP * 4;  // 16 pushed rows
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float csm[];
  const CSmem L(W, NP, Epi::kMats);
  const int ld = L.ld;
  float* Vs = csm;
  float* mats = csm + L.mats;
  float* Pw = csm + L.pw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int cl = (int)blockIdx.x / kCCtas, ncl = (int)gridDim.x / kCCtas;
  const int c0 = rank * W;                   // this CTA's first column
  const int wv = max(0, min(W, m - c0));     // its columns below m
  const int n_bands = (n + kCRows - 1) / kCRows;
  const int nb = n_bands > cl ? (n_bands - cl + ncl - 1) / ncl : 0;
  const int xch = W / 4 + 1;  // 16-byte chunks per tile row (<= kCWork)
  auto xbuf = [&](int i) { return csm + L.x + (i % kCBufs) * kCRows * ld; };
  auto pin = [&](int i) { return csm + L.pin + (i & 1) * kCCtas * NP; };
  auto uin = [&](int i) { return csm + L.uin + (i & 1) * kCRows * NP; };
  const uint32_t bars = smem_addr(csm + L.bars);
  auto p_full = [&](int i) { return bars + 8u * (i & 1); };
  auto u_full = [&](int i) { return bars + 16u + 8u * (i & 1); };
  auto parity = [](int i) { return (uint32_t)((i >> 1) & 1); };
  auto band_row = [&](int i) { return (cl + i * ncl) * kCRows; };

  if (tid == 0) {
    for (int s = 0; s < 4; ++s) mbar_init(bars + 8u * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < 4; ++s) mbar_arm(bars + 8u * s, kSlotBytes);
  }
  // V^T's slice, once, by 4-byte copies from V's rows c0 ... (V (m, k) is
  // row-major: the slice is contiguous): Vs[c][e] = V[c0 + e][c], zero
  // for c >= k or c0 + e >= m
  for (int idx = tid; idx < W * NP; idx += kCThreads) {
    const int e = idx / NP, c = idx % NP;
    const bool ok = c < k && c0 + e < m;
    cp_async4z(Vs + c * ld + e, ok ? V + (size_t)(c0 + e) * k + c : V,
               ok ? 4 : 0);
  }
  // band i's X slice, chunk q of every row by thread 32 + q of warps 1-11:
  // chunks holding no column of the slice below m, and rows past n, are
  // zero-filled without a read
  auto load_band = [&](int i) {
    const int q = tid - 32;
    if (q < 0 || q >= xch) return;
    float* Xs = xbuf(i);
    const int row0 = band_row(i);
#pragma unroll 4
    for (int r = 0; r < kCRows; ++r) {
      const int row = row0 + r;
      const float* src = X;
      int bytes = 0;
      if (row < n && wv > 0) {
        const char* rp =
            reinterpret_cast<const char*>(X + (size_t)row * m + c0);
        const char* chunk = reinterpret_cast<const char*>(
                                reinterpret_cast<uintptr_t>(rp) &
                                ~uintptr_t(15)) +
                            16 * q;
        if (chunk < rp + 4 * (size_t)wv) {
          src = reinterpret_cast<const float*>(chunk);
          bytes = 16;
        }
      }
      cp_async16(Xs + r * ld + 4 * q, src, bytes);
    }
  };
  // the elements past m in the chunk straddling each row's end (the next
  // row's values, or bytes past X), zeroed by warps 1-11 of the CTA whose
  // slice holds column m - 1 (tail: uniform in the CTA)
  const bool tail = wv > 0 && wv < W;
  auto zero_tail = [&](float* Xs) {
    const int q = tid - 32;
    if (q >= 0 && q < kCRows * 3) {
      const int r = q / 3, j = q % 3, e = row_offset(X, r, m) + wv;
      if (j < (4 - e % 4) % 4) Xs[r * ld + e + j] = 0.f;
    }
  };
  // Row offsets repeat every 16 rows (16 m floats are 64 m bytes): those
  // of the band rows this lane reads.
  const int olo = row_offset(X, g, m), ohi = row_offset(X, g + 8, m);
  int ox[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) ox[s][h] = row_offset(X, 8 * s + 2 * t + h, m);

  // 1. X V of band i over the slice, by warps 1-11: warp w the k-steps
  // w - 1, w + 10, ... in two chains from zero (alternate k-steps), added;
  // V^T's fragments by ldmatrix. The warps' partials summed in a fixed
  // order (slot s: warp s + 1, plus warp s + 7 for s < 5; then the slots
  // in order), and row r pushed to rank r.
  auto xv = [&](int i) {
    const float* Xs = xbuf(i);
    float part[2][NT][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][j][e] = 0.f;
    const float* alo = Xs + g * ld + olo;
    const float* ahi = Xs + (g + 8) * ld + ohi;
    const int ksteps = (wv + 7) / 8;
    // this lane's row of the ldmatrix tiles: matrix lane / 8 of a pair of
    // n8 tiles is tile (lane / 16), columns 4 ((lane / 8) % 2) on
    const uint32_t vrow = smem_addr(
        Vs + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 4);
    auto kstep = [&](int ks, float(&acc)[NT][4]) {
      const int kk = ks * 8;
      uint32_t hi[4], lo[4];
      split_trunc(alo[kk + t], hi[0], lo[0]);
      split_trunc(ahi[kk + t], hi[1], lo[1]);
      split_trunc(alo[kk + t + 4], hi[2], lo[2]);
      split_trunc(ahi[kk + t + 4], hi[3], lo[3]);
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]),
              "=r"(b[j + 1][1])
            : "r"(vrow + 4u * (j * 8 * ld + kk)));
      }
      if constexpr (NT % 2 == 1) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b[NT - 1][0]), "=r"(b[NT - 1][1])
            : "r"(vrow + 4u * ((NT - 1) * 8 * ld + kk)));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_trunc(__uint_as_float(b[j][0]), bh0, bl0);
        split_trunc(__uint_as_float(b[j][1]), bh1, bl1);
        mma_3xtf32(acc[j], hi, lo, bh0, bl0, bh1, bl1);
      }
    };
    constexpr int kS = kCWarps - 1;
    for (int ks = warp - 1; ks < ksteps; ks += 2 * kS) {
      kstep(ks, part[0]);
      if (ks + kS < ksteps) kstep(ks + kS, part[1]);
    }
    promote(part[0], part[1]);
    auto put = [&](float* pw, bool add) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, c = j * 8 + 2 * t;
          if (add) {
            pw[r * NP + c] += part[0][j][2 * h];
            pw[r * NP + c + 1] += part[0][j][2 * h + 1];
          } else {
            pw[r * NP + c] = part[0][j][2 * h];
            pw[r * NP + c + 1] = part[0][j][2 * h + 1];
          }
        }
    };
    if (warp <= kCSlots) put(Pw + (warp - 1) * kCRows * NP, false);
    work_sync();
    if (warp > kCSlots) put(Pw + (warp - 1 - kCSlots) * kCRows * NP, true);
    work_sync();
    const uint32_t dst = smem_addr(pin(i) + rank * NP);
    for (int e = tid - 32; e < kCRows * NP; e += kCWork) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kCSlots; ++w) s += Pw[w * kCRows * NP + e];
      const int r = e / NP, c = e % NP;
      push_f32(dst + 4u * c, p_full(i), r, s);
    }
  };

  // 3. X^T U_new of band i over the slice into numV's registers, all warps,
  // once every CTA's U_new row of the band has arrived. k-step s takes band
  // rows 8s + 2t (k index t) and 8s + 2t + 1 (t + 4): the four rows of
  // one fragment load then fall on distinct banks at even m.
  float acc[kCMTiles][NT][4];
#pragma unroll
  for (int i = 0; i < kCMTiles; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  auto xtu = [&](int i) {
    mbar_wait(u_full(i), parity(i));
    const float* Xs = xbuf(i);
    const float* Ub = uin(i);
    uint32_t bh[2][NT][2], bl[2][NT][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_trunc(Ub[(8 * s + 2 * t + h) * NP + j * 8 + g], bh[s][j][h],
                     bl[s][j][h]);
#pragma unroll
    for (int mi = 0; mi < kCMTiles; ++mi) {
      const int cc = (warp + kCWarps * mi) * 16;
      if (cc >= wv) break;
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* r0 = Xs + (8 * s + 2 * t) * ld + ox[s][0] + cc + g;
        const float* r1 = Xs + (8 * s + 2 * t + 1) * ld + ox[s][1] + cc + g;
        uint32_t hi[4], lo[4];
        split_trunc(r0[0], hi[0], lo[0]);
        split_trunc(r0[8], hi[1], lo[1]);
        split_trunc(r1[0], hi[2], lo[2]);
        split_trunc(r1[8], hi[3], lo[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_3xtf32(part[j], hi, lo, bh[s][j][0], bl[s][j][0], bh[s][j][1],
                     bl[s][j][1]);
      }
      promote(acc[mi], part);
    }
  };

  if (nb > 0) load_band(0);
  cp_async_commit();  // V^T and band 0
  if (nb > 1) load_band(1);
  cp_async_commit();
  epi.template stage<NP>(mats);
  if (tid == 0 && nb > 0 && band_row(0) + rank < n)
    epi.prefetch(band_row(0) + rank);
  cp_async_wait<1>();
  cluster_sync_all();  // V^T, band 0, mats; every CTA's barriers are armed
  if (nb > 0 && warp > 0) {
    if (tail) {
      zero_tail(xbuf(0));
      work_sync();
    }
    xv(0);
  }
  for (int i = 0; i < nb; ++i) {
    if (i > 0) xtu(i - 1);
    __syncthreads();  // band i - 1's buffer and U_new rows are consumed
    if (i > 0 && tid == 0) mbar_arm(u_full(i - 1), kSlotBytes);  // band i + 1
    if (tid == 0 && i + 1 < nb && band_row(i + 1) + rank < n)
      epi.prefetch(band_row(i + 1) + rank);  // into L2
    if (warp == 0) {
      // 2. this CTA's row of band i: X V summed over the ranks in order,
      // then the caller's epilogue; U_new's row pushed to every CTA
      mbar_wait(p_full(i), parity(i));
      const int row = band_row(i) + rank;
      float un = 0.f;
      if (row < n) {  // warp-uniform
        float xvr = 0.f;
        if (lane < k) {
          const float* P = pin(i);
#pragma unroll
          for (int q = 0; q < kCCtas; ++q) xvr += P[q * NP + lane];
        }
        un = epi.template row<NP>(row, xvr, mats);
        if (lane >= k) un = 0.f;
        if (lane < k) Unew[(size_t)row * k + lane] = un;
      }
      if (lane < NP) {
        const uint32_t dst = smem_addr(uin(i) + rank * NP + lane);
#pragma unroll 4
        for (int d = 0; d < kCCtas; ++d) push_f32(dst, u_full(i), d, un);
      }
      __syncwarp();
      if (lane == 0) mbar_arm(p_full(i), kSlotBytes);  // band i + 2
    } else {
      if (i + 1 < nb) {
        cp_async_wait<0>();  // band i + 1 has landed
        work_sync();
        if (tail) {
          zero_tail(xbuf(i + 1));
          work_sync();
        }
        xv(i + 1);
      }
      // band i + 2 into the buffer band i - 1 freed, issued once this
      // band's X V is done (its copies then wait on no mma of this band)
      if (i + 2 < nb) load_band(i + 2);
      cp_async_commit();
    }
  }
  if (nb > 0) xtu(nb - 1);
  cp_async_wait<0>();
  cluster_sync_all();  // no CTA leaves while another may address it

  // numV's partial of this cluster over the slice's columns below m
  float* dst = numv_out + (size_t)cl * m * k;
#pragma unroll
  for (int mi = 0; mi < kCMTiles; ++mi) {
    const int cc = (warp + kCWarps * mi) * 16;
    if (cc >= wv) break;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cc + g + 8 * h, c = j * 8 + 2 * t + e;
          if (col < wv && c < k)
            dst[(size_t)(c0 + col) * k + c] = acc[mi][j][2 * h + e];
        }
  }
  // the Gram partial of the rows this CTA owned, in band order, from U_new
  // as written
  if (warp == 0) {
    float gacc[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) gacc[j] = 0.f;
    for (int i = 0; i < nb; ++i) {
      const int row = band_row(i) + rank;
      if (row >= n) break;  // warp-uniform; later bands' rows are past n too
      const float u = lane < k ? Unew[(size_t)row * k + lane] : 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) gacc[j] += u * __shfl_sync(kFull, u, j);
    }
    float* gp = gram_part + (size_t)blockIdx.x * k * k;
    if (lane < k) {
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (j < k) gp[lane * k + j] = gacc[j];
    }
  }
}

// The cluster route's plan: `clusters` clusters of kCCtas CTAs, slices of
// `slice_cols` columns (mu_fused.py: u_pass_plan checks the same).
template <typename Epi>
bool cluster_plan_ok(int n, int m, int k, const UPassWork& w) {
  const int smem =
      4 * CSmem(w.slice_cols, 8 * ((k + 7) / 8), Epi::kMats).floats;
  return n >= 1 && m >= 1 && k >= 1 && k <= 32 && w.clusters >= 1 &&
         w.clusters <= 4096 && w.slice_cols >= 16 &&
         w.slice_cols % 16 == 0 && w.slice_cols <= kCMaxCols &&
         (long long)w.slice_cols * kCCtas >= m && smem <= kCSmemMax;
}

// Allows the cluster size and the widest slice's shared memory, once per
// kernel (a static of a template on Epi: see launch_cols_reduce).
template <int NT, typename Epi>
int prepare_cluster_kernel() {
  static bool ready = false;
  if (!ready) {
    auto kern = u_pass_cluster_kernel<NT, Epi>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmemMax);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  return 0;
}

// The launch configuration of the cluster kernel at NT for slices of w
// columns (attr: its cluster dimension, kept by the caller).
template <int NT, typename Epi>
cudaLaunchConfig_t cluster_config(int clusters, int w, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCCtas);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = 4 * CSmem(w, NT * 8, Epi::kMats).floats;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT, typename Epi>
int launch_u_pass_cluster_nt(const float* X, const float* V, int n, int m,
                             int k, const Epi& epi, float* Unew, float* numV,
                             float* gramU, const UPassWork& w,
                             cudaStream_t st) {
  if (int e = prepare_cluster_kernel<NT, Epi>()) return e;
  float* out = w.clusters == 1 ? numV : w.numv_part;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<NT, Epi>(w.clusters, w.slice_cols, st, &attr);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, u_pass_cluster_kernel<NT, Epi>, X, n, m, k, V, w.slice_cols, epi,
      Unew, out, w.gram_part);
  if (e != cudaSuccess) return (int)e;
  const long long mk = (long long)m * k;
  const int num_blocks = w.clusters > 1 ? (int)((mk + 255) / 256) : 0;
  u_pass_reduce_kernel<<<num_blocks + ceil_div(k * k, 8), 256, 0, st>>>(
      w.numv_part, w.clusters, mk, num_blocks, numV, w.gram_part,
      w.clusters * kCCtas, k * k, gramU);
  return (int)cudaGetLastError();
}

// Clusters of the route at k, with slices of `slice_cols` columns, that the
// current device holds at once (cudaOccupancyMaxActiveClusters).
template <int NT, typename Epi>
int cluster_occupancy_nt(int slice_cols, int* out) {
  if (int e = prepare_cluster_kernel<NT, Epi>()) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<NT, Epi>(1, slice_cols, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, u_pass_cluster_kernel<NT, Epi>, &cfg);
}

template <typename Epi>
int cluster_occupancy(int k, int slice_cols, int* out) {
  switch ((k + 7) / 8) {
    case 1: return cluster_occupancy_nt<1, Epi>(slice_cols, out);
    case 2: return cluster_occupancy_nt<2, Epi>(slice_cols, out);
    case 3: return cluster_occupancy_nt<3, Epi>(slice_cols, out);
    default: return cluster_occupancy_nt<4, Epi>(slice_cols, out);
  }
}

// The whole call on the cluster route (f32 X, k <= 32).
template <typename Epi>
int launch_u_pass_cluster(const void* X, const float* V, int n, int m, int k,
                          const Epi& epi, float* Unew, float* numV,
                          float* gramU, const UPassWork& w, cudaStream_t st) {
  const float* x = static_cast<const float*>(X);
  switch ((k + 7) / 8) {
    case 1:
      return launch_u_pass_cluster_nt<1>(x, V, n, m, k, epi, Unew, numV,
                                         gramU, w, st);
    case 2:
      return launch_u_pass_cluster_nt<2>(x, V, n, m, k, epi, Unew, numV,
                                         gramU, w, st);
    case 3:
      return launch_u_pass_cluster_nt<3>(x, V, n, m, k, epi, Unew, numV,
                                         gramU, w, st);
    default:
      return launch_u_pass_cluster_nt<4>(x, V, n, m, k, epi, Unew, numV,
                                         gramU, w, st);
  }
}

// The call on the plan's route: the cluster route where the plan gives
// clusters (f32 X only), else the two-sweep routes of u_pass_common.cuh.
template <typename Epi>
int launch_u_pass_route(int x_dtype, const void* X, const float* V, int n,
                        int m, int k, const Epi& epi, float* Unew,
                        float* numV, float* gramU, const UPassWork& w,
                        cudaStream_t st) {
  if (w.clusters == 0) {
    if (!plan_ok(n, m, k, w)) return (int)cudaErrorInvalidValue;
    return launch_u_pass_dtype(x_dtype, X, V, n, m, k, epi, Unew, numV,
                               gramU, w, st);
  }
  if (x_dtype != kXF32 || !cluster_plan_ok<Epi>(n, m, k, w))
    return (int)cudaErrorInvalidValue;
  return launch_u_pass_cluster(X, V, n, m, k, epi, Unew, numV, gramU, w, st);
}

}  // namespace pycmf
