// Sigmoid-link Newton passes for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/sigmoid_newton.py:sigmoid_gh_pass (TPU
// kernel K3) and pycmf_tpu/ops/pallas/sigmoid_newton.py:sigmoid_phi_pass
// (TPU kernel K4).
//
// With X (n, q) stored as f32, bf16 or e4m3 (widened to f32 in the kernel,
// exactly: an e4m3 call equals the bf16 call on X widened to bf16 bit for
// bit), M (n, k), B (q, k), P = sigmoid(M B^T), f' = P (1 - P):
//   K3  G[i]    = sum_j (P_ij - X_ij) f'_ij B_j + l1 sign(M_i) + l2 M_i
//       H[i]    = sum_j f'_ij^2 B_j B_j^T           (Gauss-Newton, (n, k, k))
//   K4  phi[i,0] = phi_i(M_i), phi[i,t] = phi_i(proj(M_i - 2^-(t-1) d_i)),
//       phi_i(c) = l1 |c|_1 + l2/2 |c|^2 + 1/2 sum_j (X_ij - sigmoid(c.B_j))^2
// The (n, q) predictions never reach device memory. Any k >= 1.
//
// Bound: operations. Per element of X, K3 does k products for the logit,
// k for G and k(k+1)/2 for H's packed triangle (250 at k = 20), K4 does
// (trials + 1) k products and trials + 1 sigmoids (180 and 9 at k = 20,
// trials = 8). At the dense sigmoid-X shape (30000 x 11314) K3's products
// take ~0.6 ms on the tensor cores' peaks (logits and G in 3xTF32 at 495
// TFLOP/s, H in split bf16 at 989), K4's ~0.74 ms (3xTF32); K4's 3.05 G
// sigmoids take two MUFU operations each (ex2, rcp), ~1.5 ms at 16 per SM
// per clock; X's 0.68 GB of bf16 take 0.2 ms (0.34 GB of e4m3, 0.1 ms).
// mma.sync reaches a fraction of those peaks (they are wgmma's).
//
// Design:
// - Logits and G on mma.sync m16n8k8 TF32 tiles in 3xTF32 (common.cuh:
//   mma_3xtf32), the reference's HIGHEST. H, the bulk of the products, in
//   split bf16 on m16n8k16 tiles (mma_3xbf16: each operand split into two
//   bf16 parts, three products, ~2^-16 relative per product): half the
//   mma.sync instructions of 3xTF32 per product, and the reference itself
//   builds H at DEFAULT precision. (A single TF32 or bf16 pass carries
//   2^-11 to 2^-8 relative error per product: at small q that is above the
//   1e-4 bar H's checks hold it to.) Each chunk's mma chain starts from
//   zero and is added to the f32 running sums (promote, as in
//   u_pass_common.cuh).
// - The splits are integer operations (split_fast, split_bf16x2), each
//   operand split once where it is made: cvt.rna runs on the conversion
//   pipe, a quarter of the FMA rate, and a first version that split every
//   operand at each use was bound by it.
// - One prologue launch pads B, M (and K4's d) to KG = k rounded up to 8
//   columns and whole 32-row (64-row) tiles, so the CTAs copy them without
//   masks (K3's M in TF32 parts), and builds K3's pair table (below).
// - K3 is a GEMM with an epilogue in front: [H | G] (rows x T's width) =
//   [W | RF] (rows x q) times T, T_j = [BB_j, the packed upper triangle of
//   B_j B_j^T, padded to 8 | B_j (KG columns)], with W = f'^2 for T's pair
//   columns and RF = (P - X) f' for its B columns. G's columns come last,
//   where the last column tile has room; zero columns are skipped. A
//   256-thread CTA owns 64 rows, 128 columns of T and a segment of q,
//   walked in 32-column chunks. X comes through a 3-stage cp.async ring,
//   two chunks ahead of its use (one chunk ahead left the sweep waiting on
//   DRAM), its rows copied as the 16-byte chunks covering them and read at
//   their offsets, as in u_pass_common.cuh (bf16 rows of odd q are 2-byte
//   aligned, e4m3 rows of odd q start on any byte); B's rows and the pair
//   tile come one chunk ahead. Per chunk: the logits (64 x 32) = M B^T on
//   mma, P, f', W and RF in registers, then W (bf16 parts) and RF (f32) to
//   shared memory as the next mma's A operand; then W times the chunk's
//   tile of T's pair columns, and RF times the chunk's B for the CTA's G
//   columns, into registers. The pair
//   columns are built once per call (gh_table_entry: bf16 parts, column by
//   column within each chunk, so that each fragment register is one 32-bit
//   load; 11.6 MB at q = 11314, k = 20, read from L2): built in each CTA
//   instead, for every 64 rows, they took about a third of the call at the
//   sigmoid-X shape. Column tiles across the grid are what let any k run.
// - K4: a 256-thread CTA owns 64 rows and a q segment; each warp holds 16
//   rows and 16 columns of a chunk, reads its X values from shared memory
//   once, and walks the slots: the candidate rows are built in the A
//   fragments (slot 0 = M, slot t = proj(M - 2^-(t-1) d), candidates()'s
//   f32 formula), their logits on mma, the squared residuals summed per
//   (row, slot) in registers, then across the quad's lanes by shuffles and
//   into a per-(row, slot) shared-memory sum. For k <= 32 the warp's M and
//   d fragments stay in registers for the call, and the chunk's B
//   fragments, split, for all its slots.
// - M, d and the chunk's B rows sit in shared memory when they fit (KG up
//   to ~240); past that the fragments are read from the padded copies in
//   device memory (the same generic loads).
// - Both kernels split q into segments so that path A's 20 rows fill the
//   card, write one partial per (segment, row), and a second kernel sums
//   the segments in order and adds the elastic-net terms once, after the
//   sum (the reference's axis_name arithmetic). No float atomics: a call
//   repeats bit for bit.
// - The plan (q segments, the table's width, whether the operands fit in
//   shared memory) is computed by the Python wrapper
//   (ops/kernels/sigmoid_newton.py) and checked here.
#include "common.cuh"

namespace pycmf {

constexpr int kSRows = 64;       // rows per CTA
constexpr int kSQ = 32;          // q columns per chunk
constexpr int kSCols = 128;      // columns of T per K3 CTA
constexpr int kSThreads = 256;   // 8 warps
constexpr int kSStages = 2;       // K4's ring; K3's B and pair tiles
constexpr int kXStages = 3;       // K3's X ring: X two chunks ahead
constexpr int kWLd = kSQ + 4;     // RF tile row stride (words): 4 g + t
constexpr int kP2 = kSQ / 2 + 4;  // W and T bf16-pair rows (words): 20 g + t
constexpr int kSmemMax = 232448;

// sigma(t) with the SFU's exp and reciprocal (~1e-7 relative).
__device__ __forceinline__ float sigmoid_fast(float t) {
  return __fdividef(1.f, 1.f + __expf(-t));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest on the 13 dropped bits,
// by integer operations), lo = x - hi exactly; the tensor core drops lo's
// own low bits (~2^-21 |x|), as with split_tf32's second cvt.rna.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// Two values as bf16 pairs, x0 in the low halves: hi = the values rounded
// to bf16 (to nearest even), lo = the remainders rounded to bf16; x = hi +
// lo + O(2^-16 |x|).
__device__ __forceinline__ uint32_t bf16_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const uint32_t h0 = bf16_rne(x0), h1 = bf16_rne(x1);
  hi = h0 | (h1 << 16);
  lo = bf16_rne(x0 - __uint_as_float(h0 << 16)) |
       (bf16_rne(x1 - __uint_as_float(h1 << 16)) << 16);
}

// Split bf16: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), in that order.
__device__ __forceinline__ void mma_3xbf16(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
  mma_bf16(d, alo, bh0, bh1);
  mma_bf16(d, ahi, bl0, bl1);
  mma_bf16(d, ahi, bh0, bh1);
}

__host__ __device__ inline int pad8(int k) { return (k + 7) / 8 * 8; }
__host__ __device__ inline int ops_ld(int kg) { return kg + 4; }

// Shared-memory layout of one CTA, in bytes (all offsets multiples of 16):
// per stage the X tile (kSRows x (kSQ + 16 / xb) elements) and, when the
// operands sit in shared memory, the chunk's B rows (kSQ x ops_ld f32);
// then K3's M in TF32 parts or K4's M and d (kSRows x ops_ld words each,
// same condition); then K3's W tile (bf16 pairs, hi and lo, kSRows x kP2
// words each) and RF tile (f32, kSRows x kWLd), or K4's per-(row, slot)
// sums. K3's X ring comes first, and its stages hold the pair tile (bf16
// pairs, hi and lo, kSCols x kP2 words each) and B's rows.
struct SLayout {
  int x_ld, x_bytes, t_bytes, bk_bytes, stage, x_ring, ops, tail, total;
  __host__ __device__ SLayout(int xb, int kg, bool gh, bool ops_smem,
                              int slots) {
    x_ld = kSQ + 16 / xb;
    x_bytes = kSRows * x_ld * xb;
    t_bytes = gh ? 2 * kSCols * kP2 * 4 : 0;
    bk_bytes = ops_smem ? kSQ * ops_ld(kg) * 4 : 0;
    // K3: X ring of its own, then stages of (pair tile, B rows); K4:
    // stages of (X tile, B rows)
    stage = (gh ? 0 : x_bytes) + t_bytes + bk_bytes;
    x_ring = gh ? kXStages * x_bytes : 0;
    ops = ops_smem ? 2 * kSRows * ops_ld(kg) * 4 : 0;  // M hi, lo; M, d
    tail = gh ? (2 * kSRows * kP2 + kSRows * kWLd) * 4
              : 2 * slots * kSRows * 4;
    total = x_ring + kSStages * stage + ops + tail;
  }
};

// Copy slots of one thread for the X tile: chunk c of the tile (row r =
// c / n_ch, 16-byte chunk q = c % n_ch of the row), fixed for the sweep.
// Chunks start on the aligned 16 bytes below X[row, c_begin]; a chunk at or
// past the row's end is zero-filled, as are rows past n. The chunk of
// stage i is i * kSQ columns on (kSQ columns span a multiple of 16 bytes).
template <typename XT, int kSlots>
struct XCopy {
  const char* src[kSlots];
  long long left[kSlots];
  int dst[kSlots];

  __device__ void init(const XT* X, int n, int q, int row0, int c_begin,
                       int x_ld) {
    constexpr int kEl = 16 / (int)sizeof(XT);
    const int n_ch = x_ld / kEl;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = threadIdx.x + s * kSThreads, r = c / n_ch, qc = c % n_ch;
      dst[s] = r < kSRows ? r * x_ld + qc * kEl : -1;
      src[s] = reinterpret_cast<const char*>(X);
      left[s] = 0;
      if (r < kSRows && row0 + r < n) {
        const char* rp = reinterpret_cast<const char*>(X + (size_t)(row0 + r) * q);
        const char* at = reinterpret_cast<const char*>(X + (size_t)(row0 + r) * q + c_begin);
        src[s] = reinterpret_cast<const char*>(
                     reinterpret_cast<uintptr_t>(at) & ~uintptr_t(15)) + 16 * qc;
        left[s] = (long long)(rp + (size_t)q * sizeof(XT) - src[s]);
      }
    }
  }

  __device__ void load(XT* Xs, int i) const {
    constexpr long long kStep = kSQ * (long long)sizeof(XT);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (dst[s] < 0) continue;
      const bool ok = left[s] > i * kStep;
      cp_async16(Xs + dst[s], ok ? src[s] + i * kStep : src[s], ok ? 16 : 0);
    }
  }
};

template <typename XT>
__host__ __device__ constexpr int x_slots() {
  return (kSRows * ((kSQ + 16 / (int)sizeof(XT)) / (16 / (int)sizeof(XT))) +
          kSThreads - 1) / kSThreads;
}

// Element offset of X[row, c_begin] within its 16-byte chunk (0 past n).
template <typename XT>
__device__ __forceinline__ int x_offset(const XT* X, int n, int q, int row,
                                        int c_begin) {
  if (row >= n) return 0;
  return (int)((reinterpret_cast<uintptr_t>(X + (size_t)row * q + c_begin) &
                15) / sizeof(XT));
}

// Copy rows (columns 0 .. cols - 1, cols a multiple of 4) of a row-major
// f32 matrix with row stride ld into shared memory with row stride lds.
__device__ __forceinline__ void copy_rows(float* dst, int lds,
                                          const float* src, size_t ld,
                                          int rows, int cols) {
  const int per = cols / 4;
  for (int c = threadIdx.x; c < rows * per; c += kSThreads) {
    const int r = c / per, e = (c % per) * 4;
    cp_async16(dst + r * lds + e, src + r * ld + e);
  }
}

// A fragment (m16 x k8 at column kk) of a row-major f32 operand with row
// stride ld, split.
__device__ __forceinline__ void a_frag(const float* A, int ld, int kk, int g,
                                       int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_fast(A[g * ld + kk + t], hi[0], lo[0]);
  split_fast(A[(g + 8) * ld + kk + t], hi[1], lo[1]);
  split_fast(A[g * ld + kk + t + 4], hi[2], lo[2]);
  split_fast(A[(g + 8) * ld + kk + t + 4], hi[3], lo[3]);
}

// The same fragment of an operand stored split (hi and lo arrays).
__device__ __forceinline__ void a_frag_split(const uint32_t* H,
                                             const uint32_t* L, int ld,
                                             int kk, int g, int t,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int o[4] = {g * ld + kk + t, (g + 8) * ld + kk + t,
                    g * ld + kk + t + 4, (g + 8) * ld + kk + t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = H[o[i]];
    lo[i] = L[o[i]];
  }
}

// ---------------------------------------------------------------- K3 ----

// Column of G's first component in T: the pairs rounded up to 8.
__host__ __device__ inline int g_offset(int k) { return pad8(k * (k + 1) / 2); }

// part[seg, row, c] for c in this CTA's 128 columns of T: the segment's
// sum of W (pair columns) or RF (G's columns) times T[:, c]. Bp (q rounded
// up to 32 rows x kg): B zero-padded; Mh, Ml (n rounded up to 64 rows x
// kg): M zero-padded, in TF32 parts; Tg: T's pair columns
// (gh_table_kernel).
template <typename XT>
__global__ void __launch_bounds__(kSThreads, 2)
    gh_part_kernel(const XT* __restrict__ X, const uint32_t* __restrict__ Mh,
                   const uint32_t* __restrict__ Ml,
                   const float* __restrict__ Bp,
                   const uint32_t* __restrict__ Tg, int n, int q, int k,
                   int ldp, int seg_len, int ops_smem,
                   float* __restrict__ part) {
  const int kg = pad8(k), gofs = g_offset(k);
  const SLayout lay(sizeof(XT), kg, true, ops_smem, 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kSRows;
  const int col0 = blockIdx.y * kSCols;
  const int c_begin = blockIdx.z * seg_len;
  const int c_end = min(q, c_begin + seg_len);
  const int n_chunks = (c_end - c_begin + kSQ - 1) / kSQ;
  const int ldo = ops_ld(kg);
  unsigned char* stages = smem + lay.x_ring;
  uint32_t* Msh = reinterpret_cast<uint32_t*>(stages + kSStages * lay.stage);
  uint32_t* Msl = Msh + kSRows * ldo;
  uint32_t* Wh = reinterpret_cast<uint32_t*>(stages + kSStages * lay.stage +
                                             lay.ops);  // [row][q pair]
  uint32_t* Wl = Wh + kSRows * kP2;
  float* RFs = reinterpret_cast<float*>(Wl + kSRows * kP2);  // [row][q]
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem + (i % kXStages) * lay.x_bytes);
  };
  // pair tile [column][q pair]: hi words, then lo words
  auto stage_t = [&](int i) {
    return reinterpret_cast<uint32_t*>(stages + (i % kSStages) * lay.stage);
  };
  auto stage_bk = [&](int i) {
    return reinterpret_cast<float*>(stages + (i % kSStages) * lay.stage +
                                    lay.t_bytes);
  };

  XCopy<XT, x_slots<XT>()> xc;
  xc.init(X, n, q, row0, c_begin, lay.x_ld);
  auto load_x = [&](int i) {
    if (i < n_chunks) xc.load(stage_x(i), i);
    cp_async_commit();
  };
  // the chunk's 128 pair columns: 32 words each (16 hi, 16 lo)
  auto load_tb = [&](int i) {
    if (i < n_chunks) {
      const int ci = c_begin / kSQ + i;
      const uint32_t* src = Tg + ((size_t)ci * ldp + col0) * kSQ;
      uint32_t* th = stage_t(i);
      for (int c = tid; c < kSCols * 8; c += kSThreads) {
        const int col = c >> 3, part4 = c & 7;
        cp_async16(th + (part4 >> 2) * kSCols * kP2 + col * kP2 +
                       (part4 & 3) * 4,
                   src + col * kSQ + part4 * 4);
      }
      if (ops_smem)
        copy_rows(stage_bk(i), ldo, Bp + (size_t)(c_begin + i * kSQ) * kg,
                  kg, kSQ, kg);
    }
    cp_async_commit();
  };
  if (ops_smem) {
    copy_rows(reinterpret_cast<float*>(Msh), ldo,
              reinterpret_cast<const float*>(Mh) + (size_t)row0 * kg, kg,
              kSRows, kg);
    copy_rows(reinterpret_cast<float*>(Msl), ldo,
              reinterpret_cast<const float*>(Ml) + (size_t)row0 * kg, kg,
              kSRows, kg);
  }
  load_tb(0);  // with M
  load_x(0);
  load_x(1);

  // logit phase: warp = (16-row tile lm, n8 tiles ln, ln + 1 of the chunk)
  const int lm = warp >> 1, ln = (warp & 1) * 2;
  const size_t moff = (size_t)(row0 + lm * 16) * kg;
  const uint32_t* Mah = ops_smem ? Msh + lm * 16 * ldo : Mh + moff;
  const uint32_t* Mal = ops_smem ? Msl + lm * 16 * ldo : Ml + moff;
  const int lda = ops_smem ? ldo : kg;
  const int rlo = lm * 16 + g, rhi = rlo + 8;
  const int xo[2] = {x_offset(X, n, q, row0 + rlo, c_begin),
                     x_offset(X, n, q, row0 + rhi, c_begin)};
  // product phase: warp = (16-row tile lm, 64 columns hc of the tile)
  const int hc = (warp & 1) * 64;
  // the CTA holds some of G's columns [gofs, gofs + kg), and so does this
  // warp
  const bool cta_g = col0 < gofs + kg && col0 + kSCols > gofs;
  const bool has_g = col0 + hc < gofs + kg && col0 + hc + 64 > gofs;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    // groups in flight: ..., (pair tile, B) of i, X of i + 1; all but the
    // newest complete: chunk i landed
    cp_async_wait<1>();
    __syncthreads();  // ... and every warp is done with chunk i - 1
    load_tb(i + 1);
    load_x(i + 2);
    const int j0 = c_begin + i * kSQ;
    const XT* Xs = stage_x(i);
    const float* Bk = ops_smem ? stage_bk(i) : Bp + (size_t)j0 * kg;
    const int ldb = ops_smem ? ldo : kg;
    // two chains per tile (even and odd k-steps) for the tensor cores'
    // latency, added in f32 after
    float c[2][4] = {}, c2[2][4] = {};
    auto logit_step = [&](int kk, float (&cc)[2][4]) {
      uint32_t hi[4], lo[4];
      a_frag_split(Mah, Mal, lda, kk, g, t, hi, lo);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const float* b = Bk + ((ln + jn) * 8 + g) * ldb + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_fast(b[0], bh0, bl0);
        split_fast(b[4], bh1, bl1);
        mma_3xtf32(cc[jn], hi, lo, bh0, bl0, bh1, bl1);
      }
    };
    for (int kk = 0; kk < kg; kk += 16) {
      logit_step(kk, c);
      if (kk + 8 < kg) logit_step(kk + 8, c2);
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[jn][e] += c2[jn][e];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rhi : rlo, jc = (ln + jn) * 8 + 2 * t;
        float w[2], rf[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row0 + r < n && j0 + jc + e < c_end;
          const float p = sigmoid_fast(c[jn][2 * h + e]);
          const float fp = p * (1.f - p);
          const float x = to_float(Xs[r * lay.x_ld + xo[h] + jc + e]);
          w[e] = ok ? fp * fp : 0.f;
          rf[e] = ok ? (p - x) * fp : 0.f;
        }
        split_bf16x2(w[0], w[1], Wh[r * kP2 + jc / 2], Wl[r * kP2 + jc / 2]);
        if (cta_g) {
          RFs[r * kWLd + jc] = rf[0];
          RFs[r * kWLd + jc + 1] = rf[1];
        }
      }
    __syncthreads();  // W and RF of the chunk are in shared memory
    const uint32_t* Th = stage_t(i);
    const uint32_t* Tl = Th + kSCols * kP2;
    // each tile's chain of the chunk starts from zero and is added to acc
    // H: W times the pair tile, m16n8k16 in split bf16 (word kw = q pair)
    uint32_t whi[2][4], wlo[2][4];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
      a_frag_split(Wh + lm * 16 * kP2, Wl + lm * 16 * kP2, kP2, 8 * s2, g, t,
                   whi[s2], wlo[s2]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (col0 + hc + 8 * j >= gofs) continue;  // G's or zero (uniform)
      float part_[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int o = (hc + 8 * j + g) * kP2 + 8 * s2 + t;
        mma_3xbf16(part_, whi[s2], wlo[s2], Th[o], Tl[o], Th[o + 4],
                   Tl[o + 4]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part_[e];
    }
    // G: RF times the chunk's B columns, 3xTF32
    if (has_g) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gc = col0 + hc + 8 * j - gofs;  // B's column
        if (gc < 0 || gc >= kg) continue;  // warp-uniform
        float part_[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kSQ; kk += 8) {
          uint32_t rhi_[4], rlo_[4], bh0, bl0, bh1, bl1;
          a_frag(RFs + lm * 16 * kWLd, kWLd, kk, g, t, rhi_, rlo_);
          split_fast(Bk[(kk + t) * ldb + gc + g], bh0, bl0);
          split_fast(Bk[(kk + t + 4) * ldb + gc + g], bh1, bl1);
          mma_3xtf32(part_, rhi_, rlo_, bh0, bl0, bh1, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part_[e];
      }
    }
  }
  cp_async_wait<0>();

  float* dst = part + (size_t)blockIdx.z * n * ldp;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + lm * 16 + g + 8 * h;
      const int col = col0 + hc + 8 * j + 2 * t;
      if (row < n)
        *reinterpret_cast<float2*>(dst + (size_t)row * ldp + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

// Tg (q rounded up to 32 / 32 chunks x ldp columns x 32 words): for chunk
// ci and column c of T below k(k+1)/2, pair (a, b) = the column's place in
// the packed upper triangle, word jp < 16 holds the bf16 high parts of
// B_ja B_jb for j = 32 ci + 2 jp and j + 1 (zero past q), word 16 + jp
// their low parts; columns past the pairs are zero (G's columns are read
// from B itself).
__device__ __forceinline__ void gh_table_entry(const float* __restrict__ B,
                                               int q, int k, int ldp,
                                               long long idx,
                                               uint32_t* __restrict__ Tg) {
  const int jp = (int)(idx % (kSQ / 2));
  const long long cc = idx / (kSQ / 2);
  const int c = (int)(cc % ldp), ci = (int)(cc / ldp);
  float v[2] = {0.f, 0.f};
  if (c < k * (k + 1) / 2) {
    int r = c, a = 0;
    while (r >= k - a) {  // row a of the triangle holds k - a pairs
      r -= k - a;
      ++a;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = ci * kSQ + 2 * jp + e;
      if (j < q) v[e] = B[(size_t)j * k + a] * B[(size_t)j * k + a + r];
    }
  }
  uint32_t hi, lo;
  split_bf16x2(v[0], v[1], hi, lo);
  uint32_t* dst = Tg + cc * kSQ;
  dst[jp] = hi;
  dst[kSQ / 2 + jp] = lo;
}

// Offset of pair (a, b), a <= b, in the packed upper triangle of a k x k
// matrix (row-major).
__host__ __device__ __forceinline__ int pair_index(int a, int b, int k) {
  return a * k - a * (a - 1) / 2 + (b - a);
}

// Entry idx of A (rows x k) zero-padded to kg columns.
__device__ __forceinline__ float padded(const float* __restrict__ A, int rows,
                                        int k, int kg, long long idx) {
  const int r = (int)(idx / kg), c = (int)(idx % kg);
  return r < rows && c < k ? A[(size_t)r * k + c] : 0.f;
}

// K3's prologue, one launch: Bp (q_pad x kg) = B padded; Mh, Ml (n_pad x
// kg) = M padded, in TF32 parts; Tg = T's pair columns.
__global__ void gh_prologue_kernel(const float* __restrict__ B,
                                   const float* __restrict__ M, int n, int q,
                                   int k, int kg, int ldp,
                                   float* __restrict__ Bp,
                                   uint32_t* __restrict__ Mh,
                                   uint32_t* __restrict__ Ml,
                                   uint32_t* __restrict__ Tg) {
  const long long nb = (long long)((q + kSQ - 1) / kSQ) * kSQ * kg;
  const long long nm = (long long)((n + kSRows - 1) / kSRows) * kSRows * kg;
  const long long nt = (long long)((q + kSQ - 1) / kSQ) * ldp * (kSQ / 2);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nb) {
    Bp[idx] = padded(B, q, k, kg, idx);
  } else if ((idx -= nb) < nm) {
    split_fast(padded(M, n, k, kg, idx), Mh[idx], Ml[idx]);
  } else if ((idx -= nm) < nt) {
    gh_table_entry(B, q, k, ldp, idx, Tg);
  }
}

// K4's prologue, one launch: Bp, Mp, Dp = B, M, d padded.
__global__ void phi_prologue_kernel(const float* __restrict__ B,
                                    const float* __restrict__ M,
                                    const float* __restrict__ d, int n, int q,
                                    int k, int kg, float* __restrict__ Bp,
                                    float* __restrict__ Mp,
                                    float* __restrict__ Dp) {
  const long long nb = (long long)((q + kSQ - 1) / kSQ) * kSQ * kg;
  const long long nm = (long long)((n + kSRows - 1) / kSRows) * kSRows * kg;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nb) {
    Bp[idx] = padded(B, q, k, kg, idx);
  } else if ((idx -= nb) < nm) {
    Mp[idx] = padded(M, n, k, kg, idx);
  } else if ((idx -= nm) < nm) {
    Dp[idx] = padded(d, n, k, kg, idx);
  }
}

// G = sum over segments (in order) + l1 sign(M) + l2 M; H unpacked to (k, k).
__global__ void gh_reduce_kernel(const float* __restrict__ part, int n_seg,
                                 int n, int k, int ldp,
                                 const float* __restrict__ M, float l1,
                                 float l2, float* __restrict__ G,
                                 float* __restrict__ H) {
  const int per = k + k * k;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * per) return;
  const int row = (int)(idx / per), e = (int)(idx % per);
  const float* p = part + (size_t)row * ldp;
  const size_t seg_stride = (size_t)n * ldp;
  float s = 0.f;
  if (e < k) {
    const int c = g_offset(k) + e;
    for (int sg = 0; sg < n_seg; ++sg) s += p[sg * seg_stride + c];
    const float m = M[(size_t)row * k + e];
    const float sgn = m > 0.f ? 1.f : (m < 0.f ? -1.f : 0.f);
    G[(size_t)row * k + e] = s + l1 * sgn + l2 * m;
  } else {
    const int ab = e - k, a = ab / k, b = ab % k;
    const int c = pair_index(min(a, b), max(a, b), k);
    for (int sg = 0; sg < n_seg; ++sg) s += p[sg * seg_stride + c];
    H[(size_t)row * k * k + ab] = s;
  }
}

// ---------------------------------------------------------------- K4 ----

// Candidate entry: slot 0 = M, slot s = proj(M - 2^-(s-1) d) (the product
// is exact: candidates()'s value).
__device__ __forceinline__ float candidate(float m, float d, int s,
                                           float step, int non_negative) {
  if (s == 0) return m;
  const float v = m - step * d;
  return non_negative ? fmaxf(v, 0.f) : v;
}

// part[seg, row, s] = sum over the segment's columns of
// (X_ij - sigmoid(c_s . B_j))^2 for row i's candidate c_s. KS = kg / 8 for
// kg <= 32 (fragments of M, d and each chunk's B held in registers), 0 for
// any kg (fragments read per use).
template <typename XT, int KS>
__global__ void __launch_bounds__(kSThreads, 2)
    phi_part_kernel(const XT* __restrict__ X, const float* __restrict__ Mp,
                    const float* __restrict__ Dp, const float* __restrict__ Bp,
                    int n, int q, int kg, int slots, int non_negative,
                    int seg_len, int ops_smem, float* __restrict__ part) {
  const SLayout lay(sizeof(XT), kg, false, ops_smem, slots);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kSRows;
  const int c_begin = blockIdx.y * seg_len;
  const int c_end = min(q, c_begin + seg_len);
  const int n_chunks = (c_end - c_begin + kSQ - 1) / kSQ;
  const int ldo = ops_ld(kg);
  float* Ms = reinterpret_cast<float*>(smem + kSStages * lay.stage);
  float* Ds = Ms + kSRows * ldo;
  float* Sq = reinterpret_cast<float*>(smem + kSStages * lay.stage + lay.ops);
  auto stage_x = [&](int i) {
    return reinterpret_cast<XT*>(smem + (i % kSStages) * lay.stage);
  };
  auto stage_bk = [&](int i) {
    return reinterpret_cast<float*>(smem + (i % kSStages) * lay.stage +
                                    lay.x_bytes);
  };
  for (int e = tid; e < 2 * slots * kSRows; e += kSThreads) Sq[e] = 0.f;

  XCopy<XT, x_slots<XT>()> xc;
  xc.init(X, n, q, row0, c_begin, lay.x_ld);
  auto load = [&](int i) {
    xc.load(stage_x(i), i);
    if (ops_smem)
      copy_rows(stage_bk(i), ldo, Bp + (size_t)(c_begin + i * kSQ) * kg, kg,
                kSQ, kg);
  };
  if (ops_smem) {
    copy_rows(Ms, ldo, Mp + (size_t)row0 * kg, kg, kSRows, kg);
    copy_rows(Ds, ldo, Dp + (size_t)row0 * kg, kg, kSRows, kg);
  }
  load(0);
  cp_async_commit();

  // warp = (16-row tile lm, the chunk's columns 16 hc .. 16 hc + 15)
  const int lm = warp >> 1, hc = warp & 1;
  const int lda = ops_smem ? ldo : kg;
  const float* Ma = ops_smem ? Ms + lm * 16 * ldo : Mp + (size_t)(row0 + lm * 16) * kg;
  const float* Da = ops_smem ? Ds + lm * 16 * ldo : Dp + (size_t)(row0 + lm * 16) * kg;
  const int rlo = lm * 16 + g, rhi = rlo + 8;
  const int xo[2] = {x_offset(X, n, q, row0 + rlo, c_begin),
                     x_offset(X, n, q, row0 + rhi, c_begin)};
  float* sq_mine = Sq + hc * slots * kSRows;
  // A fragment offsets of k-step kk: rows g, g + 8, columns kk + t, + 4
  auto a_off = [&](int f, int kk) {
    return (g + 8 * (f & 1)) * lda + kk + t + 4 * (f >> 1);
  };
  constexpr int KR = KS > 0 ? KS : 1;
  float mf[KR][4], df[KR][4];
  if constexpr (KS > 0) {
    cp_async_wait<0>();
    __syncthreads();  // M and d (and chunk 0) landed
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        mf[s][f] = Ma[a_off(f, 8 * s)];
        df[s][f] = Da[a_off(f, 8 * s)];
      }
  }

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_chunks) load(i + 1);
    cp_async_commit();
    const int j0 = c_begin + i * kSQ;
    const XT* Xs = stage_x(i);
    const float* Bk = ops_smem ? stage_bk(i) : Bp + (size_t)j0 * kg;
    const int ldb = ops_smem ? ldo : kg;
    // this lane's X values (rows rlo, rhi; two n8 tiles, two columns each)
    float x[2][2][2];
    bool ok[2][2][2];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = h ? rhi : rlo, jc = hc * 16 + jn * 8 + 2 * t + e;
          ok[jn][h][e] = row0 + r < n && j0 + jc < c_end;
          x[jn][h][e] = to_float(Xs[r * lay.x_ld + xo[h] + jc]);
        }
    // the chunk's B fragments, split once for every slot (KS > 0)
    uint32_t bh[KR][2][2], bl[KR][2][2];
    if constexpr (KS > 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            split_fast(Bk[(hc * 16 + jn * 8 + g) * ldb + 8 * s + t + 4 * v],
                       bh[s][jn][v], bl[s][jn][v]);
    }
    // two slots per pass (s, s + 1): four independent mma chains per warp
    for (int s = 0; s < slots; s += 2) {
      const bool two = s + 1 < slots;  // slot s + 1 exists (uniform)
      const float step[2] = {s > 0 ? ldexpf(1.f, 1 - s) : 0.f,
                             ldexpf(1.f, -s)};
      float c[2][2][4] = {};  // [slot s, s + 1][n8 tile]
      if constexpr (KS > 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int f = 0; f < 4; ++f)
              split_fast(candidate(mf[ks][f], df[ks][f], s + u, step[u],
                                   non_negative),
                         hi[f], lo[f]);
#pragma unroll
            for (int jn = 0; jn < 2; ++jn)
              mma_3xtf32(c[u][jn], hi, lo, bh[ks][jn][0], bl[ks][jn][0],
                         bh[ks][jn][1], bl[ks][jn][1]);
          }
      } else {
        for (int kk = 0; kk < kg; kk += 8) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int f = 0; f < 4; ++f)
              split_fast(candidate(Ma[a_off(f, kk)], Da[a_off(f, kk)], s + u,
                                   step[u], non_negative),
                         hi[f], lo[f]);
#pragma unroll
            for (int jn = 0; jn < 2; ++jn) {
              const float* b =
                  Bk + (size_t)(hc * 16 + jn * 8 + g) * ldb + kk + t;
              uint32_t bh0, bl0, bh1, bl1;
              split_fast(b[0], bh0, bl0);
              split_fast(b[4], bh1, bl1);
              mma_3xtf32(c[u][jn], hi, lo, bh0, bl0, bh1, bl1);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float sq[2] = {0.f, 0.f};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float r = x[jn][h][e] - sigmoid_fast(c[u][jn][2 * h + e]);
              if (ok[jn][h][e]) sq[h] += r * r;
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the quad's lanes, same bits on each
          sq[h] += __shfl_xor_sync(kFull, sq[h], 1);
          sq[h] += __shfl_xor_sync(kFull, sq[h], 2);
        }
        if (t == 0 && (u == 0 || two)) {  // one lane per (row, slot)
          sq_mine[(s + u) * kSRows + rlo] += sq[0];
          sq_mine[(s + u) * kSRows + rhi] += sq[1];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* dst = part + (size_t)blockIdx.y * n * slots;
  for (int e = tid; e < kSRows * slots; e += kSThreads) {
    const int r = e / slots, s = e % slots;
    if (row0 + r < n)
      dst[(size_t)(row0 + r) * slots + s] =
          Sq[s * kSRows + r] + Sq[slots * kSRows + s * kSRows + r];
  }
}

// phi[row, s] = l1 |c_s|_1 + l2/2 |c_s|^2 + 1/2 sum over segments (in order).
__global__ void phi_reduce_kernel(const float* __restrict__ part, int n_seg,
                                  int n, int k, int slots, int non_negative,
                                  const float* __restrict__ M,
                                  const float* __restrict__ d, float l1,
                                  float l2, float* __restrict__ phi) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * slots) return;
  const int row = (int)(idx / slots), s = (int)(idx % slots);
  float a1 = 0.f, a2 = 0.f;
  for (int c = 0; c < k; ++c) {
    float v = M[(size_t)row * k + c];
    if (s > 0) {
      v -= ldexpf(1.f, 1 - s) * d[(size_t)row * k + c];
      if (non_negative) v = fmaxf(v, 0.f);
    }
    a1 += fabsf(v);
    a2 += v * v;
  }
  float r2 = 0.f;
  for (int g = 0; g < n_seg; ++g) r2 += part[((size_t)g * n + row) * slots + s];
  phi[idx] = l1 * a1 + 0.5f * l2 * a2 + 0.5f * r2;
}

// The wrapper's plan (ops/kernels/sigmoid_newton.py: gh_plan, phi_plan).
// ldp: K3's partial row width, T's width rounded up to 128 columns.
struct SPlan {
  int ldp, n_seg, seg_len, ops_smem;
};

inline bool splan_ok(int xb, int n, int q, int k, int slots, bool gh,
                     const SPlan& p) {
  const int kg = pad8(k);
  if (n < 1 || q < 1 || k < 1 || slots < 1 || p.seg_len < kSQ ||
      p.seg_len % kSQ || p.n_seg < 1 || p.n_seg > 65535 ||
      (long long)(p.n_seg - 1) * p.seg_len >= q ||
      (long long)p.n_seg * p.seg_len < q ||
      (gh && (p.ldp < g_offset(k) + kg || p.ldp % kSCols ||
              p.ldp / kSCols > 65535)) ||
      k >= 65536 || (p.ops_smem != 0 && p.ops_smem != 1))
    return false;
  return SLayout(xb, kg, gh, p.ops_smem, slots).total <= kSmemMax;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` when it is below
// (`granted`: the caller's record of the limit already set).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

inline int blocks_for(long long total) { return (int)((total + 255) / 256); }

template <typename XT>
int launch_gh(const void* X, const float* M, const float* B, int n, int q,
              int k, float l1, float l2, float* G, float* H, float* Bp,
              uint32_t* Mh, uint32_t* Ml, uint32_t* Tg, float* part,
              const SPlan& p, cudaStream_t st) {
  const int kg = pad8(k);
  const int q_pad = ceil_div(q, kSQ) * kSQ, n_pad = ceil_div(n, kSRows) * kSRows;
  gh_prologue_kernel<<<blocks_for((long long)(q_pad + n_pad) * kg +
                                   (long long)q_pad / kSQ * p.ldp * (kSQ / 2)),
                       256, 0, st>>>(B, M, n, q, k, kg, p.ldp, Bp, Mh, Ml, Tg);
  const int smem = SLayout(sizeof(XT), kg, true, p.ops_smem, 0).total;
  static int granted = 0;
  if (cudaError_t e = set_smem(gh_part_kernel<XT>, smem, granted)) return (int)e;
  gh_part_kernel<XT><<<dim3(n_pad / kSRows, p.ldp / kSCols, p.n_seg),
                       kSThreads, smem, st>>>(
      static_cast<const XT*>(X), Mh, Ml, Bp, Tg, n, q, k, p.ldp, p.seg_len,
      p.ops_smem, part);
  gh_reduce_kernel<<<blocks_for((long long)n * (k + k * k)), 256, 0, st>>>(
      part, p.n_seg, n, k, p.ldp, M, l1, l2, G, H);
  return (int)cudaGetLastError();
}

template <typename XT, int KS>
int launch_phi_ks(const void* X, const float* Mp, const float* Dp,
                  const float* Bp, int n, int q, int kg, int slots,
                  int non_negative, float* part, const SPlan& p,
                  cudaStream_t st) {
  const int smem = SLayout(sizeof(XT), kg, false, p.ops_smem, slots).total;
  static int granted = 0;
  if (cudaError_t e = set_smem(phi_part_kernel<XT, KS>, smem, granted))
    return (int)e;
  phi_part_kernel<XT, KS>
      <<<dim3(ceil_div(n, kSRows), p.n_seg), kSThreads, smem, st>>>(
          static_cast<const XT*>(X), Mp, Dp, Bp, n, q, kg, slots, non_negative,
          p.seg_len, p.ops_smem, part);
  return 0;
}

template <typename XT>
int launch_phi(const void* X, const float* M, const float* d, const float* B,
               int n, int q, int k, int slots, int non_negative, float l1,
               float l2, float* phi, float* Bp, float* Mp, float* Dp,
               float* part, const SPlan& p, cudaStream_t st) {
  const int kg = pad8(k);
  const int q_pad = ceil_div(q, kSQ) * kSQ, n_pad = ceil_div(n, kSRows) * kSRows;
  phi_prologue_kernel<<<blocks_for((long long)(q_pad + 2 * n_pad) * kg), 256,
                        0, st>>>(B, M, d, n, q, k, kg, Bp, Mp, Dp);
  int e;
  switch (kg) {
    case 8:
      e = launch_phi_ks<XT, 1>(X, Mp, Dp, Bp, n, q, kg, slots, non_negative,
                               part, p, st);
      break;
    case 16:
      e = launch_phi_ks<XT, 2>(X, Mp, Dp, Bp, n, q, kg, slots, non_negative,
                               part, p, st);
      break;
    case 24:
      e = launch_phi_ks<XT, 3>(X, Mp, Dp, Bp, n, q, kg, slots, non_negative,
                               part, p, st);
      break;
    case 32:
      e = launch_phi_ks<XT, 4>(X, Mp, Dp, Bp, n, q, kg, slots, non_negative,
                               part, p, st);
      break;
    default:
      e = launch_phi_ks<XT, 0>(X, Mp, Dp, Bp, n, q, kg, slots, non_negative,
                               part, p, st);
  }
  if (e) return e;
  phi_reduce_kernel<<<blocks_for((long long)n * slots), 256, 0, st>>>(
      part, p.n_seg, n, k, slots, non_negative, M, d, l1, l2, phi);
  return (int)cudaGetLastError();
}

}  // namespace pycmf

// X (n, q): f32, bf16 or e4m3 by x_dtype (common.cuh: XDtype); M (n, k),
// B (q, k), G (n, k),
// H (n, k, k): f32. All row-major and contiguous; k >= 1. Scratch (16-byte
// aligned): Bp (ceil(q / 32) * 32 x KG f32), Mh and Ml (ceil(n / 64) * 64
// x KG words each), Tg (ceil(q / 32) x ldp x 32 words), part (n_seg x n x
// ldp f32). ldp, n_seg, seg_len and ops_smem: the
// wrapper's plan (checked). The launches go to `stream` on `device`.
// Returns the CUDA error of the launches (0 on success).
extern "C" int pycmf_sigmoid_gh_pass(int x_dtype, const void* X,
                                     const float* M, const float* B, int n,
                                     int q, int k, float l1, float l2,
                                     float* G, float* H, float* Bp,
                                     uint32_t* Mh, uint32_t* Ml, uint32_t* Tg,
                                     float* part, int ldp, int n_seg,
                                     int seg_len, int ops_smem, int device,
                                     void* stream) {
  using namespace pycmf;
  const SPlan p{ldp, n_seg, seg_len, ops_smem};
  const int xb = x_dtype_bytes(x_dtype);
  if (xb == 0 || !splan_ok(xb, n, q, k, 1, true, p))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kXBF16)
    return launch_gh<__nv_bfloat16>(X, M, B, n, q, k, l1, l2, G, H, Bp, Mh,
                                    Ml, Tg, part, p, st);
  if (x_dtype == kXE4M3)
    return launch_gh<__nv_fp8_e4m3>(X, M, B, n, q, k, l1, l2, G, H, Bp, Mh,
                                    Ml, Tg, part, p, st);
  return launch_gh<float>(X, M, B, n, q, k, l1, l2, G, H, Bp, Mh, Ml, Tg,
                          part, p, st);
}

// X as above; M, d (n, k), B (q, k), phi (n, slots): f32; slots = trials +
// 1 >= 1. Scratch: Bp (ceil(q / 32) * 32 x KG), Mp and Dp (ceil(n / 64) *
// 64 x KG), part (n_seg x n x slots).
extern "C" int pycmf_sigmoid_phi_pass(int x_dtype, const void* X,
                                      const float* M, const float* d,
                                      const float* B, int n, int q, int k,
                                      int slots, int non_negative, float l1,
                                      float l2, float* phi, float* Bp,
                                      float* Mp, float* Dp, float* part,
                                      int n_seg, int seg_len, int ops_smem,
                                      int device, void* stream) {
  using namespace pycmf;
  const SPlan p{0, n_seg, seg_len, ops_smem};
  const int xb = x_dtype_bytes(x_dtype);
  if (xb == 0 || !splan_ok(xb, n, q, k, slots, false, p))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kXBF16)
    return launch_phi<__nv_bfloat16>(X, M, d, B, n, q, k, slots, non_negative,
                                     l1, l2, phi, Bp, Mp, Dp, part, p, st);
  if (x_dtype == kXE4M3)
    return launch_phi<__nv_fp8_e4m3>(X, M, d, B, n, q, k, slots, non_negative,
                                     l1, l2, phi, Bp, Mp, Dp, part, p, st);
  return launch_phi<float>(X, M, d, B, n, q, k, slots, non_negative, l1, l2,
                           phi, Bp, Mp, Dp, part, p, st);
}
