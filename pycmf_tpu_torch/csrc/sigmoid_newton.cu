// Sigmoid-link Newton passes for Hopper (sm_90a), called through ctypes.
//
// Replaces: pycmf_tpu/ops/pallas/sigmoid_newton.py:sigmoid_gh_pass (TPU
// kernel K3) and pycmf_tpu/ops/pallas/sigmoid_newton.py:sigmoid_phi_pass
// (TPU kernel K4).
//
// With X (n, q) stored as f32 or bf16 (widened to f32 in the kernel), M
// (n, k), B (q, k), P = sigmoid(M B^T), f' = P (1 - P):
//   K3  G[i]    = sum_j (P_ij - X_ij) f'_ij B_j + l1 sign(M_i) + l2 M_i
//       H[i]    = sum_j f'_ij^2 B_j B_j^T           (Gauss-Newton, (n, k, k))
//   K4  phi[i,0] = phi_i(M_i), phi[i,t] = phi_i(proj(M_i - 2^-(t-1) d_i)),
//       phi_i(c) = l1 |c|_1 + l2/2 |c|^2 + 1/2 sum_j (X_ij - sigmoid(c.B_j))^2
// The (n, q) predictions never reach device memory.
//
// Bound: operations. Per element of X, K3 does 2k FMAs for the logit and
// G and k(k+1)/2 for the symmetric H (250 at k = 20) plus a sigmoid; K4
// does (trials+1) k FMAs and trials+1 sigmoids (180 and 9 at k = 20,
// trials = 8). At the dense sigmoid-X shape (30000 x 11314) that is 85 G
// and 61 G f32 FMAs against 0.68 GB of bf16 X: ~2.5 ms and ~1.8 ms at the
// card's 67 TFLOP/s f32 rate against 0.2 ms for the bytes.
//
// Design: both kernels split the q axis as well as the rows (the main
// path's Z update has 20 rows), write one partial per (q segment, row), and
// a second kernel sums the segments in order and adds the elastic-net
// terms once, after the sum (the reference's axis_name arithmetic). No
// float atomics: a call repeats bit for bit. Logits, G and H are f32 FMAs
// on the CUDA cores, no TF32 (the line search compares objectives whose
// differences are far below TF32's noise).
//   K3 treats H as a product W (rows x q) times BB (q x k(k+1)/2), with
//   W = f'^2 and BB_j the upper triangle of B_j B_j^T, and G as RF (rows x
//   q) times B with RF = (P - X) f'. A block owns R rows and walks its q
//   segment in chunks of J columns: it stages the chunk of X and B in
//   shared memory, builds BB for the chunk, computes the logits (one row
//   per thread, B broadcast) and W, RF, then each thread accumulates an
//   8 x 8 tile of H (or an 8 x 4 tile of G) in registers from float4 reads;
//   H and G tiles sit in separate warps.
//   K4 gives each thread one (row, slot) candidate in registers and walks
//   the chunk's columns with B broadcast, summing the squared residuals.
#include "common.cuh"

namespace pycmf {

__device__ __forceinline__ float sigmoid(float t) { return 1.f / (1.f + expf(-t)); }

// Split q into segments (multiples of the chunk width J) so that row tiles
// times segments give about four blocks per SM.
struct SegPlan {
  int n_seg;
  int seg_len;
};

inline SegPlan plan_segments(int row_tiles, int q, int J) {
  const int chunks = ceil_div(q, J);
  int s = ceil_div(4 * sm_count(), row_tiles);
  s = s < 1 ? 1 : (s > chunks ? chunks : s);
  const int per = ceil_div(chunks, s);
  return {ceil_div(chunks, per), per * J};
}

// ---------------------------------------------------------------- K3 ----

template <int KP>
struct Gh {
  static constexpr int R = KP <= 24 ? 64 : 32;  // rows per block
  static constexpr int J = 32;                  // columns per chunk
  static constexpr int NP = KP * (KP + 1) / 2;  // packed upper triangle
  static constexpr int NGH = (NP + 7) / 8;      // 8-wide H column groups
  static constexpr int NP8 = NGH * 8;
  static constexpr int NGG = KP / 4;            // 4-wide G column groups
  static constexpr int NRG = R / 8;             // 8-row groups
  // H tiles, then G tiles, each role padded to whole warps (a warp that
  // held both would run both loops, one after the other)
  static constexpr int NH_TILES = NRG * NGH;
  static constexpr int NG_TILES = NRG * NGG;
  static constexpr int NH = (NH_TILES + 31) / 32 * 32;
  static constexpr int NT = NH + (NG_TILES + 31) / 32 * 32;
  static constexpr int EJG = NT / R;            // logit phase: column groups
  static constexpr int XLD = J + 1;             // odd strides: no bank conflicts
  static constexpr int MLD = KP + 1;
  // shared memory, in floats; the float4-read arrays come first (aligned)
  static constexpr int OFF_BB = J * KP;
  static constexpr int OFF_W = OFF_BB + J * NP8;
  static constexpr int OFF_RF = OFF_W + J * R;
  static constexpr int OFF_X = OFF_RF + J * R;
  static constexpr int OFF_M = OFF_X + R * XLD;
  static constexpr int OFF_PAIR = OFF_M + R * MLD;
  static constexpr int SMEM_BYTES = (OFF_PAIR + 2 * NP8) * 4;
};

// Offset of pair (a, b), a <= b, in the packed upper triangle of a KP x KP
// matrix (row-major).
__host__ __device__ __forceinline__ int pair_index(int a, int b, int KP) {
  return a * KP - a * (a - 1) / 2 + (b - a);
}

// part_g[seg, row, 0:KP] and part_h[seg, row, 0:NP8]: the segment's sums.
// Two blocks per SM: at one (the 155 registers the compiler picks) each
// chunk's global loads and barriers stall the SM; capped at two it spills
// a few bytes and ran 22% faster on an H100 at 30000 x 11314 (PERF.md).
template <typename XT, int KP>
__global__ void __launch_bounds__(Gh<KP>::NT, 2)
    gh_part_kernel(const XT* __restrict__ X, const float* __restrict__ M,
                   const float* __restrict__ B, int n, int q, int k,
                   int seg_len, float* __restrict__ part_g,
                   float* __restrict__ part_h) {
  using C = Gh<KP>;
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                // J x KP
  float* BBs = sm + C::OFF_BB;   // J x NP8
  float* Ws = sm + C::OFF_W;     // J x R, column-major in rows
  float* RFs = sm + C::OFF_RF;   // J x R
  float* Xs = sm + C::OFF_X;     // R x XLD
  float* Ms = sm + C::OFF_M;     // R x MLD
  int* pa = reinterpret_cast<int*>(sm + C::OFF_PAIR);
  int* pb = pa + C::NP8;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * C::R;
  const int seg = blockIdx.y;
  const int c_begin = seg * seg_len;
  const int c_end = min(q, c_begin + seg_len);

  for (int e = tid; e < C::NP8; e += C::NT) {
    int a = -1, b = -1;  // padding pairs
    if (e < C::NP) {
      int r = e;
      a = 0;
      while (r >= KP - a) {  // row a of the triangle holds KP - a pairs
        r -= KP - a;
        ++a;
      }
      b = a + r;
    }
    pa[e] = a;
    pb[e] = b;
  }
  for (int e = tid; e < C::R * KP; e += C::NT) {
    const int r = e / KP, c = e % KP;
    Ms[r * C::MLD + c] =
        (row0 + r < n && c < k) ? M[(size_t)(row0 + r) * k + c] : 0.f;
  }

  const bool is_h = tid < C::NH_TILES;
  const bool is_g = tid >= C::NH && tid - C::NH < C::NG_TILES;
  const int item = tid < C::NH ? tid : tid - C::NH;
  const int rg = tid < C::NH ? item / C::NGH : item / C::NGG;
  const int cg = tid < C::NH ? item % C::NGH : item % C::NGG;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  // logit phase: thread = (row, column group)
  const int er = tid % C::R, ejg = tid / C::R;
  const bool is_logit = ejg < C::EJG;

  for (int j0 = c_begin; j0 < c_end; j0 += C::J) {
    const int len = min(C::J, c_end - j0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < C::R * C::J; e += C::NT) {
      const int r = e / C::J, j = e % C::J;
      Xs[r * C::XLD + j] = (row0 + r < n && j < len)
                               ? to_float(X[(size_t)(row0 + r) * q + j0 + j])
                               : 0.f;
    }
    for (int e = tid; e < C::J * KP; e += C::NT) {
      const int j = e / KP, c = e % KP;
      Bs[e] = (j < len && c < k) ? B[(size_t)(j0 + j) * k + c] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < C::J * C::NP8; e += C::NT) {
      const int j = e / C::NP8, pr = e % C::NP8;
      const int a = pa[pr];
      BBs[e] = a >= 0 ? Bs[j * KP + a] * Bs[j * KP + pb[pr]] : 0.f;
    }
    if (is_logit) {
      float m[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) m[c] = Ms[er * C::MLD + c];
      for (int j = ejg; j < len; j += C::EJG) {
        const float4* b4 = reinterpret_cast<const float4*>(Bs + j * KP);
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < KP / 4; ++p) {
          const float4 v = b4[p];
          t += m[4 * p + 0] * v.x;
          t += m[4 * p + 1] * v.y;
          t += m[4 * p + 2] * v.z;
          t += m[4 * p + 3] * v.w;
        }
        const float pr = sigmoid(t);
        const float fp = pr * (1.f - pr);
        Ws[j * C::R + er] = fp * fp;
        RFs[j * C::R + er] = (pr - Xs[er * C::XLD + j]) * fp;
      }
    }
    __syncthreads();
    if (is_h) {
      for (int j = 0; j < len; ++j) {
        // the tile's 8 pair slots are 4cg..4cg+3 and 4(NGH+cg)..: lanes
        // read consecutive float4s (no bank conflicts)
        const float4* w4 = reinterpret_cast<const float4*>(Ws + j * C::R + rg * 8);
        const float4* b4 = reinterpret_cast<const float4*>(BBs + j * C::NP8);
        const float4 w0 = w4[0], w1 = w4[1], b0 = b4[cg], b1 = b4[C::NGH + cg];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] += w[i] * bb[c];
      }
    } else if (is_g) {
      for (int j = 0; j < len; ++j) {
        const float4* r4 = reinterpret_cast<const float4*>(RFs + j * C::R + rg * 8);
        const float4 r0 = r4[0], r1 = r4[1];
        const float4 bv = *reinterpret_cast<const float4*>(Bs + j * KP + cg * 4);
        const float rf[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] += rf[i] * bb[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + rg * 8 + i;
    if (row >= n) continue;
    if (is_h) {
      float* dst = part_h + ((size_t)seg * n + row) * C::NP8;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dst[4 * cg + c] = acc[i][c];
        dst[4 * (C::NGH + cg) + c] = acc[i][4 + c];
      }
    } else if (is_g) {
      float* dst = part_g + ((size_t)seg * n + row) * KP + cg * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = acc[i][c];
    }
  }
}

// G = sum over segments (in order) + l1 sign(M) + l2 M; H unpacked to (k, k).
__global__ void gh_reduce_kernel(const float* __restrict__ part_g,
                                 const float* __restrict__ part_h, int n_seg,
                                 int n, int k, int KP, int NP8,
                                 const float* __restrict__ M, float l1,
                                 float l2, float* __restrict__ G,
                                 float* __restrict__ H) {
  const int per = k + k * k;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * per) return;
  const int row = (int)(idx / per), e = (int)(idx % per);
  float s = 0.f;
  if (e < k) {
    for (int g = 0; g < n_seg; ++g) s += part_g[((size_t)g * n + row) * KP + e];
    const float m = M[(size_t)row * k + e];
    const float sgn = m > 0.f ? 1.f : (m < 0.f ? -1.f : 0.f);
    G[(size_t)row * k + e] = s + l1 * sgn + l2 * m;
  } else {
    const int ab = e - k, a = ab / k, b = ab % k;
    const int pr = pair_index(min(a, b), max(a, b), KP);
    for (int g = 0; g < n_seg; ++g) s += part_h[((size_t)g * n + row) * NP8 + pr];
    H[(size_t)row * k * k + ab] = s;
  }
}

template <int KP>
SegPlan gh_plan(int n, int q) {
  return plan_segments(ceil_div(n, Gh<KP>::R), q, Gh<KP>::J);
}

template <typename XT, int KP>
void launch_gh(const void* X, const float* M, const float* B, int n, int q,
               int k, float l1, float l2, float* G, float* H, float* work,
               cudaStream_t st) {
  using C = Gh<KP>;
  const SegPlan sp = gh_plan<KP>(n, q);
  float* part_g = work;
  float* part_h = work + (size_t)sp.n_seg * n * KP;
  cudaFuncSetAttribute(gh_part_kernel<XT, KP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  gh_part_kernel<XT, KP><<<dim3(ceil_div(n, C::R), sp.n_seg), C::NT,
                           C::SMEM_BYTES, st>>>(
      static_cast<const XT*>(X), M, B, n, q, k, sp.seg_len, part_g, part_h);
  const long long total = (long long)n * (k + k * k);
  gh_reduce_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(
      part_g, part_h, sp.n_seg, n, k, KP, C::NP8, M, l1, l2, G, H);
}

// ---------------------------------------------------------------- K4 ----

constexpr int kPhiThreads = 256;
constexpr int kPhiJ = 64;

__host__ __device__ inline int phi_rows(int slots) { return kPhiThreads / slots; }

// part[seg, row, s] = sum over the segment's columns of
// (X_ij - sigmoid(c_s . B_j))^2 for row i's candidate c_s.
template <typename XT, int KP>
__global__ void __launch_bounds__(kPhiThreads)
    phi_part_kernel(const XT* __restrict__ X, const float* __restrict__ M,
                    const float* __restrict__ d, const float* __restrict__ B,
                    int n, int q, int k, int slots, int non_negative,
                    int seg_len, float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  constexpr int XLD = kPhiJ + 1;
  float* Bs = sm;                 // kPhiJ x KP
  float* Xs = sm + kPhiJ * KP;    // R x XLD
  const int tid = threadIdx.x;
  const int R = phi_rows(slots);
  const int row0 = blockIdx.x * R;
  const int seg = blockIdx.y;
  const int c_begin = seg * seg_len;
  const int c_end = min(q, c_begin + seg_len);
  const int r = tid / slots, s = tid % slots;
  const int row = row0 + r;
  const bool mine = r < R && row < n;

  // slot 0: M (unprojected); slot t: proj(M - 2^-(t-1) d), the product exact
  float cand[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    float v = 0.f;
    if (mine && c < k) {
      v = M[(size_t)row * k + c];
      if (s > 0) {
        v -= ldexpf(1.f, 1 - s) * d[(size_t)row * k + c];
        if (non_negative) v = fmaxf(v, 0.f);
      }
    }
    cand[c] = v;
  }

  float acc = 0.f;
  for (int j0 = c_begin; j0 < c_end; j0 += kPhiJ) {
    const int len = min(kPhiJ, c_end - j0);
    __syncthreads();
    for (int e = tid; e < R * kPhiJ; e += kPhiThreads) {
      const int rr = e / kPhiJ, j = e % kPhiJ;
      Xs[rr * XLD + j] = (row0 + rr < n && j < len)
                             ? to_float(X[(size_t)(row0 + rr) * q + j0 + j])
                             : 0.f;
    }
    for (int e = tid; e < kPhiJ * KP; e += kPhiThreads) {
      const int j = e / KP, c = e % KP;
      Bs[e] = (j < len && c < k) ? B[(size_t)(j0 + j) * k + c] : 0.f;
    }
    __syncthreads();
    if (mine) {
      for (int j = 0; j < len; ++j) {
        const float4* b4 = reinterpret_cast<const float4*>(Bs + j * KP);
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < KP / 4; ++p) {
          const float4 v = b4[p];
          t += cand[4 * p + 0] * v.x;
          t += cand[4 * p + 1] * v.y;
          t += cand[4 * p + 2] * v.z;
          t += cand[4 * p + 3] * v.w;
        }
        const float e = Xs[r * XLD + j] - sigmoid(t);
        acc += e * e;
      }
    }
  }
  if (mine) part[((size_t)seg * n + row) * slots + s] = acc;
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

inline SegPlan phi_plan(int n, int q, int slots) {
  return plan_segments(ceil_div(n, phi_rows(slots)), q, kPhiJ);
}

template <typename XT, int KP>
void launch_phi(const void* X, const float* M, const float* d, const float* B,
                int n, int q, int k, int slots, int non_negative, float l1,
                float l2, float* phi, float* work, cudaStream_t st) {
  const SegPlan sp = phi_plan(n, q, slots);
  const int smem = (kPhiJ * KP + phi_rows(slots) * (kPhiJ + 1)) * 4;
  phi_part_kernel<XT, KP><<<dim3(ceil_div(n, phi_rows(slots)), sp.n_seg),
                            kPhiThreads, smem, st>>>(
      static_cast<const XT*>(X), M, d, B, n, q, k, slots, non_negative,
      sp.seg_len, work);
  const long long total = (long long)n * slots;
  phi_reduce_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(
      work, sp.n_seg, n, k, slots, non_negative, M, d, l1, l2, phi);
}

}  // namespace pycmf

// Scratch floats for one call (the segment partials).
extern "C" long long pycmf_gh_workspace_floats(int n, int q, int k) {
  using namespace pycmf;
  long long out = 0;
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    const SegPlan sp = gh_plan<KP>(n, q);
    out = (long long)sp.n_seg * n * (KP + Gh<KP>::NP8);
  });
  return out;
}

extern "C" long long pycmf_phi_workspace_floats(int n, int q, int slots) {
  using namespace pycmf;
  return (long long)phi_plan(n, q, slots).n_seg * n * slots;
}

// X (n, q): f32 (x_is_bf16 = 0) or bf16; M (n, k), B (q, k), G (n, k),
// H (n, k, k): f32. All row-major and contiguous; 1 <= k <= 32. Returns
// the CUDA error of the launches (0 on success).
extern "C" int pycmf_sigmoid_gh_pass(int x_is_bf16, const void* X,
                                     const float* M, const float* B, int n,
                                     int q, int k, float l1, float l2,
                                     float* G, float* H, float* work,
                                     void* stream) {
  using namespace pycmf;
  if (n < 1 || q < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    if (x_is_bf16)
      launch_gh<__nv_bfloat16, KP>(X, M, B, n, q, k, l1, l2, G, H, work, st);
    else
      launch_gh<float, KP>(X, M, B, n, q, k, l1, l2, G, H, work, st);
  });
  return (int)cudaGetLastError();
}

// X as above; M, d (n, k), B (q, k), phi (n, slots): f32; slots = trials + 1
// with 1 <= slots <= 256.
extern "C" int pycmf_sigmoid_phi_pass(int x_is_bf16, const void* X,
                                      const float* M, const float* d,
                                      const float* B, int n, int q, int k,
                                      int slots, int non_negative, float l1,
                                      float l2, float* phi, float* work,
                                      void* stream) {
  using namespace pycmf;
  if (n < 1 || q < 1 || k < 1 || k > kMaxK || slots < 1 ||
      slots > kPhiThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    if (x_is_bf16)
      launch_phi<__nv_bfloat16, KP>(X, M, d, B, n, q, k, slots, non_negative,
                                    l1, l2, phi, work, st);
    else
      launch_phi<float, KP>(X, M, d, B, n, q, k, slots, non_negative, l1, l2,
                            phi, work, st);
  });
  return (int)cudaGetLastError();
}
