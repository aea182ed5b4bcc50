// Hand-written Hopper (sm_90a) kernels of the grouped (ragged) matmul of the
// MoE expert FFNs: the forward (K6) and its gradient (K6b).
//
//   K6  gmm_mma (bf16 on mma.sync m16n8k16, f32 accumulate) and gmm_f32 (f32
//       on CUDA cores) in forward mode replace the Pallas `gmm` / `_kernel`
//       (src/repro/kernels/moe_gmm.py) and, on the MoE paths, the three
//       expert einsums of `moe_mlp` (src/repro/models/moe.py)
//   K6b the same kernels twice: dx = dy w[e]^T (forward mode with the weight
//       read transposed through its strides, no transposed copy) and
//       dw[e] = x_e^T dy_e (weight-gradient mode); the JAX package takes
//       that gradient from XLA autodiff of the einsums
//
// Layout. x [T, K] holds its rows in a table of tiles of tm rows: table tile
// t is rows [t tm, (t+1) tm) and belongs to expert tile_expert[t], an int32
// array on the device that every CTA reads for itself (the Pallas kernel's
// scalar prefetch). w is [E, K, N], or [E, N, K] read transposed; out [T, N]
// in x's dtype. tm is any positive size: a CTA covers at most BM rows of one
// table tile and masks the rest, so groups of 4 rows (a decode step's
// capacity) need no padding. In weight-gradient mode x [T, M] and dy [T, N]
// give dw [E, M, N]: a CTA owns one (expert, M tile, N tile) and walks the
// table tiles of its expert in order, so each dw element is one f32 sum in a
// fixed order (no atomics: deterministic), and an expert without rows gets
// zeros.
//
// Both operands are seen as 2-D strided views, A (row m, depth k) and B
// (column n, depth k), staged per 32-deep slab in shared memory as they lie
// in memory, in 16-byte vectors: [i][k] where the depth is contiguous (x
// as A, w [E, N, K] read transposed as B), its fragments read in pairs;
// [k][i] where the other axis is (w [E, K, N] as B, and x and dy in
// weight-gradient mode), its fragments read with ldmatrix.trans. Each CTA
// issues the next slab's loads into registers before the current slab's
// products.
//
// Bounds on an H100 SXM (data sheet): a decode step (tm = 4 rows per
// expert) reads every expert's weight once, E K N bf16 elements for a few
// rows of products: bytes bound (moonshot-v1-16b-a3b: 369 MB, 0.110 ms per
// product at 3.35 TB/s). The small-tile variant (BM = 16, 4 warps, a
// 16 x 128 output tile) keeps the wasted rows of the m16 products at 12 of
// 16 and many CTAs resident to keep the weight stream in flight. Training
// (64 groups of 512 rows, K 2048, N 1408) is 189 GFLOP a product:
// operations bound (0.19 ms at 989 TFLOP/s); the large variant (128 x 128
// output tile, 8 warps of 64 x 32) reuses each staged slab 16 (A) and 32
// (B) times. Neither pipelines its loads beyond what resident CTAs overlap:
// cp.async or TMA stages and wgmma are later work.

#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 32;           // depth of one staged slab (mma path)
constexpr int kFB = 64;           // f32 path: 64 x 64 output tile
constexpr int kFK = 16;           // f32 path: slab depth
constexpr int kFThreads = 256;

struct View {                     // element (i, j) at p[i * si + j * sj]
  const void* p;
  long long si, sj;
};

struct GmmArgs {
  View a, b;                      // A (m, k) and B (n, k); b of expert 0
  void* out;
  const int* tile_expert;
  long long b_se;                 // expert stride of w (forward mode)
  int n_tiles, tm, n_experts;
  int K, M, N;                    // forward: depth K; dw: M x N per expert
  int dw;                         // 0: forward, out [T, N]; 1: dw [E, M, N]
};

// What one CTA computes: out[m, n] (m < m_lim, n < n_lim, row stride ldo)
// = sum over its depth ranges of A(m, k) B(n, k).
template <typename T>
struct Job {
  const T* a;
  const T* b;
  T* out;
  long long ldo;
  int m_lim, n_lim, e;
  bool skip;                      // an expert id outside [0, E): zeros
};

template <typename T, int BM, int BN>
__device__ __forceinline__ Job<T> make_job(const GmmArgs& g) {
  Job<T> j;
  const int n0 = blockIdx.x * BN;
  j.n_lim = g.N - n0;
  j.ldo = g.N;
  if (!g.dw) {
    const int sub = (g.tm + BM - 1) / BM;
    const int t = blockIdx.y / sub, m0 = (blockIdx.y % sub) * BM;
    const long long row0 = (long long)t * g.tm + m0;
    j.e = g.tile_expert[t];
    j.skip = j.e < 0 || j.e >= g.n_experts;
    j.m_lim = min(BM, g.tm - m0);
    j.a = static_cast<const T*>(g.a.p) + row0 * g.a.si;
    j.b = static_cast<const T*>(g.b.p) + (j.skip ? 0 : j.e) * g.b_se +
          n0 * g.b.si;
    j.out = static_cast<T*>(g.out) + row0 * g.N + n0;
  } else {
    const int m0 = blockIdx.y * BM;
    j.e = blockIdx.z;
    j.skip = false;
    j.m_lim = g.M - m0;
    j.a = static_cast<const T*>(g.a.p) + m0 * g.a.si;
    j.b = static_cast<const T*>(g.b.p) + n0 * g.b.si;
    j.out = static_cast<T*>(g.out) + ((long long)j.e * g.M + m0) * g.N + n0;
  }
  return j;
}

// The 32-deep slabs of a CTA's depth, in order: forward, [0, K) in steps
// of kBK; weight gradient, the rows of every table tile of its expert, in
// table order, each tile's last slab cut at its end. next() gives the
// slab's first depth and its length, or false past the last one.
template <int BK>
struct Slabs {
  int t = 0;
  long long k0 = 0, hi = 0;
  __device__ bool next(const GmmArgs& g, int e, bool skip, long long& at,
                       int& len) {
    while (k0 >= hi) {              // open the next range
      if (!g.dw) {
        if (t++ > 0 || skip) return false;
        k0 = 0;
        hi = g.K;
      } else {
        while (t < g.n_tiles && g.tile_expert[t] != e) ++t;
        if (t >= g.n_tiles) return false;
        k0 = (long long)t * g.tm;
        hi = k0 + g.tm;
        ++t;
      }
    }
    at = k0;
    len = (int)min(hi - k0, (long long)BK);
    k0 += BK;
    return true;
  }
};

// A bf16 operand's slab in shared memory: R rows (i) by kBK depths, held
// as the view lies in memory so that every copy is a 16-byte vector: [i][k]
// (depth contiguous, KI false; fragments read in pairs) or [k][i] (KI
// true; fragments read with ldmatrix.trans). The padding keeps the
// fragment reads of 8 rows on distinct banks.
template <int R, bool KI, int NT>
struct Slab {
  static constexpr int LD = KI ? R + 8 : kBK + 8;
  static constexpr int SIZE = KI ? kBK * LD : R * LD;
  static constexpr int VECS = KI ? kBK * (R / 8) : R * (kBK / 8);
  static constexpr int PER = (VECS + NT - 1) / NT;   // vectors per thread
  uint4 r[PER];

  // global -> registers: the slab at p (element (0, 0)), rows i >= i_lim
  // and depths k >= k_lim zero (i_lim a multiple of 8 for KI, k_lim for
  // !KI; the vector is whole or out)
  __device__ __forceinline__ void fetch(const bf16* p, long long si,
                                        long long sj, int i_lim, int k_lim) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int v = threadIdx.x + q * NT;
      r[q] = make_uint4(0, 0, 0, 0);
      if (v >= VECS) continue;
      if (KI) {
        const int k = v / (R / 8), ic = (v % (R / 8)) * 8;
        if (k < k_lim && ic < i_lim)
          r[q] = *reinterpret_cast<const uint4*>(p + ic + k * sj);
      } else {
        const int i = v / (kBK / 8), kc = (v % (kBK / 8)) * 8;
        if (i < i_lim && kc < k_lim)
          r[q] = *reinterpret_cast<const uint4*>(p + i * si + kc);
      }
    }
  }

  // registers -> shared memory
  __device__ __forceinline__ void stash(bf16* s) const {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int v = threadIdx.x + q * NT;
      if (v >= VECS) continue;
      const int at = KI ? (v / (R / 8)) * LD + (v % (R / 8)) * 8
                        : (v / (kBK / 8)) * LD + (v % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(s + at) = r[q];
    }
  }
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A fragment (16 x 16, rows m0.., depths kk..) of a slab (mma_common's
// layout). [k][m]: matrix q of ldmatrix.x4 is rows (m) 8 (q & 1) and depths
// 8 (q >> 1) on, each read transposed.
template <bool KI, int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int m0, int kk, int lane) {
  const int gid = lane / 4, tig = lane % 4;
  if (KI) {
    const int q = lane / 8, r = lane % 8;
    ldsm_x4_trans(a, s + (kk + (q >> 1) * 8 + r) * LD + m0 + (q & 1) * 8);
  } else {
    const bf16* p = s + (m0 + gid) * LD + kk + 2 * tig;
    a[0] = ld_pair(p);
    a[1] = ld_pair(p + 8 * LD);
    a[2] = ld_pair(p + 8);
    a[3] = ld_pair(p + 8 * LD + 8);
  }
}

// The B fragments of two neighbouring 8-column tiles (columns n0..n0+15,
// depths kk..): b[0], b[1] for the first, b[2], b[3] for the second.
// [k][n]: matrix q is depths 8 (q & 1) and columns 8 (q >> 1) on.
template <bool KI, int LD>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* s,
                                        int n0, int kk, int lane) {
  const int gid = lane / 4, tig = lane % 4;
  if (KI) {
    const int q = lane / 8, r = lane % 8;
    ldsm_x4_trans(b, s + (kk + (q & 1) * 8 + r) * LD + n0 + (q >> 1) * 8);
  } else {
    const bf16* p = s + (n0 + gid) * LD + kk + 2 * tig;
    b[0] = ld_pair(p);
    b[1] = ld_pair(p + 8);
    b[2] = ld_pair(p + 8 * LD);
    b[3] = ld_pair(p + 8 * LD + 8);
  }
}

// bf16: a BM x BN output tile per CTA, WM x WN warps, each warp (BM / WM) x
// (BN / WN) as m16n8k16 products with f32 accumulators. A_KI / B_KI: the
// operand's depth is strided in memory (its slab is held [k][i]). The next
// slab's loads are issued before the current one's products.
template <int BM, int BN, int WM, int WN, bool A_KI, bool B_KI>
__global__ void __launch_bounds__(WM * WN * 32) gmm_mma(GmmArgs g) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM / WM / 16, TN = BN / WN / 8;
  static_assert(TN % 2 == 0, "B fragments come in pairs of 8-column tiles");
  using SA = Slab<BM, A_KI, NT>;
  using SB = Slab<BN, B_KI, NT>;
  __shared__ __align__(16) bf16 sA[SA::SIZE];
  __shared__ __align__(16) bf16 sB[SB::SIZE];
  const Job<bf16> j = make_job<bf16, BM, BN>(g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  float acc[TM][TN][4];
#pragma unroll
  for (int mt = 0; mt < TM; ++mt)
#pragma unroll
    for (int nt = 0; nt < TN; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  SA ra;
  SB rb;
  Slabs<kBK> it;
  long long k0;
  int kl;
  bool have = it.next(g, j.e, j.skip, k0, kl);
  if (have) {
    ra.fetch(j.a + k0 * g.a.sj, g.a.si, g.a.sj, j.m_lim, kl);
    rb.fetch(j.b + k0 * g.b.sj, g.b.si, g.b.sj, j.n_lim, kl);
  }
  while (have) {
    ra.stash(sA);
    rb.stash(sB);
    __syncthreads();
    have = it.next(g, j.e, j.skip, k0, kl);
    if (have) {
      ra.fetch(j.a + k0 * g.a.sj, g.a.si, g.a.sj, j.m_lim, kl);
      rb.fetch(j.b + k0 * g.b.sj, g.b.si, g.b.sj, j.n_lim, kl);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[TM][4];
#pragma unroll
      for (int mt = 0; mt < TM; ++mt)
        frag_a<A_KI, SA::LD>(a[mt], sA, wm0 + mt * 16, kk, lane);
#pragma unroll
      for (int nt = 0; nt < TN; nt += 2) {
        uint32_t b[4];
        frag_b2<B_KI, SB::LD>(b, sB, wn0 + nt * 8, kk, lane);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int mt = 0; mt < TM; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b0);
          mma_bf16(acc[mt][nt + 1], a[mt], b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < TM; ++mt)
#pragma unroll
    for (int nt = 0; nt < TN; ++nt) {
      const int r = wm0 + mt * 16 + gid, c = wn0 + nt * 8 + 2 * tig;
      if (c >= j.n_lim) continue;
      if (r < j.m_lim)
        *reinterpret_cast<uint32_t*>(j.out + r * j.ldo + c) =
            pack_f32(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < j.m_lim)
        *reinterpret_cast<uint32_t*>(j.out + (r + 8) * j.ldo + c) =
            pack_f32(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// One R x kFK slab of an f32 view into s[kFK][R + 4] (i contiguous), out of
// range elements zero; consecutive threads walk the view's contiguous axis.
template <int R>
__device__ __forceinline__ void load_f32(float (*s)[R + 4], const float* p,
                                         long long si, long long sj,
                                         int i_lim, int k_lim) {
  for (int v = threadIdx.x; v < R * kFK; v += kFThreads) {
    int i, k;
    if (sj == 1) {
      i = v / kFK;
      k = v % kFK;
    } else {
      k = v / R;
      i = v % R;
    }
    s[k][i] = (i < i_lim && k < k_lim) ? p[i * si + k * sj] : 0.f;
  }
}

// f32 on CUDA cores: a 64 x 64 output tile per CTA, 4 x 4 per thread.
__global__ void __launch_bounds__(kFThreads) gmm_f32(GmmArgs g) {
  __shared__ float sA[kFK][kFB + 4];
  __shared__ float sB[kFK][kFB + 4];
  const Job<float> j = make_job<float, kFB, kFB>(g);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  Slabs<kFK> it;
  long long k0;
  int k_lim;
  while (it.next(g, j.e, j.skip, k0, k_lim)) {
    load_f32<kFB>(sA, j.a + k0 * g.a.sj, g.a.si, g.a.sj, j.m_lim, k_lim);
    load_f32<kFB>(sB, j.b + k0 * g.b.sj, g.b.si, g.b.sj, j.n_lim, k_lim);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = sA[k][ty * 4 + q];
        b[q] = sB[k][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ty * 4 + p, c = tx * 4 + q;
      if (r < j.m_lim && c < j.n_lim) j.out[r * j.ldo + c] = acc[p][q];
    }
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

int launch(const GmmArgs& g, int dtype, cudaStream_t st) {
  if (dtype == kF32) {
    const dim3 grid(cdiv(g.N, kFB),
                    g.dw ? cdiv(g.M, kFB) : g.n_tiles * cdiv(g.tm, kFB),
                    g.dw ? g.n_experts : 1);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32<<<grid, kFThreads, 0, st>>>(g);
  } else if (!g.dw && g.tm <= 16) {     // decode: a few rows per expert
    const dim3 grid(cdiv(g.N, 128), g.n_tiles);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (g.b.sj == 1)                    // w read transposed (dx)
      gmm_mma<16, 128, 1, 4, false, false><<<grid, 128, 0, st>>>(g);
    else
      gmm_mma<16, 128, 1, 4, false, true><<<grid, 128, 0, st>>>(g);
  } else {
    const dim3 grid(cdiv(g.N, 128),
                    g.dw ? cdiv(g.M, 128) : g.n_tiles * cdiv(g.tm, 128),
                    g.dw ? g.n_experts : 1);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (g.dw)                           // x and dy both read across rows
      gmm_mma<128, 128, 2, 4, true, true><<<grid, 256, 0, st>>>(g);
    else if (g.b.sj == 1)
      gmm_mma<128, 128, 2, 4, false, false><<<grid, 256, 0, st>>>(g);
    else
      gmm_mma<128, 128, 2, 4, false, true><<<grid, 256, 0, st>>>(g);
  }
  return cudaGetLastError();
}

bool args_ok(int n_tiles, int tm, int E, int K, int N, int dtype) {
  return n_tiles > 0 && tm > 0 && E > 0 && K > 0 && K % kBK == 0 && N > 0 &&
         N % 8 == 0 && (dtype == kF32 || dtype == kBF16);
}

}  // namespace

extern "C" {

// K6: x [n_tiles tm, K]; w [E, K, N] (w_trans 0) or [E, N, K] (w_trans 1);
// tile_expert [n_tiles] int32; out [n_tiles tm, N]; one dtype (0 f32, 1
// bf16), contiguous, 16-byte aligned. K a multiple of 32, N of 8. A tile
// whose expert id lies outside [0, E) gets zeros.
int gmm_fwd_launch(const void* x, const void* w, const int* tile_expert,
                   void* out, int n_tiles, int tm, int E, int K, int N,
                   int w_trans, int dtype, void* stream) {
  if (!args_ok(n_tiles, tm, E, K, N, dtype)) return cudaErrorInvalidValue;
  GmmArgs g{};
  g.a = View{x, K, 1};
  g.b = w_trans ? View{w, K, 1} : View{w, 1, N};
  g.out = out;
  g.tile_expert = tile_expert;
  g.b_se = (long long)K * N;
  g.n_tiles = n_tiles;
  g.tm = tm;
  g.n_experts = E;
  g.K = K;
  g.M = 0;
  g.N = N;
  g.dw = 0;
  return launch(g, dtype, static_cast<cudaStream_t>(stream));
}

// K6b's weight gradient: x [n_tiles tm, M] and dy [n_tiles tm, N] give dw
// [E, M, N] = sum over the table tiles t of expert e of x_t^T dy_t; one
// dtype, contiguous, 16-byte aligned; M and N multiples of 8.
int gmm_dw_launch(const void* x, const void* dy, const int* tile_expert,
                  void* dw, int n_tiles, int tm, int E, int M, int N,
                  int dtype, void* stream) {
  if (!args_ok(n_tiles, tm, E, kBK, N, dtype) || M <= 0 || M % 8 != 0)
    return cudaErrorInvalidValue;
  GmmArgs g{};
  g.a = View{x, 1, M};
  g.b = View{dy, 1, N};
  g.out = dw;
  g.tile_expert = tile_expert;
  g.b_se = 0;
  g.n_tiles = n_tiles;
  g.tm = tm;
  g.n_experts = E;
  g.K = 0;
  g.M = M;
  g.N = N;
  g.dw = 1;
  return launch(g, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
