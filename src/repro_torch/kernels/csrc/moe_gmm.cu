// Hand-written Hopper (sm_90a) kernels of the grouped (ragged) matmul of the
// MoE expert FFNs: the forward (K6) and its gradient (K6b).
//
//   K6  gmm_wgmma<kFwd> (bf16, tm > 16), gmm_mma (bf16 decode, tm <= 16),
//       gmm_tf32 (f32, tm > 16: split-TF32 mma.sync) and gmm_stream (f32
//       decode, tm <= 16: the weight streamed, exact f32 on CUDA cores)
//       replace the Pallas `gmm` / `_kernel` (src/repro/kernels/moe_gmm.py)
//       and, on the MoE paths, the three expert einsums of `moe_mlp`
//       (src/repro/models/moe.py)
//   K6b dx = dy w[e]^T (gmm_wgmma<kDx>, or gmm_mma at tm <= 16; f32:
//       gmm_tf32, or gmm_stream at tm <= 16; the weight read transposed, no
//       transposed copy) and dw[e] = x_e^T dy_e (gmm_wgmma<kDw>; f32:
//       gmm_tf32); the JAX package takes that gradient from XLA autodiff of
//       the einsums
//
// Layout. x [T, K] holds its rows in a table of tiles of tm rows: table tile
// t is rows [t tm, (t+1) tm) and belongs to expert tile_expert[t], an int32
// array on the device that every CTA reads for itself (the Pallas kernel's
// scalar prefetch). w is [E, K, N], or [E, N, K] read transposed; out [T, N]
// in x's dtype. tm is any positive size. In weight-gradient mode x [T, M]
// and dy [T, N] give dw [E, M, N].
//
// What bounds them on an H100 SXM (data sheet). Training (64 groups of 512
// rows, 2048 -> 1408) is 189 GFLOP a product against 0.6 GB moved:
// operations bound (0.19 ms at 989 TFLOP/s), so the bf16 kernels at tm > 16
// and dw run on wgmma, the only way to the card's full tensor-core rate, fed
// by TMA (gmm_wgmma, one template for the three products):
//   * Warp specialisation, one persistent CTA per SM (384 threads, 225 KB
//     of shared memory) walking 128 x 128 output tiles in a fixed order
//     (tile blockIdx.x, then every gridDim.x-th). Warpgroup 2 is the
//     producer: one thread issues every TMA load, 64-deep slabs of A and B
//     (32 KB) through a ring of 6 stages on full/empty mbarriers, running on
//     into the next tiles. Consumer warpgroups 0 and 1 take the CTA's tiles
//     in turn (ping-pong): each computes a whole tile (two m64n128k16
//     products a 16-deep step, one slab's group in flight behind the next),
//     and the main loops take turns on a pair of mbarriers, so one
//     warpgroup's epilogue runs beside the other's main loop.
//   * Operands land 128-byte swizzled and are read by wgmma's descriptors as
//     they lie in memory: x and dy rows K-major; w [E, K, N] in the forward,
//     and x^T and dy in dw, MN-major (the transpose immediates; B spans two
//     64-column slabs through LBO); w read as [E, N, K] for dx K-major. No
//     register round trip, no transposed copy.
//   * The epilogue rounds the f32 accumulators once to bf16 into a swizzled
//     staging buffer, 64 rows at a time, and one thread stores them with TMA.
//   * Tile edges by the tensor maps, not by masks: x, dy and out are seen as
//     3-D [n_tiles, tm, *] maps, dw as [E, M, N] and w as [E, K, N], so a
//     128-row box over a 4- or 200-row table tile reads zeros past the
//     tile's end (the next tile belongs to another expert), in the forward's
//     rows and in dw's depth alike, and the store clips rows past the tile
//     (or M); depths and columns past K or N read zeros and are not stored.
//   * Expert ids: the producer reads tile_expert[t] and uses it as the
//     weight map's expert coordinate. A tile whose id lies outside [0, E)
//     issues no load and stores zeros; in dw an expert without tiles stores
//     zeros.
//   * Determinism: each output element is one f32 sum in a fixed order
//     (the depth in order; dw walks its expert's table tiles in table
//     order, 64 rows a slab), rounded once to bf16. No atomics, no split
//     depth: two calls give the same bits.
// A decode step (tm = 4 rows per expert) reads every expert's weight once,
// E K N bf16 elements for a few rows of products: bytes bound
// (moonshot-v1-16b-a3b: 369 MB, 0.110 ms per product at 3.35 TB/s). Its
// variant (gmm_mma, BM = 16, 4 warps, a 16 x 128 output tile on mma.sync
// m16n8k16) keeps the wasted rows of the m16 products at 12 of 16 and many
// CTAs resident to keep the weight stream in flight; it stages 32-deep
// slabs in registers then shared memory, reading a [k][n] weight with
// ldmatrix.trans.
// f32 (see their sections below): a decode step's tiles stream the f32
// weight (738 MB, 0.22 ms at 3.35 TB/s) through a cp.async ring, each
// product an exact f32 fmaf (1.5 GFLOP: bandwidth sets the pace);
// training's tiles and every dw (3 x 189 GFLOP of tf32 products a product,
// 1.15 ms at the 495 TFLOP/s TF32 peak) run split TF32 on mma.sync, which
// holds the f32 rule where one tf32 product does not.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise). Tensor maps are encoded on the host for each call.

#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "tf32_tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 32;           // depth of one staged slab (decode path)

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

// The slabs of a CTA's depth, in order: forward, [0, K) in steps of BK;
// weight gradient, the rows of every table tile of its expert, in table
// order, each tile's last slab cut at its end. next() gives the slab's
// first depth and its length, or false past the last one.
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

// ---- bf16 decode (tm <= 16): mma.sync -----------------------------------

// A bf16 operand's slab in shared memory: R rows (i) by kBK depths, held
// as the view lies in memory so that every copy is a 16-byte vector: [i][k]
// (depth contiguous, KI false; fragments read in pairs) or [k][i] (KI
// true, the weight [E, K, N]; fragments read with ldmatrix.trans). The
// padding keeps the fragment reads of 8 rows on distinct banks.
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

// The A fragment (16 x 16, rows m0.., depths kk..) of an [m][k] slab
// (mma_common's layout).
template <int LD>
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4], const bf16* s,
                                            int m0, int kk, int lane) {
  const int gid = lane / 4, tig = lane % 4;
  const bf16* p = s + (m0 + gid) * LD + kk + 2 * tig;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * LD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * LD + 8);
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

// bf16 forward: a BM x BN output tile per CTA, WM x WN warps, each warp
// (BM / WM) x (BN / WN) as m16n8k16 products with f32 accumulators. B_KI:
// the weight's depth is strided in memory (its slab is held [k][n]). The
// next slab's loads are issued before the current one's products.
template <int BM, int BN, int WM, int WN, bool B_KI>
__global__ void __launch_bounds__(WM * WN * 32) gmm_mma(GmmArgs g) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM / WM / 16, TN = BN / WN / 8;
  static_assert(TN % 2 == 0, "B fragments come in pairs of 8-column tiles");
  using SA = Slab<BM, false, NT>;
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
        frag_a_bf16<SA::LD>(a[mt], sA, wm0 + mt * 16, kk, lane);
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

// ---- bf16 at tm > 16 and dw: wgmma + TMA, warp-specialised, persistent ---

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

constexpr int kWgThreads = 384;   // 2 consumer warpgroups + a producer one
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg
constexpr int kBM = 128;          // output rows of a tile
constexpr int kBN = 128;          // output columns of a tile
constexpr int kSlab = 64;         // depth of one staged slab
constexpr int kStages = 6;        // ring depth
constexpr int kABytes = kBM * 128;                 // A: 128 x 64 bf16
constexpr int kBBytes = kBN * 128;                 // B: kBN x 64 bf16
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kEpiBytes = 64 * kBN * 2;            // 64 rows of a tile
constexpr int kWgSmem =
    1024 + kStages * kStageBytes + 2 * kEpiBytes + 8 * (2 * kStages + 2);

// The grid's walk. Forward and dx: the output tiles of table tile t,
// column tile c and row sub-tile s (rows [128 s, 128 s + 128) of the
// tile), s fastest, so neighbouring CTAs share the weight slab; dw: expert
// e, row tile s of M and column tile c, c fastest, so neighbouring CTAs
// share the x slab.
struct WgArgs {
  void* out;
  const int* tile_expert;
  int n_tiles, tm, n_experts;
  int depth;                      // forward and dx: the product's depth
  int rows;                       // dw: M, the rows of each expert's dw
  int cols;                       // the output's width
  int n_sub, n_col, n_work;
};

struct Work {
  int t;                          // table tile (forward, dx) or expert (dw)
  int m0, n0;                     // the tile's first row and column
};

template <int MODE>
__device__ __forceinline__ Work work_of(const WgArgs& g, int w) {
  Work k;
  if (MODE != kDw) {
    k.m0 = (w % g.n_sub) * kBM;
    w /= g.n_sub;
    k.n0 = (w % g.n_col) * kBN;
    k.t = w / g.n_col;
  } else {
    k.n0 = (w % g.n_col) * kBN;
    w /= g.n_col;
    k.m0 = (w % g.n_sub) * kBM;
    k.t = w / g.n_sub;
  }
  return k;
}

// The number of 64-deep slabs of work k, counted alike by the producer
// and the consumers: the depth's (0 for a tile whose expert id lies
// outside [0, E)), or in dw 64-row slabs of each table tile of the
// expert. `cache` keeps the last dw expert (x), its slab count (y) and its
// first table tile (z): consecutive dw tiles share their expert.
template <int MODE>
__device__ __forceinline__ int slabs_of(const WgArgs& g, const Work& k,
                                        int3& cache) {
  if (MODE != kDw) {
    const int e = g.tile_expert[k.t];
    return e < 0 || e >= g.n_experts ? 0 : (g.depth + kSlab - 1) / kSlab;
  }
  if (cache.x != k.t) {
    int n = 0, first = g.n_tiles;
    for (int t = g.n_tiles - 1; t >= 0; --t)
      if (g.tile_expert[t] == k.t) {
        ++n;
        first = t;
      }
    cache = make_int3(k.t, n * ((g.tm + kSlab - 1) / kSlab), first);
  }
  return cache.y;
}

// The shared-memory descriptors of k16 step kk of a staged slab, for rows
// [64 h, 64 h + 64) of the tile. A: forward and dx, rows of x or dy K-major
// (64 of the slab's 128 rows of 128 bytes); dw, x^T MN-major (64 columns
// of M, one slab of 64 depth rows). B: forward and dw, MN-major
// over kBN / 64 slabs of 64 depth rows (LBO: the slab stride); dx, the
// weight's kBN rows K-major.
template <int MODE>
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int h, int kk) {
  return MODE == kDw
             ? gmma_desc(a + h * 8192 + kk * 2048, 8192, 1024, kSw128)
             : gmma_desc(a + h * 8192 + kk * 32, 16, 1024, kSw128);
}

template <int MODE>
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  return MODE == kDx ? gmma_desc(b + kk * 32, 16, 1024, kSw128)
                     : gmma_desc(b + kk * 2048, 8192, 1024, kSw128);
}

// One CTA per SM walking output tiles (see the file's note). Maps: ta over
// A (forward and dx: x or dy as [n_tiles, tm, depth], boxes of 128 rows;
// dw: x as [n_tiles, tm, M], boxes of 64 rows), tb over B (forward: w
// [E, K, N], boxes of 64 rows of K; dx: w as [E, K rows, N depth], boxes
// of kBN rows; dw: dy as [n_tiles, tm, N], boxes of 64 rows), to over the
// output (forward and dx: [n_tiles, tm, cols]; dw: [E, M, N]), boxes of
// 64 rows.
template <int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap to, WgArgs g) {
  extern __shared__ uint8_t gmm_smem[];
  uint8_t* ring = gmm_smem + ((1024 - (smem_u32(gmm_smem) & 1023)) & 1023);
  uint8_t* epi = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * kEpiBytes);
  uint64_t* empty = full + kStages;
  uint64_t* done = empty + kStages;  // a warpgroup's main loop has ended
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&done[0], 128);
    mbar_init(&done[1], 128);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle: provably warp-uniform, as the
  // branches around setmaxnreg must be
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 256) return;
    uint32_t it = 0;
    int3 cache = make_int3(-1, 0, 0);
    for (int w = blockIdx.x; w < g.n_work; w += gridDim.x) {
      const Work k = work_of<MODE>(g, w);
      const int ns = slabs_of<MODE>(g, k, cache);
      int t = cache.z, r0 = 0;    // dw: the table tile and row of a slab
      for (int s = 0; s < ns; ++s, ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* a = ring + st * kStageBytes;
        uint8_t* b = a + kABytes;
        mbar_expect_tx(&full[st], kStageBytes);
        if (MODE != kDw) {
          const int d0 = s * kSlab, e = g.tile_expert[k.t];
          tma_load_3d(a, &ta, &full[st], d0, k.m0, k.t);
          if (MODE == kFwd) {
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)
              tma_load_3d(b + c * 8192, &tb, &full[st], k.n0 + 64 * c, d0,
                          e);
          } else {
            tma_load_3d(b, &tb, &full[st], d0, k.n0, e);
          }
        } else {
          if (r0 >= g.tm) {       // the expert's next table tile
            do ++t; while (g.tile_expert[t] != k.t);
            r0 = 0;
          }
          tma_load_3d(a, &ta, &full[st], k.m0, r0, t);
          tma_load_3d(a + 8192, &ta, &full[st], k.m0 + 64, r0, t);
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c)
            tma_load_3d(b + c * 8192, &tb, &full[st], k.n0 + 64 * c, r0, t);
          r0 += kSlab;
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int cw = wg, t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32, gid = lane / 4,
              tig = lane % 4;
    constexpr int TA = MODE == kDw, TB = MODE != kDx;
    uint8_t* eb = epi + cw * kEpiBytes;   // this warpgroup's staging buffer
    uint32_t it = 0;                      // the ring's slab count
    uint32_t n = 0;                       // this warpgroup's tiles so far
    int3 cache = make_int3(-1, 0, 0);
    for (int w = blockIdx.x, i = 0; w < g.n_work; w += gridDim.x, ++i) {
      const Work k = work_of<MODE>(g, w);
      const int ns = slabs_of<MODE>(g, k, cache);
      if ((i & 1) != cw) {                // the other warpgroup's tile
        it += ns;
        continue;
      }
      // The main loops take turns in tile order: this one starts when the
      // previous tile's (the other warpgroup's) has waited for all its
      // slabs, so every slab before this tile's has landed and a full
      // barrier's parity names one phase; the other's epilogue then runs
      // beside this main loop.
      if (i > 0) mbar_wait(&done[cw ^ 1], (cw == 0 ? n - 1 : n) & 1);
      float acc[2][kBN / 2];              // rows 0-63 and 64-127
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < kBN / 2; ++q) acc[h][q] = 0.f;
      for (int s = 0; s < ns; ++s, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint32_t a = smem_u32(ring + st * kStageBytes);
        const uint32_t b = a + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk) {
          const uint64_t db = desc_b<MODE>(b, kk);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_ss_n128<TA, TB>(acc[h], desc_a<MODE>(a, h, kk), db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();          // the previous slab's products are done
        if (s > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      mbar_arrive(&done[cw]);
      ++n;
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (ns > 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // The epilogue, 64 rows at a time: rounded once to bf16 into the
      // warpgroup's staging buffer as the store map's boxes lie (kBN / 64
      // slabs of 64 rows of 128 bytes, 128-byte swizzled: chunk j % 8 of
      // row r at chunk (j % 8) ^ (r % 8), r % 8 = gid), then one thread
      // stores them with TMA, while the other warpgroup computes. The map
      // clips rows past the table tile (or M) and columns past the width.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t128 == 0) bulk_wait_read<0>();   // the last store has read eb
        named_bar_sync(1 + cw, 128);
        uint8_t* row = eb + (16 * warp + gid) * 128 + 4 * tig;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          uint8_t* p = row + (j / 8) * 8192 + (((j % 8) ^ gid) << 4);
          *reinterpret_cast<uint32_t*>(p) =
              pack_f32(acc[h][4 * j], acc[h][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(p + 8 * 128) =
              pack_f32(acc[h][4 * j + 2], acc[h][4 * j + 3]);
        }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
        if (t128 == 0) {
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c)
            tma_store_3d(&to, eb + c * 8192, k.n0 + 64 * c, k.m0 + 64 * h,
                         k.t);
          bulk_commit();
        }
      }
    }
    if (t128 == 0) bulk_wait<0>();
  }
}

// ---- f32 decode (tm <= 16): the weight streamed, exact f32 on CUDA cores --

constexpr int kSThreads = 256;    // 8 warps
constexpr int kSBN = 128;         // columns of a CTA
constexpr int kSBK = 32;          // depth of a stage
constexpr int kSStages = 4;       // ring depth: 3 stages in flight
constexpr int kSLd = kSBK + 4;    // pitch of an [i][k] slab, in floats

// A stage of the ring: the weight's slab (kSBK x kSBN) as it lies in
// memory, [k][n] (B_KI) or [n][k] padded, then the x rows' [r][k] slab.
template <bool B_KI>
struct StreamStage {
  static constexpr int kW = B_KI ? kSBK * kSBN : kSBN * kSLd;
  static constexpr int kFloats = kW + 16 * kSLd;
  static constexpr int kSmem = kSStages * kFloats * 4;
};

// The columns of lane l: four neighbours from 4 l where the slab is [k][n]
// (one float4 read a depth), l + 32 c where it is [n][k] (then the lanes
// of a quarter-warp read 16-byte pieces on distinct banks).
template <bool B_KI>
__device__ __forceinline__ int stream_col(int lane, int c) {
  return B_KI ? 4 * lane + c : lane + 32 * c;
}

// K6 (and K6b's dx, the weight read transposed) for a table tile of at
// most R rows: a CTA takes one tile and kSBN columns, and streams the
// weight's K x kSBN slab (with the tile's rows beside it) through a ring
// of kSStages stages of 16-byte cp.async copies. Warp w takes depths [4 w,
// 4 w + 4) of each stage, a lane four columns by R rows in registers, each
// product an fmaf in f32: the warps' sums are added at the end in warp
// order. Rows past the tile, and every row of a tile whose expert id lies
// outside [0, E), come out zero or are not stored.
template <int R, bool B_KI>
__global__ void __launch_bounds__(kSThreads, 2) gmm_stream(GmmArgs g) {
  using St = StreamStage<B_KI>;
  extern __shared__ __align__(16) float smem[];
  const Job<float> j = make_job<float, 16, kSBN>(g);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_slabs = j.skip ? 0 : g.K / kSBK;

  auto fetch = [&](int i) {
    float* sw = smem + (i % kSStages) * St::kFloats;
    float* sx = sw + St::kW;
    const long long k0 = (long long)i * kSBK;
#pragma unroll
    for (int q = 0; q < kSBK * kSBN / 4 / kSThreads; ++q) {
      const int v = tid + q * kSThreads;
      int n, k;
      float* dst;
      const float* src;
      if (B_KI) {                 // w [k][n]: 32 vectors a depth
        k = v / (kSBN / 4);
        n = (v % (kSBN / 4)) * 4;
        dst = sw + k * kSBN + n;
      } else {                    // w [n][k]: 8 vectors a column
        n = v / (kSBK / 4);
        k = (v % (kSBK / 4)) * 4;
        dst = sw + n * kSLd + k;
      }
      src = j.b + n * g.b.si + (k0 + k) * g.b.sj;
      const bool ok = n < j.n_lim;
      cp_async16(dst, ok ? src : j.b, ok);
    }
    if (tid < R * (kSBK / 4)) {   // x [r][k]
      const int r = tid / (kSBK / 4), k = (tid % (kSBK / 4)) * 4;
      const bool ok = r < j.m_lim;
      cp_async16(sx + r * kSLd + k, ok ? j.a + r * g.a.si + k0 + k : j.a,
                 ok);
    }
  };

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int i = 0; i < kSStages - 1; ++i) {
    if (i < n_slabs) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<kSStages - 2>();   // slab i has landed
    __syncthreads();                 // and slab i - 1's stage is free
    if (i + kSStages - 1 < n_slabs) fetch(i + kSStages - 1);
    cp_async_commit();
    const float* sw = smem + (i % kSStages) * St::kFloats;
    const float* sx = sw + St::kW;
    float4 b[4];                     // B_KI: b[kk] is depth 4 w + kk of
#pragma unroll                       // the four columns; else b[c] is
    for (int q = 0; q < 4; ++q)      // column c's four depths
      b[q] = B_KI ? *reinterpret_cast<const float4*>(
                        sw + (4 * warp + q) * kSBN + 4 * lane)
                  : *reinterpret_cast<const float4*>(
                        sw + stream_col<false>(lane, q) * kSLd + 4 * warp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(sx + r * kSLd +
                                                        4 * warp);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4& bq = b[B_KI ? kk : c];
          const float bs[4] = {bq.x, bq.y, bq.z, bq.w};
          acc[r][c] = fmaf(xs[kk], bs[B_KI ? c : kk], acc[r][c]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums, added in warp order
  float* red = smem;                 // [warp][r][kSBN]
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(warp * R + r) * kSBN + stream_col<B_KI>(lane, c)] = acc[r][c];
  __syncthreads();
  for (int o = tid; o < R * kSBN; o += kSThreads) {
    const int r = o / kSBN, n = o % kSBN;
    float v = red[o];
#pragma unroll
    for (int w = 1; w < kSThreads / 32; ++w) v += red[w * R * kSBN + o];
    if (r < j.m_lim && n < j.n_lim) j.out[r * j.ldo + n] = v;
  }
}

// ---- f32 tiles (tm > 16, and dw): split-TF32 mma.sync on tensor cores ----
//
// wgmma's tf32 form reads only K-major operands from shared memory, and the
// forward's weight [K, N] and dw's x (x^T as A) lie MN-major, so these run
// on mma.sync m16n8k8, which takes fragments from registers in any layout.
// Each product is a_hi b_hi + a_hi b_lo + a_lo b_hi (tf32_tiles.cuh's split
// and mma3: each part rounded to tf32, a fresh f32 sum a depth step added
// to the accumulator), about 22 of f32's 24 bits where one tf32 product
// keeps 11.

constexpr int kTThreads = 256;    // 8 warps: 4 (rows) x 2 (columns)
constexpr int kTB = 128;          // a CTA's output tile: 128 x 128
constexpr int kTBK = 32;          // depth of a stage
constexpr int kTStages = 3;
constexpr int kTLdK = kTBK + 4;   // pitch of an [i][k] slab (36)
constexpr int kTLdI = kTB + 8;    // pitch of a [k][i] slab (136)
constexpr int kTSlab = kTB * kTLdK;           // floats, the larger layout
constexpr int kTSmem = kTStages * 2 * kTSlab * 4;

// One operand's kTB x kTBK slab, element (i, k) at p[i si + k sj], into
// shared memory as it lies: [k][i] pitch kTLdI where i is contiguous (MN),
// else [i][k] pitch kTLdK; rows i >= i_lim and depths k >= k_lim zero
// (i_lim a multiple of 4 for MN). The pitches put the 32 lanes of every
// fragment read on distinct banks.
template <bool MN>
__device__ __forceinline__ void tile_slab(float* s, const float* p,
                                          long long si, long long sj,
                                          int i_lim, int k_lim) {
#pragma unroll
  for (int q = 0; q < kTB * kTBK / 4 / kTThreads; ++q) {
    const int v = threadIdx.x + q * kTThreads;
    int i, k;
    float* dst;
    if (MN) {
      k = v / (kTB / 4);
      i = (v % (kTB / 4)) * 4;
      dst = s + k * kTLdI + i;
    } else {
      i = v / (kTBK / 4);
      k = (v % (kTBK / 4)) * 4;
      dst = s + i * kTLdK + k;
    }
    const bool ok = i < i_lim && k < k_lim;
    cp_async16(dst, ok ? p + i * si + k * sj : p, ok);
  }
}

template <bool MN>
__device__ __forceinline__ float tile_at(const float* s, int i, int k) {
  return MN ? s[k * kTLdI + i] : s[i * kTLdK + k];
}

// out tile = A B^T over the CTA's slabs (make_job, Slabs): A (m, k) is x or
// dy (forward, dx; [i][k]) or x^T (dw; A_MN), B (n, k) is w [K, N] (forward,
// B_MN), w [N, K] (dx) or dy^T (dw, B_MN). Warp (wm, wn) computes rows
// [32 wm, 32 wm + 32) and columns [64 wn, 64 wn + 64): two 16-row strips by
// eight 8-column tiles, each A fragment split once for its eight products
// and each B fragment once for its two. Two slabs are in flight while a
// third is in the products.
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kTThreads, 2) gmm_tf32(GmmArgs g) {
  extern __shared__ __align__(16) float smem[];
  const Job<float> j = make_job<float, kTB, kTB>(g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / 2) * 32, wn0 = (warp % 2) * 64;
  Slabs<kTBK> it;
  int fetched = 0;
  auto fetch = [&]() {
    long long at;
    int len;
    if (!it.next(g, j.e, j.skip, at, len)) return;
    float* sa = smem + (fetched % kTStages) * 2 * kTSlab;
    tile_slab<A_MN>(sa, j.a + at * g.a.sj, g.a.si, g.a.sj, j.m_lim, len);
    tile_slab<B_MN>(sa + kTSlab, j.b + at * g.b.sj, g.b.si, g.b.sj, j.n_lim,
                    len);
    ++fetched;
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    fetch();
    cp_async_commit();
  }
  for (int i = 0; i < fetched; ++i) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();
    fetch();
    cp_async_commit();
    const float* sa = smem + (i % kTStages) * 2 * kTSlab;
    const float* sb = sa + kTSlab;
#pragma unroll
    for (int ks = 0; ks < kTBK / 8; ++ks) {
      const int k0 = 8 * ks + tig;
      FragA fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm0 + 16 * mt + gid;
        fa[mt] = frag_a(tile_at<A_MN>(sa, r, k0),
                        tile_at<A_MN>(sa, r + 8, k0),
                        tile_at<A_MN>(sa, r, k0 + 4),
                        tile_at<A_MN>(sa, r + 8, k0 + 4));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = wn0 + 8 * nt + gid;
        const Split b0 = split(tile_at<B_MN>(sb, n, k0));
        const Split b1 = split(tile_at<B_MN>(sb, n, k0 + 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3<false, false>(acc[mt][nt], fa[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int r = wm0 + 16 * mt + gid, c = wn0 + 8 * nt + 2 * tig;
      if (c >= j.n_lim) continue;
      if (r < j.m_lim)
        *reinterpret_cast<float2*>(j.out + r * j.ldo + c) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < j.m_lim)
        *reinterpret_cast<float2*>(j.out + (r + 8) * j.ldo + c) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---- host -----------------------------------------------------------------

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// gmm_wgmma<MODE> over maps already encoded: one CTA per SM, or per tile
// where there are fewer.
template <int MODE>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, WgArgs g,
                 cudaStream_t st) {
  g.n_col = cdiv(g.cols, kBN);
  g.n_sub = cdiv(MODE == kDw ? g.rows : g.tm, kBM);
  const int outer = MODE == kDw ? g.n_experts : g.n_tiles;
  const long long work = (long long)outer * g.n_sub * g.n_col;
  const int sms = sm_count();
  if (work > 0x7fffffff || sms == 0) return cudaErrorInvalidValue;
  g.n_work = (int)work;
  CUtensorMap to;
  cudaError_t e = encode_bf16_3d_map(&to, g.out, g.cols,
                                     MODE == kDw ? g.rows : g.tm, outer, 64);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gmm_wgmma<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgSmem);
  if (e != cudaSuccess) return e;
  gmm_wgmma<MODE><<<min(g.n_work, sms), kWgThreads, kWgSmem, st>>>(ta, tb,
                                                                    to, g);
  return cudaGetLastError();
}

static_assert(kSThreads == kTThreads, "one block size for the f32 kernels");

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, dim3 grid, int smem, const GmmArgs& g,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kSThreads, smem, st>>>(g);
  return cudaGetLastError();
}

// f32 decode (tm <= 16): the streaming kernel at the fewest rows that hold
// the tile (4, 8 or 16), w [K, N] or read transposed.
template <bool B_KI>
cudaError_t launch_stream(const GmmArgs& g, cudaStream_t st) {
  const dim3 grid(cdiv(g.N, kSBN), g.n_tiles);
  const int smem = StreamStage<B_KI>::kSmem;
  if (g.tm <= 4) return launch_f32(gmm_stream<4, B_KI>, grid, smem, g, st);
  if (g.tm <= 8) return launch_f32(gmm_stream<8, B_KI>, grid, smem, g, st);
  return launch_f32(gmm_stream<16, B_KI>, grid, smem, g, st);
}

int launch(const GmmArgs& g, int dtype, cudaStream_t st) {
  const bool w_trans = g.b.sj == 1;     // the weight read transposed (dx)
  if (dtype == kF32) {
    if (!g.dw && g.tm <= 16)
      return w_trans ? launch_stream<false>(g, st)
                     : launch_stream<true>(g, st);
    const dim3 grid(cdiv(g.N, kTB),
                    g.dw ? cdiv(g.M, kTB) : g.n_tiles * cdiv(g.tm, kTB),
                    g.dw ? g.n_experts : 1);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if (g.dw) return launch_f32(gmm_tf32<true, true>, grid, kTSmem, g, st);
    return w_trans ? launch_f32(gmm_tf32<false, false>, grid, kTSmem, g, st)
                   : launch_f32(gmm_tf32<false, true>, grid, kTSmem, g, st);
  }
  // bf16 decode: a few rows per expert
  const dim3 grid(cdiv(g.N, 128), g.n_tiles);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (w_trans)
    gmm_mma<16, 128, 1, 4, false><<<grid, 128, 0, st>>>(g);
  else
    gmm_mma<16, 128, 1, 4, true><<<grid, 128, 0, st>>>(g);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && tm > 16) {
    CUtensorMap ta, tb;
    cudaError_t e = encode_bf16_3d_map(&ta, x, K, tm, n_tiles, kBM);
    if (e == cudaSuccess)
      e = w_trans ? encode_bf16_3d_map(&tb, w, K, N, E, kBN)
                  : encode_bf16_3d_map(&tb, w, N, K, E, kSlab);
    if (e != cudaSuccess) return e;
    const WgArgs g{out, tile_expert, n_tiles, tm, E, K, 0, N, 0, 0, 0};
    return w_trans ? launch_wgmma<kDx>(ta, tb, g, st)
                   : launch_wgmma<kFwd>(ta, tb, g, st);
  }
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
  return launch(g, dtype, st);
}

// K6b's weight gradient: x [n_tiles tm, M] and dy [n_tiles tm, N] give dw
// [E, M, N] = sum over the table tiles t of expert e of x_t^T dy_t; one
// dtype, contiguous, 16-byte aligned; M and N multiples of 8.
int gmm_dw_launch(const void* x, const void* dy, const int* tile_expert,
                  void* dw, int n_tiles, int tm, int E, int M, int N,
                  int dtype, void* stream) {
  if (!args_ok(n_tiles, tm, E, kBK, N, dtype) || M <= 0 || M % 8 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    CUtensorMap ta, tb;
    cudaError_t e = encode_bf16_3d_map(&ta, x, M, tm, n_tiles, kSlab);
    if (e == cudaSuccess)
      e = encode_bf16_3d_map(&tb, dy, N, tm, n_tiles, kSlab);
    if (e != cudaSuccess) return e;
    const WgArgs g{dw, tile_expert, n_tiles, tm, E, 0, M, N, 0, 0, 0};
    return launch_wgmma<kDw>(ta, tb, g, st);
  }
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
  return launch(g, dtype, st);
}

}  // extern "C"
