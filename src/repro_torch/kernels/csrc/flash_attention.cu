// Hand-written Hopper (sm_90a) kernels of the no-cache attention: the flash
// attention forward (K3a) and backward (K3b).
//
//   fa_fwd_wgmma / fa_fwd_tf32     replace the Pallas `flash_attention_fwd` /
//                                  `_fwd_kernel`
//   fa_delta, fa_dq_wgmma,         replace `flash_attention_bwd` /
//   fa_dkv_wgmma / fa_dq_tf32,     `_dq_kernel`, `_dkv_kernel`, and (bf16)
//   fa_dkv_tf32 (+ fa_dkv_reduce)  the delta = rowsum(do * o) it takes
//                                  (src/repro/kernels/flash_attention.py)
//
// and on the training and prefill paths the XLA `flash_attention_xla` of
// the no-cache branch of `attention` (src/repro/models/layers.py).
//
// Layout: the path's own, read and written through row strides with no
// transpose: q, o, do, dq [B, Sq, H, hd]; k, v, dk, dv [B, Skv, KV, hd];
// lse [B, H, Sq] f32. Query head h reads KV head h / G, G = H / KV. Causal
// masking keeps key j for query i when i >= j (Sq == Skv; the wrapper
// refuses causal attention with Sq != Skv). Every position is covered: a
// tile that runs past Sq or Skv is zero-filled by TMA and masked (the Pallas
// grids take Sq // 128 and Skv // 128 tiles and leave the rest unwritten).
//
// What bounds them: operations. A causal forward does 2 * B * H * S^2 * hd
// FLOPs (two products over half the score matrix) for 2 * B * S * (H + KV)
// * hd elements read and written, hundreds of FLOPs per byte; the backward
// needs five products, 5 * B * H * S^2 * hd. So the score matrix stays out
// of device memory and, in bf16 (the path's compute dtype), every product
// runs on wgmma, the only way to the card's full tensor-core rate:
// bf16 (below; the f32 kernels' design is at their section):
//   * Warp specialisation, one CTA per SM (384 threads, 100-165 KB of
//     shared memory; at hd 32 two CTAs of 256 threads, below). The last
//     warpgroup is the producer: it gives up its registers (setmaxnreg 24)
//     and one of its threads issues every TMA load, the CTA's own tile
//     once, then the streamed operand through a ring of kStages stages on
//     full/empty mbarriers, so the next tile lands while this one's
//     products run. Consumer warpgroups 0 and 1 (setmaxnreg 240) own 64
//     rows each of the CTA's 128 and issue the products; two warpgroups on
//     one SM overlap one's softmax with the other's wgmma.
//   * Operands come from TMA as column slabs swizzled for wgmma
//     (hopper_common.cuh) and are read K-major for the score products and
//     MN-major for the products over keys or queries (the descriptor's
//     transpose): no scalar loads, no transposed copy. p and dS go from the
//     accumulator fragment to A-operand registers.
//   * K3a (fa_fwd_wgmma): a CTA per 128 query rows and head, K and V tiles
//     of fwd_keys streamed; the online softmax in registers in the log2
//     domain (each exponent one fma of a raw score, scale * log2 e and the
//     running max; ex2.approx.ftz, exp2f's fix-up for results under 2^-126
//     left out), f32 max, sum (both as trees) and lse.
//   * K3b is three launches, each sum in a fixed order (no atomics: two
//     calls give the same bits): fa_delta (delta from one read of o and do,
//     and lse * log2 e, into rows padded to 128 so that the tiles read no
//     tail); fa_dq_wgmma (a CTA per 128 query rows and head, 64-key
//     K/V tiles streamed: S, dP, dq += dS K); fa_dkv_wgmma (a CTA per 128
//     keys and query head, H x Skv / 128 CTAs, 64-row Q/dO/lse/delta tiles
//     streamed: S^T, dP^T, dv += P^T dO, dk += dS^T Q). dq recomputes S and
//     dP so that no launch sums across CTAs; with G > 1, fa_dkv_reduce sums
//     the G heads' f32 partials into bf16 dk and dv.
//   * Registers: the consumers hold 64 x hd f32 accumulators beside the
//     score tiles. Where ptxas spilled and serialised the wgmmas (it
//     reported 168 registers, whatever setmaxnreg's 240), the tiles
//     shrink: 64-key forward tiles at hd 128, and dk/dv at hd 128 in two
//     passes over the query tiles (dv, then dk; S^T twice). At hd 32 a
//     thread has at most 128 (two CTAs an SM; no setmaxnreg there), which
//     ptxas fits without spilling.
//   * Causal: key tiles past the diagonal are not loaded (the Pallas `live`
//     predicate), only tiles that cross the diagonal or the end of the keys
//     are masked, and the grid starts with the longest tiles (query tiles
//     nearest the end in the forward and dq, key tile 0 in dk/dv).
//   * Rounding: p to bf16 once for PV and for dv, dS once for dq and dk,
//     relative to the running max in the forward; everything else f32.
//   * hd 80: a 160-byte row is wider than one 128-byte swizzle span, so a
//     tile is a 64-column slab (128-byte swizzle) and a 16-column slab
//     (32-byte swizzle, its own tensor map), each read by its own
//     descriptors: one 16-deep step and an m64n16 product more, no padding.
//   * hd 32 (the reduced configs): a 64-byte row fits no 128-byte swizzle
//     span, so a tile is two of hd 80's 16-column slabs, each 32-byte
//     swizzled: the score products take one 16-deep step from each, the
//     products over keys or queries an m64n16 product into each. This
//     rather than one 32-column slab under the 64-byte swizzle: the 32-byte
//     slab's descriptors, K-major and MN-major, already run at hd 80, and at
//     hd 32 the tensor cores are not what sets the pace. A 128 x 128 tile
//     of scores is 2 x 2 k16 products (0.26 M MACs, ~130 clocks of an SM's
//     tensor cores) against 16 K exponentials (1 K clocks of its SFUs at 16
//     a clock) and the softmax's arithmetic beside them: the exponentials
//     and the latency of each warpgroup's serial chain (S, softmax, P V)
//     bound the kernels, and the longest CTA's walk bounds a causal call's
//     time (the forward's last query tile over all Skv keys). So at hd 32 a
//     CTA is one consumer warpgroup of 64 rows (queries, or keys in dk/dv)
//     and a producer, two CTAs an SM (consumers<HD>): twice the CTAs, each
//     walking half the rows, and an SM's two consumers step through their
//     tiles independently. Measured on an H100 at B 1, H 4, KV 2, S 4096
//     causal (`experiments/torch_ssd_compare.py --phase 6`, each pair in
//     one call): K3a 0.0484 ms with 128-row CTAs against 0.0398 with 64-row
//     ones, K3b 0.1365 against 0.1103. The forward keeps 128-key tiles
//     (64-key ones were slower); dq and dk/dv keep 64 (kDqKeys, kDkvRows).
//   * f32 runs its products on the tensor cores too, as split TF32 on
//     mma.sync (fa_fwd_tf32, fa_dq_tf32, fa_dkv_tf32 over tf32_tiles.cuh;
//     their section below), but for dq's dP where p >= 1/32, summed again
//     on the CUDA cores; delta comes from the wrapper, summed as the plain
//     version sums it.
// Not done yet: overlap of a warpgroup's softmax with its own next product
// (issuing the next S before this tile's P V made ptxas serialise every
// wgmma, C7514, and the forward slower), TMA stores of the outputs, a
// persistent grid, fp8.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise). Tensor maps are encoded on the host for each call.

#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "tf32_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool keep(int key, int row, int Skv, int causal) {
  return key < Skv && (!causal || key <= row);
}

// ---- bf16: wgmma + TMA, warp-specialised ------------------------------------

constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg
// dq: keys per streamed tile; dk/dv: query rows per streamed tile. 64 at
// every head dim: at hd 32, 128 (S beside dP at 64 registers each) spilled
// 96 and 288 bytes under the 168 registers ptxas gave a consumer of a
// 128-row CTA, and dk/dv ran 1.6x slower than at 64
constexpr int kDqKeys = 64;
constexpr int kDkvRows = 64;
constexpr int kStages = 2;       // ring depth of every streamed operand
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Columns of an hd-wide bf16 row as shared-memory slabs (hopper_common.cuh):
// kFull slabs of 64, 128-byte swizzled, then kTails slabs of 16, 32-byte
// swizzled (one at hd 80, two at hd 32).
template <int HD>
struct Cols {
  static constexpr int kFull = HD / 64;
  static constexpr int kTails = HD % 64 / 16;
  static_assert(HD % 64 == 0 || HD == 80 || HD == 32,
                "head_dim 32, 64, 80 or 128");
};

// Consumer warpgroups a CTA, each owning 64 rows: query rows in the
// forward and dq, keys in dk/dv. Two (128 rows, one CTA an SM, 384 threads
// with a producer warpgroup) but at hd 32: there one, and two CTAs an SM,
// so that a causal grid has twice the CTAs, each walking half the rows
// over the same keys or queries (the longest CTA's walk sets the call's
// time), and an SM's two consumers step through their tiles independently,
// not in lockstep on one CTA's barriers. Its registers: up to 65536 / (2 x
// 256) = 128 a thread, with no setmaxnreg (an increase the pool cannot meet
// would wait forever).
template <int HD>
__host__ __device__ constexpr int consumers() {
  return HD == 32 ? 1 : 2;
}

template <int HD>
__host__ __device__ constexpr int cta_threads() {
  return 128 * (consumers<HD>() + 1);
}

// forward: keys per streamed tile. 64 at hd 128, where a 128-key score
// tile (64 registers a thread) beside the 64 x 128 accumulator made ptxas
// spill and serialise the wgmmas; 128, the widest score product, elsewhere.
template <int HD>
__host__ __device__ constexpr int fwd_keys() {
  return HD == 128 ? 64 : 128;
}


template <int HD, int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * HD * 2;
}

// f32 accumulator of a 64 x HD product, per slab (the m64n64 fragment) and
// per tail slab (m64n16). An array a head dim has no slab for is never
// touched (its one row only keeps the type legal).
template <int HD>
struct AccHD {
  float s[Cols<HD>::kFull > 0 ? Cols<HD>::kFull : 1][32];
  float t[Cols<HD>::kTails > 0 ? Cols<HD>::kTails : 1][8];
};

template <int HD>
__device__ __forceinline__ void zero(AccHD<HD>& a) {
#pragma unroll
  for (int s = 0; s < Cols<HD>::kFull; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) a.s[s][i] = 0.f;
#pragma unroll
  for (int j = 0; j < Cols<HD>::kTails; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) a.t[j][i] = 0.f;
}

template <int HD>
__device__ __forceinline__ void fence_acc(AccHD<HD>& a) {
#pragma unroll
  for (int s = 0; s < Cols<HD>::kFull; ++s) fence_regs(a.s[s]);
#pragma unroll
  for (int j = 0; j < Cols<HD>::kTails; ++j) fence_regs(a.t[j]);
}

// Every accumulator element times `c_lo` (fragment rows lo) or `c_hi`.
template <int HD>
__device__ __forceinline__ void scale_rows(AccHD<HD>& a, float c_lo,
                                           float c_hi) {
#pragma unroll
  for (int s = 0; s < Cols<HD>::kFull; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) a.s[s][i] *= (i & 2) ? c_hi : c_lo;
#pragma unroll
  for (int j = 0; j < Cols<HD>::kTails; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) a.t[j][i] *= (i & 2) ? c_hi : c_lo;
}

// Element (i of the m64n64 fragment, slab s) of an AccHD -> its column.
__device__ __forceinline__ int frag_col(int i, int tig) {
  return 8 * (i / 4) + 2 * tig + (i & 1);
}

// 2^x on the special-function unit alone: ex2.approx.ftz, whose result
// below 2^-126 is 0 (no weight p needs one), without the range fix-up
// (a compare and two multiplies) that exp2f wraps around it.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The largest (kMax) or the sum of a score fragment's elements in row lo
// (i & 2 == 0) and in row hi, as a tree: a chain of N / 2 dependent
// operations would leave the SFU idle while it runs. The tree's levels are
// template steps, so that every index is a constant and the partial
// results stay in registers.
template <bool kMax>
__device__ __forceinline__ float combine(float x, float y) {
  return kMax ? fmaxf(x, y) : x + y;
}

template <bool kMax, int W, int M>
__device__ __forceinline__ void tree_level(float (&a)[M], float (&c)[M]) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a[j] = combine<kMax>(a[j], a[j + W]);
      c[j] = combine<kMax>(c[j], c[j + W]);
    }
    tree_level<kMax, W / 2>(a, c);
  }
}

template <bool kMax, int N>
__device__ __forceinline__ void row_reduce(const float (&s)[N], float& lo,
                                           float& hi) {
  float a[N / 4], c[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    a[j] = combine<kMax>(s[4 * j], s[4 * j + 1]);
    c[j] = combine<kMax>(s[4 * j + 2], s[4 * j + 3]);
  }
  tree_level<kMax, N / 8>(a, c);
  lo = a[0];
  hi = c[0];
}

// Byte offset of tail slab j in an R-row tile (after the 64-column slabs).
template <int HD, int R>
__host__ __device__ constexpr int tail_at(int j) {
  return Cols<HD>::kFull * R * 128 + j * R * 32;
}

// The R-row tile at head `head`, rows [row0, row0 + R) of batch row b, into
// `dst` (its slabs), counted on `bar`.
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int s = 0; s < Cols<HD>::kFull; ++s)
    tma_load_4d(dst + s * R * 128, m, bar, 64 * s, head, row0, b);
#pragma unroll
  for (int j = 0; j < Cols<HD>::kTails; ++j)
    tma_load_4d(dst + tail_at<HD, R>(j), tail, bar,
                64 * Cols<HD>::kFull + 16 * j, head, row0, b);
}

// d = A B^T over hd: A is rows [a_row0, a_row0 + 64) of an RA-row tile, B
// the whole N-row tile, both K-major (hd is the depth). N = 64 or 128.
template <int HD, int RA, int N>
__device__ __forceinline__ void mma_rows(float (&d)[N / 2],
                                         const uint8_t* a_tile, int a_row0,
                                         const uint8_t* b_tile) {
  constexpr int kFull = Cols<HD>::kFull;
  const uint32_t a = smem_u32(a_tile), b = smem_u32(b_tile);
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    uint64_t da, db;
    if (k < 4 * kFull) {
      const int s = k / 4, c = 32 * (k % 4);
      da = gmma_desc(a + s * RA * 128 + a_row0 * 128 + c, 16, 1024, kSw128);
      db = gmma_desc(b + s * N * 128 + c, 16, 1024, kSw128);
    } else {  // a tail slab: one 16-deep step each
      const int j = k - 4 * kFull;
      da = gmma_desc(a + tail_at<HD, RA>(j) + a_row0 * 32, 16, 256, kSw32);
      db = gmma_desc(b + tail_at<HD, N>(j), 16, 256, kSw32);
    }
    if constexpr (N == 128)
      wgmma_ss_n128(d, da, db, k > 0);
    else
      wgmma_ss_n64(d, da, db, k > 0);
  }
}

// acc += P B: P [64 x KR] as register fragments (p[k]: depth 16 k .. 16 k +
// 15), B the whole KR-row tile read MN-major (its hd columns are N).
template <int HD, int KR>
__device__ __forceinline__ void mma_cols(AccHD<HD>& acc,
                                         const uint32_t (&p)[KR / 16][4],
                                         const uint8_t* b_tile) {
  constexpr int kFull = Cols<HD>::kFull;
  const uint32_t b = smem_u32(b_tile);
#pragma unroll
  for (int k = 0; k < KR / 16; ++k) {
#pragma unroll
    for (int s = 0; s < kFull; ++s)
      wgmma_rs_n64(acc.s[s], p[k],
                   gmma_desc(b + s * KR * 128 + k * 16 * 128, KR * 128, 1024,
                             kSw128),
                   1);
#pragma unroll
    for (int j = 0; j < Cols<HD>::kTails; ++j)
      wgmma_rs_n16(acc.t[j], p[k],
                   gmma_desc(b + tail_at<HD, KR>(j) + k * 16 * 32, 256, 256,
                             kSw32),
                   1);
  }
}

// The D fragment of a 64 x 16 K product (d[8 k .. 8 k + 7]) as the bf16 A
// fragment of depth step k.
template <int NF>
__device__ __forceinline__ void to_frags(uint32_t (&f)[NF / 8][4],
                                         const float (&d)[NF]) {
#pragma unroll
  for (int k = 0; k < NF / 8; ++k) {
    f[k][0] = pack_f32(d[8 * k + 0], d[8 * k + 1]);
    f[k][1] = pack_f32(d[8 * k + 2], d[8 * k + 3]);
    f[k][2] = pack_f32(d[8 * k + 4], d[8 * k + 5]);
    f[k][3] = pack_f32(d[8 * k + 6], d[8 * k + 7]);
  }
}

// Two adjacent output elements, bf16 or f32.
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One fragment group (elements x0, x1 of row lo and x2, x3 of row lo + 8,
// at column c), times `mul_lo` / `mul_hi`.
template <typename T>
__device__ __forceinline__ void store_group(T* base, size_t ld, int c,
                                            float x0, float x1, float x2,
                                            float x3, bool lo_ok, bool hi_ok,
                                            float mul_lo, float mul_hi) {
  if (lo_ok) store_pair(base + c, x0 * mul_lo, x1 * mul_lo);
  if (hi_ok) store_pair(base + 8 * ld + c, x2 * mul_hi, x3 * mul_hi);
}

// Rows lo (fragment elements e < 2) and hi = lo + 8 of an AccHD, times
// `mul`, into row-major rows of stride `ld` (elements) from `base`.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* base, size_t ld,
                                           const AccHD<HD>& a, bool lo_ok,
                                           bool hi_ok, float mul_lo,
                                           float mul_hi, int tig) {
#pragma unroll
  for (int s = 0; s < Cols<HD>::kFull; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_group(base, ld, 64 * s + 8 * j + 2 * tig, a.s[s][4 * j],
                  a.s[s][4 * j + 1], a.s[s][4 * j + 2], a.s[s][4 * j + 3],
                  lo_ok, hi_ok, mul_lo, mul_hi);
#pragma unroll
  for (int t = 0; t < Cols<HD>::kTails; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      store_group(base, ld, 64 * Cols<HD>::kFull + 16 * t + 8 * j + 2 * tig,
                  a.t[t][4 * j], a.t[t][4 * j + 1], a.t[t][4 * j + 2],
                  a.t[t][4 * j + 3], lo_ok, hi_ok, mul_lo, mul_hi);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A tile map for the column slabs and one for the tail (a copy of the first
// when hd has none).
struct TileMaps {
  CUtensorMap m, tail;
};

// ---- forward ----------------------------------------------------------------

// One CTA: query rows [q0, q0 + 128) of head h of batch row b. The
// producer warpgroup's thread loads the Q tile once and streams K and V
// tiles (fwd_keys) through a ring of kStages stages (full/empty mbarriers;
// K and V on separate full barriers, so S = Q K^T starts before V has
// landed). Consumer warpgroup w owns query rows q0 + 64 w .. + 64: per key
// tile S = Q K^T on wgmma (both operands in shared memory), the online
// softmax in registers in the log2 domain (scores times scale * log2 e,
// exp2), P rounded to bf16 once relative to the running max and turned
// into A fragments in registers, and O += P V on wgmma with V read
// MN-major. Only tiles that cross the diagonal or the end of the keys are
// masked; key tiles past the diagonal are not loaded.
template <int HD>
__global__ void __launch_bounds__(cta_threads<HD>(), 3 - consumers<HD>())
    fa_fwd_wgmma(const __grid_constant__ TileMaps tq,
                 const __grid_constant__ TileMaps tk,
                 const __grid_constant__ TileMaps tv, bf16* __restrict__ o,
                 float* __restrict__ o32, float* __restrict__ lse, int H,
                 int KV, int Sq, int Skv, float scale_log2, int causal) {
  constexpr int kCons = consumers<HD>(), kQRows = 64 * kCons;
  constexpr int kFwdKeys = fwd_keys<HD>();
  constexpr int QB = tile_bytes<HD, kQRows>(), KB = tile_bytes<HD, kFwdKeys>();
  extern __shared__ uint8_t fa_smem[];
  uint8_t* sq = align_1024(fa_smem);
  uint8_t* sk = sq + QB;
  uint8_t* sv = sk + kStages * KB;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + kStages * KB);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int nqt = (Sq + kQRows - 1) / kQRows;
  const int q0 =
      (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * kQRows;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int kv_end = causal ? min(Skv, q0 + kQRows) : Skv;
  const int n_tiles = (kv_end + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 128 * kCons);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle: provably warp-uniform, as the
  // branches around setmaxnreg must be
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kCons) {
    if constexpr (kCons == 2) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kCons) {
      mbar_expect_tx(bar_q, QB);
      load_tile<HD, kQRows>(sq, &tq.m, &tq.tail, bar_q, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_k[st], KB);
        load_tile<HD, kFwdKeys>(sk + st * KB, &tk.m, &tk.tail, &full_k[st],
                                kvh, t * kFwdKeys, b);
        mbar_expect_tx(&full_v[st], KB);
        load_tile<HD, kFwdKeys>(sv + st * KB, &tv.m, &tv.tail, &full_v[st],
                                kvh, t * kFwdKeys, b);
      }
    }
  } else {
    if constexpr (kCons == 2) regs_alloc<kConsumerRegs>();
    const int cw = wg, t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32, gid = lane / 4,
              tig = lane % 4;
    const int wg_row0 = q0 + 64 * cw;
    const int r_lo = wg_row0 + 16 * warp + gid, r_hi = r_lo + 8;
    AccHD<HD> acc;
    zero(acc);
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int kv0 = t * kFwdKeys;
      float s[kFwdKeys / 2];
      mbar_wait(&full_k[st], par);
      wgmma_fence();
      mma_rows<HD, kQRows, kFwdKeys>(s, sq, 64 * cw, sk + st * KB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const bool edge = kv0 + kFwdKeys > Skv ||
                        (causal && kv0 + kFwdKeys - 1 > wg_row0);
      if (edge)
#pragma unroll
        for (int i = 0; i < kFwdKeys / 2; ++i) {
          const int key = kv0 + frag_col(i, tig);
          const int row = (i & 2) ? r_hi : r_lo;
          if (key >= Skv || (causal && key > row)) s[i] = -CUDART_INF_F;
        }
      // the max of the raw scores: scale_log2 > 0, so scaling it gives the
      // max of the scaled ones, and each exponent is one fma
      float mx_lo, mx_hi;
      row_reduce<true>(s, mx_lo, mx_hi);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2),
                  mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
      // a row with no key yet keeps max -inf: exponentiate against 0
      const float base_lo = mn_lo == -CUDART_INF_F ? 0.f : mn_lo;
      const float base_hi = mn_hi == -CUDART_INF_F ? 0.f : mn_hi;
      const float c_lo = exp2_sfu(m_lo - base_lo),
                  c_hi = exp2_sfu(m_hi - base_hi);
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i)
        s[i] = exp2_sfu(fmaf(s[i], scale_log2, (i & 2) ? -base_hi : -base_lo));
      float ps_lo, ps_hi;
      row_reduce<false>(s, ps_lo, ps_hi);
      l_lo = l_lo * c_lo + ps_lo;  // this lane's part of the row sum
      l_hi = l_hi * c_hi + ps_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
      scale_rows(acc, c_lo, c_hi);
      uint32_t pf[kFwdKeys / 16][4];
      to_frags(pf, s);
      mbar_wait(&full_v[st], par);
      wgmma_fence();
      mma_cols<HD, kFwdKeys>(acc, pf, sv + st * KB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
    const size_t ld = (size_t)H * HD;
    const size_t row = ((size_t)b * Sq + r_lo) * ld + (size_t)h * HD;
    store_rows<HD>(o + row, ld, acc, r_lo < Sq, r_hi < Sq, 1.f / d_lo,
                   1.f / d_hi, tig);
    if (o32 != nullptr)      // the same values before rounding (see fa_delta)
      store_rows<HD>(o32 + row, ld, acc, r_lo < Sq, r_hi < Sq, 1.f / d_lo,
                     1.f / d_hi, tig);
    if (tig == 0) {
      float* lb = lse + ((size_t)b * H + h) * Sq;
      if (r_lo < Sq) lb[r_lo] = (m_lo + log2f(d_lo)) * kLn2;
      if (r_hi < Sq) lb[r_hi] = (m_hi + log2f(d_hi)) * kLn2;
    }
  }
}

// ---- backward: delta, dq, dk/dv ---------------------------------------------

__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(x[0]), c = __bfloat1622float2(x[1]);
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// delta = rowsum(do * o) in f32 from one read of each (a warp per row of
// one head, 4 elements a lane), and lse2 = lse * log2 e, both into [B, H,
// pitch] rows (pitch: Sq rounded up to 128); the kernels read whole tiles
// of rows, and a row past Sq gets lse2 = +inf and delta = 0, so its p is
// exactly 0. o is bf16 or, from the forward's o32, the f32 values before
// rounding: delta is the sum of p dP over the keys that dS = p (dP -
// delta) cancels against, and o rounded to bf16 moves it by 2^-9 of |o|
// |do|, which dq and dk then carry at full size where the keys are alike
// (a cross-attention over an encoder output that varies little).
template <typename TO>
__global__ void __launch_bounds__(256) fa_delta(
    const TO* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2,
    float* __restrict__ delta, int B, int H, int Sq, int HD, int pitch) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)B * pitch * H) return;
  const int h = (int)(w % H);
  const int s = (int)((w / H) % pitch);
  const int b = (int)(w / ((long long)H * pitch));
  const size_t out = ((size_t)b * H + h) * pitch + s;
  if (s >= Sq) {
    if (lane == 0) {
      lse2[out] = CUDART_INF_F;
      delta[out] = 0.f;
    }
    return;
  }
  float acc = 0.f;
  if (lane < HD / 4) {
    const size_t off = (((size_t)b * Sq + s) * H + h) * HD + 4 * lane;
    const float4 a = load4(o + off), c = load4(dout + off);
    acc = a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    delta[out] = acc;
    lse2[out] = lse[((size_t)b * H + h) * Sq + s] * kLog2e;
  }
}

// One CTA: query rows [q0, q0 + 128) of head h, as in the forward; Q and dO
// are loaded once, 64-key K and V tiles stream through the ring. Per tile,
// in each consumer warpgroup's 64 rows: S = Q K^T and dP = dO V^T (wgmma,
// shared memory), p = exp2(S scale log2 e - lse2), dS = p (dP - delta)
// scale rounded to bf16 once, dq += dS K with the same K tile read MN-major.
template <int HD>
__global__ void __launch_bounds__(cta_threads<HD>(), 3 - consumers<HD>())
    fa_dq_wgmma(const __grid_constant__ TileMaps tq,
                const __grid_constant__ TileMaps tdo,
                const __grid_constant__ TileMaps tk,
                const __grid_constant__ TileMaps tv,
                const float* __restrict__ lse2,
                const float* __restrict__ delta, bf16* __restrict__ dq, int H,
                int KV, int Sq, int Skv, int pitch, float scale,
                float scale_log2, int causal) {
  constexpr int kCons = consumers<HD>(), kQRows = 64 * kCons;
  constexpr int QB = tile_bytes<HD, kQRows>(), KB = tile_bytes<HD, kDqKeys>();
  extern __shared__ uint8_t fa_smem[];
  uint8_t* sq = align_1024(fa_smem);
  uint8_t* sdo = sq + QB;
  uint8_t* sk = sdo + QB;
  uint8_t* sv = sk + kStages * KB;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + kStages * KB);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int nqt = (Sq + kQRows - 1) / kQRows;
  const int q0 =
      (causal ? nqt - 1 - (int)blockIdx.z : (int)blockIdx.z) * kQRows;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int kv_end = causal ? min(Skv, q0 + kQRows) : Skv;
  const int n_tiles = (kv_end + kDqKeys - 1) / kDqKeys;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 128 * kCons);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle: provably warp-uniform, as the
  // branches around setmaxnreg must be
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kCons) {
    if constexpr (kCons == 2) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kCons) {
      mbar_expect_tx(bar_q, 2 * QB);
      load_tile<HD, kQRows>(sq, &tq.m, &tq.tail, bar_q, h, q0, b);
      load_tile<HD, kQRows>(sdo, &tdo.m, &tdo.tail, bar_q, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_k[st], KB);
        load_tile<HD, kDqKeys>(sk + st * KB, &tk.m, &tk.tail, &full_k[st],
                               kvh, t * kDqKeys, b);
        mbar_expect_tx(&full_v[st], KB);
        load_tile<HD, kDqKeys>(sv + st * KB, &tv.m, &tv.tail, &full_v[st],
                               kvh, t * kDqKeys, b);
      }
    }
  } else {
    if constexpr (kCons == 2) regs_alloc<kConsumerRegs>();
    const int cw = wg, t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32, gid = lane / 4,
              tig = lane % 4;
    const int wg_row0 = q0 + 64 * cw;
    const int r_lo = wg_row0 + 16 * warp + gid, r_hi = r_lo + 8;
    const size_t srow = ((size_t)b * H + h) * pitch;  // r_hi < pitch
    const float l2_lo = lse2[srow + r_lo], l2_hi = lse2[srow + r_hi];
    // delta * scale: dS = p (dP - delta) scale = p fma(dP, scale, -delta scale)
    const float dls_lo = delta[srow + r_lo] * scale,
                dls_hi = delta[srow + r_hi] * scale;
    AccHD<HD> acc;
    zero(acc);
    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int kv0 = t * kDqKeys;
      float s[kDqKeys / 2], dp[kDqKeys / 2];
      mbar_wait(&full_k[st], par);
      wgmma_fence();
      mma_rows<HD, kQRows, kDqKeys>(s, sq, 64 * cw, sk + st * KB);
      mbar_wait(&full_v[st], par);
      wgmma_fence();
      mma_rows<HD, kQRows, kDqKeys>(dp, sdo, 64 * cw, sv + st * KB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = kv0 + kDqKeys > Skv ||
                        (causal && kv0 + kDqKeys - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        const bool hi = i & 2;
        float p = exp2_sfu(fmaf(s[i], scale_log2, hi ? -l2_hi : -l2_lo));
        if (edge) {
          const int key = kv0 + frag_col(i, tig);
          if (key >= Skv || (causal && key > (hi ? r_hi : r_lo))) p = 0.f;
        }
        s[i] = p * fmaf(dp[i], scale, hi ? -dls_hi : -dls_lo);
      }
      uint32_t dsf[kDqKeys / 16][4];
      to_frags(dsf, s);
      wgmma_fence();
      mma_cols<HD, kDqKeys>(acc, dsf, sk + st * KB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[st]);
    }
    const size_t ld = (size_t)H * HD;
    store_rows<HD>(dq + ((size_t)b * Sq + r_lo) * ld + (size_t)h * HD, ld,
                   acc, r_lo < Sq, r_hi < Sq, 1.f, 1.f, tig);
  }
}

// One pass of a dk/dv consumer warpgroup over the n streamed query tiles
// (ring uses u0 .. u0 + n - 1), for the warpgroup's 64 keys (rows wg_row0
// .. + 63 of the K and V tiles): dv += P^T dO if kDv, dk += dS^T Q if kDk.
// Keys are the rows of every product: S^T = K Q^T and, for dk, dP^T = V
// dO^T (wgmma, shared memory), p = exp2(S^T scale log2 e - lse2), dS^T = p
// (dP^T - delta) scale; p and dS are rounded to bf16 once and multiply the
// dO and Q tiles read MN-major.
template <int HD, int KR, bool kDv, bool kDk>
__device__ __forceinline__ void dkv_pass(AccHD<HD>& dva, AccHD<HD>& dka,
                                         const uint8_t* sk,
                                         const uint8_t* sv,
                                         const uint8_t* ring, uint64_t* full,
                                         uint64_t* empty, int u0, int n,
                                         int i_begin, int wg_row0, int key_lo,
                                         int tig, float scale,
                                         float scale_log2, int causal) {
  constexpr int QB = tile_bytes<HD, kDkvRows>(), kStage = 2 * QB + 1024;
  if (kDv) zero(dva);
  if (kDk) zero(dka);
  for (int t = 0; t < n; ++t) {
    const int u = u0 + t, st = u % kStages;
    const int i0 = i_begin + t * kDkvRows;
    const uint8_t* stage = ring + st * kStage;
    const float* sl2 = reinterpret_cast<const float*>(stage + 2 * QB);
    const float* sdl = reinterpret_cast<const float*>(stage + 2 * QB + 512);
    float s[kDkvRows / 2], dp[kDkvRows / 2];
    mbar_wait(&full[st], (u / kStages) & 1);
    wgmma_fence();
    mma_rows<HD, KR, kDkvRows>(s, sk, wg_row0, stage);
    if (kDk) mma_rows<HD, KR, kDkvRows>(dp, sv, wg_row0, stage + QB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (kDk) fence_regs(dp);
    // the warpgroup's last key (key_lo | 63) after the tile's first row
    const bool edge = causal && (key_lo | 63) > i0;
#pragma unroll
    for (int i = 0; i < kDkvRows / 2; ++i) {
      const int c = frag_col(i, tig);
      float p = exp2_sfu(fmaf(s[i], scale_log2, -sl2[c]));
      if (edge && key_lo + ((i & 2) ? 8 : 0) > i0 + c) p = 0.f;
      s[i] = p;
      if (kDk) dp[i] = p * ((dp[i] - sdl[c]) * scale);
    }
    uint32_t pf[kDkvRows / 16][4], dsf[kDkvRows / 16][4];
    if (kDv) to_frags(pf, s);
    if (kDk) to_frags(dsf, dp);
    wgmma_fence();
    if (kDv) mma_cols<HD, kDkvRows>(dva, pf, stage + QB);
    if (kDk) mma_cols<HD, kDkvRows>(dka, dsf, stage);
    wgmma_commit();
    wgmma_wait<0>();
    if (kDv) fence_acc(dva);
    if (kDk) fence_acc(dka);
    mbar_arrive(&empty[st]);
  }
}

// A dk/dv consumer's 64 x hd accumulator for keys key_lo, key_lo + 8 (and
// the warpgroup's others): bf16 into out [B, Skv, KV, hd] when G = 1, else
// f32 into head h of the partials [B, Skv, H, hd].
template <int HD>
__device__ __forceinline__ void store_dkv(bf16* out, float* partial,
                                          const AccHD<HD>& a, int b,
                                          int key_lo, int h, int H, int KV,
                                          int Skv, int tig) {
  const bool lo_ok = key_lo < Skv, hi_ok = key_lo + 8 < Skv;
  if (H == KV) {
    const size_t ld = (size_t)KV * HD;
    store_rows<HD>(out + ((size_t)b * Skv + key_lo) * ld + (size_t)h * HD,
                   ld, a, lo_ok, hi_ok, 1.f, 1.f, tig);
  } else {
    const size_t ld = (size_t)H * HD;
    store_rows<HD>(partial + ((size_t)b * Skv + key_lo) * ld + (size_t)h * HD,
                   ld, a, lo_ok, hi_ok, 1.f, 1.f, tig);
  }
}

// One CTA: keys [k0, k0 + 128) of KV head h / G against query head h of
// batch row b (H x Skv / 128 CTAs, not KV x ...: the G heads of a KV head
// run in parallel). K and V are loaded once; 64-row tiles of Q, dO, lse2
// and delta of head h stream through the ring. Consumer warpgroup w owns
// keys k0 + 64 w .. + 64 (dkv_pass). At hd 32, 64 and 80 it
// accumulates dk and dv together in one pass over the tiles (four
// products). At hd 128 two
// 64 x 128 accumulators beside S^T and dP^T are more registers than ptxas
// gave a consumer (it spilled 772 bytes and serialised the wgmmas), so the
// tiles stream twice: dv in the first pass, dk in the second, one product
// more (S^T twice) for one accumulator at a time. Causal: query tiles
// before k0 are skipped; grid z is the key tile, so the CTAs with the most
// query tiles (k0 = 0) start first. With G = 1 the CTA writes bf16 dk and
// dv; with G > 1 it writes its head's f32 partials [B, Skv, H, hd], summed
// over the G heads in a fixed order by fa_dkv_reduce (no atomics: two calls
// give the same bits).
template <int HD>
__global__ void __launch_bounds__(cta_threads<HD>(), 3 - consumers<HD>())
    fa_dkv_wgmma(const __grid_constant__ TileMaps tk,
                 const __grid_constant__ TileMaps tv,
                 const __grid_constant__ TileMaps tq,
                 const __grid_constant__ TileMaps tdo,
                 const __grid_constant__ CUtensorMap tlse2,
                 const __grid_constant__ CUtensorMap tdelta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ dkp, float* __restrict__ dvp, int H,
                 int KV, int Sq, int Skv, float scale, float scale_log2,
                 int causal) {
  constexpr int kCons = consumers<HD>(), kKRows = 64 * kCons;
  constexpr int KB = tile_bytes<HD, kKRows>(),
                QB = tile_bytes<HD, kDkvRows>();
  constexpr int kStage = 2 * QB + 1024;  // Q, dO, then lse2 and delta
  extern __shared__ uint8_t fa_smem[];
  uint8_t* sk = align_1024(fa_smem);
  uint8_t* sv = sk + KB;
  uint8_t* ring = sv + KB;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  constexpr int kPasses = HD == 128 ? 2 : 1;  // see above
  const int k0 = blockIdx.z * kKRows;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int i_begin = causal ? k0 : 0;  // query rows < k0 see none
  const int n_tiles =
      i_begin < Sq ? (Sq - i_begin + kDkvRows - 1) / kDkvRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kCons);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle: provably warp-uniform, as the
  // branches around setmaxnreg must be
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kCons) {
    if constexpr (kCons == 2) regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kCons) {
      mbar_expect_tx(bar_kv, 2 * KB);
      load_tile<HD, kKRows>(sk, &tk.m, &tk.tail, bar_kv, kvh, k0, b);
      load_tile<HD, kKRows>(sv, &tv.m, &tv.tail, bar_kv, kvh, k0, b);
      for (int u = 0; u < kPasses * n_tiles; ++u) {  // once per pass
        const int st = u % kStages;
        const int i0 = i_begin + (u % n_tiles) * kDkvRows;
        if (u >= kStages) mbar_wait(&empty[st], ((u / kStages) & 1) ^ 1);
        uint8_t* stage = ring + st * kStage;
        mbar_expect_tx(&full[st], 2 * QB + 2 * kDkvRows * 4);
        load_tile<HD, kDkvRows>(stage, &tq.m, &tq.tail, &full[st], h, i0, b);
        load_tile<HD, kDkvRows>(stage + QB, &tdo.m, &tdo.tail, &full[st], h,
                                i0, b);
        tma_load_2d(stage + 2 * QB, &tlse2, &full[st], i0, b * H + h);
        tma_load_2d(stage + 2 * QB + 512, &tdelta, &full[st], i0, b * H + h);
      }
    }
  } else {
    if constexpr (kCons == 2) regs_alloc<kConsumerRegs>();
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32, gid = lane / 4,
              tig = lane % 4;
    const int key_lo = k0 + 64 * wg + 16 * warp + gid;
    mbar_wait(bar_kv, 0);
    AccHD<HD> dva, dka;
    if (kPasses == 1)
      dkv_pass<HD, kKRows, true, true>(dva, dka, sk, sv, ring, full, empty,
                                       0, n_tiles, i_begin, 64 * wg, key_lo,
                                       tig, scale, scale_log2, causal);
    else
      dkv_pass<HD, kKRows, true, false>(dva, dka, sk, sv, ring, full, empty,
                                        0, n_tiles, i_begin, 64 * wg, key_lo,
                                        tig, scale, scale_log2, causal);
    store_dkv<HD>(dv, dvp, dva, b, key_lo, h, H, KV, Skv, tig);
    if (kPasses == 2)
      dkv_pass<HD, kKRows, false, true>(dva, dka, sk, sv, ring, full, empty,
                                        n_tiles, n_tiles, i_begin, 64 * wg,
                                        key_lo, tig, scale, scale_log2,
                                        causal);
    store_dkv<HD>(dk, dkp, dka, b, key_lo, h, H, KV, Skv, tig);
  }
}

__device__ __forceinline__ void store4(bf16* p, float4 a) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_f32(a.x, a.y), pack_f32(a.z, a.w));
}
__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}

// dk[b, s, g', :] = sum over g < G of dkp[b, s, g' G + g, :] in order g = 0,
// 1, ... (and dv from dvp), rounded to T (bf16 or f32) once: 4 elements a
// thread.
template <typename T>
__global__ void __launch_bounds__(256) fa_dkv_reduce(
    const float* __restrict__ dkp, const float* __restrict__ dvp,
    T* __restrict__ dk, T* __restrict__ dv, long long n4, int KV, int G,
    int HD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int d = (int)(i % (HD / 4)) * 4;
  const long long row = i / (HD / 4);  // b * Skv * KV + s * KV + kvh
  const size_t src = (size_t)(row * G) * HD + d;  // head kvh * G of (b, s)
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int g = 0; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(dkp + src + g * HD);
    const float4 y = *reinterpret_cast<const float4*>(dvp + src + g * HD);
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  const size_t dst = (size_t)row * HD + d;
  store4(dk + dst, a);
  store4(dv + dst, c);
}

// ---- f32: split TF32 on mma.sync --------------------------------------------
//
// The f32 kernels' products run on the tensor cores as split TF32
// (tf32_tiles.cuh: split, mma3), all but dq's dP where p >= kExactP: each
// element of A and B as a tf32 hi part and a tf32 lo part of the
// remainder, the product lo hi + hi lo + hi hi on mma.sync m16n8k8, about
// 22 of f32's 24 bits where one tf32 product keeps 11. A CTA is 4 or 8
// warps (kTfFwdWarps, tf_bwd_warps); each owns a strip of 16 of the CTA's
// rows (query rows in the forward and dq, keys in dk/dv) and the CTA's own
// tiles are loaded once; the other operand streams in tiles of tf_fwd_tile
// / tf_bwd_tile rows through a 2-stage ring of 16-byte cp.async copies.
//   * The score products (Q K^T, dO V^T, K Q^T, V dO^T: depth hd) read both
//     operands from shared memory; Q K^T and K Q^T sum in place over the
//     hd / 8 depth steps, dP and dP^T each step fresh. Where p >= kExactP,
//     dq's dP is summed again on the CUDA cores as the plain version's f32
//     product sums it (dot_f32): dS = p (dP - delta) cancels where one key
//     holds a row's p, and there dq is the rounding of dP (below).
//   * The backward splits each streamed tile once a CTA (tf_presplit: hi
//     in place, lo beside it), not once a warp: a B operand's split is five
//     ALU operations an element, which every warp repeated for each of its
//     products, and the kernels issue more ALU operations than products
//     (K3b at starcoder2-7b's shape 14.3 -> 13.5 ms on an H100; the B reads
//     double, and shared memory's bandwidth now paces the products about
//     as much as the issue does). The forward has no room for the lo parts
//     at hd 128 (two CTAs an SM).
//   * p (and dS) stay in registers: a C fragment of the scores is the A
//     fragment of the next product with its depth taken in the order 2t,
//     2t + 1 (tf32_tiles.cuh), so the products over keys or query rows (P V,
//     dS K, P^T dO, dS^T Q) read their B operand at depth rows 2t and 2t + 1.
//   * Long sums: those products sum over all keys (4096) or all query rows,
//     and the tensor core's sum truncates toward zero. Each tile's products
//     are summed fresh (KT keys or rows, 3-8 depth steps) and the tile's sum
//     is added to the f32 accumulator (the forward: acc = fma(acc, c, sum)
//     with the online softmax's correction c), so the truncation acts on a
//     tile's share only; a fresh sum each depth step would add 4 FADDs to
//     every 3 products. Four column tiles at a time, four product chains in
//     flight.
//   * Layout: a tile row is hd + 4 floats (4 or 20 mod 32 at hd 32, 64, 80,
//     128), no swizzle, any head dim a multiple of 16: the A read (rows g,
//     columns k + t) and the transposed B read of the scores (rows 8 nt + g,
//     columns k + t) fall on banks 4g + t (20g + t at hd 80), the B read
//     after a register A (rows 2t, 2t + 1, columns n + g) on 8t + g: all 32
//     distinct. No wgmma: its tf32 form takes only K-major operands, which V,
//     K, Q and dO are not in the products over keys or rows.
//   * The softmax in f32 with expf (accurate, not ex2.approx), as the plain
//     version: s * scale, running max and sum, lse = m + log(l); in the
//     backward p = expf(s * scale - lse), dS = p (dP - delta) scale, delta
//     from the wrapper, summed as the plain version sums it.
//   * Causal: a warp skips the products of a tile its rows do not reach;
//     key tiles past the CTA's last row are not loaded; the forward and dq
//     start with the last query tiles, dk/dv with the first keys (the
//     longest walks). dk/dv are a CTA per 64 or 128 keys and *query* head;
//     with G = H / KV > 1 each head's f32 partials are summed by
//     fa_dkv_reduce in the order g = 0, 1, ... (no atomics: two calls give
//     the same bits).

template <int HD>
__host__ __device__ constexpr int tf_pitch() {
  static_assert(HD % 16 == 0, "head_dim a multiple of 16");
  return HD + 4;
}

// Warps a CTA (each a strip of 16 of its own rows) and rows a streamed tile
// (keys in the forward and dq, query rows in dk/dv). Shared memory holds the
// own rows' tiles and a 2-stage ring of the streamed ones: the forward 4
// warps with 32 keys at hd 128, 64 elsewhere (two CTAs an SM, 8 warps, up to
// 255 registers a thread; 8 warps a CTA at hd 128 ran no faster); the
// backward 4 warps with 32 keys or rows (64 at hd 32), two CTAs an SM, but
// at hd 128 one CTA of 8 warps with 24 (Q and dO, or K and V, of 128 rows:
// 135 KB; the ring and the stage's lo parts 76 KB), so that an A fragment
// split once serves three column tiles, not two: K3b at starcoder2-7b's
// shape took 14.3 ms with 8 warps and 32-row tiles split by each warp,
// 15.6 with 4 warps and 16, 19.6 with 4 warps and 32 (one CTA an SM), on
// an H100.
constexpr int kTfFwdWarps = 4;
template <int HD>
__host__ __device__ constexpr int tf_fwd_tile() {
  return HD == 128 ? 32 : 64;
}
template <int HD>
__host__ __device__ constexpr int tf_bwd_warps() {
  return HD == 128 ? 8 : 4;
}
template <int HD>
__host__ __device__ constexpr int tf_bwd_tile() {
  return HD == 128 ? 24 : HD == 32 ? 64 : 32;
}

template <int HD>
__host__ __device__ constexpr int tf_fwd_bytes() {
  return 4 * (16 * kTfFwdWarps + 4 * tf_fwd_tile<HD>()) * tf_pitch<HD>();
}
template <int HD>
__host__ __device__ constexpr int tf_dq_bytes() {  // + the stage's lo parts
  return 4 * (32 * tf_bwd_warps<HD>() + 6 * tf_bwd_tile<HD>()) *
         tf_pitch<HD>();
}
template <int HD>
__host__ __device__ constexpr int tf_dkv_stage() {  // floats: Q, dO, lse, delta
  return 2 * tf_bwd_tile<HD>() * tf_pitch<HD>() + 2 * tf_bwd_tile<HD>();
}
template <int HD>
__host__ __device__ constexpr int tf_dkv_bytes() {  // + the stage's lo parts
  return 4 * ((32 * tf_bwd_warps<HD>() + 2 * tf_bwd_tile<HD>()) *
                  tf_pitch<HD>() +
              2 * tf_dkv_stage<HD>());
}

// Rows [r0, r0 + ROWS) of a matrix at src with a row stride of ld floats
// (HD of them used) into a shared tile of pitch tf_pitch<HD>(), as 16-byte
// cp.async pieces; rows at or past lim are zero.
template <int HD, int ROWS, int NTHR>
__device__ __forceinline__ void tf_stage(float* dst, const float* src,
                                         size_t ld, int r0, int lim) {
  constexpr int kP = tf_pitch<HD>(), kC = HD / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kC; e += NTHR) {
    const int r = e / kC, c = (e % kC) * 4;
    const bool in = r0 + r < lim;
    cp_async16(dst + r * kP + c, in ? src + (size_t)(r0 + r) * ld + c : src,
               in);
  }
}

// src[r0 .. r0 + n) into dst as 4-byte cp.async copies, 0 at or past lim.
__device__ __forceinline__ void tf_stage_vec(float* dst, const float* src,
                                             int r0, int n, int lim) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = r0 + i < lim;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     shared_addr(dst + i)),
                 "l"(in ? src + r0 + i : src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

// Rows [0, ROWS) of a tile T split once for the CTA: each element's hi
// part in place, its lo part at the same place of L (split's rounding), so
// that the warps read their B operands split (b_part).
template <int HD, int ROWS, int NTHR>
__device__ __forceinline__ void tf_presplit(float* T, float* L) {
  constexpr int kP = tf_pitch<HD>(), kC = HD / 4;
  auto part = [](float x, float& lo) {
    const Split v = split(x);
    lo = __uint_as_float(v.lo);
    return __uint_as_float(v.hi);
  };
#pragma unroll 2
  for (int e = threadIdx.x; e < ROWS * kC; e += NTHR) {
    const int i = (e / kC) * kP + (e % kC) * 4;
    const float4 x = *reinterpret_cast<const float4*>(T + i);
    float4 h, l;
    h.x = part(x.x, l.x);
    h.y = part(x.y, l.y);
    h.z = part(x.z, l.z);
    h.w = part(x.w, l.w);
    *reinterpret_cast<float4*>(T + i) = h;
    *reinterpret_cast<float4*>(L + i) = l;
  }
}

// A B operand element: split here (kPre false: T raw), or read as the hi
// and lo parts that tf_presplit left at T[i] and L[i].
template <bool kPre>
__device__ __forceinline__ Split b_part(const float* T, const float* L,
                                        int i) {
  if (kPre) return {__float_as_uint(T[i]), __float_as_uint(L[i])};
  return split(T[i]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// s[j][nt] = A_j B_j^T over the depth HD for NP products at once (their
// chains interleave): A_j(r, d) = a[j][r][d], the warp's 16 rows,
// B_j^T(d, n) = b[j][8 nt + n][d]. Product 0 sums in place over the HD / 8
// depth steps (the scores Q K^T, K Q^T: their error moves p relatively,
// which no sum cancels), product 1 each step fresh, added in f32 (dP,
// dP^T: dS = p (dP - delta) cancels against them). kPre: each B_j split
// already, its lo parts in bl[j] (tf_presplit).
template <int HD, int NT, int NP, bool kPre>
__device__ __forceinline__ void tf_scores(float (&s)[NP][NT][4],
                                          const float* const (&a)[NP],
                                          const float* const (&b)[NP],
                                          const float* const (&bl)[NP]) {
  constexpr int P = tf_pitch<HD>();
  const int lane = threadIdx.x & 31, o = (lane >> 2) * P + (lane & 3);
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][nt][e] = 0.f;
#pragma unroll 2
  for (int k = 0; k < HD; k += 8) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float* pa = a[j] + o + k;
      const float* pb = b[j] + o + k;
      const float* pl = bl[j] + o + k;
      const FragA fa = frag_a(pa[0], pa[8 * P], pa[4], pa[8 * P + 4]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const Split x = b_part<kPre>(pb, pl, 8 * nt * P);
        const Split y = b_part<kPre>(pb, pl, 8 * nt * P + 4);
        if (j == 0)
          mma3<false, false, false>(s[j][nt], fa, x, y);
        else
          mma3<false, false, true>(s[j][nt], fa, x, y);
      }
    }
  }
}

// dq's dP where p >= kExactP, as the plain version's f32 product sums it:
// sum over d < HD of a[d] b[d], one fma chain in the order d = 0, 1, ...
// Where one key holds most of a row's p, dS = p (dP - delta) cancels (row
// 0's dq is that cancellation alone, dS_00 = 0 but for rounding), and dq
// there is the rounding of dP and of delta: phase 6 holds it to the plain
// version's, which the same chain repeats bit for bit. A product of any
// other order, however exact, does not: with dP in three tf32 parts (six
// products), row 0's dq read 3.45x phase 6's f32 rule against the plain
// version at S 4096 and hd 128 on an H100, and the plain version itself
// 2.56x it against float64. Elsewhere the tensor cores' dP moves dq by p
// times its error, p < 1/32.
constexpr float kExactP = 1.f / 32.f;

template <int HD>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// The split A fragments of a 16 x 8 C tile with its depth (columns) taken
// in the order 2t, 2t + 1.
__device__ __forceinline__ FragA c_frag(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// acc[nt] = fma(acc[nt], c, z[nt]) (kScale: c = c0 on the fragment's row g,
// c1 on g + 8) or acc[nt] + z[nt], where z[nt] = sum over the tile's KT
// depth of p(r, k) T[k][8 nt + n], summed fresh: p the warp's 16 x KT strip
// as split A fragments (pa[kt] its columns [8 kt, 8 kt + 8) in the order
// 2t, 2t + 1), so T is read at rows 8 kt + 2t and + 1. kPre: T split
// already, its lo parts in TL (tf_presplit).
template <int HD, int KT, bool kScale, bool kPre>
__device__ __forceinline__ void tf_accumulate(float (&acc)[HD / 8][4],
                                              const FragA (&pa)[KT / 8],
                                              const float* T, const float* TL,
                                              float c0, float c1) {
  constexpr int P = tf_pitch<HD>(), DT = HD / 8;
  const int lane = threadIdx.x & 31, o = 2 * (lane & 3) * P + (lane >> 2);
  const float* p0 = T + o;
  const float* l0 = TL + o;
#pragma unroll
  for (int n0 = 0; n0 < DT; n0 += 4) {
    float z[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT / 8; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < DT) {
          const int i = 8 * kt * P + 8 * (n0 + j);
          mma3<false, false, false>(z[j], pa[kt], b_part<kPre>(p0, l0, i),
                                    b_part<kPre>(p0, l0, i + P));
        }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j >= DT) continue;
      float* d = acc[n0 + j];
      if (kScale) {
        d[0] = fmaf(d[0], c0, z[j][0]);
        d[1] = fmaf(d[1], c0, z[j][1]);
        d[2] = fmaf(d[2], c1, z[j][2]);
        d[3] = fmaf(d[3], c1, z[j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += z[j][e];
      }
    }
  }
}

// The warp's 16 x HD accumulator (row g: acc[nt][0, 1], row g + 8: [2, 3],
// columns 8 nt + 2t, + 1) divided by d0 / d1 into out rows row0 / row0 + 8
// (of stride ld), rows at or past lim skipped.
template <int HD>
__device__ __forceinline__ void tf_store(float* out, size_t ld,
                                         const float (&acc)[HD / 8][4],
                                         int row0, int lim, float d0,
                                         float d1) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    if (row0 < lim)
      *reinterpret_cast<float2*>(out + (size_t)row0 * ld + 8 * nt + c) =
          make_float2(acc[nt][0] / d0, acc[nt][1] / d0);
    if (row0 + 8 < lim)
      *reinterpret_cast<float2*>(out + (size_t)(row0 + 8) * ld + 8 * nt +
                                 c) =
          make_float2(acc[nt][2] / d1, acc[nt][3] / d1);
  }
}

// One CTA: query rows [q0, q0 + kRows) of head h of row b; K and V tiles
// of KT keys stream. Per tile, a warp's scores S = Q K^T (16 x KT), the online
// softmax on them (f32, expf; a row's max and sum over its quad of lanes),
// then acc = acc c + P V.
template <int HD>
__global__ void __launch_bounds__(32 * kTfFwdWarps, 2) fa_fwd_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int Sq, int Skv, float scale,
    int causal) {
  constexpr int P = tf_pitch<HD>(), KT = tf_fwd_tile<HD>(), NT = KT / 8;
  constexpr int kThr = 32 * kTfFwdWarps, kRows = kThr / 2;
  extern __shared__ float4 tf_smem4[];
  float* tf_smem = reinterpret_cast<float*>(tf_smem4);
  float* sq = tf_smem;                  // [kRows][P]
  float* ring = sq + kRows * P;         // per stage: K, then V, [KT][P]
  const int nqt = (Sq + kRows - 1) / kRows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ldq = (size_t)H * HD, ldk = (size_t)KV * HD;
  const size_t qoff = (size_t)b * Sq * ldq + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * ldk + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * ldk + (size_t)kvh * HD;
  const int n_tiles =
      ((causal ? min(Skv, q0 + kRows) : Skv) + KT - 1) / KT;
  tf_stage<HD, kRows, kThr>(sq, q + qoff, ldq, q0, Sq);
  tf_stage<HD, KT, kThr>(ring, kb, ldk, 0, Skv);
  tf_stage<HD, KT, kThr>(ring + KT * P, vb, ldk, 0, Skv);
  cp_async_commit();
  const int r0 = q0 + 16 * warp, row0 = r0 + g, row1 = row0 + 8;
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float* A[1] = {sq + 16 * warp * P};
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* nx = ring + ((it + 1) & 1) * 2 * KT * P;
      tf_stage<HD, KT, kThr>(nx, kb, ldk, (it + 1) * KT, Skv);
      tf_stage<HD, KT, kThr>(nx + KT * P, vb, ldk, (it + 1) * KT, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = it * KT;
    const float* sk = ring + (it & 1) * 2 * KT * P;
    if (!causal || j0 <= r0 + 15) {
      float s[1][NT][4];
      const float* Bk[1] = {sk};
      tf_scores<HD, NT, 1, false>(s, A, Bk, Bk);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * nt + 2 * t + (e & 1);
          const float x = keep(key, e < 2 ? row0 : row1, Skv, causal)
                              ? s[0][nt][e] * scale
                              : -CUDART_INF_F;
          s[0][nt][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0)),
                  mn1 = fmaxf(m1, quad_max(mx1));
      // a row with no key yet keeps exp's argument finite
      const float b0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float b1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      const float c0 = expf(m0 - b0), c1 = expf(m1 - b1);
      float sum0 = 0.f, sum1 = 0.f;
      FragA pa[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = expf(s[0][nt][e] - (e < 2 ? b0 : b1));
        sum0 += p[0] + p[1];
        sum1 += p[2] + p[3];
        pa[nt] = c_frag(p);
      }
      l0 = l0 * c0 + quad_sum(sum0);
      l1 = l1 * c1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
      tf_accumulate<HD, KT, true, false>(acc, pa, sk + KT * P, sk + KT * P,
                                         c0, c1);
    }
    __syncthreads();  // the stage is refilled next
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  tf_store<HD>(o + qoff, ldq, acc, row0, Sq, d0, d1);
  if (t == 0) {
    float* lb = lse + ((size_t)b * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(d0);
    if (row1 < Sq) lb[row1] = m1 + logf(d1);
  }
}

// One CTA: query rows [q0, q0 + kRows) of head h of row b, Q and dO loaded
// once; K and V tiles of KT keys stream. Per tile, a warp's S = Q K^T and
// dP = dO V^T (16 x KT), p = expf(s scale - lse) and dS = p (dP - delta)
// scale in registers, then dq += dS K.
template <int HD>
__global__ void __launch_bounds__(32 * tf_bwd_warps<HD>(),
                                  8 / tf_bwd_warps<HD>()) fa_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int KV, int Sq, int Skv, float scale,
    int causal) {
  constexpr int P = tf_pitch<HD>(), KT = tf_bwd_tile<HD>(), NT = KT / 8;
  constexpr int kThr = 32 * tf_bwd_warps<HD>(), kRows = kThr / 2;
  extern __shared__ float4 tf_smem4[];
  float* tf_smem = reinterpret_cast<float*>(tf_smem4);
  float* sq = tf_smem;                  // [kRows][P]
  float* sdo = sq + kRows * P;          // [kRows][P]
  float* ring = sdo + kRows * P;        // per stage: K, then V, [KT][P]
  float* slo = ring + 4 * KT * P;       // the lo parts of the stage in use
  const int nqt = (Sq + kRows - 1) / kRows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ldq = (size_t)H * HD, ldk = (size_t)KV * HD;
  const size_t qoff = (size_t)b * Sq * ldq + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * ldk + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * ldk + (size_t)kvh * HD;
  const int n_tiles =
      ((causal ? min(Skv, q0 + kRows) : Skv) + KT - 1) / KT;
  tf_stage<HD, kRows, kThr>(sq, q + qoff, ldq, q0, Sq);
  tf_stage<HD, kRows, kThr>(sdo, dout + qoff, ldq, q0, Sq);
  tf_stage<HD, KT, kThr>(ring, kb, ldk, 0, Skv);
  tf_stage<HD, KT, kThr>(ring + KT * P, vb, ldk, 0, Skv);
  cp_async_commit();
  const int r0 = q0 + 16 * warp, row0 = r0 + g, row1 = row0 + 8;
  const float* lb = lse + ((size_t)b * H + h) * Sq;
  const float* db = delta + ((size_t)b * H + h) * Sq;
  const float ls0 = row0 < Sq ? lb[row0] : 0.f;
  const float ls1 = row1 < Sq ? lb[row1] : 0.f;
  const float dl0 = row0 < Sq ? db[row0] : 0.f;
  const float dl1 = row1 < Sq ? db[row1] : 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float* A[2] = {sq + 16 * warp * P, sdo + 16 * warp * P};
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* nx = ring + ((it + 1) & 1) * 2 * KT * P;
      tf_stage<HD, KT, kThr>(nx, kb, ldk, (it + 1) * KT, Skv);
      tf_stage<HD, KT, kThr>(nx + KT * P, vb, ldk, (it + 1) * KT, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = it * KT;
    float* sk = ring + (it & 1) * 2 * KT * P;
    tf_presplit<HD, 2 * KT, kThr>(sk, slo);
    __syncthreads();
    if (!causal || j0 <= r0 + 15) {
      float s[2][NT][4];
      const float* Bkv[2] = {sk, sk + KT * P};
      const float* Lkv[2] = {slo, slo + KT * P};
      tf_scores<HD, NT, 2, true>(s, A, Bkv, Lkv);
      FragA pa[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * nt + 2 * t + (e & 1), key = j0 + kl;
          const int row = e < 2 ? row0 : row1;
          const float p = (row < Sq && keep(key, row, Skv, causal))
                              ? expf(s[0][nt][e] * scale - (e < 2 ? ls0 : ls1))
                              : 0.f;
          float dp = s[1][nt][e];
          if (p >= kExactP)  // V's row as stored, not its split parts
            dp = dot_f32<HD>(A[1] + (e < 2 ? g : g + 8) * P,
                             vb + (size_t)key * ldk);
          d[e] = p * (dp - (e < 2 ? dl0 : dl1)) * scale;
        }
        pa[nt] = c_frag(d);
      }
      tf_accumulate<HD, KT, false, true>(acc, pa, sk, slo, 1.f, 1.f);
    }
    __syncthreads();
  }
  tf_store<HD>(dq + qoff, ldq, acc, row0, Sq, 1.f, 1.f);
}

// One CTA: keys [k0, k0 + kRows) of the KV head of query head h, row b; K
// and V loaded once, tiles of KT query rows of Q, dO, lse and delta stream.
// Per tile, a warp's S^T = K Q^T and dP^T = V dO^T (16 keys x KT rows),
// p^T and dS^T in registers, then dv += P^T dO and dk += dS^T Q. Writes
// the head's dk, dv: into dk, dv [B, Skv, KV, hd] when H == KV, else into
// the partials [B, Skv, H, hd] that fa_dkv_reduce sums.
template <int HD>
__global__ void __launch_bounds__(32 * tf_bwd_warps<HD>(),
                                  8 / tf_bwd_warps<HD>()) fa_dkv_tf32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int KV, int Sq,
    int Skv, float scale, int causal) {
  constexpr int P = tf_pitch<HD>(), KT = tf_bwd_tile<HD>(), NT = KT / 8;
  constexpr int kStage = tf_dkv_stage<HD>();
  constexpr int kThr = 32 * tf_bwd_warps<HD>(), kRows = kThr / 2;
  extern __shared__ float4 tf_smem4[];
  float* tf_smem = reinterpret_cast<float*>(tf_smem4);
  float* sk = tf_smem;                  // [kRows][P]
  float* sv = sk + kRows * P;           // [kRows][P]
  float* ring = sv + kRows * P;  // per stage: Q, dO [KT][P], lse, delta [KT]
  float* slo = ring + 2 * kStage;  // the lo parts of the stage's Q and dO
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ldq = (size_t)H * HD, ldk = (size_t)KV * HD;
  const float* qb = q + (size_t)b * Sq * ldq + (size_t)h * HD;
  const float* dob = dout + (size_t)b * Sq * ldq + (size_t)h * HD;
  const size_t koff = (size_t)b * Skv * ldk + (size_t)kvh * HD;
  const float* lb = lse + ((size_t)b * H + h) * Sq;
  const float* db = delta + ((size_t)b * H + h) * Sq;
  // causal: query rows before the CTA's first key see none of its keys
  const int i_begin = causal ? (k0 / KT) * KT : 0;
  const int n_tiles = (Sq - i_begin + KT - 1) / KT;
  tf_stage<HD, kRows, kThr>(sk, k + koff, ldk, k0, Skv);
  tf_stage<HD, kRows, kThr>(sv, v + koff, ldk, k0, Skv);
  tf_stage<HD, KT, kThr>(ring, qb, ldq, i_begin, Sq);
  tf_stage<HD, KT, kThr>(ring + KT * P, dob, ldq, i_begin, Sq);
  tf_stage_vec(ring + 2 * KT * P, lb, i_begin, KT, Sq);
  tf_stage_vec(ring + 2 * KT * P + KT, db, i_begin, KT, Sq);
  cp_async_commit();
  const int kw = k0 + 16 * warp, key0 = kw + g, key1 = key0 + 8;
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
  const float* A[2] = {sk + 16 * warp * P, sv + 16 * warp * P};
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* nx = ring + ((it + 1) & 1) * kStage;
      const int i1 = i_begin + (it + 1) * KT;
      tf_stage<HD, KT, kThr>(nx, qb, ldq, i1, Sq);
      tf_stage<HD, KT, kThr>(nx + KT * P, dob, ldq, i1, Sq);
      tf_stage_vec(nx + 2 * KT * P, lb, i1, KT, Sq);
      tf_stage_vec(nx + 2 * KT * P + KT, db, i1, KT, Sq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = i_begin + it * KT;
    float* st = ring + (it & 1) * kStage;
    const float* sl = st + 2 * KT * P;
    const float* sd = sl + KT;
    tf_presplit<HD, 2 * KT, kThr>(st, slo);
    __syncthreads();
    if (!causal || i0 + KT - 1 >= kw) {
      float s[2][NT][4];
      const float* Bqd[2] = {st, st + KT * P};
      const float* Lqd[2] = {slo, slo + KT * P};
      tf_scores<HD, NT, 2, true>(s, A, Bqd, Lqd);
      FragA pa[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + 2 * t + (e & 1), row = i0 + c;
          const int key = e < 2 ? key0 : key1;
          p[e] = (row < Sq && keep(key, row, Skv, causal))
                     ? expf(s[0][nt][e] * scale - sl[c])
                     : 0.f;
          s[1][nt][e] = p[e] * (s[1][nt][e] - sd[c]) * scale;
        }
        pa[nt] = c_frag(p);
      }
      tf_accumulate<HD, KT, false, true>(dva, pa, st + KT * P, slo + KT * P,
                                         1.f, 1.f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) pa[nt] = c_frag(s[1][nt]);
      tf_accumulate<HD, KT, false, true>(dka, pa, st, slo, 1.f, 1.f);
    }
    __syncthreads();
  }
  // [B, Skv, H, hd] rows of head h (with H == KV that is dk / dv itself)
  const size_t out = ((size_t)b * Skv * H + h) * HD;
  tf_store<HD>(dk + out, (size_t)H * HD, dka, key0, Skv, 1.f, 1.f);
  tf_store<HD>(dv + out, (size_t)H * HD, dva, key0, Skv, 1.f, 1.f);
}

bool fa_args_ok(int B, int H, int KV, int Sq, int Skv, int hd, int causal,
                int dtype) {
  return B > 0 && KV > 0 && H % KV == 0 && Sq > 0 && Skv > 0 &&
         (hd == 32 || hd == 64 || hd == 80 || hd == 128) &&
         (dtype == kF32 || dtype == kBF16) &&
         (!causal || Sq == Skv) && B <= 65535 && H <= 65535;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The column-slab maps of one [B, S, N, hd] bf16 tensor, boxes of `rows`:
// 64 columns (none at hd 32) and 16 (hd 32, 80); a map a head dim has no
// slab for is a copy of the other.
cudaError_t tile_maps(TileMaps* t, const void* p, int B, int S, int N, int hd,
                      int rows) {
  cudaError_t e = cudaSuccess;
  if (hd >= 64) e = encode_rows_map(&t->m, p, B, S, N, hd, 64, rows, 128);
  if (e == cudaSuccess && hd % 64)
    e = encode_rows_map(&t->tail, p, B, S, N, hd, 16, rows, 32);
  if (hd < 64)
    t->m = t->tail;
  else if (hd % 64 == 0)
    t->tail = t->m;
  return e;
}

template <typename K>
cudaError_t opt_in_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The f32 forward: split TF32 on mma.sync.
template <int HD>
int fwd_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int KV, int Sq, int Skv, float scale, int causal,
             cudaStream_t st) {
  constexpr int smem = tf_fwd_bytes<HD>();
  const cudaError_t e = opt_in_smem(fa_fwd_tf32<HD>, smem);
  if (e != cudaSuccess) return e;
  constexpr int kThr = 32 * kTfFwdWarps;
  fa_fwd_tf32<HD><<<dim3(cdiv(Sq, kThr / 2), H, B), kThr, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
      Skv, scale, causal);
  return cudaGetLastError();
}

// The bf16 forward on wgmma.
template <int HD>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o,
              float* o32, float* lse, int B, int H, int KV, int Sq, int Skv,
              float scale, int causal, cudaStream_t st) {
  constexpr int kQRows = 64 * consumers<HD>();
  TileMaps tq, tk, tv;
  cudaError_t e = tile_maps(&tq, q, B, Sq, H, HD, kQRows);
  if (e == cudaSuccess) e = tile_maps(&tk, k, B, Skv, KV, HD, fwd_keys<HD>());
  if (e == cudaSuccess) e = tile_maps(&tv, v, B, Skv, KV, HD, fwd_keys<HD>());
  const int smem = 1024 + tile_bytes<HD, kQRows>() +
                   2 * kStages * tile_bytes<HD, fwd_keys<HD>()>() +
                   8 * (1 + 3 * kStages);
  if (e == cudaSuccess) e = opt_in_smem(fa_fwd_wgmma<HD>, smem);
  if (e != cudaSuccess) return e;
  fa_fwd_wgmma<HD><<<dim3(H, B, cdiv(Sq, kQRows)), cta_threads<HD>(), smem,
                     st>>>(
      tq, tk, tv, static_cast<bf16*>(o), o32, lse, H, KV, Sq, Skv,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* o32, float* lse, int B, int H, int KV, int Sq, int Skv,
               float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return fwd_tf32<HD>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal,
                        st);
  return fwd_wgmma<HD>(q, k, v, o, o32, lse, B, H, KV, Sq, Skv, scale, causal,
                       st);
}

// dq (parts & 2) and dk/dv (parts & 4) in f32, split TF32 on mma.sync;
// delta rows of Sq elements; with H > KV each query head's dk and dv go to
// the partials [2, B, Skv, H, hd], summed by fa_dkv_reduce.
template <int HD>
int bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, float* partial, void* dq,
             void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
             float scale, int causal, int parts, cudaStream_t st) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  constexpr int kThr = 32 * tf_bwd_warps<HD>();
  if (parts & 2) {
    constexpr int smem = tf_dq_bytes<HD>();
    cudaError_t e = opt_in_smem(fa_dq_tf32<HD>, smem);
    if (e != cudaSuccess) return e;
    fa_dq_tf32<HD><<<dim3(cdiv(Sq, kThr / 2), H, B), kThr, smem, st>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dq), H, KV, Sq, Skv,
        scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (parts & 4) {
    const int G = H / KV;
    float* dkp = G > 1 ? partial : static_cast<float*>(dk);
    float* dvp = G > 1 ? partial + (size_t)B * Skv * H * HD
                       : static_cast<float*>(dv);
    constexpr int smem = tf_dkv_bytes<HD>();
    cudaError_t e = opt_in_smem(fa_dkv_tf32<HD>, smem);
    if (e != cudaSuccess) return e;
    fa_dkv_tf32<HD><<<dim3(cdiv(Skv, kThr / 2), H, B), kThr, smem,
                      st>>>(qf, kf, vf, df, lse, delta, dkp, dvp, H, KV, Sq,
                            Skv, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess || G == 1) return e;
    const long long n4 = (long long)B * Skv * KV * HD / 4;
    fa_dkv_reduce<<<(int)((n4 + 255) / 256), 256, 0, st>>>(
        dkp, dvp, static_cast<float*>(dk), static_cast<float*>(dv), n4, KV,
        G, HD);
  }
  return cudaGetLastError();
}

// dq and dk/dv in bf16 on wgmma, after fa_delta.
template <int HD>
int bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const float* lse2, const float* delta, float* partial, void* dq,
              void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
              int pitch, float scale, int causal, int parts,
              cudaStream_t st) {
  constexpr int kRows = 64 * consumers<HD>();  // dq: queries, dk/dv: keys
  if (parts & 2) {
    TileMaps tq, tdo, tk, tv;
    cudaError_t e = tile_maps(&tq, q, B, Sq, H, HD, kRows);
    if (e == cudaSuccess) e = tile_maps(&tdo, dout, B, Sq, H, HD, kRows);
    if (e == cudaSuccess) e = tile_maps(&tk, k, B, Skv, KV, HD, kDqKeys);
    if (e == cudaSuccess) e = tile_maps(&tv, v, B, Skv, KV, HD, kDqKeys);
    const int smem = 1024 + 2 * tile_bytes<HD, kRows>() +
                     2 * kStages * tile_bytes<HD, kDqKeys>() +
                     8 * (1 + 3 * kStages);
    if (e == cudaSuccess) e = opt_in_smem(fa_dq_wgmma<HD>, smem);
    if (e != cudaSuccess) return e;
    fa_dq_wgmma<HD><<<dim3(H, B, cdiv(Sq, kRows)), cta_threads<HD>(), smem,
                      st>>>(
        tq, tdo, tk, tv, lse2, delta, static_cast<bf16*>(dq), H, KV, Sq, Skv,
        pitch, scale, scale * kLog2e, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (parts & 4) {
    const int G = H / KV;
    float* dkp = partial;
    float* dvp = G > 1 ? partial + (size_t)B * Skv * H * HD : nullptr;
    TileMaps tk, tv, tq, tdo;
    CUtensorMap tl, td;
    cudaError_t e = tile_maps(&tk, k, B, Skv, KV, HD, kRows);
    if (e == cudaSuccess) e = tile_maps(&tv, v, B, Skv, KV, HD, kRows);
    if (e == cudaSuccess) e = tile_maps(&tq, q, B, Sq, H, HD, kDkvRows);
    if (e == cudaSuccess) e = tile_maps(&tdo, dout, B, Sq, H, HD, kDkvRows);
    if (e == cudaSuccess)
      e = encode_f32_rows_map(&tl, lse2, B * H, pitch, kDkvRows);
    if (e == cudaSuccess)
      e = encode_f32_rows_map(&td, delta, B * H, pitch, kDkvRows);
    const int smem = 1024 + 2 * tile_bytes<HD, kRows>() +
                     kStages * (2 * tile_bytes<HD, kDkvRows>() + 1024) +
                     8 * (1 + 2 * kStages);
    if (e == cudaSuccess) e = opt_in_smem(fa_dkv_wgmma<HD>, smem);
    if (e != cudaSuccess) return e;
    fa_dkv_wgmma<HD><<<dim3(H, B, cdiv(Skv, kRows)), cta_threads<HD>(),
                       smem, st>>>(
        tk, tv, tq, tdo, tl, td, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), dkp, dvp, H, KV, Sq, Skv, scale,
        scale * kLog2e, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess || G == 1) return e;
    const long long n4 = (long long)B * Skv * KV * HD / 4;
    fa_dkv_reduce<<<(int)((n4 + 255) / 256), 256, 0, st>>>(
        dkp, dvp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4, KV, G,
        HD);
  }
  return cudaGetLastError();
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* stats,
               float* partial, void* dq, void* dk, void* dv, int B, int H,
               int KV, int Sq, int Skv, int pitch, float scale, int causal,
               int dtype, int parts, int o_f32, cudaStream_t st) {
  float* lse2 = stats;
  float* delta = stats + (size_t)B * H * pitch;
  if ((parts & 1) && dtype == kBF16) {
    const long long threads = 32LL * B * pitch * H;
    const int blocks = (int)((threads + 255) / 256);
    if (o_f32)
      fa_delta<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(o), static_cast<const bf16*>(dout), lse,
          lse2, delta, B, H, Sq, HD, pitch);
    else
      fa_delta<bf16><<<blocks, 256, 0, st>>>(
          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
          lse2, delta, B, H, Sq, HD, pitch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (dtype == kF32)
    return bwd_tf32<HD>(q, k, v, dout, lse, delta, partial, dq, dk, dv, B, H,
                        KV, Sq, Skv, scale, causal, parts, st);
  return bwd_wgmma<HD>(q, k, v, dout, lse2, delta, partial, dq, dk, dv, B, H,
                       KV, Sq, Skv, pitch, scale, causal, parts, st);
}

}  // namespace

extern "C" {

// q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (dtype: 0 f32, 1 bf16), contiguous and
// 16-byte aligned; o [B,Sq,H,hd] in the same dtype and lse [B,H,Sq] f32 are
// written, and (bf16, if o32 is not null) o32 [B,Sq,H,hd] f32, the output
// before its rounding to bf16. hd is 32, 64, 80 or 128; causal needs
// Sq == Skv.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* o32, float* lse, int B, int H,
                               int KV, int Sq, int Skv, int hd, float scale,
                               int causal, int dtype, void* stream) {
  if (!fa_args_ok(B, H, KV, Sq, Skv, hd, causal, dtype) ||
      (o32 != nullptr && dtype != kBF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32)
    return launch_fwd<32>(q, k, v, o, o32, lse, B, H, KV, Sq, Skv, scale,
                          causal, dtype, st);
  if (hd == 64)
    return launch_fwd<64>(q, k, v, o, o32, lse, B, H, KV, Sq, Skv, scale,
                          causal, dtype, st);
  if (hd == 80)
    return launch_fwd<80>(q, k, v, o, o32, lse, B, H, KV, Sq, Skv, scale,
                          causal, dtype, st);
  return launch_fwd<128>(q, k, v, o, o32, lse, B, H, KV, Sq, Skv, scale,
                         causal, dtype, st);
}

// The forward's inputs, its o (bf16: or, with o_f32, its o32) and lse, do
// [B,Sq,H,hd] (the inputs' dtype); writes
// dq [B,Sq,H,hd] and dk, dv [B,Skv,KV,hd] in the inputs' dtype. Scratch:
// stats [2, B, H, pitch] f32 (bf16: lse * log2 e and delta, written by the
// delta launch, pitch a multiple of 128 at least Sq; f32: pitch = Sq and
// stats[1] holds delta on entry) and, with H > KV, partial [2, B, Skv, H,
// hd] f32 (the dk and dv of each query head).
// parts selects the launches (1 delta, 2 dq, 4 dk/dv; 7 for the whole
// backward), so that each can be timed alone.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* stats, float* partial,
                               void* dq, void* dk, void* dv, int B, int H,
                               int KV, int Sq, int Skv, int hd, int pitch,
                               float scale, int causal, int dtype, int parts,
                               int o_f32, void* stream) {
  if (!fa_args_ok(B, H, KV, Sq, Skv, hd, causal, dtype) ||
      (dtype == kF32 ? pitch != Sq : pitch % 128 != 0 || pitch < Sq) ||
      (H != KV && partial == nullptr) ||
      (o_f32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32)
    return launch_bwd<32>(q, k, v, o, dout, lse, stats, partial, dq, dk, dv, B,
                          H, KV, Sq, Skv, pitch, scale, causal, dtype, parts,
                          o_f32, st);
  if (hd == 64)
    return launch_bwd<64>(q, k, v, o, dout, lse, stats, partial, dq, dk, dv, B,
                          H, KV, Sq, Skv, pitch, scale, causal, dtype, parts,
                          o_f32, st);
  if (hd == 80)
    return launch_bwd<80>(q, k, v, o, dout, lse, stats, partial, dq, dk, dv, B,
                          H, KV, Sq, Skv, pitch, scale, causal, dtype, parts,
                          o_f32, st);
  return launch_bwd<128>(q, k, v, o, dout, lse, stats, partial, dq, dk, dv, B,
                         H, KV, Sq, Skv, pitch, scale, causal, dtype, parts,
                         o_f32, st);
}

}  // extern "C"
