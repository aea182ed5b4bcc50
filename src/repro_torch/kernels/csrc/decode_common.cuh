// Device code shared by the paged (K1, paged_decode.cu) and dense (K2,
// dense_decode.cu) flash-decode kernels: one query token per row against a
// K/V store of one token row ([KV, hd]) per position.
//
// Where a position lives is the only difference between the two, so the
// kernels take it as a policy, `Rows`, with
//   int BS, cap;                             page size; positions a row holds
//   __device__ int token(int b, int pos)     flat token index of row b's
//                                            position pos (its K row is at
//                                            (token * KV + kvh) * hd)
//   __device__ int page_start(int b, int p)  token(b, p * BS)
// PagedRows reads a block table (K1); DenseRows computes b * S + pos (K2:
// the carried cache [B,S,KV,hd], no transpose).
//
// What bounds both is bytes: every valid K/V position is read once per
// step (2 * sum(min(lens, cap)) * KV * hd * itemsize bytes) for 4 * hd * G
// FLOPs, G = H / KV, about G FLOPs per byte in bf16 against the ~295 the
// card needs to be compute-bound; and at serving's rows of a few hundred
// positions, latency: a call is a few dependent memory round trips. So:
//   * one CTA per (row, KV head, split of the row) reads each position
//     once and serves all G query heads of that KV head from it (the Pallas
//     index maps fetch the same block once per query head), and reads only
//     positions below the row's length (the Pallas grids walk the whole
//     table and mask);
//   * decode_ring, bf16 queries on bf16 or int8 K/V at head dim 64, 80 or
//     128 (every config's), keeps loads in flight while it computes: each
//     of its 4 warps owns a ring of kStages (3-4) stripes of 16 positions in
//     shared memory, filled by cp.async 16-byte copies in commit groups, and
//     takes the stripes [16 w, 16 w + 16) of the split's 64-position tiles
//     in turn, so the next stripes' bytes are in flight while the current
//     one is in the products. cp.async, not TMA: K1's positions sit on
//     16-token pages anywhere in the arena (one TMA box each), a copy's
//     src-size of 0 writes the zeros that mask a row's end without another
//     pass, and a call encodes no tensor map on the host, which serving,
//     bound by its host, would pay every step. A warp's ring is its own, so
//     the only barriers are __syncwarp until the split's end;
//   * both products on the tensor cores (mma.sync m16n8k16, the G heads
//     padded to M = 16; at about G FLOPs per byte a 64-row wgmma would only
//     pad more), the softmax in registers: each warp keeps its own running
//     (m, l, o) over the whole head for the positions it took, and the four
//     are merged once per split, in warp order, in shared memory (the ring's
//     space, drained by then). bf16 K and V are read by ldmatrix (V
//     transposed); int8 K and V land in the ring as raw bytes, half of
//     bf16's, and become bf16 in registers as the fragments are formed
//     (exactly: |q| <= 128), with the dims of the products permuted so that
//     each thread reads whole words; 1 / QSCALE scales the f32 scores and
//     outputs instead (a power of two: the same numbers);
//   * a K1 stripe's block-table reads are issued together, before its
//     copies, so a stripe waits for one page lookup, not one per copy;
//   * every CTA reads all the call's lengths and cuts each row into at most
//     NS splits of whole 64-position tiles, long enough that the call makes
//     about as many splits as the card holds CTAs at once (`target`), and
//     at least min_split positions (merging costs more than a shorter split
//     saves); a row of one split is normalised and written by its CTA, so a
//     call of short rows is one launch. The splits of a longer row are
//     merged by the CTA that takes the row's last ticket (a counter per
//     (row, KV head), released and acquired with the partials, that it
//     resets), in split order, so two calls on the same inputs give the
//     same bits. The merge folds in the step's new token as a partial with
//     m = q . k_new * scale, l = 1 and o = v_new, so attending it costs no
//     pass over the cache;
//   * the step's new token is also written here, not by a launch of its
//     own: one CTA per (row, KV head) stores its K and V rows at the row's
//     slot (a flat token index of the cache; outside [0, n_slots) dropped)
//     in the cache's dtype, int8 as rint(x * QSCALE) clipped to +-127. In
//     decode_ring it is the CTA of split 0, once its first cp.async groups
//     are in flight, so the store overlaps the loads; in the CUDA-core path
//     decode_merge's CTA of the group's first head. K1 attends the token as
//     the cache stores it (the reference writes, then reads it back); K2
//     attends it unquantised (the carried branch's two-part softmax).
//     There is no read-write hazard inside a launch: a row attends only its
//     positions below lens[b] = cache_len[b], and its slot is position
//     cache_len[b] (K1: bt[b, cl / BS] * BS + cl % BS; K2: b * S + cl), so
//     no CTA reads what another writes; inactive K1 rows (lens 0) write
//     into the pool's null block, which no row attends.
// Everything else (f32 queries, other head dims) runs decode_split on the
// CUDA cores in f32: pages in tiles of 64 tokens loaded as f32 into shared
// memory, one thread per (head, token) score, a grid of CTAs striding over
// fixed splits, then decode_merge. Accumulation is f32 throughout.
//
// Built with GENESYS_DECODE_STAMPS defined (the --stamps build of
// experiments/torch_decode_compare.py), the CTA that merges a row's splits
// records %globaltimer at each step of the merge in decode_stamps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;         // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;         // query heads per KV head in one CTA
constexpr int kMaxSplits = 64;        // split slots of a row (ring kernel)
constexpr int kMaxDimsPerThread = 2;  // head_dim <= 256
constexpr float kLog2e = 1.4426950408889634f;

// The two kernels a call can take (the wrapper picks, decode_attention.py).
enum Variant { kRing = 0, kCudaCore = 1 };

// Positions of row b that are attended: lens[b] clipped to [0, cap].
__device__ __forceinline__ int valid_len(const int* lens, int b, int cap) {
  const int len = lens[b];
  return len <= 0 ? 0 : (len < cap ? len : cap);
}

// Pages of a row that hold at least one position below its length.
__device__ __forceinline__ int valid_pages(int len, int BS) {
  return (len + BS - 1) / BS;
}

// K1: pages through the block table [B, MB]. The new token is attended as
// the arena stores it (int8: rounded and clipped).
struct PagedRows {
  static constexpr bool kNewAsStored = true;
  const int* bt;
  int MB, BS, cap;  // cap = MB * BS
  int shift;        // log2(BS) when BS is a power of two, else -1
  __device__ __forceinline__ int page_start(int b, int p) const {
    return bt[(size_t)b * MB + p] * BS;
  }
  __device__ __forceinline__ int token(int b, int pos) const {
    return shift >= 0 ? page_start(b, pos >> shift) + (pos & (BS - 1))
                      : page_start(b, pos / BS) + pos % BS;
  }
};

// K2: row b's S positions are contiguous from token b * S (pages of BS = 64
// for the CUDA-core kernel). The new token is attended unquantised.
struct DenseRows {
  static constexpr bool kNewAsStored = false;
  int S, BS, cap;  // cap = S
  __device__ __forceinline__ int page_start(int b, int p) const {
    return b * S + p * BS;
  }
  __device__ __forceinline__ int token(int b, int pos) const {
    return b * S + pos;
  }
};

#ifdef GENESYS_DECODE_STAMPS
// %globaltimer stamps of the CTA that merges the splits of (row, KV head)
// pair: 0 its start, 1 its partial stored (the row's last split's end), 2
// its ticket taken, 3 the splits' (m, l) loaded, 4 the first batch of
// part_o staged, 5 its products done and its outputs' stores issued, 6
// every thread's; 7 the start of the pair's split-0 CTA. Thread 0 writes
// them; each call overwrites.
constexpr int kStampPairs = 1024;
constexpr int kStamps = 8;
__device__ unsigned long long decode_stamps[kStampPairs * kStamps];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp_at(int pair, int i,
                                         unsigned long long t) {
  if (threadIdx.x == 0 && pair < kStampPairs)
    decode_stamps[pair * kStamps + i] = t;
}
#else
__device__ __forceinline__ unsigned long long stamp_now() { return 0; }
__device__ __forceinline__ void stamp_at(int, int, unsigned long long) {}
#endif
__device__ __forceinline__ void stamp(int pair, int i) {
  stamp_at(pair, i, stamp_now());
}

// ---- the step's new token -------------------------------------------------

// The int8 level of x: rint(x / kv_scale) (half to even, as torch.round and
// jnp.round; kv_scale = 1 / QSCALE is a power of two, so x times its
// reciprocal is exact) clipped to +-127.
__device__ __forceinline__ float q8_level(float x, float kv_scale) {
  return fminf(fmaxf(rintf(x * __frcp_rn(kv_scale)), -127.f), 127.f);
}

// An element of the new token as the cache stores it.
template <typename KT, typename QT>
__device__ __forceinline__ KT stored(QT x, float kv_scale) {
  if constexpr (std::is_same<KT, int8_t>::value)
    return static_cast<int8_t>(q8_level(to_float(x), kv_scale));
  else
    return from_float<KT>(to_float(x));  // KT is QT
}

// An element of the new token as the call attends it: q8_scale > 0 (K1 on
// an int8 arena) reads it back as stored, else it is attended as given.
__device__ __forceinline__ float attended(float x, float q8_scale) {
  return q8_scale > 0.f ? q8_level(x, q8_scale) * q8_scale : x;
}

// The new token of row b and KV head kvh (kn, vn [hd]) stored at the
// row's slot of the cache kc / vc (token rows of KV * hd elements); a slot
// outside [0, n_slots) is dropped. The CTA's threads take the dims in turn.
template <typename KT, typename QT>
__device__ __forceinline__ void write_new(KT* kc, KT* vc, const QT* kn,
                                          const QT* vn, const int* slots,
                                          int b, long long n_slots, int KV,
                                          int kvh, int hd, float kv_scale) {
  const long long s = slots[b];
  if (s < 0 || s >= n_slots) return;
  const size_t at = ((size_t)s * KV + kvh) * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    kc[at + d] = stored<KT>(kn[d], kv_scale);
    vc[at + d] = stored<KT>(vn[d], kv_scale);
  }
}

// ---- the CUDA-core split kernel: f32 queries, other head dims ---------------

// 16 bytes of a K/V row -> kElems floats times `scale`, stored to shared
// memory as float4s (dst is 16-byte aligned).
template <typename KT>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void store(const uint4& r, float* dst,
                                               float s) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(__uint_as_float(r.x) * s, __uint_as_float(r.y) * s,
                    __uint_as_float(r.z) * s, __uint_as_float(r.w) * s);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static float lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  __device__ __forceinline__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void store(const uint4& r, float* dst,
                                               float s) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(lo(r.x) * s, hi(r.x) * s, lo(r.y) * s, hi(r.y) * s);
    d[1] = make_float4(lo(r.z) * s, hi(r.z) * s, lo(r.w) * s, hi(r.w) * s);
  }
};
template <>
struct Chunk<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static float b(uint32_t w, int i) {
    return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
  }
  __device__ __forceinline__ static void store(const uint4& r, float* dst,
                                               float s) {
    float4* d = reinterpret_cast<float4*>(dst);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = make_float4(b(w[k], 0) * s, b(w[k], 1) * s, b(w[k], 2) * s,
                         b(w[k], 3) * s);
  }
};

// Tokens one CTA holds in shared memory at a time (whole pages).
constexpr int kTileTokens = 64;
// 16-byte loads per thread per tensor kept in flight together.
constexpr int kLoadIters = 4;

__host__ __device__ __forceinline__ int tile_pages(int BS) {
  return BS < kTileTokens ? kTileTokens / BS : 1;
}

// Shared memory of the CUDA-core split kernel, in floats (plus the tile's
// page starts).
__host__ __device__ __forceinline__ size_t split_smem_bytes(int G, int hd,
                                                            int BS) {
  const size_t qs = hd + 4, tt = (size_t)tile_pages(BS) * BS;
  return (G * qs + 2 * tt * qs + G * tt + 3 * G) * sizeof(float) +
         tile_pages(BS) * sizeof(int);
}

// One CTA: row b, KV head kvh, and the splits blockIdx.x, blockIdx.x +
// gridDim.x, ... of the row's valid pages (split s = pages [s * pps,
// s * pps + pps)); the grid is sized to the card, not to the rows, so a
// short row costs few idle CTAs. Each split is walked in tiles of whole
// pages (64 tokens).
// Per tile: every thread issues its 16-byte K and V loads together, the
// tile lands in shared memory as f32 (dequantised), one thread per (head,
// token) computes a score with float4 reads, one warp per head updates the
// online softmax, and each thread folds the tile's V into its head dims for
// all G heads. Writes the unnormalised f32 accumulator and (max, sum).
template <typename QT, typename KT, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_split(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const Rows rows, const int* __restrict__ lens,
    float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KV,
    int hd, int pps, int NS, float scale, float kv_scale) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int BS = rows.BS;
  const int len = valid_len(lens, b, rows.cap);
  const int p_end = valid_pages(len, BS);
  const int n_run = (p_end + pps - 1) / pps;  // splits with valid pages
  if ((int)blockIdx.x >= n_run) return;

  constexpr int E = Chunk<KT>::kElems;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TP = tile_pages(BS), TT = TP * BS;
  const int QS = hd + 4;    // padded row stride: float4-aligned, few conflicts
  const int cpr = hd / E;   // 16-byte chunks per token row

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [G, QS]   query heads of this KV head
  float* ks = qs + G * QS;      // [TT, QS]  the tile's keys, f32
  float* vs = ks + TT * QS;     // [TT, QS]  the tile's values, f32
  float* ps = vs + TT * QS;     // [G, TT]   scores, then softmax weights
  float* m_s = ps + G * TT;     // [G]       running max
  float* l_s = m_s + G;         // [G]       running denominator
  float* c_s = l_s + G;         // [G]       this tile's rescale factor
  int* blk_s = reinterpret_cast<int*>(c_s + G);   // [TP] the tile's pages

  const size_t q0 = ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    qs[g * QS + (i - g * hd)] = to_float(q[q0 + i]);
  }
  const size_t tok_stride = (size_t)KV * hd;  // one token row of the store
  for (int split = blockIdx.x; split < n_run; split += gridDim.x) {
    const int p0 = split * pps;
    const int p1 = p0 + pps < p_end ? p0 + pps : p_end;
    if (tid < G) {  // only thread tid touches m_s[tid] / l_s[tid] here
      m_s[tid] = -CUDART_INF_F;
      l_s[tid] = 0.f;
    }

    float acc[kMaxGroup][kMaxDimsPerThread];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
      for (int j = 0; j < kMaxDimsPerThread; ++j) acc[g][j] = 0.f;

    for (int p = p0; p < p1; p += TP) {
      const int n_tok = (p1 - p < TP ? p1 - p : TP) * BS;  // tile's extent
      const int live = len - p * BS;                  // >= 1 on a valid page
      const int n_live = live < n_tok ? live : n_tok;  // tokens below len
      __syncthreads();  // the previous tile's ks, vs and ps are consumed
      if (tid < n_tok / BS) blk_s[tid] = rows.page_start(b, p + tid);
      __syncthreads();
      const int n_chunks = n_live * cpr;
      for (int c0 = 0; c0 < n_chunks; c0 += kThreads * kLoadIters) {
        uint4 kr[kLoadIters], vr[kLoadIters];
#pragma unroll
        for (int u = 0; u < kLoadIters; ++u) {
          const int c = c0 + u * kThreads + tid;
          if (c < n_chunks) {
            const int r = c / cpr, w = c - r * cpr;
            const size_t off =
                (size_t)(blk_s[r / BS] + r % BS) * tok_stride +
                (size_t)kvh * hd + (size_t)w * E;
            kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + off));
            vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + off));
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadIters; ++u) {
          const int c = c0 + u * kThreads + tid;
          if (c < n_chunks) {
            const int r = c / cpr, w = c - r * cpr;
            Chunk<KT>::store(kr[u], ks + r * QS + w * E, kv_scale);
            Chunk<KT>::store(vr[u], vs + r * QS + w * E, kv_scale);
          }
        }
      }
      __syncthreads();
      // scores: one thread per (head, token), two f32 partial sums along hd
      for (int pr = tid; pr < G * n_tok; pr += kThreads) {
        const int g = pr / n_tok, t = pr - g * n_tok;
        float s = -CUDART_INF_F;
        if (t < n_live) {
          const float4* qa = reinterpret_cast<const float4*>(qs + g * QS);
          const float4* ka = reinterpret_cast<const float4*>(ks + t * QS);
          float s0 = 0.f, s1 = 0.f;
          for (int d4 = 0; d4 < hd / 4; d4 += 2) {
            const float4 a0 = qa[d4], k0 = ka[d4];
            const float4 a1 = qa[d4 + 1], k1 = ka[d4 + 1];
            s0 = fmaf(a0.x, k0.x, s0);
            s0 = fmaf(a0.y, k0.y, s0);
            s0 = fmaf(a0.z, k0.z, s0);
            s0 = fmaf(a0.w, k0.w, s0);
            s1 = fmaf(a1.x, k1.x, s1);
            s1 = fmaf(a1.y, k1.y, s1);
            s1 = fmaf(a1.z, k1.z, s1);
            s1 = fmaf(a1.w, k1.w, s1);
          }
          s = (s0 + s1) * scale;
        }
        ps[g * TT + t] = s;
      }
      __syncthreads();
      // online softmax, one warp per head, lanes across the tile's tokens; the
      // tile holds a live token, so m_new is finite and masked scores weigh 0
      for (int g = warp; g < G; g += kThreads / 32) {
        float* pg = ps + g * TT;
        float mx = -CUDART_INF_F;
        for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, pg[t]);
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < n_tok; t += 32) {
          const float e = expf(pg[t] - m_new);
          pg[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float c = expf(m_old - m_new);  // m_old = -inf -> 0
          l_s[g] = l_s[g] * c + sum;
          m_s[g] = m_new;
          c_s[g] = c;
        }
      }
      __syncthreads();
      // acc[g][d] = acc[g][d] * c[g] + sum_t p[g][t] * v[t][d]
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float c = c_s[g];
#pragma unroll
          for (int j = 0; j < kMaxDimsPerThread; ++j) acc[g][j] *= c;
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxDimsPerThread; ++j) {
        const int d = tid + j * kThreads;
        if (d < hd) {
          for (int t = 0; t < n_live; ++t) {
            const float v = vs[t * QS + d];
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g)
              if (g < G) acc[g][j] = fmaf(ps[g * TT + t], v, acc[g][j]);
          }
        }
      }
    }

    const int h0 = kvh * G;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float* o = part_o + (((size_t)b * H + h0 + g) * NS + split) * hd;
#pragma unroll
        for (int j = 0; j < kMaxDimsPerThread; ++j) {
          const int d = tid + j * kThreads;
          if (d < hd) o[d] = acc[g][j];
        }
      }
    }
    if (tid < G) {
      float* ml = part_ml + (((size_t)b * H + h0 + tid) * NS + split) * 2;
      ml[0] = m_s[tid];
      ml[1] = l_s[tid];
    }
  }  // splits
}

// One CTA per (row, query head): log-sum-exp merge of the splits that ran,
// and of the new token (k_new, v_new [B,KV,hd] in q's dtype) when given:
// its partial is m = q . k_new * scale, l = 1, o = v_new (read back as
// stored where q8_new > 0). With slots, the CTA of the group's first head
// also writes the token into kc / vc (n_slots token rows).
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) decode_merge(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lens, const QT* __restrict__ q,
    const QT* __restrict__ k_new, const QT* __restrict__ v_new,
    QT* __restrict__ out, KT* kc, KT* vc, const int* __restrict__ slots,
    long long n_slots, int H, int KV, int hd, int cap, int split_tokens,
    int NS, float scale, float kv_scale, float q8_new) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (slots != nullptr && h % (H / KV) == 0) {
    const size_t row = ((size_t)b * KV + h / (H / KV)) * hd;
    write_new(kc, vc, k_new + row, v_new + row, slots, b, n_slots, KV,
              h / (H / KV), hd, kv_scale);
  }
  const int len = valid_len(lens, b, cap);
  const int n_run = (len + split_tokens - 1) / split_tokens;
  const float* ml = part_ml + (size_t)bh * NS * 2;
  float m = -CUDART_INF_F;
  for (int s = 0; s < n_run; ++s) m = fmaxf(m, ml[2 * s]);
  const size_t kv_row = ((size_t)b * KV + h / (H / KV)) * hd;
  float s_new = -CUDART_INF_F;
  if (k_new != nullptr) {
    __shared__ float red[kThreads / 32];
    float part = 0.f;
    for (int d = tid; d < hd; d += kThreads)
      part = fmaf(to_float(q[(size_t)bh * hd + d]),
                  attended(to_float(k_new[kv_row + d]), q8_new), part);
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) dot += red[w];
    s_new = dot * scale;
    m = fmaxf(m, s_new);
  }
  float den = 0.f;
  for (int s = 0; s < n_run; ++s) den += ml[2 * s + 1] * expf(ml[2 * s] - m);
  const float p_new = k_new != nullptr ? expf(s_new - m) : 0.f;
  den += p_new;
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = tid; d < hd; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_run; ++s)
      o += part_o[((size_t)bh * NS + s) * hd + d] * expf(ml[2 * s] - m);
    if (v_new != nullptr)
      o = fmaf(p_new, attended(to_float(v_new[kv_row + d]), q8_new), o);
    out[(size_t)bh * hd + d] = from_float<QT>(o * inv);
  }
}

// ---- the ring kernel: bf16 queries on bf16 or int8 K/V, hd 64 / 80 / 128 ---

constexpr int kStripe = 16;  // positions a warp takes from each 64-wide tile

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); .trans hands each thread a column pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

// Takes a ticket: atomic add of 1, returning the old count, with release
// (the writes this thread has seen happen before it at GPU scope) and
// acquire (what the earlier tickets released is seen after it).
__device__ __forceinline__ int ticket_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Byte k of a word of int8 biased by 128 (w ^ 0x80808080) as an exact f32:
// the bits 0x4B0000uu are 2^23 + uu.
__device__ __forceinline__ float s8_f32(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | k)) -
         8388736.f;
}
// Two f32 that bf16 holds exactly (integers of at most 8 bits) as one
// bf16 pair: their upper halves.
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t biased, int k0,
                                                int k1) {
  return bf16x2_exact(s8_f32(biased, k0), s8_f32(biased, k1));
}
// Four (two) int8 from shared memory as a word biased by 128.
__device__ __forceinline__ uint32_t biased4(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t biased2(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
}

__device__ __forceinline__ void add_scores(float (&sc)[2][4],
                                           const float (&odd)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] += odd[j][e];
}

// Shared-memory layout of a warp's ring: each stage holds a stripe's 16 K
// rows, then its 16 V rows. Row strides are padded so that the reads of a
// stripe touch distinct banks: an odd number of 16-byte units for bf16
// (ldmatrix: 8 rows of 16 bytes) and for int8 V (4-byte words of rows 2
// apart), an odd number of 32-byte units for int8 K (8-byte words of 4
// rows).
template <typename KT, int HD>
struct RingShape {
  static constexpr int kRowBytes = HD * (int)sizeof(KT);
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies per row
  static constexpr int kVStride =
      kChunks % 2 == 0 ? kRowBytes + 16 : kRowBytes;
  static constexpr int kK32 = (kRowBytes + 31) / 32 * 32;
  static constexpr int kKStride =
      std::is_same<KT, int8_t>::value ? (kK32 % 64 == 0 ? kK32 + 32 : kK32)
                                      : kVStride;
  static constexpr int kStageBytes = kStripe * (kKStride + kVStride);
  // four stages where two CTAs still fit an SM, else three
  static constexpr int kStages =
      kWarps * 4 * kStageBytes <= 100 * 1024 ? 4 : 3;
  static constexpr int kSmem = kWarps * kStages * kStageBytes;
  // the split's merge reuses the ring: [kWarps][G][HD] o, [kWarps][G][2] ml
  static_assert(kWarps * kMaxGroup * (HD + 2) * 4 <= kSmem, "merge space");
  // ... and the last CTA's merge of the splits: (m, l) of every split and
  // at least one split's o rows (merge_splits)
  static_assert((2 * kMaxGroup * kMaxSplits + 2 * kMaxGroup + 4) * 4 +
                        2 * kMaxGroup * HD * 4 <=
                    kSmem,
                "split merge space");
  static_assert(HD % 16 == 0 && kRowBytes % 16 == 0, "whole copies");
};

// How a stripe's K and V become mma fragments, per K/V dtype. q_col(s, tig,
// half) is the head dim of Q's A-fragment column pair (a0/a1 for half 0,
// a2/a3 for half 1) in k-step s, o_dim(f, tig, e) the head dim of column
// 2 tig + e of output fragment f; scores() and pv() run a stripe's two
// products. The 16-token stripe is the scores' N (two 8-token fragments)
// and PV's K: P's A fragment is the score fragments, packed to bf16.
template <typename KT, int HD>
struct RingFrags;

// bf16: ldmatrix reads K as it lies and V transposed; dims in order.
template <int HD>
struct RingFrags<__nv_bfloat16, HD> {
  using Shape = RingShape<__nv_bfloat16, HD>;
  __device__ __forceinline__ static int q_col(int s, int tig, int half) {
    return 16 * s + 2 * tig + 8 * half;
  }
  __device__ __forceinline__ static int o_dim(int f, int tig, int e) {
    return 8 * f + 2 * tig + e;
  }
  // matrix l / 8 of k-step s: tokens 8 (l / 16) + [0, 8), dims 16 s + 8
  // ((l / 8) % 2) + [0, 8): the B fragments (b0, b1) of both score halves
  __device__ __forceinline__ static void scores(const uint8_t* ks,
                                                const uint32_t (&qa)[HD / 16][4],
                                                float (&sc)[2][4], int lane) {
    const uint8_t* row = ks + ((lane >> 4) * 8 + (lane & 7)) * Shape::kKStride +
                         ((lane >> 3) & 1) * 16;
    float odd[2][4] = {};  // odd k-steps: two shorter chains of products
#pragma unroll
    for (int s = 0; s < HD / 16; ++s) {
      uint32_t r[4];
      ldsm_x4(r, row + 32 * s);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(s % 2 ? odd[0] : sc[0], qa[s], b0);
      mma_bf16(s % 2 ? odd[1] : sc[1], qa[s], b1);
    }
    add_scores(sc, odd);
  }
  // matrix l / 8 of dims 16 p: tokens 8 ((l / 8) % 2) + [0, 8), dims 16 p +
  // 8 (l / 16) + [0, 8), transposed: (b0, b1) of fragments 2p and 2p + 1
  __device__ __forceinline__ static void pv(const uint8_t* vs,
                                            const uint32_t (&pa)[4],
                                            float (&o)[HD / 8][4], int lane) {
    const uint8_t* row = vs +
                         (((lane >> 3) & 1) * 8 + (lane & 7)) * Shape::kVStride +
                         (lane >> 4) * 16;
#pragma unroll
    for (int p = 0; p < HD / 16; ++p) {
      uint32_t r[4];
      ldsm_x4_t(r, row + 32 * p);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(o[2 * p], pa, b0);
      mma_bf16(o[2 * p + 1], pa, b1);
    }
  }
};

// int8: each thread reads whole words of a row and the products' dims are
// permuted to fit (the same permutation on both sides of each product).
// QK^T: in a 32-dim block c, thread (gid, tig) reads dims 32 c + 8 tig +
// [0, 8) of token gid (8 bytes): k-step 2c takes dims +0..3, 2c + 1 dims
// +4..7; a last block of 16 (hd 80) takes 4 bytes, 32 c + 4 tig + [0, 4).
// PV: column n of output fragment 4 c + i is dim 32 c + 4 n + i, so thread
// (gid, tig) reads dims 32 c + 4 gid + [0, 4) of its tokens 2 tig, 2 tig + 1,
// 2 tig + 8 and 2 tig + 9 (a last block of 16: 2 bytes, 32 c + 2 gid + i).
template <int HD>
struct RingFrags<int8_t, HD> {
  using Shape = RingShape<int8_t, HD>;
  static constexpr int kFull = HD / 32;  // whole 32-dim blocks
  static constexpr bool kTail = HD % 32 != 0;
  __device__ __forceinline__ static int q_col(int s, int tig, int half) {
    return s < 2 * kFull ? 32 * (s / 2) + 8 * tig + 4 * (s % 2) + 2 * half
                         : 32 * kFull + 4 * tig + 2 * half;
  }
  __device__ __forceinline__ static int o_dim(int f, int tig, int e) {
    return f < 4 * kFull ? 32 * (f / 4) + 8 * tig + 4 * e + f % 4
                         : 32 * kFull + 4 * tig + 2 * e + f % 4;
  }
  __device__ __forceinline__ static void scores(const uint8_t* ks,
                                                const uint32_t (&qa)[HD / 16][4],
                                                float (&sc)[2][4], int lane) {
    const int gid = lane >> 2, tig = lane & 3;
    float odd[2][4] = {};  // odd k-steps: two shorter chains of products
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint8_t* row = ks + (8 * j + gid) * Shape::kKStride;
#pragma unroll
      for (int c = 0; c < kFull; ++c) {
        const uint2 w = *reinterpret_cast<const uint2*>(row + 32 * c + 8 * tig);
        const uint32_t x = w.x ^ 0x80808080u, y = w.y ^ 0x80808080u;
        const uint32_t b0[2] = {s8x2_bf16x2(x, 0, 1), s8x2_bf16x2(x, 2, 3)};
        const uint32_t b1[2] = {s8x2_bf16x2(y, 0, 1), s8x2_bf16x2(y, 2, 3)};
        mma_bf16(sc[j], qa[2 * c], b0);
        mma_bf16(odd[j], qa[2 * c + 1], b1);
      }
      if constexpr (kTail) {
        const uint32_t x = biased4(row + 32 * kFull + 4 * tig);
        const uint32_t b[2] = {s8x2_bf16x2(x, 0, 1), s8x2_bf16x2(x, 2, 3)};
        mma_bf16(sc[j], qa[2 * kFull], b);
      }
    }
    add_scores(sc, odd);
  }
  __device__ __forceinline__ static void pv(const uint8_t* vs,
                                            const uint32_t (&pa)[4],
                                            float (&o)[HD / 8][4], int lane) {
    const int gid = lane >> 2, tig = lane & 3;
    const uint8_t* r0 = vs + 2 * tig * Shape::kVStride;  // tokens 2tig, +1
    const uint8_t* r2 = r0 + 8 * Shape::kVStride;        // tokens 2tig+8, +9
#pragma unroll
    for (int c = 0; c < kFull; ++c) {
      const int off = 32 * c + 4 * gid;
      const uint32_t w0 = biased4(r0 + off);
      const uint32_t w1 = biased4(r0 + Shape::kVStride + off);
      const uint32_t w2 = biased4(r2 + off);
      const uint32_t w3 = biased4(r2 + Shape::kVStride + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b[2] = {bf16x2_exact(s8_f32(w0, i), s8_f32(w1, i)),
                               bf16x2_exact(s8_f32(w2, i), s8_f32(w3, i))};
        mma_bf16(o[4 * c + i], pa, b);
      }
    }
    if constexpr (kTail) {
      const int off = 32 * kFull + 2 * gid;
      const uint32_t w0 = biased2(r0 + off);
      const uint32_t w1 = biased2(r0 + Shape::kVStride + off);
      const uint32_t w2 = biased2(r2 + off);
      const uint32_t w3 = biased2(r2 + Shape::kVStride + off);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t b[2] = {bf16x2_exact(s8_f32(w0, i), s8_f32(w1, i)),
                               bf16x2_exact(s8_f32(w2, i), s8_f32(w3, i))};
        mma_bf16(o[4 * kFull + i], pa, b);
      }
    }
  }
};

// How long the splits of a call are: at least min_split positions, and long
// enough that the call's P valid positions over KV heads make about
// `target` splits (the CTAs the card holds at once), whole 64-position
// tiles. Every CTA computes it from all the rows' lengths, so a call of few
// long rows cuts them finely and a call that fills the card does not.
__host__ __device__ __forceinline__ int split_length(long long P, int KV,
                                                     int target,
                                                     int min_split) {
  const long long fill = (P * KV + target - 1) / target;
  const long long len = (fill + kTileTokens - 1) / kTileTokens * kTileTokens;
  return len > min_split ? (int)len : min_split;
}

// The splits of a row of len positions: at most NS, each about `split`
// positions (unless the row is shorter), as even as whole 64-position tiles
// allow. Returns how many run; a row with nothing to attend runs one, which
// writes its output (0, or the new token alone). decode_attention.py's
// split_length and row_splits are the same rules.
__host__ __device__ __forceinline__ int row_splits(int len, int NS, int split,
                                                   int* split_len) {
  if (len <= 0) {
    *split_len = kTileTokens;
    return 1;
  }
  int n = (len + split - 1) / split;
  if (n > NS) n = NS;
  const int per = (len + n - 1) / n;
  *split_len = (per + kTileTokens - 1) / kTileTokens * kTileTokens;
  return (len + *split_len - 1) / *split_len;
}

// The valid positions of all B rows, summed by the whole CTA (every
// thread gets the total).
__device__ __forceinline__ long long call_positions(const int* lens, int B,
                                                    int cap) {
  __shared__ long long warp_total[kWarps];
  long long n = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) n += valid_len(lens, b, cap);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = n;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_total[w];
  return total;
}

// Weight of a partial of max m_i (log2 units) under the merged max m (0 for
// an empty one).
__device__ __forceinline__ float part_weight(float m_i, float m) {
  return m_i == -CUDART_INF_F ? 0.f : exp2f(m_i - m);
}

// The CTA's kWarps partials of one query head in shared memory: warp i's
// (m, l) at ml[i * ml_stride], its unnormalised o at o[i * o_stride], read
// scaled by `scale` (1 / QSCALE for an int8 cache).
struct WarpParts {
  const float* o;
  const float* ml;
  int o_stride, ml_stride;
  float scale;
  __device__ __forceinline__ float m(int i) const { return ml[i * ml_stride]; }
  __device__ __forceinline__ float l(int i) const {
    return ml[i * ml_stride + 1];
  }
  __device__ __forceinline__ float o_at(int i, int d) const {
    return o[i * o_stride + d] * scale;
  }
  __device__ __forceinline__ float max_m() const {
    float m_max = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) m_max = fmaxf(m_max, m(i));
    return m_max;
  }
};

// One warp: the partials merged in warp order into the split's partial
// (lane d of the head dims), stored to o_dst [hd] and ml_dst [2].
__device__ __forceinline__ void store_partial(const WarpParts& p,
                                              float* o_dst, float* ml_dst,
                                              int hd, int lane) {
  const float m = p.max_m();
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) l += p.l(i) * part_weight(p.m(i), m);
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      acc = fmaf(p.o_at(i, d), part_weight(p.m(i), m), acc);
    o_dst[d] = acc;
  }
  if (lane == 0) {
    ml_dst[0] = m;
    ml_dst[1] = l;
  }
}

// One warp: the normalised output of one (row, query head) of a row of one
// split, with the new token (kn, vn [hd], its score q . kn * scale; read
// back as stored where q8_new > 0) when kn is given. qk_log2 = scale *
// log2(e). No position and no new token gives 0.
__device__ __forceinline__ void finish_head(const WarpParts& p,
                                            const __nv_bfloat16* qh,
                                            const __nv_bfloat16* kn,
                                            const __nv_bfloat16* vn,
                                            __nv_bfloat16* oh, int hd,
                                            float qk_log2, float q8_new,
                                            int lane) {
  float m = p.max_m();
  float s_new = -CUDART_INF_F;
  if (kn != nullptr) {
    float dot = 0.f;
    for (int d = lane; d < hd; d += 32)
      dot = fmaf(to_float(qh[d]), attended(to_float(kn[d]), q8_new), dot);
    s_new = warp_sum(dot) * qk_log2;
    m = fmaxf(m, s_new);
  }
  float den = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) den += p.l(i) * part_weight(p.m(i), m);
  const float p_new = kn != nullptr ? exp2f(s_new - m) : 0.f;
  den += p_new;
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      acc = fmaf(p.o_at(i, d), part_weight(p.m(i), m), acc);
    if (vn != nullptr)
      acc = fmaf(p_new, attended(to_float(vn[d]), q8_new), acc);
    oh[d] = __float2bfloat16(acc * inv);
  }
}

// The CTA that takes the last ticket of a (row, KV head): the n splits'
// partials of its G heads (rows bh0 + g of part_o [*, NS, HD] and part_ml
// [*, NS, 2]) merged in split order, with the new token (kn, vn; read back
// as stored where q8_new > 0) when given, into out. Every (m, l) comes in
// by one load of its own; the o rows go through shared memory by cp.async,
// as many splits at a time as `smem` holds (all of them at the shapes
// served), so each batch costs one round trip to L2 instead of one per
// split. Its loops stay rolled: it runs once a row, by one CTA, at the
// call's end, where after a read of other data its instructions are
// fetched from memory line by line (stamped on an H100, the unrolled
// products and store took 5-10 us cold, 1-3 warm).
template <int HD>
__device__ __forceinline__ void merge_splits(
    uint8_t* smem, int smem_bytes, const float* part_o, const float* part_ml,
    size_t bh0, int G, int n, int NS, const __nv_bfloat16* q,
    const __nv_bfloat16* kn, const __nv_bfloat16* vn, __nv_bfloat16* out,
    float qk_log2, float q8_new, int pair) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ws = reinterpret_cast<float*>(smem);  // [G][n] m, then the weight
  float* ls = ws + G * n;                       // [G][n] l
  float* hs = ls + G * n;                       // [G][2] 1 / den, p_new
  float* acc_s = ws + ((2 * G * n + 2 * G + 3) & ~3);  // [G][HD] sums
  float* os = acc_s + G * HD;                   // [G][chunk][HD]
  const int chunk =
      (smem_bytes - (int)(reinterpret_cast<uint8_t*>(os) - smem)) /
      (G * HD * 4);
  // splits [i0, i0 + nc) of every head's o rows into os
  auto stage = [&](int i0, int nc) {
    for (int c = tid; c < G * nc * (HD / 4); c += kThreads) {
      const int r = c / (HD / 4), piece = c - r * (HD / 4);  // r = g nc + i
      const int g = r / nc, i = r - g * nc;
      cp_async16(os + r * HD + 4 * piece,
                 part_o + ((bh0 + g) * NS + i0 + i) * HD + 4 * piece, true);
    }
    cp_async_commit();
  };
  stage(0, chunk < n ? chunk : n);  // in flight while (m, l) come in
  for (int x = tid; x < G * n; x += kThreads) {
    const int g = x / n, i = x - g * n;
    const float* ml = part_ml + ((bh0 + g) * NS + i) * 2;
    ws[x] = __ldcg(ml);
    ls[x] = __ldcg(ml + 1);
  }
  __syncthreads();
  stamp(pair, 3);
  for (int g = warp; g < G; g += kWarps) {  // one warp per head
    float m = -CUDART_INF_F;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, ws[g * n + i]);
    m = warp_max(m);
    float s_new = -CUDART_INF_F;
    if (kn != nullptr) {
      float dot = 0.f;
      for (int d = lane; d < HD; d += 32)
        dot = fmaf(to_float(q[(bh0 + g) * HD + d]),
                   attended(to_float(kn[d]), q8_new), dot);
      s_new = warp_sum(dot) * qk_log2;
      m = fmaxf(m, s_new);
    }
    float den = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = part_weight(ws[g * n + i], m);
      ws[g * n + i] = w;
      den += ls[g * n + i] * w;
    }
    den = warp_sum(den);
    const float p_new = kn != nullptr ? exp2f(s_new - m) : 0.f;
    if (lane == 0) {
      hs[2 * g] = 1.f / fmaxf(den + p_new, 1e-30f);
      hs[2 * g + 1] = p_new;
    }
  }
  // thread tid owns outputs x = tid + k kThreads of the G heads; a batch
  // adds its splits to their sums (kept in acc_s between batches), and the
  // last one writes them
  for (int i0 = 0; i0 < n; i0 += chunk) {
    const int nc = chunk < n - i0 ? chunk : n - i0;
    const bool last_batch = i0 + nc == n;
    if (i0 > 0) stage(i0, nc);
    cp_async_wait<0>();
    __syncthreads();  // the batch has landed, and the weights are in place
    if (i0 == 0) stamp(pair, 4);
#pragma unroll 1
    for (int x = tid; x < G * HD; x += kThreads) {
      const int g = x / HD, d = x - g * HD;
      const float* o_g = os + g * nc * HD + d;
      const float* w_g = ws + g * n + i0;
      float a = i0 > 0 ? acc_s[x] : 0.f;
      for (int i = 0; i < nc; ++i) a = fmaf(o_g[i * HD], w_g[i], a);
      if (!last_batch) {
        acc_s[x] = a;
        continue;
      }
      if (vn != nullptr)
        a = fmaf(hs[2 * g + 1], attended(to_float(vn[d]), q8_new), a);
      out[(bh0 + g) * HD + d] = __float2bfloat16(a * hs[2 * g]);
    }
    if (!last_batch) __syncthreads();  // the batch is consumed
  }
  stamp(pair, 5);
#ifdef GENESYS_DECODE_STAMPS
  __syncthreads();
  stamp(pair, 6);
#endif
}

// One CTA: row b (blockIdx.y), KV head kvh (blockIdx.x), split z
// (blockIdx.z) of row_splits(len, NS, split_length(...)). Warp w walks the
// split's
// 64-position tiles, taking positions [16 w, 16 w + 16) of each through its
// ring: stripe k + kStages - 1 is copied while stripe k is in the products.
// Then the warps' (m, l, o) are merged in shared memory; a row of one split
// is written here, normalised; otherwise each split stores its partial and
// the CTA that takes the last ticket of (b, kvh) merges them in order and
// resets the ticket. qk_log2 = hd^-0.5 * log2(e); kv_scale scales cached K
// and V (1 / QSCALE for int8), not the new token. With slots, split 0
// also writes the new token at slots[b] (kc and vc hold n_slots token
// rows; positions below lens[b] never include it).
template <typename KT, int HD, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_ring(
    const __nv_bfloat16* __restrict__ q, KT* kc, KT* vc, const Rows rows,
    const int* __restrict__ lens, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ slots,
    long long n_slots, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ tickets, int B, int H, int KV, int NS, int min_split,
    int target, float qk_log2, float kv_scale) {
  using Shape = RingShape<KT, HD>;
  using Frags = RingFrags<KT, HD>;
  constexpr int S = Shape::kStages;
  // K1 on an int8 arena attends the new token as the arena stores it
  constexpr bool kQ8New =
      Rows::kNewAsStored && std::is_same<KT, int8_t>::value;
  const float q8_new = kQ8New ? kv_scale : 0.f;
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int pair = b * KV + kvh;
  const unsigned long long started = stamp_now();
  if (z == 0) stamp_at(pair, 7, started);
  const int len = valid_len(lens, b, rows.cap);
  const int split =
      split_length(call_positions(lens, B, rows.cap), KV, target, min_split);
  int split_len;
  const int n_run = row_splits(len, NS, split, &split_len);
  if (z >= n_run) return;

  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int t0 = z * split_len;               // the split's positions [t0, t1)
  const int t1 = t0 + split_len < len ? t0 + split_len : len;
  const int n_tiles = (t1 - t0 + kTileTokens - 1) / kTileTokens;

  extern __shared__ __align__(128) uint8_t ring_smem[];
  uint8_t* ring = ring_smem + warp * S * Shape::kStageBytes;

  // the G query rows as A fragments, one per 16-deep k-step (rows >= G: 0)
  const __nv_bfloat16* qrow = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = Frags::q_col(s, tig, half);
      qa[s][2 * half] = gid < G ? ld_pair(qrow + gid * HD + c) : 0u;
      qa[s][2 * half + 1] =
          gid + 8 < G ? ld_pair(qrow + (gid + 8) * HD + c) : 0u;
    }
  }

  // stripe k: positions t0 + 64 k + 16 warp + [0, 16) into stage k % S, the
  // ones at or past t1 as zeros; always one commit group
  const size_t tok_bytes = (size_t)KV * Shape::kRowBytes;
  const uint8_t* kbase =
      reinterpret_cast<const uint8_t*>(kc) + (size_t)kvh * Shape::kRowBytes;
  const uint8_t* vbase =
      reinterpret_cast<const uint8_t*>(vc) + (size_t)kvh * Shape::kRowBytes;
  // the rows' addresses first (K1: reads of the block table, all in flight
  // together), then the copies
  constexpr int kCopies = (kStripe * Shape::kChunks + 31) / 32;  // per lane
  auto issue = [&](int k) {
    const int p0 = t0 + k * kTileTokens + warp * kStripe;
    if (p0 < t1) {
      uint8_t* ks = ring + (k % S) * Shape::kStageBytes;
      uint8_t* vs = ks + kStripe * Shape::kKStride;
      size_t off[kCopies];
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int c = lane + 32 * i, r = c / Shape::kChunks;
        off[i] = c < kStripe * Shape::kChunks && p0 + r < t1
                     ? (size_t)rows.token(b, p0 + r) * tok_bytes +
                           16 * (c - r * Shape::kChunks)
                     : 0;
      }
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int c = lane + 32 * i, r = c / Shape::kChunks;
        if (c < kStripe * Shape::kChunks) {
          const int w = c - r * Shape::kChunks;
          const bool ok = p0 + r < t1;
          cp_async16(ks + r * Shape::kKStride + 16 * w, kbase + off[i], ok);
          cp_async16(vs + r * Shape::kVStride + 16 * w, vbase + off[i], ok);
        }
      }
    }
    cp_async_commit();
  };

  float o[HD / 8][4];
#pragma unroll
  for (int f = 0; f < HD / 8; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // rows gid, gid + 8
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sums
  const float sc_log2 = qk_log2 * kv_scale;

#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);
  const size_t kv_row = ((size_t)b * KV + kvh) * HD;
  if (slots != nullptr && z == 0)  // the store overlaps the loads in flight
    write_new(kc, vc, k_new + kv_row, v_new + kv_row, slots, b, n_slots, KV,
              kvh, HD, kv_scale);
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<S - 2>();  // stripe k has landed (this thread's copies)
    __syncwarp();            // ... all lanes', and stage k - 1 is consumed
    issue(k + S - 1);
    const int live = t1 - (t0 + k * kTileTokens + warp * kStripe);
    if (live <= 0) continue;  // the split ends before this warp's stripe
    const uint8_t* ks = ring + (k % S) * Shape::kStageBytes;
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    Frags::scores(ks, qa, sc, lane);
    // scale to log2 units, mask past the split's end, then the row maxima
    // over the quad that holds each row
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = 8 * j + 2 * tig + (e & 1) < live;
        sc[j][e] = in ? sc[j][e] * sc_log2 : -CUDART_INF_F;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, sc[j][e]);
        else
          mx_hi = fmaxf(mx_hi, sc[j][e]);
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // the base of the exponent: 0 while a row has seen nothing (all -inf)
    const float base_lo = mn_lo == -CUDART_INF_F ? 0.f : mn_lo;
    const float base_hi = mn_hi == -CUDART_INF_F ? 0.f : mn_hi;
    const float c_lo = exp2f(m_lo - base_lo), c_hi = exp2f(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = exp2f(sc[j][0] - base_lo);
      sc[j][1] = exp2f(sc[j][1] - base_lo);
      sc[j][2] = exp2f(sc[j][2] - base_hi);
      sc[j][3] = exp2f(sc[j][3] - base_hi);
      sum_lo += sc[j][0] + sc[j][1];
      sum_hi += sc[j][2] + sc[j][3];
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int f = 0; f < HD / 8; ++f) {
      o[f][0] *= c_lo;
      o[f][1] *= c_lo;
      o[f][2] *= c_hi;
      o[f][3] *= c_hi;
    }
    // the weights, rounded to bf16, as PV's A fragment (k = stripe token)
    const uint32_t pa[4] = {pack_f32(sc[0][0], sc[0][1]),
                            pack_f32(sc[0][2], sc[0][3]),
                            pack_f32(sc[1][0], sc[1][1]),
                            pack_f32(sc[1][2], sc[1][3])};
    Frags::pv(ks + kStripe * Shape::kKStride, pa, o, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: its space holds the merge

  // the warps' partials, rows < G: mo [kWarps][G][HD], mml [kWarps][G][2]
  float* mo = reinterpret_cast<float*>(ring_smem);
  float* mml = mo + kWarps * G * HD;
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
#pragma unroll
  for (int f = 0; f < HD / 8; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = Frags::o_dim(f, tig, e);
      if (gid < G) mo[(warp * G + gid) * HD + d] = o[f][e];
      if (gid + 8 < G) mo[(warp * G + gid + 8) * HD + d] = o[f][2 + e];
    }
  if (tig == 0) {
    if (gid < G) {
      mml[(warp * G + gid) * 2] = m_lo;
      mml[(warp * G + gid) * 2 + 1] = l_lo;
    }
    if (gid + 8 < G) {
      mml[(warp * G + gid + 8) * 2] = m_hi;
      mml[(warp * G + gid + 8) * 2 + 1] = l_hi;
    }
  }
  __syncthreads();

  const __nv_bfloat16* kn = k_new != nullptr ? k_new + kv_row : nullptr;
  const __nv_bfloat16* vn = v_new != nullptr ? v_new + kv_row : nullptr;
  if (n_run == 1) {
    for (int g = warp; g < G; g += kWarps) {
      const size_t bh = (size_t)b * H + kvh * G + g;
      finish_head(WarpParts{mo + g * HD, mml + 2 * g, G * HD, 2 * G, kv_scale},
                  q + bh * HD, kn, vn, out + bh * HD, HD, qk_log2, q8_new,
                  lane);
    }
    return;
  }
  for (int g = warp; g < G; g += kWarps) {
    const size_t bh = (size_t)b * H + kvh * G + g;
    store_partial(WarpParts{mo + g * HD, mml + 2 * g, G * HD, 2 * G, kv_scale},
                  part_o + (bh * NS + z) * HD, part_ml + (bh * NS + z) * 2,
                  HD, lane);
  }
  // the CTA's partials, seen by thread 0 through the barrier, are released
  // to the GPU with its ticket; the last ticket acquires every split's
  __syncthreads();
  const unsigned long long stored_at = stamp_now();
  __shared__ int last;
  if (tid == 0) last = ticket_acq_rel(tickets + b * KV + kvh) == n_run - 1;
  __syncthreads();
  if (!last) return;
  stamp_at(pair, 0, started);
  stamp_at(pair, 1, stored_at);
  stamp(pair, 2);
  merge_splits<HD>(ring_smem, Shape::kSmem, part_o, part_ml,
                   (size_t)b * H + kvh * G, G, n_run, NS, q, kn, vn, out,
                   qk_log2, q8_new, pair);
  if (tid == 0) tickets[b * KV + kvh] = 0;  // ready for the next call
}

template <typename KT, int HD, typename Rows>
cudaError_t launch_ring(const void* q, void* kp, void* vp, const Rows rows,
                        const int* lens, const void* k_new, const void* v_new,
                        const int* slots, long long n_slots, void* out,
                        float* part_o, float* part_ml, int* tickets, int B,
                        int H, int KV, int NS, int min_split, int target,
                        float qk_log2, float kv_scale, cudaStream_t stream) {
  constexpr int smem = RingShape<KT, HD>::kSmem;
  // once per instantiation: the most shared memory an SM can give (so two
  // CTAs fit), and the opt-in above 48 KB
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_ring<KT, HD, Rows>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_ring<KT, HD, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  decode_ring<KT, HD, Rows><<<dim3(KV, B, NS), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<KT*>(kp),
      static_cast<KT*>(vp), rows, lens,
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), slots, n_slots,
      static_cast<__nv_bfloat16*>(out), part_o, part_ml, tickets, B, H, KV, NS,
      min_split, target, qk_log2, kv_scale);
  return cudaGetLastError();
}

__host__ __device__ __forceinline__ bool ring_head_dim(int hd) {
  return hd == 64 || hd == 80 || hd == 128;
}

// One call on `stream`: the ring kernel, or the CUDA-core split kernel and
// the merge; returns the first launch error. k_new/v_new may be null (no
// new token); slots, null or [B] with the new token, says where it is
// written into kp / vp (n_slots token rows). split_tokens: the ring's
// shortest split, or the CUDA-core
// kernel's split (a multiple of rows.BS); NS split slots per (row, KV
// head); grid_x CTAs per (row, KV head) (the ring's: NS); target: the
// splits the ring aims a call at (the CTAs the card holds at once).
template <typename QT, typename KT, typename Rows>
cudaError_t launch_decode(const void* q, void* kp, void* vp, const Rows rows,
                          const int* lens, const void* k_new,
                          const void* v_new, const int* slots,
                          long long n_slots, void* out, float* part_o,
                          float* part_ml, int* tickets, int B, int H, int KV,
                          int hd, int variant, int split_tokens, int NS,
                          int grid_x, int target, float scale, float kv_scale,
                          cudaStream_t stream) {
  if (variant == kRing) {
    if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                  !std::is_same<KT, float>::value) {
      const float qk_log2 = scale * kLog2e;
#define GENESYS_RING(HD)                                                      \
  return launch_ring<KT, HD, Rows>(q, kp, vp, rows, lens, k_new, v_new,     \
                                   slots, n_slots, out, part_o, part_ml,     \
                                   tickets, B, H, KV, NS, split_tokens,      \
                                   target, qk_log2, kv_scale, stream)
      if (hd == 64) GENESYS_RING(64);
      if (hd == 80) GENESYS_RING(80);
      if (hd == 128) GENESYS_RING(128);
#undef GENESYS_RING
    }
    return cudaErrorInvalidValue;
  }
  const size_t smem = split_smem_bytes(H / KV, hd, rows.BS);
  // once per instantiation: the most shared memory an SM can give (so
  // several CTAs fit at once), and opt in to the largest size asked for
  static size_t opted_in = 0;
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split<QT, KT, Rows>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(decode_split<QT, KT, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  decode_split<QT, KT, Rows><<<dim3(grid_x, KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), rows, lens, part_o, part_ml, H, KV, hd,
      split_tokens / rows.BS, NS, scale, kv_scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr bool kQ8New =
      Rows::kNewAsStored && std::is_same<KT, int8_t>::value;
  decode_merge<QT, KT><<<B * H, kThreads, 0, stream>>>(
      part_o, part_ml, lens, static_cast<const QT*>(q),
      static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      static_cast<QT*>(out), static_cast<KT*>(kp), static_cast<KT*>(vp),
      slots, n_slots, H, KV, hd, rows.cap, split_tokens, NS, scale, kv_scale,
      kQ8New ? kv_scale : 0.f);
  return cudaGetLastError();
}

// Checks shared by both entry points: shapes the kernels take, 16-byte
// aligned K/V (every load is 16 bytes wide), a new token given whole and
// before slots; for the ring a head dim it has and one CTA per split slot,
// for the CUDA-core kernel splits of whole pages that cover the row and a
// tile that fits shared memory.
inline bool decode_args_ok(int B, int H, int KV, int hd, int BS, int variant,
                           int split_tokens, int NS, int cap, int grid_x,
                           int target, const void* k, const void* v,
                           const void* k_new, const void* v_new,
                           const int* slots, long long n_slots) {
  const bool common =
      (k_new == nullptr) == (v_new == nullptr) &&
      (slots == nullptr || (k_new != nullptr && n_slots >= 0)) &&
      B > 0 && B <= 65535 && KV > 0 && H % KV == 0 && H / KV <= kMaxGroup &&
      hd > 0 && hd % 16 == 0 && hd <= kThreads * kMaxDimsPerThread && BS > 0 &&
      split_tokens > 0 && NS > 0 && NS <= 65535 && grid_x > 0 &&
      grid_x <= NS && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (!common) return false;
  if (variant == kRing)
    return ring_head_dim(hd) && split_tokens % kTileTokens == 0 &&
           grid_x == NS && NS <= kMaxSplits && target > 0;
  return variant == kCudaCore && split_tokens % BS == 0 &&
         (long long)NS * split_tokens >= cap &&
         split_smem_bytes(H / KV, hd, BS) <= 227 * 1024;
}

}  // namespace
