// Device code shared by the paged (K1, paged_decode.cu) and dense (K2,
// dense_decode.cu) flash-decode kernels: one query token per row against a
// K/V store whose rows are cut into pages of BS tokens.
//
// Where a page lives is the only difference between the two, so the split
// kernels take it as a policy, `Rows`, with
//   int cap;                                 positions a row can hold
//   __device__ int page_start(int b, int p)  flat token index of row b's
//                                            page p (token t of it is at
//                                            (page_start + t) * KV * hd)
// PagedRows reads a block table (K1); DenseRows computes b * S + p * BS
// (K2: the carried cache [B,S,KV,hd] viewed as pages of 64 tokens).
//
// What bounds both is bytes: every valid K/V position is read once per
// step (2 * sum(min(lens, cap)) * KV * hd * itemsize bytes) for 4 * hd * G
// FLOPs, G = H / KV, about G FLOPs per byte in bf16 against the ~295 the
// card needs to be compute-bound. So the design moves each byte once:
//   * one CTA per (row, KV head, split of pages) loads each page once into
//     shared memory and serves all G query heads of that KV head from it
//     (the Pallas index maps fetch the same block once per query head);
//   * pages arrive in tiles of 64 tokens, each thread's 16-byte loads of a
//     tile issued together, so a tile costs one memory round trip; only
//     positions below the row's length are loaded;
//   * a CTA walks only the pages below ceil(min(lens[b], cap) / BS), not
//     the whole row (the Pallas grids walk every block and mask);
//   * a row is cut into splits of a few pages, and a grid sized to the card
//     strides over them, so a long row spreads over many SMs and a short
//     one costs few idle CTAs; the merge reads only the splits that ran.
// Accumulation is f32 throughout. With bf16 queries (bf16 or int8 K/V) at
// head_dim 128 both products run on the tensor cores (mma.sync m16n8k16,
// the G heads padded to M = 16); otherwise (f32 models) on the CUDA cores
// in f32. Loads are not overlapped with compute yet (no cp.async or TMA
// ring), and the tensor-core path is mma.sync, not wgmma.
//
// The merge takes an optional extra partial: the new token of a dense
// decode step (K2's two-part softmax), with m = q . k_new * scale, l = 1
// and o = v_new, so attending it costs no pass over the cache.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;         // 4 warps per CTA
constexpr int kMaxGroup = 16;         // query heads per KV head in one CTA
constexpr int kMaxDimsPerThread = 2;  // head_dim <= 256

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Positions of row b that are attended: lens[b] clipped to [0, cap].
__device__ __forceinline__ int valid_len(const int* lens, int b, int cap) {
  const int len = lens[b];
  return len <= 0 ? 0 : (len < cap ? len : cap);
}

// Pages of a row that hold at least one position below its length.
__device__ __forceinline__ int valid_pages(int len, int BS) {
  return (len + BS - 1) / BS;
}

// K1: pages through the block table [B, MB].
struct PagedRows {
  const int* bt;
  int MB, BS, cap;  // cap = MB * BS
  __device__ __forceinline__ int page_start(int b, int p) const {
    return bt[(size_t)b * MB + p] * BS;
  }
};

// K2: row b's S positions are contiguous from token b * S.
struct DenseRows {
  int S, BS, cap;  // cap = S
  __device__ __forceinline__ int page_start(int b, int p) const {
    return b * S + p * BS;
  }
};

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

// ---- tensor-core split kernel: bf16 queries on bf16 or int8 K/V ------------

// Head dim, query rows (G padded to the mma's M) and bf16 row strides of the
// shared-memory tiles of the tensor-core kernel.
constexpr int kMmaHd = 128;
constexpr int kMmaRows = 16;
constexpr int kKvStride = kMmaHd + 8;        // K/V tile rows, bf16
constexpr int kScoreStride = kTileTokens + 4;  // score rows, f32
constexpr int kProbStride = kTileTokens + 8;   // softmax-weight rows, bf16

// d += a * b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate.
// a: 16x16 row-major fragment, b: 16x8 column-major fragment (PTX ISA
// "Matrix Fragments for mma.m16n8k16").
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two adjacent bf16 (the lower address in the low half), as one register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// One 16-byte chunk of a K/V row into a bf16 shared-memory row: bf16 is
// copied as it is, int8 dequantised (q / QSCALE is exact in bf16).
template <typename KT>
__device__ __forceinline__ void stage_bf16(const uint4& r, __nv_bfloat16* dst,
                                           float s);
template <>
__device__ __forceinline__ void stage_bf16<__nv_bfloat16>(
    const uint4& r, __nv_bfloat16* dst, float) {
  *reinterpret_cast<uint4*>(dst) = r;
}
template <>
__device__ __forceinline__ void stage_bf16<int8_t>(const uint4& r,
                                                   __nv_bfloat16* dst,
                                                   float s) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  uint32_t out[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = pack_pair(__float2bfloat16(Chunk<int8_t>::b(w[k], 0) * s),
                           __float2bfloat16(Chunk<int8_t>::b(w[k], 1) * s));
    out[2 * k + 1] =
        pack_pair(__float2bfloat16(Chunk<int8_t>::b(w[k], 2) * s),
                  __float2bfloat16(Chunk<int8_t>::b(w[k], 3) * s));
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// The same split walk as decode_split, with both products on the tensor
// cores (mma.sync m16n8k16): the G query heads of a KV head are the M = 16
// rows (padded with zeros), the tile's 64 tokens the N of QK^T and the K
// of PV. Warp w scores tokens [16w, 16w+16) and owns output dims
// [32w, 32w+32); scores meet in shared memory for the softmax, whose
// weights go back as bf16 (as the reference rounds them to V's dtype).
// Takes hd = 128, G <= 16 and BS dividing 64.
template <typename KT, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_split_mma(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const Rows rows, const int* __restrict__ lens,
    float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KV,
    int pps, int NS, float scale, float kv_scale) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int BS = rows.BS;
  const int len = valid_len(lens, b, rows.cap);
  const int p_end = valid_pages(len, BS);
  const int n_run = (p_end + pps - 1) / pps;  // splits with valid pages
  if ((int)blockIdx.x >= n_run) return;

  constexpr int E = Chunk<KT>::kElems;
  constexpr int cpr = kMmaHd / E;  // 16-byte chunks per K/V row
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int TP = kTileTokens / BS;

  __shared__ __align__(16) __nv_bfloat16 ks[kTileTokens * kKvStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileTokens * kKvStride];
  __shared__ __align__(16) float ss[kMmaRows * kScoreStride];
  __shared__ __align__(16) __nv_bfloat16 ps[kMmaRows * kProbStride];
  __shared__ float m_s[kMmaRows], l_s[kMmaRows], c_s[kMmaRows];
  __shared__ int blk_s[kTileTokens];

  // the query rows as A fragments, one per 16-wide slice of head_dim
  const __nv_bfloat16* qrow = q + ((size_t)b * H + (size_t)kvh * G) * kMmaHd;
  uint32_t qa[kMmaHd / 16][4];
#pragma unroll
  for (int s = 0; s < kMmaHd / 16; ++s) {
    const int c = 16 * s + 2 * tig;
    qa[s][0] = gid < G ? ld_pair(qrow + gid * kMmaHd + c) : 0u;
    qa[s][1] = gid + 8 < G ? ld_pair(qrow + (gid + 8) * kMmaHd + c) : 0u;
    qa[s][2] = gid < G ? ld_pair(qrow + gid * kMmaHd + c + 8) : 0u;
    qa[s][3] = gid + 8 < G ? ld_pair(qrow + (gid + 8) * kMmaHd + c + 8) : 0u;
  }

  const size_t tok_stride = (size_t)KV * kMmaHd;
  for (int split = blockIdx.x; split < n_run; split += gridDim.x) {
    const int p0 = split * pps;
    const int p1 = p0 + pps < p_end ? p0 + pps : p_end;
    if (tid < kMmaRows) {  // only thread tid touches m_s[tid] / l_s[tid] here
      m_s[tid] = -CUDART_INF_F;
      l_s[tid] = 0.f;
    }
    float o[4][4];  // this warp's 32 output dims as four 8-wide C fragments
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) o[j][k] = 0.f;

    for (int p = p0; p < p1; p += TP) {
      const int n_tok = (p1 - p < TP ? p1 - p : TP) * BS;  // tile's extent
      const int live = len - p * BS;                  // >= 1 on a valid page
      const int n_live = live < n_tok ? live : n_tok;  // tokens below len
      __syncthreads();  // the previous tile's ks, vs, ss and ps are consumed
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
                (size_t)kvh * kMmaHd + (size_t)w * E;
            kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + off));
            vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + off));
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadIters; ++u) {
          const int c = c0 + u * kThreads + tid;
          if (c < n_chunks) {
            const int r = c / cpr, w = c - r * cpr;
            stage_bf16<KT>(kr[u], ks + r * kKvStride + w * E, kv_scale);
            stage_bf16<KT>(vr[u], vs + r * kKvStride + w * E, kv_scale);
          }
        }
      }
      // rows past the loaded tokens are zero, so that 0-weight x stale
      // shared memory cannot make a NaN in the PV product
      for (int i = n_live * (kKvStride / 8) + tid;
           i < kTileTokens * (kKvStride / 8); i += kThreads) {
        reinterpret_cast<uint4*>(ks)[i] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(vs)[i] = make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
      // scores of this warp's 16 tokens: two 8-token C fragments
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < kMmaHd / 16; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const __nv_bfloat16* kr =
              ks + (16 * warp + 8 * j + gid) * kKvStride + 16 * s + 2 * tig;
          const uint32_t kb[2] = {ld_pair(kr), ld_pair(kr + 8)};
          mma_bf16(sc[j], qa[s], kb);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 16 * warp + 8 * j + 2 * tig;
        const bool in0 = t < n_live, in1 = t + 1 < n_live;
        *reinterpret_cast<float2*>(ss + gid * kScoreStride + t) = make_float2(
            in0 ? sc[j][0] * scale : -CUDART_INF_F,
            in1 ? sc[j][1] * scale : -CUDART_INF_F);
        *reinterpret_cast<float2*>(ss + (gid + 8) * kScoreStride + t) =
            make_float2(in0 ? sc[j][2] * scale : -CUDART_INF_F,
                        in1 ? sc[j][3] * scale : -CUDART_INF_F);
      }
      __syncthreads();
      // online softmax, one warp per query row, lanes across the 64 tokens;
      // padding rows (>= G) get zero weights
      for (int r = warp; r < kMmaRows; r += kThreads / 32) {
        const float* sr = ss + r * kScoreStride;
        __nv_bfloat16* pr = ps + r * kProbStride;
        if (r >= G) {
          for (int t = lane; t < kTileTokens; t += 32)
            pr[t] = __float2bfloat16(0.f);
          if (lane == 0) c_s[r] = 0.f;
          continue;
        }
        float mx = -CUDART_INF_F;
        for (int t = lane; t < kTileTokens; t += 32) mx = fmaxf(mx, sr[t]);
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < kTileTokens; t += 32) {
          const float e = expf(sr[t] - m_new);  // masked (-inf) -> 0
          pr[t] = __float2bfloat16(e);
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float c = expf(m_old - m_new);  // m_old = -inf -> 0
          l_s[r] = l_s[r] * c + sum;
          m_s[r] = m_new;
          c_s[r] = c;
        }
      }
      __syncthreads();
      // o = o * c + P V over the tile's 64 tokens, 16 at a time
      const float c_lo = c_s[gid], c_hi = c_s[gid + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j][0] *= c_lo;
        o[j][1] *= c_lo;
        o[j][2] *= c_hi;
        o[j][3] *= c_hi;
      }
#pragma unroll
      for (int s = 0; s < kTileTokens / 16; ++s) {
        const __nv_bfloat16* pr = ps + 16 * s + 2 * tig;
        const uint32_t pa[4] = {
            ld_pair(pr + gid * kProbStride),
            ld_pair(pr + (gid + 8) * kProbStride),
            ld_pair(pr + gid * kProbStride + 8),
            ld_pair(pr + (gid + 8) * kProbStride + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* vr =
              vs + (16 * s + 2 * tig) * kKvStride + 32 * warp + 8 * j + gid;
          const uint32_t vb[2] = {
              pack_pair(vr[0], vr[kKvStride]),
              pack_pair(vr[8 * kKvStride], vr[9 * kKvStride])};
          mma_bf16(o[j], pa, vb);
        }
      }
    }

    const int h0 = kvh * G;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 32 * warp + 8 * j + 2 * tig;
      if (gid < G) {
        float* od = part_o + (((size_t)b * H + h0 + gid) * NS + split) *
                                 kMmaHd + d;
        od[0] = o[j][0];
        od[1] = o[j][1];
      }
      if (gid + 8 < G) {
        float* od = part_o + (((size_t)b * H + h0 + gid + 8) * NS + split) *
                                 kMmaHd + d;
        od[0] = o[j][2];
        od[1] = o[j][3];
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
// its partial is m = q . k_new * scale, l = 1, o = v_new. A row with no
// valid position and no new token gives 0.
template <typename QT>
__global__ void __launch_bounds__(kThreads) decode_merge(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lens, const QT* __restrict__ q,
    const QT* __restrict__ k_new, const QT* __restrict__ v_new,
    QT* __restrict__ out, int H, int KV, int hd, int cap, int split_tokens,
    int NS, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
      part = fmaf(to_float(q[(size_t)bh * hd + d]), to_float(k_new[kv_row + d]),
                  part);
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
    if (v_new != nullptr) o = fmaf(p_new, to_float(v_new[kv_row + d]), o);
    out[(size_t)bh * hd + d] = from_float<QT>(o * inv);
  }
}

// Split kernels, then the merge, on `stream`; returns the first launch
// error. k_new/v_new may be null (no new token).
template <typename QT, typename KT, typename Rows>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const Rows rows, const int* lens, const void* k_new,
                          const void* v_new, void* out, float* part_o,
                          float* part_ml, int B, int H, int KV, int hd,
                          int pps, int NS, int grid_x, float scale,
                          float kv_scale, cudaStream_t stream) {
  const dim3 grid(grid_x, KV, B);
  bool mma = false;
  if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                !std::is_same<KT, float>::value) {
    // bf16 queries on bf16 or int8 K/V at hd 128: the tensor-core kernel
    mma = hd == kMmaHd && H / KV <= kMmaRows && kTileTokens % rows.BS == 0;
    if (mma)
      decode_split_mma<KT, Rows><<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(kp),
          static_cast<const KT*>(vp), rows, lens, part_o, part_ml, H, KV, pps,
          NS, scale, kv_scale);
  }
  if (!mma) {
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
    decode_split<QT, KT, Rows><<<grid, kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(kp),
        static_cast<const KT*>(vp), rows, lens, part_o, part_ml, H, KV, hd,
        pps, NS, scale, kv_scale);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_merge<QT><<<B * H, kThreads, 0, stream>>>(
      part_o, part_ml, lens, static_cast<const QT*>(q),
      static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      static_cast<QT*>(out), H, KV, hd, rows.cap, pps * rows.BS, NS, scale);
  return cudaGetLastError();
}

// Checks shared by both entry points: shapes the kernels take, 16-byte
// aligned K/V (every load is 16 bytes wide).
inline bool decode_args_ok(int B, int H, int KV, int hd, int BS, int pps,
                           int NS, int n_pages, int grid_x, const void* k,
                           const void* v) {
  return B > 0 && KV > 0 && H % KV == 0 && H / KV <= kMaxGroup && hd > 0 &&
         hd % 16 == 0 && hd <= kThreads * kMaxDimsPerThread && BS > 0 &&
         pps > 0 && NS * pps >= n_pages && grid_x > 0 && grid_x <= NS &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         split_smem_bytes(H / KV, hd, BS) <= 227 * 1024;
}

}  // namespace
