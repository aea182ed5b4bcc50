// Hand-written Hopper (sm_90a) kernels of the no-cache attention: the flash
// attention forward (K3a) and backward (K3b).
//
//   fa_fwd_mma / fa_fwd_f32        replace the Pallas `flash_attention_fwd` /
//                                  `_fwd_kernel`
//   fa_dq_mma, fa_dkv_mma /        replace `flash_attention_bwd` /
//   fa_dq_f32, fa_dkv_f32          `_dq_kernel`, `_dkv_kernel`
//                                  (src/repro/kernels/flash_attention.py)
//
// and on the training and prefill paths the XLA `flash_attention_xla` of
// the no-cache branch of `attention` (src/repro/models/layers.py).
//
// Layout: the path's own, read and written through row strides with no
// transpose: q, o, do, dq [B, Sq, H, hd]; k, v, dk, dv [B, Skv, KV, hd];
// lse and delta [B, H, Sq] f32. Query head h reads KV head h / G, G = H / KV.
// Causal masking keeps key j for query i when i >= j (Sq == Skv; the
// wrapper refuses causal attention with Sq != Skv). Every position is
// covered: a tile that runs past Sq or Skv masks its tail (the Pallas grids
// take Sq // 128 and Skv // 128 tiles and leave the rest unwritten).
//
// What bounds them: operations. A causal forward does 2 * B * H * S^2 * hd
// FLOPs (two products over half the score matrix) for 2 * B * S * (H + KV)
// * hd elements read and written, hundreds of FLOPs per byte; the backward
// does five products, 5 * B * H * S^2 * hd. So the design keeps the score
// matrix out of device memory and puts the products on the tensor cores:
//   * bf16 (the path's compute dtype, hd 64 or 128): every product is
//     mma.sync m16n8k16 with f32 accumulation. Each warp owns 16 rows of
//     the tile it accumulates (query rows in the forward and in dq, key rows
//     in dk/dv) and keeps them in registers; the operand it streams (K and V
//     tiles, or Q and dO tiles) passes through shared memory. Softmax
//     weights and dS are rounded to bf16 for the products that take them as
//     an operand, as the reference rounds p to V's dtype before PV; the
//     running max, the sums and lse stay f32.
//   * The forward keeps one online softmax per row (FlashAttention-2): the
//     scores of a 64-key tile never leave registers, and the row's max and
//     sum live in the four lanes that hold it.
//   * The backward recomputes p = exp(s * scale - lse) from the forward's
//     lse, with delta = rowsum(do * o) computed before the launch. dq loops
//     over KV tiles per query tile; dk and dv loop over the G heads and the
//     query tiles per KV tile, accumulating in registers, so the sum over the
//     G heads needs no atomics (the Pallas `_dkv_kernel` revisits its block).
//   * Tiles wholly above the diagonal are skipped (the `live` predicate of
//     the Pallas kernels), and causal forward and dq grids start with the
//     query tiles that have the most keys.
//   * f32 (f32 models) takes CUDA-core kernels: a lane per key (forward, dq)
//     or per query row (dk/dv) for the dot products, a lane per head
//     dimension for the accumulators, tiles in shared memory.
// Not done yet: cp.async or TMA to overlap loads with the products, wgmma,
// ldmatrix, warp specialisation, a persistent grid.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise).

#include "mma_common.cuh"

namespace {

constexpr int kFaThreads = 128;  // 4 warps per CTA
constexpr int kFaRows = 64;      // mma kernels: rows a CTA owns, 16 per warp

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool keep(int key, int row, int Skv, int causal) {
  return key < Skv && (!causal || key <= row);
}

// ---- forward, tensor cores ---------------------------------------------------

// One CTA: query rows [q0, q0 + 64) of head h of row b; warp w owns rows
// q0 + 16w .. +16, lane (gid, tig) rows r0 = q0 + 16w + gid and r1 = r0 + 8.
// Q stays in registers as A fragments; each 64-key tile of K and V passes
// through shared memory.
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Sq, int Skv, float scale, int causal) {
  constexpr int KT = 64;       // keys per tile
  constexpr int STR = HD + 8;  // shared row stride (bf16): conflict padding
  __shared__ __align__(16) bf16 ks[KT * STR];
  __shared__ __align__(16) bf16 vs[KT * STR];
  const int nqt = (Sq + kFaRows - 1) / kFaRows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kFaRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + 16 * warp + gid, r1 = r0 + 8;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const bf16* qb = q + (size_t)b * Sq * qs_ + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * Skv * ks_ + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * Skv * ks_ + (size_t)kvh * HD;

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const int c = 16 * s + 2 * tig;
    qa[s][0] = r0 < Sq ? ld_pair(qb + r0 * qs_ + c) : 0u;
    qa[s][1] = r1 < Sq ? ld_pair(qb + r1 * qs_ + c) : 0u;
    qa[s][2] = r0 < Sq ? ld_pair(qb + r0 * qs_ + c + 8) : 0u;
    qa[s][3] = r1 < Sq ? ld_pair(qb + r1 * qs_ + c + 8) : 0u;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  const int kv_end = causal ? min(Skv, q0 + kFaRows) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += KT) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < KT * (HD / 8); c += kFaThreads) {
      const int r = c / (HD / 8), w = c % (HD / 8);
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (kv0 + r < Skv) {
        kr = __ldg(reinterpret_cast<const uint4*>(kb + (kv0 + r) * ks_) + w);
        vr = __ldg(reinterpret_cast<const uint4*>(vb + (kv0 + r) * ks_) + w);
      }
      *reinterpret_cast<uint4*>(ks + r * STR + 8 * w) = kr;
      *reinterpret_cast<uint4*>(vs + r * STR + 8 * w) = vr;
    }
    __syncthreads();
    // scores of the warp's 16 rows against the tile's 64 keys
    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < HD / 16; ++s) {
        const bf16* kr = ks + (8 * j + gid) * STR + 16 * s + 2 * tig;
        const uint32_t kf[2] = {ld_pair(kr), ld_pair(kr + 8)};
        mma_bf16(sc[j], qa[s], kf);
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * j + 2 * tig + (e & 1);
        const float x = keep(key, e < 2 ? r0 : r1, Skv, causal)
                            ? sc[j][e] * scale
                            : -CUDART_INF_F;
        sc[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no key yet keeps max -inf: exponentiate against 0 instead
    const float base0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float base1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float c0 = expf(m0 - base0), c1 = expf(m1 - base1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      sc[j][0] = expf(sc[j][0] - base0);
      sc[j][1] = expf(sc[j][1] - base0);
      sc[j][2] = expf(sc[j][2] - base1);
      sc[j][3] = expf(sc[j][3] - base1);
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * c0 + ps0;  // this lane's part of the row sum
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // o += P V, P rounded to bf16 (V's dtype), 16 keys per product
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) {
      const uint32_t pa[4] = {pack_f32(sc[2 * s][0], sc[2 * s][1]),
                              pack_f32(sc[2 * s][2], sc[2 * s][3]),
                              pack_f32(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                              pack_f32(sc[2 * s + 1][2], sc[2 * s + 1][3])};
      const bf16* vr = vs + (16 * s + 2 * tig) * STR + gid;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* vc = vr + 8 * n;
        const uint32_t vf[2] = {pack_pair(vc[0], vc[STR]),
                                pack_pair(vc[8 * STR], vc[9 * STR])};
        mma_bf16(acc[n], pa, vf);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* ob = o + (size_t)b * Sq * qs_ + (size_t)h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * qs_ + c) =
          pack_f32(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * qs_ + c) =
          pack_f32(acc[n][2] / d1, acc[n][3] / d1);
  }
  if (tig == 0) {
    float* lb = lse + ((size_t)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(d0);
    if (r1 < Sq) lb[r1] = m1 + logf(d1);
  }
}

// ---- backward, tensor cores: dq ----------------------------------------------

// One CTA: query rows [q0, q0 + 64) of head h of row b, as in the forward;
// Q and dO stay in registers, 32-key tiles of K and V pass through shared
// memory. Per tile: S = Q K^T and dP = dO V^T, p = exp(S * scale - lse),
// dS = p * (dP - delta) * scale, dq += dS K.
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int KV, int Sq, int Skv, float scale,
    int causal) {
  constexpr int KT = 32;
  constexpr int STR = HD + 8;
  __shared__ __align__(16) bf16 ks[KT * STR];
  __shared__ __align__(16) bf16 vs[KT * STR];
  const int nqt = (Sq + kFaRows - 1) / kFaRows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kFaRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + 16 * warp + gid, r1 = r0 + 8;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const size_t qoff = (size_t)b * Sq * qs_ + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * Skv * ks_ + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * Skv * ks_ + (size_t)kvh * HD;

  uint32_t qa[HD / 16][4], da[HD / 16][4];
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const int c = 16 * s + 2 * tig;
    const bf16* qr0 = q + qoff + r0 * qs_ + c;
    const bf16* qr1 = q + qoff + r1 * qs_ + c;
    const bf16* dr0 = dout + qoff + r0 * qs_ + c;
    const bf16* dr1 = dout + qoff + r1 * qs_ + c;
    qa[s][0] = r0 < Sq ? ld_pair(qr0) : 0u;
    qa[s][1] = r1 < Sq ? ld_pair(qr1) : 0u;
    qa[s][2] = r0 < Sq ? ld_pair(qr0 + 8) : 0u;
    qa[s][3] = r1 < Sq ? ld_pair(qr1 + 8) : 0u;
    da[s][0] = r0 < Sq ? ld_pair(dr0) : 0u;
    da[s][1] = r1 < Sq ? ld_pair(dr1) : 0u;
    da[s][2] = r0 < Sq ? ld_pair(dr0 + 8) : 0u;
    da[s][3] = r1 < Sq ? ld_pair(dr1 + 8) : 0u;
  }
  const float* lb = lse + ((size_t)b * H + h) * Sq;
  const float* db = delta + ((size_t)b * H + h) * Sq;
  const float lse0 = r0 < Sq ? lb[r0] : 0.f, lse1 = r1 < Sq ? lb[r1] : 0.f;
  const float dl0 = r0 < Sq ? db[r0] : 0.f, dl1 = r1 < Sq ? db[r1] : 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + kFaRows) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += KT) {
    __syncthreads();
    for (int c = tid; c < KT * (HD / 8); c += kFaThreads) {
      const int r = c / (HD / 8), w = c % (HD / 8);
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (kv0 + r < Skv) {
        kr = __ldg(reinterpret_cast<const uint4*>(kb + (kv0 + r) * ks_) + w);
        vr = __ldg(reinterpret_cast<const uint4*>(vb + (kv0 + r) * ks_) + w);
      }
      *reinterpret_cast<uint4*>(ks + r * STR + 8 * w) = kr;
      *reinterpret_cast<uint4*>(vs + r * STR + 8 * w) = vr;
    }
    __syncthreads();
    float sc[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < HD / 16; ++s) {
        const int off = (8 * j + gid) * STR + 16 * s + 2 * tig;
        const uint32_t kf[2] = {ld_pair(ks + off), ld_pair(ks + off + 8)};
        const uint32_t vf[2] = {ld_pair(vs + off), ld_pair(vs + off + 8)};
        mma_bf16(sc[j], qa[s], kf);
        mma_bf16(dp[j], da[s], vf);
      }
    }
    // dS, in place of the scores
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * j + 2 * tig + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float p = (row < Sq && keep(key, row, Skv, causal))
                            ? expf(sc[j][e] * scale - (e < 2 ? lse0 : lse1))
                            : 0.f;
        sc[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;
      }
    }
    // dq += dS K, 16 keys per product
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) {
      const uint32_t dsa[4] = {pack_f32(sc[2 * s][0], sc[2 * s][1]),
                               pack_f32(sc[2 * s][2], sc[2 * s][3]),
                               pack_f32(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                               pack_f32(sc[2 * s + 1][2], sc[2 * s + 1][3])};
      const bf16* kr = ks + (16 * s + 2 * tig) * STR + gid;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* kc = kr + 8 * n;
        const uint32_t kf[2] = {pack_pair(kc[0], kc[STR]),
                                pack_pair(kc[8 * STR], kc[9 * STR])};
        mma_bf16(acc[n], dsa, kf);
      }
    }
  }
  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * qs_ + c) =
          pack_f32(acc[n][0], acc[n][1]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * qs_ + c) =
          pack_f32(acc[n][2], acc[n][3]);
  }
}

// ---- backward, tensor cores: dk, dv ------------------------------------------

// One CTA: keys [k0, k0 + 64) of KV head kvh of row b; warp w owns keys
// k0 + 16w .. +16 (lane rows kr0 = k0 + 16w + gid and kr1 = kr0 + 8), whose
// dk and dv stay in registers. The K and V tile sits in shared memory;
// 16-row tiles of Q and dO of each of the G heads stream through. Per
// tile, transposed: S^T = K Q^T, dP^T = V dO^T, p = exp(S^T * scale - lse),
// dS^T = p * (dP^T - delta) * scale, dv += P^T dO, dk += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq,
    int Skv, float scale, int causal) {
  constexpr int QT = 16;  // query rows per streamed tile
  constexpr int STR = HD + 8;
  __shared__ __align__(16) bf16 ks[kFaRows * STR];
  __shared__ __align__(16) bf16 vs[kFaRows * STR];
  __shared__ __align__(16) bf16 qs[QT * STR];
  __shared__ __align__(16) bf16 dos[QT * STR];
  __shared__ float lse_s[QT], dl_s[QT];
  const int G = H / KV;
  const int k0 = blockIdx.x * kFaRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr0 = k0 + 16 * warp + gid, kr1 = kr0 + 8;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const size_t koff = (size_t)b * Skv * ks_ + (size_t)kvh * HD;

  for (int c = tid; c < kFaRows * (HD / 8); c += kFaThreads) {
    const int r = c / (HD / 8), w = c % (HD / 8);
    uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
    if (k0 + r < Skv) {
      kr = __ldg(reinterpret_cast<const uint4*>(k + koff + (k0 + r) * ks_) + w);
      vr = __ldg(reinterpret_cast<const uint4*>(v + koff + (k0 + r) * ks_) + w);
    }
    *reinterpret_cast<uint4*>(ks + r * STR + 8 * w) = kr;
    *reinterpret_cast<uint4*>(vs + r * STR + 8 * w) = vr;
  }
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  // query rows below k0 see none of this CTA's keys
  const int i_begin = causal ? (k0 / QT) * QT : 0;
  const bf16* kw = ks + (16 * warp + gid) * STR + 2 * tig;
  const bf16* vw = vs + (16 * warp + gid) * STR + 2 * tig;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * Sq * qs_ + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = delta + ((size_t)b * H + h) * Sq;
    for (int i0 = i_begin; i0 < Sq; i0 += QT) {
      __syncthreads();  // the previous query tile is consumed
      for (int c = tid; c < QT * (HD / 8); c += kFaThreads) {
        const int r = c / (HD / 8), w = c % (HD / 8);
        uint4 qr = make_uint4(0, 0, 0, 0), dr = qr;
        if (i0 + r < Sq) {
          qr = __ldg(reinterpret_cast<const uint4*>(q + qoff +
                                                    (i0 + r) * qs_) + w);
          dr = __ldg(reinterpret_cast<const uint4*>(dout + qoff +
                                                    (i0 + r) * qs_) + w);
        }
        *reinterpret_cast<uint4*>(qs + r * STR + 8 * w) = qr;
        *reinterpret_cast<uint4*>(dos + r * STR + 8 * w) = dr;
      }
      if (tid < QT) {
        lse_s[tid] = i0 + tid < Sq ? lb[i0 + tid] : 0.f;
        dl_s[tid] = i0 + tid < Sq ? db[i0 + tid] : 0.f;
      }
      __syncthreads();
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < HD / 16; ++s) {
        const int c = 16 * s;
        const uint32_t ka[4] = {ld_pair(kw + c), ld_pair(kw + 8 * STR + c),
                                ld_pair(kw + c + 8),
                                ld_pair(kw + 8 * STR + c + 8)};
        const uint32_t va[4] = {ld_pair(vw + c), ld_pair(vw + 8 * STR + c),
                                ld_pair(vw + c + 8),
                                ld_pair(vw + 8 * STR + c + 8)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = (8 * j + gid) * STR + c + 2 * tig;
          const uint32_t qf[2] = {ld_pair(qs + off), ld_pair(qs + off + 8)};
          const uint32_t df[2] = {ld_pair(dos + off), ld_pair(dos + off + 8)};
          mma_bf16(st[j], ka, qf);
          mma_bf16(dpt[j], va, df);
        }
      }
      // P^T in st, dS^T in dpt
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int li = 8 * j + 2 * tig + (e & 1), row = i0 + li;
          const int key = e < 2 ? kr0 : kr1;
          const float p = (row < Sq && keep(key, row, Skv, causal))
                              ? expf(st[j][e] * scale - lse_s[li])
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl_s[li]) * scale;
        }
      }
      const uint32_t pa[4] = {pack_f32(st[0][0], st[0][1]),
                              pack_f32(st[0][2], st[0][3]),
                              pack_f32(st[1][0], st[1][1]),
                              pack_f32(st[1][2], st[1][3])};
      const uint32_t dsa[4] = {pack_f32(dpt[0][0], dpt[0][1]),
                               pack_f32(dpt[0][2], dpt[0][3]),
                               pack_f32(dpt[1][0], dpt[1][1]),
                               pack_f32(dpt[1][2], dpt[1][3])};
      const bf16* dr = dos + (2 * tig) * STR + gid;
      const bf16* qr = qs + (2 * tig) * STR + gid;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* dc = dr + 8 * n;
        const bf16* qc = qr + 8 * n;
        const uint32_t df[2] = {pack_pair(dc[0], dc[STR]),
                                pack_pair(dc[8 * STR], dc[9 * STR])};
        const uint32_t qf[2] = {pack_pair(qc[0], qc[STR]),
                                pack_pair(qc[8 * STR], qc[9 * STR])};
        mma_bf16(dva[n], pa, df);
        mma_bf16(dka[n], dsa, qf);
      }
    }
  }
  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (kr0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + kr0 * ks_ + c) =
          pack_f32(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + kr0 * ks_ + c) =
          pack_f32(dva[n][0], dva[n][1]);
    }
    if (kr1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + kr1 * ks_ + c) =
          pack_f32(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + kr1 * ks_ + c) =
          pack_f32(dva[n][2], dva[n][3]);
    }
  }
}

// ---- f32, CUDA cores ----------------------------------------------------------

constexpr int kF32Rows = 16;     // forward: query rows per CTA, 4 per warp
constexpr int kF32DqRows = 8;    // dq: query rows per CTA, 2 per warp
constexpr int kF32Keys = 32;     // forward and dq: keys per tile, one a lane
constexpr int kF32KvRows = 8;    // dk/dv: keys per CTA, 2 per warp
constexpr int kF32QTile = 32;    // dk/dv: query rows per tile, one a lane

// Rows [r0, r0 + n) of a [*, ld] f32 matrix at `src` (row stride `ld`
// elements, HD used) into shared rows of stride `str`; rows at or past
// `lim` are zero.
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, int str, const float* src,
                                          size_t ld, int r0, int n, int lim) {
  for (int c = threadIdx.x; c < n * (HD / 4); c += kFaThreads) {
    const int r = c / (HD / 4), w = c % (HD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < lim)
      x = __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * ld) + w);
    float* d = dst + r * str + 4 * w;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// One CTA: query rows [q0, q0 + 16) of head h of row b; warp w owns 4 rows.
// Per 32-key tile a lane scores one key against each row; the row's online
// softmax runs across the warp, and each lane accumulates head dims
// lane, lane + 32, ...
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int Sq, int Skv, float scale,
    int causal) {
  constexpr int DL = HD / 32;
  constexpr int RW = kF32Rows / 4;
  __shared__ float qs[kF32Rows * HD];
  __shared__ float ks[kF32Keys * (HD + 1)];
  __shared__ float vs[kF32Keys * (HD + 1)];
  const int nqt = (Sq + kF32Rows - 1) / kF32Rows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const size_t qoff = (size_t)b * Sq * qs_ + (size_t)h * HD;
  const size_t koff = (size_t)b * Skv * ks_ + (size_t)kvh * HD;
  stage_f32<HD>(qs, HD, q + qoff, qs_, q0, kF32Rows, Sq);
  float m[RW], l[RW], acc[RW][DL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }
  const int kv_end = causal ? min(Skv, q0 + kF32Rows) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kF32Keys) {
    __syncthreads();
    stage_f32<HD>(ks, HD + 1, k + koff, ks_, kv0, kF32Keys, Skv);
    stage_f32<HD>(vs, HD + 1, v + koff, ks_, kv0, kF32Keys, Skv);
    __syncthreads();
    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = RW * warp + r, row = q0 + lr;
      const float* qr = qs + lr * HD;
      const float* kr = ks + lane * (HD + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
      s = keep(key, row, Skv, causal) ? s * scale : -CUDART_INF_F;
      const float mn = fmaxf(m[r], warp_max(s));
      const float base = mn == -CUDART_INF_F ? 0.f : mn;
      const float p = expf(s - base), c = expf(m[r] - base);
      l[r] = l[r] * c + warp_sum(p);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= c;
      for (int j = 0; j < kF32Keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * (HD + 1) + lane;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += pj * vr[32 * i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + RW * warp + r;
    if (row >= Sq) continue;
    const float d = fmaxf(l[r], 1e-30f);
    float* orow = o + qoff + row * qs_;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = acc[r][i] / d;
    if (lane == 0) lse[((size_t)b * H + h) * Sq + row] = m[r] + logf(d);
  }
}

// One CTA: query rows [q0, q0 + 8) of head h of row b; warp w owns 2 rows.
// Per 32-key tile a lane takes one key: s and dP of each row, then dS; dq
// accumulates over the keys with each lane on its head dims.
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int KV, int Sq, int Skv, float scale,
    int causal) {
  constexpr int DL = HD / 32;
  constexpr int RW = kF32DqRows / 4;
  __shared__ float qs[kF32DqRows * HD];
  __shared__ float dos[kF32DqRows * HD];
  __shared__ float ks[kF32Keys * (HD + 1)];
  __shared__ float vs[kF32Keys * (HD + 1)];
  const int nqt = (Sq + kF32DqRows - 1) / kF32DqRows;
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) *
                 kF32DqRows;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const size_t qoff = (size_t)b * Sq * qs_ + (size_t)h * HD;
  const size_t koff = (size_t)b * Skv * ks_ + (size_t)kvh * HD;
  stage_f32<HD>(qs, HD, q + qoff, qs_, q0, kF32DqRows, Sq);
  stage_f32<HD>(dos, HD, dout + qoff, qs_, q0, kF32DqRows, Sq);
  float ls[RW], dl[RW], acc[RW][DL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + RW * warp + r;
    ls[r] = row < Sq ? lse[((size_t)b * H + h) * Sq + row] : 0.f;
    dl[r] = row < Sq ? delta[((size_t)b * H + h) * Sq + row] : 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }
  const int kv_end = causal ? min(Skv, q0 + kF32DqRows) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kF32Keys) {
    __syncthreads();
    stage_f32<HD>(ks, HD + 1, k + koff, ks_, kv0, kF32Keys, Skv);
    stage_f32<HD>(vs, HD + 1, v + koff, ks_, kv0, kF32Keys, Skv);
    __syncthreads();
    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = RW * warp + r, row = q0 + lr;
      const float* qr = qs + lr * HD;
      const float* dr = dos + lr * HD;
      const float* kr = ks + lane * (HD + 1);
      const float* vr = vs + lane * (HD + 1);
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s += qr[d] * kr[d];
        dp += dr[d] * vr[d];
      }
      const float p = (row < Sq && keep(key, row, Skv, causal))
                          ? expf(s * scale - ls[r])
                          : 0.f;
      const float dsv = p * (dp - dl[r]) * scale;
      for (int j = 0; j < kF32Keys; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, dsv, j);
        const float* kj = ks + j * (HD + 1) + lane;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += dsj * kj[32 * i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + RW * warp + r;
    if (row >= Sq) continue;
    float* out = dq + qoff + row * qs_;
#pragma unroll
    for (int i = 0; i < DL; ++i) out[lane + 32 * i] = acc[r][i];
  }
}

// One CTA: keys [k0, k0 + 8) of KV head kvh of row b; warp w owns 2 keys.
// For each of the G heads, 32-row tiles of Q and dO stream through shared
// memory; a lane takes one query row (p and dS against each key), then dk
// and dv accumulate over the rows with each lane on its head dims.
template <int HD>
__global__ void __launch_bounds__(kFaThreads) fa_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int KV, int Sq,
    int Skv, float scale, int causal) {
  constexpr int DL = HD / 32;
  constexpr int RW = kF32KvRows / 4;
  __shared__ float kt[kF32KvRows * HD];
  __shared__ float vt[kF32KvRows * HD];
  __shared__ float qs[kF32QTile * (HD + 1)];
  __shared__ float dos[kF32QTile * (HD + 1)];
  __shared__ float lse_s[kF32QTile], dl_s[kF32QTile];
  const int G = H / KV;
  const int k0 = blockIdx.x * kF32KvRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs_ = (size_t)H * HD, ks_ = (size_t)KV * HD;
  const size_t koff = (size_t)b * Skv * ks_ + (size_t)kvh * HD;
  stage_f32<HD>(kt, HD, k + koff, ks_, k0, kF32KvRows, Skv);
  stage_f32<HD>(vt, HD, v + koff, ks_, k0, kF32KvRows, Skv);
  float dka[RW][DL], dva[RW][DL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < DL; ++i) dka[r][i] = dva[r][i] = 0.f;
  const int i_begin = causal ? (k0 / kF32QTile) * kF32QTile : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = (size_t)b * Sq * qs_ + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = delta + ((size_t)b * H + h) * Sq;
    for (int i0 = i_begin; i0 < Sq; i0 += kF32QTile) {
      __syncthreads();
      stage_f32<HD>(qs, HD + 1, q + qoff, qs_, i0, kF32QTile, Sq);
      stage_f32<HD>(dos, HD + 1, dout + qoff, qs_, i0, kF32QTile, Sq);
      if (threadIdx.x < kF32QTile) {
        const int row = i0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lb[row] : 0.f;
        dl_s[threadIdx.x] = row < Sq ? db[row] : 0.f;
      }
      __syncthreads();
      const int row = i0 + lane;
      const float* qr = qs + lane * (HD + 1);
      const float* dr = dos + lane * (HD + 1);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int lk = RW * warp + r, key = k0 + lk;
        const float* kr = kt + lk * HD;
        const float* vr = vt + lk * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s += qr[d] * kr[d];
          dp += dr[d] * vr[d];
        }
        const float p = (row < Sq && keep(key, row, Skv, causal))
                            ? expf(s * scale - lse_s[lane])
                            : 0.f;
        const float dsv = p * (dp - dl_s[lane]) * scale;
        for (int j = 0; j < kF32QTile; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float dsj = __shfl_sync(0xffffffffu, dsv, j);
          const float* qj = qs + j * (HD + 1) + lane;
          const float* dj = dos + j * (HD + 1) + lane;
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            dva[r][i] += pj * dj[32 * i];
            dka[r][i] += dsj * qj[32 * i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int key = k0 + RW * warp + r;
    if (key >= Skv) continue;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      dk[koff + key * ks_ + lane + 32 * i] = dka[r][i];
      dv[koff + key * ks_ + lane + 32 * i] = dva[r][i];
    }
  }
}

bool fa_args_ok(int B, int H, int KV, int Sq, int Skv, int hd, int causal,
                int dtype) {
  return B > 0 && KV > 0 && H % KV == 0 && Sq > 0 && Skv > 0 &&
         (hd == 64 || hd == 128) && (dtype == kF32 || dtype == kBF16) &&
         (!causal || Sq == Skv) && B <= 65535 && H <= 65535;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
               int causal, int dtype, cudaStream_t st) {
  if (dtype == kBF16) {
    fa_fwd_mma<HD><<<dim3(cdiv(Sq, kFaRows), H, B), kFaThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Sq,
        Skv, scale, causal);
  } else {
    fa_fwd_f32<HD><<<dim3(cdiv(Sq, kF32Rows), H, B), kFaThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
        Skv, scale, causal);
  }
  return cudaGetLastError();
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int KV, int Sq, int Skv, float scale,
               int causal, int dtype, cudaStream_t st) {
  if (dtype == kBF16) {
    fa_dq_mma<HD><<<dim3(cdiv(Sq, kFaRows), H, B), kFaThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), H, KV, Sq, Skv, scale, causal);
    const int err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fa_dkv_mma<HD><<<dim3(cdiv(Skv, kFaRows), KV, B), kFaThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KV, Sq, Skv,
        scale, causal);
  } else {
    fa_dq_f32<HD><<<dim3(cdiv(Sq, kF32DqRows), H, B), kFaThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), H, KV, Sq, Skv, scale, causal);
    const int err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fa_dkv_f32<HD><<<dim3(cdiv(Skv, kF32KvRows), KV, B), kFaThreads, 0,
                     st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), H, KV, Sq,
        Skv, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (dtype: 0 f32, 1 bf16), contiguous and
// 16-byte aligned; o [B,Sq,H,hd] in the same dtype and lse [B,H,Sq] f32 are
// written. hd is 64 or 128; causal needs Sq == Skv.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int KV,
                               int Sq, int Skv, int hd, float scale,
                               int causal, int dtype, void* stream) {
  if (!fa_args_ok(B, H, KV, Sq, Skv, hd, causal, dtype))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal,
                          dtype, st);
  return launch_fwd<128>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal,
                         dtype, st);
}

// The forward's inputs, do [B,Sq,H,hd] (same dtype), its lse and delta =
// rowsum(do * o) [B,H,Sq] f32; writes dq [B,Sq,H,hd] and dk, dv
// [B,Skv,KV,hd] in the inputs' dtype (two kernels on the stream).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, void* dk,
                               void* dv, int B, int H, int KV, int Sq, int Skv,
                               int hd, float scale, int causal, int dtype,
                               void* stream) {
  if (!fa_args_ok(B, H, KV, Sq, Skv, hd, causal, dtype))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, Sq,
                          Skv, scale, causal, dtype, st);
  return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, Sq,
                         Skv, scale, causal, dtype, st);
}

}  // extern "C"
