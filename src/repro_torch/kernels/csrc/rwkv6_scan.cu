// Hand-written Hopper (sm_90a) kernels of the chunked RWKV-6 WKV: the
// forward (K5) and its gradient (K5b).
//
//   K5  wkv_chunk_state, chunk_carry, wkv_chunk_out   replace the Pallas
//       `rwkv6_wkv` / `_kernel` (src/repro/kernels/rwkv6_scan.py) and, on
//       the training and prefill paths, the XLA `wkv6_chunked`
//       (src/repro/models/rwkv6.py)
//   K5b wkv_chunk_state<with W>, chunk_carry (both directions),
//       wkv_chunk_bwd and sum_mid: the gradient the JAX package takes from
//       XLA autodiff of `wkv6_chunked`
//
// Layout: the path's own. r, k, v, o, do, dr, dk, dv [B, L, H, D] (f32 or
// bf16); w, dw [B, L, H, D] f32 in (0, 1); u, du [H, D] f32. The sequence is
// cut into chunks of c <= 64 positions (L % c == 0). Within a chunk, per key
// channel i, cs_t = sum_{m <= t} log(clip(w_m, 1e-6, 1)) and cp_t = cs_{t-1}
// (cp_0 = 0); with S_z the [D, D] state entering chunk z,
//   o_t     = sum_{s < t} A_ts v_s + (r_t . (u k_t)) v_t + (r_t exp(cp_t)) S_z
//   A_ts    = sum_i r_t,i k_s,i exp(cp_t,i - cs_s,i)
//   S_{z+1} = exp(cs_last) S_z + sum_s (k_s exp(cs_last - cs_s)) (x) v_s,
// the decay a vector over the key channel (one row of S per channel). The
// pairwise decays differ per channel, so A is no plain product. (The
// reference forms k exp(-cs) and r exp(cp) apart: exp(-cs) overflows f32
// when the decay over a chunk passes e^88.)
//
// Sub-blocks around a reference point. The chunk is cut into blocks of 16
// rows. For t in T-block a and s in an S-block b < a, with ref_b = cs at
// block b's last row and q_a = cs at the row before block a,
//   exp(cp_t - cs_s) = exp(cp_t - q_a) f_ab exp(ref_b - cs_s),
// f_ab = exp(q_a - ref_b), and each factor is at most 1: cs never increases
// and t - 1 >= 16 a - 1 >= 16 b + 15 >= s. block_factors forms them once a
// chunk: Rh = r exp(cp - q_a) and Kt = k exp(ref_b - cs) as tiles, f_ab,
// g_a = exp(q_a) and h_b = exp(cs_last - ref_b) as vectors over the
// channels. A's pair (a, b) is then the product (Rh_a f_ab) Kt_b^T, which
// the tensor cores take; dr's and dk's decayed sums are products too
// (f_ab (dA_ab Kt_b) and f_ab (dA_ab^T Rh_a)), rescaled by their other
// factor per element; exp(cp_t) = exp(cp_t - q_a) g_a and exp(cs_last -
// cs_s) = h_b exp(ref_b - cs_s) put the state terms on the same tiles. Only
// the diagonal 16 x 16 blocks keep one exponential per (t, s < t, channel),
// on the CUDA cores, the exponent clamped at 0: in diag_block a lane takes
// its channels, forms each decay once and feeds A (summed over the lanes by
// halving exchanges), dr and dk from it.
//
// The kernels:
//   1. wkv_chunk_state (grid chunks x H x B; 4 warps, with W 8): cs, each
//      chunk's own state contribution (k exp(cs_last - cs))^T v and its
//      decay exp(cs_last); with W (the backward's) also W_z = (r exp(cp))^T
//      do; the decayed operands formed in place, then plain tile products;
//   2. chunk_carry (scan_common.cuh, shared with K4): S forwards (S_z in
//      place of chunk z's contribution, S_L the final state) and, in the
//      backward's launch, the state cotangent backwards (G_z = exp(cs_last)
//      G_{z+1} + W_z, G_L = 0, G_{z+1} in place of W_z);
//   3. wkv_chunk_out (4 warps, warp a the rows of T-block a): the scores'
//      pairs and diagonal block, o = A v + beta v + (Rh g_a) S_z;
//   4. wkv_chunk_bwd (8 warps in two teams of 4; the comment above it has
//      its phases): the T-team takes its block's rows as t (dA, dr), the
//      S-team as s (A^T, dv, dk); both teams take half the channels of each
//      diagonal block. The exponents' cotangents are d cp = r (dr's decayed
//      part), d cs = -k (dk's decayed part), d cs_last = sum_s k_s (dk's
//      state part) + exp(cs_last) sum_j (G o S)_ij, and d log w is their
//      reverse running sum; dw = d log w / w inside the clip;
//   5. sum_mid: du from per-chunk partials sum_t dbeta_t r_t k_t in a fixed
//      order: the gradient is deterministic (no atomics).
//
// Design:
// - Every product runs on the tensor cores (mma.sync m16n8k8, tf32 inputs,
//   f32 accumulation) in split TF32 (tf32_tiles.cuh: a_hi b_hi + a_hi b_lo
//   + a_lo b_hi, each depth step summed in a fresh accumulator). A bf16 r,
//   k, v or do is exact in tf32 and skips its lo products. The operands are
//   tiles read through tf32_tiles.cuh's loaders, a per-channel factor
//   applied as the fragment is read (mm_s: over the depth; regs_mm: over a
//   product's columns).
// - The tiles are 64 x 64 f32 in tf32_tiles.cuh's XOR-swizzled layout,
//   loaded in 16-byte pieces (cp.async for f32, 16-byte loads converted in
//   registers for bf16) before any use.
// - cs is summed in order by one lane a channel, as torch.cumsum sums it,
//   once, by the state kernel, which writes it out for the chunk kernels
//   (scratch [B, L, H, D]: 42 MB at rwkv6's shape, written once and read
//   once, in place of w's logs and running sums in a second kernel); so is
//   d log w's reverse running sum; du's partial is summed in order by one
//   lane a channel.
// - The carry streams: the next eight chunks' loads are issued before this
//   eight's stores; the backward's runs both directions in one launch.
// - Where a loop reads shared memory and writes it, the loads come first:
//   a store between two loads keeps the second behind it.
//
// Shared memory and registers a thread (ptxas, sm_90a): wkv_chunk_state 48
// KB and ~70 registers (4 CTAs an SM), with W 80 KB and ~80 (2 CTAs of 8
// warps); wkv_chunk_out 73 KB and ~140 (3 CTAs, 12 warps an SM);
// wkv_chunk_bwd 200 KB and ~250: one CTA of 8 warps an SM. The backward
// holds the chunk's inputs (r, k, v, do, cs; S_z and G_{z+1}), the factor
// tiles Rh and Kt, and dr's and dk's diagonal parts (later d cp and d cs)
// as eleven f32 tiles; its third phase reads nine of them at once (r and k
// raw for the bonus and the exponents' cotangents, Rh and Kt, cs, v, do,
// and both diagonal parts), so no second CTA fits without bf16 tiles in
// shared memory or a second launch that reads the inputs again.
//
// What bounds them (rwkv6-3b: B 1, L 4096, H 40, D 64, c 64; the count is
// chip_smoke.py's wkv_work): split-TF32 products at the TF32 peak (495
// TFLOP/s), exponentials and logarithms at the SFU rate that experiments/
// torch_mma_rate.py measures (4.16e12 a second), bytes at 3.35 TB/s; the
// largest of the three (bytes, for both). PR 15's f32 CUDA-core bound
// (0.060 and 0.150 ms) is printed beside them. What holds them back
// (PERF.md): each warp's chains of shared loads, decays, splits and
// mma.sync wait on one another at 8-12 warps an SM (an issue rate of some
// 0.15 instructions a clock a warp in clock64 stamps), and the backward's
// phases (the diagonal blocks, then the T-team's and S-team's products,
// then the running sums) leave warps idle at each barrier.
// Not done yet: wgmma (tf32 operands must be K-major), bf16 tiles in shared
// memory for bf16 inputs (a second backward CTA an SM), a fused carry, TMA.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise).

#include "scan_common.cuh"
#include "tf32_tiles.cuh"

#include <type_traits>

namespace {

constexpr float kClip = 1e-6f;     // the reference's clip of w before its log
constexpr int kFwdThreads = 128;   // a warp per 16-row block of the chunk
constexpr int kBwdThreads = 256;   // two teams of four warps
constexpr int kBlk = 16;           // rows of a sub-block
constexpr int kBlkF = kBlk * kBlk;

// r, k, v and do of type T are exact in tf32 when bf16
template <typename T>
constexpr bool kExactT = std::is_same<T, bf16>::value;

// Per-CTA view of chunk z of row b, head h.
struct WkvChunk {
  int b, h, z, c, L, H, D, nc;
  __device__ WkvChunk(int L_, int H_, int D_, int c_)
      : b(blockIdx.z), h(blockIdx.y), z(blockIdx.x), c(c_), L(L_), H(H_),
        D(D_), nc(L_ / c_) {}
  // element (0, 0) of the chunk in a [B, L, H, D] tensor; rows ld() apart
  __device__ size_t x0() const {
    return (((size_t)b * L + (size_t)z * c) * H + h) * D;
  }
  __device__ long long ld() const { return (long long)H * D; }
  // [B, H, nc, D, D]: this chunk's state
  __device__ size_t st() const {
    return (((size_t)b * H + h) * nc + z) * D * D;
  }
  // [B, H, nc, D]: this chunk's decays
  __device__ size_t dc() const {
    return (((size_t)b * H + h) * nc + z) * D;
  }
};

__host__ __device__ __forceinline__ int tiles8(int n) { return (n + 7) >> 3; }

// exp(x) of a decay's exponent, clamped at 0: __expf's arithmetic (one
// multiply, ex2.approx) with a result below f32's normal range flushed to
// zero, which saves __expf's rescaling around ex2 (several instructions a
// decay, where the kernels form tens of thousands a chunk)
__device__ __forceinline__ float dec(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(fminf(x, 0.f) * 1.4426950408889634f));
  return y;
}

// The w tile becomes cs in place: CS[t][i] = sum_{m <= t} log(clip(w_m,i,
// 1e-6, 1)) for t < c, summed in order (so cs never increases and every
// exponent the kernels form is <= 0); rows t >= c hold cs_{c-1} and
// channels i >= D zero. The logs are taken by all NT threads, then thread i
// < 64 sums channel i in order; both passes end in a barrier, which every
// thread of the CTA reaches.
template <int NT>
__device__ __forceinline__ void log_cumsum(float* CS, int c, int D) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kE * kE; e += NT) {
    const int t = e >> 6, i = e & 63;
    float* p = CS + tat(t, i);
    *p = (t < c && i < D) ? logf(fminf(fmaxf(*p, kClip), 1.f)) : 0.f;
  }
  __syncthreads();
  if (tid < kE) {
    float run = 0.f;
#pragma unroll
    for (int t0 = 0; t0 < kE; t0 += kBlk) {
      float x[kBlk];
#pragma unroll
      for (int t = 0; t < kBlk; ++t) x[t] = CS[tat(t0 + t, tid)];
#pragma unroll
      for (int t = 0; t < kBlk; ++t) {
        run += x[t];
        CS[tat(t0 + t, tid)] = run;
      }
    }
  }
  __syncthreads();
}

// The chunk kernels' cs tile from the state kernel's (rows below c, by
// load_tile), after the caller's wait and barrier: rows c .. 63 take
// cs_{c-1}. Ends in a barrier, which every thread of the CTA reaches.
template <int NT>
__device__ __forceinline__ void cs_rows_past_c(float* CS, int c) {
  for (int e = threadIdx.x; e < (kE - c) * kE; e += NT) {
    const int t = c + e / kE, i = e % kE;
    CS[tat(t, i)] = CS[tat(c - 1, i)];
  }
  __syncthreads();
}

// dst[t][i] = T[t][i] for t < c, i < D (dst rows ld apart), in 16-byte
// pieces where D allows, by the NT threads of the CTA.
template <int NT>
__device__ __forceinline__ void store_rows(float* dst, long long ld,
                                           const float* T, int c, int D) {
  for (int e = threadIdx.x; e < kE * 16; e += NT) {
    const int t = e >> 4, i = (e & 15) * 4;
    if (t >= c || i >= D) continue;
    const float4 x = *reinterpret_cast<const float4*>(T + tat(t, i));
    float* o = dst + t * ld + i;
    if (D % 4 == 0) {
      *reinterpret_cast<float4*>(o) = x;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      for (int q = 0; q < 4 && i + q < D; ++q) o[q] = xs[q];
    }
  }
}

// cp_t,i = cs_{t-1},i (0 at t = 0)
__device__ __forceinline__ float cp_of(const float* CS, int t, int i) {
  return t > 0 ? CS[tat(t - 1, i)] : 0.f;
}

// cp of the channels (i, i + 1) of row t, i even
__device__ __forceinline__ float2 cp_of2(const float* CS, int t, int i) {
  return t > 0 ? ld2(CS, t - 1, i) : make_float2(0.f, 0.f);
}

// v[0 .. 2H) -> v[0 .. H): one halving exchange over lanes `off` apart
template <int H>
__device__ __forceinline__ void halve(float (&v)[kBlk], int off) {
  const bool up = (threadIdx.x & 31) & off;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j], hi = v[j + H];
    v[j] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, off);
  }
}

// v[0 .. NS) summed over the warp's 32 lanes by halving exchanges (about NS
// shuffles for NS sums, where NS reductions of one value would take 5 NS):
// lane l returns the sum of slot l / (32 / NS). v is overwritten.
template <int NS>
__device__ __forceinline__ float lane_sums(float (&v)[kBlk]) {
  if (NS == 16) {
    halve<8>(v, 16);
    halve<4>(v, 8);
    halve<2>(v, 4);
    halve<1>(v, 2);
    return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
  }
  halve<4>(v, 16);
  halve<2>(v, 8);
  halve<1>(v, 4);
  const float s = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// The sub-block form's factors, after cs, by the CTA's NT threads. For the
// T-block a (rows 16 a ..) and the S-block b < a, with ref_b = cs at block
// b's last row (rows >= c hold cs_{c-1}) and q_a = cs at the row before
// block a (0 for a = 0), every decay of the pair factors as
//   exp(cp_t - cs_s) = exp(cp_t - q_a) f_ab exp(ref_b - cs_s),
// f_ab = exp(q_a - ref_b), each factor at most 1. Rh[t] = r_t exp(cp_t -
// q_a) and Kt[s] = k_s exp(ref_b - cs_s) (either may be null); fab[a][b]
// (b < a), g[a] = exp(q_a), h[b] = exp(cs_last - ref_b) over the channels.
// The caller syncs after.
template <int NT>
__device__ __forceinline__ void block_factors(const float* CS, const float* Rs,
                                              const float* Ks, float* Rh,
                                              float* Kt, float* fab,
                                              float* gv, float* hv, int c) {
  const int tid = threadIdx.x;
  // 16-byte pieces (four channels) of a row: the XOR keeps them whole
  auto at4 = [](const float* T, int row, int i) {
    return *reinterpret_cast<const float4*>(T + tat(row, i));
  };
  for (int e = tid; e < kE * 16; e += NT) {
    const int t = e >> 4, i = (e & 15) * 4, a = t >> 4;
    const float4 cs = at4(CS, t, i);
    const float4 cp = t ? at4(CS, t - 1, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 q = a ? at4(CS, kBlk * a - 1, i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 ref = at4(CS, kBlk * a + kBlk - 1, i);
    if (Rh) {
      const float4 x = at4(Rs, t, i);
      *reinterpret_cast<float4*>(Rh + tat(t, i)) =
          make_float4(x.x * dec(cp.x - q.x), x.y * dec(cp.y - q.y),
                      x.z * dec(cp.z - q.z), x.w * dec(cp.w - q.w));
    }
    if (Kt) {
      const float4 x = at4(Ks, t, i);
      *reinterpret_cast<float4*>(Kt + tat(t, i)) =
          make_float4(x.x * dec(ref.x - cs.x), x.y * dec(ref.y - cs.y),
                      x.z * dec(ref.z - cs.z), x.w * dec(ref.w - cs.w));
    }
  }
  for (int e = tid; e < 4 * kE; e += NT) {
    const int a = e >> 6, i = e & 63;
    const float q = a ? CS[tat(kBlk * a - 1, i)] : 0.f;
    const float ref = CS[tat(kBlk * a + kBlk - 1, i)];
    gv[e] = dec(q);
    if (hv) hv[e] = dec(CS[tat(c - 1, i)] - ref);
    for (int b = 0; b < a; ++b)
      fab[(a * 4 + b) * kE + i] = dec(q - CS[tat(kBlk * b + kBlk - 1, i)]);
  }
}

// acc[nt] += sum over depth k in k-steps [k_lo, k_hi) of A(r, k) sk[k]
// B(k, 8 nt + col), column tiles nt in [n_lo, n_hi): A a plain tile read by
// ARow, sk a scale over the depth (null: none), B a tile loader (BRow,
// BCol).
template <bool kAExact, bool kBExact, typename OB>
__device__ __forceinline__ void mm_s(float (&acc)[8][4], const ARow& A,
                                     const float* sk, const OB& B, int k_lo,
                                     int k_hi, int n_lo, int n_hi) {
  const int t = threadIdx.x & 3;
#pragma unroll 1
  for (int ks = k_lo; ks < k_hi; ++ks) {
    float a[4];
    A.load(ks, a);
    if (sk) {
      const float s0 = sk[8 * ks + t], s4 = sk[8 * ks + t + 4];
      a[0] *= s0;
      a[1] *= s0;
      a[2] *= s4;
      a[3] *= s4;
    }
    const FragA fa = frag_a<kAExact>(a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < n_lo || nt >= n_hi) continue;
      float b0, b1;
      B.load(ks, nt, b0, b1);
      mma3<kAExact, kBExact>(acc[nt], fa, b0, b1);
    }
  }
}

// acc[nt] += p B as strip_mm_regs over p's column tiles [k_lo, k_hi), with
// B(k, n) = T[k][n] fs(kt, n): a scale per (column tile of p, column).
template <bool kBExact, typename FS>
__device__ __forceinline__ void regs_mm(float (&acc)[8][4],
                                        const float (&p)[8][4], int k_lo,
                                        int k_hi, const float* T, FS fs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = tswz(2 * t), s1 = tswz(2 * t + 1);
  const float* p0 = T + 2 * t * kE + (g ^ (s0 & 4));
  const float* p1 = T + (2 * t + 1) * kE + (g ^ (s1 & 4));
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    if (kt < k_lo || kt >= k_hi) continue;
    const FragA fa = frag_a(p[kt][0], p[kt][2], p[kt][1], p[kt][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float f = fs(kt, 8 * nt + g);
      mma3<false, kBExact>(acc[nt], fa,
                           f * p0[8 * kE * kt + ((8 * nt) ^ (s0 & 24))],
                           f * p1[8 * kE * kt + ((8 * nt) ^ (s1 & 24))]);
    }
  }
}

// The diagonal block of rows r0 .. r0 + 15 (one warp), exact: lane l takes
// the NQ channels i0 + l + 32 q and forms each decay exp(cp_t,i - cs_s,i),
// s < t in the block, once. Writes Ad[t'][s'] = the sum over those channels
// of r_t k_s e (t = r0 + t', s = r0 + s', s' < t'; 16 x 16 row-major, the
// rest unwritten). kBwd: with dAd the same block of dA, also DR[t][i] =
// sum_{s < t in the block} dA_ts k_s,i e and DK[s][i] = sum_{t > s in the
// block} dA_ts r_t,i e for the block's 16 rows and the lane's channels.
template <bool kBwd, int NQ>
__device__ __forceinline__ void diag_block(const float* Rs, const float* Ks,
                                           const float* CS, const float* dAd,
                                           float* Ad, float* DR, float* DK,
                                           int r0, int i0) {
  const int lane = threadIdx.x & 31;
  // every load first and every store last: a store between two loads of
  // shared memory keeps the second behind it
  float kk[NQ][kBlk], cs[NQ][kBlk], rr[NQ][kBlk], dk[NQ][kBlk], dr[NQ][kBlk];
  float asum[kBlk];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int s = 0; s < kBlk; ++s) {
      const int i = tat(r0 + s, i0 + lane + 32 * q);
      kk[q][s] = Ks[i];
      cs[q][s] = CS[i];
      rr[q][s] = Rs[i];
      dk[q][s] = 0.f;
      dr[q][s] = 0.f;
    }
  asum[0] = 0.f;
#pragma unroll
  for (int t = 1; t < kBlk; ++t) {
    float p[kBlk], da[kBlk];
#pragma unroll
    for (int s = 0; s < kBlk; ++s)
      da[s] = kBwd && s < t ? dAd[t * kBlk + s] : 0.f;
#pragma unroll
    for (int s = 0; s < kBlk; ++s) {
      p[s] = 0.f;
      if (s >= t) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float e = dec(cs[q][t - 1] - cs[q][s]);
        p[s] = fmaf(rr[q][t] * kk[q][s], e, p[s]);
        if (kBwd) {
          dr[q][t] = fmaf(da[s] * kk[q][s], e, dr[q][t]);
          dk[q][s] = fmaf(da[s] * rr[q][t], e, dk[q][s]);
        }
      }
    }
    asum[t] = t <= 8 ? lane_sums<8>(p) : lane_sums<16>(p);
  }
#pragma unroll
  for (int t = 1; t < kBlk; ++t) {
    const int slot = t <= 8 ? lane >> 2 : lane >> 1;
    const bool mine = t <= 8 ? (lane & 3) == 0 : (lane & 1) == 0;
    if (mine && slot < t) Ad[t * kBlk + slot] = asum[t];
  }
  if (kBwd)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int s = 0; s < kBlk; ++s) {
        const int i = tat(r0 + s, i0 + lane + 32 * q);
        DR[i] = dr[q][s];
        DK[i] = dk[q][s];
      }
}

// Fragment positions of a C tile: element e of column tile nt of the
// strip from row r0 lies at row r0 + g + 8 (e / 2), column 8 nt + 2 t + e % 2.
__device__ __forceinline__ int frag_row(int r0, int e) {
  return r0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

// The strip's C tiles into a [rows, D] tensor slice (row stride ld) at rows
// r0 .. r0 + 15 below c and columns below D.
template <typename T>
__device__ __forceinline__ void store_strip_out(T* dst, long long ld,
                                                const float (&acc)[8][4],
                                                int r0, int c, int D) {
  const bool pair_ok = D % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = frag_col(nt, 0);
    if (j >= D) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = frag_row(r0, 2 * hf);
      if (row < c)
        store_pair(dst + row * ld + j, acc[nt][2 * hf], acc[nt][2 * hf + 1],
                   j + 1 < D, pair_ok);
    }
  }
}

// ---- K5 pass 1 (and K5b's first): the chunks' own states -------------------

// V_z[i][j] = sum_s k_s,i exp(cs_last,i - cs_s,i) v_s,j into states,
// exp(cs_last) into decays and the chunk's cs into cs_out (the chunk kernels
// read it there, once formed); with kW also W_z[i][j] = sum_t r_t,i
// exp(cp_t,i) do_t,j into gstates. Warp w takes state rows i of [16 (w % 4), 16 (w % 4)
// + 16); with kW eight warps, warp w the product w / 4 (V, then W).
template <typename T, bool kW>
__global__ void __launch_bounds__(kW ? 2 * kFwdThreads : kFwdThreads)
wkv_chunk_state(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ r,
    const T* __restrict__ dout, float* __restrict__ states,
    float* __restrict__ gstates, float* __restrict__ decays,
    float* __restrict__ cs_out, int L, int H, int D, int c) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* CS = sm;
  float* Ks = CS + kTileF;
  float* Vs = Ks + kTileF;
  float* ones = Vs + kTileF;       // [64] 1: ACol's scale
  float* Rs = ones + kE;           // kW only
  float* Ds = Rs + kTileF;         // kW only
  constexpr int NT = kW ? 2 * kFwdThreads : kFwdThreads;
  const WkvChunk ch(L, H, D, c);
  const int tid = threadIdx.x;
  const size_t x0 = ch.x0();
  const long long ld = ch.ld();
  load_tile<NT>(CS, w + x0, ld, c, D, tid);
  load_tile<NT>(Ks, k + x0, ld, c, D, tid);
  load_tile<NT>(Vs, v + x0, ld, c, D, tid);
  if (kW) {
    load_tile<NT>(Rs, r + x0, ld, c, D, tid);
    load_tile<NT>(Ds, dout + x0, ld, c, D, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  log_cumsum<NT>(CS, c, D);
  if (tid < D) decays[ch.dc() + tid] = __expf(CS[tat(c - 1, tid)]);
  store_rows<NT>(cs_out + x0, ld, CS, c, D);   // for the chunk kernels
  // the products' decayed operands in place: k_s exp(cs_last - cs_s) and
  // (kW) r_t exp(cp_t)
  for (int e = tid; e < kE * 16; e += NT) {
    const int row = e >> 4, i = (e & 15) * 4;
    const float4 cs = *reinterpret_cast<const float4*>(CS + tat(row, i));
    const float4 last = *reinterpret_cast<const float4*>(CS + tat(c - 1, i));
    float4* kp = reinterpret_cast<float4*>(Ks + tat(row, i));
    const float4 x = *kp;
    *kp = make_float4(x.x * dec(last.x - cs.x), x.y * dec(last.y - cs.y),
                      x.z * dec(last.z - cs.z), x.w * dec(last.w - cs.w));
    if (kW) {
      const float4 cp =
          row ? *reinterpret_cast<const float4*>(CS + tat(row - 1, i))
              : make_float4(0.f, 0.f, 0.f, 0.f);
      float4* rp = reinterpret_cast<float4*>(Rs + tat(row, i));
      const float4 y = *rp;
      *rp = make_float4(y.x * dec(cp.x), y.y * dec(cp.y), y.z * dec(cp.z),
                        y.w * dec(cp.w));
    }
  }
  if (tid < kE) ones[tid] = 1.f;
  __syncthreads();
  const int warp = tid >> 5, r0 = 16 * (warp & 3), half = warp >> 2;
  if (r0 >= D) return;
  float* dst = (kW && half ? gstates : states) + ch.st();
  float acc[8][4];
  zero(acc);
  if (kW && half)
    strip_mm<false, kExactT<T>>(acc, ACol(Rs, r0, ones), BRow(Ds));
  else
    strip_mm<false, kExactT<T>>(acc, ACol(Ks, r0, ones), BRow(Vs));
  const bool pair_ok = D % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = frag_col(nt, 0);
    if (j >= D) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = frag_row(r0, 2 * hf);
      if (i < D)
        store_pair(dst + (size_t)i * D + j, acc[nt][2 * hf],
                   acc[nt][2 * hf + 1], j + 1 < D, pair_ok);
    }
  }
}

// ---- K5 pass 3: the outputs ------------------------------------------------

// o_t = sum_{s<t} A_ts v_s + beta_t v_t + (r_t exp(cp_t)) S_z for the rows t
// of warp a's block: A's pairs (a, b < a) as (Rh_a f_ab) Kt_b^T
// (block_factors), its diagonal block by diag_block; r exp(cp) = Rh g_a.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 3) wkv_chunk_out(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ cs,
    const float* __restrict__ u, const float* __restrict__ states,
    T* __restrict__ o, int L, int H, int D, int c) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* CS = sm;
  float* Rs = CS + kTileF;         // r; then Rh (block_factors)
  float* Ks = Rs + kTileF;         // k; then Kt
  float* Vs = Ks + kTileF;
  float* Ss = CS;                  // then S_z, the state entering the chunk
  float* Ad = Vs + kTileF;         // [4][16 x 16] the diagonal blocks of A
  float* us = Ad + 4 * kBlkF;      // [64] u
  float* fab = us + kE;            // [4][4][64]
  float* gv = fab + 16 * kE;       // [4][64]
  const WkvChunk ch(L, H, D, c);
  const int tid = threadIdx.x;
  const size_t x0 = ch.x0();
  const long long ld = ch.ld();
  load_tile<kFwdThreads>(CS, cs + x0, ld, c, D, tid);
  load_tile<kFwdThreads>(Rs, r + x0, ld, c, D, tid);
  load_tile<kFwdThreads>(Ks, k + x0, ld, c, D, tid);
  load_tile<kFwdThreads>(Vs, v + x0, ld, c, D, tid);
  if (tid < kE) us[tid] = tid < D ? u[ch.h * D + tid] : 0.f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cs_rows_past_c<kFwdThreads>(CS, c);
  const int a = tid >> 5, r0 = kBlk * a;
  const bool live = r0 < c;        // the block holds rows of the chunk
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nd = tiles8(D);
  float ba = 0.f, bb = 0.f;        // beta at rows r0 + g and r0 + g + 8
  if (live) {
    diag_block<false, 2>(Rs, Ks, CS, nullptr, Ad + a * kBlkF, nullptr,
                         nullptr, r0, 0);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = 8 * m + 2 * t;
      const float2 ra = ld2(Rs, r0 + g, i), ka = ld2(Ks, r0 + g, i);
      const float2 rb = ld2(Rs, r0 + g + 8, i), kb = ld2(Ks, r0 + g + 8, i);
      const float2 uu = *reinterpret_cast<const float2*>(us + i);
      ba += ra.x * uu.x * ka.x + ra.y * uu.y * ka.y;
      bb += rb.x * uu.x * kb.x + rb.y * uu.y * kb.y;
    }
    ba = quad_sum(ba);
    bb = quad_sum(bb);
  }
  __syncthreads();                 // r and k are read raw for the last time
  block_factors<kFwdThreads>(CS, Rs, Ks, Rs, Ks, fab, gv, nullptr, c);
  __syncthreads();                 // cs is read for the last time above
  load_tile<kFwdThreads>(Ss, states + ch.st(), D, D, D, tid);
  cp_async_commit();
  float O[8][4];
  zero(O);
  if (live) {
    float P[8][4];
    zero(P);
    const ARow ra(Rs, r0);
    const BCol kb(Ks, 0);
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (b < a)
        mm_s<false, false>(P, ra, fab + (a * 4 + b) * kE, kb, 0, nd, 2 * b,
                           2 * b + 2);
    const float* ad = Ad + a * kBlkF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt != 2 * a && nt != 2 * a + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = frag_row(r0, e) - r0, s = frag_col(nt, e) - r0;
        P[nt][e] = s < tt ? ad[tt * kBlk + s] : 0.f;
      }
    }
    strip_mm_regs<kExactT<T>>(O, P, 0, 2 * a + 2, Vs);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  // + (Rh g_a) S_z + beta v
  mm_s<false, false>(O, ARow(Rs, r0), gv + a * kE, BRow(Ss), 0, nd, 0, 8);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = frag_col(nt, 0);
    const float2 va = ld2(Vs, r0 + g, j), vb = ld2(Vs, r0 + g + 8, j);
    O[nt][0] += ba * va.x;
    O[nt][1] += ba * va.y;
    O[nt][2] += bb * vb.x;
    O[nt][3] += bb * vb.y;
  }
  store_strip_out(o + x0, ld, O, r0, c, D);
}

// ---- K5b: the chunk's gradients --------------------------------------------

// Warps 0-3 (the T-team) take the rows of block a = warp as t, warps 4-7
// (the S-team) the rows of block b = warp - 4 as s; block_factors' Rh, Kt,
// fab, g, h factor every pair's decays:
//   phase 1: cs; the S-team's beta_t = r_t . (u k_t), dbeta_t = do_t . v_t;
//            then the factors;
//   phase 2: T-team: dA's diagonal block, then diag_block (A's, dr's and
//            dk's diagonal parts into Ad, DR, DK); S-team: v G^T and dv's
//            state term (Kt h_b) G (held in registers), exp(cs_last) sum_j
//            (G o S)_ij;
//   phase 3: T-team: dr = Eh (sum_{b<a} f_ab (dA_ab Kt_b) + g_a (do S^T)) +
//            DR + dbeta u k, Eh = exp(cp - q_a); DR <- d cp = r (dr -
//            dbeta u k); S-team: dv = A^T do + the state term + beta do,
//            with A^T's pairs Kt_b f_ab Rh_a^T and its diagonal from Ad;
//            dk = Ft (sum_{a>b} f_ab (dA_ab^T Rh_a) + h_b (v G^T)) + DK +
//            dbeta u r, Ft = exp(ref_b - cs); DK <- d cs = -k (dk - dbeta u
//            r); d cs_last's part sum_s k_s (dk's state part);
//   phase 4: dw from the reverse running sum of d cs and d cp (threads
//            0-63, a channel each), du's partial (threads 64-127).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) wkv_chunk_bwd(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ cs, const float* __restrict__ u,
    const T* __restrict__ dout, const float* __restrict__ states,
    const float* __restrict__ gstates,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part, int B, int L, int H,
    int D, int c) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* CS = sm;
  float* Rs = CS + kTileF;
  float* Ks = Rs + kTileF;
  float* Vs = Ks + kTileF;
  float* Ds = Vs + kTileF;         // do
  float* Ss = Ds + kTileF;         // S_z, the state entering the chunk
  float* Gs = Ss + kTileF;         // G_{z+1}; in phase 3 w
  float* DR = Gs + kTileF;         // dr's diagonal part, then d cp
  float* DK = DR + kTileF;         // dk's diagonal part, then d cs
  float* Rh = DK + kTileF;         // block_factors' r and k factors
  float* Kt = Rh + kTileF;
  float* Ad = Kt + kTileF;         // [2][4][16 x 16] A's diagonal blocks,
                                   // over each team's half of the channels
  float* dAd = Ad + 8 * kBlkF;     // [2][4][16 x 16] dA's (a copy a team)
  float* us = dAd + 8 * kBlkF;     // [64] each
  float* beta = us + kE;
  float* dbeta = beta + kE;
  float* gsv = dbeta + kE;         // exp(cs_last) sum_j G_ij S_ij
  float* dlp = gsv + kE;           // [4][64] sum_s k_s (dk's state part)
  float* fab = dlp + 4 * kE;       // [4][4][64]
  float* gv = fab + 16 * kE;       // [4][64]
  float* hv = gv + 4 * kE;         // [4][64]
  const WkvChunk ch(L, H, D, c);
  const int tid = threadIdx.x;
  const size_t x0 = ch.x0();
  const long long ld = ch.ld();
  load_tile<kBwdThreads>(CS, cs + x0, ld, c, D, tid);
  load_tile<kBwdThreads>(Rs, r + x0, ld, c, D, tid);
  load_tile<kBwdThreads>(Ks, k + x0, ld, c, D, tid);
  load_tile<kBwdThreads>(Vs, v + x0, ld, c, D, tid);
  load_tile<kBwdThreads>(Ds, dout + x0, ld, c, D, tid);
  load_tile<kBwdThreads>(Ss, states + ch.st(), D, D, D, tid);
  load_tile<kBwdThreads>(Gs, gstates + ch.st(), D, D, D, tid);
  if (tid < kE) us[tid] = tid < D ? u[ch.h * D + tid] : 0.f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, team = warp >> 2, a = warp & 3;
  const int r0 = kBlk * a, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kc = tiles8(c), nd = tiles8(D);
  const bool live = r0 < c;        // the block holds rows of the chunk
  constexpr bool kEx = kExactT<T>;

  // phase 1
  if (team == 1) {
    float ba = 0.f, bb = 0.f, da = 0.f, db = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = 8 * m + 2 * t;
      const float2 uu = *reinterpret_cast<const float2*>(us + i);
      const float2 ra = ld2(Rs, r0 + g, i), ka = ld2(Ks, r0 + g, i);
      const float2 rb = ld2(Rs, r0 + g + 8, i), kb = ld2(Ks, r0 + g + 8, i);
      const float2 pa = ld2(Ds, r0 + g, i), va = ld2(Vs, r0 + g, i);
      const float2 pb = ld2(Ds, r0 + g + 8, i), vb = ld2(Vs, r0 + g + 8, i);
      ba += ra.x * uu.x * ka.x + ra.y * uu.y * ka.y;
      bb += rb.x * uu.x * kb.x + rb.y * uu.y * kb.y;
      da += pa.x * va.x + pa.y * va.y;
      db += pb.x * vb.x + pb.y * vb.y;
    }
    ba = quad_sum(ba);
    bb = quad_sum(bb);
    da = quad_sum(da);
    db = quad_sum(db);
    if (t == 0) {
      beta[r0 + g] = ba;
      beta[r0 + g + 8] = bb;
      dbeta[r0 + g] = da;
      dbeta[r0 + g + 8] = db;
    }
  }
  cs_rows_past_c<kBwdThreads>(CS, c);
  block_factors<kBwdThreads>(CS, Rs, Ks, Rh, Kt, fab, gv, hv, c);
  __syncthreads();

  // phase 2
  float st_k[8][4], st_v[8][4];    // S-team: v G^T, dv's state term
  float drs[8][4];                 // T-team: do S^T
  const float* last = CS + (c - 1) * kE;
  auto lastf = [&](int i) { return last[i ^ tswz(c - 1)]; };
  if (live) {
    // dA's diagonal block (each team its own copy), then the team's half of
    // the channels of the diagonal block
    float x[8][4];
    zero(x);
    mm_s<kEx, kEx>(x, ARow(Ds, r0), nullptr, BCol(Vs, 0), 0, nd, 2 * a,
                   2 * a + 2);
    float* dad = dAd + (team * 4 + a) * kBlkF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt != 2 * a && nt != 2 * a + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = frag_row(r0, e) - r0, s = frag_col(nt, e) - r0;
        dad[tt * kBlk + s] = s < tt ? x[nt][e] : 0.f;
      }
    }
    __syncwarp();
    diag_block<true, 1>(Rs, Ks, CS, dad, Ad + (team * 4 + a) * kBlkF, DR, DK,
                        r0, 32 * team);
    if (team == 0) {
      zero(drs);
      mm_s<kEx, false>(drs, ARow(Ds, r0), nullptr, BCol(Ss), 0, nd, 0, 8);
    } else {
      zero(st_k);
      strip_mm<kEx, false>(st_k, ARow(Vs, r0), BCol(Gs));
      zero(st_v);
      mm_s<false, false>(st_v, ARow(Kt, r0), hv + a * kE, BRow(Gs), 0, nd,
                         0, 8);
    }
  }
  if (team == 0) {
    // exp(cs_last) sum_j G_ij S_ij for the state rows i = r0 .. r0 + 15
    float ga = 0.f, gb = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = 8 * m + 2 * t;
      const float2 g0 = ld2(Gs, r0 + g, j), s0 = ld2(Ss, r0 + g, j);
      const float2 g1 = ld2(Gs, r0 + g + 8, j), s1 = ld2(Ss, r0 + g + 8, j);
      ga += g0.x * s0.x + g0.y * s0.y;
      gb += g1.x * s1.x + g1.y * s1.y;
    }
    ga = quad_sum(ga);
    gb = quad_sum(gb);
    if (t == 0) {
      gsv[r0 + g] = __expf(lastf(r0 + g)) * ga;
      gsv[r0 + g + 8] = __expf(lastf(r0 + g + 8)) * gb;
    }
  }
  __syncthreads();

  // phase 3 (w into G's tile, free now, for phase 4)
  load_tile<kBwdThreads>(Gs, w + x0, ld, c, D, tid);
  cp_async_commit();
  if (team == 0 && live) {
    // g_a (do S^T) + sum_{b<a} f_ab (dA_ab Kt_b), then times Eh
    const float* ga = gv + a * kE;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) drs[nt][e] *= ga[frag_col(nt, e)];
    if (a > 0) {
      float x[8][4];
      zero(x);
      mm_s<kEx, kEx>(x, ARow(Ds, r0), nullptr, BCol(Vs, 0), 0, nd, 0, 2 * a);
      const float* fa = fab + a * 4 * kE;
      regs_mm<false>(drs, x, 0, 2 * a, Kt,
                     [&](int kt, int i) { return fa[(kt >> 1) * kE + i]; });
    }
    // + the diagonal part; d cp = r (the decayed part); dr. Loads, then
    // sums, then stores: a store between two loads of shared memory keeps
    // the second behind it
    const int ra = r0 + g, rb = ra + 8;
    float dcp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      const float2 qv = a ? ld2(CS, r0 - 1, i) : make_float2(0.f, 0.f);
      const float2 ca = cp_of2(CS, ra, i), cb = cp_of2(CS, rb, i);
      const float2 da = ld2(DR, ra, i), db = ld2(DR, rb, i);
      drs[nt][0] = drs[nt][0] * dec(ca.x - qv.x) + da.x;
      drs[nt][1] = drs[nt][1] * dec(ca.y - qv.y) + da.y;
      drs[nt][2] = drs[nt][2] * dec(cb.x - qv.x) + db.x;
      drs[nt][3] = drs[nt][3] * dec(cb.y - qv.y) + db.y;
    }
    const float ba = dbeta[ra], bb = dbeta[rb];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      const float2 r_a = ld2(Rs, ra, i), r_b = ld2(Rs, rb, i);
      const float2 k_a = ld2(Ks, ra, i), k_b = ld2(Ks, rb, i);
      const float2 uu = *reinterpret_cast<const float2*>(us + i);
      dcp[nt][0] = r_a.x * drs[nt][0];
      dcp[nt][1] = r_a.y * drs[nt][1];
      dcp[nt][2] = r_b.x * drs[nt][2];
      dcp[nt][3] = r_b.y * drs[nt][3];
      drs[nt][0] += ba * uu.x * k_a.x;
      drs[nt][1] += ba * uu.y * k_a.y;
      drs[nt][2] += bb * uu.x * k_b.x;
      drs[nt][3] += bb * uu.y * k_b.y;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      *reinterpret_cast<float2*>(DR + tat(ra, i)) =
          make_float2(dcp[nt][0], dcp[nt][1]);
      *reinterpret_cast<float2*>(DR + tat(rb, i)) =
          make_float2(dcp[nt][2], dcp[nt][3]);
    }
    store_strip_out(dr + x0, ld, drs, r0, c, D);
  } else if (team == 1 && live) {
    float acc[8][4], y[8][4];
    // A^T over t >= 16 b: the pairs (a' > b, b) as (Kt_b f_a'b) Rh_a'^T,
    // the diagonal block from Ad (the two teams' halves of the channels)
    zero(acc);
    const ARow kb(Kt, r0);
    const BCol rh(Rh, 0);
#pragma unroll
    for (int a2 = 1; a2 < 4; ++a2)
      if (a2 > a && 2 * a2 < kc)
        mm_s<false, false>(acc, kb, fab + (a2 * 4 + a) * kE, rh, 0, nd,
                           2 * a2, 2 * a2 + 2);
    const float* ad0 = Ad + a * kBlkF;
    const float* ad1 = Ad + (4 + a) * kBlkF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt != 2 * a && nt != 2 * a + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = frag_row(r0, e) - r0, tt = frag_col(nt, e) - r0;
        acc[nt][e] = s < tt ? ad0[tt * kBlk + s] + ad1[tt * kBlk + s] : 0.f;
      }
    }
    // dv = A^T do + the state term + beta do
    strip_mm_regs<kEx>(st_v, acc, 2 * a, kc, Ds);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = frag_row(r0, e), j = frag_col(nt, e);
        st_v[nt][e] += beta[s] * Ds[tat(s, j)];
      }
    store_strip_out(dv + x0, ld, st_v, r0, c, D);
    // h_b (v G^T) + sum_{a'>b} f_a'b (dA_a'b^T Rh_a'), dA^T = v do^T over
    // t >= 16 b + 16, then times Ft
    const float* hb = hv + a * kE;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = st_k[nt][e] * hb[frag_col(nt, e)];
    if (2 * a + 2 < kc) {
      zero(acc);
      mm_s<kEx, kEx>(acc, ARow(Vs, r0), nullptr, BCol(Ds, 0), 0, nd,
                     2 * a + 2, kc);
      regs_mm<false>(y, acc, 2 * a + 2, kc, Rh, [&](int kt, int i) {
        return fab[((kt >> 1) * 4 + a) * kE + i];
      });
    }
    // + the diagonal part; d cs = -k (the decayed part); dk; d cs_last's
    // part sum_s k_s Ft h_b (v G^T). Loads, then sums, then stores.
    const int rf = r0 + kBlk - 1, sa = r0 + g, sb = sa + 8;
    float dcs[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      const float2 ref = ld2(CS, rf, i);
      const float2 ca = ld2(CS, sa, i), cb = ld2(CS, sb, i);
      const float2 ka = ld2(Ks, sa, i), kb = ld2(Ks, sb, i);
      const float2 da = ld2(DK, sa, i), db = ld2(DK, sb, i);
      const float2 hh = *reinterpret_cast<const float2*>(hb + i);
      const float f0 = dec(ref.x - ca.x), f1 = dec(ref.y - ca.y);
      const float f2 = dec(ref.x - cb.x), f3 = dec(ref.y - cb.y);
      float p0 = ka.x * f0 * hh.x * st_k[nt][0] + kb.x * f2 * hh.x * st_k[nt][2];
      float p1 = ka.y * f1 * hh.y * st_k[nt][1] + kb.y * f3 * hh.y * st_k[nt][3];
      y[nt][0] = y[nt][0] * f0 + da.x;
      y[nt][1] = y[nt][1] * f1 + da.y;
      y[nt][2] = y[nt][2] * f2 + db.x;
      y[nt][3] = y[nt][3] * f3 + db.y;
      dcs[nt][0] = -ka.x * y[nt][0];
      dcs[nt][1] = -ka.y * y[nt][1];
      dcs[nt][2] = -kb.x * y[nt][2];
      dcs[nt][3] = -kb.y * y[nt][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      }
      st_k[nt][0] = p0;              // lanes g = 0 hold the column sums
      st_k[nt][1] = p1;
    }
    const float ba = dbeta[sa], bb = dbeta[sb];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      const float2 r_a = ld2(Rs, sa, i), r_b = ld2(Rs, sb, i);
      const float2 uu = *reinterpret_cast<const float2*>(us + i);
      y[nt][0] += ba * uu.x * r_a.x;
      y[nt][1] += ba * uu.y * r_a.y;
      y[nt][2] += bb * uu.x * r_b.x;
      y[nt][3] += bb * uu.y * r_b.y;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i = frag_col(nt, 0);
      *reinterpret_cast<float2*>(DK + tat(sa, i)) =
          make_float2(dcs[nt][0], dcs[nt][1]);
      *reinterpret_cast<float2*>(DK + tat(sb, i)) =
          make_float2(dcs[nt][2], dcs[nt][3]);
      if (g == 0)
        *reinterpret_cast<float2*>(dlp + a * kE + i) =
            make_float2(st_k[nt][0], st_k[nt][1]);
    }
    store_strip_out(dk + x0, ld, y, r0, c, D);
  } else if (team == 1) {
    for (int i = lane; i < kE; i += 32) dlp[a * kE + i] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 4: d log w_m = d cs_last + sum_{s >= m} d cs_s + sum_{t > m} d cp_t,
  // in order; dw = d log w / w inside the clip (the log's and the clip's
  // gradient). du's partial sum_t dbeta_t r_t k_t, in order.
  if (tid < D) {
    const int i = tid;
    float run = gsv[i] + dlp[i] + dlp[kE + i] + dlp[2 * kE + i] +
                dlp[3 * kE + i];
#pragma unroll 1
    for (int blk = 3; blk >= 0; --blk) {
      if (kBlk * blk >= c) continue;
      float dcs[kBlk], dcp[kBlk], wv[kBlk];   // loaded ahead of the sums
#pragma unroll
      for (int j = 0; j < kBlk; ++j) {
        const int m = kBlk * blk + j;
        dcs[j] = DK[tat(m, i)];
        dcp[j] = DR[tat(m, i)];
        wv[j] = Gs[tat(m, i)];
      }
#pragma unroll
      for (int j = kBlk - 1; j >= 0; --j) {
        if (kBlk * blk + j >= c) continue;
        run += dcs[j];
        dcs[j] = (wv[j] >= kClip && wv[j] <= 1.f) ? __fdividef(run, wv[j])
                                                  : 0.f;
        run += dcp[j];
      }
#pragma unroll
      for (int j = 0; j < kBlk; ++j) Gs[tat(kBlk * blk + j, i)] = dcs[j];
    }
  } else if (tid >= kE && tid < kE + D) {
    const int i = tid - kE;
    float s = 0.f;
#pragma unroll 1
    for (int blk = 0; blk < 4; ++blk) {
      if (kBlk * blk >= c) break;
      float x[kBlk];
#pragma unroll
      for (int j = 0; j < kBlk; ++j) {
        const int tt = kBlk * blk + j;
        x[j] = dbeta[tt] * Rs[tat(tt, i)] * Ks[tat(tt, i)];
      }
#pragma unroll
      for (int j = 0; j < kBlk; ++j)
        if (kBlk * blk + j < c) s += x[j];
    }
    du_part[(((size_t)ch.h * B + ch.b) * ch.nc + ch.z) * D + i] = s;
  }
  __syncthreads();
  store_rows<kBwdThreads>(dw + x0, ld, Gs, c, D);   // dw, staged in w's tile
}

bool wkv_args_ok(int B, int L, int H, int D, int c, int dtype) {
  return B > 0 && L > 0 && H > 0 && D > 0 && D <= kE && c > 0 && c <= kE &&
         L % c == 0 && B <= 65535 && H <= 65535 &&
         (dtype == kF32 || dtype == kBF16);
}

constexpr size_t kStateSmem = (3 * kTileF + kE) * sizeof(float);
constexpr size_t kStateWSmem = (5 * kTileF + kE) * sizeof(float);
constexpr size_t kOutSmem =
    (4 * kTileF + 4 * kBlkF + kE + 20 * kE) * sizeof(float);
constexpr size_t kBwdSmem =
    (11 * kTileF + 16 * kBlkF + 8 * kE + 24 * kE) * sizeof(float);

template <typename T>
int launch_fwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, void* o, float* fin, float* states,
               float* decays, float* cs, int B, int L, int H, int D, int c,
               cudaStream_t st) {
  int err = allow_smem(wkv_chunk_state<T, false>, kStateSmem);
  if (err == cudaSuccess) err = allow_smem(wkv_chunk_out<T>, kOutSmem);
  if (err != cudaSuccess) return err;
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  const int nc = L / c;
  const dim3 grid(nc, H, B);
  wkv_chunk_state<T, false><<<grid, kFwdThreads, kStateSmem, st>>>(
      kt, vt, w, nullptr, nullptr, states, nullptr, decays, cs, L, H, D, c);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_carry(states, nullptr, decays, fin, B, H, nc, D * D, D, 1,
                       st);
  if (err != cudaSuccess) return err;
  wkv_chunk_out<T><<<grid, kFwdThreads, kOutSmem, st>>>(
      rt, kt, vt, cs, u, states, static_cast<T*>(o), L, H, D, c);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, const void* dout, void* dr, void* dk, void* dv,
               float* dw, float* du, float* states, float* gstates,
               float* decays, float* cs, float* du_part, int B, int L, int H,
               int D, int c, cudaStream_t st) {
  int err = allow_smem(wkv_chunk_state<T, true>, kStateWSmem);
  if (err == cudaSuccess) err = allow_smem(wkv_chunk_bwd<T>, kBwdSmem);
  if (err != cudaSuccess) return err;
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const int nc = L / c;
  const dim3 grid(nc, H, B);
  wkv_chunk_state<T, true><<<grid, 2 * kFwdThreads, kStateWSmem, st>>>(
      kt, vt, w, rt, dot, states, gstates, decays, cs, L, H, D, c);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_carry(states, gstates, decays, nullptr, B, H, nc, D * D, D,
                       2, st);
  if (err != cudaSuccess) return err;
  wkv_chunk_bwd<T><<<grid, kBwdThreads, kBwdSmem, st>>>(
      rt, kt, vt, w, cs, u, dot, states, gstates, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, B, L, H, D, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_mid<<<cdiv((long long)H * D, kScanThreads), kScanThreads, 0, st>>>(
      du_part, du, H, B * nc, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v [B,L,H,D] (dtype: 0 f32, 1 bf16), w [B,L,H,D] and u [H,D] f32,
// contiguous; writes o [B,L,H,D] in r's dtype and the final state [B,H,D,D]
// f32. Scratch: states [B,H,L/c,D,D], decays [B,H,L/c,D] and cs [B,L,H,D]
// f32. D and the chunk c at most 64, L a multiple of c.
int rwkv6_wkv_fwd_launch(const void* r, const void* k, const void* v,
                         const float* w, const float* u, void* o, float* fin,
                         float* states, float* decays, float* cs, int B,
                         int L, int H, int D, int c, int dtype,
                         void* stream) {
  if (!wkv_args_ok(B, L, H, D, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<bf16>(r, k, v, w, u, o, fin, states, decays, cs, B, L,
                            H, D, c, st);
  return launch_fwd<float>(r, k, v, w, u, o, fin, states, decays, cs, B, L,
                           H, D, c, st);
}

// The forward's inputs and do [B,L,H,D] (r's dtype); writes dr, dk, dv (r's
// dtype), dw [B,L,H,D] and du [H,D] f32, for a zero cotangent of the final
// state. Scratch: states and gstates [B,H,L/c,D,D], decays [B,H,L/c,D],
// cs [B,L,H,D], du_part [H,B,L/c,D], all f32.
int rwkv6_wkv_bwd_launch(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const void* dout,
                         void* dr, void* dk, void* dv, float* dw, float* du,
                         float* states, float* gstates, float* decays,
                         float* cs, float* du_part, int B, int L, int H,
                         int D, int c, int dtype, void* stream) {
  if (!wkv_args_ok(B, L, H, D, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<bf16>(r, k, v, w, u, dout, dr, dk, dv, dw, du, states,
                            gstates, decays, cs, du_part, B, L, H, D, c, st);
  return launch_bwd<float>(r, k, v, w, u, dout, dr, dk, dv, dw, du, states,
                           gstates, decays, cs, du_part, B, L, H, D, c, st);
}

}  // extern "C"
