// Hand-written Hopper (sm_90a) kernels of the chunked RWKV-6 WKV: the
// forward (K5) and its gradient (K5b).
//
//   K5  wkv_chunk_state, wkv_state_pass, wkv_chunk_out   replace the Pallas
//       `rwkv6_wkv` / `_kernel` (src/repro/kernels/rwkv6_scan.py) and, on
//       the training and prefill paths, the XLA `wkv6_chunked`
//       (src/repro/models/rwkv6.py)
//   K5b the same two state kernels, then wkv_chunk_dstate, wkv_state_pass
//       backwards, wkv_chunk_bwd and sum_mid: the gradient the JAX package
//       takes from XLA autodiff of `wkv6_chunked`
//
// Layout: the path's own. r, k, v, o, do, dr, dk, dv [B, L, H, D] (f32 or
// bf16); w, dw [B, L, H, D] f32 in (0, 1); u, du [H, D] f32. The sequence is
// cut into chunks of c <= 64 positions (L % c == 0). Within a chunk, per key
// channel i, cs_t = sum_{m <= t} log(clip(w_m, 1e-6, 1)) and cp_t = cs_{t-1}
// (cp_0 = 0); with S_z the [D, D] state entering chunk z,
//   o_t     = sum_{s < t} (sum_i r_t,i k_s,i exp(cp_t,i - cs_s,i)) v_s
//             + (r_t . (u k_t)) v_t + (r_t exp(cp_t)) S_z
//   S_{z+1} = exp(cs_last) S_z + sum_s (k_s exp(cs_last - cs_s)) (x) v_s,
// the decay a vector over the key channel (one row of S per channel). Every
// exponent is <= 0: cs does not increase, and each decay is a difference
// cp_t - cs_s with s < t, cs_last - cs_s, or cp_t alone. (The reference
// forms k exp(-cs) and r exp(cp) apart: exp(-cs) overflows f32 when the
// decay over a chunk passes e^88.) All arithmetic is f32.
//
// The Pallas grid (B, H, chunks) carries S in VMEM from chunk to chunk,
// sequentially per head. Here:
//   1. wkv_chunk_state (grid chunks x H x B): each chunk's own contribution
//      to the next state and its decay exp(cs_last);
//   2. wkv_state_pass (grid (D D / 256) x H x B): one thread per state
//      element walks the chunks and leaves S_z in place of chunk z's
//      contribution, and S_L in the final state;
//   3. wkv_chunk_out (grid chunks x H x B): o from the chunk's inputs and
//      S_z. The pairwise decays exp(cp_t - cs_s) differ per channel, so the
//      intra-chunk scores are no plain product: each is a sum over the
//      channels of r k exp(.), one exponential per (t, s, channel).
// The backward recomputes 1 and 2 (it keeps nothing of the forward), then
//   4. wkv_chunk_dstate: W_z = sum_t (r_t exp(cp_t)) (x) do_t per chunk;
//   5. wkv_state_pass backwards: G_z = exp(cs_last) G_{z+1} + W_z (G_L = 0:
//      the final state's cotangent is zero), leaving G_{z+1} in place of W_z;
//   6. wkv_chunk_bwd: per chunk, with A the scores of 3 and dA_ts = do_t .
//      v_s (s < t), beta_t = r_t . (u k_t), dbeta_t = do_t . v_t:
//        dv_s = sum_t A_ts do_t + beta_s do_s + G^T (k_s exp(cs_last - cs_s))
//        dr_t = sum_{s<t} dA_ts k_s exp(cp_t - cs_s) + dbeta_t u k_t
//               + exp(cp_t) (S do_t)
//        dk_s = sum_{t>s} dA_ts r_t exp(cp_t - cs_s) + dbeta_s u r_s
//               + exp(cs_last - cs_s) (G v_s)
//      The exponents' cotangents are the products of each operand with its
//      decayed terms: d cp_t = r_t (dr_t - bonus part), d cs_s = -k_s (dk_s -
//      bonus part), d cs_last = sum_s k_s (state part of dk_s) + exp(cs_last)
//      sum_j (G o S)_ij; a reverse running sum over the chunk gives d log w,
//      and dw = d log w / w inside the clip, 0 outside. du's per-chunk
//      partials (sum_t dbeta_t r_t k_t) go to scratch;
//   7. sum_mid: du summed over rows and chunks in a fixed order: the
//      gradient is deterministic (no atomics).
//
// Each per-chunk kernel is one CTA of 256 threads with its chunk's operands
// as 64 x 64 f32 tiles in shared memory (scan_common.cuh).
//
// What bounds them (rwkv6-3b: B 1, L 4096, H 40, D 64, c 64): per (row,
// head, chunk) the forward does the chunk state (c D^2 multiply-adds), the
// strictly lower scores (c^2 D / 2) and their product with v (c^2 D / 2),
// and the carried state's term (c D^2): 2c(2D^2 + cD) = 1.57 MFLOP, 4.03
// GFLOP a call, ~0.060 ms at the f32 peak, against 126 MB read and written
// (bf16 r, k, v, o; f32 w): 0.038 ms. The backward recomputes the chunk
// state, forms W_z, and does five products of c D^2 (the two state terms of
// dv and dk, dr's carried term, ...) and five of c^2 D / 2 (the scores, dA,
// dv's A^T do and the decayed sums of dr and dk): 2c(5D^2 + 5cD/2) = 3.93
// MFLOP a chunk, 10.1 GFLOP a call, ~0.150 ms at the f32 peak. Neither
// counts the exponentials (one per (t, s, channel) in each decayed sum: the
// SFU, not the FMA pipes, may well bound them).
// Not done yet: the scores on tensor cores within 16 x 16 sub-blocks (with a
// reference point between them, every decay still at most 1), cp.async, a
// shorter carry (a parallel prefix over the chunks' decays), one fused kernel.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise).

#include "scan_common.cuh"

namespace {

constexpr float kClip = 1e-6f;   // the reference's clip of w before its log

// Per-chunk view of the inputs of CTA (z, h, b).
struct WkvChunk {
  int b, h, z, l0, c, L, H, D;
  __device__ WkvChunk(int L_, int H_, int D_, int c_)
      : b(blockIdx.z), h(blockIdx.y), z(blockIdx.x), l0(blockIdx.x * c_),
        c(c_), L(L_), H(H_), D(D_) {}
  // [B, L, H, D]
  __device__ size_t xi(int t, int d) const {
    return (((size_t)b * L + l0 + t) * H + h) * D + d;
  }
  // [B, H, nc, D, D]: this chunk's state
  __device__ size_t si(int i, int j) const {
    return ((((size_t)b * H + h) * (L / c) + z) * D + i) * D + j;
  }
  // [B, H, nc, D]: this chunk's decay
  __device__ size_t gi(int i) const {
    return (((size_t)b * H + h) * (L / c) + z) * D + i;
  }
};

// CS[t][i] = sum_{m <= t} log(clip(W[m][i], 1e-6, 1)) for t < c, i < D, in
// order (so cs never increases and every cp_t - cs_s with s < t is <= 0);
// CS may be W. Ends in a barrier.
__device__ __forceinline__ void log_cumsum(const float* W, float* CS, int c,
                                           int D) {
  __syncthreads();
  if (threadIdx.x < D) {
    const int i = threadIdx.x;
    float s = 0.f;
    for (int t = 0; t < c; ++t) {
      s += logf(fminf(fmaxf(W[t * kLd + i], kClip), 1.f));
      CS[t * kLd + i] = s;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float cp_of(const float* CS, int t, int i) {
  return t > 0 ? CS[(t - 1) * kLd + i] : 0.f;
}

// acc[r][q] = sum_{i < D} R[t][i] K[s][i] exp(cp_t,i - cs_s,i) for s < t, 0
// for s >= t, at rows t = ty + 16 r and columns s = tx + 16 q (mm's layout).
// The exponent is clamped at 0, which only rows past the chunk can exceed
// (their R is 0, and exp must not make it inf * 0).
__device__ __forceinline__ void decayed_scores(float (&acc)[4][4],
                                               const float* Rs,
                                               const float* Ks,
                                               const float* CS, int D) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int i = 0; i < D; ++i) {
    float rv[4], cpv[4], kv[4], csv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      rv[r] = Rs[t * kLd + i];
      cpv[r] = cp_of(CS, t, i);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = tx + 16 * q;
      kv[q] = Ks[s * kLd + i];
      csv[q] = CS[s * kLd + i];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) {
        // blocks q < r lie wholly below the diagonal; on q == r, s < t
        // iff tx < ty
        const float e = (q < r || tx < ty)
                            ? __expf(fminf(cpv[r] - csv[q], 0.f)) : 0.f;
        acc[r][q] = fmaf(rv[r] * kv[q], e, acc[r][q]);
      }
  }
}

// ---- K5 pass 1: the chunk's own state contribution and its decay -----------

template <typename T>
__global__ void __launch_bounds__(kScanThreads) wkv_chunk_state(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ states,
    float* __restrict__ decays, int L, int H, int D, int c) {
  extern __shared__ float sm[];
  float* CS = sm;
  float* Ks = CS + kTile;        // k_s exp(cs_last - cs_s)
  float* Vs = Ks + kTile;
  const WkvChunk ch(L, H, D, c);
  fill(CS, c, D, [&](int t, int i) { return w[ch.xi(t, i)]; });
  log_cumsum(CS, CS, c, D);
  const float* last = CS + (c - 1) * kLd;
  fill(Ks, c, D, [&](int s, int i) {
    return to_float(k[ch.xi(s, i)]) * __expf(last[i] - CS[s * kLd + i]);
  });
  fill(Vs, c, D, [&](int s, int j) { return to_float(v[ch.xi(s, j)]); });
  if (threadIdx.x < D) decays[ch.gi(threadIdx.x)] = __expf(last[threadIdx.x]);
  __syncthreads();
  float acc[4][4];
  mm(acc, c, [&](int i, int s) { return Ks[s * kLd + i]; },
     [&](int s, int j) { return Vs[s * kLd + j]; });
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ty + 16 * r, j = tx + 16 * q;
      if (i < D && j < D) states[ch.si(i, j)] = acc[r][q];
    }
}

// ---- K5 pass 2 (and K5b pass 5): the carry over chunks ---------------------

// reverse == 0: S_0 = 0, S_{z+1} = g_z S_z + v_z (g_z scaling row i); v_z is
// replaced by S_z and S_nc goes to `fin`. reverse == 1: G_nc = 0, G_z = g_z
// G_{z+1} + v_z, walking z down; v_z is replaced by G_{z+1}.
__global__ void __launch_bounds__(kScanThreads) wkv_state_pass(
    float* __restrict__ v, const float* __restrict__ decays,
    float* __restrict__ fin, int nc, int H, int D, int reverse) {
  const int DD = D * D;
  const int e = blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= DD) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* g = decays + ((size_t)b * H + h) * nc * D + e / D;
  float* vb = v + ((size_t)b * H + h) * nc * DD + e;
  float s = 0.f;
  for (int t = 0; t < nc; ++t) {
    const int z = reverse ? nc - 1 - t : t;
    const float d = g[(size_t)z * D];
    const float x = vb[(size_t)z * DD];
    vb[(size_t)z * DD] = s;
    s = s * d + x;
  }
  if (!reverse) fin[((size_t)b * H + h) * DD + e] = s;
}

// ---- K5 pass 3: the outputs ------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kScanThreads) wkv_chunk_out(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ states,
    T* __restrict__ o, int L, int H, int D, int c) {
  extern __shared__ float sm[];
  float* CS = sm;
  float* Rs = CS + kTile;
  float* Ks = Rs + kTile;
  float* Vs = Ks + kTile;
  float* Ss = Vs + kTile;        // S_z, the state entering the chunk
  float* PA = Ss + kTile;        // the decayed scores, s < t
  float* beta = PA + kTile;      // [kT] r_t . (u k_t)
  const WkvChunk ch(L, H, D, c);
  fill(CS, c, D, [&](int t, int i) { return w[ch.xi(t, i)]; });
  fill(Rs, c, D, [&](int t, int i) { return to_float(r[ch.xi(t, i)]); });
  fill(Ks, c, D, [&](int t, int i) { return to_float(k[ch.xi(t, i)]); });
  fill(Vs, c, D, [&](int t, int j) { return to_float(v[ch.xi(t, j)]); });
  fill(Ss, D, D, [&](int i, int j) { return states[ch.si(i, j)]; });
  log_cumsum(CS, CS, c, D);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < kT) {
    float b = 0.f;
    for (int i = 0; i < D; ++i)
      b += Rs[tid * kLd + i] * u[ch.h * D + i] * Ks[tid * kLd + i];
    beta[tid] = b;
  }
  float acc[4][4], off[4][4];
  decayed_scores(acc, Rs, Ks, CS, D);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      PA[(ty + 16 * a) * kLd + tx + 16 * q] = acc[a][q];
  __syncthreads();
  mm(acc, c, [&](int t, int s) { return PA[t * kLd + s]; },
     [&](int s, int j) { return Vs[s * kLd + j]; });
  mm(off, D, [&](int t, int i) {
       return Rs[t * kLd + i] * __expf(cp_of(CS, t, i));
     },
     [&](int i, int j) { return Ss[i * kLd + j]; });
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = ty + 16 * a;
    if (t >= c) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + 16 * q;
      if (j < D)
        o[ch.xi(t, j)] = from_float<T>(acc[a][q] + off[a][q] +
                                       beta[t] * Vs[t * kLd + j]);
    }
  }
}

// ---- K5b pass 4: each chunk's state cotangent W_z --------------------------

template <typename T>
__global__ void __launch_bounds__(kScanThreads) wkv_chunk_dstate(
    const T* __restrict__ r, const float* __restrict__ w,
    const T* __restrict__ dout, float* __restrict__ gstates, int L, int H,
    int D, int c) {
  extern __shared__ float sm[];
  float* CS = sm;
  float* Qs = CS + kTile;        // r_t exp(cp_t)
  float* Ds = Qs + kTile;        // do_t
  const WkvChunk ch(L, H, D, c);
  fill(CS, c, D, [&](int t, int i) { return w[ch.xi(t, i)]; });
  fill(Ds, c, D, [&](int t, int j) { return to_float(dout[ch.xi(t, j)]); });
  log_cumsum(CS, CS, c, D);
  fill(Qs, c, D, [&](int t, int i) {
    return to_float(r[ch.xi(t, i)]) * __expf(cp_of(CS, t, i));
  });
  __syncthreads();
  float acc[4][4];
  mm(acc, c, [&](int i, int t) { return Qs[t * kLd + i]; },
     [&](int t, int j) { return Ds[t * kLd + j]; });
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ty + 16 * a, j = tx + 16 * q;
      if (i < D && j < D) gstates[ch.si(i, j)] = acc[a][q];
    }
}

// ---- K5b pass 6: the chunk's gradients -------------------------------------

constexpr int kBwdTiles = 10;
constexpr int kBwdVecs = 4;

template <typename T>
__global__ void __launch_bounds__(kScanThreads) wkv_chunk_bwd(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const T* __restrict__ dout,
    const float* __restrict__ states, const float* __restrict__ gstates,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part, int B, int L, int H,
    int D, int c) {
  extern __shared__ float sm[];
  float* Ws = sm;                // w
  float* CS = Ws + kTile;        // cs
  float* Rs = CS + kTile;
  float* Ks = Rs + kTile;
  float* Vs = Ks + kTile;        // v; then k_s (state part of dk_s)
  float* Ds = Vs + kTile;        // do
  float* Ss = Ds + kTile;        // S_z, the state entering the chunk
  float* Gs = Ss + kTile;        // G_{z+1}, the cotangent of the state leaving
  float* T1 = Gs + kTile;        // the scores A; then d cp
  float* T2 = T1 + kTile;        // dA (s < t); then d cs
  float* us = T2 + kTile;        // [kT] each
  float* beta = us + kT;
  float* dbeta = beta + kT;
  float* gsv = dbeta + kT;       // exp(cs_last) sum_j G_ij S_ij
  const WkvChunk ch(L, H, D, c);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < kT) us[tid] = tid < D ? u[ch.h * D + tid] : 0.f;
  fill(Ws, c, D, [&](int t, int i) { return w[ch.xi(t, i)]; });
  fill(Rs, c, D, [&](int t, int i) { return to_float(r[ch.xi(t, i)]); });
  fill(Ks, c, D, [&](int t, int i) { return to_float(k[ch.xi(t, i)]); });
  fill(Vs, c, D, [&](int t, int j) { return to_float(v[ch.xi(t, j)]); });
  fill(Ds, c, D, [&](int t, int j) { return to_float(dout[ch.xi(t, j)]); });
  fill(Ss, D, D, [&](int i, int j) { return states[ch.si(i, j)]; });
  fill(Gs, D, D, [&](int i, int j) { return gstates[ch.si(i, j)]; });
  log_cumsum(Ws, CS, c, D);
  const float* last = CS + (c - 1) * kLd;

  // the bonus's scalars and the carry's d cs_last term
  if (tid < kT) {
    float b = 0.f;
    for (int i = 0; i < D; ++i)
      b += Rs[tid * kLd + i] * us[i] * Ks[tid * kLd + i];
    beta[tid] = b;
  } else if (tid < 2 * kT) {
    const int t = tid - kT;
    float b = 0.f;
    for (int j = 0; j < D; ++j) b += Ds[t * kLd + j] * Vs[t * kLd + j];
    dbeta[t] = b;
  } else if (tid < 3 * kT) {
    const int i = tid - 2 * kT;
    float g = 0.f;
    for (int j = 0; j < D; ++j) g += Gs[i * kLd + j] * Ss[i * kLd + j];
    gsv[i] = i < D ? __expf(last[i]) * g : 0.f;
  }
  // the scores A and dA, strictly lower
  {
    float a[4][4], d[4][4];
    decayed_scores(a, Rs, Ks, CS, D);
    mm(d, D, [&](int t, int j) { return Ds[t * kLd + j]; },
       [&](int j, int s) { return Vs[s * kLd + j]; });
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = ty + 16 * p, s = tx + 16 * q;
        T1[t * kLd + s] = a[p][q];
        T2[t * kLd + s] = (s < t && t < c) ? d[p][q] : 0.f;
      }
  }
  __syncthreads();

  // du's partial, and dv_s = sum_t A_ts do_t + beta_s do_s + G^T kd_s
  if (tid < D) {
    float g = 0.f;
    for (int t = 0; t < c; ++t)
      g += dbeta[t] * Rs[t * kLd + tid] * Ks[t * kLd + tid];
    du_part[(((size_t)ch.h * B + ch.b) * (L / c) + ch.z) * D + tid] = g;
  }
  float acc[4][4], acc2[4][4];
  mm(acc, c, [&](int s, int t) { return T1[t * kLd + s]; },
     [&](int t, int j) { return Ds[t * kLd + j]; });
  mm(acc2, D, [&](int s, int i) {
       return Ks[s * kLd + i] * __expf(last[i] - CS[s * kLd + i]);
     },
     [&](int i, int j) { return Gs[i * kLd + j]; });
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int s = ty + 16 * p;
    if (s >= c) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + 16 * q;
      if (j < D)
        dv[ch.xi(s, j)] = from_float<T>(acc[p][q] + acc2[p][q] +
                                        beta[s] * Ds[s * kLd + j]);
    }
  }
  __syncthreads();               // T1 (A) is read for the last time above

  // dr_t = sum_{s<t} dA_ts k_s exp(cp_t - cs_s) + dbeta_t u k_t
  //        + exp(cp_t) (S do_t); d cp_t = r_t (dr_t - dbeta_t u k_t) -> T1
  {
    float cpv[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cpv[p][q] = cp_of(CS, ty + 16 * p, tx + 16 * q);
        acc[p][q] = 0.f;
      }
    for (int s = 0; s < c; ++s) {
      float kv[4], csv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        kv[q] = Ks[s * kLd + tx + 16 * q];
        csv[q] = CS[s * kLd + tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (s > 16 * p + 15) continue;           // no t of block p exceeds s
        const float da = T2[(ty + 16 * p) * kLd + s];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = fmaf(da * kv[q], __expf(fminf(cpv[p][q] - csv[q], 0.f)),
                           acc[p][q]);
      }
    }
    mm(acc2, D, [&](int t, int j) { return Ds[t * kLd + j]; },
       [&](int j, int i) { return Ss[i * kLd + j]; });
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int t = ty + 16 * p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tx + 16 * q;
        const float decayed = acc[p][q] + acc2[p][q] * __expf(cpv[p][q]);
        T1[t * kLd + i] = Rs[t * kLd + i] * decayed;
        if (t < c && i < D)
          dr[ch.xi(t, i)] = from_float<T>(decayed + dbeta[t] * us[i] *
                                          Ks[t * kLd + i]);
      }
    }
  }

  // dk_s = sum_{t>s} dA_ts r_t exp(cp_t - cs_s) + dbeta_s u r_s
  //        + exp(cs_last - cs_s) (G v_s); d cs_s = -k_s (dk_s - dbeta_s u r_s)
  {
    float csv[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        csv[p][q] = CS[(ty + 16 * p) * kLd + tx + 16 * q];
        acc[p][q] = 0.f;
      }
    for (int t = 1; t < c; ++t) {
      float rv[4], cpv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rv[q] = Rs[t * kLd + tx + 16 * q];
        cpv[q] = CS[(t - 1) * kLd + tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (t <= 16 * p) continue;               // no s of block p is below t
        const float da = T2[t * kLd + ty + 16 * p];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = fmaf(da * rv[q], __expf(fminf(cpv[q] - csv[p][q], 0.f)),
                           acc[p][q]);
      }
    }
    mm(acc2, D, [&](int s, int j) { return Vs[s * kLd + j]; },
       [&](int j, int i) { return Gs[i * kLd + j]; });
    float ev[4][4], kst[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int s = ty + 16 * p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tx + 16 * q;
        const float st = acc2[p][q] * __expf(last[i] - csv[p][q]);
        const float kk = Ks[s * kLd + i];
        ev[p][q] = -kk * (acc[p][q] + st);
        kst[p][q] = kk * st;
        if (s < c && i < D)
          dk[ch.xi(s, i)] = from_float<T>(acc[p][q] + st + dbeta[s] * us[i] *
                                          Rs[s * kLd + i]);
      }
    }
    __syncthreads();             // T2 (dA) and Vs are read for the last time
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = ty + 16 * p, i = tx + 16 * q;
        T2[s * kLd + i] = ev[p][q];
        Vs[s * kLd + i] = kst[p][q];
      }
  }
  __syncthreads();

  // d log w_m = d cs_last + sum_{s >= m} d cs_s + sum_{t > m} d cp_t, then
  // dw = d log w / w inside the clip (the log's and the clip's gradient)
  if (tid < D) {
    const int i = tid;
    float run = gsv[i];
    for (int s = 0; s < c; ++s) run += Vs[s * kLd + i];
    for (int m = c - 1; m >= 0; --m) {
      run += T2[m * kLd + i];
      const float wv = Ws[m * kLd + i];
      dw[ch.xi(m, i)] = (wv >= kClip && wv <= 1.f) ? run / wv : 0.f;
      run += T1[m * kLd + i];
    }
  }
}

bool wkv_args_ok(int B, int L, int H, int D, int c, int dtype) {
  return B > 0 && L > 0 && H > 0 && D > 0 && D <= kT && c > 0 && c <= kT &&
         L % c == 0 && B <= 65535 && H <= 65535 &&
         (dtype == kF32 || dtype == kBF16);
}

constexpr size_t kStateSmem = 3 * kTile * sizeof(float);
constexpr size_t kOutSmem = (6 * kTile + kT) * sizeof(float);
constexpr size_t kDstateSmem = 3 * kTile * sizeof(float);
constexpr size_t kBwdSmem =
    (kBwdTiles * kTile + kBwdVecs * kT) * sizeof(float);

template <typename T>
int launch_states(const T* k, const T* v, const float* w, float* states,
                  float* decays, float* fin, int B, int L, int H, int D,
                  int c, cudaStream_t st) {
  int err = allow_smem(wkv_chunk_state<T>, kStateSmem);
  if (err != cudaSuccess) return err;
  wkv_chunk_state<T><<<dim3(L / c, H, B), kScanThreads, kStateSmem, st>>>(
      k, v, w, states, decays, L, H, D, c);
  wkv_state_pass<<<dim3(cdiv(D * D, kScanThreads), H, B), kScanThreads, 0,
                   st>>>(states, decays, fin, L / c, H, D, 0);
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, void* o, float* fin, float* states,
               float* decays, int B, int L, int H, int D, int c,
               cudaStream_t st) {
  int err = allow_smem(wkv_chunk_out<T>, kOutSmem);
  if (err != cudaSuccess) return err;
  const T* rt = static_cast<const T*>(r);
  err = launch_states<T>(static_cast<const T*>(k), static_cast<const T*>(v),
                         w, states, decays, fin, B, L, H, D, c, st);
  if (err != cudaSuccess) return err;
  wkv_chunk_out<T><<<dim3(L / c, H, B), kScanThreads, kOutSmem, st>>>(
      rt, static_cast<const T*>(k), static_cast<const T*>(v), w, u, states,
      static_cast<T*>(o), L, H, D, c);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, const void* dout, void* dr, void* dk, void* dv,
               float* dw, float* du, float* states, float* gstates,
               float* decays, float* fin, float* du_part, int B, int L, int H,
               int D, int c, cudaStream_t st) {
  int err = allow_smem(wkv_chunk_dstate<T>, kDstateSmem);
  if (err == cudaSuccess) err = allow_smem(wkv_chunk_bwd<T>, kBwdSmem);
  if (err != cudaSuccess) return err;
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const int nc = L / c;
  const dim3 grid(nc, H, B);
  err = launch_states<T>(kt, vt, w, states, decays, fin, B, L, H, D, c, st);
  if (err != cudaSuccess) return err;
  wkv_chunk_dstate<T><<<grid, kScanThreads, kDstateSmem, st>>>(
      rt, w, dot, gstates, L, H, D, c);
  wkv_state_pass<<<dim3(cdiv(D * D, kScanThreads), H, B), kScanThreads, 0,
                   st>>>(gstates, decays, nullptr, nc, H, D, 1);
  wkv_chunk_bwd<T><<<grid, kScanThreads, kBwdSmem, st>>>(
      rt, kt, vt, w, u, dot, states, gstates, static_cast<T*>(dr),
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
// f32. Scratch: states [B,H,L/c,D,D] and decays [B,H,L/c,D] f32. D and the
// chunk c at most 64, L a multiple of c.
int rwkv6_wkv_fwd_launch(const void* r, const void* k, const void* v,
                         const float* w, const float* u, void* o, float* fin,
                         float* states, float* decays, int B, int L, int H,
                         int D, int c, int dtype, void* stream) {
  if (!wkv_args_ok(B, L, H, D, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<bf16>(r, k, v, w, u, o, fin, states, decays, B, L, H,
                            D, c, st);
  return launch_fwd<float>(r, k, v, w, u, o, fin, states, decays, B, L, H, D,
                           c, st);
}

// The forward's inputs and do [B,L,H,D] (r's dtype); writes dr, dk, dv (r's
// dtype), dw [B,L,H,D] and du [H,D] f32, for a zero cotangent of the final
// state. Scratch: states and gstates [B,H,L/c,D,D], decays [B,H,L/c,D], fin
// [B,H,D,D], du_part [H,B,L/c,D], all f32.
int rwkv6_wkv_bwd_launch(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const void* dout,
                         void* dr, void* dk, void* dv, float* dw, float* du,
                         float* states, float* gstates, float* decays,
                         float* fin, float* du_part, int B, int L, int H,
                         int D, int c, int dtype, void* stream) {
  if (!wkv_args_ok(B, L, H, D, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<bf16>(r, k, v, w, u, dout, dr, dk, dv, dw, du, states,
                            gstates, decays, fin, du_part, B, L, H, D, c, st);
  return launch_bwd<float>(r, k, v, w, u, dout, dr, dk, dv, dw, du, states,
                           gstates, decays, fin, du_part, B, L, H, D, c, st);
}

}  // extern "C"
