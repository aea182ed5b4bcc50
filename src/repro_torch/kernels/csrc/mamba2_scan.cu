// Hand-written Hopper (sm_90a) kernels of the chunked Mamba2 SSD scan: the
// forward (K4) and its gradient (K4b).
//
//   K4  ssd_chunk_state, ssd_state_pass, ssd_chunk_out   replace the Pallas
//       `mamba2_ssd` / `_kernel` (src/repro/kernels/mamba2_scan.py) and, on
//       the training and prefill paths, the XLA `ssd_chunked`
//       (src/repro/models/mamba2.py)
//   K4b the same two state kernels, then ssd_chunk_dstate, ssd_dstate_pass,
//       ssd_chunk_bwd and sum_mid: the gradient the JAX package takes from
//       XLA autodiff of `ssd_chunked`
//
// Layout: the path's own. x, y, dy, dx [B, L, H, P] (f32 or bf16); dt, ddt
// [B, L, H] f32; A, dA [H] f32; Bm, Cm, dBm, dCm [B, L, N] f32, shared by
// the H heads (ngroups = 1). The sequence is cut into chunks of c <= 64
// positions (L % c == 0). Within a chunk cs_i = sum_{k <= i} dt_k A, u_j =
// dt_j x_j, and
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) u_j + exp(cs_i) C_i S_z
//   S_{z+1} = exp(cs_last) S_z + sum_j exp(cs_last - cs_j) B_j (x) u_j
// with S_0 = 0 and S_z the [N, P] state entering chunk z. All arithmetic is
// f32. The decay exp(cs_i - cs_j) is formed only for j <= i: the exponent of
// the others is positive and may overflow, and inf * 0 is NaN.
//
// The Pallas grid (B, H, chunks) carries S in VMEM from one chunk to the
// next, sequentially per head: 80 programs at zamba2's shape. Here:
//   1. ssd_chunk_state (grid chunks x H x B): each chunk's cs (kept for the
//      later passes) and its own contribution to the next state;
//   2. ssd_state_pass (grid (N P / 256) x H x B): one thread per state
//      element walks the chunks and leaves S_z in place of chunk z's
//      contribution, and S_L in the final state;
//   3. ssd_chunk_out (grid chunks x H x B): y from the chunk's inputs and
//      S_z.
// The backward recomputes 1 and 2 (it keeps nothing of the forward), then
//   4. ssd_chunk_dstate: W_z = sum_i exp(cs_i) C_i (x) dy_i per chunk;
//   5. ssd_dstate_pass: the state cotangent backwards over the chunks,
//      G_z = exp(cs_last) G_{z+1} + W_z (G_L = 0: the final state's
//      cotangent is zero), leaving G_{z+1} in place of W_z;
//   6. ssd_chunk_bwd: per chunk, dx and ddt, and per-head partials of dBm,
//      dCm and of dA (one per chunk). The d(u) term is the scan backwards in
//      time with B and C in each other's roles; d cs collects the intra-chunk
//      decay's row and column sums, the carried state's and the chunk
//      state's terms, and its reverse running sum gives d(dt A);
//   7. sum_mid: dBm and dCm summed over the heads, dA over rows and chunks,
//      in a fixed order: the gradient is deterministic (no atomics).
//
// Each per-chunk kernel is one CTA of 256 threads with its chunk's operands
// as 64 x 64 f32 tiles in shared memory (rows past c and columns past N or P
// zero), each thread accumulating a 4 x 4 block of a 64 x 64 product on the
// CUDA cores (f32 products, as in the reference).
//
// What bounds them (zamba2: B 1, L 4096, H 80, P 64, N 64, c 64): per
// (row, head, chunk) the forward does 2c(cN + cP + 2NP) = 2.10 MFLOP, 10.7
// GFLOP a call, for about 89 MB read and written: operations, ~0.16 ms at
// the f32 peak. The backward recomputes the chunk states (c N P
// multiply-adds a chunk), forms W_z (c N P) and does eight products in
// ssd_chunk_bwd (3 c^2 N + 2 c^2 P + 3 c N P): 2c(5NP + 3cN + 2cP) = 5.24
// MFLOP a chunk, 26.8 GFLOP a call, ~0.40 ms at the f32 peak.
// Not done yet: tensor cores (tf32 or bf16 operands), cp.async, wgmma, one
// fused kernel per pass.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise).

#include "mma_common.cuh"

namespace {

constexpr int kT = 64;           // tile edge: chunk, N and P padded to it
constexpr int kLd = kT + 1;      // shared row stride (floats): no conflicts
constexpr int kTile = kT * kLd;  // floats per tile
constexpr int kSsdThreads = 256;

using bf16 = __nv_bfloat16;

// acc[r][s] = sum_{k < K} a(i_r, k) * b(k, j_s) for rows i_r = ty + 16 r and
// columns j_s = tx + 16 s of a 64 x 64 product (ty, tx = thread / 16, % 16).
template <typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], int K, FA a, FB b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a(ty + 16 * r, k);
#pragma unroll
    for (int s = 0; s < 4; ++s) bv[s] = b(k, tx + 16 * s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
  }
}

// The sum of v over the 16 threads that share a row of mm's layout (one
// half-warp), in every one of them.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[i][j] = f(i, j) for i < rows and j < cols, 0 elsewhere in the tile.
template <typename F>
__device__ __forceinline__ void fill(float* dst, int rows, int cols, F f) {
  for (int e = threadIdx.x; e < kT * kT; e += kSsdThreads) {
    const int i = e / kT, j = e % kT;
    dst[i * kLd + j] = (i < rows && j < cols) ? f(i, j) : 0.f;
  }
}

// Per-chunk view of the inputs of CTA (z, h, b).
struct Chunk {
  int b, h, z, l0, c, L, H, P, N;
  __device__ Chunk(int L_, int H_, int P_, int N_, int c_)
      : b(blockIdx.z), h(blockIdx.y), z(blockIdx.x), l0(blockIdx.x * c_),
        c(c_), L(L_), H(H_), P(P_), N(N_) {}
  // [B, L, H, P]
  __device__ size_t xi(int i, int p) const {
    return (((size_t)b * L + l0 + i) * H + h) * P + p;
  }
  // [B, L, H]
  __device__ size_t ti(int i) const {
    return ((size_t)b * L + l0 + i) * H + h;
  }
  // [B, L, N]
  __device__ size_t bi(int i, int n) const {
    return ((size_t)b * L + l0 + i) * N + n;
  }
  // [B, H, nc, N, P]: this chunk's state
  __device__ size_t si(int n, int p) const {
    return ((((size_t)b * H + h) * (L / c) + z) * N + n) * P + p;
  }
  // [B, H, L]
  __device__ size_t ci(int i) const { return ((size_t)b * H + h) * L + l0 + i; }
};

// ---- K4 pass 1: cs and the chunk's own state contribution -------------------

template <typename TX>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_state(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ cs_out, int L, int H,
    int P, int N, int c) {
  extern __shared__ float sm[];
  float* Bs = sm;
  float* Us = Bs + kTile;
  float* cs = Us + kTile;       // [kT]
  float* dts = cs + kT;         // [kT]
  const Chunk ch(L, H, P, N, c);
  if (threadIdx.x < c) dts[threadIdx.x] = dt[ch.ti(threadIdx.x)];
  __syncthreads();
  if (threadIdx.x == 0) {
    const float a = A[ch.h];
    float s = 0.f;
    for (int i = 0; i < c; ++i) {
      s += dts[i] * a;
      cs[i] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < c) cs_out[ch.ci(threadIdx.x)] = cs[threadIdx.x];
  const float last = cs[c - 1];
  fill(Bs, c, N, [&](int i, int n) { return Bm[ch.bi(i, n)]; });
  fill(Us, c, P, [&](int j, int p) {
    return expf(last - cs[j]) * dts[j] * to_float(x[ch.xi(j, p)]);
  });
  __syncthreads();
  float acc[4][4];
  mm(acc, c, [&](int n, int j) { return Bs[j * kLd + n]; },
     [&](int j, int p) { return Us[j * kLd + p]; });
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = ty + 16 * r, p = tx + 16 * s;
      if (n < N && p < P) states[ch.si(n, p)] = acc[r][s];
    }
}

// ---- K4 pass 2 (and K4b pass 5): the carry over chunks ----------------------

// reverse == 0: S_0 = 0, S_{z+1} = exp(cs_last_z) S_z + v_z; v_z is replaced
// by S_z and S_nc goes to `fin`. reverse == 1: G_nc = 0, G_z = exp(cs_last_z)
// G_{z+1} + v_z, walking z down; v_z is replaced by G_{z+1}.
__global__ void __launch_bounds__(kSsdThreads) ssd_state_pass(
    float* __restrict__ v, const float* __restrict__ cs,
    float* __restrict__ fin, int L, int H, int NP, int c, int reverse) {
  const int e = blockIdx.x * kSsdThreads + threadIdx.x;
  if (e >= NP) return;
  const int h = blockIdx.y, b = blockIdx.z, nc = L / c;
  const float* csb = cs + ((size_t)b * H + h) * L;
  float* vb = v + ((size_t)b * H + h) * nc * NP + e;
  float s = 0.f;
  for (int t = 0; t < nc; ++t) {
    const int z = reverse ? nc - 1 - t : t;
    const float d = expf(csb[z * c + c - 1]);
    const float w = vb[(size_t)z * NP];
    vb[(size_t)z * NP] = s;
    s = s * d + w;
  }
  if (!reverse) fin[((size_t)b * H + h) * NP + e] = s;
}

// ---- K4 pass 3: the outputs -------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_out(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ states, const float* __restrict__ cs_in,
    TX* __restrict__ y, int L, int H, int P, int N, int c) {
  extern __shared__ float sm[];
  float* Cs = sm;
  float* Bs = Cs + kTile;
  float* Us = Bs + kTile;
  float* Ss = Us + kTile;
  float* Ps = Ss + kTile;
  float* cs = Ps + kTile;       // [kT]
  const Chunk ch(L, H, P, N, c);
  if (threadIdx.x < c) cs[threadIdx.x] = cs_in[ch.ci(threadIdx.x)];
  fill(Cs, c, N, [&](int i, int n) { return Cm[ch.bi(i, n)]; });
  fill(Bs, c, N, [&](int i, int n) { return Bm[ch.bi(i, n)]; });
  fill(Us, c, P, [&](int j, int p) {
    return dt[ch.ti(j)] * to_float(x[ch.xi(j, p)]);
  });
  fill(Ss, N, P, [&](int n, int p) { return states[ch.si(n, p)]; });
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
  // scores C B^T, times the decay where j <= i
  mm(acc, N, [&](int i, int n) { return Cs[i * kLd + n]; },
     [&](int n, int j) { return Bs[j * kLd + n]; });
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = ty + 16 * r, j = tx + 16 * s;
      Ps[i * kLd + j] =
          (j <= i && i < c) ? acc[r][s] * expf(cs[i] - cs[j]) : 0.f;
    }
  __syncthreads();
  float off[4][4];
  mm(acc, c, [&](int i, int j) { return Ps[i * kLd + j]; },
     [&](int j, int p) { return Us[j * kLd + p]; });
  mm(off, N, [&](int i, int n) { return Cs[i * kLd + n]; },
     [&](int n, int p) { return Ss[n * kLd + p]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= c) continue;
    const float e = expf(cs[i]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tx + 16 * s;
      if (p < P) y[ch.xi(i, p)] = from_float<TX>(acc[r][s] + e * off[r][s]);
    }
  }
}

// ---- K4b pass 4: each chunk's state cotangent W_z ---------------------------

template <typename TX>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_dstate(
    const float* __restrict__ Cm, const TX* __restrict__ dy,
    const float* __restrict__ cs_in, float* __restrict__ gstates, int L,
    int H, int P, int N, int c) {
  extern __shared__ float sm[];
  float* Cs = sm;
  float* Ds = Cs + kTile;
  const Chunk ch(L, H, P, N, c);
  fill(Cs, c, N, [&](int i, int n) {
    return expf(cs_in[ch.ci(i)]) * Cm[ch.bi(i, n)];
  });
  fill(Ds, c, P, [&](int i, int p) { return to_float(dy[ch.xi(i, p)]); });
  __syncthreads();
  float acc[4][4];
  mm(acc, c, [&](int n, int i) { return Cs[i * kLd + n]; },
     [&](int i, int p) { return Ds[i * kLd + p]; });
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = ty + 16 * r, p = tx + 16 * s;
      if (n < N && p < P) gstates[ch.si(n, p)] = acc[r][s];
    }
}

// ---- K4b pass 6: the chunk's gradients --------------------------------------

constexpr int kBwdTiles = 9;
constexpr int kBwdVecs = 8;

template <typename TX>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_bwd(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const TX* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gstates,
    const float* __restrict__ cs_in, TX* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dA_part, int B, int L,
    int H, int P, int N, int c) {
  extern __shared__ float sm[];
  float* Cs = sm;               // C_i
  float* Bs = Cs + kTile;       // B_j
  float* Us = Bs + kTile;       // u_j = dt_j x_j
  float* Ds = Us + kTile;       // dy_i
  float* Ss = Ds + kTile;       // S_z, the state entering the chunk
  float* Gs = Ss + kTile;       // G_{z+1}, the cotangent of the state leaving
  float* P1 = Gs + kTile;       // (C_i . B_j) exp(cs_i - cs_j), j <= i
  float* P2 = P1 + kTile;       // exp(cs_i - cs_j) (dy_i . u_j), j <= i
  float* Ts = P2 + kTile;       // P1 (dy_i . u_j)
  float* cs = Ts + kTile;       // [kT] each
  float* dts = cs + kT;
  float* rowT = dts + kT;
  float* colT = rowT + kT;
  float* Ov = colT + kT;        // d cs_i through the carried state's output
  float* Qv = Ov + kT;          // d cs_j through the chunk's own state
  float* ddtv = Qv + kT;        // ddt_j through u_j
  float* red = ddtv + kT;       // [kSsdThreads / 32]
  const Chunk ch(L, H, P, N, c);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < kT) {
    cs[tid] = tid < c ? cs_in[ch.ci(tid)] : 0.f;
    dts[tid] = tid < c ? dt[ch.ti(tid)] : 0.f;
  }
  fill(Cs, c, N, [&](int i, int n) { return Cm[ch.bi(i, n)]; });
  fill(Bs, c, N, [&](int i, int n) { return Bm[ch.bi(i, n)]; });
  fill(Us, c, P, [&](int j, int p) {
    return dt[ch.ti(j)] * to_float(x[ch.xi(j, p)]);
  });
  fill(Ds, c, P, [&](int i, int p) { return to_float(dy[ch.xi(i, p)]); });
  fill(Ss, N, P, [&](int n, int p) { return states[ch.si(n, p)]; });
  fill(Gs, N, P, [&](int n, int p) { return gstates[ch.si(n, p)]; });
  __syncthreads();
  const float last = cs[c - 1];

  // the intra-chunk matrices
  {
    float m[4][4], d[4][4];
    mm(m, N, [&](int i, int n) { return Cs[i * kLd + n]; },
       [&](int n, int j) { return Bs[j * kLd + n]; });
    mm(d, P, [&](int i, int p) { return Ds[i * kLd + p]; },
       [&](int p, int j) { return Us[j * kLd + p]; });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = ty + 16 * r, j = tx + 16 * s;
        const float lm = (j <= i && i < c) ? expf(cs[i] - cs[j]) : 0.f;
        P1[i * kLd + j] = m[r][s] * lm;
        P2[i * kLd + j] = lm * d[r][s];
        Ts[i * kLd + j] = m[r][s] * lm * d[r][s];
      }
  }
  // the total over all ([N, P]) of G_{z+1} * S_z, for d cs_last
  float gs = 0.f;
  for (int e = tid; e < kT * kT; e += kSsdThreads) {
    const int n = e / kT, p = e % kT;
    gs += Gs[n * kLd + p] * Ss[n * kLd + p];
  }
  gs = warp_sum(gs);
  if ((tid & 31) == 0) red[tid >> 5] = gs;
  __syncthreads();
  if (tid < kT) {
    float a = 0.f;
    for (int j = 0; j < kT; ++j) a += Ts[tid * kLd + j];
    rowT[tid] = a;
  } else if (tid < 2 * kT) {
    const int j = tid - kT;
    float a = 0.f;
    for (int i = 0; i < kT; ++i) a += Ts[i * kLd + j];
    colT[j] = a;
  }

  float acc[4][4], acc2[4][4];
  // du_j = sum_i P1_ij dy_i + exp(cs_last - cs_j) G^T B_j; dx_j = dt_j du_j,
  // ddt_j through u_j = x_j . du_j
  mm(acc, c, [&](int j, int i) { return P1[i * kLd + j]; },
     [&](int i, int p) { return Ds[i * kLd + p]; });
  mm(acc2, N, [&](int j, int n) { return Bs[j * kLd + n]; },
     [&](int n, int p) { return Gs[n * kLd + p]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    const float w = j < c ? expf(last - cs[j]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = tx + 16 * s;
      if (j < c && p < P) {
        const float du = acc[r][s] + w * acc2[r][s];
        dx[ch.xi(j, p)] = from_float<TX>(dts[j] * du);
        part += to_float(x[ch.xi(j, p)]) * du;
      }
    }
    part = row_sum16(part);
    if (tx == 0) ddtv[j] = part;
  }
  // dC_i = sum_j P2_ij B_j + exp(cs_i) S dy_i; O_i = exp(cs_i) C_i . S dy_i
  mm(acc, c, [&](int i, int j) { return P2[i * kLd + j]; },
     [&](int j, int n) { return Bs[j * kLd + n]; });
  mm(acc2, P, [&](int i, int p) { return Ds[i * kLd + p]; },
     [&](int p, int n) { return Ss[n * kLd + p]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float e = i < c ? expf(cs[i]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = tx + 16 * s;
      if (i < c && n < N) {
        dC_part[(((size_t)ch.b * H + ch.h) * L + ch.l0 + i) * N + n] =
            acc[r][s] + e * acc2[r][s];
        part += Cs[i * kLd + n] * acc2[r][s];
      }
    }
    part = row_sum16(part);
    if (tx == 0) Ov[i] = e * part;
  }
  // dB_j = sum_i P2_ij C_i + exp(cs_last - cs_j) G u_j;
  // Q_j = exp(cs_last - cs_j) B_j . G u_j
  mm(acc, c, [&](int j, int i) { return P2[i * kLd + j]; },
     [&](int i, int n) { return Cs[i * kLd + n]; });
  mm(acc2, P, [&](int j, int p) { return Us[j * kLd + p]; },
     [&](int p, int n) { return Gs[n * kLd + p]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    const float w = j < c ? expf(last - cs[j]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = tx + 16 * s;
      if (j < c && n < N) {
        dB_part[(((size_t)ch.b * H + ch.h) * L + ch.l0 + j) * N + n] =
            acc[r][s] + w * acc2[r][s];
        part += Bs[j * kLd + n] * acc2[r][s];
      }
    }
    part = row_sum16(part);
    if (tx == 0) Qv[j] = w * part;
  }
  __syncthreads();
  // d cs, its reverse running sum d(dt A), then ddt and this chunk's dA
  if (tid == 0) {
    float dlast = expf(last) * [&] {
      float t = 0.f;
      for (int w = 0; w < kSsdThreads / 32; ++w) t += red[w];
      return t;
    }();
    for (int j = 0; j < c; ++j) dlast += Qv[j];
    const float a = A[ch.h];
    float da = 0.f, dA = 0.f;
    for (int k = c - 1; k >= 0; --k) {
      da += rowT[k] - colT[k] + Ov[k] - Qv[k] + (k == c - 1 ? dlast : 0.f);
      ddt[ch.ti(k)] = ddtv[k] + a * da;
      dA += dts[k] * da;
    }
    dA_part[((size_t)ch.h * B + ch.b) * (L / c) + ch.z] = dA;
  }
}

// ---- K4b pass 7: out[o][i] = sum_m in[o][m][i], m in order ------------------

__global__ void __launch_bounds__(kSsdThreads) sum_mid(
    const float* __restrict__ in, float* __restrict__ out, long long outer,
    int mid, long long inner) {
  const long long t = (long long)blockIdx.x * kSsdThreads + threadIdx.x;
  if (t >= outer * inner) return;
  const long long o = t / inner, i = t % inner;
  const float* p = in + o * mid * inner + i;
  float s = 0.f;
  for (int m = 0; m < mid; ++m) s += p[(long long)m * inner];
  out[t] = s;
}

bool ssd_args_ok(int B, int L, int H, int P, int N, int c, int dtype) {
  return B > 0 && L > 0 && H > 0 && P > 0 && P <= kT && N > 0 && N <= kT &&
         c > 0 && c <= kT && L % c == 0 && B <= 65535 && H <= 65535 &&
         (dtype == kF32 || dtype == kBF16);
}

int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

constexpr size_t kStateSmem = (2 * kTile + 2 * kT) * sizeof(float);
constexpr size_t kOutSmem = (5 * kTile + kT) * sizeof(float);
constexpr size_t kDstateSmem = 2 * kTile * sizeof(float);
constexpr size_t kBwdSmem =
    (kBwdTiles * kTile + kBwdVecs * kT) * sizeof(float);

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename TX>
int launch_states(const TX* x, const float* dt, const float* A,
                  const float* Bm, float* states, float* fin, float* cs,
                  int B, int L, int H, int P, int N, int c, cudaStream_t st) {
  const dim3 grid(L / c, H, B);
  ssd_chunk_state<TX><<<grid, kSsdThreads, kStateSmem, st>>>(
      x, dt, A, Bm, states, cs, L, H, P, N, c);
  ssd_state_pass<<<dim3(cdiv(N * P, kSsdThreads), H, B), kSsdThreads, 0,
                   st>>>(states, cs, fin, L, H, N * P, c, 0);
  return cudaGetLastError();
}

template <typename TX>
int launch_fwd(const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, void* y, float* fin,
               float* states, float* cs, int B, int L, int H, int P, int N,
               int c, cudaStream_t st) {
  int err = allow_smem(ssd_chunk_out<TX>, kOutSmem);
  if (err != cudaSuccess) return err;
  const TX* xt = static_cast<const TX*>(x);
  err = launch_states<TX>(xt, dt, A, Bm, states, fin, cs, B, L, H, P, N, c,
                          st);
  if (err != cudaSuccess) return err;
  ssd_chunk_out<TX><<<dim3(L / c, H, B), kSsdThreads, kOutSmem, st>>>(
      xt, dt, Bm, Cm, states, cs, static_cast<TX*>(y), L, H, P, N, c);
  return cudaGetLastError();
}

template <typename TX>
int launch_bwd(const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, const void* dy, void* dx,
               float* ddt, float* dA, float* dBm, float* dCm, float* states,
               float* gstates, float* fin, float* cs, float* dB_part,
               float* dC_part, float* dA_part, int B, int L, int H, int P,
               int N, int c, cudaStream_t st) {
  int err = allow_smem(ssd_chunk_bwd<TX>, kBwdSmem);
  if (err != cudaSuccess) return err;
  const TX* xt = static_cast<const TX*>(x);
  const TX* dyt = static_cast<const TX*>(dy);
  const int nc = L / c;
  const dim3 grid(nc, H, B);
  err = launch_states<TX>(xt, dt, A, Bm, states, fin, cs, B, L, H, P, N, c,
                          st);
  if (err != cudaSuccess) return err;
  ssd_chunk_dstate<TX><<<grid, kSsdThreads, kDstateSmem, st>>>(
      Cm, dyt, cs, gstates, L, H, P, N, c);
  ssd_state_pass<<<dim3(cdiv(N * P, kSsdThreads), H, B), kSsdThreads, 0,
                   st>>>(gstates, cs, nullptr, L, H, N * P, c, 1);
  ssd_chunk_bwd<TX><<<grid, kSsdThreads, kBwdSmem, st>>>(
      xt, dt, A, Bm, Cm, dyt, states, gstates, cs, static_cast<TX*>(dx), ddt,
      dB_part, dC_part, dA_part, B, L, H, P, N, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long ln = (long long)L * N;
  sum_mid<<<cdiv(B * ln, kSsdThreads), kSsdThreads, 0, st>>>(dB_part, dBm, B,
                                                             H, ln);
  sum_mid<<<cdiv(B * ln, kSsdThreads), kSsdThreads, 0, st>>>(dC_part, dCm, B,
                                                             H, ln);
  sum_mid<<<cdiv(H, kSsdThreads), kSsdThreads, 0, st>>>(dA_part, dA, H,
                                                        B * nc, 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,L,H,P] (dtype: 0 f32, 1 bf16), dt [B,L,H], A [H], Bm, Cm [B,L,N]
// f32, contiguous; writes y [B,L,H,P] in x's dtype and the final state
// [B,H,N,P] f32. Scratch: states [B,H,L/c,N,P] and cs [B,H,L] f32. P, N and
// the chunk c at most 64, L a multiple of c.
int mamba2_ssd_fwd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, void* y,
                          float* fin, float* states, float* cs, int B, int L,
                          int H, int P, int N, int c, int dtype,
                          void* stream) {
  if (!ssd_args_ok(B, L, H, P, N, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<bf16>(x, dt, A, Bm, Cm, y, fin, states, cs, B, L, H, P,
                            N, c, st);
  return launch_fwd<float>(x, dt, A, Bm, Cm, y, fin, states, cs, B, L, H, P,
                           N, c, st);
}

// The forward's inputs and dy [B,L,H,P] (x's dtype); writes dx (x's dtype),
// ddt [B,L,H], dA [H], dBm and dCm [B,L,N] f32, for a zero cotangent of the
// final state. Scratch: states and gstates [B,H,L/c,N,P], fin [B,H,N,P], cs
// [B,H,L], dB_part and dC_part [B,H,L,N], dA_part [H,B,L/c], all f32.
int mamba2_ssd_bwd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, const void* dy,
                          void* dx, float* ddt, float* dA, float* dBm,
                          float* dCm, float* states, float* gstates,
                          float* fin, float* cs, float* dB_part,
                          float* dC_part, float* dA_part, int B, int L, int H,
                          int P, int N, int c, int dtype, void* stream) {
  if (!ssd_args_ok(B, L, H, P, N, c, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<bf16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                            states, gstates, fin, cs, dB_part, dC_part,
                            dA_part, B, L, H, P, N, c, st);
  return launch_bwd<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                           states, gstates, fin, cs, dB_part, dC_part,
                           dA_part, B, L, H, P, N, c, st);
}

}  // extern "C"
