// Hand-written Hopper (sm_90a) kernels of the chunked Mamba2 SSD scan: the
// forward (K4) and its gradient (K4b).
//
//   K4  ssd_chunk_state, chunk_carry, ssd_chunk_out   replace the Pallas
//       `mamba2_ssd` / `_kernel` (src/repro/kernels/mamba2_scan.py) and, on
//       the training and prefill paths, the XLA `ssd_chunked`
//       (src/repro/models/mamba2.py)
//   K4b ssd_chunk_state<with W>, chunk_carry (both directions), ssd_chunk_bwd
//       and sum_mid: the gradient the JAX package takes from XLA autodiff
//       of `ssd_chunked`
//
// Layout: the path's own. x, y, dy, dx [B, L, H, P] (f32 or bf16); dt, ddt
// [B, L, H] f32; A, dA [H] f32; Bm, Cm, dBm, dCm [B, L, N] f32, shared by
// the H heads (ngroups = 1). The sequence is cut into chunks of c <= 64
// positions (L % c == 0). Within a chunk cs_i = sum_{k <= i} dt_k A, u_j =
// dt_j x_j, and
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) u_j + exp(cs_i) C_i S_z
//   S_{z+1} = exp(cs_last) S_z + sum_j exp(cs_last - cs_j) B_j (x) u_j
// with S_0 = 0 and S_z the [N, P] state entering chunk z. The decay
// exp(cs_i - cs_j) is formed only for j <= i: the exponent of the others is
// positive and may overflow, and inf * 0 is NaN.
//
// The Pallas grid (B, H, chunks) carries S in VMEM from one chunk to the
// next, sequentially per head. Here:
//   1. ssd_chunk_state (grid chunks x head groups x B): each chunk's own
//      contribution to the next state, and exp(cs_last) per (head, chunk);
//   2. chunk_carry (scan_common.cuh, shared with K5): the carry over
//      chunks, one thread per four state elements, leaving S_z in place of
//      chunk z's contribution and S_L in the final state;
//   3. ssd_chunk_out: y from the chunk's inputs and S_z.
// The backward recomputes 1 and 2 (it keeps nothing of the forward): its
// ssd_chunk_state also forms each chunk's state cotangent W_z = sum_i
// exp(cs_i) C_i (x) dy_i, and one chunk_carry launch runs S forwards and the
// cotangent backwards (G_z = exp(cs_last) G_{z+1} + W_z, G_L = 0, leaving
// G_{z+1} in place of W_z). Then
//   4. ssd_chunk_bwd: per chunk, dx and ddt, the head group's sums of dBm
//      and dCm, and dA per (head, chunk). The d(u) term is the scan
//      backwards in time with B and C in each other's roles; d cs collects
//      the intra-chunk decay's row and column sums, the carried state's and
//      the chunk state's terms, and its reverse running sum gives d(dt A);
//   5. sum_mid: dBm and dCm summed over the head groups, dA over rows and
//      chunks, in a fixed order: the gradient is deterministic (no atomics).
//
// Design (tf32_tiles.cuh has the tile layout and the products):
// - Every product runs on the tensor cores (mma.sync m16n8k8, tf32 inputs,
//   f32 accumulation) in split TF32: a_hi b_hi + a_hi b_lo + a_lo b_hi. A
//   bf16 x or dy is exact in tf32, so a product with one takes two mma and
//   a product of both (D = dy x^T) one; every scale (dt, the decays) goes
//   on the other operand or on the product's rows to keep them exact. The
//   chunk's scores C B^T split each operand in three parts (six products),
//   each depth step of 8 summed apart and the steps in f64: a score that
//   cancels scales a whole row of y and of dx, and there the tensor core's
//   own f32 sums (which drop the bits below their largest addend) showed
//   against the f32 rule. One tf32 product per product fails that rule
//   (tests/test_torch_mamba2.py emulates both).
// - A CTA of 256 threads takes one chunk for a group of G heads (kernels/
//   mamba2_scan.py plan(): 8 at zamba2's training shape). Its two teams of
//   four warps take the group's heads in turns (team t heads t, t + 2,
//   ...), each behind its own named barrier, so that one team's loads
//   overlap the other's products. Each warp owns 16 rows of the chunk.
// - The chunk's Bm and Cm tiles are loaded once per CTA, and M = C B^T
//   (the same for every head, ngroups = 1) is formed once into shared
//   memory; each head applies its decay mask to it.
// - Products chain through registers where the next product reads the
//   strip by rows (P1 U in the forward, P2 B in the backward), and the
//   backward forms both D = dy U^T by rows (i) and D^T by rows (j), so that
//   the transposed products (P1^T dy, P2^T C) also take their A operand
//   from registers: no intra-chunk matrix goes through shared memory, and
//   the decay's row and column sums (rowT, colT) come out of the products'
//   epilogues. Those products skip the tiles above the causal diagonal
//   (each warp has as many tiles in its two roles).
// - The backward sums the group's dBm and dCm in registers over its heads
//   (fixed order; the two teams' sums added in shared memory), writing one
//   partial per head group: [B, H / G, L, N], 21 MB at zamba2's shape where
//   the per-head partials were [B, H, L, N], 168 MB.
// - cs and the reverse running sum of d cs are summed in order by one lane,
//   each step rounded to f32 as the plain version's torch.cumsum rounds it
//   (head_vectors says why a warp scan was not kept); the team's other
//   warps issue the head's loads meanwhile. ddt is stored by the lanes that
//   own its positions, and nothing else runs in one thread.
// - The products that make y and dx sum each depth step in a fresh
//   accumulator (tf32_tiles.cuh, mma3): in place, the tensor core's
//   truncating sums drifted those bf16 outputs' roundings away from the
//   plain version's enough to take a bf16 train step's gradients (smoke
//   phase 9b) to the edge of their rule.
// - Loads are 16-byte pieces: cp.async for f32 tiles, 16-byte loads
//   converted in registers for bf16, all issued before the team waits.
// - chunk_carry issues the next eight chunks' loads before this eight's
//   stores, and the backward's runs both directions in one launch.
//
// What bounds them (zamba2: B 1, L 4096, H 80, P 64, N 64, c 64; the
// count is chip_smoke.py's ssd_work): the scores C B^T, 2c^2 N a chunk,
// serve every head; each (head, chunk) adds 2c(cP + 2NP) in the forward
// and 2c(2cN + 2cP + 5NP) in the backward. As f32 products that is 8.1
// and 24.2 GFLOP a call: ~0.12 and ~0.36 ms at the f32 CUDA-core peak
// (67 TFLOP/s). In split TF32 a product of two f32 operands is three tf32
// products, one on a bf16 x or dy two, and D = dy x^T in bf16 one: 18.9
// and 53.8 GFLOP for bf16 x, ~0.038 and ~0.109 ms at the TF32 peak (495),
// and 24.3 and 72.6 for f32 x (~0.049, ~0.147), against about 89 and 175
// MB read and written (~0.026, ~0.052 ms): operations. mma.sync reaches
// about two thirds of the TF32 peak on an H100 (experiments/
// torch_mma_rate.py), and these kernels also form D twice and the scores
// once per head group, in a three-part split. What holds them back
// (PERF.md): ssd_chunk_bwd runs one CTA of 8 warps per SM (181 KB of
// shared memory, ~250 registers a thread), too few to hide the latency of
// each warp's chains of loads, splits and mma; the carried states' round
// trips through HBM (chunk_carry) are at the memory's rate.
// Not done yet: wgmma (its tf32 operands must be K-major, and half of these
// products read a tile the other way), a fused carry (chunk z's CTA waiting
// on chunk z - 1's state), TMA, prefetching a team's next head.
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry points below: raw device pointers,
// PyTorch's current stream, return cudaGetLastError(), allocate nothing,
// never synchronise).

#include "scan_common.cuh"
#include "tf32_tiles.cuh"

#include <type_traits>

namespace {

constexpr int kSsdThreads = 256;   // two teams of four warps
constexpr int kTeamThreads = 128;
constexpr int kVec = kE;           // floats of one per-position vector

// exp(a - b) for two running sums of dt A, as the reference forms its decays
// (an f32 difference, then exp).
__device__ __forceinline__ float decay_of(float a, float b) {
  return expf(__fsub_rn(a, b));
}

// x and dy of type TX are exact in tf32 when bf16 (their products skip the
// lo part, tf32_tiles.cuh); every scale they take (dt, the decays) is moved
// onto the other operand or the product's rows, so that they stay exact.
template <typename TX>
constexpr bool kExactX = std::is_same<TX, bf16>::value;

// Per-CTA indices: chunk z of row b, head group grp.
struct Ctx {
  int b, z, grp, l0, team, tid, wt, lane, g, t, r0;
  __device__ Ctx(int c)
      : b(blockIdx.z), z(blockIdx.x), grp(blockIdx.y), l0(blockIdx.x * c),
        team(threadIdx.x >> 7), tid(threadIdx.x & 127),
        wt((threadIdx.x >> 5) & 3), lane(threadIdx.x & 31),
        g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3),
        r0(16 * ((threadIdx.x >> 5) & 3)) {}
};

__device__ __forceinline__ int tiles8(int n) { return (n + 7) >> 3; }

// One warp: a head's per-position vectors over the chunk, dts = dt, cs =
// the running sum of dt A, ecs = exp(cs) and w = exp(cs_last - cs), times dt
// with w_dt (0 past the chunk's c positions, where dt is 0 and cs the last
// value). dt0 points at position 0's dt; positions are `stride` apart.
// cs is summed in order by one lane, each product and sum rounded to f32
// as torch.cumsum over (dt A) rounds them: a warp scan's other order moved
// a steep head's decays (|cs| in the hundreds over a chunk) by up to 1e-4
// against the plain version, which helped take a bf16 train step's
// gradients (smoke phase 9b) over their rule (PERF.md). The other 31 lanes
// wait 64 additions; the team's other warps issue the head's loads
// meanwhile.
__device__ void head_vectors(const float* __restrict__ dt0, long long stride,
                             float a, int c, float* dts, float* cs,
                             float* ecs, float* w, bool w_dt = false) {
  const int lane = threadIdx.x & 31;
  for (int k = lane; k < kVec; k += 32) dts[k] = k < c ? dt0[k * stride] : 0.f;
  __syncwarp();
  if (lane == 0) {
    float s = 0.f;
    for (int k = 0; k < c; ++k) {
      s = __fadd_rn(s, __fmul_rn(dts[k], a));
      cs[k] = s;
    }
  }
  __syncwarp();
  const float last = cs[c - 1];
  for (int k = lane; k < kVec; k += 32) {
    const bool in = k < c;
    if (!in) cs[k] = last;
    ecs[k] = in ? expf(cs[k]) : 0.f;
    if (w) w[k] = in ? decay_of(last, cs[k]) * (w_dt ? dts[k] : 1.f) : 0.f;
  }
  __syncwarp();
}

// M = C B^T (the chunk's scores, every head's) into Ms, by all 8 warps:
// warp w takes rows 16 (w % 4) and columns [32 (w / 4), 32 (w / 4) + 32).
__device__ __forceinline__ void chunk_scores(float* Ms, const float* Cs,
                                             const float* Bs, int N) {
  const int w = threadIdx.x >> 5, r0 = 16 * (w & 3), c0 = 32 * (w >> 2);
  float acc[8][4];
  zero(acc);
  strip_mm_fine<4>(acc, ARow(Cs, r0), BCol(Bs, c0));
  store_strip<4>(Ms, acc, r0, c0);
}

// ---- K4 pass 1 (and K4b's first): the chunks' own state contributions ------

// V_z[n][p] = sum_j B_j[n] exp(cs_last - cs_j) dt_j x_j[p] into states; with
// kW also W_z[n][p] = sum_i exp(cs_i) C_i[n] dy_i[p] into gstates; decay =
// exp(cs_last) per (row, head, chunk).
template <typename TX, bool kW>
__global__ void __launch_bounds__(kSsdThreads, 2) ssd_chunk_state(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const TX* __restrict__ dy,
    float* __restrict__ states, float* __restrict__ gstates,
    float* __restrict__ decay, int L, int H, int P, int N, int c, int G) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kTeamF = (kW ? 2 : 1) * kTileF + 4 * kVec;
  float* Bs = sm;
  float* Cs = Bs + kTileF;                       // kW only
  const Ctx cx(c);
  float* Xs = sm + (kW ? 2 : 1) * kTileF + cx.team * kTeamF;
  float* Ds = Xs + kTileF;                       // kW only
  float* dts = Xs + (kW ? 2 : 1) * kTileF;
  float* cs = dts + kVec;
  float* ecs = cs + kVec;
  float* w = ecs + kVec;         // exp(cs_last - cs_j) dt_j
  const int nc = L / c;
  const size_t row0 = (size_t)cx.b * L + cx.l0;
  load_tile<kSsdThreads>(Bs, Bm + row0 * N, N, c, N, threadIdx.x);
  if (kW) load_tile<kSsdThreads>(Cs, Cm + row0 * N, N, c, N, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int h_hi = min(H, (cx.grp + 1) * G);
  for (int h = cx.grp * G + cx.team; h < h_hi; h += 2) {
    if (cx.wt == 0) {
      head_vectors(dt + row0 * H + h, H, A[h], c, dts, cs, ecs, w, true);
      if (cx.lane == 0)
        decay[((size_t)cx.b * H + h) * nc + cx.z] = expf(cs[c - 1]);
    }
    const size_t xo = (row0 * H + h) * P;
    load_tile<kTeamThreads>(Xs, x + xo, (long long)H * P, c, P, cx.tid);
    if (kW) load_tile<kTeamThreads>(Ds, dy + xo, (long long)H * P, c, P,
                                    cx.tid);
    cp_async_commit();
    cp_async_wait<0>();
    team_sync(cx.team);
    const size_t so = (((size_t)cx.b * H + h) * nc + cx.z) * N * P;
    const bool pair_ok = P % 2 == 0;
    auto put = [&](float* dst, const float (&acc)[8][4]) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * cx.t;
        if (p >= P) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = cx.r0 + cx.g + 8 * hf;
          if (n < N)
            store_pair(dst + so + (size_t)n * P + p, acc[nt][2 * hf],
                       acc[nt][2 * hf + 1], p + 1 < P, pair_ok);
        }
      }
    };
    if (cx.r0 < N) {
      float acc[8][4];
      zero(acc);
      strip_mm<false, kExactX<TX>>(acc, ACol(Bs, cx.r0, w), BRow(Xs));
      put(states, acc);
      if (kW) {
        zero(acc);
        strip_mm<false, kExactX<TX>>(acc, ACol(Cs, cx.r0, ecs), BRow(Ds));
        put(gstates, acc);
      }
    }
    team_sync(cx.team);
  }
}

// ---- K4 pass 3: the outputs -------------------------------------------------

// y_i = sum_{j <= i} M_ij exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i S_z.
template <typename TX>
__global__ void __launch_bounds__(kSsdThreads, 2) ssd_chunk_out(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ states,
    TX* __restrict__ y, int L, int H, int P, int N, int c, int G) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kTeamF = 2 * kTileF + 3 * kVec;
  float* Cs = sm;
  float* Ms = Cs + kTileF;
  const Ctx cx(c);
  float* Xs = Ms + kTileF + cx.team * kTeamF;
  float* Ss = Xs + kTileF;
  float* dts = Ss + kTileF;
  float* cs = dts + kVec;
  float* ecs = cs + kVec;
  float* Bs = Ms + kTileF + kTeamF;   // team 1's X tile, free until the heads
  const int nc = L / c;
  const size_t row0 = (size_t)cx.b * L + cx.l0;
  load_tile<kSsdThreads>(Cs, Cm + row0 * N, N, c, N, threadIdx.x);
  load_tile<kSsdThreads>(Bs, Bm + row0 * N, N, c, N, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_scores(Ms, Cs, Bs, N);
  __syncthreads();
  const int h_hi = min(H, (cx.grp + 1) * G);
  const int ia = cx.r0 + cx.g, ib = ia + 8;
  const bool pair_ok = P % 2 == 0;
  for (int h = cx.grp * G + cx.team; h < h_hi; h += 2) {
    if (cx.wt == 0)
      head_vectors(dt + row0 * H + h, H, A[h], c, dts, cs, ecs, nullptr);
    const size_t xo = (row0 * H + h) * P;
    load_tile<kTeamThreads>(Xs, x + xo, (long long)H * P, c, P, cx.tid);
    load_tile<kTeamThreads>(
        Ss, states + (((size_t)cx.b * H + h) * nc + cx.z) * N * P, P, N, P,
        cx.tid);
    cp_async_commit();
    cp_async_wait<0>();
    team_sync(cx.team);
    float acc[8][4];
    zero(acc);
    // P1 U: P1_ij = M_ij exp(cs_i - cs_j) for j <= i < c, formed as the A
    // fragment is (depth j in the order 2t, 2t + 1 of each 8)
    const int kt_hi = min(tiles8(c), (cx.r0 + 16) >> 3);
    const float csa = cs[ia], csb = cs[ib];
    for (int kt = 0; kt < kt_hi; ++kt) {
      const int j = 8 * kt + 2 * cx.t;
      const float2 ma = ld2(Ms, ia, j), mb = ld2(Ms, ib, j);
      const float c0 = cs[j], c1 = cs[j + 1];
      const float d0 = dts[j], d1 = dts[j + 1];
      const FragA fa = frag_a(
          (j <= ia && ia < c) ? ma.x * decay_of(csa, c0) * d0 : 0.f,
          (j <= ib && ib < c) ? mb.x * decay_of(csb, c0) * d0 : 0.f,
          (j + 1 <= ia && ia < c) ? ma.y * decay_of(csa, c1) * d1 : 0.f,
          (j + 1 <= ib && ib < c) ? mb.y * decay_of(csb, c1) * d1 : 0.f);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma3<false, kExactX<TX>>(acc[nt], fa, Xs[tat(j, 8 * nt + cx.g)],
                                 Xs[tat(j + 1, 8 * nt + cx.g)]);
    }
    // + exp(cs_i) C_i S_z
    strip_mm<false, false>(acc, ARow(Cs, cx.r0, ecs), BRow(Ss));
    TX* yo = y + xo;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = 8 * nt + 2 * cx.t;
      if (p >= P) continue;
      if (ia < c)
        store_pair(yo + (size_t)ia * H * P + p, acc[nt][0], acc[nt][1],
                   p + 1 < P, pair_ok);
      if (ib < c)
        store_pair(yo + (size_t)ib * H * P + p, acc[nt][2], acc[nt][3],
                   p + 1 < P, pair_ok);
    }
    team_sync(cx.team);
  }
}

// ---- K4b: the chunk's gradients ---------------------------------------------

constexpr int kBwdVecs = 9;   // dts cs ecs w rowT colT Ov Qv ddtv

template <typename TX>
__global__ void __launch_bounds__(kSsdThreads, 1) ssd_chunk_bwd(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const TX* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gstates,
    TX* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dA_part, int B, int L, int H, int P, int N, int c,
    int G) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kTeamF = 4 * kTileF + (kBwdVecs + 1) * kVec + 16;
  float* Cs = sm;               // C_i
  float* Bs = Cs + kTileF;      // B_j
  float* Ms = Bs + kTileF;      // C_i . B_j
  const Ctx cx(c);
  float* Xs = Ms + kTileF + cx.team * kTeamF;   // x_j
  float* Ds = Xs + kTileF;      // dy_i
  float* Ss = Ds + kTileF;      // S_z, the state entering the chunk
  float* Gs = Ss + kTileF;      // G_{z+1}, the cotangent of the state leaving
  float* dts = Gs + kTileF;     // [kVec] each
  float* cs = dts + kVec;
  float* ecs = cs + kVec;
  float* w = ecs + kVec;        // exp(cs_last - cs_j)
  float* rowT = w + kVec;       // d cs_i through the decay's rows
  float* colT = rowT + kVec;    //            and its columns
  float* Ov = colT + kVec;      // d cs_i through the carried state's output
  float* Qv = Ov + kVec;        // d cs_j through the chunk's own state
  float* ddtv = Qv + kVec;      // ddt_j through u_j
  float* red = ddtv + kVec;     // [4]: G . S by warp; [4, 4 + c): d(dt A)
  const int nc = L / c, ngroups = gridDim.y;
  const size_t row0 = (size_t)cx.b * L + cx.l0;
  load_tile<kSsdThreads>(Cs, Cm + row0 * N, N, c, N, threadIdx.x);
  load_tile<kSsdThreads>(Bs, Bm + row0 * N, N, c, N, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_scores(Ms, Cs, Bs, N);
  __syncthreads();

  const int r0 = cx.r0, g = cx.g, t = cx.t;
  const int ia = r0 + g, ib = ia + 8;   // this lane's two rows (i, then j)
  const int nk = tiles8(c), nn = tiles8(N);
  const bool pair_ok = P % 2 == 0;
  float accB[8][4], accC[8][4];   // the group's dB and dC rows r0 .. r0 + 15
  zero(accB);
  zero(accC);
  const int h_hi = min(H, (cx.grp + 1) * G);
  for (int h = cx.grp * G + cx.team; h < h_hi; h += 2) {
    if (cx.wt == 0)
      head_vectors(dt + row0 * H + h, H, A[h], c, dts, cs, ecs, w);
    const size_t xo = (row0 * H + h) * P;
    const size_t so = (((size_t)cx.b * H + h) * nc + cx.z) * N * P;
    load_tile<kTeamThreads>(Ss, states + so, P, N, P, cx.tid);
    load_tile<kTeamThreads>(Gs, gstates + so, P, N, P, cx.tid);
    load_tile<kTeamThreads>(Xs, x + xo, (long long)H * P, c, P, cx.tid);
    load_tile<kTeamThreads>(Ds, dy + xo, (long long)H * P, c, P, cx.tid);
    cp_async_commit();
    cp_async_wait<0>();
    team_sync(cx.team);
    {   // G . S, for d cs_last
      float s = 0.f;
      for (int e = 4 * cx.tid; e < kTileF; e += 4 * kTeamThreads) {
        const float4 a = *reinterpret_cast<const float4*>(Gs + e);
        const float4 q = *reinterpret_cast<const float4*>(Ss + e);
        s += a.x * q.x + a.y * q.y + a.z * q.z + a.w * q.w;
      }
      s = warp_sum(s);
      if (cx.lane == 0) red[cx.wt] = s;
    }
    const float csa = cs[ia], csb = cs[ib];
    // i-role. D = dy U^T by rows i, then P2 = lm D in place, with lm_ij =
    // exp(cs_i - cs_j) for j <= i < c; rowT_i = sum_j M_ij lm_ij D_ij.
    {
      const int jt_hi = min(nk, (r0 + 16) >> 3);
      float d[8][4];
      zero(d);
      strip_mm<kExactX<TX>, kExactX<TX>, false>(d, ARow(Ds, r0), BCol(Xs));
      float ra = 0.f, rb = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= jt_hi) continue;
        const int j = 8 * nt + 2 * t;
        const float2 ma = ld2(Ms, ia, j), mb = ld2(Ms, ib, j);
        const float c0 = cs[j], c1 = cs[j + 1];
        const float d0 = dts[j], d1 = dts[j + 1];   // u_j = dt_j x_j
        const float l0 = (j <= ia && ia < c) ? decay_of(csa, c0) : 0.f;
        const float l1 = (j + 1 <= ia && ia < c) ? decay_of(csa, c1) : 0.f;
        const float l2 = (j <= ib && ib < c) ? decay_of(csb, c0) : 0.f;
        const float l3 = (j + 1 <= ib && ib < c) ? decay_of(csb, c1) : 0.f;
        d[nt][0] *= d0;
        d[nt][1] *= d1;
        d[nt][2] *= d0;
        d[nt][3] *= d1;
        ra += ma.x * l0 * d[nt][0] + ma.y * l1 * d[nt][1];
        rb += mb.x * l2 * d[nt][2] + mb.y * l3 * d[nt][3];
        d[nt][0] *= l0;
        d[nt][1] *= l1;
        d[nt][2] *= l2;
        d[nt][3] *= l3;
      }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      if (t == 0) {
        rowT[ia] = ra;
        rowT[ib] = rb;
      }
      // dC_i += sum_j P2_ij B_j
      strip_mm_regs<false, false>(accC, d, 0, jt_hi, Bs);
      // + exp(cs_i) S dy_i; O_i = C_i . exp(cs_i) S dy_i
      zero(d);
      strip_mm<kExactX<TX>, false, false>(d, ARow(Ds, r0), BCol(Ss));
      float oa = 0.f, ob = 0.f;
      const float ea = ecs[ia], eb = ecs[ib];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nn) continue;
        const int n = 8 * nt + 2 * t;
        d[nt][0] *= ea;
        d[nt][1] *= ea;
        d[nt][2] *= eb;
        d[nt][3] *= eb;
        const float2 ca = ld2(Cs, ia, n), cb = ld2(Cs, ib, n);
        oa += ca.x * d[nt][0] + ca.y * d[nt][1];
        ob += cb.x * d[nt][2] + cb.y * d[nt][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) accC[nt][e] += d[nt][e];
      }
      oa = quad_sum(oa);
      ob = quad_sum(ob);
      if (t == 0) {
        Ov[ia] = oa;
        Ov[ib] = ob;
      }
    }
    // j-role. D^T = U dy^T by rows j, then P1^T = M^T lm^T and P2^T = lm^T
    // D^T; colT_j = sum_i M_ij lm_ij D_ij.
    {
      const int it_lo = r0 >> 3;
      float dT[8][4], p1[8][4];
      zero(dT);
      strip_mm<kExactX<TX>, kExactX<TX>, false>(dT, ARow(Xs, r0),
                                                BCol(Ds));
      float ca = 0.f, cb = 0.f;
      const float dta = dts[ia], dtb = dts[ib];   // u_j = dt_j x_j
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < it_lo || nt >= nk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p1[nt][e] = 0.f;
          continue;
        }
        const int i = 8 * nt + 2 * t;   // columns i, i + 1; rows ia, ib (j)
        const float c0 = cs[i], c1 = cs[i + 1];
        const float l0 = (ia <= i && i < c) ? decay_of(c0, csa) : 0.f;
        const float l1 = (ia <= i + 1 && i + 1 < c) ? decay_of(c1, csa) : 0.f;
        const float l2 = (ib <= i && i < c) ? decay_of(c0, csb) : 0.f;
        const float l3 = (ib <= i + 1 && i + 1 < c) ? decay_of(c1, csb) : 0.f;
        dT[nt][0] *= dta;
        dT[nt][1] *= dta;
        dT[nt][2] *= dtb;
        dT[nt][3] *= dtb;
        p1[nt][0] = Ms[tat(i, ia)] * l0;
        p1[nt][1] = Ms[tat(i + 1, ia)] * l1;
        p1[nt][2] = Ms[tat(i, ib)] * l2;
        p1[nt][3] = Ms[tat(i + 1, ib)] * l3;
        ca += p1[nt][0] * dT[nt][0] + p1[nt][1] * dT[nt][1];
        cb += p1[nt][2] * dT[nt][2] + p1[nt][3] * dT[nt][3];
        dT[nt][0] *= l0;
        dT[nt][1] *= l1;
        dT[nt][2] *= l2;
        dT[nt][3] *= l3;
      }
      ca = quad_sum(ca);
      cb = quad_sum(cb);
      if (t == 0) {
        colT[ia] = ca;
        colT[ib] = cb;
      }
      // dB_j += sum_i P2_ij C_i
      strip_mm_regs<false, false>(accB, dT, it_lo, nk, Cs);
      // du_j = sum_i P1_ij dy_i + exp(cs_last - cs_j) G^T B_j
      zero(dT);
      strip_mm_regs<kExactX<TX>>(dT, p1, it_lo, nk, Ds);
      strip_mm<false, false>(dT, ARow(Bs, r0, w), BRow(Gs));
      // dx_j = dt_j du_j; ddt_j through u_j: x_j . du_j
      float xa = 0.f, xb = 0.f;
      TX* dxo = dx + xo;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        if (p >= P) continue;
        const float2 x0 = ld2(Xs, ia, p), x1 = ld2(Xs, ib, p);
        xa += x0.x * dT[nt][0] + x0.y * dT[nt][1];
        xb += x1.x * dT[nt][2] + x1.y * dT[nt][3];
        if (ia < c)
          store_pair(dxo + (size_t)ia * H * P + p, dta * dT[nt][0],
                     dta * dT[nt][1], p + 1 < P, pair_ok);
        if (ib < c)
          store_pair(dxo + (size_t)ib * H * P + p, dtb * dT[nt][2],
                     dtb * dT[nt][3], p + 1 < P, pair_ok);
      }
      xa = quad_sum(xa);
      xb = quad_sum(xb);
      if (t == 0) {
        ddtv[ia] = xa;
        ddtv[ib] = xb;
      }
      // dB_j += exp(cs_last - cs_j) G u_j; Q_j = B_j . exp(cs_last - cs_j)
      // G u_j
      zero(dT);
      strip_mm<kExactX<TX>, false, false>(dT, ARow(Xs, r0), BCol(Gs));
      float qa = 0.f, qb = 0.f;
      const float sa = dta * w[ia], sb = dtb * w[ib];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nn) continue;
        const int n = 8 * nt + 2 * t;
        dT[nt][0] *= sa;
        dT[nt][1] *= sa;
        dT[nt][2] *= sb;
        dT[nt][3] *= sb;
        const float2 b0 = ld2(Bs, ia, n), b1 = ld2(Bs, ib, n);
        qa += b0.x * dT[nt][0] + b0.y * dT[nt][1];
        qb += b1.x * dT[nt][2] + b1.y * dT[nt][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) accB[nt][e] += dT[nt][e];
      }
      qa = quad_sum(qa);
      qb = quad_sum(qb);
      if (t == 0) {
        Qv[ia] = qa;
        Qv[ib] = qb;
      }
    }
    team_sync(cx.team);
    // d cs and its reverse running sum d(dt A), summed in order by one lane
    // as the plain version's autograd (a reversed torch.cumsum) sums it;
    // then ddt, stored by the lanes that own its positions, and this
    // (head, chunk)'s dA, by the team's first warp
    if (cx.wt == 0) {
      if (cx.lane == 0) {
        float dlast = expf(cs[c - 1]) * (red[0] + red[1] + red[2] + red[3]);
        for (int j = 0; j < c; ++j) dlast += Qv[j];
        float da = 0.f;
        for (int k = c - 1; k >= 0; --k) {
          da += rowT[k] - colT[k] + Ov[k] - Qv[k] + (k == c - 1 ? dlast : 0.f);
          red[4 + k] = da;
        }
      }
      __syncwarp();
      const float a = A[h];
      float* ddto = ddt + row0 * H + h;
      float part = 0.f;
      for (int k = cx.lane; k < c; k += 32) {
        ddto[(size_t)k * H] = ddtv[k] + a * red[4 + k];
        part += dts[k] * red[4 + k];
      }
      const float dA = warp_sum(part);
      if (cx.lane == 0) dA_part[((size_t)h * B + cx.b) * nc + cx.z] = dA;
    }
  }
  // the group's dB and dC: team 0's heads, then team 1's
  __syncthreads();
  float* tB = Ms + kTileF + kTeamF;   // team 1's x and dy tiles
  float* tC = tB + kTileF;
  if (cx.team == 1) {
    store_strip(tB, accB, r0, 0);
    store_strip(tC, accC, r0, 0);
  }
  __syncthreads();
  if (cx.team == 0) {
    const size_t po = ((size_t)cx.b * ngroups + cx.grp) * L + cx.l0;
    const bool npair = N % 2 == 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = ia + 8 * hf;
        if (r >= c) continue;
        const float2 ob = ld2(tB, r, n), oc = ld2(tC, r, n);
        store_pair(dB_part + (po + r) * N + n, accB[nt][2 * hf] + ob.x,
                   accB[nt][2 * hf + 1] + ob.y, n + 1 < N, npair);
        store_pair(dC_part + (po + r) * N + n, accC[nt][2 * hf] + oc.x,
                   accC[nt][2 * hf + 1] + oc.y, n + 1 < N, npair);
      }
    }
  }
}

bool ssd_args_ok(int B, int L, int H, int P, int N, int c, int G,
                 int dtype) {
  return B > 0 && L > 0 && H > 0 && P > 0 && P <= kE && N > 0 && N <= kE &&
         c > 0 && c <= kE && L % c == 0 && B <= 65535 && G > 0 &&
         (H + G - 1) / G <= 65535 && (dtype == kF32 || dtype == kBF16);
}

constexpr size_t kStateSmem = (3 * kTileF + 2 * 4 * kVec) * sizeof(float);
constexpr size_t kStateWSmem = (6 * kTileF + 2 * 4 * kVec) * sizeof(float);
constexpr size_t kOutSmem = (6 * kTileF + 2 * 3 * kVec) * sizeof(float);
constexpr size_t kBwdSmem =
    (11 * kTileF + 2 * ((kBwdVecs + 1) * kVec + 16)) * sizeof(float);

template <typename TX>
int launch_fwd(const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, void* y, float* fin,
               float* states, float* decay, int B, int L, int H, int P, int N,
               int c, int G, cudaStream_t st) {
  int err = allow_smem(ssd_chunk_state<TX, false>, kStateSmem);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_out<TX>, kOutSmem);
  if (err != cudaSuccess) return err;
  const TX* xt = static_cast<const TX*>(x);
  const int nc = L / c;
  const dim3 grid(nc, (H + G - 1) / G, B);
  ssd_chunk_state<TX, false><<<grid, kSsdThreads, kStateSmem, st>>>(
      xt, dt, A, Bm, nullptr, nullptr, states, nullptr, decay, L, H, P, N, c,
      G);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_carry(states, nullptr, decay, fin, B, H, nc, N * P, 1, 1,
                       st);
  if (err != cudaSuccess) return err;
  ssd_chunk_out<TX><<<grid, kSsdThreads, kOutSmem, st>>>(
      xt, dt, A, Bm, Cm, states, static_cast<TX*>(y), L, H, P, N, c, G);
  return cudaGetLastError();
}

template <typename TX>
int launch_bwd(const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, const void* dy, void* dx,
               float* ddt, float* dA, float* dBm, float* dCm, float* states,
               float* gstates, float* decay, float* dB_part, float* dC_part,
               float* dA_part, int B, int L, int H, int P, int N, int c,
               int G, cudaStream_t st) {
  int err = allow_smem(ssd_chunk_state<TX, true>, kStateWSmem);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_bwd<TX>, kBwdSmem);
  if (err != cudaSuccess) return err;
  const TX* xt = static_cast<const TX*>(x);
  const TX* dyt = static_cast<const TX*>(dy);
  const int nc = L / c, ngroups = (H + G - 1) / G;
  const dim3 grid(nc, ngroups, B);
  ssd_chunk_state<TX, true><<<grid, kSsdThreads, kStateWSmem, st>>>(
      xt, dt, A, Bm, Cm, dyt, states, gstates, decay, L, H, P, N, c, G);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_carry(states, gstates, decay, nullptr, B, H, nc, N * P, 1, 2,
                       st);
  if (err != cudaSuccess) return err;
  ssd_chunk_bwd<TX><<<grid, kSsdThreads, kBwdSmem, st>>>(
      xt, dt, A, Bm, Cm, dyt, states, gstates, static_cast<TX*>(dx), ddt,
      dB_part, dC_part, dA_part, B, L, H, P, N, c, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long ln = (long long)L * N;
  sum_mid<<<cdiv(B * ln, kScanThreads), kScanThreads, 0, st>>>(
      dB_part, dBm, B, ngroups, ln);
  sum_mid<<<cdiv(B * ln, kScanThreads), kScanThreads, 0, st>>>(
      dC_part, dCm, B, ngroups, ln);
  sum_mid<<<cdiv(H, kScanThreads), kScanThreads, 0, st>>>(dA_part, dA, H,
                                                        B * nc, 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,L,H,P] (dtype: 0 f32, 1 bf16), dt [B,L,H], A [H], Bm, Cm [B,L,N]
// f32, contiguous; writes y [B,L,H,P] in x's dtype and the final state
// [B,H,N,P] f32. Scratch: states [B,H,L/c,N,P] and decay [B,H,L/c] f32. P,
// N and the chunk c at most 64, L a multiple of c; G heads to a CTA.
int mamba2_ssd_fwd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, void* y,
                          float* fin, float* states, float* decay, int B,
                          int L, int H, int P, int N, int c, int G, int dtype,
                          void* stream) {
  if (!ssd_args_ok(B, L, H, P, N, c, G, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<bf16>(x, dt, A, Bm, Cm, y, fin, states, decay, B, L, H,
                            P, N, c, G, st);
  return launch_fwd<float>(x, dt, A, Bm, Cm, y, fin, states, decay, B, L, H,
                           P, N, c, G, st);
}

// The forward's inputs and dy [B,L,H,P] (x's dtype); writes dx (x's dtype),
// ddt [B,L,H], dA [H], dBm and dCm [B,L,N] f32, for a zero cotangent of the
// final state. Scratch: states and gstates [B,H,L/c,N,P], decay [B,H,L/c],
// dB_part and dC_part [B,ceil(H/G),L,N], dA_part [H,B,L/c], all f32.
int mamba2_ssd_bwd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, const void* dy,
                          void* dx, float* ddt, float* dA, float* dBm,
                          float* dCm, float* states, float* gstates,
                          float* decay, float* dB_part, float* dC_part,
                          float* dA_part, int B, int L, int H, int P, int N,
                          int c, int G, int dtype, void* stream) {
  if (!ssd_args_ok(B, L, H, P, N, c, G, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bwd<bf16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                            states, gstates, decay, dB_part, dC_part, dA_part,
                            B, L, H, P, N, c, G, st);
  return launch_bwd<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBm, dCm,
                           states, gstates, decay, dB_part, dC_part, dA_part,
                           B, L, H, P, N, c, G, st);
}

}  // extern "C"
