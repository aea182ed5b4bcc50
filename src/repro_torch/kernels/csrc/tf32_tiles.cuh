// Split-TF32 tensor-core products on 64 x 64 f32 tiles in shared memory,
// for the chunked scans (mamba2_scan.cu, rwkv6_scan.cu); the grouped
// matmul's f32 tiles (moe_gmm.cu) take the products alone.
//
// Split TF32. An f32 operand a is taken as a_hi = tf32(a) and a_lo =
// tf32(a - a_hi) (each rounded as cvt.rna rounds), formed in registers as
// the fragment is read; the product runs as a_lo b_hi + a_hi b_lo + a_hi
// b_hi (small terms first) on mma.sync.m16n8k8 with tf32 inputs and f32
// accumulation: each product keeps about 22 of f32's 24 bits, where one
// tf32 product keeps 11.
// A bf16 operand (x, dy when they are bf16) is exact in tf32: its lo part is
// zero and the product that would read it is skipped. A product formed once
// per chunk and read by every head (the scores C B^T) splits each operand in
// three parts instead, and sums its depth steps in f64 (strip_mm_fine).
//
// Fragments of m16n8k8 tf32 (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// lane = 4 g + t:
//   A (16 x 8, row):  a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                     a3 = A[g + 8][t + 4]
//   B (8 x 8, col):   b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8, f32):  c0, c1 = C[g][2t, 2t + 1], c2, c3 = C[g + 8][2t, 2t + 1]
// A 16 x 8 C tile of one product is the A fragment of the next with the
// depth taken in the order 2t, 2t + 1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3):
// the B operand of that product is then read at depth rows 8 kt + 2t and
// 8 kt + 2t + 1 (strip_mm_regs). A warp works on a strip of 16 rows and up
// to 64 columns (eight 16 x 8 tiles).
//
// Shared layout. A tile is 64 rows of 64 floats, no padding; element (r, c)
// lies at r * 64 + (c ^ tswz(r)), an XOR of column bits 2-4 with a function
// of r % 8 (tswz). The tiles are read in four ways, and this one layout puts
// the 32 lanes of each on 32 distinct banks:
//   rows g, columns k + t        (an A operand, or B read transposed);
//   rows k + t, columns n + g    (B, or A read transposed: B^T U, P^T dy);
//   rows 2t and 2t + 1, columns n + g (B after a register A, above);
//   float2 at rows g, columns 2t (the C fragment's own positions);
// (k a multiple of 4, n of 8). A padded pitch serves the first two only
// (pitch = 4 mod 32 the first, 8 mod 32 the second), and several tiles are
// read both ways (G in du and dB, the chunk's B and C). The XOR keeps 16-byte
// pieces whole, so loads store them as float4.

#pragma once

#include "mma_common.cuh"

namespace {

constexpr int kE = 64;             // tile edge: chunk, N and P padded to it
constexpr int kTileF = kE * kE;    // floats per tile

__device__ __forceinline__ int tswz(int r) {
  // h(r) takes distinct values over rows {0..3}, {4..7}, {0,2,4,6} and
  // {1,3,5,7}; with bit 2 of r below it, a permutation of 0..7
  const int h = ((r >> 1) & 1) | (((r ^ (r >> 2)) & 1) << 1);
  return ((h << 1) | ((r >> 2) & 1)) << 2;
}

__device__ __forceinline__ int tat(int r, int c) {
  return r * kE + (c ^ tswz(r));
}

__device__ __forceinline__ float2 ld2(const float* T, int r, int c) {
  return *reinterpret_cast<const float2*>(T + tat(r, c));
}

// ---- products ----------------------------------------------------------------

// x rounded to tf32, to nearest with ties away from zero (cvt.rna's
// rounding), as two integer operations: cvt.rna.tf32.f32 issues at a
// fraction of their rate, and the products' operands are split by the
// thousand.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Split {
  uint32_t hi, lo;
};

// kExact: x is exact in tf32 (a bf16 value: x, dy), lo = 0 and unused.
template <bool kExact = false>
__device__ __forceinline__ Split split(float x) {
  if (kExact) return {__float_as_uint(x), 0u};
  const uint32_t hi = tf32_hi(x);
  return {hi, tf32_hi(x - __uint_as_float(hi))};
}

struct FragA {
  Split v[4];
};

template <bool kExact = false>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  return {{split<kExact>(a0), split<kExact>(a1), split<kExact>(a2),
           split<kExact>(a3)}};
}

// d += a b, b = (b0, b1) this lane's B elements, as a_lo b_hi + a_hi b_lo +
// a_hi b_hi; the product with an exact operand's lo part (zero) is skipped,
// so an exact operand takes two products and two exact operands one. With
// kFresh the step's products are summed in a fresh accumulator and added
// to d in f32: the tensor core's sum does not round to nearest (it aligns
// its addends to the largest and drops the bits below, always toward
// zero), so adding to a long sum in place drifts it by about half a unit of
// its last place a step, where a fresh sum drops bits of the step's own
// size only. The products that make y and dx (bf16 outputs, where each
// drift flips roundings against the plain version) take it.
// The B elements already split (x, y), for a B fragment that several
// products read.
template <bool kAExact, bool kBExact, bool kFresh = true>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const Split& x, const Split& y) {
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  float (&s)[4] = kFresh ? z : d;
  if (!kAExact)
    mma_tf32(s, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, x.hi, y.hi);
  if (!kBExact)
    mma_tf32(s, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, x.lo, y.lo);
  mma_tf32(s, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, x.hi, y.hi);
  if (kFresh)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += z[e];
}

template <bool kAExact, bool kBExact, bool kFresh = true>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  mma3<kAExact, kBExact, kFresh>(d, a, split<kBExact>(b0),
                                 split<kBExact>(b1));
}

// Operands of a strip product, read from a tile: A (16 x 64, the strip's
// rows by the depth k) and B (64 x 64, the depth by the columns). Each
// forms its lane's addresses once, as the lane's own offsets (every row
// that a lane reads has a known row % 8: g, t, t + 4, 2t or 2t + 1) plus the
// step's and the tile's: a column c0 + 8 q + l with l < 8 swizzles to
// ((c0 + 8 q) ^ (s & 24)) + (l ^ (s & 4)) for s = tswz(row).

// A(r, k) = s_r T[r0 + r][k], s_r = sr[r0 + r] (1 without sr).
struct ARow {
  const float* p0;
  const float* p4;
  int sh;
  float sa, sb;
  __device__ __forceinline__ ARow(const float* T, int r0,
                                  const float* sr = nullptr) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int s = tswz(g);
    sh = s & 24;
    p0 = T + (r0 + g) * kE + (t ^ (s & 4));
    p4 = T + (r0 + g) * kE + ((t + 4) ^ (s & 4));
    sa = sr ? sr[r0 + g] : 1.f;
    sb = sr ? sr[r0 + g + 8] : 1.f;
  }
  __device__ __forceinline__ void load(int ks, float (&a)[4]) const {
    const int x = (8 * ks) ^ sh;
    a[0] = p0[x] * sa;
    a[1] = p0[x + 8 * kE] * sb;
    a[2] = p4[x] * sa;
    a[3] = p4[x + 8 * kE] * sb;
  }
};

// A(r, k) = sk[k] T[k][r0 + r].
struct ACol {
  const float* q0;
  const float* q1;
  const float* q4;
  const float* q5;
  const float* sk;
  int t;
  __device__ __forceinline__ ACol(const float* T, int r0, const float* sk_)
      : sk(sk_) {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    t = lane & 3;
    const int s0 = tswz(t), s4 = tswz(t + 4);
    q0 = T + t * kE + ((r0 + g) ^ s0);
    q1 = T + t * kE + ((r0 + g + 8) ^ s0);
    q4 = T + (t + 4) * kE + ((r0 + g) ^ s4);
    q5 = T + (t + 4) * kE + ((r0 + g + 8) ^ s4);
  }
  __device__ __forceinline__ void load(int ks, float (&a)[4]) const {
    const int o = 8 * kE * ks;
    const float s0 = sk[8 * ks + t], s4 = sk[8 * ks + t + 4];
    a[0] = q0[o] * s0;
    a[1] = q1[o] * s0;
    a[2] = q4[o] * s4;
    a[3] = q5[o] * s4;
  }
};

// B(k, n) = T[k][c0 + n], c0 a multiple of 8.
struct BRow {
  const float* p0;
  const float* p4;
  int c0, h0, h4;
  __device__ __forceinline__ BRow(const float* T, int c0_ = 0) : c0(c0_) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int s0 = tswz(t), s4 = tswz(t + 4);
    h0 = s0 & 24;
    h4 = s4 & 24;
    p0 = T + t * kE + (g ^ (s0 & 4));
    p4 = T + (t + 4) * kE + (g ^ (s4 & 4));
  }
  __device__ __forceinline__ void load(int ks, int nt, float& b0,
                                       float& b1) const {
    const int o = 8 * kE * ks, c = c0 + 8 * nt;
    b0 = p0[o + (c ^ h0)];
    b1 = p4[o + (c ^ h4)];
  }
};

// B(k, n) = T[c0 + n][k], c0 a multiple of 8.
struct BCol {
  const float* p0;
  const float* p4;
  int sh;
  __device__ __forceinline__ BCol(const float* T, int c0 = 0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int s = tswz(g);
    sh = s & 24;
    p0 = T + (c0 + g) * kE + (t ^ (s & 4));
    p4 = T + (c0 + g) * kE + ((t + 4) ^ (s & 4));
  }
  __device__ __forceinline__ void load(int ks, int nt, float& b0,
                                       float& b1) const {
    const int x = ((8 * ks) ^ sh) + 8 * kE * nt;
    b0 = p0[x];
    b1 = p4[x];
  }
};

// acc[nt] += sum over depth k < 64 of A(r, k) B(k, 8 nt + col) for the
// warp's 16-row strip, all eight column tiles. kAExact / kBExact say that an
// operand is exact in tf32. The depth runs over the whole tile and every
// column tile is computed (past a width the tiles are zero): a tile skipped
// at run time would cut the step into blocks that cannot be interleaved.
template <bool kAExact, bool kBExact, bool kFresh = true, typename OA,
          typename OB>
__device__ __forceinline__ void strip_mm(float (&acc)[8][4], const OA& A,
                                         const OB& B) {
#pragma unroll 1
  for (int ks = 0; ks < kE / 8; ++ks) {
    float a[4];
    A.load(ks, a);
    const FragA fa = frag_a<kAExact>(a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float b0, b1;
      B.load(ks, nt, b0, b1);
      mma3<kAExact, kBExact, kFresh>(acc[nt], fa, b0, b1);
    }
  }
}

// acc[nt] += p B for p the strip held as C tiles (p[kt] its columns
// [8 kt, 8 kt + 8), kt in [k_lo, k_hi)) and B(k, n) = T[k][n]: the depth of
// this product is p's column, taken in the order 2t, 2t + 1, so T is read
// at rows 8 kt + 2t and + 1. All eight column tiles.
template <bool kBExact, bool kFresh = true>
__device__ __forceinline__ void strip_mm_regs(float (&acc)[8][4],
                                              const float (&p)[8][4],
                                              int k_lo, int k_hi,
                                              const float* T) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = tswz(2 * t), s1 = tswz(2 * t + 1);
  const float* p0 = T + 2 * t * kE + (g ^ (s0 & 4));
  const float* p1 = T + (2 * t + 1) * kE + (g ^ (s1 & 4));
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    if (kt < k_lo || kt >= k_hi) continue;
    const FragA fa = frag_a(p[kt][0], p[kt][2], p[kt][1], p[kt][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma3<false, kBExact, kFresh>(acc[nt], fa,
                           p0[8 * kE * kt + ((8 * nt) ^ (s0 & 24))],
                           p1[8 * kE * kt + ((8 * nt) ^ (s1 & 24))]);
  }
}

// acc[nt] = A B as strip_mm, with each operand split in three tf32 parts
// (x = x1 + x2 + x3) and the six products above 2^-33 of |a b|, for a
// product formed once and read by every head, where the others' error
// would show: a score C_i . B_i that cancels scales a whole row of y and of
// dx. The tensor core's f32 sum does not round to nearest (it aligns its
// addends to the largest and drops the bits below), so the sums of a long
// depth drift by several units of their largest partial sum: each depth
// step of 8 is summed into a fresh accumulator and the steps in f64.
template <int kNT, typename OA, typename OB>
__device__ __forceinline__ void strip_mm_fine(float (&acc)[8][4], const OA& A,
                                              const OB& B) {
  auto three = [](float x, uint32_t (&o)[3]) {
    o[0] = tf32_hi(x);
    const float r = x - __uint_as_float(o[0]);
    o[1] = tf32_hi(r);
    o[2] = tf32_hi(r - __uint_as_float(o[1]));
  };
  double sum[kNT][4] = {};
#pragma unroll 1
  for (int ks = 0; ks < kE / 8; ++ks) {
    float a[4];
    A.load(ks, a);
    uint32_t P[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) three(a[e], P[e]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float b0, b1;
      B.load(ks, nt, b0, b1);
      uint32_t x[3], y[3];
      three(b0, x);
      three(b1, y);
      // (i, j) = parts of a and b, smallest products first
      constexpr int kPairs[6][2] = {{1, 1}, {2, 0}, {0, 2},
                                    {1, 0}, {0, 1}, {0, 0}};
      float step[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const int i = kPairs[q][0], j = kPairs[q][1];
        mma_tf32(step, P[0][i], P[1][i], P[2][i], P[3][i], x[j], y[j]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[nt][e] += step[e];
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = static_cast<float>(sum[nt][e]);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// The strip's first kNT C tiles into tile T at rows r0 .. r0 + 15, columns
// from c0.
template <int kNT = 8>
__device__ __forceinline__ void store_strip(float* T, const float (&acc)[8][4],
                                            int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = c0 + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(T + tat(r0 + g, c)) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(T + tat(r0 + g + 8, c)) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Sums v over the four lanes of a row of the C fragment (lanes 4g .. 4g+3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- loads ---------------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// T[r][c] = src[r * ld + c] for r < rows, c < cols, 0 elsewhere, by the NT
// threads numbered tid. f32: 16-byte cp.async pieces (complete after
// cp_async_commit and cp_async_wait), or element loads where a row is not
// 16-byte aligned.
template <int NT>
__device__ __forceinline__ void load_tile(float* T, const float* src,
                                          long long ld, int rows, int cols,
                                          int tid) {
  if (cols % 4 == 0 && ld % 4 == 0 && aligned16(src)) {
#pragma unroll
    for (int e = tid; e < kE * 16; e += NT) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool in = r < rows && c < cols;
      cp_async16(T + tat(r, c), in ? src + r * ld + c : src, in);
    }
    return;
  }
  for (int e = tid; e < kE * kE; e += NT) {
    const int r = e >> 6, c = e & 63;
    T[tat(r, c)] = (r < rows && c < cols) ? src[r * ld + c] : 0.f;
  }
}

// bf16: 16-byte loads (8 elements), all issued before any is converted and
// stored as two float4.
template <int NT>
__device__ __forceinline__ void load_tile(float* T, const __nv_bfloat16* src,
                                          long long ld, int rows, int cols,
                                          int tid) {
  if (cols % 8 == 0 && ld % 8 == 0 && aligned16(src)) {
    constexpr int kIt = kE * 8 / NT;
    uint4 v[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * NT, r = e >> 3, c = (e & 7) * 8;
      v[it] = (r < rows && c < cols)
                  ? __ldg(reinterpret_cast<const uint4*>(src + r * ld + c))
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * NT, r = e >> 3, c = (e & 7) * 8;
      const uint32_t w[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
      float f[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        f[2 * u] = __uint_as_float(w[u] << 16);
        f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
      }
      *reinterpret_cast<float4*>(T + tat(r, c)) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(T + tat(r, c + 4)) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
    return;
  }
  for (int e = tid; e < kE * kE; e += NT) {
    const int r = e >> 6, c = e & 63;
    T[tat(r, c)] =
        (r < rows && c < cols) ? __bfloat162float(src[r * ld + c]) : 0.f;
  }
}

// Two adjacent outputs (p, p + 1) of a row; the second only when p + 1 <
// cols; as one store where the pair is aligned.
__device__ __forceinline__ void store_pair(float* dst, float a, float b,
                                           bool both, bool pair_ok) {
  if (both && pair_ok) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (both) dst[1] = b;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b, bool both, bool pair_ok) {
  if (both && pair_ok) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  } else {
    dst[0] = __float2bfloat16(a);
    if (both) dst[1] = __float2bfloat16(b);
  }
}

// Named barrier of the 128 threads of team `team` (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(team + 1) : "memory");
}

}  // namespace
