// Helpers of the chunked-scan kernels (mamba2_scan.cu, rwkv6_scan.cu): one
// CTA of 256 threads per chunk holds its operands as 64 x 64 f32 tiles in
// shared memory (rows and columns past the chunk or the width zero), each
// thread accumulating a 4 x 4 block of a 64 x 64 product on the CUDA cores.

#pragma once

#include "mma_common.cuh"

namespace {

constexpr int kT = 64;           // tile edge: chunk, N and P padded to it
constexpr int kLd = kT + 1;      // shared row stride (floats): no conflicts
constexpr int kTile = kT * kLd;  // floats per tile
constexpr int kScanThreads = 256;

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
  for (int e = threadIdx.x; e < kT * kT; e += kScanThreads) {
    const int i = e / kT, j = e % kT;
    dst[i * kLd + j] = (i < rows && j < cols) ? f(i, j) : 0.f;
  }
}

// out[o][i] = sum_m in[o][m][i], m in order: a sum across CTAs from their
// partials, deterministic (no atomics).
__global__ void __launch_bounds__(kScanThreads) sum_mid(
    const float* __restrict__ in, float* __restrict__ out, long long outer,
    int mid, long long inner) {
  const long long t = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (t >= outer * inner) return;
  const long long o = t / inner, i = t % inner;
  const float* p = in + o * mid * inner + i;
  float s = 0.f;
  for (int m = 0; m < mid; ++m) s += p[(long long)m * inner];
  out[t] = s;
}

int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
