// Helpers of the chunked-scan kernels (mamba2_scan.cu, rwkv6_scan.cu): the
// carry of each chunk's state over the chunks (both directions), the
// deterministic sum of per-CTA partials, and the launch helpers. The
// products and the tiles are tf32_tiles.cuh's.

#pragma once

#include "mma_common.cuh"

namespace {

constexpr int kScanThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 ld_v(const float* p, float4) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float ld_v(const float* p, float) { return *p; }
__device__ __forceinline__ void st_v(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st_v(float* p, float v) { *p = v; }
__device__ __forceinline__ float4 carry_step(float4 s, float d, float4 v) {
  return make_float4(s.x * d + v.x, s.y * d + v.y, s.z * d + v.z,
                     s.w * d + v.w);
}
__device__ __forceinline__ float carry_step(float s, float d, float v) {
  return s * d + v;
}

// The carry over chunks. Each (row b, head h, chunk z) holds a state of n
// floats in `rows` rows of n / rows; the decay of row q over chunk z is
// d_z = decay[((b H + h) nc + z) rows + q] (Mamba2: one row, the whole
// state; RWKV-6: a row per key channel). blockIdx.y < H: forwards over v,
// S_0 = 0, v_z <- S_z, S_{z+1} = d_z S_z + v_z, S_nc to fin (when given).
// blockIdx.y >= H: backwards over g, G_nc = 0, g_z <- G_{z+1}, G_z = d_z
// G_{z+1} + g_z. V is float4 (a row's length a multiple of 4) or float;
// each thread takes one V of every chunk, in one row. The next eight
// chunks' loads are issued before this eight's stores.
template <typename V>
__global__ void __launch_bounds__(kScanThreads) chunk_carry(
    float* __restrict__ v, float* __restrict__ g,
    const float* __restrict__ decay, float* __restrict__ fin, int H, int nc,
    int n, int rows) {
  constexpr int kW = sizeof(V) / sizeof(float), kU = 8;
  const int e = (blockIdx.x * kScanThreads + threadIdx.x) * kW;
  if (e >= n) return;
  const bool rev = blockIdx.y >= H;
  const int h = rev ? blockIdx.y - H : blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  float* base = (rev ? g : v) + bh * nc * n + e;
  const float* d = decay + bh * nc * rows + e / (n / rows);
  V cur[kU], nxt[kU];
  V s{};
#pragma unroll
  for (int u = 0; u < kU; ++u)
    if (u < nc) cur[u] = ld_v(base + (size_t)(rev ? nc - 1 - u : u) * n, V{});
  for (int t0 = 0; t0 < nc; t0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + kU + u;
      if (t < nc) nxt[u] = ld_v(base + (size_t)(rev ? nc - 1 - t : t) * n,
                                V{});
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t >= nc) break;
      const int z = rev ? nc - 1 - t : t;
      st_v(base + (size_t)z * n, s);
      s = carry_step(s, d[(size_t)z * rows], cur[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
  if (!rev && fin) st_v(fin + bh * n + e, s);
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

// chunk_carry over states v (forwards) and, with dirs = 2, g (backwards) in
// one launch: B rows, H heads, nc chunks of n floats in `rows` rows each.
int launch_carry(float* v, float* g, const float* decay, float* fin, int B,
                 int H, int nc, int n, int rows, int dirs, cudaStream_t st) {
  if ((n / rows) % 4 == 0)
    chunk_carry<float4><<<dim3(cdiv(n, 4 * kScanThreads), dirs * H, B),
                          kScanThreads, 0, st>>>(v, g, decay, fin, H, nc, n,
                                                 rows);
  else
    chunk_carry<float><<<dim3(cdiv(n, kScanThreads), dirs * H, B),
                         kScanThreads, 0, st>>>(v, g, decay, fin, H, nc, n,
                                                rows);
  return cudaGetLastError();
}

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
