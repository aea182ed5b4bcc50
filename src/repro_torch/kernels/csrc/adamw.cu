// Hand-written kernels of the optimizer's step: AdamW with global-norm
// clipping over a table of f32 leaves, updated in place.
//
//   adamw_sqnorm_partial + adamw_sqnorm_final   the global norm of the
//       gradients (each divided by the microbatches), into a device scalar
//   adamw_update_leaves + adamw_count           p, m and v of every leaf,
//       then the step count
//
// They replace no Pallas kernel: they stand for the reference's update
// under jit (`AdamW.update`, src/repro/optim/adamw.py), which XLA fuses into
// one pass a leaf. In eager PyTorch the same update is ~14 passes a leaf
// (~128 bytes a parameter).
//
// What bounds them on an H100 SXM (data sheet): bytes. The norm reads g
// (4 bytes a parameter); the update reads g, m, v and p and writes m, v and
// p (28 bytes): 32 bytes a parameter, 70 GB a step at starcoder2-7b's 2.19 B
// parameters, 21 ms at 3.35 TB/s. In the time a parameter's 28 bytes take
// the card issues ~280 instructions a thread, against a few tens for the
// update (four IEEE divisions and a square root); the norm's 4 bytes leave
// ~35, for one IEEE division and a fused multiply-add. So the design is to
// move each byte once:
//   * One persistent launch a pass, grid-stride over the whole table: every
//     block walks every leaf, thread t taking the 16-byte vectors t, t +
//     stride, ... (four in flight a thread in the norm), and a scalar tail
//     for a leaf whose length is not a multiple of 4. Small leaves (norm
//     weights) cost a loop trip, and the large ones spread over every SM.
//   * The table travels by value as a kernel parameter (64 leaves, 2.6 KB,
//     inside the 4 KB that every toolkit takes); a longer table is cut into
//     launches of 64. No host-to-device copy, so the host never waits on the
//     stream inside the step, and nothing is allocated but `blocks` partial
//     sums of the norm.
//   * Scalars stay on the device: the update reads the norm and the count
//     there and forms the clip scale and the bias corrections itself; a
//     one-thread launch after it adds 1 to the count.
//   * Determinism: each block sums its squares in a fixed order (its
//     threads' sums, then warp shuffles, then the warps in order), and one
//     block adds the partials in index order. No atomics: two calls give the
//     same bits on one card.
//   * The element's arithmetic is the eager update's, rounding by rounding
//     (IEEE division and square root, named roundings, no fast math):
//       g = g / divisor * scale
//       m = b1 m + (1 - b1) g             mul, then fma (add_ with alpha)
//       v = b2 v + (1 - b2) g g           mul, then fma (addcmul_)
//       d = m / (sqrt(v / c2) + eps) / c1 + wd p
//       p = p - lr d
//     with c = count + 1, c1 = 1 - b1^c, c2 = 1 - b2^c and scale = min(1,
//     clip / max(gnorm, 1e-9)) (NaN passes through, as torch.clamp's).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;   // the wrapper's BLOCKS_PER_SM
constexpr int kFinalThreads = 1024;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int count;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd, neg_lr, clip;
};

// The sum of x over the block, in a fixed order; valid in thread 0.
__device__ float block_sum(float x) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
  return total;
}

__device__ __forceinline__ float sq_add(float acc, float g, float divisor) {
  const float x = __fdiv_rn(g, divisor);
  return __fmaf_rn(x, x, acc);
}

__device__ __forceinline__ float sq4_add(float acc, float4 g, float divisor) {
  acc = sq_add(acc, g.x, divisor);
  acc = sq_add(acc, g.y, divisor);
  acc = sq_add(acc, g.z, divisor);
  return sq_add(acc, g.w, divisor);
}

// partials[blockIdx.x] = (accumulate ? partials[blockIdx.x] : 0) + the
// block's sum of (g / divisor)^2 over the table.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
adamw_sqnorm_partial(const LeafTable t, float divisor, int accumulate,
                     float* __restrict__ partials) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (int l = 0; l < t.count; ++l) {
    const float* g = t.leaf[l].g;
    const long long n = t.leaf[l].n, n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    long long i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const float4 a = g4[i], b = g4[i + stride], c = g4[i + 2 * stride],
                   d = g4[i + 3 * stride];
      acc = sq4_add(acc, a, divisor);
      acc = sq4_add(acc, b, divisor);
      acc = sq4_add(acc, c, divisor);
      acc = sq4_add(acc, d, divisor);
    }
    for (; i < n4; i += stride) acc = sq4_add(acc, g4[i], divisor);
    for (long long j = 4 * n4 + tid; j < n; j += stride)
      acc = sq_add(acc, g[j], divisor);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0)
    partials[blockIdx.x] = accumulate ? partials[blockIdx.x] + total : total;
}

// gnorm = sqrt of the partials' sum, added in index order.
__global__ void __launch_bounds__(kFinalThreads)
adamw_sqnorm_final(const float* __restrict__ partials, int n,
                   float* __restrict__ gnorm) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) *gnorm = __fsqrt_rn(total);
}

__device__ __forceinline__ void adamw_element(float g, float& m, float& v,
                                              float& p, const Hyper& h,
                                              float divisor, float scale,
                                              float c1, float c2) {
  g = __fmul_rn(__fdiv_rn(g, divisor), scale);
  m = __fmaf_rn(h.one_minus_b1, g, __fmul_rn(h.b1, m));
  v = __fmaf_rn(__fmul_rn(h.one_minus_b2, g), g, __fmul_rn(h.b2, v));
  const float s = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps);
  const float d = __fmaf_rn(h.wd, p, __fdiv_rn(__fdiv_rn(m, s), c1));
  p = __fmaf_rn(h.neg_lr, d, p);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
adamw_update_leaves(const LeafTable t, const Hyper h, float divisor,
                    const float* __restrict__ gnorm,
                    const int* __restrict__ count) {
  const float c = (float)(*count + 1);
  const float c1 = 1.f - powf(h.b1, c), c2 = 1.f - powf(h.b2, c);
  const float gn = *gnorm;
  const float clamped = gn < 1e-9f ? 1e-9f : gn;   // NaN stays NaN
  const float r = __fdiv_rn(h.clip, clamped);
  const float scale = r > 1.f ? 1.f : r;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < t.count; ++l) {
    const Leaf L = t.leaf[l];
    const long long n4 = L.n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(L.g);
    float4* m4 = reinterpret_cast<float4*>(L.m);
    float4* v4 = reinterpret_cast<float4*>(L.v);
    float4* p4 = reinterpret_cast<float4*>(L.p);
    for (long long i = tid; i < n4; i += stride) {
      const float4 g = g4[i];
      float4 m = m4[i], v = v4[i], p = p4[i];
      adamw_element(g.x, m.x, v.x, p.x, h, divisor, scale, c1, c2);
      adamw_element(g.y, m.y, v.y, p.y, h, divisor, scale, c1, c2);
      adamw_element(g.z, m.z, v.z, p.z, h, divisor, scale, c1, c2);
      adamw_element(g.w, m.w, v.w, p.w, h, divisor, scale, c1, c2);
      m4[i] = m;
      v4[i] = v;
      p4[i] = p;
    }
    for (long long j = 4 * n4 + tid; j < L.n; j += stride)
      adamw_element(L.g[j], L.m[j], L.v[j], L.p[j], h, divisor, scale, c1,
                    c2);
  }
}

__global__ void adamw_count(int* count) { *count += 1; }

}  // namespace

extern "C" {

// The global norm of the f32 gradients g[0..leaves) (n[i] elements each,
// 16-byte aligned), each element divided by `divisor`: `blocks` partial
// sums into partials[0..blocks), then their sum's square root into *gnorm.
int adamw_sqnorm_launch(void* const* g, const long long* n, int leaves,
                        float divisor, float* partials, int blocks,
                        float* gnorm, void* stream) {
  if (leaves < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < leaves; first += kMaxLeaves) {
    LeafTable t = {};
    t.count = leaves - first < kMaxLeaves ? leaves - first : kMaxLeaves;
    for (int i = 0; i < t.count; ++i) {
      t.leaf[i].g = static_cast<const float*>(g[first + i]);
      t.leaf[i].n = n[first + i];
    }
    adamw_sqnorm_partial<<<blocks, kThreads, 0, st>>>(t, divisor, first > 0,
                                                      partials);
  }
  adamw_sqnorm_final<<<1, kFinalThreads, 0, st>>>(partials, blocks, gnorm);
  return cudaGetLastError();
}

// One AdamW step over the f32 leaves p, g, m, v [0..leaves) (n[i]
// elements each, 16-byte aligned), in place: the clip scale from *gnorm,
// the bias corrections from *count + 1, then *count += 1. g is only read.
int adamw_update_launch(void* const* p, void* const* g, void* const* m,
                        void* const* v, const long long* n, int leaves,
                        const float* gnorm, int* count, float b1,
                        float one_minus_b1, float b2, float one_minus_b2,
                        float eps, float wd, float neg_lr, float clip,
                        float divisor, int blocks, void* stream) {
  if (leaves < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h = {b1, one_minus_b1, b2, one_minus_b2, eps, wd, neg_lr, clip};
  for (int first = 0; first < leaves; first += kMaxLeaves) {
    LeafTable t = {};
    t.count = leaves - first < kMaxLeaves ? leaves - first : kMaxLeaves;
    for (int i = 0; i < t.count; ++i) {
      const int k = first + i;
      t.leaf[i] = {static_cast<float*>(p[k]), static_cast<const float*>(g[k]),
                   static_cast<float*>(m[k]), static_cast<float*>(v[k]), n[k]};
    }
    adamw_update_leaves<<<blocks, kThreads, 0, st>>>(t, h, divisor, gnorm,
                                                     count);
  }
  adamw_count<<<1, 1, 0, st>>>(count);
  return cudaGetLastError();
}

}  // extern "C"
