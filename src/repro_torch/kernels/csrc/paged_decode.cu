// Hand-written Hopper (sm_90a) kernels of the paged decode step.
//
//   decode_ring (bf16 queries on bf16 or int8 pages at head_dim 64, 80 or
//   128: tensor cores, a cp.async ring per warp, one launch) or
//   decode_split + decode_merge (CUDA cores: f32 queries, other head dims)
//   over PagedRows (all in decode_common.cuh, shared with the dense K2 of
//   dense_decode.cu)
//       replace the Pallas split-KV paged flash-decode
//       `paged_decode_attention` / `_paged_kernel`
//       (src/repro/kernels/decode_attention.py), and, given the step's
//       new token and its slots, the paged KV append before it (the
//       reference's write-then-attend, src/repro/models/layers.py): one
//       launch writes the token into the arena and attends it with the
//       cached positions, so the serving path launches no append.
//   kv_append
//       replaces the paged KV append `update_kv_buffer`
//       (src/repro/kernels/ops.py, a scatter with mode="drop") where it is
//       called alone.
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry points at the bottom have a plain C
// interface, take raw device pointers and PyTorch's current stream, launch,
// and return cudaGetLastError(). They allocate nothing and never synchronise.
//
// The decode kernels are bound by bytes and, on short rows, by latency;
// decode_common.cuh says how their design moves each byte once and keeps
// the loads in flight.

#include "decode_common.cuh"

namespace {

// One CTA per batch row: copy the row's K and V into its flat arena slot,
// or drop the row when the slot is outside [0, n_slots).
template <typename U>
__global__ void kv_append(U* __restrict__ kp, U* __restrict__ vp,
                          const U* __restrict__ kn, const U* __restrict__ vn,
                          const int* __restrict__ slots, long long n_slots,
                          int row) {
  const int b = blockIdx.x;
  const long long s = slots[b];
  if (s < 0 || s >= n_slots) return;
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    kp[s * row + i] = kn[(size_t)b * row + i];
    vp[s * row + i] = vn[(size_t)b * row + i];
  }
}

template <typename U>
cudaError_t launch_append(void* kp, void* vp, const void* kn, const void* vn,
                          const int* slots, int B, long long n_slots,
                          long long row_bytes, cudaStream_t stream) {
  const int row = (int)(row_bytes / sizeof(U));
  const int threads = row < 256 ? ((row + 31) / 32) * 32 : 256;
  kv_append<U><<<B, threads, 0, stream>>>(
      static_cast<U*>(kp), static_cast<U*>(vp), static_cast<const U*>(kn),
      static_cast<const U*>(vn), slots, n_slots, row);
  return cudaGetLastError();
}

bool aligned(const void* p, long long unit) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)unit == 0;
}

}  // namespace

extern "C" {

const char* genesys_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B,H,hd] (q_dtype); k/v pages [NB,BS,KV,hd] (kv_dtype); block_tables
// [B,MB] int32; lens [B] int32, the cached positions to attend; k_new /
// v_new [B,KV,hd] (q_dtype) and slots [B] int32, or all three null: the
// step's new token, written at its flat slot of the arena's n_slots = NB *
// BS (dropped outside [0, n_slots)) and attended as the arena stores it
// beside positions [0, lens[b]), which must not hold the slot; out
// [B,H,hd] (q_dtype); part_o
// [B,H,NS,hd] f32 and part_ml [B,H,NS,2] f32 scratch for NS split slots;
// tickets [B*KV] int32, all 0 (the ring kernel leaves them 0).
// variant: kRing (bf16 q, hd 64/80/128; split_tokens is the shortest split, a
// multiple of 64, grid_x == NS <= 64, and target the splits to aim a call
// at) or kCudaCore (split_tokens a multiple of BS, NS * split_tokens >=
// MB * BS, grid_x CTAs per (row, KV head) striding over the splits).
// kv_scale multiplies every K/V element (1/QSCALE for int8 pages).
int paged_decode_attention_launch(const void* q, void* k_pages, void* v_pages,
                                  const int* block_tables, const int* lens,
                                  const void* k_new, const void* v_new,
                                  const int* slots, long long n_slots,
                                  void* out, float* part_o, float* part_ml,
                                  int* tickets, int B, int H, int KV, int hd,
                                  int BS, int MB, int variant,
                                  int split_tokens, int NS, int grid_x,
                                  int target, float scale, float kv_scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  if (MB <= 0 || (long long)MB * BS >= (1LL << 31) ||
      (k_new == nullptr) != (slots == nullptr) ||
      !decode_args_ok(B, H, KV, hd, BS, variant, split_tokens, NS, MB * BS,
                      grid_x, target, k_pages, v_pages, k_new, v_new, slots,
                      n_slots))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedRows rows{block_tables, MB, BS, MB * BS,
                       (BS & (BS - 1)) == 0 ? __builtin_ctz(BS) : -1};
#define GENESYS_DECODE(QT, KT)                                               \
  return launch_decode<QT, KT, PagedRows>(                                   \
      q, k_pages, v_pages, rows, lens, k_new, v_new, slots, n_slots, out,    \
      part_o, part_ml, tickets, B, H, KV, hd, variant, split_tokens, NS,     \
      grid_x, target, scale, kv_scale, st)
  if (q_dtype == kF32 && kv_dtype == kF32) GENESYS_DECODE(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    GENESYS_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) GENESYS_DECODE(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) GENESYS_DECODE(__nv_bfloat16, int8_t);
#undef GENESYS_DECODE
  return cudaErrorInvalidValue;
}

// k/v pages: n_slots rows of row_bytes each (the flat [NB*BS] view of one
// layer's arena); k_new/v_new [B] rows of row_bytes; slots [B] int32.
int kv_append_launch(void* k_pages, void* v_pages, const void* k_new,
                     const void* v_new, const int* slots, int B,
                     long long n_slots, long long row_bytes, void* stream) {
  if (B <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // widest copy unit that divides the row and every pointer
  for (long long unit = 16; unit > 1; unit >>= 1) {
    if (row_bytes % unit || !aligned(k_pages, unit) ||
        !aligned(v_pages, unit) || !aligned(k_new, unit) ||
        !aligned(v_new, unit))
      continue;
    if (unit == 16)
      return launch_append<uint4>(k_pages, v_pages, k_new, v_new, slots, B,
                                  n_slots, row_bytes, st);
    if (unit == 8)
      return launch_append<uint2>(k_pages, v_pages, k_new, v_new, slots, B,
                                  n_slots, row_bytes, st);
    if (unit == 4)
      return launch_append<uint32_t>(k_pages, v_pages, k_new, v_new, slots, B,
                                     n_slots, row_bytes, st);
    return launch_append<uint16_t>(k_pages, v_pages, k_new, v_new, slots, B,
                                   n_slots, row_bytes, st);
  }
  return launch_append<uint8_t>(k_pages, v_pages, k_new, v_new, slots, B,
                                n_slots, row_bytes, st);
}

#ifdef GENESYS_DECODE_STAMPS
// The merge stamps of the last call (decode_common.cuh): n words of
// decode_stamps into host memory dst.
int decode_stamps_read(void* dst, int n) {
  if (n < 0 || n > kStampPairs * kStamps) return cudaErrorInvalidValue;
  return cudaMemcpyFromSymbol(dst, decode_stamps,
                              (size_t)n * sizeof(unsigned long long));
}
#endif

}  // extern "C"
