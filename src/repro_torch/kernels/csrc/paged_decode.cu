// Hand-written Hopper (sm_90a) kernels of the paged decode step.
//
//   decode_split (CUDA cores) or decode_split_mma (tensor cores, bf16
//   queries at head_dim 128) over PagedRows, then decode_merge (all in
//   decode_common.cuh, shared with the dense K2 of dense_decode.cu)
//       replace the Pallas split-KV paged flash-decode
//       `paged_decode_attention` / `_paged_kernel`
//       (src/repro/kernels/decode_attention.py).
//   kv_append
//       replaces the paged KV append `update_kv_buffer`
//       (src/repro/kernels/ops.py, a scatter with mode="drop").
//
// Built by src/repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry points at the bottom have a plain C
// interface, take raw device pointers and PyTorch's current stream, launch,
// and return cudaGetLastError(). They allocate nothing and never synchronise.
//
// The decode kernels are bound by bytes; decode_common.cuh says how their
// design moves each byte once.

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
// [B,MB] int32; lens [B] int32; out [B,H,hd] (q_dtype); part_o
// [B,H,NS,hd] f32 and part_ml [B,H,NS,2] f32 scratch, NS = ceil(MB / pps)
// splits; grid_x CTAs per (row, KV head) stride over a row's splits.
// kv_scale multiplies every K/V element after its conversion to f32
// (1/QSCALE for int8 pages).
int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const int* block_tables,
                                  const int* lens, void* out, float* part_o,
                                  float* part_ml, int B, int H, int KV, int hd,
                                  int BS, int MB, int pps, int NS, int grid_x,
                                  float scale, float kv_scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  if (MB <= 0 ||
      !decode_args_ok(B, H, KV, hd, BS, pps, NS, MB, grid_x, k_pages, v_pages))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedRows rows{block_tables, MB, BS, MB * BS};
#define GENESYS_DECODE(QT, KT)                                              \
  return launch_decode<QT, KT, PagedRows>(q, k_pages, v_pages, rows, lens,  \
                                          nullptr, nullptr, out, part_o,    \
                                          part_ml, B, H, KV, hd, pps, NS,   \
                                          grid_x, scale, kv_scale, st)
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

}  // extern "C"
