// Hand-written Hopper (sm_90a) kernel of the dense-cache decode step (K2).
//
//   decode_split (CUDA cores) or decode_split_mma (tensor cores, bf16
//   queries at head_dim 128) over DenseRows, then decode_merge (all in
//   decode_common.cuh, shared with the paged K1 of paged_decode.cu)
//       replace the Pallas dense flash-decode `decode_attention` / `_kernel`
//       (src/repro/kernels/decode_attention.py), and on the serve path the
//       XLA `decode_attention_two_part` of the carried-cache branch
//       (src/repro/models/layers.py).
//
// The cache is read in the carried layout [B, S, KV, hd] of one layer, with
// no transpose: row b's positions are contiguous from token b * S, viewed as
// pages of 64 tokens (the last one partial when S % 64 != 0). A row attends
// positions below min(lens[b], S); the optional new token (k_new, v_new
// [B, KV, hd]) enters the merge as one more partial, so the two-part softmax
// of the carried branch costs no extra pass. Unlike the Pallas grid, whose
// nk = S // block_k drops positions from nk * block_k on when S is not a
// multiple of 512, every position below S is covered.
//
// Bound: bytes, 2 * sum(min(lens, S)) * KV * hd * itemsize (see
// decode_common.cuh for how the design moves each byte once).
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry point below: raw device pointers,
// PyTorch's current stream, returns cudaGetLastError(), allocates nothing,
// never synchronises).

#include "decode_common.cuh"

extern "C" {

// q [B,H,hd] (q_dtype); k/v [B,S,KV,hd] (kv_dtype), one layer of the
// carried cache; k_new/v_new [B,KV,hd] in q_dtype, or both null; lens [B]
// int32 (positions of the cache to attend, clipped to [0, S]); out
// [B,H,hd] (q_dtype); part_o [B,H,NS,hd] f32 and part_ml [B,H,NS,2] f32
// scratch, NS = ceil(S / split_tokens) splits of split_tokens positions (a
// multiple of 64); grid_x CTAs per (row, KV head) stride over a row's
// splits. kv_scale multiplies every cached K/V element after its
// conversion to f32 (1/QSCALE for an int8 cache); the new token is not
// scaled.
int dense_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* k_new, const void* v_new,
                                  const int* lens, void* out, float* part_o,
                                  float* part_ml, int B, int H, int KV, int hd,
                                  int S, int split_tokens, int NS, int grid_x,
                                  float scale, float kv_scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  const int BS = kTileTokens;
  const int pps = split_tokens / BS;
  if (S <= 0 || split_tokens % BS != 0 || (long long)B * S >= (1LL << 31) ||
      (k_new == nullptr) != (v_new == nullptr) ||
      !decode_args_ok(B, H, KV, hd, BS, pps, NS, (S + BS - 1) / BS, grid_x, k,
                      v))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseRows rows{S, BS, S};
#define GENESYS_DECODE(QT, KT)                                              \
  return launch_decode<QT, KT, DenseRows>(q, k, v, rows, lens, k_new, v_new, \
                                          out, part_o, part_ml, B, H, KV,    \
                                          hd, pps, NS, grid_x, scale,        \
                                          kv_scale, st)
  if (q_dtype == kF32 && kv_dtype == kF32) GENESYS_DECODE(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    GENESYS_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) GENESYS_DECODE(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) GENESYS_DECODE(__nv_bfloat16, int8_t);
#undef GENESYS_DECODE
  return cudaErrorInvalidValue;
}

}  // extern "C"
