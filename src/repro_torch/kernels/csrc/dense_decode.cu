// Hand-written Hopper (sm_90a) kernel of the dense-cache decode step (K2).
//
//   decode_ring (bf16 queries on a bf16 or int8 cache at head_dim 64, 80 or
//   128: tensor cores, a cp.async ring per warp, one launch) or
//   decode_split + decode_merge (CUDA cores: f32 queries, other head dims)
//   over DenseRows (all in decode_common.cuh, shared with the paged K1 of
//   paged_decode.cu)
//       replace the Pallas dense flash-decode `decode_attention` / `_kernel`
//       (src/repro/kernels/decode_attention.py), and on the serve path the
//       XLA `decode_attention_two_part` of the carried-cache branch
//       (src/repro/models/layers.py).
//
// The cache is read in the carried layout [B, S, KV, hd] of one layer, with
// no transpose: row b's positions are contiguous from token b * S (the
// CUDA-core kernel views them as pages of 64, the last one partial when
// S % 64 != 0). A row attends positions below min(lens[b], S); the optional
// new token (k_new, v_new [B, KV, hd]) enters the merge as one more partial,
// so the two-part softmax of the carried branch costs no extra pass, and,
// given slots, the same launch writes it into the cache (quantised where
// the cache is int8) in place of the append that followed it. Unlike
// the Pallas grid, whose nk = S // block_k drops positions from nk * block_k
// on when S is not a multiple of 512, every position below S is covered.
//
// Bound: bytes, 2 * sum(min(lens, S)) * KV * hd * itemsize, and latency on
// short rows (see decode_common.cuh for how the design meets both).
//
// Built with the other csrc/*.cu files by src/repro_torch/kernels/_build.py
// and bound through ctypes (plain C entry point below: raw device pointers,
// PyTorch's current stream, returns cudaGetLastError(), allocates nothing,
// never synchronises).

#include "decode_common.cuh"

extern "C" {

// q [B,H,hd] (q_dtype); k/v [B,S,KV,hd] (kv_dtype), one layer of the
// carried cache; k_new/v_new [B,KV,hd] in q_dtype, or both null; slots [B]
// int32 or null (only with k_new): the token's flat slot b * S +
// cache_len[b] in the layer's B * S token rows, dropped outside [0, B * S);
// lens [B] int32 (positions of the cache to attend, clipped to [0, S]; a
// row's slot is never among them); out
// [B,H,hd] (q_dtype); part_o [B,H,NS,hd] f32 and part_ml [B,H,NS,2] f32
// scratch for NS split slots; tickets [B*KV] int32, all 0 (the ring
// kernel leaves them 0). variant: kRing (bf16 q, hd 64/80/128;
// split_tokens is the shortest split, a multiple of 64, grid_x == NS <= 64,
// and target the splits to aim a call at) or kCudaCore (split_tokens a
// multiple of 64, NS * split_tokens >= S, grid_x CTAs per (row, KV head)
// striding over the splits). kv_scale multiplies every cached K/V element
// (1/QSCALE for an int8 cache); the new token is attended unscaled.
int dense_decode_attention_launch(const void* q, void* k, void* v,
                                  const void* k_new, const void* v_new,
                                  const int* slots, const int* lens,
                                  void* out, float* part_o,
                                  float* part_ml, int* tickets, int B, int H,
                                  int KV, int hd, int S, int variant,
                                  int split_tokens, int NS, int grid_x,
                                  int target, float scale, float kv_scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  if (S <= 0 || (long long)B * S >= (1LL << 31) ||
      !decode_args_ok(B, H, KV, hd, kTileTokens, variant, split_tokens, NS, S,
                      grid_x, target, k, v, k_new, v_new, slots,
                      (long long)B * S))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseRows rows{S, kTileTokens, S};
#define GENESYS_DECODE(QT, KT)                                               \
  return launch_decode<QT, KT, DenseRows>(                                   \
      q, k, v, rows, lens, k_new, v_new, slots, (long long)B * S, out,       \
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

}  // extern "C"
