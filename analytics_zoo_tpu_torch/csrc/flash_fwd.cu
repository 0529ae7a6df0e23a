// C entry point of the flash-attention forward without grad (`flash_fwd`
// in analytics_zoo_tpu_torch/ops/flash_attention.py, B7): the normalised
// instance of flash_fwd_sm90.cuh (D 64, 128) or flash_attn_fwd.cuh (D 32,
// 256). Writes o (B, Tq, H, D) in q's type; kmask (B, Tk) f32 or null;
// strides in elements; causal offset Tk - Tq.

#include "flash_fwd_sm90.cuh"

extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, const void* kmask,
    void* o, int B, int H, int Tq, int Tk, int D, long long q_sb,
    long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, int causal, int off, float scale, int bf16,
    void* stream) {
  const zoo::flash::FwdArgs a = zoo::flash::make_fwd_args(
      q, k, v, kmask, o, nullptr, nullptr, B, H, Tq, Tk, q_sb, q_st, k_sb,
      k_st, v_sb, v_st, causal, off, scale);
  return zoo::ffwd::launch<false>(a, D, bf16,
                                  static_cast<cudaStream_t>(stream));
}

// The tile an instance runs (`fwd_tile` in ops/flash_attention.py): out
// = {1 on the wgmma route else 0, consumer warpgroups, query rows per
// block, keys per tile, shared-memory bytes}; returns 0, or an error for
// a D it does not take.
extern "C" int flash_fwd_config(int D, int bf16, int* out) {
  return zoo::ffwd::config(D, bf16, out);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(flash_fwd)
