// C entry point of the flash-attention partials (`flash_block` in
// analytics_zoo_tpu_torch/ops/flash_attention.py, B8): the partial
// instance of flash_fwd_sm90.cuh (D 64, 128) or flash_attn_fwd.cuh (D 32,
// 256). Writes acc (B, Tq, H, D) f32 unnormalised and m, l (B, H, Tq)
// f32; `off` is the runtime causal offset q_start - k_start (any int).

#include "flash_fwd_sm90.cuh"

extern "C" int flash_block_launch(
    const void* q, const void* k, const void* v, const void* kmask,
    void* acc, void* m, void* l, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, int causal, int off, float scale,
    int bf16, void* stream) {
  const zoo::flash::FwdArgs a = zoo::flash::make_fwd_args(
      q, k, v, kmask, acc, m, l, B, H, Tq, Tk, q_sb, q_st, k_sb, k_st, v_sb,
      v_st, causal, off, scale);
  return zoo::ffwd::launch<true>(a, D, bf16,
                                 static_cast<cudaStream_t>(stream));
}

// The tile an instance runs (`fwd_tile` in ops/flash_attention.py), as
// flash_fwd_config.
extern "C" int flash_block_config(int D, int bf16, int* out) {
  return zoo::ffwd::config(D, bf16, out);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(flash_block)
