// C entry point of the flash-attention backward's dQ (B10): writes
// dq (B, Tq, H, D) in q's type
// (`flash_bwd_dq` in analytics_zoo_tpu_torch/ops/flash_attention.py),
// from flash_bwd_sm90.cuh (D 64, 128) or flash_attn_bwd.cuh (D 32,
// 256). m, l and delta are (B, H, Tq) f32; strides in elements; `off`
// the causal offset.

#include "flash_bwd_sm90.cuh"

extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kmask, const void* m, const void* l, const void* delta,
    void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long do_sb, long long do_st,
    int causal, int off, float scale, int bf16, void* stream) {
  const zoo::flash::BwdArgs a = zoo::flash::make_bwd_args(
      q, k, v, dout, kmask, m, l, delta, dq, dk, dv, B, H, Tq, Tk, q_sb,
      q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, causal, off, scale);
  return zoo::fbwd::launch<false>(a, D, bf16,
                                  static_cast<cudaStream_t>(stream));
}

// The tile an instance runs (`bwd_tile` in ops/flash_attention.py): out
// = {1 on the wgmma route else 0, warpgroups, rows per walked tile,
// shared-memory bytes}; returns 0, or an error for a D it does not take.
extern "C" int flash_bwd_dq_config(int D, int bf16, int* out) {
  return zoo::fbwd::config<false>(D, bf16, out);
}
