"""The flash-attention backward (B9 ``flash_bwd_dkdv``, B10
``flash_bwd_dq``) of the PyTorch port: the route and tile each head dim
and dtype takes on the card, the shared memory each tile asks for, and
the gradients at key-padding lengths that leave whole key tiles dead,
held against the JAX package on the same numpy inputs.

The route and tile helpers (``bwd_route``, ``bwd_tile``, ``bwd_smem`` in
``analytics_zoo_tpu_torch/ops/flash_attention.py``) mirror ``Cfg`` in
``csrc/flash_bwd_sm90.cuh``; the card tests hold the built library's
own answer (``bwd_config_on_card``) against them. Here they are pinned.

The gradient comparisons run the port's plain versions (CPU tensors)
and the reference's Pallas kernels in interpret mode; tolerance 1e-5 of
max(1, max|ref|) in f32, as tests/test_torch_flash_attention.py holds
them (the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")
LIMIT = 232448      # a block's opt-in shared memory on the H100

# (kernel, D, dtype) -> (route, (warpgroups, rows per walked tile),
# shared-memory bytes)
PINNED = {
    ("flash_bwd_dkdv", 64, "float32"): ("wgmma_tf32x3", (2, 64), 232008),
    ("flash_bwd_dkdv", 128, "float32"): ("wgmma_tf32x3", (1, 32), 231240),
    ("flash_bwd_dkdv", 64, "bfloat16"): ("wgmma_bf16", (1, 64), 51784),
    ("flash_bwd_dkdv", 128, "bfloat16"): ("wgmma_bf16", (1, 64), 100936),
    ("flash_bwd_dq", 64, "float32"): ("wgmma_tf32x3", (2, 64), 198216),
    ("flash_bwd_dq", 128, "float32"): ("wgmma_tf32x3", (1, 32), 197960),
    ("flash_bwd_dq", 64, "bfloat16"): ("wgmma_bf16", (1, 64), 50760),
    ("flash_bwd_dq", 128, "bfloat16"): ("wgmma_bf16", (1, 64), 99912),
    ("flash_bwd_dkdv", 32, "float32"): ("fma_f32", (0, 64), 68096),
    ("flash_bwd_dkdv", 256, "float32"): ("fma_f32", (0, 32), 140544),
    ("flash_bwd_dkdv", 32, "bfloat16"): ("mma_bf16", (0, 64), 21504),
    ("flash_bwd_dkdv", 256, "bfloat16"): ("mma_bf16", (0, 64), 136192),
    ("flash_bwd_dq", 32, "float32"): ("fma_f32", (0, 64), 68096),
    ("flash_bwd_dq", 256, "float32"): ("fma_f32", (0, 32), 140544),
    ("flash_bwd_dq", 32, "bfloat16"): ("mma_bf16", (0, 64), 21504),
    ("flash_bwd_dq", 256, "bfloat16"): ("mma_bf16", (0, 64), 136192),
}


@pytest.mark.parametrize("name,d,dtype", sorted(PINNED))
def test_backward_route_tile_and_smem_are_pinned(name, d, dtype):
    route, tile, smem = PINNED[(name, d, dtype)]
    dt = getattr(torch, dtype)
    assert tfa.bwd_route(d, dt) == route
    assert tfa.bwd_tile(name, d, dt) == tile
    assert tfa.bwd_smem(name, d, dt) == smem
    assert smem <= LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_and_gpt_widths_take_the_wgmma_route(dtype):
    # D 64 (BERT-base, GPT-1) and D 128 run the redesigned kernels in
    # both dtypes; f32 is never plain tf32
    dt = getattr(torch, dtype)
    for d in (64, 128):
        assert tfa.bwd_route(d, dt) == ("wgmma_bf16" if dtype == "bfloat16"
                                        else "wgmma_tf32x3")
    for d in (32, 256):
        assert not tfa.bwd_route(d, dt).startswith("wgmma")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgmma_tiles_divide_every_feasible_length(name, d, dtype):
    # the kernels take Tq, Tk multiples of 128 (``supports``): a block
    # owns 64 rows per warpgroup and walks whole tiles of the other side
    wgs, rows = tfa.bwd_tile(name, d, getattr(torch, dtype))
    assert wgs in (1, 2) and rows in (32, 64)
    assert 128 % (64 * wgs) == 0 and 128 % rows == 0
    assert tfa._feasible(128, 384, d) and not tfa._feasible(192, 128, d)


def test_bwd_tile_refuses_other_kernels():
    with pytest.raises(ValueError, match="no backward kernel"):
        tfa.bwd_tile("flash_fwd", 64, torch.float32)


def test_tensor_map_operands_never_overlap_batches():
    # the backward's tensor maps read (B, T, H D) with the operand's
    # strides: a batch stride below T times the time stride is copied
    t = torch.zeros(2, 128, 2, 64)
    overlapping = t.as_strided((2, 128, 2, 64), (64 * 128, 128, 64, 1))
    got, (sb, st) = tfa._operand("flash_bwd_dq", overlapping, overlapping,
                                 tma=True)
    assert (sb, st) == (128 * 128, 128)
    kept, strides = tfa._operand("flash_bwd_dq", overlapping, overlapping)
    assert strides == (64 * 128, 128) and kept.data_ptr() == \
        overlapping.data_ptr()
    qkv = torch.zeros(2, 128, 3 * 2 * 64)
    q = qkv[..., :128].reshape(2, 128, 2, 64)
    got, strides = tfa._operand("flash_bwd_dq", q, q, tma=True)
    assert got.data_ptr() == q.data_ptr() and strides == (128 * 384, 384)


def test_aligned_copies_only_what_is_misaligned():
    t = torch.arange(40, dtype=torch.float32)
    assert tfa._aligned(t).data_ptr() == t.data_ptr()
    off = t[1:33]
    assert off.data_ptr() % 16 != 0
    got = tfa._aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


# -- dead key tiles against the reference ------------------------------------

def _padded(lens, tq, tk, h, d, seed):
    rs = np.random.RandomState(seed)
    b = len(lens)
    q, k, v = [(rs.randn(b, t, h, d) * 0.5).astype(np.float32)
               for t in (tq, tk, tk)]
    w = rs.randn(b, tq, h, d).astype(np.float32)
    km = np.zeros((b, tk), np.float32)
    for i, n in enumerate(lens):
        km[i, :n] = 1.0
    return q, k, v, w, km


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("tq,tk,causal,lens", [
    # a sample of length 0 attends uniformly: its p feeds dV only
    (128, 128, False, (0, 1, 63, 64, 65, 128)),
    # causal with tail padding: every row sees its first key
    (128, 128, True, (1, 63, 64, 65, 128)),
    # cross lengths: whole 64-key tiles past each length are dead
    (128, 256, False, (0, 1, 63, 64, 65, 129, 256)),
])
def test_gradients_at_dead_key_tiles_match_jax(tq, tk, causal, lens):
    import jax
    q, k, v, w, km = _padded(lens, tq, tk, 1, 64, seed=11)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal,
                                  key_mask=jnp.asarray(km))
        return jnp.sum(out * jnp.asarray(w)), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *[jnp.asarray(a) for a in (q, k, v)])
    ts = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    tout = tfa.flash_attention(*ts, causal=causal,
                               key_mask=torch.tensor(km))
    (tout * torch.tensor(w)).sum().backward()
    _close(tout, jout, "out")
    for name, t, jg in zip("qkv", ts, jgrads):
        _close(t.grad, jg, f"d{name}")
    # keys past each length get no dK; a sample of length 0 still gets dV
    for i, n in enumerate(lens):
        assert float(ts[1].grad[i, n:].abs().max() if n < tk else 0.0) == 0.0
    if 0 in lens:
        assert float(ts[2].grad[lens.index(0)].abs().max()) > 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_in_float64_keeps_the_semantics(causal):
    # compute=float64 (the f32 kernels' accuracy reference) runs every
    # step in float64 and returns float64: within f32 rounding of the
    # f32 plain version, a sample of all padding still averaging (its
    # masked logit the f32 -1e30 that m holds) and bf16 inputs still
    # rounding p and ds to bf16
    g = torch.Generator().manual_seed(12)
    q, k, v, do = [torch.randn(3, 128, 2, 32, generator=g) * 0.5
                   for _ in range(4)]
    km = torch.ones(3, 128)
    km[1, 40:] = 0
    km[2] = 0
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, do))
        _, m, l = tfa.flash_block_ref(qd, kd, vd, km, causal, 32 ** -0.5, 0)
        out = tfa.flash_fwd_ref(qd, kd, vd, km, causal, 32 ** -0.5)
        delta = (dod.float() * out.float()).sum(-1).transpose(1, 2)
        args = (qd, kd, vd, dod, km, m, l, delta, causal, 32 ** -0.5, 0)
        for ref in (tfa.flash_bwd_dkdv_ref, tfa.flash_bwd_dq_ref):
            plain = ref(*args)
            exact = ref(*args, compute=torch.float64)
            plain = plain if isinstance(plain, tuple) else (plain,)
            exact = exact if isinstance(exact, tuple) else (exact,)
            for p_, e_ in zip(plain, exact):
                assert e_.dtype == torch.float64 and p_.dtype == dt
                assert bool(torch.isfinite(e_).all())
                tol = 1e-5 if dt == torch.float32 else 2e-2
                scale = max(1.0, e_.abs().max().item())
                assert (p_.double() - e_).abs().max().item() <= tol * scale
