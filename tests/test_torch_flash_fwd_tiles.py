"""The flash-attention forward (B7 ``flash_fwd``, B8 ``flash_block``) of
the PyTorch port: the route and tile each head dim and dtype takes on
the card, the shared memory each tile asks for, the rule by which the
kernels skip key tiles that are all padding, and the outputs at padding
lengths that leave whole key tiles dead, at causal offsets, held against
the JAX package on the same numpy inputs.

The route and tile helpers (``fwd_route``, ``fwd_tile``, ``fwd_smem``,
``fwd_skip_dead`` in ``analytics_zoo_tpu_torch/ops/flash_attention.py``)
mirror ``Tile``, ``Cfg`` and ``skip_rule`` in
``csrc/flash_fwd_sm90.cuh``; the card tests hold the built library's own
answer (``fwd_config_on_card``) against them. Here they are pinned.

The comparisons run the port's plain versions (CPU tensors) and the
reference's Pallas kernels in interpret mode; tolerance 1e-5 of max(1,
max|ref|) in f32, as tests/test_torch_flash_attention.py holds them (the
same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

KERNELS = ("flash_fwd", "flash_block")
LIMIT = 232448      # a block's opt-in shared memory on the H100
NEG = float(np.float32(-1e30))

# (D, dtype) -> (route, (warpgroups, query rows per block, keys per tile),
# shared-memory bytes); B7 and B8 are one template
PINNED = {
    (64, "float32"): ("wgmma_tf32x3", (2, 128, 64), 181816),
    (128, "float32"): ("wgmma_tf32x3", (1, 64, 32), 181560),
    (64, "bfloat16"): ("wgmma_bf16", (1, 64, 64), 42552),
    (128, "bfloat16"): ("wgmma_bf16", (1, 64, 64), 83512),
    (32, "float32"): ("fma_f32", (0, 64, 64), 43008),
    (256, "float32"): ("fma_f32", (0, 32, 32), 103424),
    (32, "bfloat16"): ("mma_bf16", (0, 64, 64), 15616),
    (256, "bfloat16"): ("mma_bf16", (0, 64, 64), 101632),
}


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("d,dtype", sorted(PINNED))
def test_forward_route_tile_and_smem_are_pinned(name, d, dtype):
    route, tile, smem = PINNED[(d, dtype)]
    dt = getattr(torch, dtype)
    assert tfa.fwd_route(d, dt) == route
    assert tfa.fwd_tile(name, d, dt) == tile
    assert tfa.fwd_smem(name, d, dt) == smem
    assert smem <= LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_and_gpt_widths_take_the_wgmma_forward(dtype):
    # D 64 (BERT-base, GPT-1) and D 128 run the redesigned template in
    # both dtypes; f32 is never plain tf32
    dt = getattr(torch, dtype)
    for d in (64, 128):
        assert tfa.fwd_route(d, dt) == ("wgmma_bf16" if dtype == "bfloat16"
                                        else "wgmma_tf32x3")
    for d in (32, 256):
        assert not tfa.fwd_route(d, dt).startswith("wgmma")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_tiles_divide_every_feasible_length(name, d, dtype):
    # the kernels take Tq, Tk multiples of 128 (``supports``): a block
    # owns whole query tiles and walks whole key tiles
    wgs, rows, keys = tfa.fwd_tile(name, d, getattr(torch, dtype))
    assert wgs in (0, 1, 2) and rows in (32, 64, 128)
    assert keys in (32, 64, 128)
    assert not wgs or rows == 64 * wgs
    for t in (128, 256, 384, 512, 2048):
        assert tfa._feasible(t, t, d)
        assert t % rows == 0 and t % keys == 0


def test_fwd_tile_refuses_other_kernels():
    with pytest.raises(ValueError, match="no forward kernel"):
        tfa.fwd_tile("flash_bwd_dq", 64, torch.float32)


# -- the dead-tile skip rule --------------------------------------------------

# (first live key, Tk, block's first query row, offset, causal) -> skip
SKIP = [
    ((0, 512, 0, 0, False), True),       # tail padding: every row sees key 0
    ((512, 512, 0, 0, False), False),    # a sample of length 0
    ((300, 512, 0, 0, False), True),     # head padding, no causal mask
    ((0, 512, 0, 0, True), True),        # causal, row 0 sees key 0
    ((100, 512, 0, 0, True), False),     # rows 0..99 see only padding
    ((100, 512, 128, 0, True), True),    # this block's row 128 sees key 100
    ((100, 512, 64, 36, True), True),    # 64 + 36 = 100: just visible
    ((100, 512, 64, 35, True), False),   # one short
    ((0, 256, 0, -128, True), False),    # B8 at offset -128: row 0 sees none
    ((0, 256, 128, -128, True), True),
    ((5, 256, 0, 300, True), True),      # offset past Tk
]


@pytest.mark.parametrize("args,want", SKIP)
def test_skip_rule_is_pinned(args, want):
    assert tfa.fwd_skip_dead(*args) is want


def _lens_mask(lens, tk):
    km = np.zeros((len(lens), tk), np.float32)
    for i, n in enumerate(lens):
        km[i, :n] = 1.0
    return km


@pytest.mark.parametrize("causal,off,rows", [(False, 0, 128),
                                             (True, 0, 64),
                                             (True, 64, 64),
                                             (True, -64, 64)])
def test_skipped_tiles_add_nothing_and_kept_ones_do(causal, off, rows):
    # where the rule skips a dead key tile for a block of query rows, the
    # plain version's p over that tile is exactly 0 on every row of the
    # block and m is a real logit; where it refuses, it is because a row
    # of the block would average padding keys (p > 0 there), or the row
    # sees no key at all
    rs = np.random.RandomState(3)
    tq, tk, d, keys = 128, 256, 32, 64
    lens = (0, 1, 63, 64, 65, 129, 256)
    km = _lens_mask(lens, tk)
    q, k, v = [torch.tensor(rs.randn(len(lens), t, 1, d).astype(np.float32))
               for t in (tq, tk, tk)]
    s, vis, _ = tfa._logits(q, k, torch.tensor(km), causal, d ** -0.5, off)
    _, m, _ = tfa.flash_block_ref(q, k, v, torch.tensor(km), causal,
                                  d ** -0.5, off)
    p = torch.exp(s - m[..., None])
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    refused = 0
    for i, n in enumerate(lens):
        first = int(np.argmax(km[i] > 0)) if n else tk
        for q0 in range(0, tq, rows):
            blk = slice(q0, q0 + rows)
            for k0 in range(0, tk, keys):
                if km[i, k0:k0 + keys].any():
                    continue                    # a live tile always runs
                if tfa.fwd_skip_dead(first, tk, q0, off, causal):
                    assert float(p[i, 0, blk, k0:k0 + keys].abs().max()) \
                        == 0.0
                    assert bool((m[i, 0, blk] > NEG).all())
                else:
                    refused += 1
                    mb = m[i, 0, blk]
                    assert bool((mb == NEG).any())
    assert refused > 0


# -- outputs against the reference -------------------------------------------

def _close(got, want, what, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _inputs(lens, tq, tk, h, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v = [(rs.randn(len(lens), t, h, d) * 0.5).astype(np.float32)
               for t in (tq, tk, tk)]
    w = rs.randn(len(lens), tq, h, d).astype(np.float32)
    return q, k, v, w, _lens_mask(lens, tk)


@pytest.mark.parametrize("tq,tk,causal,lens", [
    # a sample of length 0 averages its keys uniformly
    (128, 128, False, (0, 1, 63, 64, 65, 128)),
    (128, 256, False, (0, 1, 63, 64, 65, 129, 256)),
    # causal with tail padding: every row sees its first key
    (128, 128, True, (1, 63, 64, 65, 128)),
    (256, 256, True, (1, 64, 65, 129, 256)),
    (128, 256, True, (1, 63, 129, 256)),
])
@pytest.mark.parametrize("grad", [False, True])
def test_flash_attention_at_dead_key_tiles_matches_jax(monkeypatch, tq, tk,
                                                       causal, lens, grad):
    # without grad B7's plain version runs, under grad B8's (then B9, B10)
    q, k, v, w, km = _inputs(lens, tq, tk, 2, 64, seed=31)
    jargs = [jnp.asarray(a) for a in (q, k, v)]

    def jflash(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal,
                                   key_mask=jnp.asarray(km))
    calls = []
    for name in ("_flash_fwd", "_block_partials"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    ts = [torch.tensor(a).requires_grad_(grad) for a in (q, k, v)]
    with torch.set_grad_enabled(grad):
        tout = tfa.flash_attention(*ts, causal=causal,
                                   key_mask=torch.tensor(km))
    assert calls == (["_block_partials"] if grad else ["_flash_fwd"])
    _close(tout, jflash(*jargs), "out")
    if grad:
        (tout * torch.tensor(w)).sum().backward()
        jgrads = jax.grad(lambda *a: jnp.sum(jflash(*a) * jnp.asarray(w)),
                          argnums=(0, 1, 2))(*jargs)
        for name, t, jg in zip("qkv", ts, jgrads):
            _close(t.grad, jg, f"d{name}")


@pytest.mark.parametrize("offset", [-128, -1, 0, 5, 256, 300])
def test_flash_block_partial_at_offsets_matches_jax(offset):
    # B8 at a runtime q-k offset: negative (rows that see no key), inside,
    # or past Tk (every row sees every key); a row that sees no key gives
    # acc 0, m = -1e30 and l = 0 whatever the tiling, where the
    # reference's value depends on its block size (compared elsewhere)
    q, k, v, _, _ = _inputs((1, 1), 128, 256, 2, 64, seed=32)
    scale = 64 ** -0.5
    jacc, jm, jl = jfa.flash_block_partial(
        *[jnp.asarray(a) for a in (q, k, v)], offset, True, scale)
    tacc, tm, tl = tfa.flash_block_partial(
        *[torch.tensor(a) for a in (q, k, v)], offset, True, scale)
    dead = max(0, -offset)      # rows i with i + offset < 0
    assert float(tacc[:, :dead].abs().max() if dead else 0.0) == 0.0
    assert bool((tm[..., :dead] == NEG).all())
    assert float(tl[..., :dead].abs().max() if dead else 0.0) == 0.0
    if dead < 128:
        live = slice(dead, None)
        _close(tacc[:, live], np.asarray(jacc)[:, live], "acc")
        _close(tm[..., live], np.asarray(jm)[..., live], "m")
        _close(tl[..., live], np.asarray(jl)[..., live], "l")


# -- the float64 plain versions ----------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_in_float64_keeps_the_semantics(causal):
    # compute=float64 (the f32 kernels' accuracy reference) runs every
    # step in float64 and returns float64: within 1e-6 of the f32 plain
    # version, a sample of all padding still averaging, and a row that
    # sees no key (causal, Tq > Tk) keeping m at the f32 -1e30 exactly
    g = torch.Generator().manual_seed(33)
    q = torch.randn(3, 256, 2, 32, generator=g) * 0.5
    k, v = [torch.randn(3, 128, 2, 32, generator=g) * 0.5 for _ in range(2)]
    km = torch.ones(3, 128)
    km[1, 40:] = 0
    km[2] = 0
    scale = 32 ** -0.5
    off = 128 - 256
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        plain = tfa.flash_block_ref(qd, kd, vd, km, causal, scale, off)
        exact = tfa.flash_block_ref(qd, kd, vd, km, causal, scale, off,
                                    compute=torch.float64)
        o32 = tfa.flash_fwd_ref(qd, kd, vd, km, causal, scale)
        o64 = tfa.flash_fwd_ref(qd, kd, vd, km, causal, scale,
                                compute=torch.float64)
        assert o32.dtype == dt and o64.dtype == torch.float64
        for p_, e_ in zip(plain + (o32,), exact + (o64,)):
            assert e_.dtype == torch.float64 and p_.dtype != torch.float64
            dead = e_ == NEG
            assert torch.equal(p_.double() == NEG, dead)
            live = ~dead
            tol = 1e-6 if dt == torch.float32 else 2e-2
            scale_ = max(1.0, e_[live].abs().max().item())
            assert (p_.double()[live] - e_[live]).abs().max().item() <= \
                tol * scale_
        m64 = exact[1]
        if causal:   # rows 0..127 see no key: m exactly the f32 -1e30
            assert bool((m64[:, :, :128] == NEG).all())
            assert float(exact[2][:, :, :128].abs().max()) == 0.0
        else:        # the all-padding sample averages: m -1e30, l = Tk
            assert bool((m64[2] == NEG).all())
            assert bool((exact[2][2] == 128).all())
