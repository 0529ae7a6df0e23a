"""The decode kernel's paged route (B11 reading the pages in place) on
the CPU, against the JAX package on the same numpy inputs.

- The paged plain route (``paged_decode_attention`` and
  ``flash_decode_paged`` on CPU tensors: ``gather_layer``, then
  ``dequantize_rows`` or the cast to q's type, then ``flash_decode_ref``)
  against the JAX package's ``gather_layer`` + ``flash_decode_attention``
  (Pallas interpret mode), through a permuted page table with an
  out-of-range id past a slot's length and in a slot with no valid key
  (both clamp), for f32, bf16 and int8 pools: within 1e-5 of max(1,
  |ref|) with an f32 query (the same products, sums in another order),
  2e-2 with a bf16 one (one bf16 rounding of p and of the output).
- The split of the context across blocks (``decode_plan``) and the
  fixed-order merge of plain partials (``decode_partials_ref`` +
  ``decode_merge``) against the one-pass plain version, at lengths on
  the chunk edges: within 1e-6 of max|ref| in f32 (a rescale by
  exp(m_c - m) per chunk).
- ``decode_step`` with ``attention_impl="flash"`` against the JAX
  ``decode_step`` from one bridged cache state, through the paged entry
  once per block and step: the tolerances of
  ``tests/test_torch_generate.py`` (1e-5 f32, 2e-2 bf16, 5e-2 int8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu.ops import kv_cache as jkv
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu_torch.bridge import (kv_cache_from_numpy,
                                            params_from_numpy)
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import kv_cache as tkv
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


# -- the paged plain route against the JAX package ---------------------------

def _paged_case(pool, seed, pages=40, page=16, s=3, pps=8, h=2, d=64):
    """Pools of ``pages`` pages, a permuted (s, pps) table with an
    out-of-range id past slot 0's length and two in slot 2, which has no
    valid key; lengths 17, the whole context, 0."""
    rs = np.random.RandomState(seed)
    kp = rs.randn(pages, page, h, d).astype(np.float32)
    vp = rs.randn(pages, page, h, d).astype(np.float32)
    table = rs.permutation(pages)[:s * pps].reshape(s, pps).astype(np.int32)
    table[0, pps - 3] = pages + 7
    table[2, 3], table[2, pps - 2] = pages + 100, -3
    lens = np.asarray([17, pps * page, 0], np.int32)
    q = rs.randn(s, h, d).astype(np.float32)
    ks = vs = None
    if pool == "int8":
        (kp, ks), (vp, vs) = [[np.array(a) for a in
                               jkv.quantize_rows(jnp.asarray(x))]
                              for x in (kp, vp)]
    return q, kp, vp, table, lens, ks, vs


@pytest.mark.parametrize("pool,qdt", [
    ("float32", "float32"), ("bfloat16", "float32"), ("int8", "float32"),
    ("bfloat16", "bfloat16"), ("int8", "bfloat16")])
def test_paged_plain_route_matches_jax_gather_and_kernel(pool, qdt):
    q, kp, vp, table, lens, ks, vs = _paged_case(pool, 0)
    t = table.shape[1] * kp.shape[1]
    scale = 0.125
    jq = jnp.asarray(q, JDT[qdt])
    jk = jkv.gather_layer(jnp.asarray(kp, JDT[pool]), jnp.asarray(table), t)
    jv = jkv.gather_layer(jnp.asarray(vp, JDT[pool]), jnp.asarray(table), t)
    jkw = {}
    if ks is None:
        jk, jv = jk.astype(jq.dtype), jv.astype(jq.dtype)
    else:
        jkw = dict(k_scales=jkv.gather_layer(jnp.asarray(ks),
                                             jnp.asarray(table), t),
                   v_scales=jkv.gather_layer(jnp.asarray(vs),
                                             jnp.asarray(table), t))
    want = jfa.flash_decode_attention(
        jq, jk, jv, jkv.length_mask(jnp.asarray(lens), t), scale,
        interpret=True, **jkw)
    tq = torch.from_numpy(q).to(TDT[qdt])
    tk, tv = [torch.from_numpy(x) if pool == "int8" else
              torch.from_numpy(x).to(TDT[pool]) for x in (kp, vp)]
    tkw = {} if ks is None else dict(k_scales=torch.from_numpy(ks),
                                     v_scales=torch.from_numpy(vs))
    args = (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lens))
    tol = 1e-5 if qdt == "float32" else 2e-2
    got = tatt.paged_decode_attention(*args, scale=scale, impl="flash",
                                      **tkw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, np.asarray(want, np.float32), tol)
    _close(tfa.flash_decode_paged(*args, scale, **tkw),
           np.asarray(want, np.float32), tol)
    # the dense route of the same entry (gather, then dense attention)
    _close(tatt.paged_decode_attention(*args, scale=scale, impl="xla", **tkw),
           np.asarray(want, np.float32), 1e-5 if qdt == "float32" else 5e-2)
    # the slot with no valid key averages every row its table names,
    # the out-of-range ids clamped into the pool
    v_rows = tkv.gather_layer(tv, torch.from_numpy(table), t)
    if ks is not None:
        v_rows = tkv.dequantize_rows(
            v_rows, tkv.gather_layer(torch.from_numpy(vs),
                                     torch.from_numpy(table), t), tq.dtype)
    _close(got[2], v_rows[2].to(tq.dtype).float().mean(0).numpy(), tol)
    assert tfa.launches["flash_decode"] == 0


def test_paged_route_refuses_what_the_kernel_does_not_take():
    q, kp, vp, table, lens, _, _ = _paged_case("float32", 1, pps=6)
    with pytest.raises(ValueError, match="divisible by 128"):
        tfa.flash_decode_paged(*(torch.from_numpy(a) for a in
                                 (q, kp, vp, table, lens)), 0.125)
    # the router sends a context the kernel does not take to dense
    got = tatt.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lens)),
        impl="flash")
    want = tatt.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lens)),
        impl="xla")
    assert torch.equal(got, want)


@pytest.mark.parametrize("short", ["table", "lens"])
def test_paged_route_refuses_a_table_or_lengths_short_of_q(short):
    # the kernel reads table[s] and seq_lens[s] for every slot of q: one
    # row short of q is an error on every device, never a read past them
    q, kp, vp, table, lens, _, _ = _paged_case("float32", 1)
    table, lens = ((table[:-1], lens) if short == "table"
                   else (table, lens[:-1]))
    with pytest.raises(ValueError, match="one row each"):
        tfa.flash_decode_paged(*(torch.from_numpy(a) for a in
                                 (q, kp, vp, table, lens)), 0.125)


# -- the split across blocks and the fixed-order merge ------------------------

def test_decode_plan_from_shapes():
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    # the generation path (8 slots, T 2048, 12 heads, D 64): 8 chunks of
    # 256 keys, 768 blocks; bf16 D 256 at S 4, H 4 fills 132 SMs
    assert tfa.decode_plan(8, 12, 2048, 64, f32) == (256, 8)
    assert tfa.decode_plan(8, 12, 2048, 64, bf16) == (256, 8)
    assert tfa.decode_plan(8, 12, 2048, 64, i8) == (256, 8)
    assert tfa.decode_plan(4, 4, 1024, 256, bf16) == (64, 16)
    assert tfa.decode_plan(4, 8, 1024, 128, bf16) == (64, 16)
    assert [tfa.decode_lanes(64, dt) for dt in (f32, bf16, i8)] == [16, 8, 4]
    assert [tfa.decode_lanes(256, dt) for dt in (f32, bf16, i8)] == \
        [32, 32, 16]
    # 8 warps of 32 // lanes key groups, 2 keys in flight each
    assert [tfa.decode_keys(64, dt) for dt in (f32, bf16, i8)] == \
        [32, 64, 128]
    assert [tfa.decode_keys(256, dt) for dt in (f32, bf16, i8)] == \
        [16, 16, 32]
    assert [tfa.decode_takes(d) for d in (32, 48, 64, 128, 256)] == \
        [True, False, True, True, True]
    for s, h, t, d, dt in [(1, 1, 128, 32, i8), (8, 12, 2048, 64, f32),
                           (2, 3, 384, 128, f32), (4, 4, 1024, 256, bf16),
                           (1, 12, 32768, 64, bf16), (64, 32, 4096, 128, i8)]:
        chunk, n = tfa.decode_plan(s, h, t, d, dt)
        keys = tfa.decode_keys(d, dt)
        assert chunk % keys == 0 and chunk % 64 == 0
        assert chunk & (chunk - 1) == 0
        assert (n - 1) * chunk < t <= n * chunk
        assert s * h * n >= tfa._DECODE_BLOCKS or chunk == max(keys, 64)


@pytest.mark.parametrize("t,chunk", [(256, 64), (384, 128), (256, 100)])
@pytest.mark.parametrize("holes", [False, True])
def test_chunk_partials_merge_in_order_match_one_pass(t, chunk, holes):
    rs = np.random.RandomState(t + chunk)
    lens = [1, chunk - 1, chunk, chunk + 1, t, 0]
    s, h, d = len(lens), 3, 32
    q, k, v = [torch.from_numpy(rs.randn(*shape).astype(np.float32))
               for shape in ((s, h, d), (s, t, h, d), (s, t, h, d))]
    km = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).float()
    if holes:       # a mask that is not a prefix (the dense entry's)
        km = km * torch.from_numpy((rs.rand(s, t) > 0.3).astype(np.float32))
        km[0, 0] = 1.0
    acc, m, l = tfa.decode_partials_ref(q, k, v, km, 0.125, chunk)
    n = -(-t // chunk)
    assert acc.shape == (s, h, n, d) and m.shape == l.shape == (s, h, n)
    # a chunk with no valid key of a slot that has one is empty
    for i in range(s):
        for c in range(n):
            empty = not bool(km[i, c * chunk:(c + 1) * chunk].any()) and \
                bool(km[i].any())
            assert bool((l[i, :, c] == 0).all()) == empty
    got = tfa.decode_merge(acc, m, l, torch.float32)
    want = tfa.flash_decode_ref(q, k, v, km, 0.125)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale
    # the slot with no valid key: the uniform average
    assert torch.allclose(got[-1], v[-1].mean(0), atol=1e-6)


# -- the decode step through the paged entry ----------------------------------

TOY = dict(n_block=2, hidden_size=128, n_head=2, vocab=61,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_decode_step_flash_paged_matches_jax(dtype, monkeypatch):
    """Two decode steps with ``attention_impl="flash"`` (head dim 64, a
    context of 128 in 16-token pages through a permuted table, one slot
    frozen for a step): the port through ``flash_decode_paged`` once per
    block and step, JAX through its decode kernel in interpret mode."""
    tzoo.init_nncontext(seed=0, device="cpu")
    try:
        jnet = jtr.TransformerLayer(seq_len=128, **TOY)     # prefill
        jflash = jtr.TransformerLayer(seq_len=128, attention_impl="flash",
                                      **TOY)
        params = jax.device_get(jnet.build(jax.random.key(0), (128,)))
        tnet = ttr.TransformerLayer(seq_len=128, attention_impl="flash",
                                    **TOY)
        tparams = params_from_numpy(params)
        rs = np.random.RandomState(5)
        c = jax.device_get(jnet.init_kv_cache(3, 128, page_size=16,
                                              dtype=JDT[dtype]))
        c = c._replace(page_table=rs.permutation(c.k_pages.shape[1]).astype(
            np.int32).reshape(c.page_table.shape))
        ids = np.zeros((3, 64), np.int32)
        plens = np.asarray([20, 5, 57], np.int32)
        for i, n in enumerate(plens):
            ids[i, :n] = rs.randint(1, 61, size=n)
        jc, jlg = jnet.prefill(params, jax.tree_util.tree_map(jnp.asarray, c),
                               jnp.asarray(ids), jnp.asarray(plens))
        tc = kv_cache_from_numpy(jax.device_get(jc))
        calls = []
        real = tfa.flash_decode_paged

        def spy(*a, **kw):
            calls.append(tuple(a[1].shape))
            return real(*a, **kw)
        monkeypatch.setattr(tfa, "flash_decode_paged", spy)
        tok = np.array(jnp.argmax(jlg, -1), np.int32)
        for i in range(2):
            active = np.asarray([True, i == 0, True])
            jc, jlg = jflash.decode_step(params, jc, jnp.asarray(tok),
                                         active=jnp.asarray(active))
            tc, tlg = tnet.decode_step(tparams, tc, torch.from_numpy(tok),
                                       active=torch.from_numpy(active))
            _close(tlg, jlg, TOL[dtype], f"step {i}")
            tok = np.array(jnp.argmax(jlg, -1), np.int32)
        assert calls == [tuple(tc.k_pages.shape[1:])] * 4
        assert tc.seq_lens.tolist() == [22, 6, 59]
    finally:
        tzoo.reset_nncontext()
