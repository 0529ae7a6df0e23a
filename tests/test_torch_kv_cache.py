"""The PyTorch port's paged KV cache, sampling and decode attention
against the JAX package's, on the same numpy inputs.

The cache writes and gathers must agree bit for bit (they move values;
int8 quantization rounds half to even on both sides), including the
rows that must not be written: inactive slots, positions past a prompt
and positions past the context. ``sampling_probs`` agrees within 1e-6;
``sample_tokens`` draws from a ``torch.Generator`` (not ``jax.random``),
so its histogram over 20k draws is held within 0.025 of those
probabilities. The decode kernel's plain version (B11) and the dense
decode path agree with the JAX package's within 1e-5 of max(1, |ref|)
in f32 (sums in another order); the JAX decode kernel runs in Pallas
interpret mode, as the JAX package's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jatt
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu.ops import kv_cache as jkv
from analytics_zoo_tpu.ops import sampling as jsamp
from analytics_zoo_tpu_torch.bridge import (kv_cache_from_numpy,
                                            kv_cache_to_numpy)
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import kv_cache as tkv
from analytics_zoo_tpu_torch.ops import sampling as tsamp

P, PAGE, H, D = 12, 4, 2, 8          # pool pages, page size, heads, dim
S, PPS = 3, 4                        # slots, pages per slot (context 16)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _same(got, want, what=""):
    """Bit for bit: same dtype family, same values."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _pool(rs, dtype):
    """A pool holding random rows (int8 pools: random ints and scales),
    a permuted page table and mixed lengths."""
    pages = rs.randn(2, P, PAGE, H, D).astype(np.float32)
    table = rs.permutation(P)[:S * PPS].reshape(S, PPS).astype(np.int32)
    if dtype == "int8":
        q = rs.randint(-127, 128, size=pages.shape).astype(np.int8)
        sc = rs.rand(2, P, PAGE, H).astype(np.float32)
        return q, q.copy(), table, sc, sc.copy()
    return pages, pages[::-1].copy(), table, None, None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_append_layer_matches_jax_bit_for_bit(dtype):
    rs = np.random.RandomState(0)
    kp, vp, table, ks, vs = _pool(rs, dtype)
    # slot 1 is inactive, slot 2 is full (position 16 = the context)
    seq_lens = np.asarray([5, 3, PAGE * PPS], np.int32)
    active = np.asarray([True, False, True])
    k_new = rs.randn(S, H, D).astype(np.float32)
    v_new = rs.randn(S, H, D).astype(np.float32)
    k_new[0, 0] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.5, 0.0]  # ties
    jargs = [jnp.asarray(kp[0]), jnp.asarray(vp[0]), jnp.asarray(table),
             jnp.asarray(seq_lens), jnp.asarray(k_new), jnp.asarray(v_new)]
    targs = [torch.from_numpy(kp[0].copy()), torch.from_numpy(vp[0].copy()),
             torch.from_numpy(table), torch.from_numpy(seq_lens),
             torch.from_numpy(k_new), torch.from_numpy(v_new)]
    jkw, tkw = {}, {}
    if ks is not None:
        jkw = dict(k_scales=jnp.asarray(ks[0]), v_scales=jnp.asarray(vs[0]))
        tkw = dict(k_scales=torch.from_numpy(ks[0].copy()),
                   v_scales=torch.from_numpy(vs[0].copy()))
    want = jkv.append_layer(*jargs, active=jnp.asarray(active), **jkw)
    got = tkv.append_layer(*targs, active=torch.from_numpy(active), **tkw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    # nothing but slot 0's new row changed
    changed = np.nonzero((got[0].numpy() != kp[0]).any(axis=(-1, -2)))
    assert set(zip(*changed)) <= {(int(table[0, 1]), 1)}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("with_start", [False, True])
def test_write_prompt_layer_matches_jax_bit_for_bit(dtype, with_start):
    rs = np.random.RandomState(1)
    kp, vp, table, ks, vs = _pool(rs, dtype)
    t = 7
    k_seq = rs.randn(S, t, H, D).astype(np.float32)
    v_seq = rs.randn(S, t, H, D).astype(np.float32)
    # slot 1 untouched (length 0); slot 2 runs past the context
    prompt_lens = np.asarray([5, 0, 19], np.int32)
    start = np.asarray([2, 0, 12], np.int32) if with_start else None
    jkw = {} if start is None else {"start": jnp.asarray(start)}
    tkw = {} if start is None else {"start": torch.from_numpy(start)}
    if ks is not None:
        jkw.update(k_scales=jnp.asarray(ks[0]), v_scales=jnp.asarray(vs[0]))
        tkw.update(k_scales=torch.from_numpy(ks[0].copy()),
                   v_scales=torch.from_numpy(vs[0].copy()))
    want = jkv.write_prompt_layer(
        jnp.asarray(kp[0]), jnp.asarray(vp[0]), jnp.asarray(table),
        jnp.asarray(prompt_lens), jnp.asarray(k_seq), jnp.asarray(v_seq),
        **jkw)
    got = tkv.write_prompt_layer(
        torch.from_numpy(kp[0].copy()), torch.from_numpy(vp[0].copy()),
        torch.from_numpy(table), torch.from_numpy(prompt_lens),
        torch.from_numpy(k_seq), torch.from_numpy(v_seq), **tkw)
    for g, w in zip(got, want):
        _same(g, w)
    # slot 1's pages are untouched
    for page in table[1]:
        _same(got[0][int(page)], kp[0][int(page)])


def test_gather_layer_length_mask_and_quantize_match_jax():
    rs = np.random.RandomState(2)
    kp, _, table, _, _ = _pool(rs, "float32")
    table = table.copy()
    table[2, 3] = P + 5                  # out of the pool: clipped
    for t_max in (8, 16):
        _same(tkv.gather_layer(torch.from_numpy(kp[0]),
                               torch.from_numpy(table), t_max),
              jkv.gather_layer(jnp.asarray(kp[0]), jnp.asarray(table),
                               t_max))
    with pytest.raises(ValueError):
        tkv.gather_layer(torch.from_numpy(kp[0]), torch.from_numpy(table), 6)
    lens = np.asarray([0, 7, 16], np.int32)
    _same(tkv.length_mask(torch.from_numpy(lens), 16),
          jkv.length_mask(jnp.asarray(lens), 16))
    x = rs.randn(5, H, D).astype(np.float32) * 3
    x[0, 0] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.5, 0.0]   # half ties
    x[1, 1] = 0.0                                             # zero row
    qt, st = tkv.quantize_rows(torch.from_numpy(x))
    qj, sj = jkv.quantize_rows(jnp.asarray(x))
    _same(qt, qj)
    _same(st, sj)
    assert qt[0, 0].tolist() == [0, 2, 2, 0, -2, 127, 4, 0]
    _same(tkv.dequantize_rows(qt, st), jkv.dequantize_rows(qj, sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_init_cache_and_bridge_round_trip(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}[dtype]
    tdt = getattr(torch, dtype)
    want = jax.device_get(jkv.init_cache(2, 3, 30, H, D, page_size=8,
                                         dtype=jdt))
    got = tkv.init_cache(2, 3, 30, H, D, page_size=8, dtype=tdt)
    assert got.max_context == want.max_context == 32
    assert got.max_slots == 3 and got.page_size == 8
    assert got.quantized == (dtype == "int8")
    back = kv_cache_to_numpy(got)
    for f in ("k_pages", "page_table", "seq_lens", "k_scales"):
        if getattr(want, f) is None:
            assert back[f] is None
        else:
            _same(back[f], np.asarray(getattr(want, f), back[f].dtype))
    # a filled JAX cache crosses both ways unchanged
    rs = np.random.RandomState(3)
    filled = want._replace(
        k_pages=np.asarray(rs.randn(*want.k_pages.shape), want.k_pages.dtype),
        seq_lens=np.asarray([3, 0, 9], np.int32))
    port = kv_cache_from_numpy(filled)
    assert port.k_pages.dtype == tdt
    _same(kv_cache_to_numpy(port)["k_pages"],
          np.asarray(filled.k_pages, np.float32 if dtype == "bfloat16"
                     else filled.k_pages.dtype))
    _same(port.seq_lens, filled.seq_lens)


def test_page_allocator_matches_reference_order():
    ja, ta = jkv.PageAllocator(6), tkv.PageAllocator(6)
    assert ta.alloc(2) == ja.alloc(2) == [0, 1]
    ta.free([0]), ja.free([0])
    assert ta.alloc(3) == ja.alloc(3)
    assert ta.free_pages == ja.free_pages == 2
    assert not ta.can_alloc(3)
    with pytest.raises(MemoryError):
        ta.alloc(3)
    with pytest.raises(ValueError):
        ta.free([6])
    assert tkv.PageAllocator.pages_needed(17, 8) == 3


# -- sampling -----------------------------------------------------------------

def _logits(rs, s=4, v=11):
    lg = rs.randn(s, v).astype(np.float32) * 2
    lg[-1, 3] = lg[-1].max() + 1.0         # a clear argmax
    return lg


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampling_probs_match_jax(top_k):
    rs = np.random.RandomState(5)
    lg = _logits(rs)
    temp = np.asarray([0.7, 0.0, 1.3, -1.0], np.float32)
    got = tsamp.sampling_probs(torch.from_numpy(lg), torch.from_numpy(temp),
                               top_k)
    want = jsamp.sampling_probs(jnp.asarray(lg), jnp.asarray(temp), top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # greedy slots get a one-hot at the argmax
    assert got[1].tolist() == np.eye(11)[np.argmax(lg[1])].tolist()
    assert got[3].tolist() == np.eye(11)[np.argmax(lg[3])].tolist()


@pytest.mark.parametrize("top_k", [0, 4])
def test_sample_tokens_histogram_matches_probs(top_k):
    rs = np.random.RandomState(6)
    row = _logits(rs, s=1, v=9)[0]
    n = 20000
    lg = torch.from_numpy(np.tile(row, (n, 1)))
    temp = np.full((n,), 0.8, np.float32)
    toks = tsamp.sample_tokens(123, lg, temp, top_k)
    assert toks.dtype == torch.int32 and toks.shape == (n,)
    hist = np.bincount(toks.numpy(), minlength=9) / n
    p = np.asarray(jsamp.sampling_probs(jnp.asarray(row[None]),
                                        jnp.asarray([0.8]), top_k))[0]
    np.testing.assert_allclose(hist, p, atol=0.025)
    if top_k:
        assert (hist[p == 0] == 0).all()
    # the same seed gives the same stream, another seed another one
    again = tsamp.sample_tokens(123, lg, temp, top_k)
    assert torch.equal(again, toks)
    assert not torch.equal(tsamp.sample_tokens(124, lg, temp, top_k), toks)


def test_sample_tokens_greedy_slots_take_the_argmax():
    rs = np.random.RandomState(7)
    lg = _logits(rs)
    want = np.asarray(jsamp.sample_tokens(jax.random.key(0),
                                          jnp.asarray(lg), 0.0))
    for temp in (0.0, np.zeros(4, np.float32), torch.zeros(4)):
        got = tsamp.sample_tokens(0, torch.from_numpy(lg), temp)
        _same(got, want.astype(np.int32))
    mixed = tsamp.sample_tokens(3, torch.from_numpy(lg),
                                np.asarray([0.0, 1.0, 0.0, 1.0], np.float32))
    assert mixed[0] == want[0] and mixed[2] == want[2]


# -- decode attention: B11's plain version and the dense path -----------------

def _decode_inputs(seed, s=3, t=128, h=2, d=64, lens=(17, 128, 1)):
    rs = np.random.RandomState(seed)
    q = rs.randn(s, h, d).astype(np.float32)
    k = rs.randn(s, t, h, d).astype(np.float32)
    v = rs.randn(s, t, h, d).astype(np.float32)
    seq_lens = np.asarray(lens, np.int32)
    key_mask = (np.arange(t)[None, :] < seq_lens[:, None]).astype(np.float32)
    return q, k, v, seq_lens, key_mask


@pytest.mark.parametrize("lens", [(17, 128, 1), (0, 5, 128)])
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_plain_matches_jax_kernel(lens, int8):
    """B11's plain version against the JAX kernel in interpret mode;
    (0, ...) is a slot with no valid key (a uniform average)."""
    q, k, v, _, km = _decode_inputs(3, lens=lens)
    scale = 1.0 / 8.0
    jkw, tkw = {}, {}
    if int8:
        kq, ksc = jkv.quantize_rows(jnp.asarray(k))
        vq, vsc = jkv.quantize_rows(jnp.asarray(v))
        k, v = np.array(kq), np.array(vq)
        jkw = dict(k_scales=ksc, v_scales=vsc)
        tkw = dict(k_scales=torch.from_numpy(np.array(ksc)),
                   v_scales=torch.from_numpy(np.array(vsc)))
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(km), scale,
                                      interpret=True, **jkw)
    got = tfa.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(km), scale, **tkw)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    if lens[0] == 0:
        dense_v = torch.from_numpy(v).float() if not int8 else \
            tkv.dequantize_rows(torch.from_numpy(v), tkw["v_scales"])
        _close(got[0], dense_v[0].mean(0), 1e-5)
    # no kernel ran: CPU tensors take the plain version
    assert tfa.launches["flash_decode"] == 0


def test_flash_decode_refuses_what_the_kernel_does_not_take():
    q, k, v, _, km = _decode_inputs(4, t=96, lens=(5, 6, 7))
    with pytest.raises(ValueError):
        tfa.flash_decode_attention(*(torch.from_numpy(a) for a in
                                     (q, k, v, km)), 0.125)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [40, 128])
def test_decode_attention_dense_matches_jax(int8, t):
    q, k, v, seq_lens, _ = _decode_inputs(5, t=t, lens=(17, t, 1))
    jkw, tkw = {}, {}
    if int8:
        kq, ksc = jkv.quantize_rows(jnp.asarray(k))
        vq, vsc = jkv.quantize_rows(jnp.asarray(v))
        k, v = np.array(kq), np.array(vq)
        jkw = dict(k_scales=ksc, v_scales=vsc)
        tkw = dict(k_scales=torch.from_numpy(np.array(ksc)),
                   v_scales=torch.from_numpy(np.array(vsc)))
    want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(seq_lens),
                                 impl="xla", **jkw)
    got = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.from_numpy(seq_lens), impl="xla", **tkw)
    _close(got, want, 1e-5)


def test_decode_attention_routing(monkeypatch):
    """"flash" takes B11 when T is 128-divisible; "auto" on CPU tensors
    stays dense; the threshold follows the reference (2048) and its
    environment override."""
    calls = []
    real = tfa.flash_decode_attention

    def spy(*a, **kw):
        calls.append(a[1].shape[1])
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_decode_attention", spy)
    q, k, v, seq_lens, _ = _decode_inputs(6)
    args = [torch.from_numpy(a) for a in (q, k, v, seq_lens)]
    dense = tatt.decode_attention(*args, impl="xla")
    flash = tatt.decode_attention(*args, impl="flash")
    _close(flash, dense.numpy(), 1e-5)
    tatt.decode_attention(*args, impl="auto")
    tatt.decode_attention(args[0], args[1][:, :100], args[2][:, :100],
                          args[3], impl="flash")      # T % 128: dense
    assert calls == [128]
    assert not tatt.decode_flash_profitable(1024)
    assert tatt.decode_flash_profitable(2048)
    monkeypatch.setenv("ZOO_TPU_DECODE_FLASH_MIN_T", "128")
    assert tatt.decode_flash_profitable(128)
