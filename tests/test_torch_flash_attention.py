"""The PyTorch port's flash attention and attention routing against the
JAX package's, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU (its
default off-TPU); the port's runs the plain versions of its CUDA kernels
B7-B10 (CPU tensors), through the same entry points and autograd.

Tolerances, as a fraction of max(1, max|ref|): 1e-5 in f32 (the same
sums in another order: the reference accumulates over 128- to 256-key
blocks, the plain versions over whole rows); 2e-2 in bf16 (p is
rounded to bf16 at the running row max in the reference and at the
final one in the port, one bf16 rounding apart).

Rows that see no key under causal masking (Tq > Tk) are the one
deliberate difference: the port outputs 0 and passes no gradient there
whatever its tiling; the reference does so only where its block size
leaves a whole q-block dead, and otherwise averages the keys of the
blocks it ran. Those rows are compared where the reference's value does
not depend on its blocks, and pinned to 0 elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jatt
from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _inputs(b, tq, tk, h, d, masked, seed=0, all_padding=False):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, tq, h, d) * 0.5).astype(np.float32)
    k = (rs.randn(b, tk, h, d) * 0.5).astype(np.float32)
    v = (rs.randn(b, tk, h, d) * 0.5).astype(np.float32)
    w = rs.randn(b, tq, h, d).astype(np.float32)     # loss weights
    km = None
    if masked:
        # padding at the tail, at least one real key per sample, so every
        # causal row sees one
        km = np.zeros((b, tk), np.float32)
        for i, n in enumerate(rs.randint(1, tk, size=b)):
            km[i, :n] = 1.0
        if all_padding:
            km[-1] = 0.0
    return q, k, v, w, km


def _to(a, dtype, grad=False):
    t = torch.tensor(a).to(getattr(torch, dtype))
    return t.requires_grad_(True) if grad else t


def _jax_run(fn, q, k, v, w, dtype, rows=slice(None)):
    """fn(q, k, v) and the grads of sum(out[:, rows] * w[:, rows])."""
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    wj = jnp.asarray(w)[:, rows]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v)[:, rows].astype(jnp.float32) * wj)
    return fn(*args), jax.grad(loss, argnums=(0, 1, 2))(*args)


def _torch_run(fn, q, k, v, w, dtype, rows=slice(None)):
    ts = [_to(a, dtype, grad=True) for a in (q, k, v)]
    out = fn(*ts)
    (out[:, rows].float() * torch.tensor(w)[:, rows]).sum().backward()
    return out, [t.grad for t in ts]


# -- flash_attention: forward and grads --------------------------------------

CASES = [
    # tq, tk, causal, masked, d, dtype
    (128, 128, False, False, 32, "float32"),
    (128, 128, False, True, 64, "float32"),
    (128, 128, True, False, 64, "float32"),
    (128, 128, True, True, 32, "float32"),
    (128, 256, False, True, 32, "float32"),
    (128, 256, True, False, 32, "float32"),
    (128, 256, True, True, 64, "float32"),
    (256, 128, False, False, 64, "float32"),
    (256, 128, True, True, 32, "float32"),
    (256, 256, True, True, 64, "float32"),
    (128, 128, False, True, 64, "bfloat16"),
    (128, 256, True, True, 32, "bfloat16"),
    (256, 128, True, False, 64, "bfloat16"),
    (256, 256, False, False, 32, "bfloat16"),
]


@pytest.mark.parametrize("tq,tk,causal,masked,d,dtype", CASES)
def test_flash_attention_matches_jax(tq, tk, causal, masked, d, dtype):
    q, k, v, w, km = _inputs(2, tq, tk, 2, d, masked)
    # live rows: every row unless causal with Tq > Tk
    dead = max(0, tq - tk) if causal else 0
    rows = slice(dead, None)
    jkm = None if km is None else jnp.asarray(km)
    tkm = None if km is None else torch.tensor(km)
    jout, jgrads = _jax_run(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            key_mask=jkm),
        q, k, v, w, dtype, rows)
    tout, tgrads = _torch_run(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal,
                                            key_mask=tkm),
        q, k, v, w, dtype, rows)
    assert tout.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    _close(tout[:, dead:], np.asarray(jout, np.float32)[:, dead:], tol,
           "out")
    assert float(tout[:, :dead].detach().abs().max() if dead else 0.0) \
        == 0.0
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        assert tg.dtype == getattr(torch, dtype)
        _close(tg, np.asarray(jg, np.float32), tol, f"d{name}")


def test_no_grad_runs_the_forward_kernel_and_grad_the_partials(
        monkeypatch):
    # B7 without grad, B8 + B9 + B10 with it (the plain versions here)
    calls = []
    for name in ("_flash_fwd", "_block_partials", "_backward"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _f=fn, _n=name:
                            calls.append(a[0] if _n == "_backward" else _n)
                            or _f(*a))
    q, k, v, _, _ = _inputs(1, 128, 128, 2, 32, False)
    with torch.no_grad():
        tfa.flash_attention(*[_to(a, "float32", True) for a in (q, k, v)])
    assert calls == ["_flash_fwd"]
    calls.clear()
    out = tfa.flash_attention(*[_to(a, "float32", True) for a in (q, k, v)])
    out.sum().backward()
    assert calls == ["_block_partials", "flash_bwd_dkdv", "flash_bwd_dq"]


@pytest.mark.parametrize("causal,offset", [(False, 0), (True, 0),
                                           (True, -128), (True, 128),
                                           (True, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_block_partial_matches_jax(causal, offset, dtype):
    # B8 alone at a runtime q-k offset (negative, or past Tk); at -128
    # every query row is dead and the reference skips the whole block
    q, k, v, _, _ = _inputs(2, 128, 256, 2, 32, False, seed=1)
    jdt = getattr(jnp, dtype)
    jacc, jm, jl = jfa.flash_block_partial(
        *[jnp.asarray(a, jdt) for a in (q, k, v)], offset, causal,
        32 ** -0.5)
    tacc, tm, tl = tfa.flash_block_partial(
        *[_to(a, dtype) for a in (q, k, v)], offset, causal, 32 ** -0.5)
    for got, want in ((tacc, jacc), (tm, jm), (tl, jl)):
        assert got.dtype == torch.float32
        _close(got, np.asarray(want), TOL[dtype])


# -- rows that see no key ----------------------------------------------------

def test_dead_q_block_outputs_zero_and_passes_no_gradient():
    # Tq - Tk = 128 dead rows: with 128-row blocks the reference skips
    # the dead q-block, which is the port's rule for every dead row
    q, k, v, w, _ = _inputs(1, 256, 128, 2, 32, False, seed=2)
    scale = 32 ** -0.5

    def jax_flash(q, k, v):
        t = lambda a: jnp.transpose(a, (0, 2, 1, 3))
        out = jfa._flash(t(q), t(k), t(v), jnp.zeros((), jnp.float32),
                         scale, True, 128, 128, True)
        return t(out)
    jout, jgrads = _jax_run(jax_flash, q, k, v, w, "float32")
    tout, tgrads = _torch_run(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True),
        q, k, v, w, "float32")
    assert float(np.abs(np.asarray(jout)[:, :128]).max()) == 0.0
    assert float(tout[:, :128].detach().abs().max()) == 0.0
    _close(tout, np.asarray(jout), 1e-5, "out")
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        _close(tg, np.asarray(jg), 1e-5, f"d{name}")
    assert float(tgrads[0][:, :128].abs().max()) == 0.0


def test_dead_rows_sharing_a_block_differ_from_the_reference_only_there():
    # with its default 256-row block the reference averages the keys for
    # the dead rows (block-dependent); the port gives 0 and matches on
    # every live row, values and gradients (loss over the live rows)
    q, k, v, w, _ = _inputs(1, 256, 128, 2, 32, False, seed=3)
    rows = slice(128, None)
    jout, jgrads = _jax_run(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=True),
        q, k, v, w, "float32", rows)
    tout, tgrads = _torch_run(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True),
        q, k, v, w, "float32", rows)
    assert float(np.abs(np.asarray(jout)[:, :128]).max()) > 0.0
    assert float(tout[:, :128].detach().abs().max()) == 0.0
    _close(tout[:, 128:], np.asarray(jout)[:, 128:], 1e-5, "live rows")
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        _close(tg, np.asarray(jg), 1e-5, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_padding_sample_attends_uniformly_like_dense(dtype):
    # masked logits are -1e30, not -inf: a sample whose keys are all
    # padding averages them (no NaN), as the dense path does
    q, k, v, w, km = _inputs(2, 128, 128, 2, 64, True, seed=4,
                             all_padding=True)
    mask4 = km[:, None, None, :]
    jdense = jatt.dot_product_attention(
        *[jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)],
        mask=jnp.asarray(mask4), impl="xla")
    tout, _ = _torch_run(
        lambda q, k, v: tfa.flash_attention(q, k, v,
                                            key_mask=torch.tensor(km)),
        q, k, v, w, dtype)
    assert bool(torch.isfinite(tout.float()).all())
    _close(tout, np.asarray(jdense, np.float32), TOL[dtype])
    mean_v = _to(v, dtype).float()[1].mean(0)
    _close(tout[1].float(), mean_v.expand_as(tout[1]).numpy(), TOL[dtype])


def test_causal_all_padding_row_averages_its_visible_keys():
    # causal and every visible key padding: the port averages the keys
    # the row may see (the reference's value depends on its blocks)
    q, k, v, _, _ = _inputs(1, 128, 128, 1, 32, False, seed=5)
    km = np.zeros((1, 128), np.float32)
    km[0, 100:] = 1.0          # rows 0..99 see only padding
    out = tfa.flash_attention(_to(q, "float32"), _to(k, "float32"),
                              _to(v, "float32"), causal=True,
                              key_mask=torch.tensor(km))
    want = np.cumsum(v[0], axis=0) / np.arange(1, 129)[:, None, None]
    _close(out[0, :100], want[:100], 1e-5)


# -- dot_product_attention and routing ---------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)])
def test_dot_product_attention_matches_jax(impl, causal, masked):
    q, k, v, w, km = _inputs(2, 128, 128, 2, 32, masked, seed=6,
                             all_padding=True)
    jmask = None if km is None else jnp.asarray(km[:, None, None, :])
    tmask = None if km is None else torch.tensor(km[:, None, None, :])
    jout, jgrads = _jax_run(
        lambda q, k, v: jatt.dot_product_attention(
            q, k, v, mask=jmask, causal=causal, impl=impl),
        q, k, v, w, "float32")
    tout, tgrads = _torch_run(
        lambda q, k, v: tatt.dot_product_attention(
            q, k, v, mask=tmask, causal=causal, impl=impl),
        q, k, v, w, "float32")
    _close(tout, np.asarray(jout), 1e-5, "out")
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        _close(tg, np.asarray(jg), 1e-5, f"d{name}")


def test_dense_attention_takes_a_per_query_mask_like_jax():
    q, k, v, _, _ = _inputs(1, 16, 24, 2, 8, False, seed=7)
    mask = (np.random.RandomState(7).rand(1, 2, 16, 24) > 0.3)
    jout = jatt.dot_product_attention(q, k, v, mask=jnp.asarray(mask),
                                      causal=True, impl="xla")
    tout = tatt.dot_product_attention(
        *[torch.tensor(a) for a in (q, k, v)], mask=torch.tensor(mask),
        causal=True, impl="xla")
    _close(tout, np.asarray(jout), 1e-5)


def test_routing_matches_the_reference(monkeypatch):
    for args in [(128, 256, 64, None), (100, 128, 64, None),
                 (128, 128, 320, None)]:
        assert tfa.supports(*args) == jfa.supports(*args)
    km4 = np.ones((2, 1, 1, 128), np.float32)
    for mask, b in [(km4, 2), (km4[:1], 2), (np.ones((2, 1, 128, 128)), 2),
                    (np.ones((128, 128)), 2), (None, 2)]:
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.tensor(mask)
        jk, tk = jfa.as_key_mask(jm, b, 128), tfa.as_key_mask(tm, b, 128)
        assert (jk is None) == (tk is None)
        if jk is not None:
            assert tuple(tk.shape) == tuple(jk.shape) == (b, 128)
        assert tfa.supports(128, 128, 64, tm, b) == \
            jfa.supports(128, 128, 64, jm, b)
    for t in (128, 512, 1024, 4096):
        assert tatt.flash_profitable(t) == (t >= 1024)
    monkeypatch.setenv("ZOO_TPU_FLASH_MIN_T", "256")
    assert tatt.flash_profitable(256) and not tatt.flash_profitable(128)
    monkeypatch.delenv("ZOO_TPU_FLASH_MIN_T")
    # "flash" never falls back to dense: unsupported shapes raise
    x = torch.zeros(1, 100, 2, 32)
    with pytest.raises(ValueError, match="impl='flash' unsupported"):
        tatt.dot_product_attention(x, x, x, impl="flash")
    y = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="impl='flash' unsupported"):
        tatt.dot_product_attention(y, y, y, mask=torch.ones(1, 2, 128, 128),
                                   impl="flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.resolve_attention_impl("fast")
    monkeypatch.setenv("ZOO_TPU_ATTENTION", "xla")
    assert tatt.resolve_attention_impl(None) == "xla"


def test_auto_routes_to_flash_only_where_the_reference_would(monkeypatch):
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    y = torch.zeros(1, 128, 2, 32)
    tatt.dot_product_attention(y, y, y)          # CPU tensor: dense
    assert not calls and not tatt.flash_backend_ok(y)
    monkeypatch.setattr(tatt, "flash_backend_ok", lambda t: True)
    tatt.dot_product_attention(y, y, y)          # below the crossover
    assert not calls
    monkeypatch.setenv("ZOO_TPU_FLASH_MIN_T", "128")
    tatt.dot_product_attention(y, y, y)
    assert calls == [1]
    tatt.dot_product_attention(y, y, y, impl="xla")
    assert calls == [1]
