"""The PyTorch port's transformer layers and the ops around them against
the JAX package's, on the same numpy inputs and bridged weights:
LayerNormalization, MultiHeadAttention and TransformerLayer (with and
without ``remat``) on the flash path, plus Dropout, Lambda, the
learning-rate schedules, the metrics and the dropout seeds.

The JAX flash kernels run in interpret mode; the port's run their plain
versions (CPU tensors). Tolerances, as a fraction of max(1, |ref|):
1e-5 for forwards in f32 (the same products and sums in another order),
1e-4 for gradients through a two-block stack, 2e-2 for bf16, 1e-6
relative for the schedules (optax computes them in f32, the port in
f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import metrics as jmetrics
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline.api import autograd as jag
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu_torch.bridge import params_from_numpy
from analytics_zoo_tpu_torch.ops import metrics as tmetrics
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.ops import rng as trng
from analytics_zoo_tpu_torch.pipeline.api import autograd as tag
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _bridged(jlayer, tlayer, input_shape, seed=0):
    """Build both layers; the port's gets the JAX weights."""
    p = jax.device_get(jlayer.init(jax.random.PRNGKey(seed), input_shape))
    tlayer.init(torch.Generator().manual_seed(seed), input_shape)
    tlayer.set_params(params_from_numpy(p))
    return p


def _tree_grads(tree):
    return {k: _tree_grads(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _with_grad(tree):
    return {k: _with_grad(v) if isinstance(v, dict) else
            v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def _tree_close(got, want, tol, path=""):
    assert sorted(got) == sorted(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, tol, f"{path}/{k}")
        else:
            _close(got[k], v, tol, f"{path}/{k}")


# -- layer norm --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_normalization_matches_jax(dtype):
    x = np.random.RandomState(0).randn(3, 5, 64).astype(np.float32) * 3 + 1
    jl, tl = JL.LayerNormalization(), TL.LayerNormalization()
    p = _bridged(jl, tl, (5, 64))
    p["gamma"] = p["gamma"] * 1.5
    tl.set_params(params_from_numpy(p))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.call(p, jnp.asarray(x, jdt))
    got = tl.call(tl.params(), torch.tensor(x).to(tdt))
    assert got.dtype == tdt
    _close(got, np.asarray(want, np.float32),
           1e-5 if dtype == "float32" else 2e-2)


def test_transformer_layer_norm_helper_rounds_like_jax_in_bf16():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 64).astype(np.float32) * 4 + 2
    g, b = rs.rand(64).astype(np.float32) + 0.5, rs.randn(64) \
        .astype(np.float32)
    want = jtr._layer_norm(jnp.asarray(x, jnp.bfloat16), g, b)
    got = ttr._layer_norm(torch.tensor(x).bfloat16(), torch.tensor(g),
                          torch.tensor(b))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2e-2)


# -- multi-head attention ----------------------------------------------------

@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)])
def test_multi_head_attention_matches_jax(causal, masked):
    t, h = 128, 64
    kw = dict(hidden_size=h, n_head=4, causal=causal,
              attention_impl="flash")
    jl, tl = JL.MultiHeadAttention(**kw), TL.MultiHeadAttention(**kw)
    p = _bridged(jl, tl, (t, h))
    rs = np.random.RandomState(2)
    x = rs.randn(2, t, h).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 1, 1, t), np.float32)
        mask[0, ..., 90:] = 0
    want = jl.call(p, jnp.asarray(x),
                   mask=None if mask is None else jnp.asarray(mask))
    got = tl.call(tl.params(), torch.tensor(x),
                  mask=None if mask is None else torch.tensor(mask))
    _close(got, np.asarray(want), 1e-5)


# -- the transformer stack ---------------------------------------------------

def _stack(mod, remat, **extra):
    return mod.TransformerLayer(
        n_block=2, hidden_size=64, n_head=2, seq_len=128, vocab=50,
        hidden_p_drop=0.0, embed_p_drop=0.0, attention_impl="flash",
        remat=remat, **extra)


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_layer_matches_jax(remat):
    # causal (GPT-style) blocks on the flash path, forward and grads
    jl, tl = _stack(JL, remat), _stack(TL, remat)
    p = _bridged(jl, tl, (128,))
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 50, (2, 128)).astype(np.int32)
    w = rs.randn(2, 128, 64).astype(np.float32)

    def jloss(p):
        return jnp.sum(jl.call(p, jnp.asarray(ids), training=True) * w)
    jval, jgrad = jax.value_and_grad(jloss)(p)
    tp = _with_grad(tl.params())
    out = tl.call(tp, torch.tensor(ids), training=True)
    want = jl.call(p, jnp.asarray(ids))
    _close(out, np.asarray(want), 1e-5, "forward")
    loss = (out * torch.tensor(w)).sum()
    loss.backward()
    _close(loss, float(jval), 1e-5, "loss")
    _tree_close(_tree_grads(tp), jax.device_get(jgrad), 1e-4)


def test_transformer_layer_all_blocks_output_matches_jax():
    jl = _stack(JL, False, output_all_block=True)
    tl = _stack(TL, False, output_all_block=True)
    p = _bridged(jl, tl, (128,))
    ids = np.random.RandomState(4).randint(0, 50, (1, 128)).astype(np.int32)
    want = jl.call(p, jnp.asarray(ids))
    got = tl.call(tl.params(), torch.tensor(ids))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _close(a, np.asarray(b), 1e-5)
    assert tl.compute_output_shape((128,)) == [(128, 64)] * 2


def test_transformer_layer_takes_token_and_position_ids_like_jax():
    # the reference's (B, T, 2) input: token ids and position ids
    jl, tl = _stack(JL, False), _stack(TL, False)
    p = _bridged(jl, tl, (128,))
    rs = np.random.RandomState(8)
    ids = np.stack([rs.randint(0, 50, (2, 128)),
                    rs.randint(0, 128, (2, 128))], -1).astype(np.int32)
    _close(tl.call(tl.params(), torch.tensor(ids)),
           np.asarray(jl.call(p, jnp.asarray(ids))), 1e-5)


def test_remat_redraws_the_same_dropout_masks():
    # checkpointed blocks rebuild their generators from the seeds handed
    # in, so remat changes neither the loss nor a single gradient bit
    results = []
    for remat in (False, True):
        tl = TL.TransformerLayer(n_block=2, hidden_size=64, n_head=2,
                                 seq_len=128, vocab=50, hidden_p_drop=0.3,
                                 embed_p_drop=0.2, attention_impl="flash",
                                 remat=remat)
        tl.init(torch.Generator().manual_seed(0), (128,))
        tp = _with_grad(tl.params())
        ids = torch.tensor(np.random.RandomState(5).randint(0, 50, (2, 128)))
        out = tl.call(tp, ids, training=True, rng=12345)
        out.square().sum().backward()
        results.append((out.detach(), _tree_grads(tp)))
    (o1, g1), (o2, g2) = results
    assert torch.equal(o1, o2)
    for k in g1["blocks"]:
        assert torch.equal(g1["blocks"][k], g2["blocks"][k]), k
    # dropout did apply: another seed gives another output
    tl.init(torch.Generator().manual_seed(0), (128,))
    with torch.no_grad():
        other = tl.call(tl.params(), ids, training=True, rng=54321)
        plain = tl.call(tl.params(), ids, training=False)
    assert not torch.equal(other, o1) and not torch.equal(plain, o1)


# -- dropout, lambda, seeds --------------------------------------------------

def test_dropout_layer():
    drop = TL.Dropout(0.25)
    x = torch.ones(64, 256)
    assert torch.equal(drop.call({}, x, training=False), x)
    y = drop.call({}, x, training=True, rng=7)
    assert torch.equal(y, drop.call({}, x, training=True, rng=7))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    with pytest.raises(ValueError, match="needs an rng"):
        drop.call({}, x, training=True)
    assert torch.equal(TL.Dropout(0.0).call({}, x, training=True), x)


def test_fold_in_is_deterministic_and_spreads():
    seeds = {trng.fold_in(trng.fold_in(3, i), j) for i in range(50)
             for j in range(50)}
    assert len(seeds) == 2500
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert trng.fold_in(3, 4) == trng.fold_in(3, 4) != trng.fold_in(4, 3)


def test_lambda_matches_jax():
    x = np.random.RandomState(6).randn(2, 8).astype(np.float32)
    jlam = jag.Lambda(lambda a: a[:, :3] * 2.0, output_shape=(3,))
    tlam = tag.Lambda(lambda a: a[:, :3] * 2.0, output_shape=(3,))
    assert tlam.compute_output_shape((8,)) == jlam.compute_output_shape(
        (8,)) == (3,)
    _close(tlam.call({}, torch.tensor(x)),
           np.asarray(jlam.call({}, jnp.asarray(x))), 1e-7)


# -- schedules and metrics ---------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.warmup(5e-5, 8, delta=(5e-4 - 5e-5) / 8),
    lambda m: m.warmup(1e-3, 3, 1e-3, after=m.poly(4e-3, 0.5, 10)),
    lambda m: m.poly(0.1, 2.0, 6, end_lr=0.01),
    lambda m: m.exponential_decay(0.1, 0.5, 3),
    lambda m: m.exponential_decay(0.1, 0.5, 3, staircase=True),
    lambda m: m.step_decay(0.1, 2, 0.5)])
def test_schedules_match_optax(make):
    tf, jf = make(topt), make(jopt)
    for step in range(20):
        want = float(jf(step))
        assert abs(tf(step) - want) <= 1e-6 * max(abs(want), 1e-3), step


@pytest.mark.parametrize("name", ["accuracy", "top5", "mae", "mse", "auc"])
def test_metrics_match_jax(name):
    rs = np.random.RandomState(7)
    if name in ("mae", "mse"):
        yt, yp = rs.randn(16, 3), rs.randn(16, 3)
    elif name == "auc":
        yt = (rs.rand(64) > 0.5).astype(np.float32)
        yp = np.clip(yt * 0.3 + rs.rand(64) * 0.7, 0, 1)
    else:
        yt = rs.randint(0, 8, (16, 1))
        yp = rs.rand(16, 8)
    yt, yp = yt.astype(np.float32), yp.astype(np.float32)
    jm, tm = jmetrics.get(name), tmetrics.get(name)
    halves = [slice(0, len(yt) // 2), slice(len(yt) // 2, None)]
    jtot, ttot = {}, {}
    for sl in halves:
        for k, v in jm.batch_stats(jnp.asarray(yt[sl]),
                                   jnp.asarray(yp[sl])).items():
            jtot[k] = jtot.get(k, 0) + np.asarray(v)
        for k, v in tm.batch_stats(torch.tensor(yt[sl]),
                                   torch.tensor(yp[sl])).items():
            ttot[k] = ttot.get(k, 0) + np.asarray(torch.as_tensor(v))
    assert tm.name == jm.name
    assert abs(tm.aggregate(ttot) - jm.aggregate(jtot)) < 1e-6
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get("nope")
