"""The PyTorch port's BERT slice against the JAX package's, on the same
numpy inputs and bridged weights: the BERT encoder's forward on the
flash path, the multi-output functional graph, and the
``examples/bert_finetune.py`` structure (BERT → Lambda(pooled) →
Dropout → Dense(softmax)) trained two steps by the Estimator with
Adam(warmup), then evaluated with the accuracy metric.

The JAX flash kernels run in interpret mode; the port's run their plain
versions (CPU tensors). Dropout is 0 on both sides in the training
comparison, since the two frameworks draw different random numbers.
Tolerances: forwards 1e-5·max(1, |ref|) in f32; losses 1e-5·max(1,
|loss|); after two steps each param leaf's update within 1e-4 of JAX's
in norm, relative to JAX's update, and each Adam moment leaf within
1e-4·max|JAX's| (both with no floor, since updates and moments are far
below 1; the key bias, whose true gradient is 0, is held to staying
below 1e-2 of the largest on both sides); evaluate's loss 1e-5 and its
accuracy exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline import estimator as jest_mod
from analytics_zoo_tpu.pipeline.api import autograd as jag
from analytics_zoo_tpu.pipeline.api.keras import engine as je
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu_torch.bridge import (
    opt_state_from_numpy, opt_state_to_numpy, optax_state_to_numpy,
    params_from_numpy, params_to_numpy)
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline import estimator as test_mod
from analytics_zoo_tpu_torch.pipeline.api import autograd as tag
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as te
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels

T, H, VOCAB = 128, 64, 100


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


def _tree_close(got, want, tol, path=""):
    assert sorted(got) == sorted(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, tol, f"{path}/{k}")
        else:
            _close(got[k], v, tol, f"{path}/{k}")


def _leaves(tree, path=""):
    """(path, float64 array) per leaf; a fused qkv bias is split into its
    query, key and value thirds."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif path.endswith("/qkv_bias"):
        for n, part in zip("qkv", np.split(np.asarray(tree, np.float64), 3,
                                           axis=-1)):
            yield f"{path[:-8]}{n}_bias", part
    else:
        yield path, np.asarray(tree, np.float64)


def _noise_only(path, got, want, ref):
    """The key bias's true gradient is 0 (a softmax row is unchanged by a
    shift), so its Adam moments and update are rounding noise on both
    sides, which Adam, dividing by the gradient's size, can blow up to
    any share of a step. It is held to that: both below 1e-2 of the
    largest ``ref`` over the tree. Returns whether ``path`` is it."""
    if not path.endswith("/k_bias"):
        return False
    assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-2 * ref, path
    return True


def _updates_close(got, want, start, tol):
    """Per leaf, the port's update against JAX's, in norm and relative
    to JAX's: ||(got - start) - (want - start)|| <= tol * ||want - start||
    (the key bias: :func:`_noise_only`)."""
    g, w, s0 = (dict(_leaves(t)) for t in (got, want, start))
    assert sorted(g) == sorted(w) == sorted(s0)
    step = max(np.abs(w[p] - s0[p]).max() for p in w)
    for path in w:
        dg, dw = g[path] - s0[path], w[path] - s0[path]
        if not _noise_only(path, dg, dw, step):
            assert np.linalg.norm(dg - dw) <= tol * np.linalg.norm(dw), \
                path


def _leaves_rel_close(got, want, tol):
    """Per leaf, max|got - want| <= tol * max|want| (no floor: Adam's
    moments are far below 1; the key bias: :func:`_noise_only`)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    top = max(np.abs(a).max() for a in w.values())
    for path in w:
        assert g[path].shape == w[path].shape, path
        if not _noise_only(path, g[path], w[path], top):
            assert np.abs(g[path] - w[path]).max() <= \
                tol * np.abs(w[path]).max(), path


def _bert(mod, **kw):
    cfg = dict(vocab=VOCAB, hidden_size=H, n_block=2, n_head=2, seq_len=T,
               intermediate_size=4 * H, output_all_block=False,
               attention_impl="flash", input_shape=[(T,)] * 4)
    cfg.update(kw)
    return mod.BERT(**cfg)


def _batch(n, seed=0, all_padding=True):
    """Sentence-pair inputs as the example makes them, with key-padding
    masks of random lengths (one sample all padding)."""
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, VOCAB, (n, T)).astype(np.int32)
    seg = (np.arange(T)[None, :] >= T // 2).astype(np.int32) * \
        np.ones((n, 1), np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (n, 1))
    mask = np.zeros((n, T), np.float32)
    for i, ln in enumerate(rs.randint(T // 4, T + 1, size=n)):
        mask[i, :ln] = 1.0
    if all_padding:
        mask[-1] = 0.0
    y = (tok[:, :T // 2].mean(axis=1) > VOCAB / 2).astype(np.int32)[:, None]
    return [tok, seg, pos, mask], y


@pytest.mark.parametrize("all_blocks", [False, True])
def test_bert_forward_matches_jax(all_blocks):
    jb, tb = _bert(JL, output_all_block=all_blocks), \
        _bert(TL, output_all_block=all_blocks)
    p = jax.device_get(jb.init(jax.random.PRNGKey(0), [(T,)] * 4))
    tb.init(torch.Generator().manual_seed(0), [(T,)] * 4)
    tb.set_params(params_from_numpy(p))
    x, _ = _batch(3)
    want = jb.call(p, [jnp.asarray(a) for a in x])
    got = tb.call(tb.params(), [torch.tensor(a) for a in x])
    assert len(got) == len(want) == (3 if all_blocks else 2)
    for a, b in zip(got, want):
        _close(a, np.asarray(b), 1e-5)
    assert tb.compute_output_shape([(T,)] * 4) == \
        jb.compute_output_shape([(T,)] * 4)


def test_bert_all_padding_sample_matches_dense():
    # masked logits are -1e30, so a sample whose keys are all padding
    # attends uniformly on the flash path exactly as on the dense one
    x, _ = _batch(2)
    flash, dense = _bert(TL), _bert(TL, attention_impl="xla")
    flash.init(torch.Generator().manual_seed(1), [(T,)] * 4)
    dense.init(torch.Generator().manual_seed(2), [(T,)] * 4)
    dense.set_params(flash.params())
    xt = [torch.tensor(a) for a in x]
    for a, b in zip(flash.call(flash.params(), xt),
                    dense.call(dense.params(), xt)):
        assert bool(torch.isfinite(a).all())
        _close(a, b.numpy(), 1e-5)


def test_bert_functional_graph_matches_jax():
    # a multi-output layer in the functional API: one node per output
    def build(engine, L, models, ag):
        ins = [engine.Input((T,)) for _ in range(4)]
        seq, pooled = _bert(L, name="bert")(ins)
        out = L.Dense(2, activation="softmax", name="head")(pooled)
        return models.Model(ins, out)
    jm, tm = build(je, JL, jmodels, jag), build(te, TL, tmodels, tag)
    p = jax.device_get(jm.init_params(jax.random.key(0)))
    tm.load_params(p, device="cpu")
    assert sorted(tm.params()) == sorted(p)
    x, _ = _batch(2, seed=1)
    want = jm.forward(p, [jnp.asarray(a) for a in x])
    _close(tm.call(tm.params(), [torch.tensor(a) for a in x]),
           np.asarray(want), 1e-5)


def _finetune_model(mod, L, ag):
    model = mod.Sequential()
    model.add(_bert(L, name="bert", remat=True, hidden_p_drop=0.0,
                    embed_p_drop=0.0))
    model.add(ag.Lambda(lambda outs: outs[1], name="take_pooled",
                        output_shape=(H,)))
    model.add(L.Dropout(0.0))
    model.add(L.Dense(2, activation="softmax", name="classifier"))
    return model


def test_bert_finetune_slice_matches_jax():
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    jm = _finetune_model(jmodels, JL, jag)
    tm = _finetune_model(tmodels, TL, tag)
    p = jax.device_get(jm.init_params(jax.random.key(0)))
    b = 4
    x, y = _batch(2 * b + 3, seed=2)

    def adam(m):
        return m.Adam(lr=m.warmup(5e-5, 8, delta=(5e-4 - 5e-5) / 8))
    jest = jest_mod.Estimator(jm, optimizer=adam(jopt),
                              loss="sparse_categorical_crossentropy",
                              metrics=["accuracy"])
    jest.params = jax.device_put(p)
    test = test_mod.Estimator(tm, optimizer=adam(topt),
                              loss="sparse_categorical_crossentropy",
                              metrics=["accuracy"])
    test.params = p
    for i in range(2):                    # one step per call
        sl = slice(i * b, (i + 1) * b)
        xs = [a[sl] for a in x]
        jl = jest.train(xs, y[sl], batch_size=b).history[-1]["loss"]
        res = test.train(xs, y[sl], batch_size=b)
        tl = res.history[-1]["loss"]
        assert res.history[-1]["losses"] == [tl]
        assert abs(tl - jl) <= 1e-5 * max(1.0, abs(jl)), i
    assert test.step == jest.step == 2
    _updates_close(params_to_numpy(tm), jax.device_get(jest.params), p,
                   1e-4)
    ts = opt_state_to_numpy(test)
    js = optax_state_to_numpy(jax.device_get(jest.opt_state))
    assert int(ts["count"]) == 2
    _leaves_rel_close(ts["mu"], js["mu"], 1e-4)
    _leaves_rel_close(ts["nu"], js["nu"], 1e-4)
    jscores = jest.evaluate(x, y, batch_size=b)
    tscores = test.evaluate(x, y, batch_size=b)
    assert sorted(tscores) == sorted(jscores) == ["accuracy", "loss"]
    assert tscores["accuracy"] == pytest.approx(jscores["accuracy"], abs=0)
    assert abs(tscores["loss"] - jscores["loss"]) <= \
        1e-5 * max(1.0, abs(jscores["loss"]))
    jpred = jest.predict(x, batch_size=b)
    _close(test.predict(x, batch_size=b), jpred, 1e-5)


def test_adam_state_bridges_both_ways():
    tm = _finetune_model(tmodels, TL, tag)
    est = test_mod.Estimator(tm, optimizer=topt.Adam(1e-3),
                             loss="sparse_categorical_crossentropy")
    x, y = _batch(4, seed=3)
    est.train(x, y, batch_size=4)
    state = opt_state_to_numpy(est)
    est2 = test_mod.Estimator(tm, optimizer=topt.Adam(1e-3),
                              loss="sparse_categorical_crossentropy")
    est2._ensure_initialized()
    opt_state_from_numpy(est2, state)
    back = opt_state_to_numpy(est2)
    assert int(back["count"]) == 1
    for key in ("mu", "nu"):
        _tree_close(back[key], state[key], 0.0)


def test_training_hands_dropout_a_seed_per_step():
    # dropout > 0 draws other masks at every step (the same batch at lr 0
    # gives another loss) and the same masks from the same context seed
    def run():
        tzoo.init_nncontext(seed=3, device="cpu")
        tm = tmodels.Sequential()
        tm.add(_bert(TL, name="bert", n_block=1, hidden_p_drop=0.5))
        tm.add(tag.Lambda(lambda outs: outs[1], output_shape=(H,)))
        tm.add(TL.Dropout(0.5))
        tm.add(TL.Dense(2, activation="softmax"))
        tm.init_params(torch.Generator().manual_seed(0), device="cpu")
        est = test_mod.Estimator(tm, optimizer=topt.SGD(0.0),
                                 loss="sparse_categorical_crossentropy")
        x, y = _batch(4, seed=4, all_padding=False)
        return [est.train(x, y, batch_size=4).history[-1]["loss"]
                for _ in range(2)]
    a, b = run(), run()
    assert a == b and a[0] != a[1]
