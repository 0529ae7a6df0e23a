"""The port's layers, losses, regularizers and initializers of the
recommendation slice against the JAX package's, on the same numpy
inputs and params: the Merge family, the rest of ``core`` (Select,
Narrow, Reshape, Permute, RepeatVector, Squeeze, ExpandDim, Masking),
Embedding and WordEmbedding, the loss table, L1/L2 and the initializer
registry.

Forward and gradient (of ``sum(out * w)`` for a fixed random ``w``, by
inputs and params) within f32 1e-5; initializers by their moments and
bounds at 4096 draws (the draws differ: another generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.ops import initializers as jinit
from analytics_zoo_tpu.ops import losses as jlosses
from analytics_zoo_tpu.ops import regularizers as jreg
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu_torch.bridge import params_from_numpy, \
    params_to_numpy
from analytics_zoo_tpu_torch.ops import initializers as tinit
from analytics_zoo_tpu_torch.ops import losses as tlosses
from analytics_zoo_tpu_torch.ops import regularizers as treg
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input as TInput

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _fwd_grad(jlyr, tlyr, xs, shape, params=None, grad_inputs=True):
    """Run both layers on ``xs`` (an array or a list of them) with the
    JAX layer's params; hold outputs, output shapes and the gradients of
    ``sum(out * w)`` by every param and (``grad_inputs``) every float
    input. NaN outputs count as 0 in the sum."""
    p = jax.device_get(jlyr.init(jax.random.key(0), shape))
    if params is not None:
        p = params(p)
    multi = isinstance(xs, list)
    xl = xs if multi else [xs]
    floats = [i for i, a in enumerate(xl)
              if grad_inputs and a.dtype.kind == "f"]

    def jloss(p, fx):
        args = list(xl)
        for i, a in zip(floats, fx):
            args[i] = a
        out = jlyr.call(p, args if multi else args[0])
        out = jnp.where(jnp.isnan(out), 0.0, out)
        return jnp.sum(out * w), out

    jout = jax.jit(lambda p: jlyr.call(
        p, [jnp.asarray(a) for a in xl] if multi else jnp.asarray(xl[0])))(p)
    w = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    (jgp, jgx), _ = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
        p, [jnp.asarray(xl[i]) for i in floats])

    tp = params_from_numpy(p)
    leaves = [v.requires_grad_(True) for v in tp.values()]
    tx = [torch.from_numpy(a.copy()) for a in xl]
    for i in floats:
        tx[i].requires_grad_(True)
    tout = tlyr.call(tp, tx if multi else tx[0])
    _close(tout, jout, "out")
    assert tlyr.compute_output_shape(shape) == jlyr.compute_output_shape(
        shape) == tuple(jout.shape[1:])
    loss = torch.sum(torch.where(torch.isnan(tout), 0.0, tout) *
                     torch.from_numpy(w))
    grads = torch.autograd.grad(loss, leaves + [tx[i] for i in floats],
                                allow_unused=True)
    for (k, _), g in zip(tp.items(), grads[:len(leaves)]):
        _close(g, jgp[k], f"grad {k}")
    for i, g, jg in zip(floats, grads[len(leaves):], jgx):
        _close(g, jg, f"grad input {i}")
    return tout


# -- merge --------------------------------------------------------------------

_MERGE = [("sum", 3, -1), ("sub", 2, -1), ("mul", 3, -1), ("ave", 3, -1),
          ("max", 3, -1), ("min", 3, -1), ("concat", 3, -1),
          ("concat", 2, 1), ("concat", 2, 2), ("dot", 2, -1),
          ("cos", 2, -1)]


@pytest.mark.parametrize("mode,n,axis", _MERGE)
def test_merge_modes_match_jax(mode, n, axis):
    rs = np.random.RandomState(1)
    xs = [rs.randn(4, 3, 5).astype(np.float32) for _ in range(n)]
    _fwd_grad(JL.Merge(mode=mode, concat_axis=axis),
              TL.Merge(mode=mode, concat_axis=axis), xs, [(3, 5)] * n)


@pytest.mark.parametrize("name,kw", [
    ("Add", {}), ("Multiply", {}), ("Average", {}), ("Maximum", {}),
    ("Minimum", {}), ("Concatenate", {"axis": 1}), ("Dot", {})])
def test_merge_aliases_match_jax(name, kw):
    rs = np.random.RandomState(2)
    xs = [rs.randn(3, 4).astype(np.float32) for _ in range(2)]
    tlyr = getattr(TL, name)(**kw)
    assert isinstance(tlyr, TL.Merge)
    assert tlyr.mode == getattr(JL, name)(**kw).mode
    assert tlyr.name.startswith(name.lower() + "_")
    _fwd_grad(getattr(JL, name)(**kw), tlyr, xs, [(4,), (4,)])


def test_merge_helper_and_errors():
    a, b = TInput((3,)), TInput((3,))
    out = TL.merge([a, b], mode="concat")
    ja, jb = JInput((3,)), JInput((3,))
    assert out.shape == JL.merge([ja, jb], mode="concat").shape == (6,)
    m = tmodels.Model([a, b], out)
    x = [np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)]
    np.testing.assert_array_equal(m.predict(x), np.concatenate(x, 1))
    with pytest.raises(ValueError, match="merge mode"):
        TL.Merge(mode="nope")
    with pytest.raises(ValueError, match=">= 2 inputs"):
        TL.Add().call({}, [torch.ones(2, 3)])


# -- core -------------------------------------------------------------------

_CORE = [
    ("Select", dict(dim=1, index=0), (3, 4)),
    ("Select", dict(dim=2, index=-1), (3, 4)),
    ("Narrow", dict(dim=1, offset=1, length=2), (3, 4)),
    ("Narrow", dict(dim=2, offset=-3, length=2), (3, 4)),
    ("Reshape", dict(target_shape=(2, -1)), (3, 4)),
    ("Permute", dict(dims=(2, 1)), (3, 4)),
    ("RepeatVector", dict(n=3), (4,)),
    ("Squeeze", dict(dim=2), (3, 1, 4)),
    ("ExpandDim", dict(dim=1), (3, 4)),
    ("Masking", dict(mask_value=0.0), (3, 4)),
]


@pytest.mark.parametrize("name,kw,shape", _CORE)
def test_core_layers_match_jax(name, kw, shape):
    rs = np.random.RandomState(3)
    x = rs.randn(2, *shape).astype(np.float32)
    if name == "Masking":
        x[0, 1] = 0.0
        x[1, 2, 1] = 0.0          # one zero feature keeps the step
    out = _fwd_grad(getattr(JL, name)(**kw), getattr(TL, name)(**kw), x,
                    shape)
    if name == "Masking":
        assert torch.all(out[0, 1] == 0) and out[1, 2, 0] != 0


def test_squeeze_of_a_wide_dim_raises():
    with pytest.raises(ValueError, match="is not 1"):
        TL.Squeeze(1).compute_output_shape((3, 4))
    with pytest.raises(ValueError, match="is not 1"):
        TL.Squeeze(1).call({}, torch.ones(2, 3, 4))
    with pytest.raises(ValueError, match="cannot reshape"):
        TL.Reshape((5, -1)).compute_output_shape((3, 4))


# -- embedding ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("pad_zero", [False, True])
def test_embedding_matches_jnp_take(dtype, pad_zero):
    # ids in [-n, -1] wrap, ids n and -n-1 give NaN rows and no
    # gradient (jnp.take's fill); float ids truncate; the table's
    # gradient is dense
    n = 6
    ids = np.array([[0, 5, -1, 6], [-6, -7, 2, 2]])
    if dtype == "float32":
        ids = ids + np.where(ids >= 0, 0.7, -0.7)
    ids = ids.astype(dtype)
    out = _fwd_grad(JL.Embedding(n, 3, pad_zero=pad_zero),
                    TL.Embedding(n, 3, pad_zero=pad_zero), ids, (4,),
                    grad_inputs=False)
    nan_rows = torch.isnan(out).all(-1)
    assert nan_rows.tolist() == [[False, False, False, True],
                                 [False, True, False, False]]
    if pad_zero:
        g = torch.Generator().manual_seed(0)
        assert torch.all(TL.Embedding(n, 3, pad_zero=True).build(
            g, (4,))["embeddings"][0] == 0)


def test_embedding_take_rows_and_registry():
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding \
        import take_rows
    table = torch.arange(8.0).reshape(4, 2).requires_grad_(True)
    out = take_rows(table, torch.tensor([-4, 3, 4, -5]))
    assert out[0].tolist() == [0.0, 1.0] and out[1].tolist() == [6.0, 7.0]
    assert torch.isnan(out[2:]).all()
    (g,) = torch.autograd.grad(torch.nansum(out), [table])
    assert not g.is_sparse
    assert g.tolist() == [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]
    lyr = TL.Embedding(4, 2, w_regularizer="l2")
    assert lyr.regularizers()[0][0] == "embeddings"


def test_word_embedding_from_glove(tmp_path):
    path = tmp_path / "glove.txt"
    path.write_text("the 0.1 0.2 0.3\ncat -1 0.5 2\nunused 9 9 9\n"
                    "dog 0.25 0.5 0.75\n", encoding="utf-8")
    index = {"the": 1, "cat": 2, "dog": 4, "fish": 3}
    jw = JL.WordEmbedding.from_glove(str(path), index)
    tw = TL.WordEmbedding.from_glove(str(path), index, input_shape=(3,))
    np.testing.assert_array_equal(tw.table, jw.weights)
    assert tw.table.shape == (5, 3) and not tw.trainable
    assert np.all(tw.table[[0, 3]] == 0)
    m = tmodels.Sequential([tw])
    ids = np.array([[1, 2, 4], [0, 3, -1]], np.int32)
    want = jmodels.Sequential([JL.WordEmbedding(jw.weights,
                                                input_shape=(3,))])
    jp = want.init_params(jax.random.key(0))
    np.testing.assert_array_equal(m.predict(ids),
                                  np.asarray(want.call(jp, ids)))
    assert m.trainable_mask(m.params()) == {
        tw.name: {"embeddings": False}}
    with pytest.raises(ValueError, match="no usable vectors"):
        TL.WordEmbedding.from_glove(str(path), {"zebra": 1})


# -- losses -------------------------------------------------------------------

def _loss_inputs(name, rs):
    logits = rs.randn(6, 5).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(logits))
    if name == "class_nll":
        return rs.randint(0, 5, size=(6, 1)).astype(np.int32), \
            np.asarray(jax.nn.log_softmax(logits))
    if name == "class_nll_flat":
        return rs.randint(0, 5, size=(6,)).astype(np.int32), \
            np.asarray(jax.nn.log_softmax(logits))
    if name in ("binary_crossentropy", "sigmoid_cross_entropy"):
        y = rs.randint(0, 2, size=(6, 5)).astype(np.float32)
        return y, (np.asarray(jax.nn.sigmoid(logits))
                   if name == "binary_crossentropy" else logits)
    if name in ("hinge", "squared_hinge"):
        return np.sign(rs.randn(6, 5)).astype(np.float32), logits
    if name in ("kld", "kullback_leibler_divergence"):
        return np.asarray(jax.nn.softmax(rs.randn(6, 5))).astype(
            np.float32), prob
    if name == "poisson":
        return rs.poisson(2.0, size=(6, 5)).astype(np.float32), \
            np.exp(logits * 0.5)
    if name == "cosine_proximity":
        return rs.randn(6, 5).astype(np.float32), logits
    # mape, msle: positive targets and predictions (and one clipped)
    y = rs.rand(6, 5).astype(np.float32) + 0.5
    y[0, 0] = 0.0
    return y, np.exp(logits * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", [
    "class_nll", "class_nll_flat", "binary_crossentropy", "mape", "msle",
    "mean_absolute_percentage_error", "mean_squared_logarithmic_error",
    "sigmoid_cross_entropy", "hinge", "squared_hinge", "kld",
    "kullback_leibler_divergence", "poisson", "cosine_proximity"])
def test_losses_match_jax(name):
    y, pred = _loss_inputs(name, np.random.RandomState(4))
    key = "class_nll" if name == "class_nll_flat" else name
    jfn, tfn = jlosses.get(key), tlosses.get(key)
    want, jg = jax.value_and_grad(lambda p: jfn(jnp.asarray(y), p))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred.copy()).requires_grad_(True)
    got = tfn(torch.from_numpy(y), tp)
    (tg,) = torch.autograd.grad(got, [tp])
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    _close(tg, jg, "grad " + name)


def test_loss_table_is_the_reference_table():
    assert sorted(tlosses._REGISTRY) == sorted(jlosses._REGISTRY)


# -- regularizers -------------------------------------------------------------

@pytest.mark.parametrize("spec", ["l1", "l2", "l1l2", "l1_l2",
                                  ("L1L2", 0.3, 0.05)])
def test_regularizers_match_jax(spec):
    w = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    if isinstance(spec, tuple):
        jr, tr = jreg.L1L2(*spec[1:]), treg.L1L2(*spec[1:])
    else:
        jr, tr = jreg.get(spec), treg.get(spec)
    assert repr(tr) == repr(jr)
    want, jg = jax.value_and_grad(lambda a: jr(a))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tr(tw)
    (tg,) = torch.autograd.grad(got, [tw])
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    _close(tg, jg)
    assert treg.get(None) is None and treg.get(tr) is tr
    with pytest.raises(ValueError, match="unknown regularizer"):
        treg.get("l3")


def test_regularized_training_steps_match_jax():
    # Embedding(w_regularizer) -> Flatten -> Dense(w/b regularizers) ->
    # log_softmax under class_nll, two Adam steps through compile/fit:
    # the regularizers' terms are in each step's loss and gradient
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])

    def build(L, M):
        return M.Sequential([
            L.Embedding(7, 4, w_regularizer="l2", input_shape=(3,)),
            L.Flatten(),
            L.Dense(5, w_regularizer=jreg.l1l2(0.02, 0.01)
                    if L is JL else treg.l1l2(0.02, 0.01),
                    b_regularizer="l1"),
            L.Activation("log_softmax")])

    rs = np.random.RandomState(6)
    x = rs.randint(0, 7, size=(16, 3)).astype(np.int32)
    y = rs.randint(0, 5, size=(16, 1)).astype(np.int32)
    jm, tm = build(JL, jmodels), build(TL, tmodels)
    jm.compile(optimizer="adam", loss="class_nll")
    tm.compile(optimizer="adam", loss="class_nll")
    jm.estimator.params = jax.device_put(jm.init_params(jax.random.key(3)))
    # biases away from 0, where |b| has no gradient
    p = jax.device_get(jm.estimator.params)
    p["dense_1"]["bias"] = rs.randn(5).astype(np.float32) * 0.1
    jm.estimator.params = jax.device_put(p)
    tm.estimator.params = p
    np.testing.assert_allclose(
        float(tm.regularization_loss(tm.params())),
        float(jm.regularization_loss(p)), rtol=TOL)
    jh = jm.fit(x, y, batch_size=16, nb_epoch=2).history
    th = tm.fit(x, y, batch_size=16, nb_epoch=2).history
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=TOL)
    want = jax.device_get(jm.estimator.params)
    got = params_to_numpy(tm)
    for layer, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=TOL,
                                       atol=TOL, err_msg=f"{layer}/{k}")


# -- initializers -------------------------------------------------------------

_INITS = ["uniform", "normal", "glorot_uniform", "glorot_normal",
          "he_uniform", "he_normal", "lecun_uniform", "lecun_normal"]


@pytest.mark.parametrize("name", _INITS)
@pytest.mark.parametrize("shape", [(64, 64), (2, 2, 16, 64)])
def test_initializer_moments_match_jax(name, shape):
    w = tinit.get(name)(torch.Generator().manual_seed(0), shape)
    jw = np.asarray(jinit.get(name)(jax.random.key(0), shape))
    w = w.numpy()
    assert w.shape == jw.shape == shape and w.dtype == np.float32
    np.testing.assert_allclose(w.std(), jw.std(), rtol=0.05)
    assert abs(w.mean()) < 0.1 * jw.std()
    if name in ("uniform", "normal"):
        # fixed scales: U(-0.05, 0.05) and N(0, 0.05^2)
        np.testing.assert_allclose(
            w.std(), 0.05 / np.sqrt(3) if name == "uniform" else 0.05,
            rtol=0.05)
    if "uniform" in name:
        # the support: [-limit, limit], reached within a few percent
        limit = np.sqrt(3) * jw.std()
        assert np.abs(w).max() <= limit * 1.03
        assert np.abs(w).max() >= limit * 0.95
    elif name != "normal":
        # truncated at two standard deviations of the untruncated
        # normal, whose scale is corrected so the std is sqrt(var)
        bound = 2 * jw.std() / 0.87962566103423978
        assert np.abs(w).max() <= bound * 1.03
        assert np.abs(jw).max() <= bound * 1.03
        assert np.abs(w).max() >= bound * 0.9


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (4, 4, 8)])
def test_orthogonal_and_identity(shape):
    w = tinit.get("orthogonal")(torch.Generator().manual_seed(0), shape)
    jw = np.asarray(jinit.get("orthogonal")(jax.random.key(0), shape))
    assert w.shape == jw.shape == shape
    m = w.reshape(-1, shape[-1]).double()
    small = min(m.shape)
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-5)
    np.testing.assert_array_equal(
        tinit.get("identity")(None, (5, 5)).numpy(),
        np.asarray(jinit.get("identity")(jax.random.key(0), (5, 5))))
    with pytest.raises(ValueError, match="square 2D"):
        tinit.get("identity")(None, shape)
    with pytest.raises(ValueError, match="square 2D"):
        jinit.get("identity")(jax.random.key(0), shape)


def test_initializer_registry_is_the_reference_registry():
    assert sorted(tinit._REGISTRY) == sorted(jinit._REGISTRY)
