"""The PyTorch port's training slice against the JAX package's, on the
same numpy inputs and weights: the max-pool backward, losses,
optimizers, the fused bottleneck's training forward and gradients, the
Estimator's train step, and the Keras ``compile``/``fit`` surface.

The JAX fused bottleneck runs its Pallas kernels in interpret mode with
the 1x1's Pallas backward pinned (``ZOO_TPU_CONV_BN_PALLAS_BWD=1``);
the port's runs the plain versions of its CUDA kernels (CPU tensors).

Tolerances, as a fraction of max(1, max|ref|) unless stated: 1e-5 for
elementwise work and the max-pool split (exact arithmetic either way);
1e-4 for one forward and backward of a block (the same products and
sums in another order, through three chained BatchNorms); 1e-4 for the
three-step train slice, whose learning rate (SGD 0.01, momentum 0.9)
keeps the steps from amplifying rounding (at 0.1 the tiny net's loss
jumps, and three steps part the two sides far more than one step
does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models.image.imageclassification import resnet as jr
from analytics_zoo_tpu.ops import losses as jlosses
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.ops import pool_grad as jpool
from analytics_zoo_tpu.pipeline import estimator as jest_mod
from analytics_zoo_tpu.pipeline.api.keras import engine as je
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu_torch.bridge import (
    opt_state_to_numpy, optax_state_to_numpy, params_from_numpy,
    params_to_numpy)
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    resnet as tr
from analytics_zoo_tpu_torch.ops import losses as tlosses
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.ops import pool_grad as tpool
from analytics_zoo_tpu_torch.pipeline import estimator as test_mod
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as te
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_CONV_BN_PALLAS_BWD", "1")
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    yield
    tzoo.reset_nncontext()


def _rel_close(got, want, tol, what=""):
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
            _rel_close(got[k], v, tol, f"{path}/{k}")


# -- max pool ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool2d_splits_ties_like_jax(dtype):
    # many ties: a ReLU'd, coarsely quantised input, as in bf16 training
    rs = np.random.RandomState(0)
    x = np.maximum(np.round(rs.randn(2, 9, 9, 4) * 2) / 2, 0).astype(
        np.float32)
    g = rs.randn(2, 5, 5, 4).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(x_):
        y = jpool.maxpool2d(x_, (3, 3), (2, 2), "SAME")
        return jnp.sum(y.astype(jnp.float32) * g)
    jgx = jax.grad(jloss)(jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = tpool.maxpool2d(tx, (3, 3), (2, 2), "same")
    np.testing.assert_array_equal(
        y.float().detach().numpy(),
        np.asarray(jpool.maxpool2d(jnp.asarray(x, jdt), (3, 3), (2, 2),
                                   "SAME"), np.float32))
    (tgx,) = torch.autograd.grad((y.float() * torch.from_numpy(g)).sum(),
                                 [tx])
    assert tgx.dtype == tdt
    _rel_close(tgx, np.asarray(jgx, np.float32), 1e-5, "dx")
    # torch's own backward routes a window's whole cotangent to one
    # index, so it differs exactly where ties are
    tx2 = torch.from_numpy(x).requires_grad_(True)
    yt = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(tx2.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                value=float("-inf")), 3, 2)
    (native,) = torch.autograd.grad(
        (yt.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum(), [tx2])
    assert not np.allclose(native.numpy(), np.asarray(jgx, np.float32))


def test_maxpool_layer_valid_mode_matches_jax_grad():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    jl, tl = JL.MaxPooling2D(2), TL.MaxPooling2D(2)
    jgx = jax.grad(lambda x_: jnp.sum(jl.call({}, x_) ** 2))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tgx,) = torch.autograd.grad((tl.call({}, tx) ** 2).sum(), [tx])
    _rel_close(tgx, jgx, 1e-5)


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["softmax_cross_entropy",
                                  "sparse_categorical_crossentropy",
                                  "categorical_crossentropy", "mse", "mae",
                                  "rank_hinge"])
def test_losses_match_jax(name):
    rs = np.random.RandomState(2)
    logits = rs.randn(6, 5).astype(np.float32)
    labels = rs.randint(0, 5, size=(6, 1)).astype(np.int32)
    if name == "softmax_cross_entropy":
        pred, y = logits, labels
    elif name == "sparse_categorical_crossentropy":
        pred, y = np.array(jax.nn.softmax(logits)), labels[:, 0]
    elif name == "categorical_crossentropy":
        pred = np.array(jax.nn.softmax(logits))
        y = np.eye(5, dtype=np.float32)[labels[:, 0]]
    else:
        pred, y = logits, rs.randn(6, 5).astype(np.float32)
    jfn, tfn = jlosses.get(name), tlosses.get(name)
    want, jg = jax.value_and_grad(lambda p: jfn(jnp.asarray(y), p))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(torch.from_numpy(y), tp)
    (tg,) = torch.autograd.grad(got, [tp])
    _rel_close(got, want, 1e-6, name)
    _rel_close(tg, jg, 1e-6, "grad " + name)


def test_loss_lookup():
    assert tlosses.get("mean_squared_error") is tlosses.mean_squared_error
    assert tlosses.get("sparse_categorical_crossentropy_from_logits") is \
        tlosses.softmax_cross_entropy
    with pytest.raises(ValueError, match="unknown"):
        tlosses.get("hinge_nope")


# -- optimizers --------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ("sgd", dict(lr=lambda step: 0.1 / (1 + step), momentum=0.5)),
    ("adam", dict(lr=1e-2)),
    ("adam", dict(lr=1e-2, beta_1=0.8, weight_decay=1e-2)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizer_steps_match_optax(name, kw):
    rs = np.random.RandomState(3)
    params = {"a": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cls = {"sgd": (jopt.SGD, topt.SGD), "adam": (jopt.Adam, topt.Adam)}
    tx = cls[name][0](**kw).to_optax()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    opt = cls[name][1](**kw)
    leaves = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    tstate = opt.init(leaves)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(leaves, [torch.from_numpy(g[k]) for k in ("a", "b")],
                   tstate)
    for k, leaf in zip(("a", "b"), leaves):
        _rel_close(leaf, jp[k], 1e-6, k)
    assert tstate["count"] == 3
    moments = optax_state_to_numpy(jax.device_get(state))
    for key in ("trace", "mu", "nu"):
        if key in tstate:
            for k, leaf in zip(("a", "b"), tstate[key]):
                _rel_close(leaf, moments[key][k], 1e-6, f"{key}/{k}")


def test_optimizer_lookup():
    assert isinstance(topt.get("adam"), topt.Adam)
    sgd = topt.SGD(lr=0.5)
    assert topt.get(sgd) is sgd
    with pytest.raises(ValueError, match="unknown"):
        topt.get("rmsprop_nope")


# -- the fused bottleneck in training -----------------------------------------

def _trainable_paths(tree, prefix=()):
    for k, v in tree.items():
        if k == "_state":
            continue
        if isinstance(v, dict):
            yield from _trainable_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("stride,downsample,channels", [
    (1, False, 256), (2, True, 64)])
def test_fused_bottleneck_training_matches_jax(stride, downsample,
                                               channels):
    rs = np.random.RandomState(4)
    shape = (8, 8, channels)
    jblk = jr.FusedBottleneck(64, stride=stride, downsample=downsample)
    p = jax.device_get(jblk.build(jax.random.key(0), shape))
    for grp in [v for v in p.values() if isinstance(v, dict)]:
        n = grp["gamma"].shape[0]
        grp["gamma"] = (1 + rs.randn(n) * 0.1).astype(np.float32)
        grp["beta"] = (rs.randn(n) * 0.1).astype(np.float32)
        grp["_state"]["moving_mean"] = (rs.randn(n) * 0.1).astype(
            np.float32)
    x = rs.randn(2, *shape).astype(np.float32)
    out_shape = (2, 8 // stride, 8 // stride, 256)
    c = rs.randn(*out_shape).astype(np.float32)

    def jloss(p_, x_):
        out, upd = jblk.apply(p_, x_, training=True)
        return jnp.sum(out * c), (out, upd)
    (_, (want, jupd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, x)

    tblk = tr.FusedBottleneck(64, stride=stride, downsample=downsample)
    tp = params_from_numpy(p)
    paths = list(_trainable_paths(tp))
    for path in paths:
        _get(tp, path).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got, tupd = tblk.apply(tp, tx, training=True)
    _rel_close(got, want, 1e-4, "out")
    _tree_close(params_to_numpy(tupd), jax.device_get(jupd), 1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                                [tx] + [_get(tp, q) for q in paths])
    _rel_close(grads[0], jgx, 1e-4, "dx")
    for path, g in zip(paths, grads[1:]):
        _rel_close(g, _get(jgp, path), 1e-4, "d" + "/".join(path))


# -- the slice: Estimator.train, 3 f32 SGD-momentum steps ---------------------

def _small_resnet(E, L, R, M):
    """A ResNet-50 head cut to two blocks: the 7x7/s2 stem, the 3x3/s2
    max pool, a stride-1 and a stride-2 downsampling FusedBottleneck,
    global pooling and the classifier."""
    inp = E.Input((16, 16, 3), name="image")
    x = R.conv_bn(inp, 64, 7, stride=2, name="stem")
    x = L.MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = R.FusedBottleneck(64, stride=1, downsample=True, name="s0b0")(x)
    x = R.FusedBottleneck(64, stride=2, downsample=True, name="s1b0")(x)
    x = L.GlobalAveragePooling2D()(x)
    return M(inp, L.Dense(10, name="fc")(x))


def test_estimator_train_slice_matches_jax():
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    jm = _small_resnet(je, JL, jr, jmodels.Model)
    p = jax.device_get(jm.init_params(jax.random.key(0)))
    rs = np.random.RandomState(5)
    b = 8
    x = rs.rand(3 * b, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, size=(3 * b, 1)).astype(np.int32)

    jest = jest_mod.Estimator(jm, optimizer=jopt.SGD(lr=0.01, momentum=0.9),
                              loss="softmax_cross_entropy")
    jest.params = jax.device_put(p)       # the same weights on both sides
    tm = _small_resnet(te, TL, tr, tmodels.Model)
    test = test_mod.Estimator(tm, optimizer=topt.SGD(lr=0.01, momentum=0.9),
                              loss="softmax_cross_entropy")
    test.params = p
    assert test.dtype_policy == jest.dtype_policy == "float32"
    jl, tl = [], []
    for i in range(3):                    # one step per call
        sl = slice(i * b, (i + 1) * b)
        jl.append(jest.train(x[sl], y[sl], batch_size=b).history[-1]["loss"])
        res = test.train(x[sl], y[sl], batch_size=b)
        tl.append(res.history[-1]["loss"])
        assert res.history[-1]["losses"] == [tl[-1]]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert res.step == test.step == jest.step == 3
    # final params and moving stats, and the optimizer's momentum
    _tree_close(params_to_numpy(tm), jax.device_get(jest.params), 1e-4)
    ts = opt_state_to_numpy(test)
    js = optax_state_to_numpy(jax.device_get(jest.opt_state))
    assert int(ts["count"]) == 3
    _tree_close(ts["trace"], js["trace"], 1e-4)
    # the train counters
    snap = tobs.snapshot()
    assert snap["zoo_tpu_train_steps_total"]["values"][0]["value"] == 3
    assert snap["zoo_tpu_train_examples_total"]["values"][0]["value"] == 24
    assert snap["zoo_tpu_train_step_seconds"]["values"][0]["count"] == 3


def test_trainable_mask_matches_jax():
    jm = _small_resnet(je, JL, jr, jmodels.Model)
    tm = _small_resnet(te, TL, tr, tmodels.Model)
    p = jax.device_get(jm.init_params(jax.random.key(0)))
    tm.load_params(p, device="cpu")
    jm.freeze("fc")
    tm.freeze("fc")
    assert tm.trainable_mask(tm.params()) == jm.trainable_mask(p)
    assert tm.trainable_mask(tm.params())["s0b0"]["bn1"] == {
        "gamma": True, "beta": True,
        "_state": {"moving_mean": False, "moving_var": False}}
    assert float(tm.regularization_loss(tm.params())) == 0.0


def test_compile_fit_evaluate_match_jax():
    # Keras surface: compile's defaults (Adam, mse) route to the
    # Estimator; two epochs of two shuffled batches
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    rs = np.random.RandomState(6)
    x = rs.randn(10, 4).astype(np.float32)
    y = rs.randn(10, 2).astype(np.float32)
    jm = jmodels.Sequential([JL.Dense(8, activation="relu",
                                      input_shape=(4,)), JL.Dense(2)])
    tm = tmodels.Sequential([TL.Dense(8, activation="relu",
                                      input_shape=(4,)), TL.Dense(2)])
    jm.compile()
    tm.compile()
    jm.estimator.params = jax.device_put(jm.init_params(jax.random.key(1)))
    tm.estimator.params = jax.device_get(jm.estimator.params)
    jh = jm.fit(x, y, batch_size=4, nb_epoch=2).history
    th = tm.fit(x, y, batch_size=4, nb_epoch=2).history
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    assert [len(h["losses"]) for h in th] == [2, 2]   # tail dropped
    _tree_close(params_to_numpy(tm), jax.device_get(jm.estimator.params),
                1e-5)
    np.testing.assert_allclose(tm.evaluate(x, y, batch_size=4)["loss"],
                               jm.evaluate(x, y, batch_size=4)["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(tm.estimator.predict(x, batch_size=3),
                               np.asarray(jm.predict(x, batch_size=3)),
                               rtol=1e-5, atol=1e-6)


def test_array_dataset_order_matches_jax():
    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    y = np.arange(11)
    jb = list(jest_mod.ArrayDataset(x, y).iter_batches(4, seed=2))
    tb = list(test_mod.ArrayDataset(x, y).iter_batches(4, seed=2))
    assert len(tb) == len(jb) == 2                # last 3 samples dropped
    for (jx, jy), (tx, ty) in zip(jb, tb):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_triggers_and_batch_check():
    ctx = tzoo.init_nncontext(seed=0, device="cpu")
    assert ctx.check_batch_size(3) == 3
    with pytest.raises(ValueError, match="batch_size"):
        ctx.check_batch_size(0)
    assert test_mod.MaxIteration(2)(0, 2, False)
    assert not test_mod.MaxEpoch(2)(1, 5, True)
    assert test_mod.EveryEpoch()(1, 5, True)
    # end_trigger stops mid-epoch
    tm = tmodels.Sequential([TL.Dense(2, input_shape=(3,))])
    est = test_mod.Estimator(tm, optimizer="sgd", loss="mse")
    x = np.ones((8, 3), np.float32)
    res = est.train(x, np.zeros((8, 2), np.float32), batch_size=2,
                    nb_epoch=3, end_trigger=test_mod.MaxIteration(3))
    assert res.step == 3 and len(res.history) == 1
    with pytest.raises(ValueError, match="dtype_policy"):
        test_mod.Estimator(tm, dtype_policy="float16")
