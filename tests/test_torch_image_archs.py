"""The image-classification family of the port against the JAX package,
on the CPU, on the same numpy weights and inputs.

- Each block of ``archs.py`` (``_inception_module``, ``_dw_block``,
  ``_inverted_residual``, ``_dense_layer``, ``_fire``) as a small Model
  at narrow widths: the eval forward, and one SGD step through the
  port's ``compile``/``fit`` against the JAX package's gradient and
  BatchNorm updates on the same batch (the loss, every updated leaf and
  moving statistic).
- Whole ``lenet5`` and ``inception_v1`` at 32x32 and 7 classes, the
  same two checks, with every Dropout's rate set to 0 on both instances.
- The param trees of every architecture but the ResNets at 64x64 equal
  the reference's in names and shapes (``jax.eval_shape`` of its
  ``init``), and such a tree, filled with numpy values, loads into the
  port through the bridge leaf for leaf.
- ``ImageClassifier.ARCHS``, the fused flag, ``load_model`` and
  ``ImageClassificationConfig`` on ``.npz``/``.model`` files the tests
  write.

JAX builds whole architectures for LeNet-5 and Inception-v1 only (its
initializers are slow here); the port's seeded init supplies the weights
both sides use. f32 within 1e-5, but Inception-v1's step (its test says
why).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models import config as jconfig
from analytics_zoo_tpu.models.image.imageclassification import archs as jarchs
from analytics_zoo_tpu.models.image.imageclassification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.models.image.imageclassification.lenet import \
    lenet5 as jlenet5
from analytics_zoo_tpu.ops import losses as jlosses
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras.layers import Dropout as JDropout
from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.models import config as tconfig
from analytics_zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier, archs as tarchs, lenet5)
from analytics_zoo_tpu_torch.ops.optimizers import SGD
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input as TInput
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    Dropout as TDropout
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model as TModel

TOL = 1e-5
LR = 0.1


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _tree_close(got, want, path="", tol=TOL):
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{path}/{k}", tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=tol,
                                       atol=tol, err_msg=f"{path}/{k}")


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), np.dtype(v.dtype).name) for k, v in tree.items()}


def _zero_dropout(*models):
    for m in models:
        for lyr in m.layers:
            if isinstance(lyr, (JDropout, TDropout)):
                lyr.p = 0.0


def _jax_sgd_step(jm, p, x, y, loss):
    """The JAX package's loss, one SGD step of the trainable leaves and
    the BatchNorm updates on ``(x, y)``: ``(loss, new params)``."""
    def f(p):
        out, upd = jm.apply(p, jnp.asarray(x), training=True,
                            rng=jax.random.key(0))
        return jnp.mean(jlosses.get(loss)(jnp.asarray(y), out)), upd

    (val, upd), g = jax.jit(jax.value_and_grad(f, has_aux=True))(p)

    def step(p, g, upd):
        out = {}
        for k, v in p.items():
            if k == "_state":
                out[k] = {s: np.asarray(upd.get("_state", {}).get(s, w))
                          for s, w in v.items()}
            elif isinstance(v, dict):
                out[k] = step(v, g[k], upd.get(k, {}))
            else:
                out[k] = np.asarray(v) - LR * np.asarray(g[k])
        return out

    return float(val), step(p, jax.device_get(g), jax.device_get(upd))


def _updates_close(got, want, before, rel):
    """Each trainable leaf's update ``after - before`` within ``rel`` of
    that leaf's largest update; moving statistics within 1e-5."""
    for k, v in want.items():
        if k == "_state":
            _tree_close(got[k], v)
        elif isinstance(v, dict):
            _updates_close(got[k], v, before[k], rel)
        else:
            du, dw = got[k] - before[k], np.asarray(v) - before[k]
            bound = rel * max(float(np.abs(dw).max()), 1e-12)
            assert float(np.abs(du - dw).max()) <= bound, (k, bound)


def _held_to_jax(jm, tm, x, y, loss, tol=TOL, update_rel=None):
    """``tm`` initialized by the port; JAX runs the same weights: the
    eval forward, then one SGD step (the port's ``fit`` over one batch
    of all of ``x``) against the JAX package's: the updated tree within
    ``tol``, or with ``update_rel`` each leaf's update within that share
    of its largest."""
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    p = params_to_numpy(tm)
    assert _shapes(p) == _shapes(jax.eval_shape(
        lambda k: jm.init(k), jax.random.key(0)))
    want = np.asarray(jax.jit(lambda p, x: jm.call(p, x))(p, x))
    got = tm.predict(x)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.ptp(want, axis=0).max() > 100 * tol     # inputs move them
    jloss, jnext = _jax_sgd_step(jm, p, x, y, loss)
    tm.compile(optimizer=SGD(lr=LR), loss=loss)
    hist = tm.fit(x, y, batch_size=len(x), nb_epoch=1).history
    np.testing.assert_allclose(hist[0]["loss"], jloss, rtol=tol)
    if update_rel is None:
        _tree_close(params_to_numpy(tm), jnext, tol=tol)
    else:
        _updates_close(params_to_numpy(tm), jnext, p, update_rel)


def _images(n, size, c=3, seed=0):
    """Images whose brightness differs between samples, so the logits
    differ from image to image."""
    rs = np.random.RandomState(seed)
    scale = np.linspace(0.2, 2.0, n).astype(np.float32)[:, None, None, None]
    return (rs.rand(n, size, size, c).astype(np.float32) * scale,
            rs.randint(0, 7, (n, 1)).astype(np.int32))


# -- blocks -------------------------------------------------------------------

def _block(arch, lib, name, c):
    Inp, M = (JInput, JModel) if lib == "jax" else (TInput, TModel)
    x = Inp((8, 8, c), name="image")
    y = {
        "_inception_module": lambda v: arch._inception_module(
            v, 4, 3, 6, 2, 3, 5, "i"),
        "_dw_block": lambda v: arch._dw_block(v, 6, 2, "b", alpha=1.0),
        "_inverted_residual": lambda v: arch._inverted_residual(
            v, c, c, 1, 3, "ir"),
        "_dense_layer": lambda v: arch._dense_layer(v, 4, "d"),
        "_fire": lambda v: arch._fire(v, 3, 5, "f"),
    }[name](x)
    return M(x, y)


@pytest.mark.parametrize("name", ["_inception_module", "_dw_block",
                                  "_inverted_residual", "_dense_layer",
                                  "_fire"])
def test_block_forward_and_sgd_step_match_jax(name):
    jm, tm = _block(jarchs, "jax", name, 4), _block(tarchs, "torch", name, 4)
    x = _images(4, 8, c=4, seed=1)[0]
    # a regression target over the block's output, summed to a scalar
    # per sample: "mse" against zeros of the output's shape
    y = np.zeros((4,) + tuple(tm.outputs[0].shape), np.float32)
    _held_to_jax(jm, tm, x, y, "mse")


def test_inverted_residual_with_expansion_and_stride():
    """MobileNet-v2's strided, channel-changing block has no residual."""
    def build(arch, Inp, M):
        x = Inp((7, 7, 4), name="image")
        return M(x, arch._inverted_residual(x, 4, 6, 2, 6, "ir"))
    jm, tm = build(jarchs, JInput, JModel), build(tarchs, TInput, TModel)
    assert "add_1" not in tm.graph_layers
    x = _images(3, 7, c=4, seed=2)[0]
    y = np.zeros((3, 4, 4, 6), np.float32)
    _held_to_jax(jm, tm, x, y, "mse")


# -- whole architectures ------------------------------------------------------

def test_lenet5_forward_and_sgd_step_match_jax():
    jm, tm = jlenet5(classes=7), lenet5(classes=7)
    _zero_dropout(jm, tm)
    x, y = _images(6, 28, c=1, seed=3)
    _held_to_jax(jm, tm, x, y, "sparse_categorical_crossentropy")


def test_inception_v1_forward_and_sgd_step_match_jax():
    """At this depth, on 8 images and at random init, the first step's
    f32 gradient is ill-conditioned in the early layers (BatchNorm over
    few samples): the two packages' updates there differ by more than
    1e-5 of the weights, from rounding alone. So the step is held by
    each leaf's update, within 1e-3 of that leaf's largest update, and
    the loss and the moving statistics within 1e-5."""
    jm = jarchs.inception_v1(input_shape=(32, 32, 3), classes=7)
    tm = tarchs.inception_v1(input_shape=(32, 32, 3), classes=7)
    _zero_dropout(jm, tm)
    x, y = _images(8, 32, seed=4)
    _held_to_jax(jm, tm, x, y, "softmax_cross_entropy", update_rel=1e-3)


_BUILDERS = ["lenet-5", "vgg-16", "vgg-19", "inception-v1", "mobilenet",
             "mobilenet-v2", "densenet-121", "squeezenet"]


@pytest.mark.parametrize("name", _BUILDERS)
def test_param_tree_equals_reference_and_bridges(name):
    shape = (28, 28, 1) if name == "lenet-5" else (64, 64, 3)
    jm = JImageClassifier(name, input_shape=shape, classes=7).model
    want = _shapes(jax.eval_shape(lambda k: jm.init(k), jax.random.key(0)))
    tm = ImageClassifier(name, input_shape=shape, classes=7).model
    tm.init(torch.Generator().manual_seed(0))
    assert _shapes(params_to_numpy(tm)) == want
    assert tm.output_shape == jm.compute_output_shape(shape) == (7,)
    # a reference-format tree (the eval_shape's structure, numpy values)
    # loads through the bridge unchanged
    rs = np.random.RandomState(0)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                rs.randn(*v[0]).astype(v[1]) for k, v in t.items()}
    tree = fill(want)
    tm.load_params(tree, device="cpu")
    got = params_to_numpy(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, tree)


# -- the registry and the weights' resolution ---------------------------------

def test_archs_registry_equals_reference():
    assert ImageClassifier.ARCHS == JImageClassifier.ARCHS
    assert ImageClassifier("squeezenet").ARCHS == ImageClassifier.ARCHS
    assert len(ImageClassifier.ARCHS) == 11
    assert tconfig.ImageClassificationConfig.names() == \
        jconfig.ImageClassificationConfig.names()
    with pytest.raises(ValueError, match="ResNet-only"):
        ImageClassifier("mobilenet", fused=True)
    with pytest.raises(ValueError, match="unknown architecture"):
        ImageClassifier("alexnet")
    assert ImageClassifier("vgg-16").fused is False
    clf = ImageClassifier("LeNet-5", input_shape=(28, 28, 1), classes=10)
    assert clf.model_name == "lenet-5" and clf.model.name == "lenet5"
    for published in ("analytics-zoo_inception-v1_imagenet_0.1.0",
                      "zoo_vgg-16_imagenet_0.1.0", "mobilenet"):
        assert tconfig._strip_published_name(published) == \
            jconfig._strip_published_name(published)


def test_weights_resolution_order(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_PRETRAINED_DIR", str(tmp_path))
    name = "analytics-zoo_squeezenet_imagenet_0.1.0"
    for stem, ext in (("squeezenet", ".model"), (name, ".model"),
                      ("squeezenet", ".npz")):
        (tmp_path / (stem + ext)).write_bytes(b"")
        got = tconfig._resolve_weights(name, "squeezenet", None)
        assert got == jconfig._resolve_weights(name, "squeezenet", None)
    # every .npz before any .model, the published name first
    assert got == str(tmp_path / "squeezenet.npz")
    explicit = tmp_path / "w.npz"
    explicit.write_bytes(b"")
    assert tconfig._resolve_weights(name, "squeezenet", str(explicit)) == \
        str(explicit)
    with pytest.raises(FileNotFoundError):
        tconfig._resolve_weights(name, "squeezenet", str(tmp_path / "no"))
    monkeypatch.delenv("ZOO_TPU_PRETRAINED_DIR")
    assert tconfig._resolve_weights(name, "squeezenet", None) is None


def test_load_model_by_name_and_path(tmp_path, monkeypatch):
    monkeypatch.delenv("ZOO_TPU_PRETRAINED_DIR", raising=False)
    kw = dict(input_shape=(28, 28, 1), classes=10)
    with pytest.raises(FileNotFoundError, match="no pretrained weights"):
        ImageClassifier.load_model("lenet-5", **kw)
    rand = ImageClassifier.load_model("lenet-5", allow_random=True, **kw)
    assert rand.model_name == "lenet-5"
    # a weight file written by the JAX package loads, shapes checked
    jclf = JImageClassifier("lenet-5", **kw)
    jclf.compile()
    jclf.model.estimator._ensure_initialized()
    wfile = str(tmp_path / "lenet-5.npz")
    jclf.save_weights(wfile)
    x = _images(3, 28, c=1, seed=5)[0]
    want = np.asarray(jclf.predict(x))
    got = ImageClassifier.load_model("lenet-5", weights_path=wfile, **kw)
    np.testing.assert_allclose(got.predict(x), want, rtol=TOL, atol=TOL)
    # the same file found under $ZOO_TPU_PRETRAINED_DIR by published name
    monkeypatch.setenv("ZOO_TPU_PRETRAINED_DIR", str(tmp_path))
    by_dir = tconfig.ImageClassificationConfig.create(
        "analytics-zoo_lenet-5_mnist_0.1.0", **kw)
    np.testing.assert_allclose(by_dir.predict(x), want, rtol=TOL, atol=TOL)
    # a shape mismatch raises
    with pytest.raises(ValueError, match="does not match"):
        ImageClassifier.load_model("lenet-5", weights_path=wfile,
                                   input_shape=(28, 28, 1), classes=7)
    # a .model artifact goes through the BigDL loader (Net.load_bigdl):
    # a file that does not parse raises there, as in the reference, and
    # never falls back to random weights
    (tmp_path / "squeezenet.model").write_bytes(b"\x00")
    with pytest.raises(IndexError):
        ImageClassifier.load_model("squeezenet")
    with pytest.raises(IndexError):
        tconfig.ImageClassificationConfig.create("squeezenet",
                                                 allow_random=True)
    # anything else is a save_model path
    saved = str(tmp_path / "saved.zoo")
    got.save_model(saved)
    back = ImageClassifier.load_model(saved)
    assert back.hyper_parameters() == got.hyper_parameters()
    np.testing.assert_allclose(back.predict(x), want, rtol=TOL, atol=TOL)
    assert os.path.exists(saved)
