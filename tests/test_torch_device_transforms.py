"""The port's batched augmentation (``feature/image/device_transforms``)
and the Estimator's ``augment`` against the JAX package's, on the CPU.

Each op's ``apply`` is handed the very parameters the reference's op
draws from its ``jax.random`` key (re-derived here as the reference
derives them) and held to the reference's output: crops, flips and
cutout bit for bit; brightness, contrast, saturation and normalisation
within 1e-4 and hue and the resized crop within 1e-3, on the 0-255
scale. The resized crop is held at windows that upscale, that
downscale, and that span the whole height. Then: each op's own
``sample``, ``augment_pipeline``'s positional seeds, the argument
conventions, the Estimator's two SGD steps with a deterministic augment
(losses within 1e-5 relative), augmentation in training only, the
f32-then-bf16 order under ``mixed_bfloat16``, the net's seed independent
of the augment, the augment's products in the step's FLOP count, and
the ``resnet_imagenet`` example on a folder of PNGs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.feature.image import device_transforms as JD
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline import estimator as jest
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JS
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.feature.image import device_transforms as TD
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.pipeline import estimator as test_
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

N, H, W = 6, 16, 20


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _batch(seed=0, n=N, h=H, w=W):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.float32)


# -- the reference's draws, re-derived from its key ---------------------------

def _crop_draws(key, x, ch, cw):
    ky, kx = jax.random.split(key)
    n, h, w, _ = x.shape
    return {"y": jax.random.randint(ky, (n,), 0, h - ch + 1),
            "x": jax.random.randint(kx, (n,), 0, w - cw + 1)}


def _cutout_draws(key, x, s):
    ky, kx = jax.random.split(key)
    n, h, w, _ = x.shape
    return {"y": jax.random.randint(ky, (n, 1, 1), 0, max(h - s, 0) + 1),
            "x": jax.random.randint(kx, (n, 1, 1), 0, max(w - s, 0) + 1)}


def _uniform_draws(name, shape, lo, hi, scale=1.0):
    return lambda key, x: {name: jax.random.uniform(
        key, (x.shape[0],) + shape, minval=lo, maxval=hi) * scale}


def _rrc_draws(scale, ratio=(0.75, 4 / 3)):
    def draws(key, x):
        n, h, w, _ = x.shape
        k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
        area = jax.random.uniform(k_area, (n,), minval=scale[0],
                                  maxval=scale[1]) * (h * w)
        r = jnp.exp(jax.random.uniform(k_ratio, (n,),
                                       minval=jnp.log(ratio[0]),
                                       maxval=jnp.log(ratio[1])))
        ww = jnp.clip(jnp.sqrt(area * r), 1.0, float(w))
        wh = jnp.clip(jnp.sqrt(area / r), 1.0, float(h))
        return {"y0": jax.random.uniform(k_y, (n,)) * (h - wh),
                "x0": jax.random.uniform(k_x, (n,)) * (w - ww),
                "wh": wh, "ww": ww}
    return draws


# (name, build(M), draws(key, x), tolerance on the 0-255 scale)
OPS = [
    ("random_crop", lambda M: M.random_crop((8, 10)),
     lambda k, x: _crop_draws(k, x, 8, 10), 0.0),
    ("center_crop", lambda M: M.center_crop((9, 7)), lambda k, x: {}, 0.0),
    ("random_hflip", lambda M: M.random_hflip(),
     lambda k, x: {"flip": jax.random.bernoulli(k, 0.5, (x.shape[0],))}, 0.0),
    ("cutout", lambda M: M.cutout(6, fill=3.0),
     lambda k, x: _cutout_draws(k, x, 6), 0.0),
    ("random_brightness", lambda M: M.random_brightness(32.0),
     _uniform_draws("delta", (1, 1, 1), -32.0, 32.0), 1e-4),
    ("random_brightness-2", lambda M: M.random_brightness(-80.0, 90.0),
     _uniform_draws("delta", (1, 1, 1), -80.0, 90.0), 1e-4),
    ("random_contrast", lambda M: M.random_contrast(),
     _uniform_draws("factor", (1, 1, 1), 0.5, 1.5), 1e-4),
    ("random_saturation", lambda M: M.random_saturation(0.3),
     _uniform_draws("factor", (1, 1, 1), 0.7, 1.3), 1e-4),
    ("random_hue", lambda M: M.random_hue(),
     _uniform_draws("theta", (1, 1), -18.0, 18.0, np.pi / 180.0), 1e-3),
    ("random_hue-2", lambda M: M.random_hue(-40.0, 120.0),
     _uniform_draws("theta", (1, 1), -40.0, 120.0, np.pi / 180.0), 1e-3),
    ("normalize", lambda M: M.normalize((123.68, 116.779, 103.939),
                                        (58.393, 57.12, 57.375)),
     lambda k, x: {}, 1e-4),
    # windows of 2-5 pixels to 24 x 30: every axis upscales
    ("random_resized_crop-up",
     lambda M: M.random_resized_crop((24, 30), scale=(0.02, 0.08)),
     _rrc_draws((0.02, 0.08)), 1e-3),
    # windows of 13-20 pixels to 6 x 6: every axis downscales (the widened
    # triangle kernel)
    ("random_resized_crop-down",
     lambda M: M.random_resized_crop((6, 6), scale=(0.8, 1.0)),
     _rrc_draws((0.8, 1.0)), 1e-3),
    # the whole height (y0 = 0, wh = h): the samples reach both borders
    ("random_resized_crop-border",
     lambda M: M.random_resized_crop((11, 11), scale=(1.0, 1.0),
                                     ratio=(1.0, 1.0)),
     _rrc_draws((1.0, 1.0), (1.0, 1.0)), 1e-3),
]


@pytest.mark.parametrize("name, build, draws, tol", OPS,
                         ids=[o[0] for o in OPS])
def test_apply_on_the_references_draws(name, build, draws, tol):
    x = _batch(1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(build(JD)(key, jnp.asarray(x)))
    params = {k: torch.from_numpy(np.array(v)).reshape(
        (N,) + np.shape(v)[1:] if k not in ("y", "x") else (N,))
        for k, v in draws(key, x).items()}
    got = build(TD).apply(torch.from_numpy(x), params).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= tol, (name, err)
    if name.endswith("-up"):
        assert (params["wh"] < 24).all() and (params["ww"] < 30).all()
    if name.endswith("-down"):
        assert (params["wh"] > 6).all() and (params["ww"] > 6).all()
    if name.endswith("-border"):
        assert (params["y0"] == 0).all() and (params["wh"] == H).all()


@pytest.mark.parametrize("name, build", [(o[0], o[1]) for o in OPS],
                         ids=[o[0] for o in OPS])
def test_own_draws_and_call(name, build):
    x = torch.from_numpy(_batch(2))
    op = build(TD)
    params = op.sample(11, x)
    for v in params.values():
        assert v.shape[0] == N and v.device == x.device
    out = op(11, x)
    torch.testing.assert_close(out, op.apply(x, params), rtol=0, atol=0)
    torch.testing.assert_close(op(11, x), out, rtol=0, atol=0)
    if params:
        other = op.sample(12, x)
        assert any(not torch.equal(params[k], other[k]) for k in params)
    if "y0" in params:
        _, h, w, _ = x.shape
        assert (params["y0"] >= 0).all() and \
            (params["y0"] + params["wh"] <= h + 1e-4).all()
        assert (params["x0"] >= 0).all() and \
            (params["x0"] + params["ww"] <= w + 1e-4).all()
    if "delta" in params or "factor" in params:
        assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0


def test_pipeline_seeds_are_positional():
    x = torch.from_numpy(_batch(3))
    ops = [TD.random_crop((10, 12)), TD.random_hflip(),
           TD.random_brightness(20.0)]
    two = TD.augment_pipeline(*ops[:2])
    three = TD.augment_pipeline(*ops)
    # appending an op keeps the earlier ops' draws
    torch.testing.assert_close(
        three(5, x), ops[2](fold_in(5, 2), two(5, x)), rtol=0, atol=0)
    manual = x
    for i, op in enumerate(ops):
        manual = op.apply(manual, op.sample(fold_in(5, i), manual))
    torch.testing.assert_close(three(5, x), manual, rtol=0, atol=0)
    # inserting one moves the draws of the ops after it
    inserted = TD.augment_pipeline(ops[0], TD.cutout(1), *ops[1:])
    assert not torch.equal(inserted(5, x)[..., 1:-1, :],
                           three(5, x)[..., 1:-1, :])
    assert not torch.equal(three(6, x), three(5, x))


def test_argument_conventions_match_jax():
    for args in ((None, None), (0.2, None), (1.5, None), (0.3, 0.9)):
        assert TD._factor_range(*args) == JD._factor_range(*args)
    for M in (TD, JD):
        with pytest.raises(ValueError, match="empty factor range"):
            M.random_saturation(1.5, 0.5)
        with pytest.raises(ValueError, match="empty degree range"):
            M.random_hue(30.0, 18.0)
    with pytest.raises(ValueError, match="larger than input"):
        TD.random_crop((64, 64))(0, torch.zeros(2, 8, 8, 3))
    with pytest.raises(ValueError, match="larger than input"):
        TD.center_crop((9, 2)).apply(torch.zeros(2, 8, 8, 3), {})
    # one-argument hue is symmetric: both signs occur
    theta = TD.random_hue(30.0).sample(0, torch.zeros(64, 2, 2, 3))["theta"]
    assert (theta < 0).any() and (theta > 0).any()
    assert float(theta.abs().max()) <= 30.0 * np.pi / 180.0 + 1e-6


# -- the Estimator's augment --------------------------------------------------

def _conv_net(L, model, size):
    model.add(L.Convolution2D(4, 3, 3, activation="relu",
                              input_shape=(size, size, 3)))
    model.add(L.Flatten())
    model.add(L.Dense(3, activation="softmax"))
    return model


def test_two_sgd_steps_with_a_deterministic_augment_match_jax():
    x = _batch(4, n=16, h=10, w=10)
    y = np.random.RandomState(4).randint(0, 3, (16, 1)).astype(np.int32)

    def aug(M):
        return M.augment_pipeline(M.center_crop((8, 8)),
                                  M.normalize((120.0, 110.0, 100.0),
                                              (60.0, 50.0, 40.0)))
    jinit(seed=0)
    je = jest.Estimator(_conv_net(JL, JS(), 8), optimizer=jopt.SGD(0.1),
                        loss="sparse_categorical_crossentropy",
                        augment=aug(JD))
    je._ensure_initialized()
    te = test_.Estimator(_conv_net(TL, Sequential(), 8),
                         optimizer=topt.SGD(0.1),
                         loss="sparse_categorical_crossentropy",
                         augment=aug(TD))
    te.params = jax.device_get(je.params)
    # one whole-data step per epoch: each epoch's loss is one step's
    want = [h["loss"] for h in je.train(x, y, batch_size=16,
                                        nb_epoch=2).history]
    got = [h["loss"] for h in te.train(x, y, batch_size=16,
                                       nb_epoch=2).history]
    assert len(got) == len(want) == 2 and te.step == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _recording(fn, log):
    def run(seed, images):
        log.append((seed, images.dtype, tuple(images.shape)))
        return fn(seed, images)
    return run


def test_augment_runs_in_training_only():
    rs = np.random.RandomState(0)
    x = rs.rand(32, 8, 8, 3).astype(np.float32) * 255
    y = rs.randint(0, 2, (32, 1))
    calls = []

    def build(augment):
        tzoo.init_nncontext(seed=11, device="cpu")
        m = Sequential()
        m.add(TL.Flatten(input_shape=(6, 6, 3)))
        m.add(TL.Dense(2, activation="softmax"))
        return test_.Estimator(m, optimizer="sgd",
                               loss="sparse_categorical_crossentropy",
                               augment=augment)

    aug = _recording(TD.augment_pipeline(TD.random_crop((6, 6)),
                                         TD.random_hflip()), calls)
    est = build(aug)
    xe = x[:, :6, :6, :]
    res = est.train(x, y, batch_size=16, nb_epoch=2,
                    validation_data=(xe, y))
    assert np.isfinite(res.history[-1]["loss"])
    assert "val_loss" in res.history[-1]
    assert len(calls) == est.step == 4      # steps only, no validation
    assert all(shape == (16, 8, 8, 3) for _, _, shape in calls)
    est2 = build(None)
    est2.params = params_to_numpy(est.model)
    np.testing.assert_allclose(est.predict(xe, batch_size=16),
                               est2.predict(xe, batch_size=16), rtol=1e-6)
    e1 = est.evaluate(xe, y, batch_size=16)
    e2 = est2.evaluate(xe, y, batch_size=16)
    assert np.isclose(e1["loss"], e2["loss"], rtol=1e-6)
    assert len(calls) == 4


def test_mixed_policy_casts_after_the_augment_and_keeps_the_net_seed():
    x = _batch(5, n=8, h=10, w=10)
    y = np.random.RandomState(5).randint(0, 3, (8, 1))
    seen = {}

    def run(augment, key):
        tzoo.init_nncontext(seed=3, device="cpu")
        net = _conv_net(TL, Sequential(), 8)
        log = seen.setdefault(key, {"aug": [], "net": []})
        apply = net.apply

        def recording_apply(params, inputs, **kw):
            log["net"].append((inputs.dtype, kw.get("rng")))
            return apply(params, inputs, **kw)
        net.apply = recording_apply
        est = test_.Estimator(
            net, optimizer="sgd", loss="sparse_categorical_crossentropy",
            dtype_policy="mixed_bfloat16",
            augment=augment and _recording(augment, log["aug"]))
        est.train(x if augment else x[:, 1:9, 1:9], y, batch_size=4,
                  nb_epoch=1)
        return est

    est = run(TD.center_crop((8, 8)), "aug")
    run(None, "plain")
    assert [d for _, d, _ in seen["aug"]["aug"]] == [torch.float32] * 2
    assert [d for d, _ in seen["aug"]["net"]] == [torch.bfloat16] * 2
    # the net's seeds are the step's own, augment or not
    assert [r for _, r in seen["aug"]["net"]] == \
        [r for _, r in seen["plain"]["net"]]
    # the augment's seed is another: the step's folded once more
    assert all(s != r for (s, _, _), (_, r) in
               zip(seen["aug"]["aug"], seen["aug"]["net"]))
    assert est.evaluate(x[:, 1:9, 1:9], y, batch_size=4)["loss"] > 0


def test_the_augments_products_enter_the_flop_count():
    x = _batch(6, n=4, h=12, w=12)
    y = np.zeros((4, 1), np.int32)
    flops = {}
    for key, aug in (("plain", None),
                     ("rrc", TD.random_resized_crop((8, 8)))):
        tzoo.init_nncontext(seed=0, device="cpu")
        est = test_.Estimator(_conv_net(TL, Sequential(), 8),
                              optimizer="sgd",
                              loss="sparse_categorical_crossentropy",
                              augment=aug)
        est.train(x if aug else x[:, :8, :8], y, batch_size=4, nb_epoch=1)
        flops[key] = est.flops_per_step
    # the two resampling products: (n, 8, 12) x (n, 12, 12 * 3), then
    # (n, 8, 12) x (n, 12, 8 * 3)
    assert flops["rrc"] - flops["plain"] == \
        2 * 4 * 8 * 12 * 12 * 3 + 2 * 4 * 8 * 12 * 8 * 3


# -- the resnet_imagenet example ----------------------------------------------

def test_resnet_imagenet_recipe_on_a_folder(tmp_path):
    from PIL import Image

    from analytics_zoo_tpu_torch.examples import EXAMPLES, resnet_imagenet
    assert "resnet_imagenet" in EXAMPLES
    rs = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i in range(4):
            Image.fromarray(rs.randint(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(tmp_path / cls / f"{i}.png")
    args = ["--folder", str(tmp_path), "--image-size", "32",
            "--batch-per-device", "2", "--epochs", "1", "--fused", "0",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="A14"):
        resnet_imagenet.main(args + ["--devices", "2"])
    hist = resnet_imagenet.main(args + ["--checkpoint",
                                        str(tmp_path / "ck")])
    assert hist[-1]["step"] == 4 and np.isfinite(hist[-1]["loss"])
    assert (tmp_path / "ck" / "LATEST").exists()
