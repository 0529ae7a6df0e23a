"""The PyTorch port's ResNet as the reference's bench builds it (the
space-to-depth stem, the deferred-apply stage layout ``fused="defer"``,
the fused default's gate) against the JAX package's, on bridged numpy
weights.

The JAX stage runs its Pallas kernels in interpret mode under
``jax.jit``; the port runs the plain versions of its CUDA kernels (CPU
tensors). Tolerances, as a fraction of max(1, max|ref|) unless stated:
1e-5 for f32 outputs, BatchNorm updates and losses; 1e-4 of max|g| for
gradients; the four-block stage's output within 3e-5 of the JAX
package's, whose own distance from the same math in float64 is 1.2e-5,
and within 1e-5 of float64.

Each BatchNorm's moving mean is set to its batch mean, the regime the
shifted one-pass statistics are built for: at the initial moving mean of
0 the one-pass variance cancels, and reduction order alone parted the
port's unfused ResNet-50 from the JAX package's by 6e-4 of max|out| in
a training forward at 32x32. The whole ResNet-50's training step is
held to the JAX package's unfused graph (the same math; the JAX package
holds its own layouts to each other, and its fused kernels in interpret
mode would take minutes here): the loss within 1e-5, the updated
weights within chip_smoke.py's rule, twice the port's unfused graph's
own movement under a 1e-6 relative input change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models.image.imageclassification import resnet as jr
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline import estimator as jest_mod
from analytics_zoo_tpu_torch.bridge import params_from_numpy, \
    params_to_numpy
from analytics_zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier, resnet as tr)
from analytics_zoo_tpu_torch.ops import conv_bn as tcb
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline import estimator as test_mod
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_map(tree, dtype):
    return {k: _tree_map(v, dtype) if isinstance(v, dict) else
            v.astype(dtype) for k, v in tree.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _moving_at_batch_means(tree, upd):
    """Each BatchNorm's moving mean in the numpy ``tree`` set to its
    batch mean, from a training forward's ``upd`` at the initial moving
    mean of 0 (the new mean is 0.99 * 0 + 0.01 * batch mean)."""
    for k, v in upd.items():
        if k == "_state":
            tree["_state"]["moving_mean"] = (
                v["moving_mean"].numpy() / 0.01).astype(np.float32)
        else:
            _moving_at_batch_means(tree[k], v)
    return tree


# -- the space-to-depth stem -------------------------------------------------

def test_space_to_depth_stem_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    k = (rs.randn(4, 4, 12, 64) * 0.1).astype(np.float32)
    js, ts = jr.SpaceToDepth2D(2), tr.SpaceToDepth2D(2)
    jc, tc = jr.S2DStemConv(64), tr.S2DStemConv(64)
    want_s = js.call({}, jnp.asarray(x))
    got_s = ts.call({}, torch.from_numpy(x))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert ts.compute_output_shape((8, 8, 3)) == (4, 4, 12)
    with pytest.raises(ValueError, match="divisible"):
        ts.compute_output_shape((7, 8, 3))

    def jloss(k_, x_):
        y = jc.call({"kernel": k_}, js.call({}, x_))
        return jnp.sum(y * jnp.cos(y)), y
    (_, want), (jgk, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(k), jnp.asarray(x))
    tk = torch.from_numpy(k).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tc.call({"kernel": tk}, ts.call({}, tx))
    assert tc.compute_output_shape((4, 4, 12)) == (4, 4, 64)
    _close(got, want, 1e-5, "stem")
    gk, gx = torch.autograd.grad((got * torch.cos(got)).sum(), [tk, tx])
    _close(gk, jgk, 1e-4, "dkernel")
    _close(gx, jgx, 1e-4, "dx")
    # the param layout is the reference's
    tp = tc.build(torch.Generator().manual_seed(0), (4, 4, 12))
    assert {n: tuple(v.shape) for n, v in tp.items()} == {
        "kernel": (4, 4, 12, 64)}


def test_s2d_stem_kernel_gives_the_7x7_stem():
    # the 4x4 conv over the space-to-depth image with the converted
    # kernel is the 7x7/s2 SAME conv
    rs = np.random.RandomState(1)
    k7 = (rs.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    k4 = tr.s2d_stem_kernel(k7)
    np.testing.assert_array_equal(k4, jr.s2d_stem_kernel(k7))
    conv7 = Convolution2D(64, 7, 7, subsample=2, border_mode="same",
                          bias=False)
    want = conv7.call({"kernel": torch.from_numpy(k7)}, torch.from_numpy(x))
    got = tr.S2DStemConv(64).call(
        {"kernel": torch.from_numpy(k4)},
        tr.SpaceToDepth2D(2).call({}, torch.from_numpy(x)))
    _close(got, want.numpy(), 1e-5, "s2d stem vs 7x7/s2")
    with pytest.raises(ValueError, match="7x7"):
        tr.s2d_stem_kernel(k7[:5, :5])


# -- the deferred-apply stage ------------------------------------------------

def _stage_params(blocks, shapes, rs):
    """Seeded block params with gamma and beta off their init."""
    out = []
    for i, (blk, shp) in enumerate(zip(blocks, shapes)):
        p = params_to_numpy(blk.build(torch.Generator().manual_seed(i), shp))
        for bn in ("bn1", "bn2", "bn3", "bnd"):
            if bn in p:
                n = p[bn]["gamma"].shape[0]
                p[bn]["gamma"] = (rs.rand(n) + 0.5).astype(np.float32)
                p[bn]["beta"] = (rs.randn(n) * 0.1).astype(np.float32)
        out.append(p)
    return out


def test_fused_stage_forward_matches_jax(monkeypatch):
    # four blocks: a downsampling entry, then three identity blocks, so
    # b1 defers, b2 consumes and defers in turn, b3 consumes
    rs = np.random.RandomState(2)
    names = ["b0", "b1", "b2", "b3"]
    jblocks = [jr.FusedBottleneck(64, downsample=(i == 0), name=n)
               for i, n in enumerate(names)]
    tblocks = [tr.FusedBottleneck(64, downsample=(i == 0), name=n)
               for i, n in enumerate(names)]
    shapes = [(4, 4, 128)] + [(4, 4, 256)] * 3
    ps = _stage_params(tblocks, shapes, rs)
    x = rs.randn(2, 4, 4, 128).astype(np.float32)
    c = rs.randn(2, 4, 4, 256).astype(np.float32)
    with torch.no_grad():
        _, upds = tr.fused_stage_forward(
            tblocks, [params_from_numpy(p) for p in ps], torch.from_numpy(x))
    for p, u in zip(ps, upds):
        _moving_at_batch_means(p, u)

    def jloss(ps_, x_):
        out, upd = jr.fused_stage_forward(jblocks, ps_, x_, training=True)
        return jnp.sum(out * c), (out, upd)
    (_, (want, jupd)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(ps, x)

    consumed = []
    c1 = tr.conv1x1_bn

    def spy(*a, in_residual=None, **kw):
        consumed.append(in_residual is not None)
        return c1(*a, in_residual=in_residual, **kw)
    monkeypatch.setattr(tr, "conv1x1_bn", spy)
    tps = [params_from_numpy(p) for p in ps]
    paths = [[q for q, _ in _flat(p) if "_state" not in q] for p in tps]
    leaves = [_get(p, q) for p, qs in zip(tps, paths) for q in qs]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got, tupd = tr.fused_stage_forward(tblocks, tps, tx, training=True)
    # c1 of b2 and b3 took a pending input; b0's c1 and shortcut, b1's
    # c1 did not (c3 never does)
    c1_calls = [consumed[0], consumed[3], consumed[5], consumed[7]]
    assert c1_calls == [False, False, True, True] and sum(consumed) == 2
    # the JAX stage's output is itself 1.2e-5 of max|out| from the same
    # math in float64 (the port's, 1.2e-6): the port meets float64
    # within 1e-5 and the JAX stage within 3e-5
    _close(got, want, 3e-5, "out")
    with torch.no_grad():
        want64, _ = tr.fused_stage_forward(
            tblocks, [params_from_numpy(_tree_map(p, np.float64))
                      for p in ps], torch.from_numpy(x).double())
    _close(got, want64.float(), 1e-5, "out against float64")
    for b, (u_got, u_want) in enumerate(zip(tupd, jupd)):
        assert sorted(u_got) == sorted(u_want)
        for bn in u_got:
            for k in ("moving_mean", "moving_var"):
                _close(u_got[bn]["_state"][k],
                       u_want[bn]["_state"][k], 1e-5, f"b{b}/{bn}/{k}")
    grads = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                                [tx] + leaves)
    jg = jax.device_get(jgx)
    np.testing.assert_allclose(
        grads[0].numpy(), jg, atol=1e-4 * float(np.abs(jg).max()),
        rtol=1e-4, err_msg="dx")
    it = iter(grads[1:])
    for b, qs in enumerate(paths):
        for q in qs:
            want_g = np.asarray(_get(jgp[b], q))
            np.testing.assert_allclose(
                next(it).numpy(), want_g,
                atol=1e-4 * float(np.abs(want_g).max()), rtol=1e-4,
                err_msg=f"d b{b}/{'/'.join(q)}")


def test_fused_stage_layer_matches_per_block():
    # FusedStage across a stage transition (stride-2 entry) against
    # the same blocks run one by one, in both modes; its tree nests
    # the blocks' groups as b0, b1, ...
    rs = np.random.RandomState(3)
    s0 = tr.FusedStage(64, 2, first_stride=1, name="t0")
    s1 = tr.FusedStage(64, 3, first_stride=2, name="t1")
    p0 = s0.init(torch.Generator().manual_seed(0), (8, 8, 128))
    p1 = s1.init(torch.Generator().manual_seed(1), (8, 8, 256))
    assert sorted(p1) == ["b0", "b1", "b2"] and "bnd" in p1["b0"]
    assert s1.output_shape == (4, 4, 256)
    x = torch.from_numpy(rs.randn(2, 8, 8, 128).astype(np.float32))
    for training in (True, False):
        a, u0 = s0.apply(p0, x, training=training)
        got, u1 = s1.apply(p1, a, training=training)
        ref, upds = x, []
        for stage, params in ((s0, p0), (s1, p1)):
            for b, blk in enumerate(stage.blocks):
                ref, u = blk.apply(params[f"b{b}"], ref, training=training)
                upds.append(u)
        _close(got, ref.numpy(), 1e-5, f"training={training}")
        if training:
            assert sorted(u1) == ["b0", "b1", "b2"]
            _close(u1["b2"]["bn3"]["_state"]["moving_var"],
                   upds[-1]["bn3"]["_state"]["moving_var"].numpy(), 1e-5)
        else:
            assert u0 == u1 == {}


def test_deferred_apply_refuses_what_the_reference_refuses():
    p = tr.FusedBottleneck(64, downsample=True).build(
        torch.Generator().manual_seed(0), (4, 4, 64))
    x = torch.zeros(1, 4, 4, 64)
    pend = (torch.zeros(1, 4, 4, 64),) + (torch.ones(64),) * 2 + (x,)
    with pytest.raises(ValueError, match="identity shortcut"):
        tr.FusedBottleneck(64, downsample=True)._apply_train(
            p, None, pending_in=pend)
    for blk in (tr.FusedBottleneck(64, downsample=True),
                tr.FusedBottleneck(64, stride=2)):
        with pytest.raises(ValueError, match="defer_out"):
            blk._apply_train(p, x, defer_out=True)
    with pytest.raises(ValueError, match="param dicts"):
        tr.fused_stage_forward([tr.FusedBottleneck(64)], [], x)


# -- the stage layout's params ------------------------------------------------

def _same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), w,
                                      err_msg="/".join(path))


def test_convert_resnet_params_stage_layout_round_trip():
    # the stage layout converts exactly to the per-block fused and the
    # unfused layouts and back, as the JAX converter does on the same
    # trees; the bridge carries its nested b{j} groups as they are
    kw = dict(input_shape=(32, 32, 3), classes=10)
    defer = tr.resnet50(fused="defer", **kw)
    dp = params_to_numpy(defer.init_params(torch.Generator().manual_seed(0),
                                           device="cpu"))
    fp0 = params_to_numpy(tr.resnet50(fused=True, **kw).init_params(
        torch.Generator().manual_seed(1), device="cpu"))
    up0 = params_to_numpy(tr.resnet50(**kw).init_params(
        torch.Generator().manual_seed(2), device="cpu"))
    assert sorted(dp["s2"]) == [f"b{j}" for j in range(6)]
    fp = tr.convert_resnet_params(dp, fp0)
    np.testing.assert_array_equal(fp["s0b0"]["c1"], dp["s0"]["b0"]["c1"])
    up = tr.convert_resnet_params(dp, up0)
    for src, dst in ((dp, fp0), (dp, up0), (fp, dp), (up, dp), (up, fp0)):
        _same_tree(tr.convert_resnet_params(src, dst),
                   jr.convert_resnet_params(src, dst))
    _same_tree(tr.convert_resnet_params(up, dp), dp)
    _same_tree(tr.convert_resnet_params(fp, dp), dp)
    # the bridge: the stage tree loads into a defer model and comes back
    # bit for bit
    again = tr.resnet50(fused="defer", **kw)
    again.load_params(dp, device="cpu")
    _same_tree(params_to_numpy(again), dp)
    mask = again.trainable_mask(again.params())
    assert mask["s1"]["b3"]["bn2"] == {
        "gamma": True, "beta": True,
        "_state": {"moving_mean": False, "moving_var": False}}


def test_builder_takes_the_reference_s_fused_values():
    kw = dict(input_shape=(32, 32, 3), classes=10)
    m = tr.resnet50(space_to_depth=True, fused="defer", **kw)
    names = [lyr.name for lyr in m.layers]
    assert names[:3] == ["stem_s2d", "stem", "stem_bn"]
    assert [n for n in names if n.startswith("s") and n[1:].isdigit()] == \
        ["s0", "s1", "s2", "s3"]
    jm = jr.resnet50(space_to_depth=True, fused="defer", **kw)
    assert names == [lyr.name for lyr in jm.layers]
    with pytest.raises(ValueError, match="defer"):
        tr.resnet50(fused="stage", **kw)


# -- the whole model ---------------------------------------------------------

def _batch_means_as_moving(model, x, tree):
    """``tree`` with every BatchNorm's moving mean at its batch mean on
    ``x``."""
    with torch.no_grad():
        _, upd = model.apply(model.params(), torch.from_numpy(x),
                             training=True)
    return _moving_at_batch_means(tree, upd)


def test_resnet50_s2d_defer_matches_jax():
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    rs = np.random.RandomState(4)
    b, kw = 8, dict(input_shape=(32, 32, 3), classes=10,
                    space_to_depth=True)
    x = rs.rand(b, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, size=(b, 1)).astype(np.int32)
    unfused = tr.resnet50(**kw)
    unfused.init_params(torch.Generator().manual_seed(0), device="cpu")
    up = _batch_means_as_moving(unfused, x, params_to_numpy(unfused))
    defer = tr.resnet50(fused="defer", **kw)
    defer.init_params(torch.Generator().manual_seed(1), device="cpu")
    defer.load_params(tr.convert_resnet_params(up, params_to_numpy(defer)))
    jm = jr.resnet50(**kw)

    # the forward (eval: the chained folds)
    want = jax.jit(lambda p, a: jm.apply(p, a, training=False)[0])(up, x)
    _close(defer.predict(x, batch_size=b), want, 1e-5, "logits")

    # one Estimator step, SGD with momentum
    def sgd():
        return dict(lr=0.01, momentum=0.9)
    jest = jest_mod.Estimator(jm, optimizer=jopt.SGD(**sgd()),
                              loss="softmax_cross_entropy")
    jest.params = jax.device_put(up)
    jloss = jest.train(x, y, batch_size=b).history[-1]["loss"]
    test = test_mod.Estimator(defer, optimizer=topt.SGD(**sgd()),
                              loss="softmax_cross_entropy")
    tloss = test.train(x, y, batch_size=b).history[-1]["loss"]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    got = tr.convert_resnet_params(params_to_numpy(defer), up)
    want = jax.device_get(jest.params)

    # the port's unfused graph's movement under a 1e-6 input change
    def step(images):
        unfused.load_params(up)
        test_mod.Estimator(unfused, optimizer=topt.SGD(**sgd()),
                           loss="softmax_cross_entropy").train(
            images, y, batch_size=b)
        return params_to_numpy(unfused)
    ref = step(x)
    jit = step(x * (1.0 + 1e-6 * rs.standard_normal(x.shape[1:]).astype(
        np.float32)))
    for path, w in _flat(want):
        a, r, j = _get(got, path), _get(ref, path), _get(jit, path)
        if "_state" in path:
            _close(a, w, 1e-5, "/".join(path))
            continue
        move = float(np.abs(w - _get(up, path)).max())
        bound = max(1e-4 * move, 2.0 * float(np.abs(j - r).max()))
        assert float(np.abs(a - w).max()) <= bound, (path, bound)


# -- the fused default's gate -------------------------------------------------

@pytest.mark.parametrize("mode,win,want", [
    ("1", None, True), ("0", None, False), ("auto", None, False),
    ("auto", "1", True), ("auto", "0", False), (None, None, False)])
def test_image_classifier_resolves_zoo_tpu_fused_resnet(monkeypatch, mode,
                                                       win, want):
    # "auto" follows fused_profitable(): MEASURED_WIN on a CUDA context
    # (this one is the CPU's), or ZOO_TPU_FUSED_WIN; the value resolved
    # at construction stays in hyper_parameters
    for var, val in (("ZOO_TPU_FUSED_RESNET", mode),
                     ("ZOO_TPU_FUSED_WIN", win)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    monkeypatch.setattr(tcb, "MEASURED_WIN", True)
    clf = ImageClassifier("resnet-50", input_shape=(32, 32, 3), classes=10)
    assert clf.fused is want and clf.hyper_parameters()["fused"] is want
    monkeypatch.setenv("ZOO_TPU_FUSED_RESNET", "1")
    assert ImageClassifier("resnet-50", fused=False).fused is False
    assert tcb.fused_profitable() is (win == "1")
    tzoo.reset_nncontext()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcb.fused_profitable() is (win != "0")
