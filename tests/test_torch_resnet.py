"""The PyTorch port's ResNet (``FusedBottleneck`` eval, the builder,
``convert_resnet_params``) against the JAX package's, on the same numpy
inputs and weights.

The JAX bottleneck runs its Pallas eval folds in interpret mode; the
port's runs the plain versions of its CUDA kernels (CPU tensors).
Moving statistics are made distinctive, as tests/test_conv_bn.py does,
so every BN fold matters. f32 atol/rtol 1e-3: three chained folds (the
bound of the JAX package's own fused-bottleneck test).
"""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models.image.imageclassification import resnet as jr
from analytics_zoo_tpu_torch.bridge import params_from_numpy, \
    params_to_numpy
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    resnet as tr


@pytest.fixture(autouse=True)
def _cpu_context():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _distinct_stats(tree, rs):
    """Distinctive gamma/beta and moving stats for every BN group of a
    numpy param tree, in place."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if "_state" in v:
            n = v["_state"]["moving_mean"].shape[0]
            v["_state"]["moving_mean"] = (rs.randn(n) * 0.1).astype(
                np.float32)
            v["_state"]["moving_var"] = (rs.rand(n) + 0.5).astype(
                np.float32)
            v["gamma"] = (1 + rs.randn(n) * 0.1).astype(np.float32)
            v["beta"] = (rs.randn(n) * 0.1).astype(np.float32)
        else:
            _distinct_stats(v, rs)
    return tree


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("stride,downsample,channels", [
    (1, True, 64), (2, True, 64), (1, False, 256)])
def test_fused_bottleneck_eval_matches_jax(stride, downsample, channels):
    rs = np.random.RandomState(0)
    shape = (8, 8, channels)
    jblk = jr.FusedBottleneck(64, stride=stride, downsample=downsample)
    p = _distinct_stats(jax.device_get(
        jblk.build(jax.random.key(0), shape)), rs)
    x = rs.randn(2, *shape).astype(np.float32)
    want, upd = jblk.apply(p, x, training=False)
    assert upd == {}
    tblk = tr.FusedBottleneck(64, stride=stride, downsample=downsample)
    got = tblk.call(params_from_numpy(p), torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert tblk.compute_output_shape(shape) == want.shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_fused_bottleneck_params_match_jax_layout():
    shape = (8, 8, 64)
    jp = jax.device_get(jr.FusedBottleneck(64, downsample=True).build(
        jax.random.key(0), shape))
    tp = tr.FusedBottleneck(64, downsample=True).build(
        torch.Generator().manual_seed(0), shape)
    assert _shapes(tp) == _shapes(jp)


def test_fused_bottleneck_trains():
    # a training forward returns every BN's moving-stat update and
    # back-propagates to every weight
    blk = tr.FusedBottleneck(64, downsample=True)
    p = blk.init(torch.Generator().manual_seed(0), (4, 4, 64))
    x = torch.randn(2, 4, 4, 64, generator=torch.Generator().manual_seed(1))
    leaves = [p[k] for k in ("c1", "c2", "c3", "down")] + \
        [p[b][k] for b in ("bn1", "bn2", "bn3", "bnd")
         for k in ("gamma", "beta")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, upd = blk.apply(p, x, training=True)
    assert tuple(out.shape) == (2, 4, 4, 256) and bool((out >= 0).all())
    assert sorted(upd) == ["bn1", "bn2", "bn3", "bnd"]
    for u in upd.values():
        assert sorted(u["_state"]) == ["moving_mean", "moving_var"]
    grads = torch.autograd.grad(out.square().sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0
               for g in grads)


def test_resnet50_param_tree_matches_jax():
    # the unfused graph here; the fused tree is held against the JAX
    # one in tests/test_torch_serving.py
    jm = jr.resnet50(input_shape=(32, 32, 3), classes=10)
    tm = tr.resnet50(input_shape=(32, 32, 3), classes=10)
    jp = jax.device_get(jm.init_params(jax.random.key(0)))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(tp) == _shapes(jp)
    assert [lyr.name for lyr in tm.layers] == \
        [lyr.name for lyr in jm.layers]


def test_convert_resnet_params_round_trip_and_matches_jax():
    fused = tr.resnet50(input_shape=(32, 32, 3), classes=10, fused=True)
    unfused = tr.resnet50(input_shape=(32, 32, 3), classes=10,
                          fused=False)
    fp = params_to_numpy(fused.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    up = params_to_numpy(unfused.init_params(
        torch.Generator().manual_seed(1), device="cpu"))
    to_unfused = tr.convert_resnet_params(fp, up)
    back = tr.convert_resnet_params(to_unfused, fp)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, fp))
    # the JAX converter maps the same trees the same way
    want = jr.convert_resnet_params(fp, up)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, to_unfused, want))


def test_fused_matches_unfused_graph_on_same_weights():
    rs = np.random.RandomState(1)
    fused = tr.resnet50(input_shape=(32, 32, 3), classes=10, fused=True)
    unfused = tr.resnet50(input_shape=(32, 32, 3), classes=10,
                          fused=False)
    fp = _distinct_stats(params_to_numpy(fused.init_params(
        torch.Generator().manual_seed(0), device="cpu")), rs)
    fused.load_params(fp)
    unfused.init_params(torch.Generator().manual_seed(1), device="cpu")
    unfused.load_params(tr.convert_resnet_params(
        fp, params_to_numpy(unfused)))
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(fused.predict(x), unfused.predict(x),
                               rtol=1e-3, atol=1e-3)
