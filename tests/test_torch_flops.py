"""The port's step FLOP count (``analytics_zoo_tpu_torch/perf/flops.py``):
the fused and unfused ResNet-50 graphs (the kernels' plain versions on
the CPU, which the kernel wrappers record and mute) count the same
products; on stride-1 Dense and conv models the count is the JAX
package's ``executed_flops`` of its own train step; on strided convs
the two differ by design (the reference executes the zeros of XLA's
dilated backward, the port counts model FLOPs), which is stated here
exactly.

Tolerances: the fused/unfused counts and the analytic model counts
exactly; against the JAX package within 1% (the acceptance bound; the
cases here agree exactly).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JS
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    resnet50
from analytics_zoo_tpu_torch.ops import conv_bn as cb
from analytics_zoo_tpu_torch.perf import flops
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import tree_leaves
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    yield
    tzoo.reset_nncontext()


def _resnet_step_flops(fused, s2d):
    m = resnet50(input_shape=(32, 32, 3), classes=10, fused=fused,
                 space_to_depth=s2d)
    m.init_params(torch.Generator().manual_seed(0), device="cpu")
    params = m.params()
    leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with flops.count() as c:
        out, _ = m.apply(params, x, training=True)
        torch.autograd.grad(out.square().mean(), leaves, allow_unused=True)
    return c


@pytest.mark.parametrize("s2d", [False, True])
def test_fused_and_unfused_resnet_count_the_same(s2d):
    counts = {f: _resnet_step_flops(f, s2d) for f in (False, True, "defer")}
    totals = {f: c.total for f, c in counts.items()}
    assert totals[True] == totals[False] == totals["defer"], totals
    # the fused graphs' 1x1s and 3x3s are the kernels' records: B1, B2,
    # B3 and B4 one each per conv, nothing of their plain versions
    names = {o.name for o in counts[True].ops}
    assert {"matmul_bn", "conv3x3_bn", "matmul_bn_dx",
            "matmul_bn_dw"} <= names
    assert sum(o.name == "matmul_bn" for o in counts[True].ops) == 36
    assert sum(o.name == "conv3x3_bn" for o in counts[True].ops) == 16
    top = flops.top_ops(counts[False].ops, 3)
    assert [o.flops for o in top] == sorted((o.flops for o in
                                             counts[False].ops),
                                            reverse=True)[:3]
    # the stem reads 3 (or 12) channels: a 128-lane tile wastes most of it
    pads = flops.channel_padding(counts[False].ops)
    assert any(p.extent == (12 if s2d else 3) and p.role == "lhs_f"
               for p in pads)


def test_a_kernel_record_mutes_its_plain_version():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(48, 64).astype(np.float32))
    w = torch.from_numpy(rs.randn(64, 128).astype(np.float32))
    with flops.count() as c:
        cb.matmul_bn(x, w)
    assert [(o.name, o.flops) for o in c.ops] == \
        [("matmul_bn", 2.0 * 48 * 64 * 128)]
    with flops.count() as c:        # no wrapper: the aten op itself
        torch.mm(x, w)
    assert [(o.name, o.flops) for o in c.ops] == \
        [("aten.mm", 2.0 * 48 * 64 * 128)]
    assert flops._active == []         # every count closed


def _jax_step_flops(build, x, y):
    jinit(seed=0)
    m = build(JL, JS())
    m.compile(optimizer="sgd", loss="mse")
    res = m.fit(x, y, batch_size=len(x), nb_epoch=1)
    return res.history[-1]["goodput"]["flops_per_step"]


def _port_step_flops(build, x, y):
    m = build(TL, Sequential())
    m.compile(optimizer="sgd", loss="mse")
    res = m.fit(x, y, batch_size=len(x), nb_epoch=1)
    return res.history[-1]["goodput"]["flops_per_step"]


def _dense(lib, m):
    m.add(lib.Dense(16, activation="relu", input_shape=(12,)))
    m.add(lib.Dense(8))
    m.add(lib.Dense(3))
    return m


def _conv(stride):
    def build(lib, m):
        m.add(lib.Convolution2D(4, 3, 3, border_mode="same",
                                subsample=stride, input_shape=(8, 8, 3)))
        m.add(lib.Convolution2D(6, 3, 3, border_mode="same",
                                subsample=stride))
        m.add(lib.Flatten())
        m.add(lib.Dense(2))
        return m
    return build


@pytest.mark.parametrize("model", ["dense", "conv"])
def test_stride_1_count_is_the_references(model):
    rs = np.random.RandomState(3)
    if model == "dense":
        build, x = _dense, rs.randn(8, 12).astype(np.float32)
        y = rs.randn(8, 3).astype(np.float32)
    else:
        build, x = _conv(1), rs.randn(8, 8, 8, 3).astype(np.float32)
        y = rs.randn(8, 2).astype(np.float32)
    port = _port_step_flops(build, x, y)
    ref = _jax_step_flops(build, x, y)
    assert abs(port / ref - 1.0) <= 0.01, (port, ref)


def test_strided_convs_count_model_flops_not_the_dilated_zeros():
    rs = np.random.RandomState(4)
    n = 8
    x = rs.randn(n, 8, 8, 3).astype(np.float32)
    y = rs.randn(n, 2).astype(np.float32)
    port = _port_step_flops(_conv(2), x, y)
    # model FLOPs: conv1 8x8x3 -> 4x4x4, conv2 -> 2x2x6, dense 24 -> 2;
    # forward and dW of each, dx of all but the first
    c1 = 2 * n * 4 * 4 * 9 * 3 * 4
    c2 = 2 * n * 2 * 2 * 9 * 4 * 6
    d = 2 * n * 24 * 2
    assert port == 2 * (c1 + c2 + d) + c2 + d
    # the reference's executed count holds the dilated backward's zeros:
    # more than the model's products, by design
    ref = _jax_step_flops(_conv(2), x, y)
    assert ref > port
