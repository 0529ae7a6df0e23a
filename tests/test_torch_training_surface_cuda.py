"""The Estimator's training surface on the card: a checkpoint round trip
of the fused ResNet-50 (``fused="defer"``, the s2d stem) bit for bit,
the device-memory gauges, the step's FLOP count through the kernels
against the unfused graph's (cuDNN and cuBLAS, which the dispatch mode
sees), and the optimizers' updates against the CPU port's.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none. This file imports no JAX, so it runs on a machine
that has none:

    python -m pytest --noconftest tests/test_torch_training_surface_cuda.py -q

Tolerances: the checkpoint bit for bit; the FLOP counts equal (the
acceptance bound is 1%); each update within 1e-6 of max|param| on the
same params, state and gradients (TF32 off).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo

IMAGE = (64, 64, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tzoo.init_nncontext(seed=0)
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _flagship(fused):
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        resnet50
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    net = resnet50(input_shape=IMAGE, classes=10, space_to_depth=True,
                   fused=fused)
    net.init_params()
    est = Estimator(net, optimizer=SGD(0.1, momentum=0.9),
                    loss="softmax_cross_entropy",
                    dtype_policy="mixed_bfloat16")
    return net, est


def _data(n=16):
    rs = np.random.RandomState(0)
    return (rs.rand(n, *IMAGE).astype(np.float32),
            rs.randint(0, 10, size=(n, 1)).astype(np.int32))


@pytest.mark.cuda
def test_fused_resnet_checkpoint_round_trip_bit_for_bit(cuda, tmp_path):
    from analytics_zoo_tpu_torch.common.safe_pickle import checked_load
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    x, y = _data()
    net, est = _flagship("defer")
    cb.reset_launches()
    est.train(x, y, batch_size=8, nb_epoch=1)
    assert cb.launches["matmul_bn"] == 2 * 36
    path = est.save_checkpoint(str(tmp_path))
    saved = checked_load(path)
    net2, est2 = _flagship("defer")
    est2.load_checkpoint(str(tmp_path))
    back = est2.checkpoint_state()
    assert back["step"] == saved["step"] == 2

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        return [tree]
    for a, b in zip(leaves(back["params"]) + back["opt_state"],
                    leaves(saved["params"]) + saved["opt_state"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the same next step from either
    r1 = est.train(x, y, batch_size=8, nb_epoch=1).history[-1]["losses"]
    r2 = est2.train(x, y, batch_size=8, nb_epoch=1).history[-1]["losses"]
    assert np.allclose(r1, r2, rtol=1e-3)


@pytest.mark.cuda
def test_device_memory_gauges(cuda):
    from analytics_zoo_tpu_torch.common import diagnostics
    from analytics_zoo_tpu_torch.common import observability as obs
    obs.reset_metrics()
    t = torch.empty(1 << 20, device="cuda")
    assert diagnostics.update_device_memory_gauges() == 3
    vals = {v["labels"]["kind"]: v["value"] for v in
            obs.snapshot()["zoo_tpu_device_memory_bytes"]["values"]}
    assert set(vals) == {"in_use", "peak", "limit"}
    assert vals["in_use"] >= t.numel() * 4 and vals["peak"] >= \
        vals["in_use"] and vals["limit"] > vals["peak"]


@pytest.mark.cuda
def test_flop_count_through_the_kernels_equals_the_unfused_graph(cuda):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        convert_resnet_params
    x, y = _data(8)
    counts = {}
    w0 = None
    for fused in ("defer", False):
        net, est = _flagship(fused)
        if w0 is None:
            w0 = params_to_numpy(net)
        else:
            net.load_params(convert_resnet_params(w0, params_to_numpy(net)))
        est.train(x, y, batch_size=8, nb_epoch=1)
        counts[fused] = est.flops_per_step
        names = {o.name for o in est.flop_ops}
        assert ("matmul_bn" in names) == (fused == "defer")
    assert counts["defer"] == counts[False] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AdamW", "RMSprop", "Adagrad",
                                  "Adadelta", "Adamax"])
def test_optimizer_update_on_the_card_matches_the_cpu_port(cuda, name):
    from analytics_zoo_tpu_torch.ops import optimizers as topt
    rs = np.random.RandomState(1)
    shapes = [(64, 32), (32,), (32, 8), (8,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    out = {}
    for dev in ("cuda", "cpu"):
        opt = getattr(topt, name)(lr=0.01)
        leaves = [torch.from_numpy(p.copy()).to(dev) for p in params]
        state = opt.init(leaves)
        g_rs = np.random.RandomState(2)
        for _ in range(3):
            grads = [torch.from_numpy(g_rs.randn(*s).astype(np.float32)
                                      ).to(dev) for s in shapes]
            opt.update(leaves, grads, state)
        out[dev] = [t.cpu().numpy() for t in leaves]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * float(np.abs(b).max()))
