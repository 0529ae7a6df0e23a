"""The serving front end of the port on the card: a ``DynamicBatcher``
in front of ResNet-50 (the eval folds B5 and B6) and the int8 tower.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_serving_cuda.py -q

Held: each served bucket bit for bit to ``predict`` of the same padded
bucket, each request's rows bit for bit to its rows of that bucket and
within 1e-3 (f32, TF32 off) or 2e-2 (bf16) of max(1, max|ref|) of the
request served alone; no library loaded and no bucket callable made
after warm-up; 36 B5 and 16 B6 launches per bucket execution. int8:
the first layer's quantized input and int32 accumulator equal to the
CPU port's (the scales are calibrated on the host, so they are equal
too), outputs within 1e-5 of max(1, max|out|).
"""

import threading

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.common import observability as tobs

TIMEOUT = 600
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tzoo.init_nncontext(seed=0)
    tobs.reset_metrics()
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _executions():
    fam = tobs.snapshot().get("zoo_tpu_serving_batch_executions_total")
    return 0 if fam is None else int(sum(v["value"]
                                         for v in fam["values"]))


def _compiles():
    fam = tobs.snapshot().get("zoo_tpu_serving_bucket_compiles_total")
    return 0 if fam is None else int(fam["values"][0]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_served_buckets_equal_predict_and_warm_builds_everything(cuda,
                                                                 dtype):
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel)

    net = ImageClassifier("resnet-50", input_shape=(224, 224, 3),
                          classes=1000, fused=True).model
    net.init_params()
    rs = np.random.RandomState(0)
    x8 = torch.from_numpy(rs.rand(8, 224, 224, 3).astype(np.float32))
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(
        net, example_inputs=[x8.to(dtype)])
    runs = []

    class Recording(DynamicBatcher):
        def _pad_and_run(self, sig, xs, n):
            outs, multi = super()._pad_and_run(sig, xs, n)
            runs.append((xs[0], n, outs[0]))
            return outs, multi

    b = Recording(im, max_batch_size=8, max_wait_ms=20)
    try:
        b.start()
        assert b.warmed_buckets == 4
        libs, compiles = cuda_build.loaded(), _compiles()
        assert {"matmul_bn_apply", "conv3x3_bn_apply"} <= set(libs)
        cb.reset_launches()
        sizes = [1, 3, 2, 1, 4, 1]
        reqs = [rs.rand(n, 224, 224, 3).astype(np.float32) for n in sizes]
        outs = [None] * len(reqs)

        def client(i):
            outs[i] = b.submit([reqs[i]]).result(timeout=TIMEOUT)

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in ts)
        torch.cuda.synchronize()
        execs = _executions()
        assert cuda_build.loaded() == libs and _compiles() == compiles
    finally:
        b.stop()
    assert cb.launches["matmul_bn_apply"] == 36 * execs
    assert cb.launches["conv3x3_bn_apply"] == 16 * execs
    # each bucket run again through predict: the same bits (the padded
    # inputs were kept only for the rows; rebuild the zero padding)
    for xs, n, out in runs:
        bucket = next(s for s in b.buckets if s >= n)
        padded = np.concatenate(
            [xs, np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)])
        np.testing.assert_array_equal(im.predict(padded)[:n], out)
    # each request: its rows of the bucket it rode, and close to alone
    for x, got in zip(reqs, outs):
        hits = [(xs, out, off) for xs, n, out in runs
                for off in range(n - len(x) + 1)
                if np.array_equal(xs[off:off + len(x)], x)]
        assert len(hits) == 1
        _, out, off = hits[0]
        np.testing.assert_array_equal(got, out[off:off + len(x)])
        alone = im.predict(x)
        tol = TOL[dtype] * max(1.0, float(np.abs(alone).max()))
        assert float(np.abs(got - alone).max()) <= tol


def _tower(params=None, device="cpu"):
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    m = Sequential([TL.Dense(4096, activation="relu", input_shape=(256,)),
                    TL.Dense(4096, activation="relu"),
                    TL.Dense(512, activation="relu"), TL.Dense(10)])
    if params is None:
        m.init_params(torch.Generator().manual_seed(0), device=device)
    else:
        m.load_params(params, device=device)
    return m


@pytest.mark.cuda
def test_int8_on_the_card_equals_the_cpu_port(cuda):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel)

    cpu_net = _tower()
    params = params_to_numpy(cpu_net)
    rs = np.random.RandomState(1)
    calib = rs.randn(8, 256).astype(np.float32)
    cpu = InferenceModel().load_keras_net(cpu_net, example_inputs=[calib],
                                          quantize=True)
    card = InferenceModel().load_keras_net(_tower(params, cuda),
                                           example_inputs=[calib],
                                           quantize=True)
    # the scales are calibrated on the host: equal on both devices
    for ce, ge in zip(cpu.quantized.plan, card.quantized.plan):
        assert ce["mode"] == ge["mode"] == "int8"
        np.testing.assert_array_equal(ce["w_q"], ge["w_q"])
        assert ce["a_scale"] == ge["a_scale"]
    x = rs.randn(5, 256).astype(np.float32)
    xq_cpu = cpu.quantized.quantize_input(0, torch.from_numpy(x))
    xq_card = card.quantized.quantize_input(0, torch.from_numpy(x).to(cuda))
    assert torch.equal(xq_card.cpu(), xq_cpu)
    for rows in (1, 5, 17, 32):     # below, at and above _int_mm's rule
        xq = xq_cpu[:rows] if rows <= 5 else torch.from_numpy(
            rs.randint(-127, 128, (rows, 256)).astype(np.int8))
        acc_cpu = cpu.quantized.accumulator(0, xq)
        acc_card = card.quantized.accumulator(0, xq.to(cuda))
        assert acc_card.dtype == torch.int32
        assert torch.equal(acc_card.cpu(), acc_cpu)
    want = cpu.predict(x)
    b = DynamicBatcher(card, max_batch_size=8, max_wait_ms=1)
    try:
        b.start()
        got = b.submit([x]).result(timeout=TIMEOUT)
    finally:
        b.stop()
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    assert float(np.abs(card.predict(x) - want).max()) <= tol
    f, q = card.quantized.size_bytes()
    assert f > 3 * q
