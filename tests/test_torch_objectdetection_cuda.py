"""Object detection and Seq2seq decoding of the port on the card, held
against the CPU port (the plain path) on the same inputs and weights:
the device ``nms`` (the same indices and flags, and ``_nms_numpy``'s
choice, with no host sync in its loop), ``MultiBoxLoss`` at SSD300's
8732 priors (value and gradient), SSD at 64x64 (the flat output and
``detect``), and Seq2seq's greedy ``generate_tokens``, whose token loop
makes no host sync (``torch.cuda.set_sync_debug_mode("error")``).

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_objectdetection_cuda.py -q

Tolerances (f32, TF32 off): the loss 1e-5 relative, its gradient 1e-5
of its largest, the flat output 1e-4 of max(1, max|CPU|), boxes 1e-4.
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    MultiBoxLoss, ObjectDetector, bbox_util, detection, prior_box, ssd)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode("default")
    tzoo.reset_nncontext()


def _boxes(rs, n):
    lo = rs.uniform(0.0, 0.7, (n, 2))
    wh = rs.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([lo, lo + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,max_output", [(300, 50), (2000, 200)])
def test_nms_on_card_matches_cpu_and_numpy(cuda, n, max_output):
    rs = np.random.RandomState(n)
    boxes, scores = _boxes(rs, n), rs.rand(n).astype(np.float32)
    want = bbox_util.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.45, max_output)
    bd, sd = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(
        cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    idx, valid = bbox_util.nms(bd, sd, 0.45, max_output)
    torch.cuda.set_sync_debug_mode("default")
    assert idx.tolist() == want[0].tolist()
    assert valid.tolist() == want[1].tolist()
    kept = [i for i, v in zip(idx.tolist(), valid.tolist()) if v]
    assert kept == detection._nms_numpy(boxes, scores, 0.45)[:max_output]


def test_multibox_loss_on_card_matches_cpu(cuda):
    priors = prior_box.generate_ssd_priors(prior_box.SSD300_SPECS, 300.0)
    p, c, b = priors.shape[0], 21, 4
    rs = np.random.RandomState(1)
    loc = rs.randn(b, p, 4).astype(np.float32)
    conf = rs.randn(b, p, c).astype(np.float32)
    conf[:, 100:900] = 0.0                      # tied negatives
    conf[:, 100:900, 0] = -8.0
    gt = np.stack([_boxes(rs, 5) for _ in range(b)])
    labels = rs.randint(0, c - 1, (b, 5)).astype(np.int32)
    labels[2, 3:] = -1
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tl = torch.from_numpy(loc).to(dev).requires_grad_(True)
        tc = torch.from_numpy(conf).to(dev).requires_grad_(True)
        val = MultiBoxLoss(c)(torch.from_numpy(priors).to(dev), tl, tc,
                              torch.from_numpy(gt).to(dev),
                              torch.from_numpy(labels).to(dev))
        gl, gc = torch.autograd.grad(val, (tl, tc))
        out[dev.type] = (val.item(), gl.cpu().numpy(), gc.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, w in zip(out["cuda"][1:], out["cpu"][1:]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_ssd_tiny_forward_and_detect_on_card_match_cpu(cuda):
    specs = [prior_box.PriorBoxSpec(8, 20.0, 40.0, (2.0,)),
             prior_box.PriorBoxSpec(4, 40.0, 60.0, (2.0,)),
             prior_box.PriorBoxSpec(2, 60.0, 80.0, (2.0,)),
             prior_box.PriorBoxSpec(1, 80.0, 100.0, (2.0,))]
    dets = {}
    for dev in ("cuda", "cpu"):
        tzoo.init_nncontext(seed=0, device=None if dev == "cuda" else dev)
        det = ObjectDetector("ssd-vgg16-300x300", n_classes=4, img_size=64)
        det._builder = ssd.SSDVGG(4, 64, specs=specs)
        det.priors = det._builder.priors
        det.compile_detection(optimizer="sgd")
        dets[dev] = det
    dets["cuda"].model.init_params(torch.Generator().manual_seed(0), cuda)
    dets["cpu"].model.load_params(params_to_numpy(dets["cuda"].model),
                                  device="cpu")
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    got = dets["cuda"].model.predict(x, batch_size=2)
    want = dets["cpu"].model.predict(x, batch_size=2)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), err
    a = dets["cuda"].detect(x, batch_size=2, conf_threshold=0.3)
    b = dets["cpu"].detect(x, batch_size=2, conf_threshold=0.3)
    assert [len(d) for d in a] == [len(d) for d in b]
    for da, db in zip(a, b):
        for u, v in zip(da, db):
            assert u.class_id == v.class_id
            np.testing.assert_allclose(u.box, v.box, atol=1e-4)


def test_seq2seq_greedy_tokens_on_card_match_cpu_without_sync(cuda):
    from analytics_zoo_tpu_torch.models.seq2seq import (
        Bridge, RNNDecoder, RNNEncoder, Seq2seq)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    v, t = 50, 8
    nets = {}
    for dev in ("cuda", "cpu"):
        tzoo.init_nncontext(seed=0, device=None if dev == "cuda" else dev)
        nets[dev] = Seq2seq(RNNEncoder("lstm", 2, 32),
                            RNNDecoder("lstm", 2, 32), input_shape=(t, v),
                            output_shape=(t, v), bridge=Bridge("dense"),
                            generator=Dense(v, activation="softmax",
                                            name="generator")).model
    nets["cuda"].init_params(torch.Generator().manual_seed(0), cuda)
    nets["cpu"].load_params(params_to_numpy(nets["cuda"]), device="cpu")
    enc = np.random.RandomState(3).randn(3, t, v).astype(np.float32)
    enc_d = torch.from_numpy(enc).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    got = nets["cuda"].generate_tokens(nets["cuda"].params(), enc_d, 1, t,
                                       eos_id=2)
    torch.cuda.set_sync_debug_mode("default")
    want = nets["cpu"].generate_tokens(nets["cpu"].params(),
                                       torch.from_numpy(enc), 1, t,
                                       eos_id=2)
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
