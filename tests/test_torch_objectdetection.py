"""The port's object detection and its dilated and grouped convolutions
against the JAX package's, on the same numpy inputs and weights:

- ``Convolution1D``/``2D`` with dilation and groups, both border modes,
  odd sizes, strided: the forward and the gradients (f32 1e-5);
- the box geometry: IoU, encode/decode, ``nms`` (the same indices and
  valid flags, and ``_nms_numpy``'s choice), the bipartite match where
  GTs share a best prior (the highest GT index wins), ``match_priors``;
- ``MultiBoxLoss`` at SSD300's 8732 priors with tied negatives: the
  loss (1e-4 relative) and its gradient (1e-5 of the largest);
- ``DetectionOutput``, the mAP evaluator, the VOC and COCO readers on
  files the test writes, the ``Visualizer``;
- SSD at 64x64 with the reference test's small prior specs: the forward
  (1e-5 of max(1, max|out|)), two f32 SGD steps (losses 1e-4 relative),
  ``detect``; one ``mixed_bfloat16`` step (2e-2), where both packages
  keep ``y_true`` and the loss in f32;
- ``ObjectDetectionConfig`` and the example with ``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu as jzoo
import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models.image.objectdetection import (
    bbox_util as jbox, detection as jdet, evaluation as jeval,
    multibox_loss as jmbl, object_detector as jod, prior_box as jpb,
    ssd as jssd)
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    bbox_util as tbox, detection as tdet, evaluation as teval,
    multibox_loss as tmbl, object_detector as tod, prior_box as tpb,
    ssd as tssd)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    jzoo.init_nncontext(seed=0)
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rs, n):
    lo = rs.uniform(0.0, 0.7, (n, 2))
    wh = rs.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([lo, lo + wh], 1).astype(np.float32)


# -- dilated and grouped convolutions ----------------------------------------

def _conv_case(jlyr, tlyr, shape, seed=0):
    """Forward and the gradients of ``sum(out * w)`` by the input and
    every param, both layers on the JAX layer's params (bias made
    non-zero)."""
    rs = np.random.RandomState(seed)
    p = jax.device_get(jlyr.init(jax.random.key(0), shape))
    p = {k: (rs.randn(*v.shape).astype(np.float32) if k == "bias" else v)
         for k, v in p.items()}
    x = rs.randn(2, *shape).astype(np.float32)
    jout = jlyr.call(p, jnp.asarray(x))
    w = rs.randn(*jout.shape).astype(np.float32)

    def jloss(p_, x_):
        return jnp.sum(jlyr.call(p_, x_) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tlyr.init(torch.Generator().manual_seed(0), shape)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tout = tlyr.call(tp, tx)
    assert tuple(tout.shape[1:]) == tuple(tlyr.compute_output_shape(shape))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    (tout * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=TOL, atol=TOL * 10)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=TOL, atol=TOL * 10, err_msg=k)


@pytest.mark.parametrize("dilation,border,stride,groups", [
    (1, "same", 1, 1), (2, "same", 1, 1), (6, "same", 1, 1),
    (2, "valid", 1, 1), (6, "valid", 1, 1), (2, "same", 2, 1),
    (1, "same", 2, 2), (2, "valid", 1, 2), ((2, 3), "same", 1, 1)])
def test_convolution2d_dilation_groups_match_jax(dilation, border, stride,
                                                 groups):
    kw = dict(border_mode=border, subsample=stride, dilation=dilation,
              groups=groups, activation="relu")
    _conv_case(JL.Convolution2D(6, 3, 3, **kw),
               TL.Convolution2D(6, 3, 3, **kw), (17, 15, 4))


@pytest.mark.parametrize("dilation,border,stride,groups", [
    (2, "same", 1, 1), (3, "valid", 1, 1), (2, "same", 2, 2),
    (1, "valid", 1, 2)])
def test_convolution1d_dilation_groups_match_jax(dilation, border, stride,
                                                 groups):
    kw = dict(border_mode=border, subsample_length=stride,
              dilation=dilation, groups=groups)
    _conv_case(JL.Convolution1D(4, 3, **kw), TL.Convolution1D(4, 3, **kw),
               (19, 6))


def test_convolution_groups_errors():
    with pytest.raises(ValueError):
        TL.Convolution2D(5, 3, 3, groups=2)
    lyr = TL.Convolution2D(4, 3, 3, groups=2)
    with pytest.raises(ValueError):
        lyr.init(torch.Generator().manual_seed(0), (8, 8, 3))


# -- box geometry -------------------------------------------------------------

def test_iou_encode_decode_match_jax():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 9), _boxes(rs, 13)
    b[0] = [0.2, 0.2, 0.2, 0.5]                     # a degenerate box
    np.testing.assert_allclose(tbox.iou_matrix(_t(a), _t(b)).numpy(),
                               np.asarray(jbox.iou_matrix(a, b)),
                               rtol=TOL, atol=1e-7)
    enc_t = tbox.encode_boxes(_t(a), _t(b[:9]))
    enc_j = np.asarray(jbox.encode_boxes(a, b[:9]))
    np.testing.assert_allclose(enc_t.numpy(), enc_j, rtol=TOL, atol=TOL)
    loc = rs.randn(9, 4).astype(np.float32)
    np.testing.assert_allclose(
        tbox.decode_boxes(_t(loc), _t(a)).numpy(),
        np.asarray(jbox.decode_boxes(loc, a)), rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(
        tbox.clip_boxes(_t(loc)).numpy(), np.asarray(jbox.clip_boxes(loc)))


@pytest.mark.parametrize("n,max_output,score_threshold", [
    (40, 100, 0.0), (40, 10, 0.3), (6, 6, 0.0)])
def test_nms_matches_jax_and_numpy(n, max_output, score_threshold):
    rs = np.random.RandomState(n + max_output)
    boxes = _boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    scores[3] = scores[5]                            # a tie: first wins
    idx, valid = tbox.nms(_t(boxes), _t(scores), 0.45, max_output,
                          score_threshold)
    jidx, jvalid = jbox.nms(boxes, scores, 0.45, max_output,
                            score_threshold)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert valid.tolist() == np.asarray(jvalid).tolist()
    kept = [int(i) for i, v in zip(idx, valid) if v]
    if score_threshold == 0.0 and max_output >= n:
        assert kept == tdet._nms_numpy(boxes, scores, 0.45)


def test_bipartite_shared_best_prior_highest_gt_wins():
    cases = [
        # GTs 0 and 2 share best prior 1; GT 1 takes prior 3
        ([[0.1, 0.9, 0.2, 0.0, 0.3], [0.0, 0.2, 0.1, 0.7, 0.0],
          [0.05, 0.6, 0.3, 0.1, 0.2]], 0.5, [-1, 2, -1, 1, -1]),
        # a padding row after a GT, both on prior 0: the padding's write
        # (the prior's own match, -1) wins
        ([[0.9, 0.1, 0.2], [0.0, 0.0, 0.0]], 0.95, [-1, -1, -1]),
        ([[0.0, 0.0, 0.0], [0.9, 0.1, 0.2]], 0.95, [1, -1, -1]),
        ((np.tile([[0.9, 0.1, 0.2]], (20, 1)) *
          np.linspace(1, 0.5, 20)[:, None]).tolist(), 0.95, [19, -1, -1]),
    ]
    for iou, thr, want in cases:
        iou = np.asarray(iou, np.float32)
        got, matched = tbox.bipartite_and_per_prediction_match(_t(iou), thr)
        jgot, jmatched = jbox.bipartite_and_per_prediction_match(
            jnp.asarray(iou), thr)
        assert got.tolist() == want == np.asarray(jgot).tolist()
        assert matched.tolist() == np.asarray(jmatched).tolist()
    # batched: each image as alone
    rs = np.random.RandomState(3)
    iou = (rs.rand(4, 6, 30) * 0.9).astype(np.float32)
    iou[:, :, 7] = 0.99                              # every GT's best prior
    got, _ = tbox.bipartite_and_per_prediction_match(_t(iou), 0.5)
    for i in range(4):
        want, _ = jbox.bipartite_and_per_prediction_match(
            jnp.asarray(iou[i]), 0.5)
        assert got[i].tolist() == np.asarray(want).tolist()
        assert int(got[i, 7]) == 5


def test_match_priors_matches_jax():
    rs = np.random.RandomState(1)
    priors = tpb.generate_ssd_priors(
        [tpb.PriorBoxSpec(6, 20.0, 40.0, (2.0,)),
         tpb.PriorBoxSpec(3, 40.0, 70.0, (2.0, 3.0))], 100.0)
    gt = np.stack([_boxes(rs, 5) for _ in range(3)])
    labels = rs.randint(0, 4, (3, 5)).astype(np.int32)
    labels[0, 3:] = -1
    labels[2, 1:] = -1
    got = tmbl.match_priors(_t(gt), _t(labels), _t(priors), 0.5)
    for i in range(3):
        want = jmbl.match_priors(gt[i], labels[i], priors, 0.5)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        assert got[1][i].tolist() == np.asarray(want[1]).tolist()
        assert got[2][i].tolist() == np.asarray(want[2]).tolist()


def test_multibox_loss_and_grad_match_jax_at_ssd300_priors():
    priors = tpb.generate_ssd_priors(tpb.SSD300_SPECS, 300.0)
    p, c, b = priors.shape[0], 21, 2
    assert p == 8732
    rs = np.random.RandomState(2)
    loc = rs.randn(b, p, 4).astype(np.float32)
    conf = rs.randn(b, p, c).astype(np.float32)
    # tied negatives: a block of priors with equal logits and the
    # largest background loss, so the mining cut falls inside it
    conf[:, 4000:6000] = 0.0
    conf[:, 4000:6000, 0] = -8.0
    gt = np.stack([_boxes(rs, 6) for _ in range(b)])
    labels = rs.randint(0, c - 1, (b, 6)).astype(np.int32)
    labels[1, 4:] = -1
    loss = tmbl.MultiBoxLoss(c)
    jloss = jmbl.MultiBoxLoss(c)
    # the cut lies inside the tied block for image 0
    _, _, matched = tmbl.match_priors(_t(gt), _t(labels), _t(priors))
    n_neg = int(matched[0].sum()) * 3
    ce0 = -torch.log_softmax(_t(conf[0]), -1)[:, 0]
    neg = torch.where(matched[0], torch.tensor(-np.inf), ce0)
    kth = neg.sort(descending=True).values[n_neg - 1]
    assert (neg == kth).sum() > 1

    tl, tc = _t(loc).requires_grad_(True), _t(conf).requires_grad_(True)
    got = loss(_t(priors), tl, tc, _t(gt), _t(labels))
    got.backward()

    def jfn(l_, c_):
        return jloss(jnp.asarray(priors), l_, c_, jnp.asarray(gt),
                     jnp.asarray(labels))

    want, (gl, gc) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(loc), jnp.asarray(conf))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for g, jg in ((tl.grad, gl), (tc.grad, gc)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=TOL * np.abs(jg).max())
    # the keras form on the flat layout
    y_pred = np.concatenate([loc.reshape(b, -1), conf.reshape(b, -1)], 1)
    y_true = tod.ObjectDetector.pack_targets(list(gt), list(labels), 8)
    y_true[1, 8 * 4 + 4:] = -1.0
    fn = loss.as_keras_loss(priors)
    jfn2 = jloss.as_keras_loss(jnp.asarray(priors))
    np.testing.assert_allclose(float(fn(_t(y_true), _t(y_pred))),
                               float(jfn2(jnp.asarray(y_true),
                                          jnp.asarray(y_pred))), rtol=1e-4)


# -- host post-processing, evaluation, readers ------------------------------

def test_detection_output_matches_jax():
    priors = tpb.generate_ssd_priors(
        [tpb.PriorBoxSpec(3, 20.0, 40.0, (2.0,))], 100.0)
    rs = np.random.RandomState(4)
    p = priors.shape[0]
    loc = (rs.randn(2, p, 4) * 0.5).astype(np.float32)
    conf = (rs.randn(2, p, 5) * 3).astype(np.float32)
    for kw in ({"conf_threshold": 0.2}, {"conf_threshold": 0.3,
                                         "top_k": 7}):
        got = tdet.DetectionOutput(5, **kw)(loc, conf, priors)
        want = jdet.DetectionOutput(5, **kw)(loc, conf, priors)
        assert [len(d) for d in got] == [len(d) for d in want]
        for gd, wd in zip(got, want):
            for g, w in zip(gd, wd):
                assert g.class_id == w.class_id
                np.testing.assert_allclose(g.score, w.score, rtol=1e-6)
                np.testing.assert_allclose(g.box, w.box, atol=1e-6)
    flat = np.concatenate([loc.reshape(2, -1), conf.reshape(2, -1)], 1)
    a = tdet.DetectionOutput(5).from_flat(flat, priors)
    b = tdet.DetectionOutput(5)(loc, conf, priors)
    assert [len(d) for d in a] == [len(d) for d in b]


@pytest.mark.parametrize("use_07", [False, True])
def test_mean_average_precision_matches_jax(use_07):
    rs = np.random.RandomState(5)
    gt_boxes = [_boxes(rs, 4) for _ in range(3)]
    gt_labels = [rs.randint(1, 4, 4) for _ in range(3)]
    dets_t, dets_j = [], []
    for boxes, labels in zip(gt_boxes, gt_labels):
        row_t, row_j = [], []
        for i in range(6):
            box = (boxes[i % 4] + rs.randn(4) * 0.02).astype(np.float32)
            cls, score = int(rs.randint(1, 4)), float(rs.rand())
            row_t.append(tdet.Detection(cls, score, box))
            row_j.append(jdet.Detection(cls, score, box))
        dets_t.append(row_t)
        dets_j.append(row_j)
    got = teval.MeanAveragePrecision(4, use_07_metric=use_07).evaluate(
        dets_t, gt_boxes, gt_labels)
    want = jeval.MeanAveragePrecision(4, use_07_metric=use_07).evaluate(
        dets_j, gt_boxes, gt_labels)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert got[1].keys() == want[1].keys()
    for k in got[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-6)


def test_voc_and_coco_readers_match_jax(tmp_path):
    (tmp_path / "Annotations").mkdir()
    (tmp_path / "JPEGImages").mkdir()
    for name, objs in (("a", [("dog", 10, 20, 50, 100),
                              ("zebra", 1, 1, 2, 2)]),
                       ("b", [("person", 0, 0, 100, 200),
                              ("car", 30, 40, 60, 90)])):
        body = "".join(
            f"<object><name>{n}</name><bndbox><xmin>{x0}</xmin><ymin>{y0}"
            f"</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
            for n, x0, y0, x1, y1 in objs)
        (tmp_path / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename><size><width>100"
            f"</width><height>200</height><depth>3</depth></size>{body}"
            "</annotation>")
    coco = {"images": [{"id": 1, "file_name": "x.jpg", "width": 200,
                        "height": 100},
                       {"id": 2, "file_name": "y.jpg", "width": 50,
                        "height": 50}],
            "categories": [{"id": 18, "name": "dog"},
                           {"id": 1, "name": "person"}],
            "annotations": [{"image_id": 1, "category_id": 18,
                             "bbox": [20, 10, 100, 50]},
                            {"image_id": 2, "category_id": 1,
                             "bbox": [0, 0, 25, 50]},
                            {"image_id": 1, "category_id": 1,
                             "bbox": [0, 0, 10, 10]}]}
    path = tmp_path / "coco.json"
    path.write_text(json.dumps(coco))
    for got, want in (
            (tod.PascalVocDataset(str(tmp_path)).read_annotations(),
             jod.PascalVocDataset(str(tmp_path)).read_annotations()),
            (tod.CocoDataset(str(path), "imgs").read_annotations(),
             jod.CocoDataset(str(path), "imgs").read_annotations())):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["image"] == w["image"]
            np.testing.assert_array_equal(g["boxes"], w["boxes"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    voc = tod.PascalVocDataset(str(tmp_path)).read_annotations()
    assert voc[0]["labels"].tolist() == [12]       # dog; zebra dropped


def test_visualizer_draws():
    dets = [tdet.Detection(1, 0.9, np.array([0.1, 0.1, 0.6, 0.6])),
            tdet.Detection(2, 0.1, np.array([0.0, 0.0, 0.5, 0.5]))]
    img = np.zeros((50, 50, 3), np.uint8)
    out = tdet.Visualizer(["bg", "cat"]).draw(img, dets)
    want = jdet.Visualizer(["bg", "cat"]).draw(img, [
        jdet.Detection(d.class_id, d.score, d.box) for d in dets])
    assert out.shape == (50, 50, 3) and out.sum() > 0
    np.testing.assert_array_equal(out, want)


def test_priors_match_jax():
    got = tpb.generate_ssd_priors(tpb.SSD300_SPECS, 300.0)
    assert got.shape == (8732, 4)
    np.testing.assert_array_equal(
        got, jpb.generate_ssd_priors(jpb.SSD300_SPECS, 300.0))
    assert [tpb.num_priors_per_cell(s) for s in tpb.SSD300_SPECS] == \
        [4, 6, 6, 6, 4, 4]


# -- SSD at 64x64 -------------------------------------------------------------

def _tiny_specs(pb):
    return [pb.PriorBoxSpec(8, 20.0, 40.0, (2.0,)),
            pb.PriorBoxSpec(4, 40.0, 60.0, (2.0,)),
            pb.PriorBoxSpec(2, 60.0, 80.0, (2.0,)),
            pb.PriorBoxSpec(1, 80.0, 100.0, (2.0,)),
            pb.PriorBoxSpec(1, 90.0, 110.0, (2.0,)),
            pb.PriorBoxSpec(1, 100.0, 120.0, (2.0,))]


def _tiny_detectors(policy="float32"):
    """The JAX and the port's 4-class SSD at 64x64 on the reference
    test's prior specs, compiled with SGD at lr 1e-3, the port holding
    the JAX weights. (At SGD's default 0.01 the random-init SSD diverges,
    losses 28 -> 69 -> 386 over three steps, and the packages' f32
    updates of the first convolutions, which differ by ~1e-3 of their
    largest where ReLUs sit at their kinks, grow with it: the second
    loss then differs by 4e-4.)"""
    from analytics_zoo_tpu.ops.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.ops.optimizers import SGD as TSGD
    dets = []
    for od, ssd, pb, sgd in ((jod, jssd, jpb, JSGD), (tod, tssd, tpb, TSGD)):
        det = od.ObjectDetector("ssd-vgg16-300x300", n_classes=4,
                                img_size=64)
        det._builder = ssd.SSDVGG(4, 64, specs=_tiny_specs(pb))
        det.priors = det._builder.priors
        det._model = None
        det.compile_detection(optimizer=sgd(lr=1e-3))
        det.model.estimator.set_dtype_policy(policy)
        dets.append(det)
    jdet_, tdet_ = dets
    # weights drawn by the port (the JAX package's eager initializers
    # take ~10 s here) and placed by the JAX Estimator
    est = jdet_.model.estimator
    est.params = est._place_params(params_to_numpy(
        tdet_.model.init_params(torch.Generator().manual_seed(0), "cpu")))
    est._ensure_initialized()
    return jdet_, tdet_


def _tiny_data(n=8):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 64, 64, 3).astype(np.float32)
    y = tod.ObjectDetector.pack_targets(
        [_boxes(rs, 2) for _ in range(n)],
        [rs.randint(0, 3, 2).astype(np.int32) for _ in range(n)], max_gt=4)
    return x, y


def test_ssd_tiny_forward_steps_and_detect_match_jax():
    jd, td = _tiny_detectors()
    assert np.array_equal(td.priors, jd.priors)
    assert td.priors.shape == (340, 4)
    names = set(td.model.params())
    for n in ("conv1_1", "conv5_3", "fc6", "fc7", "conv4_3_norm", "conv7_2",
              "head0_loc", "head3_conf"):
        assert n in names
    assert set(td.model.params()["conv4_3_norm"]) == {"scale"}
    x, y = _tiny_data()
    want = np.asarray(jd.model.forward(jd.model.estimator.params, x[:2]))
    got = td.model.predict(x[:2], batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    # the JAX package's detect is its DetectionOutput on that forward
    jdets = jdet.DetectionOutput(4, conf_threshold=0.2).from_flat(
        want, jd.priors)
    tdets = td.detect(x[:2], batch_size=2, conf_threshold=0.2)
    assert [len(d) for d in tdets] == [len(d) for d in jdets]
    for gd, wd in zip(tdets, jdets):
        for g, w in zip(gd, wd):
            assert g.class_id == w.class_id
            np.testing.assert_allclose(g.box, w.box, atol=1e-4)
    jl = [h["loss"] for h in jd.fit(x, y, batch_size=8,
                                    nb_epoch=2).history]
    tl = [h["loss"] for h in td.fit(x, y, batch_size=8,
                                    nb_epoch=2).history]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_ssd_tiny_mixed_bfloat16_loss_in_f32():
    jd, td = _tiny_detectors("mixed_bfloat16")
    seen = []
    loss_fn = td.model.estimator.loss_fn

    def spy(y_true, y_pred):
        seen.append((y_true.dtype, y_pred.dtype))
        return loss_fn(y_true, y_pred)

    td.model.estimator.loss_fn = spy
    x, y = _tiny_data()
    jl = jd.fit(x, y, batch_size=8, nb_epoch=1).history[0]["loss"]
    tl = td.fit(x, y, batch_size=8, nb_epoch=1).history[0]["loss"]
    assert seen == [(torch.float32, torch.float32)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_object_detection_config():
    from analytics_zoo_tpu.models.config import \
        ObjectDetectionConfig as JCfg
    from analytics_zoo_tpu_torch.models.config import \
        ObjectDetectionConfig as TCfg
    assert TCfg.names() == JCfg.names()
    with pytest.raises(FileNotFoundError):
        TCfg.create("ssd-vgg16-300x300")
    det = TCfg.create("analytics-zoo_ssd-vgg16-300x300_PASCAL_0.1.0",
                      allow_random=True)
    assert isinstance(det, tod.ObjectDetector)
    assert det.n_classes == 21 and det.img_size == 300
    assert det.model.compute_output_shape(None) == (8732 * (4 + 21),)


def test_object_detection_config_refuses_bigdl_model(tmp_path):
    from analytics_zoo_tpu_torch.models.config import ObjectDetectionConfig
    # a .model goes through Net.load_bigdl, whose codec refuses a file
    # that does not parse (as the reference's): no random weights
    path = tmp_path / "ssd.model"
    path.write_bytes(b"\0")
    with pytest.raises(IndexError):
        ObjectDetectionConfig.create("ssd-vgg16-300x300",
                                     weights_path=str(path))


def test_object_detection_example_runs_on_cpu(capsys):
    from analytics_zoo_tpu_torch.examples import EXAMPLES, object_detection
    assert "object_detection" in EXAMPLES
    out = object_detection.main(["--device", "cpu", "--images", "1",
                                 "--conf", "0.05"])
    assert len(out) == 1
    assert "image 0:" in capsys.readouterr().out
