"""The port's host image data path against the JAX package's, on the
CPU: every one of the 24 host transformers on the same images with the
same seeds, ``ImageSet.read`` (labels from class directories, an
undecodable file skipped, a flat folder, ``memory://``), ``from_arrays``,
``to_arrays`` and ``to_feature_set`` in each tier, the 3-D transforms,
and the ``image_classification`` example on a folder of PNGs, where the
reference's example raises.

Everything is numpy and PIL on the host: results are held bit for bit.
"""

import io
import uuid

import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature import image3d as jimage3d
from analytics_zoo_tpu.feature.common import Sample as JSample
from analytics_zoo_tpu.feature.image3d.transforms import \
    trilinear_sample as j_trilinear
from analytics_zoo_tpu_torch.common import utils as tutils
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.feature import image3d as timage3d
from analytics_zoo_tpu_torch.feature.common import Sample as TSample

PIL = pytest.importorskip("PIL.Image")

H, W = 16, 20


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _images(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def _png(img) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _same(got, want, where=""):
    """Two feature values equal bit for bit (arrays with their dtypes,
    Samples field by field, the rest by ==)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, JSample):
        assert isinstance(got, TSample), where
        _same(got.feature, want.feature, where + ".feature")
        _same(got.label, want.label, where + ".label")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def _same_sets(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got.features, want.features)):
        assert sorted(g) == sorted(w), i
        for k in w:
            _same(g[k], w[k], f"feature {i} {k}")


# one factory per exported transformer: (name, build(L), input kind)
TRANSFORMS = [
    ("ImageResize", lambda L: L.ImageResize(12, 10), "u8"),
    ("ImageCenterCrop", lambda L: L.ImageCenterCrop(10, 8), "u8"),
    ("ImageRandomCrop", lambda L: L.ImageRandomCrop(10, 8, seed=1), "u8"),
    ("ImageHFlip", lambda L: L.ImageHFlip(0.5, seed=2), "u8"),
    ("ImageBrightness", lambda L: L.ImageBrightness(seed=3), "u8"),
    ("ImageContrast", lambda L: L.ImageContrast(seed=4), "u8"),
    ("ImageSaturation", lambda L: L.ImageSaturation(seed=5), "u8"),
    ("ImageHue", lambda L: L.ImageHue(seed=6), "u8"),
    ("ImageChannelNormalize",
     lambda L: L.ImageChannelNormalize(123.0, 117.0, 104.0, 58.0, 57.0, 57.5),
     "u8"),
    ("ImagePixelNormalizer",
     lambda L: L.ImagePixelNormalizer(
         np.random.RandomState(9).rand(H, W, 3) * 255), "u8"),
    ("ImageMatToTensor", lambda L: L.ImageMatToTensor(), "u8"),
    ("ImageMatToTensor-chw", lambda L: L.ImageMatToTensor(to_chw=True),
     "u8"),
    ("ImageSetToSample", lambda L: L.ImageSetToSample(), "u8"),
    ("ImageExpand", lambda L: L.ImageExpand(seed=7, max_expand_ratio=2.0),
     "u8"),
    ("ImageFiller", lambda L: L.ImageFiller(0.1, 0.2, 0.5, 0.6, value=7),
     "u8"),
    ("ImageRandomPreprocessing",
     lambda L: L.ImageRandomPreprocessing(L.ImageHFlip(1.0), 0.5, seed=8),
     "u8"),
    ("ImageAspectScale", lambda L: L.ImageAspectScale(8, max_size=14), "u8"),
    ("ImageRandomAspectScale",
     lambda L: L.ImageRandomAspectScale([6, 8, 10], max_size=20, seed=9),
     "u8"),
    ("ImageChannelScaledNormalizer",
     lambda L: L.ImageChannelScaledNormalizer(100.0, 110.0, 120.0, 0.0175),
     "u8"),
    ("ImageColorJitter", lambda L: L.ImageColorJitter(seed=10), "u8"),
    ("ImageBytesToMat", lambda L: L.ImageBytesToMat(), "png"),
    ("ImageBytesToMat-bgr", lambda L: L.ImageBytesToMat("BGR"), "png"),
    ("ImageBytesToMat-decoded", lambda L: L.ImageBytesToMat("BGR"), "u8"),
    ("ImagePixelBytesToMat", lambda L: L.ImagePixelBytesToMat(H, W, 3),
     "raw"),
    ("ImageChannelOrder", lambda L: L.ImageChannelOrder(), "u8"),
    ("ImageFixedCrop", lambda L: L.ImageFixedCrop(0.1, 0.2, 0.7, 0.9), "u8"),
    ("ImageFixedCrop-abs",
     lambda L: L.ImageFixedCrop(2, 3, 15, 11, normalized=False), "u8"),
    ("ImageMatToFloats", lambda L: L.ImageMatToFloats(), "u8"),
]


def _input_set(L, kind):
    imgs = _images()
    labels = np.arange(len(imgs)) % 3
    if kind == "u8":
        return L.ImageSet.from_arrays(imgs, labels)
    blobs = [_png(a) if kind == "png" else a.tobytes() for a in imgs]
    return L.ImageSet([L.ImageFeature(b, label=int(lab), uri=f"img{i}")
                       for i, (b, lab) in enumerate(zip(blobs, labels))])


@pytest.mark.parametrize("name, build, kind", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_host_transform_matches_jax(name, build, kind):
    got = _input_set(timage, kind).transform(build(timage))
    want = _input_set(jimage, kind).transform(build(jimage))
    _same_sets(got, want)


def test_every_exported_transform_is_covered():
    assert timage.__all__ == jimage.__all__ and len(timage.__all__) == 27
    covered = {name.split("-")[0] for name, _, _ in TRANSFORMS}
    assert covered == set(timage.__all__) - {
        "ImageFeature", "ImageSet", "LocalImageSet"}


def test_chained_pipeline_and_sample_match_jax():
    def chain(L):
        return (L.ImagePixelBytesToMat(H, W, 3), L.ImageHFlip(seed=1),
                L.ImageBrightness(seed=2), L.ImageSaturation(seed=3),
                L.ImageChannelNormalize(123.0, 117.0, 104.0),
                L.ImageMatToTensor(), L.ImageSetToSample())
    got = _input_set(timage, "raw").transform(*chain(timage))
    want = _input_set(jimage, "raw").transform(*chain(jimage))
    _same_sets(got, want)
    x, y = got.to_arrays()
    wx, wy = want.to_arrays()
    _same(x, wx)
    _same(y, wy)
    assert x.shape == (6, H, W, 3) and y.shape == (6, 1)


# -- ImageSet.read and the exports --------------------------------------------

def _write_tree(root, flat=False):
    imgs = _images(5, seed=1)
    names = []
    for i, img in enumerate(imgs):
        cls = "" if flat else ("cat/", "dog/")[i % 2]
        names.append(f"{root}/{cls}{i}.png")
        tutils.save_bytes(_png(img), names[-1])
    tutils.save_bytes(b"not an image", f"{root}/{'' if flat else 'dog/'}"
                      "bad.png")
    return names


@pytest.mark.parametrize("where", ["local", "memory"])
def test_image_set_read_matches_jax(where, tmp_path, caplog):
    root = (str(tmp_path) if where == "local"
            else f"memory://zoo-img-{uuid.uuid4().hex}")
    _write_tree(root)
    got = timage.ImageSet.read(root, with_label_from_dirs=True)
    assert "skipped 1 of 6 file(s)" in caplog.text
    want = jimage.ImageSet.read(root, with_label_from_dirs=True)
    assert len(got) == 5
    _same_sets(got, want)
    assert [int(f.label[0]) for f in got.features] == [0, 0, 0, 1, 1]
    few = timage.ImageSet.read(root, with_label_from_dirs=True,
                               max_images=2)
    _same_sets(few, jimage.ImageSet.read(root, with_label_from_dirs=True,
                                         max_images=2))
    assert len(few) == 2


def test_flat_read_tiers_and_arrays_match_jax(tmp_path):
    _write_tree(str(tmp_path), flat=True)
    got = timage.ImageSet.read(str(tmp_path))
    want = jimage.ImageSet.read(str(tmp_path))
    _same_sets(got, want)
    assert got.to_arrays()[1] is None
    _same(got.get_image(), want.get_image())
    assert got.get_label() == want.get_label() == [None] * 5
    imgs, labels = _images(8), np.arange(8) % 2
    for tier in ("dram", "direct", "pmem"):
        g = timage.ImageSet.from_arrays(imgs, labels).to_feature_set(tier)
        w = jimage.ImageSet.from_arrays(imgs, labels).to_feature_set(tier)
        assert g.memory_type.value == tier
        for (gx, gy), (wx, wy) in zip(g.iter_batches(3, seed=4),
                                      w.iter_batches(3, seed=4)):
            _same(gx, wx)
            _same(np.asarray(gy), np.asarray(wy))
    assert timage.LocalImageSet is timage.ImageSet


# -- 3-D transforms -----------------------------------------------------------

def _volumes():
    rs = np.random.RandomState(2)
    return [rs.rand(6, 7, 8).astype(np.float32),
            rs.rand(5, 6, 7, 2).astype(np.float32),
            rs.randint(0, 255, (6, 6, 6)).astype(np.uint8)]


TRANSFORMS_3D = [
    ("affine-clamp", lambda L, v: L.AffineTransform3D(
        np.diag([1.1, 0.9, 1.2]) + 0.05, (0.3, -0.2, 0.5))),
    ("affine-padding", lambda L, v: L.AffineTransform3D(
        np.eye(3) * 1.3, (1.0, 0.0, -0.5), clamp_mode="padding",
        pad_value=-1.0)),
    ("rotation", lambda L, v: L.Rotation3D((0.3, -0.2, 0.5))),
    ("rotation-padding", lambda L, v: L.Rotation3D(
        (0.0, 0.0, 0.7), clamp_mode="padding")),
    ("crop", lambda L, v: L.Crop3D((1, 2, 0), (3, 3, 4))),
    ("random-crop", lambda L, v: L.RandomCrop3D(3, 4, 5, seed=3)),
    ("center-crop", lambda L, v: L.CenterCrop3D(3, 4, 5)),
    ("warp", lambda L, v: L.WarpTransformer(
        np.random.RandomState(4).randn(*v.shape[:3], 3))),
    ("warp-padding", lambda L, v: L.WarpTransformer(
        np.random.RandomState(5).randn(*v.shape[:3], 3) * 2,
        clamp_mode="padding", pad_value=3.0)),
]


@pytest.mark.parametrize("name, build", TRANSFORMS_3D,
                         ids=[t[0] for t in TRANSFORMS_3D])
def test_3d_transform_matches_jax(name, build):
    for vol in _volumes():
        t, j = build(timage3d, vol), build(jimage3d, vol)
        for _ in range(2):     # a random crop draws again
            got = t.apply(timage3d.ImageFeature3D(vol, label=1, uri="v"))
            want = j.apply(jimage3d.ImageFeature3D(vol, label=1, uri="v"))
            assert sorted(got) == sorted(want)
            _same(got.image, want.image, name)
            _same(got["original_size"], want["original_size"])


def test_3d_sampler_and_errors_match_jax():
    vol = _volumes()[0]
    coords = np.random.RandomState(6).uniform(-1, 9, (3, 40))
    for mode in ("clamp", "constant"):
        _same(timage3d.trilinear_sample(vol, coords, mode, 2.0),
              j_trilinear(vol, coords, mode, 2.0))
    # a raw ndarray is wrapped on the fly
    _same(timage3d.CenterCrop3D(2, 2, 2).apply(vol).image,
          jimage3d.CenterCrop3D(2, 2, 2).apply(vol).image)
    for bad in (lambda L: L.ImageFeature3D(np.zeros((3, 3))),
                lambda L: L.Crop3D((0, 0), (1, 1)),
                lambda L: L.Crop3D((5, 0, 0), (3, 3, 3)).apply(vol),
                lambda L: L.RandomCrop3D(9, 1, 1).apply(vol),
                lambda L: L.AffineTransform3D(np.eye(3), clamp_mode="wrap"),
                lambda L: L.WarpTransformer(np.zeros((2, 2, 2))),
                lambda L: L.WarpTransformer(np.zeros((2, 2, 2, 3))).apply(
                    vol)):
        with pytest.raises(ValueError):
            bad(jimage3d)
        with pytest.raises(ValueError):
            bad(timage3d)


# -- the image_classification example -----------------------------------------

def test_image_classification_example_reads_a_folder(tmp_path, capsys):
    from analytics_zoo_tpu_torch.examples import (EXAMPLES,
                                                  image_classification)
    assert "image_classification" in EXAMPLES
    _write_tree(str(tmp_path), flat=True)
    args = ["--image-size", "32", "--classes", "5", "--model", "squeezenet",
            "--top-n", "2"]
    results = image_classification.main(
        ["--device", "cpu", "--folder", str(tmp_path)] + args)
    assert [uri for uri, _ in results] == \
        [f"{tmp_path}/{i}.png" for i in range(5)]
    for _, top in results:
        assert len(top) == 2 and all(0 <= c < 5 for c, _ in top)
        assert top[0][1] >= top[1][1]
    synthetic = image_classification.main(["--device", "cpu"] + args)
    assert [u for u, _ in synthetic] == [f"synthetic_{i}" for i in range(4)]
    assert "synthetic_3: class" in capsys.readouterr().out
    # the reference's --folder branch reads a generator's .features
    # (ROADMAP C, deliberate differences)
    from analytics_zoo_tpu.examples import image_classification as jic
    with pytest.raises(AttributeError, match="generator"):
        jic.main(["--folder", str(tmp_path)] + args)
