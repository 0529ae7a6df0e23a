"""The port's keras dataset loaders against the JAX package's: each
``load_data`` on local cache files the test writes, and each seeded
synthetic stand-in (no cache file), array for array and list for list.
Nothing is downloaded by either package."""

import gzip
import os
import pickle

import numpy as np
import pytest

from analytics_zoo_tpu.pipeline.api.keras.datasets import (
    boston_housing as j_boston, imdb as j_imdb, mnist as j_mnist,
    reuters as j_reuters)
from analytics_zoo_tpu_torch.common.safe_pickle import UnsafePickleError
from analytics_zoo_tpu_torch.pipeline.api.keras import datasets
from analytics_zoo_tpu_torch.pipeline.api.keras.datasets import (
    boston_housing, imdb, mnist, reuters)


def _same(got, want):
    """Nested tuples/lists of arrays, lists and scalars: equal, with
    the same types and dtypes."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def test_package_exports_the_reference_modules():
    assert datasets.__all__ == ["mnist", "imdb", "reuters", "boston_housing"]
    assert (mnist.TRAIN_MEAN, mnist.TRAIN_STD, mnist.TEST_MEAN,
            mnist.TEST_STD) == (j_mnist.TRAIN_MEAN, j_mnist.TRAIN_STD,
                                j_mnist.TEST_MEAN, j_mnist.TEST_STD)


@pytest.mark.parametrize("port,ref,kw", [
    (mnist, j_mnist, {}),
    (boston_housing, j_boston, {"test_split": 0.3}),
    (imdb, j_imdb, {"nb_words": 500}),
    (imdb, j_imdb, {"nb_words": 500, "oov_char": None}),
    (reuters, j_reuters, {"nb_words": 1000, "test_split": 0.25}),
])
def test_synthetic_stand_ins_equal_reference(tmp_path, port, ref, kw):
    where = ({"location": str(tmp_path)} if port is mnist
             else {"dest_dir": str(tmp_path)})
    got = port.load_data(**where, **kw)
    _same(got, ref.load_data(**where, **kw))
    (x_train, y_train), (x_test, y_test) = got
    assert len(x_train) == len(y_train) and len(x_test) == len(y_test)
    assert not os.listdir(tmp_path)          # nothing written, nothing read


def _idx(path, magic, dims, data):
    with gzip.open(path, "wb") as f:
        f.write(np.array([magic, *dims], ">u4").tobytes())
        f.write(data.astype(np.uint8).tobytes())


def test_mnist_reads_idx_files(tmp_path):
    rs = np.random.RandomState(0)
    for split, n in (("train", 9), ("test", 5)):
        img, lbl, _ = mnist._FILES[split]
        _idx(tmp_path / img, 2051, (n, 28, 28), rs.randint(0, 256, n * 784))
        _idx(tmp_path / lbl, 2049, (n,), rs.randint(0, 10, n))
    got = mnist.load_data(str(tmp_path))
    _same(got, j_mnist.load_data(str(tmp_path)))
    assert got[0][0].shape == (9, 28, 28, 1) and got[1][1].shape == (5,)
    _idx(tmp_path / mnist._FILES["test"][0], 7, (5, 28, 28),
         np.zeros(5 * 784))
    with pytest.raises(ValueError, match="bad magic"):
        mnist.load_data(str(tmp_path))


def test_boston_housing_reads_npz(tmp_path):
    rs = np.random.RandomState(1)
    np.savez(tmp_path / "boston_housing.npz", x=rs.rand(40, 13),
             y=rs.rand(40))
    _same(boston_housing.load_data(dest_dir=str(tmp_path)),
          j_boston.load_data(dest_dir=str(tmp_path)))


def test_imdb_reads_pickle_and_refuses_a_gadget(tmp_path):
    data = (([[1, 5, 900], [2, 3]], [0, 1]), ([[7, 8, 12000]], [1]))
    with open(tmp_path / "imdb_full.pkl", "wb") as f:
        pickle.dump(data, f)
    for kw in ({}, {"nb_words": 10}, {"nb_words": 10, "oov_char": None}):
        got = imdb.load_data(dest_dir=str(tmp_path), **kw)
        _same(got, j_imdb.load_data(dest_dir=str(tmp_path), **kw))
    assert imdb.load_data(dest_dir=str(tmp_path), nb_words=10)[0][0] == \
        [[1, 5, 2], [2, 3]]
    with open(tmp_path / "imdb_full.pkl", "wb") as f:
        pickle.dump((os.getcwd, ()), f)
    with pytest.raises(UnsafePickleError):
        imdb.load_data(dest_dir=str(tmp_path))


def test_reuters_reads_flat_npz_pickle_and_legacy_npz(tmp_path):
    xs, ys = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10], [11]], [0, 3, 45, 2, 1]
    off = np.cumsum([0] + [len(s) for s in xs])
    np.savez(tmp_path / "reuters.npz", x_flat=np.concatenate(xs),
             x_off=off, y=np.asarray(ys))
    got = reuters.load_data(dest_dir=str(tmp_path), test_split=0.4)
    _same(got, j_reuters.load_data(dest_dir=str(tmp_path), test_split=0.4))
    assert [list(map(int, s)) for s in got[1][0]] == xs[:2]
    os.remove(tmp_path / "reuters.npz")
    with open(tmp_path / "reuters.pkl", "wb") as f:
        pickle.dump((xs, ys), f)
    _same(reuters.load_data(dest_dir=str(tmp_path), nb_words=6),
          j_reuters.load_data(dest_dir=str(tmp_path), nb_words=6))
    os.remove(tmp_path / "reuters.pkl")
    # a legacy object-array cache is read through the checked unpickler
    # and rewritten in the flat format
    obj = np.empty(len(xs), dtype=object)
    obj[:] = [list(s) for s in xs]
    np.savez(tmp_path / "reuters.npz", x=obj, y=np.asarray(ys))
    got = reuters.load_data(dest_dir=str(tmp_path), test_split=0.4)
    assert [list(s) for s in got[0][0]] == xs[2:]
    with np.load(tmp_path / "reuters.npz", allow_pickle=False) as f:
        assert sorted(f.files) == ["x_flat", "x_off", "y"]
