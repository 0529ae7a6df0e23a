"""The port's nnframes against the JAX package's, on the CPU, part two:
``NNModel.save``/``load`` (a round trip, the class whitelist, a lambda
refused), ``NNImageReader``'s DataFrame (local, resized, ``memory://``,
undecodable files), a ``LocalRdd`` source and the chunked transform of a
duck-typed Spark DataFrame. Part one, ``test_torch_nnframes.py``, holds
``fit`` and ``transform``, the setters and the weight rules.

Tolerances: predictions within 1e-5 of max(1, max|value|); DataFrames
of images, weights of one package's two paths and chunk sizes exactly.
"""

import io
import logging
import os
import pickle
import uuid

import jax
import numpy as np
import pandas as pd
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline import nnframes as jnn
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common.safe_pickle import (
    UnsafePickleError, checked_load, load_architecture)
from analytics_zoo_tpu_torch.feature.common import SeqToTensor
from analytics_zoo_tpu_torch.feature.rdd import LocalRdd
from analytics_zoo_tpu_torch.pipeline import nnframes as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu.feature.common import SeqToTensor as JSeqToTensor
from test_torch_nnframes import _close, _frame, _near, _net, _pair


@pytest.fixture(autouse=True)
def _ctx(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    # no FLOP count in each fit's first step: no test here reads it
    monkeypatch.setenv("ZOO_TPU_GOODPUT_FLOPS", "0")
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    yield
    tzoo.reset_nncontext()


# -- persistence --------------------------------------------------------------

@pytest.mark.parametrize("klass", ["NNEstimator", "NNClassifier"])
def test_save_load_round_trip(klass, tmp_path):
    t, _, _ = _pair(2, "softmax")
    df = _frame(16, kind="classes")
    m = (getattr(tnn, klass)(t, "sparse_categorical_crossentropy",
                             SeqToTensor((4,)))
         .set_batch_size(8).set_max_epoch(1).set_prediction_col("p")
         .fit(df))
    path = str(tmp_path / "nn.model")
    m.save(path)
    with pytest.raises(FileExistsError):
        m.save(path)
    m.save(path, over_write=True)
    # the weights are numpy: a file saved on the card loads on the CPU
    state = load_architecture(path)
    leaves = [v for d in state["params"].values() for v in d.values()]
    assert all(type(v) is np.ndarray for v in leaves)
    tzoo.reset_nncontext()
    tzoo.init_nncontext(seed=1, device="cpu")
    loaded = tnn.NNModel.load(path)
    assert type(loaded) is type(m) and loaded.prediction_col == "p"
    assert loaded.batch_size == 8 and loaded.model is not t
    assert loaded.model.device.type == "cpu"
    got, want = loaded.transform(df)["p"], m.transform(df)["p"]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_load_refuses_a_class_outside_the_whitelist(tmp_path):
    path = str(tmp_path / "evil.model")
    with open(path, "wb") as f:
        pickle.dump({"class": "NNModel", "model": uuid.UUID(int=1)}, f)
    with pytest.raises(UnsafePickleError):
        tnn.NNModel.load(path)
    # a file of the JAX package names its classes
    with open(path, "wb") as f:
        pickle.dump({"class": "NNModel", "model": _net(JL, JSequential, 1),
                     "params": {}}, f)
    with pytest.raises(UnsafePickleError, match="analytics_zoo_tpu"):
        tnn.NNModel.load(path)
    # a persistent id names only the port's tensor functions
    buf = io.BytesIO()

    class _Evil(pickle.Pickler):
        def persistent_id(self, obj):
            return ("fn", "os", "system") if obj == "x" else None
    _Evil(buf).dump({"class": "NNModel", "model": "x"})
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    with pytest.raises(UnsafePickleError):
        tnn.NNModel.load(path)


class _Call:
    """Pickles as a call of the persistent id's object on ``args``."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


def _pid_file(path, pid):
    """An NNModel file whose net is the persistent id ``pid``, called
    with a path (what a REDUCE gadget would do with ``from_file``)."""
    buf = io.BytesIO()
    def tag(*args):
        raise AssertionError("written as the persistent id")

    class _Tagged(pickle.Pickler):
        def persistent_id(self, obj):
            return pid if obj is tag else None
    _Tagged(buf).dump({"class": "NNModel",
                       "model": _Call(tag, (str(path), True, 8))})
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@pytest.mark.parametrize("pid", [
    ("torch_op", "from_file"), ("fn", "activation", "from_file"),
    ("fn", "initializer", "__class__"), ("fn", "torch", "from_file"),
    ("fn", "torch.nn.functional", "relu"), ("fn", "activation", 1),
    ("estimator", "extra"), "params"])
def test_load_refuses_a_persistent_id_outside_the_registries(pid, tmp_path):
    path = tmp_path / "evil.model"
    _pid_file(path, pid)
    with pytest.raises(UnsafePickleError, match="persistent id"):
        tnn.NNModel.load(str(path))
    assert path.stat().st_size > 0


@pytest.mark.parametrize("pid", [("fn", "activation", "relu"),
                                 ("estimator",), ("params",)])
def test_checkpoint_load_refuses_every_persistent_id(pid, tmp_path):
    # checked_load reads the Estimator's checkpoints: an architecture's
    # tags, even those NNModel.load reads, are refused there
    path = tmp_path / "ckpt"
    with open(path, "wb") as f:
        buf = io.BytesIO()

        class _Tagged(pickle.Pickler):
            def persistent_id(self, obj):
                return pid if obj == "x" else None
        _Tagged(buf).dump({"params": "x"})
        f.write(buf.getvalue())
    with pytest.raises(pickle.UnpicklingError):
        checked_load(str(path))


def test_loaded_model_trains_from_its_weights(tmp_path):
    # (a) for a loaded model: the loaded net carries the file's weights
    # and is compiled, so a later fit starts from them, as the
    # reference's compiled net trains from the weights it carries (its
    # own save cannot pickle a compiled net's Estimator, so its side
    # fits the same net twice); the loaded NNModel keeps its weights
    t, j, _ = _pair(2, "softmax")
    df = _frame(16, kind="classes")
    df["label"] = df["label"].astype(np.float64)

    def fit(lib, net, pre, lr=0.1):
        return (lib.NNClassifier(net, "softmax_cross_entropy", pre)
                .set_batch_size(8).set_max_epoch(1)
                .set_optim_method("sgd").set_learning_rate(lr).fit(df))
    path = str(tmp_path / "nn.model")
    tm1 = fit(tnn, t, SeqToTensor((4,)))
    tm1.save(path)
    loaded = tnn.NNModel.load(path)
    before = np.stack(loaded.transform(df)["prediction"])
    tm2 = fit(tnn, loaded.model, SeqToTensor((4,)))
    jm1 = fit(jnn, j, JSeqToTensor((4,)))
    jw1 = jax.device_get(jm1.estimator.params)
    jm2 = fit(jnn, j, JSeqToTensor((4,)))
    tw1 = params_to_numpy(tm1.params)
    _close(tw1, jw1)
    _close(loaded.params, tw1, tol=0)
    _close(tm2.params, jm2.estimator.params)
    assert not all(np.allclose(params_to_numpy(tm2.params)["head"][k],
                               tw1["head"][k]) for k in tw1["head"])
    np.testing.assert_array_equal(
        np.stack(loaded.transform(df)["prediction"]), before)
    # a net saved before it was compiled also keeps the loaded weights:
    # a fit at a learning rate of 0 leaves them as they are
    u, _, _ = _pair(2, "softmax", compiled=False)
    fit(tnn, u, SeqToTensor((4,))).save(path, over_write=True)
    loaded = tnn.NNModel.load(path)
    _close(fit(tnn, loaded.model, SeqToTensor((4,)), lr=0.0).params,
           params_to_numpy(loaded.params), tol=0)


def test_save_refuses_a_lambda(tmp_path):
    from analytics_zoo_tpu_torch.feature.common import FnPreprocessing
    t, _, _ = _pair()
    m = tnn.NNModel(t, FnPreprocessing(lambda v: v))
    with pytest.raises((ValueError, pickle.PicklingError, AttributeError)):
        m.save(str(tmp_path / "lambda.model"))


# -- NNImageReader ------------------------------------------------------------

def _images(write, names, rs):
    from PIL import Image
    for name in names:
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 255, (10, 12, 3)).astype(np.uint8)) \
            .save(buf, format="PNG")
        write(name, buf.getvalue())


@pytest.mark.parametrize("where,resize", [("local", None), ("local", (6, 8)),
                                          ("memory", None)])
def test_image_reader_matches_the_reference(where, resize, tmp_path):
    rs = np.random.RandomState(0)
    if where == "local":
        root = str(tmp_path)

        def write(name, data):
            os.makedirs(os.path.dirname(os.path.join(root, name)),
                        exist_ok=True)
            with open(os.path.join(root, name), "wb") as f:
                f.write(data)
    else:
        import fsspec
        fs = fsspec.filesystem("memory")
        base = f"/nnimg-{uuid.uuid4().hex}"
        root = "memory://" + base.lstrip("/")

        def write(name, data):
            with fs.open(f"{base}/{name}", "wb") as f:
                f.write(data)
    _images(write, ["a.png", "sub/b.png", "sub/c.png"], rs)
    write("sub/notes.txt", b"hi")
    kw = {} if resize is None else {"resize_h": resize[0],
                                    "resize_w": resize[1]}
    got = tnn.NNImageReader.read_images(root, **kw)
    want = jnn.NNImageReader.read_images(root, **kw)
    assert list(got.columns) == tnn.NNImageSchema.COLUMNS == \
        list(want.columns)
    assert len(got) == 3
    for col in tnn.NNImageSchema.COLUMNS:
        for a, b in zip(got[col], want[col]):
            np.testing.assert_array_equal(a, b)
    shape = tnn.NNImageSchema.to_ndarray(got.iloc[0]).shape
    assert shape == ((10, 12, 3) if resize is None else (*resize, 3))
    if where == "memory":
        assert got.iloc[0]["origin"].startswith("memory://")
        fs.rm(base, recursive=True)


def test_image_reader_warns_once_for_undecodable_files(tmp_path, caplog,
                                                       monkeypatch):
    rs = np.random.RandomState(0)

    def write(name, data):
        (tmp_path / name).write_bytes(data)
    _images(write, ["img0.png", "img1.png"], rs)
    (tmp_path / "corrupt.png").write_bytes(b"\x89PNG but truncated")
    monkeypatch.setattr(logging.getLogger("analytics_zoo_tpu_torch"),
                        "propagate", True)
    name = "analytics_zoo_tpu_torch.pipeline.nnframes.nn_image_reader"
    with caplog.at_level("WARNING", logger=name):
        df = tnn.NNImageReader.read_images(str(tmp_path))
    assert len(df) == 2
    msgs = [r.getMessage() for r in caplog.records if r.name == name]
    assert len(msgs) == 1 and "skipped 1 of 3" in msgs[0]


# -- sources: a LocalRdd, a Spark DataFrame -----------------------------------

def test_local_rdd_of_tuples_trains_as_the_dataframe():
    df = _frame(kind="classes")
    rdd = LocalRdd(list(zip(df["features"], df["label"].astype(float))),
                   num_partitions=4)
    _, _, w0 = _pair(2, "softmax", compiled=False)
    models = []
    for src in (df, rdd):
        t = _net(TL, Sequential, 2, "softmax")
        t.load_params(w0)
        t.compile("adam", "mse")
        models.append(tnn.NNClassifier(t, "sparse_categorical_crossentropy")
                      .set_batch_size(8).set_max_epoch(2).fit(src))
    _close(models[0].params, params_to_numpy(models[1].params), tol=0)


class _FakeSparkDF:
    """A duck-typed Spark DataFrame: ``toLocalIterator``,
    ``createDataFrame`` (which logs each chunk's rows) and
    ``unionAll``."""

    class _Session:
        def __init__(self, log):
            self._log = log

        def createDataFrame(self, pdf):
            self._log.append(len(pdf))
            return _FakeSparkDF(pdf, self._log)

    def __init__(self, pdf, log=None):
        self._pdf = pdf.reset_index(drop=True)
        self._log = [] if log is None else log
        self.sparkSession = _FakeSparkDF._Session(self._log)

    @property
    def columns(self):
        return list(self._pdf.columns)

    @property
    def rdd(self):
        return None

    def toPandas(self):
        return self._pdf.copy()

    def toLocalIterator(self):
        yield from self._pdf.itertuples(index=False)

    def unionAll(self, other):
        return _FakeSparkDF(pd.concat([self._pdf, other._pdf],
                                      ignore_index=True), self._log)


@pytest.mark.parametrize("klass", ["NNModel", "NNClassifierModel"])
def test_spark_dataframe_streams_in_chunks(klass, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRANSFORM_CHUNK", "8")
    t, j, _ = _pair(2, "softmax")
    df = _frame(20, kind="classes")[["features"]]
    out = {}
    for key, lib, net in (("port", tnn, t), ("ref", jnn, j)):
        # the reference's NNModel draws fresh weights without its
        # compiled Estimator; the port's takes the net's
        m = (getattr(lib, klass)(net) if key == "port" else
             getattr(lib, klass)(net, estimator=net.estimator))
        m.set_batch_size(4)
        sdf = _FakeSparkDF(df)
        res = m.transform(sdf)
        out[key] = (sdf._log, res.toPandas(), m.transform(df))
    assert out["port"][0] == out["ref"][0] == [8, 8, 4]
    pandas_path = out["port"][2]["prediction"]
    for key in ("port", "ref"):
        res = out[key][1]
        assert list(res.columns) == list(out["port"][2].columns)
        _near(np.array([np.asarray(v, np.float64)
                        for v in res["prediction"]]),
              np.array([np.asarray(v, np.float64) for v in pandas_path]),
              msg=key)
