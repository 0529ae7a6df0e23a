"""The port's model loaders against the JAX package's on the CPU, on
files the tests write: ``Net.load_torch`` (the cases of
``tests/test_net_load.py``), ``Net.load_caffe`` (a prototxt and a binary
caffemodel), ``Net.load_bigdl`` and ``Net.load`` (BigDL ``.model``
protobufs and the framework's own saved models), ``ImportedZooModel``'s
save/load round trip, both model configs' ``.model`` branch, and the
``onnx_import`` example as the reference's test runs its own."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.pipeline.api import bigdl_pb as pb
from analytics_zoo_tpu_torch.pipeline.api import caffe_load as tcaffe
from analytics_zoo_tpu_torch.pipeline.api.net_load import Net as TNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _ctx():
    import jax

    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    tzoo.init_nncontext(device="cpu")
    yield
    tzoo.reset_nncontext()


def _jnet():
    from analytics_zoo_tpu.pipeline.api.net_load import Net
    return Net


def held(tnet, jnet, x, tol=TOL, batch=None):
    """The port's and the reference's predictions on ``x``, equal within
    ``tol``; returns the port's."""
    batch = batch or len(x)
    got = np.asarray(tnet.predict(x, batch_size=batch))
    want = np.asarray(jnet.predict(x, batch_size=batch))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return got


# -- load_torch ---------------------------------------------------------------

def _seeded(seed, build):
    torch.manual_seed(seed)
    m = build()
    m.eval()
    return m


def _bn_trained(m, shape):
    m.train()
    with torch.no_grad():
        for _ in range(3):
            m(torch.randn(*shape))
    m.eval()
    return m


TORCH_CASES = {
    "mlp": (lambda: nn.Sequential(nn.Linear(6, 16), nn.ReLU(),
                                  nn.Dropout(0.0), nn.Linear(16, 3),
                                  nn.Softmax(dim=-1)), (6,), 1e-5),
    "convnet": (lambda: nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=1, padding=1), nn.BatchNorm2d(8),
        nn.ReLU(), nn.MaxPool2d(2), nn.Conv2d(8, 4, 3), nn.ReLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(4, 5)),
        (3, 12, 12), 1e-4),
    "padded_maxpool_negative_window": (
        lambda: nn.Sequential(nn.MaxPool2d(2, stride=2, padding=1)),
        (1, 4, 4), 1e-5),
    "bn_no_affine": (lambda: _bn_trained(nn.Sequential(
        nn.Conv2d(2, 3, 3), nn.BatchNorm2d(3, affine=False), nn.Flatten(),
        nn.Linear(3 * 4 * 4, 2)), (4, 2, 6, 6)), (2, 6, 6), 1e-4),
    "padded_avgpool": (lambda: nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.AvgPool2d(3, stride=2, padding=1)),
        (3, 10, 10), 1e-4),
    "adaptive_avgpool_any_size": (lambda: nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.AdaptiveAvgPool2d((2, 2)),
        nn.Flatten(), nn.Linear(32, 4)), (3, 8, 8), 1e-4),
    "grouped_conv": (lambda: nn.Sequential(
        nn.Conv2d(8, 16, 3, padding=1), nn.ReLU(),
        nn.Conv2d(16, 16, 3, groups=4, padding=1)), (8, 12, 12), 1e-4),
    "activations": (lambda: nn.Sequential(
        nn.Linear(5, 6), nn.LeakyReLU(0.2), nn.Linear(6, 6), nn.ELU(0.7),
        nn.Linear(6, 4), nn.Tanh(), nn.LayerNorm(4), nn.Sigmoid(),
        nn.BatchNorm1d(4)), (5,), 1e-5),
}
CEIL_CASES = [(3, 2, 0, (7, 7)), (3, 2, 1, (8, 8)), (2, 2, 0, (7, 7)),
              (3, 3, 1, (6, 6)), ((3, 2), (2, 2), 0, (9, 6))]
for _k, _s, _p, _size in CEIL_CASES:
    TORCH_CASES[f"ceil_maxpool_{_k}_{_s}_{_p}_{_size[0]}x{_size[1]}"] = (
        (lambda k, s, p: lambda: nn.Sequential(
            nn.Conv2d(3, 4, 3, padding=1),
            nn.MaxPool2d(k, stride=s, padding=p, ceil_mode=True)))(
                _k, _s, _p), (3,) + _size, 1e-4)
TORCH_CASES["ceil_avgpool_harmless"] = (
    lambda: nn.Sequential(nn.AvgPool2d(2, 2, ceil_mode=True)), (3, 8, 8),
    1e-5)


@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_load_torch_matches_module_and_reference(case):
    build, shape, tol = TORCH_CASES[case]
    tm = _seeded(sum(map(ord, case)), build)
    rs = np.random.RandomState(0)
    x = rs.randn(2, *shape).astype(np.float32)
    if case.startswith("padded_maxpool"):
        x = -np.abs(x) - 1.0
    tnet = TNet.load_torch(tm, input_shape=shape)
    jnet = _jnet().load_torch(tm, input_shape=shape)
    got = held(tnet, jnet, x, tol=tol)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(),
                                   rtol=tol, atol=tol)
    # the net owns its weights: the module's storage is not shared
    module_ptrs = {p.data_ptr() for p in tm.parameters()}
    assert not module_ptrs & {p.data_ptr() for p in tnet.parameters()}
    if case.startswith("padded_maxpool"):
        assert got.max() < 0


def test_load_torch_embedding():
    tm = _seeded(3, lambda: nn.Sequential(nn.Embedding(20, 8), nn.Flatten(),
                                          nn.Linear(5 * 8, 2)))
    x = np.random.RandomState(1).randint(0, 20, (3, 5)).astype(np.int32)
    got = held(TNet.load_torch(tm, input_shape=(5,)),
               _jnet().load_torch(tm, input_shape=(5,)), x)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x).long()),
                                   rtol=TOL, atol=TOL)


def test_load_torch_fine_tunes_as_the_reference():
    from analytics_zoo_tpu.ops.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.ops.optimizers import Adam as TAdam
    tm = _seeded(5, lambda: nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                          nn.Linear(8, 1)))
    rs = np.random.RandomState(2)
    x = rs.randn(32, 4).astype(np.float32)
    y = x.sum(1, keepdims=True).astype(np.float32)
    tnet = TNet.load_torch(tm, input_shape=(4,))
    jnet = _jnet().load_torch(tm, input_shape=(4,))
    tnet.compile(optimizer=TAdam(lr=0.05), loss="mse")
    jnet.compile(optimizer=JAdam(lr=0.05), loss="mse")
    before = float(np.mean((held(tnet, jnet, x) - y) ** 2))
    tnet.fit(x, y, batch_size=16, nb_epoch=3)
    jnet.fit(x, y, batch_size=16, nb_epoch=3)
    after = float(np.mean((held(tnet, jnet, x, tol=1e-4) - y) ** 2))
    assert after < before


def test_load_torch_from_a_path_weights_only(tmp_path):
    tm = _seeded(4, lambda: nn.Sequential(nn.Linear(6, 8), nn.ReLU(),
                                          nn.Linear(8, 2)))
    p = str(tmp_path / "model.pt")
    torch.save(tm, p)
    x = np.random.RandomState(3).randn(3, 6).astype(np.float32)
    held(TNet.load_torch(p, input_shape=(6,)),
         _jnet().load_torch(p, input_shape=(6,)), x)


def test_load_torch_refusals():
    import pickle

    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    cases = [
        (nn.Sequential(nn.Linear(4, 4), nn.TransformerEncoderLayer(4, 2)),
         (4,), NotImplementedError, "ONNX"),
        (nn.Sequential(nn.AvgPool2d(3, stride=2, ceil_mode=True)),
         (3, 8, 8), NotImplementedError, "ceil"),
        (nn.Sequential(nn.Conv2d(3, 4, 3, padding=1,
                                 padding_mode="reflect")),
         (3, 8, 8), NotImplementedError, "padding_mode"),
        (nn.Sequential(nn.BatchNorm2d(3, track_running_stats=False)),
         (3, 8, 8), NotImplementedError, "track_running_stats"),
        (nn.Sequential(nn.AvgPool2d(3, padding=1, count_include_pad=False)),
         (3, 10, 10), NotImplementedError, "count_include_pad"),
        (nn.Sequential(nn.AvgPool2d(3, divisor_override=5)),
         (3, 10, 10), NotImplementedError, "divisor_override"),
        (nn.Sequential(nn.AdaptiveAvgPool2d((3, 3))), (3, 8, 8),
         NotImplementedError, "non-divisible"),
    ]
    for module, shape, exc, match in cases:
        for net in (TNet, _jnet()):
            with pytest.raises(exc, match=match):
                net.load_torch(module, input_shape=shape)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "evil.pt")
        with open(p, "wb") as f:
            pickle.dump(Evil(), f)
        with pytest.raises(RuntimeError, match="refusing to unpickle"):
            TNet.load_torch(p, input_shape=(4,))
    with pytest.raises(FileNotFoundError):
        TNet.load_caffe("deploy.prototxt", "weights.caffemodel")
    for fn in (TNet.load_tf, TNet.load_keras):
        with pytest.raises(NotImplementedError, match="A16e"):
            fn("model")


def test_net_load_reads_a_saved_zoo_model(tmp_path):
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    ncf = NeuralCF(user_count=20, item_count=30, num_classes=2,
                   user_embed=8, item_embed=8, hidden_layers=(16, 8))
    ncf.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(4)
    x = np.stack([rs.randint(1, 21, 16), rs.randint(1, 31, 16)],
                 axis=1).astype(np.int32)
    before = ncf.predict(x, batch_size=16)
    path = str(tmp_path / "ncf.zoomodel")
    ncf.save_model(path)
    np.testing.assert_allclose(TNet.load(path).predict(x, batch_size=16),
                               before, rtol=TOL, atol=TOL)


# -- BigDL .model files -------------------------------------------------------

_NN = "com.intel.analytics.bigdl.nn."


def _tensor(arr):
    arr = np.asarray(arr, np.float32)
    return pb.BigDLTensor(
        datatype=pb.DT_FLOAT, size=list(arr.shape),
        stride=list(np.array(arr.strides) // 4), offset=1,
        dimension=arr.ndim, nElements=arr.size,
        storage=pb.TensorStorage(datatype=pb.DT_FLOAT,
                                 float_data=arr.reshape(-1).tolist()))


def _attrs(**kw):
    out = []
    for k, v in kw.items():
        if isinstance(v, float):
            val = pb.AttrValue(doubleValue=v)
        elif isinstance(v, (list, tuple)):
            val = pb.AttrValue(arrayValue=pb.ArrayValue(i32=list(v)))
        else:
            val = pb.AttrValue(int32Value=int(v))
        out.append(pb.AttrEntry(key=k, value=val))
    return out


def _module(kind, name=None, weight=None, bias=None, subs=(), **attrs):
    return pb.BigDLModule(
        name=name, moduleType=_NN + kind, subModules=list(subs),
        weight=None if weight is None else _tensor(weight),
        bias=None if bias is None else _tensor(bias), attr=_attrs(**attrs))


def bigdl_lenet(rs):
    """A LeNet-5 ``.model`` at the reference fixture's widths (28x28,
    6 and 12 filters of 5x5, a 100-wide hidden layer, 5 classes, a
    LogSoftMax head), with seeded weights and BatchNorm statistics."""
    w = lambda *s: (rs.randn(*s) * 0.2).astype(np.float32)  # noqa: E731
    bn = _module("SpatialBatchNormalization", "bn1",
                 weight=rs.rand(6) + 0.5, bias=w(6), eps=1e-5,
                 momentum=0.1)
    bn.attr += [pb.AttrEntry(key="runningMean",
                             value=pb.AttrValue(tensorValue=_tensor(w(6)))),
                pb.AttrEntry(key="runningVar", value=pb.AttrValue(
                    tensorValue=_tensor(rs.rand(6) + 0.5)))]
    layers = [
        _module("Reshape", "reshape", size=[1, 28, 28]),
        _module("SpatialConvolution", "conv1", weight=w(6, 1, 5, 5),
                bias=w(6), nInputPlane=1, nOutputPlane=6, kernelW=5,
                kernelH=5),
        bn,
        _module("Tanh", "tanh1"),
        _module("SpatialMaxPooling", "pool1", kW=2, kH=2, dW=2, dH=2),
        _module("SpatialConvolution", "conv2", weight=w(12, 6, 5, 5),
                bias=w(12), nInputPlane=6, nOutputPlane=12, kernelW=5,
                kernelH=5, padW=1, padH=1),
        _module("ReLU", "relu2"),
        _module("SpatialAveragePooling", "pool2", kW=2, kH=2, dW=2, dH=2),
        _module("Reshape", "flat", size=[12 * 5 * 5]),
        _module("Linear", "fc1", weight=w(100, 300), bias=w(100),
                outputSize=100),
        _module("Dropout", "drop", initP=0.5),
        _module("Linear", "fc2", weight=w(5, 100), bias=w(5), outputSize=5),
        _module("LogSoftMax", "out"),
    ]
    return _module("Sequential", "lenet", subs=layers)


def _write(path, module):
    with open(path, "wb") as f:
        f.write(module.SerializeToString())
    return str(path)


def test_load_bigdl_lenet_predicts_as_the_reference(tmp_path):
    rs = np.random.RandomState(6)
    path = _write(tmp_path / "lenet.model", bigdl_lenet(rs))
    tnet, jnet = TNet.load_bigdl(path), _jnet().load_bigdl(path)
    x = rs.randn(4, 784).astype(np.float32)
    out = held(tnet, jnet, x, tol=1e-4)
    assert out.shape == (4, 5)
    np.testing.assert_allclose(np.exp(out).sum(-1), 1.0, atol=1e-4)
    # Net.load sniffs the same file as BigDL
    held(TNet.load(path), jnet, x, tol=1e-4)
    # the imported weights are the file's
    table = pb.StorageTable(pb.load_model(path))
    fc2 = next(s for s in pb.load_model(path).subModules if s.name == "fc2")
    np.testing.assert_allclose(params_to_numpy(tnet)["fc2"]["kernel"],
                               table.tensor_to_numpy(fc2.weight).T,
                               atol=1e-7)
    # and it fine-tunes
    y = rs.randint(0, 5, (8,)).astype(np.int32)
    tnet.compile(optimizer="sgd", loss="class_nll")
    tnet.fit(x[:4].repeat(2, 0), y, batch_size=8, nb_epoch=1)
    assert np.isfinite(tnet.predict(x)).all()


def test_load_bigdl_linear_static_graph_and_keras_wrapper(tmp_path):
    rs = np.random.RandomState(7)
    w1, b1 = rs.randn(6, 4).astype(np.float32), rs.randn(6).astype(
        np.float32)
    lin = _module("Linear", "inner", weight=w1, bias=b1, outputSize=6)
    dense = pb.BigDLModule(
        name="dense1", moduleType="com.intel.analytics.zoo.pipeline.api."
        "keras.layers.Dense", subModules=[lin],
        attr=_attrs(outputDim=6) + [pb.AttrEntry(
            key="inputShape", value=pb.AttrValue(
                shape=pb.BShape(shapeValue=[4])))])
    relu = _module("ReLU", "r")
    relu.preModules = ["dense1"]
    out = _module("Linear", "fc", weight=rs.randn(3, 6), bias=rs.randn(3),
                  outputSize=3)
    out.preModules = ["r"]
    graph = _module("StaticGraph", "g", subs=[out, relu, dense])
    path = _write(tmp_path / "graph.model", graph)
    x = rs.randn(5, 4).astype(np.float32)
    got = held(TNet.load_bigdl(path), _jnet().load_bigdl(path), x, tol=1e-5)
    want = np.maximum(x @ w1.T + b1, 0) @ np.asarray(
        pb.StorageTable().tensor_to_numpy(out.weight)).T + \
        pb.StorageTable().tensor_to_numpy(out.bias)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    bad = _module("Sequential", "s", subs=[_module("Cosine", "c")])
    path = _write(tmp_path / "bad.model", bad)
    for net in (TNet, _jnet()):
        with pytest.raises(NotImplementedError, match="Cosine"):
            net.load_bigdl(path, input_shape=(4,))


def test_imported_zoo_model_round_trip(tmp_path):
    from analytics_zoo_tpu.models.common import ImportedZooModel as JIZM
    from analytics_zoo_tpu_torch.models.common import ImportedZooModel
    from analytics_zoo_tpu_torch.models.common import ZooModel
    rs = np.random.RandomState(8)
    path = _write(tmp_path / "lenet.model", bigdl_lenet(rs))
    x = rs.randn(3, 784).astype(np.float32)
    m = ImportedZooModel(path, model_name="lenet")
    m.compile(optimizer="sgd", loss="class_nll")
    jm = JIZM(path, model_name="lenet")
    jm.compile(optimizer="sgd", loss="class_nll")
    np.testing.assert_allclose(m.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-4, atol=1e-4)
    y = rs.randint(0, 5, (8,)).astype(np.int32)
    m.fit(rs.randn(8, 784).astype(np.float32), y, batch_size=8, nb_epoch=1)
    tuned = m.predict(x)
    saved = str(tmp_path / "tuned.zoo")
    m.save_model(saved)
    back = ZooModel.load_model(saved)
    assert isinstance(back, ImportedZooModel)
    assert back.hyper_parameters() == {"artifact": path,
                                       "model_name": "lenet"}
    np.testing.assert_allclose(back.predict(x), tuned, rtol=TOL, atol=TOL)
    text = back.summary()
    assert "conv1 (Convolution2D)" in text and "Total params" in text


def test_configs_import_a_bigdl_model(tmp_path):
    from analytics_zoo_tpu.models import config as jconfig
    from analytics_zoo_tpu_torch.models import config as tconfig
    from analytics_zoo_tpu_torch.models.common import ImportedZooModel
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    rs = np.random.RandomState(9)
    path = _write(tmp_path / "lenet-5.model", bigdl_lenet(rs))
    x = rs.randn(2, 784).astype(np.float32)
    clf = tconfig.ImageClassificationConfig.create("lenet-5",
                                                   weights_path=path)
    jclf = jconfig.ImageClassificationConfig.create("lenet-5",
                                                    weights_path=path)
    assert isinstance(clf, ImageClassifier)
    np.testing.assert_allclose(clf.predict(x), np.asarray(jclf.predict(x)),
                               rtol=1e-4, atol=1e-4)
    det = tconfig.ObjectDetectionConfig.create("custom-det",
                                               weights_path=path)
    jdet = jconfig.ObjectDetectionConfig.create("custom-det",
                                                weights_path=path)
    assert isinstance(det, ImportedZooModel) and det.model_name == \
        "custom-det"
    np.testing.assert_allclose(det.predict(x), np.asarray(jdet.predict(x)),
                               rtol=1e-4, atol=1e-4)


# -- Caffe --------------------------------------------------------------------

LENET_PROTOTXT = '''
name: "LeNet"  # LeNet-5 at Caffe's example widths
input: "data"
input_dim: 1 input_dim: 1 input_dim: 28 input_dim: 28
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 20 kernel_size: 5 stride: 1 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
        convolution_param { num_output: 50 kernel_size: 5 pad: 1 } }
layer { name: "bn2" type: "BatchNorm" bottom: "conv2" top: "conv2" }
layer { name: "sc2" type: "Scale" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
        pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
        inner_product_param { num_output: 500 } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "drop" type: "Dropout" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 10 } }
layer { name: "prob" type: "Softmax" bottom: "ip2" top: "prob" }
'''


def caffe_lenet_weights(rs):
    w = lambda *s: (rs.randn(*s) * 0.1).astype(np.float32)  # noqa: E731

    def blob(a):
        return tcaffe.BlobProto(shape=tcaffe.BlobShape(dim=list(a.shape)),
                                data=np.asarray(a).reshape(-1).tolist())

    def layer(name, *arrays):
        return tcaffe.CaffeLayerParameter(name=name,
                                          blobs=[blob(a) for a in arrays])
    net = tcaffe.NetParameter(name="LeNet", layer=[
        layer("conv1", w(20, 1, 5, 5), w(20)),
        layer("conv2", w(50, 20, 5, 5), w(50)),
        layer("bn2", w(50) * 2, rs.rand(50).astype(np.float32) * 2 + 1,
              np.array([2.0], np.float32)),
        layer("sc2", rs.rand(50).astype(np.float32) + 0.5, w(50)),
        layer("ip1", w(500, 50 * 5 * 5), w(500)),
        layer("ip2", w(10, 500), w(10)),
    ])
    return net.SerializeToString()


def test_load_caffe_lenet_predicts_as_the_reference(tmp_path):
    rs = np.random.RandomState(10)
    proto = tmp_path / "lenet.prototxt"
    proto.write_text(LENET_PROTOTXT)
    model = tmp_path / "lenet.caffemodel"
    model.write_bytes(caffe_lenet_weights(rs))
    tnet = TNet.load_caffe(str(proto), str(model))
    jnet = _jnet().load_caffe(str(proto), str(model))
    x = rs.randn(3, 1, 28, 28).astype(np.float32)
    out = held(tnet, jnet, x, tol=1e-4)
    assert out.shape == (3, 10)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    # the weights are the file's, in HWIO
    saved = tcaffe.NetParameter()
    saved.ParseFromString(model.read_bytes())
    conv = next(lyr for lyr in saved.layer if lyr.name == "conv1")
    np.testing.assert_allclose(
        params_to_numpy(tnet)["conv1"]["kernel"],
        np.transpose(conv.blobs[0].to_numpy(), (2, 3, 1, 0)), atol=1e-7)
    # architecture only: drawn weights, the same shapes
    assert TNet.load_caffe(str(proto)).predict(x).shape == (3, 10)


def test_caffe_grouped_conv_imports(tmp_path):
    proto = tmp_path / "g.prototxt"
    proto.write_text('''
        name: "g"
        input: "data"
        input_dim: 1 input_dim: 4 input_dim: 6 input_dim: 6
        layer { name: "conv_g" type: "Convolution" bottom: "data"
                top: "conv_g"
                convolution_param { num_output: 8 kernel_size: 3
                                    group: 2 bias_term: true } }
    ''')
    net = TNet.load_caffe(str(proto), input_shape=(4, 6, 6))
    x = np.random.RandomState(11).randn(2, 4, 6, 6).astype(np.float32)
    out = np.asarray(net.predict(x, batch_size=2))
    assert out.shape == (2, 8, 4, 4)
    p = params_to_numpy(net)["conv_g"]
    tconv = torch.nn.Conv2d(4, 8, 3, groups=2, bias=True)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(p["kernel"], (3, 2, 0, 1)))))
        tconv.bias.copy_(torch.from_numpy(p["bias"]))
        want = tconv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_prototxt_parser_matches_the_reference():
    from analytics_zoo_tpu.pipeline.api.caffe_load import parse_prototxt
    text = '''
        name: "n"  # comment
        input_dim: 1 input_dim: 3
        layer { name: "c" type: "Convolution"
                convolution_param { num_output: 4 bias_term: false
                                    pool: MAX scale: 0.5 } }
        layers { name: "v1" type: CONVOLUTION }
    '''
    d = tcaffe.parse_prototxt(text)
    assert d == parse_prototxt(text)
    assert d["input_dim"] == [1, 3]
    p = d["layer"][0]["convolution_param"][0]
    assert p["num_output"] == [4] and p["bias_term"] == [False]
    assert p["pool"] == ["MAX"] and p["scale"] == [0.5]


# -- the example --------------------------------------------------------------

def test_onnx_import_example(tmp_path):
    path = os.path.join(ROOT, "analytics_zoo_tpu_torch", "examples",
                        "onnx_import.py")
    spec = importlib.util.spec_from_file_location("example_onnx_import",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--path", str(tmp_path / "m.onnx"), "--epochs", "1",
                    "--device", "cpu"])
    assert np.isfinite(out["mse_after"])
    assert os.path.exists(tmp_path / "m.onnx")
