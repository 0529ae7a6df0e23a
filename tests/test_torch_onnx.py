"""The port's ONNX importer against the JAX package's, on the CPU: every
op of the reference's registry through both ``run_node``s on the same
numpy inputs (f32 within 1e-5, integer and boolean outputs equal), the
``If`` node, LSTM/GRU graphs, ``Resize`` in each supported mode (against
``jax.image.resize`` where it downsamples), ``TopK`` with ties, and a
small convolutional graph loaded, predicted and fine-tuned one step in
both packages from one file."""

import ast
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.onnx import onnx_loader as jol
from analytics_zoo_tpu_torch.pipeline.api.onnx import helper, onnx_pb
from analytics_zoo_tpu_torch.pipeline.api.onnx import onnx_loader as tol
from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import TensorProto
from onnx_op_cases import CASES, f32, mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _jax_context():
    """The JAX package's context on one host device (its tests run on
    eight virtual ones)."""
    import jax

    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])


def assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind or want.dtype.kind == "b", \
            (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=TOL,
                                   atol=TOL, err_msg=what)


@pytest.mark.parametrize("op", sorted(jol._OPS))
def test_op_matches_reference(op):
    assert op in tol._OPS, f"{op} is not registered in the port"
    rs = np.random.RandomState(sum(map(ord, op)))
    cases = CASES[op](rs)
    assert cases
    for k, case in enumerate(cases):
        node, inputs = case[0], case[1]
        kw = case[2] if len(case) > 2 else {}
        want = jol.run_node(node, inputs, **kw)
        got = tol.run_node(node, inputs, device="cpu", **kw)
        assert len(got) == len(want), (op, k)
        for j, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{op} case {k} output {j}")


def test_registry_matches_the_reference():
    assert sorted(tol._OPS) == sorted(jol._OPS)
    assert tol.OnnxLoader.supported_ops() == jol.OnnxLoader.supported_ops()


def test_refusals_match_the_reference():
    x = np.random.RandomState(0).randn(1, 2, 5, 5).astype(np.float32)
    bad = [
        (mk("Resize", ["x", "roi", "scales", "sizes"], ["y"], mode="cubic",
            coordinate_transformation_mode="align_corners"),
         [x, None, None, np.array([1, 2, 9, 3], np.int64)], "cubic"),
        (mk("Resize", ["x", "roi", "scales", "sizes"], ["y"], mode="linear",
            coordinate_transformation_mode="tf_crop_and_resize"),
         [x, None, None, np.array([1, 2, 9, 3], np.int64)], "coordinate"),
        (mk("Upsample", ["x", "s"], ["y"], mode="linear"),
         [x, np.array([1, 1, 2, 2], np.float32)], "asymmetric"),
        (mk("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
            strides=[2, 2], ceil_mode=1, count_include_pad=1), [x],
         "ceil_mode"),
        (mk("NonexistentOp", ["x"], ["y"]), [x], "Nonexistent"),
        (mk("DequantizeLinear", ["x", "s"], ["y"]),
         [np.zeros(3, np.uint8), np.array([.1, .2, .3], np.float32)],
         "axis 1 out of range"),
    ]
    for node, inputs, match in bad:
        for run in (jol.run_node,
                    lambda n, i: tol.run_node(n, i, device="cpu")):
            with pytest.raises(Exception, match=match):
                run(node, inputs)


def test_scatter_with_a_repeated_index_and_no_reduction_raises():
    x = np.zeros((3, 4), np.float32)
    for node, inputs in (
            (mk("ScatterElements", ["x", "i", "u"], ["y"], axis=1),
             [x, np.array([[1, 1]], np.int64),
              np.array([[5.0, 7.0]], np.float32)]),
            (mk("ScatterND", ["x", "i", "u"], ["y"]),
             [x, np.array([[1], [1]], np.int64),
              np.ones((2, 4), np.float32)])):
        with pytest.raises(NotImplementedError, match="write order"):
            tol.run_node(node, inputs, device="cpu")


def test_dropout_in_training():
    x = np.ones((200, 100), np.float32)
    node = mk("Dropout", ["x", "r"], ["y"])
    r = np.array(0.3, np.float32)
    a = tol.run_node(node, [x, r], device="cpu", training=True, rng=5)[0]
    b = tol.run_node(node, [x, r], device="cpu", training=True, rng=5)[0]
    np.testing.assert_array_equal(a, b)          # the seed fixes the mask
    kept = a != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_allclose(a[kept], 1 / 0.7, rtol=1e-6)
    want = jol.run_node(node, [x, r], training=True,
                        rng=__import__("jax").random.PRNGKey(5))[0]
    assert abs(kept.mean() - (want != 0).mean()) < 0.02
    # without a seed, or at inference, dropout is the identity
    np.testing.assert_array_equal(
        tol.run_node(node, [x, r], device="cpu", training=True)[0], x)


def _if_model(cond_is_input):
    then_g = helper.make_graph(
        [mk("Relu", ["x"], ["tb"])], "then", [],
        [helper.make_tensor_value_info("tb", TensorProto.FLOAT, [2, 3])], [])
    # a static condition never interprets the dead branch, whatever it
    # holds
    dead = [] if cond_is_input else [mk("NoSuchOp", ["x"], ["zz"])]
    else_g = helper.make_graph(
        [mk("Neg", ["x"], ["eb"])] + dead, "else",
        [], [helper.make_tensor_value_info("eb", TensorProto.FLOAT, [2, 3])],
        [])
    inputs = [helper.make_tensor_value_info("x", TensorProto.FLOAT, [2, 3])]
    inits = []
    if cond_is_input:
        inputs.append(helper.make_tensor_value_info(
            "c", TensorProto.BOOL, []))
    else:
        inits.append(helper.make_tensor("c", np.array(True)))
    graph = helper.make_graph(
        [mk("If", ["c"], ["y"], then_branch=then_g, else_branch=else_g)],
        "ifg", inputs,
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [2, 3])],
        inits)
    return helper.make_model(graph)


def test_if_node_static_and_from_an_input():
    import analytics_zoo_tpu_torch as tzoo
    tzoo.init_nncontext(device="cpu")
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    net = tol.OnnxLoader.load_model(_if_model(False).SerializeToString())
    params = net.init_params()
    got = net.call(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.maximum(x, 0))
    jnet = jol.OnnxLoader.load_model(_if_model(False).SerializeToString())
    np.testing.assert_allclose(
        got, np.asarray(jnet.call(jnet.init_params(), x)), rtol=TOL)
    # a condition fed as an input picks the branch per call
    net = tol.OnnxLoader.load_model(_if_model(True).SerializeToString())
    params = net.init_params()
    jnet = jol.OnnxLoader.load_model(_if_model(True).SerializeToString())
    jparams = jnet.init_params()
    for c in (True, False):
        got = net.call(params, [torch.from_numpy(x), torch.tensor(c)])
        want = jnet.call(jparams, [x, np.array(c)])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)
    np.testing.assert_allclose(got.numpy(), -x)


def _host_shape_graph():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape: shape
    arithmetic that must stay on the host."""
    nodes = [
        mk("Shape", ["x"], ["s"]),
        mk("Gather", ["s", "zero"], ["n"], axis=0),
        mk("Unsqueeze", ["n"], ["n1"], axes=[0]),
        mk("Concat", ["n1", "minus1"], ["shp"], axis=0),
        mk("Reshape", ["x", "shp"], ["f"]),
        mk("Gemm", ["f", "w"], ["y"], transB=1),
    ]
    rs = np.random.RandomState(3)
    graph = helper.make_graph(
        nodes, "shapes",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, ["N", 2, 3])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, ["N", 4])],
        [helper.make_tensor("zero", np.array(0, np.int64)),
         helper.make_tensor("minus1", np.array([-1], np.int64)),
         helper.make_tensor("w", rs.randn(4, 6).astype(np.float32))])
    return helper.make_model(graph)


def test_shape_arithmetic_stays_on_the_host():
    import analytics_zoo_tpu_torch as tzoo
    tzoo.init_nncontext(device="cpu")
    proto = _host_shape_graph()
    net = tol.OnnxLoader.load_model(proto)
    layer = net.layers[0]
    params = net.init_params()
    env = dict(layer._host)
    env.update(params[layer.name]["w"])
    x = torch.randn(5, 2, 3)
    env["x"] = x
    with tol._on("cpu"):
        layer._run_nodes(proto.graph.node, env, training=False, rng=None)
    for name in ("s", "n", "n1", "shp"):
        assert isinstance(env[name], np.ndarray), name
    assert isinstance(env["y"], torch.Tensor)
    # (the reference cannot load this graph: its shape inference traces
    # the Gather of the shape, and a traced shape operand raises)
    w = onnx_pb.tensor_to_numpy(proto.graph.initializer[2])
    want = x.numpy().reshape(5, -1) @ w.T
    np.testing.assert_allclose(env["y"].numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(net.predict(x.numpy()), want, rtol=TOL,
                               atol=TOL)
    # a static operand computed as data raises rather than reading it back
    with pytest.raises(ValueError, match="static operands"):
        tol._static(torch.zeros(2, device="meta"))


def _convnet_proto(rs):
    cw, cb = f32(rs, 4, 3, 3, 3, scale=0.3), f32(rs, 4, scale=0.1)
    bn = [rs.rand(4).astype(np.float32) + 0.5, f32(rs, 4, scale=0.1),
          f32(rs, 4, scale=0.1), rs.rand(4).astype(np.float32) + 0.5]
    fw, fb = f32(rs, 5, 4 * 4 * 4, scale=0.2), f32(rs, 5, scale=0.1)
    nodes = [
        mk("Conv", ["x", "cw", "cb"], ["c"], kernel_shape=[3, 3],
           pads=[1, 1, 1, 1]),
        mk("BatchNormalization", ["c", "g", "be", "m", "v"], ["cn"]),
        mk("Relu", ["cn"], ["cr"]),
        mk("MaxPool", ["cr"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
        mk("Flatten", ["p"], ["f"], axis=1),
        mk("Gemm", ["f", "fw", "fb"], ["y"], transB=1),
    ]
    inits = [helper.make_tensor(n, v) for n, v in
             (("cw", cw), ("cb", cb), ("g", bn[0]), ("be", bn[1]),
              ("m", bn[2]), ("v", bn[3]), ("fw", fw), ("fb", fb))]
    graph = helper.make_graph(
        nodes, "convnet",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       ["N", 3, 8, 8])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, ["N", 5])],
        inits)
    return helper.make_model(graph)


def test_conv_graph_loads_predicts_and_fine_tunes_as_the_reference(tmp_path):
    import analytics_zoo_tpu_torch as tzoo
    from analytics_zoo_tpu.ops.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.ops.optimizers import SGD as TSGD
    import jax

    tzoo.init_nncontext(device="cpu")
    _jax_context()
    rs = np.random.RandomState(11)
    path = str(tmp_path / "conv.onnx")
    onnx_pb.save_model(_convnet_proto(rs), path)
    x = rs.randn(4, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (4,)).astype(np.int32)
    tnet = tol.OnnxLoader.load_model(path)
    jnet = jol.OnnxLoader.load_model(path)
    assert tnet.layers[0].compute_output_shape((3, 8, 8)) == (5,)
    for net, sgd in ((tnet, TSGD), (jnet, JSGD)):
        net.compile(optimizer=sgd(lr=0.05, momentum=0.9),
                    loss="sparse_categorical_crossentropy")
    np.testing.assert_allclose(tnet.predict(x, batch_size=4),
                               jnet.predict(x, batch_size=4),
                               rtol=TOL, atol=TOL)
    tnet.fit(x, y, batch_size=4, nb_epoch=1)
    jnet.fit(x, y, batch_size=4, nb_epoch=1)
    got = params_to_numpy(tnet)[tnet.layers[0].name]["w"]
    want = jax.device_get(jnet.estimator.params)[jnet.layers[0].name]["w"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tnet.predict(x, batch_size=4),
                               jnet.predict(x, batch_size=4),
                               rtol=1e-4, atol=1e-4)


def test_graph_level_lstm_and_multi_output():
    import analytics_zoo_tpu_torch as tzoo
    tzoo.init_nncontext(device="cpu")
    rs = np.random.RandomState(2)
    t, bsz, inp, hid = 4, 2, 3, 5
    w, r = f32(rs, 1, 4 * hid, inp, scale=.4), f32(rs, 1, 4 * hid, hid,
                                                     scale=.4)
    b, gw = f32(rs, 1, 8 * hid, scale=.4), f32(rs, 2, hid, scale=.4)
    nodes = [mk("LSTM", ["x", "w", "r", "b"], ["ys", "yh", "yc"],
                hidden_size=hid),
             mk("Squeeze", ["yh"], ["h"], axes=[0]),
             mk("Gemm", ["h", "gw"], ["y"], transB=1),
             mk("Neg", ["h"], ["z"])]
    graph = helper.make_graph(
        nodes, "lstm_g",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       [t, bsz, inp])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [bsz, 2]),
         helper.make_tensor_value_info("z", TensorProto.FLOAT, [bsz, hid])],
        [helper.make_tensor(n, v) for n, v in
         (("w", w), ("r", r), ("b", b), ("gw", gw))])
    proto = helper.make_model(graph)
    x = f32(rs, t, bsz, inp)
    tl, jl = (tol.OnnxGraphLayer(proto.graph), jol.OnnxGraphLayer(
        proto.graph))
    assert tl.compute_output_shape((bsz, inp)) == \
        jl.compute_output_shape((bsz, inp))
    tp = tl.init(torch.Generator().manual_seed(0), (bsz, inp))
    jp = jl.init(__import__("jax").random.PRNGKey(0), (bsz, inp))
    got = tl.call(tp, torch.from_numpy(x))
    want = jl.call(jp, x)
    assert isinstance(got, list) and len(got) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)


def test_initializer_names_that_are_no_attribute_names():
    import analytics_zoo_tpu_torch as tzoo
    tzoo.init_nncontext(device="cpu")
    rs = np.random.RandomState(4)
    w = f32(rs, 3, 2)
    graph = helper.make_graph(
        [mk("MatMul", ["x", "fc.weight"], ["h"]),
         mk("Add", ["h", "training"], ["y"])], "names",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, ["N", 3])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, ["N", 2])],
        [helper.make_tensor("fc.weight", w),
         helper.make_tensor("training", f32(rs, 2))])
    net = tol.OnnxLoader.load_model(helper.make_model(graph))
    params = net.init_params()
    assert sorted(params[net.layers[0].name]["w"]) == ["fc.weight",
                                                       "training"]
    x = f32(rs, 4, 3)
    _jax_context()
    jnet = jol.OnnxLoader.load_model(
        helper.make_model(graph).SerializeToString())
    jnet.compile(optimizer="sgd", loss="mse")
    np.testing.assert_allclose(net.predict(x), jnet.predict(x), rtol=TOL,
                               atol=TOL)


def test_symbolic_dims_need_an_input_shape():
    import analytics_zoo_tpu_torch as tzoo
    tzoo.init_nncontext(device="cpu")
    graph = helper.make_graph(
        [mk("Relu", ["x"], ["y"])], "dyn",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, ["N", "H"])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, ["N", "H"])])
    proto = helper.make_model(graph)
    with pytest.raises(ValueError, match="symbolic"):
        tol.OnnxLoader.load_model(proto)
    net = tol.OnnxLoader.load_model(proto, input_shape=(7,))
    x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    np.testing.assert_allclose(net.predict(x, batch_size=3),
                               np.maximum(x, 0))


@pytest.mark.parametrize("name", ["onnx/onnx_pb.py", "onnx/helper.py",
                                  "bigdl_pb.py"])
def test_copied_codecs_match_the_reference_apart_from_imports(name):
    def tree(pkg):
        with open(os.path.join(ROOT, pkg, "pipeline", "api", name)) as f:
            mod = ast.parse(f.read())
        mod.body = [n for n in mod.body
                    if not isinstance(n, (ast.Import, ast.ImportFrom))]
        return ast.dump(mod)
    assert tree("analytics_zoo_tpu_torch") == tree("analytics_zoo_tpu")


def test_codec_round_trip(tmp_path):
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    graph = helper.make_graph(
        [mk("Gemm", ["x", "w"], ["y"], alpha=0.5, transB=1)], "g",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, [1, 3])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [1, 4])],
        [helper.make_tensor("w", w)])
    path = str(tmp_path / "m.onnx")
    onnx_pb.save_model(helper.make_model(graph, opset_version=13), path)
    from analytics_zoo_tpu.pipeline.api.onnx import onnx_pb as jpb
    with open(path, "rb") as f:
        blob = f.read()
    assert jpb.load_model(path).SerializeToString() == blob
    loaded = onnx_pb.load_model(path)
    np.testing.assert_array_equal(
        onnx_pb.tensor_to_numpy(loaded.graph.initializer[0]), w)
