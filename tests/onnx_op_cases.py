"""ONNX op cases shared by the CPU tests against the JAX package
(``test_torch_onnx.py``) and the card tests (``test_torch_import_cuda.py``):
for every op name of the reference's registry, a builder from a seeded
``RandomState`` to ``(node, inputs[, run_node kwargs])`` cases, with the
inputs of the reference's ``tests/test_onnx.py``. numpy and the port's
proto helper only (no JAX, so the card's machine can import it)."""

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.onnx import helper
from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import TensorProto

mk = helper.make_node


def f32(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def i64(*v):
    return np.array(v, np.int64)


def u8(rs, *shape):
    return rs.randint(0, 255, shape).astype(np.uint8)


def _unary(op, lo=None, hi=None):
    def build(rs):
        x = f32(rs, 3, 4)
        if lo is not None:
            x = (rs.rand(3, 4) * (hi - lo) + lo).astype(np.float32)
        return [(mk(op, ["x"], ["y"]), [x])]
    return build


def _binary(op):
    def build(rs):
        a, b = f32(rs, 2, 3, 4), f32(rs, 4)
        return [(mk(op, ["a", "b"], ["y"]), [a, b])]
    return build


def _reduce(op, positive=False):
    def build(rs):
        x = f32(rs, 2, 3, 4)
        if positive:
            x = np.abs(x) + 0.1
        return [(mk(op, ["x"], ["y"], axes=[1]), [x]),
                (mk(op, ["x"], ["y"], axes=[0, 2], keepdims=0), [x]),
                (mk(op, ["x", "ax"], ["y"], keepdims=1), [x, i64(2)]),
                (mk(op, ["x"], ["y"]), [x])]
    return build


def _int_conv(rs):
    x8, w8 = u8(rs, 1, 3, 7, 7), u8(rs, 4, 3, 3, 3)
    return [(mk("ConvInteger", ["x", "w", "xz", "wz"], ["y"],
                kernel_shape=[3, 3]),
             [x8, w8, np.array(120, np.uint8), np.array(128, np.uint8)]),
            (mk("ConvInteger", ["x", "w"], ["y"], kernel_shape=[3, 3],
                pads=[1, 0, 2, 1], strides=[2, 1]), [x8, w8])]


def _int_matmul(rs):
    a8, b8 = u8(rs, 2, 5), u8(rs, 5, 3)
    n = mk("MatMulInteger", ["a", "b", "az", "bz"], ["y"])
    return [(n, [a8, b8, np.array(7, np.uint8), np.array(9, np.uint8)]),
            (n, [a8, b8, np.array([3, 11], np.uint8),
                 np.array(9, np.uint8)]),
            (n, [u8(rs, 3, 2, 5), u8(rs, 3, 5, 4), np.array(1, np.uint8),
                 np.array(2, np.uint8)])]


def _qlinear_conv(rs):
    x8, w8 = u8(rs, 1, 3, 7, 7), u8(rs, 4, 3, 3, 3)
    args = [x8, np.array(0.02, np.float32), np.array(120, np.uint8), w8,
            np.array([0.01, 0.02, 0.03, 0.04], np.float32),
            np.array(128, np.uint8), np.array(0.2, np.float32),
            np.array(100, np.uint8),
            rs.randint(-500, 500, (4,)).astype(np.int32)]
    return [(mk("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys",
                                "yz", "b"], ["y"], kernel_shape=[3, 3]),
             args),
            (mk("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys",
                                "yz"], ["y"], kernel_shape=[3, 3],
                pads=[1, 1, 1, 1]), args[:8])]


def _qlinear_matmul(rs):
    node = mk("QLinearMatMul",
              ["a", "sa", "za", "b", "sb", "zb", "sy", "zy"], ["y"])
    sc = [np.array(0.02, np.float32), np.array(120, np.uint8)]
    sb = [np.array(0.03, np.float32), np.array(130, np.uint8)]
    sy = [np.array(0.1, np.float32), np.array(128, np.uint8)]
    return [(node, [u8(rs, 2, 5)] + sc + [u8(rs, 5, 3)] + sb + sy),
            (node, [u8(rs, 3, 2, 5)] + sc + [u8(rs, 3, 5, 4)] + sb + sy),
            (node, [u8(rs, 2, 5), np.array([0.02, 0.04], np.float32),
                    np.array([120, 3], np.uint8), u8(rs, 5, 3)] + sb + sy)]


def _lstm(rs):
    t, b, i, h = 5, 2, 3, 4
    out = []
    for dirs, direction in ((1, "forward"), (1, "reverse"),
                            (2, "bidirectional")):
        w, r = f32(rs, dirs, 4 * h, i, scale=0.4), f32(rs, dirs, 4 * h, h,
                                                         scale=0.4)
        bias = f32(rs, dirs, 8 * h, scale=0.4)
        x = f32(rs, t, b, i)
        out.append((mk("LSTM", ["x", "w", "r", "b"], ["y", "yh", "yc"],
                       hidden_size=h, direction=direction),
                    [x, w, r, bias]))
    h0, c0 = f32(rs, 1, b, h), f32(rs, 1, b, h)
    out.append((mk("LSTM", ["x", "w", "r", "", "", "h0", "c0"],
                   ["y", "yh", "yc"], hidden_size=h),
                [f32(rs, t, b, i), f32(rs, 1, 4 * h, i, scale=0.4),
                 f32(rs, 1, 4 * h, h, scale=0.4), None, None, h0, c0]))
    return out


def _gru(rs):
    t, b, i, h = 5, 2, 3, 4
    out = []
    for lbr in (0, 1):
        for dirs, direction in ((1, "forward"), (2, "bidirectional")):
            out.append((mk("GRU", ["x", "w", "r", "b"], ["y", "yh"],
                           hidden_size=h, linear_before_reset=lbr,
                           direction=direction),
                        [f32(rs, t, b, i), f32(rs, dirs, 3 * h, i, scale=.4),
                         f32(rs, dirs, 3 * h, h, scale=.4),
                         f32(rs, dirs, 6 * h, scale=.4)]))
    return out


def _resize(rs):
    x = f32(rs, 1, 2, 5, 7)
    node = lambda **kw: mk("Resize", ["x", "roi", "scales", "sizes"],  # noqa
                           ["y"], **kw)
    sizes = lambda *s: np.array(s, np.int64)  # noqa: E731
    out = []
    for mode in ("nearest", "linear", "cubic"):
        for sz in ((1, 2, 10, 14), (1, 2, 3, 4), (1, 2, 8, 5)):
            out.append((node(mode=mode), [x, None, None, sizes(*sz)]))
    out += [
        (node(mode="linear", coordinate_transformation_mode="align_corners"),
         [x, None, None, sizes(1, 2, 10, 14)]),
        (node(mode="linear", coordinate_transformation_mode="align_corners"),
         [x, None, None, sizes(1, 2, 3, 4)]),
        (node(mode="nearest",
              coordinate_transformation_mode="align_corners"),
         [x, None, None, sizes(1, 2, 9, 3)]),
        (node(mode="nearest", coordinate_transformation_mode="asymmetric",
              nearest_mode="floor"), [x, None, None, sizes(1, 2, 11, 4)]),
        (node(mode="linear",
              coordinate_transformation_mode="pytorch_half_pixel"),
         [x, None, None, sizes(1, 2, 4, 9)]),
        (mk("Resize", ["x", "roi", "scales"], ["y"], mode="nearest"),
         [x, None, np.array([1, 1, 1.9, 1.9], np.float32)]),
        (mk("Resize", ["x", "roi", "scales"], ["y"], mode="linear"),
         [x, None, np.array([1, 1, 0.5, 0.6], np.float32)]),
    ]
    return out


def _topk(rs):
    x = f32(rs, 2, 6)
    ties = np.array([[1, 3, 3, 2, 3, 1], [0, 0, 5, 5, 0, 5]], np.float32)
    return [(mk("TopK", ["x", "k"], ["v", "i"], axis=-1), [x, i64(3)]),
            (mk("TopK", ["x", "k"], ["v", "i"], axis=-1, largest=0),
             [x, i64(2)]),
            (mk("TopK", ["x", "k"], ["v", "i"], axis=-1), [ties, i64(4)]),
            (mk("TopK", ["x", "k"], ["v", "i"], axis=-1, largest=0),
             [ties, i64(4)]),
            (mk("TopK", ["x", "k"], ["v", "i"], axis=0), [ties, i64(1)]),
            (mk("TopK", ["x", "k"], ["v", "i"], largest=0),
             [np.array([[0, 5, 3]], np.uint8), i64(1)])]


def _arg(op):
    def build(rs):
        x = f32(rs, 2, 3, 4)
        ties = np.array([[2, 7, 7, 1], [3, 3, 0, 3]], np.float32)
        return [(mk(op, ["x"], ["y"], axis=2, keepdims=0), [x]),
                (mk(op, ["x"], ["y"]), [x]),
                (mk(op, ["x"], ["y"], axis=1), [ties]),
                (mk(op, ["x"], ["y"], axis=1, select_last_index=1),
                 [ties])]
    return build


def _pool(op):
    def build(rs):
        x = f32(rs, 2, 3, 8, 8)
        out = [(mk(op, ["x"], ["y"], kernel_shape=[2, 2], strides=[2, 2]),
                [x]),
               (mk(op, ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1]), [x]),
               (mk(op, ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                   ceil_mode=1), [f32(rs, 2, 3, 7, 7)]),
               (mk(op, ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                   auto_pad="SAME_UPPER"), [x]),
               (mk(op, ["x"], ["y"], kernel_shape=[3], strides=[2],
                   pads=[1, 0]), [f32(rs, 2, 3, 9)])]
        if op == "MaxPool":
            out += [(mk(op, ["x"], ["y"], kernel_shape=[2, 2],
                        dilations=[2, 2]), [f32(rs, 1, 2, 9, 9)]),
                    (mk(op, ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                        pads=[0, 0, 1, 1]),
                     [-np.abs(x) - 1.0])]
        else:
            out.append((mk(op, ["x"], ["y"], kernel_shape=[3, 3],
                           strides=[2, 2], pads=[1, 1, 1, 1],
                           count_include_pad=1), [x]))
        return out
    return build


def _scatter_elements(rs):
    idx = np.array([[1, 3], [0, 2]], np.int64)
    upd = np.array([[5.0, 7.0], [1.0, 2.0]], np.float32)
    base = f32(rs, 3, 4)
    out = [(mk(op, ["x", "i", "u"], ["y"], axis=1), [base, idx, upd])
           for op in ("ScatterElements",)]
    for red in ("add", "mul", "max", "min"):
        out.append((mk("ScatterElements", ["x", "i", "u"], ["y"], axis=1,
                       reduction=red),
                    [base, np.array([[1, 1], [0, -1]], np.int64), upd]))
    return out


def _scatter_nd(rs):
    base = f32(rs, 4, 3)
    sidx = np.array([[1], [3]], np.int64)
    upd = f32(rs, 2, 3)
    out = [(mk("ScatterND", ["x", "i", "u"], ["y"]), [base, sidx, upd]),
           (mk("ScatterND", ["x", "i", "u"], ["y"]),
            [f32(rs, 2, 3, 4), np.array([[0, 1], [1, 2]], np.int64),
             f32(rs, 2, 4)])]
    for red in ("add", "mul", "max", "min"):
        out.append((mk("ScatterND", ["x", "i", "u"], ["y"], reduction=red),
                    [base, np.array([[1], [1], [3]], np.int64),
                     f32(rs, 3, 3)]))
    return out


def _quantize(rs):
    x = f32(rs, 4, 6, scale=3)
    return [(mk("QuantizeLinear", ["x", "s", "z"], ["y"]),
             [x, np.array(0.05, np.float32), np.array(128, np.uint8)]),
            (mk("QuantizeLinear", ["x", "s"], ["y"]),
             [x, np.array(0.05, np.float32)]),
            (mk("QuantizeLinear", ["x", "s", "z"], ["y"], axis=0),
             [x, np.array([0.1, 0.2, 0.3, 0.4], np.float32),
              np.array([1, -2, 3, 0], np.int8)])]


def _dequantize(rs):
    w = u8(rs, 3, 4)
    ws = np.array([0.1, 0.2, 0.3], np.float32)
    return [(mk("DequantizeLinear", ["x", "s", "z"], ["y"]),
             [w, np.array(0.05, np.float32), np.array(128, np.uint8)]),
            (mk("DequantizeLinear", ["x", "s", "z"], ["y"], axis=0),
             [w, ws, np.array([10, 20, 30], np.uint8)]),
            (mk("DequantizeLinear", ["x", "s"], ["y"], axis=0), [w, ws]),
            (mk("DequantizeLinear", ["x", "s"], ["y"], axis=-1),
             [w, np.array([0.1, 0.2, 0.3, 0.4], np.float32)])]


def _gather_nd(rs):
    x = f32(rs, 4, 5, 6)
    node = mk("GatherND", ["x", "i"], ["y"])
    return [(node, [x, np.array([[0, 1], [3, 4], [2, 0]], np.int64)]),
            (node, [x, np.array([[0, 1, 2], [3, 4, 5]], np.int64)]),
            (mk("GatherND", ["x", "i"], ["y"], batch_dims=1),
             [x, np.array([[[1]], [[0]], [[4]], [[2]]], np.int64)])]


def _conv(rs):
    node = lambda **kw: mk("Conv", ["x", "w", "b"], ["y"], **kw)  # noqa
    return [
        (node(kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[2, 2]),
         [f32(rs, 2, 3, 9, 9), f32(rs, 8, 3, 3, 3), f32(rs, 8)]),
        (mk("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3], group=2,
            dilations=[2, 2]), [f32(rs, 1, 4, 10, 10), f32(rs, 8, 2, 3, 3)]),
        (mk("Conv", ["x", "w"], ["y"], kernel_shape=[3], pads=[1, 1]),
         [f32(rs, 2, 3, 12), f32(rs, 5, 3, 3)]),
        (mk("Conv", ["x", "w"], ["y"], kernel_shape=[2, 2, 2]),
         [f32(rs, 1, 2, 5, 5, 5), f32(rs, 4, 2, 2, 2, 2)]),
        (node(kernel_shape=[7, 7], pads=[2, 2, 3, 3], strides=[2, 2]),
         [f32(rs, 1, 3, 16, 16), f32(rs, 4, 3, 7, 7), f32(rs, 4)]),
        (mk("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3],
            auto_pad="SAME_LOWER", strides=[2, 2]),
         [f32(rs, 1, 3, 8, 8), f32(rs, 4, 3, 3, 3)])]


def _conv_transpose(rs):
    x, w = f32(rs, 1, 4, 7, 7), f32(rs, 4, 6, 3, 3)
    xs, ws = f32(rs, 1, 3, 5, 5), f32(rs, 3, 4, 3, 3)
    return [(mk("ConvTranspose", ["x", "w"], ["y"], kernel_shape=[3, 3],
                strides=[2, 2], pads=[1, 1, 1, 1], output_padding=[1, 1]),
             [x, w]),
            (mk("ConvTranspose", ["x", "w"], ["y"], kernel_shape=[3, 3],
                strides=[2, 2], auto_pad="SAME_UPPER"), [xs, ws]),
            (mk("ConvTranspose", ["x", "w"], ["y"], kernel_shape=[3, 3],
                strides=[2, 2], output_shape=[11, 11]), [xs, ws]),
            (mk("ConvTranspose", ["x", "w", "b"], ["y"], kernel_shape=[3, 3],
                group=2), [f32(rs, 1, 4, 5, 5), f32(rs, 4, 3, 3, 3),
                           f32(rs, 6)])]


def _slice(rs):
    x = f32(rs, 2, 6, 4)
    n = mk("Slice", ["x", "st", "en", "ax", "sp"], ["y"])
    v = np.arange(5, dtype=np.float32)
    return [(n, [x, i64(1), i64(5), i64(1), i64(2)]),
            (n, [v, i64(-1), i64(-(1 << 63)), i64(0), i64(-1)]),
            (n, [v, i64(3), i64(-6), i64(0), i64(-1)]),
            (mk("Slice", ["x", "st", "en"], ["y"]),
             [x, i64(0, -3), i64(1, 1 << 40)]),
            (mk("Slice", ["x"], ["y"], starts=[1], ends=[3], axes=[2]),
             [x])]


def _pad(rs):
    x = f32(rs, 3, 5)
    n = mk("Pad", ["x", "p"], ["y"], mode="constant")
    return [(n, [x, i64(0, -1, 0, -2)]), (n, [x, i64(0, 1, 0, 2)]),
            (mk("Pad", ["x", "p", "v"], ["y"]),
             [x, i64(1, 0, 0, 2), np.array(1.5, np.float32)])] + [
        (mk("Pad", ["x", "p"], ["y"], mode=m), [x, i64(1, 2, 2, 1)])
        for m in ("reflect", "edge", "wrap")]


def _cast(rs):
    x = f32(rs, 3, 3, scale=3)
    return [(mk("Cast", ["x"], ["y"], to=t), [x])
            for t in (TensorProto.INT32, TensorProto.INT64,
                      TensorProto.FLOAT16, TensorProto.BOOL,
                      TensorProto.DOUBLE, TensorProto.BFLOAT16)]


def _split(rs):
    x = f32(rs, 2, 6, 4)
    return [(mk("Split", ["x"], ["a", "b", "c"], axis=1, split=[1, 2, 3]),
             [x]),
            (mk("Split", ["x"], ["a", "b", "c"], axis=1), [f32(rs, 1, 7)]),
            (mk("Split", ["x", "s"], ["a", "b"], axis=2),
             [x, i64(1, 3)])]


def _onehot(rs):
    idx = np.array([[0, 2, -1]], np.int64)
    return [(mk("OneHot", ["i", "d", "v"], ["y"], axis=-1),
             [idx, np.array(3, np.int64), np.array([0.5, 2.0], np.float32)]),
            (mk("OneHot", ["i", "d", "v"], ["y"], axis=0),
             [idx, np.array(4, np.int64), np.array([0, 7], np.int32)])]


CASES = {
    "Gemm": lambda rs: [
        (mk("Gemm", ["x", "w", "b"], ["y"], alpha=1.0, beta=1.0, transB=1),
         [f32(rs, 4, 5), f32(rs, 6, 5), f32(rs, 6)]),
        (mk("Gemm", ["x", "w", "b"], ["y"], alpha=0.5, beta=2.0, transA=1),
         [f32(rs, 5, 4), f32(rs, 5, 6), f32(rs, 6)])],
    "MatMul": lambda rs: [
        (mk("MatMul", ["a", "b"], ["y"]), [f32(rs, 3, 2, 5), f32(rs, 5, 4)]),
        (mk("MatMul", ["a", "b"], ["y"]),
         [np.arange(6, dtype=np.int32).reshape(2, 3),
          np.arange(12, dtype=np.int32).reshape(3, 4)])],
    "Conv": _conv,
    "ConvTranspose": _conv_transpose,
    "ConvInteger": _int_conv,
    "MatMulInteger": _int_matmul,
    "QLinearConv": _qlinear_conv,
    "QLinearMatMul": _qlinear_matmul,
    "MaxPool": _pool("MaxPool"),
    "AveragePool": _pool("AveragePool"),
    "GlobalAveragePool": lambda rs: [
        (mk("GlobalAveragePool", ["x"], ["y"]), [f32(rs, 2, 4, 5, 6)])],
    "GlobalMaxPool": lambda rs: [
        (mk("GlobalMaxPool", ["x"], ["y"]), [f32(rs, 2, 4, 5, 6)])],
    "BatchNormalization": lambda rs: [
        (mk("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
            epsilon=1e-5),
         [f32(rs, 3, 5, 4, 4), rs.rand(5).astype(np.float32) + 0.5,
          f32(rs, 5), f32(rs, 5), rs.rand(5).astype(np.float32) + 0.1])],
    "InstanceNormalization": lambda rs: [
        (mk("InstanceNormalization", ["x", "s", "b"], ["y"], epsilon=1e-5),
         [f32(rs, 2, 3, 6, 6), rs.rand(3).astype(np.float32) + 0.5,
          f32(rs, 3)])],
    "LayerNormalization": lambda rs: [
        (mk("LayerNormalization", ["x", "s", "b"], ["y"], axis=-1),
         [f32(rs, 4, 7), rs.rand(7).astype(np.float32), f32(rs, 7)]),
        (mk("LayerNormalization", ["x", "s"], ["y"], axis=1),
         [f32(rs, 2, 3, 4), rs.rand(3, 4).astype(np.float32)])],
    "LRN": lambda rs: [
        (mk("LRN", ["x"], ["y"], size=3, alpha=1e-4, beta=0.75, bias=1.0),
         [f32(rs, 2, 8, 5, 5)]),
        (mk("LRN", ["x"], ["y"], size=4), [f32(rs, 1, 6, 3, 3)])],
    "Softmax": lambda rs: [
        (mk("Softmax", ["x"], ["y"], axis=-1), [f32(rs, 3, 5)]),
        (mk("Softmax", ["x"], ["y"]), [f32(rs, 2, 3, 4)]),
        (mk("Softmax", ["x"], ["y"]), [f32(rs, 2, 3, 4)], {"opset": 11})],
    "LogSoftmax": lambda rs: [
        (mk("LogSoftmax", ["x"], ["y"], axis=1), [f32(rs, 3, 5)]),
        (mk("LogSoftmax", ["x"], ["y"]), [f32(rs, 2, 3, 4)], {"opset": 11})],
    "LeakyRelu": lambda rs: [
        (mk("LeakyRelu", ["x"], ["y"], alpha=0.2), [f32(rs, 4, 4)]),
        (mk("LeakyRelu", ["x"], ["y"]), [f32(rs, 4, 4)])],
    "Elu": lambda rs: [(mk("Elu", ["x"], ["y"], alpha=1.5), [f32(rs, 4, 4)])],
    "Selu": lambda rs: [(mk("Selu", ["x"], ["y"]), [f32(rs, 4, 4)])],
    "Celu": lambda rs: [(mk("Celu", ["x"], ["y"], alpha=0.7),
                         [f32(rs, 3, 4)])],
    "PRelu": lambda rs: [(mk("PRelu", ["x", "s"], ["y"]),
                          [f32(rs, 4, 4), rs.rand(4).astype(np.float32)])],
    "HardSigmoid": lambda rs: [
        (mk("HardSigmoid", ["x"], ["y"], alpha=0.3, beta=0.4),
         [f32(rs, 4, 4, scale=3)])],
    "ThresholdedRelu": lambda rs: [
        (mk("ThresholdedRelu", ["x"], ["y"], alpha=0.5), [f32(rs, 4, 4)])],
    "Gelu": lambda rs: [
        (mk("Gelu", ["x"], ["y"]), [f32(rs, 4, 4)]),
        (mk("Gelu", ["x"], ["y"], approximate="tanh"), [f32(rs, 4, 4)])],
    "Shrink": lambda rs: [
        (mk("Shrink", ["x"], ["y"], lambd=0.5, bias=0.1),
         [np.array([-3.0, -0.2, 0.0, 0.4, 2.0], np.float32)])],
    "Clip": lambda rs: [
        (mk("Clip", ["x"], ["y"], min=-1.0, max=1.0),
         [f32(rs, 5, 5, scale=3)]),
        (mk("Clip", ["x", "lo", "hi"], ["y"]),
         [f32(rs, 5, 5, scale=3), np.float32(-0.5), np.float32(0.5)]),
        (mk("Clip", ["x", "", "hi"], ["y"]),
         [f32(rs, 5, 5, scale=3), None, np.float32(0.5)])],
    "Reshape": lambda rs: [
        (mk("Reshape", ["x", "s"], ["y"]), [f32(rs, 2, 3, 4), i64(2, 12)]),
        (mk("Reshape", ["x", "s"], ["y"]), [f32(rs, 2, 3, 4), i64(0, -1)])],
    "Flatten": lambda rs: [
        (mk("Flatten", ["x"], ["y"], axis=a), [f32(rs, 2, 3, 4)])
        for a in (0, 1, 2, -1)],
    "Transpose": lambda rs: [
        (mk("Transpose", ["x"], ["y"], perm=[2, 0, 1]), [f32(rs, 2, 3, 4)]),
        (mk("Transpose", ["x"], ["y"]), [f32(rs, 2, 3, 4)])],
    "Squeeze": lambda rs: [
        (mk("Squeeze", ["x"], ["y"], axes=[0, 3]), [f32(rs, 1, 2, 3, 1)]),
        (mk("Squeeze", ["x", "a"], ["y"]), [f32(rs, 1, 2, 1), i64(-1)]),
        (mk("Squeeze", ["x"], ["y"]), [f32(rs, 1, 2, 1)])],
    "Unsqueeze": lambda rs: [
        (mk("Unsqueeze", ["x"], ["y"], axes=[0, 3]), [f32(rs, 2, 3, 4)]),
        (mk("Unsqueeze", ["x", "a"], ["y"]), [f32(rs, 5), i64(-1)]),
        (mk("Unsqueeze", ["x"], ["y"], axes=[1, 2]), [f32(rs, 5)])],
    "Concat": lambda rs: [
        (mk("Concat", ["a", "b"], ["y"], axis=1),
         [f32(rs, 2, 3, 4), f32(rs, 2, 1, 4)])],
    "Split": _split,
    "Slice": _slice,
    "Gather": lambda rs: [
        (mk("Gather", ["x", "i"], ["y"], axis=1),
         [f32(rs, 2, 6, 4), i64(2, 0, 1)]),
        (mk("Gather", ["x", "i"], ["y"]),
         [f32(rs, 5, 3), np.array([[0, -1], [2, 4]], np.int64)])],
    "GatherElements": lambda rs: [
        (mk("GatherElements", ["x", "i"], ["y"], axis=1),
         [f32(rs, 3, 4), np.array([[0, 3], [1, -1], [2, 2]], np.int64)])],
    "GatherND": _gather_nd,
    "Expand": lambda rs: [
        (mk("Expand", ["x", "s"], ["y"]), [f32(rs, 1, 3), i64(4, 3)]),
        (mk("Expand", ["x", "s"], ["y"]), [f32(rs, 3, 1), i64(2, 1, 6)])],
    "Tile": lambda rs: [(mk("Tile", ["x", "r"], ["y"]),
                         [f32(rs, 2, 3), i64(2, 1)])],
    "Pad": _pad,
    "Shape": lambda rs: [
        (mk("Shape", ["x"], ["y"]), [f32(rs, 2, 3, 4)]),
        (mk("Shape", ["x"], ["y"], start=1), [f32(rs, 2, 3, 4)]),
        (mk("Shape", ["x"], ["y"], end=-1), [f32(rs, 2, 3, 4)])],
    "ConstantOfShape": lambda rs: [
        (mk("ConstantOfShape", ["s"], ["y"]), [i64(2, 3)]),
        (mk("ConstantOfShape", ["s"], ["y"],
            value=helper.make_tensor("v", np.array([7], np.int32))),
         [i64(2, 2)])],
    "Range": lambda rs: [
        (mk("Range", ["a", "b", "c"], ["y"]),
         [np.int64(0), np.int64(10), np.int64(2)]),
        (mk("Range", ["a", "b", "c"], ["y"]),
         [np.float32(1.0), np.float32(2.0), np.float32(0.25)])],
    "Cast": _cast,
    "Where": lambda rs: [
        (mk("Where", ["c", "a", "b"], ["y"]),
         [f32(rs, 3, 3) > 0, f32(rs, 3, 3), f32(rs, 3)])],
    "Einsum": lambda rs: [
        (mk("Einsum", ["a", "b"], ["y"], equation="ij,jk->ik"),
         [f32(rs, 3, 4), f32(rs, 4, 5)]),
        (mk("Einsum", ["a"], ["y"], equation="bij->bji"),
         [f32(rs, 2, 3, 4)])],
    "TopK": _topk,
    "CumSum": lambda rs: [
        (mk("CumSum", ["x", "ax"], ["y"]), [f32(rs, 2, 6), np.array(1)]),
        (mk("CumSum", ["x", "ax"], ["y"], exclusive=1, reverse=1),
         [f32(rs, 2, 6), np.array(1)]),
        (mk("CumSum", ["x", "ax"], ["y"], exclusive=1),
         [f32(rs, 3, 2), np.array(0)])],
    "ArgMax": _arg("ArgMax"),
    "ArgMin": _arg("ArgMin"),
    "DepthToSpace": lambda rs: [
        (mk("DepthToSpace", ["x"], ["y"], blocksize=2, mode=m),
         [f32(rs, 2, 8, 4, 6)]) for m in ("DCR", "CRD")],
    "SpaceToDepth": lambda rs: [
        (mk("SpaceToDepth", ["x"], ["y"], blocksize=2),
         [f32(rs, 2, 3, 4, 6)])],
    "OneHot": _onehot,
    "Trilu": lambda rs: [
        (mk("Trilu", ["x"], ["y"], upper=0), [f32(rs, 4, 4)]),
        (mk("Trilu", ["x", "k"], ["y"]), [f32(rs, 2, 4, 4), np.array(1)])],
    "ScatterElements": _scatter_elements,
    "Scatter": lambda rs: [
        (mk("Scatter", ["x", "i", "u"], ["y"], axis=0),
         [f32(rs, 3, 3), np.array([[1, 0, 2]], np.int64), f32(rs, 1, 3)])],
    "ScatterND": _scatter_nd,
    "LpNormalization": lambda rs: [
        (mk("LpNormalization", ["x"], ["y"], axis=1, p=p), [f32(rs, 3, 4)])
        for p in (1, 2)],
    "MeanVarianceNormalization": lambda rs: [
        (mk("MeanVarianceNormalization", ["x"], ["y"]),
         [f32(rs, 2, 3, 4, 4)]),
        (mk("MeanVarianceNormalization", ["x"], ["y"], axes=[1]),
         [f32(rs, 2, 3, 4)])],
    "IsNaN": lambda rs: [
        (mk("IsNaN", ["x"], ["y"]),
         [np.array([1.0, np.inf, -np.inf, np.nan], np.float32)])],
    "IsInf": lambda rs: [
        (mk("IsInf", ["x"], ["y"], **kw),
         [np.array([1.0, np.inf, -np.inf, np.nan], np.float32)])
        for kw in ({}, {"detect_negative": 0}, {"detect_positive": 0})],
    "Mod": lambda rs: [
        (mk("Mod", ["a", "b"], ["y"]), [i64(-7, 7, 5), i64(3, -3, 2)]),
        (mk("Mod", ["a", "b"], ["y"], fmod=1),
         [np.array([-7.5, 7.5], np.float32),
          np.array([3.0, -3.0], np.float32)]),
        (mk("Mod", ["a", "b"], ["y"]),
         [np.array([-7.5, 7.5], np.float32),
          np.array([3.0, -3.0], np.float32)])],
    "QuantizeLinear": _quantize,
    "DequantizeLinear": _dequantize,
    "DynamicQuantizeLinear": lambda rs: [
        (mk("DynamicQuantizeLinear", ["x"], ["y", "ys", "yz"]),
         [f32(rs, 4, 6, scale=3)]),
        (mk("DynamicQuantizeLinear", ["x"], ["y", "ys", "yz"]),
         [np.zeros((3, 3), np.float32)])],
    "LSTM": _lstm,
    "GRU": _gru,
    "Resize": _resize,
    "Upsample": lambda rs: [
        (mk("Upsample", ["x", "s"], ["y"], mode="nearest"),
         [f32(rs, 1, 2, 3, 4), np.array([1, 1, 2, 3], np.float32)]),
        (mk("Upsample", ["x"], ["y"], mode="nearest", scales=[1.0, 1.0, 1.5,
                                                               2.0]),
         [f32(rs, 1, 2, 4, 3)])],
    "Dropout": lambda rs: [
        (mk("Dropout", ["x"], ["y"]), [f32(rs, 3, 4)]),
        (mk("Dropout", ["x", "r"], ["y"]),
         [f32(rs, 3, 4), np.array(0.3, np.float32)])],
    "Constant": lambda rs: [
        (mk("Constant", [], ["y"],
            value=helper.make_tensor("v", f32(rs, 2, 3))), []),
        (mk("Constant", [], ["y"], value_floats=[1.0, 2.5]), []),
        (mk("Constant", [], ["y"], value_ints=[3, 4]), []),
        (mk("Constant", [], ["y"], value_float=1.5), [])],
    "Sum": lambda rs: [(mk("Sum", ["a", "b", "c"], ["y"]),
                        [f32(rs, 2, 3), f32(rs, 3), f32(rs, 2, 1)])],
    "Max": lambda rs: [(mk("Max", ["a", "b"], ["y"]),
                        [f32(rs, 2, 3), f32(rs, 3)]),
                       (mk("Max", ["a"], ["y"]), [f32(rs, 2)])],
    "Min": lambda rs: [(mk("Min", ["a", "b", "c"], ["y"]),
                        [f32(rs, 2, 3), f32(rs, 3), f32(rs, 2, 1)])],
    "Mean": lambda rs: [(mk("Mean", ["a", "b"], ["y"]),
                         [f32(rs, 2, 3), f32(rs, 3)])],
    "Pow": lambda rs: [(mk("Pow", ["a", "b"], ["y"]),
                        [np.abs(f32(rs, 2, 3)) + 0.5, f32(rs, 3)]),
                       (mk("Pow", ["a", "b"], ["y"]),
                        [f32(rs, 2, 3), np.array(2, np.int64)])],
    "Not": lambda rs: [(mk("Not", ["x"], ["y"]), [f32(rs, 3, 3) > 0])],
    "Identity": lambda rs: [(mk("Identity", ["x"], ["y"]), [f32(rs, 3)])],
    "Reciprocal": _unary("Reciprocal", 0.5, 3.0),
    "Sqrt": _unary("Sqrt", 0.1, 4.0),
    "Log": _unary("Log", 0.1, 4.0),
    "ReduceLogSum": _reduce("ReduceLogSum", positive=True),
    "Acosh": _unary("Acosh", 1.1, 4.0),
    "Asin": _unary("Asin", -0.9, 0.9),
    "Acos": _unary("Acos", -0.9, 0.9),
    "Atanh": _unary("Atanh", -0.9, 0.9),
}
for _op in ("Relu", "Sigmoid", "Tanh", "Exp", "Neg", "Abs", "Softplus",
            "Softsign", "Erf", "Sign", "Sin", "Cos", "Tan", "Atan", "Sinh",
            "Cosh", "Asinh", "Floor", "Ceil", "Round", "HardSwish", "Mish"):
    CASES[_op] = _unary(_op)
for _op in ("Add", "Sub", "Mul", "Div", "Equal", "Greater",
            "GreaterOrEqual", "Less", "LessOrEqual"):
    CASES[_op] = _binary(_op)
for _op in ("And", "Or"):
    CASES[_op] = (lambda op: lambda rs: [(mk(op, ["a", "b"], ["y"]),
                                          [f32(rs, 3, 4) > 0,
                                           f32(rs, 4) > 0])])(_op)
for _op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
            "ReduceProd", "ReduceL1", "ReduceL2", "ReduceSumSquare",
            "ReduceLogSumExp"):
    CASES[_op] = _reduce(_op)
