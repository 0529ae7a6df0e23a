"""Model import on the card: every ONNX op of the reference's registry
on the card against the CPU port on the same inputs (the cases of
``onnx_op_cases.py``: integer and boolean outputs equal, f32 within
1e-5 with TF32 off), an imported ONNX graph served and trained on the
card against the CPU, and a torch net imported onto the card against
the module.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none. The file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest tests/test_torch_import_cuda.py -q
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.pipeline.api.onnx import onnx_loader as tol
from onnx_op_cases import CASES, f32, mk

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tzoo.init_nncontext(seed=0)
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _same(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=TOL,
                                   atol=TOL, err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(cuda, op):
    rs = np.random.RandomState(sum(map(ord, op)))
    for k, case in enumerate(CASES[op](rs)):
        node, inputs = case[0], case[1]
        kw = case[2] if len(case) > 2 else {}
        got = tol.run_node(node, inputs, device="cuda", **kw)
        want = tol.run_node(node, inputs, device="cpu", **kw)
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{op} case {k} output {j}")


@pytest.mark.cuda
def test_imported_conv_graph_serves_and_trains_on_the_card(cuda, tmp_path):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.onnx import (OnnxLoader,
                                                           helper, onnx_pb)
    from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import \
        TensorProto
    rs = np.random.RandomState(0)
    nodes = [mk("Conv", ["x", "cw", "cb"], ["c"], kernel_shape=[3, 3],
                pads=[0, 0, 1, 1], strides=[2, 2]),
             mk("BatchNormalization", ["c", "g", "b", "m", "v"], ["n"]),
             mk("Relu", ["n"], ["r"]),
             mk("Shape", ["r"], ["s"]),
             mk("Gather", ["s", "zero"], ["bsz"], axis=0),
             mk("Unsqueeze", ["bsz"], ["b1"], axes=[0]),
             mk("Concat", ["b1", "minus1"], ["shp"], axis=0),
             mk("Reshape", ["r", "shp"], ["f"]),
             mk("Gemm", ["f", "fw", "fb"], ["y"], transB=1)]
    inits = {"cw": f32(rs, 8, 3, 3, 3, scale=0.3), "cb": f32(rs, 8),
             "g": rs.rand(8).astype(np.float32) + 0.5, "b": f32(rs, 8),
             "m": f32(rs, 8), "v": rs.rand(8).astype(np.float32) + 0.5,
             "fw": f32(rs, 5, 8 * 4 * 4, scale=0.1), "fb": f32(rs, 5),
             "zero": np.array(0, np.int64),
             "minus1": np.array([-1], np.int64)}
    graph = helper.make_graph(
        nodes, "g",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       ["N", 3, 8, 8])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, ["N", 5])],
        [helper.make_tensor(k, v) for k, v in inits.items()])
    path = str(tmp_path / "g.onnx")
    onnx_pb.save_model(helper.make_model(graph), path)
    x = rs.randn(16, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (16,)).astype(np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        tzoo.init_nncontext(seed=0, device=device)
        net = OnnxLoader.load_model(path)
        net.compile(optimizer=SGD(lr=0.05, momentum=0.9),
                    loss="sparse_categorical_crossentropy")
        pred = net.predict(x, batch_size=8)
        net.fit(x, y, batch_size=8, nb_epoch=1)
        # (each load names its graph layer anew: read it by the net's)
        out[device] = (net.device, pred,
                       params_to_numpy(net)[net.layers[0].name]["w"])
    assert out["cuda"][0].type == "cuda"
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=TOL,
                               atol=TOL)
    for k, v in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_torch_import_on_the_card(cuda):
    import torch.nn as nn

    from analytics_zoo_tpu_torch import Net
    torch.manual_seed(0)
    tm = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8),
                       nn.ReLU(), nn.MaxPool2d(3, 2, padding=1,
                                               ceil_mode=True),
                       nn.Flatten(), nn.Linear(8 * 6 * 6, 4)).eval()
    x = np.random.RandomState(1).randn(6, 3, 10, 10).astype(np.float32)
    got = Net.load_torch(tm, (3, 10, 10)).predict(x)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
