"""ONNX import example (the reference's ``examples/onnx_import.py``):
write an MLP as an ONNX file with the framework's own proto builder (a
stand-in for a file exported elsewhere), load it with ``OnnxLoader``,
predict and fine-tune it.

    python -m analytics_zoo_tpu_torch.examples onnx_import
    python -m analytics_zoo_tpu_torch.examples onnx_import --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", default=os.path.join(tempfile.gettempdir(),
                                                  "example_mlp.onnx"))
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api.onnx import (
        OnnxLoader, helper, onnx_pb)
    from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import \
        TensorProto

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)

    # an MLP .onnx file (any exporter's file loads the same way)
    w1 = (rng.randn(32, 8) * 0.3).astype(np.float32)
    b1 = np.zeros(32, np.float32)
    w2 = (rng.randn(4, 32) * 0.3).astype(np.float32)
    nodes = [
        helper.make_node("Gemm", ["x", "w1", "b1"], ["h"], transB=1),
        helper.make_node("Relu", ["h"], ["hr"]),
        helper.make_node("Gemm", ["hr", "w2"], ["out"], transB=1),
    ]
    graph = helper.make_graph(
        nodes, "mlp",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, ["N", 8])],
        [helper.make_tensor_value_info("out", TensorProto.FLOAT, ["N", 4])],
        [helper.make_tensor("w1", w1), helper.make_tensor("b1", b1),
         helper.make_tensor("w2", w2)])
    onnx_pb.save_model(helper.make_model(graph), args.path)
    print(f"wrote {args.path}")

    net = OnnxLoader.load_model(args.path)
    net.compile(optimizer="adam", loss="mse")
    x = rng.randn(128, 8).astype(np.float32)
    y = rng.randn(128, 4).astype(np.float32)
    before = float(np.mean((net.predict(x, batch_size=64) - y) ** 2))
    print("imported forward:", net.predict(x, batch_size=64).shape)
    net.fit(x, y, batch_size=64, nb_epoch=args.epochs)
    after = float(np.mean((net.predict(x, batch_size=64) - y) ** 2))
    print(f"fine-tuned the imported ONNX model on {net.device}: mse "
          f"{before:.4f} -> {after:.4f}")
    return {"mse_before": before, "mse_after": after}


if __name__ == "__main__":
    main()
