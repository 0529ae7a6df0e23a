"""INT8 quantized serving example: trains a small classifier, serves it
in f32 and in int8 behind the HTTP front end, and reports the two
servers' agreement, the kernels' size reduction and, at the end, the
int8 server's SLO states from ``GET /debug/slo``.

    python -m analytics_zoo_tpu_torch.examples quantized_serving
    python -m analytics_zoo_tpu_torch.examples quantized_serving --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.examples._serving_common import (
        call, print_slo, slo_baseline)
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.inference import (
        InferenceModel, InferenceServer)

    init_nncontext(seed=0, device=args.device)
    rs = np.random.RandomState(0)
    x = rs.randn(args.n, args.dim).astype(np.float32)
    w = rs.randn(args.dim, args.classes).astype(np.float32)
    y = np.argmax(x @ w, -1).astype(np.int32).reshape(-1, 1)

    model = Sequential()
    model.add(L.Dense(64, activation="relu", input_shape=(args.dim,)))
    model.add(L.Dense(args.classes))
    model.compile(optimizer="adam", loss="softmax_cross_entropy")
    model.fit(x, y, batch_size=64, nb_epoch=args.epochs)

    im_f32 = InferenceModel().load_keras_net(model, example_inputs=[x])
    im_int8 = InferenceModel().load_keras_net(model, example_inputs=[x],
                                              quantize=True)
    servers = [InferenceServer(im, port=0, batcher=None).start()
               for im in (im_f32, im_int8)]
    slo_baseline(servers[1].port)
    try:
        preds, times = [], []
        for srv in servers:
            t0 = time.perf_counter()
            out = call(srv.port, "/predict", {"inputs": x.tolist()})
            times.append(time.perf_counter() - t0)
            preds.append(np.argmax(np.asarray(out["outputs"]), -1))
        agree = float(np.mean(preds[0] == preds[1]))
        f_bytes, q_bytes = im_int8.quantized.size_bytes()
        result = {"agreement": agree,
                  "kernel_bytes_f32": f_bytes,
                  "kernel_bytes_int8": q_bytes,
                  "t_f32_s": round(times[0], 4),
                  "t_int8_s": round(times[1], 4)}
        print("int8 serving:", result)
        result["slo"] = print_slo(servers[1].port)
    finally:
        for srv in servers:
            srv.stop()
    return result


if __name__ == "__main__":
    main()
