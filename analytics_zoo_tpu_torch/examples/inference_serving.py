"""Serving example: a classifier loaded into the concurrent serving
pool behind the HTTP front end and its dynamic batcher, answering
``/predict`` requests from several client threads; at the end the
server's SLO states from ``GET /debug/slo``.

    python -m analytics_zoo_tpu_torch.examples inference_serving
    python -m analytics_zoo_tpu_torch.examples inference_serving --device cpu
"""

from __future__ import annotations

import argparse
import threading

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.examples._serving_common import (
        call, print_slo, slo_baseline)
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer)

    init_nncontext(seed=0, device=args.device)
    net = Sequential()
    net.add(L.Dense(32, input_shape=(8,), activation="relu"))
    net.add(L.Dense(3, activation="softmax"))
    net.compile(optimizer="adam", loss="sparse_categorical_crossentropy")

    model = InferenceModel(supported_concurrent_num=args.concurrency)
    model.load_keras_net(net, example_inputs=[np.zeros((4, 8),
                                                       np.float32)])
    server = InferenceServer(model, port=0, batcher=DynamicBatcher(
        model, max_batch_size=16, max_wait_ms=5)).start()
    slo_baseline(server.port)
    try:
        rng = np.random.RandomState(0)
        xs = [rng.rand(4, 8).astype(np.float32)
              for _ in range(args.requests)]
        results = [None] * args.requests

        def worker(idx):
            for i in idx:
                out = call(server.port, "/predict",
                           {"inputs": xs[i].tolist()})
                results[i] = np.asarray(out["outputs"], np.float32)

        threads = [threading.Thread(
            target=worker, args=(range(k, args.requests,
                                       args.concurrency),))
            for k in range(args.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        shapes = {r.shape for r in results}
        print(f"served {args.requests} requests from "
              f"{args.concurrency} client threads; output shapes: "
              f"{shapes}")
        slo = print_slo(server.port)
    finally:
        server.stop()
    return {"outputs": results, "slo": slo}


if __name__ == "__main__":
    main()
