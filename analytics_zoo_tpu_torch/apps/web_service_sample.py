"""Web-service app (the reference's ``apps/web-service-sample``): a small
classifier behind the HTTP front end, its ``/health`` read, then
concurrent clients posting ``/predict`` and checking every answer.

An ``InferenceModel`` with a pool of ``--concurrency`` slots serves a
Dense 8→32→3 softmax net; ``--requests`` client threads each post two
rows and expect two rows of probabilities summing to one.

    python -m analytics_zoo_tpu_torch.apps web_service_sample
    python -m analytics_zoo_tpu_torch.apps web_service_sample --device cpu \\
        --requests 4 --concurrency 2
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.request

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
        Sequential
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.pipeline.inference.serving import \
        make_inference_server

    init_nncontext(device=args.device)
    net = Sequential()
    net.add(L.Dense(32, input_shape=(8,), activation="relu"))
    net.add(L.Dense(3, activation="softmax"))
    net.compile(optimizer="adam", loss="sparse_categorical_crossentropy")

    model = InferenceModel(supported_concurrent_num=args.concurrency)
    model.load_keras_net(net)
    server = make_inference_server(model)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    print(f"serving on {base} via {type(server).__name__}")
    errors: "list[str]" = []
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            health = json.loads(r.read())
        print("health:", health)

        # payloads made up front: RandomState is not thread-safe
        rng = np.random.RandomState(0)
        payloads = [rng.rand(2, 8).astype(np.float32).tolist()
                    for _ in range(args.requests)]

        def client(i: int):
            req = urllib.request.Request(
                f"{base}/predict",
                data=json.dumps({"inputs": payloads[i]}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    rows = np.asarray(json.loads(r.read())["outputs"],
                                      np.float32)
                if rows.shape != (2, 3) or not np.allclose(
                        rows.sum(-1), 1.0, atol=1e-3):
                    errors.append(f"request {i}: bad payload {rows!r}")
            except Exception as e:
                errors.append(f"request {i}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    if errors:
        raise SystemExit("FAILED:\n" + "\n".join(errors[:5]))
    print(f"{args.requests} concurrent requests served OK "
          f"({args.concurrency}-way pool)")
    return {"requests": args.requests, "errors": 0, "health": health}


if __name__ == "__main__":
    main()
