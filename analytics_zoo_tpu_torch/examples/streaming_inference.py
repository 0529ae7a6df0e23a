"""Streaming micro-batch inference: a producer thread feeds a bounded
queue (the stream source), a consumer drains it into micro-batches on a
time or size trigger, and each micro-batch is scored by a
TextClassifier behind the HTTP front end. Prints each batch's latency,
a throughput summary and, at the end, the server's SLO states from
``GET /debug/slo``.

The demo streams synthetic pre-embedded text; swap the producer for a
socket or Kafka reader for real streams.

    python -m analytics_zoo_tpu_torch.examples streaming_inference
    python -m analytics_zoo_tpu_torch.examples streaming_inference --device cpu
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--records", type=int, default=96,
                   help="total records the producer emits")
    p.add_argument("--rate", type=float, default=400.0,
                   help="producer records/sec")
    p.add_argument("--batch-max", type=int, default=16)
    p.add_argument("--batch-interval-ms", type=int, default=100,
                   help="micro-batch trigger (the stream's batch "
                        "duration)")
    p.add_argument("--concurrency", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.examples._serving_common import (
        call, print_slo, slo_baseline)
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.pipeline.inference import (
        InferenceModel, InferenceServer)

    init_nncontext(seed=0, device=args.device)
    seq_len, token_len, classes = 32, 16, 3

    # random weights: the pipeline is the demo; records arrive
    # pre-embedded, (T, token_len) each
    tc = TextClassifier(class_num=classes, token_length=token_len,
                        sequence_length=seq_len, encoder="cnn")
    tc.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    im = InferenceModel(supported_concurrent_num=args.concurrency)
    im.load_keras_net(tc.model)
    server = InferenceServer(im, port=0, batcher=None).start()

    slo_baseline(server.port)
    q: "queue.Queue" = queue.Queue(maxsize=args.batch_max * 4)
    rs = np.random.RandomState(0)
    records = rs.randn(args.records, seq_len, token_len).astype(np.float32)

    def produce():
        for rec in records:
            q.put(rec)
            time.sleep(1.0 / args.rate)
        q.put(None)  # end of stream

    threading.Thread(target=produce, daemon=True).start()

    interval = args.batch_interval_ms / 1000.0
    done, n_scored, n_batches = False, 0, 0
    lat_ms = []
    t_start = time.time()
    try:
        while not done:
            batch, deadline = [], time.time() + interval
            while len(batch) < args.batch_max:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    item = q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    done = True
                    break
                batch.append(item)
            if not batch:
                continue
            t0 = time.time()
            x = np.zeros((args.batch_max, seq_len, token_len), np.float32)
            x[: len(batch)] = np.stack(batch)  # one shape for every batch
            out = call(server.port, "/predict", {"inputs": x.tolist()})
            preds = np.asarray(out["outputs"])[: len(batch)].argmax(-1)
            dt = (time.time() - t0) * 1000
            lat_ms.append(dt)
            n_scored += len(batch)
            n_batches += 1
            print(f"batch {n_batches}: {len(batch)} records "
                  f"classes={np.bincount(preds, minlength=classes)} "
                  f"latency={dt:.1f}ms")
        wall = time.time() - t_start
        print(f"stream done: {n_scored} records in {n_batches} "
              f"micro-batches, {n_scored / wall:.0f} rec/s end-to-end, "
              f"median batch latency {np.median(lat_ms):.1f}ms")
        slo = print_slo(server.port)
    finally:
        server.stop()
    return {"records": n_scored, "batches": n_batches, "slo": slo}


if __name__ == "__main__":
    main()
