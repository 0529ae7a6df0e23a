"""Anomaly detection example: unroll a univariate time series into
windows, train the stacked-LSTM AnomalyDetector to predict the next
value, and flag the test points with the largest prediction errors. A
synthetic series shaped like NYC taxi demand (a daily cycle, noise and
injected spikes) stands in for the data.

    python -m analytics_zoo_tpu_torch.examples anomaly_detection
    python -m analytics_zoo_tpu_torch.examples anomaly_detection \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--points", type=int, default=600)
    p.add_argument("--unroll", type=int, default=24)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--anomalies", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.anomalydetection import \
        AnomalyDetector

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    t = np.arange(args.points)
    series = (np.sin(t / 24 * 2 * np.pi) +
              0.1 * rng.randn(args.points)).astype(np.float32)
    spikes = rng.choice(args.points, args.anomalies, replace=False)
    series[spikes] += 3.0  # injected anomalies

    indexed = AnomalyDetector.unroll(series[:, None], args.unroll)
    x, y = AnomalyDetector.to_arrays(indexed)
    split = int(len(x) * 0.8)
    x_train, y_train = x[:split], y[:split]
    x_test, y_test = x[split:], y[split:]

    ad = AnomalyDetector(feature_shape=(args.unroll, 1),
                         hidden_layers=(16, 8, 4),
                         dropouts=(0.1, 0.1, 0.1))
    ad.compile(optimizer="adam", loss="mse")
    hist = ad.fit(x_train, y_train, batch_size=args.batch_size,
                  nb_epoch=args.epochs).history
    y_pred = ad.predict(x_test, batch_size=args.batch_size).reshape(-1)
    flagged, threshold = AnomalyDetector.detect_anomalies(
        y_test.reshape(-1), y_pred, anomaly_size=args.anomalies)
    print(f"flagged {len(flagged)} anomalies (threshold "
          f"{threshold:.3f}) at test indices {flagged.tolist()}")
    return {"loss": hist[-1]["loss"], "threshold": float(threshold),
            "flagged": flagged}


if __name__ == "__main__":
    main()
