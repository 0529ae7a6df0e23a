"""Transformer sentiment example (the reference's
``P/examples/attention/transformer.py``): IMDB sequences padded to a
fixed length, classified by TransformerLayer, GlobalAveragePooling1D,
Dropout and Dense(2, softmax).

Uses ``keras.datasets.imdb`` (the real cache file when present, a
synthetic stand-in offline). The defaults are small; ``--hidden-size
128 --n-head 8 --max-len 200`` is the reference's configuration.

    python -m analytics_zoo_tpu_torch.examples transformer_sentiment
    python -m analytics_zoo_tpu_torch.examples transformer_sentiment \\
        --device cpu --max-len 16 --n-train 64
"""

from __future__ import annotations

import argparse

import numpy as np


def pad_sequences(seqs, maxlen):
    out = np.zeros((len(seqs), maxlen), np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[-maxlen:]            # keras 'pre' truncation
        out[i, maxlen - len(s):] = s     # keras 'pre' padding
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max-features", type=int, default=2000)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--n-head", type=int, default=4)
    p.add_argument("--n-block", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.datasets import imdb
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    init_nncontext(device=args.device)
    (x_train, y_train), _ = imdb.load_data(nb_words=args.max_features)
    x = pad_sequences(x_train[:args.n_train], args.max_len)
    y = np.asarray(y_train[:args.n_train], np.int32).reshape(-1, 1)

    model = Sequential()
    model.add(L.TransformerLayer(
        n_block=args.n_block, hidden_size=args.hidden_size,
        n_head=args.n_head, seq_len=args.max_len,
        vocab=args.max_features, bidirectional=True,
        input_shape=(args.max_len,)))
    model.add(L.GlobalAveragePooling1D())
    model.add(L.Dropout(0.2))
    model.add(L.Dense(2, activation="softmax"))
    model.compile(optimizer=Adam(lr=1e-3),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=args.batch_size, nb_epoch=args.epochs)
    metrics = model.evaluate(x, y, batch_size=args.batch_size)
    print("transformer_sentiment:", metrics)
    return metrics


if __name__ == "__main__":
    main()
