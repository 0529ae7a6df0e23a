"""BERT fine-tuning on the card: the zoo's BERT encoder with a classifier
on its pooled output, trained by the Estimator with Adam on a warmup
schedule (BASELINE's fifth configuration, "distributed BERT-base
fine-tune", on one card).

The reference fine-tunes BERT through TFOptimizer on BigDL's
data-parallel loop; the port trains the native ``BERT`` layer
(``layers/transformer.py``) with ``remat=True``, attention routed by the
reference's crossover (dense below 1024 keys). Synthetic sentence-pair
data stands in for GLUE; real token ids drop in unchanged.
``--devices`` other than 0 or 1 waits for data parallelism (ROADMAP
A14). ``--hidden 768 --blocks 12`` is BERT-base.

    python -m analytics_zoo_tpu_torch.examples bert_finetune
    python -m analytics_zoo_tpu_torch.examples bert_finetune --device cpu \\
        --seq-len 32 --hidden 32 --blocks 1 --batch-per-device 2
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=0,
                   help="cards to train on: 0 or 1 (one card)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--hidden", type=int, default=128,
                   help="128 keeps the demo fast; BERT-base is 768")
    p.add_argument("--blocks", type=int, default=2,
                   help="2 keeps the demo fast; BERT-base is 12")
    p.add_argument("--batch-per-device", type=int, default=4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--freeze-encoder", action="store_true",
                   help="train only the classifier head (feature-"
                        "extraction fine-tune)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)
    if args.devices not in (0, 1):
        raise ValueError(
            f"--devices {args.devices}: the port trains on one card until "
            "its data parallelism (ROADMAP A14); pass 0 or 1")

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops.optimizers import Adam, warmup
    from analytics_zoo_tpu_torch.pipeline.api.autograd import Lambda
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

    ctx = init_nncontext(seed=0, device=args.device)
    t, h = args.seq_len, args.hidden
    batch = args.batch_per_device
    n_cls, vocab = 2, 1000

    # -- model: BERT encoder + pooled-output classifier head ----------
    bert = L.BERT(vocab=vocab, hidden_size=h, n_block=args.blocks,
                  n_head=max(2, h // 64), seq_len=t,
                  intermediate_size=4 * h, output_all_block=False,
                  remat=True, name="bert", input_shape=[(t,)] * 4)
    if args.freeze_encoder:
        bert.trainable = False
    model = Sequential()
    model.add(bert)
    # BERT outputs [sequence_output, pooled_output]; classify on pooled
    model.add(Lambda(lambda outs: outs[1], name="take_pooled",
                     output_shape=(h,)))
    model.add(L.Dropout(0.1))
    model.add(L.Dense(n_cls, activation="softmax", name="classifier"))

    # -- synthetic sentence-pair batch (GLUE-shaped) -------------------
    rs = np.random.RandomState(0)
    n_samples = batch * 8
    tok = rs.randint(1, vocab, size=(n_samples, t)).astype(np.int32)
    seg = (np.arange(t)[None, :] >= t // 2).astype(np.int32) \
        * np.ones((n_samples, 1), np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (n_samples, 1))
    mask = np.ones((n_samples, t), np.float32)
    # separable labels: whether the first segment's mean token id is
    # above the vocabulary's midpoint (learnable from embeddings alone)
    y = (tok[:, : t // 2].mean(axis=1) > vocab / 2).astype(
        np.int32)[:, None]

    est = Estimator(
        model,
        optimizer=Adam(lr=warmup(5e-5, 8, delta=(5e-4 - 5e-5) / 8)),
        loss="sparse_categorical_crossentropy",
        metrics=["accuracy"], ctx=ctx)
    res = est.train([tok, seg, pos, mask], y, batch_size=batch,
                    nb_epoch=args.epochs)
    scores = est.evaluate([tok, seg, pos, mask], y, batch_size=batch)
    print(f"device={ctx.device} seq_len={t} blocks={args.blocks} "
          f"frozen={args.freeze_encoder}")
    print(f"final train loss={res.history[-1]['loss']:.4f} "
          f"eval={scores}")
    return scores


if __name__ == "__main__":
    main()
