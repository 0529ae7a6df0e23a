"""Neural Collaborative Filtering example: build NeuralCF, train it on
(user, item) → rating pairs, then ``recommend_for_user``. Synthetic
ml-1m-shaped data.

Ids are 0-based, ``randint(0, users)``, so every id has a row of the
users × embed table. The JAX package's example draws ids ``1..users``
against tables of ``users`` rows: the largest id is one past the
table, its lookup is a row of NaN (``jnp.take``'s fill), and that
example trains to a NaN loss. This one departs from it there.

    python -m analytics_zoo_tpu_torch.examples ncf_recommendation
    python -m analytics_zoo_tpu_torch.examples ncf_recommendation \\
        --device cpu --samples 512
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--users", type=int, default=200)
    p.add_argument("--items", type=int, default=100)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.recommendation import (
        NeuralCF, UserItemFeature)

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    users = rng.randint(0, args.users, args.samples)
    items = rng.randint(0, args.items, args.samples)
    # implicit 5-class ratings correlated with user/item parity
    ratings = ((users + items) % 5 + 1).astype(np.int32)

    ncf = NeuralCF(user_count=args.users, item_count=args.items,
                   num_classes=5, user_embed=16, item_embed=16,
                   hidden_layers=(32, 16, 8), mf_embed=16)
    # class_nll pairs with NeuralCF's log-softmax head (LogSoftMax +
    # ClassNLLCriterion)
    ncf.compile(optimizer="adam", loss="class_nll", metrics=["accuracy"])
    x = np.stack([users, items], axis=1).astype(np.int32)
    y = (ratings - 1).reshape(-1, 1)
    result = ncf.fit(x, y, batch_size=args.batch_size, nb_epoch=args.epochs)
    for h in result.history:
        print(f"epoch {h['epoch']}: loss {h['loss']:.4f}")

    pairs = [UserItemFeature(user_id=int(u), item_id=int(i),
                             feature=np.array([u, i], np.int32))
             for u, i in zip(users[:50], items[:50])]
    recs = ncf.recommend_for_user(pairs, max_items=3)
    for r in recs[:5]:
        print(f"user {r.user_id}: item {r.item_id} rated "
              f"{r.prediction + 1} (p={r.probability:.3f})")
    return {"loss": result.history[-1]["loss"], "recommendations": recs}


if __name__ == "__main__":
    main()
