"""Recommendation app with NeuralCF (the reference's
``apps/recommendation-ncf``): ml-1m ratings (or a synthetic set with
latent structure), NeuralCF trained with Adam and ``class_nll``, its test
metrics, then ``recommend_for_user`` and ``recommend_for_item``.

Ids are 0-based (the ratings file's ids minus one), so every id has a
row of its embedding table.

    python -m analytics_zoo_tpu_torch.apps recommendation_ncf
    python -m analytics_zoo_tpu_torch.apps recommendation_ncf --device cpu \\
        --users 50 --items 40 --samples 2000 --epochs 1
    python -m analytics_zoo_tpu_torch.apps recommendation_ncf \\
        --ratings ml-1m/ratings.dat
"""

from __future__ import annotations

import argparse

import numpy as np


def load_ratings(path: "str | None", n_users: int, n_items: int,
                 n_samples: int, rng):
    """``(user, item, rating 1..5)`` int arrays: an ml-1m
    ``ratings.dat`` (``user::item::rating::ts``), or a synthetic set
    with a learnable latent affinity."""
    if path:
        from analytics_zoo_tpu_torch.common.utils import read_bytes
        rows = []
        for line in read_bytes(path).decode().splitlines():
            parts = line.strip().split("::")
            if len(parts) >= 3:
                rows.append((int(parts[0]) - 1, int(parts[1]) - 1,
                             int(parts[2])))
        if not rows:
            raise ValueError(
                f"no ratings parsed from {path} (expected ml-1m "
                f"'user::item::rating::ts' lines)")
        arr = np.asarray(rows, np.int64)
        return arr[:, 0], arr[:, 1], arr[:, 2].astype(np.int32)
    users = rng.randint(0, n_users, n_samples)
    items = rng.randint(0, n_items, n_samples)
    u_lat = rng.randn(n_users, 4)
    i_lat = rng.randn(n_items, 4)
    affinity = np.sum(u_lat[users] * i_lat[items], axis=1)
    rating = np.clip(np.round(3 + affinity), 1, 5).astype(np.int32)
    return users, items, rating


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ratings", default=None,
                   help="ml-1m ratings.dat (user::item::rating::ts); "
                        "omit for synthetic data")
    p.add_argument("--users", type=int, default=600)
    p.add_argument("--items", type=int, default=370)
    p.add_argument("--samples", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.recommendation import (
        NeuralCF, UserItemFeature)

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    users, items, rating = load_ratings(args.ratings, args.users,
                                        args.items, args.samples, rng)
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1

    x = np.stack([users, items], axis=1).astype(np.int32)
    y = (rating - 1).reshape(-1, 1)          # classes 0..4
    idx = rng.permutation(len(x))
    split = int(len(x) * 0.9)
    tr, te = idx[:split], idx[split:]

    ncf = NeuralCF(user_count=n_users, item_count=n_items, num_classes=5,
                   user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20)
    # class_nll pairs with NeuralCF's log-softmax head (LogSoftMax +
    # ClassNLLCriterion); a probability-space loss would train nothing
    ncf.compile(optimizer="adam", loss="class_nll", metrics=["accuracy"])
    ncf.fit(x[tr], y[tr], batch_size=args.batch_size, nb_epoch=args.epochs)
    metrics = ncf.evaluate(x[te], y[te], batch_size=args.batch_size)
    print("test:", {k: round(float(v), 4) for k, v in metrics.items()})

    pairs = [UserItemFeature(user_id=int(u), item_id=int(i),
                             feature=np.array([u, i], np.int32))
             for u, i in zip(users[te][:200], items[te][:200])]
    by_user = ncf.recommend_for_user(pairs, max_items=3)
    for r in by_user[:5]:
        print(f"user {r.user_id}: item {r.item_id} rated "
              f"{r.prediction + 1} (p={r.probability:.3f})")
    by_item = ncf.recommend_for_item(pairs, max_users=3)
    for r in by_item[:5]:
        print(f"item {r.item_id}: user {r.user_id} rated "
              f"{r.prediction + 1} (p={r.probability:.3f})")
    return dict(metrics, recommend_for_user=by_user,
                recommend_for_item=by_item)


if __name__ == "__main__":
    main()
