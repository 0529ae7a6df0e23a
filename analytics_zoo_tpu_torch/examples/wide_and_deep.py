"""Wide&Deep recommendation example: the ml-1m recipe (wide base
occupation and gender, the age×gender cross hash-bucketed to 100,
indicators genres and gender, userId/itemId embeddings, continuous
age) trained with Adam on 5 rating classes, then
``predict_user_item_pair``, ``recommend_for_user`` and
``recommend_for_item``. Synthetic ml-1m-shaped data from
``RandomState(0)``; the embedding ids are ``uid - 1`` and ``iid - 1``,
each within its table.

    python -m analytics_zoo_tpu_torch.examples wide_and_deep
    python -m analytics_zoo_tpu_torch.examples wide_and_deep \\
        --device cpu --samples 512
"""

from __future__ import annotations

import argparse

import numpy as np

BUCKET = 100          # the bucket size of the age-gender cross
N_OCC, N_GENDER, N_GENRES = 21, 3, 19


def synth_ml1m(n, users, items, rng):
    """Synthetic ratings joined with user and item profiles: the rating
    depends on user/item affinity and age, so the model has signal."""
    uid = rng.randint(1, users + 1, n)
    iid = rng.randint(1, items + 1, n)
    gender = rng.randint(1, N_GENDER, n)           # 1..2 like M/F
    age = rng.choice([18, 25, 35, 45, 50, 56], n)
    occupation = rng.randint(0, N_OCC, n)
    genres = rng.randint(0, N_GENRES, n)
    affinity = ((uid * 7 + iid * 3) % 10) / 9.0
    score = 2.5 * affinity + 1.2 * (age / 56.0) + 0.3 * rng.randn(n)
    rating = np.clip(np.round(score + 1.5), 1, 5).astype(np.int64)
    return dict(uid=uid, iid=iid, gender=gender, age=age,
                occupation=occupation, genres=genres, rating=rating)


def column_info(users, items):
    """The ml-1m column layout (the reference's ``localColumnInfo``)."""
    from analytics_zoo_tpu_torch.models.recommendation import \
        ColumnFeatureInfo
    return ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"],
        wide_base_dims=[N_OCC, N_GENDER],
        wide_cross_cols=["age-gender"],
        wide_cross_dims=[BUCKET],
        indicator_cols=["genres", "gender"],
        indicator_dims=[N_GENRES, N_GENDER],
        embed_cols=["userId", "itemId"],
        embed_in_dims=[users, items],
        embed_out_dims=[64, 64],
        continuous_cols=["age"])


def assembly_feature(d, info):
    """The multi-hot wide vector and the [indicators | embedding ids |
    continuous] deep vector of each sample."""
    n = len(d["uid"])
    x_wide = np.zeros((n, info.wide_dim), np.float32)
    x_wide[np.arange(n), d["occupation"]] = 1.0          # base 0..20
    x_wide[np.arange(n), N_OCC + d["gender"]] = 1.0      # base gender
    cross = (d["age"] * 3 + d["gender"]) % BUCKET        # hash cross
    x_wide[np.arange(n), N_OCC + N_GENDER + cross] = 1.0

    ind_genres = np.eye(N_GENRES, dtype=np.float32)[d["genres"]]
    ind_gender = np.eye(N_GENDER, dtype=np.float32)[d["gender"]]
    x_deep = np.concatenate([
        ind_genres, ind_gender,
        (d["uid"] - 1)[:, None].astype(np.float32),
        (d["iid"] - 1)[:, None].astype(np.float32),
        (d["age"][:, None] / 56.0).astype(np.float32),
    ], axis=1)
    return x_wide, x_deep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-type", default="wide_n_deep",
                   choices=["wide", "deep", "wide_n_deep"])
    p.add_argument("--users", type=int, default=200)
    p.add_argument("--items", type=int, default=100)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.recommendation import (
        UserItemFeature, WideAndDeep)
    from analytics_zoo_tpu_torch.ops.optimizers import Adam

    init_nncontext(seed=0, device=args.device)
    rng = np.random.RandomState(0)
    d = synth_ml1m(args.samples, args.users, args.items, rng)
    info = column_info(args.users, args.items)

    wnd = WideAndDeep(args.model_type, num_classes=5, column_info=info)
    # class_nll pairs with the log-softmax head (LogSoftMax +
    # ClassNLLCriterion + Adam(1e-2))
    wnd.compile(optimizer=Adam(lr=1e-2), loss="class_nll",
                metrics=["accuracy"])

    x_wide, x_deep = assembly_feature(d, info)
    y = (d["rating"] - 1).reshape(-1, 1).astype(np.int32)
    x = {"wide": x_wide, "deep": x_deep,
         "wide_n_deep": [x_wide, x_deep]}[args.model_type]
    n_train = int(0.8 * args.samples)
    result = wnd.fit(x[:n_train] if isinstance(x, np.ndarray)
                     else [a[:n_train] for a in x],
                     y[:n_train], batch_size=args.batch_size,
                     nb_epoch=args.epochs)
    for h in result.history:
        print(f"epoch {h['epoch']}: loss {h['loss']:.4f}")

    x_val = (x[n_train:] if isinstance(x, np.ndarray)
             else [a[n_train:] for a in x])
    logp = wnd.predict(x_val, batch_size=args.batch_size)
    acc = float((np.argmax(logp, -1) == y[n_train:, 0]).mean())
    print(f"validation accuracy: {acc:.3f} "
          f"({args.samples - n_train} samples)")

    def row(i):
        if isinstance(x, np.ndarray):
            return x[n_train + i]
        return [a[n_train + i] for a in x]
    pairs = [UserItemFeature(user_id=int(d["uid"][n_train + i]),
                             item_id=int(d["iid"][n_train + i]),
                             feature=row(i))
             for i in range(min(200, args.samples - n_train))]
    print("predict_user_item_pair:")
    for pred in wnd.predict_user_item_pair(pairs)[:5]:
        print(f"  user {pred.user_id} item {pred.item_id}: rating "
              f"{pred.prediction + 1} (p={pred.probability:.3f})")
    print("recommend_for_user (top-3):")
    for pred in wnd.recommend_for_user(pairs, max_items=3)[:6]:
        print(f"  user {pred.user_id}: item {pred.item_id} "
              f"({pred.prediction + 1}, p={pred.probability:.3f})")
    print("recommend_for_item (top-3):")
    for pred in wnd.recommend_for_item(pairs, max_users=3)[:6]:
        print(f"  item {pred.item_id}: user {pred.user_id} "
              f"({pred.prediction + 1}, p={pred.probability:.3f})")
    return {"accuracy": acc, "loss": result.history[-1]["loss"]}


if __name__ == "__main__":
    main()
