"""QA ranking example: question and answer corpora through the TextSet
pipeline (tokenize, normalize, word2idx, shape_sequence), relations
made into alternating positive and negative training pairs, KNRM
trained with ``rank_hinge``, and NDCG@3, NDCG@5 and MAP on the
validation relation lists.

It runs on a small synthetic QA corpus unless ``--data-path`` holds
``question_corpus.csv``, ``answer_corpus.csv``, ``relation_train.csv``
and ``relation_valid.csv`` (the WikiQA layout of the JAX package's
example). The ids ride the input as float32, as there; keep the
default float32 policy (under ``mixed_bfloat16`` float ids above 256
round to bf16).

    python -m analytics_zoo_tpu_torch.examples qa_ranker
    python -m analytics_zoo_tpu_torch.examples qa_ranker --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def synthetic_corpus(data_dir):
    """WikiQA-shaped toy data in ``data_dir``: each question has one
    on-topic answer (a shared keyword) and one off-topic distractor."""
    topics = ["rain", "sun", "moon", "wind", "snow", "fire", "tree",
              "fish"]
    qs, ans, rel_train, rel_valid = [], [], [], []
    for i, t in enumerate(topics):
        qs.append((f"q{i}", f"what causes {t} to appear"))
        ans.append((f"a{i}p", f"the {t} appears because of {t} physics"))
        ans.append((f"a{i}n", "unrelated text about something else"))
        dst = rel_train if i < 6 else rel_valid
        dst.append((f"q{i}", f"a{i}p", 1))
        dst.append((f"q{i}", f"a{i}n", 0))

    def write(name, rows, header):
        with open(os.path.join(data_dir, name), "w", encoding="utf-8") as f:
            f.write(header + "\n")
            for r in rows:
                f.write(",".join(str(c) for c in r) + "\n")

    write("question_corpus.csv", qs, "id,text")
    write("answer_corpus.csv", ans, "id,text")
    write("relation_train.csv", rel_train, "id1,id2,label")
    write("relation_valid.csv", rel_valid, "id1,id2,label")


def run(args, data):
    from analytics_zoo_tpu_torch.feature.text import Relations, TextSet
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    from analytics_zoo_tpu_torch.ops.optimizers import Adam

    q_set = TextSet.read_csv(os.path.join(data, "question_corpus.csv")) \
        .tokenize().normalize().word2idx(min_freq=1) \
        .shape_sequence(args.question_length)
    a_set = TextSet.read_csv(os.path.join(data, "answer_corpus.csv")) \
        .tokenize().normalize() \
        .word2idx(min_freq=1, existing_map=q_set.get_word_index()) \
        .shape_sequence(args.answer_length)
    vocab = max(a_set.get_word_index().values()) + 1

    train_rel = Relations.read(os.path.join(data, "relation_train.csv"))
    x1, x2 = TextSet.from_relation_pairs(train_rel, q_set, a_set, seed=0)
    x = np.concatenate([x1, x2], axis=1).astype(np.float32)
    y = np.zeros((x.shape[0], 1), np.float32)  # rank_hinge ignores it

    knrm = KNRM(args.question_length, args.answer_length, vocab,
                embed_size=16, kernel_num=5)
    knrm.compile(optimizer=Adam(lr=args.learning_rate), loss="rank_hinge")
    knrm.fit(x, y, batch_size=args.batch_size, nb_epoch=args.nb_epoch)

    valid_rel = Relations.read(os.path.join(data, "relation_valid.csv"))
    l1, l2, labels, gids = TextSet.from_relation_lists(
        valid_rel, q_set, a_set)
    xv = np.concatenate([l1, l2], axis=1).astype(np.float32)
    scores = knrm.predict(xv, batch_size=args.batch_size).reshape(-1)
    return {"ndcg@3": knrm.evaluate_ndcg(scores, labels, gids, k=3),
            "ndcg@5": knrm.evaluate_ndcg(scores, labels, gids, k=5),
            "map": knrm.evaluate_map(scores, labels, gids)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-path", default=None)
    p.add_argument("--question-length", type=int, default=10)
    p.add_argument("--answer-length", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--nb-epoch", type=int, default=3)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    init_nncontext(device=args.device)
    if args.data_path is not None:
        metrics = run(args, args.data_path)
    else:
        with tempfile.TemporaryDirectory(prefix="qaranker_") as data:
            synthetic_corpus(data)
            metrics = run(args, data)
    print("qa_ranker:", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
