"""Text classification example: the TextSet pipeline (tokenize,
word2idx, shape_sequence, generate_sample) into a TextClassifier with
an Embedding front, trained through ``compile``/``fit``. A synthetic
corpus shaped like 20 Newsgroups' (a topic per class) stands in for the
dataset.

At its defaults it draws the JAX package's example corpus (three topics
of six words). ``synth_corpus`` widens to any number of classes over a
synthetic vocabulary of ``vocab_words`` words.

    python -m analytics_zoo_tpu_torch.examples text_classification
    python -m analytics_zoo_tpu_torch.examples text_classification \\
        --device cpu --encoder lstm
"""

from __future__ import annotations

import argparse

import numpy as np

_TOPICS = {
    0: ["game", "team", "score", "season", "coach", "win"],
    1: ["gpu", "kernel", "driver", "compile", "memory", "bug"],
    2: ["senate", "vote", "policy", "bill", "election", "law"],
}


def synth_corpus(rng, n_per_class, classes, vocab_words=0,
                 length=(8, 20)):
    """``(texts, labels)``: ``n_per_class`` documents per class of
    ``length[0]`` to ``length[1] - 1`` words, shuffled. With
    ``vocab_words`` 0, each class's words come from one of three
    six-word topics (the JAX package's corpus). Otherwise the words are
    ``w0`` .. ``w<vocab_words - 1>``: half of each document from a
    Zipf-like background over all of them, half from its class's own
    band of ``vocab_words // classes`` words."""
    if vocab_words:
        rank = np.arange(vocab_words)
        p = 1.0 / (rank + 10.0)
        p /= p.sum()
        band = vocab_words // classes
        names = np.array([f"w{i}" for i in range(vocab_words)])
    texts, labels = [], []
    for c in range(classes):
        for _ in range(n_per_class):
            n = rng.randint(*length)
            if not vocab_words:
                words = rng.choice(_TOPICS[c % len(_TOPICS)], n)
            else:
                ids = np.where(rng.rand(n) < 0.5,
                               rng.choice(vocab_words, n, p=p),
                               c * band + rng.randint(0, band, n))
                words = names[ids]
            texts.append(" ".join(words))
            labels.append(c)
    order = rng.permutation(len(texts))
    return [texts[i] for i in order], [labels[i] for i in order]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--per-class", type=int, default=64)
    p.add_argument("--sequence-length", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--encoder", default="cnn",
                   choices=["cnn", "lstm", "gru"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.feature.text import TextSet
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Embedding

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    texts, labels = synth_corpus(rng, args.per_class, args.classes)

    text_set = TextSet.from_texts(texts, labels)
    transformed = (text_set.tokenize()
                   .word2idx()
                   .shape_sequence(args.sequence_length)
                   .generate_sample())
    x, y = transformed.to_arrays()
    vocab_size = len(transformed.get_word_index()) + 2

    clf = TextClassifier(class_num=args.classes,
                         sequence_length=args.sequence_length,
                         encoder=args.encoder, encoder_output_dim=32,
                         embedding=Embedding(
                             vocab_size, 32,
                             input_shape=(args.sequence_length,)))
    clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    clf.fit(x, y, batch_size=args.batch_size, nb_epoch=args.epochs)
    metrics = clf.evaluate(x, y, batch_size=args.batch_size)
    print(f"train-set metrics: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
