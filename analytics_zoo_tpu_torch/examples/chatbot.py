"""Chatbot example: ZooDictionary and Seq2seq over a dialog corpus,
with greedy or beam replies. ``ZooDictionary`` builds the word↔index
vocabulary, tokens become one-hot vectors, ``Seq2seq`` (LSTM encoder
and decoder, a dense bridge, a softmax Dense generator) trains
teacher-forced, and ``infer`` generates a reply word by word.

A tiny built-in dialog corpus keeps the demo offline; point
``--corpus`` at a two-column TSV (utterance<TAB>reply) for real data.

    python -m analytics_zoo_tpu_torch.examples chatbot
    python -m analytics_zoo_tpu_torch.examples chatbot --device cpu --beam 3
"""

from __future__ import annotations

import argparse

import numpy as np

_TINY_DIALOGS = [
    ("hello", "hi there"),
    ("hi", "hello"),
    ("how are you", "i am fine"),
    ("what is your name", "i am zoo"),
    ("bye", "goodbye"),
    ("thanks", "you are welcome"),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", default=None,
                   help="TSV file: utterance<TAB>reply per line")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--max-len", type=int, default=6)
    p.add_argument("--ask", default="how are you")
    p.add_argument("--beam", type=int, default=1,
                   help=">1 switches the reply decode to beam search")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.common.dictionary import ZooDictionary
    from analytics_zoo_tpu_torch.models.seq2seq import (
        Bridge, RNNDecoder, RNNEncoder, Seq2seq)
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    init_nncontext(seed=0, device=args.device)
    if args.corpus:
        pairs = []
        with open(args.corpus) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    pairs.append((parts[0], parts[1]))
    else:
        pairs = _TINY_DIALOGS
    if not pairs:
        raise SystemExit(
            "no utterance<TAB>reply lines found in --corpus")

    # -- vocab (reference: ZooDictionary over the corpus) --------------
    sos, eos, pad = "<sos>", "<eos>", "<pad>"
    sentences = [q.split() for q, _ in pairs] + \
        [a.split() for _, a in pairs] + [[sos, eos, pad]]
    vocab = ZooDictionary.from_corpus(sentences)
    v = len(vocab)
    t = args.max_len

    def encode(words, add_sos=False, add_eos=False):
        # unseen words map to <pad> (no KeyError for novel --ask words)
        unk = vocab.get_index(pad)
        keep = t - int(add_sos) - int(add_eos)
        ids = vocab.encode(words, unk_index=unk)[:keep]
        if add_sos:
            ids = [vocab.get_index(sos)] + ids
        if add_eos:
            ids = ids + [vocab.get_index(eos)]
        ids += [unk] * (t - len(ids))
        return ids[:t]

    def onehot(ids):
        out = np.zeros((len(ids), v), np.float32)
        out[np.arange(len(ids)), ids] = 1.0
        return out

    enc_in = np.stack([onehot(encode(q.split())) for q, _ in pairs])
    dec_in = np.stack([onehot(encode(a.split(), add_sos=True))
                       for _, a in pairs])
    target = np.stack([onehot(encode(a.split(), add_eos=True))
                       for _, a in pairs])

    # -- model (teacher-forced training) -------------------------------
    s2s = Seq2seq(encoder=RNNEncoder("lstm", 1, args.hidden),
                  decoder=RNNDecoder("lstm", 1, args.hidden),
                  input_shape=(t, v), output_shape=(t, v),
                  bridge=Bridge("dense"),
                  generator=Dense(v, activation="softmax",
                                  name="generator"))
    s2s.compile(optimizer=Adam(lr=0.02), loss="categorical_crossentropy")
    # one card: batches of up to 8 dialogs
    batch = min(len(pairs), 8)
    res = s2s.fit([enc_in, dec_in], target, batch_size=batch,
                  nb_epoch=args.epochs)

    # -- chat: greedy (reference infer loop) or beam search ------------
    q = onehot(encode(args.ask.split()))[None]
    if args.beam > 1:
        ids, score = s2s.infer_beam(
            q[0], start_token=vocab.get_index(sos),
            beam_size=args.beam, max_seq_len=t,
            stop_token=vocab.get_index(eos))
        words = [vocab.get_word(i) for i in ids]
    else:
        start = onehot([vocab.get_index(sos)])[0]
        gen = s2s.infer(q[0], start_sign=start, max_seq_len=t)
        words = []
        for step in range(1, gen.shape[1]):    # skip the <sos> start
            w = vocab.get_word(int(np.argmax(gen[0, step])))
            if w in (eos, pad, sos):  # stop at end/filler tokens
                break
            words.append(w)
    words = [w for w in words if w not in (eos, pad, sos)]
    reply = " ".join(words)
    print(f"loss: {res.history[0]['loss']:.3f} -> "
          f"{res.history[-1]['loss']:.3f} over {args.epochs} epochs")
    print(f"> {args.ask}")
    print(f"< {reply or '(silence)'}")
    return {"loss": res.history[-1]["loss"], "reply": reply}


if __name__ == "__main__":
    main()
