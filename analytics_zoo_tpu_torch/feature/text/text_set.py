"""TextSet (port of ``analytics_zoo_tpu/feature/text/text_set.py``, pure
Python and numpy, kept as a copy): a corpus of TextFeatures with the
NLP pipeline (tokenize, normalize, word2idx, shape_sequence,
generate_sample), the word index's build, save and load, directory, CSV
and parquet readers, and the ranking layouts ``from_relation_pairs``
and ``from_relation_lists``. The word index ranks words exactly as the
reference does (``Counter.most_common`` order, indices from 1), so the
same corpus gives the same ids in both packages."""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.text.relations import (Relation,
                                                      Relations)
from analytics_zoo_tpu_torch.feature.text.text_feature import TextFeature
from analytics_zoo_tpu_torch.feature.text.transforms import (
    Normalizer, SequenceShaper, TextFeatureToSample, Tokenizer,
    WordIndexer)


class TextSet:
    def __init__(self, features: "list[TextFeature]"):
        self.features = features
        self._word_index: Optional[Dict[str, int]] = None

    # -- readers (reference TextSet.read / readCSV / readParquet) ----------
    @staticmethod
    def read(path: str) -> "TextSet":
        """Read a ``<dir>/<category>/<file>.txt`` layout (the 20
        Newsgroups layout of the text-classification recipe); labels
        are the categories' sorted order."""
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        feats = []
        for label, c in enumerate(classes):
            cdir = os.path.join(path, c)
            for fname in sorted(os.listdir(cdir)):
                fpath = os.path.join(cdir, fname)
                if not os.path.isfile(fpath):
                    continue
                with open(fpath, encoding="utf-8", errors="ignore") as f:
                    feats.append(TextFeature(
                        f.read(), label=np.asarray([label], np.int32),
                        uri=fpath))
        ts = TextSet(feats)
        ts.n_classes = len(classes)
        return ts

    @staticmethod
    def read_csv(path: str) -> "TextSet":
        """CSV rows `id,text` (reference `TextSet.readCSV`)."""
        feats = []
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) < 2:
                    continue
                feats.append(TextFeature(row[1], uri=row[0]))
        return TextSet(feats)

    @staticmethod
    def read_parquet(path: str) -> "TextSet":
        """Rows ``id, text`` of a parquet file (pandas, imported here)."""
        import pandas as pd
        df = pd.read_parquet(path)
        return TextSet([TextFeature(str(r.text), uri=str(r.id))
                        for r in df.itertuples()])

    @staticmethod
    def from_texts(texts: Sequence[str], labels=None) -> "TextSet":
        feats = []
        for i, t in enumerate(texts):
            lbl = None if labels is None else \
                np.asarray([labels[i]], np.int32)
            feats.append(TextFeature(t, label=lbl))
        return TextSet(feats)

    # -- pipeline (each step returns self for chaining, reference style) ---
    def tokenize(self) -> "TextSet":
        tok = Tokenizer()
        for f in self.features:
            tok.apply(f)
        return self

    def normalize(self) -> "TextSet":
        norm = Normalizer()
        for f in self.features:
            norm.apply(f)
        return self

    def word2idx(self, remove_topn: int = 0,
                 max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build the vocab (reference `TextSet.word2idx`: drop the
        `remove_topn` most frequent, keep at most `max_words_num` with
        freq >= `min_freq`; index starts at 1, 0 = padding)."""
        if existing_map is not None:
            self._word_index = dict(existing_map)
        else:
            counter: Counter = Counter()
            for f in self.features:
                if f.tokens is None:
                    raise ValueError("call tokenize() before word2idx()")
                counter.update(f.tokens)
            ranked = counter.most_common()
            ranked = ranked[remove_topn:]
            ranked = [(w, c) for w, c in ranked if c >= min_freq]
            if max_words_num > 0:
                ranked = ranked[:max_words_num]
            self._word_index = {w: i + 1 for i, (w, _) in
                                enumerate(ranked)}
        indexer = WordIndexer(self._word_index)
        for f in self.features:
            indexer.apply(f)
        return self

    def shape_sequence(self, len: int,  # noqa: A002
                       trunc_mode: str = "pre") -> "TextSet":
        shaper = SequenceShaper(len, trunc_mode)
        for f in self.features:
            shaper.apply(f)
        return self

    def generate_sample(self) -> "TextSet":
        to_sample = TextFeatureToSample()
        for f in self.features:
            to_sample.apply(f)
        return self

    # -- vocab --------------------------------------------------------------
    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self._word_index

    def save_word_index(self, path: str):
        if self._word_index is None:
            raise ValueError("no word index built")
        with open(path, "w", encoding="utf-8") as f:
            for w, i in self._word_index.items():
                f.write(f"{w} {i}\n")

    def load_word_index(self, path: str) -> "TextSet":
        idx = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                w, i = line.rsplit(" ", 1)
                idx[w] = int(i)
        self._word_index = idx
        return self

    # -- ranking datasets ---------------------------------------------------
    @staticmethod
    def from_relation_pairs(relations: "list[Relation]",
                            corpus1: "TextSet", corpus2: "TextSet",
                            seed: int = 0) -> "tuple[np.ndarray, np.ndarray]":
        """→ (x1, x2) arrays with rows alternating positive/negative —
        the `rank_hinge` training layout (reference
        `TextSet.fromRelationPairs:398`). Corpora must be indexed+shaped;
        URIs are the relation ids."""
        t1 = {f[TextFeature.URI]: f.indices for f in corpus1.features}
        t2 = {f[TextFeature.URI]: f.indices for f in corpus2.features}
        pairs = Relations.generate_relation_pairs(relations, seed=seed)
        rows1, rows2 = [], []
        for pos, neg in pairs:
            rows1 += [t1[pos.id1], t1[neg.id1]]
            rows2 += [t2[pos.id2], t2[neg.id2]]
        return (np.asarray(rows1, np.int32), np.asarray(rows2, np.int32))

    @staticmethod
    def from_relation_lists(
            relations: "list[Relation]", corpus1: "TextSet",
            corpus2: "TextSet"
    ) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
        """→ (x1, x2, labels, group_ids) flattened candidate lists for
        NDCG/MAP evaluation (reference `TextSet.fromRelationLists:502`)."""
        t1 = {f[TextFeature.URI]: f.indices for f in corpus1.features}
        t2 = {f[TextFeature.URI]: f.indices for f in corpus2.features}
        groups = Relations.group_by_query(relations)
        rows1, rows2, labels, gids = [], [], [], []
        for gid, (q, rels) in enumerate(sorted(groups.items())):
            for r in rels:
                rows1.append(t1[r.id1])
                rows2.append(t2[r.id2])
                labels.append(r.label)
                gids.append(gid)
        return (np.asarray(rows1, np.int32), np.asarray(rows2, np.int32),
                np.asarray(labels, np.int32), np.asarray(gids, np.int32))

    # -- export -------------------------------------------------------------
    def to_feature_set(self, memory_type="dram"):
        """The generated samples as a :class:`~analytics_zoo_tpu_torch.
        feature.feature_set.FeatureSet` in ``memory_type``'s tier."""
        from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
        samples = []
        for f in self.features:
            s = f.get_sample()
            if s is None:
                raise ValueError("call generate_sample() first")
            samples.append(s)
        return FeatureSet.sample_rdd(samples, memory_type=memory_type)

    def to_arrays(self) -> "tuple[np.ndarray, Optional[np.ndarray]]":
        xs, ys = [], []
        has_label = False
        for f in self.features:
            if f.indices is None:
                raise ValueError("pipeline incomplete: no indices")
            xs.append(f.indices)
            if f.label is not None:
                has_label = True
                ys.append(np.asarray(f.label))
        return (np.asarray(xs, np.int32),
                np.stack(ys) if has_label else None)

    def __len__(self):
        return len(self.features)
