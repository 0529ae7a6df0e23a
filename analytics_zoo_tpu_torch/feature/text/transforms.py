"""Text transformers (port of ``analytics_zoo_tpu/feature/text/
transforms.py``): Tokenizer, Normalizer, WordIndexer, SequenceShaper
and TextFeatureToSample."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing, Sample
from analytics_zoo_tpu_torch.feature.text.text_feature import TextFeature


class Tokenizer(Preprocessing):
    """Whitespace tokenization (reference `Tokenizer.scala`)."""

    def apply(self, feature: TextFeature) -> TextFeature:
        feature[TextFeature.TOKENS] = feature.text.split()
        return feature


class Normalizer(Preprocessing):
    """Lower-case + strip non-alphanumeric chars from tokens (reference
    `Normalizer.scala`)."""

    _pattern = re.compile(r"[^a-zA-Z0-9]")

    def apply(self, feature: TextFeature) -> TextFeature:
        tokens = feature.tokens
        if tokens is None:
            raise ValueError("Normalizer requires Tokenizer first")
        norm = [self._pattern.sub("", t.lower()) for t in tokens]
        feature[TextFeature.TOKENS] = [t for t in norm if t]
        return feature


class WordIndexer(Preprocessing):
    """tokens → indices using a word→index map (reference
    `WordIndexer.scala`). Unknown words are dropped (reference
    behavior)."""

    def __init__(self, word_index: "Dict[str, int]"):
        self.word_index = word_index

    def apply(self, feature: TextFeature) -> TextFeature:
        tokens = feature.tokens
        if tokens is None:
            raise ValueError("WordIndexer requires tokens")
        feature[TextFeature.INDEXED] = [
            self.word_index[t] for t in tokens if t in self.word_index]
        return feature


class SequenceShaper(Preprocessing):
    """Pad/truncate the index sequence to `len` (reference
    `SequenceShaper.scala`; `trunc_mode` pre|post, pad value 0)."""

    def __init__(self, len: int, trunc_mode: str = "pre",  # noqa: A002
                 pad_element: int = 0):
        self.seq_len = int(len)
        if trunc_mode not in ("pre", "post"):
            raise ValueError("trunc_mode must be pre|post")
        self.trunc_mode = trunc_mode
        self.pad_element = int(pad_element)

    def apply(self, feature: TextFeature) -> TextFeature:
        idx = feature.indices
        if idx is None:
            raise ValueError("SequenceShaper requires WordIndexer first")
        if len(idx) > self.seq_len:
            idx = (idx[-self.seq_len:] if self.trunc_mode == "pre"
                   else idx[:self.seq_len])
        else:
            idx = idx + [self.pad_element] * (self.seq_len - len(idx))
        feature[TextFeature.INDEXED] = idx
        return feature


class TextFeatureToSample(Preprocessing):
    """indices (+label) → Sample (reference
    `TextFeatureToSample.scala`)."""

    def apply(self, feature: TextFeature) -> TextFeature:
        idx = feature.indices
        if idx is None:
            raise ValueError("TextFeatureToSample requires indices")
        label = feature.label
        feature[TextFeature.SAMPLE] = Sample(
            feature=np.asarray(idx, np.int32),
            label=None if label is None else np.asarray(label))
        return feature
