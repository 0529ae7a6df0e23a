"""ZooDictionary: word↔index vocabulary (port of
``analytics_zoo_tpu/common/dictionary.py``, a copy: pure Python, used
by the Seq2seq chatbot pipeline).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence


class ZooDictionary:
    """Bidirectional word↔index mapping built from a corpus or loaded
    from saved vocab files."""

    def __init__(self, words: Optional[Iterable[str]] = None,
                 case_sensitive: bool = True):
        self._word2idx: Dict[str, int] = {}
        self._idx2word: List[str] = []
        self.case_sensitive = case_sensitive
        if words is not None:
            for w in words:
                self.add_word(w)

    # -- construction -------------------------------------------------------
    def _norm(self, word: str) -> str:
        return word if self.case_sensitive else word.lower()

    def add_word(self, word: str) -> int:
        word = self._norm(word)
        if word not in self._word2idx:
            self._word2idx[word] = len(self._idx2word)
            self._idx2word.append(word)
        return self._word2idx[word]

    @classmethod
    def from_corpus(cls, sentences: Iterable[Sequence[str]],
                    max_vocab: Optional[int] = None,
                    case_sensitive: bool = True) -> "ZooDictionary":
        """Build from tokenized sentences, most-frequent-first
        (reference constructor from a dataset of sentences)."""
        counts: Dict[str, int] = {}
        d = cls(case_sensitive=case_sensitive)
        for sent in sentences:
            for w in sent:
                w = d._norm(w)
                counts[w] = counts.get(w, 0) + 1
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if max_vocab is not None:
            ranked = ranked[:max_vocab]
        for w, _ in ranked:
            d.add_word(w)
        return d

    # -- lookup (reference getIndex/getWord) --------------------------------
    def get_index(self, word: str, default: Optional[int] = None) -> int:
        word = self._norm(word)
        if word in self._word2idx:
            return self._word2idx[word]
        if default is not None:
            return default
        raise KeyError(f"word {word!r} not in dictionary")

    def get_word(self, index: int) -> str:
        return self._idx2word[index]

    def contains(self, word: str) -> bool:
        return self._norm(word) in self._word2idx

    def __contains__(self, word: str) -> bool:
        return self.contains(word)

    def __len__(self) -> int:
        return len(self._idx2word)

    @property
    def vocab_size(self) -> int:
        return len(self._idx2word)

    def word2idx(self) -> Dict[str, int]:
        return dict(self._word2idx)

    def idx2word(self) -> List[str]:
        return list(self._idx2word)

    # -- encode / decode ----------------------------------------------------
    def encode(self, tokens: Sequence[str],
               unk_index: Optional[int] = None) -> List[int]:
        return [self.get_index(t, default=unk_index) for t in tokens]

    def decode(self, indices: Sequence[int]) -> List[str]:
        return [self.get_word(int(i)) for i in indices]

    # -- persistence (reference save/load vocab files) ----------------------
    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"case_sensitive": self.case_sensitive,
                       "words": self._idx2word}, f)

    @classmethod
    def load(cls, path: str) -> "ZooDictionary":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        d = cls(case_sensitive=data.get("case_sensitive", True))
        for w in data["words"]:
            d.add_word(w)
        return d
