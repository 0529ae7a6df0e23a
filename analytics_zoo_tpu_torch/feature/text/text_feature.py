"""TextFeature (port of ``analytics_zoo_tpu/feature/text/
text_feature.py``): one text record carrying its text, label, tokens,
indices and sample through the pipeline."""

from __future__ import annotations

from typing import Optional


class TextFeature(dict):
    TEXT = "text"
    LABEL = "label"
    TOKENS = "tokens"
    INDEXED = "indexed_tokens"
    SAMPLE = "sample"
    URI = "uri"

    def __init__(self, text: Optional[str] = None, label=None,
                 uri: Optional[str] = None):
        super().__init__()
        if text is not None:
            self[self.TEXT] = text
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def text(self) -> str:
        return self.get(self.TEXT, "")

    @property
    def label(self):
        return self.get(self.LABEL)

    @property
    def tokens(self):
        return self.get(self.TOKENS)

    @property
    def indices(self):
        return self.get(self.INDEXED)

    def get_sample(self):
        return self.get(self.SAMPLE)
