"""The text data path (port of ``analytics_zoo_tpu/feature/text``):
TextSet and its transforms, TextFeature, and the ranking relations."""

from analytics_zoo_tpu_torch.feature.text.text_feature import TextFeature
from analytics_zoo_tpu_torch.feature.text.text_set import TextSet
from analytics_zoo_tpu_torch.feature.text.transforms import (
    Tokenizer, Normalizer, WordIndexer, SequenceShaper,
    TextFeatureToSample)
from analytics_zoo_tpu_torch.feature.text.relations import (
    Relation, Relations)

__all__ = ["TextFeature", "TextSet", "Tokenizer", "Normalizer",
           "WordIndexer", "SequenceShaper", "TextFeatureToSample",
           "Relation", "Relations"]
