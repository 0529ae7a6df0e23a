"""Text matching of the port: TextMatcher and KNRM."""

from analytics_zoo_tpu_torch.models.textmatching.knrm import KNRM
from analytics_zoo_tpu_torch.models.textmatching.text_matcher import \
    TextMatcher

__all__ = ["KNRM", "TextMatcher"]
