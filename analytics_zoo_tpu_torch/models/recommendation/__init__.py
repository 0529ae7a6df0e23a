"""Recommendation models of the port: NeuralCF and Wide&Deep over the
``Recommender`` ranking surface."""

from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender, UserItemFeature, UserItemPrediction)
from analytics_zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo, WideAndDeep)

__all__ = ["Recommender", "UserItemFeature", "UserItemPrediction",
           "NeuralCF", "WideAndDeep", "ColumnFeatureInfo"]
