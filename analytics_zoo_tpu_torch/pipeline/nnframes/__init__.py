"""nnframes on the card (port of the JAX package's ``pipeline/nnframes``):
Spark-ML-style estimators and transformers over pandas DataFrames, Spark
DataFrames and RDDs."""

from analytics_zoo_tpu_torch.pipeline.nnframes.nn_estimator import (
    NNClassifier, NNClassifierModel, NNEstimator, NNModel)
from analytics_zoo_tpu_torch.pipeline.nnframes.nn_image_reader import (
    NNImageReader, NNImageSchema)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader", "NNImageSchema"]
