"""Keras-style dataset loaders (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets``; numpy and the
standard library only, and nothing is downloaded).

Each loader resolves in order:

1. a local cache file in ``dest_dir`` (the reference's on-disk formats:
   MNIST idx-gzip, ``boston_housing.npz``, pickled or npz index
   sequences), read when present;
2. otherwise a small deterministic synthetic stand-in with the real
   shapes, dtypes and label ranges (seeded, and logged as synthetic),
   equal array for array to the reference's for the same arguments.

Every ``load_data`` returns ``(x_train, y_train), (x_test, y_test)``
with the reference's dtypes.
"""

from analytics_zoo_tpu_torch.pipeline.api.keras.datasets import (  # noqa: F401
    boston_housing, imdb, mnist, reuters)

__all__ = ["mnist", "imdb", "reuters", "boston_housing"]
