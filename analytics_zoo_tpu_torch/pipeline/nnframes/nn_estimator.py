"""nnframes: the DataFrame-native ML pipeline (port of
the JAX package's ``pipeline/nnframes/nn_estimator.py``; the Scala
original is ``Z/pipeline/nnframes/NNEstimator.scala:183-816`` with
``NNClassifier.scala:42,140``).

An :class:`NNEstimator` is a Spark-ML-style estimator: its rows, from a
pandas DataFrame, a Spark DataFrame or an RDD, go through a
``Preprocessing`` chain into ``Sample`` s and a ``FeatureSet``, the
Estimator trains the net on the card, and ``fit`` returns an
:class:`NNModel`, a transformer whose ``transform`` appends a prediction
column. :class:`NNClassifier` and :class:`NNClassifierModel` add the
class column (the argmax, or ``> 0.5`` for one output).

Weights. The port's nets hold their weights (``model.params()``), where
the reference's Estimators each hold a tree of their own. So ``fit``
keeps the reference's semantics by these rules:

- a model that was compiled trains from the weights it carries (a
  pretrained backbone, an earlier fit), and its frozen layers stay
  fixed; a model never compiled starts from a fresh init on every fit,
  drawn from the context, as the reference's Estimator draws one;
- after ``fit`` the model carries the trained weights, and a compiled
  model's optimizer state starts again at its next ``fit``;
- the :class:`NNModel` that ``fit`` returns predicts with a snapshot of
  that fit's weights (``NNModel.params``), which a later fit of the
  same model leaves as it is.

Persistence. ``NNModel.save`` writes the net's architecture without its
tensors (``common.safe_pickle.ArchPickler``), the weights as numpy, the
columns, the batch size, the preprocessing and the class name; ``load``
reads the file through ``load_architecture`` and places the weights on
the context's device, so a file saved on the card loads on the CPU. The
loaded net is compiled, so that a later ``fit`` trains from the loaded
weights, as from a compiled model's; the reference's can save only a
net never compiled, and a later fit of it starts afresh. A file written
by the JAX package names JAX classes, which the whitelist refuses.

Neither pandas nor pyspark is imported at import time: a pandas
DataFrame is recognised by its module, and pandas is imported where a
DataFrame is made.
"""

from __future__ import annotations

import io
import itertools
import os
import sys
from typing import Callable, Optional

import numpy as np

from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
from analytics_zoo_tpu_torch.common.safe_pickle import (
    ArchPickler, load_architecture, restore_architecture)
from analytics_zoo_tpu_torch.feature.common import Preprocessing, Sample
from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
from analytics_zoo_tpu_torch.feature.rdd import (is_rdd_like,
                                                 is_spark_dataframe,
                                                 iter_shard)
from analytics_zoo_tpu_torch.pipeline.estimator import Estimator, Trigger


def _is_pandas(df) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(df, pd.DataFrame)


def _snapshot(tree: dict) -> dict:
    """A copy of a param tree's tensors on their device."""
    return {k: _snapshot(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


class _Params:
    """Spark-ML-style params: ``set_x(v)`` and ``setX(v)`` both work."""

    def __getattr__(self, name):
        # camelCase aliases (setFeaturesCol, ...)
        if name.startswith("set") and len(name) > 3 and name[3].isupper():
            snake = "set_" + "".join(
                ("_" + c.lower()) if c.isupper() else c
                for c in name[3:]).lstrip("_")
            return object.__getattribute__(self, snake)
        raise AttributeError(name)


class NNEstimator(_Params):
    def __init__(self, model, criterion="mse",
                 feature_preprocessing: Optional[Preprocessing] = None,
                 label_preprocessing: Optional[Preprocessing] = None):
        self.model = model
        self.criterion = criterion
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.features_col = "features"
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 10
        self.optim_method = "adam"
        self.learning_rate: Optional[float] = None
        self.validation_df = None
        self.validation_trigger: Optional[Trigger] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.tensorboard: Optional[tuple] = None
        self.clip_l2: Optional[float] = None
        self.clip_const: Optional[tuple] = None
        self.metrics: list = []

    # -- params (the reference's NNEstimator params) ------------------------
    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    def set_batch_size(self, v):
        self.batch_size = int(v)
        return self

    def set_max_epoch(self, v):
        self.max_epoch = int(v)
        return self

    def set_optim_method(self, v):
        self.optim_method = v
        return self

    def set_learning_rate(self, v):
        self.learning_rate = float(v)
        return self

    def set_validation(self, df, trigger: Optional[Trigger] = None,
                       metrics: Optional[list] = None):
        """Evaluate ``df`` at ``trigger`` (every epoch by default)."""
        self.validation_df = df
        self.validation_trigger = trigger
        if metrics:
            self.metrics = metrics
        return self

    def set_checkpoint(self, path, trigger: Optional[Trigger] = None):
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def set_tensorboard(self, log_dir, app_name="nnframes"):
        self.tensorboard = (log_dir, app_name)
        return self

    def set_gradient_clipping_by_l2_norm(self, v):
        self.clip_l2 = float(v)
        return self

    def set_constant_gradient_clipping(self, lo, hi):
        self.clip_const = (float(lo), float(hi))
        return self

    # -- rows to samples (the reference's getDataSet) ------------------------
    def _row_to_feature(self, value):
        if self.feature_preprocessing is not None:
            return self.feature_preprocessing.apply(value)
        return np.asarray(value, np.float32)

    def _collect_rows(self, df, with_label: bool):
        """``(feature value, label value or None)`` per row of a pandas
        DataFrame, a Spark DataFrame (narrowed to the two columns, this
        process's share of the partitions) or an RDD of ``(feature,
        label)`` tuples, ``Sample`` s or bare features."""
        if _is_pandas(df):
            has_label = with_label and self.label_col in df.columns
            labels = (df[self.label_col] if has_label
                      else itertools.repeat(None))
            yield from zip(df[self.features_col], labels)
            return
        if is_spark_dataframe(df):
            has_label = with_label and self.label_col in df.columns
            cols = [self.features_col] + ([self.label_col] if has_label
                                          else [])
            for row in iter_shard(df.select(*cols).rdd):
                yield row[0], (row[1] if has_label else None)
            return
        if is_rdd_like(df):
            for rec in iter_shard(df):
                if isinstance(rec, tuple) and len(rec) == 2:
                    yield rec[0], (rec[1] if with_label else None)
                else:
                    yield rec, None
            return
        raise TypeError(
            f"unsupported DataFrame/RDD type: {type(df).__name__}")

    def _df_to_feature_set(self, df, with_label: bool = True) -> FeatureSet:
        samples = []
        for value, label_val in self._collect_rows(df, with_label):
            feat = value if isinstance(value, Sample) else \
                self._row_to_feature(value)
            if isinstance(feat, Sample):
                samples.append(feat)
                continue
            label = None
            if label_val is not None:
                if self.label_preprocessing is not None:
                    label = self.label_preprocessing.apply(label_val)
                else:
                    label = np.atleast_1d(np.asarray(label_val, np.float32))
            samples.append(Sample(feature=feat, label=label))
        return FeatureSet.sample_rdd(samples)

    # -- fit ----------------------------------------------------------------
    def _build_optimizer(self):
        from analytics_zoo_tpu_torch.ops import optimizers as optim_lib
        opt = self.optim_method
        if isinstance(opt, str) and self.learning_rate is not None:
            opt = optim_lib._REGISTRY[opt.lower()](lr=self.learning_rate)
        return opt

    def fit(self, df) -> "NNModel":
        """Train the model on ``df`` for ``max_epoch`` epochs and return
        the transformer of the trained weights (the reference's
        ``NNEstimator.fit``, NNEstimator.scala:392-450)."""
        fs = self._df_to_feature_set(df)
        est = Estimator(self.model, optimizer=self._build_optimizer(),
                        loss=self.criterion, metrics=self.metrics)
        prior = getattr(self.model, "_estimator", None)
        if prior is None:
            # never compiled: a fresh init from the context, as the
            # reference's new Estimator draws one
            self.model.init_params(est.ctx.new_generator(),
                                   device=est.ctx.device)
        if self.clip_l2 is not None:
            est.set_gradient_clipping_by_l2_norm(self.clip_l2)
        if self.clip_const is not None:
            est.set_constant_gradient_clipping(*self.clip_const)
        if self.checkpoint_path:
            est.set_checkpoint(self.checkpoint_path, self.checkpoint_trigger)
        if self.tensorboard:
            est.set_tensorboard(*self.tensorboard)
        val = None
        if self.validation_df is not None:
            val = self._df_to_feature_set(self.validation_df)
        est.train(fs, batch_size=self.batch_size, nb_epoch=self.max_epoch,
                  validation_data=val,
                  validation_trigger=self.validation_trigger)
        if prior is not None:
            # the moments belong to this fit's Estimator
            prior.opt_state = None
        return self._wrap_model(est, _snapshot(self.model.params()))

    def _model_type(self) -> type:
        return NNModel

    def _wrap_model(self, est: Estimator, params: dict) -> "NNModel":
        m = self._model_type()(self.model, self.feature_preprocessing,
                               estimator=est, params=params)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m


class NNModel(_Params):
    """The ``ml.Transformer``: batched prediction appending a prediction
    column (the reference's NNEstimator.scala:571-816, persistence
    included). It predicts with ``params``, a tree of the model's
    structure: by default a snapshot of the model's weights, initialized
    first from the context where the model has none."""

    def __init__(self, model,
                 feature_preprocessing: Optional[Preprocessing] = None,
                 estimator: Optional[Estimator] = None,
                 params: Optional[dict] = None):
        self.model = model
        self.feature_preprocessing = feature_preprocessing
        self.features_col = "features"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.estimator = estimator or Estimator(model, optimizer="adam",
                                                loss="mse")
        if params is None:
            if not model.initialized:
                ctx = self.estimator.ctx
                model.init_params(ctx.new_generator(), device=ctx.device)
            params = _snapshot(model.params())
        self.params = params

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    def set_batch_size(self, v):
        self.batch_size = int(v)
        return self

    @staticmethod
    def _spark_session_of(df):
        return getattr(df, "sparkSession", None) or df.sql_ctx.sparkSession

    @staticmethod
    def _spark_safe(pdf):
        # createDataFrame refuses ndarray cells (a features column that
        # came through toPandas): lists instead
        return pdf.apply(lambda col: col.map(
            lambda v: v.tolist() if isinstance(v, np.ndarray) else v))

    def _features_array(self, df) -> np.ndarray:
        """The features column (of a DataFrame, or any mapping of
        columns) through the preprocessing, stacked in f32."""
        rows = []
        for v in df[self.features_col]:
            f = (self.feature_preprocessing.apply(v)
                 if self.feature_preprocessing is not None
                 else np.asarray(v, np.float32))
            if isinstance(f, Sample):
                f = f.feature
            rows.append(np.asarray(f, np.float32))
        return np.stack(rows)

    def _raw_predict(self, df) -> np.ndarray:
        return self.estimator.predict(self._features_array(df),
                                      batch_size=self.batch_size,
                                      params=self.params)

    def transform(self, df):
        """``df`` with the prediction column appended. A Spark DataFrame
        streams through this process in chunks (``toLocalIterator``,
        predict, one ``createDataFrame`` per chunk, unions), so one
        chunk is resident at a time; ``ZOO_TPU_TRANSFORM_CHUNK`` rows
        (1024 by default, at least the batch size)."""
        if is_spark_dataframe(df):
            return self._stream_spark_transform(
                df, lambda col: [[float(v)
                                  for v in np.asarray(p).reshape(-1)]
                                 for p in col],
                scalar_pred=False)
        preds = self._raw_predict(df)
        out = df.copy()
        out[self.prediction_col] = [np.asarray(p).reshape(-1)
                                    for p in preds]
        return out

    def _output_schema(self, df, scalar_pred: bool):
        """The input's schema plus the prediction field, so that every
        chunk's ``createDataFrame`` takes one schema; None where pyspark's
        types are not importable (a duck-typed DataFrame) or the column
        is scored again in place: the first chunk's inference then pins
        it."""
        base = getattr(df, "schema", None)
        if base is None or self.prediction_col in df.columns:
            return None
        try:
            from pyspark.sql.types import (ArrayType, DoubleType,
                                           StructField, StructType)
        except ImportError:
            return None
        pred_t = DoubleType() if scalar_pred else ArrayType(DoubleType())
        fields = [f for f in base.fields if f.name != self.prediction_col]
        return StructType(
            fields + [StructField(self.prediction_col, pred_t, True)])

    def _stream_spark_transform(self, df, finalize: Callable,
                                scalar_pred: bool = False):
        """The chunked Spark transform: ``toLocalIterator``, this
        class's pandas transform per chunk, a ``createDataFrame`` per
        chunk with one schema, and unions reduced as a tree (the plan's
        depth and the union count grow as log n). ``finalize`` turns the
        prediction column into Spark values."""
        import pandas as pd
        spark = self._spark_session_of(df)
        chunk_rows = max(self.batch_size, int(os.environ.get(
            "ZOO_TPU_TRANSFORM_CHUNK", "1024")))
        cols = list(df.columns)
        schema = self._output_schema(df, scalar_pred)

        def flush(buf):
            nonlocal schema
            out = self.transform(pd.DataFrame(buf, columns=cols))
            out[self.prediction_col] = finalize(out[self.prediction_col])
            safe = self._spark_safe(out)
            part = (spark.createDataFrame(safe) if schema is None
                    else spark.createDataFrame(safe, schema=schema))
            if schema is None:
                schema = getattr(part, "schema", None)
            return part

        # (level, DataFrame) pairs; equal levels merge
        stack: list = []

        def push(part):
            level = 0
            while stack and stack[-1][0] == level:
                _, prev = stack.pop()
                part = prev.unionAll(part)
                level += 1
            stack.append((level, part))

        it = df.toLocalIterator()
        chunks = iter(
            lambda: [tuple(r) for r in itertools.islice(it, chunk_rows)],
            [])
        n = 0
        for buf in chunks:
            push(flush(buf))
            n += 1
        if n == 0:          # an empty input fails as pandas' does
            push(flush([]))
        result = None
        for _, part in stack:
            result = part if result is None else result.unionAll(part)
        return result

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, over_write: bool = False):
        """The architecture, the weights as numpy, the columns, the batch
        size, the preprocessing and the class (see the module's
        docstring); a lambda in the net or the preprocessing cannot be
        saved."""
        if os.path.exists(path) and not over_write:
            raise FileExistsError(path)
        state = {
            "model": self.model,
            "params": params_to_numpy(self.params),
            "features_col": self.features_col,
            "prediction_col": self.prediction_col,
            "batch_size": self.batch_size,
            "feature_preprocessing": self.feature_preprocessing,
            "class": type(self).__name__,
        }
        buf = io.BytesIO()
        ArchPickler(buf).dump(state)
        with open(path, "wb") as f:
            f.write(buf.getvalue())

    @classmethod
    def load(cls, path: str) -> "NNModel":
        """A :meth:`save` file, read through the class whitelist, its
        weights on the context's device. The net is compiled, with the
        default optimizer and loss (the file keeps no optimizer), so
        that a later ``fit`` trains from the loaded weights."""
        state = load_architecture(path)
        klass = (NNClassifierModel
                 if state.get("class") == "NNClassifierModel" else cls)
        net = restore_architecture(state["model"])
        net.load_params(state["params"], device=get_nncontext().device)
        net.compile()
        m = klass(net, state["feature_preprocessing"],
                  params=_snapshot(net.params()))
        m.features_col = state["features_col"]
        m.prediction_col = state["prediction_col"]
        m.batch_size = state["batch_size"]
        return m


class NNClassifier(NNEstimator):
    """Classification (the reference's NNClassifier.scala:42): float
    labels, the class as the prediction."""

    def _model_type(self) -> type:
        return NNClassifierModel


class NNClassifierModel(NNModel):
    """(the reference's NNClassifierModel, NNClassifier.scala:140):
    appends the class as a scalar prediction: the argmax, or ``> 0.5``
    for one output."""

    @staticmethod
    def classes(preds: np.ndarray) -> np.ndarray:
        """The prediction column of :meth:`transform` from the model's
        outputs, as float64."""
        if preds.ndim > 1 and preds.shape[-1] > 1:
            return np.argmax(preds, axis=-1).astype(np.float64)
        return (preds.reshape(-1) > 0.5).astype(np.float64)

    def transform(self, df):
        if is_spark_dataframe(df):
            return self._stream_spark_transform(
                df, lambda col: [float(v) for v in col], scalar_pred=True)
        out = df.copy()
        out[self.prediction_col] = self.classes(self._raw_predict(df))
        return out

