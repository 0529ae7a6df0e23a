"""Wide & Deep recommender (port of
``analytics_zoo_tpu/models/recommendation/wide_and_deep.py``).

Inputs, two dense arrays:

- ``x_wide``: (batch, wide_dim), the multi-hot wide base and cross
  features, into a zero-initialized Dense;
- ``x_deep``: (batch, indicator dims + embedding columns + continuous
  columns): the indicator one-hots, then the embedding ids (as floats,
  truncated to ints by the lookup), then the continuous values.

Output: log-probabilities over ``num_classes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from analytics_zoo_tpu_torch.models.recommendation.recommender import \
    Recommender
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation, Add, Concatenate, Dense, Embedding, Narrow, Select)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model


@dataclass
class ColumnFeatureInfo:
    """The column layout of the wide and deep inputs."""

    wide_base_cols: "list[str]" = field(default_factory=list)
    wide_base_dims: "list[int]" = field(default_factory=list)
    wide_cross_cols: "list[str]" = field(default_factory=list)
    wide_cross_dims: "list[int]" = field(default_factory=list)
    indicator_cols: "list[str]" = field(default_factory=list)
    indicator_dims: "list[int]" = field(default_factory=list)
    embed_cols: "list[str]" = field(default_factory=list)
    embed_in_dims: "list[int]" = field(default_factory=list)
    embed_out_dims: "list[int]" = field(default_factory=list)
    continuous_cols: "list[str]" = field(default_factory=list)

    @property
    def wide_dim(self) -> int:
        return sum(self.wide_base_dims) + sum(self.wide_cross_dims)

    @property
    def deep_dim(self) -> int:
        return (sum(self.indicator_dims) + len(self.embed_cols) +
                len(self.continuous_cols))


class WideAndDeep(Recommender):
    def __init__(self, model_type: str = "wide_n_deep",
                 num_classes: int = 2,
                 column_info: Optional[ColumnFeatureInfo] = None,
                 hidden_layers: Sequence[int] = (40, 20, 10)):
        super().__init__()
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError("model_type must be wide|deep|wide_n_deep")
        if column_info is None:
            raise ValueError("column_info is required")
        self.model_type = model_type
        self.num_classes = int(num_classes)
        self.column_info = column_info
        self.hidden_layers = tuple(int(h) for h in hidden_layers)

    def hyper_parameters(self):
        return {"model_type": self.model_type,
                "num_classes": self.num_classes,
                "column_info": self.column_info,
                "hidden_layers": self.hidden_layers}

    def _build_deep(self, x_deep):
        info = self.column_info
        pieces = []
        offset = 0
        ind_width = sum(info.indicator_dims)
        if ind_width:
            pieces.append(Narrow(1, 0, ind_width,
                                 name="indicator_cols")(x_deep))
            offset += ind_width
        for i, (in_dim, out_dim) in enumerate(
                zip(info.embed_in_dims, info.embed_out_dims)):
            ids = Select(1, offset + i, name=f"embed_id_{i}")(x_deep)
            pieces.append(Embedding(in_dim, out_dim, init="normal",
                                    name=f"embed_table_{i}")(ids))
        offset += len(info.embed_cols)
        if info.continuous_cols:
            pieces.append(Narrow(1, offset, len(info.continuous_cols),
                                 name="continuous_cols")(x_deep))
        x = pieces[0] if len(pieces) == 1 else Concatenate(axis=-1)(pieces)
        for h in self.hidden_layers:
            x = Dense(h, activation="relu")(x)
        return Dense(self.num_classes, name="deep_out")(x)

    def build_model(self) -> Model:
        info = self.column_info
        logsoftmax = Activation("log_softmax")
        if self.model_type == "wide":
            x_wide = Input((info.wide_dim,), name="x_wide")
            out = Dense(self.num_classes, init="zero",
                        name="wide_linear")(x_wide)
            return Model(x_wide, logsoftmax(out), name="wide")
        if self.model_type == "deep":
            x_deep = Input((info.deep_dim,), name="x_deep")
            return Model(x_deep, logsoftmax(self._build_deep(x_deep)),
                         name="deep")
        x_wide = Input((info.wide_dim,), name="x_wide")
        x_deep = Input((info.deep_dim,), name="x_deep")
        wide_out = Dense(self.num_classes, init="zero",
                         name="wide_linear")(x_wide)
        deep_out = self._build_deep(x_deep)
        out = logsoftmax(Add()([wide_out, deep_out]))
        return Model([x_wide, x_deep], out, name="wide_n_deep")
