"""``Add`` (port of the sum mode of
``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``)."""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape, ShapeLike)


class Add(KerasLayer):
    """Elementwise sum of two or more inputs."""

    def call(self, params, inputs, *, training=False, rng=None):
        xs = list(inputs)
        if len(xs) < 2:
            raise ValueError(f"{self.name}: Add needs >= 2 inputs")
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def compute_output_shape(self, input_shape: ShapeLike) -> Shape:
        return tuple(input_shape[0])
