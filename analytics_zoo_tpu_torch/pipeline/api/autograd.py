"""Function layers (port of the ``_OpLayer`` and ``Lambda`` part of
``analytics_zoo_tpu/pipeline/api/autograd.py``; the autograd operators
on graph variables wait)."""

from __future__ import annotations

from typing import Callable

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, as_shape, unique_name)


class _OpLayer(KerasLayer):
    """A layer wrapping a function of its input tensors."""

    def __init__(self, fn: Callable, shape_fn: Callable, name=None):
        super().__init__(name=name or unique_name("op"))
        self.fn = fn
        self.shape_fn = shape_fn

    def call(self, params, inputs, *, training=False, rng=None):
        return self.fn(inputs)

    def compute_output_shape(self, input_shape):
        return self.shape_fn(input_shape)


class Lambda(_OpLayer):
    """User function → layer. The function takes and returns tensors
    (the reference's takes jnp arrays), and autograd differentiates it.
    """

    def __init__(self, function: Callable, output_shape=None,
                 input_shape=None, name=None):
        shape_fn = ((lambda s: as_shape(output_shape))
                    if output_shape is not None else (lambda s: s))
        super().__init__(function, shape_fn,
                         name=name or unique_name("lambda"))
        self._given_input_shape = (None if input_shape is None
                                   else as_shape(input_shape))
