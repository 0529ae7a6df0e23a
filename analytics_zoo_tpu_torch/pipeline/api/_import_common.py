"""Shared machinery of the external-model importers (BigDL, Caffe,
torch): build a ``Sequential`` from converted layers and install the
saved weights after shape inference (port of
``analytics_zoo_tpu/pipeline/api/_import_common.py``)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.nncontext import logger


def assign_param(sub: dict, key: str, value, name: str) -> None:
    """Shape-checked assignment of a saved weight into a layer's tree."""
    if key not in sub:
        raise KeyError(f"imported layer {name} has no param {key!r}")
    if tuple(sub[key].shape) != tuple(np.shape(value)):
        raise ValueError(
            f"{name}.{key}: saved shape {tuple(np.shape(value))} does "
            f"not match model {tuple(sub[key].shape)}")
    sub[key] = np.array(value, np.float32)


def install_weights(net, assignments, origin: str) -> int:
    """Install ``assignments`` (``(layer name, {param: array, "_state":
    {...}})`` pairs) into the compiled ``net`` on its context's device,
    each shape-checked; returns the number of tensors assigned. The net
    owns copies: nothing of the source's storage is kept."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.parallel.mesh import place_inference_params
    est = net.estimator
    est._ensure_initialized()
    params = params_to_numpy(net)
    n_assigned = 0
    for name, ws in assignments:
        sub = params[name]
        for key, value in ws.items():
            if key == "_state":
                for sk, sv in value.items():
                    assign_param(sub["_state"], sk, sv, name)
                    n_assigned += 1
            else:
                assign_param(sub, key, value, name)
                n_assigned += 1
    net.load_params(place_inference_params(params, [est.ctx.device]),
                    device=est.ctx.device)
    # the optimizer's moments belonged to the drawn weights
    est.opt_state = None
    logger.info("%s: imported %d layers, %d weight tensors", origin,
                len(net.layers), n_assigned)
    return n_assigned


def build_sequential(converted: "Sequence[Tuple[object, Dict]]",
                     input_shape: Tuple[int, ...], origin: str):
    """``(layer, weights)`` pairs → a compiled ``Sequential`` with the
    saved weights installed on the context's device (one device: the
    port has no sharded placement, ROADMAP A14)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

    net = Sequential()
    for k, (lyr, _) in enumerate(converted):
        if k == 0:
            lyr._given_input_shape = tuple(input_shape)
        net.add(lyr)
    net.compile(optimizer="sgd", loss="mse")
    install_weights(net, [(lyr.name, ws) for lyr, ws in converted if ws],
                    origin)
    return net
