"""Weight bridge between the JAX package's param pytrees and the port.

A JAX param tree, brought to the host with ``jax.device_get``, is a
nested dict of numpy arrays keyed by layer name. The port keeps the
same names and layouts, so the bridge is a copy in both directions:
``params_to_numpy(params_from_numpy(tree))`` gives back ``tree`` bit
for bit. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dict of host arrays (or tensors) → same dict of tensors on
    ``device``, dtypes kept. Host arrays are copied; a tensor already on
    ``device`` is shared, not copied."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(model_or_tree):
    """A net's param tree (or a tree of tensors) → nested dict of host
    arrays, the layout ``jax.device_get`` gives."""
    if isinstance(model_or_tree, torch.nn.Module):
        model_or_tree = model_or_tree.params()
    if isinstance(model_or_tree, dict):
        return {k: params_to_numpy(v) for k, v in model_or_tree.items()}
    return model_or_tree.detach().cpu().numpy().copy()
