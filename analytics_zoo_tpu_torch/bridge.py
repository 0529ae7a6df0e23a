"""Weight bridge between the JAX package's param pytrees and the port.

A JAX param tree, brought to the host with ``jax.device_get``, is a
nested dict of numpy arrays keyed by layer name. The port keeps the
same names and layouts, so the bridge is a copy in both directions:
``params_to_numpy(params_from_numpy(tree))`` gives back ``tree`` bit
for bit. Optimizer state crosses too, both ways: an Estimator's and an
optax state's moments come out in one layout, and that layout loads
back into an Estimator. So does a checkpoint (:func:`checkpoint_from_
reference`, :func:`checkpoint_to_reference`): the two packages write
one format, ``{"params", "opt_state", "step"}``, whose ``opt_state`` is
an optax state tree in the reference's files and the same tree's leaves
in the port's. So does a paged KV cache (pages, scales, table, lengths),
so both packages can start from one cache state. This module imports no
JAX.
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


def _fill(mask, leaves):
    """The True entries of a bool tree, filled in order from ``leaves``;
    subtrees left empty are dropped."""
    out = {}
    for k, v in mask.items():
        if isinstance(v, dict):
            sub = _fill(v, leaves)
            if sub:
                out[k] = sub
        elif v:
            out[k] = next(leaves)
    return out


def opt_state_to_numpy(estimator) -> dict:
    """An Estimator's optimizer state as host arrays: ``count`` and each
    moment (``trace`` for SGD with momentum, ``mu`` and ``nu`` for Adam)
    as a tree shaped like the trainable part of the param tree."""
    model = estimator.model
    mask = model.trainable_mask(model.params())
    out = {}
    for key, val in estimator.opt_state.items():
        out[key] = (np.asarray(val) if key == "count" else
                    params_to_numpy(_fill(mask, iter(val))))
    return out


def _leaves_in_mask_order(mask, tree):
    """The leaves of ``tree`` at the True entries of ``mask``, in the
    mask's order."""
    out = []
    for k, v in mask.items():
        if isinstance(v, dict):
            out += _leaves_in_mask_order(v, tree.get(k, {}))
        elif v:
            out.append(tree[k])
    return out


def opt_state_from_numpy(estimator, state: dict) -> None:
    """Load :func:`opt_state_to_numpy`'s layout (host arrays, or an
    optax state's moments from :func:`optax_state_to_numpy`) into an
    initialized Estimator's optimizer state, on the net's device."""
    model = estimator.model
    mask = model.trainable_mask(model.params())
    dev = model.device
    for key, val in state.items():
        if key == "count":
            estimator.opt_state["count"] = int(np.asarray(val))
            continue
        dst = estimator.opt_state[key]
        src = _leaves_in_mask_order(mask, val)
        if len(src) != len(dst):
            raise ValueError(f"{key}: {len(src)} leaves for {len(dst)} "
                             "trainable params")
        for d, s_ in zip(dst, src):
            d.copy_(torch.as_tensor(np.asarray(s_)).to(dev, d.dtype))


def _moments(tree):
    """A moment tree with the leaves an optax mask left out (its
    ``MaskedNode``, an empty named tuple) and emptied subtrees dropped."""
    if isinstance(tree, dict):
        kept = {k: _moments(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == ():
        return None
    return np.asarray(tree)


def optax_state_to_numpy(state) -> dict:
    """The moments of an optax optimizer state brought to the host with
    ``jax.device_get``, in :func:`opt_state_to_numpy`'s layout: the
    first ``trace``, ``mu``, ``nu`` and ``count`` fields found, with the
    masked-out leaves dropped. Named tuples are walked by field name, so
    this imports neither JAX nor optax."""
    out = {}

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                v = getattr(node, f)
                if f in ("trace", "mu", "nu", "count") and f not in out:
                    out[f] = _moments(v)
                else:
                    walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(state)
    return out


def optax_leaves(node) -> list:
    """The leaves of an optimizer state as ``jax.tree_util.tree_leaves``
    flattens it: dicts by sorted key, tuples (optax's named tuples) and
    lists in order, and None and empty tuples (``EmptyState``,
    ``MaskedNode``) without a leaf. A port checkpoint's state is already
    this flat list."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in optax_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [leaf for v in node for leaf in optax_leaves(v)]
    return [node]


def _unflatten_like(like, leaves):
    """``like``'s structure (dicts, named tuples, tuples, lists) with its
    leaves taken in order from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten_like(v, leaves) for v in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return next(leaves)


def checkpoint_from_reference(state: dict) -> dict:
    """A checkpoint dict of the JAX package's Estimator (as unpickled,
    its optax state's classes real or stand-ins) → the port's layout:
    the same params and step, the state's leaves as a flat list of host
    arrays in the reference's order."""
    return {"params": state["params"],
            "opt_state": [np.asarray(a) for a in
                          optax_leaves(state["opt_state"])],
            "step": int(state["step"])}


def checkpoint_to_reference(state: dict, opt_state_like) -> dict:
    """A port checkpoint dict → the reference's layout, its optimizer
    state rebuilt in the structure of ``opt_state_like`` (the reference
    Estimator's state for the same model and optimizer, e.g. after
    ``jax.device_get``). The leaf counts must agree."""
    leaves = list(state["opt_state"])
    want = len(optax_leaves(opt_state_like))
    if len(leaves) != want:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, the "
                         f"reference's structure {want}")
    return {"params": state["params"],
            "opt_state": _unflatten_like(opt_state_like, iter(leaves)),
            "step": int(state["step"])}


_CACHE_FIELDS = ("k_pages", "v_pages", "page_table", "seq_lens", "k_scales",
                 "v_scales")


def _host_to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: bits as int16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def kv_cache_from_numpy(cache, device="cpu"):
    """A paged KV cache brought to the host (the JAX package's
    ``PagedKVCache`` after ``jax.device_get``, any object with its
    fields, or a dict of them) → the port's ``PagedKVCache`` of tensors
    on ``device``, dtypes kept (bf16 pages included)."""
    from analytics_zoo_tpu_torch.ops.kv_cache import PagedKVCache
    get = cache.get if isinstance(cache, dict) else \
        (lambda f: getattr(cache, f, None))
    return PagedKVCache(*(None if get(f) is None else
                          _host_to_tensor(get(f), device)
                          for f in _CACHE_FIELDS))


def kv_cache_to_numpy(cache) -> dict:
    """The port's ``PagedKVCache`` → dict of host arrays by field name
    (bf16 pages widened to f32; absent scales as None)."""
    out = {}
    for f in _CACHE_FIELDS:
        t = getattr(cache, f)
        if t is not None and t.dtype == torch.bfloat16:
            t = t.float()
        out[f] = None if t is None else t.detach().cpu().numpy().copy()
    return out
