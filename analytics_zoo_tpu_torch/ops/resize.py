"""Image resampling with ``jax.image``'s semantics, for the layers and
the ONNX ``Resize`` op that the reference builds on ``jax.image.resize``
and ``jax.image.scale_and_translate``.

Those functions are separable: per resized axis they build a weight
matrix ``(in, out)`` from a kernel (triangle for linear, Keys cubic with
a = -0.5), widened by the inverse scale when downsampling with
``antialias``, each column normalised to sum 1 and zeroed where the
sample falls outside the input, then contract the image with it. Here
the matrices are computed on the host in float32 (the reference's
dtype) from the static shapes, and the contractions run where the image
is, one ``tensordot`` per axis. ``F.interpolate`` neither antialiases
nor uses a = -0.5, so it is not used. Nearest resizing gathers rows at
``floor((i + 0.5) * in / out)``, as ``jax.image.resize`` does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_F32 = np.float32


def _triangle(x):
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1)
    out = np.where(x >= 1, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4)) * x
                   + _F32(2), out)
    return np.where(x >= 2, _F32(0), out).astype(_F32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}
_ALIASES = {"bilinear": "linear", "bicubic": "cubic"}


def _method(method: str) -> str:
    method = _ALIASES.get(method, method)
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    return method


def weight_matrix(in_size: int, out_size: int, scale: float,
                  translation: float, method: str,
                  antialias: bool) -> np.ndarray:
    """The ``(in, out)`` resampling matrix of one axis (float32), as
    ``jax.image``'s ``compute_weight_mat`` builds it."""
    kernel = _KERNELS[_method(method)]
    scale, translation = _F32(scale), _F32(translation)
    inv_scale = _F32(1) / scale
    kernel_scale = max(inv_scale, _F32(1)) if antialias else _F32(1)
    sample_f = ((np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale
                - translation * inv_scale - _F32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]
               ) / kernel_scale
    w = kernel(x.astype(_F32)).astype(_F32)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > _F32(1000) * np.finfo(_F32).eps,
                 w / np.where(total != 0, total, _F32(1)), _F32(0))
    inside = (sample_f >= -0.5) & (sample_f <= _F32(in_size) - _F32(0.5))
    return np.where(inside[None, :], w, _F32(0)).astype(_F32)


def _floating(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype.is_floating_point else x.float()


def scale_and_translate(x: torch.Tensor, shape: Sequence[int],
                        spatial_dims: Sequence[int], scale, translation,
                        method: str = "linear",
                        antialias: bool = True) -> torch.Tensor:
    """``jax.image.scale_and_translate``: ``x`` resampled to ``shape``
    along ``spatial_dims`` (nearest is refused, as there)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError("shape must have length equal to the number of "
                         f"dimensions of x; {shape} vs {tuple(x.shape)}")
    if _method(method) == "nearest":
        raise ValueError("Nearest neighbor resampling is not currently "
                         "supported for scale_and_translate.")
    y = _floating(x)
    for i, d in enumerate(spatial_dims):
        d = d % x.dim()
        w = weight_matrix(x.shape[d], shape[d], float(scale[i]),
                          float(translation[i]), method, antialias)
        wt = torch.from_numpy(w).to(device=y.device, dtype=y.dtype)
        y = torch.movedim(torch.tensordot(y, wt, dims=([d], [0])), -1, d)
    return y


def _resize_nearest(x: torch.Tensor, shape) -> torch.Tensor:
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        offsets = (np.arange(n, dtype=_F32) + _F32(0.5)) * _F32(m) / _F32(n)
        idx = torch.from_numpy(np.floor(offsets).astype(np.int64))
        x = torch.index_select(x, d, idx.to(x.device))
    return x


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize``: every axis whose size changes is resampled
    (scale ``out / in``, no translation)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError("shape must have length equal to the number of "
                         f"dimensions of x; {shape} vs {tuple(x.shape)}")
    if _method(method) == "nearest":
        return _resize_nearest(x, shape)
    dims = [d for d in range(x.dim()) if x.shape[d] != shape[d]]
    scale = [1.0 if shape[d] == 0 else shape[d] / x.shape[d] for d in dims]
    return scale_and_translate(x, shape, dims, scale, [0.0] * len(dims),
                               method, antialias)
