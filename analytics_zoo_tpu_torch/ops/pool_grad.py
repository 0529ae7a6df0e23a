"""2-D max pooling whose backward splits the cotangent equally among
tied maxima (port of ``analytics_zoo_tpu/ops/pool_grad.py``).

``torch.nn.functional.max_pool2d``'s backward routes a window's whole
cotangent to one index. The reference's mask backward instead masks
each of the k*k strided window patches of the padded input against the
pooled output (``patch == y``) and divides the cotangent by the tie
count. Ties have measure zero for continuous inputs, but not in bf16,
where a ReLU output of many equal positive values is common enough to
change gradients; so the port keeps the reference's rule. Plain
PyTorch on every device (the reference has no Pallas kernel here).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops.conv_bn import tf_same_pads


def _patch(xt: torch.Tensor, dh: int, dw: int, strides, out_hw):
    """Window offset (dh, dw) of every output position: ``xt[:, s*p+dh,
    s*q+dw]`` for NHWC ``xt``."""
    sh, sw = strides
    ho, wo = out_hw
    return xt[:, dh:dh + (ho - 1) * sh + 1:sh, dw:dw + (wo - 1) * sw + 1:sw]


class _MaxPool2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        (lo_h, hi_h), (lo_w, hi_w) = pads
        xt = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
        y = F.max_pool2d(xt.permute(0, 3, 1, 2), window, strides)
        y = y.permute(0, 2, 3, 1).contiguous()
        ctx.save_for_backward(x, y)
        ctx.cfg = (window, strides, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, strides, pads = ctx.cfg
        (lo_h, hi_h), (lo_w, hi_w) = pads
        hx, wx = x.shape[1], x.shape[2]
        out_hw = (y.shape[1], y.shape[2])
        # -inf padding never ties with a window max (every SAME window
        # overlaps at least one real element)
        xt = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
        offsets = [(dh, dw) for dh in range(window[0])
                   for dw in range(window[1])]
        masks = [(_patch(xt, dh, dw, strides, out_hw) == y).float()
                 for dh, dw in offsets]
        count = sum(masks)                # >= 1: the max is in-window
        gn = g.float() / count            # equal split among ties
        dxt = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
        for (dh, dw), mask in zip(offsets, masks):
            _patch(dxt, dh, dw, strides, out_hw).add_(mask * gn)
        dx = dxt[:, lo_h:lo_h + hx, lo_w:lo_w + wx]
        return dx.to(x.dtype), None, None, None


def maxpool2d(x: torch.Tensor, pool_size: Tuple[int, int],
              strides: Tuple[int, int], border_mode: str) -> torch.Tensor:
    """NHWC 2-D max pool padded with -inf for ``border_mode`` "same" or
    "valid"; its backward splits the cotangent equally among ties."""
    window = tuple(int(p) for p in pool_size)
    strides = tuple(int(s) for s in strides)
    pads = ((0, 0), (0, 0)) if border_mode == "valid" else tuple(
        tf_same_pads(n, k, s)[:2]
        for n, k, s in zip(x.shape[1:3], window, strides))
    return _MaxPool2d.apply(x, window, strides, pads)
