"""Phase-decomposed backward for strided convolutions (port of
``analytics_zoo_tpu/ops/conv_grad.py``).

A strided conv's input gradient is a transposed conv: the usual rule
dilates the cotangent with zeros (``s - 1`` between neighbours) and
slides the whole kernel over it, so (s^2 - 1)/s^2 of its products
multiply inserted zeros. The phase decomposition does the same sums
without them:

- dx: split the kernel into s^2 spatial phases ``w[ph::s, pw::s]``;
  each output phase ``dx[s m + ph]`` is a stride-1 conv of the
  undilated cotangent with the reversed sub-kernel, and the s^2 planes
  interleave back by a reshape (inverse space-to-depth);
- dw: phase-slice the padded input instead, ``dw[s j + ph] = sum_p
  x[s p + s j + ph] dy[p]``: for each phase a dense stride-1 conv of
  ``x[ph::s]`` against the cotangent.

The same sums as the transpose rule, reassociated: the gradients match
to rounding. The reference's phase backward is XLA convs, not a Pallas
kernel, and so is this one: plain PyTorch ``F.conv2d`` s, stride 1
(cuDNN on the card). ``ZOO_TPU_PHASE_BWD=1``/``0`` picks the phase
backward or cuDNN's strided dgrad/wgrad (``aten.convolution_backward``);
unset, the phase backward runs on a CUDA device only once
``PHASE_MEASURED_WIN`` records that it won on the card.

The API is the reference's: NHWC activations, HWIO kernels, per-dim
``(lo, hi)`` paddings (:func:`normalize_padding`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

# calls into this module (tests read them, like ops.conv_bn.launches)
invocations = {"conv2d": 0, "bwd_phase": 0, "bwd_ref": 0}

# The auto default's gate: True only once chip_smoke's conv_grad A/B
# shows the phase backward beating cuDNN's strided backward on every
# strided shape of ResNet-50 in two whole runs. Until then the phase
# path is opt-in (ZOO_TPU_PHASE_BWD=1).
PHASE_MEASURED_WIN = False

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def phase_bwd_enabled(device=None) -> bool:
    """Whether strided convs take the phase backward:
    ``ZOO_TPU_PHASE_BWD`` (``0`` off, else on) when set, otherwise a
    CUDA ``device`` and ``PHASE_MEASURED_WIN``."""
    env = os.environ.get("ZOO_TPU_PHASE_BWD")
    if env is not None:
        return env != "0"
    return PHASE_MEASURED_WIN and device is not None and \
        torch.device(device).type == "cuda"


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo = total // 2
    return lo, total - lo


def normalize_padding(padding, x_spatial: Sequence[int],
                      k_spatial: Sequence[int], stride: Sequence[int]
                      ) -> Tuple[Tuple[int, int], ...]:
    """"SAME"/"VALID"/explicit padding as per-dim ``(lo, hi)`` pairs
    (TF's SAME: ``lo = total // 2``)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return tuple((0, 0) for _ in x_spatial)
        if p == "SAME":
            return tuple(_same_pads(sz, k, s) for sz, k, s in
                         zip(x_spatial, k_spatial, stride))
        raise ValueError(f"padding must be SAME|VALID, got {padding}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _grid(size: int, lo: int, hi: int, k: int, stride: int
          ) -> Tuple[int, int, int]:
    """(padded extent, conv output extent, phase-plane extent M): every
    phase plane is computed at ``M = ceil(padded / s)``."""
    padded = size + lo + hi
    return padded, (padded - k) // stride + 1, -(-padded // stride)


def phase_dx(g: torch.Tensor, w: torch.Tensor,
             x_spatial: Tuple[int, int], stride: Tuple[int, int],
             pads: Pads) -> torch.Tensor:
    """dx (NHWC) of ``conv(x, w, stride, pads)`` from the cotangent
    ``g`` (NHWC) and ``w`` (HWIO), with no dilated operand: s^2 stride-1
    convs of ``g`` with the reversed sub-kernels ``w[ph::s, pw::s]``,
    interleaved. A phase's high padding may be negative (a crop); an
    empty phase (a 1x1 kernel at s 2) is a zero plane."""
    n, ho, wo, cout = g.shape
    kh, kw, cin, _ = w.shape
    sh, sw = stride
    (lo_h, hi_h), (lo_w, hi_w) = pads
    hx, wx = x_spatial
    _, oh, mh = _grid(hx, lo_h, hi_h, kh, sh)
    _, ow, mw = _grid(wx, lo_w, hi_w, kw, sw)
    if (oh, ow) != (ho, wo):
        raise ValueError(f"cotangent extent {(ho, wo)} != conv output "
                         f"{(oh, ow)}")
    gc = g.permute(0, 3, 1, 2)
    planes = g.new_zeros((n, cin, mh, sh, mw, sw))
    for ph in range(sh):
        for pw in range(sw):
            wsub = w[ph::sh, pw::sw]
            kph, kpw = wsub.shape[0], wsub.shape[1]
            if kph == 0 or kpw == 0:
                continue
            # (out = cin, in = cout, kph, kpw), reversed in space
            wk = wsub.flip(0, 1).permute(2, 3, 0, 1)
            gp = F.pad(gc, (kpw - 1, mw - wo, kph - 1, mh - ho))
            planes[:, :, :, ph, :, pw] = F.conv2d(gp, wk)
    dx = planes.reshape(n, cin, mh * sh, mw * sw)
    return dx[:, :, lo_h:lo_h + hx, lo_w:lo_w + wx].permute(0, 2, 3, 1)


def phase_dw(x: torch.Tensor, g: torch.Tensor, k_spatial: Tuple[int, int],
             stride: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """dw (HWIO) of ``conv(x, w, stride, pads)`` from ``x`` and the
    cotangent ``g`` (NHWC), with no dilated operand: the padded input
    phase-sliced by a reshape, and for each kernel phase a dense stride-1
    conv of ``x[ph::s]`` against the cotangent (the batch is the
    contraction). Its products are the model's dw products exactly."""
    n, hx, wx, cin = x.shape
    _, ho, wo, cout = g.shape
    kh, kw = k_spatial
    sh, sw = stride
    (lo_h, hi_h), (lo_w, hi_w) = pads
    _, oh, mh = _grid(hx, lo_h, hi_h, kh, sh)
    _, ow, mw = _grid(wx, lo_w, hi_w, kw, sw)
    if (oh, ow) != (ho, wo):
        raise ValueError(f"cotangent extent {(ho, wo)} != conv output "
                         f"{(oh, ow)}")
    # conv padding, then up to the next stride multiple: the phase slice
    # is a reshape and an index
    xt = F.pad(x, (0, 0, lo_w, mw * sw - wx - lo_w, lo_h,
                   mh * sh - hx - lo_h))
    xt = xt.reshape(n, mh, sh, mw, sw, cin)
    gk = g.permute(3, 0, 1, 2)          # (cout, N, ho, wo): the kernel
    dw = x.new_zeros((kh, kw, cin, cout))
    for ph in range(sh):
        kph = len(range(ph, kh, sh))
        for pw in range(sw):
            kpw = len(range(pw, kw, sw))
            if kph == 0 or kpw == 0:
                continue
            # the samples as channels: (cin, N, Mh, Mw)
            xp = xt[:, :, ph, :, pw, :].permute(3, 0, 1, 2)
            xp = F.pad(xp, (0, wo - 1 + kpw - mw, 0, ho - 1 + kph - mh))
            dw[ph::sh, pw::sw] = F.conv2d(xp, gk).permute(2, 3, 0, 1)
    return dw


def _pad_nchw(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    (lo_h, hi_h), (lo_w, hi_w) = pads
    if lo_h == hi_h == lo_w == hi_w == 0:
        return x
    return F.pad(x, (lo_w, hi_w, lo_h, hi_h))


class _Conv2d(torch.autograd.Function):
    """NHWC/HWIO conv: ``F.conv2d`` forward, the gated backward."""

    @staticmethod
    def forward(ctx, x, w, stride, pads, use_phase):
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, pads, use_phase)
        y = F.conv2d(_pad_nchw(x.permute(0, 3, 1, 2), pads),
                     w.permute(3, 2, 0, 1), stride=stride)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pads, use_phase = ctx.cfg
        g = g.contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if use_phase:
            invocations["bwd_phase"] += 1
            if need_dx:
                dx = phase_dx(g, w, tuple(x.shape[1:3]), stride, pads)
            if need_dw:
                dw = phase_dw(x, g, tuple(w.shape[:2]), stride, pads)
        else:
            invocations["bwd_ref"] += 1
            # cuDNN's strided dgrad and wgrad on the padded input
            (lo_h, _), (lo_w, _) = pads
            h, wd = x.shape[1], x.shape[2]
            gi, gw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), _pad_nchw(x.permute(0, 3, 1, 2),
                                                 pads),
                w.permute(3, 2, 0, 1), None, list(stride), [0, 0], [1, 1],
                False, [0, 0], 1, [need_dx, need_dw, False])
            if need_dx:
                dx = gi[:, :, lo_h:lo_h + h, lo_w:lo_w + wd].permute(
                    0, 2, 3, 1)
            if need_dw:
                dw = gw.permute(2, 3, 1, 0)
        return (None if dx is None else dx.to(x.dtype).contiguous(),
                None if dw is None else dw.to(w.dtype).contiguous(),
                None, None, None)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           stride: Union[int, Tuple[int, int]] = (1, 1), padding="SAME",
           *, phase_bwd: Optional[bool] = None) -> torch.Tensor:
    """NHWC/HWIO 2-D conv (``w`` in x's dtype) whose backward is
    :func:`phase_dx`/:func:`phase_dw` when the phase backward is on
    (``phase_bwd=None`` asks :func:`phase_bwd_enabled` for x's device;
    True/False for an A/B in one process), else cuDNN's strided
    backward. No groups, no kernel dilation."""
    if isinstance(stride, int):
        stride = (stride, stride)
    stride = tuple(int(s) for s in stride)
    pads = normalize_padding(padding, x.shape[1:3], w.shape[:2], stride)
    if phase_bwd is None:
        phase_bwd = phase_bwd_enabled(x.device)
    invocations["conv2d"] += 1
    return _Conv2d.apply(x, w, stride, pads, bool(phase_bwd))
