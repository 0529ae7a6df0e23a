"""Post-training int8 quantization for serving (port of
``analytics_zoo_tpu/pipeline/inference/quantize.py``).

The reference's scheme, unchanged:

- weights: symmetric int8 per output channel (``w ≈ w_q · s_w``),
  computed on the host in numpy exactly as the reference does;
- activations: one symmetric int8 scale per tensor, the max-|x| each
  quantized layer sees over the calibration batch, divided by 127
  (the calibration forward runs on the host, so the scales do not
  depend on the device's f32 rounding);
- the product accumulates in int32, followed by one rescale
  (``s_x · s_w``) to f32, then bias and activation.

Dense layers are quantized by default; ``Convolution2D`` only when
``quantize_types`` names it. The reference computes the product with
``lax.dot_general`` / ``conv_general_dilated`` outside any Pallas
kernel; here :func:`int8_matmul` is cuBLASLt's int8 product
(``torch._int_mm``) on the card and an int32 matmul on the CPU. The
convolution goes through the same product on gathered windows
(:func:`_im2col`). Integer arithmetic is exact, so the int32
accumulators equal the reference's bit for bit on either device. There
is no float route: a shape the card's product cannot take raises.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.nncontext import logger
from analytics_zoo_tpu_torch.ops.conv_bn import tf_same_pads

__all__ = ["QuantizedModel", "int8_matmul"]

# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17


def _quantize_per_channel(w: np.ndarray, channel_axis: int):
    """Symmetric per-channel int8: (w_q int8, f32 scale with singleton
    dims except ``channel_axis``)."""
    reduce_axes = tuple(a for a in range(w.ndim) if a != channel_axis)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w_q, scale


def _quantize_activation(x: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """``clip(round(x / scale))`` to int8 (round half to even, as
    ``jnp.round``). ``scale`` is a 0-d tensor on ``x``'s device: a
    Python number as divisor would let CUDA multiply by its reciprocal,
    which can move a value across a rounding edge."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 ``(M, K)`` and ``(K, N)`` into int32 ``(M, N)``.
    On the card: ``torch._int_mm`` with ``a`` padded by zero rows to
    more than 16 rows and K, N padded by zero columns to multiples of 8
    (zeros add nothing: the result is exact). On the CPU: an int32
    matmul."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_INT_MM_MIN_ROWS, m), _ceil8(k), _ceil8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _im2col(x: torch.Tensor, layer) -> torch.Tensor:
    """NHWC int8 ``x`` as ``(N, OH, OW, KH·KW·C)`` windows of the
    layer's convolution (TF padding with zeros, the kernel's HWI
    order), so the HWIO kernel reshaped to ``(KH·KW·C, O)`` makes the
    convolution one product."""
    kh, kw = layer.kernel_size
    sh, sw = layer.subsample
    _, h, w, _ = x.shape
    if layer.border_mode == "same":
        pt, pb, _ = tf_same_pads(h, kh, sh)
        pl, pr, _ = tf_same_pads(w, kw, sw)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw) // sw + 1
    cols = [x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


class QuantizedModel:
    """A Sequential served with its Dense (and opted-in Convolution2D)
    layers in int8, calibrated on ``calibration_inputs`` (the
    reference's quantized ``InferenceModel`` load path). The net keeps
    its float params; ``plan`` holds one entry per layer, the int8
    ones with their tables on the net's device."""

    def __init__(self, model, calibration_inputs,
                 quantize_types=("Dense",)):
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
            Sequential
        if not isinstance(model, Sequential):
            raise TypeError(
                "quantization requires a Sequential model (got "
                f"{type(model).__name__})")
        self.model = model
        self.device = model.device
        self.plan: List[Dict[str, Any]] = []
        self._calibrate(calibration_inputs, tuple(quantize_types))

    # -- calibration --------------------------------------------------------
    def _calibrate(self, calibration_inputs, quantize_types) -> None:
        # the float forward that sets the activation scales runs on the
        # host, on a copy of the params: a scale is max|x| / 127, and
        # the card's f32 products round otherwise than the CPU's, which
        # would move a later layer's scale by an ulp and flip int8
        # values at rounding edges. Host scales make the int8 model
        # serve the same bits on the card as on the CPU.
        params = _to_host(self.model.params())
        x = torch.from_numpy(np.asarray(calibration_inputs, np.float32))
        n_q = 0
        with torch.inference_mode():
            for layer in self.model.layers:
                p = params[layer.name]
                entry: Dict[str, Any] = {"layer": layer, "mode": "float"}
                if type(layer).__name__ in quantize_types and "kernel" in p:
                    kernel = p["kernel"].numpy()
                    # Dense (in, out), conv HWIO: the output channel is
                    # the last axis
                    w_q, w_scale = _quantize_per_channel(
                        kernel, kernel.ndim - 1)
                    a_scale = float(x.abs().max().item()) / 127.0
                    a_scale = np.float32(a_scale or 1.0)
                    w_scale = w_scale.reshape(-1)
                    entry.update(
                        mode="int8", w_q=w_q, w_scale=w_scale,
                        a_scale=a_scale,
                        a_scale_t=torch.tensor(a_scale,
                                               device=self.device),
                        w_mat=torch.from_numpy(w_q.reshape(
                            -1, w_q.shape[-1])).to(self.device),
                        scale=torch.from_numpy(a_scale * w_scale
                                               ).to(self.device))
                    n_q += 1
                self.plan.append(entry)
                x = layer.call(p, x, training=False)
        logger.info("quantize: %d/%d layers int8", n_q,
                    len(self.model.layers))

    # -- forward ------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = self.model.params()
        for entry in self.plan:
            layer = entry["layer"]
            p = params[layer.name]
            if entry["mode"] == "float":
                x = layer.call(p, x, training=False)
            else:
                x = self._int8_layer(entry, layer, p, x)
        return x

    def quantize_input(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Plan entry ``i``'s input ``x`` quantized with its scale."""
        return _quantize_activation(x, self.plan[i]["a_scale_t"])

    def accumulator(self, i: int, x_q: torch.Tensor) -> torch.Tensor:
        """The int32 accumulator of plan entry ``i`` (an int8 layer)
        for its quantized input ``x_q``."""
        return self._accumulate(self.plan[i], x_q)

    @staticmethod
    def _accumulate(entry, x_q: torch.Tensor) -> torch.Tensor:
        layer = entry["layer"]
        if type(layer).__name__ == "Dense":
            lead = x_q.shape[:-1]
            acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]),
                              entry["w_mat"])
            return acc.reshape(*lead, acc.shape[-1])
        cols = _im2col(x_q, layer)
        n, oh, ow, kk = cols.shape
        acc = int8_matmul(cols.reshape(-1, kk), entry["w_mat"])
        return acc.reshape(n, oh, ow, -1)

    def _int8_layer(self, entry, layer, p, x):
        acc = self._accumulate(
            entry, _quantize_activation(x, entry["a_scale_t"]))
        y = acc.to(torch.float32) * entry["scale"]
        if layer.use_bias:
            y = y + p["bias"]
        if layer.activation is not None:
            y = layer.activation(y)
        return y

    # -- introspection ------------------------------------------------------
    @property
    def n_quantized(self) -> int:
        return sum(1 for e in self.plan if e["mode"] == "int8")

    def size_bytes(self) -> "tuple[int, int]":
        """(float_bytes, int8_bytes) of the quantized kernels: the
        reference's 4x model-size-reduction metric."""
        f = q = 0
        for e in self.plan:
            if e["mode"] == "int8":
                f += e["w_q"].size * 4
                q += e["w_q"].size + e["w_scale"].size * 4
        return f, q
