"""Model loaders (port of ``analytics_zoo_tpu/pipeline/api/net_load.py``):
``Net.load_caffe``, ``Net.load_bigdl``, ``Net.load`` and
``Net.load_torch``.

- :meth:`Net.load` sniffs the file: a pickle is this framework's own
  ``ZooModel.save_model`` file, anything else a BigDL ``.model``;
- :meth:`Net.load_bigdl` reads BigDL/zoo-Keras ``.model`` protobufs
  (:mod:`bigdl_load`), :meth:`Net.load_caffe` a prototxt and caffemodel
  (:mod:`caffe_load`);
- :meth:`Net.load_torch` maps a ``torch.nn.Sequential`` of standard
  modules onto the Keras layers (channels-first, weights transposed to
  their layouts: Dense ``(in, out)``, conv HWIO) and copies its weights
  in; a path is read by torch's weights-only unpickler with an allowlist
  of exactly the modules it maps, arbitrary code only with
  ``ZOO_TPU_TRUST_TORCH_PICKLE=1``.

Every loader returns a compiled ``Sequential`` whose weights are its own
copies on the context's device (the card unless the caller asked for
the CPU). ``Net.load_tf`` and ``Net.load_keras`` need ``TFNet`` and
``tfpark``, not ported yet (ROADMAP A16e): they raise.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Sequence

from analytics_zoo_tpu_torch.common.nncontext import logger


class Net:
    """The model loaders."""

    @staticmethod
    def load_tf(path: str, inputs: Optional[Sequence[str]] = None,
                outputs: Optional[Sequence[str]] = None):
        """The reference bridges TensorFlow graphs through ``TFNet``,
        which the port does not have yet (ROADMAP A16e, with
        ``tfpark``): raises."""
        raise NotImplementedError(
            "Net.load_tf needs TFNet, not ported yet (ROADMAP A16e, "
            "tfpark); export the model to ONNX and use OnnxLoader")

    @staticmethod
    def load_keras(path_or_model, by_name: bool = False):
        """The reference wraps tf.keras models in ``tfpark.KerasModel``,
        which the port does not have yet (ROADMAP A16e): raises."""
        raise NotImplementedError(
            "Net.load_keras needs tfpark's KerasModel, not ported yet "
            "(ROADMAP A16e); export the model to ONNX and use OnnxLoader")

    @staticmethod
    def load_caffe(def_path: str, model_path: Optional[str] = None,
                   input_shape=None):
        """A Caffe prototxt (and caffemodel weights; without them the
        architecture with drawn weights) as a channels-first
        ``Sequential``."""
        from analytics_zoo_tpu_torch.pipeline.api.caffe_load import \
            load_caffe
        return load_caffe(def_path, model_path, input_shape=input_shape)

    @staticmethod
    def load_bigdl(path: str, weight_path: Optional[str] = None,
                   input_shape=None):
        """A BigDL ``.model`` protobuf as a ``Sequential``;
        ``weight_path`` is accepted for the reference's signature (the
        weights are in the file)."""
        del weight_path
        from analytics_zoo_tpu_torch.pipeline.api.bigdl_load import \
            load_bigdl
        return load_bigdl(path, input_shape=input_shape)

    @staticmethod
    def load(path: str, weight_path: Optional[str] = None,
             input_shape=None):
        """An analytics-zoo saved model, by its first byte: a pickle
        (``ZooModel.save_model``) or a BigDL ``.model`` protobuf."""
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"\x80":  # the pickle protocol marker
            from analytics_zoo_tpu_torch.models.common import ZooModel
            return ZooModel.load_model(path)
        return Net.load_bigdl(path, weight_path, input_shape=input_shape)

    @staticmethod
    def load_torch(module_or_path, input_shape) -> Any:
        """A ``torch.nn.Sequential`` (or a path to a saved one) as a
        ``Sequential`` of Keras layers. ``input_shape`` excludes the
        batch and is torch's channels-first layout for images (C, H, W).
        The weights are copied, so the net predicts as the module does
        and fine-tunes on its own."""
        import torch

        module = module_or_path
        if isinstance(module_or_path, str):
            module = _safe_torch_load(module_or_path)
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"expected torch.nn.Module, got "
                            f"{type(module)}")
        zoo_layers, weight_map = _torch_to_zoo(module,
                                               input_shape=input_shape)
        from analytics_zoo_tpu_torch.pipeline.api._import_common import \
            install_weights
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
            Sequential
        net = Sequential()
        for k, lyr in enumerate(zoo_layers):
            if k == 0:
                lyr._given_input_shape = tuple(input_shape)
            net.add(lyr)
        net.compile(optimizer="sgd", loss="mse")
        install_weights(net, list(weight_map.items()), "load_torch")
        return net


_SAFE_TORCH_CLASSES = (
    "Sequential", "Linear", "Conv2d", "MaxPool2d", "AvgPool2d",
    "AdaptiveAvgPool2d", "BatchNorm1d", "BatchNorm2d", "LayerNorm",
    "Embedding", "Flatten", "Dropout", "Identity", "ReLU", "Sigmoid",
    "Tanh", "GELU", "SiLU", "Softmax", "LeakyReLU", "ELU")


def _safe_torch_load(path: str):
    """Load a pickled torch module WITHOUT running arbitrary pickle
    code: ``weights_only=True`` and an allowlist of exactly the
    ``torch.nn`` classes the importer maps. A pickle that needs more is
    loaded only with ``ZOO_TPU_TRUST_TORCH_PICKLE=1``."""
    import torch
    import torch.nn as nn

    safe = [getattr(nn, name) for name in _SAFE_TORCH_CLASSES]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with torch.serialization.safe_globals(safe):
            return torch.load(path, weights_only=True, map_location="cpu")
    except (pickle.UnpicklingError, RuntimeError, ValueError) as e:
        # only unpickling-safety failures reach the trust gate; a
        # missing or corrupt file raises as itself
        if os.environ.get("ZOO_TPU_TRUST_TORCH_PICKLE") == "1":
            logger.warning(
                "load_torch: %s failed the weights-only safety check "
                "(%s); loading with arbitrary pickle execution because "
                "ZOO_TPU_TRUST_TORCH_PICKLE=1 — only do this for "
                "trusted files", path, e)
            return torch.load(path, weights_only=False, map_location="cpu")
        raise RuntimeError(
            f"refusing to unpickle {path!r} with code execution "
            f"(weights-only load failed: {e}); if the file is trusted, "
            "set ZOO_TPU_TRUST_TORCH_PICKLE=1 or pass the live module "
            "object instead of a path") from e


def _flatten_torch(module):
    import torch.nn as nn
    if isinstance(module, nn.Sequential):
        out = []
        for child in module.children():
            out.extend(_flatten_torch(child))
        return out
    return [module]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _np(t):
    """A module tensor as a host array (a copy, wherever it lives)."""
    return t.detach().cpu().numpy().copy()


def _torch_to_zoo(module, input_shape=None):
    """torch modules → (Keras layers, ``(layer, assignments)`` pairs
    resolved to the layers' names after the ``Sequential`` names them).

    Images stay in torch's NCHW layout (``dim_ordering="th"``).
    ``input_shape`` (torch layout, no batch) lets the walk track the
    running shape through the emitted layers, for modules whose mapping
    needs static sizes (an AdaptiveAvgPool2d to any output size, ceil
    mode pooling)."""
    import torch.nn as nn

    from analytics_zoo_tpu_torch.common.utils import ceil_pool_extra
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    zoo_layers = []
    weights = {}
    shape = {"cur": tuple(input_shape) if input_shape else None}

    def emit(layer, assignments=None):
        zoo_layers.append(layer)
        if assignments:
            weights[id(layer)] = assignments
        if shape["cur"] is not None:
            try:
                shape["cur"] = tuple(
                    layer.compute_output_shape(shape["cur"]))
            except Exception as e:
                # stop tracking but keep importing; remember why, so a
                # shape-dependent module can say which layer broke it
                shape["cur"] = None
                shape["lost_at"] = f"{type(layer).__name__}: {e}"
        return layer

    for m in _flatten_torch(module):
        if isinstance(m, nn.Identity):
            continue
        if isinstance(m, nn.Linear):
            asg = {"kernel": _np(m.weight).T}
            if m.bias is not None:
                asg["bias"] = _np(m.bias)
            emit(L.Dense(m.out_features, bias=m.bias is not None), asg)
        elif isinstance(m, nn.Conv2d):
            if m.padding_mode != "zeros":
                raise NotImplementedError(
                    f"Conv2d padding_mode={m.padding_mode!r}; only "
                    "'zeros' imports exactly")
            pad = _pair(m.padding) if not isinstance(m.padding, str) \
                else m.padding
            if pad not in ("same", "valid") and any(pad):
                emit(L.ZeroPadding2D(padding=pad, dim_ordering="th"))
                border = "valid"
            else:
                border = pad if isinstance(pad, str) else "valid"
            # torch (O, I/g, kH, kW) → the grouped HWIO (kH, kW, I/g, O)
            asg = {"kernel": _np(m.weight).transpose(2, 3, 1, 0)}
            if m.bias is not None:
                asg["bias"] = _np(m.bias)
            emit(L.Convolution2D(
                m.out_channels, *_pair(m.kernel_size),
                subsample=_pair(m.stride), border_mode=border,
                dilation=_pair(m.dilation), dim_ordering="th",
                groups=m.groups, bias=m.bias is not None), asg)
        elif isinstance(m, (nn.MaxPool2d, nn.AvgPool2d)):
            ceil_extra = (0, 0)
            if getattr(m, "ceil_mode", False):
                # with the running shape known, ceil mode's windows are
                # floor windows over a -inf extension of the right and
                # bottom padding (torch drops a window that starts in it)
                if shape["cur"] is None or len(shape["cur"]) != 3:
                    raise NotImplementedError(
                        "pooling ceil_mode=True needs a tracked "
                        "running shape (lost at "
                        f"{shape.get('lost_at', 'non-3D input')})")
                kh, kw = _pair(m.kernel_size)
                sh_, sw_ = _pair(m.stride if m.stride is not None
                                 else m.kernel_size)
                ph_, pw_ = _pair(m.padding)
                ceil_extra = tuple(
                    ceil_pool_extra(dim, k, s_, p_, p_)
                    for dim, k, s_, p_ in (
                        (shape["cur"][1], kh, sh_, ph_),
                        (shape["cur"][2], kw, sw_, pw_)))
                if isinstance(m, nn.AvgPool2d) and any(ceil_extra):
                    raise NotImplementedError(
                        "AvgPool2d ceil_mode=True with ceil-extended "
                        "windows (divisor excludes the extension); "
                        "harmless ceil_mode (ceil==floor) imports")
            if getattr(m, "dilation", 1) not in (1, (1, 1)):
                raise NotImplementedError("dilated torch MaxPool2d")
            if isinstance(m, nn.AvgPool2d) and \
                    getattr(m, "divisor_override", None) is not None:
                raise NotImplementedError(
                    "AvgPool2d divisor_override (fixed divisor "
                    "replaces the kernel-area average)")
            pad = _pair(m.padding)
            if any(pad):
                if isinstance(m, nn.AvgPool2d):
                    if not getattr(m, "count_include_pad", True):
                        raise NotImplementedError(
                            "padded torch AvgPool2d with "
                            "count_include_pad=False (per-window "
                            "divisor varies)")
                    # count_include_pad=True: zero pad + valid average
                    emit(L.ZeroPadding2D(padding=pad, dim_ordering="th"))
                else:
                    # torch pads MaxPool with -inf, not zeros
                    emit(L.ZeroPadding2D(
                        padding=((pad[0], pad[0] + ceil_extra[0]),
                                 (pad[1], pad[1] + ceil_extra[1])),
                        dim_ordering="th", value=float("-inf")))
                    ceil_extra = (0, 0)
            if any(ceil_extra):   # ceil windows without base padding
                emit(L.ZeroPadding2D(
                    padding=((0, ceil_extra[0]), (0, ceil_extra[1])),
                    dim_ordering="th", value=float("-inf")))
            cls = (L.MaxPooling2D if isinstance(m, nn.MaxPool2d)
                   else L.AveragePooling2D)
            stride = m.stride if m.stride is not None else m.kernel_size
            emit(cls(pool_size=_pair(m.kernel_size),
                     strides=_pair(stride), dim_ordering="th"))
        elif isinstance(m, nn.AdaptiveAvgPool2d):
            out_hw = (_pair(m.output_size)
                      if m.output_size is not None else (None, None))
            if None in out_hw:
                raise NotImplementedError(
                    "AdaptiveAvgPool2d with a None output dim "
                    "(keep-input-size) is not supported")
            if out_hw == (1, 1):
                emit(L.GlobalAveragePooling2D(dim_ordering="th"))
            elif shape["cur"] is not None and len(shape["cur"]) == 3:
                in_h, in_w = shape["cur"][1], shape["cur"][2]
                if in_h % out_hw[0] or in_w % out_hw[1]:
                    raise NotImplementedError(
                        f"AdaptiveAvgPool2d {out_hw} from "
                        f"({in_h},{in_w}): non-divisible adaptive "
                        "windows (torch uses variable window sizes)")
                kh, kw = in_h // out_hw[0], in_w // out_hw[1]
                emit(L.AveragePooling2D(pool_size=(kh, kw),
                                        strides=(kh, kw),
                                        dim_ordering="th"))
            else:
                raise NotImplementedError(
                    "AdaptiveAvgPool2d with output_size>1 needs the "
                    "running shape, which was lost at "
                    f"{shape.get('lost_at', 'a non-3D input_shape')}")
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            if m.running_mean is None:
                raise NotImplementedError(
                    "BatchNorm with track_running_stats=False (eval "
                    "semantics differ: batch stats vs moving stats)")
            affine = m.weight is not None
            asg = {"_state": {"moving_mean": _np(m.running_mean),
                              "moving_var": _np(m.running_var)}}
            if affine:
                asg["gamma"] = _np(m.weight)
                asg["beta"] = _np(m.bias)
            emit(L.BatchNormalization(
                epsilon=m.eps, momentum=1.0 - (m.momentum or 0.1),
                dim_ordering="th" if isinstance(m, nn.BatchNorm2d)
                else "tf", scale=affine, center=affine), asg)
        elif isinstance(m, nn.LayerNorm):
            if m.weight is None:
                raise NotImplementedError(
                    "LayerNorm with elementwise_affine=False")
            emit(L.LayerNormalization(epsilon=m.eps),
                 {"gamma": _np(m.weight), "beta": _np(m.bias)})
        elif isinstance(m, nn.Embedding):
            emit(L.Embedding(m.num_embeddings, m.embedding_dim),
                 {"embeddings": _np(m.weight)})
        elif isinstance(m, nn.Flatten):
            emit(L.Flatten())
        elif isinstance(m, nn.Dropout):
            emit(L.Dropout(m.p))
        elif isinstance(m, (nn.ReLU, nn.Sigmoid, nn.Tanh, nn.GELU, nn.SiLU,
                            nn.Softmax)):
            emit(L.Activation({nn.ReLU: "relu", nn.Sigmoid: "sigmoid",
                               nn.Tanh: "tanh", nn.GELU: "gelu",
                               nn.SiLU: "silu", nn.Softmax: "softmax"}[
                type(m)]))
        elif isinstance(m, nn.LeakyReLU):
            emit(L.LeakyReLU(alpha=m.negative_slope))
        elif isinstance(m, nn.ELU):
            emit(L.ELU(alpha=m.alpha))
        else:
            raise NotImplementedError(
                f"no zoo mapping for torch module {type(m).__name__}; "
                "export to ONNX and use OnnxLoader for full coverage")

    # the Sequential names the layers when they are added: resolve the
    # assignments to names then
    return zoo_layers, _LateNameMap(zoo_layers, weights)


class _LateNameMap:
    """Layer-id-keyed weight assignments, read by layer NAME: the
    ``Sequential`` names the layers at ``add`` time, after they are
    made."""

    def __init__(self, layers, by_id):
        self._layers = layers
        self._by_id = by_id

    def items(self):
        for lyr in self._layers:
            if id(lyr) in self._by_id:
                yield lyr.name, self._by_id[id(lyr)]

    def __len__(self):
        return len(self._by_id)
