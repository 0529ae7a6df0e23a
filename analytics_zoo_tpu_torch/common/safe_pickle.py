"""Class-whitelist deserialization for saved models (the port's copy of
``analytics_zoo_tpu/common/safe_pickle.py``; the reference's analog is
``CheckedObjectInputStream.scala``). A restricted
``Unpickler.find_class`` admits only the numeric and container types a
saved param tree or hyperparameter dict holds, and classes of the
port's own subtrees, so a tampered file cannot run code on load. The
port's saved files hold numpy trees and lists. A checkpoint of the JAX
package's Estimator names optax's state classes (named tuples such as
``optax._src.transform.ScaleByAdamState``): they are never imported, but
read as local tuple stand-ins (:func:`state_tuple`) that keep their
fields' order, which is all a resume needs. No class of the JAX package
is admitted.

A net's architecture is saved without its tensors (``NNModel.save``):
:class:`ArchPickler` writes each layer's ``ParamTree`` and a compiled
net's Estimator as tags, and a function as its key in the port's
activation or initializer registry. Only :func:`load_architecture`
reads such a file: its :class:`ArchUnpickler` resolves exactly those
tags, and :func:`checked_load`, which reads checkpoints, refuses every
persistent id."""

from __future__ import annotations

import io
import pickle
import types
from typing import Any, BinaryIO

_SAFE_MODULE_PREFIXES = (
    # CLASSES only (enforced in find_class): a function admitted by
    # prefix would be a REDUCE gadget. Scoped to the subtrees whose
    # classes appear in saved files (layers, models, ops, features);
    # every entry ends with "." and `module == p[:-1]` below admits the
    # package or module itself
    "analytics_zoo_tpu_torch.pipeline.api.",
    "analytics_zoo_tpu_torch.feature.",
    "analytics_zoo_tpu_torch.models.",
    "analytics_zoo_tpu_torch.ops.",
)

_SAFE_CLASSES = {
    ("builtins", "dict"), ("builtins", "list"), ("builtins", "tuple"),
    ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "int"), ("builtins", "float"), ("builtins", "str"),
    ("builtins", "bytes"), ("builtins", "bool"), ("builtins", "complex"),
    ("builtins", "bytearray"), ("builtins", "slice"),
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}

# the containers of a net's layers, admitted in ArchPickler's files only
_ARCH_CLASSES = {
    ("torch.nn.modules.container", "ModuleDict"),
    ("torch.nn.modules.container", "ModuleList"),
}

# the optimizer libraries whose state classes a reference checkpoint
# names; each is read as a tuple (its named-tuple fields in order)
_STATE_MODULE_PREFIXES = ("optax", "chex")
_stand_ins: "dict[tuple, type]" = {}


class UnsafePickleError(pickle.UnpicklingError):
    pass


def state_tuple(module: str, name: str) -> type:
    """The stand-in for the named tuple ``module.name``: a ``tuple``
    subclass built from positional fields, as pickle rebuilds a named
    tuple (``cls.__new__(cls, *fields)``)."""
    key = (module, name)
    cls = _stand_ins.get(key)
    if cls is None:
        cls = type(name, (tuple,), {
            "__new__": lambda c, *fields: tuple.__new__(c, fields),
            "__module__": __name__,
            "__qualname__": f"state_tuple[{module}.{name}]",
            "__repr__": lambda self: f"{name}{tuple.__repr__(self)}"})
        _stand_ins[key] = cls
    return cls


class CheckedUnpickler(pickle.Unpickler):
    """An unpickler that admits only the whitelist."""

    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE_CLASSES:
            return super().find_class(module, name)
        if module.split(".", 1)[0] in _STATE_MODULE_PREFIXES:
            return state_tuple(module, name)
        if module.startswith("numpy") and name in ("ndarray", "dtype"):
            return super().find_class(module, name)
        if any(module == p[:-1] or module.startswith(p)
               for p in _SAFE_MODULE_PREFIXES):
            obj = super().find_class(module, name)
            if not isinstance(obj, type):
                raise UnsafePickleError(
                    f"refusing to deserialize {module}.{name}: only "
                    "classes are admitted by prefix (functions are "
                    "REDUCE code-execution gadgets)")
            return obj
        raise UnsafePickleError(
            f"refusing to deserialize {module}.{name}: not in the "
            "checkpoint class whitelist (tampered or foreign file?)")


class ArchPickler(pickle.Pickler):
    """Pickles a net without its tensors: a ``ParamTree`` and an
    Estimator are written as tags, and a function as its key in one of
    the registries of :func:`_function_registries` (a layer's activation
    or initializer). A tensor outside a ``ParamTree``, a lambda or any
    other function raises ``ValueError``: :func:`load_architecture`
    could not read it back."""

    def persistent_id(self, obj):
        import torch

        from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
            ParamTree
        from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
        if isinstance(obj, ParamTree):
            return ("params",)
        if isinstance(obj, Estimator):
            return ("estimator",)
        if isinstance(obj, torch.Tensor):
            raise ValueError("a tensor outside a layer's params: the "
                             "architecture cannot be saved without it")
        if not isinstance(obj, (types.FunctionType,
                                types.BuiltinFunctionType)):
            return None
        for kind, registry in _function_registries().items():
            for key, fn in registry.items():
                if fn is obj:
                    return ("fn", kind, key)
        if isinstance(obj, types.FunctionType) or getattr(
                torch._C._VariableFunctions, obj.__name__, None) is obj:
            raise ValueError(
                f"cannot save the function {obj.__module__}."
                f"{obj.__qualname__}: only the activations and "
                "initializers of the port's registries are saved, by name")
        return None


class ArchUnpickler(CheckedUnpickler):
    """:class:`CheckedUnpickler` that also reads :class:`ArchPickler`'s
    tags: a layer's params and an Estimator as None (the params travel
    beside the architecture; ``NNModel.load`` compiles the net again), a
    function by its key in :func:`_function_registries` and nothing
    else. Only
    :func:`load_architecture` uses it: every other load refuses
    persistent ids and the containers of :data:`_ARCH_CLASSES`."""

    def find_class(self, module: str, name: str):
        if (module, name) in _ARCH_CLASSES:
            return pickle.Unpickler.find_class(self, module, name)
        return super().find_class(module, name)

    def persistent_load(self, pid):
        if pid in (("params",), ("estimator",)):
            return None
        if isinstance(pid, tuple) and len(pid) == 3 and pid[0] == "fn":
            registry = _function_registries().get(pid[1], {})
            if isinstance(pid[2], str) and pid[2] in registry:
                return registry[pid[2]]
        raise UnsafePickleError(f"refusing the persistent id {pid!r}")


def _function_registries() -> "dict[str, dict]":
    """The functions a saved architecture may name, by registry and
    key: the activations and initializers that layers keep."""
    from analytics_zoo_tpu_torch.ops import activations, initializers
    return {"activation": activations._REGISTRY,
            "initializer": initializers._REGISTRY}


def restore_architecture(net):
    """Clear the places of :class:`ArchPickler`'s ``ParamTree`` tags in a
    net read by :func:`load_architecture`, so that ``load_params``
    installs its weights."""
    for m in net.modules():
        if "weights" in m._modules and m._modules["weights"] is None:
            del m._modules["weights"]
    return net


def load_architecture(file: "BinaryIO | str") -> Any:
    """Read an :class:`ArchPickler` file through the whitelist and the
    tags of :class:`ArchUnpickler`; :func:`restore_architecture` then
    makes its net whole."""
    if isinstance(file, str):
        with open(file, "rb") as f:
            return ArchUnpickler(f).load()
    return ArchUnpickler(file).load()


def checked_load(file: "BinaryIO | str") -> Any:
    """``pickle.load`` through the whitelist."""
    if isinstance(file, str):
        with open(file, "rb") as f:
            return CheckedUnpickler(f).load()
    return CheckedUnpickler(file).load()


def checked_loads(data: bytes) -> Any:
    return CheckedUnpickler(io.BytesIO(data)).load()
