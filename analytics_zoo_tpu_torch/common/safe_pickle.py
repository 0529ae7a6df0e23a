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
is admitted."""

from __future__ import annotations

import io
import pickle
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


def checked_load(file: "BinaryIO | str") -> Any:
    """``pickle.load`` through the whitelist."""
    if isinstance(file, str):
        with open(file, "rb") as f:
            return CheckedUnpickler(f).load()
    return CheckedUnpickler(file).load()


def checked_loads(data: bytes) -> Any:
    return CheckedUnpickler(io.BytesIO(data)).load()
