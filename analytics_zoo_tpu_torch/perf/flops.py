"""The train step's product FLOPs, counted on the step itself (port of
``analytics_zoo_tpu/perf/flops.py``).

The reference parses the HLO text of its lowered train step and sums
every convolution and dot. The port has no HLO, so it counts the same
products while a step runs: :func:`count` opens a
``TorchDispatchMode`` that records each matrix product and convolution
aten op (``mm``, ``addmm``, ``bmm``, ``convolution``,
``convolution_backward`` and the rest of ``torch.utils.flop_counter``'s
table, with its formulas), and the hand-written kernels record
themselves (:func:`kernel`): their wrappers are ctypes launches inside
``autograd.Function`` s that no dispatch mode sees. On the CPU a wrapper
runs its plain version, whose aten ops such a mode would see; the
wrapper records the kernel's products and mutes the mode for the plain
version, so the count is the same on both paths and nothing counts
twice. The Estimator counts inside the first step of a run, with no
extra step and no second forward.

Counting rules (products only; elementwise work is left out):

- a dot or a 1x1 conv: ``2 x M x K x N``;
- a convolution: ``2 x out elements x window taps x input channels``,
  its backward ``dx`` and ``dw`` the same each (torch's formulas);
- a flash-attention kernel: its own products (``4 B H Tq Tk D`` for a
  forward).

FLOPs are 2 x MACs: ResNet-50's 4.09 GMAC forward is 8.18 GFLOP here.

Strided convolutions: XLA's backward for a strided conv dilates an
operand with zeros and executes the products with them, and the
reference's executed count includes those zeros. The port counts model
FLOPs: cuDNN's strided dgrad/wgrad and the phase decomposition
(``ops/conv_grad.py``) do no product with an inserted zero, and torch's
formula for ``convolution_backward`` counts the model's products. So on a
model with strided convs the two counts differ by design; on stride-1
models they agree.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, NamedTuple, Sequence

__all__ = ["OpCost", "PadWaste", "FlopCount", "count", "kernel",
           "executed_flops", "top_ops", "channel_padding"]


class OpCost(NamedTuple):
    name: str
    kind: str        # "convolution" | "dot" | "attention"
    flops: float
    detail: str      # the shapes, for a printout
    # (role, extent) of the product's feature axes: "lhs_f" the input's
    # contraction extent, "rhs_i"/"rhs_o" the weight's in and out
    features: tuple = ()


class PadWaste(NamedTuple):
    name: str
    role: str
    extent: int
    util: float      # extent / lane-padded extent


_lock = threading.Lock()
_active: "List[FlopCount]" = []
_mute = threading.local()


class FlopCount:
    """The products recorded while :func:`count` was open."""

    def __init__(self):
        self.ops: "List[OpCost]" = []
        self._lock = threading.Lock()

    def add(self, op: OpCost) -> None:
        with self._lock:
            self.ops.append(op)

    @property
    def total(self) -> float:
        return executed_flops(self.ops)


def _record(op: OpCost) -> None:
    with _lock:
        counts = list(_active)
    for c in counts:
        c.add(op)


@contextlib.contextmanager
def kernel(name: str, kind: str, flops: float, detail: str = "",
           features: tuple = ()):
    """Around a hand-written kernel's call (or its plain version's):
    records the kernel's products in every open count and mutes the
    dispatch mode inside, on this thread."""
    if not _active:
        yield
        return
    _record(OpCost(name, kind, float(flops), detail, tuple(features)))
    _mute.depth = getattr(_mute, "depth", 0) + 1
    try:
        yield
    finally:
        _mute.depth -= 1


def _shape(t) -> str:
    return "x".join(str(d) for d in getattr(t, "shape", ()))


def _features(packet_name: str, args) -> tuple:
    """The feature extents of a product's operands, for
    :func:`channel_padding`."""
    try:
        if packet_name in ("mm", "addmm", "bmm", "baddbmm"):
            a, b = (args[1], args[2]) if packet_name in (
                "addmm", "baddbmm") else (args[0], args[1])
            return (("lhs_f", int(a.shape[-1])), ("rhs_i", int(b.shape[-2])),
                    ("rhs_o", int(b.shape[-1])))
        if packet_name == "convolution":
            x, w = args[0], args[1]
            return (("lhs_f", int(x.shape[1])), ("rhs_i", int(w.shape[1])),
                    ("rhs_o", int(w.shape[0])))
        if packet_name == "convolution_backward":
            x, w = args[1], args[2]
            return (("lhs_f", int(x.shape[1])), ("rhs_i", int(w.shape[1])),
                    ("rhs_o", int(w.shape[0])))
    except (IndexError, AttributeError, TypeError):
        pass
    return ()


def _dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _ProductCounter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if getattr(_mute, "depth", 0):
                return out
            packet = func._overloadpacket
            fn = flop_registry.get(packet)
            if fn is not None:
                flops = fn(*args, **kwargs, out_val=out)
                if flops:
                    pname = packet.__name__
                    kind = "convolution" if "conv" in pname else (
                        "attention" if "attention" in pname else "dot")
                    _record(OpCost(
                        f"aten.{pname}", kind, float(flops),
                        " ".join(_shape(a) for a in args[:3]
                                 if hasattr(a, "shape")),
                        _features(pname, args)))
            return out

    return _ProductCounter()


@contextlib.contextmanager
def count():
    """Count the products run while open: the aten ops this thread
    dispatches (and the autograd engine's, which carry the mode) and
    every hand-written kernel's record. Yields a :class:`FlopCount`."""
    c = FlopCount()
    with _lock:
        _active.append(c)
    try:
        with _dispatch_mode():
            yield c
    finally:
        with _lock:
            _active.remove(c)


def executed_flops(ops: Sequence[OpCost]) -> float:
    """The total of the counted products."""
    return float(sum(op.flops for op in ops))


def top_ops(ops: Sequence[OpCost], n: int = 10) -> List[OpCost]:
    return sorted(ops, key=lambda o: -o.flops)[:n]


def channel_padding(ops: Sequence[OpCost], lane: int = 128
                    ) -> List[PadWaste]:
    """The counted products' feature extents that are not multiples of
    ``lane``: a tile of that width spends ``extent / ceil_lane(extent)``
    of its work on that axis (ResNet's 3-channel stem: 3/128)."""
    out = []
    for op in ops:
        for role, ext in op.features:
            if ext % lane:
                padded = -(-ext // lane) * lane
                out.append(PadWaste(op.name, role, ext, ext / padded))
    return out
