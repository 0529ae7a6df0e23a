"""Estimator: train, evaluate and predict a Keras-style net on the card
(port of ``analytics_zoo_tpu/pipeline/estimator.py``, the single-card
train loop with the reference's whole training surface and its
on-device augmentation; the fsdp/tp/ep modes, sharded checkpoints and
training SLOs wait for later slices).

A train step is the reference's, written eagerly: the net's ``apply``
in training mode under autograd, the loss (in f32 under the
``mixed_bfloat16`` policy, whose inputs go to the card as bf16 while
the params stay f32), the gradients of the trainable leaves, the
clipping (global L2 norm or a constant range, first, as the
reference's ``optax.chain``), the optimizer's in-place update, then the
BatchNorm state updates copied into the net's buffers. The weights live
in the net itself (``model.params()``), so ``predict`` and serving see
every step. Inputs may be one array or a list of them (BERT takes
four). Each step hands the net a seed, ``fold_in(base, step)`` with
``base`` drawn from the context once per ``train`` call, from which the
layers that draw noise (dropout) derive theirs (``ops/rng.py``).

``Estimator(augment=fn)`` augments each training batch on its device
inside the step, before the forward (``fn(seed, x)``, e.g. a
``feature.image.device_transforms.augment_pipeline``); evaluation,
prediction and validation never augment. The augment's seed is the
step's seed folded once more with a fixed constant, so the net's own
seed is the same with and without it. With an augment the training
batches reach the step in f32, and the bf16 cast of ``mixed_bfloat16``
comes after the augment, as in the reference. The net is built for the
augmented shape (a crop from 257 x 257 to 224 x 224 feeds a 224 x 224
net).

Data reaches the loop as numpy arrays, a dataset with ``iter_batches``
(a ``FeatureSet``), a TextSet or ImageSet (their ``to_arrays``), or an
RDD or Spark DataFrame, which ``FeatureSet.from_rdd`` collects
(:func:`to_dataset`).

Input batches are prepared ahead of the step, as the reference does
(``_prefetch_iter``): a worker thread named ``zoo-tpu-prefetch`` runs
``ZOO_TPU_PREFETCH`` batches ahead (2 by default, 0 or less runs in
line). On the card the worker gathers each batch into a pinned host
buffer (a ring of depth + 1 per input), copies it on a copy stream of
its own and records an event, which the step's stream waits for before
it casts the inputs to bf16 under ``mixed_bfloat16``. Each train step's
wait for its batch is observed in ``zoo_tpu_train_data_wait_seconds``.

The loop around the step is the reference's: the triggers decide when
to validate, checkpoint, write summaries and stop; each epoch is a
``train/epoch`` span and each step a ``train/step`` trace annotated
with its ``data_wait_s``, ``dispatch_s``, ``device_s`` (with
``ZOO_TPU_TRACE_SYNC=1``, a card sync per step) and ``checkpoint_s``;
the gauges ``zoo_tpu_train_first_step_seconds``,
``zoo_tpu_learning_rate`` and ``zoo_tpu_train_throughput_examples_per_
sec``; a :class:`~analytics_zoo_tpu_torch.common.diagnostics.
StepTimeWatcher` per run, the recompile monitor, the shipped training
objectives of ``common/slo.py`` with the SLO ticker, the device-memory
gauges per epoch; and the goodput ledger (``perf/goodput.py``), whose
step FLOPs are counted inside the run's first step (``perf/flops.py``)
and whose epoch summary goes into the history's ``goodput``.
Checkpoints are the reference's files: either package resumes the
other's.

Multi-output models follow the reference's Keras semantics: labels
given as a list of arrays are one column per output
(``feature.normalize_labels``), the loss sums one term per output
(``loss`` may be a list, one per output), and ``predict`` returns one
array per output.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.bridge import optax_leaves
from analytics_zoo_tpu_torch.common import diagnostics, faults
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import slo as slo_lib
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.common.nncontext import (
    NNContext, get_nncontext)
from analytics_zoo_tpu_torch.common.safe_pickle import checked_load
from analytics_zoo_tpu_torch.feature.feature_set import normalize_labels
from analytics_zoo_tpu_torch.ops import losses as losses_lib
from analytics_zoo_tpu_torch.ops import metrics as metrics_lib
from analytics_zoo_tpu_torch.ops import optimizers as optim_lib
from analytics_zoo_tpu_torch.perf import flops as flops_lib
from analytics_zoo_tpu_torch.perf import goodput as goodput_lib
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import tree_leaves
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    concat_outputs, to_numpy)

logger = logging.getLogger("analytics_zoo_tpu_torch")

# fires after the pickle's bytes are in the tmp file and before any
# fsync or rename: a failure here leaves only the tmp file, never a torn
# ckpt_*.pkl
_CKPT_FAULT = faults.point("estimator/checkpoint_write")

# folded into a step's seed for the augment's: the net's seed stays the
# step's own
_AUGMENT_STREAM = 0x617567


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------

class Trigger:
    """Training-control predicate (the reference's BigDL ``Trigger``
    algebra: every epoch, several iterations, max epoch, max iteration,
    min loss, max score, and their and/or). ``**state`` carries the
    epoch's loss and validation metrics at epoch-end checks."""

    def __call__(self, epoch: int, iteration: int, epoch_end: bool,
                 **state) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch() -> "Trigger":
        return EveryEpoch()

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return SeveralIteration(n)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return MaxEpoch(n)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return MaxIteration(n)

    @staticmethod
    def min_loss(v: float) -> "Trigger":
        return MinLoss(v)

    @staticmethod
    def max_score(v: float, metric: Optional[str] = None) -> "Trigger":
        return MaxScore(v, metric)

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return TriggerAnd(*triggers)

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return TriggerOr(*triggers)


class EveryEpoch(Trigger):
    def __call__(self, epoch, iteration, epoch_end, **state):
        return epoch_end


class SeveralIteration(Trigger):
    def __init__(self, n: int):
        self.n = int(n)

    def __call__(self, epoch, iteration, epoch_end, **state):
        return iteration > 0 and iteration % self.n == 0


class MaxEpoch(Trigger):
    def __init__(self, n: int):
        self.n = int(n)

    def __call__(self, epoch, iteration, epoch_end, **state):
        return epoch >= self.n


class MaxIteration(Trigger):
    def __init__(self, n: int):
        self.n = int(n)

    def __call__(self, epoch, iteration, epoch_end, **state):
        return iteration >= self.n


class MinLoss(Trigger):
    """The epoch's training loss at or below ``v``, at epoch end."""

    def __init__(self, v: float):
        self.v = float(v)

    def __call__(self, epoch, iteration, epoch_end, **state):
        loss = state.get("loss")
        return epoch_end and loss is not None and loss <= self.v


class MaxScore(Trigger):
    """A validation metric (``metric``, or the first reported) at or
    above ``v``, at epoch end."""

    def __init__(self, v: float, metric: Optional[str] = None):
        self.v = float(v)
        self.metric = metric

    def __call__(self, epoch, iteration, epoch_end, **state):
        metrics = state.get("val_metrics") or {}
        if not (epoch_end and metrics):
            return False
        score = (metrics.get(self.metric) if self.metric is not None
                 else next(iter(metrics.values()), None))
        return score is not None and score >= self.v


class TriggerAnd(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, *a, **state):
        return all(t(*a, **state) for t in self.triggers)


class TriggerOr(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, *a, **state):
        return any(t(*a, **state) for t in self.triggers)


# ---------------------------------------------------------------------------
# In-memory dataset
# ---------------------------------------------------------------------------

class ArrayDataset:
    """Numpy (x, y) pairs with per-epoch shuffling and fixed-size
    batches; the trailing incomplete batch is dropped in training. The
    shuffle is numpy's ``RandomState(seed)``, so the order is the
    reference's exactly. ``y`` is one label array or, for a
    multi-output model, a list of them (:func:`normalize_labels`
    decides); a batch then carries a list of label columns."""

    def __init__(self, x, y=None):
        self.x = [np.asarray(a) for a in
                  (x if isinstance(x, (list, tuple)) else [x])]
        y_cols, self._multi_y = normalize_labels(y)
        self.y = (y_cols if self._multi_y
                  else y_cols[0] if y_cols else None)
        n = self.x[0].shape[0]
        if any(a.shape[0] != n for a in self.x):
            raise ValueError("inconsistent sample counts in x")
        if any(a.shape[0] != n for a in y_cols):
            raise ValueError("x and y sample counts differ")
        self._n = n
        self._tensors = None

    @property
    def num_samples(self) -> int:
        return self._n

    def iter_indices(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True):
        """The sample indices of each batch, in :meth:`iter_batches`'
        order."""
        idx = np.arange(self._n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        end = (self._n - self._n % batch_size) if drop_last else self._n
        for start in range(0, end, batch_size):
            yield idx[start:start + batch_size]

    def gather(self, sel):
        """The ``(x, y)`` batch of the samples ``sel``."""
        xb = [a[sel] for a in self.x]
        if self.y is None:
            yb = None
        elif self._multi_y:
            yb = [a[sel] for a in self.y]
        else:
            yb = self.y[sel]
        return xb[0] if len(xb) == 1 else xb, yb

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True):
        for sel in self.iter_indices(batch_size, shuffle, seed, drop_last):
            yield self.gather(sel)

    def tensors(self):
        """The arrays as CPU tensors, ``(x columns, y columns)`` (no
        labels: an empty list), made once; f64 comes in as f32 (the
        reference's default precision). The card's placement gathers
        from them."""
        if self._tensors is None:
            ys = [] if self.y is None else (
                self.y if self._multi_y else [self.y])
            self._tensors = tuple(
                [_f32(torch.from_numpy(np.ascontiguousarray(a)))
                 for a in arrays] for arrays in (self.x, ys))
        return self._tensors


def _whole_batches(batches):
    """Each ``(x, y)`` batch of another dataset as an item ``(ds, sel)``
    of the placement: a dataset of its own and all of its rows."""
    for xb, yb in batches:
        ds = ArrayDataset(xb, yb)
        yield ds, np.arange(ds.num_samples)


def to_dataset(data, y=None):
    """The Estimator's view of ``data``, in the reference's order: a
    dataset with ``iter_batches`` as it is; a TextSet or ImageSet through
    its ``to_arrays`` (``y`` overrides its labels); an RDD-like or Spark
    DataFrame collected into a ``FeatureSet`` (this process's share of
    the partitions); arrays as an :class:`ArrayDataset`."""
    if hasattr(data, "iter_batches"):
        return data
    if hasattr(data, "to_arrays"):
        xs, ys = data.to_arrays()
        return ArrayDataset(xs, ys if y is None else y)
    from analytics_zoo_tpu_torch.feature.rdd import (is_rdd_like,
                                                     is_spark_dataframe)
    if is_rdd_like(data) or is_spark_dataframe(data):
        from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
        return FeatureSet.from_rdd(data)
    return ArrayDataset(data, y)


def _to_device(a, device, float_dtype=None):
    """A host array (or list of them) as tensors on ``device``; f64 comes
    in as f32 (the reference's default precision), and floating arrays
    are cast to ``float_dtype`` when given."""
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return [_to_device(v, device, float_dtype) for v in a]
    t = _f32(a if isinstance(a, torch.Tensor) else
             torch.from_numpy(np.ascontiguousarray(a)))
    t = t.to(device)
    if float_dtype is not None and t.is_floating_point():
        t = t.to(float_dtype)
    return t


# ---------------------------------------------------------------------------
# Input pipeline (the reference's _prefetch_iter, _timed_iter and
# _prefetch_depth)
# ---------------------------------------------------------------------------

def _prefetch_iter(it, place, depth: int):
    """Run ``place`` over ``it`` on a worker thread ``depth`` items
    ahead of the consumer, in order. An exception in the worker is
    raised again at the consumer's next pull; closing the generator
    (``break``, an exception, or ``close()``) stops the worker at once.
    ``depth <= 0`` runs ``place`` in line."""
    if depth <= 0:
        for item in it:
            yield place(item)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if stop.is_set() or not _put(place(item)):
                    return
            _put(sentinel)
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True, name="zoo-tpu-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _timed_iter(it):
    """``(wait_s, item)`` for each item of ``it``: how long the consumer
    waited for it. About 0 while the prefetch worker keeps ahead; a
    lasting wait means the input pipeline, not the card, sets the
    pace."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield time.perf_counter() - t0, item


def _prefetch_depth() -> int:
    raw = os.environ.get("ZOO_TPU_PREFETCH", "2")
    try:
        return int(raw)
    except ValueError:
        logger.warning("ZOO_TPU_PREFETCH=%r is not an integer; using "
                       "default depth 2", raw)
        return 2


class _CardPlacer:
    """Places host batches on a CUDA device ahead of the step (the
    prefetch worker calls it; one per pass over the data). An item is
    ``(ds, sel)``: an :class:`ArrayDataset` and a batch's sample indices
    into it. Per input, a ring of ``depth + 1`` pinned host buffers: the
    batch is gathered into the next one (``torch.index_select`` from the
    dataset's arrays, which releases the GIL) and copied to the card as
    it is with ``non_blocking`` on a copy stream, after which an event is
    recorded. A buffer is written again only after its copy's event has
    completed. :meth:`take` makes the step's stream wait for the event
    and casts the inputs' floating tensors to ``float_dtype`` there
    (``mixed_bfloat16``: the cast the synchronous path makes, on the
    same stream); the labels keep their dtype. Pinning and the copy
    raise where they fail: there is no pageable path to fall back to."""

    def __init__(self, device: torch.device, depth: int,
                 float_dtype: Optional[torch.dtype]):
        self.device = device
        self.float_dtype = float_dtype
        self.slots = max(depth, 0) + 1
        self.stream = torch.cuda.Stream(device)
        self._ring = {}      # (input, column) -> pinned buffers
        self._done = [None] * self.slots   # each slot's copy event
        self._turn = 0

    def _stage(self, key, src: torch.Tensor, idx: torch.Tensor,
               slot: int) -> torch.Tensor:
        """Rows ``idx`` of the dataset's array ``src`` gathered into the
        slot's pinned buffer of input ``key``."""
        n = idx.shape[0]
        ring = self._ring.get(key)
        if ring is None or ring[0].shape[0] < n or \
                ring[0].shape[1:] != src.shape[1:] or \
                ring[0].dtype != src.dtype:
            ring = self._ring[key] = [
                torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                            pin_memory=True) for _ in range(self.slots)]
        return torch.index_select(src, 0, idx, out=ring[slot][:n])

    def __call__(self, item):
        ds, sel = item
        slot = self._turn % self.slots
        self._turn += 1
        if self._done[slot] is not None:
            self._done[slot].synchronize()   # the buffer's last copy
        xs, ys = ds.tensors()
        idx = torch.from_numpy(np.asarray(sel, np.int64))
        xs = [self._stage(("x", i), a, idx, slot) for i, a in enumerate(xs)]
        ys = [self._stage(("y", i), a, idx, slot) for i, a in enumerate(ys)]
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            xs = [t.to(self.device, non_blocking=True) for t in xs]
            ys = [t.to(self.device, non_blocking=True) for t in ys]
            done = torch.cuda.Event()
            done.record(self.stream)
        self._done[slot] = done
        x = xs[0] if len(xs) == 1 else xs
        y = None if ds.y is None else (ys if ds._multi_y else ys[0])
        return x, y, done

    def take(self, batch):
        """The placed ``(x, y)`` for the step: the current stream waits
        for the copy, and the caching allocator keeps the tensors'
        memory until that stream's work on them is done."""
        x, y, done = batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in _flat(x) + _flat(y):
            t.record_stream(stream)
        if self.float_dtype is not None:
            x = _cast_floats(x, self.float_dtype)
        return x, y


class _HostPlacer:
    """The CPU device's placement of an item ``(ds, sel)``: the batch
    as tensors, in the calling thread's order (no streams)."""

    def __init__(self, device: torch.device,
                 float_dtype: Optional[torch.dtype]):
        self.device = device
        self.float_dtype = float_dtype

    def __call__(self, item):
        xb, yb = item[0].gather(item[1])
        return (_to_device(xb, self.device, self.float_dtype),
                _to_device(yb, self.device), None)

    @staticmethod
    def take(batch):
        return batch[0], batch[1]


def _flat(v) -> list:
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.float64 else t


def _cast_floats(x, dtype):
    if isinstance(x, (list, tuple)):
        return [_cast_floats(v, dtype) for v in x]
    return x.to(dtype) if x.is_floating_point() else x


def _is_pairwise(loss_fn) -> bool:
    base = getattr(loss_fn, "func", loss_fn)
    return base is losses_lib.rank_hinge or \
        getattr(base, "__name__", "") == "rank_hinge"


def _apply_loss(loss_fn, y, out):
    """Keras multi-output semantics: a list of model outputs against a
    list of label columns sums one loss per output (``loss_fn`` may be a
    list, one loss per output). Mixed structures (list outputs and one
    label array, or the reverse) go to the single loss as they are: a
    custom joint loss may unpack them."""
    if isinstance(out, (list, tuple)) and isinstance(y, (list, tuple)):
        fns = (list(loss_fn) if isinstance(loss_fn, (list, tuple))
               else [loss_fn] * len(out))
        if not (len(fns) == len(out) == len(y)):
            raise ValueError(
                f"multi-output mismatch: {len(out)} outputs, "
                f"{len(y)} label columns, {len(fns)} losses")
        total = fns[0](y[0], out[0])
        for f, t, o in zip(fns[1:], y[1:], out[1:]):
            total = total + f(t, o)
        return total
    if isinstance(loss_fn, (list, tuple)):
        raise ValueError(
            f"a list of {len(loss_fn)} losses needs a multi-output "
            f"model AND a list of label columns (outputs are "
            f"{type(out).__name__}, labels {type(y).__name__})")
    return loss_fn(y, out)


def _batch_dim(out) -> int:
    return int((out[0] if isinstance(out, (list, tuple)) else out).shape[0])


@dataclass
class TrainResult:
    history: "list[dict]"
    params: Any
    opt_state: Any
    step: int


class Estimator:
    """``train``/``evaluate``/``predict`` over a Keras-style net, with
    the reference's training surface: triggers, validation, gradient
    clipping, checkpoints, TensorBoard summaries, profiling and the
    goodput ledger."""

    def __init__(self, model, optimizer="adam", loss="mse",
                 metrics: Optional[List] = None,
                 ctx: Optional[NNContext] = None,
                 dtype_policy: Optional[str] = None,
                 augment: Optional[Callable] = None):
        # explicit, then ZOO_TPU_DTYPE_POLICY, then the default: the
        # reference defaults to bf16 activations on a TPU only, and the
        # card is not one
        dtype_policy = (dtype_policy or
                        os.environ.get("ZOO_TPU_DTYPE_POLICY") or "float32")
        if dtype_policy not in ("float32", "mixed_bfloat16"):
            raise ValueError("dtype_policy must be float32|mixed_bfloat16")
        self.dtype_policy = dtype_policy
        # train-only augmentation on the batch's device: fn(seed, x)
        self.augment = augment
        self.model = model
        self.ctx = ctx or get_nncontext()
        if isinstance(loss, (list, tuple)):
            # one loss per model output; _apply_loss sums them
            self.loss_fn = [losses_lib.get(name) for name in loss]
            if any(_is_pairwise(f) for f in self.loss_fn):
                raise ValueError(
                    "rank_hinge is pairwise and not supported inside a "
                    "multi-output loss list")
        else:
            self.loss_fn = losses_lib.get(loss)
        self.metrics = [metrics_lib.get(m) for m in (metrics or [])]
        self.optimizer = optim_lib.get(optimizer)
        self._clip: Optional[Callable] = None
        self.opt_state: Optional[dict] = None
        self.step = 0
        # the product FLOPs of a step, counted in a run's first step
        # (perf/flops.py), and the counted products
        self.flops_per_step: Optional[float] = None
        self.flop_ops: list = []

        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Trigger = EveryEpoch()
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self.tensorboard_dir: Optional[str] = None
        self.tensorboard_app = "zoo_tpu"
        self._tb_writer = None
        # True only for a writer _tb() opened: an injected writer is the
        # caller's and is never closed here
        self._tb_owns_writer = False
        self._summary_triggers: "dict[str, Trigger]" = {}
        self._profile_dir: Optional[str] = None
        self._profile_start = 0
        self._profile_end = 0
        self._profiling = False
        self._profiler = None

    # -- knobs ---------------------------------------------------------------
    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Scale the gradients to a global L2 norm of ``clip_norm`` when
        they exceed it (optax.clip_by_global_norm), before the update."""
        clip_norm = float(clip_norm)
        self._clip = lambda g: optim_lib.clip_by_global_norm(g, clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clamp every gradient element into ``[min_value, max_value]``
        before the update."""
        lo, hi = float(min_value), float(max_value)
        self._clip = lambda g: optim_lib.clip_constant(g, lo, hi)
        return self

    def set_checkpoint(self, path: str, trigger: Optional[Trigger] = None):
        self.checkpoint_path = path
        if trigger is not None:
            self.checkpoint_trigger = trigger
        return self

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo_tpu"):
        """Write the ``Loss``, ``LearningRate``, ``Throughput`` and
        ``Validation/<metric>`` scalars under ``log_dir/app_name``
        (``torch.utils.tensorboard``, imported at the first ``train``:
        without the ``tensorboard`` package that raises)."""
        self.tensorboard_dir = log_dir
        self.tensorboard_app = app_name
        return self

    def set_summary_trigger(self, name: str, trigger: Trigger):
        """Extra summaries on a trigger (BigDL
        ``TrainSummary.setSummaryTrigger``): ``"Parameters"``, a
        histogram per weight (``Parameters/<layer>/<param>``, one fetch
        of the whole tree per firing), or ``"LearningRate"``, the
        schedule's value as a scalar and the ``zoo_tpu_learning_rate``
        gauge."""
        if name not in ("Parameters", "LearningRate"):
            raise ValueError(f"unsupported summary {name!r}; supported: "
                             "Parameters, LearningRate")
        self._summary_triggers[name] = trigger
        return self

    def set_dtype_policy(self, policy: str):
        """"float32" or "mixed_bfloat16" (bf16 activations, f32 params
        and loss)."""
        if policy not in ("float32", "mixed_bfloat16"):
            raise ValueError("dtype_policy must be float32|mixed_bfloat16")
        self.dtype_policy = policy
        return self

    def set_profile(self, log_dir: str, start_step: int = 3,
                    n_steps: int = 3):
        """Profile training steps ``start_step`` to ``start_step +
        n_steps`` of the next ``train`` call (counted from its start)
        with ``torch.profiler`` (the card's kernels too), and write the
        trace into ``log_dir`` as ``<first>-<last>.pt.trace.json``. The
        profiler stops on every exit path."""
        self._profile_dir = log_dir
        self._profile_start = int(start_step)
        self._profile_end = int(start_step) + int(n_steps)
        return self

    def _tb(self):
        if self.tensorboard_dir is None:
            return None
        if self._tb_writer is None:
            from torch.utils.tensorboard import SummaryWriter
            self._tb_writer = SummaryWriter(
                os.path.join(self.tensorboard_dir, self.tensorboard_app))
            self._tb_owns_writer = True
        return self._tb_writer

    def _record_lr(self, tb, step: int) -> float:
        """The schedule's value at ``step`` into the
        ``zoo_tpu_learning_rate`` gauge, and the ``LearningRate`` scalar
        when a writer is passed."""
        lr = self.optimizer.lr_at(step)
        obs.gauge("zoo_tpu_learning_rate",
                  help="current learning-rate schedule value").set(lr)
        if tb is not None:
            tb.add_scalar("LearningRate", lr, step)
        return lr

    def _write_param_histograms(self, tb, step: int) -> None:
        paths, leaves = _sorted_leaves(self.model.params())
        for path, arr in zip(paths, _host_copies(leaves)):
            tb.add_histogram("Parameters/" + "/".join(path), arr, step)

    # -- params ------------------------------------------------------------
    @property
    def params(self) -> Optional[dict]:
        return self.model.params() if self.model.initialized else None

    @params.setter
    def params(self, tree: dict) -> None:
        self.model.load_params(tree, device=self.ctx.device)

    def trainable_leaves(self) -> "list[torch.Tensor]":
        """The trainable param tensors, in tree order (the order of
        every list in ``opt_state``)."""
        params = self.model.params()
        mask = self.model.trainable_mask(params)
        return [p for p, on in zip(tree_leaves(params), tree_leaves(mask))
                if on]

    def _trainable_order(self) -> "list[int]":
        """The trainable leaves' indices in the reference's tree order
        (every dict's keys sorted, as ``jax.tree_util`` flattens)."""
        params = self.model.params()
        mask = self.model.trainable_mask(params)
        paths = [p for p, on in zip(_leaf_paths(params), tree_leaves(mask))
                 if on]
        return sorted(range(len(paths)), key=lambda i: paths[i])

    def _ensure_initialized(self) -> None:
        if not self.model.initialized:
            self.model.init_params(self.ctx.new_generator(),
                                   device=self.ctx.device)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.trainable_leaves())

    @staticmethod
    def _merge_updates(params: dict, updates: dict) -> dict:
        """Fold BatchNorm-style state updates into the param tree. In
        place, where the reference returns a new tree: the leaves are
        the net's buffers."""
        for k, v in updates.items():
            if isinstance(v, dict):
                Estimator._merge_updates(params[k], v)
            else:
                params[k].copy_(v)
        return params

    # -- steps ---------------------------------------------------------------
    @property
    def _mixed(self) -> bool:
        return self.dtype_policy == "mixed_bfloat16"

    def _batches(self, ds, batch_size: int, shuffle: bool, seed: int = 0,
                 drop_last: bool = True, cast: bool = True):
        """One pass over ``ds`` as placed batches ``(x, y, event)``,
        prefetched ``ZOO_TPU_PREFETCH`` ahead (the reference's
        ``_prefetch_iter`` over ``shard_batch``); returns the generator,
        which the caller closes, and the placer, whose ``take`` hands a
        batch to the step. ``cast=False`` keeps the inputs' dtype under
        ``mixed_bfloat16`` (the augmented train step casts them
        itself)."""
        dev = self.model.device
        fdt = torch.bfloat16 if self._mixed and cast else None
        depth = _prefetch_depth()
        if isinstance(ds, ArrayDataset):
            items = ((ds, sel) for sel in ds.iter_indices(
                batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last))
        else:
            # another dataset's batches, each as a dataset of its own
            items = _whole_batches(ds.iter_batches(
                batch_size, shuffle=shuffle, seed=seed, drop_last=drop_last))
        place = (_CardPlacer(dev, depth, fdt) if dev.type == "cuda"
                 else _HostPlacer(dev, fdt))
        return _prefetch_iter(items, place, depth), place

    def _train_step(self, x, y, rng: Optional[int] = None
                    ) -> torch.Tensor:
        if self.augment is not None:
            # on the batch's device, in f32; then the policy's cast
            with torch.no_grad():
                x = self.augment(fold_in(rng or 0, _AUGMENT_STREAM), x)
            if self._mixed:
                x = _cast_floats(x, torch.bfloat16)
        params = self.model.params()
        leaves = self.trainable_leaves()
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                out, state_upd = self.model.apply(params, x, training=True,
                                                  rng=rng)
                if self._mixed:      # loss in f32 for numeric stability
                    out = _cast_floats(out, torch.float32)
                loss = _apply_loss(self.loss_fn, y, out) + \
                    self.model.regularization_loss(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if self._clip is not None:     # first in the chain, as optax's
            grads = self._clip(grads)
        self.optimizer.update(leaves, grads, self.opt_state)
        with torch.no_grad():
            self._merge_updates(params, state_upd)
        return loss.detach()

    def _forward_eval(self, x, params=None):
        out = self.model.call(self.model.params() if params is None
                              else params, x, training=False)
        return _cast_floats(out, torch.float32) if self._mixed else out

    def _sync(self) -> None:
        dev = self.model.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()
        self._profiling = True
        self._profile_first = self.step + 1

    def _stop_profile(self) -> None:
        """Stop the profiler and write its trace (every exit path)."""
        prof, self._profiler = self._profiler, None
        log_dir, self._profile_dir = self._profile_dir, None
        self._profiling = False
        self._sync()
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{self._profile_first}-{self.step}.pt.trace.json"))

    # -- API -----------------------------------------------------------------
    def train(self, data, y=None, batch_size: int = 32, nb_epoch: int = 1,
              validation_data=None,
              validation_trigger: Optional[Trigger] = None,
              end_trigger: Optional[Trigger] = None) -> TrainResult:
        """Train for ``nb_epoch`` epochs (or until ``end_trigger``). Each
        history entry has the epoch's mean loss, its per-step losses,
        throughput (examples/s, host clock), the step count, the
        ``val_<metric>`` results where ``validation_trigger`` (default
        every epoch) fired, and the goodput ledger's ``goodput``
        summary."""
        ds = to_dataset(data, y)
        self.ctx.check_batch_size(batch_size)
        self._ensure_initialized()
        tb = self._tb()
        validation_trigger = validation_trigger or EveryEpoch()
        # per-step host wall time is dispatch to dispatch, as in the
        # reference: no sync per step
        step_hist = obs.histogram(
            "zoo_tpu_train_step_seconds",
            help="host wall time per training step (dispatch-to-dispatch)")
        steps_total = obs.counter("zoo_tpu_train_steps_total",
                                  help="training steps dispatched")
        examples_total = obs.counter("zoo_tpu_train_examples_total",
                                     help="training examples consumed")
        # the reference's data_wait_s: how long each step waited for
        # its batch
        wait_hist = obs.histogram(
            "zoo_tpu_train_data_wait_seconds",
            help="host time each training step waited for its batch")
        watcher = diagnostics.StepTimeWatcher()
        diagnostics.install_recompile_monitor()
        # the shipped training objectives and the SLO ticker
        # (ZOO_TPU_SLO=0 disables)
        slo_lib.ensure_default_slos("training")
        ledger = goodput_lib.ledger_for_backend(device=self.model.device)
        # ZOO_TPU_TRACE_SYNC=1: a card sync per step, so each step's
        # trace carries its device time (it stops the host running ahead)
        trace_sync = os.environ.get("ZOO_TPU_TRACE_SYNC", "0") == "1"
        base_rng = self.ctx.next_seed()
        # the profile window counts from this run's start
        p_start = self.step + self._profile_start
        p_end = self.step + self._profile_end
        history: "list[dict]" = []
        first_step = True
        stop = False
        try:
            for epoch in range(1, nb_epoch + 1):
                pending: "list[tuple[int, torch.Tensor]]" = []
                n_records = 0
                batches, place = self._batches(
                    ds, batch_size, shuffle=True, seed=epoch,
                    cast=self.augment is None)
                ep_span = obs.span("train/epoch", epoch=epoch,
                                   step=self.step)
                with ep_span:
                    try:
                        t_prev = t_led_prev = time.perf_counter()
                        for wait_s, batch in _timed_iter(batches):
                            wait_hist.observe(wait_s)
                            with tracing.trace("train/step",
                                               step=self.step + 1,
                                               epoch=epoch) as tr:
                                if self._profile_dir and \
                                        not self._profiling and \
                                        self.step + 1 >= p_start:
                                    self._start_profile()
                                count = (first_step and ledger is not None
                                         and goodput_lib.flops_enabled())
                                t_disp = time.perf_counter()
                                with (flops_lib.count() if count else
                                      contextlib.nullcontext()) as fc:
                                    loss = self._train_step(
                                        *place.take(batch),
                                        fold_in(base_rng, self.step))
                                dispatch_s = time.perf_counter() - t_disp
                                self.step += 1
                                device_s = None
                                if trace_sync:
                                    t_dev = time.perf_counter()
                                    self._sync()
                                    device_s = time.perf_counter() - t_dev
                                if first_step:
                                    # the run's first step, its builds and
                                    # the FLOP count included
                                    self._sync()
                                    obs.gauge(
                                        "zoo_tpu_train_first_step_seconds",
                                        help="first-step wall time of the "
                                        "latest run").set(
                                            time.perf_counter() - t_prev)
                                    first_step = False
                                    if fc is not None:
                                        self.flop_ops = fc.ops
                                        self.flops_per_step = fc.total
                                        ledger.set_flops_per_step(fc.total)
                                if self._profiling and self.step >= p_end:
                                    self._stop_profile()
                                now = time.perf_counter()
                                step_hist.observe(now - t_prev)
                                watcher.observe(now - t_prev, step=self.step)
                                t_prev = now
                                steps_total.inc()
                                examples_total.inc(batch_size)
                                n_records += batch_size
                                pending.append((self.step, loss))
                                self._fire_summaries(tb, epoch, False)
                                ckpt_s = None
                                if self.checkpoint_path and \
                                        self.checkpoint_trigger(
                                            epoch, self.step, False):
                                    t_ck = time.perf_counter()
                                    self.save_checkpoint()
                                    ckpt_s = time.perf_counter() - t_ck
                                tr.annotate(data_wait_s=round(wait_s, 6),
                                            dispatch_s=round(dispatch_s, 6),
                                            device_s=device_s,
                                            checkpoint_s=ckpt_s)
                                if ledger is not None:
                                    # iteration to iteration, the
                                    # checkpoint included: the shares sum
                                    # to 1
                                    t_led = time.perf_counter()
                                    ledger.note_step(
                                        t_led - t_led_prev,
                                        data_wait_s=wait_s,
                                        dispatch_s=dispatch_s,
                                        checkpoint_s=ckpt_s or 0.0)
                                    t_led_prev = t_led
                                if end_trigger is not None and end_trigger(
                                        epoch - 1, self.step, False):
                                    stop = True
                                    break
                    finally:
                        # a break or an exception stops the worker now,
                        # not at garbage collection (it would hold depth
                        # + 1 batches)
                        batches.close()
                    # one fetch per epoch, not one sync per step
                    step_losses = [float(v) for v in
                                   _host_copies([v for _, v in pending])]
                dt = max(ep_span.elapsed, 1e-9)
                if tb is not None:
                    for (s, _), lf in zip(pending, step_losses):
                        tb.add_scalar("Loss", lf, s)
                        tb.add_scalar("LearningRate",
                                      self.optimizer.lr_at(s), s)
                throughput = n_records / dt
                obs.gauge("zoo_tpu_train_throughput_examples_per_sec",
                          help="epoch training throughput").set(throughput)
                self._record_lr(None, self.step)
                diagnostics.update_device_memory_gauges()
                entry = {"epoch": epoch,
                         "loss": float(np.mean(step_losses)) if step_losses
                         else 0.0,
                         "losses": step_losses,
                         "throughput": throughput, "step": self.step}
                if ledger is not None:
                    gp = ledger.epoch_summary(epoch=epoch)
                    if gp is not None:
                        entry["goodput"] = gp
                if tb is not None:
                    tb.add_scalar("Throughput", throughput, self.step)
                if validation_data is not None and validation_trigger(
                        epoch, self.step, True):
                    # a Keras-style (x_val, y_val) pair is data and
                    # labels, not a two-input feature list
                    if isinstance(validation_data, tuple) and \
                            len(validation_data) == 2 and not hasattr(
                                validation_data, "iter_batches"):
                        val = self.evaluate(validation_data[0],
                                            validation_data[1],
                                            batch_size=batch_size)
                    else:
                        val = self.evaluate(validation_data,
                                            batch_size=batch_size)
                    entry.update({f"val_{k}": v for k, v in val.items()})
                    if tb is not None:
                        for k, v in val.items():
                            tb.add_scalar(f"Validation/{k}", v, self.step)
                if self.checkpoint_path and self.checkpoint_trigger(
                        epoch, self.step, True):
                    self.save_checkpoint()
                self._fire_summaries(tb, epoch, True)
                history.append(entry)
                logger.info("epoch %d: %s", epoch, entry)
                if stop or (end_trigger is not None and end_trigger(
                        epoch, self.step, True, loss=entry["loss"],
                        val_metrics={k[4:]: v for k, v in entry.items()
                                     if k.startswith("val_")})):
                    break
        finally:
            if self._profiling:     # the run ended inside the window
                self._stop_profile()
            if self._tb_writer is not None:
                self._tb_writer.flush()
                if self._tb_owns_writer:
                    self._tb_writer.close()
                    self._tb_writer = None
                    self._tb_owns_writer = False
        # durable on return: join an async checkpoint write
        self.wait_for_checkpoint()
        return TrainResult(history, self.params, self.opt_state, self.step)

    def _fire_summaries(self, tb, epoch: int, epoch_end: bool) -> None:
        trig = self._summary_triggers.get("Parameters")
        if tb is not None and trig is not None and trig(
                epoch, self.step, epoch_end):
            self._write_param_histograms(tb, self.step)
        trig = self._summary_triggers.get("LearningRate")
        if trig is not None and trig(epoch, self.step, epoch_end):
            self._record_lr(tb, self.step)

    @torch.no_grad()
    def evaluate(self, data, y=None, batch_size: int = 32
                 ) -> "dict[str, float]":
        """The mean loss and each metric over every sample (the tail
        batch included); the sums stay on the card until the end. One
        ``train/eval_run`` trace per call."""
        ds = to_dataset(data, y)
        self._ensure_initialized()
        if self.metrics and isinstance(self.model.output_shape, list):
            raise ValueError("metrics are not supported with multi-output "
                             "models yet; evaluate with metrics=[]")
        pairwise = _is_pairwise(self.loss_fn)
        total, count = 0.0, 0
        sums: "dict[str, dict]" = {m.name: {} for m in self.metrics}
        batches, place = self._batches(ds, batch_size, shuffle=False,
                                       drop_last=False)
        try:
            with tracing.trace("train/eval_run", step=self.step), \
                    obs.span("train/eval", step=self.step,
                             n=getattr(ds, "num_samples", None)):
                for batch in batches:
                    x, yt = place.take(batch)
                    total, n = self._eval_batch(x, yt, total, pairwise,
                                                sums)
                    count += n
        finally:
            batches.close()
        result = {"loss": float(total) / max(count, 1)}
        for m in self.metrics:
            result[m.name] = m.aggregate(
                {k: np.asarray(torch.as_tensor(v).cpu())
                 for k, v in sums[m.name].items()})
        return result

    def _eval_batch(self, x, yt, total, pairwise, sums):
        """Adds one batch's loss sum to ``total`` and its metric
        statistics to ``sums``; returns the new total and the batch's
        sample count."""
        out = self._forward_eval(x)
        n = _batch_dim(out)
        if pairwise:
            # the mean over (positive, negative) row pairs; an odd last
            # row has no partner and is left out, as in the reference
            n = n // 2
            if n:
                total = total + self.loss_fn(yt[:2 * n], out[:2 * n]) * n
        else:
            # a batch-mean loss times the batch: the per-sample sum
            total = total + _apply_loss(self.loss_fn, yt, out) * n
        for m in self.metrics:
            acc = sums[m.name]
            for k, v in m.batch_stats(yt, out).items():
                acc[k] = acc.get(k, 0) + v
        return total, n

    @torch.no_grad()
    def predict(self, data, batch_size: int = 32, params=None):
        """Outputs over every sample: an array, or one array per output
        of a multi-output model. ``params`` (a tree of the net's
        structure on its device) runs other weights than the net's own
        (an ``NNModel``'s)."""
        ds = to_dataset(data)
        self._ensure_initialized()
        batches, place = self._batches(ds, batch_size, shuffle=False,
                                       drop_last=False)
        try:
            outs = [to_numpy(self._forward_eval(place.take(batch)[0],
                                                params))
                    for batch in batches]
        finally:
            batches.close()
        return concat_outputs(outs)

    # -- checkpoints ---------------------------------------------------------
    def checkpoint_state(self) -> dict:
        """The checkpoint's contents, on the host, in the reference's
        format: ``{"params": numpy tree keyed by layer name, "opt_state":
        the leaves of the reference's optax state in its tree order,
        "step": int}``. One synchronous copy from the card: the step
        updates the params in place, so a background read would race
        the next step."""
        self._ensure_initialized()
        tree = self.model.params()
        params = tree_leaves(tree)
        moments = [t for k, v in self.opt_state.items() if k != "count"
                   for t in v]
        host = _host_copies(params + moments)
        # the param tree's own structure (layers without params keep
        # their empty dicts), its leaves on the host
        it = iter(host)
        tree = _fill_like(tree, it)
        # the moments as host arrays, in the state's own layout
        host_state = {k: (v if k == "count" else [next(it) for _ in v])
                      for k, v in self.opt_state.items()}
        return {"params": tree,
                "opt_state": self.optimizer.to_optax_leaves(
                    host_state, self._trainable_order()),
                "step": int(self.step)}

    def save_checkpoint(self, path: Optional[str] = None,
                        block: Optional[bool] = None) -> str:
        """Snapshot params, optimizer state and step to
        ``path/ckpt_<step>.pkl`` and point ``path/LATEST`` at it.

        The write is atomic: the pickle goes to ``.tmp_ckpt_<step>``, is
        fsynced and renamed; ``LATEST`` is promoted the same way, then
        the directory is fsynced. The fault point
        ``estimator/checkpoint_write`` fires between the bytes and the
        rename, so a failure there leaves only the tmp file, which no
        load reads. The copy from the card is synchronous; with
        ``block=False`` (or ``ZOO_TPU_ASYNC_CKPT=1``) the pickle and the
        write run on a non-daemon thread, and its error raises at the
        next save or :meth:`wait_for_checkpoint`. Sharded checkpoints
        wait for the multi-card slice."""
        path = path or self.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path set")
        if block is None:
            block = os.environ.get("ZOO_TPU_ASYNC_CKPT", "0") != "1"
        self.wait_for_checkpoint()   # one write at a time; raise its error
        os.makedirs(path, exist_ok=True)
        state = self.checkpoint_state()
        step = self.step

        def write():
            with obs.span("train/checkpoint", step=step):
                tmp = os.path.join(path, f".tmp_ckpt_{step}")
                with open(tmp, "wb") as f:
                    pickle.dump(state, f)
                    _CKPT_FAULT.fire(step=step)
                    f.flush()
                    os.fsync(f.fileno())
                final = os.path.join(path, f"ckpt_{step}.pkl")
                os.replace(tmp, final)
                latest = os.path.join(path, "LATEST")
                ltmp = latest + ".tmp"
                with open(ltmp, "w") as f:
                    f.write(os.path.basename(final))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(ltmp, latest)
                _fsync_dir(path)
            return final

        if block:
            return write()

        def worker():
            try:
                write()
            except BaseException as e:  # noqa: BLE001 — raised at the wait
                self._ckpt_error = e

        # non-daemon: a training process that dies mid-write still joins
        # the writer at exit, so the newest checkpoint lands
        t = threading.Thread(target=worker, daemon=False,
                             name="zoo-tpu-ckpt-write")
        t.start()
        self._ckpt_thread = t
        return os.path.join(path, f"ckpt_{step}.pkl")

    def _join_ckpt_write(self) -> None:
        """Join an in-flight async write without raising (safe inside
        ``finally``)."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None

    def wait_for_checkpoint(self) -> None:
        """Join an in-flight async checkpoint write; raise its error if
        it failed."""
        self._join_ckpt_write()
        err, self._ckpt_error = self._ckpt_error, None
        if err is not None:
            raise err

    def load_checkpoint(self, path: Optional[str] = None,
                        step: Optional[int] = None) -> "Estimator":
        """Resume from ``path``'s ``LATEST`` (or ``ckpt_<step>.pkl``): a
        checkpoint of this package or of the JAX package's Estimator.
        The file is read through the class whitelist
        (``common/safe_pickle.py``), which reads the reference's optax
        state classes as plain tuples; the state's leaves are poured into
        this model's optimizer state in the reference's tree order."""
        # join only: a failed async write stays pending for the next
        # save or wait, and LATEST then names the last good file
        self._join_ckpt_write()
        if self._ckpt_error is not None:
            logger.warning(
                "an async checkpoint write failed (%s); LATEST may point "
                "at an older step. The error re-raises at the next "
                "save_checkpoint/wait_for_checkpoint.", self._ckpt_error)
        path = path or self.checkpoint_path
        if step is not None:
            fname = os.path.join(path, f"ckpt_{step}.pkl")
        else:
            with open(os.path.join(path, "LATEST")) as f:
                latest = f.read().strip()
            if latest.startswith("sharded:"):
                raise NotImplementedError(
                    "sharded checkpoints wait for the multi-card slice")
            fname = os.path.join(path, latest)
        state = checked_load(fname)
        _check_params_compatible(self.model, state["params"])
        self.params = state["params"]
        self.opt_state = self.optimizer.from_optax_leaves(
            optax_leaves(state["opt_state"]), self._trainable_order(),
            self.trainable_leaves(), count=int(state["step"]))
        self.step = int(state["step"])
        return self


def _check_params_compatible(model, saved: dict) -> None:
    """Layer names are deterministic per architecture, so a checkpoint's
    keys must be this model's layer names exactly; a mismatch means
    another architecture (or renamed layers)."""
    expected = {lyr.name for lyr in model.layers}
    got = set(saved)
    if expected != got:
        raise ValueError(
            "checkpoint does not match model architecture; missing "
            f"layers {sorted(expected - got)}, unexpected "
            f"{sorted(got - expected)}")


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename in it is durable; where the
    filesystem refuses, only crash durability is lost, not atomicity."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fill_like(tree, leaves):
    """``tree``'s dicts with its leaves taken in order from the iterator
    ``leaves`` (:func:`tree_leaves`' order)."""
    if isinstance(tree, dict):
        return {k: _fill_like(v, leaves) for k, v in tree.items()}
    return next(leaves)


def _leaf_paths(tree, prefix=()) -> "list[tuple]":
    """The key path of each leaf, in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, prefix + (k,))]
    return [prefix]


def _sorted_leaves(tree):
    """The leaves and their paths in the reference's order (keys
    sorted)."""
    paths, leaves = _leaf_paths(tree), tree_leaves(tree)
    order = sorted(range(len(paths)), key=lambda i: paths[i])
    return [paths[i] for i in order], [leaves[i] for i in order]


def _host_copies(tensors: "list[torch.Tensor]") -> "list[np.ndarray]":
    """Each tensor as a host array, in one copy per dtype and device:
    the tensors are flattened into one buffer, brought over, and split."""
    out: "list" = [None] * len(tensors)
    groups: "dict" = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        ts = [tensors[i].detach() for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts]).cpu()
        if flat.dtype == torch.bfloat16:
            flat = flat.float()
        flat = flat.numpy()
        pos = 0
        for i, t in zip(idx, ts):
            n = t.numel()
            out[i] = flat[pos:pos + n].reshape(tuple(t.shape)).copy()
            pos += n
    return out
