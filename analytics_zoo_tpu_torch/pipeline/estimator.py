"""Estimator: train, evaluate and predict a Keras-style net on the card
(port of ``analytics_zoo_tpu/pipeline/estimator.py``, the single-card
core; checkpoints, TensorBoard, profiling, gradient clipping and the
fsdp/tp/ep modes wait).

A train step is the reference's, written eagerly: the net's ``apply``
in training mode under autograd, the loss (in f32 under the
``mixed_bfloat16`` policy, whose inputs go to the card as bf16 while
the params stay f32), the gradients of the trainable leaves, the
optimizer's in-place update, then the BatchNorm state updates copied
into the net's buffers. The weights live in the net itself
(``model.params()``), so ``predict`` and serving see every step. Inputs
may be one array or a list of them (BERT takes four). Each step hands
the net a seed, ``fold_in(base, step)`` with ``base`` drawn from the
context once per ``train`` call, from which the layers that draw noise
(dropout) derive theirs (``ops/rng.py``).

Input batches are prepared ahead of the step, as the reference does
(``_prefetch_iter``): a worker thread named ``zoo-tpu-prefetch`` runs
``ZOO_TPU_PREFETCH`` batches ahead (2 by default, 0 or less runs in
line). On the card the worker gathers each batch into a pinned host
buffer (a ring of depth + 1 per input), copies it on a copy stream of
its own and records an event, which the step's stream waits for before
it casts the inputs to bf16 under ``mixed_bfloat16``; the pageable copy
on the compute stream is gone. Each train step's wait for its batch is
observed in ``zoo_tpu_train_data_wait_seconds``.

Multi-output models follow the reference's Keras semantics: labels
given as a list of arrays are one column per output
(``feature.normalize_labels``), the loss sums one term per output
(``loss`` may be a list, one per output), and ``predict`` returns one
array per output.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common.nncontext import (
    NNContext, get_nncontext)
from analytics_zoo_tpu_torch.feature.feature_set import normalize_labels
from analytics_zoo_tpu_torch.ops import losses as losses_lib
from analytics_zoo_tpu_torch.ops import metrics as metrics_lib
from analytics_zoo_tpu_torch.ops import optimizers as optim_lib
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import tree_leaves
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    concat_outputs, to_numpy)

logger = logging.getLogger("analytics_zoo_tpu_torch")


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------

class Trigger:
    """Training-control predicate (the reference's BigDL ``Trigger``
    algebra, the everyEpoch/maxEpoch/maxIteration part)."""

    def __call__(self, epoch: int, iteration: int, epoch_end: bool,
                 **state) -> bool:
        raise NotImplementedError


class EveryEpoch(Trigger):
    def __call__(self, epoch, iteration, epoch_end, **state):
        return epoch_end


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
    if hasattr(data, "iter_batches"):
        return data
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
    """``train``/``evaluate``/``predict`` over a Keras-style net."""

    def __init__(self, model, optimizer="adam", loss="mse",
                 metrics: Optional[List] = None,
                 ctx: Optional[NNContext] = None,
                 dtype_policy: Optional[str] = None):
        # the reference defaults to bf16 activations on a TPU only: the
        # port's card is not one, so float32 unless asked
        dtype_policy = dtype_policy or "float32"
        if dtype_policy not in ("float32", "mixed_bfloat16"):
            raise ValueError("dtype_policy must be float32|mixed_bfloat16")
        self.dtype_policy = dtype_policy
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
        self.opt_state: Optional[dict] = None
        self.step = 0

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
                 drop_last: bool = True):
        """One pass over ``ds`` as placed batches ``(x, y, event)``,
        prefetched ``ZOO_TPU_PREFETCH`` ahead (the reference's
        ``_prefetch_iter`` over ``shard_batch``); returns the generator,
        which the caller closes, and the placer, whose ``take`` hands a
        batch to the step."""
        dev = self.model.device
        fdt = torch.bfloat16 if self._mixed else None
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
        self.optimizer.update(leaves, grads, self.opt_state)
        with torch.no_grad():
            self._merge_updates(params, state_upd)
        return loss.detach()

    def _forward_eval(self, x):
        out = self.model.call(self.model.params(), x, training=False)
        return _cast_floats(out, torch.float32) if self._mixed else out

    # -- API -----------------------------------------------------------------
    def train(self, data, y=None, batch_size: int = 32, nb_epoch: int = 1,
              end_trigger: Optional[Trigger] = None) -> TrainResult:
        """Train for ``nb_epoch`` epochs (or until ``end_trigger``). Each
        history entry has the epoch's mean loss, its per-step losses,
        throughput (examples/s, host clock) and the step count."""
        ds = to_dataset(data, y)
        self.ctx.check_batch_size(batch_size)
        self._ensure_initialized()
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
        base_rng = self.ctx.next_seed()
        history: "list[dict]" = []
        for epoch in range(1, nb_epoch + 1):
            pending: "list[torch.Tensor]" = []
            stop = False
            t0 = t_prev = time.perf_counter()
            batches, place = self._batches(ds, batch_size, shuffle=True,
                                           seed=epoch)
            try:
                for wait_s, batch in _timed_iter(batches):
                    wait_hist.observe(wait_s)
                    pending.append(self._train_step(
                        *place.take(batch), fold_in(base_rng, self.step)))
                    self.step += 1
                    now = time.perf_counter()
                    step_hist.observe(now - t_prev)
                    t_prev = now
                    steps_total.inc()
                    examples_total.inc(batch_size)
                    if end_trigger is not None and end_trigger(
                            epoch - 1, self.step, False):
                        stop = True
                        break
            finally:
                # a break or an exception stops the worker now, not at
                # garbage collection (it would hold depth + 1 batches)
                batches.close()
            # one fetch per epoch, not one sync per step
            step_losses = [float(v) for v in pending]
            dt = max(time.perf_counter() - t0, 1e-9)
            entry = {"epoch": epoch,
                     "loss": float(np.mean(step_losses)) if step_losses
                     else 0.0,
                     "losses": step_losses,
                     "throughput": len(pending) * batch_size / dt,
                     "step": self.step}
            history.append(entry)
            if stop or (end_trigger is not None and end_trigger(
                    epoch, self.step, True, loss=entry["loss"])):
                break
        return TrainResult(history, self.params, self.opt_state, self.step)

    @torch.no_grad()
    def evaluate(self, data, y=None, batch_size: int = 32
                 ) -> "dict[str, float]":
        """The mean loss and each metric over every sample (the tail
        batch included); the sums stay on the card until the end."""
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
            for batch in batches:
                x, yt = place.take(batch)
                total, n = self._eval_batch(x, yt, total, pairwise, sums)
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
    def predict(self, data, batch_size: int = 32):
        """Outputs over every sample: an array, or one array per output
        of a multi-output model."""
        ds = to_dataset(data)
        self._ensure_initialized()
        batches, place = self._batches(ds, batch_size, shuffle=False,
                                       drop_last=False)
        try:
            outs = [to_numpy(self._forward_eval(place.take(batch)[0]))
                    for batch in batches]
        finally:
            batches.close()
        return concat_outputs(outs)
