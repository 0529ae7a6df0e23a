"""InferenceModel: thread-safe serving wrapper (port of the
``load_keras_net``/``predict`` and ``load_generator``/``generate`` paths
of ``analytics_zoo_tpu/pipeline/inference/inference_model.py``).

A pool of ``supported_concurrent_num`` slots bounds how many predicts
run at once; the slots share one net (the reference's weight-sharing
clones). The pool is a Python queue of slot ids, the JAX package's
``PyServingQueue`` kind; its C++ queue and HTTP front-end are not
ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    KerasNet, to_numpy, to_tensor)


class SlotQueue:
    """Blocking pool of slot ids: ``take`` returns -1 on timeout."""

    def __init__(self, n: int):
        self._q: "queue.Queue[int]" = queue.Queue()
        for slot in range(n):
            self._q.put(slot)

    def put(self, slot: int) -> None:
        self._q.put(slot)

    def take(self, timeout_ms: int = -1) -> int:
        try:
            return self._q.get(
                timeout=None if timeout_ms < 0 else timeout_ms / 1000.0)
        except queue.Empty:
            return -1

    def size(self) -> int:
        return self._q.qsize()


class InferenceModel:
    def __init__(self, supported_concurrent_num: int = 1):
        self.supported_concurrent_num = int(supported_concurrent_num)
        self._net: Optional[KerasNet] = None
        self._queue = SlotQueue(self.supported_concurrent_num)
        self._lock = threading.Lock()
        self._generator = None

    def load_keras_net(self, net: KerasNet, params=None):
        """Serve an in-memory net. ``params`` (a tree of tensors or host
        arrays) is installed first; without it the net's own params are
        served, initialised from the process context if it has none."""
        if params is not None:
            net.load_params(params)
        elif not net.initialized:
            net.init_params()
        net.eval()
        # a fresh pool per load: slots held by in-flight predicts of
        # the old net return to the retired queue
        with self._lock:
            self._net = net
            self._queue = SlotQueue(self.supported_concurrent_num)
        return self

    def predict(self, inputs, timeout_ms: int = -1) -> np.ndarray:
        """Take a slot, run the forward on the net's device, return the
        slot. ``inputs``: a host array or tensor (a list of them for a
        multi-input net); the result is a host array (bf16 widened to
        f32)."""
        with self._lock:
            net, q = self._net, self._queue
        if net is None:
            raise RuntimeError("no model loaded")
        slot = q.take(timeout_ms)
        if slot < 0:
            obs.counter("zoo_tpu_serving_errors_total",
                        help="serving errors by kind",
                        labels={"kind": "slot_timeout"}).inc()
            raise TimeoutError(
                f"no free model slot within {timeout_ms}ms "
                f"(concurrency={self.supported_concurrent_num})")
        try:
            xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
            dev = net.device
            xs = [to_tensor(x, dev) for x in xs]
            obs.histogram("zoo_tpu_serving_batch_size",
                          help="predict batch size (leading dim)",
                          buckets=obs.SIZE_BUCKETS).observe(
                xs[0].shape[0] if xs[0].dim() else 1)
            with obs.span("serving/predict"), torch.inference_mode():
                out = net(xs[0] if len(xs) == 1 else xs)
                if isinstance(out, (list, tuple)):
                    return [to_numpy(o) for o in out]
                return to_numpy(out)
        finally:
            q.put(slot)

    # -- generation (pipeline/inference/generation.py) ------------------------
    def load_generator(self, net, params=None, **engine_kwargs):
        """Attach an autoregressive decode engine for ``net`` (a
        transformer stack with ``init_kv_cache / prefill / decode_step /
        generate``), beside the predict path. ``params`` defaults to the
        net's own, initialised from the context if it has none.
        ``engine_kwargs`` go to :class:`GenerationEngine`
        (``max_slots``, ``max_context``, ``page_size``, ``top_k``,
        ``cache_dtype``, ``device``; environment defaults)."""
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
        from analytics_zoo_tpu_torch.pipeline.inference.generation import \
            GenerationEngine
        if params is None:
            if not net.params():
                net.init(get_nncontext().new_generator())
            params = net.params()
        self._generator = GenerationEngine(net, params, **engine_kwargs)
        return self

    @property
    def generator(self):
        """The attached GenerationEngine, or None."""
        return self._generator

    def generate(self, prompts, max_new_tokens: int = 32, *,
                 temperature: float = 0.0, eos_id=None):
        """Sequential per-request generation (the baseline the
        continuous batcher is measured against). ``prompts``: one
        token-id list or a list of them. Returns a list of 1-D arrays of
        newly generated ids."""
        if self._generator is None:
            raise RuntimeError(
                "no generator loaded; call load_generator(net) first")
        return self._generator.generate(
            prompts, max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id)

    @property
    def concurrent_slots_free(self) -> int:
        return self._queue.size()

    def __repr__(self):
        return (f"InferenceModel(concurrency="
                f"{self.supported_concurrent_num}, "
                f"loaded={self._net is not None})")
