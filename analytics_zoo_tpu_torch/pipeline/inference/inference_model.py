"""InferenceModel: thread-safe serving wrapper (port of
``analytics_zoo_tpu/pipeline/inference/inference_model.py``: the
``load_keras_net``/``load``/``predict`` path with int8 serving, the
``DynamicBatcher``'s hooks and ``load_generator``/``generate``).

A pool of ``supported_concurrent_num`` slots bounds how many predicts
run at once; the slots share one net (the reference's weight-sharing
clones). The pool is a Python queue of slot ids, the JAX package's
``PyServingQueue`` kind.

Where the reference AOT-compiles its forward for the declared
``example_inputs``, the port records their signature: the
``DynamicBatcher`` warms one bucket callable per ladder size from it
(:meth:`InferenceModel.lower_for`), and ``/predict`` coerces JSON to
its dtypes. A declared ``torch.bfloat16`` example serves in bf16: the
host keeps f32 (numpy has no bf16) and each input is cast on the card
after its one host-to-device copy.

Not ported yet (ROADMAP A13): ``export_compiled``/``load_compiled``
(the reference's ``jax.export`` artifacts), ``load_tf`` and
``load_openvino``.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

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


def _spec(example) -> "tuple":
    """``(shape, host numpy dtype, dtype on the card)`` of one declared
    example input (a host array or a tensor)."""
    if isinstance(example, torch.Tensor):
        dev_dtype = example.dtype
        host = (np.dtype(np.float32) if dev_dtype == torch.bfloat16
                else np.dtype(str(dev_dtype).split(".")[-1]))
        return tuple(example.shape), host, dev_dtype
    arr = np.asarray(example)
    return tuple(arr.shape), arr.dtype, None


class InferenceModel:
    def __init__(self, supported_concurrent_num: int = 1):
        self.supported_concurrent_num = int(supported_concurrent_num)
        self._net: Optional[KerasNet] = None
        self._forward = None
        self._specs = None   # [(shape, host dtype, card dtype)] declared
        self._generation = 0
        self._queue = SlotQueue(self.supported_concurrent_num)
        self._lock = threading.Lock()
        self._generator = None
        self.quantized = None  # QuantizedModel when loaded with int8

    # -- loaders ------------------------------------------------------------
    def _swap_model(self, net, forward, specs):
        """Install the net, its forward, its declared input specs and a
        fresh slot pool under one lock, and bump ``generation``:
        :meth:`predict` snapshots them together, so a reload never pairs
        a new forward with stale specs. The pool is replaced, not
        drained: slots held by in-flight predicts of the old net return
        to the retired pool."""
        q = SlotQueue(self.supported_concurrent_num)
        with self._lock:
            self._net = net
            self._forward = forward
            self._specs = specs
            self._generation += 1
            self._queue = q

    def load(self, model_path: str,
             example_inputs: Optional[Sequence] = None,
             quantize: bool = False):
        """Load a saved ZooModel (``ZooModel.save_model`` output, the
        port's files) and serve its net; ``quantize=True`` serves int8
        (needs ``example_inputs`` for calibration)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel
        zm = ZooModel.load_model(model_path)
        return self.load_keras_net(zm.model, example_inputs=example_inputs,
                                   quantize=quantize)

    def load_keras_net(self, net: KerasNet, params=None,
                       example_inputs: Optional[Sequence] = None,
                       quantize: bool = False,
                       quantize_types: Optional[Sequence[str]] = None):
        """Serve an in-memory net. ``params`` (a tree of tensors or host
        arrays) is installed first; without it the net's own params are
        served, initialised from the process context if it has none.
        ``example_inputs`` (host arrays, or tensors: a bf16 one serves
        in bf16) declare the request signature. ``quantize=True`` swaps
        Dense kernels (and those of ``quantize_types``, e.g.
        ``("Dense", "Convolution2D")``) for int8 ones calibrated on
        ``example_inputs[0]`` (``inference/quantize.py``)."""
        if params is not None:
            net.load_params(params)
        elif not net.initialized:
            net.init_params()
        net.eval()
        if quantize:
            if example_inputs is None:
                raise ValueError(
                    "quantize=True needs example_inputs for "
                    "activation-scale calibration")
            from analytics_zoo_tpu_torch.pipeline.inference.quantize import \
                QuantizedModel
            kw = {} if quantize_types is None else \
                {"quantize_types": tuple(quantize_types)}
            qm = QuantizedModel(net, to_numpy(to_tensor(
                example_inputs[0], "cpu")), **kw)
            self.quantized = qm
            forward = qm.forward
        else:
            self.quantized = None
            forward = net
        self._swap_model(net, forward, None if example_inputs is None
                         else [_spec(e) for e in example_inputs])
        return self

    # -- predict ------------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            return self._net, self._forward, self._specs, self._queue

    @staticmethod
    def _run(net, forward, specs, xs):
        """One forward of host arrays (or tensors) ``xs`` on the net's
        device: one copy to the card per input (each then cast to its
        declared dtype), one copy back per output (bf16 widened to
        f32)."""
        dev = net.device
        cast = [s[2] for s in specs or ()]
        ts = [to_tensor(x, dev) for x in xs]
        ts = [t.to(cast[i]) if i < len(cast) and cast[i] is not None
              else t for i, t in enumerate(ts)]
        with torch.inference_mode():
            out = forward(ts[0] if len(ts) == 1 else ts)
            return to_numpy(out)

    def predict(self, inputs, timeout_ms: int = -1):
        """Take a slot, run the forward on the net's device, return the
        slot. ``inputs``: a host array or tensor (a list of them for a
        multi-input net); the result is a host array (bf16 widened to
        f32), or a list of them for a multi-output net."""
        net, forward, specs, q = self._snapshot()
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
            bdim = tuple(xs[0].shape)
            obs.histogram("zoo_tpu_serving_batch_size",
                          help="predict batch size (leading dim)",
                          buckets=obs.SIZE_BUCKETS).observe(
                bdim[0] if bdim else 1)
            with obs.span("serving/predict"):
                return self._run(net, forward, specs, xs)
        finally:
            q.put(slot)

    # -- dynamic-batching hooks (pipeline/inference/batching.py) ------------
    @property
    def generation(self) -> int:
        """Bumped on every model (re)load: the DynamicBatcher drops its
        bucket callables when it changes."""
        return self._generation

    @property
    def can_relower(self) -> bool:
        """Whether bucket callables can be made for new input shapes:
        true whenever a model is loaded (the port's forward takes any
        batch size)."""
        return self._net is not None

    @property
    def example_input_specs(self):
        """``[(shape, np.dtype), ...]`` of the declared example inputs
        as the host holds them (bf16 as f32), or ``None`` when the model
        was loaded without them."""
        with self._lock:
            specs = self._specs
        return None if specs is None else [(s[0], s[1]) for s in specs]

    def lower_for(self, example_args: Sequence):
        """The bucket callable for exactly these arguments (``(shape,
        dtype)`` pairs or arrays): ``fn(*host_arrays)`` runs the loaded
        forward under ``torch.inference_mode`` and returns host arrays.
        It is run once here on zeros of those shapes, on the calling
        thread, so kernels are built, cuDNN has chosen its algorithms
        and the allocator holds the blocks before the first request.
        :meth:`predict` is unaffected."""
        net, forward, specs, _ = self._snapshot()
        if net is None:
            raise RuntimeError("no model loaded")
        shapes = [(tuple(a[0]), np.dtype(a[1])) if isinstance(a, tuple)
                  else (tuple(a.shape), np.dtype(a.dtype))
                  for a in example_args]

        def fn(*xs):
            return InferenceModel._run(net, forward, specs, xs)

        fn(*[np.zeros(shape, dt) for shape, dt in shapes])
        return fn

    # -- generation (pipeline/inference/generation.py) ------------------------
    def load_generator(self, net, params=None, **engine_kwargs):
        """Attach an autoregressive decode engine for ``net`` (a
        transformer stack with ``init_kv_cache / prefill / decode_step /
        forward_chunk / generate``), beside the predict path. ``params``
        defaults to the net's own, initialised from the context if it
        has none. ``engine_kwargs`` go to :class:`GenerationEngine`
        (``max_slots``, ``max_context``, ``page_size``, ``top_k``,
        ``cache_dtype``, ``prefill_chunk``, ``spec_k``, ``role``,
        ``device``; environment defaults). For speculative decoding pass
        ``drafter=`` (a smaller net sharing the vocabulary);
        ``drafter_params`` defaults to the drafter's own params as
        ``params`` does to ``net``'s."""
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
        from analytics_zoo_tpu_torch.pipeline.inference.generation import \
            GenerationEngine

        def params_of(n, explicit):
            if explicit is not None:
                return explicit
            if not n.params():
                n.init(get_nncontext().new_generator())
            return n.params()

        params = params_of(net, params)
        drafter = engine_kwargs.get("drafter")
        if drafter is not None:
            engine_kwargs["drafter_params"] = params_of(
                drafter, engine_kwargs.get("drafter_params"))
        self._generator = GenerationEngine(net, params, **engine_kwargs)
        return self

    @property
    def generator(self):
        """The attached GenerationEngine, or None: how the server
        decides whether ``/generate`` has a model."""
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
