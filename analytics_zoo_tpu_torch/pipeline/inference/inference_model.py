"""InferenceModel: thread-safe serving wrapper (port of
``analytics_zoo_tpu/pipeline/inference/inference_model.py``: the
``load_keras_net``/``load``/``predict`` path with int8 serving, the
``DynamicBatcher``'s hooks, ``load_generator``/``generate`` and the
compiled serving artifacts).

A pool of ``supported_concurrent_num`` slots bounds how many predicts
run at once; the slots share one net (the reference's weight-sharing
clones). The pool is the native C++ queue (``native/serving_queue.cpp``),
or the Python one where the library cannot be built.

Where the reference AOT-compiles its forward for the declared
``example_inputs``, the port records their signature: the
``DynamicBatcher`` warms one bucket callable per ladder size from it
(:meth:`InferenceModel.lower_for`), and ``/predict`` coerces JSON to
its dtypes. A declared ``torch.bfloat16`` example serves in bf16: the
host keeps f32 (numpy has no bf16) and each input is cast on the card
after its one host-to-device copy.

The serving artifact (the reference's OpenVINO-IR role,
:meth:`InferenceModel.export_compiled` / :meth:`~InferenceModel.
load_compiled`) is a zip of ``meta.json``, ``program.pt2`` (the forward
at the declared shapes through ``torch.export``, weights embedded) and,
where it exports, ``program_dyn.pt2`` (the same with a symbolic batch).
The fused ResNet's eval folds are the ops ``zoo_torch::matmul_bn_apply``
and ``zoo_torch::conv3x3_bn_apply`` (``ops/conv_bn.py``), nodes of the
program that launch B5 and B6 when it runs on the card. The reference's
``.zooaot`` bundles (XLA executables) are refused. ``load_tf`` needs
``TFNet`` (ROADMAP A16e) and raises.
"""

from __future__ import annotations

import io
import json
import threading
import warnings
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common.nncontext import logger
from analytics_zoo_tpu_torch.native import make_serving_queue
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    KerasNet, to_numpy, to_tensor)

_ARTIFACT_VERSION = 1


def _slot_pool(n: int):
    q = make_serving_queue()
    for slot in range(n):
        q.put(slot)
    return q


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


def _device_inputs(device, specs, xs) -> "list":
    """Host arrays (or tensors) ``xs`` on ``device``, each cast to its
    declared dtype on the card."""
    cast = [s[2] for s in specs or ()]
    ts = [to_tensor(x, device) for x in xs]
    return [t.to(cast[i]) if i < len(cast) and cast[i] is not None else t
            for i, t in enumerate(ts)]


class _LoadedProgram:
    """A loaded artifact's forward: ``program.pt2`` at its declared
    shapes, ``program_dyn.pt2`` (when the artifact has one) at any other
    batch size."""

    def __init__(self, static, dynamic, shapes):
        self.static, self.dynamic, self.shapes = static, dynamic, shapes

    def __call__(self, inputs):
        ts = inputs if isinstance(inputs, list) else [inputs]
        if self.dynamic is None or \
                [tuple(t.shape) for t in ts] == self.shapes:
            return self.static(inputs)
        return self.dynamic(inputs)


def _relowerable(forward) -> bool:
    """Whether ``forward`` takes any batch size: a net's, or an artifact's
    with ``program_dyn.pt2``."""
    return forward is not None and not (
        isinstance(forward, _LoadedProgram) and forward.dynamic is None)


class InferenceModel:
    def __init__(self, supported_concurrent_num: int = 1):
        self.supported_concurrent_num = int(supported_concurrent_num)
        self._net: Optional[KerasNet] = None
        self._forward = None
        self._device: Optional[torch.device] = None
        self._specs = None   # [(shape, host dtype, card dtype)] declared
        self._generation = 0
        self._queue = _slot_pool(self.supported_concurrent_num)
        self._lock = threading.Lock()
        self._generator = None
        self.quantized = None  # QuantizedModel when loaded with int8

    # -- loaders ------------------------------------------------------------
    def _swap_model(self, net, forward, specs, device):
        """Install the net (None for a loaded artifact), its forward, its
        declared input specs, its device and a fresh slot pool under one
        lock, and bump ``generation``: :meth:`predict` snapshots them
        together, so a reload never pairs a new forward with stale specs.
        The pool is replaced, not drained: slots held by in-flight
        predicts of the old net return to the retired pool."""
        q = _slot_pool(self.supported_concurrent_num)
        with self._lock:
            self._net = net
            self._forward = forward
            self._specs = specs
            self._device = device
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
                         else [_spec(e) for e in example_inputs],
                         net.device)
        return self

    def load_tf(self, saved_model_path: str,
                example_inputs: Optional[Sequence] = None,
                signature: str = "serving_default"):
        """The reference's TF SavedModel loader bridges through
        ``TFNet`` (``jax2tf.call_tf``), which the port does not have yet
        (ROADMAP A16e, with ``tfpark``): raises."""
        raise NotImplementedError(
            "load_tf needs TFNet, not ported yet (ROADMAP A16e); export "
            "the model with export_compiled, or load a port's net with "
            "load_keras_net")

    def load_openvino(self, model_path: str, weight_path=None, **kwargs):
        """Deprecated delegating shim (the reference's): the OpenVINO-IR
        role, an on-disk serving artifact any process loads, is played by
        :meth:`export_compiled` / :meth:`load_compiled` bundles.
        ``model_path`` must be an ``export_compiled`` artifact;
        ``weight_path`` is ignored (weights are embedded).

        TRUST MODEL: an OpenVINO IR load fails safely on a bad file; this
        shim delegates to :meth:`load_compiled`, whose programs
        deserialize through ``torch.export.load`` and run with the
        loader's privileges. Load artifacts only from sources you
        trust."""
        warnings.warn(
            "load_openvino is deprecated; pass an export_compiled() "
            "artifact (delegating to load_compiled, whose programs "
            "deserialize through torch.export.load: load artifacts only "
            "from sources you trust)", DeprecationWarning, stacklevel=2)
        return self.load_compiled(model_path)

    # -- the serving artifact (the OpenVINO-IR role) --------------------------
    def export_compiled(self, path: str) -> str:
        """Write the serving program to ``path``, a zip that another
        process loads with :meth:`load_compiled` and serves without the
        model's code: ``meta.json``; ``program.pt2``, ``torch.export`` of
        the forward at the declared ``example_inputs`` with the weights
        embedded; and ``program_dyn.pt2``, the same with a symbolic batch
        dimension (skipped, with a log line, where the forward does not
        export under one). A declared bf16 input is exported in bf16 and
        the manifest keeps its host dtype beside it. Needs a net loaded
        with ``example_inputs``; an int8 ``QuantizedModel`` raises
        ``NotImplementedError``. A forward that reaches a hand-written
        kernel other than B5 and B6 on the card raises naming it (only
        those two are operators: ``ops/conv_bn.py``'s ``untraceable``)."""
        net, forward, specs, _, device = self._snapshot()
        if net is None or specs is None:
            raise RuntimeError(
                "export_compiled needs a model loaded with example_inputs "
                "(load_keras_net(net, example_inputs=...))")
        if self.quantized is not None:
            raise NotImplementedError(
                "export_compiled supports load/load_keras_net models; "
                "int8 programs (QuantizedModel) do not export")
        xs = _device_inputs(device, specs,
                            [np.zeros(s[0], s[1]) for s in specs])
        args = (xs[0] if len(xs) == 1 else xs,)
        with torch.no_grad():
            program = torch.export.export(net, args)
            batch = torch.export.Dim("batch")
            dims = [{0: batch} for _ in xs]
            try:
                dyn = torch.export.export(
                    net, args, dynamic_shapes=(dims[0] if len(xs) == 1
                                               else dims,))
            except Exception as e:
                dyn = None
                logger.info("export under a symbolic batch unavailable "
                            "(%s: %s); the artifact serves its declared "
                            "shapes only", type(e).__name__, e)
        from torch.utils import _pytree
        meta = {
            "version": _ARTIFACT_VERSION,
            "platform": device.type,
            "torch_version": torch.__version__,
            "n_devices": 1,
            "in_spec": _pytree.treespec_dumps(program.call_spec.in_spec),
            "out_spec": _pytree.treespec_dumps(program.call_spec.out_spec),
            "inputs": [{"shape": list(s[0]), "dtype": str(s[1]),
                        "cast": None if s[2] is None
                        else str(s[2]).split(".")[-1]} for s in specs],
        }
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("meta.json", json.dumps(meta))
            for name, prog in (("program.pt2", program),
                               ("program_dyn.pt2", dyn)):
                if prog is not None:
                    buf = io.BytesIO()
                    torch.export.save(prog, buf)
                    z.writestr(name, buf.getvalue())
        logger.info("exported serving artifact -> %s (%d inputs, platform "
                    "%s, symbolic batch %s)", path, len(specs),
                    meta["platform"], dyn is not None)
        return path

    def load_compiled(self, path: str, device=None):
        """Load an :meth:`export_compiled` bundle and serve it on
        ``device`` (the context's by default): no tracing, no compile, no
        model code. An artifact exported on the card loads on the card,
        or on the CPU (its program moved there); a CPU artifact on the
        card, an artifact newer than this runtime, and the JAX package's
        ``.zooaot`` bundles raise ``ValueError``. ``generation`` bumps
        and the slot pool is replaced; bucket callables for other batch
        sizes (:meth:`lower_for`) need ``program_dyn.pt2``.

        TRUST MODEL: like any executable format (an OpenVINO IR, a shared
        library), a bundle runs with the loader's privileges: its
        programs deserialize through ``torch.export.load``. Load
        artifacts only from sources you trust."""
        # registers zoo_torch::matmul_bn_apply and conv3x3_bn_apply
        from analytics_zoo_tpu_torch.ops import conv_bn  # noqa: F401
        if device is None:
            from analytics_zoo_tpu_torch.common.nncontext import \
                get_nncontext
            device = get_nncontext().device
        device = torch.device(device)
        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            meta = json.loads(z.read("meta.json").decode())
            if "program.pt2" not in names:
                raise ValueError(
                    f"{path} is not a port artifact (no program.pt2): the "
                    "JAX package's .zooaot bundles hold XLA executables; "
                    "re-export the model with this package's "
                    "export_compiled")
            if meta.get("version", 0) > _ARTIFACT_VERSION:
                raise ValueError(
                    f"artifact version {meta.get('version')} is newer "
                    f"than this runtime's {_ARTIFACT_VERSION}")
            if meta["platform"] == "cpu" and device.type != "cpu":
                raise ValueError(
                    f"artifact was exported for cpu; this model serves on "
                    f"{device}: re-export on a matching device")
            blobs = {n: z.read(n) for n in ("program.pt2",
                                            "program_dyn.pt2")
                     if n in names}

        def module(blob):
            prog = torch.export.load(io.BytesIO(blob))
            if meta["platform"] != device.type or device.index not in \
                    (None, 0):
                from torch.export.passes import move_to_device_pass
                prog = move_to_device_pass(prog, device)
            return prog.module()

        specs = [(tuple(i["shape"]), np.dtype(i["dtype"]),
                  None if i.get("cast") is None
                  else getattr(torch, i["cast"])) for i in meta["inputs"]]
        dyn = blobs.get("program_dyn.pt2")
        forward = _LoadedProgram(module(blobs["program.pt2"]),
                                 None if dyn is None else module(dyn),
                                 [s[0] for s in specs])
        self.quantized = None     # any prior int8 load is replaced
        self._swap_model(None, forward, specs, device)
        logger.info("loaded serving artifact %s on %s (symbolic batch %s)",
                    path, device, forward.dynamic is not None)
        return self

    # -- predict ------------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            return (self._net, self._forward, self._specs, self._queue,
                    self._device)

    @staticmethod
    def _run(device, forward, specs, xs):
        """One forward of host arrays (or tensors) ``xs`` on ``device``:
        one copy to the card per input (each then cast to its declared
        dtype), one copy back per output (bf16 widened to f32)."""
        ts = _device_inputs(device, specs, xs)
        with torch.inference_mode():
            out = forward(ts[0] if len(ts) == 1 else ts)
            return to_numpy(out)

    def predict(self, inputs, timeout_ms: int = -1):
        """Take a slot, run the forward on the model's device, return the
        slot. ``inputs``: a host array or tensor (a list of them for a
        multi-input net); the result is a host array (bf16 widened to
        f32), or a list of them for a multi-output net."""
        _, forward, specs, q, device = self._snapshot()
        if forward is None:
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
                return self._run(device, forward, specs, xs)
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
        true for a loaded net (its forward takes any batch size) and for
        an artifact with ``program_dyn.pt2``."""
        with self._lock:
            return _relowerable(self._forward)

    @property
    def programs(self):
        """A loaded artifact's programs, ``{"program.pt2": module,
        "program_dyn.pt2": module or None}`` (the ``torch.fx``
        ``GraphModule`` s it runs, for inspection); None for a net."""
        with self._lock:
            fwd = self._forward
        if not isinstance(fwd, _LoadedProgram):
            return None
        return {"program.pt2": fwd.static, "program_dyn.pt2": fwd.dynamic}

    @property
    def example_input_specs(self):
        """``[(shape, np.dtype), ...]`` of the declared example inputs
        as the host holds them (bf16 as f32), from ``example_inputs`` or
        an artifact's manifest; ``None`` when the model was loaded
        without them."""
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
        :meth:`predict` is unaffected. Raises for an artifact without
        ``program_dyn.pt2``."""
        _, forward, specs, _, device = self._snapshot()
        if not _relowerable(forward):
            raise RuntimeError(
                "model cannot serve new shapes (a load_compiled artifact "
                "without program_dyn.pt2, or no model loaded)")
        shapes = [(tuple(a[0]), np.dtype(a[1])) if isinstance(a, tuple)
                  else (tuple(a.shape), np.dtype(a.dtype))
                  for a in example_args]

        def fn(*xs):
            return InferenceModel._run(device, forward, specs, xs)

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
                f"loaded={self._forward is not None})")
