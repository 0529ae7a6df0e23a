"""The slice as a whole: ResNet-50 served through the PyTorch port's
entry points (``ImageClassifier(fused=True)`` →
``InferenceModel.load_keras_net`` → ``predict``) against the JAX
package's same chain (tests/test_inference_and_net.py), on the same
numpy weights and images; plus the weight bridge, the port's purity
(no JAX), the context's device rule and the serving slot pool.

The JAX side serves its Pallas eval folds in interpret mode; the port's
runs the plain versions on the CPU. f32 rtol/atol 1e-3, the bound of
the JAX package's own fused-vs-unfused serving test.
"""

import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.models.image.imageclassification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.bridge import params_from_numpy, \
    params_to_numpy
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier, convert_resnet_params)
from analytics_zoo_tpu_torch.ops import conv_bn as tcb
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_context():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    yield
    tzoo.reset_nncontext()


def _distinct_stats(tree, rs):
    for v in tree.values():
        if isinstance(v, dict) and "_state" in v:
            n = v["_state"]["moving_mean"].shape[0]
            v["_state"]["moving_mean"] = (rs.randn(n) * 0.1).astype(
                np.float32)
            v["_state"]["moving_var"] = (rs.rand(n) + 0.5).astype(
                np.float32)
        elif isinstance(v, dict):
            _distinct_stats(v, rs)
    return tree


@pytest.fixture(scope="module")
def jax_served():
    """The JAX package serving its fused ResNet-50 (32x32, 10 classes)
    with distinctive moving stats: (numpy params, images, logits)."""
    rs = np.random.RandomState(0)
    clf = JImageClassifier("resnet-50", input_shape=(32, 32, 3),
                           classes=10, fused=True)
    params = _distinct_stats(jax.device_get(
        clf.model.init_params(jax.random.key(0))), rs)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    im = JInferenceModel()
    im.load_keras_net(clf.model,
                      params=jax.tree_util.tree_map(jnp.asarray, params))
    return params, x, np.asarray(im.predict(x))


def test_serving_slice_matches_jax(jax_served):
    params, x, want = jax_served
    clf = ImageClassifier("resnet-50", input_shape=(32, 32, 3), classes=10,
                          fused=True)
    im = InferenceModel(supported_concurrent_num=2)
    im.load_keras_net(clf.model, params=params)
    before = dict(tcb.launches)
    got = im.predict(x)
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # CPU serving ran the plain versions: nothing launched
    assert tcb.launches == before
    snap = tobs.snapshot()
    assert snap["zoo_tpu_serving_batch_size"]["values"][0]["count"] == 1
    assert snap["zoo_tpu_serving_predict_seconds"]["values"][0][
        "count"] == 1


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_fused_param_tree_matches_jax(jax_served):
    params, _, _ = jax_served
    clf = ImageClassifier("resnet-50", input_shape=(32, 32, 3), classes=10,
                          fused=True)
    ported = clf.model.init_params()
    assert _shapes(ported) == _shapes(params)


def test_serving_fused_matches_unfused_port(jax_served):
    params, x, _ = jax_served
    fused = ImageClassifier("resnet-50", input_shape=(32, 32, 3),
                            classes=10, fused=True)
    unfused = ImageClassifier("resnet-50", input_shape=(32, 32, 3),
                              classes=10, fused=False)
    fused.model.load_params(params)
    unfused.model.init_params()
    unfused.model.load_params(convert_resnet_params(
        params, params_to_numpy(unfused.model)))
    np.testing.assert_allclose(fused.predict(x), unfused.predict(x),
                               rtol=1e-3, atol=1e-3)
    assert fused.predict_classes(x).shape == (2,)


def test_bridge_round_trip_is_bit_exact(jax_served):
    params, _, _ = jax_served
    clf = ImageClassifier("resnet-50", input_shape=(32, 32, 3), classes=10,
                          fused=True)
    clf.model.load_params(params)
    back = params_to_numpy(clf.model)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port holds copies, not views of the caller's arrays
    t = params_from_numpy(params)
    t["fc"]["bias"] += 1
    assert not np.array_equal(t["fc"]["bias"].numpy(), params["fc"]["bias"])


def test_port_imports_no_jax():
    # a fresh process builds and runs ResNet-50 through the port and
    # imports the judgement layer; JAX and the JAX package are never
    # imported
    code = (
        "import sys, numpy as np\n"
        "import analytics_zoo_tpu_torch as z\n"
        "from analytics_zoo_tpu_torch.common import (federation, forecast,"
        " slo, timeseries)\n"
        "from analytics_zoo_tpu_torch.models.image.imageclassification "
        "import resnet50\n"
        "from analytics_zoo_tpu_torch.pipeline.inference import "
        "InferenceModel\n"
        "z.init_nncontext(device='cpu')\n"
        "m = resnet50(input_shape=(32, 32, 3), classes=10, fused=True)\n"
        "im = InferenceModel().load_keras_net(\n"
        "    m, example_inputs=[np.zeros((2, 32, 32, 3), np.float32)])\n"
        "y = im.predict(np.zeros((1, 32, 32, 3), np.float32))\n"
        "assert y.shape == (1, 10)\n"
        "# the HTTP front end, its batcher and tracing, started and\n"
        "# stopped\n"
        "import json, urllib.request\n"
        "from analytics_zoo_tpu_torch.pipeline.inference import (\n"
        "    DynamicBatcher, make_inference_server)\n"
        "srv = make_inference_server(im, batcher=DynamicBatcher(\n"
        "    im, max_batch_size=2)).start()\n"
        "try:\n"
        "    r = urllib.request.urlopen(urllib.request.Request(\n"
        "        f'http://127.0.0.1:{srv.port}/predict', data=json.dumps(\n"
        "            {'inputs': np.zeros((1, 32, 32, 3)).tolist()}\n"
        "        ).encode()), timeout=120)\n"
        "    assert len(json.loads(r.read())['outputs'][0]) == 10\n"
        "finally:\n"
        "    srv.stop()\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'analytics_zoo_tpu' or "
        "k.startswith('analytics_zoo_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]


def test_package_and_smoke_script_name_no_jax():
    # static check: no module of the port, nor chip_smoke.py, imports
    # jax or the JAX package
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.join(ROOT, "analytics_zoo_tpu_torch")
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "analytics_zoo_tpu"), \
                    f"{path} imports {mod}"


def test_init_nncontext_defaults_to_the_card(monkeypatch):
    tzoo.reset_nncontext()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.init_nncontext()
    ctx = tzoo.init_nncontext(seed=3, device="cpu")
    assert ctx.device == torch.device("cpu")
    assert tzoo.get_nncontext() is ctx
    # generators drawn from the same seed repeat
    a = ctx.new_generator().initial_seed()
    b = tzoo.init_nncontext(seed=3, device="cpu").new_generator()
    assert b.initial_seed() == a


class _SlowNet(Sequential):
    """A one-layer net whose forward sleeps, recording concurrency."""

    def __init__(self):
        super().__init__([TL.Activation("linear", input_shape=(4,))])
        self.active = 0
        self.peak = 0
        self.lock = threading.Lock()

    def forward(self, x):
        with self.lock:
            self.active += 1
            self.peak = max(self.peak, self.active)
        time.sleep(0.05)
        with self.lock:
            self.active -= 1
        return x * 2


def test_concurrent_predict_respects_slots():
    net = _SlowNet()
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(net)
    x = np.ones((3, 4), np.float32)
    results, errors = [], []

    def worker():
        try:
            for _ in range(3):
                results.append(im.predict(x))
        except Exception as e:        # surfaced by the assert below
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 12
    assert all(np.array_equal(r, x * 2) for r in results)
    assert net.peak == 2            # both slots used, never more
    assert im.concurrent_slots_free == 2


def test_slot_timeout_raises():
    net = _SlowNet()
    im = InferenceModel(supported_concurrent_num=1).load_keras_net(net)
    with pytest.raises(RuntimeError, match="no model loaded"):
        InferenceModel().predict(np.ones((1, 4), np.float32))
    slot = im._queue.take()          # hold the only slot
    try:
        with pytest.raises(TimeoutError, match="no free model slot"):
            im.predict(np.ones((1, 4), np.float32), timeout_ms=20)
    finally:
        im._queue.put(slot)
    snap = tobs.snapshot()["zoo_tpu_serving_errors_total"]["values"]
    assert snap == [{"labels": {"kind": "slot_timeout"}, "value": 1.0}]
    assert im.predict(np.ones((1, 4), np.float32)).shape == (1, 4)
