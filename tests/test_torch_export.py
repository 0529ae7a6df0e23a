"""The port's serving artifacts (``InferenceModel.export_compiled`` /
``load_compiled`` / ``load_openvino``) against the JAX package's, on the
CPU: the reference's six export tests (``test_inference_and_net.py``),
each on both packages over the same bridged Dense net, plus the port's
own cases.

Held: a load runs no trace and no compile (``torch.export.export`` and
``torch.compile`` patched to raise; ``jax.jit`` on the JAX side), the
loaded model's outputs bit for bit the port's in-memory ``predict`` and
within 1e-5 of max(1, max|ref|) of the JAX package's; a second process
serving the artifact; the deprecated ``load_openvino`` shim; the slot
pool after a reload; ``example_inputs`` required. The port's own: a net
of one ``FusedBottleneck`` at 8x8x64 (BatchNorm statistics from a numpy
seed) exports with both custom-op nodes (B5,
B6) in its graph and serves batch 3 through ``program_dyn.pt2`` bit for
bit the in-memory net (which ``test_torch_resnet.py`` holds to the JAX
package's folds); a
``DynamicBatcher`` warms its ladder from a loaded artifact; the refusals
(the JAX package's ``.zooaot``, a CPU artifact on the card, a newer
artifact, an int8 model, ``load_tf``).

Every net is tiny; each artifact is exported once per module.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    resnet as tr
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as te
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.inference import (DynamicBatcher,
                                                        InferenceModel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("port", "jax")
X = np.random.RandomState(0).randn(32, 4).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _dense(lib):
    # the reference tests' model: Dense 4→8 relu → 1 sigmoid
    m = JSequential() if lib is JL else tmodels.Sequential()
    m.add(lib.Dense(8, activation="relu", input_shape=(4,)))
    m.add(lib.Dense(1, activation="sigmoid"))
    return m


def _fresh(side):
    return InferenceModel if side == "port" else JInferenceModel


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """Per package: the Dense net on the same weights, loaded with an
    8-row example, its predict of X[:8] and its exported artifact."""
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    jm = _dense(JL)
    params = jax.device_get(jm.init_params(jax.random.key(0)))
    d = tmp_path_factory.mktemp("dense")
    out = {}
    for side in SIDES:
        im = _fresh(side)(supported_concurrent_num=2)
        if side == "port":
            im.load_keras_net(_dense(TL), params=params,
                              example_inputs=[X[:8]])
        else:
            im.load_keras_net(jm, params=jax.tree_util.tree_map(
                jnp.asarray, params), example_inputs=[X[:8]])
        art = str(d / f"{side}.zip")
        im.export_compiled(art)
        out[side] = {"im": im, "art": art,
                     "expected": np.asarray(im.predict(X[:8]))}
    _close(out["port"]["expected"], out["jax"]["expected"])
    yield out
    tzoo.reset_nncontext()


def _held(side, got, dense):
    """Bit for bit the package's own in-memory predict (the port) or
    within the reference's own 1e-6 (the JAX package); within 1e-5 of
    the other package either way."""
    if side == "port":
        assert np.array_equal(got, dense["port"]["expected"])
    else:
        np.testing.assert_allclose(got, dense["jax"]["expected"],
                                   rtol=1e-6, atol=1e-7)
    _close(got, dense["jax" if side == "port" else "port"]["expected"])


# -- the reference's six, on both packages ------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_export_compiled_roundtrip_no_recompile(dense, side, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("load_compiled must not trace or compile")
    if side == "port":
        monkeypatch.setattr(torch.export, "export", boom)
        monkeypatch.setattr(torch, "compile", boom)
    else:
        monkeypatch.setattr(jax, "jit", boom)
    im2 = _fresh(side)(supported_concurrent_num=2)
    im2.load_compiled(dense[side]["art"])
    monkeypatch.undo()
    _held(side, np.asarray(im2.predict(X[:8])), dense)
    assert im2.concurrent_slots_free == 2


def test_export_compiled_serves_in_second_process(dense, tmp_path):
    np.save(str(tmp_path / "x.npy"), X[:8])
    code = f"""
import numpy as np
import analytics_zoo_tpu_torch as zoo
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
zoo.init_nncontext(seed=0, device="cpu")
im = InferenceModel()
im.load_compiled({dense['port']['art']!r})
np.save({str(tmp_path / 'out.npy')!r},
        im.predict(np.load({str(tmp_path / 'x.npy')!r})))
print("SECOND_PROCESS_SERVE_OK")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, (p.stdout + p.stderr)[-2000:]
    assert "SECOND_PROCESS_SERVE_OK" in p.stdout
    _held("port", np.load(str(tmp_path / "out.npy")), dense)


@pytest.mark.parametrize("side", SIDES)
def test_load_openvino_is_delegating_shim(dense, side):
    im2 = _fresh(side)()
    with pytest.warns(DeprecationWarning, match="export_compiled"):
        im2.load_openvino(dense[side]["art"])
    _held(side, np.asarray(im2.predict(X[:8])), dense)


@pytest.mark.parametrize("side", SIDES)
def test_reload_does_not_inflate_slot_pool(dense, side):
    im = _fresh(side)(supported_concurrent_num=2)
    im.load_compiled(dense[side]["art"])
    gen = im.generation
    im.load_compiled(dense[side]["art"])   # a second load, same instance
    assert im.concurrent_slots_free == 2 and im.generation == gen + 1
    if side == "port":
        im.load_keras_net(_dense(TL), example_inputs=[X[:8]])
        assert im.concurrent_slots_free == 2


@pytest.mark.parametrize("side", SIDES)
def test_export_compiled_requires_example_inputs(dense, side, tmp_path):
    im = _fresh(side)()
    if side == "port":
        im.load_keras_net(_dense(TL))
    else:
        im.load_keras_net(_dense(JL), params=jax.tree_util.tree_map(
            jnp.asarray, jax.device_get(_dense(JL).init_params(
                jax.random.key(0)))))
    with pytest.raises(RuntimeError, match="example_inputs"):
        im.export_compiled(str(tmp_path / "m.zip"))


@pytest.mark.parametrize("side", SIDES)
def test_loaded_artifact_manifest(dense, side):
    im = _fresh(side)()
    im.load_compiled(dense[side]["art"])
    assert [(tuple(s), np.dtype(d)) for s, d in im.example_input_specs] \
        == [((8, 4), np.dtype(np.float32))]
    # both packages' artifacts carry a batch-symbolic program
    assert im.can_relower


# -- the port's own cases -----------------------------------------------------

def _bottleneck_net(E, L, R, M):
    inp = E.Input((8, 8, 64), name="image")
    x = R.FusedBottleneck(64, stride=1, downsample=True, name="b0")(inp)
    x = L.GlobalAveragePooling2D()(x)
    return M(inp, L.Dense(10, name="fc")(x))


@pytest.fixture(scope="module")
def bottleneck(tmp_path_factory):
    """One FusedBottleneck at 8x8x64 with BatchNorm statistics drawn
    from a numpy seed (so every fold matters), exported with a batch-4
    example."""
    tzoo.init_nncontext(seed=0, device="cpu")
    net = _bottleneck_net(te, TL, tr, tmodels.Model)
    net.init_params()
    rs = np.random.RandomState(3)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("moving_mean"):
                buf.copy_(torch.from_numpy(rs.randn(buf.shape[0]) * 0.1))
            elif name.endswith("moving_var"):
                buf.copy_(torch.from_numpy(rs.rand(buf.shape[0]) + 0.5))
    im = InferenceModel(2).load_keras_net(
        net, example_inputs=[np.zeros((4, 8, 8, 64), np.float32)])
    art = str(tmp_path_factory.mktemp("bottleneck") / "b.zip")
    im.export_compiled(art)
    yield {"im": im, "art": art}
    tzoo.reset_nncontext()


def test_fused_bottleneck_exports_both_ops_and_serves_batch_3(bottleneck):
    with zipfile.ZipFile(bottleneck["art"]) as z:
        names = set(z.namelist())
        meta = json.loads(z.read("meta.json"))
    assert names == {"meta.json", "program.pt2", "program_dyn.pt2"}
    assert meta["version"] == 1 and meta["platform"] == "cpu"
    assert meta["n_devices"] == 1
    assert meta["inputs"] == [{"shape": [4, 8, 8, 64], "dtype": "float32",
                               "cast": None}]
    im = InferenceModel().load_compiled(bottleneck["art"])
    assert InferenceModel().load_keras_net(
        _bottleneck_net(te, TL, tr, tmodels.Model)).programs is None
    for prog in im.programs.values():
        ops = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
        assert ops.count("zoo_torch.matmul_bn_apply.default") == 3
        assert ops.count("zoo_torch.conv3x3_bn_apply.default") == 1
    x = np.random.RandomState(4).rand(3, 8, 8, 64).astype(np.float32)
    got = im.predict(x)      # batch 3: program_dyn.pt2
    assert np.array_equal(got, bottleneck["im"].predict(x))


def test_dynamic_batcher_warms_its_ladder_from_an_artifact(bottleneck):
    im = InferenceModel().load_compiled(bottleneck["art"])
    b = DynamicBatcher(im, max_batch_size=4, max_wait_ms=2).start()
    try:
        assert b.stats()["warmed_buckets"] == len(b.buckets) == 3
        x = np.random.RandomState(5).rand(3, 8, 8, 64).astype(np.float32)
        got = b.submit([x]).result(timeout=60)
        got = got[0] if isinstance(got, list) else got
        assert np.array_equal(got, bottleneck["im"].predict(
            np.concatenate([x, np.zeros_like(x[:1])]))[:3])
    finally:
        b.stop()


def test_artifact_without_dyn_program_serves_declared_shape_only(
        bottleneck, tmp_path):
    art = str(tmp_path / "static.zip")
    with zipfile.ZipFile(bottleneck["art"]) as src, \
            zipfile.ZipFile(art, "w") as dst:
        for n in ("meta.json", "program.pt2"):
            dst.writestr(n, src.read(n))
    im = InferenceModel().load_compiled(art)
    assert not im.can_relower
    with pytest.raises(RuntimeError, match="program_dyn"):
        im.lower_for([((2, 8, 8, 64), np.float32)])
    x = np.random.RandomState(6).rand(4, 8, 8, 64).astype(np.float32)
    assert np.array_equal(im.predict(x), bottleneck["im"].predict(x))


def test_refuses_reference_zooaot(dense):
    with pytest.raises(ValueError, match="JAX package"):
        InferenceModel().load_compiled(dense["jax"]["art"])


def test_refuses_cpu_artifact_on_the_card_and_newer_versions(dense,
                                                             tmp_path):
    with pytest.raises(ValueError, match="re-export on a matching device"):
        InferenceModel().load_compiled(dense["port"]["art"], device="cuda")
    newer = str(tmp_path / "newer.zip")
    shutil.copy(dense["port"]["art"], newer)
    with zipfile.ZipFile(dense["port"]["art"]) as src, \
            zipfile.ZipFile(newer, "w") as dst:
        for n in src.namelist():
            blob = src.read(n)
            if n == "meta.json":
                blob = json.dumps(dict(json.loads(blob), version=2))
            dst.writestr(n, blob)
    with pytest.raises(ValueError, match="newer"):
        InferenceModel().load_compiled(newer)


def test_quantized_export_and_load_tf_raise(tmp_path):
    tzoo.init_nncontext(seed=0, device="cpu")
    im = InferenceModel().load_keras_net(
        _dense(TL), example_inputs=[X[:8]], quantize=True)
    with pytest.raises(NotImplementedError, match="QuantizedModel"):
        im.export_compiled(str(tmp_path / "q.zip"))
    with pytest.raises(NotImplementedError, match="A16e"):
        InferenceModel().load_tf(str(tmp_path))


def test_tracing_through_other_kernels_on_the_card_raises():
    # under tracing (fake tensors) on the card, a kernel that is no
    # operator names itself and the ROADMAP item; B5 and B6 trace into
    # their operators' fake implementations
    from torch._subclasses.fake_tensor import FakeTensorMode

    from analytics_zoo_tpu_torch.ops import conv_bn as tcb
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    with FakeTensorMode():
        x = torch.empty(2, 4, 4, 64, device="cuda")
        w = torch.empty(64, 128, device="cuda")
        w3 = torch.empty(3, 3, 64, 64, device="cuda")
        q = torch.empty(1, 128, 2, 64, device="cuda")
        assert tcb.conv1x1_bn_apply(x, w, stride=2).shape == (2, 2, 2, 128)
        assert tcb.conv3x3_bn_apply(x, w3).shape == (2, 4, 4, 64)
        with pytest.raises(NotImplementedError, match="matmul_bn:.*A13.7"):
            tcb.conv1x1_bn(x, w)
        with pytest.raises(NotImplementedError, match="flash_fwd:.*A13.7"):
            tfa.flash_attention(q, q, q)
