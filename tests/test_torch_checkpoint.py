"""The port's checkpoints (``Estimator.save_checkpoint`` /
``load_checkpoint``) on the CPU: a resume equals the uninterrupted run
bit for bit; async writes; the torn-checkpoint cases of
``tests/test_faults.py`` (a kill between the bytes and the rename, an
async error surfacing at the wait), each resuming the last good file;
files crossing between the packages both ways (a JAX ``Estimator``
checkpoint resumed by the port and a port checkpoint resumed by the JAX
``Estimator``, each continuing to the other package's uninterrupted
losses, with SGD momentum and with Adam); the bridge's conversion of a
checkpoint dict; the class whitelist; ``_check_params_compatible``.

Tolerances: the port against itself bit for bit; across the packages
1e-5 of max(1, |loss|) per loss (f32 arithmetic in another order) and
the restored state bit for bit.
"""

import os
import pickle

import jax
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JS
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch import bridge
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common.faults import (
    InjectedFaultError, InjectedKillError)
from analytics_zoo_tpu_torch.common.safe_pickle import (
    UnsafePickleError, checked_load, checked_loads)
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.estimator import (
    SeveralIteration, _check_params_compatible)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    faults.reset_faults()
    yield
    faults.reset_faults()
    jfaults.reset_faults()
    tzoo.reset_nncontext()


def _net(lib, model):
    model.add(lib.Dense(8, activation="relu", input_shape=(5,)))
    model.add(lib.BatchNormalization())
    model.add(lib.Dense(3))
    return model


def _port(optimizer):
    m = _net(TL, Sequential())
    m.compile(optimizer=optimizer, loss="mse")
    return m


def _jax(optimizer, seed=3):
    jinit(seed=seed)
    m = _net(JL, JS())
    m.compile(optimizer=optimizer, loss="mse")
    return m


def _data(seed):
    rs = np.random.RandomState(seed)
    return rs.randn(32, 5).astype(np.float32), \
        rs.randn(32, 3).astype(np.float32)


def _losses(model, x, y):
    """Four steps, one per epoch (the whole batch): each epoch's loss is
    its step's in both packages."""
    return [h["loss"] for h in model.fit(x, y, batch_size=32,
                                         nb_epoch=4).history]


OPTS = {"sgd_momentum": (lambda: topt.SGD(0.1, momentum=0.9),
                         lambda: jopt.SGD(0.1, momentum=0.9)),
        "adam": (lambda: topt.Adam(1e-2), lambda: jopt.Adam(1e-2))}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, opt):
    (xa, ya), (xb, yb) = _data(0), _data(1)
    a = _port(OPTS[opt][0]())
    w0 = a.get_weights()
    want = _losses(a, xa, ya) + _losses(a, xb, yb)
    b = _port(OPTS[opt][0]())
    b.set_weights(w0)
    assert _losses(b, xa, ya) == want[:4]
    path = b.estimator.save_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "ckpt_4.pkl"
    saved = checked_load(path)
    c = _port(OPTS[opt][0]())
    c.estimator.load_checkpoint(str(tmp_path))
    restored = c.estimator.checkpoint_state()
    assert restored["step"] == saved["step"] == 4
    assert len(restored["opt_state"]) == len(saved["opt_state"])
    for p, q in zip(restored["opt_state"], saved["opt_state"]):
        assert p.dtype == q.dtype and np.array_equal(p, q)
    for lyr, sub in saved["params"].items():
        for k, v in jax.tree_util.tree_leaves_with_path(sub):
            got = restored["params"][lyr]
            for key in k:
                got = got[key.key]
            assert np.array_equal(got, v)
    assert _losses(c, xb, yb) == want[4:]


def test_async_writes_and_the_trigger(tmp_path, monkeypatch):
    x, y = _data(2)
    m = _port(topt.SGD(0.05, momentum=0.9))
    d = str(tmp_path / "ck")
    monkeypatch.setenv("ZOO_TPU_ASYNC_CKPT", "1")
    m.set_checkpoint(d, SeveralIteration(3))
    m.fit(x, y, batch_size=8, nb_epoch=2)       # 8 steps: 3 and 6
    names = sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))
    assert names == ["ckpt_3.pkl", "ckpt_6.pkl"]
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read().strip() == "ckpt_6.pkl"
    assert not any(f.startswith(".tmp") for f in os.listdir(d))
    # an explicit async save returns before the write, which the wait
    # joins; the thread is not a daemon (a dying process still joins it)
    est = m.estimator
    est.save_checkpoint(d, block=False)
    assert est._ckpt_thread is not None and not est._ckpt_thread.daemon
    est.wait_for_checkpoint()
    assert checked_load(os.path.join(d, "ckpt_8.pkl"))["step"] == 8
    assert tobs.snapshot()["zoo_tpu_train_checkpoint_seconds"][
        "values"][0]["count"] >= 3


def _fit_model(seed):
    tzoo.init_nncontext(seed=seed, device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = (x @ rs.randn(4, 1)).astype(np.float32)
    m = Sequential()
    m.add(TL.Dense(1, input_shape=(4,)))
    m.compile(optimizer=topt.Adam(lr=0.05), loss="mse")
    m.fit(x, y, batch_size=32, nb_epoch=1)
    return m, x, y


def _fresh_dense():
    m = Sequential()
    m.add(TL.Dense(1, input_shape=(4,)))
    m.compile(optimizer=topt.Adam(lr=0.05), loss="mse")
    return m


def test_torn_checkpoint_is_never_loaded(tmp_path):
    m, x, y = _fit_model(8)
    est = m.estimator
    d = str(tmp_path / "ckpt")
    est.save_checkpoint(d)
    step_a = est.step
    params_a = m.get_weights()
    m.fit(x, y, batch_size=32, nb_epoch=1)
    assert est.step > step_a
    faults.arm("estimator/checkpoint_write", "kill")
    with pytest.raises(InjectedKillError):
        est.save_checkpoint(d)      # dies after the bytes, before rename
    names = sorted(os.listdir(d))
    assert f"ckpt_{step_a}.pkl" in names
    assert f"ckpt_{est.step}.pkl" not in names
    assert any(n.startswith(".tmp_ckpt_") for n in names)
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read().strip() == f"ckpt_{step_a}.pkl"
    m2 = _fresh_dense()
    m2.estimator.load_checkpoint(d)
    assert m2.estimator.step == step_a
    for a, b in zip(m2.get_weights(), params_a):
        np.testing.assert_array_equal(a, b)


def test_async_torn_checkpoint_surfaces_and_resumes(tmp_path):
    m, x, y = _fit_model(9)
    est = m.estimator
    d = str(tmp_path / "ckpt")
    est.save_checkpoint(d)
    step_a = est.step
    m.fit(x, y, batch_size=32, nb_epoch=1)
    faults.arm("estimator/checkpoint_write", "error")
    est.save_checkpoint(d, block=False)
    # a load joins the writer without raising: the error stays pending
    # and LATEST still names the good file
    est.load_checkpoint(d)
    assert est.step == step_a
    with pytest.raises(InjectedFaultError):
        est.wait_for_checkpoint()
    est.wait_for_checkpoint()            # raised once
    m2 = _fresh_dense()
    m2.estimator.load_checkpoint(d)
    assert m2.estimator.step == step_a
    res = m2.fit(x, y, batch_size=32, nb_epoch=1)
    assert np.isfinite(res.history[-1]["loss"])


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_a_reference_checkpoint_resumes_in_the_port(tmp_path, opt):
    (xa, ya), (xb, yb) = _data(0), _data(1)
    jm = _jax(OPTS[opt][1]())
    _losses(jm, xa, ya)
    jm.estimator.save_checkpoint(str(tmp_path))
    want = _losses(jm, xb, yb)                # the reference continues
    tm = _port(OPTS[opt][0]())
    tm.estimator.load_checkpoint(str(tmp_path))
    assert tm.estimator.step == 4
    # the restored state is the file's, bit for bit
    ref = bridge.checkpoint_from_reference(
        checked_load(os.path.join(str(tmp_path), "ckpt_4.pkl")))
    got = tm.estimator.checkpoint_state()
    for a, b in zip(got["opt_state"], ref["opt_state"]):
        assert np.array_equal(a, b)
    got_losses = _losses(tm, xb, yb)
    np.testing.assert_allclose(got_losses, want, rtol=TOL,
                               atol=TOL * max(1.0, max(map(abs, want))))


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_a_port_checkpoint_resumes_in_the_reference(tmp_path, opt):
    (xa, ya), (xb, yb) = _data(0), _data(1)
    tm = _port(OPTS[opt][0]())
    _losses(tm, xa, ya)
    tm.estimator.save_checkpoint(str(tmp_path))
    want = _losses(tm, xb, yb)                # the port continues
    jm = _jax(OPTS[opt][1](), seed=5)
    jm.estimator.load_checkpoint(str(tmp_path))
    assert jm.estimator.step == 4
    got_losses = _losses(jm, xb, yb)
    np.testing.assert_allclose(got_losses, want, rtol=TOL,
                               atol=TOL * max(1.0, max(map(abs, want))))
    assert jm.estimator.step == 8


def test_the_bridge_converts_checkpoints_both_ways(tmp_path):
    x, y = _data(0)
    jm = _jax(jopt.Adam(1e-2))
    _losses(jm, x, y)
    jm.estimator.save_checkpoint(str(tmp_path))
    with open(os.path.join(str(tmp_path), "ckpt_4.pkl"), "rb") as f:
        ref = pickle.load(f)             # the real optax classes
    port = bridge.checkpoint_from_reference(ref)
    assert isinstance(port["opt_state"], list) and port["step"] == 4
    back = bridge.checkpoint_to_reference(port, ref["opt_state"])
    assert jax.tree_util.tree_structure(back["opt_state"]) == \
        jax.tree_util.tree_structure(ref["opt_state"])
    for a, b in zip(jax.tree_util.tree_leaves(back["opt_state"]),
                    jax.tree_util.tree_leaves(ref["opt_state"])):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        bridge.checkpoint_to_reference(
            dict(port, opt_state=port["opt_state"][1:]), ref["opt_state"])
    # the whitelist reads the same file with stand-ins: the same leaves
    stand_in = checked_load(os.path.join(str(tmp_path), "ckpt_4.pkl"))
    assert [np.asarray(a).tolist() for a in
            bridge.optax_leaves(stand_in["opt_state"])] == \
        [np.asarray(a).tolist() for a in port["opt_state"]]


def test_the_whitelist_refuses_code():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))
    with pytest.raises(UnsafePickleError):
        checked_loads(pickle.dumps(Evil()))
    with pytest.raises(UnsafePickleError):
        checked_loads(pickle.dumps(jinit))


def test_check_params_compatible_and_a_mismatched_optimizer(tmp_path):
    x, y = _data(0)
    m = _port(topt.SGD(0.1, momentum=0.9))
    _losses(m, x, y)
    saved = m.estimator.checkpoint_state()["params"]
    _check_params_compatible(m, saved)
    with pytest.raises(ValueError, match="does not match model"):
        _check_params_compatible(m, {k: v for k, v in saved.items()
                                     if k != "dense_2"})
    m.estimator.save_checkpoint(str(tmp_path))
    other = Sequential()
    other.add(TL.Dense(8, input_shape=(5,)))
    other.compile(optimizer="sgd", loss="mse")
    with pytest.raises(ValueError, match="does not match model"):
        other.estimator.load_checkpoint(str(tmp_path))
    adam = _port(topt.Adam(1e-3))      # another optimizer's state
    with pytest.raises(ValueError, match="optimizer state"):
        adam.estimator.load_checkpoint(str(tmp_path))
    assert m.estimator.load_checkpoint(str(tmp_path), step=4).step == 4
