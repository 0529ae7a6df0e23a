"""The autograd operators, KNRM, the qa_ranker example and the
AnomalyDetector of the port against the JAX package's, on the CPU.

Each operator is held on a small graph (``Input`` s, the operator, a
``Model``): forward and the gradients of ``sum(out * w)`` by the inputs
and any ``Parameter``, f32 within 1e-5. KNRM in both target modes:
scores, one ``rank_hinge`` (or binary cross-entropy) Adam step (loss
1e-4 relative, weights 1e-5), NDCG@3 and MAP; the AnomalyDetector's
forward, one step at dropout 0, ``unroll`` and ``detect_anomalies``;
``save_model``/``load_model`` round trips; the example end to end.
Weights cross as numpy (``bridge``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as j_init
from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models import textmatching as jtm
from analytics_zoo_tpu.pipeline.api import autograd as JA
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models import textmatching as ttm
from analytics_zoo_tpu_torch.pipeline.api import autograd as TA
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input as TInput

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    j_init(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    yield
    tzoo.reset_nncontext()


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _tree_close(got, want, path=""):
    """Every leaf of ``want`` in ``got``; operator nodes hold no params,
    and their names differ (numbered by process in the JAX package)."""
    for k, v in want.items():
        if isinstance(v, dict) and not v:
            continue
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{path}/{k}")
        else:
            _close(got[k], v, f"{path}/{k}")


# -- the operators ------------------------------------------------------------

def _pos(shape, rs):
    return (rs.rand(*shape) + 0.5).astype(np.float32)


def _any(shape, rs):
    return rs.randn(*shape).astype(np.float32)


# name -> (graph builder over the autograd module A and inputs, input
# shapes, input draw)
OPS = {
    "add": (lambda A, a, b: a + b, [(3, 4), (3, 4)], _any),
    "add_broadcast": (lambda A, a, b: A.add(a, b), [(3, 4), (1, 4)], _any),
    "add_scalar": (lambda A, a: a + 2.5, [(3, 4)], _any),
    "radd": (lambda A, a: 2.5 + a, [(3, 4)], _any),
    "sub": (lambda A, a, b: a - b, [(3, 4), (3, 4)], _any),
    "rsub": (lambda A, a: 2.0 - a, [(3, 4)], _any),
    "mul": (lambda A, a, b: a * b, [(3, 4), (3, 4)], _any),
    "rmul": (lambda A, a: 3.0 * a, [(3, 4)], _any),
    "div": (lambda A, a, b: a / b, [(3, 4), (3, 4)], _pos),
    "rdiv": (lambda A, a: 1.5 / a, [(3, 4)], _pos),
    "neg": (lambda A, a: -a, [(3, 4)], _any),
    "abs": (lambda A, a: A.abs(a), [(3, 4)], _any),
    "square": (lambda A, a: A.square(a), [(3, 4)], _any),
    "sqrt": (lambda A, a: A.sqrt(a), [(3, 4)], _pos),
    "log": (lambda A, a: A.log(a), [(3, 4)], _pos),
    "exp": (lambda A, a: A.exp(a), [(3, 4)], _any),
    "pow": (lambda A, a: a ** 3, [(3, 4)], _any),
    "softsign": (lambda A, a: A.softsign(a), [(3, 4)], _any),
    "softplus": (lambda A, a: A.softplus(a), [(3, 4)], _any),
    "clip": (lambda A, a: A.clip(a, -0.5, 0.7), [(3, 4)], _any),
    "maximum": (lambda A, a, b: A.maximum(a, b), [(3, 4), (3, 4)], _any),
    "maximum_scalar": (lambda A, a: A.maximum(a, 0.1), [(3, 4)], _any),
    "minimum": (lambda A, a, b: A.minimum(a, b), [(3, 4), (3, 4)], _any),
    "minimum_scalar": (lambda A, a: A.minimum(a, 0.1), [(3, 4)], _any),
    "sum": (lambda A, a: A.sum(a, axis=2), [(3, 4)], _any),
    "sum_keepdims": (lambda A, a: A.sum(a, axis=1, keepdims=True),
                     [(3, 4)], _any),
    "mean": (lambda A, a: A.mean(a, axis=-1), [(3, 4)], _any),
    "max": (lambda A, a: A.max(a, axis=1, keepdims=True), [(3, 4)], _any),
    "stack": (lambda A, a, b: A.stack([a, b], axis=2), [(3, 4), (3, 4)],
              _any),
    "expand_dims": (lambda A, a: A.expand_dims(a, 1), [(3, 4)], _any),
    "squeeze_dim": (lambda A, a: A.squeeze(a, dim=2), [(3, 1, 4)], _any),
    "squeeze_all": (lambda A, a: a.squeeze(), [(1, 4, 1)], _any),
    "expand_method": (lambda A, a: a.expand_dims(3), [(3, 4)], _any),
    "contiguous": (lambda A, a: A.contiguous(a), [(3, 4)], _any),
    "slice": (lambda A, a: a[1:3], [(4, 5)], _any),
    "slice_index": (lambda A, a: a[:, 2], [(4, 5)], _any),
    "mm": (lambda A, a, b: A.mm(a, b), [(3, 4), (4, 5)], _any),
    "mm_axes": (lambda A, a, b: A.mm(a, b, axes=(2, 2)), [(3, 4), (5, 4)],
                _any),
    "batch_dot": (lambda A, a, b: A.batch_dot(a, b, axes=(2, 2)),
                  [(3, 4), (5, 4)], _any),
    "batch_dot_default": (lambda A, a, b: A.batch_dot(a, b),
                          [(3, 4), (4, 2)], _any),
    "batch_dot_3d": (lambda A, a, b: A.batch_dot(a, b, axes=(1, 3)),
                     [(4, 2, 3), (2, 5, 4)], _any),
    "l2_normalize": (lambda A, a: A.l2_normalize(a, axis=2), [(3, 4)],
                     _any),
    "epsilon": (lambda A, a: a + A.epsilon(), [(3, 4)], _any),
    "parameter": (lambda A, a: a * A.Parameter(
        (4,), init_weight=np.linspace(-1, 1, 4)) + 1.0, [(3, 4)], _any),
    "parameter_random": (lambda A, a: A.mm(a, A.Parameter((4, 2))),
                         [(3, 4)], _any),
    "constant": (lambda A, a: a * A.Constant(np.arange(4.0) - 1.5),
                 [(3, 4)], _any),
    "chain": (lambda A, a, b: A.log(A.sum(A.exp((a - b) * (a - b) * -2.0),
                                          axis=2) + 1.0),
              [(3, 4), (3, 4)], _any),
}


def _graph(A, inp, model, name):
    build, shapes, _ = OPS[name]
    ins = [inp(s) for s in shapes]
    return model(ins if len(ins) > 1 else ins[0], build(A, *ins))


@pytest.mark.parametrize("name", sorted(OPS))
def test_autograd_operator_matches_jax(name):
    _, shapes, draw = OPS[name]
    rs = np.random.RandomState(3)
    xs = [draw((2,) + s, rs) for s in shapes]
    jm = _graph(JA, JInput, jmodels.Model, name)
    tm = _graph(TA, TInput, tmodels.Model, name)
    p = jax.device_get(jm.init(jax.random.key(0)))
    multi = len(xs) > 1

    def jfwd(p, xs):
        return jm.forward(p, xs if multi else xs[0])

    jout = jfwd(p, [jnp.asarray(x) for x in xs])
    w = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xs: jnp.sum(jfwd(p, xs) * w),
                        argnums=(0, 1))(p, [jnp.asarray(x) for x in xs])

    tm.load_params(p, device="cpu")
    tp = tm.params()
    leaves = [(n, k, v) for n, sub in tp.items() for k, v in sub.items()]
    for _, _, v in leaves:
        v.requires_grad_(True)
    tx = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    tout = tm.call(tp, tx if multi else tx[0])
    _close(tout, jout, "out")
    assert tm.output_shape == tuple(jout.shape[1:])
    grads = torch.autograd.grad(torch.sum(tout * torch.from_numpy(w)),
                                [v for _, _, v in leaves] + tx)
    for (n, k, _), g in zip(leaves, grads):
        _close(g, jgp[n][k], f"grad {n}/{k}")
    for i, (g, jg) in enumerate(zip(grads[len(leaves):], jgx)):
        _close(g, jg, f"grad input {i}")
    # operator nodes are numbered by the container from 1
    ops = [lyr.name for lyr in tm.layers if isinstance(lyr, TA._OpLayer)]
    assert all(n.rsplit("_", 1)[1].isdigit() for n in ops), ops


def test_autograd_refuses_the_batch_axis():
    a = TInput((3, 4))
    for op in (lambda: TA.sum(a, axis=0), lambda: TA.mean(a, axis=-3),
               lambda: TA.max(a, 0), lambda: TA.stack([a, a], axis=0),
               lambda: TA.expand_dims(a, 0), lambda: TA.squeeze(a, 0),
               lambda: TA.l2_normalize(a, axis=0)):
        with pytest.raises(ValueError, match="batch axis"):
            op()
    with pytest.raises(ValueError, match="init_weight shape"):
        p = TA.Parameter((4,), init_weight=np.zeros(3))
        tmodels.Model(a, a * p).init(torch.Generator())
    assert TA.epsilon() == JA.epsilon() == 1e-7


def test_custom_loss_compiles_and_steps_like_jax():
    def loss(A):
        return lambda t, p: A.mean(A.abs(t - p) * 2.0 + A.square(p),
                                   axis=1)

    def net(L, M, Inp):
        x = Inp((5,))
        return M.Model(x, L.Dense(3, name="d")(x))

    jm, tm = net(JL, jmodels, JInput), net(TL, tmodels, TInput)
    jm.compile(optimizer="adam", loss=JA.CustomLoss(loss(JA), (3,)))
    tm.compile(optimizer="adam", loss=TA.CustomLoss(loss(TA), (3,)))
    jm.estimator._ensure_initialized()
    tm.estimator.params = jax.device_get(jm.estimator.params)
    rs = np.random.RandomState(5)
    x, y = _any((8, 5), rs), _any((8, 3), rs)
    jh = jm.fit(x, y, batch_size=8, nb_epoch=2).history
    th = tm.fit(x, y, batch_size=8, nb_epoch=2).history
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-4)
    _tree_close(params_to_numpy(tm), jax.device_get(jm.estimator.params))
    with pytest.raises(TypeError, match="Variable"):
        TA.CustomLoss(lambda t, p: 1.0, (3,))


# -- KNRM ---------------------------------------------------------------------

KNRM = dict(text1_length=4, text2_length=6, vocab_size=30, embed_size=8)


def _knrm_ids(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, KNRM["vocab_size"], (n, 10)).astype(np.float32)
    x[:, 5] = x[:, 0]          # an exact match for the exact kernel
    return x


def _bridged(jzoo, tzoo_model, **compile_kw):
    jzoo.compile(**compile_kw)
    tzoo_model.compile(**compile_kw)
    jest = jzoo.model.estimator
    jest._ensure_initialized()
    p = jax.device_get(jest.params)
    tzoo_model.model.estimator.params = p
    return p


@pytest.mark.parametrize("mode,kernels,loss", [
    ("ranking", 21, "rank_hinge"), ("classification", 5,
                                    "binary_crossentropy")])
def test_knrm_scores_and_one_step_match_jax(mode, kernels, loss):
    from analytics_zoo_tpu.ops.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.ops.optimizers import Adam as TAdam
    kw = dict(KNRM, kernel_num=kernels, target_mode=mode)
    jk, tk = jtm.KNRM(**kw), ttm.KNRM(**kw)
    jk.compile(optimizer=JAdam(lr=1e-2), loss=loss)
    tk.compile(optimizer=TAdam(lr=1e-2), loss=loss)
    jest = jk.model.estimator
    jest._ensure_initialized()
    p = jax.device_get(jest.params)
    # a wider table, so the kernels see cosines away from 0
    p["embedding"]["embeddings"] = np.random.RandomState(1).randn(
        30, 8).astype(np.float32) * 0.3
    jest.params = jax.device_put(p)
    tk.model.estimator.params = p
    assert sorted(tk.model.params()["embedding"]) == ["embeddings"]
    x = _knrm_ids(8)
    want = np.asarray(jk.predict(x, batch_size=8))
    got = tk.predict(x, batch_size=8)
    assert got.shape == (8, 1)
    _close(got, want, "scores", tol=max(1.0, float(np.abs(want).max())) * TOL)
    y = (np.arange(8) % 2 == 0).astype(np.float32).reshape(-1, 1)
    jh = jk.fit(x, y, batch_size=8, nb_epoch=1).history
    th = tk.fit(x, y, batch_size=8, nb_epoch=1).history
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-4)
    _tree_close(params_to_numpy(tk.model), jax.device_get(jest.params))
    # NDCG@3 and MAP on the same scores, through the relation helpers
    x1, x2 = x[:, :4], x[:, 4:]
    labels = np.array([1, 0, 0, 1, 0, 1, 1, 0], np.int32)
    gids = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)
    for fn in ("evaluate_ndcg_on_relations", "evaluate_map_on_relations"):
        np.testing.assert_allclose(
            getattr(tk, fn)(x1, x2, labels, gids),
            getattr(jk, fn)(x1, x2, labels, gids), rtol=1e-6)


def test_knrm_word_embedding_hyper_parameters_and_errors():
    table = np.random.RandomState(2).randn(30, 8).astype(np.float32)
    kw = dict(KNRM, embed_weights=table, train_embed=False, kernel_num=5)
    jk, tk = jtm.KNRM(**kw), ttm.KNRM(**kw)
    _bridged(jk, tk, optimizer="adam", loss="rank_hinge")
    emb = tk.model.graph_layers["embedding"]
    assert isinstance(emb, TL.WordEmbedding) and not emb.trainable
    x = _knrm_ids(6, seed=3)
    _close(tk.predict(x), np.asarray(jk.predict(x)), "scores")
    assert tk.hyper_parameters() == jk.hyper_parameters()
    assert np.array_equal(ttm.KNRM.concat_inputs(x[:, :4], x[:, 4:]), x)
    with pytest.raises(ValueError, match="kernel_num"):
        ttm.KNRM(4, 6, 30, kernel_num=1)
    with pytest.raises(ValueError, match="target_mode"):
        ttm.KNRM(4, 6, 30, target_mode="regression")


def test_knrm_save_model_round_trip(tmp_path):
    tk = ttm.KNRM(**KNRM, kernel_num=5).compile(optimizer="adam",
                                                loss="rank_hinge")
    x = _knrm_ids(8, seed=4)
    tk.fit(x, np.zeros((8, 1), np.float32), batch_size=8, nb_epoch=1)
    path = str(tmp_path / "knrm.model")
    tk.save_model(path)
    # a second build in the same process names its operators alike
    back = ttm.KNRM.load_model(path)
    assert back.hyper_parameters() == tk.hyper_parameters()
    np.testing.assert_array_equal(back.predict(x), tk.predict(x))


def test_qa_ranker_example_runs_on_the_cpu():
    from analytics_zoo_tpu_torch.examples import qa_ranker
    metrics = qa_ranker.main(["--device", "cpu"])
    assert sorted(metrics) == ["map", "ndcg@3", "ndcg@5"]
    assert all(0.0 <= v <= 1.0 for v in metrics.values())


# -- AnomalyDetector ----------------------------------------------------------

AD = dict(feature_shape=(10, 2), hidden_layers=(6, 8, 5),
          dropouts=(0.2, 0.2, 0.2))


def test_anomaly_detector_forward_and_one_step_match_jax():
    jd, td = jad.AnomalyDetector(**AD), tad.AnomalyDetector(**AD)
    _bridged(jd, td, optimizer="adam", loss="mse")
    rs = np.random.RandomState(6)
    x = _any((16, 10, 2), rs)
    y = _any((16, 1), rs)
    _close(td.predict(x, batch_size=8), np.asarray(jd.predict(x, 8)), "y")
    for m in (jd, td):
        for lyr in m.model.layers:
            if type(lyr).__name__ == "Dropout":
                lyr.p = 0.0
    jh = jd.fit(x, y, batch_size=16, nb_epoch=1).history
    th = td.fit(x, y, batch_size=16, nb_epoch=1).history
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-4)
    _tree_close(params_to_numpy(td.model),
                jax.device_get(jd.model.estimator.params))
    assert [type(lyr).__name__ for lyr in td.model.layers] == \
        [type(lyr).__name__ for lyr in jd.model.layers]


def test_anomaly_detector_unroll_and_detect_match_jax(tmp_path):
    rs = np.random.RandomState(7)
    series = rs.randn(40, 3).astype(np.float32)
    for unroll, step in ((5, 1), (8, 3)):
        ji = jad.AnomalyDetector.unroll(series, unroll, step)
        ti = tad.AnomalyDetector.unroll(series, unroll, step)
        assert [(f.label, f.index) for f in ti] == \
            [(f.label, f.index) for f in ji]
        jx, jy = jad.AnomalyDetector.to_arrays(ji)
        tx, ty = tad.AnomalyDetector.to_arrays(ti)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    flat = tad.AnomalyDetector.unroll(series[:, 0], 4)
    assert flat[0].feature.shape == (4, 1)
    truth, pred = rs.randn(30), rs.randn(30)
    for size in (1, 5, 30, 40):
        ti, tt = tad.AnomalyDetector.detect_anomalies(truth, pred, size)
        ji, jt = jad.AnomalyDetector.detect_anomalies(truth, pred, size)
        np.testing.assert_array_equal(ti, ji)
        assert tt == jt
    with pytest.raises(ValueError, match="equal length"):
        tad.AnomalyDetector((10, 2), hidden_layers=(4, 4), dropouts=(0.1,))
    td = tad.AnomalyDetector(**AD).compile(optimizer="adam", loss="mse")
    x = _any((4, 10, 2), rs)
    want = td.predict(x)
    path = str(tmp_path / "ad.model")
    td.save_model(path)
    back = tad.AnomalyDetector.load_model(path)
    assert back.hyper_parameters() == td.hyper_parameters()
    np.testing.assert_array_equal(back.predict(x), want)


def test_anomaly_detection_example_runs_on_the_cpu():
    from analytics_zoo_tpu_torch.examples import anomaly_detection
    out = anomaly_detection.main(["--device", "cpu", "--points", "300",
                                  "--epochs", "2"])
    assert np.isfinite(out["loss"]) and np.isfinite(out["threshold"])
    assert len(out["flagged"]) >= 5
