"""The recommendation slice of the port against the JAX package, on the
CPU: NeuralCF and Wide&Deep through ``compile``/``fit``/``predict``,
the Recommender's ranking surface, ``ZooModel`` persistence (saved
models, weight files in both directions), ``Ranker``, the two examples,
the multi-input ``KerasNet.predict``, and the port's purity (no JAX).

Weights cross as numpy (``bridge``); f32 within 1e-5 (losses relative,
params and outputs rtol/atol).
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as j_init
from analytics_zoo_tpu.models import common as jcommon
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu_torch.bridge import (
    opt_state_to_numpy, optax_state_to_numpy, params_to_numpy)
from analytics_zoo_tpu_torch.common.safe_pickle import (
    UnsafePickleError, checked_loads)
from analytics_zoo_tpu_torch.models import common as tcommon
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input as TInput

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
NCF = dict(user_count=50, item_count=40, num_classes=5, user_embed=8,
           item_embed=8, hidden_layers=(16, 8, 4), mf_embed=8)


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    j_init(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    yield
    tzoo.reset_nncontext()


def _tree_close(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=TOL,
                                       atol=TOL, err_msg=f"{path}/{k}")


def _pairs(n, users, items, seed=0):
    rs = np.random.RandomState(seed)
    x = np.stack([rs.randint(0, users, n), rs.randint(0, items, n)],
                 axis=1).astype(np.int32)
    return x, ((x[:, :1] + x[:, 1:]) % 5).astype(np.int32)


def _bridged(jzoo, tzoo_model, optimizer="adam", loss="class_nll"):
    """Compile both, initialize the JAX model and load its params into
    the port's."""
    jzoo.compile(optimizer=optimizer, loss=loss)
    tzoo_model.compile(optimizer=optimizer, loss=loss)
    jest = jzoo.model.estimator
    jest._ensure_initialized()
    p = jax.device_get(jest.params)
    tzoo_model.model.estimator.params = p
    return p


# -- the multi-input predict (the repair) -------------------------------------

def test_keras_net_predict_takes_a_list_of_inputs():
    def build(L, M, Inp):
        a, b = Inp((3,)), Inp((5,))
        return M.Model([a, b], L.Add()([L.Dense(2)(a), L.Dense(2)(b)]))

    jm, tm = build(JL, jmodels, JInput), build(TL, tmodels, TInput)
    jm.compile()
    jm.estimator._ensure_initialized()
    tm.load_params(jax.device_get(jm.estimator.params), device="cpu")
    rs = np.random.RandomState(0)
    x = [rs.randn(7, 3).astype(np.float32), rs.randn(7, 5).astype(np.float32)]
    want = np.asarray(jm.predict(x, batch_size=3))
    got = tm.predict(x, batch_size=3)
    assert got.shape == want.shape == (7, 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.predict(tuple(x), batch_size=4), want,
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="inconsistent sample counts"):
        tm.predict([x[0], x[1][:5]])


# -- NeuralCF -----------------------------------------------------------------

def test_neuralcf_forward_and_two_adam_steps_match_jax():
    jncf, tncf = jrec.NeuralCF(**NCF), trec.NeuralCF(**NCF)
    p = _bridged(jncf, tncf)
    assert sorted(p) == sorted(tncf.model.graph_layers)
    for name in ("user_id", "item_id", "mlp_user_table", "mlp_item_table",
                 "mf_user_table", "mf_item_table"):
        assert name in p
    x, y = _pairs(64, 50, 40)
    np.testing.assert_allclose(tncf.predict(x, batch_size=32),
                               np.asarray(jncf.predict(x, batch_size=32)),
                               rtol=TOL, atol=TOL)
    # one step per epoch (batch = the data), two epochs: two Adam steps
    jh = jncf.fit(x, y, batch_size=64, nb_epoch=2).history
    th = tncf.fit(x, y, batch_size=64, nb_epoch=2).history
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=TOL)
    jest, test = jncf.model.estimator, tncf.model.estimator
    _tree_close(params_to_numpy(tncf.model), jax.device_get(jest.params))
    ts = opt_state_to_numpy(test)
    js = optax_state_to_numpy(jax.device_get(jest.opt_state))
    assert int(ts["count"]) == int(js["count"]) == 2
    _tree_close(ts["mu"], js["mu"])
    _tree_close(ts["nu"], js["nu"])
    np.testing.assert_allclose(
        tncf.evaluate(x, y, batch_size=16)["loss"],
        jncf.evaluate(x, y, batch_size=16)["loss"], rtol=TOL)


def test_neuralcf_without_mf_and_its_errors():
    kw = dict(NCF, include_mf=False)
    jncf, tncf = jrec.NeuralCF(**kw), trec.NeuralCF(**kw)
    p = _bridged(jncf, tncf)
    assert "mf_user_table" not in p
    x, _ = _pairs(9, 50, 40, seed=1)
    np.testing.assert_allclose(tncf.predict(x), np.asarray(jncf.predict(x)),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="mf_embed"):
        trec.NeuralCF(**dict(NCF, mf_embed=0)).model


# -- Wide & Deep --------------------------------------------------------------

def _wnd_info(mod):
    return mod.ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"], wide_base_dims=[4, 3],
        wide_cross_cols=["age-gender"], wide_cross_dims=[6],
        indicator_cols=["genres"], indicator_dims=[5],
        embed_cols=["userId", "itemId"], embed_in_dims=[30, 20],
        embed_out_dims=[6, 4], continuous_cols=["age", "score"])


def _wnd_data(n, seed=0):
    rs = np.random.RandomState(seed)
    x_wide = (rs.rand(n, 13) < 0.3).astype(np.float32)
    x_deep = np.concatenate([
        np.eye(5, dtype=np.float32)[rs.randint(0, 5, n)],
        rs.randint(0, 30, (n, 1)).astype(np.float32),
        rs.randint(0, 20, (n, 1)).astype(np.float32),
        rs.rand(n, 2).astype(np.float32)], axis=1)
    y = rs.randint(0, 4, (n, 1)).astype(np.int32)
    return x_wide, x_deep, y


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_forward_and_step_match_jax(model_type):
    from analytics_zoo_tpu.ops.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.ops.optimizers import Adam as TAdam
    kw = dict(model_type=model_type, num_classes=4, hidden_layers=(8, 4))
    jw = jrec.WideAndDeep(column_info=_wnd_info(jrec), **kw)
    tw = trec.WideAndDeep(column_info=_wnd_info(trec), **kw)
    assert tw.column_info.wide_dim == 13 and tw.column_info.deep_dim == 9
    jw.compile(optimizer=JAdam(lr=1e-2), loss="class_nll")
    tw.compile(optimizer=TAdam(lr=1e-2), loss="class_nll")
    jest = jw.model.estimator
    jest._ensure_initialized()
    p = jax.device_get(jest.params)
    if model_type != "deep":
        # the wide Dense starts at zero: give it weights to carry
        rs = np.random.RandomState(2)
        p["wide_linear"]["kernel"] = rs.randn(13, 4).astype(np.float32)
        jest.params = jax.device_put(p)
    tw.model.estimator.params = p
    x_wide, x_deep, y = _wnd_data(24)
    x = {"wide": x_wide, "deep": x_deep,
         "wide_n_deep": [x_wide, x_deep]}[model_type]
    np.testing.assert_allclose(tw.predict(x, batch_size=10),
                               np.asarray(jw.predict(x, batch_size=10)),
                               rtol=TOL, atol=TOL)
    jh = jw.fit(x, y, batch_size=24, nb_epoch=1).history
    th = tw.fit(x, y, batch_size=24, nb_epoch=1).history
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=TOL)
    _tree_close(params_to_numpy(tw.model), jax.device_get(jest.params))


def test_wide_and_deep_arguments():
    with pytest.raises(ValueError, match="model_type"):
        trec.WideAndDeep("tall", column_info=_wnd_info(trec))
    with pytest.raises(ValueError, match="column_info"):
        trec.WideAndDeep("wide")


# -- the ranking surface ------------------------------------------------------

def _summary(preds):
    return [(p.user_id, p.item_id, p.prediction, round(p.probability, 5))
            for p in preds]


def test_recommender_results_and_order_match_jax():
    jncf, tncf = jrec.NeuralCF(**NCF), trec.NeuralCF(**NCF)
    _bridged(jncf, tncf)
    x, _ = _pairs(60, 6, 8, seed=3)     # few ids: groups of several
    jp = [jrec.UserItemFeature(int(u), int(i), np.array([u, i], np.int32))
          for u, i in x]
    tp = [trec.UserItemFeature(int(u), int(i), np.array([u, i], np.int32))
          for u, i in x]
    assert _summary(tncf.predict_user_item_pair(tp)) == \
        _summary(jncf.predict_user_item_pair(jp))
    got = tncf.recommend_for_user(tp, max_items=3)
    assert _summary(got) == _summary(jncf.recommend_for_user(jp, 3))
    assert [p.user_id for p in got] == sorted(p.user_id for p in got)
    got = tncf.recommend_for_item(tp, max_users=2)
    assert _summary(got) == _summary(jncf.recommend_for_item(jp, 2))
    for a, b in zip(got, got[1:]):
        if a.item_id == b.item_id:
            assert (a.prediction, a.probability) >= \
                (b.prediction, b.probability)
    # a two-input model's pairs carry a list of rows each
    info_j, info_t = _wnd_info(jrec), _wnd_info(trec)
    jw = jrec.WideAndDeep("wide_n_deep", 4, info_j, (8, 4))
    tw = trec.WideAndDeep("wide_n_deep", 4, info_t, (8, 4))
    _bridged(jw, tw)
    x_wide, x_deep, _ = _wnd_data(12, seed=4)
    jpairs = [jrec.UserItemFeature(int(d[5]), int(d[6]), [w, d])
              for w, d in zip(x_wide, x_deep)]
    tpairs = [trec.UserItemFeature(int(d[5]), int(d[6]), [w, d])
              for w, d in zip(x_wide, x_deep)]
    assert _summary(tw.recommend_for_user(tpairs, 2)) == \
        _summary(jw.recommend_for_user(jpairs, 2))


# -- persistence --------------------------------------------------------------

def test_save_model_and_load_model_round_trip(tmp_path):
    tncf = trec.NeuralCF(**NCF).compile(optimizer="adam", loss="class_nll")
    x, y = _pairs(32, 50, 40)
    tncf.fit(x, y, batch_size=16, nb_epoch=1)
    path = str(tmp_path / "ncf.model")
    tncf.save_model(path)
    with pytest.raises(FileExistsError):
        tncf.save_model(path)
    tncf.save_model(path, over_write=True)
    back = trec.NeuralCF.load_model(path)
    assert isinstance(back, trec.NeuralCF)
    assert back.hyper_parameters() == tncf.hyper_parameters()
    np.testing.assert_array_equal(back.predict(x), tncf.predict(x))
    back.fit(x, y, batch_size=16, nb_epoch=1)        # compiled on load
    # a Wide&Deep file pickles its ColumnFeatureInfo: a port class
    tw = trec.WideAndDeep("deep", 4, _wnd_info(trec), (8, 4))
    tw.compile()
    tw.save_model(str(tmp_path / "wnd.model"))
    back = tcommon.ZooModel.load_model(str(tmp_path / "wnd.model"))
    assert back.column_info == tw.column_info
    _, x_deep, _ = _wnd_data(5)
    np.testing.assert_array_equal(back.predict(x_deep), tw.predict(x_deep))


def test_load_model_refuses_foreign_and_tampered_files(tmp_path):
    # a file the JAX package saved names a module outside the port
    jncf = jrec.NeuralCF(**NCF)
    jncf.compile(loss="class_nll")
    jpath = str(tmp_path / "jax.model")
    jncf.save_model(jpath)
    with pytest.raises(ValueError, match="not a framework model"):
        trec.NeuralCF.load_model(jpath)

    def write(state):
        path = str(tmp_path / "t.model")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path
    good = {"module": "analytics_zoo_tpu_torch.models.recommendation."
                      "neuralcf", "class": "NeuralCF",
            "hyper_parameters": NCF, "params": {}}
    with pytest.raises(ValueError, match="not a ZooModel subclass"):
        tcommon.ZooModel.load_model(write(dict(
            good, module="analytics_zoo_tpu_torch.pipeline.api.keras."
                         "models", **{"class": "Sequential"})))
    with pytest.raises(ValueError, match="does not match model"):
        tcommon.ZooModel.load_model(write(good))
    # the whitelist: no class of the JAX package, no function of the port
    with pytest.raises(UnsafePickleError):
        checked_loads(pickle.dumps(jrec.ColumnFeatureInfo()))
    with pytest.raises(UnsafePickleError, match="only classes"):
        checked_loads(pickle.dumps(tcommon._check_params_compatible))
    assert checked_loads(pickle.dumps(trec.ColumnFeatureInfo(
        wide_base_dims=[2]))).wide_dim == 2


def test_weight_files_cross_between_the_packages(tmp_path):
    jncf, tncf = jrec.NeuralCF(**NCF), trec.NeuralCF(**NCF)
    jncf.compile(loss="class_nll")
    tncf.compile(loss="class_nll")
    x, y = _pairs(32, 50, 40, seed=5)
    jncf.fit(x, y, batch_size=16, nb_epoch=1)       # weights off the init
    jfile = str(tmp_path / "jax_weights.npz")
    jncf.save_weights(jfile)
    tncf.load_weights(jfile)
    assert tncf.model.estimator.opt_state is None    # moments reset
    want = np.asarray(jncf.predict(x))
    np.testing.assert_allclose(tncf.predict(x), want, rtol=TOL, atol=TOL)
    # and back: the port's file loads into the JAX package
    tfile = str(tmp_path / "port_weights.npz")
    tncf.save_weights(tfile)
    with np.load(tfile) as a, np.load(jfile) as b:
        assert sorted(a.files) == sorted(b.files)
    jback = jrec.NeuralCF(**NCF)
    jback.compile(loss="class_nll")
    jback.load_weights(tfile)
    np.testing.assert_allclose(np.asarray(jback.predict(x)), want,
                               rtol=TOL, atol=TOL)
    tncf.fit(x, y, batch_size=16, nb_epoch=1)         # Adam starts again

    flat = {k: np.asarray(v) for k, v in np.load(tfile).items()}
    bad = tmp_path / "bad.npz"
    np.savez(bad, **{k: v for k, v in flat.items()
                     if k != "dense_1/kernel"})
    with pytest.raises(KeyError, match="missing tensor 'dense_1/kernel'"):
        tncf.load_weights(str(bad))
    np.savez(bad, **flat, extra=np.zeros(2))
    with pytest.raises(ValueError, match="1 unused tensors"):
        tncf.load_weights(str(bad))
    np.savez(bad, **dict(flat, **{"dense_1/bias": np.zeros(3)}))
    with pytest.raises(ValueError, match="file shape"):
        tncf.load_weights(str(bad))


# -- Ranker -------------------------------------------------------------------

def test_ranker_known_values_and_random_groups_match_jax():
    r = tcommon.Ranker()
    scores = np.array([0.9, 0.1, 0.2, 0.8])
    labels = np.array([1, 0, 1, 0])
    gids = np.array([0, 0, 1, 1])
    assert r.evaluate_ndcg(scores, labels, gids, k=1) == pytest.approx(0.5)
    assert r.evaluate_map(scores, labels, gids) == pytest.approx(0.75)
    rs = np.random.RandomState(7)
    jr = jcommon.Ranker()
    for _ in range(5):
        n = 40
        scores, labels = rs.rand(n), rs.randint(0, 3, n)
        gids = rs.randint(0, 6, n)
        for k in (1, 3, 10):
            assert r.evaluate_ndcg(scores, labels, gids, k) == \
                jr.evaluate_ndcg(scores, labels, gids, k)
        assert r.evaluate_map(scores, labels, gids) == \
            jr.evaluate_map(scores, labels, gids)
    assert r.evaluate_map([0.5], [0], [0]) == 0.0


# -- the examples -------------------------------------------------------------

@pytest.mark.parametrize("name,argv", [
    ("ncf_recommendation", ["--users", "20", "--items", "10",
                            "--samples", "256", "--batch-size", "64",
                            "--epochs", "2"]),
    ("wide_and_deep", ["--users", "20", "--items", "10", "--samples",
                       "320", "--batch-size", "64", "--epochs", "2"]),
    ("wide_and_deep", ["--model-type", "deep", "--users", "20", "--items",
                       "10", "--samples", "160", "--batch-size", "64",
                       "--epochs", "1"])])
def test_examples_train_on_the_cpu(name, argv, capsys):
    from analytics_zoo_tpu_torch.examples.__main__ import main
    import importlib
    mod = importlib.import_module(f"analytics_zoo_tpu_torch.examples.{name}")
    out = mod.main(argv + ["--device", "cpu"])
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    if name == "ncf_recommendation":
        assert out["recommendations"]
    assert main([name.replace("_", "-")] + argv + ["--device", "cpu"]) == 0
    assert main(["nope"]) == 2
    assert main(["list"]) == 0
    assert "ncf_recommendation" in capsys.readouterr().out


# -- purity -------------------------------------------------------------------

def test_recommendation_path_imports_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import analytics_zoo_tpu_torch as z\n"
        "from analytics_zoo_tpu_torch.models.recommendation import (\n"
        "    NeuralCF, WideAndDeep)\n"
        "from analytics_zoo_tpu_torch.examples import ncf_recommendation,"
        " wide_and_deep\n"
        "import analytics_zoo_tpu_torch.examples.__main__\n"
        "z.init_nncontext(device='cpu')\n"
        "m = NeuralCF(10, 8, 5)\n"
        "y = m.predict(np.array([[1, 2], [3, 4]], np.int32))\n"
        "assert y.shape == (2, 5)\n"
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
