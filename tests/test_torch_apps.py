"""The port's apps (``analytics_zoo_tpu_torch/apps``) and its examples of
the nnframes slice on the CPU, with the reference's own tiny arguments
and assertions (``tests/test_apps.py``, ``tests/test_examples.py``);
``bert_finetune`` trains on one device, and ``--devices 2`` raises
naming the data-parallel item it waits for. The dispatchers list 4 apps
and 21 examples."""

import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.apps import APPS
from analytics_zoo_tpu_torch.apps.__main__ import main as apps_main
from analytics_zoo_tpu_torch.examples import EXAMPLES
from analytics_zoo_tpu_torch.examples.__main__ import main as examples_main


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    # no FLOP count in each fit's first step: no test here reads it
    monkeypatch.setenv("ZOO_TPU_GOODPUT_FLOPS", "0")
    yield
    tzoo.reset_nncontext()


def _check_dogs(r):
    assert r["frozen_unchanged"] and 0.0 <= r["accuracy"] <= 1.0
    assert r["images"] == 32


def _check_vae(r):
    assert np.isfinite(r["loss"])
    assert r["samples"].shape == (4, 784)
    assert 0.0 <= r["samples"].min() and r["samples"].max() <= 1.0


CASES = {
    "dogs_vs_cats": (
        "apps", ["--per-class", "16", "--epochs", "10", "--batch-size",
                 "16"], _check_dogs),
    "dogs_vs_cats_in_memory": (
        "apps", ["--per-class", "16", "--epochs", "2", "--batch-size",
                 "16", "--in-memory"], _check_dogs),
    "recommendation_ncf": (
        "apps", ["--users", "50", "--items", "40", "--samples", "2000",
                 "--epochs", "1", "--batch-size", "256"],
        lambda r: (np.isfinite(r["loss"]) and
                   len(r["recommend_for_user"]) > 0 and
                   len(r["recommend_for_item"]) > 0) or pytest.fail(r)),
    "recommendation_wide_n_deep": (
        "apps", ["--samples", "1024", "--epochs", "2", "--batch-size",
                 "256", "--users", "50", "--items", "40"],
        lambda r: r["accuracy"] > 0.25 or pytest.fail(r)),
    "web_service_sample": (
        "apps", ["--requests", "4", "--concurrency", "2"],
        lambda r: (r["errors"] == 0 and r["health"]["status"] == "ok")
        or pytest.fail(r)),
    "nnframes_classification": (
        "examples", ["--samples", "64", "--epochs", "2"],
        lambda acc: 0.0 <= acc <= 1.0 or pytest.fail(acc)),
    "autograd_custom": (
        "examples", ["--n", "256", "--epochs", "40"],
        lambda r: r["mae"] < 0.2 or pytest.fail(r)),
    "transformer_sentiment": (
        "examples", ["--max-len", "16", "--n-train", "64", "--hidden-size",
                     "16", "--n-head", "2", "--max-features", "500"],
        lambda r: "loss" in r or pytest.fail(r)),
    "vae_mnist": (
        "examples", ["--n-train", "128", "--epochs", "1", "--hidden", "32"],
        _check_vae),
    "bert_finetune": (
        "examples", ["--devices", "1", "--seq-len", "32", "--hidden", "32",
                     "--blocks", "1", "--batch-per-device", "2",
                     "--epochs", "1"],
        lambda r: "accuracy" in r or pytest.fail(r)),
    "bert_finetune_frozen_encoder": (
        "examples", ["--devices", "1", "--seq-len", "32", "--hidden", "32",
                     "--blocks", "1", "--batch-per-device", "2",
                     "--epochs", "1", "--freeze-encoder"],
        lambda r: np.isfinite(r["loss"]) or pytest.fail(r)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runs_on_the_cpu(case):
    kind, argv, check = CASES[case]
    name = next(n for n in APPS + EXAMPLES if case.startswith(n))
    mod = __import__(f"analytics_zoo_tpu_torch.{kind}.{name}",
                     fromlist=["main"])
    check(mod.main(argv + ["--device", "cpu"]))


def test_bert_finetune_refuses_more_than_one_device():
    from analytics_zoo_tpu_torch.examples import bert_finetune
    with pytest.raises(ValueError, match="A14"):
        bert_finetune.main(["--devices", "2", "--device", "cpu"])


def test_dispatchers_list_3_apps_and_20_examples(capsys):
    """The app list (four apps since the web-service sample) and the
    twenty-one examples (since onnx_import); the name is kept from when
    they held three and twenty."""
    assert apps_main(["list"]) == 0
    out = capsys.readouterr().out
    assert len(APPS) == 4 and all(f"  {a} " in out for a in APPS)
    assert "Dogs-vs-cats transfer learning" in out
    assert apps_main(["nope"]) == 2
    assert examples_main(["list"]) == 0
    out = capsys.readouterr().out
    assert len(EXAMPLES) == 21 and all(f"  {e} " in out for e in EXAMPLES)
