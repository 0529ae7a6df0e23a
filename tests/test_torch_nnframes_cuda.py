"""nnframes on the card: an f32 ``NNClassifier.fit`` on the card against
``Estimator.train`` of the same initial weights over the same arrays
(the same batches in the same order), and an ``NNModel`` saved on the
card and loaded on the CPU.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none. The file imports no JAX and no pandas (the rows
come as a ``LocalRdd``, predictions through the transformer's batched
core), so it runs on a machine that has neither:

    python -m pytest --noconftest tests/test_torch_nnframes_cuda.py -q

Tolerances: bit for bit on the card (the same f32 kernels on the same
batches); the CPU's predictions of the loaded model within 1e-5 of
max(1, max|p|) of the card's (f32 with TF32 off, sums in another order).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tzoo.init_nncontext(seed=0)
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _net():
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    m = Sequential()
    m.add(L.Dense(64, activation="relu", input_shape=(16,), name="hidden"))
    m.add(L.Dense(3, activation="softmax", name="head"))
    return m


def _rows(n=256):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 16).astype(np.float32)
    y = rs.randint(0, 3, n).astype(np.float32)
    return x, y


@pytest.mark.cuda
def test_f32_fit_on_the_card_is_estimator_train_bit_for_bit(cuda):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.feature.rdd import LocalRdd
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier
    x, y = _rows()
    a = _net()
    a.init_params()
    w0 = params_to_numpy(a)
    a.compile("sgd", "sparse_categorical_crossentropy")
    m = (NNClassifier(a, "sparse_categorical_crossentropy")
         .set_batch_size(32).set_max_epoch(2).set_optim_method("sgd")
         .set_learning_rate(0.1)
         .fit(LocalRdd(list(zip(x, y)), num_partitions=4)))
    assert m.params["head"]["kernel"].device.type == "cuda"
    b = _net()
    b.load_params(w0)
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    Estimator(b, optimizer=SGD(lr=0.1),
              loss="sparse_categorical_crossentropy").train(
        x, y.reshape(-1, 1), batch_size=32, nb_epoch=2)
    got, want = params_to_numpy(m.params), params_to_numpy(b)
    for k in want:
        for p in want[k]:
            np.testing.assert_array_equal(got[k][p], want[k][p],
                                          err_msg=f"{k}/{p}")
    preds = m._raw_predict({"features": list(x)})
    np.testing.assert_array_equal(m.classes(preds),
                                  np.argmax(b.predict(x), -1))


@pytest.mark.cuda
def test_saved_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    from analytics_zoo_tpu_torch.feature.common import SeqToTensor
    from analytics_zoo_tpu_torch.feature.rdd import LocalRdd
    from analytics_zoo_tpu_torch.pipeline.nnframes import (NNClassifier,
                                                           NNClassifierModel,
                                                           NNModel)
    x, y = _rows()
    net = _net()
    net.compile("adam", "mse")
    m = (NNClassifier(net, "sparse_categorical_crossentropy",
                      SeqToTensor((16,)))
         .set_batch_size(32).set_max_epoch(1)
         .fit(LocalRdd(list(zip(x, y)))))
    on_card = m._raw_predict({"features": list(x)})
    path = str(tmp_path / "nn.model")
    m.save(path)
    tzoo.reset_nncontext()
    tzoo.init_nncontext(seed=0, device="cpu")
    loaded = NNModel.load(path)
    assert isinstance(loaded, NNClassifierModel)
    assert loaded.params["head"]["kernel"].device.type == "cpu"
    on_cpu = loaded._raw_predict({"features": list(x)})
    np.testing.assert_allclose(
        on_cpu, on_card, rtol=0,
        atol=1e-5 * max(1.0, float(np.abs(on_card).max())))
