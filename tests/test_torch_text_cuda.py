"""The text family of the port on the card: the TextClassifier with
each encoder (probabilities and one Adam step at dropout 0, f32 with
TF32 off) and KNRM's scores against the CPU port on the same weights,
and an LSTM at T 500, H 256 whose forward and backward make no host
sync (``torch.cuda.set_sync_debug_mode("error")`` raises on one).

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_text_cuda.py -q

Tolerances: probabilities and scores within 1e-5 of max(1, max|CPU|),
a step's loss within 1e-4 relative, the weights after it within 1e-5
of max(1, max|CPU|).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

pytestmark = pytest.mark.cuda

SEQ, TOK, VOCAB, CLASSES = 50, 32, 500, 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _both(build, compile_kw):
    """The model built on the CPU and on the card, the card's weights
    (made first) loaded into the CPU's: (card, CPU)."""
    tzoo.init_nncontext(seed=0)
    card = build().compile(**compile_kw)
    card.model.estimator._ensure_initialized()
    tzoo.init_nncontext(seed=0, device="cpu")
    cpu = build().compile(**compile_kw)
    cpu.model.estimator.params = params_to_numpy(card.model)
    return card, cpu


def _near(got, want, rel, what):
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_on_the_card_matches_the_cpu(cuda, encoder):
    def build():
        return TextClassifier(CLASSES, TOK, SEQ, encoder, 64,
                              embedding=TL.Embedding(VOCAB, TOK))

    card, cpu = _both(build, dict(optimizer="adam",
                                  loss="sparse_categorical_crossentropy"))
    rs = np.random.RandomState(0)
    x = rs.randint(0, VOCAB, (8, SEQ)).astype(np.int32)
    y = rs.randint(0, CLASSES, (8, 1)).astype(np.int32)
    _near(card.predict(x, 8), cpu.predict(x, 8), 1e-5, "probabilities")
    for m in (card, cpu):
        for lyr in m.model.layers:
            if isinstance(lyr, TL.Dropout):
                lyr.p = 0.0
    lc = card.fit(x, y, batch_size=8, nb_epoch=1).history[0]["loss"]
    lp = cpu.fit(x, y, batch_size=8, nb_epoch=1).history[0]["loss"]
    assert abs(lc - lp) <= 1e-4 * abs(lp), (lc, lp)
    pc, pp = params_to_numpy(card.model), params_to_numpy(cpu.model)
    for name, sub in pp.items():
        for k, v in sub.items():
            _near(pc[name][k], v, 1e-5, f"{name}/{k}")


def test_knrm_scores_on_the_card_match_the_cpu(cuda):
    card, cpu = _both(lambda: KNRM(10, 40, 2000, embed_size=64),
                      dict(optimizer="adam", loss="rank_hinge"))
    with torch.no_grad():
        emb = card.model.graph_layers["embedding"].params()["embeddings"]
        emb.normal_(0.0, 0.3, generator=torch.Generator(
            device=emb.device).manual_seed(1))
    cpu.model.estimator.params = params_to_numpy(card.model)
    x = np.random.RandomState(1).randint(0, 2000, (8, 50)).astype(
        np.float32)
    _near(card.predict(x, 8), cpu.predict(x, 8), 1e-5, "scores")


def test_lstm_time_loop_makes_no_host_sync(cuda):
    lyr = TL.LSTM(256, return_sequences=True)
    p = {k: v.to(cuda).requires_grad_(True) for k, v in
         lyr.build(torch.Generator().manual_seed(0), (500, 200)).items()}
    x = torch.randn(16, 500, 200, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lyr.call(p, x)
        grads = torch.autograd.grad(out.square().sum(), list(p.values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == (16, 500, 256)
    assert all(torch.isfinite(g).all() for g in grads)
