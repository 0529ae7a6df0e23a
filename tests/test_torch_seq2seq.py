"""The port's Seq2seq, ZooDictionary and chatbot example against the JAX
package's, on the same numpy weights (bridged) and inputs: the forward
for LSTM and GRU, one and two layers and every bridge; two Adam steps
through ``fit``; ``decode_step`` against one step of ``call_with_state``
(bit for bit); ``generate`` against a host loop of full re-forwards and
against the JAX package's (stop sign included); greedy
``generate_tokens`` (identical ids and counts, with an end token);
``infer``; ``infer_beam`` (identical ids, the score within 1e-5).

Tolerances: f32 outputs 1e-5, losses 1e-4 relative, params after two
steps 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu as jzoo
import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.common.dictionary import ZooDictionary as JDict
from analytics_zoo_tpu.models import seq2seq as JS
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu_torch.common.dictionary import ZooDictionary as TDict
from analytics_zoo_tpu_torch.models import seq2seq as TS
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense as TDense

TOL = 1e-5
T_IN, V, H = 4, 7, 16


@pytest.fixture(autouse=True)
def _cpu():
    jzoo.init_nncontext(seed=0)
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _pair(rnn="lstm", layers=1, bridge="dense", softmax=True, seed=0):
    """The JAX Seq2seq and the port's, compiled with Adam and
    categorical cross-entropy, the port holding the JAX weights."""
    def make(pkg, dense):
        m = pkg.Seq2seq(encoder=pkg.RNNEncoder(rnn, layers, H),
                        decoder=pkg.RNNDecoder(rnn, layers, H),
                        input_shape=(T_IN, V), output_shape=(T_IN, V),
                        bridge=pkg.Bridge(bridge),
                        generator=dense(V, activation="softmax"
                                        if softmax else None,
                                        name="generator"))
        return m.compile(optimizer="adam",
                         loss="categorical_crossentropy" if softmax
                         else "mse")
    jzoo.init_nncontext(seed=seed)
    js, ts = make(JS, JDense), make(TS, TDense)
    est = js.model.estimator
    est._ensure_initialized()
    ts.model.load_params(jax.device_get(est.params), device="cpu")
    return js, ts


def _data(b=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, T_IN, V).astype(np.float32),
            rs.randn(b, T_IN, V).astype(np.float32))


@pytest.mark.parametrize("rnn,layers,bridge", [
    ("lstm", 1, "passthrough"), ("lstm", 2, "dense"),
    ("lstm", 2, "densenonlinear"), ("gru", 1, "dense"),
    ("gru", 2, "passthrough"), ("gru", 2, "densenonlinear")])
def test_apply_matches_jax(rnn, layers, bridge):
    js, ts = _pair(rnn, layers, bridge)
    enc, dec = _data()
    want = np.asarray(js.model.forward(js.model.estimator.params,
                                       [enc, dec]))
    got = ts.model.forward([torch.from_numpy(enc), torch.from_numpy(dec)])
    assert got.shape == (3, T_IN, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the param tree keeps the reference's names
    names = set(ts.model.params())
    assert {f"enc_rnn_{i}" for i in range(layers)} <= names
    assert {f"dec_rnn_{i}" for i in range(layers)} <= names
    assert "generator" in names
    n_bridge = 0 if bridge == "passthrough" else \
        layers * (2 if rnn == "lstm" else 1)
    assert {n for n in names if n.startswith("bridge_")} == \
        {f"bridge_{i}" for i in range(n_bridge)}


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_two_adam_steps_match_jax(rnn):
    js, ts = _pair(rnn, 2, "dense")
    # batch 8: the JAX package's tests run on 8 host devices
    enc, dec = _data(8, seed=1)
    y = np.eye(V, dtype=np.float32)[
        np.random.RandomState(2).randint(0, V, (8, T_IN))]
    jl = [h["loss"] for h in js.fit([enc, dec], y, batch_size=8,
                                    nb_epoch=2).history]
    tl = [h["loss"] for h in ts.fit([enc, dec], y, batch_size=8,
                                    nb_epoch=2).history]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jp = jax.device_get(js.model.estimator.params)
    tp = {k: {n: v.detach().numpy() for n, v in d.items()}
          for k, d in ts.model.params().items()}
    for k in jp:
        for n in jp[k]:
            np.testing.assert_allclose(tp[k][n], jp[k][n], atol=TOL,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_decode_step_is_one_step_of_call_with_state(rnn):
    _, ts = _pair(rnn, 2, "densenonlinear")
    net = ts.model
    params = net.params()
    enc, dec = _data()
    enc_t, x = torch.from_numpy(enc), torch.from_numpy(dec[:, 0])
    carries = net.encode(params, enc_t)
    new, y = net.decode_step(params, carries, x)
    # the same step through the layers' sequence call, one step long
    h = x[:, None]
    for r, c, c_new in zip(net.decoder.rnns, carries, new):
        h, c_seq = r.call_with_state(params[r.name], h, initial_carry=c)
        for a, b in zip(c_seq if isinstance(c_seq, tuple) else (c_seq,),
                        c_new if isinstance(c_new, tuple) else (c_new,)):
            assert torch.equal(a, b)
    want = net.generator.call(params["generator"], h[:, 0])
    assert torch.equal(y, want)


@pytest.mark.parametrize("rnn,stop", [("lstm", False), ("gru", True)])
def test_generate_matches_reforward_and_jax(rnn, stop):
    js, ts = _pair(rnn, 1, "dense", softmax=False)
    enc, _ = _data(2, seed=3)
    start = np.ones((V,), np.float32)
    max_new = 5
    net = ts.model
    params = net.params()
    # a stop vector that row 0 emits at its third step
    stop_sign = None
    if stop:
        b0, _ = net.generate(params, torch.from_numpy(enc[:1]), start, 3)
        stop_sign = b0[0, 3].numpy()
    buf, counts = net.generate(params, torch.from_numpy(enc), start,
                               max_new, stop_sign=stop_sign)
    jbuf, jcounts = js.model.generate(
        js.model.estimator.params, jnp.asarray(enc), start, max_new,
        stop_sign=None if stop_sign is None else jnp.asarray(stop_sign))
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf), rtol=TOL,
                               atol=TOL)
    assert counts.tolist() == np.asarray(jcounts).tolist()
    if stop:
        assert counts.tolist()[0] == 3
    else:
        assert counts.tolist() == [1 + max_new] * 2
    # a host loop of full re-forwards of the growing decoder input
    seq = np.broadcast_to(start, (2, 1, V)).copy()
    for _ in range(max_new):
        out = net.call(params, [torch.from_numpy(enc),
                                torch.from_numpy(seq)])[:, -1]
        seq = np.concatenate([seq, out.numpy()[:, None]], axis=1)
    n0 = int(counts[0])
    np.testing.assert_allclose(buf.numpy()[0, :n0], seq[0, :n0],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(buf.numpy()[1], seq[1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_generate_tokens_greedy_identical_to_jax(rnn):
    js, ts = _pair(rnn, 2, "dense", seed=5)
    enc, _ = _data(3, seed=4)
    for eos in (None, 2):
        jb, jn = js.model.generate_tokens(js.model.estimator.params,
                                          jnp.asarray(enc), 1, 6,
                                          eos_id=eos)
        tb, tn = ts.model.generate_tokens(ts.model.params(),
                                          torch.from_numpy(enc), 1, 6,
                                          eos_id=eos)
        assert tb.dtype == torch.int32
        assert tb.tolist() == np.asarray(jb).tolist()
        assert tn.tolist() == np.asarray(jn).tolist()
    # greedy ids are a host loop of argmaxes over full re-forwards
    net, params = ts.model, ts.model.params()
    ids = [[1]] * 3
    for _ in range(6):
        dec = np.zeros((3, len(ids[0]), V), np.float32)
        for r, row in enumerate(ids):
            dec[r, np.arange(len(row)), row] = 1.0
        out = net.call(params, [torch.from_numpy(enc),
                                torch.from_numpy(dec)])[:, -1]
        nxt = out.argmax(-1).tolist()
        ids = [row + [t] for row, t in zip(ids, nxt)]
    tb, _ = net.generate_tokens(params, torch.from_numpy(enc), 1, 6)
    assert tb.tolist() == ids


def test_generate_tokens_sampled_is_seeded():
    _, ts = _pair("gru", 1, "dense")
    enc, _ = _data(2)
    net, params = ts.model, ts.model.params()
    a, _ = net.generate_tokens(params, torch.from_numpy(enc), 1, 6,
                               temperature=1.0, rng=7)
    b, _ = net.generate_tokens(params, torch.from_numpy(enc), 1, 6,
                               temperature=1.0, rng=7)
    assert a.tolist() == b.tolist()
    assert ((a >= 0) & (a < V)).all()


@pytest.mark.parametrize("rnn,stop", [("lstm", None), ("gru", 3)])
def test_infer_matches_jax(rnn, stop):
    js, ts = _pair(rnn, 2, "densenonlinear")
    enc, _ = _data(1, seed=6)
    start = np.eye(V, dtype=np.float32)[1]
    stop_sign = None
    if stop is not None:
        full = ts.infer(enc[0], start, max_seq_len=6)
        stop_sign = full[0, stop]
    got = ts.infer(enc[0], start, max_seq_len=6, stop_sign=stop_sign)
    want = js.infer(enc[0], start, max_seq_len=6, stop_sign=stop_sign)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if stop is not None:
        assert got.shape[1] == stop


@pytest.mark.parametrize("rnn,seed", [("lstm", 11), ("gru", 12)])
def test_infer_beam_matches_jax(rnn, seed):
    js, ts = _pair(rnn, 1, "dense", seed=seed)
    enc, _ = _data(1, seed=seed)
    # the seeds' candidate gaps exceed the f32 tolerance: the
    # log-probabilities of every step's candidates differ by more than
    # 1e-4, so both packages rank them alike
    for stop in (None, 2):
        got = ts.infer_beam(enc[0], 1, beam_size=3, max_seq_len=4,
                            stop_token=stop)
        want = js.infer_beam(enc[0], 1, beam_size=3, max_seq_len=4,
                             stop_token=stop)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=TOL)


def test_zoo_dictionary_matches_jax(tmp_path):
    corpus = [["The", "cat", "sat"], ["the", "dog", "sat", "down"],
              ["a", "cat", "and", "a", "dog"], ["The", "end"]]
    for kw in ({}, {"case_sensitive": False}, {"max_vocab": 4}):
        j, t = JDict.from_corpus(corpus, **kw), TDict.from_corpus(corpus, **kw)
        assert t.idx2word() == j.idx2word()
        assert t.word2idx() == j.word2idx()
        words = ["cat", "THE", "zebra"]
        unk = 0
        assert t.encode(words, unk_index=unk) == j.encode(words,
                                                          unk_index=unk)
        assert t.decode([0, 1, 2]) == j.decode([0, 1, 2])
        assert ("The" in t) == ("The" in j)
    t = TDict.from_corpus(corpus, case_sensitive=False)
    with pytest.raises(KeyError):
        t.get_index("zebra")
    # files cross both ways
    t.save(str(tmp_path / "t.json"))
    assert JDict.load(str(tmp_path / "t.json")).idx2word() == t.idx2word()
    j = JDict.from_corpus(corpus)
    j.save(str(tmp_path / "j.json"))
    loaded = TDict.load(str(tmp_path / "j.json"))
    assert loaded.idx2word() == j.idx2word()
    assert loaded.case_sensitive and len(loaded) == len(j)


@pytest.mark.parametrize("beam", [1, 3])
def test_chatbot_example_runs_on_cpu(beam, capsys):
    from analytics_zoo_tpu_torch.examples import EXAMPLES, chatbot
    assert "chatbot" in EXAMPLES
    out = chatbot.main(["--device", "cpu", "--epochs", "3", "--beam",
                        str(beam)])
    assert np.isfinite(out["loss"])
    assert isinstance(out["reply"], str)
    assert "> how are you" in capsys.readouterr().out
