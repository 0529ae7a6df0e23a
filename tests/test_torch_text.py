"""The text-classification slice of the port against the JAX package's,
on the CPU: ``feature.common``'s preprocessing algebra, the text data
path (TextSet's readers and pipeline, the word index with each of its
options, both trunc modes, the relation pairs and lists, ``Relations``)
compared value for value, the TextClassifier with each encoder (eval
probabilities, one Adam step at dropout 0, the pre-embedded input),
its ``save_model``/``load_model`` round trip and the example.

Probabilities within 1e-5 of max(1, max|p|); a step's loss within 1e-4
relative and the weights after it within 1e-5. Weights cross as numpy
(``bridge``).
"""

import jax
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as j_init
from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature import text as jtext
from analytics_zoo_tpu.models import textclassification as jtc
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.feature import common as tcommon
from analytics_zoo_tpu_torch.feature import text as ttext
from analytics_zoo_tpu_torch.models import textclassification as ttc
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    j_init(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    yield
    tzoo.reset_nncontext()


def _tree_close(got, want, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=TOL,
                                       atol=TOL, err_msg=f"{path}/{k}")


# -- feature.common -----------------------------------------------------------

def _ingested(stage):
    snap = tobs.snapshot().get("zoo_tpu_ingest_records_total",
                               {"values": []})
    return sum(v["value"] for v in snap["values"]
               if v["labels"] == {"stage": stage})


def test_preprocessing_chain_and_adapters_match_jax():
    def chain(C):
        return (C.FnPreprocessing(lambda r: None if r[0] < 0 else r) >>
                C.SeqToTensor((2, 2)) >> C.TensorToSample())

    rows = [[1, 2, 3, 4], [-1, 0, 0, 0], [5, 6, 7, 8]]
    before = _ingested("TensorToSample")
    got = list(chain(tcommon)(rows))
    want = list(chain(jcommon)(rows))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.feature.dtype == np.float32 and g.label is None
    assert _ingested("TensorToSample") - before == 2
    assert len(chain(tcommon).stages) == 3
    assert [chain(tcommon).apply(r) is None for r in rows] == \
        [False, True, False]

    flp = tcommon.FeatureLabelPreprocessing(tcommon.ArrayToTensor(),
                                            tcommon.ScalarToTensor())
    s = flp.apply(([1, 2], 3))
    np.testing.assert_array_equal(s.label, np.array([3.0], np.float32))
    assert [a.shape for a in tcommon.Sample([np.zeros(2), 1.0])
            .feature_arrays()] == [(2,), ()]

    class Vec:
        def toArray(self):
            return [1.0, 2.0]

    np.testing.assert_array_equal(
        tcommon.MLlibVectorToTensor().apply(Vec()),
        jcommon.MLlibVectorToTensor().apply(Vec()))
    assert tcommon.BigDLAdapter(len).apply("abc") == 3


# -- the text data path -------------------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
         "iota", "kappa", "Lambda!", "mu,"]


def _corpus(n=24, seed=0):
    rs = np.random.RandomState(seed)
    texts = [" ".join(rs.choice(WORDS, rs.randint(3, 15)))
             for _ in range(n)]
    return texts, list(rs.randint(0, 4, n))


@pytest.mark.parametrize("kw", [
    {}, {"remove_topn": 2}, {"max_words_num": 5}, {"min_freq": 9},
    {"remove_topn": 1, "max_words_num": 6, "min_freq": 3}])
def test_text_set_pipeline_and_word_index_match_jax(kw):
    texts, labels = _corpus()
    sets = []
    for mod in (jtext, ttext):
        ts = mod.TextSet.from_texts(texts, labels).tokenize().normalize()
        sets.append(ts)
    for f, g in zip(sets[0].features, sets[1].features):
        assert g.tokens == f.tokens and g.text == f.text
    for ts in sets:
        ts.word2idx(**kw)
    assert sets[1].get_word_index() == sets[0].get_word_index()
    assert list(sets[1].get_word_index()) == list(sets[0].get_word_index())
    assert min(sets[1].get_word_index().values()) == 1
    for trunc in ("pre", "post"):
        arrs = [ts.shape_sequence(6, trunc_mode=trunc).generate_sample()
                .to_arrays() for ts in sets]
        np.testing.assert_array_equal(arrs[1][0], arrs[0][0])
        np.testing.assert_array_equal(arrs[1][1], arrs[0][1])
        assert arrs[1][0].dtype == np.int32 and arrs[1][0].shape == (24, 6)


def test_word_index_with_an_existing_map_save_and_load(tmp_path):
    texts, labels = _corpus(seed=1)
    existing = {"beta": 3, "alpha": 1, "iota": 7}
    got = ttext.TextSet.from_texts(texts).tokenize().word2idx(
        existing_map=existing).shape_sequence(5, "post")
    want = jtext.TextSet.from_texts(texts).tokenize().word2idx(
        existing_map=existing).shape_sequence(5, "post")
    assert got.get_word_index() == existing
    np.testing.assert_array_equal(got.to_arrays()[0], want.to_arrays()[0])
    assert got.to_arrays()[1] is None
    path = str(tmp_path / "words.txt")
    got.save_word_index(path)
    back = ttext.TextSet([]).load_word_index(path)
    assert back.get_word_index() == existing
    with pytest.raises(ValueError, match="no word index"):
        ttext.TextSet([]).save_word_index(path)
    with pytest.raises(ValueError, match="tokenize"):
        ttext.TextSet.from_texts(texts).word2idx()
    with pytest.raises(ValueError, match="trunc_mode"):
        ttext.SequenceShaper(4, "middle")
    with pytest.raises(ValueError, match="no indices"):
        ttext.TextSet.from_texts(texts).tokenize().to_arrays()
    fs = got.generate_sample().to_feature_set()
    want_fs = want.generate_sample().to_feature_set()
    assert fs.num_samples == want_fs.num_samples == len(texts)
    (xb, yb), = fs.iter_batches(len(texts), shuffle=False)
    (wx, wy), = want_fs.iter_batches(len(texts), shuffle=False)
    np.testing.assert_array_equal(xb, wx)
    assert yb is None and wy is None


def test_text_set_readers_match_jax(tmp_path):
    root = tmp_path / "news"
    for c, body in (("sci", "gpu kernel"), ("sport", "team win")):
        (root / c).mkdir(parents=True)
        for i in range(2):
            (root / c / f"{i}.txt").write_text(f"{body} {i}")
    csv_path = tmp_path / "corpus.csv"
    csv_path.write_text("id,text\nq1,What is rain\nq2,Why sun\n")
    for reader, arg in (("read", str(root)), ("read_csv", str(csv_path))):
        got = getattr(ttext.TextSet, reader)(arg)
        want = getattr(jtext.TextSet, reader)(arg)
        assert len(got) == len(want)
        for g, w in zip(got.features, want.features):
            assert g.text == w.text
            assert g.get(ttext.TextFeature.URI) == \
                w.get(jtext.TextFeature.URI)
            assert (g.label is None) == (w.label is None)
            if g.label is not None:
                np.testing.assert_array_equal(g.label, w.label)
    assert ttext.TextSet.read(str(root)).n_classes == 2


def _relations_csv(path, rs):
    rows = ["id1,id2,label"]
    for q in range(6):
        for a in rs.choice(8, 4, replace=False):
            rows.append(f"q{q},a{a},{int(rs.rand() < 0.4)}")
    path.write_text("\n".join(rows) + "\n")


def test_relations_pairs_and_lists_match_jax(tmp_path):
    rs = np.random.RandomState(2)
    qs = [f"q{i}," + " ".join(rs.choice(WORDS, 4)) for i in range(6)]
    ans = [f"a{i}," + " ".join(rs.choice(WORDS, 7)) for i in range(8)]
    (tmp_path / "q.csv").write_text("\n".join(qs) + "\n")
    (tmp_path / "a.csv").write_text("\n".join(ans) + "\n")
    _relations_csv(tmp_path / "rel.csv", rs)
    out = {}
    for name, mod in (("jax", jtext), ("torch", ttext)):
        rel = mod.Relations.read(str(tmp_path / "rel.csv"))
        q = mod.TextSet.read_csv(str(tmp_path / "q.csv")).tokenize() \
            .normalize().word2idx().shape_sequence(3)
        a = mod.TextSet.read_csv(str(tmp_path / "a.csv")).tokenize() \
            .normalize().word2idx(existing_map=q.get_word_index()) \
            .shape_sequence(5)
        pairs = mod.Relations.generate_relation_pairs(rel, seed=0)
        out[name] = (
            [(r.id1, r.id2, r.label) for r in rel],
            [((p.id1, p.id2), (n.id1, n.id2)) for p, n in pairs],
            mod.TextSet.from_relation_pairs(rel, q, a, seed=0),
            mod.TextSet.from_relation_lists(rel, q, a),
            sorted(mod.Relations.group_by_query(rel)))
    j, t = out["jax"], out["torch"]
    assert t[0] == j[0] and len(t[0]) == 24
    assert t[1] == j[1] and len(t[1]) > 0
    for got, want in zip(t[2] + t[3], j[2] + j[3]):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    assert t[4] == j[4]
    assert ttext.Relation("q", "a", 1) == ttext.Relation("q", "a", 1)


# -- TextClassifier -----------------------------------------------------------

SEQ, TOK, VOCAB, CLASSES = 12, 8, 64, 5


def _classifier(mod, layers, encoder, embedded):
    emb = (layers.Embedding(VOCAB, TOK, input_shape=(SEQ,))
           if embedded else None)
    return mod.TextClassifier(CLASSES, token_length=TOK, sequence_length=SEQ,
                              encoder=encoder, encoder_output_dim=16,
                              embedding=emb)


def _data(n, embedded, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randint(0, VOCAB, (n, SEQ)).astype(np.int32) if embedded
         else rs.randn(n, SEQ, TOK).astype(np.float32))
    return x, rs.randint(0, CLASSES, (n, 1)).astype(np.int32)


@pytest.mark.parametrize("embedded", [True, False])
@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_matches_jax(encoder, embedded):
    jc = _classifier(jtc, JL, encoder, embedded)
    tc = _classifier(ttc, TL, encoder, embedded)
    for c in (jc, tc):
        c.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jest = jc.model.estimator
    jest._ensure_initialized()
    p = jax.device_get(jest.params)
    tc.model.estimator.params = p
    assert [lyr.name for lyr in tc.model.layers] == \
        [lyr.name for lyr in jc.model.layers]
    hp = tc.hyper_parameters()
    if embedded:
        assert hp.pop("embedding") == {"class": "Embedding",
                                       "input_dim": VOCAB, "output_dim": TOK,
                                       "trainable": True}
    assert hp == jc.hyper_parameters()
    x, y = _data(8, embedded)
    want = np.asarray(jc.predict(x, batch_size=8))
    got = tc.predict(x, batch_size=8)
    assert got.shape == (8, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    for c in (jc, tc):
        drops = [lyr for lyr in c.model.layers
                 if type(lyr).__name__ == "Dropout"]
        assert [d.p for d in drops] == [0.2]
        drops[0].p = 0.0
    jh = jc.fit(x, y, batch_size=8, nb_epoch=1).history
    th = tc.fit(x, y, batch_size=8, nb_epoch=1).history
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-4)
    _tree_close(params_to_numpy(tc.model), jax.device_get(jest.params))


def test_text_classifier_arguments_and_round_trip(tmp_path):
    with pytest.raises(ValueError, match="encoder"):
        ttc.TextClassifier(3, encoder="transformer")
    emb = TL.Embedding(VOCAB, TOK)
    tc = ttc.TextClassifier(CLASSES, TOK, SEQ, "gru", 16, embedding=emb)
    tc.model
    assert emb._given_input_shape == (SEQ,)
    table = np.random.RandomState(3).randn(VOCAB, TOK).astype(np.float32)
    fronts = {"none": None, "embedding": TL.Embedding(VOCAB, TOK),
              "word_embedding": TL.WordEmbedding(table)}
    for name, front in fronts.items():
        tc = ttc.TextClassifier(CLASSES, TOK, SEQ, "lstm", 16,
                                embedding=front)
        tc.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
        x, y = _data(8, front is not None, seed=2)
        tc.fit(x, y, batch_size=4, nb_epoch=1)
        path = str(tmp_path / f"clf_{name}.model")
        tc.save_model(path)
        back = ttc.TextClassifier.load_model(path)
        assert back.hyper_parameters() == tc.hyper_parameters()
        np.testing.assert_array_equal(back.predict(x), tc.predict(x))
    assert not back.model.layers[0].trainable     # WordEmbedding: frozen
    with pytest.raises(ValueError, match="only Embedding"):
        ttc.TextClassifier(3, embedding=TL.Dense(4)).hyper_parameters()


def test_text_classification_example_runs_on_the_cpu():
    from analytics_zoo_tpu_torch.examples import text_classification
    metrics = text_classification.main(["--device", "cpu", "--epochs",
                                        "2"])
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1
    rs = np.random.RandomState(0)
    texts, labels = text_classification.synth_corpus(
        rs, 4, 20, vocab_words=400, length=(30, 40))
    assert len(texts) == 80 and sorted(set(labels)) == list(range(20))
    assert all(30 <= len(t.split()) < 40 for t in texts)
