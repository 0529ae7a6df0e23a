"""The port's data plumbing against the JAX package's, on the CPU:
``common/utils``' file helpers on local paths and on ``memory://``
(fsspec's in-memory store), the RDD adapter (``LocalRdd``, each
process's round-robin share), ``FeatureSet``'s batches in its three
memory tiers and two shard layouts, ``from_rdd``, ``transform``,
``TextSet.to_feature_set``, the Estimator's ``to_dataset`` on an
ImageSet, a TextSet and a ``LocalRdd``, and the ``rdd_ingest`` example.

Everything here is numpy or bytes: results are held bit for bit.
"""

import os
import uuid

import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.common import utils as jutils
from analytics_zoo_tpu.feature import common as jcommon
from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.feature import rdd as jrdd
from analytics_zoo_tpu.feature import text as jtext
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import utils as tutils
from analytics_zoo_tpu_torch.feature import common as tcommon
from analytics_zoo_tpu_torch.feature import feature_set as tfs
from analytics_zoo_tpu_torch.feature import rdd as trdd
from analytics_zoo_tpu_torch.feature import text as ttext
from analytics_zoo_tpu_torch.pipeline import estimator as test_


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


# -- common/utils -------------------------------------------------------------

def _tree(root):
    """Writes the same small tree through both packages' ``save_bytes``;
    returns the file names."""
    names = ["a/x.bin", "a/y.bin", "b/z.bin", "top.bin"]
    for i, name in enumerate(names):
        tutils.save_bytes(bytes([i]) * (i + 1), f"{root}/{name}")
    return names


@pytest.mark.parametrize("where", ["local", "memory"])
def test_file_helpers_match_jax(where, tmp_path):
    root = (str(tmp_path / "t") if where == "local"
            else f"memory://zoo-{uuid.uuid4().hex}")
    names = _tree(root)
    for fn, arg in (("list_files", root), ("list_dirs", root),
                    ("walk_files", root), ("list_files", f"{root}/a/*.bin"),
                    ("is_dir", root), ("is_dir", f"{root}/top.bin")):
        got, want = getattr(tutils, fn)(arg), getattr(jutils, fn)(arg)
        assert got == want, (fn, arg)
    files = tutils.walk_files(root)
    assert len(files) == len(names)
    for f in files:
        assert tutils.read_bytes(f) == jutils.read_bytes(f)
    assert tutils.read_bytes_many(files) == jutils.read_bytes_many(files)
    with pytest.raises(FileExistsError):
        tutils.save_bytes(b"again", files[0])
    tutils.save_bytes(b"again", files[0], is_overwrite=True)
    assert jutils.read_bytes(files[0]) == b"again"
    tutils.mkdirs(f"{root}/c/d")
    assert tutils.is_dir(f"{root}/c/d") and jutils.is_dir(f"{root}/c/d")
    tutils.remove(files[-1])
    assert tutils.walk_files(root) == jutils.walk_files(root) == files[:-1]
    tutils.remove(files[-1])          # a missing path is a no-op
    if where == "local":
        with pytest.raises(IsADirectoryError):
            tutils.remove(f"{root}/a")
    tutils.remove(f"{root}/a", recursive=True)
    assert tutils.walk_files(root) == jutils.walk_files(root)


def test_missing_backend_names_the_protocol():
    with pytest.raises(NotImplementedError, match="zoonosuch"):
        tutils.read_bytes("zoonosuch://bucket/key")
    with pytest.raises(ValueError, match="bad call"):
        tutils.log_usage_error_and_throw("bad call")


def test_parallel_map_and_ceil_pool_extra_match_jax(monkeypatch):
    items = list(range(23))
    for workers in ("1", "4", "junk"):
        monkeypatch.setenv("ZOO_TPU_DECODE_WORKERS", workers)
        assert tutils.parallel_map(lambda v: v * v, items) == \
            jutils.parallel_map(lambda v: v * v, items) == \
            [v * v for v in items]
    for args in [(d, k, s, lo, hi) for d in (5, 7, 8, 13)
                 for k in (2, 3) for s in (1, 2, 3) for lo in (0, 1)
                 for hi in (0, 1)]:
        assert tutils.ceil_pool_extra(*args) == jutils.ceil_pool_extra(*args)


# -- the RDD adapter ----------------------------------------------------------

@pytest.mark.parametrize("n, parts", [(10, 4), (3, 5), (0, 2)])
def test_local_rdd_and_shares_match_jax(n, parts):
    recs = [(i, i * i) for i in range(n)]
    got, want = trdd.LocalRdd(recs, parts), jrdd.LocalRdd(recs, parts)
    assert got._parts == want._parts
    assert got.getNumPartitions() == parts and got.count() == n
    assert got.map(lambda r: r[1]).filter(lambda v: v % 2).collect() == \
        want.map(lambda r: r[1]).filter(lambda v: v % 2).collect()
    assert got.repartition(3)._parts == want.repartition(3)._parts
    for k in (1, 2, 3):
        for i in range(k):
            assert trdd.collect_shard(got, i, k) == \
                jrdd.collect_shard(want, i, k)
    assert trdd.process_shard_spec() == (0, 1)
    assert trdd.is_rdd_like(got) and not trdd.is_rdd_like(recs)
    assert not trdd.is_spark_dataframe(got)


def test_iter_shard_streams_partitions_and_counts_records():
    def ingested():
        snap = tobs.snapshot().get("zoo_tpu_ingest_records_total",
                                   {"values": []})
        return sum(v["value"] for v in snap["values"]
                   if v["labels"] == {"stage": "rdd"})

    rdd = trdd.LocalRdd(range(12), 4)
    before = ingested()
    it = trdd.iter_shard(rdd)
    assert next(it) == 0 and rdd.partitions_fetched == 1
    assert list(it) == list(range(1, 12)) and rdd.partitions_fetched == 4
    assert ingested() - before == 12


# -- FeatureSet ---------------------------------------------------------------

def _columns(rs, n=23):
    return ([rs.randn(n, 4).astype(np.float32),
             rs.randint(0, 9, (n, 3)).astype(np.int32)],
            rs.randint(0, 5, (n, 1)).astype(np.int32))


def _batches_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        for a, b in zip(gx if isinstance(gx, list) else [gx],
                        wx if isinstance(wx, list) else [wx]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if wy is None:
            assert gy is None
        else:
            for a, b in zip(gy if isinstance(gy, list) else [gy],
                            wy if isinstance(wy, list) else [wy]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tier", ["dram", "direct", "pmem"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_feature_set_batches_match_jax(tier, shard, tmp_path):
    xs, y = _columns(np.random.RandomState(3))
    kw = dict(memory_type=tier, shard_index=shard[0], num_shards=shard[1])
    got = tfs.FeatureSet(xs, y, pmem_path=str(tmp_path / "t"), **kw)
    want = jfs.FeatureSet(xs, y, pmem_path=str(tmp_path / "j"), **kw)
    assert got.num_samples == want.num_samples == len(got)
    assert got.memory_type.value == tier and repr(got) == repr(want)
    if tier == "pmem":
        assert isinstance(got._x[0], np.memmap)
        assert sorted(os.listdir(tmp_path / "t")) == \
            ["col0.mm", "col1.mm", "col2.mm"]
    for seed, bs, shuffle, drop in ((0, 4, True, True), (5, 3, True, False),
                                    (0, 5, False, False)):
        _batches_equal(list(got.iter_batches(bs, shuffle, seed, drop)),
                       list(want.iter_batches(bs, shuffle, seed, drop)))


def test_feature_set_constructors_and_labels_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(12, 3).astype(np.float32)
    ya, yb = rs.randint(0, 3, (12, 1)), rs.randn(12, 2).astype(np.float32)
    for args in ((x, None), (x, ya), (x, [ya, yb]), ([x, x * 2], ya)):
        got, want = tfs.FeatureSet.array(*args), jfs.FeatureSet.array(*args)
        _batches_equal(list(got.iter_batches(4, seed=2)),
                       list(want.iter_batches(4, seed=2)))
    samples = [(x[i], [ya[i], yb[i]]) for i in range(12)]
    got = tfs.FeatureSet.sample_rdd(
        tcommon.Sample(feature=f, label=lab) for f, lab in samples)
    want = jfs.FeatureSet.sample_rdd(
        jcommon.Sample(feature=f, label=lab) for f, lab in samples)
    _batches_equal(list(got.iter_batches(5, seed=1)),
                   list(want.iter_batches(5, seed=1)))
    # a transform re-caches the samples through a preprocessing chain
    got2 = got.transform(tcommon.FnPreprocessing(
        lambda s: tcommon.Sample(s.feature * 2, s.label)))
    want2 = want.transform(jcommon.FnPreprocessing(
        lambda s: jcommon.Sample(s.feature * 2, s.label)))
    _batches_equal(list(got2.iter_batches(5, seed=1)),
                   list(want2.iter_batches(5, seed=1)))
    with pytest.raises(ValueError, match="empty sample stream"):
        tfs.FeatureSet.sample_rdd([])
    with pytest.raises(ValueError, match="does not match"):
        tfs.FeatureSet([x], ya[:5])
    with pytest.raises(ValueError, match="bad shard"):
        tfs.FeatureSet([x], shard_index=2, num_shards=2)


@pytest.mark.parametrize("kind", ["samples", "tuples", "bare", "preprocessed"])
def test_from_rdd_matches_jax(kind):
    rs = np.random.RandomState(5)
    x = rs.randn(17, 3).astype(np.float32)
    y = rs.randint(0, 4, (17, 1)).astype(np.int32)
    recs = {"samples": lambda C: [C.Sample(feature=x[i], label=y[i])
                                  for i in range(17)],
            "tuples": lambda C: [(x[i], y[i]) for i in range(17)],
            "bare": lambda C: [x[i] for i in range(17)],
            "preprocessed": lambda C: [list(x[i]) for i in range(17)]}[kind]
    pre = {"preprocessed": lambda C: C.SeqToTensor((3,)) >>
           C.TensorToSample()}.get(kind, lambda C: None)
    got = tfs.FeatureSet.from_rdd(trdd.LocalRdd(recs(tcommon), 3),
                                  pre(tcommon), shard_index=1, num_shards=2)
    want = jfs.FeatureSet.from_rdd(jrdd.LocalRdd(recs(jcommon), 3),
                                   pre(jcommon), shard_index=1, num_shards=2)
    assert got.num_samples == want.num_samples
    _batches_equal(list(got.iter_batches(3, seed=7)),
                   list(want.iter_batches(3, seed=7)))


# -- TextSet.to_feature_set and to_dataset ------------------------------------

def _texts():
    rs = np.random.RandomState(6)
    words = ["gpu", "kernel", "team", "win", "rain", "sun", "map"]
    texts = [" ".join(rs.choice(words, 5)) for _ in range(10)]
    return texts, [i % 3 for i in range(10)]


@pytest.mark.parametrize("tier", ["dram", "pmem"])
def test_text_set_to_feature_set_matches_jax(tier):
    texts, labels = _texts()
    got, want = (T.TextSet.from_texts(texts, labels).tokenize().word2idx()
                 .shape_sequence(4).generate_sample().to_feature_set(tier)
                 for T in (ttext, jtext))
    assert isinstance(got, tfs.FeatureSet)
    _batches_equal(list(got.iter_batches(4, seed=3, drop_last=False)),
                   list(want.iter_batches(4, seed=3, drop_last=False)))
    with pytest.raises(ValueError, match="generate_sample"):
        ttext.TextSet.from_texts(texts).to_feature_set()


def test_to_dataset_matches_jax_on_sets_and_rdds():
    from analytics_zoo_tpu.feature.image import ImageSet as JImageSet
    from analytics_zoo_tpu.pipeline import estimator as jest
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 255, (6, 5, 4, 3)).astype(np.uint8)
    labels = rs.randint(0, 2, 6)
    texts, tlabels = _texts()
    cases = [
        (ImageSet.from_arrays(imgs, labels),
         JImageSet.from_arrays(imgs, labels)),
        (ImageSet.from_arrays(imgs), JImageSet.from_arrays(imgs)),
        (ttext.TextSet.from_texts(texts, tlabels).tokenize().word2idx()
         .shape_sequence(4),
         jtext.TextSet.from_texts(texts, tlabels).tokenize().word2idx()
         .shape_sequence(4)),
        (trdd.LocalRdd([(imgs[i].astype(np.float32), labels[i:i + 1])
                        for i in range(6)], 2),
         jrdd.LocalRdd([(imgs[i].astype(np.float32), labels[i:i + 1])
                        for i in range(6)], 2)),
    ]
    for got_in, want_in in cases:
        got, want = test_.to_dataset(got_in), jest.to_dataset(want_in)
        assert type(got).__name__ == type(want).__name__
        _batches_equal(list(got.iter_batches(4, seed=1, drop_last=False)),
                       list(want.iter_batches(4, seed=1, drop_last=False)))
    # y overrides a set's own labels
    got = test_.to_dataset(ImageSet.from_arrays(imgs, labels), labels * 0)
    assert not got.y.any()


def test_rdd_ingest_example_runs_on_cpu(capsys):
    from analytics_zoo_tpu_torch.examples import EXAMPLES, rdd_ingest
    assert "rdd_ingest" in EXAMPLES
    metrics = rdd_ingest.main(["--device", "cpu", "--n", "64",
                               "--partitions", "4", "--epochs", "2",
                               "--batch-size", "16"])
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1
    assert "FeatureSet(n=64, tier=dram" in capsys.readouterr().out
